"""Activation checkpointing in the port against plain autograd and the JAX
package, on the CPU (the JAX tests as the model).

Gradients through ``checkpointing.checkpoint`` (and
``CheckpointFunction.apply``) equal the plain forward's bit for bit, with
non-tensor arguments, with dropout drawn inside the segment (torch's
generator; the port's counter-based dropout, its seed from the CPU
default generator; GPT-2's blocks with their seeds), under
``cpu_checkpointing`` and under ``partition_activations`` over two model
ranks (one launch of two gloo ranks: each saves half of every input and
all-gathers it in the backward). The fp32 gradients are within 1e-6 of the
JAX package's checkpointed gradients on the same numpy inputs. Also: the
RNG tracker's named streams (fork advances a stream and restores the
caller's state; duplicate seeds and names are refused), the model-parallel
seed rule, and the engine configuring the module from its
``activation_checkpointing`` block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime.activation_checkpointing import (
    checkpointing as jckpt)
from tests.torch_dist_worker import run_ranks

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.models.simple import SimpleModel
from deepspeed_tpu_torch.ops.transformer.kernels.dropout import dropout
from deepspeed_tpu_torch.runtime.activation_checkpointing import (
    checkpointing)

torch.set_num_threads(1)

JAX_TOL = 1e-6


@pytest.fixture(autouse=True)
def _reset_config():
    yield
    checkpointing.PARTITION_ACTIVATIONS = False
    checkpointing.CONTIGUOUS_CHECKPOINTING = False
    checkpointing.PA_TO_CPU = False
    checkpointing.SYNCHRONIZE = False
    checkpointing.PROFILE_TIME = False
    checkpointing.num_layers = None
    checkpointing._CONFIGURED = False
    checkpointing._mesh = None
    checkpointing.mpu = None


def _mlp(x, w1, w2):
    h = torch.tanh(x @ w1)
    return ((h @ w2) ** 2).sum()


def _jmlp(x, w1, w2):
    h = jnp.tanh(x @ w1)
    return jnp.sum((h @ w2) ** 2)


def _grads(fn, *arrays, wrt=(1, 2)):
    leaves = [torch.from_numpy(a).requires_grad_(i in wrt)
              for i, a in enumerate(arrays)]
    fn(*leaves).backward()
    return [leaves[i].grad for i in wrt]


def _equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _near_jax(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= JAX_TOL * np.abs(w).max()


def test_ckpt_inputs1_outputs1_grad_parity():
    rng = np.random.RandomState(0)
    x, w1, w2 = (rng.randn(*s).astype(np.float32)
                 for s in ((4, 8), (8, 16), (16, 4)))
    checkpointing.configure(num_checkpoints=1)
    plain = _grads(_mlp, x, w1, w2)
    ckpt = _grads(lambda *a: checkpointing.checkpoint(_mlp, *a), x, w1, w2)
    _equal(plain, ckpt)
    jgrads = jax.grad(lambda x, a, b: jckpt.checkpoint(_jmlp, x, a, b),
                      argnums=(1, 2))(*(jnp.asarray(a) for a in (x, w1, w2)))
    _near_jax(ckpt, jgrads)


def test_ckpt_non_tensor_and_tuple_args():
    rng = np.random.RandomState(1)
    x, w = (rng.randn(*s).astype(np.float32) for s in ((4, 8), (8, 8)))
    mask = (rng.rand(4, 8) > 0.5).astype(np.float32)

    def seg(x, w, mask, scale, off):
        h = (x @ w) * mask * scale
        return torch.tanh(h).sum() if off is None else torch.tanh(h).sum()

    checkpointing.configure()
    wrapped = checkpointing.checkpoint_wrapped(seg)
    m = torch.from_numpy(mask)
    plain = _grads(lambda x, w: seg(x, w, m, 2.0, None), x, w, wrt=(1,))
    ckpt = _grads(lambda x, w: wrapped(x, w, m, 2.0, None), x, w, wrt=(1,))
    _equal(plain, ckpt)

    def jseg(x, w, mask, scale):
        return jnp.sum(jnp.tanh((x @ w) * mask * scale))

    jg = jax.grad(lambda x, w: jckpt.checkpoint_wrapped(jseg)(
        x, w, jnp.asarray(mask), 2.0), argnums=1)(jnp.asarray(x),
                                                 jnp.asarray(w))
    _near_jax(ckpt, [jg])


@pytest.mark.parametrize("source", ["torch_rng", "port_dropout",
                                    "generator_arg"])
def test_ckpt_dropout_reproducibility(source):
    """The recompute draws the masks the forward drew: the segment's
    random states are saved and restored (torch's generator; the port's
    counter-based dropout, its seed from the CPU default generator or from
    a ``torch.Generator`` argument, as the engine passes its own)."""
    rng = np.random.RandomState(2)
    x, w = (rng.randn(*s).astype(np.float32) for s in ((4, 16), (16, 16)))

    def seg(x, w, gen):
        h = x @ w
        if source == "torch_rng":
            h = torch.where(torch.rand(h.shape) < 0.9, h, 0.0)
        else:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
            h = dropout(h, 0.1, seed, False)
        return (h ** 2).sum()

    grads = []
    for run in ("plain", "ckpt"):
        torch.manual_seed(7)
        gen = torch.Generator().manual_seed(11) \
            if source == "generator_arg" else None
        fn = seg if run == "plain" else \
            (lambda x, w, g: checkpointing.checkpoint(seg, x, w, g))
        grads.append(_grads(lambda x, w: fn(x, w, gen), x, w, wrt=(1,)))
        if gen is not None:  # the generator moves on as the forward left it
            grads[-1].append(torch.randint(0, 2 ** 62, (1,), generator=gen))
    _equal(*grads)


def test_gpt2_blocks_bit_equal_under_dropout():
    """A stack of GPT-2 blocks at dropout 0.1, each through ``checkpoint``:
    the gradients of the input and of every weight equal the plain
    stack's."""
    cfg = GPT2Config.tiny(dtype=torch.float32, dropout=0.1)
    model = GPT2LMHeadModel(cfg, device="cpu").requires_grad_(True)
    x0 = torch.from_numpy(np.random.RandomState(3).randn(
        2, 16, cfg.n_embd).astype(np.float32))
    seeds = [11, 12]
    grads = []
    for run in ("plain", "ckpt"):
        for p in model.parameters():
            p.grad = None
        x = x0.clone().requires_grad_()
        h = x
        for blk, seed in zip(model.blocks(), seeds):
            h = blk(h, cfg, seed) if run == "plain" else \
                checkpointing.checkpoint(blk, h, cfg, seed)
        h.square().sum().backward()
        grads.append([x.grad] + [p.grad.clone() for p in model.parameters()
                                 if p.grad is not None])
    assert len(grads[0]) == len(grads[1]) > 1
    _equal(*grads)


def test_rng_tracker_named_streams():
    tracker = checkpointing.RNGStatesTracker()
    tracker.add("model-parallel-rng", 42)
    with tracker.fork("model-parallel-rng"):
        a = torch.randn(4)
    with tracker.fork("model-parallel-rng"):
        b = torch.randn(4)
    assert not torch.equal(a, b)  # the stream advances
    t2 = checkpointing.RNGStatesTracker()
    t2.add("model-parallel-rng", 42)
    with t2.fork("model-parallel-rng"):
        assert torch.equal(torch.randn(4), a)  # same seed, same sequence
    with pytest.raises(Exception):
        tracker.add("other", 42)
    with pytest.raises(Exception):
        tracker.add("model-parallel-rng", 43)
    with pytest.raises(Exception):
        with tracker.fork("missing"):
            pass


def test_rng_tracker_fork_restores_the_callers_state():
    """Draws outside a fork do not see the stream (the reference's state
    swap), and a checkpointed segment replays the tracker's streams."""
    tracker = checkpointing.get_cuda_rng_tracker()
    tracker.reset()
    tracker.add("s", 5)
    torch.manual_seed(1)
    want = torch.randn(3)
    torch.manual_seed(1)
    with tracker.fork("s"):
        torch.randn(8)
    assert torch.equal(torch.randn(3), want)

    def seg(x):
        with tracker.fork("s"):
            keep = torch.rand(x.shape) < 0.5
        return (torch.where(keep, x, 0.0) ** 2).sum()

    x = torch.randn(16)
    tracker.reset()
    tracker.add("s", 5)
    xa = x.clone().requires_grad_()
    seg(xa).backward()
    tracker.reset()
    tracker.add("s", 5)
    xb = x.clone().requires_grad_()
    checkpointing.checkpoint(seg, xb).backward()
    assert torch.equal(xa.grad, xb.grad)
    tracker.reset()


def test_partition_activations_over_model_ranks(tmp_path):
    """Two model ranks: a checkpointed segment saves each rank's half of
    every input, all-gathers them in the backward (one call per input),
    and its gradients equal the plain segment's."""
    rng = np.random.RandomState(4)
    x, w = (rng.randn(*s).astype(np.float32) for s in ((8, 8), (8, 8)))
    ranks = run_ranks(2, [dict(name="p", kind="ckpt_partition", x=x, w=w)],
                      str(tmp_path / "w2"))
    for r in ranks:
        p = r["p"]
        for a, b in zip(p["plain"]["grads"], p["ckpt"]["grads"]):
            np.testing.assert_array_equal(a, b)
        assert p["ckpt"]["saved"] == [(32,), (32,)]
        assert p["ckpt"]["gathers"] == 2 and p["plain"]["gathers"] == 0


def test_checkpoint_function_apply_shim():
    x = torch.ones(2, 2, requires_grad=True)
    out = checkpointing.CheckpointFunction.apply(lambda a: (a * 2.0).sum(),
                                                 x)
    assert float(out.detach()) == 8.0
    out.backward()
    assert torch.equal(x.grad, torch.full((2, 2), 2.0))


def test_model_parallel_manual_seed():
    seed = checkpointing.model_parallel_cuda_manual_seed(1234)
    assert seed == 1234 + 2718 == jckpt.model_parallel_cuda_manual_seed(1234)
    assert "model-parallel-rng" in \
        checkpointing.get_cuda_rng_tracker().get_states()


def test_configure_from_engine_config():
    tds.initialize(model=SimpleModel(8, device="cpu"), device="cpu",
                   config_params={
                       "train_batch_size": 8,
                       "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                       "activation_checkpointing": {
                           "partition_activations": True,
                           "number_checkpoints": 4,
                           "cpu_checkpointing": True}})
    assert checkpointing.is_configured()
    assert checkpointing.PARTITION_ACTIVATIONS and checkpointing.PA_TO_CPU
    assert checkpointing.num_layers == 4
    assert checkpointing._mesh is not None


def test_cpu_checkpointing_grads_match():
    checkpointing.configure(checkpoint_in_cpu=True)
    rng = np.random.RandomState(3)
    x, w = (rng.randn(*s).astype(np.float32) for s in ((4, 8), (8, 8)))

    def seg(x, w):
        return (torch.tanh(x @ w) ** 2).sum()

    plain = _grads(seg, x, w, wrt=(1,))
    ckpt = _grads(checkpointing.checkpoint_wrapped(seg), x, w, wrt=(1,))
    _equal(plain, ckpt)
    jg = jax.grad(lambda x, w: jnp.sum(jnp.tanh(x @ w) ** 2), argnums=1)(
        jnp.asarray(x), jnp.asarray(w))
    _near_jax(ckpt, [jg])
