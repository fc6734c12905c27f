"""Port parity: mixture-of-experts (deepspeed_tpu_torch.moe) against the
JAX package's, on the CPU.

The contracts are those of the JAX package's ``test_moe.py``:

- GATING: ``top1gating`` / ``top2gating`` give the JAX package's dispatch
  exactly and its combine within 1e-6 on the same logits, respect
  capacity (no expert over it, no slot booked twice), drop overflow
  tokens and renormalize the top-2 weights; a ``torch.Generator`` is the
  JAX ``noise_rng``.
- THE LAYER: ``MoE`` on the JAX layer's parameters gives its output within
  1e-5 of the largest absolute value (top-1 and top-2), its aux loss and
  counts; stacked experts carry the leading expert axis; identical
  experts reduce to gate * expert(x); gradients are finite and reach the
  router; ``self.training`` picks the capacity factor (the JAX rng-stream
  inference).
- UTILITIES: expert parameters by path, and the dense / expert split.

The JAX tests that shard experts over a 'model' mesh axis, and the one
that trains an MoE model through the engine, run over gloo ranks in
``test_torch_moe_mesh.py`` and ``test_torch_moe_training.py``; here, a
rank's adapter and its shard of the tree, cut without a process group.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import deepspeed_tpu.moe as jm
from deepspeed_tpu_torch.inference import InferenceConfig
from deepspeed_tpu_torch.inference.adapters import MoEAdapter
from deepspeed_tpu_torch.parallel.mesh import build_mesh
from deepspeed_tpu_torch.moe import (MoE, is_moe_param_path,
                                     split_moe_param_groups, top1gating,
                                     top2gating)
from tests.unit.test_moe import _moe_layer as _jax_layer

torch.set_num_threads(1)

GATES = {"top1": (top1gating, jm.top1gating),
         "top2": (top2gating, jm.top2gating)}


def _logits(s=32, e=4, seed=0):
    return np.random.RandomState(seed).randn(s, e).astype(np.float32)


@pytest.mark.parametrize("gate", ["top1", "top2"])
def test_gating_shapes_and_capacity(gate):
    fn = GATES[gate][0]
    s, e = 32, 4
    k = 1 if gate == "top1" else 2
    l_aux, combine, dispatch, counts = fn(torch.from_numpy(_logits(s, e)),
                                          capacity_factor=1.0)
    cap = max(4, -(-k * s // e))
    assert combine.shape == (s, e, cap) and dispatch.shape == (s, e, cap)
    assert counts.shape == (e,) and counts.dtype == torch.int32
    assert int(counts.max()) <= cap
    assert dispatch.float().sum(dim=0).max() <= 1.0 + 1e-6
    assert (combine[dispatch] > 0).all()
    assert torch.isfinite(l_aux)


@pytest.mark.parametrize("gate", ["top1", "top2"])
@pytest.mark.parametrize("factor,min_cap", [(1.0, 4), (0.5, 1), (2.0, 4),
                                            (4.0, 1)])
def test_gating_equals_jax(gate, factor, min_cap):
    """Dispatch exactly, combine within 1e-6, the aux loss and the counts
    of the JAX gate, at capacities that drop tokens and that do not."""
    port, ref = GATES[gate]
    for seed in range(3):
        lg = _logits(48, 8, seed)
        got = port(torch.from_numpy(lg), capacity_factor=factor,
                   min_capacity=min_cap)
        want = ref(jnp.asarray(lg), capacity_factor=factor,
                   min_capacity=min_cap)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        np.testing.assert_allclose(float(got[0]), float(want[0]),
                                   rtol=1e-6)


def test_gating_used_token_mask_equals_jax():
    lg = _logits(32, 4, 5)
    mask = (np.arange(32) % 3 != 0).astype(np.float32)
    for port, ref in GATES.values():
        got = port(torch.from_numpy(lg), capacity_factor=1.0,
                   used_token_mask=torch.from_numpy(mask))
        want = ref(jnp.asarray(lg), capacity_factor=1.0,
                   used_token_mask=jnp.asarray(mask))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert not got[2][mask == 0].any()


def test_top1_respects_capacity_drop():
    s, e = 16, 4
    logits = torch.tensor([[10.0, 0.0, 0.0, 0.0]]).repeat(s, 1)
    _, combine, dispatch, counts = top1gating(logits, capacity_factor=1.0)
    cap = max(4, s // e)
    assert int(counts[0]) == cap
    token_weight = combine.sum(dim=(1, 2))
    assert int((token_weight == 0).sum()) == s - cap


def test_top2_weights_renormalized():
    _, combine, _, _ = top2gating(torch.from_numpy(_logits(64, 8)),
                                  capacity_factor=2.0)
    w = combine.sum(dim=(1, 2)).numpy()
    full = w[w > 0.99]
    assert len(full) > 0
    np.testing.assert_allclose(full, 1.0, atol=1e-5)


def test_noise_generator_is_the_jax_noise_rng():
    """The Jitter draws and the top-2 Gumbel draws come from the
    generator: the same seed gives the same routing, shapes hold and
    capacity still holds."""
    lg = torch.from_numpy(_logits(32, 4, 9))
    for fn in (top1gating, top2gating):
        a = fn(lg, capacity_factor=1.0,
               noise_rng=torch.Generator().manual_seed(3))
        b = fn(lg, capacity_factor=1.0,
               noise_rng=torch.Generator().manual_seed(3))
        assert torch.equal(a[2], b[2]) and torch.equal(a[1], b[1])
        assert a[2].float().sum(dim=0).max() <= 1.0


# -------------------------------------------------------------- the layer


class _Dense(nn.Module):
    """flax Dense layout: ``kernel`` [in, out], ``bias`` [out]."""

    def __init__(self, n_in, n_out):
        super().__init__()
        self.kernel = nn.Parameter(torch.randn(n_in, n_out) * 0.02)
        self.bias = nn.Parameter(torch.zeros(n_out))

    def forward(self, x):
        return x @ self.kernel + self.bias


class _MLP(nn.Module):
    """The JAX test's expert: Dense(2w) -> tanh GELU -> Dense(w)."""

    def __init__(self, width=16):
        super().__init__()
        self.Dense_0 = _Dense(width, 2 * width)
        self.Dense_1 = _Dense(2 * width, width)

    def forward(self, x):
        return self.Dense_1(F.gelu(self.Dense_0(x), approximate="tanh"))


def _layer(num_experts=4, k=1, **kw):
    return MoE(hidden_size=16, expert=lambda: _MLP(16),
               num_experts=num_experts, k=k, **kw)


def _load_jax(layer, params):
    """The JAX layer's parameters into the port's (same names, same
    layouts)."""
    with torch.no_grad():
        layer.gate.kernel.copy_(torch.from_numpy(
            np.asarray(params["gate"]["kernel"])))
        mlp = params["experts"]["_MLP_0"]
        for name, t in layer.experts.stacked_params().items():
            mod, leaf = name.split(".")
            t.copy_(torch.from_numpy(np.asarray(mlp[mod][leaf])))


@pytest.mark.parametrize("k", [1, 2])
def test_layer_equals_jax(k):
    """The port's layer on the JAX layer's parameters: output within 1e-5
    of the largest absolute value, aux loss and counts equal (eval
    capacity; the JAX layer infers eval from the missing rng stream)."""
    x = np.random.RandomState(4).randn(2, 8, 16).astype(np.float32)
    jl = _jax_layer(num_experts=4, k=k, capacity_factor=1.0)
    params = jl.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    out_j, aux_j, counts_j = jl.apply({"params": params}, jnp.asarray(x))
    layer = _layer(4, k, capacity_factor=1.0).eval()
    _load_jax(layer, params)
    with torch.no_grad():
        out, aux, counts = layer(torch.from_numpy(x))
    out_j = np.asarray(out_j)
    np.testing.assert_allclose(out.numpy(), out_j, rtol=0,
                               atol=1e-5 * np.abs(out_j).max())
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-6)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))


def test_moe_forward_shapes_and_aux():
    layer = _layer()
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 8, 16)
                         .astype(np.float32))
    out, l_aux, counts = layer(x)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert float(l_aux) > 0
    assert int(counts.sum()) <= 2 * 8
    experts = {n: p for n, p in layer.named_parameters()
               if is_moe_param_path(n)}
    assert experts and all(p.shape[0] == 4 for p in experts.values())


def test_identical_experts_match_single_expert():
    # Capacity for every token in eval too (deterministic=True reads
    # eval_capacity_factor): a dropped token would not be the single
    # expert's output, whatever the gate's random weights route.
    layer = _layer(num_experts=4, k=1, capacity_factor=4.0,
                   eval_capacity_factor=4.0).eval()
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 8, 16)
                         .astype(np.float32))
    stacked = layer.experts.stacked_params()
    with torch.no_grad():
        for t in stacked.values():
            t.copy_(t[0:1].expand_as(t))
        out, _, _ = layer(x, deterministic=True)
    single = _MLP(16)
    with torch.no_grad():
        for name, t in stacked.items():
            mod, leaf = name.split(".")
            getattr(getattr(single, mod), leaf).copy_(t[0])
        flat = x.reshape(-1, 16)
        gate1 = torch.softmax(flat @ layer.gate.kernel, dim=-1).max(-1)[0]
        ref = (single(flat) * gate1[:, None]).reshape(x.shape)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_moe_backward_finite_and_router_learns():
    layer = _layer(num_experts=4, k=2, capacity_factor=2.0)
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 8, 16)
                         .astype(np.float32))
    out, l_aux, _ = layer(x)
    (out.pow(2).sum() + 0.01 * l_aux).backward()
    grads = [p.grad for p in layer.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert float(layer.gate.kernel.grad.abs().max()) > 0


def test_moe_infers_training_from_module_mode():
    """``deterministic=None`` follows ``self.training``: training uses
    ``capacity_factor`` (here dropping tokens), eval the eval factor
    (none dropped), as the JAX layer picks from its rng stream."""
    layer = _layer(num_experts=4, k=1, capacity_factor=0.25,
                   eval_capacity_factor=4.0, min_capacity=1)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 16, 16)
                         .astype(np.float32))
    _, _, train_counts = layer.train()(x)
    _, _, eval_counts = layer.eval()(x)
    assert int(eval_counts.sum()) == 32
    assert int(train_counts.sum()) < 32
    jitter = _layer(noisy_gate_policy="Jitter").train()
    with pytest.raises(ValueError, match="generator"):
        jitter(x)
    out, _, _ = jitter(x, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out).all()


def test_split_moe_param_groups():
    layer = _layer()
    dense, expert = split_moe_param_groups(layer)
    assert set(dense) == {"gate.kernel"}
    assert expert and all(is_moe_param_path(n) for n in expert)
    assert len(dense) + len(expert) == len(list(layer.parameters()))
    d2, e2 = split_moe_param_groups(dict(layer.named_parameters()))
    assert set(d2) == set(dense) and set(e2) == set(expert)
    assert is_moe_param_path(("h_0", "experts", "w1"))
    assert not is_moe_param_path("h_0.attn.c_attn.kernel")


def test_expert_sharding_over_a_mesh_is_refused():
    """Over a mesh the adapter is this rank's: ``bind`` carries its model
    context, ``param_shardings`` cuts its shard of the JAX tree (experts
    ``[r E/mp, (r + 1) E/mp)`` on model rank r, every expert without
    expert parallelism; the attention's heads either way). No mesh (or a
    1-wide model axis): nothing is cut."""
    a = MoEAdapter.from_config()
    tree = a.init_params(device="cpu")
    full = {"h_0": {"experts": {"w1": tree.blocks[0].experts.w1.numpy()},
                    "attn": {"c_attn": {
                        "kernel": tree.blocks[0].attn.c_attn.kernel.numpy()}},
                    "router": {"kernel":
                               tree.blocks[0].router.kernel.numpy()}}}
    assert a.param_shardings(None, full) is None
    for rank in range(2):
        mesh = build_mesh(num_mp=2, world_size=2, rank=rank)
        bound = a.bind(InferenceConfig(), mesh)
        assert bound.tp.size == 2 and bound.tp.rank == rank
        assert bound.gcfg == a.gcfg
        got = bound.param_shardings(mesh, full)["h_0"]
        np.testing.assert_array_equal(
            got["experts"]["w1"], full["h_0"]["experts"]["w1"][
                2 * rank:2 * rank + 2])
        assert got["attn"]["c_attn"]["kernel"].shape == (32, 48)
        np.testing.assert_array_equal(got["router"]["kernel"],
                                      full["h_0"]["router"]["kernel"])
        off = a.bind(InferenceConfig(expert_parallel=False), mesh)
        assert not off.expert_parallel and off.gcfg == a.gcfg
        np.testing.assert_array_equal(
            off.param_shardings(mesh, full)["h_0"]["experts"]["w1"],
            full["h_0"]["experts"]["w1"])
        weights = bound.prepare_params(tree, "cpu")
        assert tuple(weights.blocks[0].experts.w1.shape) == (2, 32, 128)
        assert weights.blocks[0].experts.tp.rank == rank
    assert a.bind(InferenceConfig(), build_mesh(world_size=2, rank=0)) \
        .tp is None
