"""Port parity: deepspeed_tpu_torch.models.heads.chunked_tied_softmax_xent
against the JAX package's, on the CPU, in fp32.

The same numpy hidden states, tied embedding, labels and decoder bias go
through both; the loss and the gradients of x, wte and bias must agree
within 1e-5 relative to each tensor's max-abs. Cases: every token
supervised (GPT-2's head) over one and several chunks, and BERT's head
(-1-ignored labels with a decoder bias); both reductions; the remat head
against the eager head and the JAX remat head, fp32 and bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import heads as jheads
from deepspeed_tpu_torch.models import heads as theads

torch.set_num_threads(1)

TOL = 1e-5
B, T, C, V = 2, 24, 32, 300


def _inputs(bias, ignore, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, C).astype(np.float32)
    wte = (0.2 * rng.randn(V, C)).astype(np.float32)
    labels = rng.randint(0, V, size=(B, T))
    if ignore:
        labels[rng.rand(B, T) < 0.4] = -1
    b = (0.1 * rng.randn(V)).astype(np.float32) if bias else None
    return x, wte, labels, b


def _close(got, want):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=0)


@pytest.mark.parametrize("chunk", [2048, 16])
@pytest.mark.parametrize("bias,ignore", [(False, False), (True, True)])
def test_loss_and_grads_match_jax(chunk, bias, ignore):
    x, wte, labels, b = _inputs(bias, ignore)
    ignore_index = -1 if ignore else None

    def jloss(x_, w_, b_):
        return jheads.chunked_tied_softmax_xent(
            x_, w_, jnp.asarray(labels), jnp.float32, chunk=chunk, bias=b_,
            ignore_index=ignore_index)

    args = (jnp.asarray(x), jnp.asarray(wte),
            None if b is None else jnp.asarray(b))
    argnums = (0, 1, 2) if bias else (0, 1)
    want, jgrads = jax.value_and_grad(jloss, argnums=argnums)(*args)

    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, wte)]
    tb = None if b is None else torch.from_numpy(b).requires_grad_()
    loss = theads.chunked_tied_softmax_xent(
        leaves[0], leaves[1], torch.from_numpy(labels), torch.float32,
        chunk=chunk, bias=tb, ignore_index=ignore_index)
    loss.backward()
    _close(loss.detach().numpy(), np.asarray(want))
    got = [leaves[0].grad, leaves[1].grad] + ([tb.grad] if bias else [])
    for g, w in zip(got, jgrads):
        _close(g.numpy(), np.asarray(w))


def test_sum_count_and_no_grad_forward():
    x, wte, labels, b = _inputs(True, True, seed=1)
    tx, tw, tl, tb = (torch.from_numpy(a) for a in (x, wte, labels, b))
    total, count = theads.chunked_tied_softmax_xent(
        tx, tw, tl, torch.float32, chunk=16, bias=tb, ignore_index=-1,
        reduction="sum_count")
    jt, jc = jheads.chunked_tied_softmax_xent(
        jnp.asarray(x), jnp.asarray(wte), jnp.asarray(labels), jnp.float32,
        chunk=16, bias=jnp.asarray(b), ignore_index=-1,
        reduction="sum_count")
    _close(total.numpy(), np.asarray(jt))
    assert float(count) == float(jc)
    with torch.no_grad():
        mean = theads.chunked_tied_softmax_xent(tx, tw, tl, torch.float32,
                                                bias=tb, ignore_index=-1)
    _close(mean.numpy(), np.asarray(jt / jc))


# Remat against eager and against the JAX remat head: fp32 within TOL; bf16
# (x and wte bf16, fp32 accumulation) within two bf16 ulps (2**-7) of each
# tensor's max-abs: dx and dW are rounded to bf16 in both heads, and the
# remat head sums the chunks' dW in bf16 (as the JAX scan's transpose
# does) where the eager head sums them in fp32.
REMAT_TOL = {"fp32": TOL, "bf16": 2.0 ** -7}


@pytest.mark.parametrize("chunk", [2048, 16])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_remat_head_matches_eager_and_jax(chunk, precision):
    x, wte, labels, b = _inputs(True, True, seed=2)
    tdt = torch.float32 if precision == "fp32" else torch.bfloat16
    jdt = jnp.float32 if precision == "fp32" else jnp.bfloat16

    def jloss(x_, w_, b_):
        return jheads.chunked_tied_softmax_xent(
            x_.astype(jdt), w_.astype(jdt), jnp.asarray(labels), jdt,
            chunk=chunk, bias=b_, ignore_index=-1, impl="remat")

    want, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(wte), jnp.asarray(b))
    runs = {}
    for impl in ("remat", "eager"):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (x, wte, b)]
        loss = theads.chunked_tied_softmax_xent(
            leaves[0].to(tdt), leaves[1].to(tdt), torch.from_numpy(labels),
            tdt, chunk=chunk, bias=leaves[2], ignore_index=-1, impl=impl)
        loss.backward()
        runs[impl] = [loss.detach()] + [t.grad for t in leaves]
    tol = REMAT_TOL[precision]
    remat, eager = runs["remat"], runs["eager"]
    np.testing.assert_allclose(float(remat[0]), float(want), rtol=TOL)
    for got, ref, jref in zip(remat[1:], eager[1:], jgrads):
        for other in (ref.numpy(), np.asarray(jref, np.float32)):
            scale = max(float(np.abs(other).max()), 1e-30)
            np.testing.assert_allclose(got.numpy(), other,
                                       atol=tol * scale, rtol=0)


def test_head_impl_selection(monkeypatch):
    """impl= or DS_TPU_XE_HEAD picks the head; remat keeps no gradient from
    the forward (its backward recomputes the chunk); unknown names raise."""
    x, wte, labels, _ = _inputs(False, False)
    args = (torch.from_numpy(x), torch.from_numpy(wte).requires_grad_(),
            torch.from_numpy(labels), torch.float32)
    eager = theads.chunked_tied_softmax_xent(*args, chunk=16)
    remat = theads.chunked_tied_softmax_xent(*args, chunk=16, impl="remat")
    assert _node_names(remat.grad_fn).count("_RematChunkXEBackward") == 3
    assert "_RematChunkXEBackward" not in _node_names(eager.grad_fn)
    assert float(remat) == pytest.approx(float(eager), rel=TOL)
    monkeypatch.setenv("DS_TPU_XE_HEAD", "remat")
    env = theads.chunked_tied_softmax_xent(*args, chunk=16)
    assert float(env) == float(remat)
    monkeypatch.setenv("DS_TPU_XE_HEAD", "fused")
    with pytest.raises(ValueError, match="eager|remat"):
        theads.chunked_tied_softmax_xent(*args)


def _node_names(fn):
    """Class names of every node of an autograd graph."""
    seen, stack, names = set(), [fn], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        stack.extend(nxt for nxt, _ in node.next_functions)
    return names
