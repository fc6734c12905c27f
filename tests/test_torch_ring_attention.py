"""Port parity for ring and Ulysses attention: four gloo ranks on the CPU
(one launch of ``tests/torch_dist_worker.py`` through the port's launcher)
against the JAX package's ring and Ulysses under ``shard_map`` on four of
the conftest's virtual devices, and against dense attention.

Inputs are numpy from a seed: q, k, v and dO ``[B, H, T, D]``, an additive
key mask (0 keep, -1e9 drop). Each rank holds its shard (tokens over
'seq', the batch over 'data'); the shards of the output and of dq, dk, dv
are put back together and held, with dO as the cotangent, against
autograd through the port's ``mha_reference`` on the full sequence, and
(``JAX_CASES``: causal and full, masked, ragged, Ulysses, the grid)
against the JAX package's ring or Ulysses.

Tolerance: every tensor within 1e-5 of its max-abs (fp32). The ragged
shards (T = 96 over four ranks: 24 keys a shard) are the lengths the JAX
ring sends to its dense per-block path (tiles of 16); the port's kernels
take any length, and on the CPU both compute the same dense function. A
row whose keys are all masked is held only to be finite, as in JAX.

Also: the collectives each rank runs (ring shifts of k/v, of the mask and
of dk/dv; Ulysses' all-to-alls) against the schedule's counts and bytes,
the refusal of heads that do not divide by the line, a dp 2 x sp 2 grid,
``sequence_parallel_attention`` on global tensors, and on one process the
logsumexp merge and the lse outputs against JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from deepspeed_tpu.ops.transformer import ring_attention as jring
from deepspeed_tpu.ops.transformer.kernels.attention import (
    flash_attention_with_lse as jflash_lse)
from deepspeed_tpu.utils.jax_compat import shard_map
from tests.torch_dist_worker import start_ranks, wait_ranks
from tests.unit.test_ring_attention import _shard_map_ulysses

from deepspeed_tpu_torch.ops.transformer import ring_attention as tring
from deepspeed_tpu_torch.ops.transformer.kernels.attention import (
    flash_attention_with_lse, mha_reference)

torch.set_num_threads(1)

TOL = 1e-5
WORLD = 4
B, H, T, D = 2, 4, 64, 16
BLOCK = 16  # the JAX kernels' tiles


def _inputs(seed, t=T, h=H):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, h, t, D).astype(np.float32) for _ in range(4))


def _mask(seed, t=T, full_row=False):
    rng = np.random.RandomState(seed)
    m = np.where(rng.rand(B, t) > 0.2, 0.0, -1e9).astype(np.float32)
    if full_row:
        m[0, :] = -1e9
    return m


# name: (mode, causal, seed, T, mask, seq ranks, heads)
CASES = {
    "ring_full": ("ring", False, 0, T, None, WORLD, H),
    "ring_causal": ("ring", True, 1, T, None, WORLD, H),
    "ring_mask_full": ("ring", False, 2, T, "mask", WORLD, H),
    "ring_mask_causal": ("ring", True, 3, T, "mask", WORLD, H),
    "ring_ragged_full": ("ring", False, 4, 96, None, WORLD, H),
    "ring_ragged_causal": ("ring", True, 5, 96, None, WORLD, H),
    "ring_ragged_masked_row": ("ring", False, 6, 96, "full_row", WORLD, H),
    "uly_full": ("ulysses", False, 7, T, None, WORLD, H),
    "uly_causal": ("ulysses", True, 8, T, None, WORLD, H),
    "uly_mask": ("ulysses", False, 9, T, "mask", WORLD, H),
    "uly_indivisible": ("ulysses", False, 10, T, None, WORLD, 2),
    "ring_grid": ("ring", True, 11, T, None, 2, H),
}


def _case_arrays(name):
    mode, causal, seed, t, mask, sp, h = CASES[name]
    q, k, v, do = _inputs(seed, t, h)
    m = None if mask is None else _mask(seed + 100, t,
                                        full_row=mask == "full_row")
    return q, k, v, do, m


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = []
    for name, (mode, causal, _, _, _, sp, _) in CASES.items():
        q, k, v, do, m = _case_arrays(name)
        cases.append(dict(name=name, mode=mode, causal=causal, sp=sp, q=q,
                          k=k, v=v, do=do, mask=m))
    hq, hk, hv, _ = _inputs(20)
    tasks = [dict(name="attn", kind="ring", cases=cases,
                  helper=dict(sp=WORLD, mode="ring", q=hq, k=hk, v=hv))]
    root = tmp_path_factory.mktemp("ring")
    return [r["attn"] for r in wait_ranks(start_ranks(WORLD, tasks,
                                                      str(root / "w4")))]


def _assemble(ranks, name):
    """The global output and (dq, dk, dv) from every rank's shards."""
    mode, causal, seed, t, mask, sp, h = CASES[name]
    dp = WORLD // sp
    shape = (B, h, t, D)
    o, grads = np.zeros(shape, np.float32), [np.zeros(shape, np.float32)
                                             for _ in range(3)]
    for r in ranks:
        e = r[name]
        bs, ts = B // dp, t // sp
        sl = (slice(e["dp_rank"] * bs, (e["dp_rank"] + 1) * bs), slice(None),
              slice(e["sp_rank"] * ts, (e["sp_rank"] + 1) * ts))
        o[sl] = e["o"]
        for g, part in zip(grads, e["grads"]):
            g[sl] = part
    return o, grads


def _dense(name):
    """Autograd through the port's dense reference on the full sequence."""
    mode, causal, *_ = CASES[name]
    q, k, v, do, m = _case_arrays(name)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = mha_reference(*leaves, mask=None if m is None else
                      torch.from_numpy(m), causal=causal)
    grads = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    return o.detach().numpy(), [g.numpy() for g in grads]


def _jax(name):
    """The JAX package's ring (or Ulysses) on a mesh of the same shape."""
    mode, causal, seed, t, mask, sp, h = CASES[name]
    q, k, v, do, m = (None if x is None else jnp.asarray(x)
                      for x in _case_arrays(name))
    devices = np.array(jax.devices()[:WORLD])
    if sp == WORLD:
        mesh = Mesh(devices, ("seq",))
        if mode == "ring":
            def fn(q, k, v):
                return jring.sequence_parallel_attention(
                    mesh, q, k, v, axis_name="seq", causal=causal, mask=m,
                    block_q=BLOCK, block_k=BLOCK)
        else:
            def fn(q, k, v):
                return _shard_map_ulysses(mesh, q, k, v, mask=m,
                                          causal=causal, block_q=BLOCK,
                                          block_k=BLOCK)
    else:
        mesh = Mesh(devices.reshape(WORLD // sp, sp), ("data", "seq"))
        spec = P("data", None, "seq", None)
        fn = shard_map(functools.partial(
            jring.ring_flash_attention, axis_name="seq", causal=causal,
            block_q=BLOCK, block_k=BLOCK), mesh=mesh,
            in_specs=(spec, spec, spec), out_specs=spec, check_vma=False)
    o, vjp = jax.vjp(fn, q, k, v)
    return np.asarray(o), [np.asarray(g) for g in vjp(do)]


def _close(got, want, rows=slice(None)):
    got, want = np.asarray(got)[rows], np.asarray(want)[rows]
    limit = TOL * max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= limit, \
        (np.abs(got - want).max(), limit)


# The cases also held to the JAX package's ring or Ulysses (each a JAX
# compile of its own); every case is held to dense attention.
JAX_CASES = ("ring_causal", "ring_mask_full", "ring_ragged_causal",
             "ring_ragged_masked_row", "uly_causal", "uly_mask", "ring_grid")


def _held(ranks, name, rows=slice(None)):
    o, grads = _assemble(ranks, name)
    refs = [_dense(name)] + ([_jax(name)] if name in JAX_CASES else [])
    for want_o, want_g in refs:
        _close(o, want_o, rows)
        for g, w in zip(grads, want_g):
            _close(g, w, rows)
    return o, grads


def test_merge_matches_jax():
    rng = np.random.RandomState(0)
    o_a, o_b = (rng.randn(2, 3, 5, 4).astype(np.float32) for _ in range(2))
    lse_a = rng.randn(2, 3, 5, 1).astype(np.float32)
    lse_b = np.where(rng.rand(2, 3, 5, 1) > 0.3,
                     rng.randn(2, 3, 5, 1), -1e30).astype(np.float32)
    got = tring._merge(*(torch.from_numpy(x) for x in (o_a, lse_a, o_b,
                                                       lse_b)))
    want = jring._merge(*(jnp.asarray(x) for x in (o_a, lse_a, o_b, lse_b)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_with_lse_matches_jax():
    q, k, v, _ = _inputs(30)
    o, lse = flash_attention_with_lse(*(torch.from_numpy(x)
                                        for x in (q, k, v)), causal=True)
    jo, jlse = jflash_lse(*(jnp.asarray(x) for x in (q, k, v)), causal=True,
                          block_q=BLOCK, block_k=BLOCK)
    _close(o.numpy(), jo)
    _close(lse.numpy(), jlse)


def test_lse_cotangent_matches_jax():
    """Gradients through the lse output (the ring's merge needs them)."""
    q, k, v, do = _inputs(31)
    dlse = np.random.RandomState(32).randn(B, H, T, 1).astype(np.float32)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o, lse = flash_attention_with_lse(*leaves, causal=True)
    got = torch.autograd.grad((o, lse), leaves, (torch.from_numpy(do),
                                                 torch.from_numpy(dlse)))

    def fn(q, k, v):
        return jflash_lse(q, k, v, causal=True, block_q=BLOCK,
                          block_k=BLOCK)

    _, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("name", ["ring_full", "ring_causal",
                                  "ring_mask_full", "ring_mask_causal"])
def test_ring_matches_jax(ranks, name):
    _held(ranks, name)


@pytest.mark.parametrize("name", ["ring_ragged_full", "ring_ragged_causal"])
def test_ring_ragged_shards(ranks, name):
    """Shards of 24 keys: JAX's dense per-block path, the port's kernels'
    plain versions."""
    _held(ranks, name)


def test_ring_ragged_with_fully_masked_row(ranks):
    """A fully padded sequence keeps every gradient finite; the others
    match JAX and dense attention."""
    o, grads = _held(ranks, "ring_ragged_masked_row", rows=slice(1, None))
    for x in [o] + grads:
        assert np.isfinite(x).all()


@pytest.mark.parametrize("name", ["uly_full", "uly_causal", "uly_mask"])
def test_ulysses_matches_jax(ranks, name):
    _held(ranks, name)


def test_ulysses_rejects_indivisible_heads(ranks):
    for r in ranks:
        assert "divisible" in r["uly_indivisible"]["error"]
    q, k, v, _ = _inputs(0, h=2)
    with pytest.raises(ValueError, match="divisible"):
        _shard_map_ulysses(Mesh(np.array(jax.devices()[:WORLD]), ("seq",)),
                           *(jnp.asarray(x) for x in (q, k, v)))


def test_ring_in_data_seq_grid(ranks):
    """dp 2 x sp 2: the batch over 'data', the ring over 'seq'."""
    _held(ranks, "ring_grid")


def test_collectives_follow_the_schedule(ranks):
    """Per rank and call, the ring shifts k/v (stacked) N - 1 times forward
    and N - 1 times backward, the mask beside them, and dk/dv (fp32,
    stacked) N times; Ulysses runs one all-to-all each way forward and
    backward, the mask gathered once. Bytes are what the rank hands over."""
    n = WORLD
    plane = B * H * (T // n) * D * 4
    mask_b = B * (T // n) * 4
    for r in ranks:
        full, masked = r["ring_full"], r["ring_mask_full"]
        assert full["fwd"]["ring_shift"] == n - 1
        assert full["fwd"]["ring_shift_bytes"] == (n - 1) * 2 * plane
        assert full["all"]["ring_shift"] == 2 * (n - 1) + n
        assert full["all"]["ring_shift_bytes"] == \
            2 * (n - 1) * 2 * plane + n * 2 * plane
        assert masked["all"]["ring_shift"] == 4 * (n - 1) + n
        assert masked["all"]["ring_shift_bytes"] == \
            full["all"]["ring_shift_bytes"] + 2 * (n - 1) * mask_b
        uly = r["uly_mask"]
        assert uly["all"]["all_to_all"] == 4 and uly["all"]["ring_shift"] == 0
        assert uly["fwd"]["all_to_all_bytes"] == 3 * plane + plane
        assert uly["fwd"]["all_gather"] == 1


def test_sequence_parallel_attention_gathers_the_global_output(ranks):
    q, k, v, _ = _inputs(20)
    want = mha_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                         causal=True).numpy()
    for r in ranks:
        _close(r["helper"], want)


def test_get_sp_attention_modes():
    assert tring.get_sp_attention("ring") is tring.ring_flash_attention
    assert tring.get_sp_attention("ulysses") is tring.ulysses_attention
    for get in (tring.get_sp_attention, jring.get_sp_attention):
        with pytest.raises(ValueError, match="sequence_parallel_mode"):
            get("tree")
    # Without a seq line both are flash attention on the whole sequence.
    q, k, v, _ = _inputs(33)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    for fn in (tring.ring_flash_attention, tring.ulysses_attention):
        _close(fn(*args, None, causal=True).numpy(),
               mha_reference(*args, causal=True).numpy())
