"""Port parity: int8 KV in deepspeed_tpu_torch against the JAX package, on
the CPU.

- ``quantize_kv`` / ``dequantize_kv`` equal the JAX package's bit for bit
  (codes and scales: the absmax / 127 scale with its 1e-8 floor, a
  division, half-to-even rounding, the clip to +-127);
- the plain versions of K4 (dense int8) and K6 (paged int8) agree with the
  JAX references and with the JAX Pallas kernels run in interpret mode, in
  fp32 within 1e-5, and K6's equals K4's on the gathered plane bit for bit;
- a dense int8 engine emits the JAX int8 engine's greedy streams token for
  token, and the paged int8 engine equals the dense int8 engine exactly,
  greedy and sampled.

Inputs come from numpy with a seed and go to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu.ops.transformer.kernels import decode_attention as jda
from deepspeed_tpu_torch.inference import kv_pool
from deepspeed_tpu_torch.inference.kv_hierarchy import (HierarchySpec,
                                                        KVHierarchy)
from deepspeed_tpu_torch.models import GPT2Config
from deepspeed_tpu_torch.models.generation import as_gencfg
from deepspeed_tpu_torch.ops.transformer.kernels import decode_attention as tda
from tests.test_torch_inference import SERVE, models, port_engine, prompts
from tests.test_torch_paged_kv import paged_layout

torch.set_num_threads(1)

T, D = 256, 64


def _rows(seed):
    """k/v rows with a spread of magnitudes, an all-zero row (the scale
    floor) and values on exact half-quanta (ties of the rounding)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(3, 4, 40, D).astype(np.float32)
    x *= np.float32(10.0) ** rng.randint(-3, 3, size=(3, 4, 40, 1))
    x[0, 0, 0] = 0.0
    # absmax 127, so scale 1: every other element sits on a half-quantum.
    x[1, 1, 1] = np.concatenate([[127.0], np.arange(D - 1) - 30.5])
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_jax_bit_for_bit(dtype):
    x = _rows(0)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jc, js = jda.quantize_kv(jx)
    tc, ts = tda.quantize_kv(tx)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[0, 0, 0]) == np.float32(1e-8)
    jd = jda.dequantize_kv(jc, js, jx.dtype)
    td = tda.dequantize_kv(tc, ts, tx.dtype)
    np.testing.assert_array_equal(td.float().numpy(),
                                  np.asarray(jd.astype(jnp.float32)))


def q8_inputs(s, seed):
    """q and int8 codes/scales of k and v; positions past each row's
    frontier hold large values, quantized like any other row."""
    rng = np.random.RandomState(seed)
    pos = np.asarray({1: [0, 127, 200], 5: [0, 126, T - 5]}[s], np.int32)
    b = pos.size
    q = rng.randn(b, 2, s, D).astype(np.float32)
    k = rng.randn(b, 2, T, D).astype(np.float32)
    v = rng.randn(b, 2, T, D).astype(np.float32)
    stale = (np.arange(T)[None] > pos[:, None] + s - 1)[:, None, :, None]
    k = np.where(stale, 3e4 * np.sign(k), k).astype(np.float32)
    v = np.where(stale, -3e4 * np.sign(v), v).astype(np.float32)
    kc, ks = (np.asarray(a) for a in jda.quantize_kv(jnp.asarray(k)))
    vc, vs = (np.asarray(a) for a in jda.quantize_kv(jnp.asarray(v)))
    return q, kc, vc, ks, vs, pos


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("s", [1, 5])
def test_q8_plain_matches_jax_reference_and_kernel(s):
    q, kc, vc, ks, vs, pos = q8_inputs(s, seed=s)
    got = tda.flash_decode_attention_q8(*_t(q, kc, vc, ks, vs, pos)).numpy()
    jargs = [jnp.asarray(a) for a in (q, kc, vc, ks, vs, pos)]
    want_ref = jda.decode_attention_q8_reference(*jargs)
    want_kernel = jda.flash_decode_attention_q8(*jargs, block_k=128)
    np.testing.assert_allclose(got, np.asarray(want_ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(want_kernel), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("s", [1, 5])
def test_paged_q8_plain_matches_jax_and_dense_q8(s):
    """Codes and scales scattered into a shuffled arena of 128-position
    pages (trash page 0 and one unmapped page full of garbage): the port's
    plain K6 equals its plain K4 on the dense plane bit for bit, and the
    JAX reference and interpret-mode kernel within 1e-5."""
    q, kc, vc, ks, vs, pos = q8_inputs(s, seed=10 + s)
    ak, av, tbl = paged_layout(kc, vc, 128, seed=s)
    aks, avs, _ = paged_layout(ks[..., None], vs[..., None], 128, seed=s)
    aks, avs = aks[..., 0], avs[..., 0]
    got = tda.flash_decode_attention_paged_q8(
        *_t(q, ak, av, aks, avs, tbl, pos)).numpy()
    dense = tda.flash_decode_attention_q8(*_t(q, kc, vc, ks, vs, pos))
    np.testing.assert_array_equal(got, dense.numpy())
    jargs = [jnp.asarray(a) for a in (q, ak, av, aks, avs, tbl, pos)]
    want_ref = jda.decode_attention_paged_q8_reference(*jargs)
    want_kernel = jda.flash_decode_attention_paged_q8(*jargs)
    np.testing.assert_allclose(got, np.asarray(want_ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(want_kernel), atol=1e-5,
                               rtol=0)


def test_q8_wrappers_count_nothing_on_the_cpu_and_check_operands():
    q, kc, vc, ks, vs, pos = _t(*q8_inputs(1, seed=3))
    tda.reset_launches()
    tda.flash_decode_attention_q8(q, kc, vc, ks, vs, pos)
    assert not any(tda.launches.values())
    with pytest.raises(TypeError):      # fp keys where codes belong
        tda.flash_decode_attention_q8(q, kc.float(), vc.float(), ks, vs, pos)
    with pytest.raises(ValueError):     # a scale plane of the wrong length
        tda.flash_decode_attention_q8(q, kc, vc, ks[..., :-1], vs, pos)


def test_int8_pool_layout_and_byte_accounting():
    gcfg = as_gencfg(GPT2Config.tiny(dtype=torch.float32))
    hier = HierarchySpec(int8=True)
    pool = kv_pool.init_pool(gcfg, 3, 16, slack=4, device="cpu", hier=hier)
    assert pool["k"].dtype == torch.int8
    assert pool["k_scale"].shape == pool["k"].shape[:-1]
    assert pool["k_scale"].dtype == torch.float32
    view = kv_pool.slot_cache_view(pool, 2,
                                   torch.tensor([0], dtype=torch.int32))
    assert view["k_scale"] is pool["k_scale"]
    assert view["block_tbl"].tolist() == [[2]]
    view["k_scale"][0, view["block_tbl"][0, 0], 1, 3] = 5.0
    assert pool["k_scale"][0, 2, 1, 3] == 5.0   # the slot's plane, in place
    acct = KVHierarchy(hier, gcfg, 20, 3)
    per_pos = gcfg.n_layer * gcfg.n_head * (2 * 16 + 8)
    assert acct.bytes_per_slot() == per_pos * 20
    assert acct.flat_bytes_per_slot() == \
        gcfg.n_layer * gcfg.n_head * 16 * 4 * 2 * 20
    assert kv_pool.pool_nbytes(pool) >= 3 * acct.bytes_per_slot()


def _serve_staggered(submit, step, run):
    """Four requests, two steps, three more; two sampled."""
    ps = prompts([5, 19, 9, 26, 3, 12, 7], seed=11)
    budgets = [10, 6, 12, 7, 1, 9, 8]
    reqs = []
    for i, (p, n) in enumerate(zip(ps, budgets)):
        if i == 4:
            step()
            step()
        kw = {"temperature": 0.9, "seed": 70 + i} if i in (2, 5) else {}
        reqs.append(submit(p, n, **kw))
    run()
    return reqs


def _greedy_staggered(submit, step, run):
    ps = prompts([5, 19, 9, 26, 3, 12], seed=12)
    budgets = [10, 6, 12, 7, 1, 9]
    reqs = [submit(p, n) for p, n in zip(ps[:3], budgets[:3])]
    step()
    step()
    reqs += [submit(p, n) for p, n in zip(ps[3:], budgets[3:])]
    run()
    return reqs


def test_int8_engine_greedy_streams_match_jax_int8_engine():
    jmodel, params, _ = models()
    jeng = JEngine(jmodel, params, config=dict(
        SERVE, int8_kv=True, use_flash_decode=False, telemetry=False,
        perf_xray=False))
    want = _greedy_staggered(
        lambda p, n: jeng.submit(p, max_new_tokens=n), jeng.step, jeng.run)
    teng = port_engine(int8_kv=True)
    got = _greedy_staggered(
        lambda p, n: teng.submit(p, max_new_tokens=n), teng.step, teng.run)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    m = teng.metrics()
    assert m["int8_kv"] and not m["paged_kv"]
    assert m["kv_bytes_per_slot"] < m["kv_bytes_per_slot_flat"]


def test_paged_int8_engine_equals_dense_int8_greedy_and_sampled():
    def serve(**extra):
        eng = port_engine(int8_kv=True, **extra)
        reqs = _serve_staggered(
            lambda p, n, **kw: eng.submit(p, max_new_tokens=n, **kw),
            eng.step, eng.run)
        return eng, [r.tokens for r in reqs]

    dense, want = serve()
    paged, got = serve(paged_kv=True, kv_page_len=8)
    assert got == want
    assert paged._pool["k"].dtype == torch.int8 and "block_tbl" in paged._pool
    assert paged.kv_page_stats()["pages_in_use"] == 0
    assert paged.metrics()["kv_hbm_bytes"] < \
        port_engine(paged_kv=True, kv_page_len=8).metrics()["kv_hbm_bytes"]
