"""Port parity: the paged KV cache in deepspeed_tpu_torch against the JAX
package, on the CPU.

- ``PageAllocator`` driven through the JAX package's allocator sequences
  (lifecycle, copy-on-write and refcounts, the retry hint) holds the same
  table, free list, refcounts and reservations as the JAX allocator after
  every operation;
- the plain version of K5 equals the dense plain version (K3's) on the
  gathered plane bit for bit, and the JAX reference and the JAX Pallas
  kernel (interpret mode, 128-position pages) within 1e-5 in fp32;
- a paged engine (``kv_page_len=8, prefill_chunk=8``) emits the JAX paged
  engine's greedy streams token for token, and the dense engine's greedy
  AND sampled streams exactly, and drains to zero pages in use;
- page-aware admission is strict FIFO; at fewer KV bytes than a 2-slot dense
  pool the paged pool carries at least 3x the concurrent sessions, streams
  unchanged; a request the arena can never hold is refused at submit.

Inputs come from numpy with a seed and go to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu.inference.paging import PageAllocator as JPageAllocator
from deepspeed_tpu.ops.transformer.kernels import decode_attention as jda
from deepspeed_tpu_torch.inference import InferenceConfig, Scheduler, kv_pool
from deepspeed_tpu_torch.inference.paging import TRASH_PAGE, PageAllocator
from deepspeed_tpu_torch.models import GPT2Config
from deepspeed_tpu_torch.models.generation import as_gencfg
from deepspeed_tpu_torch.ops.transformer.kernels import decode_attention as tda
from tests.test_torch_inference import SERVE, models, port_engine, prompts

torch.set_num_threads(1)


def paged_layout(k, v, page_len, seed=11):
    """Scatter dense [B, H, T, ...] planes into a shuffled page arena and
    block table, as the JAX package's paged tests build them: page 0 is the
    trash page, and the arena also holds one page no row maps. Both hold
    large finite garbage, which must never reach a result."""
    b, h, t = k.shape[:3]
    n_lp = t // page_len
    perm = np.random.RandomState(seed).permutation(b * n_lp) + 1
    tbl = perm.reshape(b, n_lp).astype(np.int32)
    shape = (b * n_lp + 2, h, page_len) + k.shape[3:]
    garbage = (np.ones(shape) * (100 if k.dtype == np.int8 else 3e4)
               ).astype(k.dtype)
    arena_k, arena_v = garbage.copy(), -garbage
    for row in range(b):
        for lp in range(n_lp):
            sl = np.s_[:, lp * page_len:(lp + 1) * page_len]
            arena_k[tbl[row, lp]] = k[row][sl]
            arena_v[tbl[row, lp]] = v[row][sl]
    return arena_k, arena_v, tbl


# ---------------------------------------------------- allocator parity


def _state(pg):
    return (pg.table.tolist(), pg.mapped.tolist(), list(pg.free),
            pg.refcount.tolist(), dict(pg.reserved), dict(pg.slot_rid),
            pg.pages_in_use(), pg.available())


def _drive(ctor, ops):
    """Apply ``ops`` to a JAX and a port allocator built alike; after every
    op, the results (or the exception types) and the states must agree."""
    j, t = JPageAllocator(**ctor), PageAllocator(**ctor)
    assert _state(j) == _state(t)
    for name, args, kw in ops:
        outs = []
        for pg in (j, t):
            try:
                outs.append(getattr(pg, name)(*args, **kw))
            except RuntimeError as exc:
                outs.append(type(exc))
        assert outs[0] == outs[1], (name, args, outs)
        assert _state(j) == _state(t), (name, args)
    return t


def test_allocator_lifecycle_matches_jax():
    t = _drive(dict(num_slots=2, pages_per_slot=4, total_pages=6,
                    page_len=8), [
        ("pages_for", (9,), {}), ("reserve", (7, 3), {}),
        ("can_reserve", (4,), {}), ("reserve", (8, 4), {}),
        ("bind_slot", (0, 7), {}), ("ensure_mapped", (0, 12), {}),
        ("ensure_mapped", (0, 12), {}), ("row_pages", (0,), {}),
        ("ensure_mapped", (0, 10_000), {}), ("free_slot", (0,), {}),
        ("release_reservation", (7,), {}),
        ("fragmentation", (0,), {})])
    assert t.pages_free() == 6 and list(t.table[0]) == [TRASH_PAGE] * 4


def test_allocator_cow_and_refcounts_match_jax():
    ops = [("bind_slot", (0, 1), {}), ("ensure_mapped", (0, 8), {})]
    j = JPageAllocator(num_slots=3, pages_per_slot=4, total_pages=8,
                       page_len=4)
    j.bind_slot(0, 1)
    j.ensure_mapped(0, 8)
    shared = j.row_pages(0)
    ops += [("install_shared", (1, shared), {}),
            ("cow_page", (1, shared[1]), {}), ("free_slot", (0,), {}),
            ("free_slot", (1,), {}), ("bind_slot", (2, 9), {}),
            ("ensure_mapped", (2, 4), {}), ("alloc_pages", (3,), {}),
            ("reset", (), {}), ("decref", ([1, 2, 3],), {}),
            ("alloc_pages", (9,), {})]
    t = _drive(dict(num_slots=3, pages_per_slot=4, total_pages=8,
                    page_len=4), ops)
    assert t.pages_free() == 8


def test_allocator_retry_hint_matches_jax():
    ctor = dict(num_slots=1, pages_per_slot=4, total_pages=4, page_len=4)
    _drive(ctor, [("retry_after_s", (2,), {"now": 5.0}),
                  ("bind_slot", (0, 1), {}), ("ensure_mapped", (0, 16), {}),
                  ("free_slot", (0,), {"now": 100.0}),
                  ("retry_after_s", (8,), {"now": 101.0}),
                  ("ensure_mapped", (0, 16), {}),
                  ("retry_after_s", (8,), {"now": 1000.0})])


# ---------------------------------------------------- plain-version parity


T, D = 256, 64


def _inputs(s, seed):
    rng = np.random.RandomState(seed)
    pos = np.asarray({1: [0, 127, 200], 5: [0, 126, T - 5]}[s], np.int32)
    b = pos.size
    q = rng.randn(b, 2, s, D).astype(np.float32)
    k = rng.randn(b, 2, T, D).astype(np.float32)
    v = rng.randn(b, 2, T, D).astype(np.float32)
    stale = (np.arange(T)[None] > pos[:, None] + s - 1)[:, None, :, None]
    return (q, np.where(stale, 3e4, k).astype(np.float32),
            np.where(stale, -3e4, v).astype(np.float32), pos)


@pytest.mark.parametrize("s", [1, 5])
def test_paged_plain_equals_dense_and_matches_jax(s):
    q, k, v, pos = _inputs(s, seed=s)
    ak, av, tbl = paged_layout(k, v, 128, seed=s)
    t = [torch.from_numpy(a) for a in (q, ak, av, tbl, pos)]
    got = tda.flash_decode_attention_paged(*t).numpy()
    dense = tda.flash_decode_attention(*[torch.from_numpy(a)
                                         for a in (q, k, v, pos)])
    np.testing.assert_array_equal(got, dense.numpy())
    jargs = [jnp.asarray(a) for a in (q, ak, av, tbl, pos)]
    np.testing.assert_allclose(
        got, np.asarray(jda.decode_attention_paged_reference(*jargs)),
        atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        got, np.asarray(jda.flash_decode_attention_paged(*jargs)),
        atol=1e-5, rtol=0)


@pytest.mark.parametrize("page_len", [1, 7])
def test_paged_plain_at_odd_page_lengths(page_len):
    """Any page length: a ragged plane (T = 28 keys in pages of 7, or of
    1) gives the dense result bit for bit."""
    rng = np.random.RandomState(page_len)
    q = torch.from_numpy(rng.randn(3, 2, 1, D).astype(np.float32))
    k, v = (rng.randn(3, 2, 28, D).astype(np.float32) for _ in range(2))
    pos = torch.tensor([0, 13, 27], dtype=torch.int32)
    ak, av, tbl = paged_layout(k, v, page_len)
    got = tda.flash_decode_attention_paged(
        q, torch.from_numpy(ak), torch.from_numpy(av),
        torch.from_numpy(tbl), pos)
    want = tda.flash_decode_attention(q, torch.from_numpy(k),
                                      torch.from_numpy(v), pos)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_paged_wrapper_checks_its_table():
    q, k, v, pos = (torch.from_numpy(a) for a in _inputs(1, seed=4))
    ak, av, tbl = (torch.from_numpy(a)
                   for a in paged_layout(k.numpy(), v.numpy(), 128))
    tda.reset_launches()
    tda.flash_decode_attention_paged(q, ak, av, tbl, pos)
    assert not any(tda.launches.values())
    with pytest.raises(ValueError):     # a table row per query row
        tda.flash_decode_attention_paged(q, ak, av, tbl[:2], pos)
    with pytest.raises(ValueError):     # the table is [B, n_lp]
        tda.flash_decode_attention_paged(q, ak, av, tbl[0], pos)


# ------------------------------------------------------------ pool views


def test_paged_pool_layout_and_views():
    gcfg = as_gencfg(GPT2Config.tiny(dtype=torch.float32))
    assert kv_pool.paged_plane_len(1024, 32, 128) == 1152
    pool = kv_pool.init_pool(gcfg, 3, 20, slack=4, device="cpu", page_len=8)
    n_lp = 3                            # 24 positions in 8-position pages
    assert pool["k"].shape == (gcfg.n_layer, 3 * n_lp + 1, gcfg.n_head, 8,
                               16)
    assert pool["block_tbl"].shape == (3, n_lp)
    assert not pool["block_tbl"].any()  # every row on the trash page
    pool["block_tbl"][1] = torch.tensor([4, 2, 7], dtype=torch.int32)
    view = kv_pool.slot_cache_view(pool, 1,
                                   torch.tensor([0], dtype=torch.int32))
    assert view["k"] is pool["k"]
    assert view["block_tbl"].tolist() == [[4, 2, 7]]
    assert kv_pool.cache_view(pool)["block_tbl"] is pool["block_tbl"]
    small = kv_pool.init_pool(gcfg, 3, 20, slack=4, device="cpu",
                              page_len=8, num_pages=4)
    assert small["k"].shape[1] == 5
    assert kv_pool.pool_nbytes(small) < kv_pool.pool_nbytes(pool)


# ---------------------------------------------------------------- engine


def _staggered(submit, step, run, sampled=()):
    ps = prompts([5, 19, 9, 26, 3, 12, 17], seed=21)
    budgets = [10, 6, 12, 7, 1, 9, 11]
    reqs = []
    for i, (p, n) in enumerate(zip(ps, budgets)):
        if i == 3:
            step()
            step()
        kw = {"temperature": 0.8, "top_k": 30, "seed": 90 + i} \
            if i in sampled else {}
        reqs.append(submit(p, n, **kw))
    run()
    return reqs


def test_paged_engine_greedy_streams_match_jax_paged_engine():
    jmodel, params, _ = models()
    jeng = JEngine(jmodel, params, config=dict(
        SERVE, paged_kv=True, kv_page_len=8, use_flash_decode=False,
        telemetry=False, perf_xray=False))
    want = _staggered(lambda p, n: jeng.submit(p, max_new_tokens=n),
                      jeng.step, jeng.run)
    teng = port_engine(paged_kv=True, kv_page_len=8)
    got = _staggered(lambda p, n: teng.submit(p, max_new_tokens=n),
                     teng.step, teng.run)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert teng.kv_page_stats() == jeng.kv_page_stats()


def test_paged_engine_equals_dense_greedy_and_sampled_and_drains():
    def serve(**extra):
        eng = port_engine(**extra)
        reqs = _staggered(
            lambda p, n, **kw: eng.submit(p, max_new_tokens=n, **kw),
            eng.step, eng.run, sampled=(1, 4, 6))
        return eng, [r.tokens for r in reqs]

    dense, want = serve()
    paged, got = serve(paged_kv=True, kv_page_len=8)
    assert got == want
    assert any(len(set(t)) > 1 for t in got)
    st = paged.kv_page_stats()
    assert st["pages_in_use"] == 0 and st["pages_free"] == st["pages_total"]
    assert st["pages_available"] == st["pages_total"]
    assert dense.kv_page_stats() is None
    m = paged.metrics()
    assert m["paged_kv"] is True and m["kv_page_len"] == 8
    assert m["kv_pages_in_use"] == 0 and m["kv_hbm_bytes"] > 0
    assert paged.adapter.cache_spec().kv_page_len == 8
    assert dense.adapter.cache_spec().kv_page_len == 0


def test_pages_map_on_demand_and_the_device_table_follows_the_host():
    eng = port_engine(paged_kv=True, kv_page_len=8)
    req = eng.submit(prompts([19])[0], max_new_tokens=12)
    eng.step()                          # admit + the first 8-token slice
    pg = eng._pager
    assert pg.reserved[req.rid] + pg.mapped[req.slot] == \
        pg.pages_for(19 + 12 + 8)
    assert pg.mapped[req.slot] == 1
    assert eng._pool["block_tbl"].tolist() == pg.table.tolist()
    eng.run()
    assert pg.pages_in_use() == 0 and pg.outstanding() == 0
    assert not pg.table.any()


def test_page_aware_admission_is_strict_fifo():
    s = Scheduler(num_slots=4, max_queue=8)
    for n in (30, 4, 4):
        s.submit(np.zeros(n), 1, 0.0, 0, -1, 0)
    budget = {"pages": 3}

    def gate(req):
        need = -(-req.prompt.size // 8)
        if need > budget["pages"]:
            return False
        budget["pages"] -= need
        return True

    # The head needs 4 pages: refused, and the 1-page followers wait.
    assert s.admissions(gate=gate) == [] and len(s.queue) == 3
    budget["pages"] = 4
    assert [r.rid for r, _ in s.admissions(gate=gate)] == [0]
    # The engine: a head too large for the free pages blocks a follower
    # that would fit them (2 pages free after the first admission).
    eng = port_engine(paged_kv=True, kv_page_len=8, kv_pages=8,
                      max_slots=3)
    big = eng.submit(prompts([30])[0], max_new_tokens=8)   # 6 pages
    head = eng.submit(prompts([20])[0], max_new_tokens=8)  # 5 pages
    small = eng.submit(prompts([3])[0], max_new_tokens=2)  # 2 pages
    eng.step()
    assert big.phase == "prefilling" and head.phase == "queued"
    assert small.phase == "queued"
    eng.run()
    assert big.admit_time < head.admit_time <= small.admit_time
    assert [len(r.tokens) for r in (big, head, small)] == [8, 8, 2]


def test_capacity_pin_three_times_the_dense_sessions_at_fewer_bytes():
    """At fewer KV bytes than a 2-slot dense pool (34 pages of 4 plus the
    trash page: 140 positions against 2 x 72), page-aware admission
    carries >= 3x the dense pool's concurrent sessions; every request
    reserves ceil((4..6 + 6 + 8) / 4) = 5 pages, so 6 run at once. The
    streams are the dense pool's."""
    stream = prompts([4, 5, 6] * 4, seed=7)

    def serve(**extra):
        eng = port_engine(max_len=64, prefill_chunk=8, max_queue=32,
                          **extra)
        reqs = [eng.submit(p, max_new_tokens=6) for p in stream]
        peak = 0
        while not eng.idle:
            eng.step()
            peak = max(peak, len(eng._scheduler.running))
        return eng, reqs, peak

    dense, dense_reqs, dense_peak = serve(max_slots=2)
    paged, paged_reqs, paged_peak = serve(max_slots=8, paged_kv=True,
                                          kv_page_len=4, kv_pages=34)
    assert paged.metrics()["kv_hbm_bytes"] <= dense.metrics()["kv_hbm_bytes"]
    assert dense_peak == 2 and paged_peak >= 3 * dense_peak
    assert [r.tokens for r in paged_reqs] == [r.tokens for r in dense_reqs]
    assert paged.kv_page_stats()["pages_in_use"] == 0


def test_submit_refuses_what_the_arena_can_never_hold():
    eng = port_engine(paged_kv=True, kv_page_len=8, kv_pages=3)
    with pytest.raises(ValueError, match="page"):
        eng.submit(prompts([20], seed=3)[0], max_new_tokens=30)
    eng.submit(prompts([3], seed=3)[0], max_new_tokens=4)   # 2 pages: fits


@pytest.mark.parametrize("bad", [{"kv_page_len": 0}, {"kv_pages": 0}])
def test_config_validates_the_page_settings(bad):
    with pytest.raises(ValueError):
        InferenceConfig.from_dict(dict(paged_kv=True, **bad))
