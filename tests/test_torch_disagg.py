"""Port parity: disaggregated prefill/decode serving (fleet roles and the
KV handoff) against the JAX package's, on the CPU.

The contracts are those of the JAX package's ``test_disagg.py``:

1. ROLES: the per-replica roles validate as the JAX fleet's; the
   router's ``eligible`` mask skips ineligible views before scoring (no
   draw), so an all-mixed fleet routes as before.
2. HANDOFF INVARIANT: new prompts route to the prefill replica, every
   finished prompt migrates to a decode replica, decode replicas never run
   a prefill lane, and every stream equals the single engine's (greedy
   ones the JAX fleet's and the JAX single engine's); the handoff counters
   equal the JAX fleet's. The decode replicas meet only lane-free program
   keys: no capture after warm-up (``recompiles == 0``).
3. EDGES: cancel and a deadline mid-handoff, a rolling drain with
   migrations in flight, the decode target's death mid-handoff (the
   stream replays on the surviving prefill replica, now effective-mixed).
4. THE RECORDS: a handoff record and a prefix row, captured and restored
   on the live pools (dense fp32 and paged int8), byte for byte.
5. REPORT: the loadgen report's ``disagg`` section attributes the
   migrations of a run over a disaggregated fleet.

The JAX wall-clock A/B (decode ITL p99 beating the all-mixed fleet) is
not copied: on a shared host it measures the scheduler. Its docstring's
facts are held instead: zero lost, no fallback, no prefill on a decode
replica.
"""

import time

import numpy as np
import pytest
import torch

import deepspeed_tpu.inference as ji
import deepspeed_tpu_torch.inference as ti
import deepspeed_tpu_torch.loadgen as tl
from deepspeed_tpu_torch.inference.kv_hierarchy import (capture_prefix_pages,
                                                        capture_prefix_row,
                                                        capture_slots,
                                                        capture_slots_paged,
                                                        restore_prefix_pages,
                                                        restore_prefix_row,
                                                        restore_slot,
                                                        restore_slot_paged)
from tests.test_torch_fleet import (GREEDY, MIX_LENS, fleet_of, mix_kw,
                                    reference, single_engine)
from tests.test_torch_inference import prompts

torch.set_num_threads(1)

ROLES = ("prefill", "decode", "decode")


def disagg(pkg, roles=ROLES, **cfg):
    return fleet_of(pkg, n_replicas=len(roles), roles=roles, **cfg)


def _step_until(fleet, rep, pred, max_steps=400):
    """Step ONE replica until ``pred()``: parks a request mid-handoff (the
    donor captures, nobody pumps)."""
    for _ in range(max_steps):
        fleet._step_replica(rep)
        if pred():
            return
    pytest.fail("condition not reached in {} steps".format(max_steps))


# ---------------------------------------------------------------- roles


@pytest.mark.parametrize("n, roles", [
    (1, ("prefill",)), (2, ("prefill", "prefill")), (2, ("mixed",)),
    (2, ("decode", "router"))],
    ids=["lone_prefill", "no_acceptor", "count", "unknown"])
def test_roles_validate_as_jax(n, roles):
    for pkg in ("jax", "port"):
        with pytest.raises(ValueError):
            fleet_of(pkg, n_replicas=n, roles=roles)


def test_router_eligible_skips_score_and_rng():
    """An all-eligible mask routes as no mask (no draw changes); an
    ineligible view is absent and consumed no draw."""
    from types import SimpleNamespace
    views = [SimpleNamespace(slot_occupancy=0.5, queue_depth=1,
                             max_slots=4, health="healthy", name=n)
             for n in "abcd"]
    for mod in (ti, ji):
        plain = [[v.name for v in mod.Router(seed=4).order(views)]
                 for _ in range(3)]
        masked = [[v.name for v in mod.Router(seed=4).order(
            views, eligible=[True] * 4)] for _ in range(3)]
        assert plain == masked
    r_port, r_jax = ti.Router(seed=2), ji.Router(seed=2)
    mask = [True, False, True, True]
    for _ in range(4):
        got = [v.name for v in r_port.order(views, eligible=mask)]
        assert got == [v.name for v in r_jax.order(views, eligible=mask)]
        assert "b" not in got


# ------------------------------------------------------ the invariant


HANDOFF_COUNTERS = ("handoffs", "handoffs_in", "handoff_fallbacks",
                    "tokens_out", "requests_completed")


def test_disagg_streams_and_counters_equal_jax():
    out = {}
    for pkg in ("jax", "port"):
        fleet = disagg(pkg)
        try:
            frs = [fleet.submit(p, **mix_kw(i))
                   for i, p in enumerate(prompts(MIX_LENS))]
            assert all(fr.replica_id == 0 for fr in frs)
            assert fleet.wait_idle(timeout_s=120.0)
            assert all(fr.phase == "done" for fr in frs)
            donor, d1, d2 = (rep.engine for rep in fleet.replicas)
            assert 0 < donor.counters["handoffs"] <= len(frs)
            assert d1.counters["handoffs_in"] + \
                d2.counters["handoffs_in"] == donor.counters["handoffs"]
            assert d1.counters["handoffs_in"] > 0
            assert d2.counters["handoffs_in"] > 0
            assert d1.counters["prefills"] == d2.counters["prefills"] == 0
            assert donor.counters["handoff_bytes_shipped"] > 0
            m = fleet.metrics()["fleet"]
            assert m["roles"] == {0: "prefill", 1: "decode", 2: "decode"}
            assert m["pending_handoffs"] == 0
            assert m["handoffs"] == m["handoffs_in"]
            assert "handoff_latency_seconds" in fleet.prometheus()
            out[pkg] = {"tokens": [fr.tokens for fr in frs],
                        "owners": [fr.replica_id for fr in frs],
                        "counters": {n: fleet.counters[n]
                                     for n in HANDOFF_COUNTERS},
                        "per_replica": [(e.counters["handoffs"],
                                         e.counters["handoffs_in"],
                                         e.counters["prefills"])
                                        for e in (donor, d1, d2)]}
            if pkg == "port":
                # The decode replicas met only lane-free keys.
                for e in (d1, d2):
                    assert all(not key[0] for key in e._programs)
                    assert e.metrics()["prefill_lanes"] == 0
        finally:
            fleet.close()
    assert out["port"]["tokens"] == reference("port")
    jref = reference("jax")
    for i in GREEDY:
        assert out["port"]["tokens"][i] == out["jax"]["tokens"][i] == jref[i]
    for key in ("owners", "counters", "per_replica"):
        assert out["port"][key] == out["jax"][key], key


def test_decode_replica_captures_nothing_after_warm_up():
    """With speculation: a warm-up stream, stepped on one thread, lets
    every replica meet its keys (the prefill replica the two lane keys,
    each decode replica the two lane-free ones); then, on the stepping
    threads, a second stream captures no program anywhere (``recompiles``
    0), and its streams equal the single engine's."""
    cfg = {"spec_decode": True, "spec_k": 2, "spec_ngram": 2}
    fleet = disagg("port", **cfg)
    try:
        for sampled in ({}, {"temperature": 0.7, "seed": 3}):
            # A greedy wave, then a sampled one: least-loaded placement
            # gives each decode replica handoffs of both.
            warm = [fleet.submit(p, max_new_tokens=30, **sampled)
                    for p in prompts([6, 7, 8, 9], seed=8)]
            assert fleet.wait_idle(timeout_s=120.0)
            assert all(fr.phase == "done" for fr in warm)
        keys = [sorted(rep.engine._programs) for rep in fleet.replicas]
        assert keys == [[(True, False, False), (True, True, False)]] + \
            [[(False, False, False), (False, True, False)]] * 2
        for rep in fleet.replicas:
            rep.engine.recompile_detector.mark_warm()
        fleet.start()
        frs = [fleet.submit(p, **mix_kw(i))
               for i, p in enumerate(prompts(MIX_LENS))]
        assert fleet.wait_idle(timeout_s=120.0)
        assert [fr.tokens for fr in frs] == reference("port", **cfg)
        m = fleet.metrics()
        assert all(r["recompiles"] == 0 for r in m["replicas"].values())
        assert m["fleet"]["handoff_fallbacks"] == 0
        assert m["replicas"][1]["prefills"] == \
            m["replicas"][2]["prefills"] == 0
    finally:
        fleet.close()


def test_all_mixed_fleet_never_hands_off():
    fleet = disagg("port", roles=("mixed", "mixed"))
    try:
        frs = [fleet.submit(p, **mix_kw(i))
               for i, p in enumerate(prompts(MIX_LENS[:4]))]
        assert fleet.wait_idle(timeout_s=120.0)
        assert [fr.tokens for fr in frs] == reference("port")[:4]
        m = fleet.metrics()["fleet"]
        assert m["handoffs"] == m["handoffs_in"] == 0
        assert m["roles"] == {0: "mixed", 1: "mixed"}
    finally:
        fleet.close()


# ---------------------------------------------------------------- edges


def test_cancel_reaches_request_mid_handoff():
    fleet = disagg("port", roles=("prefill", "decode"))
    try:
        fr = fleet.submit(prompts([9])[0], max_new_tokens=8)
        _step_until(fleet, fleet.replicas[0],
                    lambda: fleet._handoffs.pending)
        assert fr._req.phase == "handoff"
        assert fleet.cancel(fr) is True
        assert fr.phase == "cancelled"
        assert fleet.wait_idle(timeout_s=30.0)
        assert not fleet.replicas[0].engine._scheduler.handoff
        assert fleet.metrics()["fleet"]["pending_handoffs"] == 0
        assert fleet.replicas[1].engine.counters["handoffs_in"] == 0
    finally:
        fleet.close()


def test_deadline_expiry_mid_handoff_still_completes():
    fleet = disagg("port", roles=("prefill", "decode"))
    try:
        fr = fleet.submit(prompts([9])[0], max_new_tokens=8,
                          deadline_ms=200)
        _step_until(fleet, fleet.replicas[0],
                    lambda: fleet._handoffs.pending)
        time.sleep(0.3)
        assert fleet.wait_idle(timeout_s=30.0)
        assert fr.phase == "done" and len(fr.tokens) == 8
        assert all(rep.engine.counters["deadline_sheds"] == 0
                   for rep in fleet.replicas)
    finally:
        fleet.close()


def test_rolling_drain_prefill_with_inflight_handoffs():
    fleet = disagg("port")
    try:
        frs = [fleet.submit(p, **mix_kw(i))
               for i, p in enumerate(prompts(MIX_LENS))]
        _step_until(fleet, fleet.replicas[0],
                    lambda: fleet._handoffs.pending)
        report = fleet.rolling_drain(timeout_s=60.0)
        assert [r["drained"] for r in report] == [True, True, True]
        assert fleet.wait_idle(timeout_s=120.0)
        assert [fr.tokens for fr in frs] == reference("port")
        assert fleet.health == "healthy"
        fr = fleet.submit(prompts([6])[0], max_new_tokens=3)
        assert fr.replica_id == 0
        assert fleet.wait_idle(timeout_s=60.0)
        assert fr.phase == "done" and len(fr.tokens) == 3
    finally:
        fleet.close()


def test_decode_target_death_mid_handoff_replays_on_the_donor():
    """The only decode replica dies with migrations in flight: the streams
    replay on the surviving prefill replica (capture now off) through the
    orphan path, re-deriving what they delivered; zero lost, streams
    equal to the single engine's (greedy ones the JAX fleet's), and the
    fallback counted as the JAX fleet counts it."""
    out = {}
    for pkg in ("jax", "port"):
        fleet = disagg(pkg, roles=("prefill", "decode"))
        try:
            frs = [fleet.submit(p, **mix_kw(i))
                   for i, p in enumerate(prompts(MIX_LENS[:2]))]
            _step_until(fleet, fleet.replicas[0],
                        lambda: fleet._handoffs.pending)
            fleet.replicas[1].failed = True
            assert fleet.wait_idle(timeout_s=120.0)
            donor = fleet.replicas[0].engine
            assert donor.counters["handoff_fallbacks"] >= 1
            assert donor._handoff_enabled is False
            assert all(fr.phase == "done" for fr in frs)
            assert fleet.replicas[1].engine.counters["handoffs_in"] == 0
            assert fleet.metrics()["fleet"]["pending_handoffs"] == 0
            out[pkg] = ([fr.tokens for fr in frs],
                        donor.counters["handoff_fallbacks"],
                        donor.counters["tokens_out"])
        finally:
            fleet.close()
    assert out["port"][0] == reference("port")[:2]
    assert out["port"][0][0] == out["jax"][0][0]
    assert out["port"][1:] == out["jax"][1:]


# -------------------------------------------------------------- records


def _pool_copy(pool):
    return {name: t.clone() for name, t in pool.items()}


@pytest.mark.parametrize("layout", ["dense_fp32", "paged_int8"])
def test_handoff_and_prefix_records_round_trip_bit_exact(layout):
    """On a live pool mid-run: every decoding slot captured in one
    ``capture_slots`` call, scribbled over and restored in place, and a
    prefix row (dense) or prefix pages (paged) captured and written back:
    the whole pool byte for byte. No pool tensor is rebound."""
    extra = {"prefix_cache": True, "prefix_slots": 2, "prefix_len": 16,
             "min_prefix_len": 4}
    if layout == "paged_int8":
        extra.update(paged_kv=True, kv_page_len=8, int8_kv=True)
    eng = single_engine("port", **extra)
    head = prompts([12], seed=5)[0]
    for i, tail in enumerate(prompts([3, 4, 5], seed=6)):
        eng.submit(np.concatenate([head, tail]), max_new_tokens=20)
    for _ in range(40):
        eng.step()
        live = [r for r in eng._scheduler.running.values()
                if r.phase == "decoding"]
        if len(live) >= 2:
            break
    assert len(live) >= 2
    pool = eng._pool
    addrs = {n: t.data_ptr() for n, t in pool.items()}
    before = _pool_copy(pool)
    slots = [r.slot for r in live]
    pager = eng._pager
    if pager is None:
        records = capture_slots(pool, slots)
    else:
        records = capture_slots_paged(pool, slots,
                                      [pager.row_pages(s) for s in slots])
    for slot in slots:
        at = slot if pager is None else pager.row_pages(slot)
        for name in ("k", "v", "k_scale", "v_scale"):
            if name in pool:
                pool[name][:, at] = 0
        for name in ("pos", "last_tok", "active", "remaining", "toks"):
            if name in pool:
                pool[name][slot] = 0
    for slot, record in zip(slots, records):
        if pager is None:
            restore_slot(pool, slot, record)
        else:
            restore_slot_paged(pool, slot, record, pager.row_pages(slot))
    store = eng._hier.store
    row = next(iter(store.tokens))
    if pager is None:
        prec = capture_prefix_row(pool, row, 12)
        pool["pk"][:, row] = 0
        restore_prefix_row(pool, row, prec)
        pool["pk"][:, row, :, 12:] = before["pk"][:, row, :, 12:]
        if "pk_scale" in pool:
            pool["pk_scale"][:, row, :, 12:] = \
                before["pk_scale"][:, row, :, 12:]
    else:
        pages, span = store.payload[row]
        prec = capture_prefix_pages(pool, pages, span)
        assert prec["pk"].shape[2] == span and prec["pk"].dtype == torch.int8
        for name in ("k", "v", "k_scale", "v_scale"):
            pool[name][:, list(pages)] = 0
        restore_prefix_pages(pool, pages, prec)
        full = span // pager.page_len
        if span % pager.page_len:
            # The straddle page's positions past the span read back as 0;
            # put the rest of that page back before comparing.
            last = pages[full]
            for name in ("k", "v", "k_scale", "v_scale"):
                pool[name][:, last, :, span % pager.page_len:] = \
                    before[name][:, last, :, span % pager.page_len:]
    differ = [n for n, t in pool.items() if not torch.equal(t, before[n])]
    assert not differ
    assert {n: t.data_ptr() for n, t in pool.items()} == addrs
    eng.run()


def test_adopt_handoff_refuses_the_other_layout_and_a_full_pool():
    dense = single_engine("port")
    paged = single_engine("port", paged_kv=True, kv_page_len=8)
    for eng in (dense, paged):
        eng.submit(prompts([6])[0], max_new_tokens=20)
        eng.step()
    req = next(iter(paged._scheduler.running.values()))
    rec = capture_slots_paged(paged._pool, [req.slot],
                              [paged._pager.row_pages(req.slot)])[0]
    spec = {"prompt": req.prompt, "max_new_tokens": req.max_new_tokens,
            "temperature": 0.0, "top_k": 0, "eos_token_id": -1, "seed": 0,
            "spec": False, "deadline": None, "submit_time": None,
            "admit_time": None, "first_token_time": None,
            "tokens": list(req.tokens)}
    assert dense.adopt_handoff(spec, rec) is None
    for _ in range(dense.config.max_slots):
        dense.submit(prompts([6])[0], max_new_tokens=20)
    dense.step()
    drec = capture_slots(dense._pool, [0])[0]
    assert dense.adopt_handoff(spec, drec) is None  # no free slot


# --------------------------------------------------------------- report


def test_loadgen_report_disagg_section_fills_from_a_fleet():
    fleet = disagg("port", start=True, max_queue=64)
    try:
        spec = tl.WorkloadSpec(rate=60.0, n_requests=8, prompt_mean=8,
                               prompt_max=16, output_mean=6, output_max=8,
                               vocab_size=1024, seed=5)
        res = tl.SustainedRunner(fleet, spec, window_seconds=0.1,
                                 max_steps=200_000).run()
        assert res.requests_lost == 0 and res.completed == 8
        rep = tl.build_report(spec, res, tl.SLO(ttft_p99_ms=1e6,
                                                itl_p99_ms=1e6))
        d = rep["disagg"]
        assert d["handoffs"] == fleet.counters["handoffs"] > 0
        assert d["handoff_fallbacks"] == 0
        assert d["handoff_bytes_shipped"] == \
            fleet.counters["handoff_bytes_shipped"] > 0
    finally:
        fleet.close()
