"""Port parity: the fleet-global prefix cache (kv_hierarchy
.prefix_directory, prefix-affinity routing, cross-replica row adoption)
against the JAX package's, on the CPU.

The contracts are those of the JAX package's ``test_fleet_prefix.py``:

1. DIRECTORY: sync (version-gated publish), add, match, holders,
   invalidate and the snapshot equal the JAX directory's on the same
   script.
2. AFFINITY: the router folds the matched depth into its score as the JAX
   router does; a holder wins the route at comparable load.
3. ADOPTION: a cold replica that wins on load adopts the holder's row
   (``export_prefix`` / ``adopt_prefix``; int8 codes as stored) instead
   of prefilling it, both ends re-validating against their live store;
   the adopted row is byte for byte the donor's, dense and paged int8.
4. THE A/B: on a template-heavy stream over three replicas, affinity on
   against off: hits, misses, adoptions, affinity routes and prefilled
   tokens equal the JAX fleet's on both sides, the on side's hit rate at
   least twice the off side's, every stream equal to the single engine's.
5. FAILOVER: killing the holder mid-stream invalidates its entries, its
   orphans replay on survivors (zero lost, streams equal), and the
   directory re-warms from the survivors.
"""

import types

import numpy as np
import pytest
import torch

import deepspeed_tpu.inference as ji
import deepspeed_tpu_torch.inference as ti
from deepspeed_tpu.inference.kv_hierarchy import \
    PrefixDirectory as JDirectory
from deepspeed_tpu_torch.inference.kv_hierarchy import PrefixDirectory
from tests.test_torch_fleet import fleet_of, single_engine
from tests.test_torch_telemetry import _parse_prom

torch.set_num_threads(1)

PREFIX = dict(max_slots=2, prefix_cache=True, prefix_slots=4, prefix_len=16,
              min_prefix_len=4)


def pfleet(pkg, n_replicas=3, **cfg):
    return fleet_of(pkg, n_replicas=n_replicas, **dict(PREFIX, **cfg))


def template_requests(n=24, n_templates=4, template_len=12, seed=5,
                      max_new=None):
    """The JAX tests' template-heavy stream: shared heads, short unique
    tails, greedy and sampled interleaved."""
    rng = np.random.RandomState(seed)
    templates = rng.randint(0, 1024, size=(n_templates, template_len))
    reqs = []
    for i in range(n):
        tail = rng.randint(0, 1024, size=3 + (i % 4))
        prompt = np.concatenate([templates[i % n_templates], tail])
        kw = {"max_new_tokens": (3 + (i % 3) if max_new is None
                                 else max_new + (i % 3))}
        if i % 2:
            kw["temperature"] = 0.7
            kw["seed"] = 300 + i
        reqs.append((prompt.astype(np.int32), kw))
    return reqs


_ORACLE = {}


def oracle(reqs, **cfg):
    """The port's single engine on the same stream (memoized)."""
    key = (tuple((tuple(int(t) for t in p), tuple(sorted(kw.items())))
                 for p, kw in reqs), tuple(sorted(cfg.items())))
    if key not in _ORACLE:
        eng = single_engine("port", **dict(PREFIX, **cfg))
        hs = [eng.submit(p, **kw) for p, kw in reqs]
        eng.run()
        _ORACLE[key] = [list(h.tokens) for h in hs]
    return _ORACLE[key]


def greedy(reqs, tokens):
    return [t for (_, kw), t in zip(reqs, tokens) if "temperature" not in kw]


# ------------------------------------------------------------ directory


def _directory_script(cls):
    d = cls()
    out = [d.sync(0, [(1, 2, 3, 4), (9, 9)]),
           d.sync(0, [(9, 9), (1, 2, 3, 4)]), d.sync(1, [(1, 2, 7)]),
           len(d), d.match([1, 2, 3, 4, 5]), d.match([7, 7]),
           d.holders([1, 2, 3, 4]), sorted(d.holders([1, 2]))]
    d.add(1, (1, 2, 3, 4))
    d.add(1, (1, 2, 3, 4))
    out += [d.match([1, 2, 3, 4]), d.snapshot(), d.invalidate(0),
            d.invalidate(0), d.match([1, 2, 3, 4]), d.snapshot()]
    d.sync(0, [(1, 2)])
    out.append(d.match([1, 2, 3]))
    d.sync(2, [(5, 6, 7, 8, 9)])
    out += [d.match([5, 6, 7, 1, 1]), d.holders([5, 6, 7, 8, 9, 9])]
    return out


def test_prefix_directory_equals_jax():
    got = _directory_script(PrefixDirectory)
    assert got == _directory_script(JDirectory)
    assert got[4] == {0: 4, 1: 2} and got[8] == {0: 4, 1: 4}
    assert got[-2] == {2: 3} and got[-1] == []


def _view(occ, q, slots=4, health="healthy"):
    return types.SimpleNamespace(slot_occupancy=occ, queue_depth=q,
                                 max_slots=slots, health=health)


def test_router_affinity_blends_as_jax():
    cold, warm = _view(0.5, 0), _view(0.75, 0)
    packed = _view(1.0, 4, slots=4)
    dead = _view(0.0, 0, health="dead")
    for mod in (ti, ji):
        r = mod.Router(seed=3)
        assert r.order([cold, warm]) == [cold, warm]
        assert r.order([cold, warm], affinity=[0.0, 1.0]) == [warm, cold]
        assert r.order([cold, packed], affinity=[0.0, 1.0]) == \
            [cold, packed]
        assert r.order([dead, warm], affinity=[1.0, 0.0]) == [warm, dead]


# ------------------------------------------------------------- adoption


def _sticky_then_adopt(pkg):
    fleet = pfleet(pkg, n_replicas=2)
    try:
        rng = np.random.RandomState(2)
        head = rng.randint(0, 1024, size=12)

        def req(tail_seed):
            tail = np.random.RandomState(tail_seed).randint(0, 1024, size=4)
            return np.concatenate([head, tail]).astype(np.int32)

        frs = [fleet.submit(req(0), max_new_tokens=3)]
        assert fleet.wait_idle(timeout_s=60.0)
        warm = frs[0].replica_id
        for s in range(1, 4):
            frs.append(fleet.submit(req(s), max_new_tokens=3))
            assert fleet.wait_idle(timeout_s=60.0)
        assert all(fr.replica_id == warm for fr in frs)
        burst = [fleet.submit(req(10 + s), max_new_tokens=3)
                 for s in range(6)]
        assert fleet.wait_idle(timeout_s=60.0)
        frs += burst
        assert {fr.replica_id for fr in burst} == {0, 1}
        snap = fleet.metrics()["fleet"]["prefix_directory"]
        assert set(snap["rows"]) == {0, 1}
        c = fleet.counters
        return ([fr.tokens for fr in frs], [fr.replica_id for fr in frs],
                {n: c[n] for n in ("affinity_routed", "prefix_adoptions",
                                   "prefix_hits", "prefix_misses",
                                   "prefix_bytes_shipped",
                                   "prefill_tokens")})
    finally:
        fleet.close()


def test_submit_sticks_to_holder_then_cold_replica_adopts_as_jax():
    port, jax_ = _sticky_then_adopt("port"), _sticky_then_adopt("jax")
    assert port[0] == jax_[0] and port[1] == jax_[1]
    counts, jcounts = port[2], jax_[2]
    assert counts["affinity_routed"] >= 3
    assert counts["prefix_adoptions"] >= 1
    assert counts["prefix_misses"] == 1
    for name in ("affinity_routed", "prefix_adoptions", "prefix_hits",
                 "prefix_misses", "prefill_tokens"):
        assert counts[name] == jcounts[name], name
    assert counts["prefix_bytes_shipped"] > 0


@pytest.mark.parametrize("layout", ["dense_fp32", "paged_int8"])
def test_export_adopt_validate_against_live_store(layout):
    extra = {} if layout == "dense_fp32" else {
        "paged_kv": True, "kv_page_len": 8, "int8_kv": True}
    fleet = pfleet("port", n_replicas=2, **extra)
    try:
        rng = np.random.RandomState(4)
        head = rng.randint(0, 1024, size=12)
        prompt = np.concatenate([head, rng.randint(0, 1024, size=4)])
        fr = fleet.submit(prompt, max_new_tokens=3)
        assert fleet.wait_idle(timeout_s=60.0)
        holder = fleet.replicas[fr.replica_id].engine
        other = fleet.replicas[1 - fr.replica_id].engine
        toks = [int(t) for t in prompt[:12]]
        matched, record = holder.export_prefix(toks)
        assert list(matched) == toks[:len(matched)]
        assert all(v.shape[2] == len(matched) for v in record.values())
        if extra:
            assert record["pk"].dtype == torch.int8
            assert record["pk_scale"].dtype == torch.float32
        assert other.adopt_prefix(matched, record)
        row, depth = other._hier.store.lookup(list(matched))
        assert depth == len(matched)
        again, _ = other.export_prefix(list(matched))
        assert tuple(again) == tuple(matched)
        back = other.export_prefix(list(matched))[1]
        assert all(torch.equal(back[n], record[n]) for n in record)
        assert not other.adopt_prefix(matched, record)
        holder._hier.store.reset()
        assert holder.export_prefix(toks) is None
        # The adopted row serves: a request on the acceptor hits it and
        # its stream equals the single engine's.
        m0 = other.counters["prefix_hits"]
        with fleet.replicas[1 - fr.replica_id].lock:
            r = other.submit(prompt, max_new_tokens=5)
            while not other.idle:
                other.step()
        assert other.counters["prefix_hits"] == m0 + 1
        ref = single_engine("port", **dict(PREFIX, **extra))
        want = ref.submit(prompt, max_new_tokens=5)
        ref.run()
        assert r.tokens == want.tokens
    finally:
        fleet.close()


# ---------------------------------------------------------------- the A/B


def _template_run(pkg, reqs, prefix_affinity, **cfg):
    fleet = pfleet(pkg, prefix_affinity=prefix_affinity, **cfg)
    try:
        hs = []
        for prompt, kw in reqs:
            hs.append(fleet.submit(prompt, **kw))
            fleet.step()
            fleet.step()
        assert fleet.wait_idle(timeout_s=120.0)
        assert all(h.phase == "done" for h in hs)
        c = fleet.counters
        return {"tokens": [list(h.tokens) for h in hs],
                "owners": [h.replica_id for h in hs],
                "hits": c["prefix_hits"], "misses": c["prefix_misses"],
                "hit_rate": fleet.prefix_hit_rate(),
                "prefill_tokens": c["prefill_tokens"],
                "adoptions": c["prefix_adoptions"],
                "affinity_routed": c["affinity_routed"]}
    finally:
        fleet.close()


def test_template_heavy_affinity_ab_equals_jax():
    reqs = template_requests(n=24, n_templates=6)
    ref = oracle(reqs, prefix_slots=2)
    runs = {(pkg, on): _template_run(pkg, reqs, on, prefix_slots=2)
            for pkg in ("port", "jax") for on in (True, False)}
    on, off = runs[("port", True)], runs[("port", False)]
    assert on["tokens"] == off["tokens"] == ref
    assert on["hits"] + on["misses"] == off["hits"] + off["misses"]
    assert off["hit_rate"] < 0.3 and on["hit_rate"] > 0.5
    assert on["hit_rate"] >= 2.0 * off["hit_rate"]
    assert on["prefill_tokens"] < off["prefill_tokens"]
    assert on["affinity_routed"] > 0
    assert off["affinity_routed"] == off["adoptions"] == 0
    for side in (True, False):
        port, jax_ = runs[("port", side)], runs[("jax", side)]
        assert greedy(reqs, port["tokens"]) == greedy(reqs, jax_["tokens"])
        for key in ("owners", "hits", "misses", "prefill_tokens",
                    "adoptions", "affinity_routed"):
            assert port[key] == jax_[key], (side, key)


# ------------------------------------------------------------- failover


def test_prefix_holder_kill_invalidates_then_rewarms():
    reqs = template_requests(n=12, n_templates=1, max_new=10)
    ref = oracle(reqs)
    fleet = pfleet("port", prefix_affinity=True, fault_injection=True,
                   recovery_max_retries=0)
    try:
        frs = [fleet.submit(reqs[0][0], **reqs[0][1])]
        assert fleet.wait_idle(timeout_s=60.0)
        (holder,) = fleet.metrics()["fleet"]["prefix_directory"]["rows"]
        assert holder == frs[0].replica_id
        frs += [fleet.submit(p, **kw) for p, kw in reqs[1:]]
        for _ in range(300):
            if any(fr.replica_id == holder and fr.tokens and not fr.done
                   for fr in frs):
                break
            fleet.step()
        else:
            pytest.fail("holder never reached mid-stream")
        fleet.inject_faults(ti.FaultPlan(faults=(ti.Fault("raise",
                                                          step=0),)),
                            replica=holder)
        assert fleet.wait_idle(timeout_s=120.0)
        assert all(fr.phase == "done" for fr in frs)
        assert [fr.tokens for fr in frs] == ref
        assert not fleet.replicas[holder].alive and fleet.failovers >= 1
        snap = fleet.metrics()["fleet"]["prefix_directory"]
        assert holder not in snap["rows"] and snap["invalidations"] >= 1
        assert snap["rows"], "directory never re-warmed on survivors"
        match = fleet._directory.match([int(t) for t in reqs[0][0]])
        assert match and all(d >= PREFIX["min_prefix_len"]
                             for d in match.values())
        by_rid = {r["replica"]: r for r in fleet.rolling_drain(30.0)}
        assert by_rid[holder] == {"replica": holder, "drained": False,
                                  "skipped": "dead"}
        assert any(r["drained"] for rid, r in by_rid.items()
                   if rid != holder)
    finally:
        fleet.close()


def test_fleet_prometheus_exports_prefix_counters():
    fleet = pfleet("port", n_replicas=2)
    try:
        kinds, samples = _parse_prom(fleet.prometheus())
        for name in ("ds_tpu_prefix_adoptions_total",
                     "ds_tpu_prefix_bytes_shipped_total",
                     "ds_tpu_affinity_routed_total"):
            assert kinds[name] == "counter"
            rows = {k: v for k, v in samples.items() if k[0] == name}
            assert {dict(k[1])["replica"] for k in rows} == {"0", "1"}
            assert all(v == 0.0 for v in rows.values())
        rng = np.random.RandomState(6)
        head = rng.randint(0, 1024, size=12)
        for _ in range(2):
            tail = rng.randint(0, 1024, size=4)
            fleet.submit(np.concatenate([head, tail]), max_new_tokens=3)
            assert fleet.wait_idle(timeout_s=60.0)
        assert fleet.counters["affinity_routed"] >= 1
        kinds, samples = _parse_prom(fleet.prometheus())
        routed = {dict(k[1])["replica"]: v for k, v in samples.items()
                  if k[0] == "ds_tpu_affinity_routed_total"}
        assert sum(routed.values()) == fleet.counters["affinity_routed"]
        # Per replica: the collector's closed windows plus the open one
        # hold every affinity route, whenever the 0.05 s window clock
        # closed a window (nothing steps now, so no window closes between
        # the two reads).
        per_rep = {rid: r.get("affinity_routed", 0)
                   for rid, r in fleet.metrics()["replicas"].items()}
        for rec in fleet.collector.windows():
            for rid in per_rep:
                per_rep[rid] += rec["metrics"].get(
                    "affinity_routed{{replica={}}}".format(rid), 0.0)
        assert fleet.collector.dropped == 0
        assert sum(per_rep.values()) == fleet.counters["affinity_routed"]
        assert any(v >= 1 for v in per_rep.values())
    finally:
        fleet.close()


def test_paged_int8_fleet_adopts_and_streams_equal_single_engine():
    """The adoption path on paged int8 pools with speculation: rows ship
    page-shaped as int8 codes with their scales, the acceptor's pages
    hold them under its store's pin (every page in use is a stored row's
    once idle), and every stream equals the single engine's."""
    cfg = dict(paged_kv=True, kv_page_len=8, int8_kv=True,
               spec_decode=True, spec_k=2, spec_ngram=2, prefix_slots=2)
    reqs = template_requests(n=16, n_templates=4, seed=9)
    ref = oracle(reqs, **cfg)
    fleet = pfleet("port", n_replicas=2, **cfg)
    try:
        hs = []
        for p, kw in reqs:
            hs.append(fleet.submit(p, **kw))
            fleet.step()
            fleet.step()
        assert fleet.wait_idle(timeout_s=120.0)
        assert [h.tokens for h in hs] == ref
        c = fleet.counters
        assert c["prefix_adoptions"] >= 1 and c["prefix_bytes_shipped"] > 0
        for rep in fleet.replicas:
            stats = rep.engine.kv_page_stats()
            store = rep.engine._hier.store
            held = sum(len(p) for p, _ in store.payload.values())
            assert stats["pages_in_use"] == held
    finally:
        fleet.close()
