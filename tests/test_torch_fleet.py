"""Port parity: the serving fleet (deepspeed_tpu_torch.inference.fleet,
router, parallel.mesh) against the JAX package's, on the CPU.

The contracts are those of the JAX package's ``test_fleet.py``:

1. ROUTER AND BREAKER: the circuit breaker's state machine and the
   router's scores and orders (the seeded tie-break draws included) are
   the JAX package's on the same inputs.
2. ROUTING: an unstepped port fleet routes a stream replica for replica
   as the JAX fleet does under the same seed.
3. STREAMS: a threaded fleet's greedy streams equal the JAX fleet's and a
   JAX single engine's token for token; sampled streams equal the port's
   single engine.
4. FAILOVER: replica 0 killed mid-stream loses no request; every stream
   equals the fault-free single engine's (greedy ones the JAX fleet's
   through the same kill), the counters equal the JAX fleet's, the
   survivor captures no program for the orphans, and no delivered token
   is delivered twice (the replay re-derives them).
5. EDGES: open breakers, drain, cancel (live owner, dead owner, orphan),
   rolling drain with and without headroom, close, metrics brackets,
   replica chaos through loadgen, preemption through the fleet.
6. HAZARDS of several engines in one process: per-engine launch counts
   under two stepping threads, a capture's tally against replays on
   another thread, and the kernel-library cache under two loaders.

Every threaded test waits through ``wait_idle(timeout_s=...)`` and
asserts on its result. Sampled streams are not compared with the JAX
package's: the port draws from a (seed, position) generator.
"""

import os
import sys
import threading
import types

import numpy as np
import pytest
import torch

import deepspeed_tpu.inference as ji
import deepspeed_tpu_torch.inference as ti
import deepspeed_tpu_torch.inference.engine as engine_mod
import deepspeed_tpu_torch.loadgen as tl
from deepspeed_tpu.inference import router as jrouter
from deepspeed_tpu.parallel.mesh import replica_devices as j_replica_devices
from deepspeed_tpu_torch.inference import router as trouter
from deepspeed_tpu_torch.inference.scheduler import RETRY_AFTER_CAP_S
from deepspeed_tpu_torch.models import GPT2Config
from deepspeed_tpu_torch.op_builder import builder
from deepspeed_tpu_torch.ops.transformer.kernels import decode_attention as da
from deepspeed_tpu_torch.parallel.mesh import replica_devices
from tests.test_torch_inference import SERVE, models, prompts
from tests.test_torch_telemetry import _parse_prom

torch.set_num_threads(1)

PACKAGES = {"jax": ji, "port": ti}
FLEET = dict(SERVE, max_queue=32)
SPEC = {"spec_decode": True, "spec_k": 2, "spec_ngram": 2}
CHAOS = {"fault_injection": True, "recovery_max_retries": 0}


def fleet_of(pkg, n_replicas=2, start=False, seed=0, breaker_factory=None,
             roles=None, prefix_affinity=None, **cfg):
    """A fleet of the tiny fp32 GPT-2 on the CPU, in either package."""
    jmodel, params, tree = models()
    cfg = dict(FLEET, **cfg)
    kw = dict(n_replicas=n_replicas, seed=seed, start=start,
              window_seconds=0.05, breaker_factory=breaker_factory,
              roles=roles, prefix_affinity=prefix_affinity)
    if pkg == "jax":
        return ji.ServingFleet(jmodel, params, config=dict(
            cfg, use_flash_decode=False, perf_xray=False), **kw)
    return ti.ServingFleet(GPT2Config.tiny(dtype=torch.float32), tree,
                           config=cfg, device="cpu", **kw)


def single_engine(pkg, **cfg):
    jmodel, params, tree = models()
    cfg = dict(FLEET, **cfg)
    if pkg == "jax":
        return ji.InferenceEngine(jmodel, params, config=dict(
            cfg, use_flash_decode=False, perf_xray=False))
    return ti.InferenceEngine(GPT2Config.tiny(dtype=torch.float32), tree,
                              config=cfg, device="cpu")


MIX_LENS = [5, 9, 6, 12, 7, 8]


def mix_kw(i):
    """The JAX tests' mixed stream: spec and non-spec, greedy and
    sampled."""
    kw = {"max_new_tokens": 5 + (i % 3)}
    if i % 2:
        kw["temperature"] = 0.7
        kw["seed"] = 100 + i
    if i % 3 == 0:
        kw["spec_decode"] = False
    return kw


GREEDY = [i for i in range(len(MIX_LENS)) if i % 2 == 0]
_REF = {}


def reference(pkg, **cfg):
    """The fault-free single-engine run of the mixed stream (memoized)."""
    key = (pkg, tuple(sorted(cfg.items())))
    if key not in _REF:
        eng = single_engine(pkg, **cfg)
        reqs = [eng.submit(p, **mix_kw(i))
                for i, p in enumerate(prompts(MIX_LENS))]
        eng.run()
        _REF[key] = [list(r.tokens) for r in reqs]
    return _REF[key]


class _Clock(object):
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _view(occ, q, slots=4, health="healthy"):
    return types.SimpleNamespace(slot_occupancy=occ, queue_depth=q,
                                 max_slots=slots, health=health)


# ------------------------------------------------------ breaker, router


def _breaker_script(mod):
    """Every transition of the JAX tests' two breaker scripts, recorded."""
    out = []
    clk = _Clock()
    b = mod.CircuitBreaker(failure_threshold=3, backoff_base_s=0.5,
                           clock=clk)

    def rec(x=None):
        out.append((x, b.state, b.trips, b.probes, b.backoff_s,
                    round(b.retry_after_s(), 9), b.consecutive_failures))

    for _ in range(3):
        rec(b.allow())
        b.record_failure()
    rec(b.allow())
    clk.advance(0.5)
    rec(b.allow())
    rec(b.allow())
    b.record_failure()
    rec()
    clk.advance(1.0)
    rec(b.allow())
    b.record_success()
    rec(b.allow())
    b = mod.CircuitBreaker(failure_threshold=1, backoff_base_s=0.5,
                           backoff_max_s=30.0, clock=clk)
    for hint in (5.0, None, 1e6):
        b.record_failure(retry_after_s=hint)
        rec()
        clk.advance(b.backoff_s)
        rec(b.allow())
    for bad in ({"failure_threshold": 0}, {"backoff_base_s": 0.0},
                {"backoff_base_s": 2.0, "backoff_max_s": 1.0}):
        with pytest.raises(ValueError):
            mod.CircuitBreaker(**bad)
    return out


def test_breaker_state_machine_equals_jax():
    got = _breaker_script(trouter)
    assert got == _breaker_script(jrouter)
    assert trouter.BREAKER_STATES == ("closed", "open", "half_open")
    # The JAX contract's landmarks: trips at the threshold, one probe per
    # elapsed backoff, a failed probe doubles, a hint floors, the cap.
    assert got[3][1] == "open" and got[3][4] == 0.5
    assert got[4][1] == "half_open" and not got[5][0]
    assert got[6][4] == 1.0 and got[-1][0] and got[-2][4] == 30.0


def _router_script(mod, seed):
    """Orders of seeded random views: plain, with affinity, with role
    masks, and the scores; the JAX tests' fixed cases too."""
    rng = np.random.RandomState(seed)
    healths = ["healthy", "healthy", "degraded", "dead"]
    views = [_view(float(rng.choice([0.0, 0.25, 0.5, 1.0])),
                   int(rng.randint(0, 3)), slots=4,
                   health=healths[rng.randint(0, 4)]) for _ in range(5)]
    for i, v in enumerate(views):
        v.name = i
    r = mod.Router(seed=seed)
    out = [[mod.Router.score(v) for v in views]]
    for _ in range(3):
        out.append([v.name for v in r.order(views)])
        aff = rng.rand(len(views)).round(2).tolist()
        out.append([v.name for v in r.order(views, aff)])
        mask = (rng.rand(len(views)) > 0.4).tolist()
        out.append([v.name for v in r.order(views, eligible=mask)])
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 9])
def test_router_scores_and_orders_equal_jax(seed):
    assert _router_script(trouter, seed) == _router_script(jrouter, seed)
    assert trouter.DEGRADED_PENALTY == jrouter.DEGRADED_PENALTY
    assert trouter.AFFINITY_WEIGHT == jrouter.AFFINITY_WEIGHT
    light, heavy = _view(0.25, 0), _view(1.0, 3)
    degraded, dead = _view(0.0, 0, health="degraded"), \
        _view(0.0, 0, health="dead")
    assert trouter.Router(seed=1).order([dead, heavy, degraded, light]) \
        == [light, heavy, degraded, dead]


def test_replica_devices_round_robin():
    assert replica_devices(3, devices=["d0", "d1"]) == \
        j_replica_devices(3, devices=["d0", "d1"]) == ["d0", "d1", "d0"]
    assert replica_devices(2, device="cpu") == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        replica_devices(0, device="cpu")
    if not torch.cuda.is_available():
        # Entry points run on the card unless the caller names the CPU.
        with pytest.raises(RuntimeError, match="cpu"):
            replica_devices(2)
        with pytest.raises(RuntimeError, match="cpu"):
            ti.ServingFleet(GPT2Config.tiny(dtype=torch.float32),
                            models()[2], n_replicas=1, start=False)


@pytest.mark.parametrize("block", [
    {"replica_id": -1}, {"role": "router"}, {"role": "decode"},
    {"replica_id": 3, "role": "prefill"}], ids=["bad_id", "bad_role",
                                                "decode", "prefill"])
def test_replica_id_and_role_validate_as_jax(block):
    from deepspeed_tpu.inference.config import InferenceConfig as JCfg
    try:
        JCfg.from_dict(dict(block, chunked_prefill=True))
        want = None
    except ValueError as e:
        want = type(e)
    if want is None:
        cfg = ti.InferenceConfig.from_dict(block)
        assert (cfg.replica_id, cfg.role) == (block.get("replica_id"),
                                              block.get("role", "mixed"))
    else:
        with pytest.raises(want):
            ti.InferenceConfig.from_dict(block)


def test_queue_full_carries_replica_id_and_clamped_hint():
    s = ti.Scheduler(2, 1, replica_id=7)
    s._finish_times.extend([0.0, 10000.0])
    assert s.retry_after_s() == RETRY_AFTER_CAP_S
    p = np.arange(4)
    s.submit(p, 4, 0.0, 0, -1, 0)
    with pytest.raises(ti.QueueFull) as ei:
        s.submit(p, 4, 0.0, 0, -1, 0, priority="batch", tenant="t")
    e = ei.value
    assert (e.replica_id, e.queue_depth, e.priority, e.tenant) == \
        (7, 1, "batch", "t")


# -------------------------------------------------------------- routing


def test_fleet_routing_equals_jax_under_seed():
    ps = prompts([6] * 6)
    owners = {}
    for pkg in PACKAGES:
        for seed in (5, 5, 6):
            fleet = fleet_of(pkg, seed=seed)
            try:
                owners.setdefault(pkg, []).append(
                    [fleet.submit(p, max_new_tokens=4).replica_id
                     for p in ps])
            finally:
                fleet.close()
    assert owners["port"] == owners["jax"]
    a = owners["port"][0]
    assert a == owners["port"][1]
    assert all(a[i] != a[i + 1] for i in range(0, len(a), 2))


# -------------------------------------------------------------- streams


def test_fleet_streams_equal_jax_with_replica_labeled_metrics():
    """Threaded fleets, the mixed stream: greedy streams equal the JAX
    fleet's and the JAX single engine's; every stream equals the port's
    single engine; both replicas serve; the merged Prometheus text
    carries one replica-labelled series per engine."""
    got = {}
    for pkg in PACKAGES:
        fleet = fleet_of(pkg, start=True, **SPEC)
        try:
            frs = [fleet.submit(p, **mix_kw(i))
                   for i, p in enumerate(prompts(MIX_LENS))]
            assert fleet.wait_idle(timeout_s=120.0)
            got[pkg] = [fr.tokens for fr in frs]
            assert all(fr.phase == "done" and fr.done for fr in frs)
            assert all(fr.submit_time <= fr.first_token_time
                       <= fr.finish_time for fr in frs)
            assert sorted({fr.replica_id for fr in frs}) == [0, 1]
            assert sorted(fr.fid for fr in fleet.harvest()) == \
                [fr.fid for fr in frs]
            assert fleet.harvest() == []
            m = fleet.metrics()["fleet"]
            assert m["requests_completed"] == len(frs)
            assert (m["alive"], m["health"], m["failovers"],
                    m["orphans"]) == (2, "healthy", 0, 0)
            assert m["breaker_states"] == {0: "closed", 1: "closed"}
            if pkg == "port":
                # One program per key met; a replica meets at most the
                # lane / no-lane pair of each sampling key.
                assert all(1 <= c <= 4
                           for c in fleet.compile_counts.values())
                kinds, samples = _parse_prom(fleet.prometheus())
                assert kinds["ds_tpu_tokens_out_total"] == "counter"
                for rid in ("0", "1"):
                    lbl = (("engine", "inference"), ("replica", rid))
                    assert samples[("ds_tpu_tokens_out_total", lbl)] > 0
                    assert ("ds_tpu_queue_depth", lbl) in samples
                assert "ds_tpu_alerts_firing" in kinds
        finally:
            fleet.close()
    assert got["port"] == reference("port", **SPEC)
    jref = reference("jax", **SPEC)
    for i in GREEDY:
        assert got["port"][i] == got["jax"][i] == jref[i]


# ------------------------------------------------------------- failover


def warm_replicas(fleet):
    """Each replica meets every key the mixed stream can meet (prefill
    lane or not, sampling or not) before the run: a long greedy request
    with a short sampled one behind it. The port captures one program per
    key met, so a warm survivor must capture none for the orphans, as the
    JAX survivor compiles none. Done alike on a JAX fleet, so counters
    stay comparable; the port's replicas are then marked warm."""
    for rep in fleet.replicas:
        eng = rep.engine
        eng.submit(prompts([5], seed=21)[0], max_new_tokens=40,
                   spec_decode=False)
        eng.submit(prompts([6], seed=22)[0], max_new_tokens=9,
                   temperature=0.7, seed=7, spec_decode=False)
        eng.run()
        if isinstance(eng, ti.InferenceEngine):
            assert eng.compile_count == 4, sorted(eng._programs)
            eng.recompile_detector.mark_warm()


def _kill_mid_stream(pkg):
    """Replica 0 killed once one of its requests has delivered tokens
    and not finished (start=False: the kill lands at a fixed point), on
    warm replicas."""
    mod = PACKAGES[pkg]
    fleet = fleet_of(pkg, **dict(SPEC, **CHAOS))
    warm_replicas(fleet)
    tokens_out0 = fleet.counters["tokens_out"]
    frs = [fleet.submit(p, **mix_kw(i))
           for i, p in enumerate(prompts(MIX_LENS))]
    victims = [fr for fr in frs if fr.replica_id == 0]
    assert victims and len(victims) < len(frs)
    for _ in range(200):
        if any(fr.tokens and not fr.done for fr in victims):
            break
        fleet.step()
    else:
        pytest.fail("replica 0 never reached mid-stream")
    facts = {"survivor_compiles": fleet.compile_counts[1],
             "emitted": {fr.fid: len(fr.tokens) for fr in victims},
             "at_kill": {fr.fid: list(fr.tokens) for fr in frs},
             "tokens_out0": tokens_out0,
             "unfinished": {fr.fid for fr in victims if not fr.done}}
    fleet.inject_faults(mod.FaultPlan(faults=(mod.Fault("raise",
                                                        step=0),)),
                        replica=0)
    assert fleet.wait_idle(timeout_s=120.0)
    return fleet, frs, facts


COUNTERS = ("tokens_out", "requests_completed", "faults_injected",
            "recoveries", "handoffs", "handoffs_in", "prefix_adoptions",
            "affinity_routed", "prefix_hits", "prefix_misses")


def test_failover_mid_stream_kill_equals_jax():
    """THE invariant: zero lost, every stream equal to the fault-free
    single engine's (greedy ones to the JAX fleet's through the same
    kill), the counters the JAX fleet's, the survivor's programs
    unchanged, the fleet healthy; then the rolling drain skips the dead
    replica and refuses the lone survivor unless forced."""
    out = {}
    for pkg in PACKAGES:
        fleet, frs, facts = _kill_mid_stream(pkg)
        try:
            moved = [fr for fr in frs if fr.failovers > 0]
            assert all(fr.phase == "done" for fr in frs)
            assert {fr.fid for fr in moved} == facts["unfinished"]
            assert all(fr.replica_id == 1 for fr in moved)
            assert fleet.failovers == len(moved) >= 1
            assert fleet.compile_counts[1] == facts["survivor_compiles"]
            if pkg == "port":
                assert fleet.metrics()["replicas"][1]["recompiles"] == 0
            m = fleet.metrics()["fleet"]
            assert (m["health"], m["alive"], m["faults_injected"],
                    m["orphans"]) == ("healthy", 1, 1, 0)
            assert not fleet.replicas[0].alive
            if pkg == "port":
                # The fleet keeps what failed the replica: the injected
                # fault, under the engine's exhausted recovery.
                cause = fleet.replicas[0].cause
                assert isinstance(cause, ti.EngineDeadError)
                assert isinstance(cause.__cause__, ti.InjectedFault)
                assert fleet.replicas[1].cause is None
            assert all(fr.first_token_time is not None for fr in moved
                       if facts["emitted"][fr.fid] > 0)
            out[pkg] = {"tokens": [fr.tokens for fr in frs],
                        "failovers": fleet.failovers,
                        "moved": sorted(fr.fid for fr in moved),
                        "counters": {n: fleet.counters[n]
                                     for n in COUNTERS}}
            report = fleet.rolling_drain(timeout_s=30.0)
            assert report[0] == {"replica": 0, "drained": False,
                                 "skipped": "dead"}
            assert report[1]["skipped"] == "no_headroom"
            assert report[1]["headroom"]["survivors"] == []
            forced = fleet.rolling_drain(timeout_s=30.0,
                                         require_headroom=False)
            assert forced[1]["drained"]
            assert fleet.replicas[1].engine.health == "healthy"
            if pkg == "port":
                # The autopsy's failover arrow crosses replicas.
                tree = fleet.explain(moved[0])
                names = [h["name"] for h in tree["hops"]]
                assert "request/failover_out" in names
                assert "request/failover_in" in names
                assert tree["terminal"]["lost_then_replayed"]
        finally:
            fleet.close()
    assert out["port"]["tokens"] == reference("port", **SPEC)
    for i in GREEDY:
        assert out["port"]["tokens"][i] == out["jax"]["tokens"][i]
    for key in ("failovers", "moved", "counters"):
        assert out["port"][key] == out["jax"][key], key


def test_unexpected_step_error_fails_replica_over_and_is_kept():
    """An error the engine does not handle (not a fatal step error, so no
    recovery) escapes a replica's step: the fleet fails that replica
    over, crash-only, and keeps the error as its ``cause``; the survivor
    finishes every stream as the fault-free single engine does. A caller
    that injected no fault tells such a death apart by ``cause`` and
    ``failovers``, since the streams alone would not show it."""
    fleet = fleet_of("port", **SPEC)
    try:
        warm_replicas(fleet)
        frs = [fleet.submit(p, **mix_kw(i))
               for i, p in enumerate(prompts(MIX_LENS))]
        assert any(fr.replica_id == 0 for fr in frs)
        fleet.step()
        boom = RuntimeError("a bug in a step")

        def broken_step():
            raise boom

        fleet.replicas[0].engine.step = broken_step
        assert fleet.wait_idle(timeout_s=120.0)
        assert [fr.tokens for fr in frs] == reference("port", **SPEC)
        assert fleet.replicas[0].cause is boom
        assert fleet.replicas[1].cause is None
        assert fleet.failovers >= 1
        assert [rep.alive for rep in fleet.replicas] == [False, True]
        assert fleet.health == "healthy"
    finally:
        fleet.close()


def test_orphan_replay_never_delivers_a_token_twice(monkeypatch):
    """A re-homed request re-derives the tokens it delivered through the
    survivor's decode lane: each is checked and none is delivered again.
    Every token a client sees is appended once (a duplicate would
    lengthen the stream past its budget and out of the reference), and
    the fleet's tokens_out counts each once. Then the JAX replay for a
    re-derivation that disagrees: the stream still holds every
    delivered token once."""
    delivered = []
    take = engine_mod.InferenceEngine._take

    def spy(self, req, emitted):
        new = take(self, req, emitted)
        if new:
            delivered.append((id(req.trace), list(new)))
        return new

    monkeypatch.setattr(engine_mod.InferenceEngine, "_take", spy)
    fleet, frs, facts = _kill_mid_stream("port")
    try:
        ref = reference("port", **SPEC)
        assert [fr.tokens for fr in frs] == ref
        assert fleet.counters["tokens_out"] - facts["tokens_out0"] == \
            sum(len(t) for t in ref)
        for fr in frs:
            mine = [t for tid, new in delivered if tid == id(fr.trace)
                    for t in new]
            # _harvest_first appends a first token outside _take's
            # return; every later token passed through it exactly once.
            assert mine == fr.tokens[len(fr.tokens) - len(mine):]
        moved = [fr for fr in frs if fr.failovers and len(fr.tokens) > 1]
        assert moved and all(
            fleet.replicas[1].engine.find_request(fr._req.rid).resync
            is None for fr in moved)
    finally:
        fleet.close()
    # A survivor whose re-derivation disagrees falls back to the replay
    # of prompt + delivered tokens, and still delivers nothing twice.
    monkeypatch.setattr(engine_mod.InferenceEngine, "_take", take)

    def wrong(self, req, emitted):
        if req.resync is not None and req.resync > 0:
            return None  # as if the device re-derived another token
        return take(self, req, emitted)

    monkeypatch.setattr(engine_mod.InferenceEngine, "_take", wrong)
    fleet, frs, facts = _kill_mid_stream("port")
    try:
        # On the CPU the JAX replay is exact too: the streams are the
        # reference's, and each begins with what it had delivered.
        assert all(fr.phase == "done" for fr in frs)
        assert [fr.tokens for fr in frs] == reference("port", **SPEC)
        assert all(fr.tokens[:len(facts["at_kill"][fr.fid])] ==
                   facts["at_kill"][fr.fid] for fr in frs)
        assert any(len(facts["at_kill"][fr.fid]) > 1
                   for fr in frs if fr.failovers)
        assert fleet.counters["requests_replayed"] >= 1
    finally:
        fleet.close()


# ---------------------------------------------------------------- edges


def test_all_open_breakers_raise_fleet_queuefull_with_min_hint():
    clk = _Clock()
    fleet = fleet_of("port", breaker_factory=lambda: ti.CircuitBreaker(
        failure_threshold=1, backoff_base_s=2.0, clock=clk))
    try:
        (p,) = prompts([6])
        fleet.replicas[0].breaker.trip()
        fleet.replicas[1].breaker.trip(retry_after_s=5.0)
        with pytest.raises(ti.QueueFull) as ei:
            fleet.submit(p, max_new_tokens=4)
        assert ei.value.replica_id is None
        assert ei.value.retry_after_s == pytest.approx(2.0)
        clk.advance(2.0)
        fr = fleet.submit(p, max_new_tokens=4)
        assert fr.replica_id == 0
        assert fleet.replicas[0].breaker.state == "closed"
        assert fleet.replicas[1].breaker.state == "open"
    finally:
        fleet.close()


def test_submit_during_drain_lands_on_open_replica():
    fleet = fleet_of("port", seed=3)
    try:
        (p,) = prompts([6])
        fleet.replicas[0].engine.close_admissions()
        assert [fleet.submit(p, max_new_tokens=4).replica_id
                for _ in range(4)] == [1, 1, 1, 1]
        fleet.replicas[1].engine.close_admissions()
        with pytest.raises(ti.EngineDraining):
            fleet.submit(p, max_new_tokens=4)
        fleet.undrain_all()
        assert fleet.submit(p, max_new_tokens=4).replica_id == 0
        for rep in fleet.replicas:
            rep.failed = True
        with pytest.raises(ti.EngineDeadError):
            fleet.submit(p, max_new_tokens=4)
    finally:
        fleet.close()


def test_cancel_reaches_live_owner_and_dead_owner():
    fleet = fleet_of("port")
    try:
        ps = prompts([6, 6])
        fr0 = fleet.submit(ps[0], max_new_tokens=20)
        fr1 = fleet.submit(ps[1], max_new_tokens=20)
        assert fr0.replica_id != fr1.replica_id
        fleet.step()
        assert fr0.phase == "decoding"
        assert fleet.cancel(fr0)
        assert fr0.phase == "cancelled" and fr0.done
        assert not fleet.cancel(fr0)
        eng0 = fleet.replicas[fr0.replica_id].engine
        assert not bool(eng0._pool["active"].any())
        fleet.replicas[fr1.replica_id].failed = True
        assert fleet.cancel(fr1)
        assert fr1.phase == "cancelled"
        assert fleet.idle
    finally:
        fleet.close()


def test_cancel_reaches_orphan_mid_failover():
    fleet = fleet_of("port", max_slots=1, max_queue=1, **CHAOS)
    try:
        ps = prompts([6, 6, 6])
        fleet.replicas[1].engine.close_admissions()
        fr_a = fleet.submit(ps[0], max_new_tokens=8)
        assert fr_a.replica_id == 0
        fleet.replicas[1].engine.undrain()
        fleet.replicas[0].engine.close_admissions()
        fr_b = fleet.submit(ps[1], max_new_tokens=6)
        fleet.step()
        fr_c = fleet.submit(ps[2], max_new_tokens=6)
        assert fr_b.replica_id == fr_c.replica_id == 1
        fleet.inject_faults(ti.FaultPlan(faults=(ti.Fault("raise",
                                                          step=0),)),
                            replica=0)
        fleet.step()
        assert fr_a.replica_id is None and fr_a.phase == "queued"
        assert not fleet.idle
        assert fleet.cancel(fr_a)
        assert fr_a.phase == "cancelled" and fr_a.done
        assert fleet.wait_idle(timeout_s=120.0)
        assert fr_b.phase == "done" and fr_c.phase == "done"
        assert {fr.fid for fr in fleet.harvest()} == \
            {fr_a.fid, fr_b.fid, fr_c.fid}
    finally:
        fleet.close()


def test_rolling_drain_with_headroom_rotates_and_without_skips():
    fleet = fleet_of("port", start=True)
    try:
        frs = [fleet.submit(p, max_new_tokens=3) for p in prompts([6, 8])]
        assert fleet.wait_idle(timeout_s=120.0)
        report = fleet.rolling_drain(timeout_s=30.0)
        assert [r["replica"] for r in report] == [0, 1]
        assert all(r["drained"] for r in report)
        for r in report:
            h = r["headroom"]
            assert h["spare_capacity"] >= h["in_flight"]
            assert h["survivors"] == [1 - r["replica"]]
        assert all(rep.engine.health == "healthy"
                   for rep in fleet.replicas)
        fr = fleet.submit(prompts([5])[0], max_new_tokens=2)
        assert fleet.wait_idle(timeout_s=60.0) and fr.phase == "done"
        assert all(fr.done for fr in frs)
    finally:
        fleet.close()
    fleet = fleet_of("port", n_replicas=1)
    try:
        report = fleet.rolling_drain()
        assert report == [{"replica": 0, "drained": False,
                           "skipped": "no_headroom",
                           "headroom": report[0]["headroom"]}]
        assert report[0]["headroom"]["survivors"] == []
        assert fleet.rolling_drain(require_headroom=False)[0]["drained"]
        assert fleet.replicas[0].engine.health == "healthy"
    finally:
        fleet.close()


def test_close_joins_threads_and_stops_watchdogs():
    fleet = fleet_of("port", start=True, step_budget_s=5.0)
    threads = [rep.thread for rep in fleet.replicas]
    assert all(t.is_alive() for t in threads)
    fleet.close()
    assert all(not t.is_alive() for t in threads)
    assert all(rep.engine._watchdog._timer is None
               for rep in fleet.replicas)
    fleet.close()
    with pytest.raises(RuntimeError):
        fleet.submit(prompts([4])[0], max_new_tokens=2)
    with pytest.raises(ValueError):
        ti.ServingFleet(GPT2Config.tiny(dtype=torch.float32), models()[2],
                        n_replicas=0, device="cpu")
    # The x-ray is off in FLEET's config: every replica's section is None.
    assert fleet.perf_xray() == {0: None, 1: None}


def test_runner_chaos_kills_replica_mid_run_zero_lost():
    fleet = fleet_of("port", start=True, max_slots=4, max_queue=64,
                     **CHAOS)
    try:
        spec = tl.WorkloadSpec(rate=80.0, n_requests=10, prompt_mean=8,
                               prompt_max=16, output_mean=4, output_max=8,
                               vocab_size=1024, seed=11)
        plan = ti.FaultPlan(faults=(ti.Fault("raise", step=0),))
        res = tl.SustainedRunner(fleet, spec, window_seconds=0.1,
                                 max_steps=200_000, chaos_plan=plan,
                                 chaos_after_s=0.0, chaos_replica=0).run()
        assert res.faults_injected == 1
        assert res.requests_lost == 0 and res.shed == 0
        assert res.completed == res.submitted == 10
        m = fleet.metrics()["fleet"]
        assert m["alive"] == 1 and m["health"] == "healthy"
        assert not fleet.replicas[0].alive
    finally:
        fleet.close()


def test_fleet_metrics_reset_brackets_like_a_lone_engine():
    fleet = fleet_of("port")
    try:
        ps = prompts([5, 9, 7])
        batch_a = [fleet.submit(p, max_new_tokens=4) for p in ps]
        assert fleet.wait_idle(timeout_s=120.0)
        m1 = fleet.metrics(reset=True)
        assert m1["fleet"]["requests_completed"] == len(batch_a)
        tokens_a = m1["fleet"]["tokens_out"]
        assert tokens_a == sum(len(fr.tokens) for fr in batch_a) > 0
        m2 = fleet.metrics()
        assert m2["fleet"]["requests_completed"] == 0
        assert m2["fleet"]["tokens_out"] == 0
        batch_b = [fleet.submit(p, max_new_tokens=4) for p in ps[:2]]
        assert fleet.wait_idle(timeout_s=120.0)
        m3 = fleet.metrics(reset=True)
        assert m3["fleet"]["requests_completed"] == len(batch_b)
        tokens_b = m3["fleet"]["tokens_out"]
        assert tokens_b == sum(len(fr.tokens) for fr in batch_b) > 0
        assert fleet.counters["tokens_out"] == tokens_a + tokens_b
        assert fleet.counters["requests_completed"] == 5
    finally:
        fleet.close()


def test_preempt_parks_and_release_resumes_through_the_fleet():
    """Preemption through the fleet (the front door's call, next slice):
    a decoding request parks in the swapped phase, stays parked while
    held, resumes once released, and its stream equals an unpreempted
    run's."""
    cfg = dict(host_offload=True, swap_slots=2)
    ref = single_engine("port", **cfg)
    want = [ref.submit(p, max_new_tokens=10) for p in prompts([6, 9])]
    ref.run()
    fleet = fleet_of("port", n_replicas=1, **cfg)
    try:
        frs = [fleet.submit(p, max_new_tokens=10) for p in prompts([6, 9])]
        for _ in range(50):
            fleet.step()
            if frs[0].phase == "decoding":
                break
        assert fleet.preempt(frs[0])
        assert frs[0].phase == "swapped"
        assert not fleet.preempt(frs[0])
        eng = fleet.replicas[0].engine
        assert eng.preempted_held() == {frs[0]._req.rid}
        for _ in range(3):
            fleet.step()
        assert frs[0].phase == "swapped"
        assert fleet.release_preempted(frs[0])
        assert fleet.wait_idle(timeout_s=60.0)
        assert [fr.tokens for fr in frs] == [r.tokens for r in want]
        m = fleet.metrics()["fleet"]
        assert m["preemptions"] == m["preempt_resumes"] == 1
    finally:
        fleet.close()


# ------------------------------------------------------------- hazards


def _counting_references(monkeypatch):
    """Make the decode wrappers' CPU branch count a launch, as the CUDA
    branch does, so CPU engines show their launch counts."""
    for kind, name in (("decode", "decode_attention_reference"),
                       ("paged", "decode_attention_paged_reference")):
        ref = getattr(da, name)

        def counted(*a, _ref=ref, _kind=kind, **k):
            da._count(_kind)
            return _ref(*a, **k)

        monkeypatch.setattr(da, name, counted)


def test_per_engine_launch_counts_exact_on_two_threads(monkeypatch):
    """Two engines stepping on two threads at once: each engine's own
    ``launches`` equals what it counts stepping alone, and the process
    counts are their sum."""
    _counting_references(monkeypatch)
    ps = prompts([5, 9, 6, 12])

    def serve(eng):
        for p in ps:
            eng.submit(p, max_new_tokens=6)
        eng.run()
        return dict(eng.launches)

    alone = serve(single_engine("port"))
    assert alone["decode"] > 0 and alone["paged"] > 0
    engines = [single_engine("port") for _ in range(2)]
    da.reset_launches()
    threads = [threading.Thread(target=serve, args=(e,)) for e in engines]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    assert not any(t.is_alive() for t in threads)
    assert [e.launches for e in engines] == [alone, alone]
    assert da.launches == {k: 2 * n for k, n in alone.items()}


def test_capture_tally_is_exact_beside_replays_on_another_thread():
    """A stub program stands in for a graph capture on one thread while
    more replaying threads than the host has cores count replays, each
    into its own engine's sink, with the interpreter switching threads
    as often as it can: the capture's launches land in its tally only,
    the replays in the process counts and their own sinks, and nothing is
    lost or double counted (the old snapshot-and-restore of the global
    counts lost the replays counted meanwhile)."""
    n_threads = max(4, 2 * (os.cpu_count() or 1))
    da.reset_launches()
    sinks = [dict.fromkeys(da.launches, 0) for _ in range(n_threads)]
    tallies, stop = [], threading.Event()
    barrier = threading.Barrier(n_threads + 1)
    replays = [0] * n_threads
    one = {"decode": 1, "paged": 2, "q8": 0, "paged_q8": 0}

    def capture():
        barrier.wait()
        for _ in range(200):
            with da.recording() as tally:
                for kind in ("decode", "paged", "paged"):
                    da._count(kind)
            tallies.append(dict(tally))
        stop.set()

    def replay(i):
        with da.counting_into(sinks[i]):
            barrier.wait()
            while not stop.is_set() or replays[i] < 100:
                da.add_launches(one)
                replays[i] += 1

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=capture)] + [
            threading.Thread(target=replay, args=(i,))
            for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(tallies) == 200 and all(t == one for t in tallies)
    assert [s["decode"] for s in sinks] == replays
    assert all(s["paged"] == 2 * n for s, n in zip(sinks, replays))
    n = sum(replays)
    assert da.launches == {"decode": n, "paged": 2 * n, "q8": 0,
                           "paged_q8": 0}


def test_kernel_library_loads_once_under_two_threads(monkeypatch):
    """``op_builder.load`` from two threads at once builds and loads the
    library once (a stub build stands in for nvcc)."""
    calls = []
    gate = threading.Event()

    def fake_build(name):
        calls.append(name)
        gate.wait(1.0)
        return "/nonexistent/lib{}.so".format(name), 0.0

    loaded = []
    monkeypatch.setattr(builder, "_build", fake_build)
    monkeypatch.setattr(builder.ctypes, "CDLL", lambda path: (
        loaded.append(path) or types.SimpleNamespace(path=path)))
    monkeypatch.setattr(builder, "_LOADED", {})
    libs = []
    threads = [threading.Thread(target=lambda: libs.append(
        builder.load("stub"))) for _ in range(2)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join(timeout=10.0)
    assert calls == ["stub"] and len(loaded) == 1
    assert len(libs) == 2 and libs[0] is libs[1]
