"""Port parity: front-door preemption under faults, against the JAX
package's, on the CPU.

The contracts are those of the JAX package's
``test_frontdoor_resilience.py``:

1. PREEMPT/RESUME: ``engine.preempt()`` parks a decoding request in the
   ``swapped`` phase and holds it there; ``release_preempted()`` lifts
   the hold and the stream resumes bit for bit.
2. PREEMPT x CRASH: a fatal step fault while a request sits preempted
   loses nothing; recovery clears the holds and every stream equals the
   fault-free run.
3. PREEMPT x REPLICA KILL: the preempted request's replica dies; the
   fleet re-homes it on the survivor and it completes bit for bit.
4. MID-STREAM FAILOVER: TokenStreams consumed while their replica dies
   yield exactly the fault-free streams, no token twice and none missing.

Greedy streams are held to the JAX engine's token for token; sampled ones
to the port's own fault-free run (the port draws from a (seed, position)
generator).
"""

import pytest
import torch

import deepspeed_tpu_torch.inference as ti
from deepspeed_tpu_torch.inference import (Fault, FaultPlan, FrontDoor,
                                           FrontDoorConfig, PriorityClass)
from tests.test_torch_fleet import fleet_of, single_engine, warm_replicas
from tests.test_torch_inference import prompts

torch.set_num_threads(1)

_LENS = [6, 9, 5, 12, 7, 8]
GREEDY = [i for i in range(len(_LENS)) if i % 2 == 0]
HIER = {"host_offload": True, "swap_slots": 8}


def _mix_kw(i):
    kw = {"max_new_tokens": 16 + (i % 3)}
    if i % 2:
        kw["temperature"] = 0.7
        kw["seed"] = 100 + i
    return kw


def _step_until(target, pred, limit=800, what="condition"):
    for _ in range(limit):
        if pred():
            return
        target.step()
    pytest.fail("never reached: " + what)


_REF = {}


def _reference(pkg):
    """The fault-free single-engine run of the mixed stream (memoized)."""
    if pkg not in _REF:
        eng = single_engine(pkg)
        reqs = [eng.submit(p, **_mix_kw(i))
                for i, p in enumerate(prompts(_LENS))]
        eng.run()
        _REF[pkg] = [[int(t) for t in r.tokens] for r in reqs]
    return _REF[pkg]


def _check_streams(got):
    """Every stream equals the port's fault-free run; the greedy ones
    also the JAX engine's."""
    assert got == _reference("port")
    jref = _reference("jax")
    for i in GREEDY:
        assert got[i] == jref[i]


def _greedy_ref(pkg, ps, n):
    eng = single_engine(pkg)
    reqs = [eng.submit(p, max_new_tokens=n) for p in ps]
    eng.run()
    return [[int(t) for t in r.tokens] for r in reqs]


def _fd_cfg():
    return FrontDoorConfig(classes=(
        PriorityClass("interactive", ttft_budget_ms=60_000.0, weight=4.0),
        PriorityClass("batch", weight=1.0, preemptible=True),
    ))


def test_preempt_release_resume_bit_identical():
    ps = prompts([6, 9, 5])
    eng = single_engine("port", max_slots=2, **HIER)
    reqs = [eng.submit(p, max_new_tokens=24) for p in ps]
    _step_until(eng, lambda: reqs[0].phase == "decoding" and reqs[0].tokens,
                what="reqs[0] mid-decode")
    emitted = len(reqs[0].tokens)
    keys = sorted(eng._programs)
    assert eng.preempt(reqs[0])
    assert reqs[0].phase == "swapped"
    assert reqs[0].rid in eng.preempted_held()
    for _ in range(20):
        eng.step()
    assert reqs[0].phase == "swapped"
    assert len(reqs[0].tokens) == emitted
    assert not eng.idle
    eng.release_preempted(reqs[0])
    assert eng.preempted_held() == frozenset()
    eng.run()
    assert all(r.phase == "done" for r in reqs)
    got = [[int(t) for t in r.tokens] for r in reqs]
    assert got == _greedy_ref("jax", ps, 24)
    assert eng.counters["preemptions"] == 1
    assert eng.counters["preempt_resumes"] == 1
    assert set(keys) <= set(eng._programs)


def test_release_all_and_unparkable_phases():
    (p,) = prompts([6])
    eng = single_engine("port", max_slots=2, **HIER)
    req = eng.submit(p, max_new_tokens=24)
    assert not eng.preempt(req)
    _step_until(eng, lambda: req.phase == "decoding", what="req decoding")
    assert eng.preempt(req)
    eng.release_preempted()
    assert eng.preempted_held() == frozenset()
    eng.run()
    assert [int(t) for t in req.tokens] == _greedy_ref("jax", [p], 24)[0]
    plain = single_engine("port", max_slots=2)
    r2 = plain.submit(p, max_new_tokens=24)
    _step_until(plain, lambda: r2.phase == "decoding", what="r2 decoding")
    assert not plain.preempt(r2)
    plain.run()


def test_preempted_request_survives_engine_crash():
    eng = single_engine("port", max_slots=3, fault_injection=True, **HIER)
    reqs = [eng.submit(p, **_mix_kw(i))
            for i, p in enumerate(prompts(_LENS))]
    _step_until(eng, lambda: reqs[0].phase == "decoding" and reqs[0].tokens,
                what="reqs[0] mid-decode")
    assert eng.preempt(reqs[0])
    assert reqs[0].phase == "swapped"
    n_keys = eng.compile_count
    eng.inject_faults(FaultPlan(faults=(Fault("raise", step=0),)))
    eng.run()
    assert all(r.phase == "done" for r in reqs)
    _check_streams([[int(t) for t in r.tokens] for r in reqs])
    assert len(eng.recovery_log) == 1
    assert eng.preempted_held() == frozenset()
    assert eng.health == "healthy"
    assert eng.compile_count >= n_keys


def test_preempted_request_survives_replica_kill():
    fleet = fleet_of("port", start=False, fault_injection=True,
                     recovery_max_retries=0, **HIER)
    try:
        frs = [fleet.submit(p, **_mix_kw(i))
               for i, p in enumerate(prompts(_LENS))]
        victims = [fr for fr in frs if fr.replica_id == 0]
        assert victims and len(victims) < len(frs)
        _step_until(fleet, lambda: any(
            fr.phase == "decoding" and fr.tokens and not fr.done
            for fr in victims), limit=300, what="replica 0 mid-decode")
        victim = next(fr for fr in victims
                      if fr.phase == "decoding" and fr.tokens)
        assert fleet.preempt(victim)
        assert victim.phase == "swapped"
        fleet.inject_faults(
            FaultPlan(faults=(Fault("raise", step=0),)), replica=0)
        assert fleet.wait_idle(timeout_s=120.0)
        assert all(fr.phase == "done" for fr in frs)
        _check_streams([[int(t) for t in fr.tokens] for fr in frs])
        assert victim.failovers >= 1
        assert fleet.metrics()["fleet"]["health"] == "healthy"
    finally:
        fleet.close()


def test_mid_stream_failover_no_duplicate_no_drop():
    fleet = fleet_of("port", start=False, fault_injection=True,
                     recovery_max_retries=0, **HIER)
    warm_replicas(fleet)
    fd = FrontDoor(fleet, _fd_cfg())
    try:
        streams = [fd.stream(p, **_mix_kw(i))
                   for i, p in enumerate(prompts(_LENS))]
        victims = [s for s in streams if s.handle._req.replica_id == 0]
        assert victims and len(victims) < len(streams)
        got = [[int(next(s))] for s in streams]
        assert any(not s.handle.done for s in victims)
        survivor_compiles = fleet.compile_counts[1]
        fleet.inject_faults(
            FaultPlan(faults=(Fault("raise", step=0),)), replica=0)
        live = set(range(len(streams)))
        while live:
            for i in sorted(live):
                try:
                    got[i].append(int(next(streams[i])))
                except StopIteration:
                    live.discard(i)
        _check_streams(got)
        assert all(s.handle.phase == "done" for s in streams)
        assert any(s.handle._req.failovers >= 1 for s in victims)
        # A warm survivor captures no program for the orphans.
        assert fleet.compile_counts[1] == survivor_compiles
        assert fleet.replicas[1].engine.recompile_detector \
            .recompiles.value == 0
        assert fd.compile_count == sum(fleet.compile_counts.values())
        assert fd.metrics()["frontdoor"]["stats"]["completed"] == len(_LENS)
    finally:
        fleet.close()


def test_frontdoor_preempts_through_fleet_and_resumes():
    """The front door's own preemption over a fleet: a warm predictor
    that says an interactive arrival misses its budget parks a decoding
    batch request through ``ServingFleet.preempt``; once the pressure is
    gone the hold lifts and every stream equals the fault-free run."""
    fleet = fleet_of("port", start=False, **HIER)
    fd = FrontDoor(fleet, FrontDoorConfig(classes=(
        PriorityClass("interactive", ttft_budget_ms=1.0, weight=4.0,
                      shed_on_budget=False),
        PriorityClass("batch", weight=1.0, preemptible=True),
    )))
    try:
        ps = prompts(_LENS)
        hs = [fd.submit(p, priority="batch", **_mix_kw(i))
              for i, p in enumerate(ps)]
        _step_until(fd, lambda: any(h.phase == "decoding" and h.tokens
                                    for h in hs), what="batch decoding")
        adm = fd._admission
        adm._rate, adm._service_base = 1e-3, 10.0
        adm._finish_times.extend([0.0, 1.0])
        fd._maybe_preempt(fd._classes["interactive"])
        assert fd.metrics()["frontdoor"]["stats"]["preemptions"] >= 1
        assert any(h._req.phase == "swapped" for h in hs)
        adm._rate = None
        assert fd.wait_idle(timeout_s=120.0)
        assert fd.metrics()["frontdoor"]["preempted_held"] == 0
        assert fd.metrics()["frontdoor"]["stats"]["preempt_releases"] >= 1
        _check_streams([[int(t) for t in h.tokens] for h in hs])
        assert isinstance(fleet, ti.ServingFleet)
    finally:
        fleet.close()
