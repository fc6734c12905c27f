"""Port parity: crash-only serving (deepspeed_tpu_torch.inference's
faults, resilience and the engine's recovery, cancel, drain and
deadlines) against the JAX package's, on the CPU.

The contracts are those of the JAX package's ``test_resilience.py``,
``test_chunked_prefill.py`` (cancel), ``test_telemetry.py`` (the
resilience families) and ``test_loadgen.py`` (chaos mode):

1. PRIMITIVES: fault plans validate, injectors step and corrupt a
   harvest, health machines move and export, exactly as the JAX
   package's on the same inputs; ``fatal_step_errors()`` is the torch
   family and holds no bare RuntimeError.
2. RECOVERY INVARIANT: a ``raise`` or ``nan`` fault mid-decode under a
   mixed workload (spec and non-spec, greedy and sampled, prefill in
   flight), on a dense and on a paged int8 pool, loses no request; the
   recovered streams equal the fault-free ones token for token, the
   greedy ones also the JAX engine's recovered streams; ``compile_count``
   does not move, every pool tensor keeps its address, and the recovery
   log and counters equal the JAX engine's. A failure while the device
   is reset ends ``dead``.
3. The rest of the JAX cases: residual budget and one TTFT, dead is
   terminal, the streak reset, stall then heal, drain, ``run(timeout_s)``,
   structured QueueFull and ``admission_block``, deadlines, ``close()``,
   cancel mid-prefill, mid-decode and at its edges, the Prometheus
   families, and the chaos runner with zero requests lost.

Sampled streams are not compared with the JAX engine's: the port draws
from a (seed, position) generator, not threefry. The stall test sleeps
0.2 s against a 0.05 s budget; nothing else depends on the wall clock.
"""

import time

import numpy as np
import pytest
import torch

import deepspeed_tpu.inference as ji
import deepspeed_tpu.loadgen as jl
import deepspeed_tpu.telemetry as jt
import deepspeed_tpu_torch.inference as ti
import deepspeed_tpu_torch.inference.engine as engine_mod
import deepspeed_tpu_torch.loadgen as tl
import deepspeed_tpu_torch.telemetry as tt
from deepspeed_tpu.inference.faults import FaultInjector as JInjector
from deepspeed_tpu.inference.resilience import HealthState as JHealth
from deepspeed_tpu_torch.inference.faults import FaultInjector
from deepspeed_tpu_torch.inference.kv_hierarchy import HierarchySpec
from deepspeed_tpu_torch.inference.kv_pool import init_pool, reset_pool
from deepspeed_tpu_torch.inference.resilience import (HealthState,
                                                      StepWatchdog,
                                                      fatal_step_errors)
from deepspeed_tpu_torch.models import GPT2Config
from deepspeed_tpu_torch.models.generation import as_gencfg
from tests.test_torch_inference import SERVE, models, port_engine, prompts
from tests.test_torch_telemetry import _parse_prom

torch.set_num_threads(1)

PACKAGES = {"jax": ji, "port": ti}


def _jax_engine(**extra):
    jmodel, params, _ = models()
    return ji.InferenceEngine(jmodel, params, config=dict(
        SERVE, use_flash_decode=False, perf_xray=False, **extra))


def _engines(**extra):
    return {"jax": _jax_engine(**extra), "port": port_engine(**extra)}


# ------------------------------------------------------------ fault plans

BAD_FAULTS = [
    (("segfault",), {"step": 0}),
    (("raise",), {"step": -1}),
    (("raise",), {"step": 0, "duration_steps": 0}),
    (("raise",), {"step": 0, "stall_s": 1.0}),
    (("stall",), {"step": 0, "stall_s": -1.0}),
]


@pytest.mark.parametrize("case", range(len(BAD_FAULTS)))
def test_fault_validation_equals_jax(case):
    args, kw = BAD_FAULTS[case]
    for mod in PACKAGES.values():
        with pytest.raises(ValueError):
            mod.Fault(*args, **kw)


def test_fault_plan_validation_and_activity_equal_jax():
    got = {}
    for name, mod in PACKAGES.items():
        with pytest.raises(ValueError):
            mod.FaultPlan(faults=())
        with pytest.raises(TypeError):
            mod.FaultPlan(faults=("raise",))
        f = mod.Fault("stall", step=2, duration_steps=3, stall_s=0.1)
        plan = mod.FaultPlan(faults=(f, mod.Fault("raise", step=7)))
        got[name] = [
            [f.active_at(s) for s in range(8)],
            [(s, k, [g.kind for g in plan.active(s, k)])
             for s in range(9) for k in ("stall", "raise", "nan")]]
    assert got["port"] == got["jax"]
    assert got["port"][0] == [False, False, True, True, True, False, False,
                              False]


def _drive(mod, injector_cls, registry):
    """Every hook of an injector over 8 steps of one plan of every kind,
    on seeded numpy harvests: what each hook returned at each step."""
    plan = mod.FaultPlan(faults=(
        mod.Fault("raise", step=1), mod.Fault("nan", step=2,
                                              duration_steps=2),
        mod.Fault("stall", step=4, stall_s=0.25),
        mod.Fault("admission_block", step=5, duration_steps=2)), seed=4321)
    inj = injector_cls(plan, registry=registry)
    rng = np.random.RandomState(0)
    out = []
    for _ in range(8):
        toks = rng.randint(0, 1024, size=(4, 3, 5)).astype(np.int64)
        valid = rng.rand(4, 3, 5) < 0.6
        row = [inj.step_index, inj.admission_blocked(),
               inj.stall_seconds()]
        try:
            inj.maybe_raise()
            row.append(None)
        except RuntimeError as exc:
            row.append((type(exc).__name__, exc.step, str(exc)))
        bad = inj.corrupt_harvest(toks, valid)
        row.append(bad.tolist())
        row.append(inj.exhausted())
        inj.advance()
        out.append(row)
    return out


def test_injector_stepping_and_corrupt_harvest_equal_jax():
    regs = {"jax": jt.MetricsRegistry(), "port": tt.MetricsRegistry()}
    got = {name: _drive(mod, cls, regs[name]) for (name, mod), cls in zip(
        PACKAGES.items(), (JInjector, FaultInjector))}
    assert got["port"] == got["jax"]
    # The nan steps wrote the seeded sentinel into every valid lane.
    sentinel = -2 - 4321 % 1009
    assert any(sentinel in np.asarray(r[4]) for r in got["port"])
    assert regs["port"].snapshot() == regs["jax"].snapshot()
    assert regs["port"].counter("faults_injected").value == 6
    with pytest.raises(TypeError):
        FaultInjector("not a plan")


def test_inject_faults_requires_config_switch():
    eng = port_engine()
    with pytest.raises(ValueError):
        eng.inject_faults(ti.FaultPlan(faults=(ti.Fault("raise", step=0),)))


# --------------------------------------------------- resilience primitives


def _health_walk(health_cls, registry):
    h = health_cls(registry)
    seen = [(h.state, h.index, h.accepting,
             registry.gauge("health_state").value)]
    for state in ("degraded", "healthy", "draining", "zombie", "dead",
                  "dead", "healthy"):
        try:
            h.to(state)
            seen.append((h.state, h.index, h.accepting,
                         registry.gauge("health_state").value))
        except (ValueError, RuntimeError) as exc:
            seen.append(type(exc).__name__)
    return seen


def test_health_state_machine_and_live_gauge_equal_jax():
    assert ti.HEALTH_STATES == ji.HEALTH_STATES == (
        "healthy", "degraded", "draining", "dead")
    got = _health_walk(HealthState, tt.MetricsRegistry())
    assert got == _health_walk(JHealth, jt.MetricsRegistry())
    assert got[-1] == "EngineDeadError" and got[4] == "ValueError"
    assert got[3] == ("draining", 2, False, 2.0)


def test_step_watchdog_trips_rearms_and_stops():
    trips = []
    wd = StepWatchdog(0.02, trips.append)
    with wd:
        time.sleep(0.08)                        # overruns the budget
    assert wd.tripped and wd.trips == 1 and trips == [0.02]
    with wd:
        pass                                    # fast step: no trip
    assert not wd.tripped and wd.trips == 1
    off = StepWatchdog(None, trips.append)      # disabled
    with off:
        time.sleep(0.03)
    assert not off.tripped
    with pytest.raises(ValueError):
        StepWatchdog(0.0, trips.append)
    late = StepWatchdog(30.0, trips.append)
    late.__enter__()
    late.stop()
    late.stop()                                 # idempotent
    assert late._timer is None and trips == [0.02]


def test_fatal_step_errors_are_the_torch_family():
    errs = fatal_step_errors()
    assert ti.InjectedFault in errs and ti.NumericsError in errs
    assert torch.cuda.OutOfMemoryError in errs
    if hasattr(torch, "AcceleratorError"):
        assert torch.AcceleratorError in errs
    # A programming error is not a device fault.
    assert RuntimeError not in errs
    assert not isinstance(RuntimeError("bug"), errs)
    assert not isinstance(ValueError("bug"), errs)


def test_a_programming_error_reaches_the_caller():
    eng = port_engine(fault_injection=True)
    eng.submit(prompts([6])[0], max_new_tokens=4)

    def broken():
        raise RuntimeError("a bug, not a device fault")

    eng._step_chunked = broken
    with pytest.raises(RuntimeError, match="a bug"):
        eng.step()
    assert eng.recovery_log == [] and eng.health == "healthy"


# ------------------------------------------------------ recovery invariant

LAYOUTS = {"dense": {},
           "paged_int8": {"paged_kv": True, "kv_page_len": 8,
                          "int8_kv": True}}
MIXED = dict(max_slots=3, prefill_chunk=4, spec_decode=True, spec_k=2,
             spec_ngram=2, fault_injection=True)
GREEDY = (0, 2)  # the mixed stream's greedy requests


def _mixed_submit(eng, ps):
    """The JAX test's mixed stream: spec and non-spec, greedy and
    sampled, long and short prompts."""
    return [
        eng.submit(ps[0], max_new_tokens=10),
        eng.submit(ps[1], max_new_tokens=8, temperature=0.8, seed=11),
        eng.submit(ps[2], max_new_tokens=12, spec_decode=False),
        eng.submit(ps[3], max_new_tokens=6, temperature=0.5, seed=7,
                   spec_decode=False),
    ]


def _run_mixed(eng, plan=None):
    reqs = _mixed_submit(eng, prompts([12, 7, 20, 5]))
    if plan is not None:
        # Fire MID-DECODE against a live batch: 4 requests on 3 slots,
        # so the fault also hits queued and prefilling requests.
        while not any(r.phase == "decoding" for r in reqs):
            eng.step()
        eng.inject_faults(plan)
    eng.run()
    return reqs


_REF = {}


def _port_reference(layout):
    if layout not in _REF:
        eng = port_engine(**MIXED, **LAYOUTS[layout])
        _REF[layout] = (eng, _run_mixed(eng))
    return _REF[layout]


def _addresses(eng):
    return {name: t.data_ptr() for name, t in eng._pool.items()}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("kind", ["raise", "nan"])
def test_recovery_invariant_mixed_workload(kind, layout):
    ref_eng, ref = _port_reference(layout)
    eng = port_engine(**MIXED, **LAYOUTS[layout])
    addrs = _addresses(eng)
    got = _run_mixed(eng, ti.FaultPlan(faults=(ti.Fault(kind, step=0),)))
    assert all(r.phase == "done" for r in got)          # zero lost
    assert [r.tokens for r in got] == [r.tokens for r in ref]
    assert len(eng.recovery_log) == 1
    rec = eng.recovery_log[0]
    assert rec["replayed"] >= 1 and rec["duration_s"] >= 0
    assert rec["error"].startswith(
        "NumericsError" if kind == "nan" else "InjectedFault")
    assert sum(r.replays for r in got) == rec["replayed"]
    # No program built again, no tensor of the pool rebound.
    assert eng.compile_count == ref_eng.compile_count
    assert _addresses(eng) == addrs
    assert eng.health == "healthy" and eng.idle
    if eng._pager is not None:
        assert eng.kv_page_stats()["pages_in_use"] == 0
    m = eng.metrics()
    assert (m["recoveries"], m["faults_injected"],
            m["requests_replayed"]) == (1, 1, rec["replayed"])
    # A re-derived token is not delivered (nor counted) twice.
    assert m["tokens_out"] == sum(len(r.tokens) for r in got) == \
        ref_eng.counters["tokens_out"]
    assert all(r.resync is None for r in got)
    # The JAX engine under the same plan: the same greedy streams, the
    # same recovery record (less its clock) and counters.
    jeng = _jax_engine(**MIXED, **LAYOUTS[layout])
    jgot = _run_mixed(jeng, ji.FaultPlan(faults=(ji.Fault(kind, step=0),)))
    assert [got[i].tokens for i in GREEDY] == [jgot[i].tokens for i in GREEDY]
    jrec = jeng.recovery_log[0]
    assert set(rec) == set(jrec)
    for key in ("replayed", "attempt", "error"):
        assert rec[key] == jrec[key], key
    assert [r.replays for r in got] == [r.replays for r in jgot]
    for name in ("recoveries", "faults_injected", "requests_replayed",
                 "requests_completed"):
        assert eng.counters[name] == jeng.counters[name], name


def test_replay_that_disagrees_falls_back_to_prompt_plus_delivered():
    """A replayed request re-derives its delivered tokens through the
    decode lane; if one differs (a device that did not reproduce its
    arithmetic: here a delivered token altered by hand), that request
    takes the JAX engine's replay: prompt + delivered tokens, budget less
    those, so its stream goes on from what was delivered."""
    eng = port_engine(max_slots=2, prefill_chunk=4, fault_injection=True)
    (p,) = prompts([6])
    req = eng.submit(p, max_new_tokens=20)
    while len(req.tokens) < 5:
        eng.step()
    eng.inject_faults(ti.FaultPlan(faults=(ti.Fault("raise", step=0),)))
    eng.step()                                  # the recovery
    assert req.resync == 0 and req.phase == "queued"
    req.tokens[2] = (req.tokens[2] + 1) % 1024
    delivered = list(req.tokens)
    eng.run()
    assert req.phase == "done" and len(req.tokens) == 20
    assert req.tokens[:len(delivered)] == delivered
    assert req.folded == len(delivered) and req.replays == 2
    assert eng.metrics()["requests_replayed"] == 2
    plain = port_engine(max_slots=2, prefill_chunk=4)
    rest = plain.generate([np.concatenate([p, delivered])],
                          max_new_tokens=20 - len(delivered))[0]
    assert req.tokens[len(delivered):] == rest


def _scribble(pool, seed):
    g = torch.Generator().manual_seed(seed)
    for t in pool.values():
        if t.dtype == torch.bool:
            t.copy_(torch.rand(t.shape, generator=g) < 0.5)
        elif t.dtype.is_floating_point:
            t.copy_(torch.randn(t.shape, generator=g))
        else:
            t.copy_(torch.randint(-5, 100, t.shape, generator=g))


POOLS = {"dense": {}, "paged_int8": {"page_len": 8, "int8": True},
         "ring": {"ring": True}, "paged_ring": {"page_len": 8,
                                                "ring": True}}


@pytest.mark.parametrize("layout", sorted(POOLS))
def test_reset_pool_refills_in_place_with_init_pool_values(layout):
    kw = dict(POOLS[layout])
    hier = HierarchySpec(int8=True) if kw.pop("int8", False) else None
    gcfg = as_gencfg(GPT2Config.tiny(dtype=torch.float32))

    def build():
        return init_pool(gcfg, 3, 40, slack=8, device="cpu", hier=hier, **kw)

    pool, fresh = build(), build()
    _scribble(pool, 1)
    addrs = {name: t.data_ptr() for name, t in pool.items()}
    reset_pool(pool, hier)
    assert {name: t.data_ptr() for name, t in pool.items()} == addrs
    assert set(pool) == set(fresh)
    for name, t in fresh.items():
        assert torch.equal(pool[name], t), name
        assert pool[name].dtype == t.dtype, name
    with pytest.raises(ValueError):
        reset_pool(pool, HierarchySpec(int8=hier is None))


def test_speculating_paged_reservation_does_not_grow_under_replay():
    """prompt + budget is invariant under replay (prompt + m emitted,
    budget - m), so a replayed request reserves exactly its original
    pages; the look-ahead's mapping stays inside that reservation."""
    extra = dict(MIXED, paged_kv=True, kv_page_len=8, kv_pages=24)
    eng = port_engine(**extra)
    reserved = {}
    real = eng._pager.reserve

    def reserve(rid, n):
        reserved.setdefault(rid, []).append(n)
        return real(rid, n)

    eng._pager.reserve = reserve
    got = _run_mixed(eng, ti.FaultPlan(faults=(ti.Fault("raise", step=1),)))
    assert eng.recovery_log and all(r.phase == "done" for r in got)
    replayed = [r for r in got if r.replays]
    assert replayed
    for r in replayed:
        assert len(reserved[r.rid]) == 2
        assert reserved[r.rid][0] == reserved[r.rid][1]
    assert eng.kv_page_stats()["pages_in_use"] == 0
    assert eng._pager.outstanding() == 0
    ref = port_engine(**extra)
    assert [r.tokens for r in got] == [r.tokens for r in _run_mixed(ref)]


def test_a_failure_while_the_device_is_reset_ends_dead(monkeypatch):
    """A fatal error in the drain or the in-place reset is a sticky CUDA
    error: the engine goes dead instead of serving on a pool it could not
    reset."""
    if not hasattr(torch, "AcceleratorError"):
        pytest.skip("this torch has no AcceleratorError")
    eng = port_engine(fault_injection=True)
    p = prompts([6])[0]
    eng.submit(p, max_new_tokens=8)
    eng.inject_faults(ti.FaultPlan(faults=(ti.Fault("raise", step=1),)))

    def sticky(pool, hier=None):
        raise torch.AcceleratorError("CUDA error: an illegal memory access "
                                     "was encountered")

    monkeypatch.setattr(engine_mod, "reset_pool", sticky)
    eng.step()
    with pytest.raises(ti.EngineDeadError) as ei:
        eng.step()
    assert isinstance(ei.value.__cause__, torch.AcceleratorError)
    assert eng.health == "dead" and eng.recovery_log == []
    with pytest.raises(ti.EngineDeadError):
        eng.step()
    with pytest.raises(ti.EngineDeadError):
        eng.submit(p)


# -------------------------------------------------- the rest of the cases


def test_replay_preserves_budget_and_single_ttft():
    eng = port_engine(max_slots=2, prefill_chunk=4, fault_injection=True)
    (p,) = prompts([6])
    req = eng.submit(p, max_new_tokens=20)
    while req.phase != "decoding":
        eng.step()
    eng.step()
    emitted_before = len(req.tokens)
    assert 0 < emitted_before < 20
    ttft, admit = req.first_token_time, req.admit_time
    eng.inject_faults(ti.FaultPlan(faults=(ti.Fault("raise", step=0),)))
    eng.run()
    assert req.phase == "done" and req.replays == 1
    assert len(req.tokens) == 20                # residual budget honored
    assert req.first_token_time == ttft         # not re-stamped on replay
    assert req.admit_time == admit
    plain = port_engine(max_slots=2, prefill_chunk=4)
    assert req.tokens == plain.generate([p], max_new_tokens=20)[0]


def test_persistent_failure_ends_dead():
    eng = port_engine(fault_injection=True, recovery_max_retries=1)
    (p,) = prompts([6])
    eng.submit(p, max_new_tokens=4)
    eng.inject_faults(ti.FaultPlan(
        faults=(ti.Fault("raise", step=0, duration_steps=10),)))
    with pytest.raises(ti.EngineDeadError) as ei:
        eng.run()
    assert isinstance(ei.value.__cause__, ti.InjectedFault)
    assert eng.health == "dead" and len(eng.recovery_log) == 1
    for call in (lambda: eng.submit(p), eng.step, eng.drain, eng.undrain,
                 eng.close_admissions):
        with pytest.raises(ti.EngineDeadError):
            call()
    eng.close()
    eng.close()


def test_clean_step_resets_retry_streak():
    eng = port_engine(fault_injection=True, recovery_max_retries=1)
    (p,) = prompts([6])
    req = eng.submit(p, max_new_tokens=40)
    eng.inject_faults(ti.FaultPlan(
        faults=(ti.Fault("raise", step=1), ti.Fault("raise", step=5))))
    eng.run()
    assert req.phase == "done" and len(eng.recovery_log) == 2
    assert [r["attempt"] for r in eng.recovery_log] == [1, 1]
    assert eng.health == "healthy"


def test_stall_fault_trips_watchdog_then_self_heals():
    eng = port_engine(fault_injection=True, step_budget_s=0.05)
    (p,) = prompts([6])
    req = eng.submit(p, max_new_tokens=12)
    eng.inject_faults(ti.FaultPlan(
        faults=(ti.Fault("stall", step=0, stall_s=0.2),)))
    eng.step()                                  # the stalled step
    assert eng.health == "degraded"             # watchdog fired mid-step
    eng.step()                                  # clean step
    assert eng.health == "healthy"              # self-healed
    eng.run()
    assert req.phase == "done"
    m = eng.metrics()
    assert m["step_stalls"] >= 1 and m["health"] == "healthy"
    assert m["faults_injected"] == 1 and m["recoveries"] == 0


def test_drain_settles_idle_and_gates_admissions():
    engines = _engines(max_slots=1)
    for eng in engines.values():
        a, b = (eng.submit(q, max_new_tokens=4) for q in prompts([5, 7]))
        done = eng.drain()
        assert eng.idle and eng.health == "draining"
        assert {r.rid for r in done} == {a.rid, b.rid}
        assert a.phase == b.phase == "done"
        mod = ti if eng is engines["port"] else ji
        with pytest.raises(mod.EngineDraining):
            eng.submit(prompts([5])[0])
        eng.undrain()
        assert eng.health == "healthy"
        assert eng.submit(prompts([5])[0], max_new_tokens=2).rid > b.rid
        eng.run()
    assert [r.tokens for r in engines["port"]._scheduler.completed.values()] \
        == [r.tokens for r in engines["jax"]._scheduler.completed.values()]


def test_run_timeout_s_bounds_wall_clock():
    eng = port_engine(max_slots=1)
    (p,) = prompts([5])
    req = eng.submit(p, max_new_tokens=40)
    out = eng.run(timeout_s=0.0)                # expires after one step
    assert out == [] and not eng.idle and not req.done
    eng.run(max_steps=1)
    assert not req.done
    eng.run()
    assert req.done


def test_queuefull_carries_structured_backpressure_as_jax():
    errs = {}
    for name, mod in PACKAGES.items():
        s = mod.Scheduler(num_slots=1, max_queue=1)
        s.submit(np.arange(4, dtype=np.int32), 4, 0.0, 0, -1, 0)
        with pytest.raises(mod.QueueFull) as ei:
            s.submit(np.arange(4, dtype=np.int32), 4, 0.0, 0, -1, 0)
        first = ei.value
        assert first.retry_after_s is None       # no completions yet
        now = 1000.0
        s._finish_times.extend([now, now + 0.5, now + 1.0])
        assert s.retry_after_s() == pytest.approx(0.5, abs=1e-3)
        later = s.queue_full_error("blocked", cause="pages",
                                   retry_after_s=2.5)
        errs[name] = [
            (str(e), e.queue_depth, e.retry_after_s, e.replica_id,
             e.swap_eligible, e.priority, e.tenant, e.reason)
            for e in (first, s.queue_full_error(), later)]
    assert errs["port"] == errs["jax"]
    assert errs["port"][1][7] == "queue_full"
    assert "retry_after_s" in errs["port"][1][0]
    assert errs["port"][2][1:] == (1, 2.5, None, False, None, None, "pages")


def test_admission_block_fault_sheds_with_structured_queuefull():
    eng = port_engine(fault_injection=True)
    (p,) = prompts([5])
    inj = eng.inject_faults(ti.FaultPlan(
        faults=(ti.Fault("admission_block", step=0),)))
    with pytest.raises(ti.QueueFull) as ei:
        eng.submit(p, max_new_tokens=2)
    assert ei.value.queue_depth == 0            # pressure, not depth
    assert ei.value.reason == "queue_full"
    assert "admission_block" in str(ei.value)
    eng.step()                                  # idle step advances past
    assert inj.exhausted()
    req = eng.submit(p, max_new_tokens=2)       # pressure lifted
    eng.run()
    assert req.phase == "done"
    assert eng.metrics()["faults_injected"] == 1


def test_scheduler_deadline_expiry_is_queue_side_only():
    tracer = tt.SpanRecorder(capacity=64)
    reg = tt.MetricsRegistry()
    s = ti.Scheduler(num_slots=1, max_queue=8, tracer=tracer, registry=reg)
    t = time.time()
    a = s.submit(np.arange(4), 4, 0.0, 0, -1, 0, deadline=t + 100.0)
    b = s.submit(np.arange(4), 4, 0.0, 0, -1, 0, deadline=t + 0.5)
    s.admissions()                              # a takes the only slot
    assert a.phase == "prefilling"
    assert s.expire_deadlines(now=t + 0.1) == []
    assert s.expire_deadlines(now=t + 1.0) == [b]
    assert b.phase == "expired" and b.done and b.tokens == []
    assert s.completed[b.rid] is b
    # a's deadline passing after admission changes nothing.
    assert s.expire_deadlines(now=t + 200.0) == []
    assert a.phase == "prefilling"
    assert reg.counter("deadline_sheds").value == 1
    counts = tracer.span_counts()
    assert counts["request/expired"] == 1 and counts["request"] == 1
    # Free without deadlines.
    plain = ti.Scheduler(num_slots=1, max_queue=8)
    plain.submit(np.arange(4), 4, 0.0, 0, -1, 0)
    assert plain.expire_deadlines(now=t + 1e9) == []


def test_engine_deadline_ms_sheds_expired_queued_requests():
    engines = _engines(max_slots=1)
    for name, eng in engines.items():
        long_p, short_p = prompts([8, 5])
        a = eng.submit(long_p, max_new_tokens=20)   # hogs the only slot
        b = eng.submit(short_p, max_new_tokens=4, deadline_ms=1)
        with pytest.raises(ValueError):
            eng.submit(short_p, deadline_ms=0)
        time.sleep(0.01)
        eng.run()
        assert a.phase == "done" and b.phase == "expired", name
        assert eng.metrics()["deadline_sheds"] == 1
    assert engines["port"].find_request(0).tokens == \
        engines["jax"]._scheduler.completed[0].tokens


def test_close_is_idempotent_and_close_admissions_gates_submit():
    eng = port_engine(step_budget_s=30.0)
    (p,) = prompts([5])
    eng.close_admissions()                      # gate WITHOUT stepping
    assert eng.health == "draining"
    with pytest.raises(ti.EngineDraining):
        eng.submit(p, max_new_tokens=2)
    eng.undrain()
    req = eng.submit(p, max_new_tokens=2)
    eng.run()
    assert req.phase == "done"
    eng.close()
    eng.close()                                 # idempotent
    assert eng._watchdog._timer is None
    assert eng.metrics()["requests_completed"] == 1   # still readable
    eng._health.to("dead")
    with pytest.raises(ti.EngineDeadError):
        eng.close_admissions()


def test_scheduler_cancel_mid_prefill_frees_slot_for_queue():
    s = ti.Scheduler(num_slots=1, max_queue=4)
    a = s.submit(np.arange(20), 4, 0.0, 0, -1, 0)
    c = s.submit(np.arange(3), 4, 0.0, 0, -1, 0)
    s.admissions()
    s.advance_prefill(a, 8)                     # half-way through
    assert s.cancel(a) is True
    assert a.phase == "cancelled" and a.done and a.slot is None
    assert s.cancel(a) is False                 # already finished
    pairs = s.admissions()                      # the freed slot re-admits
    assert [(r.rid, slot) for r, slot in pairs] == [(c.rid, 0)]
    assert s.next_prefill() is c
    q = s.submit(np.arange(3), 4, 0.0, 0, -1, 0)
    assert s.cancel(q) is True and q not in s.queue   # cancel while queued


def _cancel_script(eng):
    """The JAX cancel test's script: a long prompt cancelled mid-prefill
    (the queued request behind it completes), then a decoding request
    cancelled between steps."""
    long_p, short_p = prompts([40, 6])
    a = eng.submit(long_p, max_new_tokens=4)
    b = eng.submit(short_p, max_new_tokens=5)
    eng.step()                                  # one 4-token chunk
    assert a.phase == "prefilling" and 0 < a.cursor < len(long_p)
    assert eng.cancel(a) is True and a.done and a.tokens == []
    eng.run()
    c = eng.submit(short_p, max_new_tokens=30)
    while c.phase != "decoding":
        eng.step()
    eng.step()
    got = list(c.tokens)
    assert 0 < len(got) < 30
    assert eng.cancel(c) is True
    eng.run()
    assert c.tokens == got and c.phase == "cancelled"
    return [b.tokens, c.tokens]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_engine_cancel_mid_prefill_and_decoding(layout):
    extra = dict(max_slots=1, prefill_chunk=4)
    if layout == "paged":
        extra.update(paged_kv=True, kv_page_len=8)
    engines = _engines(**extra)
    port = engines["port"]
    active = port._pool["active"].data_ptr()
    got = _cancel_script(port)
    assert got == _cancel_script(engines["jax"])
    assert port._pool["active"].data_ptr() == active    # written in place
    assert not bool(port._pool["active"].any())
    if layout == "paged":
        stats = port.kv_page_stats()
        assert stats["pages_in_use"] == 0 and port._pager.outstanding() == 0
    # The stream cut by the cancel is the uncut stream's prefix.
    plain = port_engine(**extra)
    full = plain.generate(prompts([40, 6])[1:], max_new_tokens=30)[0]
    assert got[1] == full[:len(got[1])]


def test_cancel_edge_cases_boundary_double_and_after_complete():
    eng = port_engine(max_slots=1, prefill_chunk=4)
    exact, short = prompts([12, 6])             # 12 = 3 exact chunks
    a = eng.submit(exact, max_new_tokens=4)
    b = eng.submit(short, max_new_tokens=5)
    eng.step()
    assert a.phase == "prefilling" and a.cursor == 4   # exact boundary
    assert eng.cancel(a) is True
    assert eng.cancel(a) is False               # idempotent
    assert a.phase == "cancelled" and a.slot is None and a.tokens == []
    eng.run()
    assert b.phase == "done"
    assert b.tokens == port_engine().generate([short], max_new_tokens=5)[0]
    finish = b.finish_time
    assert eng.cancel(b) is False               # cancel after complete
    assert b.phase == "done" and b.finish_time == finish


def _prometheus_script(eng, mod):
    long_p, short_p = prompts([8, 5])
    eng.submit(long_p, max_new_tokens=12)
    expired = eng.submit(short_p, max_new_tokens=4, deadline_ms=1)
    eng.inject_faults(mod.FaultPlan(faults=(mod.Fault("raise", step=1),)))
    time.sleep(0.01)
    eng.run()
    assert expired.phase == "expired"
    out = [_parse_prom(eng.prometheus())]
    eng.drain()
    out.append(_parse_prom(eng.prometheus()))
    eng.metrics(reset=True)
    out.append(_parse_prom(eng.prometheus()))
    return out


RESILIENCE_SAMPLES = ("ds_tpu_faults_injected_total", "ds_tpu_recoveries_total",
                      "ds_tpu_requests_replayed_total",
                      "ds_tpu_deadline_sheds_total",
                      "ds_tpu_step_stalls_total",
                      "ds_tpu_recovery_seconds_count", "ds_tpu_health_state")


def test_resilience_counters_and_health_gauge_export_as_jax():
    engines = _engines(fault_injection=True, max_slots=1)
    got = {name: _prometheus_script(eng, PACKAGES[name])
           for name, eng in engines.items()}
    lbl = (("engine", "inference"),)
    for (tk, ts), (jk, js) in zip(got["port"], got["jax"]):
        for name in RESILIENCE_SAMPLES:
            assert ts[(name, lbl)] == js[(name, lbl)], name
            fam = name.replace("_count", "")
            assert tk[fam] == jk[fam], fam
    (kinds, first), (_, drained), (_, reset) = got["port"]
    assert kinds["ds_tpu_faults_injected_total"] == "counter"
    assert kinds["ds_tpu_health_state"] == "gauge"
    assert kinds["ds_tpu_recovery_seconds"] == "summary"
    assert first[("ds_tpu_faults_injected_total", lbl)] == 1
    assert first[("ds_tpu_recoveries_total", lbl)] == 1
    assert first[("ds_tpu_requests_replayed_total", lbl)] >= 1
    assert first[("ds_tpu_deadline_sheds_total", lbl)] == 1
    assert first[("ds_tpu_step_stalls_total", lbl)] == 0
    assert first[("ds_tpu_recovery_seconds_count", lbl)] == 1
    assert first[("ds_tpu_health_state", lbl)] == 0.0   # healthy again
    assert drained[("ds_tpu_health_state", lbl)] == 2.0  # live: draining
    assert reset[("ds_tpu_recoveries_total", lbl)] == 1  # never rewinds


# ----------------------------------------------------------------- chaos


def _warm(engine):
    engine.generate(prompts([3], seed=8), max_new_tokens=9)
    engine.recompile_detector.mark_warm()
    engine.metrics(reset=True)


def test_chaos_runner_records_recovery_and_zero_lost():
    """Chaos mode end to end: a fatal fault armed mid-run fires against a
    live batch, the engine recovers, and the run and its report carry the
    recovery with zero requests lost; the report equals the JAX
    package's report of the same result."""
    engine = port_engine(max_slots=4, max_queue=64, fault_injection=True)
    _warm(engine)
    compiled = engine.compile_count
    spec = tl.WorkloadSpec(vocab_size=1024, n_requests=24, prompt_mean=8,
                           prompt_max=16, output_mean=8, output_min=4,
                           output_max=12, rate=80.0, seed=11)
    plan = ti.FaultPlan(faults=(ti.Fault("raise", step=2),))
    res = tl.SustainedRunner(engine, spec, window_seconds=0.1,
                             max_steps=100_000, chaos_plan=plan,
                             chaos_after_s=0.05).run()
    assert res.faults_injected == 1 and res.requests_lost == 0
    assert res.completed == 24 and engine.idle
    assert engine.health == "healthy"
    assert engine.compile_count == compiled
    assert engine.metrics()["recompiles"] == 0
    assert len(res.recovery) == 1
    rec = res.recovery[0]
    assert 0.0 <= rec["t_start_s"] <= rec["t_end_s"] <= res.wall_s
    assert rec["duration_s"] >= 0 and "InjectedFault" in rec["error"]
    rep = tl.build_report(spec, res, tl.SLO(ttft_p99_ms=1e4,
                                            itl_p99_ms=2e3), platform="cpu")
    chaos = rep["chaos"]
    assert chaos["requests_lost"] == 0
    assert chaos["recoveries"] == chaos["faults_injected"] == 1
    assert chaos["recovery_time_s"] == pytest.approx(rec["duration_s"],
                                                     abs=1e-6)
    assert chaos["recovery_intervals"] == res.recovery
    for key in ("slo_attainment_during_recovery",
                "slo_attainment_outside_recovery"):
        assert chaos[key] is None or 0.0 <= chaos[key] <= 1.0
    assert rep == jl.build_report(spec, res, jl.SLO(ttft_p99_ms=1e4,
                                                    itl_p99_ms=2e3),
                                  platform="cpu")


def test_chaos_section_empty_on_fault_free_run():
    engine = port_engine(max_slots=4, max_queue=64)
    _warm(engine)
    spec = tl.WorkloadSpec(vocab_size=1024, n_requests=8, prompt_mean=8,
                           prompt_max=16, output_mean=6, output_max=12,
                           rate=80.0, seed=5)
    res = tl.SustainedRunner(engine, spec, window_seconds=0.1,
                             max_steps=100_000).run()
    assert res.recovery == [] and res.requests_lost == 0
    assert res.faults_injected == 0
    chaos = tl.build_report(spec, res, tl.SLO(ttft_p99_ms=1e4,
                                              itl_p99_ms=2e3))["chaos"]
    assert chaos["recoveries"] == 0 and chaos["recovery_time_s"] == 0.0
    assert chaos["requests_during_recovery"] == 0
    assert chaos["slo_attainment_during_recovery"] is None
