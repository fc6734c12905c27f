"""Port parity: the front door (deepspeed_tpu_torch.inference.frontdoor)
against the JAX package's, on the CPU.

The contracts are those of the JAX package's ``test_frontdoor.py``:

1. ADMISSION MATH: the predictor is optimistic cold and warm from live
   evidence; the retry hint reads a class's own completions first; the
   token bucket refills at its rate.
2. SHEDDING: every shed is a structured ``QueueFull`` with its reason
   (rate_limit / frontdoor_full / deadline / slo), the class, the tenant
   and a class-aware ``retry_after_s`` clamped to RETRY_AFTER_CAP_S.
3. FAIRNESS AND THE GATE: latency tiers before throughput ones, a
   weighted fair queue over (class, tenant) lanes, batch held behind a
   non-empty target queue unless the warm predictor has headroom, and
   preemption that parks batch for a latency budget.
4. OBSERVABILITY: class and tenant labels in ``metrics()`` and in the
   Prometheus text.
5. STREAMING over a real engine: greedy streams equal the JAX front
   door's token for token and sampled ones the port's own batch harvest;
   the front door adds no program key.

Every decision test runs the same script against both packages on the
same injected clock (``pkg``), and ``test_decisions_equal_jax`` holds
the two transcripts (shed reasons and hints, lane order, bucket state)
equal. ``test_bench_frontdoor_smoke_ab_acceptance`` is a wall-clock A/B;
the port is held to its docstring (``test_frontdoor_ab_to_the_docstring``)
and the card reports the A/B (``chip_smoke.py`` ``phase_frontdoor``).
"""

import collections

import numpy as np
import pytest
import torch

import deepspeed_tpu.inference as ji
import deepspeed_tpu.inference.frontdoor as jfd
import deepspeed_tpu_torch.inference as ti
import deepspeed_tpu_torch.inference.frontdoor as tfd
from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu_torch.inference.scheduler import RETRY_AFTER_CAP_S
from deepspeed_tpu_torch.models import GPT2Config
from tests.test_torch_inference import SERVE, models, prompts
from tests.test_torch_telemetry import _parse_prom

torch.set_num_threads(1)

PKGS = {"jax": (ji, jfd), "port": (ti, tfd)}
PKG_IDS = ["jax", "port"]


class _Clock(object):
    """Manually advanced clock shared by the front door under test."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


class _FakeReq(object):
    def __init__(self, rid, prompt, max_new_tokens, priority, tenant, now):
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.priority = priority
        self.tenant = tenant
        self.tokens = []
        self.phase = "decoding"
        self.submit_time = now
        self.first_token_time = None
        self.finish_time = None

    @property
    def done(self):
        return self.finish_time is not None


class _FakeTarget(object):
    """Engine-shaped stub: the surface FrontDoor probes, a switchable
    submit() refusal (raising ``queue_full``, the package's QueueFull)
    and an engine that finishes one request per step."""

    class _Config(object):
        def __init__(self, max_slots, host_offload):
            self.max_slots = max_slots
            self.host_offload = host_offload
            self.max_new_tokens = 16
            self.max_len = 64

    class _Sched(object):
        def __init__(self):
            self.queue = collections.deque()

    def __init__(self, clock, queue_full, max_slots=2, host_offload=False,
                 refuse=False):
        self.config = self._Config(max_slots, host_offload)
        self._scheduler = self._Sched()
        self._clock = clock
        self._queue_full = queue_full
        self.refuse = refuse
        self.submitted = []
        self.preempt_calls = []
        self.release_calls = []
        self.counters = {"requests_completed": 0, "tokens_out": 0}
        self._rids = iter(range(10**6))
        self.compile_count = 1

    def submit(self, prompt, max_new_tokens=None, priority=None,
               tenant=None, **kw):
        if self.refuse:
            raise self._queue_full("fake target full", queue_depth=0)
        req = _FakeReq(next(self._rids), prompt, max_new_tokens,
                       priority, tenant, self._clock())
        self.submitted.append(req)
        return req

    def step(self):
        for req in self.submitted:
            if not req.done:
                now = self._clock()
                req.tokens.extend(range(req.max_new_tokens or 1))
                req.first_token_time = now
                req.finish_time = now
                req.phase = "done"
                self.counters["requests_completed"] += 1
                self.counters["tokens_out"] += len(req.tokens)
                return

    @property
    def idle(self):
        return not self._scheduler.queue and all(
            r.done for r in self.submitted)

    def cancel(self, req):
        if req.done:
            return False
        req.phase = "cancelled"
        req.finish_time = self._clock()
        return True

    def preempt(self, req):
        self.preempt_calls.append(req.rid)
        req.phase = "swapped"
        return True

    def release_preempted(self, req=None):
        self.release_calls.append(None if req is None else req.rid)
        if req is not None and req.phase == "swapped":
            req.phase = "decoding"

    def metrics(self, reset=False):
        return {"compile_count": self.compile_count}

    def prometheus(self):
        return ""


def _target(pkg, clk, **kw):
    return _FakeTarget(clk, PKGS[pkg][0].QueueFull, **kw)


def _warm_admission(fd, clk, rate=10.0, token_rate=100.0, service_s=0.01):
    """Two poll windows and two finishes: the predictor leaves its cold
    state with known rates."""
    adm = fd._admission
    adm.observe_poll(0, 0)
    clk.advance(1.0)
    adm.observe_poll(int(rate), int(token_rate))
    adm.observe_finish("interactive", service_s)
    clk.advance(1.0)
    adm.observe_poll(int(2 * rate), int(2 * token_rate))
    adm.observe_finish("interactive", service_s)
    assert not adm.cold


def _fd_of(pkg, clk, target, **cfg_kw):
    mod = PKGS[pkg][0]
    cfg_kw.setdefault("classes", (
        mod.PriorityClass("interactive", ttft_budget_ms=100.0, weight=4.0),
        mod.PriorityClass("batch", weight=1.0, preemptible=True),
    ))
    return mod.FrontDoor(target, mod.FrontDoorConfig(**cfg_kw), clock=clk,
                         sleep=lambda s: clk.advance(s))


# ----------------------------------------------------- admission math


@pytest.mark.parametrize("pkg", PKG_IDS)
def test_admission_cold_then_warm_prediction(pkg):
    clk = _Clock()
    adm = PKGS[pkg][1].AdmissionController(alpha=0.5, slots=2, clock=clk)
    assert adm.cold
    assert adm.predict_ttft_s(5) is None
    assert adm.predict_e2e_s(5, 16) is None
    adm.observe_poll(0, 0)
    clk.advance(1.0)
    adm.observe_poll(10, 200)
    adm.observe_finish("interactive", 0.05)
    clk.advance(1.0)
    adm.observe_poll(20, 400)
    adm.observe_finish("interactive", 0.05)
    assert not adm.cold
    assert adm.predict_ttft_s(10) == pytest.approx(10 / 10.0 + 0.05)
    assert adm.predict_e2e_s(10, 100) == pytest.approx(
        10 / 10.0 + 0.05 + 100 / 100.0)


@pytest.mark.parametrize("pkg", PKG_IDS)
def test_admission_poll_skips_sub_interval_noise(pkg):
    clk = _Clock()
    adm = PKGS[pkg][1].AdmissionController(clock=clk)
    adm.observe_poll(0, 0)
    clk.advance(0.05)
    adm.observe_poll(1000, 1000)
    assert adm._rate is None
    clk.advance(1.0)
    adm.observe_poll(10, 100)
    assert adm._rate == pytest.approx(10 / 1.05, rel=1e-3)


@pytest.mark.parametrize("pkg", PKG_IDS)
def test_admission_retry_hint_prefers_class_evidence(pkg):
    clk = _Clock()
    adm = PKGS[pkg][1].AdmissionController(clock=clk)
    for _ in range(4):
        clk.advance(1.0)
        adm.observe_finish("batch")
    for _ in range(4):
        clk.advance(0.1)
        adm.observe_finish("interactive")
    hint_i = adm.retry_hint_s("interactive")
    hint_b = adm.retry_hint_s("batch")
    assert hint_i == pytest.approx(0.1, rel=1e-3)
    assert hint_b > hint_i
    assert adm.retry_hint_s("gold") is not None


@pytest.mark.parametrize("pkg", PKG_IDS)
def test_token_bucket_refill_and_retry_after(pkg):
    b = PKGS[pkg][1].TokenBucket(rate=2.0, burst=2.0, now=0.0)
    assert b.take(0.0) and b.take(0.0)
    assert not b.take(0.0)
    assert b.retry_after(0.0) == pytest.approx(0.5)
    assert b.take(0.6)
    assert not b.take(0.6)


# ---------------------------------------------------- config validation


def test_frontdoor_config_validates_loudly():
    with pytest.raises(ValueError, match="unknown FrontDoorConfig key"):
        tfd.FrontDoorConfig.from_dict({"clases": ()})
    with pytest.raises(ValueError, match="duplicate class names"):
        tfd.FrontDoorConfig(classes=(tfd.PriorityClass("a"),
                                     tfd.PriorityClass("a")),
                            default_class="a")
    with pytest.raises(ValueError, match="default_class"):
        tfd.FrontDoorConfig(classes=(tfd.PriorityClass("a"),),
                            default_class="b")
    with pytest.raises(ValueError, match="ttft_budget_ms"):
        tfd.PriorityClass("x", ttft_budget_ms=0.0)
    with pytest.raises(ValueError, match="rate"):
        tfd.TenantPolicy("t", rate=-1.0)
    with pytest.raises(ValueError, match="batch_headroom"):
        tfd.FrontDoorConfig(batch_headroom=0.0)
    cfg = tfd.FrontDoorConfig.from_dict({
        "classes": [{"name": "gold", "ttft_budget_ms": 50.0},
                    {"name": "bulk"}],
        "tenants": [{"name": "t1", "rate": 5.0}],
        "default_class": "gold"})
    assert cfg.classes[0].is_latency and not cfg.classes[1].is_latency
    assert cfg.tenants[0].bucket_burst == 5.0
    # The defaults are the JAX package's.
    assert tfd.DEFAULT_CLASSES == tuple(
        tfd.PriorityClass(**vars(c)) for c in jfd.DEFAULT_CLASSES)
    j, t = jfd.FrontDoorConfig(), tfd.FrontDoorConfig()
    for name in ("default_class", "default_tenant", "batch_headroom",
                 "cold_depth", "preempt_max", "ewma_alpha",
                 "stream_poll_s"):
        assert getattr(j, name) == getattr(t, name), name


# ------------------------------------------------------------ shedding


@pytest.mark.parametrize("pkg", PKG_IDS)
def test_rate_limit_shed_is_structured_and_clamped(pkg):
    mod = PKGS[pkg][0]
    clk = _Clock()
    fd = _fd_of(pkg, clk, _target(pkg, clk),
                tenants=(mod.TenantPolicy("slow", rate=1e-6, burst=1.0),))
    fd.submit([1, 2], max_new_tokens=2, tenant="slow")
    with pytest.raises(mod.QueueFull) as ei:
        fd.submit([1, 2], max_new_tokens=2, tenant="slow")
    exc = ei.value
    assert exc.reason == "rate_limit"
    assert exc.priority == "interactive" and exc.tenant == "slow"
    assert exc.retry_after_s == RETRY_AFTER_CAP_S
    assert fd.metrics()["frontdoor"]["sheds"] == {
        "interactive/slow/rate_limit": 1}


@pytest.mark.parametrize("pkg", PKG_IDS)
def test_frontdoor_full_shed_per_lane_cap(pkg):
    mod = PKGS[pkg][0]
    clk = _Clock()
    target = _target(pkg, clk, refuse=True)
    fd = _fd_of(pkg, clk, target, classes=(
        mod.PriorityClass("interactive", ttft_budget_ms=100.0,
                          max_pending=1),
        mod.PriorityClass("batch"),
    ))
    fd.submit([1], max_new_tokens=1)
    with pytest.raises(mod.QueueFull) as ei:
        fd.submit([1], max_new_tokens=1)
    assert ei.value.reason == "frontdoor_full"
    assert ei.value.queue_depth == 1
    fd.submit([1], max_new_tokens=1, priority="batch")


@pytest.mark.parametrize("pkg", PKG_IDS)
def test_deadline_shed_at_submit_when_eta_exceeds_deadline(pkg):
    mod = PKGS[pkg][0]
    clk = _Clock()
    target = _target(pkg, clk)
    fd = _fd_of(pkg, clk, target)
    _warm_admission(fd, clk, rate=10.0, token_rate=100.0)
    target._scheduler.queue.extend(range(5))
    with pytest.raises(mod.QueueFull) as ei:
        fd.submit([1], max_new_tokens=50, deadline_ms=100.0)
    assert ei.value.reason == "deadline"
    target._scheduler.queue.clear()
    h = fd.submit([1], max_new_tokens=2, deadline_ms=10_000.0)
    assert h.phase == "decoding"
    with pytest.raises(ValueError, match="deadline_ms"):
        fd.submit([1], max_new_tokens=2, deadline_ms=0)


@pytest.mark.parametrize("pkg", PKG_IDS)
def test_slo_shed_when_warm_prediction_exceeds_budget(pkg):
    mod = PKGS[pkg][0]
    clk = _Clock()
    target = _target(pkg, clk)
    fd = _fd_of(pkg, clk, target)
    _warm_admission(fd, clk, rate=10.0)
    target._scheduler.queue.extend(range(50))
    with pytest.raises(mod.QueueFull) as ei:
        fd.submit([1], max_new_tokens=2)
    exc = ei.value
    assert exc.reason == "slo" and exc.priority == "interactive"
    assert exc.retry_after_s is not None
    fd2 = _fd_of(pkg, clk, target, classes=(
        mod.PriorityClass("interactive", ttft_budget_ms=100.0,
                          shed_on_budget=False),
        mod.PriorityClass("batch"),
    ))
    _warm_admission(fd2, clk, rate=10.0)
    h = fd2.submit([1], max_new_tokens=2)
    assert h.phase in ("pending", "decoding")


@pytest.mark.parametrize("pkg", PKG_IDS)
def test_deadline_expires_in_lane_without_dispatch(pkg):
    clk = _Clock()
    target = _target(pkg, clk, refuse=True)
    fd = _fd_of(pkg, clk, target)
    h = fd.submit([1], max_new_tokens=2, deadline_ms=50.0)
    assert h.phase == "pending"
    clk.advance(0.2)
    fd.step()
    assert h.phase == "expired" and h.done
    assert target.submitted == []
    assert fd.metrics()["frontdoor"]["stats"]["expired"] == 1
    assert [x.hid for x in fd.harvest()] == [h.hid]


# ------------------------------------------------- tiers, WFQ, the gate


@pytest.mark.parametrize("pkg", PKG_IDS)
def test_latency_tier_dispatches_before_batch(pkg):
    clk = _Clock()
    target = _target(pkg, clk, refuse=True)
    fd = _fd_of(pkg, clk, target)
    fd.submit([1], max_new_tokens=1, priority="batch")
    fd.submit([2], max_new_tokens=1, priority="interactive")
    target.refuse = False
    fd.step()
    assert [r.priority for r in target.submitted[:2]] == [
        "interactive", "batch"]


@pytest.mark.parametrize("pkg", PKG_IDS)
def test_weighted_fair_queue_shares_by_tenant_weight(pkg):
    mod = PKGS[pkg][0]
    clk = _Clock()
    target = _target(pkg, clk, refuse=True)
    fd = _fd_of(pkg, clk, target,
                tenants=(mod.TenantPolicy("heavy", weight=3.0),
                         mod.TenantPolicy("light", weight=1.0)))
    for _ in range(4):
        fd.submit([1], max_new_tokens=1, tenant="heavy")
        fd.submit([2], max_new_tokens=1, tenant="light")
    target.refuse = False
    fd.step()
    order = [r.tenant for r in target.submitted]
    assert len(order) == 8
    assert order[:4].count("heavy") == 3
    assert "light" in order[:4]


@pytest.mark.parametrize("pkg", PKG_IDS)
def test_batch_gate_holds_batch_behind_nonempty_queue(pkg):
    clk = _Clock()
    target = _target(pkg, clk)
    fd = _fd_of(pkg, clk, target)
    target._scheduler.queue.append(object())
    h = fd.submit([1], max_new_tokens=1, priority="batch")
    assert h.phase == "pending" and target.submitted == []
    assert fd.metrics()["frontdoor"]["stats"]["deferrals"] >= 1
    target._scheduler.queue.clear()
    fd.submit([2], max_new_tokens=1, priority="batch")
    assert len(target.submitted) == 2
    fd.submit([3], max_new_tokens=1, priority="batch")
    assert len(target.submitted) == 2


@pytest.mark.parametrize("pkg", PKG_IDS)
def test_batch_flows_when_warm_predictor_has_headroom(pkg):
    mod = PKGS[pkg][0]
    clk = _Clock()
    target = _target(pkg, clk)
    fd = _fd_of(pkg, clk, target, batch_headroom=1.0, classes=(
        mod.PriorityClass("interactive", ttft_budget_ms=60_000.0),
        mod.PriorityClass("batch"),
    ))
    _warm_admission(fd, clk, rate=100.0)
    for i in range(5):
        fd.submit([i], max_new_tokens=1, priority="batch")
    assert len(target.submitted) == 5


@pytest.mark.parametrize("pkg", PKG_IDS)
def test_preemption_parks_batch_for_latency_budget(pkg):
    mod = PKGS[pkg][0]
    clk = _Clock()
    target = _target(pkg, clk, host_offload=True)
    fd = _fd_of(pkg, clk, target)
    b = fd.submit([1], max_new_tokens=8, priority="batch")
    assert b.phase == "decoding"
    _warm_admission(fd, clk, rate=10.0)
    target._scheduler.queue.extend(range(50))
    with pytest.raises(mod.QueueFull):
        fd.submit([2], max_new_tokens=1)
    assert target.preempt_calls == [b._req.rid]
    assert b._req.phase == "swapped"
    stats = fd.metrics()["frontdoor"]
    assert stats["stats"]["preemptions"] == 1
    assert stats["preempted_held"] == 1
    assert stats["preemptions_by_class"] == {"batch": 1}
    target._scheduler.queue.clear()
    fd.step()
    assert target.release_calls == [b._req.rid]
    assert fd.metrics()["frontdoor"]["preempted_held"] == 0


def _decision_script(pkg):
    """One fixed script of submissions, refusals, clock steps and
    steps; returns its transcript: every shed's (reason, class, tenant,
    hint, depth), the dispatch order, each bucket's (tokens, t_last), the
    frontdoor stats and the predictor's state."""
    mod = PKGS[pkg][0]
    clk = _Clock()
    target = _target(pkg, clk, host_offload=True, max_slots=3)
    fd = _fd_of(pkg, clk, target,
                tenants=(mod.TenantPolicy("a", weight=2.0, rate=4.0,
                                          burst=3.0),
                         mod.TenantPolicy("b", weight=1.0)),
                batch_headroom=0.25)
    log = []
    rng = np.random.RandomState(11)
    for i in range(60):
        if i == 20:
            target.refuse = True
        if i == 35:
            target.refuse = False
        if i == 40:
            _warm_admission(fd, clk, rate=20.0)
        if i == 45:
            target._scheduler.queue.extend(range(30))
        if i == 52:
            target._scheduler.queue.clear()
        kw = {"max_new_tokens": int(rng.randint(1, 9)),
              "priority": ("interactive", "batch")[rng.randint(2)],
              "tenant": ("a", "b")[rng.randint(2)]}
        if rng.rand() < 0.2:
            kw["deadline_ms"] = float(rng.choice([30.0, 5_000.0]))
        try:
            h = fd.submit([i], **kw)
            log.append(("admit", h.hid, h.phase))
        except mod.QueueFull as e:
            log.append(("shed", e.reason, e.priority, e.tenant,
                        e.retry_after_s, e.queue_depth))
        clk.advance(float(rng.choice([0.01, 0.05, 0.3])))
        if i % 3 == 0:
            fd.step()
    fd.wait_idle(timeout_s=1e9)
    m = fd.metrics()["frontdoor"]
    buckets = {k: (round(b._tokens, 9), b._t_last)
               for k, b in sorted(fd._buckets.items())}
    return {"log": log,
            "order": [(r.priority, r.tenant, r.prompt[0])
                      for r in target.submitted],
            "buckets": buckets, "stats": m["stats"], "sheds": m["sheds"],
            "admissions": m["admissions"],
            "preempts": target.preempt_calls,
            "releases": target.release_calls,
            "harvest": [(h.hid, h.phase) for h in fd.harvest()]}


def test_decisions_equal_jax():
    """The same script on the same clock through both front doors:
    identical sheds (reason, class, tenant, hint), lane order, bucket
    state, preemptions and harvest."""
    want, got = _decision_script("jax"), _decision_script("port")
    assert any(e[0] == "shed" for e in got["log"])
    assert len(got["order"]) > 10
    assert got == want


def test_scheduler_retry_after_is_class_aware():
    sched = ti.Scheduler(num_slots=2, max_queue=4)
    sched._finish_times.extend([0.0, 2.0, 4.0, 6.0])
    sched._finish_by_class["interactive"] = collections.deque(
        [10.0, 10.1, 10.2], maxlen=32)
    assert sched.retry_after_s() == pytest.approx(2.0)
    assert sched.retry_after_s("interactive") == pytest.approx(0.1)
    assert sched.retry_after_s("batch") == pytest.approx(2.0)
    err = sched.queue_full_error(priority="interactive", tenant="t9")
    assert err.reason == "queue_full"
    assert err.priority == "interactive" and err.tenant == "t9"
    assert err.retry_after_s == pytest.approx(0.1)
    sched._finish_by_class["interactive"] = collections.deque(
        [0.0, 1e6], maxlen=32)
    assert sched.retry_after_s("interactive") == RETRY_AFTER_CAP_S


def test_scheduler_records_completions_by_class():
    """Completion evidence lands per class exactly as in the JAX
    scheduler: the same admissions and completions leave the same
    classes in ``_finish_by_class``."""
    out = {}
    for name, mod in (("jax", ji), ("port", ti)):
        s = mod.Scheduler(num_slots=2, max_queue=8)
        for i, pr in enumerate(("interactive", "batch", None, "batch")):
            s.submit(np.array([i]), 4, 0.0, 0, -1, 0, priority=pr)
        for _ in range(2):
            for req, slot in s.admissions():
                s.complete(slot)
        out[name] = {k: len(v) for k, v in s._finish_by_class.items()}
    assert out["port"] == out["jax"] == {"interactive": 1, "batch": 2}


# -------------------------------------------------------- observability


def test_metrics_and_prometheus_carry_class_tenant_labels():
    clk = _Clock()
    fd = _fd_of("port", clk, _target("port", clk),
                tenants=(ti.TenantPolicy("acme", rate=1e-6, burst=1.0),))
    fd.submit([1], max_new_tokens=2, tenant="acme")
    fd.step()
    with pytest.raises(ti.QueueFull):
        fd.submit([1], max_new_tokens=2, tenant="acme")
    m = fd.metrics()["frontdoor"]
    assert m["stats"]["admitted"] == 1 and m["stats"]["sheds"] == 1
    assert m["admissions"] == {"interactive/acme": 1}
    assert m["sheds"] == {"interactive/acme/rate_limit": 1}
    assert m["predictor"]["cold"] in (True, False)
    kinds, samples = _parse_prom(fd.prometheus())
    assert kinds["ds_tpu_frontdoor_admissions_total"] == "counter"
    assert kinds["ds_tpu_frontdoor_sheds_total"] == "counter"
    assert samples[("ds_tpu_frontdoor_admissions_total",
                    (("engine", "frontdoor"),
                     ("priority", "interactive"),
                     ("tenant", "acme")))] == 1.0
    assert samples[("ds_tpu_frontdoor_sheds_total",
                    (("engine", "frontdoor"),
                     ("priority", "interactive"),
                     ("reason", "rate_limit"),
                     ("tenant", "acme")))] == 1.0
    assert samples[("ds_tpu_frontdoor_completed_total",
                    (("engine", "frontdoor"),
                     ("priority", "interactive"),
                     ("tenant", "acme")))] == 1.0


# ------------------------------------------------------------ streaming


_STREAM_LENS = [5, 9, 6, 12]
_FD_CLASSES = {"interactive": dict(ttft_budget_ms=60_000.0),
               "batch": dict(preemptible=True)}


def _stream_kw(i):
    kw = {"max_new_tokens": 5 + (i % 3)}
    if i % 2:
        kw["temperature"] = 0.7
        kw["seed"] = 100 + i
    return kw


def _engine(pkg, **cfg):
    jmodel, params, tree = models()
    cfg = dict(dict(SERVE, max_queue=32), **cfg)
    if pkg == "jax":
        return JEngine(jmodel, params, config=dict(
            cfg, use_flash_decode=False, perf_xray=False))
    return ti.InferenceEngine(GPT2Config.tiny(dtype=torch.float32), tree,
                              config=cfg, device="cpu")


def _frontdoor(pkg, target):
    mod = PKGS[pkg][0]
    return mod.FrontDoor(target, mod.FrontDoorConfig(classes=tuple(
        mod.PriorityClass(n, **kw) for n, kw in _FD_CLASSES.items())))


def _drain_round_robin(streams):
    """Interleave consumption across all streams and return each
    stream's token list."""
    out = [[] for _ in streams]
    live = set(range(len(streams)))
    while live:
        for i in sorted(live):
            try:
                out[i].append(next(streams[i]))
            except StopIteration:
                live.discard(i)
    return out


def test_stream_parity_greedy_and_sampled_vs_batch_harvest():
    ps = prompts(_STREAM_LENS)
    ref_eng = _engine("port")
    ref = [ref_eng.submit(p, **_stream_kw(i)) for i, p in enumerate(ps)]
    ref_eng.run()
    got = {}
    for pkg in PKG_IDS:
        eng = _engine(pkg)
        fd = _frontdoor(pkg, eng)
        streams = [fd.stream(p, **_stream_kw(i)) for i, p in enumerate(ps)]
        got[pkg] = _drain_round_robin(streams)
        assert fd.idle
        assert fd.metrics()["frontdoor"]["stats"]["completed"] == len(ps)
        if pkg == "port":
            # No program key of its own: the bare engine's count.
            assert fd.compile_count == ref_eng.compile_count
            assert eng.recompile_detector.recompiles.value == 0
    assert got["port"] == [list(r.tokens) for r in ref]
    for i in range(0, len(ps), 2):
        assert got["port"][i] == got["jax"][i]


def test_stream_close_cancels_in_flight_request():
    ps = prompts([6, 7])
    out = {}
    for pkg in PKG_IDS:
        fd = _frontdoor(pkg, _engine(pkg))
        victim = fd.stream(ps[0], max_new_tokens=8)
        other = fd.stream(ps[1], max_new_tokens=4)
        first = next(victim)
        victim.close()
        assert victim.handle.phase == "cancelled"
        with pytest.raises(StopIteration):
            next(victim)
        out[pkg] = (int(first), [int(t) for t in other])
        assert fd.wait_idle(timeout_s=30.0)
    assert out["port"] == out["jax"]


def test_stream_for_existing_handle_and_context_manager():
    (p,) = prompts([6])
    out = {}
    for pkg in PKG_IDS:
        fd = _frontdoor(pkg, _engine(pkg))
        h = fd.submit(p, max_new_tokens=5)
        with fd.stream_for(h) as s:
            got = [int(t) for t in s]
        assert [int(t) for t in fd.stream_for(h)] == got
        out[pkg] = got
    assert out["port"] == out["jax"]


def test_frontdoor_over_warm_engine_adds_no_key_or_capture():
    """Warm the engine on every key the traffic meets, mark it warm, then
    serve a mixed two-class load through the front door: no key is added
    and the detector counts no recompile; every request completes."""
    eng = _engine("port", host_offload=True, swap_slots=4)
    warm = [eng.submit(p, **_stream_kw(i))
            for i, p in enumerate(prompts([5, 6]))]
    eng.run()
    assert all(r.phase == "done" for r in warm)
    keys = sorted(eng._programs)
    eng.recompile_detector.mark_warm()
    fd = _frontdoor("port", eng)
    hs = [fd.submit(p, priority=("interactive", "batch")[i % 2],
                    **_stream_kw(i))
          for i, p in enumerate(prompts([5, 9, 6, 12, 7, 8]))]
    assert fd.wait_idle(timeout_s=60.0)
    assert all(h.phase == "done" for h in hs)
    assert sorted(eng._programs) == keys
    assert eng.recompile_detector.recompiles.value == 0


def test_frontdoor_ab_to_the_docstring():
    """The JAX acceptance test's docstring, on an injected clock instead
    of the wall clock: with the front door, interactive requests submitted
    behind a batch flood wait for no batch request in the target's queue
    (zero lost, no new key); without it, the same interactive requests sit
    behind the whole batch FIFO."""
    def run(frontdoor):
        eng = _engine("port", max_queue=64)
        target = _frontdoor("port", eng) if frontdoor else eng
        batch = [target.submit(p, max_new_tokens=6,
                               **({"priority": "batch"} if frontdoor
                                  else {}))
                 for p in prompts([8] * 12, seed=5)]
        inter = [target.submit(p, max_new_tokens=4,
                               **({"priority": "interactive"}
                                  if frontdoor else {}))
                 for p in prompts([5, 6, 7], seed=6)]
        steps_to_first = [None] * len(inter)
        n = 0
        while not target.idle:
            target.step()
            n += 1
            for i, h in enumerate(inter):
                if steps_to_first[i] is None and h.tokens:
                    steps_to_first[i] = n
        assert all(h.phase == "done" for h in batch + inter)
        return steps_to_first, eng
    on, eng_on = run(True)
    off, eng_off = run(False)
    assert max(on) < min(off)
