"""Port parity: deepspeed_tpu_torch.telemetry and the serving engine's
telemetry against the JAX package's, on the CPU.

- REGISTRY: the same operations on a port and a JAX ``MetricsRegistry``
  give the same ``snapshot()`` and the same Prometheus text, byte for
  byte (the histograms' seeded reservoirs draw in the same order); the
  JAX package's registry contract holds on the port's (windows,
  gauges read at scrape time, one kind per name, the null registry).
- SPANS: a ``SpanRecorder`` fed the same injected clock gives the same
  Chrome JSON; the ring is bounded with exact counts; ``validate_trace``
  and ``merged_trace`` agree with the JAX package's.
- PROMETHEUS: the text parses with an independent parser, counters
  survive window resets, labels escape, and the stdlib endpoint serves
  the same text while the registry grows.
- RECOMPILES: the detector reads any ``_cache_size()`` and counts a
  growth after ``mark_warm()`` exactly once.
- ENGINE: the same prompts through the JAX and the port engine (tiny
  fp32 GPT-2) give equal streams, equal windowed counters, equal span
  counts per name and equal ``metrics(reset=True)`` windows; the port's
  Prometheus families are the JAX engine's less those of unported
  slices, with equal kinds; telemetry off keeps ``metrics()`` and drops
  the spans.

No test here asserts a wall-clock bound: the host cost of telemetry is
measured on the card (``chip_smoke.py`` ``phase_telemetry``).
"""

import itertools
import json
import logging
import math
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import deepspeed_tpu.telemetry as jt
import deepspeed_tpu_torch.telemetry as tt
from deepspeed_tpu.inference import InferenceEngine as JEngine
from tests.test_torch_inference import SERVE, models, port_engine, prompts

torch.set_num_threads(1)

# ---------------------------------------------------------------- registry


def _script(reg, rng):
    """One fixed mix of registry operations, driven by ``rng``: counters
    with labels, a set and a live gauge, histograms past their
    reservoir, a window reset, label values that need escaping."""
    reg.counter("tokens_out").inc(12)
    reg.counter("hits", pool="kv").inc(3)
    reg.counter("hits", pool="slot").inc(5)
    reg.gauge("queue_depth").set(4)
    box = [7.5]
    reg.gauge("live").set_fn(lambda: box[0])
    reg.gauge("path", where='C:\\tmp\n"x"').set(1)
    reg.gauge("inf").set(float("inf"))
    h = reg.histogram("lat", reservoir_size=64)
    for v in rng.lognormal(0.0, 1.0, size=1000):
        h.observe(float(v))
    reg.histogram("empty")
    first = reg.snapshot(reset=True)
    reg.counter("tokens_out").inc(2)
    for v in rng.uniform(0.0, 1.0, size=300):
        reg.histogram("timer_seconds", timer="fwd").observe(float(v))
    box[0] = 9.0
    return first


@pytest.mark.parametrize("labels", [{}, {"engine": "inference"}])
def test_registry_ops_give_the_jax_snapshot_and_text(labels):
    regs = {}
    firsts = {}
    for name, mod in (("jax", jt), ("port", tt)):
        regs[name] = mod.MetricsRegistry(**labels)
        firsts[name] = _script(regs[name], np.random.RandomState(5))
    assert firsts["port"] == firsts["jax"]
    assert regs["port"].snapshot() == regs["jax"].snapshot()
    assert tt.prometheus_text(regs["port"]) == \
        jt.prometheus_text(regs["jax"])
    assert tt.prometheus_digest(regs["port"]) == \
        jt.prometheus_digest(regs["jax"])
    hp = regs["port"].histogram("lat", reservoir_size=64)
    hj = regs["jax"].histogram("lat", reservoir_size=64)
    assert hp.quantiles((1, 50, 90, 99)) == hj.quantiles((1, 50, 90, 99))


def test_merged_registry_gives_the_jax_text():
    out = {}
    for name, mod in (("jax", jt), ("port", tt)):
        regs = {}
        for rid in (0, 1):
            reg = mod.MetricsRegistry(engine="inference", replica=str(rid))
            reg.counter("tokens_out").inc(10 * (rid + 1))
            reg.histogram("ttft").observe(0.5 * (rid + 1))
            regs[rid] = reg
        plain = mod.MetricsRegistry(engine="inference")
        plain.gauge("queue_depth").set(3)
        regs[7] = plain
        merged = mod.MergedRegistry(regs)
        out[name] = (mod.prometheus_text(merged), merged.snapshot())
        with pytest.raises(TypeError):
            merged.counter("x")
    assert out["port"] == out["jax"]
    assert out["port"][1]["tokens_out{replica=1}"] == 20


def test_counter_monotonic_with_windowed_view():
    c = tt.MetricsRegistry().counter("tokens_out")
    c.inc(5)
    c.inc(3)
    assert c.value == 8 and c.window_value == 8
    c.reset_window()
    assert c.value == 8 and c.window_value == 0
    c.inc(2)
    assert c.value == 10 and c.window_value == 2
    with pytest.raises(ValueError):
        c.inc(-1)


def test_gauge_set_fn_is_sampled_at_read_time():
    g = tt.MetricsRegistry().gauge("depth")
    g.set(4)
    assert g.value == 4.0
    box = [7]
    g.set_fn(lambda: box[0])
    assert g.value == 7.0
    box[0] = 9
    assert g.value == 9.0


def test_histogram_bounded_and_percentiles_nearest_rank():
    h = tt.MetricsRegistry().histogram("lat", reservoir_size=64)
    for v in range(1000):
        h.observe(v)
    assert h.count == 1000 and len(h._sample) == 64
    s = h.stats()
    assert s["min"] == 0 and s["max"] == 999 and s["sum"] == sum(range(1000))
    small = tt.MetricsRegistry().histogram("lat")
    assert small.percentile(50) is None
    for v in [1.0, 2.0, 3.0, 4.0]:
        small.observe(v)
    assert small.percentile(0) == 1.0
    assert small.percentile(50) == 3.0
    assert small.percentile(100) == 4.0


def test_one_name_one_kind_and_const_labels():
    reg = tt.MetricsRegistry(engine="inference")
    a = reg.counter("hits", pool="kv")
    assert a is reg.counter("hits", pool="kv")
    assert a is not reg.counter("hits", pool="slot")
    assert a.labels == {"engine": "inference", "pool": "kv"}
    with pytest.raises(TypeError):
        reg.gauge("hits")
    with pytest.raises(TypeError):
        reg.histogram("hits")


def test_snapshot_reset_opens_new_window_and_null_registry():
    reg = tt.MetricsRegistry()
    reg.counter("n").inc(3)
    reg.gauge("g").set(5)
    reg.histogram("h").observe(1.5)
    snap = reg.snapshot(reset=True)
    assert snap["n"] == 3 and snap["g"] == 5.0 and snap["h"]["count"] == 1
    snap2 = reg.snapshot()
    assert snap2["n"] == 0 and snap2["h"]["count"] == 0 and snap2["g"] == 5.0
    assert reg.counter("n").value == 3
    null = tt.NullRegistry()
    null.counter("a").inc(5)
    null.gauge("b").set_fn(lambda: 1)
    null.histogram("c").observe(2.0)
    assert null.snapshot(reset=True) == {} and list(null.collect()) == []


# ------------------------------------------------------------------ spans


def _clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 0.00125


def _record(mod):
    rec = mod.SpanRecorder(capacity=8, clock=_clock(), pid=3)
    rec.span("long", start=0.0, end=0.01, tid=7, rid=3)
    rec.instant("mark", hop=1)
    with rec.timed("work", tid=2, chunk=1):
        rec.instant("inner")
    for i in range(10):
        rec.instant("tick", i=i)
    return rec


def test_span_recorder_gives_the_jax_chrome_json(tmp_path):
    port, ref = _record(tt), _record(jt)
    assert port.chrome_trace() == ref.chrome_trace()
    assert port.jsonl_lines() == ref.jsonl_lines()
    assert port.span_counts() == ref.span_counts() == {
        "long": 1, "mark": 1, "inner": 1, "work": 1, "tick": 10}
    assert port.dropped == ref.dropped == 6
    assert len(port.events()) == 8
    a = port.write_chrome_trace(str(tmp_path / "port.json"))
    b = ref.write_chrome_trace(str(tmp_path / "jax.json"))
    assert open(a).read() == open(b).read()
    doc = json.loads(open(a).read())
    ts = [e["ts"] for e in doc["traceEvents"]]
    assert ts == sorted(ts) and doc["displayTimeUnit"] == "ms"
    assert tt.validate_trace(doc) == len(ts)


def test_null_recorder_surface():
    rec = tt.NullRecorder()
    with rec.timed("x"):
        rec.instant("y")
    rec.span("z", start=0.0)
    assert rec.span_counts() == {} and rec.events() == []
    with pytest.raises(RuntimeError):
        rec.write_chrome_trace("never.json")


def test_merged_trace_and_validate_trace_agree_with_jax():
    out = {}
    for name, mod in (("jax", jt), ("port", tt)):
        clock = _clock()
        donor = mod.SpanRecorder(capacity=64, clock=clock)
        acceptor = mod.SpanRecorder(capacity=64, clock=clock)
        ctx = mod.TraceContext(1_000_007, origin="test")
        key = "handoff/{}/{}".format(ctx.tid, 0)
        donor.span("request/prefill", start=clock(), tid=ctx.tid,
                   hop=ctx.hop())
        donor.instant("request/handoff", tid=ctx.tid, hop=ctx.hop(),
                      flow_out=key)
        acceptor.instant("request/handoff_in", tid=ctx.tid, hop=ctx.hop(),
                         flow_in=key)
        out[name] = mod.merged_trace({"donor": donor, "acceptor": acceptor})
        assert mod.validate_trace(out[name]) == len(out[name]["traceEvents"])
    assert out["port"] == out["jax"]
    broken = json.loads(json.dumps(out["port"]))
    for ev in broken["traceEvents"]:
        if ev["ph"] == "f":
            ev["id"] = 999
    with pytest.raises(tt.TraceError):
        tt.validate_trace(broken)
    with pytest.raises(tt.TraceError):
        tt.validate_trace({"traceEvents": [{"name": "x", "ph": "X",
                                            "ts": 1.0, "pid": 0, "tid": 0,
                                            "dur": -1.0}]})


def test_distributed_self_check_runs():
    out = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.telemetry.distributed"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "self-check: OK" in out.stdout


# -------------------------------------------------------------- timeseries


def test_timeseries_collector_gives_the_jax_windows():
    out = {}
    for name, mod in (("jax", jt), ("port", tt)):
        reg = mod.MetricsRegistry()
        t = [100.0]
        col = mod.TimeseriesCollector(reg, window_seconds=1.0, capacity=3,
                                      clock=lambda: t[0])
        col.tick()
        for i in range(12):
            reg.counter("tokens_out").inc(i)
            reg.histogram("ttft_seconds").observe(0.01 * i)
            reg.gauge("queue_depth").set(i % 4)
            t[0] += 0.45
            col.tick()
        col.sample()
        out[name] = (col.to_json(), col.chrome_counter_events(epoch=100.0))
    assert out["port"] == out["jax"]
    assert out["port"][0]["dropped"] > 0


# -------------------------------------------------------------- prometheus


def _parse_prom(text):
    """Minimal text-exposition parser, independent of the exporter:
    ({name: kind}, {(name, labels): value})."""
    kinds, samples = {}, {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("#"):
            _, _, name, kind = line.split()
            kinds[name] = kind
            continue
        head, val = line.rsplit(" ", 1)
        if "{" in head:
            name, rest = head.split("{", 1)
            labels = tuple(sorted(
                (kv.split("=", 1)[0], kv.split("=", 1)[1].strip('"'))
                for kv in rest.rstrip("}").split(",")))
        else:
            name, labels = head, ()
        samples[(name, labels)] = float(val)
    return kinds, samples


def test_prometheus_text_parses_and_counters_stay_monotonic():
    reg = tt.MetricsRegistry(engine="inference")
    reg.counter("tokens_out").inc(12)
    reg.gauge("queue_depth").set(3)
    h = reg.histogram("ttft")
    h.observe(0.5)
    h.observe(1.5)
    reg.histogram("empty")
    kinds, samples = _parse_prom(tt.prometheus_text(reg))
    assert kinds["ds_tpu_tokens_out_total"] == "counter"
    assert kinds["ds_tpu_queue_depth"] == "gauge"
    assert kinds["ds_tpu_ttft"] == "summary"
    lbl = ("engine", "inference")
    assert samples[("ds_tpu_tokens_out_total", (lbl,))] == 12
    assert samples[("ds_tpu_ttft_count", (lbl,))] == 2
    assert samples[("ds_tpu_ttft", (lbl, ("quantile", "0.5")))] == 1.5
    assert math.isnan(samples[("ds_tpu_empty", (lbl, ("quantile", "0.5")))])
    reg.reset_window()
    _, after = _parse_prom(tt.prometheus_text(reg))
    assert after[("ds_tpu_tokens_out_total", (lbl,))] == 12


def test_prometheus_label_escaping_and_special_values():
    from deepspeed_tpu_torch.telemetry.exporters import (_escape_label,
                                                         _fmt_value)

    assert _escape_label('a\\b"c\nd') == 'a\\\\b\\"c\\nd'
    assert _escape_label("\\n") == "\\\\n"
    assert _fmt_value(float("inf")) == "+Inf"
    assert _fmt_value(float("-inf")) == "-Inf"
    assert _fmt_value(float("nan")) == "NaN" and _fmt_value(None) == "NaN"
    assert _fmt_value(3) == "3" and _fmt_value(2.5) == "2.5"


def test_prometheus_endpoint_serves_registry_during_churn():
    """Scrapes from several threads while another creates metrics: every
    scrape answers 200 with the registry's text (the collect walk is
    structure-locked); other paths 404."""
    reg = tt.MetricsRegistry()
    reg.counter("base").inc(4)
    ep = tt.PrometheusEndpoint(reg, port=0)
    url = "http://{}:{}/metrics".format(ep.host, ep.port)
    errors = []

    def scrape():
        for _ in range(10):
            try:
                body = urllib.request.urlopen(url, timeout=30).read()
                assert b"ds_tpu_base_total 4" in body
            except Exception as e:  # noqa: BLE001 - collected for assert
                errors.append(e)

    def churn():
        for i in range(300):
            reg.counter("churn_{}".format(i % 30)).inc(1)
            reg.histogram("hist_{}".format(i % 30)).observe(0.1)

    threads = [threading.Thread(target=churn)] + \
        [threading.Thread(target=scrape) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        body = urllib.request.urlopen(url, timeout=10).read().decode()
        assert body == tt.prometheus_text(reg)
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                "http://{}:{}/other".format(ep.host, ep.port), timeout=10)
    finally:
        ep.close()
    assert errors == []


# -------------------------------------------------------------- recompiles


class _FakeCache(object):
    def __init__(self):
        self.size = 0

    def _cache_size(self):
        return self.size


def test_recompile_detector_counts_growth_after_warm_once(caplog):
    reg = tt.MetricsRegistry()
    det = tt.RecompileDetector(reg, describe=lambda label: "key (1, 2)")
    prog = _FakeCache()
    det.watch("mixed_step", prog)
    with pytest.raises(TypeError):
        det.watch("plain", object())
    prog.size = 2
    assert reg.gauge("compile_count").value == 2
    assert det.observe() == 0  # growth before warm-up is not a recompile
    assert det.mark_warm() == 2 and det.warm
    assert det.observe() == 0
    prog.size = 3
    with caplog.at_level(logging.WARNING, logger="DeepSpeedTPUTorch"):
        # The package logger does not propagate: hook caplog onto it.
        logger = logging.getLogger("DeepSpeedTPUTorch")
        logger.addHandler(caplog.handler)
        try:
            assert det.observe() == 1
        finally:
            logger.removeHandler(caplog.handler)
    assert det.observe() == 0
    assert reg.counter("recompiles").value == 1
    assert reg.gauge("compile_count").value == 3
    assert "mixed_step" in caplog.text and "key (1, 2)" in caplog.text


# ------------------------------------------------- annotate/profile/degrade


def test_annotate_and_profile_window_noop_when_unset(monkeypatch):
    monkeypatch.delenv("DS_TPU_PROFILE_DIR", raising=False)
    with tt.annotate("test/scope"):
        pass
    with tt.profile_window("x") as p:
        assert p is None


def test_profile_window_captures_under_env(tmp_path, monkeypatch):
    monkeypatch.setenv("DS_TPU_PROFILE_DIR", str(tmp_path))
    with tt.profile_window("unit") as p:
        # Nested windows no-op instead of raising mid-serve.
        with tt.profile_window("inner") as q:
            assert q is None
        with tt.annotate("test/scope"):
            torch.ones(8).sum()
    assert p == str(tmp_path / "unit")
    traces = sorted((tmp_path / "unit").glob("trace.*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())
             ["traceEvents"]}
    assert "test/scope" in names
    # A window opened while another torch profiler runs is a no-op.
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        with tt.profile_window("busy") as r:
            assert r is None


def test_tensorboard_writer_degrades_without_extra(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = tt.TensorBoardScalarWriter(str(tmp_path / "tb"))
    assert w.available is False
    w.add_scalar("loss", 1.0, 0)
    reg = tt.MetricsRegistry()
    reg.counter("n").inc(1)
    w.publish(reg, step=0)
    w.flush()
    w.close()
    assert not (tmp_path / "tb").exists()


def test_import_without_extras():
    code = ("import sys; "
            "sys.modules['torch.utils.tensorboard'] = None; "
            "sys.modules['prometheus_client'] = None; "
            "import deepspeed_tpu_torch.telemetry as t; "
            "r = t.MetricsRegistry(); r.counter('ok').inc(1); "
            "print(t.prometheus_text(r).strip().splitlines()[-1])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ds_tpu_ok_total 1")


# ------------------------------------------------------------------ engine

LAYOUTS = {"dense": {}, "paged": {"paged_kv": True, "kv_page_len": 8},
           "int8": {"int8_kv": True},
           "spec": {"spec_decode": True, "spec_k": 2},
           "hierarchy": {"int8_kv": True, "prefix_cache": True,
                         "host_offload": True, "min_prefix_len": 4}}
# The JAX engine's counters that the port's features drive.
COUNTERS = ("tokens_out", "prefills", "prefill_tokens", "chunks",
            "requests_completed", "occupied_slot_steps", "slot_steps",
            "prefix_hits", "prefix_misses", "prefix_inserts",
            "prefix_evictions", "swap_outs", "swap_ins")
# metrics() keys of a window that count work (times differ by host).
WINDOW_KEYS = ("tokens_out", "requests_completed", "prefills",
               "prefill_tokens", "chunks", "slot_occupancy", "queue_depth",
               "running", "slots_prefilling", "recompiles", "adapter",
               "chunked_prefill", "prefill_chunk", "spec_decode",
               "paged_kv", "kv_page_len", "kv_pages_total",
               "kv_pages_in_use", "kv_pages_free", "kv_page_fragmentation",
               "spec_k", "spec_ngram", "accepted_per_step_mean",
               "accepted_per_step_p50", "accepted_per_step_p99",
               "draft_accept_rate", "int8_kv", "health", "faults_injected",
               "recoveries", "requests_replayed", "deadline_sheds",
               "step_stalls", "prefix_cache", "host_offload", "prefix_hits",
               "prefix_misses", "prefix_inserts", "prefix_evictions",
               "prefix_hit_rate", "kv_bytes_per_slot",
               "kv_bytes_per_slot_flat", "kv_bytes_aliased",
               "prefix_bytes_aliased_total", "prefix_store_bytes",
               "effective_slots", "swap_outs", "swap_ins", "slots_swapped")
# The resilience families: the port must export each, of the JAX
# engine's kind.
RESILIENCE = {"faults_injected", "recoveries", "requests_replayed",
              "deadline_sheds", "step_stalls", "health_state",
              "recovery_seconds"}
# The KV hierarchy's families: the counters on every engine, the gauges
# and histograms where the JAX engine has them (any tier on); the port
# must export each, of the JAX engine's kind.
KV_HIERARCHY = {"prefix_hits", "prefix_misses", "prefix_inserts",
                "prefix_evictions", "swap_outs", "swap_ins"}
KV_HIERARCHY_GAUGES = {"prefix_hit_rate", "kv_bytes_aliased",
                       "kv_bytes_per_slot", "effective_slots",
                       "slots_swapped", "swap_out_seconds",
                       "swap_in_seconds"}
# Prometheus families only the JAX engine exports, by the slice that
# brings them (ROADMAP Queue 1): none since the fleet's (prefix adoption,
# disaggregated handoff, preemption) came.
JAX_ONLY = {}


def _staggered(eng):
    """Three requests, two steps, three more (one finishing at its first
    token), run to idle, one window read; then one more request and a
    second window. Returns the streams and both windows."""
    ps = prompts([5, 19, 9, 26, 3, 12, 7])
    reqs = [eng.submit(p, max_new_tokens=n)
            for p, n in zip(ps[:3], [10, 6, 12])]
    eng.step()
    eng.step()
    reqs += [eng.submit(p, max_new_tokens=n)
             for p, n in zip(ps[3:6], [7, 1, 9])]
    eng.run()
    first = eng.metrics(reset=True)
    reqs.append(eng.submit(ps[6], max_new_tokens=5))
    eng.run()
    return [r.tokens for r in reqs], first, eng.metrics(reset=True)


def _jax_engine(**extra):
    jmodel, params, _ = models()
    return JEngine(jmodel, params, config=dict(
        SERVE, use_flash_decode=False, perf_xray=False, **extra))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_engine_streams_counters_spans_and_windows_equal_jax(layout):
    jeng = _jax_engine(**LAYOUTS[layout])
    teng = port_engine(**LAYOUTS[layout])
    want, jw1, jw2 = _staggered(jeng)
    got, tw1, tw2 = _staggered(teng)
    assert got == want
    for name in COUNTERS:
        assert teng.counters[name] == jeng.counters[name], name
    for tw, jw in ((tw1, jw1), (tw2, jw2)):
        for key in WINDOW_KEYS:
            if key in jw:
                assert tw[key] == jw[key], key
    assert tw1["chunks"] > 0 and tw2["requests_completed"] == 1
    # Span counts per name: the JAX engine records no name the port
    # does not, on any of these layouts.
    assert teng.tracer.span_counts() == jeng.tracer.span_counts()
    assert teng.tracer.span_counts()["step/mixed"] == \
        teng.counters["chunks"]
    # Prometheus families: the port's are the JAX engine's less those of
    # unported slices, each of the same kind.
    tk, jk = ({name: kind for name, kind, _ in e.telemetry.collect()}
              for e in (teng, jeng))
    assert set(tk) <= set(jk)
    assert all(tk[n] == jk[n] for n in tk)
    assert set(jk) - set(tk) <= set().union(*JAX_ONLY.values())
    assert RESILIENCE <= set(tk)
    assert KV_HIERARCHY <= set(tk)
    assert KV_HIERARCHY_GAUGES & set(jk) <= set(tk)
    if layout in ("int8", "hierarchy"):
        assert KV_HIERARCHY_GAUGES <= set(tk)


def test_engine_trace_file_validates_and_rides_request_tracks(tmp_path):
    eng = port_engine()
    r = eng.submit(prompts([6])[0], max_new_tokens=4)
    eng.run()
    counts = eng.tracer.span_counts()
    for name in ("request/submitted", "request/queued", "request/prefill",
                 "request/decode", "request", "step/mixed", "step/harvest",
                 "request/chunk"):
        assert counts.get(name, 0) >= 1, name
    path = eng.write_trace(str(tmp_path / "t.json"))
    doc = json.loads(open(path).read())
    ts = [e["ts"] for e in doc["traceEvents"]]
    assert ts == sorted(ts) and tt.validate_trace(doc) == len(ts)
    q = next(e for e in doc["traceEvents"] if e["name"] == "request/queued")
    assert q["tid"] == r.rid and r.trace.tid == r.rid
    steps = [e for e in doc["traceEvents"] if e["name"] == "step/mixed"]
    # Nothing is captured on the CPU.
    assert all(e["args"]["captured"] is False for e in steps)
    assert eng.find_request(r.rid) is r and eng.find_request(99) is None
    assert eng.trace_recorders() == {"engine": eng.tracer}


def test_engine_snapshot_prometheus_and_windowed_metrics():
    eng = port_engine()
    eng.generate(prompts([5]), max_new_tokens=9)  # meets both keys
    m1 = eng.metrics(reset=True)
    assert m1["tokens_out"] == 9 and m1["requests_completed"] == 1
    assert m1["ttft_p50_ms"] is not None and m1["queue_wait_p50_ms"] >= 0
    m2 = eng.metrics()
    assert m2["tokens_out"] == 0 and m2["requests_completed"] == 0
    assert m2["ttft_p50_ms"] is None and m2["prefill_lanes"] == 0
    assert m2["compile_count"] == m1["compile_count"] == 2
    assert m2["graph_replays"] == m1["graph_replays"]  # cumulative
    eng.generate(prompts([7]), max_new_tokens=3)
    m3 = eng.metrics(reset=True)
    assert m3["tokens_out"] == 3 and m3["requests_completed"] == 1
    snap = eng.telemetry_snapshot()
    assert snap["compile_count"] == 2 and snap["recompiles"] == 0
    assert snap["spans_dropped"] == 0 and snap["xray_programs"] == 0
    kinds, samples = _parse_prom(eng.prometheus())
    lbl = (("engine", "inference"),)
    assert kinds["ds_tpu_tokens_out_total"] == "counter"
    assert samples[("ds_tpu_tokens_out_total", lbl)] == 12  # monotonic
    assert samples[("ds_tpu_compile_count", lbl)] == 2
    assert samples[("ds_tpu_recompiles_total", lbl)] == 0
    assert samples[("ds_tpu_ttft_seconds_count", lbl)] == 0  # windowed
    dec = (("engine", "inference"), ("timer", "inference/decode"))
    assert samples[("ds_tpu_timer_seconds_count", dec)] == 0


def test_new_key_after_mark_warm_counts_one_recompile():
    """The port's programs are one per key: warm-up meets the greedy
    keys, and a sampled request after ``mark_warm()`` meets two new
    ones, counted as recompiles; the JAX engine's one program would
    count none."""
    eng = port_engine()
    eng.generate(prompts([3], seed=8), max_new_tokens=9)
    assert eng.recompile_detector.mark_warm() == 2
    eng.generate(prompts([4]), max_new_tokens=6)
    assert eng.metrics()["recompiles"] == 0
    eng.generate(prompts([4]), max_new_tokens=6, temperature=0.8, seed=1)
    m = eng.metrics()
    assert m["compile_count"] == 4 and m["recompiles"] == 2
    assert eng._programs.describe("mixed_step").endswith(
        "(False, True, False)")


@pytest.mark.parametrize("extra", [
    {}, {"paged_kv": True, "kv_page_len": 8},
    {"fault_injection": True, "step_budget_s": 30.0},
    {"paged_kv": True, "kv_page_len": 8, "prefix_cache": True,
     "host_offload": True, "max_slots": 1}])
def test_dropped_engine_is_freed_without_the_cycle_collector(extra):
    """No gauge, detector or watchdog refers back to the engine: dropping
    the last reference frees it (and on the card its pool and graphs) at
    once."""
    import gc
    import weakref

    eng = port_engine(**extra)
    if extra.get("fault_injection"):
        # A recovery on the way: the injector and the recovery path
        # must not leave a reference back either.
        from deepspeed_tpu_torch.inference import Fault, FaultPlan
        eng.inject_faults(FaultPlan(faults=(Fault("raise", step=1),)))
    if extra.get("host_offload"):
        # The hierarchy's gauges and hooks too, after hits and swaps.
        head = prompts([9])[0]
        eng.generate([np.concatenate([head, t]) for t in prompts([2, 3])],
                     max_new_tokens=12)
        assert eng.metrics()["swap_outs"] >= 1
        assert eng.metrics()["prefix_hits"] >= 1
    eng.generate(prompts([5]), max_new_tokens=6)
    if extra.get("fault_injection"):
        assert eng.metrics()["recoveries"] == 1
    eng.prometheus()
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()


def test_engine_telemetry_off_keeps_metrics_drops_spans(tmp_path):
    on = port_engine()
    off = port_engine(telemetry=False)
    got = [e.generate(prompts([5, 9]), max_new_tokens=4) for e in (on, off)]
    assert got[0] == got[1]
    assert isinstance(off.tracer, tt.NullRecorder)
    assert off.tracer.span_counts() == {}
    m_on, m_off = on.metrics(), off.metrics()
    for key in ("tokens_out", "requests_completed", "chunks", "recompiles",
                "compile_count"):
        assert m_off[key] == m_on[key], key
    assert m_off["tokens_out"] == 8
    with pytest.raises(RuntimeError):
        off.write_trace(str(tmp_path / "never.json"))


def test_scrape_while_serving_reads_live_gauges():
    eng = port_engine(max_queue=32)
    ep = tt.PrometheusEndpoint(eng.telemetry, port=0)
    url = "http://{}:{}/metrics".format(ep.host, ep.port)
    bodies, errors, stop = [], [], threading.Event()

    def scrape():
        while not stop.is_set():
            try:
                bodies.append(urllib.request.urlopen(url, timeout=30).read())
            except Exception as e:  # noqa: BLE001 - collected for assert
                errors.append(e)

    t = threading.Thread(target=scrape)
    try:
        t.start()
        got = eng.generate(prompts([5, 19, 9, 26]), max_new_tokens=6)
    finally:
        stop.set()
        t.join(timeout=60)
        ep.close()
    assert not t.is_alive() and errors == [] and bodies
    assert got == port_engine().generate(prompts([5, 19, 9, 26]),
                                         max_new_tokens=6)
    assert all(b"ds_tpu_queue_depth" in b for b in bodies)
