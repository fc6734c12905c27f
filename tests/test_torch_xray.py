"""Port parity: the perf x-ray (deepspeed_tpu_torch.telemetry.xray)
against the JAX package's, on the CPU.

The contracts are those of the JAX package's ``test_xray.py``, with the
port's measurement in place of XLA's cost model (``telemetry/xray.py``):

- IDENTITY: a signature separates shapes, dtypes and static leaves; the
  fingerprint and the measured cost are deterministic across registries;
  a new signature under a label after warm-up is a recompile event
  (capped), a flip back to a seen one is not; notes bill each record for
  its own calls.
- PROMETHEUS: the ``xray_*`` and ``hbm_*`` families at the parser level,
  no MFU/MBU/roofline gauges without a peaks row (the CPU has none),
  utilization only after a sampled step, label escaping, replica labels
  through ``MergedRegistry``.
- THE GATE: ``cost_model_gate`` gives the JAX gate's verdict on the same
  sections (A/A, 2x bytes, an improvement, mismatched context), and the
  loadgen gate folds it in.
- THE ENGINES: ``perf_xray()`` on a serving engine records every program
  key met with flops > 0, its calls and tokens, adds no key and no
  recompile, is None with the x-ray off; the detector's warning and the
  autopsy name the same identity; a fleet returns each replica's
  section; the training engine records its step.
"""

import copy
import logging

import numpy as np
import pytest
import torch

import deepspeed_tpu.telemetry.xray as jx
import deepspeed_tpu_torch.inference as ti
import deepspeed_tpu_torch.loadgen as tl
from deepspeed_tpu_torch.models import GPT2Config
from deepspeed_tpu_torch.telemetry import (MergedRegistry, MetricsRegistry,
                                           RecompileDetector,
                                           prometheus_text)
from deepspeed_tpu_torch.telemetry.xray import (PLATFORM_PEAKS,
                                                RECOMPILE_EVENT_CAP,
                                                SCHEMA_VERSION, HBMLedger,
                                                ProgramRegistry, _self_check,
                                                _shapes_of, _signature,
                                                cost_model_gate)
from tests.test_torch_inference import SERVE, models, prompts
from tests.test_torch_telemetry import _parse_prom

torch.set_num_threads(1)


def _fn(a, b):
    return torch.tanh(a @ b).sum()


def _toy(rows=8):
    return _fn, torch.ones(rows, 16), torch.ones(16, 4)


# ------------------------------------------------------------ identity


def test_signature_separates_shapes_dtypes_and_statics():
    x = torch.ones(2, 3, dtype=torch.int32)
    sig = _signature((x, 7, "mode"), {})
    assert sig[0] == ((2, 3), "int32")
    assert sig[1][0] == "static" and sig[1][1] == "int"
    assert _shapes_of(sig)[0] == "int32[2,3]"
    assert _shapes_of(sig)[1] == "static:int=7"
    assert _signature((x, 7, "mode"), {}) == sig
    assert _signature((torch.ones(2, 4, dtype=torch.int32), 7, "mode"),
                      {}) != sig


def test_fingerprint_and_cost_are_deterministic_across_registries():
    fn, x, y = _toy()
    r1 = ProgramRegistry().observe("p", fn, x, y, tokens=1)
    r2 = ProgramRegistry().observe("p", fn, x, y, tokens=1)
    assert r1["fingerprint"] and r1["fingerprint"] == r2["fingerprint"]
    # The product's flops: 2 * 8 * 16 * 4.
    assert r1["flops"] == r2["flops"] == 2 * 8 * 16 * 4
    assert r1["bytes_accessed"] > 0
    assert r1["bytes_accessed"] == r2["bytes_accessed"]
    assert r1["error"] is None
    r3 = ProgramRegistry().observe("p", fn, *_toy(4)[1:], tokens=1)
    assert r3["fingerprint"] != r1["fingerprint"]


def test_measure_runs_once_under_the_cost_modes():
    """``measure`` runs the active program once for its record (the
    engine's eager first run) and plainly afterwards; the result is the
    program's."""
    fn, x, y = _toy()
    xr = ProgramRegistry()
    xr.stash("p", fn, x, y)
    calls = []

    def run():
        calls.append(1)
        return fn(x, y)

    assert xr.measure("p", run) == fn(x, y)
    assert xr.measure("p", run) == fn(x, y)
    assert len(calls) == 2
    (rec,) = xr.to_json()["programs"]
    assert rec["flops"] == 2 * 8 * 16 * 4 and rec["kernel_flops"] == 0


def test_stash_fast_path_and_recompile_events_resolve():
    fn, x, y = _toy()
    xr = ProgramRegistry()
    assert xr.stash("p", fn, x, y) is True
    assert xr.stash("p", fn, x, y) is False
    assert xr.recompile_events == []
    x2 = torch.ones(4, 16)
    assert xr.stash("p", fn, x2, y, track_change=True) is True
    (ev,) = xr.recompile_events
    assert ev["program"] == "p"
    assert ev["old_shapes"][0] == "float32[8,16]"
    assert ev["new_shapes"][0] == "float32[4,16]"
    (resolved,) = xr.recompile_dicts()
    assert resolved["old_fingerprint"] != resolved["new_fingerprint"]
    ident = xr.identity("p")
    assert "->" in ident and "float32[4,16]" in ident


def test_stash_seen_signature_flips_never_accumulate_or_log():
    fn, x, y = _toy()
    x2 = torch.ones(4, 16)
    xr = ProgramRegistry()
    assert xr.stash("p", fn, x, y, track_change=True) is True
    assert xr.stash("p", fn, x2, y, track_change=True) is True
    assert len(xr.recompile_events) == 1
    for _ in range(50):
        assert xr.stash("p", fn, x, y, track_change=True) is True
        assert xr.stash("p", fn, x2, y, track_change=True) is True
    assert len(xr._programs["p"]) == 2
    assert len(xr.recompile_events) == 1
    assert xr.recompile_events_dropped == 0
    assert xr.stash("p", fn, torch.ones(2, 16), y, track_change=True)
    assert len(xr._programs["p"]) == 3
    assert len(xr.recompile_events) == 2


def test_recompile_events_are_capped_not_unbounded():
    fn, _, y = _toy()
    xr = ProgramRegistry()
    n = RECOMPILE_EVENT_CAP + 6
    for i in range(1, n + 2):
        xr.stash("p", fn, torch.ones(i, 16), y, track_change=True)
    assert len(xr.recompile_events) == RECOMPILE_EVENT_CAP
    assert xr.recompile_events_dropped == n - RECOMPILE_EVENT_CAP
    assert RECOMPILE_EVENT_CAP == jx.RECOMPILE_EVENT_CAP
    assert SCHEMA_VERSION == jx.SCHEMA_VERSION


def test_note_attributes_calls_and_cost_per_signature():
    fn, x, y = _toy()
    x2 = torch.ones(4, 16)
    xr = ProgramRegistry()
    xr.stash("p", fn, x, y)
    xr.note("p", tokens=2)
    xr.note("p", tokens=2)
    xr.stash("p", fn, x2, y)
    xr.note("p", tokens=8)
    section = xr.to_json()
    big = next(e for e in section["programs"]
               if "float32[8,16]" in e["input_shapes"][0])
    small = next(e for e in section["programs"]
                 if "float32[4,16]" in e["input_shapes"][0])
    assert big["superseded"] and not small["superseded"]
    assert (big["calls"], big["tokens"]) == (2, 4)
    assert (small["calls"], small["tokens"]) == (1, 8)
    t = section["totals"]
    assert t["calls"] == 3 and t["tokens"] == 12
    assert t["flops_total"] == pytest.approx(
        big["flops"] * 2 + small["flops"] * 1)
    assert t["bytes_total"] == pytest.approx(
        big["bytes_accessed"] * 2 + small["bytes_accessed"] * 1)
    xr.stash("p", fn, x, y)
    xr.note("p", tokens=1)
    big2 = next(e for e in xr.to_json()["programs"]
                if "float32[8,16]" in e["input_shapes"][0])
    assert not big2["superseded"]
    assert (big2["calls"], big2["tokens"]) == (3, 5)


# ----------------------------------------------------------- prometheus


def test_xray_gauges_at_parser_level_no_fabricated_mfu():
    fn, x, y = _toy()
    reg = MetricsRegistry(engine="inference")
    xr = ProgramRegistry(reg, platform="cpu")
    xr.observe("mixed_step", fn, x, y, tokens=4)
    kinds, samples = _parse_prom(prometheus_text(reg))
    assert kinds["ds_tpu_xray_flops"] == "gauge"
    lbl = (("engine", "inference"), ("platform", "cpu"),
           ("program", "mixed_step"))
    assert samples[("ds_tpu_xray_flops", lbl)] > 0
    assert samples[("ds_tpu_xray_bytes_accessed", lbl)] > 0
    # No graph on the CPU: the program's device pool is 0.
    assert samples[("ds_tpu_xray_peak_hbm_bytes", lbl)] == 0
    for fabricated in ("ds_tpu_xray_mfu", "ds_tpu_xray_mbu",
                       "ds_tpu_xray_roofline_ratio"):
        assert fabricated not in kinds


def test_xray_roofline_gauges_with_peaks_and_sampled_step():
    fn, x, y = _toy()
    reg = MetricsRegistry()
    peaks = {"flops_per_s": 1e9, "hbm_bytes_per_s": 1e9, "source": "test"}
    xr = ProgramRegistry(reg, platform="cuda", peaks=peaks, sample_every=1)
    xr.observe("mixed_step", fn, x, y, tokens=4)
    _, before = _parse_prom(prometheus_text(reg))
    lbl = (("platform", "cuda"), ("program", "mixed_step"))
    assert before[("ds_tpu_xray_mfu", lbl)] == 0.0
    xr.sample_step("mixed_step", lambda: None, dispatch_s=0.001)
    kinds, samples = _parse_prom(prometheus_text(reg))
    assert samples[("ds_tpu_xray_mfu", lbl)] > 0
    assert samples[("ds_tpu_xray_mbu", lbl)] > 0
    assert samples[("ds_tpu_xray_roofline_ratio", lbl)] > 0
    assert kinds["ds_tpu_xray_host_dispatch_seconds"] == "summary"
    assert samples[("ds_tpu_xray_device_wait_seconds_count",
                    (("program", "mixed_step"),))] == 1
    (entry,) = xr.to_json()["programs"]
    assert 0 < entry["mfu"] and 0 < entry["mbu"]


def test_xray_label_escaping_survives_exposition():
    fn, x, y = _toy()
    reg = MetricsRegistry()
    ProgramRegistry(reg, platform="cpu").observe(
        'train[bs=8,"mixed"]\n', fn, x, y)
    assert 'program="train[bs=8,\\"mixed\\"]\\n"' in prometheus_text(reg)


def test_xray_series_carry_replica_labels_through_merge():
    fn, x, y = _toy()
    regs = {}
    for rid in (0, 1):
        reg = MetricsRegistry(engine="inference", replica=str(rid))
        ProgramRegistry(reg, platform="cpu").observe("mixed_step", fn, x, y)
        regs[rid] = reg
    _, samples = _parse_prom(prometheus_text(MergedRegistry(regs)))
    for rid in (0, 1):
        lbl = (("engine", "inference"), ("platform", "cpu"),
               ("program", "mixed_step"), ("replica", str(rid)))
        assert samples[("ds_tpu_xray_flops", lbl)] > 0


def test_due_sampling_cadence_skips_first_and_disables_at_zero():
    for mod in (jx, None):
        reg = (mod.ProgramRegistry if mod is not None
               else ProgramRegistry)
        xr = reg(sample_every=3)
        assert [xr.due() for _ in range(7)] == [False, False, True,
                                                False, False, True, False]
        assert not any(reg(sample_every=0).due() for _ in range(5))


def test_decomposition_lands_in_export():
    fn, x, y = _toy()
    xr = ProgramRegistry(sample_every=1)
    xr.observe("p", fn, x, y, tokens=2)
    xr.sample_step("p", lambda: None, dispatch_s=0.002)
    xr.sample_step("p", lambda: None, dispatch_s=0.001)
    section = xr.to_json()
    d = section["decomposition"]["p"]
    assert d["samples"] == 2
    assert d["host_dispatch_s"] == pytest.approx(0.003)
    assert d["device_wait_s"] >= 0
    (entry,) = [e for e in section["programs"] if not e["superseded"]]
    assert entry["sampled_step_seconds"] > 0
    # No peaks row on the CPU: no utilization in the export either.
    assert entry["mfu"] is None and entry["mbu"] is None


# --------------------------------------------------------------- ledger


def test_hbm_ledger_math_and_prometheus_families():
    out = {}
    for name, cls in (("jax", jx.HBMLedger), ("port", HBMLedger)):
        reg = MetricsRegistry()
        led = cls(reg, capacity_bytes=1000)
        led.set_component("params", 500)
        led.set_component("kv_arena", lambda: 200)
        assert led.predicted() == 700 and led.capacity() == 1000
        assert led.pressure() == pytest.approx(0.7)
        assert led.live() is None and led.headroom() == 300
        kinds, samples = _parse_prom(prometheus_text(reg))
        assert samples[("ds_tpu_hbm_predicted_bytes", ())] == 700
        assert samples[("ds_tpu_hbm_headroom_bytes", ())] == 300
        assert "ds_tpu_hbm_live_bytes" not in kinds
        out[name] = led.to_json()
    assert out["port"] == out["jax"]


def test_hbm_ledger_unknown_capacity_reads_zero_pressure():
    reg = MetricsRegistry()
    led = HBMLedger(reg)
    led.set_component("params", 10**12)
    assert led.capacity() is None
    assert led.pressure() == 0.0
    assert led.headroom() is None
    kinds, samples = _parse_prom(prometheus_text(reg))
    assert samples[("ds_tpu_hbm_pressure", ())] == 0.0
    assert "ds_tpu_hbm_headroom_bytes" not in kinds


# ----------------------------------------------------------------- gate


def _section(**overrides):
    fn, x, y = _toy()
    xr = ProgramRegistry(platform="cpu")
    xr.observe("mixed_step", fn, x, y, tokens=8)
    out = xr.to_json()
    out.update(overrides)
    return out


def _both_gates(a, b):
    got, want = cost_model_gate(a, b), jx.cost_model_gate(a, b)
    assert got == want
    return got


def test_cost_model_gate_aa_passes_clean():
    a = _section()
    g = _both_gates(a, a)
    assert g["pass"] and not g["flagged"] and not g["caveats"]


def test_cost_model_gate_flags_2x_bytes_and_records_improvement():
    a = _section()
    worse = copy.deepcopy(a)
    for e in worse["programs"]:
        e["bytes_accessed"] *= 2
    worse["totals"]["bytes_per_token"] *= 2
    g = _both_gates(a, worse)
    assert not g["pass"]
    assert any("bytes_accessed" in f for f in g["flagged"])
    assert any("totals.bytes_per_token" in f for f in g["flagged"])
    better = copy.deepcopy(a)
    for e in better["programs"]:
        e["flops"] *= 0.5
    g2 = _both_gates(a, better)
    assert g2["pass"] and any("flops" in s for s in g2["improved"])
    pool = copy.deepcopy(a)
    for e in pool["programs"]:
        e["peak_hbm_bytes"] = 1e6
    assert not _both_gates(a, pool)["pass"]


def test_cost_model_gate_caveats_on_mismatched_context():
    a = _section()
    g = _both_gates(a, _section(platform="cuda"))
    assert any("platform mismatch" in c for c in g["caveats"])
    g2 = _both_gates(a, _section(schema_version=SCHEMA_VERSION + 1))
    assert g2["pass"] and not g2["programs"]
    assert any("schema_version mismatch" in c for c in g2["caveats"])
    g3 = _both_gates(a, None)
    assert any("missing" in c for c in g3["caveats"])


def test_regression_gate_carries_cost_model_arm():
    base = {"schema_version": 99, "context": {}, "aggregate": {},
            "windows": [], "perf_xray": _section()}
    aa = tl.regression_gate(base, base)
    assert aa["pass"] and aa["perf_xray"]["pass"]
    worse = copy.deepcopy(base)
    for e in worse["perf_xray"]["programs"]:
        e["bytes_accessed"] *= 2
    ab = tl.regression_gate(base, worse)
    assert not ab["pass"] and not ab["perf_xray"]["pass"]
    plain = {k: v for k, v in base.items() if k != "perf_xray"}
    assert "perf_xray" not in tl.regression_gate(plain, plain)


def test_module_self_check_passes():
    assert _self_check() == 0


def test_platform_peaks_table_is_honest():
    for plat, row in PLATFORM_PEAKS.items():
        if row is None:
            continue
        assert row["flops_per_s"] > 0 and row["hbm_bytes_per_s"] > 0
        assert row.get("source")
    assert PLATFORM_PEAKS["cpu"] is None
    # The H100 row PERF.md's bound column uses; no TPU row in the port.
    assert PLATFORM_PEAKS["cuda"]["flops_per_s"] == 989e12
    assert PLATFORM_PEAKS["cuda"]["hbm_bytes_per_s"] == 3.35e12
    assert "tpu" not in PLATFORM_PEAKS


# ----------------------------------------------------- engine integration


def _engine(**cfg):
    _, _, tree = models()
    return ti.InferenceEngine(GPT2Config.tiny(dtype=torch.float32), tree,
                              config=dict(SERVE, **cfg), device="cpu")


def _serve(eng):
    reqs = [eng.submit(p, max_new_tokens=5,
                       **({"temperature": 0.7, "seed": i} if i % 2 else {}))
            for i, p in enumerate(prompts([5, 9, 6]))]
    eng.run()
    return reqs


def test_engine_perf_xray_covers_program_family_without_recompiles():
    eng = _engine(perf_xray=True, xray_sample_every=2)
    _serve(eng)
    keys = sorted(eng._programs)
    out = eng.perf_xray()
    assert out["schema_version"] == SCHEMA_VERSION
    assert len(out["programs"]) == len(keys) >= 2
    shapes = sorted(tuple(p["input_shapes"][:3]) for p in out["programs"])
    assert shapes == sorted(tuple("static:bool={}".format(b) for b in k)
                            for k in keys)
    for p in out["programs"]:
        assert p["flops"] > 0 and p["bytes_accessed"] > 0, p
        assert p["platform"] == "cpu" and p["graph_pool_bytes"] == 0
        assert p["mfu"] is None
    assert out["platform"] == "cpu" and out["peaks"] is None
    assert sum(p["calls"] for p in out["programs"]) == \
        eng.counters["chunks"]
    assert sum(p["tokens"] for p in out["programs"]) == \
        eng.counters["tokens_out"]
    assert out["totals"]["flops_per_token"] > 0
    assert out["hbm"]["components"]["weights"] > 0
    assert out["hbm"]["components"]["kv_arena"] > 0
    assert out["decomposition"]["mixed_step"]["samples"] >= 1
    assert sorted(eng._programs) == keys
    assert out["recompiles"] == []
    assert eng.metrics()["recompiles"] == 0
    again = eng.perf_xray()
    assert [p["fingerprint"] for p in again["programs"]] == \
        [p["fingerprint"] for p in out["programs"]]
    kinds, _ = _parse_prom(eng.prometheus())
    assert "ds_tpu_xray_flops" in kinds
    assert "ds_tpu_hbm_predicted_bytes" in kinds
    assert "ds_tpu_xray_mfu" not in kinds
    assert eng.telemetry_snapshot()["xray_programs"] == len(keys)


def test_engine_xray_leaves_streams_unchanged():
    """The measured first runs compute what plain ones do: streams with
    the x-ray on equal those with it off."""
    on = [list(r.tokens) for r in _serve(_engine(perf_xray=True))]
    off = [list(r.tokens) for r in _serve(_engine())]
    assert on == off


def test_engine_perf_xray_off_is_none():
    eng = _engine(perf_xray=False)
    eng.generate([np.arange(1, 6, dtype=np.int32)], max_new_tokens=2)
    assert eng.perf_xray() is None
    assert eng.telemetry_snapshot()["xray_programs"] == 0
    assert "ds_tpu_hbm_predicted_bytes" not in eng.prometheus()


class _Capture(logging.Handler):
    def __init__(self):
        logging.Handler.__init__(self)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def test_recompile_warning_and_autopsy_share_identity_key():
    from deepspeed_tpu_torch.utils.logging import logger as ds_logger

    fn, x, y = _toy()
    reg = MetricsRegistry()
    xr = ProgramRegistry(reg, platform="cpu")
    cache = {}

    class _Cache(object):
        def _cache_size(self):
            return len(cache)

    det = RecompileDetector(reg, describe=xr.identity)
    det.watch("p", _Cache())
    xr.stash("p", fn, x, y, track_change=det.warm)
    cache[(8,)] = 1
    det.mark_warm()
    x2 = torch.ones(4, 16)
    xr.stash("p", fn, x2, y, track_change=det.warm)
    cache[(4,)] = 1
    cap = _Capture()
    ds_logger.addHandler(cap)
    try:
        assert det.observe() == 1
    finally:
        ds_logger.removeHandler(cap)
    (msg,) = [r.getMessage() for r in cap.records
              if "recompiled" in r.getMessage()]
    assert "float32[8,16]" in msg and "float32[4,16]" in msg
    assert "fingerprint" in msg
    (ev,) = xr.recompile_dicts()
    ident = xr.identity("p")
    assert ev["old_fingerprint"] in ident
    assert ev["new_fingerprint"] in ident


def test_engine_new_key_after_warm_is_a_named_recompile():
    """On the engine: a key met first after ``mark_warm()`` is one
    recompile event; the detector's warning and ``explain()`` name it by
    the x-ray's identity (the key's values and fingerprints)."""
    from deepspeed_tpu_torch.utils.logging import logger as ds_logger

    eng = _engine(perf_xray=True)
    p = prompts([6])[0]
    eng.submit(p, max_new_tokens=4)
    eng.run()
    eng.recompile_detector.mark_warm()
    cap = _Capture()
    ds_logger.addHandler(cap)
    try:
        req = eng.submit(p, max_new_tokens=4, temperature=0.9, seed=3)
        eng.run()
    finally:
        ds_logger.removeHandler(cap)
    assert eng.metrics()["recompiles"] >= 1
    msgs = [r.getMessage() for r in cap.records
            if "recompiled" in r.getMessage()]
    assert msgs and "static:bool=True" in msgs[0]
    events = eng.perf_xray()["recompiles"]
    assert events and events[0]["program"] == "mixed_step"
    out = eng.explain(req.rid)
    assert out["recompiled_programs"] == events
    assert events[0]["new_fingerprint"] in msgs[-1] or \
        events[-1]["new_fingerprint"] in msgs[-1]


def test_fleet_perf_xray_keys_each_replica():
    _, _, tree = models()
    fleet = ti.ServingFleet(GPT2Config.tiny(dtype=torch.float32), tree,
                            n_replicas=2, start=False, device="cpu",
                            config=dict(SERVE, max_queue=32,
                                        perf_xray=True))
    try:
        for p in prompts([5, 9, 6, 7]):
            fleet.submit(p, max_new_tokens=4)
        assert fleet.wait_idle(timeout_s=60.0)
        out = fleet.perf_xray()
        assert sorted(out) == [0, 1]
        for rid, sec in out.items():
            eng = fleet.replicas[rid].engine
            assert len(sec["programs"]) == eng.compile_count
            assert all(p["flops"] > 0 for p in sec["programs"])
        kinds, samples = _parse_prom(fleet.prometheus())
        replicas = {dict(k[1]).get("replica") for k in samples
                    if k[0] == "ds_tpu_xray_flops"}
        assert replicas == {"0", "1"}
    finally:
        fleet.close()


def test_training_engine_perf_xray_records_its_step():
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import GPT2LMHeadModel
    cfg = GPT2Config.tiny(dtype=torch.float32)
    trainer, _, _, _ = deepspeed_tpu_torch.initialize(
        model=GPT2LMHeadModel(cfg, device="cpu"), device="cpu",
        config_params={"train_batch_size": 2,
                       "optimizer": {"type": "AdamW",
                                     "params": {"lr": 1e-3}}})
    ids = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 16)))
    losses = [float(trainer.train_batch((ids, ids))) for _ in range(3)]
    out = trainer.perf_xray()
    (rec,) = out["programs"]
    assert rec["program"] == "train_step" and rec["calls"] == 3
    assert rec["tokens"] == 6 and rec["flops"] > 0
    assert rec["input_shapes"] == ["int64[2,16]", "int64[2,16]"]
    # The measured first step is an ordinary step: the losses fall.
    assert losses[-1] < losses[0]
