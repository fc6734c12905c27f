"""deepspeed_tpu_torch.loadgen against the JAX package's loadgen, on the CPU.

- WORKLOAD: ``requests()`` of every preset (Poisson, burst, ramp, Zipf
  lengths, a shared-prefix pool, ``template_heavy``, ``long_context``,
  ``mixed_tenants``) equals the JAX package's row by row, and a saved
  trace replays identically through both.
- SLO, REPORT, GATE, SWEEP: ``evaluate``, ``build_report``,
  ``regression_gate`` and ``saturation_sweep`` give the JAX package's
  output on the same samples.
- RUNNER: ``SustainedRunner`` drives a tiny fp32 port engine open loop
  under an injected clock: every accepted request completes, sheds are
  sample rows, the windows carry the engine's registry, and the report
  over the run equals the JAX ``build_report`` of the same result.
  ``chaos_plan`` and ``alerts`` raise: chaos needs the resilience
  slice, alerting the alerts slice.

No test here asserts a wall-clock bound: the clock is injected.
"""

import copy
import dataclasses
import json

import pytest
import torch

import deepspeed_tpu.loadgen as jl
import deepspeed_tpu_torch.loadgen as tl
from tests.test_torch_inference import port_engine, prompts

torch.set_num_threads(1)


def _small(**kw):
    kw.setdefault("vocab_size", 1024)
    kw.setdefault("n_requests", 16)
    kw.setdefault("prompt_mean", 8)
    kw.setdefault("prompt_max", 16)
    kw.setdefault("output_mean", 6)
    kw.setdefault("output_max", 12)
    return kw


PRESETS = {
    "poisson": lambda m: m.WorkloadSpec(**_small(seed=3)),
    "burst": lambda m: m.WorkloadSpec(**_small(arrival="burst",
                                               burst_size=4, seed=5)),
    "ramp": lambda m: m.WorkloadSpec(**_small(arrival="ramp", rate=20.0,
                                              ramp_from=2.0, seed=7)),
    "zipf": lambda m: m.WorkloadSpec(**_small(prompt_dist="zipf",
                                              output_dist="zipf", seed=9)),
    "fixed_random_tokens": lambda m: m.WorkloadSpec(**_small(
        prompt_dist="fixed", output_dist="fixed", phrase_len=0, seed=1)),
    "prefix_pool": lambda m: m.WorkloadSpec(**_small(
        prefix_pool=3, prefix_tokens=4, prompt_max=24, seed=11)),
    "template_heavy": lambda m: m.WorkloadSpec.template_heavy(
        prefix_tokens=8, prompt_mean=14, prompt_min=10, prompt_max=24,
        vocab_size=1024, n_requests=16, seed=13),
    "long_context": lambda m: m.WorkloadSpec.long_context(
        prompt_mean=64, prompt_min=8, prompt_max=512, output_max=32,
        vocab_size=1024, n_requests=16, seed=15),
    "mixed_tenants": lambda m: m.WorkloadSpec.mixed_tenants(
        seed=2, interactive_n=6, batch_n=6, vocab_size=1024,
        prompt_max=16, output_max=12),
    "sustained_card": lambda m: m.WorkloadSpec(
        arrival="poisson", rate=12.0, n_requests=96,
        prompt_dist="lognormal", prompt_mean=64, prompt_max=256,
        output_dist="lognormal", output_mean=96, output_min=8,
        output_max=256, prefix_pool=4, prefix_tokens=32, vocab_size=50257,
        seed=17),
}


def _rows(reqs):
    return [(r.arrival_s, r.prompt.tolist(), r.prompt.dtype.str,
             r.max_new_tokens, r.temperature, r.seed, r.priority, r.tenant)
            for r in reqs]


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_workload_requests_equal_jax_row_by_row(preset):
    port, ref = PRESETS[preset](tl), PRESETS[preset](jl)
    got, want = _rows(port.requests()), _rows(ref.requests())
    assert got == want and len(got) > 0
    assert _rows(port.requests()) == got  # deterministic per seed
    assert port.to_json() == ref.to_json()


def test_trace_roundtrip_replays_like_jax(tmp_path):
    reqs = PRESETS["prefix_pool"](tl).requests()
    path = tl.save_trace(reqs, str(tmp_path / "t.jsonl"))
    assert _rows(tl.replay_trace(path, vocab_size=1024)) == \
        _rows(jl.replay_trace(path, vocab_size=1024)) == _rows(reqs)


# ------------------------------------------------------------ slo/report


def _row(ttft=0.05, itl=0.01, tokens=8, shed=False, completed=True,
         arrival=0.0):
    return {"arrival_s": arrival, "prompt_tokens": 8, "max_new_tokens": 8,
            "shed": shed, "shed_reason": None, "rid": None,
            "priority": None, "tenant": None,
            "ttft_s": None if shed else ttft,
            "e2e_s": None if shed else ttft + (itl or 0.0) * (tokens - 1),
            "itl_s": None if shed else itl, "tokens_out": tokens,
            "completed": completed, "phase": "done" if completed else None}


SAMPLES = [_row(), _row(ttft=0.5), _row(itl=0.2),
           _row(shed=True, completed=False, tokens=0),
           _row(itl=None, tokens=1), _row(ttft=0.08, arrival=0.7),
           _row(ttft=0.02, itl=0.03, tokens=20, arrival=1.3)]


def test_slo_evaluate_equals_jax():
    for kw in ({"ttft_p99_ms": 100.0, "itl_p99_ms": 50.0},
               {"ttft_p99_ms": None, "itl_p99_ms": 50.0}, {}):
        got = tl.evaluate(SAMPLES, tl.SLO(**kw), wall_s=2.0, chips=2)
        want = jl.evaluate(SAMPLES, jl.SLO(**kw), wall_s=2.0, chips=2)
        assert got == want
    got = tl.evaluate(SAMPLES, tl.SLO(ttft_p99_ms=100.0, itl_p99_ms=50.0),
                      wall_s=2.0, chips=2)
    assert got["slo_met"] == 4 and got["shed"] == 1


class _Collector(object):
    window_seconds = 1.0
    _idx = 3
    dropped = 0


def _windows():
    return [{"index": i, "t_start": 10.0 + i, "t_end": 11.0 + i,
             "duration_s": 1.0,
             "metrics": {"tokens_out": 10.0 * (i + 1),
                         "requests_completed": float(i),
                         "queue_depth": float(i % 2),
                         "slot_occupancy": 0.25 * i,
                         "ttft_seconds": {"p50": 0.01 * (i + 1),
                                          "p99": 0.02 * (i + 1)},
                         "inter_token_seconds": {"p50": None, "p99": None},
                         "queue_wait_seconds": {"p50": 0.001,
                                                "p99": 0.002}}}
            for i in range(3)]


def _result(mod):
    return mod.RunResult(samples=copy.deepcopy(SAMPLES), windows=_windows(),
                         collector=_Collector(), wall_s=3.0, submitted=6,
                         completed=6, shed=1, tokens_out=53)


def test_build_report_gate_and_sweep_equal_jax():
    spec = {"jax": PRESETS["poisson"](jl), "port": PRESETS["poisson"](tl)}
    slo = {"jax": jl.SLO(ttft_p99_ms=100.0, itl_p99_ms=50.0),
           "port": tl.SLO(ttft_p99_ms=100.0, itl_p99_ms=50.0)}
    reps = {name: mod.build_report(spec[name], _result(mod), slo[name],
                                   platform="cpu", extra={"model": "tiny"})
            for name, mod in (("jax", jl), ("port", tl))}
    assert reps["port"] == reps["jax"]
    assert reps["port"]["schema_version"] == jl.SCHEMA_VERSION
    # Sections of features the port lacks come out at their zero values.
    assert reps["port"]["chaos"]["requests_lost"] == 0
    assert reps["port"]["prefix"]["hit_rate"] is None
    assert reps["port"]["disagg"]["handoffs"] == 0
    json.dumps(reps["port"])
    slower = copy.deepcopy(reps["port"])
    slower["aggregate"]["ttft_p99_ms"] *= 2.0
    for a, b in ((reps["port"], reps["port"]), (reps["port"], slower),
                 (slower, reps["port"])):
        assert tl.regression_gate(a, b) == jl.regression_gate(a, b)
    assert tl.regression_gate(reps["port"], reps["port"])["pass"]
    assert not tl.regression_gate(reps["port"], slower)["pass"]

    def run_fn(mod):
        def run(rate):
            rep = copy.deepcopy(reps["port"])
            rep["aggregate"]["slo_attainment"] = 1.0 if rate <= 16 else 0.4
            rep["aggregate"]["tokens_per_sec"] = rate * 30.0
            return rep
        return run

    got = tl.saturation_sweep(run_fn(tl), (8, 16, 24))
    assert got == jl.saturation_sweep(run_fn(jl), (8, 16, 24))
    assert got["max_sustainable_rate"] == 16


def test_gate_refuses_perf_xray_sections():
    rep = tl.build_report(PRESETS["poisson"](tl), _result(tl), tl.SLO())
    rep["perf_xray"] = {"programs": {}}
    with pytest.raises(NotImplementedError, match="x-ray"):
        tl.regression_gate(rep, rep)


# ---------------------------------------------------------------- runner


class _Clock(object):
    """Injected clock: each read advances 1 ms; ``sleep`` jumps."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 0.001
        return self.t

    def sleep(self, s):
        self.t += s


def _warm(engine):
    """The caller's warm-up: a request that outlives its prefill step
    meets both greedy keys; then mark warm and open a fresh window."""
    engine.generate(prompts([3], seed=8), max_new_tokens=9)
    assert engine.compile_count == 2
    engine.recompile_detector.mark_warm()
    engine.metrics(reset=True)


def test_runner_open_loop_end_to_end_on_the_port_engine():
    engine = port_engine(max_slots=3, max_queue=64)
    _warm(engine)
    spec = tl.WorkloadSpec(**_small(rate=40.0, n_requests=12, seed=11))
    clock = _Clock()
    runner = tl.SustainedRunner(engine, spec, window_seconds=0.05,
                                max_steps=10_000, clock=clock,
                                sleep=clock.sleep)
    res = runner.run()
    assert res.submitted == 12 and res.shed == 0 and res.completed == 12
    assert res.requests_lost == 0 and engine.idle
    assert res.tokens_out == sum(r.max_new_tokens for r in spec.requests())
    assert len(res.windows) >= 2
    assert sum(w["metrics"]["tokens_out"] for w in res.windows) == \
        res.tokens_out
    assert engine.metrics()["recompiles"] == 0
    done = [s for s in res.samples if s["completed"]]
    assert all(s["ttft_s"] is not None and s["e2e_s"] >= s["ttft_s"]
               for s in done)
    slo = tl.SLO(ttft_p99_ms=1e6, itl_p99_ms=1e6)
    rep = tl.build_report(spec, res, slo, platform="cpu")
    assert rep["aggregate"]["completed"] == 12
    assert rep["slo"]["attainment"] == 1.0
    assert rep["paged"]["paged"] is False
    json.dumps(rep)
    # The JAX report of the same result is the same document.
    want = jl.build_report(spec, res, jl.SLO(ttft_p99_ms=1e6,
                                             itl_p99_ms=1e6),
                           platform="cpu")
    assert rep == want
    assert tl.regression_gate(rep, rep)["pass"]


def test_runner_records_queuefull_as_shed_samples_and_pages():
    engine = port_engine(max_slots=2, max_queue=2, paged_kv=True,
                         kv_page_len=8)
    _warm(engine)
    spec = tl.WorkloadSpec(**_small(arrival="burst", n_requests=12,
                                    burst_size=12, seed=4))
    clock = _Clock()
    res = tl.SustainedRunner(engine, spec, window_seconds=0.05,
                             max_steps=10_000, clock=clock,
                             sleep=clock.sleep).run()
    assert res.shed > 0 and res.submitted + res.shed == 12
    shed = [s for s in res.samples if s["shed"]]
    assert len(shed) == res.shed
    assert all(s["tokens_out"] == 0 and not s["completed"] for s in shed)
    assert res.requests_lost == 0
    assert res.paged and res.kv_page_len == 8 and res.kv_pages_peak > 0
    rep = tl.build_report(spec, res, tl.SLO(ttft_p99_ms=1e6,
                                            itl_p99_ms=1e6))
    assert rep["slo"]["attainment"] < 1.0
    assert rep["paged"]["pages_peak"] == res.kv_pages_peak


def test_runner_refuses_chaos_mode_and_alerts():
    engine = port_engine()
    with pytest.raises(NotImplementedError, match="resilience"):
        tl.SustainedRunner(engine, PRESETS["poisson"](tl),
                           chaos_plan=object())
    with pytest.raises(NotImplementedError, match="alerts"):
        tl.SustainedRunner(engine, PRESETS["poisson"](tl), alerts=object())


def test_run_result_fields_equal_jax():
    names = [f.name for f in dataclasses.fields(tl.RunResult)]
    assert names == [f.name for f in dataclasses.fields(jl.RunResult)]
