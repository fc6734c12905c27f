"""Sustained-load report: windowed SLO time-series, saturation sweep,
noise-aware regression gate.

Counterpart of ``deepspeed_tpu/loadgen/report.py``: the same report for
the same run result. The ``prefix`` and ``disagg`` sections fill from a
``ServingFleet``'s summed counters (adoptions, bytes shipped, affinity
routes; handoffs, fallbacks, handoff bytes), the ``frontdoor`` section
from a ``FrontDoor`` target and the ``adapter`` section from an MoE or
long-context engine. The gate's cost-model arm compares two reports'
``perf_xray`` sections (``telemetry/xray.cost_model_gate``).

The report is the harness's one artifact — a plain-JSON document that
carries (a) the per-window curves (TTFT/ITL p50/p99, queue depth, slot
occupancy, tokens/sec) the collector recorded, (b) run aggregates and
the SLO/goodput verdict, and (c) enough provenance (workload echo,
platform, schema version) that two reports can be compared honestly.

The regression gate is NOISE-AWARE because a fixed threshold is wrong
at both ends: tight enough to catch real 10% regressions, it flags
run-to-run noise every week; loose enough to never false-alarm, it
waves through real slowdowns. The windowed time-series is what breaks
the dilemma — each report carries N per-window measurements of every
metric, so the gate can estimate each run's OWN noise (standard error
of the window mean) and demand the A/B delta clear both a relative
floor and k standard errors of the combined noise. An A/A comparison
(same report twice) has delta exactly 0 and always passes; a real 2x
TTFT regression clears any plausible noise floor and fails — both ends
are pinned by the loadgen tests.
"""

import math

from deepspeed_tpu_torch.loadgen import slo as slo_mod

SCHEMA_VERSION = 7  # v2: + chaos section (recovery/requests_lost) and
# per-sample terminal phase. v3: + prefix section (hit rate, bytes
# shipped by cross-replica adoption, affinity-routed count). v4: +
# disagg section (prefill->decode handoff counts, fallbacks, bytes
# shipped). v5: + frontdoor section (per-class SLO attainment, sheds by
# reason, per-tenant tallies, preemption counts) and per-sample
# priority/tenant/shed_reason keys. v6: + adapter section (which
# ModelAdapter served the run, MoE expert-load balance, the sparse-
# attention token fraction, offloaded-page counts). v7: + paged section
# (page-granular KV pool facts: page quantum, arena size, peak pages
# in use, utilization at peak) — each additive, but comparisons across
# versions deserve the gate's schema caveat.

# Gate polarity: which direction is a REGRESSION for each report
# metric. Lower-is-better latencies only fail when they grow;
# higher-is-better rates only fail when they shrink — an improvement
# must never fail a gate (that trains people to stop running it).
LOWER_IS_BETTER = ("ttft_p50_ms", "ttft_p99_ms", "itl_p50_ms",
                   "itl_p99_ms", "queue_wait_p99_ms")
HIGHER_IS_BETTER = ("tokens_per_sec", "goodput_tokens_per_sec",
                    "goodput_tokens_per_sec_per_chip", "slo_attainment")
GATE_DEFAULT_METRICS = ("ttft_p99_ms", "itl_p99_ms", "tokens_per_sec",
                        "goodput_tokens_per_sec")

# window-metric key -> (registry snapshot key, histogram stat, scale)
_WINDOW_HIST = {
    "ttft_p50_ms": ("ttft_seconds", "p50", 1e3),
    "ttft_p99_ms": ("ttft_seconds", "p99", 1e3),
    "itl_p50_ms": ("inter_token_seconds", "p50", 1e3),
    "itl_p99_ms": ("inter_token_seconds", "p99", 1e3),
    "queue_wait_p50_ms": ("queue_wait_seconds", "p50", 1e3),
    "queue_wait_p99_ms": ("queue_wait_seconds", "p99", 1e3),
}
_WINDOW_GAUGE = {
    "queue_depth": "queue_depth",
    "slot_occupancy": "slot_occupancy",
}


def _window_rows(windows, t0):
    """Flatten collector records into the report's window rows: stable
    top-level keys (the schema the gate and the docs promise), times
    relative to the run start."""
    rows = []
    for w in windows:
        m = w["metrics"]
        row = {
            "index": w["index"],
            "t_start_s": round(w["t_start"] - t0, 6),
            "duration_s": round(w["duration_s"], 6),
        }
        for key, (src, stat, scale) in _WINDOW_HIST.items():
            stats = m.get(src)
            v = stats.get(stat) if isinstance(stats, dict) else None
            row[key] = None if v is None else v * scale
        for key, src in _WINDOW_GAUGE.items():
            row[key] = m.get(src)
        toks = m.get("tokens_out", 0) or 0
        row["tokens_out"] = int(toks)
        row["tokens_per_sec"] = toks / w["duration_s"]
        row["requests_completed"] = int(m.get("requests_completed", 0) or 0)
        rows.append(row)
    return rows


def _percentile(vals, p):
    if not vals:
        return None
    s = sorted(vals)
    return s[min(int(len(s) * p / 100.0), len(s) - 1)]


def _chaos_section(result, slo):
    """Fold the run's recovery facts into the report's ``chaos``
    section. Present on every report (stable schema — a fault-free run
    shows zeros), load-bearing on chaos runs: ``requests_lost`` is the
    recovery invariant's bottom line (MUST be 0), ``recovery_time_s``
    the total wall clock spent rebuilding, and the attainment split —
    requests whose lifespan overlapped a recovery interval vs the rest —
    is the SLO price of surviving the fault, separated from steady-state
    quality instead of smeared over the whole run."""
    recovery = list(getattr(result, "recovery", []) or [])
    touched, untouched = [], []
    for s in result.samples:
        if s["shed"] or s["e2e_s"] is None:
            continue
        start, end = s["arrival_s"], s["arrival_s"] + s["e2e_s"]
        hit = any(start <= r["t_end_s"] and end >= r["t_start_s"]
                  for r in recovery)
        (touched if hit else untouched).append(s)

    def _att(rows):
        if not rows:
            return None
        return sum(1 for s in rows if slo.meets(s)) / len(rows)

    return {
        "requests_lost": int(getattr(result, "requests_lost", 0)),
        "faults_injected": int(getattr(result, "faults_injected", 0)),
        "recoveries": len(recovery),
        "recovery_time_s": round(sum(r["duration_s"] for r in recovery), 6),
        "recovery_intervals": recovery,
        "requests_during_recovery": len(touched),
        "slo_attainment_during_recovery": _att(touched),
        "slo_attainment_outside_recovery": _att(untouched),
    }


def _prefix_section(result):
    """Prefix-cache facts for the run (stable schema — an engine with
    no prefix cache shows zeros and a null hit rate). The counters are
    run DELTAS the runner read back; ``hit_rate`` is the headline the
    fleet-affinity A/B compares: hits / probes, null when the run never
    probed (so a disabled cache is distinguishable from a 0% one)."""
    hits = int(getattr(result, "prefix_hits", 0))
    misses = int(getattr(result, "prefix_misses", 0))
    probes = hits + misses
    return {
        "prefix_hits": hits,
        "prefix_misses": misses,
        "hit_rate": (hits / probes) if probes else None,
        "prefix_bytes_shipped": int(
            getattr(result, "prefix_bytes_shipped", 0)),
        "affinity_routed": int(getattr(result, "affinity_routed", 0)),
    }


def _disagg_section(result):
    """Disaggregated-serving facts for the run (stable schema — a
    single engine or all-mixed fleet shows zeros). The counters are run
    DELTAS the runner read back: ``handoffs`` prompts captured off
    prefill replicas and migrated, ``handoff_fallbacks`` the re-prefills
    taken when no decode-capable replica could adopt (each one is a
    resilience event, not a loss — the stream still completed), and the
    KV bytes the handoff records shipped host-side. The disagg A/B's
    headline lives in the aggregate ITL percentiles; this section is
    the attribution that the traffic really migrated."""
    return {
        "handoffs": int(getattr(result, "handoffs", 0)),
        "handoff_fallbacks": int(getattr(result, "handoff_fallbacks", 0)),
        "handoff_bytes_shipped": int(
            getattr(result, "handoff_bytes_shipped", 0)),
    }


def _frontdoor_section(result, slo, class_slos=None):
    """Front-door facts for the run (stable schema — an untagged run
    shows one ``untagged`` class and zero preemptions). Samples group
    by their ``priority`` tag; each class is judged against its OWN
    budget from ``class_slos`` (name -> SLO) with the run-level SLO as
    the fallback — per-class attainment under per-class budgets is the
    number the mixed-tenant acceptance gate pins. ``sheds_by_reason``
    folds the structured QueueFull reasons (rate_limit /
    frontdoor_full / deadline / slo / queue_full); preemption counts
    are the runner's counter deltas."""
    class_slos = class_slos or {}
    by_class = {}
    for s in result.samples:
        by_class.setdefault(s.get("priority") or "untagged",
                            []).append(s)
    classes = {}
    for cname, rows in sorted(by_class.items()):
        budget = class_slos.get(cname, slo)
        ttfts = [r["ttft_s"] * 1e3 for r in rows
                 if r.get("ttft_s") is not None]
        itls = [r["itl_s"] * 1e3 for r in rows
                if r.get("itl_s") is not None]
        classes[cname] = {
            "requests": len(rows),
            "completed": sum(1 for r in rows if r["completed"]),
            "shed": sum(1 for r in rows if r["shed"]),
            "budgets": budget.to_json(),
            "slo_attainment": (sum(1 for r in rows if budget.meets(r))
                               / len(rows)) if rows else None,
            "ttft_p50_ms": _percentile(ttfts, 50),
            "ttft_p99_ms": _percentile(ttfts, 99),
            "itl_p50_ms": _percentile(itls, 50),
            "itl_p99_ms": _percentile(itls, 99),
        }
    sheds = {}
    tenants = {}
    for s in result.samples:
        if s["shed"]:
            reason = s.get("shed_reason") or "queue_full"
            sheds[reason] = sheds.get(reason, 0) + 1
        tname = s.get("tenant")
        if tname is not None:
            row = tenants.setdefault(
                tname, {"requests": 0, "completed": 0, "shed": 0,
                        "tokens_out": 0})
            row["requests"] += 1
            row["completed"] += 1 if s["completed"] else 0
            row["shed"] += 1 if s["shed"] else 0
            row["tokens_out"] += s["tokens_out"]
    return {
        "classes": classes,
        "sheds_by_reason": sheds,
        "tenants": tenants,
        "preemptions": int(getattr(result, "preemptions", 0)),
        "preempt_resumes": int(getattr(result, "preempt_resumes", 0)),
    }


def _adapter_section(result):
    """Adapter facts for the run (stable schema — a plain GPT-2 run
    shows the adapter name with empty/zero workload tallies). MoE:
    per-expert dispatch totals plus the imbalance ratio (max load over
    uniform share; 1.0 = perfectly balanced) the expert-parallel A/B
    reads. Long-context: the sparse threshold in force and the fraction
    of GENERATED tokens emitted from query positions past it — computed
    from the per-sample geometry, so it is exact for the stream the run
    actually served — plus the KV host-offload swap deltas
    (offloaded/restored page counts) that evidence capacity headroom
    came from the hierarchy, not luck."""
    load = [float(v) for v in getattr(result, "expert_load", []) or []]
    total = sum(load)
    thr = int(getattr(result, "sparse_decode_threshold", 0) or 0)
    gen = sparse = 0
    if thr > 0:
        for s in result.samples:
            n = s["tokens_out"]
            if not n:
                continue
            gen += n
            # Generated tokens sit at positions prompt..prompt+n-1; a
            # token is sparse-served when its position >= threshold.
            sparse += max(0, s["prompt_tokens"] + n - max(
                thr, s["prompt_tokens"]))
    return {
        "adapter": getattr(result, "adapter", None),
        "expert_load": load,
        "expert_load_imbalance": (
            max(load) * len(load) / total) if total else None,
        "sparse_decode_threshold": thr,
        "sparse_token_fraction": (sparse / gen) if gen else None,
        "offloaded_pages": int(getattr(result, "swap_outs", 0)),
        "restored_pages": int(getattr(result, "swap_ins", 0)),
    }


def _paged_section(result):
    """Paged-KV facts for the run (schema v7; stable schema — a dense
    engine shows ``paged: false`` with zero/null tallies). The numbers
    are the runner's poll of ``engine.kv_page_stats()``: the page
    quantum and arena size are static, ``pages_peak`` is the high-water
    page count across the run's steps, and ``page_utilization`` is
    live tokens over mapped capacity AT that peak — the fragmentation
    bound that says how much of the claimed HBM actually held KV."""
    util = getattr(result, "kv_page_utilization", None)
    return {
        "paged": bool(getattr(result, "paged", False)),
        "page_len": int(getattr(result, "kv_page_len", 0) or 0),
        "pages_total": int(getattr(result, "kv_pages_total", 0) or 0),
        "pages_peak": int(getattr(result, "kv_pages_peak", 0) or 0),
        "page_utilization": None if util is None else round(float(util), 6),
    }


def build_report(spec, result, slo, chips=1, platform=None, extra=None,
                 class_slos=None):
    """Fold one RunResult into the report document.

    Aggregates come from the per-request samples (exact, not windowed);
    the ``windows`` rows carry the curves. ``extra`` merges caller
    provenance (git hash, config digest, probe state) into
    ``context`` — the gate reads context to warn when two reports were
    never comparable to begin with. ``class_slos`` (name -> SLO) gives
    each priority class its own budget in the frontdoor section."""
    t0 = result.windows[0]["t_start"] if result.windows else 0.0
    ttfts = [s["ttft_s"] * 1e3 for s in result.samples
             if s["ttft_s"] is not None]
    itls = [s["itl_s"] * 1e3 for s in result.samples
            if s["itl_s"] is not None]
    wall = max(result.wall_s, 1e-9)
    slo_section = slo_mod.evaluate(result.samples, slo, result.wall_s,
                                   chips=chips)
    context = {"platform": platform, "chips": int(chips),
               "seed": getattr(spec, "seed", None)}
    if extra:
        context.update(extra)
    return {
        "schema_version": SCHEMA_VERSION,
        "workload": spec.to_json() if hasattr(spec, "to_json") else None,
        "context": context,
        "aggregate": {
            "wall_s": result.wall_s,
            "submitted": result.submitted,
            "completed": result.completed,
            "shed": result.shed,
            "tokens_out": result.tokens_out,
            "tokens_per_sec": result.tokens_out / wall,
            "ttft_p50_ms": _percentile(ttfts, 50),
            "ttft_p99_ms": _percentile(ttfts, 99),
            "itl_p50_ms": _percentile(itls, 50),
            "itl_p99_ms": _percentile(itls, 99),
            "slo_attainment": slo_section["attainment"],
            "goodput_tokens_per_sec":
                slo_section["goodput_tokens_per_sec"],
            "goodput_tokens_per_sec_per_chip":
                slo_section["goodput_tokens_per_sec_per_chip"],
        },
        "slo": slo_section,
        "chaos": _chaos_section(result, slo),
        "prefix": _prefix_section(result),
        "disagg": _disagg_section(result),
        "frontdoor": _frontdoor_section(result, slo, class_slos),
        "adapter": _adapter_section(result),
        "paged": _paged_section(result),
        "timeseries": {
            "window_seconds": result.collector.window_seconds,
            "windows_total": result.collector._idx,
            "dropped": result.collector.dropped,
            "windows": _window_rows(result.windows, t0),
        },
        "samples": result.samples,
    }


# ------------------------------------------------------------- saturation


def saturation_sweep(run_fn, rates, attainment_floor=0.95):
    """Step the offered arrival rate through ``rates`` and report the
    max sustainable one.

    ``run_fn(rate)`` runs one sustained pass at that offered rate and
    returns its report (callers reuse ONE warm engine across steps —
    the sweep measures capacity, not compile time). A rate is
    SUSTAINABLE when SLO attainment held ``attainment_floor``; the knee
    where attainment collapses and tokens/sec flatlines is the
    engine's real capacity — the number a single-rate run can't give
    you."""
    steps = []
    max_rate = None
    for rate in rates:
        rep = run_fn(rate)
        att = rep["aggregate"]["slo_attainment"]
        ok = att is not None and att >= attainment_floor
        steps.append({
            "rate": rate,
            "attainment": att,
            "tokens_per_sec": rep["aggregate"]["tokens_per_sec"],
            "goodput_tokens_per_sec":
                rep["aggregate"]["goodput_tokens_per_sec"],
            "shed": rep["aggregate"]["shed"],
            "sustainable": ok,
        })
        if ok and (max_rate is None or rate > max_rate):
            max_rate = rate
    return {"attainment_floor": attainment_floor, "rates": steps,
            "max_sustainable_rate": max_rate}


# ------------------------------------------------------------------- gate


def _series(report, metric):
    """Per-window series for ``metric``: the windowed samples the noise
    floor is estimated from. Rate/goodput metrics don't have window
    rows under those exact names — tokens_per_sec does, and the
    goodput/attainment family falls back to it as its noise proxy (same
    underlying token stream)."""
    key = metric if metric in ("ttft_p50_ms", "ttft_p99_ms", "itl_p50_ms",
                               "itl_p99_ms", "queue_wait_p50_ms",
                               "queue_wait_p99_ms", "queue_depth",
                               "slot_occupancy", "tokens_per_sec") \
        else "tokens_per_sec"
    vals = [w.get(key) for w in report["timeseries"]["windows"]]
    return [v for v in vals if v is not None]


def _rel_sem(series, center):
    """Relative standard error of the window mean — this run's own
    noise, in the same units as a relative delta. Fewer than 2 windows
    (or a zero center) estimates nothing: returns 0, leaving the fixed
    ``rel_tol`` floor in charge."""
    n = len(series)
    if n < 2 or not center:
        return 0.0
    mean = sum(series) / n
    var = sum((v - mean) ** 2 for v in series) / (n - 1)
    return math.sqrt(var / n) / abs(center)


def _agg(report, metric):
    if metric == "slo_attainment":
        return report["aggregate"]["slo_attainment"]
    return report["aggregate"].get(metric)


def regression_gate(baseline, candidate, metrics=None, rel_tol=0.10,
                    noise_k=3.0):
    """Noise-aware A/B gate between two reports.

    Per metric: relative delta of the aggregate values, compared
    against ``threshold = max(rel_tol, noise_k * sqrt(sem_a^2 +
    sem_b^2))`` where each sem is that run's relative standard error
    estimated from its per-window series. A metric FLAGS only when the
    delta exceeds the threshold IN THE REGRESSION DIRECTION for its
    polarity — improvements never flag. Identical reports (A/A) have
    delta 0 and pass by construction.

    ``caveats`` lists context mismatches (platform, seed, schema) that
    make the comparison itself suspect — the gate still runs, but a
    red result on mismatched context blames the context first."""
    metrics = list(metrics or GATE_DEFAULT_METRICS)
    caveats = []
    for k in ("platform", "seed"):
        a = baseline.get("context", {}).get(k)
        b = candidate.get("context", {}).get(k)
        if a != b:
            caveats.append("context.{} differs: {!r} vs {!r}".format(
                k, a, b))
    if baseline.get("schema_version") != candidate.get("schema_version"):
        caveats.append("schema_version differs: {!r} vs {!r}".format(
            baseline.get("schema_version"),
            candidate.get("schema_version")))
    rows = {}
    for m in metrics:
        a, b = _agg(baseline, m), _agg(candidate, m)
        row = {"baseline": a, "candidate": b, "delta_rel": None,
               "noise_floor": None, "threshold": None,
               "direction": ("lower_is_better"
                             if m in LOWER_IS_BETTER else
                             "higher_is_better"),
               "flagged": False}
        if a is not None and b is not None and a != 0:
            delta = (b - a) / abs(a)
            noise = noise_k * math.sqrt(
                _rel_sem(_series(baseline, m), a) ** 2 +
                _rel_sem(_series(candidate, m), b) ** 2)
            thr = max(rel_tol, noise)
            regress = delta > thr if m in LOWER_IS_BETTER else delta < -thr
            row.update({"delta_rel": delta, "noise_floor": noise,
                        "threshold": thr, "flagged": bool(regress)})
        rows[m] = row
    out = {
        "pass": not any(r["flagged"] for r in rows.values()),
        "rel_tol": rel_tol,
        "noise_k": noise_k,
        "metrics": rows,
        "caveats": caveats,
    }
    # Cost-model arm (telemetry/xray.py): when both reports carry a
    # perf_xray section, compare the programs' cost records too (flops,
    # bytes, the graph pool's bytes per program, bytes per token). Each is
    # computed from the programs' shapes and one recorded run, not timed,
    # so an A/B catches a "2x bytes per token" regression no timing series
    # could resolve. A/A passes by construction.
    xa, xb = baseline.get("perf_xray"), candidate.get("perf_xray")
    if xa is not None and xb is not None:
        from deepspeed_tpu_torch.telemetry.xray import cost_model_gate

        xgate = cost_model_gate(xa, xb)
        out["perf_xray"] = xgate
        out["pass"] = out["pass"] and bool(xgate.get("pass", True))
    return out
