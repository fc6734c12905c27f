"""Seeded workload specs — deterministic open-loop request streams.

Counterpart of ``deepspeed_tpu/loadgen/workload.py``, unchanged: the same
spec and seed give the JAX package's streams, row by row.

A ``WorkloadSpec`` describes the TRAFFIC, not the engine: when requests
arrive (Poisson / burst / ramp arrival processes, or a JSONL trace
replayed verbatim), how long their prompts are and how many tokens they
want back (heavy-tail lognormal / Zipf mixes — production length
distributions are long-tailed, and a harness that offers uniform
lengths never sees the head-of-line effects the tail causes), and what
the prompt tokens actually are (repetition-heavy phrase tiling by
default, so n-gram speculative drafting has self-matches to find — the
same choice the JAX package's serving benchmark makes).

Everything is FULLY DETERMINISTIC per ``seed``: two calls to
``spec.requests()`` — on different days, different machines — produce
identical arrival times, identical token ids, identical budgets. That
determinism is what makes an A/B comparable at all (two runs that
served different streams measure the streams, not the code) and is
pinned by the loadgen tests.

The spec is engine-agnostic: ``requests()`` returns plain
``LoadRequest`` rows the open-loop runner (runner.py) feeds to
``engine.submit()`` at their scheduled times.
"""

import dataclasses
import json
import math
from typing import Optional

import numpy as np

ARRIVALS = ("poisson", "burst", "ramp", "trace")
LENGTH_DISTS = ("fixed", "lognormal", "zipf")


@dataclasses.dataclass(eq=False)
class LoadRequest:
    """One scheduled request: WHEN it arrives and WHAT it asks for.

    ``priority``/``tenant`` are front-door tags (inference/frontdoor):
    None keeps the legacy untagged stream and the runner's legacy
    submit() call shape byte-for-byte."""

    arrival_s: float
    prompt: np.ndarray          # int32 token ids
    max_new_tokens: int
    temperature: float = 0.0
    seed: int = 0
    priority: Optional[str] = None
    tenant: Optional[str] = None


def _lengths(rng, dist, n, mean, sigma, zipf_a, lo, hi):
    """``n`` integer lengths in [lo, hi] from the named distribution.

    - ``lognormal``: mu chosen so the UNDERLYING mean is ``mean``
      (heavier sigma = heavier right tail, same center).
    - ``zipf``: ``lo * Zipf(a)`` — most draws sit at ``lo``, a power-law
      tail reaches toward ``hi`` (the shared-prefix-plus-occasional-
      novel-monster shape of real prompt traffic).
    - ``fixed``: every length is ``mean``.
    """
    if lo < 1 or hi < lo:
        raise ValueError("length bounds must satisfy 1 <= lo <= hi, got "
                         "[{}, {}]".format(lo, hi))
    if dist == "fixed":
        lens = np.full(n, float(mean))
    elif dist == "lognormal":
        mu = math.log(max(float(mean), 1.0)) - sigma * sigma / 2.0
        lens = rng.lognormal(mu, sigma, size=n)
    elif dist == "zipf":
        lens = float(lo) * rng.zipf(zipf_a, size=n)
    else:
        raise ValueError("unknown length distribution {!r}; one of "
                         "{}".format(dist, LENGTH_DISTS))
    return np.clip(np.rint(lens), lo, hi).astype(int)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    # Arrival process: 'poisson' (exponential gaps at ``rate``), 'burst'
    # (groups of ``burst_size`` simultaneous arrivals every
    # ``burst_gap_s``), 'ramp' (Poisson whose intensity ramps linearly
    # ``ramp_from`` -> ``rate`` across the stream — the saturation-sweep
    # shape in one run), 'trace' (replay ``trace_path`` JSONL verbatim).
    arrival: str = "poisson"
    # Mean arrivals/second (poisson), final rate (ramp); unused by
    # 'burst' (its rate is burst_size / burst_gap_s) and 'trace'.
    rate: float = 8.0
    n_requests: int = 64
    burst_size: int = 8
    burst_gap_s: float = 1.0
    ramp_from: float = 1.0
    # Prompt-length mix (tokens).
    prompt_dist: str = "lognormal"
    prompt_mean: int = 64
    prompt_sigma: float = 0.6
    prompt_zipf_a: float = 2.2
    prompt_min: int = 1
    prompt_max: int = 256
    # Output-budget mix (max_new_tokens per request).
    output_dist: str = "lognormal"
    output_mean: int = 64
    output_sigma: float = 0.6
    output_zipf_a: float = 2.2
    output_min: int = 1
    output_max: int = 128
    vocab_size: int = 50257
    # Prompt content: > 0 tiles a per-request random phrase of this many
    # tokens to the prompt length (repetition-heavy — text repeats, and
    # the n-gram drafter needs matches); 0 draws uniform random tokens.
    phrase_len: int = 8
    # Shared system-prompt pool: > 0 pre-draws this many fixed prefixes
    # of ``prefix_tokens`` tokens each and prepends one to every prompt,
    # chosen by a Zipf(``prefix_zipf_a``) rank — a few prefixes dominate
    # (the shape of real system-prompt traffic), which is exactly what a
    # shared-prefix KV cache exploits. 0 disables (and keeps streams
    # byte-identical to specs that predate this knob: the pool draws
    # come AFTER every legacy draw in RandomState order).
    prefix_pool: int = 0
    prefix_tokens: int = 32
    prefix_zipf_a: float = 1.5
    temperature: float = 0.0
    # JSONL trace to replay when arrival == 'trace' (see replay_trace).
    trace_path: Optional[str] = None
    seed: int = 0

    def __post_init__(self):
        if self.arrival not in ARRIVALS:
            raise ValueError("unknown arrival process {!r}; one of "
                             "{}".format(self.arrival, ARRIVALS))
        if self.arrival == "trace":
            if not self.trace_path:
                raise ValueError(
                    "arrival='trace' requires trace_path (a JSONL file — "
                    "see loadgen.workload.save_trace)")
        else:
            if self.n_requests < 1:
                raise ValueError("n_requests must be >= 1, got "
                                 "{}".format(self.n_requests))
            if self.rate <= 0:
                raise ValueError("rate must be > 0, got "
                                 "{}".format(self.rate))
        if self.arrival == "burst" and (self.burst_size < 1 or
                                        self.burst_gap_s <= 0):
            raise ValueError("burst needs burst_size >= 1 and "
                             "burst_gap_s > 0")
        if self.arrival == "ramp" and self.ramp_from <= 0:
            raise ValueError("ramp_from must be > 0, got "
                             "{}".format(self.ramp_from))
        for d in (self.prompt_dist, self.output_dist):
            if d not in LENGTH_DISTS:
                raise ValueError("unknown length distribution {!r}; one "
                                 "of {}".format(d, LENGTH_DISTS))
        if self.prefix_pool < 0:
            raise ValueError("prefix_pool must be >= 0, got "
                             "{}".format(self.prefix_pool))
        if self.prefix_pool > 0:
            if self.prefix_tokens < 1:
                raise ValueError("prefix_tokens must be >= 1 when "
                                 "prefix_pool > 0, got "
                                 "{}".format(self.prefix_tokens))
            if self.prefix_zipf_a <= 1.0:
                raise ValueError("prefix_zipf_a must be > 1, got "
                                 "{}".format(self.prefix_zipf_a))

    # ---------------------------------------------------------- arrivals

    def _arrival_times(self, rng):
        n = self.n_requests
        if self.arrival == "poisson":
            return np.cumsum(rng.exponential(1.0 / self.rate, size=n))
        if self.arrival == "burst":
            group = np.arange(n) // self.burst_size
            return group.astype(float) * self.burst_gap_s
        # ramp: a Poisson process whose intensity ramps linearly from
        # ramp_from to rate across the stream — gap i is an exponential
        # draw at the instantaneous rate.
        rates = np.linspace(self.ramp_from, self.rate, n)
        return np.cumsum(rng.exponential(1.0, size=n) / rates)

    # ---------------------------------------------------------- requests

    def requests(self):
        """The full request stream, arrival-sorted. Deterministic per
        ``seed`` — every random draw comes from one RandomState(seed)
        consumed in a fixed order."""
        if self.arrival == "trace":
            return replay_trace(self.trace_path,
                                vocab_size=self.vocab_size, seed=self.seed)
        rng = np.random.RandomState(self.seed)
        arrivals = self._arrival_times(rng)
        plens = _lengths(rng, self.prompt_dist, self.n_requests,
                         self.prompt_mean, self.prompt_sigma,
                         self.prompt_zipf_a, self.prompt_min,
                         self.prompt_max)
        outs = _lengths(rng, self.output_dist, self.n_requests,
                        self.output_mean, self.output_sigma,
                        self.output_zipf_a, self.output_min,
                        self.output_max)
        # Shared prefixes are drawn ONCE, after all legacy draws, so a
        # prefix_pool=0 spec consumes the RandomState identically to
        # specs written before the knob existed.
        pool = None
        if self.prefix_pool > 0:
            pool = rng.randint(0, self.vocab_size,
                               size=(self.prefix_pool, self.prefix_tokens))
        reqs = []
        for i in range(self.n_requests):
            n = int(plens[i])
            prefix = None
            if pool is not None:
                # Zipf rank folded onto the pool: rank 1 (most of the
                # mass) is prefix 0, so a small number of prefixes serve
                # most requests.
                rank = int(rng.zipf(self.prefix_zipf_a))
                prefix = pool[(rank - 1) % self.prefix_pool]
                n = max(n - prefix.size, 0)
            if n == 0:
                toks = np.empty((0,), dtype=int)
            elif self.phrase_len > 0:
                phrase = rng.randint(0, self.vocab_size,
                                     size=(min(self.phrase_len, n),))
                toks = np.tile(phrase, -(-n // phrase.size))[:n]
            else:
                toks = rng.randint(0, self.vocab_size, size=(n,))
            if prefix is not None:
                toks = np.concatenate([prefix, toks])
            reqs.append(LoadRequest(
                arrival_s=float(arrivals[i]),
                prompt=toks.astype(np.int32),
                max_new_tokens=int(outs[i]),
                temperature=self.temperature,
                seed=int(rng.randint(0, 2 ** 31 - 1))))
        return reqs

    def to_json(self):
        """JSON-safe echo of the spec for run reports (a report must
        carry the workload that produced it — a gate comparing runs of
        DIFFERENT workloads measures the workloads)."""
        return dataclasses.asdict(self)

    @classmethod
    def template_heavy(cls, **overrides):
        """Template-dominated traffic: a SMALL pool of long shared
        system prompts (Zipf-skewed, so two templates carry most of the
        mass) with short unique tails — the workload shape the fleet
        prefix directory and prefix-affinity routing are built for. A
        prompt is ``prefix_tokens`` shared tokens plus a 2..~48-token
        per-request tail (the lognormal prompt-length draw minus the
        prefix; tails are unique because each request tiles its own
        phrase draw). Deterministic per ``seed`` like every spec —
        same-seeded calls produce byte-identical streams. Tests override
        geometry down (prefix_tokens, prompt bounds) to fit tiny-engine
        max_len; the defaults fit the serving benchmark."""
        params = dict(
            arrival="poisson",
            rate=8.0,
            n_requests=64,
            prefix_pool=4,
            prefix_tokens=48,
            prefix_zipf_a=1.3,
            prompt_dist="lognormal",
            prompt_mean=60,
            prompt_sigma=0.15,
            prompt_min=50,
            prompt_max=96,
            phrase_len=4,
            output_dist="lognormal",
            output_mean=16,
            output_sigma=0.3,
            output_min=4,
            output_max=32,
        )
        params.update(overrides)
        return cls(**params)

    @classmethod
    def long_context(cls, **overrides):
        """Long-context traffic: heavy-tailed lognormal prompt lengths
        whose right tail crosses 32k tokens — the workload the
        LongContextAdapter's block-sparse decode and KV host-offload
        exist for. Most requests sit in the few-thousand-token body
        (sigma 1.4 on an 8k mean puts ~4-5% of draws past 32k), so a
        run exercises BOTH regimes: dense below the sparse threshold
        and block-sparse + offload pressure above it. Arrival rate is
        low — long prompts saturate slots, and an open-loop stream that
        arrives faster than prefill drains measures only the queue.
        Output budgets stay modest (summarization shape: huge context
        in, short answer out). Tests override geometry down to fit
        tiny-engine max_len; the defaults fit the serving benchmark."""
        params = dict(
            arrival="poisson",
            rate=1.0,
            n_requests=32,
            prompt_dist="lognormal",
            prompt_mean=8192,
            prompt_sigma=1.4,
            prompt_min=512,
            prompt_max=65536,
            phrase_len=16,
            output_dist="lognormal",
            output_mean=128,
            output_sigma=0.5,
            output_min=16,
            output_max=512,
        )
        params.update(overrides)
        return cls(**params)

    @classmethod
    def mixed_tenants(cls, tenants=("tenant_a", "tenant_b"), seed=0,
                      interactive_rate=4.0, interactive_n=16,
                      batch_rate=8.0, batch_ramp_from=1.0, batch_n=16,
                      interactive_overrides=None, batch_overrides=None,
                      **common):
        """The front-door acceptance workload: per tenant, an
        INTERACTIVE Poisson stream (steady chat-shaped arrivals) plus a
        BATCH ramp (offered load climbing from ``batch_ramp_from`` to
        ``batch_rate`` — by the tail of the run batch alone saturates
        the target, which is exactly when the interactive TTFT budget
        is earned or lost). Returns a MixedWorkload whose ``requests()``
        merges every sub-stream arrival-sorted with each row tagged
        ``priority``/``tenant``.

        Determinism: each sub-spec's seed derives from (``seed``, tenant
        index, class) by fixed arithmetic — same seed, same tenants,
        same streams, forever. ``common`` overrides apply to every
        sub-spec (geometry knobs: prompt/output bounds, vocab);
        ``interactive_overrides``/``batch_overrides`` apply per class."""
        parts = []
        for i, tenant in enumerate(tenants):
            ikw = dict(
                arrival="poisson", rate=interactive_rate,
                n_requests=interactive_n,
                seed=seed * 1000 + i * 2 + 1)
            ikw.update(common)
            ikw.update(interactive_overrides or {})
            parts.append((tenant, "interactive", cls(**ikw)))
            bkw = dict(
                arrival="ramp", rate=batch_rate,
                ramp_from=batch_ramp_from, n_requests=batch_n,
                seed=seed * 1000 + i * 2 + 2)
            bkw.update(common)
            bkw.update(batch_overrides or {})
            parts.append((tenant, "batch", cls(**bkw)))
        return MixedWorkload(parts, seed=seed)


@dataclasses.dataclass(frozen=True)
class MixedWorkload:
    """Several tagged WorkloadSpec sub-streams merged into one arrival-
    sorted stream. Duck-types the WorkloadSpec surface the runner and
    report use (``requests()``, ``to_json()``, ``seed``)."""

    parts: tuple   # ((tenant, priority, WorkloadSpec), ...)
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "parts", tuple(self.parts))
        if not self.parts:
            raise ValueError("MixedWorkload needs at least one part")

    def requests(self):
        rows = []
        for tenant, priority, spec in self.parts:
            for r in spec.requests():
                r.priority = priority
                r.tenant = tenant
                rows.append(r)
        rows.sort(key=lambda r: r.arrival_s)
        return rows

    def to_json(self):
        return {
            "mixed_tenants": [
                {"tenant": tenant, "priority": priority,
                 "spec": spec.to_json()}
                for tenant, priority, spec in self.parts],
            "seed": self.seed,
        }


# ------------------------------------------------------------------ trace


def save_trace(requests, path):
    """Write a request stream as replayable JSONL — one object per
    request with explicit token ids, so replay is exact."""
    with open(path, "w") as f:
        for r in requests:
            f.write(json.dumps({
                "arrival_s": r.arrival_s,
                "prompt": [int(t) for t in np.asarray(r.prompt)],
                "max_new_tokens": int(r.max_new_tokens),
                "temperature": float(r.temperature),
                "seed": int(r.seed),
            }))
            f.write("\n")
    return path


def replay_trace(path, vocab_size=50257, seed=0):
    """Load a JSONL trace into LoadRequest rows, arrival-sorted.

    Each line needs ``arrival_s`` plus either ``prompt`` (explicit token
    ids — exact replay) or ``prompt_len`` (tokens synthesized
    deterministically from ``seed`` + line order, for traces captured
    from systems that log lengths but not content). ``max_new_tokens``
    defaults to 16; ``temperature``/``seed`` default to 0/line index.
    """
    rng = np.random.RandomState(seed)
    reqs = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            if "prompt" in row:
                toks = np.asarray(row["prompt"], np.int32)
            elif "prompt_len" in row:
                toks = rng.randint(0, vocab_size,
                                   size=(int(row["prompt_len"]),)
                                   ).astype(np.int32)
            else:
                raise ValueError(
                    "trace line {} has neither 'prompt' nor 'prompt_len'"
                    .format(i + 1))
            if toks.size < 1:
                raise ValueError("trace line {} has an empty prompt"
                                 .format(i + 1))
            reqs.append(LoadRequest(
                arrival_s=float(row["arrival_s"]),
                prompt=toks,
                max_new_tokens=int(row.get("max_new_tokens", 16)),
                temperature=float(row.get("temperature", 0.0)),
                seed=int(row.get("seed", i))))
    reqs.sort(key=lambda r: r.arrival_s)
    return reqs
