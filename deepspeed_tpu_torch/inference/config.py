"""InferenceConfig: the serving engine's settings.

Counterpart of ``deepspeed_tpu/inference/config.py``. The dataclass holds
the settings the port reads, with the JAX package's defaults: chunked
prefill into a dense or paged slotted pool of fp or int8 planes, the
rest of the KV hierarchy (``prefix_cache``, ``prefix_slots``,
``prefix_len``, ``min_prefix_len``: the shared-prefix cache;
``host_offload``, ``swap_slots``: host offload; ``hbm_budget_bytes``: the
budget of the ``effective_slots`` gauge), speculative decoding (``spec_decode``, ``spec_k``, ``spec_ngram``; see
``resolved_spec_decode``), telemetry (``telemetry``: trace spans and
profiler scopes on top of the always-on metrics registry; ``trace_ring``:
the span ring's capacity), the perf x-ray (``perf_xray``, ``xray_sample_every``), the adapters'
switches (``sparse_decode``, ``expert_parallel``), and crash-only
resilience
(``fault_injection``: the switch that lets ``engine.inject_faults`` arm a
plan; ``step_budget_s``: the step watchdog's budget, None for none;
``recovery_max_retries``: consecutive fatal steps recovered before the
engine is dead; ``recovery_backoff_s``: the sleep before the n-th
consecutive recovery, times n), and the serving fleet's per-replica
facts (``replica_id``: the replica's index, stamped into its metrics'
``replica`` label and its QueueFull errors, None outside a fleet;
``role``: ``mixed``, ``prefill`` or ``decode``, see
``inference/fleet.py``).

There is no switch for the step's CUDA graphs, as the JAX package has
none for its jit: on the card the engine always captures its step
program, one graph per key (``inference/engine.py``).

``from_dict`` parses a ds_config ``inference`` block written for the JAX
package. A key of that package which switches or sizes a subsystem the port
does not have yet parses only at its JAX default (or at the value that
names what the port already does); any other value raises
NotImplementedError naming the slice that brings it, never a quiet run down
another path. A key neither package knows raises ValueError.
"""

import dataclasses
import os
from typing import Optional

# JAX-package key -> (values the port accepts, the slice that ports the
# rest). The first accepted value is the JAX default.
_UNPORTED = {
    "prefill_buckets": ((None,), "no slice: the port serves only the "
                        "chunked mixed step"),
    "chunked_prefill": ((True,), "no slice: the port serves only the "
                        "chunked mixed step"),
    "use_flash_decode": ((None, True), "no slice: the stock GPT-2 adapter's "
                         "one attention path is kernel K3 on the GPU and its "
                         "plain version on the CPU (the einsum path serves "
                         "LongContextAdapter)"),
}


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Field meanings follow ``deepspeed_tpu.inference.config``."""

    max_slots: int = 8
    max_len: int = 512
    chunk_size: int = 16
    max_queue: int = 64
    eos_token_id: Optional[int] = None
    max_new_tokens: int = 128
    prefill_chunk: int = 32
    # Paged KV pool: a shared page arena plus per-slot block tables
    # (inference/paging.py); kv_pages sizes the usable arena (None: as
    # many pages as max_slots full rows need).
    paged_kv: bool = False
    kv_page_len: int = 128
    kv_pages: Optional[int] = None
    # int8 KV planes with fp32 per-(head, position) scales.
    int8_kv: bool = False
    # Shared-prefix cache (inference/kv_hierarchy): a host-side radix trie
    # over prompt token ids finds a shared prefix at admission; the slot
    # starts its prefill past the matched span. prefix_slots rows of up to
    # prefix_len positions (dense pools; a paged pool shares arena pages
    # and has no length cap), LRU-evicted when no live request pins them;
    # a match shorter than min_prefix_len is a miss.
    prefix_cache: bool = False
    prefix_slots: int = 8
    prefix_len: int = 64
    min_prefix_len: int = 8
    # Host offload: an idle decoding session's slot swaps to host memory
    # under slot pressure and resumes first when a slot frees (the
    # scheduler's ``swapped`` phase); at most swap_slots sessions swapped.
    host_offload: bool = False
    swap_slots: int = 8
    # The device budget effective_slots divides (None: the flat fp pool's
    # own footprint).
    hbm_budget_bytes: Optional[int] = None
    # Speculative decoding: each decode step drafts spec_k tokens by
    # spec_ngram-gram lookup over the slot's own tokens and verifies them
    # in one forward of spec_k + 1 query rows. None defers to the
    # environment (resolved_spec_decode).
    spec_decode: Optional[bool] = None
    spec_k: int = 4
    spec_ngram: int = 3
    # Trace spans and profiler scopes (the metrics registry is always
    # on), and the span ring's capacity in events.
    telemetry: bool = True
    trace_ring: int = 4096
    # Crash-only resilience (inference/resilience.py): the fault-injection
    # switch, the step watchdog's budget in seconds (None: no watchdog),
    # and the bounds on recovery (consecutive retries, linear backoff).
    fault_injection: bool = False
    step_budget_s: Optional[float] = None
    recovery_max_retries: int = 2
    recovery_backoff_s: float = 0.0
    # The serving fleet (inference/fleet.py): this replica's index (None
    # outside a fleet) and its role in disaggregated serving. A
    # ``prefill`` replica hands every finished prompt to a decode-capable
    # peer; a ``decode`` replica takes only those handoffs (it never runs
    # a prefill lane); ``mixed`` does both. Every role runs the same step
    # programs.
    replica_id: Optional[int] = None
    role: str = "mixed"
    # The perf x-ray (telemetry/xray.py): per-program cost records made on
    # each key's eager first run, the HBM ledger and the roofline gauges;
    # 1 in xray_sample_every steps is timed to the stream's end (0: none).
    # Off by default in the port (the JAX default is on): a record costs
    # the key's first run a FlopCounterMode pass on the host.
    perf_xray: bool = False
    xray_sample_every: int = 64
    # The long-context adapter's block-sparse mask (False: a dense einsum,
    # the A/B switch), and the MoE adapter's expert parallelism (over a
    # mesh's 'model' axis each rank holds E/mp experts; False: every
    # expert on every rank; no effect on one card).
    sparse_decode: bool = True
    expert_parallel: bool = True

    def __post_init__(self):
        for name in ("max_slots", "chunk_size", "max_queue", "prefill_chunk",
                     "max_len", "kv_page_len", "spec_k", "spec_ngram",
                     "trace_ring"):
            if getattr(self, name) < 1:
                raise ValueError("inference.{} must be >= 1, got {}".format(
                    name, getattr(self, name)))
        if self.xray_sample_every < 0:
            raise ValueError("inference.xray_sample_every must be >= 0 "
                             "(0 disables step-decomposition sampling), "
                             "got {}".format(self.xray_sample_every))
        if self.kv_pages is not None and self.kv_pages < 1:
            raise ValueError("inference.kv_pages must be >= 1 (or None for "
                             "dense-parity capacity), got "
                             "{}".format(self.kv_pages))
        if self.step_budget_s is not None and self.step_budget_s <= 0:
            raise ValueError("inference.step_budget_s must be > 0 (or None "
                             "to disable the watchdog), got "
                             "{}".format(self.step_budget_s))
        if self.recovery_max_retries < 0:
            raise ValueError("inference.recovery_max_retries must be >= 0, "
                             "got {}".format(self.recovery_max_retries))
        if self.recovery_backoff_s < 0:
            raise ValueError("inference.recovery_backoff_s must be >= 0, "
                             "got {}".format(self.recovery_backoff_s))
        if self.prefix_slots < 1:
            raise ValueError("inference.prefix_slots must be >= 1, got "
                             "{}".format(self.prefix_slots))
        if self.min_prefix_len < 1:
            raise ValueError("inference.min_prefix_len must be >= 1, got "
                             "{}".format(self.min_prefix_len))
        if self.prefix_len < self.min_prefix_len:
            raise ValueError(
                "inference.prefix_len={} must be >= min_prefix_len={}"
                .format(self.prefix_len, self.min_prefix_len))
        if self.prefix_len > self.max_len:
            raise ValueError(
                "inference.prefix_len={} exceeds max_len={}".format(
                    self.prefix_len, self.max_len))
        if self.swap_slots < 1:
            raise ValueError("inference.swap_slots must be >= 1, got "
                             "{}".format(self.swap_slots))
        if self.replica_id is not None and self.replica_id < 0:
            raise ValueError("inference.replica_id must be >= 0 (or None "
                             "outside a fleet), got "
                             "{}".format(self.replica_id))
        if self.role not in ("mixed", "prefill", "decode"):
            raise ValueError(
                "inference.role must be one of 'mixed'/'prefill'/'decode', "
                "got {!r}".format(self.role))
        if self.hbm_budget_bytes is not None and self.hbm_budget_bytes <= 0:
            raise ValueError(
                "inference.hbm_budget_bytes must be > 0 (or None for the "
                "flat-pool baseline), got {}".format(self.hbm_budget_bytes))

    @classmethod
    def from_dict(cls, block):
        """Build from a ds_config ``inference`` block (module docstring)."""
        block = dict(block or {})
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(block) - fields - set(_UNPORTED)
        if unknown:
            raise ValueError(
                "unknown inference config key(s) {}; valid keys: {}".format(
                    sorted(unknown), sorted(fields | set(_UNPORTED))))
        for name in sorted(set(block) & set(_UNPORTED)):
            accepted, where = _UNPORTED[name]
            if block[name] not in accepted:
                raise NotImplementedError(
                    "inference.{}={!r} is not ported yet: {}".format(
                        name, block[name], where))
        return cls(**{k: v for k, v in block.items() if k in fields})

    def resolved_spec_decode(self):
        """The effective speculation switch, as the JAX config resolves it:
        the explicit field wins; None defers to the ``DS_TPU_SPEC_DECODE``
        environment variable (any value but ``0`` / ``false`` turns it on);
        the default is off. The JAX config applies the variable only where
        chunked prefill is on, and the port serves only that path."""
        if self.spec_decode is not None:
            return bool(self.spec_decode)
        env = os.environ.get("DS_TPU_SPEC_DECODE", "")
        if env:
            return env not in ("0", "false")
        return False

    def validate_against_model(self, n_positions):
        if self.max_len > n_positions:
            raise ValueError(
                "inference.max_len={} exceeds the model's n_positions={}"
                .format(self.max_len, n_positions))
