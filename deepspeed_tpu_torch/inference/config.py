"""InferenceConfig: the serving engine's settings.

Counterpart of ``deepspeed_tpu/inference/config.py``. The dataclass holds
the settings the port reads, with the JAX package's defaults: chunked
prefill into a dense or paged slotted pool of fp or int8 planes,
speculative decoding (``spec_decode``, ``spec_k``, ``spec_ngram``; see
``resolved_spec_decode``), and telemetry (``telemetry``: trace spans and
profiler scopes on top of the always-on metrics registry; ``trace_ring``:
the span ring's capacity).

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

_FLEET = "the reliability and fleet slice (ROADMAP Queue 1)"
_HIERARCHY = ("the prefix and offload tiers of the KV hierarchy (ROADMAP "
              "Queue 1)")
_XRAY = "the perf x-ray slice (ROADMAP Queue 1 item 7)"

# JAX-package key -> (values the port accepts, the slice that ports the
# rest). The first accepted value is the JAX default.
_UNPORTED = {
    "prefill_buckets": ((None,), "no slice: the port serves only the "
                        "chunked mixed step"),
    "chunked_prefill": ((True,), "no slice: the port serves only the "
                        "chunked mixed step"),
    "use_flash_decode": ((None, True), "no slice: the port's one attention "
                         "path is kernel K3 on the GPU and its plain version "
                         "on the CPU"),
    # The port has no perf x-ray: switching it off asks for what it does.
    "perf_xray": ((True, False), _XRAY),
    "xray_sample_every": ((64,), _XRAY),
    "fault_injection": ((False,), _FLEET),
    "step_budget_s": ((None,), _FLEET),
    "recovery_max_retries": ((2,), _FLEET),
    "recovery_backoff_s": ((0.0,), _FLEET),
    "replica_id": ((None,), _FLEET),
    "role": (("mixed",), _FLEET),
    "prefix_cache": ((False,), _HIERARCHY),
    "prefix_slots": ((8,), _HIERARCHY),
    "prefix_len": ((64,), _HIERARCHY),
    "min_prefix_len": ((8,), _HIERARCHY),
    "host_offload": ((False,), _HIERARCHY),
    "swap_slots": ((8,), _HIERARCHY),
    "hbm_budget_bytes": ((None,), _HIERARCHY),
    "sparse_decode": ((True,), "the long-context adapter slice "
                      "(ROADMAP Queue 1)"),
    "expert_parallel": ((True,), "the MoE adapter slice (ROADMAP Queue 1)"),
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

    def __post_init__(self):
        for name in ("max_slots", "chunk_size", "max_queue", "prefill_chunk",
                     "max_len", "kv_page_len", "spec_k", "spec_ngram",
                     "trace_ring"):
            if getattr(self, name) < 1:
                raise ValueError("inference.{} must be >= 1, got {}".format(
                    name, getattr(self, name)))
        if self.kv_pages is not None and self.kv_pages < 1:
            raise ValueError("inference.kv_pages must be >= 1 (or None for "
                             "dense-parity capacity), got "
                             "{}".format(self.kv_pages))

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
