"""Zero-cost source annotations for graftlint over the port.

Counterpart of ``deepspeed_tpu/analysis/annotations.py``. Hot code imports
this module (the serving engine, the decode kernels, the model source), so
it has no dependencies and its markers cost nothing at run time:

- ``hot_path`` is an identity decorator: it returns the function itself
  (no wrapper frame) after stamping ``__graftlint_hot_path__`` on it. The
  analyzer reads the decorator from the source; the stamp lets run-time
  introspection agree.
- ``_THREAD_OWNED`` is a plain class attribute (a frozenset of attribute
  names) that classes checked by THREADRACE declare: the attributes one
  thread owns.

The tables below are the analyzer's second source of truth: a function
named here is hot-path (HOSTSYNC and DETERMINISM cover its whole body,
nested defs included) even if its decorator is deleted; the sanctioned
sites are the only places allowed to read the step's harvest back or to
capture a CUDA graph.
"""


def hot_path(fn):
    """Mark ``fn`` as serving/decode hot-path code: no device-to-host read
    (HOSTSYNC) and no wall clock or unseeded RNG (DETERMINISM) in its
    body. Returns ``fn`` itself."""
    fn.__graftlint_hot_path__ = True
    return fn


# Functions hot by decree, by canonical module path (from the repo root).
# Names match the last segment of the function's qualname.
HOT_PATH_FUNCTIONS = {
    "deepspeed_tpu_torch/inference/engine.py": frozenset({
        "_mixed_step_program", "_decode_chunk_program",
        "_spec_decode_chunk_program", "_prefill_lane",
    }),
    "deepspeed_tpu_torch/ops/sampling.py": frozenset({"sample_rows"}),
    "deepspeed_tpu_torch/models/generation.py": frozenset({
        "_forward", "decode_step", "append_forward", "verify_forward",
        "ngram_draft", "accept_counts",
    }),
    "deepspeed_tpu_torch/inference/kv_pool.py": frozenset({
        "cache_view", "slot_cache_view",
    }),
    "deepspeed_tpu_torch/ops/transformer/kernels/decode_attention.py":
        frozenset({
            "flash_decode_attention", "flash_decode_attention_q8",
            "quantize_kv", "dequantize_kv", "decode_attention_reference",
            "decode_attention_q8_reference",
            "flash_decode_attention_paged",
            "flash_decode_attention_paged_q8",
            "decode_attention_paged_reference",
            "decode_attention_paged_q8_reference",
        }),
}

# The only functions allowed to read the step's harvest back
# (``<...harvest>.read()``, the one device-to-host copy a step) and to
# call the kv_pool snapshot helpers without a snapshot: the engine's step
# and kv_pool itself. The x-ray's sampled step wait is the measurement.
SANCTIONED_SYNC_SITES = {
    "deepspeed_tpu_torch/inference/kv_pool.py": frozenset({
        "read", "max_active_frontier", "free_slots",
    }),
    "deepspeed_tpu_torch/inference/engine.py": frozenset({
        "_step_chunked",
    }),
    "deepspeed_tpu_torch/telemetry/xray.py": frozenset({
        "sample_step",
    }),
}

# The only places that capture CUDA graphs: the serving engine's program
# cache (each key's graph, captured once after its eager first run) and
# the compiled pipeline's tick programs. A module maps to the functions or
# classes (every method) sanctioned in it; "*" sanctions the whole module.
SANCTIONED_CAPTURE_SITES = {
    "deepspeed_tpu_torch/inference/engine.py": frozenset({
        "_run_program", "_StepGraph",
    }),
    "deepspeed_tpu_torch/runtime/pipe/compiled.py": frozenset({"*"}),
}

# Modules where DETERMINISM applies to every function: seeded workload
# generation (a WorkloadSpec replays bit for bit from its seed) and the
# decode program's source.
DETERMINISM_MODULES = (
    "deepspeed_tpu_torch/loadgen/workload.py",
    "deepspeed_tpu_torch/models/generation.py",
    "deepspeed_tpu_torch/inference/kv_pool.py",
)

# Classes THREADRACE always checks, manifest or not (a class that defines
# ``_THREAD_OWNED`` opts in wherever it lives).
THREAD_CHECKED_CLASSES = ("InferenceEngine", "ServingFleet",
                          "PrefixDirectory", "HandoffPump",
                          "FrontDoor", "TokenStream",
                          "AlertManager", "TraceContext")
