"""graftlint over the port: a static analyzer of the serving and training
contracts in torch idioms, and a thread-race detector.

Counterpart of ``deepspeed_tpu.analysis``. Stdlib ``ast`` only, so it is
safe to import anywhere. Entry points:

- CLI: ``python -m deepspeed_tpu_torch.analysis [paths] [--baseline F]
  [--format text|json]`` (``__main__``);
- library: ``collect_findings(paths)`` / ``analyze_file(path)``;
- markers: ``deepspeed_tpu_torch.analysis.annotations.hot_path`` and the
  ``_THREAD_OWNED`` class-attribute convention.

The rules (``rules/``), each with the JAX rule's name and invariant:
HOSTSYNC (no device-to-host read in hot-path code; the harvest is read at
the step's sanctioned point only), RECOMPILE (no CUDA-graph capture outside
the sanctioned sites; a program key of host facts only), DONATION (a host
buffer handed to a ``non_blocking`` copy is not written again before the
copy is waited on), DETERMINISM (no wall clock and no unseeded RNG in
replayable code), THREADRACE (shared state written under the lock or
declared thread-owned) and ADAPTER (serving reaches the model through the
adapter).
"""

from . import annotations
from .core import (AnalysisConfig, Finding, analyze_file, analyze_source,
                   apply_baseline, baseline_key, collect_findings,
                   load_baseline, write_baseline)

DEFAULT_BASELINE = "baseline.json"  # relative to this package directory

__all__ = [
    "AnalysisConfig", "Finding", "analyze_file", "analyze_source",
    "apply_baseline", "baseline_key", "collect_findings", "load_baseline",
    "write_baseline", "annotations", "DEFAULT_BASELINE",
]
