"""graftlint CLI over the port.

Usage::

    python -m deepspeed_tpu_torch.analysis [paths...] \
        [--baseline analysis/baseline.json | --baseline none] \
        [--format text|json] [--write-baseline]

Defaults: scan the ``deepspeed_tpu_torch`` package, apply the
checked-in baseline next to this file. Exit 0 when there are no new
findings AND no stale baseline entries; exit 1 otherwise; exit 2 on
usage errors. ``--write-baseline`` rewrites the baseline to exactly the
current findings (the sanctioned way to grandfather or pay down debt).
"""

import argparse
import json
import os
import sys
from collections import Counter

from .core import (AnalysisConfig, apply_baseline, collect_findings,
                   load_baseline, write_baseline)

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_DEFAULT_BASELINE = os.path.join(_PKG_DIR, "baseline.json")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.analysis",
        description="graftlint: the port's serving-contract static analyzer")
    parser.add_argument("paths", nargs="*",
                        help="files/dirs to scan (default: the deepspeed_tpu_torch package)")
    parser.add_argument("--baseline", default=_DEFAULT_BASELINE,
                        help="baseline JSON path, or 'none' to disable")
    parser.add_argument("--format", choices=("text", "json"), default="text")
    parser.add_argument("--write-baseline", action="store_true",
                        help="rewrite the baseline to the current findings and exit 0")
    args = parser.parse_args(argv)

    paths = args.paths or [os.path.dirname(_PKG_DIR)]
    for p in paths:
        if not os.path.exists(p):
            parser.error(f"no such path: {p}")

    findings = collect_findings(paths, AnalysisConfig())

    baseline_path = None if args.baseline.lower() == "none" else args.baseline
    baseline = []
    if baseline_path and os.path.exists(baseline_path):
        baseline = load_baseline(baseline_path)

    if args.write_baseline:
        if not baseline_path:
            parser.error("--write-baseline requires a --baseline path")
        write_baseline(baseline_path, findings)
        print(f"graftlint: wrote {len(findings)} finding(s) to {baseline_path}")
        return 0

    new, stale = apply_baseline(findings, baseline)
    counts = Counter(f.rule for f in findings)

    if args.format == "json":
        print(json.dumps({
            "findings": [f.to_dict() for f in new],
            "baselined": len(findings) - len(new),
            "stale_baseline": stale,
            "counts_by_rule": dict(sorted(counts.items())),
            "baseline_size": len(baseline),
        }, indent=2, sort_keys=True))
    else:
        for f in new:
            print(f.render())
        for e in stale:
            print(f"STALE-BASELINE: {e.get('rule')} {e.get('path')} "
                  f"[{e.get('symbol')}] no longer fires - delete the entry "
                  f"(shrink-only baseline)")
        summary = ", ".join(f"{k}={v}" for k, v in sorted(counts.items())) or "clean"
        print(f"graftlint: {len(new)} new finding(s), "
              f"{len(findings) - len(new)} baselined, {len(stale)} stale "
              f"baseline entr(ies) | {summary}")

    return 1 if (new or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
