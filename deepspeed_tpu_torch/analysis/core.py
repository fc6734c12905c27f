"""graftlint core: file driver, suppression comments, baseline handling.

Counterpart of ``deepspeed_tpu/analysis/core.py``. Everything here is
stdlib-only (``ast`` + ``json``). A rule is a callable ``check(ctx,
config) -> iterable[Finding]`` registered in
``deepspeed_tpu_torch.analysis.rules.RULES``; this module owns what the
rules share: parsing, the per-module context (source lines, parent links,
function table, suppression map), canonical paths so baseline entries
survive a checkout move, and the baseline's shrink-only semantics (a
baseline entry with no matching finding is itself an error: grandfathered
debt may only be paid down, never accumulate silently).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from . import annotations as _ann

RULE_NAMES = ("HOSTSYNC", "RECOMPILE", "DONATION", "DETERMINISM", "THREADRACE",
              "ADAPTER")

# ``# graftlint: disable=RULE`` or ``disable=RULE1,RULE2`` or ``disable=all``.
_SUPPRESS_RE = re.compile(r"#\s*graftlint:\s*disable=([A-Za-z_][A-Za-z0-9_,\s]*)")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # canonical repo-relative posix path
    line: int
    col: int
    symbol: str        # enclosing qualname ("" at module level)
    message: str

    def key(self) -> Tuple[str, str, str, str]:
        # Line/col intentionally excluded: baseline entries must survive
        # unrelated edits that shift line numbers.
        return (self.rule, self.path, self.symbol, self.message)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        where = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}{where}"


@dataclasses.dataclass
class AnalysisConfig:
    """Knobs the rules consult; tests override these to point at fixtures."""
    hot_path_functions: dict = dataclasses.field(
        default_factory=lambda: dict(_ann.HOT_PATH_FUNCTIONS))
    sanctioned_sync_sites: dict = dataclasses.field(
        default_factory=lambda: dict(_ann.SANCTIONED_SYNC_SITES))
    determinism_modules: tuple = _ann.DETERMINISM_MODULES
    thread_checked_classes: tuple = _ann.THREAD_CHECKED_CLASSES
    sanctioned_capture_sites: dict = dataclasses.field(
        default_factory=lambda: dict(_ann.SANCTIONED_CAPTURE_SITES))
    rules: Optional[Sequence[str]] = None   # None -> all registered rules


def canonical_relpath(path: str) -> str:
    """Stable repo-relative posix path: anchor at the
    ``deepspeed_tpu_torch`` or ``tests`` path component so baselines don't
    embed a checkout prefix; fall back to the basename."""
    parts = os.path.abspath(path).replace(os.sep, "/").split("/")
    for anchor in ("deepspeed_tpu_torch", "tests"):
        if anchor in parts:
            return "/".join(parts[parts.index(anchor):])
    return parts[-1]


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    chain: List[str] = []
    while isinstance(node, ast.Attribute):
        chain.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        chain.append(node.id)
        return ".".join(reversed(chain))
    return None


class ModuleContext:
    """Everything a rule needs about one parsed file."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.relpath = canonical_relpath(path)
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        # (node, qualname, enclosing class name or None)
        self.functions: List[Tuple[ast.AST, str, Optional[str]]] = []
        self._collect_functions(self.tree, "", None)
        self.suppressed = self._suppression_map()

    def _collect_functions(self, node, qual, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{qual}.{child.name}" if qual else child.name
                self.functions.append((child, q, cls))
                self._collect_functions(child, q, cls)
            elif isinstance(child, ast.ClassDef):
                cq = f"{qual}.{child.name}" if qual else child.name
                self._collect_functions(child, cq, child.name)
            else:
                self._collect_functions(child, qual, cls)

    def _suppression_map(self) -> Dict[int, Set[str]]:
        out: Dict[int, Set[str]] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            rules = {r.strip().upper() for r in m.group(1).split(",") if r.strip()}
            out.setdefault(i, set()).update(rules)
            if text.lstrip().startswith("#"):
                # Standalone directive comment also covers the next line.
                out.setdefault(i + 1, set()).update(rules)
        return out

    def is_suppressed(self, finding: Finding) -> bool:
        rules = self.suppressed.get(finding.line, ())
        return finding.rule in rules or "ALL" in rules

    # --- shared lookups used by several rules -------------------------

    def enclosing_function(self, node) -> Optional[Tuple[ast.AST, str]]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for fnode, qual, _cls in self.functions:
                    if fnode is cur:
                        return cur, qual
                return cur, cur.name
            cur = self.parents.get(cur)
        return None

    def module_allowlist(self, table: dict) -> frozenset:
        for key, names in table.items():
            if self.relpath == key or self.relpath.endswith("/" + key):
                return names
        return frozenset()

    def hot_functions(self, config: AnalysisConfig) -> List[Tuple[ast.AST, str]]:
        """Top-most hot-path functions (decorated with @hot_path or named
        in the module allowlist). Nested defs are covered by scanning the
        returned subtrees, so a nested hot function inside a hot root is
        not returned twice."""
        allow = self.module_allowlist(config.hot_path_functions)
        hot_nodes = {}
        for fnode, qual, _cls in self.functions:
            name = qual.rsplit(".", 1)[-1]
            decorated = any(
                (dotted(d) or "").rsplit(".", 1)[-1] == "hot_path"
                for d in getattr(fnode, "decorator_list", []))
            if decorated or name in allow:
                hot_nodes[fnode] = qual
        roots = []
        for fnode, qual in hot_nodes.items():
            cur = self.parents.get(fnode)
            nested_in_hot = False
            while cur is not None:
                if cur in hot_nodes:
                    nested_in_hot = True
                    break
                cur = self.parents.get(cur)
            if not nested_in_hot:
                roots.append((fnode, qual))
        return roots


def analyze_source(path: str, source: str,
                   config: Optional[AnalysisConfig] = None) -> List[Finding]:
    from .rules import RULES  # late import: rules import this module
    config = config or AnalysisConfig()
    try:
        ctx = ModuleContext(path, source)
    except SyntaxError as exc:
        return [Finding("SYNTAX", canonical_relpath(path),
                        int(exc.lineno or 0), int(exc.offset or 0), "",
                        f"file does not parse: {exc.msg}")]
    active = config.rules if config.rules is not None else RULES.keys()
    findings: List[Finding] = []
    for name in active:
        for f in RULES[name](ctx, config):
            if not ctx.is_suppressed(f):
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def analyze_file(path: str, config: Optional[AnalysisConfig] = None) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        return analyze_source(path, fh.read(), config)


def iter_python_files(paths: Iterable[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames
                                 if not d.startswith(".") and d != "__pycache__")
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def collect_findings(paths: Iterable[str],
                     config: Optional[AnalysisConfig] = None) -> List[Finding]:
    config = config or AnalysisConfig()
    out: List[Finding] = []
    for path in iter_python_files(paths):
        out.extend(analyze_file(path, config))
    return out


# --- baseline -------------------------------------------------------------

def load_baseline(path: str) -> List[dict]:
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    entries = data.get("findings", data) if isinstance(data, dict) else data
    if not isinstance(entries, list):
        raise ValueError(f"baseline {path}: expected a list of findings")
    return entries


def baseline_key(entry: dict) -> Tuple[str, str, str, str]:
    return (entry.get("rule", ""), entry.get("path", ""),
            entry.get("symbol", ""), entry.get("message", ""))


def apply_baseline(findings: Sequence[Finding],
                   baseline: Sequence[dict]) -> Tuple[List[Finding], List[dict]]:
    """Split findings into (new, stale-baseline-entries). Every baseline
    entry must still match a real finding; unmatched entries are STALE —
    the debt was paid and the entry must be deleted (shrink-only)."""
    keys = {baseline_key(e) for e in baseline}
    new = [f for f in findings if f.key() not in keys]
    found = {f.key() for f in findings}
    stale = [e for e in baseline if baseline_key(e) not in found]
    return new, stale


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    payload = {
        "comment": "graftlint grandfathered findings; shrink-only. "
                   "Each entry needs a justifying comment at the source site.",
        "findings": [f.to_dict() for f in findings],
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")
