"""THREADRACE: shared-state attribute writes must hold the lock.

Counterpart of ``deepspeed_tpu/analysis/rules/threadrace.py``, over the
port's classes. Invariant guarded: the fleet's lock discipline (docs/RESILIENCE.md) -
``ServingFleet`` bookkeeping is mutated from replica pump threads, the
watchdog, AND the caller, so every ``self.<attr> = ...`` outside
``__init__`` must happen inside ``with self._lock`` (any context
manager whose dotted path mentions 'lock' counts), OR the attribute
must be declared in the class's ``_THREAD_OWNED`` manifest - the
explicit, reviewable claim that a single thread owns it (e.g. the
engine's stepper-owned ``_pool``, serialized externally by rep.lock).

A class is checked when it defines ``_THREAD_OWNED`` or its name is in
``annotations.THREAD_CHECKED_CLASSES``; deleting the manifest from a
listed class therefore cannot silently disable the rule. Besides
``__init__``, the port exempts its construction helpers: methods that only
``__init__`` (or another such helper) calls, before any other thread can
see the object (the serving engine builds itself in ``_build`` and
``_build_serving``).
"""

import ast

from ..core import Finding, dotted

_EXEMPT_METHODS = {"__init__", "__new__", "__del__", "__init_subclass__"}


def _manifest(cls: ast.ClassDef):
    """Parse ``_THREAD_OWNED = frozenset({...})`` (or a tuple/list/set
    literal) at class level; returns (names, found)."""
    for stmt in cls.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets = [stmt.target]
        if not any(isinstance(t, ast.Name) and t.id == "_THREAD_OWNED"
                   for t in targets):
            continue
        value = stmt.value
        if isinstance(value, ast.Call) and dotted(value.func) in ("frozenset", "set") \
                and len(value.args) == 1:
            value = value.args[0]
        names = set()
        if isinstance(value, (ast.Tuple, ast.List, ast.Set)):
            for elt in value.elts:
                if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                    names.add(elt.value)
        return names, True
    return set(), False


def _is_lockish(expr: ast.AST) -> bool:
    d = dotted(expr)
    if d is None and isinstance(expr, ast.Call):
        d = dotted(expr.func)
    return d is not None and "lock" in d.lower()


def _self_attr_writes(node, under_lock=False):
    """Yield (Attribute target, under_lock) for every self.<attr> store,
    tracking lexical ``with <lock>`` nesting. Nested defs are traversed -
    a closure run on the same threads is subject to the same discipline."""
    if isinstance(node, ast.With):
        locked = under_lock or any(_is_lockish(item.context_expr)
                                   for item in node.items)
        for child in node.body:
            yield from _self_attr_writes(child, locked)
        return
    if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for t in targets:
            elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
            for e in elts:
                if isinstance(e, ast.Starred):
                    e = e.value
                if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name) \
                        and e.value.id == "self":
                    yield e, under_lock
    for child in ast.iter_child_nodes(node):
        if isinstance(child, ast.ClassDef):
            continue
        yield from _self_attr_writes(child, under_lock)


def _construction_helpers(cls: ast.ClassDef):
    """Methods that run only while the object is built: every reference
    to them in the class is a ``self.<name>(...)`` call from ``__init__``
    (or another such helper). No other thread can see the object yet, so
    they are exempt as ``__init__`` is."""
    methods = {s.name: s for s in cls.body
               if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))}
    callers = {name: set() for name in methods}
    for mname, m in methods.items():
        called = set()
        for node in ast.walk(m):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    dotted(node.func.value) == "self" and \
                    node.func.attr in methods:
                callers[node.func.attr].add(mname)
                called.add(id(node.func))
        for node in ast.walk(m):
            if isinstance(node, ast.Attribute) and \
                    dotted(node.value) == "self" and \
                    node.attr in methods and id(node) not in called:
                callers[node.attr].add(None)  # referenced, not called
    helpers, changed = set(), True
    while changed:
        changed = False
        for name, cs in callers.items():
            if name in helpers or name in _EXEMPT_METHODS or not cs:
                continue
            if all(c in _EXEMPT_METHODS or c in helpers for c in cs):
                helpers.add(name)
                changed = True
    return helpers


def check(ctx, config):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        owned, has_manifest = _manifest(node)
        if not has_manifest and node.name not in config.thread_checked_classes:
            continue
        helpers = _construction_helpers(node)
        for stmt in node.body:
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if stmt.name in _EXEMPT_METHODS or stmt.name in helpers:
                continue
            qual = f"{node.name}.{stmt.name}"
            for target, under_lock in _self_attr_writes(stmt):
                if under_lock or target.attr in owned:
                    continue
                yield Finding(
                    "THREADRACE", ctx.relpath, target.lineno,
                    target.col_offset, qual,
                    f"self.{target.attr} assigned outside 'with self._lock' "
                    f"and not declared in {node.name}._THREAD_OWNED")
