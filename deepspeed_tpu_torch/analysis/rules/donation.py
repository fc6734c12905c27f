"""DONATION: a host buffer handed to an asynchronous copy is not written
again before the copy is waited on.

Counterpart of ``deepspeed_tpu/analysis/rules/donation.py``. JAX's hazard
is a buffer read after ``donate_argnums`` handed it to XLA. The torch
hazard nearest to it: ``dst.copy_(host, non_blocking=True)`` (or
``host.to(device, non_blocking=True)``, ``host.cuda(non_blocking=True)``)
only enqueues the copy; until the stream (or an event after it) is waited
on, the copy may still be reading ``host``, so writing ``host`` again
changes what arrives on the device, silently (the step inputs'
``PackedBuffer.upload`` is written again only after the step's blocking
harvest read).

Scope, as the JAX rule's: intraprocedural and name-based. For each such
copy whose source is a plain name or dotted ``self.attr`` path, a later
write to it in the same function (``host[...] = ...``, an in-place method
``host.<op>_(...)``, ``np.copyto(host, ...)``) with no wait between them
in textual order (``.synchronize()``, ``.wait_stream()``,
``.wait_event()``, ``.wait()``, or a blocking ``.read()``) is a finding.
Rebinding the name is not a write. Loops that wrap around and aliases are
out of scope.
"""

import ast

from ..core import Finding, dotted

_WAITS = {"synchronize", "wait_stream", "wait_event", "wait", "read"}


def _non_blocking(call):
    return any(kw.arg == "non_blocking" and
               isinstance(kw.value, ast.Constant) and kw.value.value is True
               for kw in call.keywords)


def _async_sources(fnode):
    """(source path, call) for each asynchronous copy in ``fnode``."""
    for node in ast.walk(fnode):
        if not isinstance(node, ast.Call) or \
                not isinstance(node.func, ast.Attribute) or \
                not _non_blocking(node):
            continue
        attr = node.func.attr
        if attr == "copy_" and node.args:
            src = node.args[0]
        elif attr in ("to", "cuda"):
            src = node.func.value
        else:
            continue
        path = dotted(src)
        if path and (path.count(".") == 0 or path.startswith("self.")):
            yield path, node


def _writes(fnode, path):
    """Nodes that write into the buffer at ``path``."""
    for node in ast.walk(fnode):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
                for e in elts:
                    if isinstance(e, ast.Subscript) and \
                            dotted(e.value) == path:
                        yield e
        elif isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) and \
                    func.attr.endswith("_") and \
                    not func.attr.startswith("_") and \
                    dotted(func.value) == path:
                yield node
            elif dotted(func) in ("np.copyto", "numpy.copyto") and \
                    node.args and dotted(node.args[0]) == path:
                yield node


def _rebinds(fnode, path):
    """Lines that bind ``path`` to a new object (no longer the buffer)."""
    lines = []
    for node in ast.walk(fnode):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
                if any(dotted(e) == path for e in elts):
                    lines.append(node.lineno)
    return lines


def _waits(fnode):
    return [node.lineno for node in ast.walk(fnode)
            if isinstance(node, ast.Call) and
            isinstance(node.func, ast.Attribute) and
            node.func.attr in _WAITS]


def check(ctx, config):
    for fnode, qual, _cls in ctx.functions:
        copies = list(_async_sources(fnode))
        if not copies:
            continue
        waits = _waits(fnode)
        for path, call in copies:
            clear = waits + _rebinds(fnode, path)
            bad = [w for w in _writes(fnode, path)
                   if w.lineno > call.lineno and
                   not any(call.lineno <= line < w.lineno for line in clear)]
            if bad:
                first = min(bad, key=lambda n: (n.lineno, n.col_offset))
                yield Finding(
                    "DONATION", ctx.relpath, first.lineno, first.col_offset,
                    qual,
                    f"'{path}' written after an asynchronous copy read it at "
                    f"line {call.lineno} and before any wait - the copy may "
                    f"still be reading it; wait on its stream or event first")
