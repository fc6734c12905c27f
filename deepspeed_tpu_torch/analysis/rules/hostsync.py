"""HOSTSYNC: no device-to-host read in hot-path code.

Counterpart of ``deepspeed_tpu/analysis/rules/hostsync.py``. Invariant: the
serving step and the decode kernels never wait on the device mid-step. In
a ``@hot_path`` function (or one named in ``annotations.HOT_PATH_FUNCTIONS``)
each of these is a finding: ``.item()``, ``.tolist()``, ``.cpu()``,
``.numpy()``, ``int()`` / ``float()`` / ``bool()`` of a tensor-valued
expression, ``np.asarray`` / ``np.array``, ``torch.cuda.synchronize()`` and
``<event or stream>.synchronize()``.

Second half, anywhere in the tree: the step's harvest is read back once a
step, at the sanctioned points (``annotations.SANCTIONED_SYNC_SITES``: the
engine's step, kv_pool itself). A ``<...harvest>.read()`` elsewhere pays a
second transfer, and so does a kv_pool snapshot helper
(``max_active_frontier``, ``free_slots``) called without the snapshot it
reads: pass the step's snapshot instead.
"""

import ast

from ..core import Finding, dotted

_SYNC_ATTR_CALLS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_SYNC_DOTTED = {
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
    "torch.cuda.synchronize",
}
_CAST_NAMES = {"int", "float", "bool"}
# kv_pool helpers that read a harvest snapshot: without one they have
# nothing to read but the device.
_SNAP_HELPERS = {"max_active_frontier", "free_slots"}


def _looks_tensorlike(node: ast.AST) -> bool:
    """Heuristic: a cast's argument is tensor-valued if it indexes anything
    other than ``.shape`` or calls anything other than ``len`` / ``.size()``
    / ``.dim()`` / ``.numel()``. Bare names, constants and shape arithmetic
    (``x.shape[0]``, ``hd ** 0.5``) are host scalars."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Subscript):
            base = sub.value
            if isinstance(base, ast.Attribute) and base.attr == "shape":
                continue
            return True
        if isinstance(sub, ast.Call):
            d = dotted(sub.func)
            if d == "len" or (isinstance(sub.func, ast.Attribute) and
                              sub.func.attr in ("size", "dim", "numel",
                                                "element_size")):
                continue
            return True
    return False


def _scan_hot_subtree(ctx, root, qual):
    for node in ast.walk(root):
        if not isinstance(node, ast.Call):
            continue
        d = dotted(node.func)
        if d in _SYNC_DOTTED:
            yield Finding(
                "HOSTSYNC", ctx.relpath, node.lineno, node.col_offset, qual,
                f"{d}() forces a device->host sync in hot-path code")
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in _SYNC_ATTR_CALLS:
            yield Finding(
                "HOSTSYNC", ctx.relpath, node.lineno, node.col_offset, qual,
                f".{node.func.attr}() forces a device->host sync in "
                f"hot-path code")
        elif d in _CAST_NAMES and node.args and \
                _looks_tensorlike(node.args[0]):
            yield Finding(
                "HOSTSYNC", ctx.relpath, node.lineno, node.col_offset, qual,
                f"{d}() on a tensor-valued expression blocks on a device "
                f"readback in hot-path code")


def _sanctioned(ctx, node, config) -> bool:
    allow = ctx.module_allowlist(config.sanctioned_sync_sites)
    enc = ctx.enclosing_function(node)
    if enc is None:
        return False
    _fnode, qual = enc
    return qual in allow or qual.rsplit(".", 1)[-1] in allow


def _is_harvest_read(node) -> bool:
    func = node.func
    if not isinstance(func, ast.Attribute) or func.attr != "read":
        return False
    base = dotted(func.value)
    return base is not None and "harvest" in base.rsplit(".", 1)[-1].lower()


def check(ctx, config):
    for fnode, qual in ctx.hot_functions(config):
        yield from _scan_hot_subtree(ctx, fnode, qual)

    # The harvest discipline applies to the whole module, hot or not.
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if _sanctioned(ctx, node, config):
            continue
        enc = ctx.enclosing_function(node)
        qual = enc[1] if enc else ""
        if _is_harvest_read(node):
            yield Finding(
                "HOSTSYNC", ctx.relpath, node.lineno, node.col_offset, qual,
                f"{dotted(node.func)}() outside a sanctioned snapshot point "
                f"- reuse the step's snapshot instead of paying a fresh "
                f"transfer")
            continue
        d = dotted(node.func)
        name = d.rsplit(".", 1)[-1] if d else None
        if name in _SNAP_HELPERS and not node.args and \
                not any(kw.arg == "snap" for kw in node.keywords):
            yield Finding(
                "HOSTSYNC", ctx.relpath, node.lineno, node.col_offset, qual,
                f"{name}() without a snapshot pays its own device->host "
                f"transfer - pass the step's harvest snapshot")
