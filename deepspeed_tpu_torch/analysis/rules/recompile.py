"""RECOMPILE: no CUDA-graph capture after warm-up, outside its sites.

Counterpart of ``deepspeed_tpu/analysis/rules/recompile.py``, whose
invariant (``compile_count`` stays at the keys met: no retrace after
warm-up) becomes, for the port's captured programs:

A. A CUDA-graph capture (``torch.cuda.CUDAGraph()``, ``torch.cuda.graph``,
   ``torch.cuda.make_graphed_callables``, ``.capture_begin()``) outside the
   sanctioned sites (``annotations.SANCTIONED_CAPTURE_SITES``: the serving
   engine's ``_run_program`` / ``_StepGraph``, each key captured once after
   its eager first run, and the compiled pipeline's tick programs). A
   capture anywhere else is a program nothing counts and nothing replays.
B. A program key built from anything but the key's host facts: an element
   of the key passed to ``_run_program`` (a tuple literal, or a name bound
   to one in the same function) that reads a tensor (``.shape``,
   ``.dtype``, ``.device``, ``.data_ptr()``, ``.item()``, ``.tolist()``,
   ``.numel()``), takes an ``id()`` or ``hash()``, or is a container
   literal. Each distinct value is a new key and a new capture.
"""

import ast

from ..core import Finding, dotted
from ._jit import enclosing_names, is_capture

_TENSOR_ATTRS = {"shape", "dtype", "device", "data_ptr", "item", "tolist",
                 "numel"}
_CONTAINERS = (ast.List, ast.Dict, ast.Set,
               ast.ListComp, ast.DictComp, ast.SetComp)


def _not_host_fact(elt):
    """Why a key element is not a host fact, or None."""
    if isinstance(elt, _CONTAINERS):
        return "a container literal"
    for sub in ast.walk(elt):
        if isinstance(sub, ast.Attribute) and sub.attr in _TENSOR_ATTRS:
            return "a tensor's .{}".format(sub.attr)
        if isinstance(sub, ast.Call) and dotted(sub.func) in ("id", "hash"):
            return "{}()".format(dotted(sub.func))
    return None


def _key_elements(ctx, call, fnode):
    """The elements of the key a ``_run_program`` call passes: a tuple
    literal, or a name bound to one in ``fnode``."""
    if not call.args:
        return []
    arg = call.args[0]
    if isinstance(arg, ast.Tuple):
        return list(arg.elts)
    if isinstance(arg, ast.Name) and fnode is not None:
        for node in ast.walk(fnode):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Tuple) and \
                    any(isinstance(t, ast.Name) and t.id == arg.id
                        for t in node.targets):
                return list(node.value.elts)
    if isinstance(arg, _CONTAINERS):
        return [arg]
    return []


def check(ctx, config):
    allow = ctx.module_allowlist(config.sanctioned_capture_sites)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        enc = ctx.enclosing_function(node)
        qual = enc[1] if enc else ""
        if is_capture(node):
            if "*" in allow or set(enclosing_names(ctx, node)) & allow:
                continue
            yield Finding(
                "RECOMPILE", ctx.relpath, node.lineno, node.col_offset, qual,
                f"CUDA-graph capture ({dotted(node.func) or 'capture'}) "
                f"outside the sanctioned capture sites - a program nothing "
                f"counts as a key and nothing replays")
            continue
        d = dotted(node.func)
        if d is None or d.rsplit(".", 1)[-1] != "_run_program":
            continue
        for elt in _key_elements(ctx, node, enc[0] if enc else None):
            why = _not_host_fact(elt)
            if why:
                yield Finding(
                    "RECOMPILE", ctx.relpath, elt.lineno, elt.col_offset,
                    qual,
                    f"program key element built from {why} - a key holds "
                    f"host facts only; each distinct value captures anew")
