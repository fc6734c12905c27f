"""Shared helper: recognise the calls that make a captured program.

Counterpart of ``deepspeed_tpu/analysis/rules/_jit.py``, which collects
``x = jax.jit(...)`` bindings. The port's compiled programs are CUDA
graphs: a program is made by ``torch.cuda.CUDAGraph()``,
``torch.cuda.graph(...)``, ``torch.cuda.make_graphed_callables(...)`` or a
``.capture_begin()``. Name-based and conservative, as the JAX helper: an
alias the table cannot see is out of scope.
"""

import ast

from ..core import dotted

CAPTURE_CALLS = ("torch.cuda.CUDAGraph", "torch.cuda.graph",
                 "torch.cuda.make_graphed_callables", "cuda.CUDAGraph",
                 "cuda.graph", "CUDAGraph")


def is_capture(call: ast.Call) -> bool:
    """True for a call that begins or makes a CUDA-graph capture."""
    d = dotted(call.func)
    if d is not None and d in CAPTURE_CALLS:
        return True
    return isinstance(call.func, ast.Attribute) and \
        call.func.attr == "capture_begin"


def enclosing_names(ctx, node):
    """The names of the functions and classes around ``node``, innermost
    first."""
    names = []
    cur = ctx.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            names.append(cur.name)
        cur = ctx.parents.get(cur)
    return names
