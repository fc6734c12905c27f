"""DETERMINISM: no wall clock and no unseeded RNG in replayable code.

Counterpart of ``deepspeed_tpu/analysis/rules/determinism.py``. Invariant:
a ``WorkloadSpec`` replays bit for bit from its seed, and the decode
program derives every random draw from (seed, position). Inside hot-path
functions and the modules of ``annotations.DETERMINISM_MODULES`` these are
findings: the wall clock (``time.time()`` and kin, ``datetime.now()``),
the process-global ``random`` module, numpy's global RNG and its
generators built without a seed, and torch's draws without an explicit
``generator=`` (``torch.rand``, ``randn``, ``randint``, ``randperm``,
``bernoulli``, ``multinomial``, ``normal``, and the in-place
``.bernoulli_()``, ``.normal_()``, ``.uniform_()``, ``.random_()``,
``.exponential_()``, ``.multinomial()``). ``np.random.default_rng(seed)``,
``RandomState(seed)`` and ``torch.Generator().manual_seed(seed)`` are the
sanctioned forms.
"""

import ast

from ..core import Finding, dotted

_CLOCK_CALLS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "datetime.now", "datetime.datetime.now", "datetime.utcnow",
    "datetime.datetime.utcnow",
}
# numpy constructors that are fine given an explicit seed argument.
_SEEDABLE = {"default_rng", "RandomState", "Generator", "SeedSequence",
             "PCG64", "Philox", "MT19937", "Random"}
_TORCH_DRAWS = {"rand", "rand_like", "randn", "randn_like", "randint",
                "randint_like", "randperm", "bernoulli", "multinomial",
                "normal", "poisson"}
_TORCH_INPLACE_DRAWS = {"bernoulli_", "normal_", "uniform_", "random_",
                        "exponential_", "geometric_", "log_normal_",
                        "cauchy_", "multinomial"}


def _has_generator(node):
    return any(kw.arg == "generator" for kw in node.keywords)


def _scan(ctx, root, fixed_qual=None):
    for node in ast.walk(root):
        if not isinstance(node, ast.Call):
            continue
        d = dotted(node.func)
        if fixed_qual is None:
            enc = ctx.enclosing_function(node)
            qual = enc[1] if enc else ""
        else:
            qual = fixed_qual
        if d is None:
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _TORCH_INPLACE_DRAWS and \
                    not _has_generator(node):
                yield Finding(
                    "DETERMINISM", ctx.relpath, node.lineno, node.col_offset,
                    qual,
                    f".{node.func.attr}() draws from torch's global RNG - "
                    f"pass generator= (a seeded torch.Generator)")
            continue
        if d in _CLOCK_CALLS:
            yield Finding(
                "DETERMINISM", ctx.relpath, node.lineno, node.col_offset, qual,
                f"{d}() reads the wall clock in deterministic/replay code - "
                f"inject a clock or derive from the request trace")
            continue
        parts = d.split(".")
        if parts[0] == "random" and len(parts) == 2:
            if parts[1] in _SEEDABLE and (node.args or node.keywords):
                continue
            yield Finding(
                "DETERMINISM", ctx.relpath, node.lineno, node.col_offset, qual,
                f"{d}() uses the process-global RNG - seed a dedicated "
                f"generator")
        elif len(parts) >= 3 and parts[0] in ("np", "numpy") and \
                parts[1] == "random":
            leaf = parts[-1]
            if leaf in _SEEDABLE:
                if node.args or node.keywords:
                    continue
                yield Finding(
                    "DETERMINISM", ctx.relpath, node.lineno, node.col_offset,
                    qual,
                    f"{d}() constructed without an explicit seed - replay "
                    f"paths must be reproducible from the workload seed")
            else:
                yield Finding(
                    "DETERMINISM", ctx.relpath, node.lineno, node.col_offset,
                    qual,
                    f"{d}() draws from numpy's global RNG - use a seeded "
                    f"Generator (np.random.default_rng(seed))")
        elif parts[0] == "torch" and len(parts) == 2 and \
                parts[1] in _TORCH_DRAWS and not _has_generator(node):
            yield Finding(
                "DETERMINISM", ctx.relpath, node.lineno, node.col_offset,
                qual,
                f"{d}() draws from torch's global RNG - pass generator= "
                f"(a seeded torch.Generator)")
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in _TORCH_INPLACE_DRAWS and \
                parts[0] != "torch" and not _has_generator(node):
            yield Finding(
                "DETERMINISM", ctx.relpath, node.lineno, node.col_offset,
                qual,
                f".{node.func.attr}() draws from torch's global RNG - pass "
                f"generator= (a seeded torch.Generator)")


def check(ctx, config):
    whole_module = any(
        ctx.relpath == m or ctx.relpath.endswith("/" + m)
        for m in config.determinism_modules)
    if whole_module:
        yield from _scan(ctx, ctx.tree)
        return
    for fnode, qual in ctx.hot_functions(config):
        yield from _scan(ctx, fnode, qual)
