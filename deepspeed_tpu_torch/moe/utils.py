"""MoE utilities: identify expert parameters, for per-group optimizer
settings or checkpoint policies.

Counterpart of ``deepspeed_tpu/moe/utils.py``. A path is a parameter's
dotted name (``"h_0.experts.w1"``, as ``named_parameters`` gives it) or a
sequence of its parts.
"""


def is_moe_param_path(path) -> bool:
    """True when a parameter path belongs to a stacked expert (leading
    expert axis)."""
    names = path.split(".") if isinstance(path, str) else \
        [str(getattr(p, "key", getattr(p, "name", p))) for p in path]
    return "experts" in names


def split_moe_param_groups(params):
    """Partition named parameters into (dense, expert) dicts, so callers
    can give the two groups different optimizer settings (the reference
    splits torch param groups). ``params``: a module (its
    ``named_parameters``) or a {name: tensor} mapping."""
    items = params.named_parameters() if hasattr(params, "named_parameters") \
        else params.items()
    dense, expert = {}, {}
    for name, p in items:
        (expert if is_moe_param_path(name) else dense)[name] = p
    return dense, expert
