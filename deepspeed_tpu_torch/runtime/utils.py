"""Runtime helpers: gradient norms, clipping, the overflow check, the
flax-tree bridge for parameters, and the pipeline's layer partitions.

Counterpart of ``deepspeed_tpu/runtime/utils.py`` for what the training
path uses. The JAX functions take pytrees and return new ones; these take
a list of tensors, and ``clip_grad_norm_`` scales them in place (torch's
convention for a trailing underscore).
"""

import bisect
import os

import numpy as np
import torch


def global_norm(tensors):
    """L2 norm over every element of ``tensors``, an fp32 0-d tensor."""
    if not tensors:
        return torch.zeros((), dtype=torch.float32)
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_grad_norm_(tensors, max_norm):
    """Scale ``tensors`` in place so their global 2-norm is at most
    ``max_norm``: clip_coef = min(max_norm / (norm + 1e-6), 1), as the JAX
    package and the reference's fp16 optimizers compute it. Returns the
    norm before clipping (a 0-d tensor; no host sync)."""
    total = global_norm(tensors)
    if tensors:
        coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
        torch._foreach_mul_(tensors, coef.to(tensors[0].device))
    return total


def has_overflow(tensors):
    """True (a 0-d bool tensor) if any element of ``tensors`` is inf or
    NaN."""
    if not tensors:
        return torch.zeros((), dtype=torch.bool)
    return ~torch.stack([torch.isfinite(t).all() for t in tensors]).all()


def flax_tree(module):
    """The module's parameters as a nested dict of fp32 numpy arrays, keyed
    as flax keys them (``h_0.attn.c_attn.kernel`` -> ``tree["h_0"]["attn"]
    ["c_attn"]["kernel"]``)."""
    tree = {}
    for name, p in module.named_parameters():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p.detach().float().cpu().numpy()
    return tree


def load_flax_tree(module, tree):
    """Copy a nested dict of arrays (a flax parameter tree) into the
    module's parameters, in place. Raises KeyError for a missing or
    unexpected name and ValueError for a shape that disagrees."""
    flat = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, prefix + key + ".")
            else:
                flat[prefix + key] = np.asarray(val)

    walk(tree, "")
    own = dict(module.named_parameters())
    missing, extra = set(own) - set(flat), set(flat) - set(own)
    if missing or extra:
        raise KeyError("flax tree does not match the module: missing {}, "
                       "unexpected {}".format(sorted(missing), sorted(extra)))
    with torch.no_grad():
        for name, p in own.items():
            arr = flat[name]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError("{}: flax shape {} != {}".format(
                    name, arr.shape, tuple(p.shape)))
            p.copy_(torch.from_numpy(arr.astype(np.float32)).to(p.dtype))


def ensure_directory_exists(filename):
    dirname = os.path.dirname(filename)
    if dirname:
        os.makedirs(dirname, exist_ok=True)


# ------------------------------------------------ pipeline partitions
# The pipeline module's stage boundaries (the JAX package's
# ``runtime/utils.py`` partition functions, pure Python).


def prefix_sum_inc(weights):
    """The inclusive prefix sum of ``weights``."""
    out = list(weights)
    for i in range(1, len(out)):
        out[i] += out[i - 1]
    return out


def partition_uniform(num_items, num_parts):
    """``num_parts + 1`` evenly spaced boundaries over ``num_items`` (the
    last part takes the remainder)."""
    parts = [0] * (num_parts + 1)
    chunksize = num_items // num_parts
    for p in range(num_parts):
        parts[p] = min(chunksize * p, num_items)
    parts[num_parts] = num_items
    return parts


def _lprobe(weights, num_parts, bottleneck):
    """Greedy boundaries over the prefix sums ``weights`` with no part
    heavier than ``bottleneck``; (parts, whether they cover every item)."""
    num_items = len(weights)
    total_weight = weights[-1]
    parts = [0] * (num_parts + 1)
    for p in range(1, num_parts + 1):
        parts[p] = num_items
    bsum = bottleneck
    chunksize = num_items // num_parts
    step = chunksize
    for p in range(1, num_parts):
        while step < num_items and weights[step] < bsum:
            step += chunksize
        parts[p] = bisect.bisect_left(weights, bsum, step - chunksize,
                                      min(step, num_items))
        if parts[p] == num_items:
            part_size = weights[-1] - weights[parts[p - 1]]
            return parts, part_size < bottleneck
        bsum = weights[parts[p] - 1] + bottleneck
    return parts, bsum >= total_weight


def _rb_partition_balanced(weights, num_parts, eps):
    """The smallest heaviest-part weight, by binary search."""
    lower = weights[-1] / num_parts
    upper = weights[-1]
    while upper > lower + eps:
        mid = lower + ((upper - lower) / 2)
        _, success = _lprobe(weights, num_parts, mid)
        if success:
            upper = mid
        else:
            lower = mid + eps
    return upper


def partition_balanced(weights, num_parts, eps=1e-3):
    """``num_parts + 1`` boundaries over ``weights`` (one per item) that
    make the heaviest part as light as possible."""
    if len(weights) <= num_parts:
        return partition_uniform(len(weights), num_parts)
    weights_ = prefix_sum_inc(weights)
    bottleneck = _rb_partition_balanced(weights_, num_parts, eps=eps)
    parts, success = _lprobe(weights_, num_parts, bottleneck)
    assert success
    return parts
