"""Runtime helpers: gradient norms, clipping, the overflow check, and the
flax-tree bridge for parameters.

Counterpart of ``deepspeed_tpu/runtime/utils.py`` for what the training
path uses. The JAX functions take pytrees and return new ones; these take
a list of tensors, and ``clip_grad_norm_`` scales them in place (torch's
convention for a trailing underscore).
"""

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
