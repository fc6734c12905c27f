"""Top-k gating and capacity-based dispatch for mixture-of-experts.

Counterpart of ``deepspeed_tpu/moe/sharded_moe.py``. The GShard recipe:
a per-token softmax gate, capacity ``ceil(k * S / E * factor)``, dispatch
and combine as dense ``[tokens, experts, capacity]`` tensors, so expert
routing is fixed-shape arithmetic: no host sync and no data-dependent
shape, and a CUDA graph captures it. Capacity is a host int from shapes.

The JAX ``noise_rng`` (a PRNG key) is a ``torch.Generator`` here: the
jitter and the Gumbel draws come from it, on the logits' device. Ties in
the argmax go to the lowest expert index, as in JAX.

Gating is over the GLOBAL batch, as in the JAX program over its 'data'
axis: the capacity counts every data rank's tokens, the cumsum position
race runs over them in rank order and ``l_aux`` takes the global means.
A data rank gathers the router logits of its data line
(``gather_rows``, in rank order), gates them whole and keeps its own
rows. The gather's backward sums the ranks' gradients before it keeps the
rank's rows (a reduce-scatter), so each rank's ``l_aux`` is the global one
and the engine's mean over 'data' gives its gradient once.
"""

import torch

from deepspeed_tpu_torch.parallel import comm


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank = torch.distributed.get_rank(group)
        ctx.rows = x.shape[0]
        flat = comm.all_gather(x.contiguous().reshape(-1), group)
        return flat.view(-1, *x.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        total = comm.all_reduce(grad.contiguous().clone(), ctx.group)
        return total[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def gather_rows(x, group):
    """Every rank's ``x`` (equal rows) of ``group`` concatenated along dim
    0 in rank order; the backward sums the ranks' gradients and keeps this
    rank's rows (module docstring)."""
    return _GatherRows.apply(x, group)


def _one_hot(x, n):
    """fp32 one-hot of integer-valued ``x`` over ``n`` classes; an index
    outside ``[0, n)`` gives a zero row, as ``jax.nn.one_hot`` does (and
    nothing is checked on the device)."""
    idx = x.to(torch.int64)
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _capacity(tokens, num_experts, k, factor, min_capacity):
    cap = int(max(min_capacity, -(-(k * tokens * factor) // num_experts)))
    return min(cap, tokens)


def _load_balance_loss(gates, mask1):
    """GShard aux loss: E * <fraction of tokens per expert> . <mean gate
    per expert>; minimized when routing is uniform."""
    e = gates.shape[-1]
    me = gates.mean(dim=0)
    ce = mask1.mean(dim=0)
    return e * torch.sum(me * ce)


def _uniform(shape, low, high, generator, device):
    u = torch.rand(shape, generator=generator, device=device)
    return low + (high - low) * u


def top1gating(logits, capacity_factor=1.0, min_capacity=4,
               noise_rng=None, noise_eps=1e-2, used_token_mask=None):
    """Switch-style top-1 gating.

    Args:
      logits: [S, E] fp32 router outputs.
      noise_rng: optional ``torch.Generator`` on the logits' device:
        multiplicative jitter on the routing logits (the 'Jitter' policy).
      used_token_mask: optional [S] 0/1; padding tokens get no slot.
    Returns: (l_aux, combine [S, E, C] fp32, dispatch [S, E, C] bool,
      exp_counts [E] int32).
    """
    s, e = logits.shape
    cap = _capacity(s, e, 1, capacity_factor, min_capacity)
    route_logits = logits
    if noise_rng is not None:
        route_logits = logits * _uniform(logits.shape, 1.0 - noise_eps,
                                         1.0 + noise_eps, noise_rng,
                                         logits.device)
    gates = torch.softmax(logits, dim=-1)                 # [S, E]
    expert1 = torch.argmax(route_logits, dim=-1)          # [S]
    mask1 = _one_hot(expert1, e)                          # [S, E]
    if used_token_mask is not None:
        mask1 = mask1 * used_token_mask[:, None]
    l_aux = _load_balance_loss(gates, mask1)
    # Position of each token in its expert's buffer; capacity overflow
    # drops the token (its combine weights become 0).
    pos1 = torch.cumsum(mask1, dim=0) - mask1             # [S, E]
    mask1 = mask1 * (pos1 < cap)
    exp_counts = mask1.sum(dim=0).to(torch.int32)
    gate1 = torch.sum(gates * mask1, dim=-1)              # [S]
    pos_in_exp = torch.sum(pos1 * mask1, dim=-1)          # [S]
    dispatch = mask1[:, :, None] * _one_hot(pos_in_exp, cap)[:, None, :]
    combine = gate1[:, None, None] * dispatch
    return l_aux, combine, dispatch.bool(), exp_counts


def top2gating(logits, capacity_factor=1.0, min_capacity=4,
               noise_rng=None, used_token_mask=None):
    """GShard top-2 gating: the second expert from the residual
    distribution (sampled by Gumbel noise from ``noise_rng`` when given),
    the two winners' weights renormalized."""
    s, e = logits.shape
    cap = _capacity(s, e, 2, capacity_factor, min_capacity)
    gates = torch.softmax(logits, dim=-1)
    expert1 = torch.argmax(gates, dim=-1)
    mask1 = _one_hot(expert1, e)
    logits2 = torch.where(mask1 > 0, float("-inf"), logits)
    if noise_rng is not None:
        u = torch.rand(logits2.shape, generator=noise_rng,
                       device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype)
                                               .tiny)))
        logits2 = logits2 + gumbel
    expert2 = torch.argmax(logits2, dim=-1)
    mask2 = _one_hot(expert2, e)
    if used_token_mask is not None:
        mask1 = mask1 * used_token_mask[:, None]
        mask2 = mask2 * used_token_mask[:, None]
    l_aux = _load_balance_loss(gates, mask1)

    pos1 = torch.cumsum(mask1, dim=0) - mask1
    # Expert-2 slots start after all expert-1 claims on the same expert.
    pos2 = torch.cumsum(mask2, dim=0) - mask2 + mask1.sum(dim=0)
    mask1 = mask1 * (pos1 < cap)
    mask2 = mask2 * (pos2 < cap)
    exp_counts = (mask1 + mask2).sum(dim=0).to(torch.int32)

    gate1 = torch.sum(gates * mask1, dim=-1)
    gate2 = torch.sum(gates * mask2, dim=-1)
    denom = torch.clamp(gate1 + gate2, min=1e-9)
    gate1, gate2 = gate1 / denom, gate2 / denom

    p1 = torch.sum(pos1 * mask1, dim=-1)
    p2 = torch.sum(pos2 * mask2, dim=-1)
    disp1 = mask1[:, :, None] * _one_hot(p1, cap)[:, None, :]
    disp2 = mask2[:, :, None] * _one_hot(p2, cap)[:, None, :]
    combine = gate1[:, None, None] * disp1 + gate2[:, None, None] * disp2
    dispatch = (disp1 + disp2) > 0
    return l_aux, combine, dispatch, exp_counts
