"""Sequence-parallel attention over the 'seq' line: the ring and Ulysses.

Counterpart of ``deepspeed_tpu/ops/transformer/ring_attention.py``. Each
rank of a seq line holds a ``[B, H, T/N, D]`` shard of q, k and v (shards
in rank order along the sequence); the line is a ``SeqContext``
(``parallel/sequence_parallel.py``), the JAX package's bound axis name.

- ``ring_flash_attention``: the k/v blocks travel the ring
  (``comm.ring_shift``, N - 1 shifts). On each step the rank runs K1
  (``flash_fwd``) for its queries against the block it holds, and merges
  the partial (o, lse) by logsumexp algebra (``_merge``). Causality is
  decided per block from the step's source rank: an earlier shard is
  attended in full, the rank's own shard causally, a later one not at all
  (no kernel runs). The backward (a ``torch.autograd.Function``) recomputes
  nothing of the forward's results: it rotates k/v again and runs K2
  (``flash_bwd``) on each block with the GLOBAL lse of the merged output
  and delta = rowsum(dO * O) (the flash identity ds = p (dp - delta) holds
  per block with global statistics); dk and dv accumulate in fp32 buffers
  that travel with their block and arrive home after the N-th shift. K/v
  travel as one stacked message, dk/dv as another, an additive key mask
  ``[B, T/N]`` beside its block. Activation memory is O(T/N) a rank.
- ``ulysses_attention``: two all-to-alls swap the token shards for head
  shards (q, k, v stacked into one exchange), ``flash_attention`` runs the
  full sequence on H/N heads, and the reverse exchange restores the token
  shards. The heads must divide by N, as in JAX.
- ``get_sp_attention(mode)``: "ring" or "ulysses".
- ``sequence_parallel_attention``: for a caller holding GLOBAL tensors:
  this rank's shard in, the gathered global output out.

The JAX ring sends shard lengths its tiled kernels cannot take to a dense
per-block computation. The port's K1/K2 take any length (they guard the
ragged tile), so every block on the card launches a kernel; on CPU
tensors the wrappers compute their plain versions (``mha_reference`` with
the lse, ``flash_bwd_reference`` with the global lse and delta), the
function of the JAX dense per-block path.
"""

import torch

from deepspeed_tpu_torch.ops.transformer.kernels.attention import (
    NEG_INF, flash_attention, flash_bwd, flash_fwd)
from deepspeed_tpu_torch.parallel import comm


def _merge(o_a, lse_a, o_b, lse_b):
    """Two partial results over the same queries (o fp32 ``[B, H, T, D]``,
    lse fp32 ``[B, H, T, 1]``): the flash online-softmax update at block
    granularity. A block that was skipped carries lse = NEG_INF (finite), so
    its weight underflows to 0 after the max is subtracted."""
    m = torch.maximum(lse_a, lse_b)
    w_a = torch.exp(lse_a - m)
    w_b = torch.exp(lse_b - m)
    denom = w_a + w_b
    return (o_a * w_a + o_b * w_b) / denom, m + torch.log(denom)


def _block_mode(causal, src, rank):
    """The block of source shard ``src`` seen by ``rank``: None (skipped),
    True (the diagonal, causal) or False (full)."""
    if not causal:
        return False
    if src > rank:
        return None
    return src == rank


def _rotate(kv, mask, group, last):
    """The next ring step's k/v (stacked) and mask, unless this was the
    last step (whose shift would be discarded)."""
    if last:
        return kv, mask
    kv = comm.ring_shift(kv, group)
    if mask is not None:
        mask = comm.ring_shift(mask, group)
    return kv, mask


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, mask, sp, causal, scale):
        n, rank = sp.size, sp.rank
        B, H, T, D = q.shape
        o = torch.zeros(B, H, T, D, dtype=torch.float32, device=q.device)
        lse = torch.full((B, H, T, 1), NEG_INF, dtype=torch.float32,
                         device=q.device)
        kv, m = torch.stack([k, v]), mask
        for s in range(n):
            mode = _block_mode(causal, (rank - s) % n, rank)
            if mode is not None:
                o_b, lse_b = flash_fwd(q, kv[0], kv[1], m, mode, scale)
                o, lse = _merge(o, lse, o_b.float(), lse_b)
            kv, m = _rotate(kv, m, sp.group, s == n - 1)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.sp, ctx.causal, ctx.scale = sp, causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, o, lse = ctx.saved_tensors
        sp, causal, scale = ctx.sp, ctx.causal, ctx.scale
        n, rank = sp.size, sp.rank
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkv = torch.zeros((2,) + tuple(k.shape), dtype=torch.float32,
                          device=k.device)
        kv, m = torch.stack([k, v]), mask
        for s in range(n):
            mode = _block_mode(causal, (rank - s) % n, rank)
            if mode is not None:
                dq_b, dk_b, dv_b = flash_bwd(q, kv[0], kv[1], m, lse, delta,
                                             do, mode, scale)
                dq += dq_b.float()
                dkv[0] += dk_b.float()
                dkv[1] += dv_b.float()
            # The gradient buffers shift on every step: the N-th shift
            # brings each block's dk/dv home.
            dkv = comm.ring_shift(dkv, sp.group)
            kv, m = _rotate(kv, m, sp.group, s == n - 1)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype), None,
                None, None, None)


def ring_flash_attention(q, k, v, sp, causal=False, mask=None, scale=None):
    """Flash attention over the seq line's shards on a ring (module
    docstring). q, k, v: ``[B, H, T/N, D]``, this rank's shard; ``sp``: the
    ``SeqContext`` (None or a line of 1: ``flash_attention``); causal: in
    GLOBAL positions; mask: optional additive key mask ``[B, T/N]`` of this
    shard's keys (0 keep, -1e9 drop), no gradient; scale: default
    1/sqrt(D). Returns ``[B, H, T/N, D]`` in q's dtype."""
    d = q.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / d ** 0.5
    if sp is None or sp.size == 1:
        return flash_attention(q, k, v, mask=mask, causal=causal,
                               scale=scale)
    mask_f = None if mask is None else mask.float().contiguous()
    return _Ring.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                       mask_f, sp, bool(causal), scale)


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all; its backward is the reverse exchange."""

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, concat_dim, split_dim)
        return comm.all_to_all(x.contiguous(), group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        return (comm.all_to_all(grad.contiguous(), *ctx.args), None, None,
                None)


def _gather_tokens(mask, sp):
    """The full ``[B, T]`` key mask from every rank's ``[B, T/N]`` shard."""
    flat = comm.all_gather(mask.float().contiguous().reshape(-1), sp.group)
    B, t = mask.shape
    return flat.view(sp.size, B, t).permute(1, 0, 2).reshape(B, sp.size * t)


def ulysses_attention(q, k, v, sp, causal=False, mask=None, scale=None):
    """All-to-all sequence-parallel attention (module docstring): same
    arguments and result as ``ring_flash_attention``. Raises ValueError
    when the heads do not divide by the line's size."""
    if sp is None or sp.size == 1:
        return flash_attention(q, k, v, mask=mask, causal=causal,
                               scale=scale)
    h = q.shape[1]
    if h % sp.size:
        raise ValueError(
            "ulysses_attention requires num_heads ({}) divisible by the "
            "'seq' axis size ({}); use ring attention for more shards than "
            "heads".format(h, sp.size))
    full_mask = None if mask is None else _gather_tokens(mask, sp)
    # One exchange for q, k and v: [3, B, H, T/N, D] -> [3, B, H/N, T, D].
    qkv = _AllToAll.apply(torch.stack([q, k, v]), sp.group, 2, 3)
    o = flash_attention(qkv[0].contiguous(), qkv[1].contiguous(),
                        qkv[2].contiguous(), mask=full_mask, causal=causal,
                        scale=scale)
    # [B, H/N, T, D] -> [B, H, T/N, D].
    return _AllToAll.apply(o, sp.group, 2, 1)


def get_sp_attention(mode):
    """The attention of a ``sequence_parallel_mode``: "ring" or "ulysses";
    another mode raises ValueError."""
    impls = {"ring": ring_flash_attention, "ulysses": ulysses_attention}
    try:
        return impls[mode]
    except KeyError:
        raise ValueError(
            "unknown sequence_parallel_mode {!r}; expected one of {}"
            .format(mode, sorted(impls))) from None


def sequence_parallel_attention(sp, q, k, v, causal=False, mask=None,
                                scale=None, mode="ring"):
    """For a caller holding GLOBAL ``[B, H, T, D]`` q, k, v (and a global
    ``[B, T]`` mask): this rank's token shard through ``mode``'s attention,
    the output gathered back to ``[B, H, T, D]`` on every rank (forward
    only: the gather carries no gradient)."""
    n, r = sp.size, sp.rank
    T = q.shape[2]
    if T % n:
        raise ValueError("sequence_parallel_attention: T={} is not "
                         "divisible by {} shards".format(T, n))
    t = T // n

    def mine(x, dim):
        return x.narrow(dim, r * t, t).contiguous()

    out = get_sp_attention(mode)(
        mine(q, 2), mine(k, 2), mine(v, 2), sp, causal=causal,
        mask=None if mask is None else mine(mask, 1), scale=scale)
    flat = comm.all_gather(out.detach().contiguous().reshape(-1), sp.group)
    B, H, _, D = q.shape
    return flat.view(n, B, H, t, D).permute(1, 2, 0, 3, 4).reshape(
        B, H, T, D)
