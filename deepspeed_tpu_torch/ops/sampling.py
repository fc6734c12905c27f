"""Per-row token sampling with a counter-based generator.

Every draw is named by (request seed, absolute token position): the same
pair gives the same token whichever slot the request sits in, whoever its
neighbours are, and however the steps were cut. This is what
``jax.random.fold_in(PRNGKey(seed), pos)`` gives the JAX package; the bits
differ (threefry is not reproduced), the property is the same.

The generator is an integer hash on the device (no ``torch.Generator``
state to thread through the steps), computed in int64 arithmetic that never
overflows, so CPU and GPU draw identical numbers.
"""

import torch

from deepspeed_tpu_torch.analysis.annotations import hot_path

_M32 = 0xFFFFFFFF


def _mix32(x):
    """32-bit avalanche hash of int64 values in [0, 2**32). Both multipliers
    are below 2**31, so no product leaves the int64 range."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x1B873593) & _M32
    return x ^ (x >> 16)


def positional_uniform(seed, position, n):
    """[R, n] float32 uniforms in (0, 1) for rows named by int ``seed`` [R]
    and ``position`` [R]: column j is a pure function of (seed, position,
    j)."""
    dev = seed.device
    key = _mix32((_mix32(seed.to(torch.int64) & _M32)
                  + position.to(torch.int64)) & _M32)
    col = _mix32(torch.arange(n, device=dev, dtype=torch.int64))
    bits = _mix32((key[:, None] + col[None]) & _M32)
    return ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


@hot_path
def sample_rows(logits, temp, top_k, seed, position, any_sample=True,
                any_top_k=True):
    """Per-row sampling over [R, V] fp32 logits with per-row parameters.

    ``temp`` [R] <= 0 is greedy (argmax); ``top_k`` [R] <= 0 disables the
    top-k filter. ``any_sample`` / ``any_top_k`` are HOST facts (from the
    request records) saying whether any row samples / filters: when no row
    samples, the result is the argmax and the [R, V] sort and draw are
    skipped. Sampling is Gumbel-max over ``positional_uniform(seed,
    position)``. Returns [R] int64 token ids."""
    greedy = torch.argmax(logits, dim=-1)
    if not any_sample:
        return greedy
    V = logits.shape[-1]
    masked = logits
    if any_top_k:
        srt = torch.sort(logits, dim=-1, descending=True).values
        k_idx = (top_k.to(torch.int64) - 1).clamp(0, V - 1)
        kth = srt.gather(1, k_idx[:, None])
        masked = logits.masked_fill((top_k[:, None] > 0) & (logits < kth),
                                    float("-inf"))
    u = positional_uniform(seed, position, V)
    gumbel = -torch.log(-torch.log(u))
    scaled = masked / temp.clamp(min=1e-6)[:, None]
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(temp > 0, sampled, greedy)
