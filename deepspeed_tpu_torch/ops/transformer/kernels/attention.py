"""Flash attention for training: forward (K1) and backward (K2a/K2b).

Counterpart of ``deepspeed_tpu/ops/transformer/kernels/attention.py``, with
its layout at the public function: q, k, v ``[B, H, T, D]``, an optional
additive ``[B, T_kv]`` mask broadcast over heads and query rows, and a
causal switch that keeps key ``j`` for query ``i`` iff ``j <= i``.

- ``mha_reference``: the plain dense version (fp32 scores, ``NEG_INF``
  causal cut, normalised by division), with the logsumexp on request: K1's
  plain version.
- ``flash_bwd_reference``: K2's plain version, (dq, dk, dv) from q, k, v,
  the saved lse, ``delta = rowsum(dO * O)`` and dO, with P recomputed from
  the lse.
- ``flash_fwd`` / ``flash_bwd``: the kernel wrappers. On CPU tensors they
  compute the plain versions; on CUDA tensors they launch the hand-written
  kernels of ``csrc/flash_attention.cu`` or raise. They never fall back.
- ``flash_attention_with_lse``: the ``torch.autograd.Function``, returning
  (o, lse), both differentiable (ring attention merges partial results
  through the lse). Its forward is K1; its backward computes ``delta =
  rowsum(dO * O) - dlse`` as a plain tensor op, then runs K2a (one launch,
  dq by atomics) or K2b (two launches, no atomics), as ``_flash_bwd_mode``
  chooses (``DS_TPU_FLASH_BWD``, else the autotuner's table of modes
  measured on the card, else ``_bwd_mode``'s 6 MiB rule). Since ``d lse /
  d s = P``, the lse's gradient enters ds = P (dP - delta) exactly as
  delta does, so no kernel changes.
- ``flash_attention``: its o alone, which the model calls (no lse gradient
  then).

The kernels take any T (they guard the ragged last tile), so the port sends
no shape to the dense path on the card.

Inside ``kernels/costing.costing()`` (the perf x-ray's and the flops
profiler's measured runs) a launch on the card charges the dispatch modes with its plain
version's operators (``kernels/costing.py``), so a step counts the same
flops and bytes on the card as on the CPU.
"""

import contextlib
import ctypes
import os

import torch

from deepspeed_tpu_torch.ops.transformer.kernels.costing import (charge,
                                                                hidden)

NEG_INF = -1e30
HEAD_DIM = 64  # the head width the CUDA kernels take

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# The JAX package's resident-set budget for the fused backward
# (``_RESIDENT_BWD_VMEM_BUDGET``): above it both packages take the split
# backward.
_FUSED_BWD_BYTES = 6 * 1024 * 1024

# Kernel launches since the last reset; chip_smoke.py reads them to show
# the training path went through the kernels. K2b counts its two kernels.
# A launch inside a CUDA graph capture (``recording``) goes to the
# capture's tally instead, and each replay adds the tally
# (``add_launches``): the counts are kernels run.
launches = {"flash_fwd": 0, "flash_bwd_fused": 0, "flash_bwd_split": 0}
_tally = None

_fns = {}


def reset_launches():
    for name in launches:
        launches[name] = 0


def _count(kind):
    if _tally is not None:
        _tally[kind] += 1
    else:
        launches[kind] += 1


@contextlib.contextmanager
def recording():
    """A CUDA graph capture: the launches until the block ends are
    recorded, not run, so they go to the tally this yields. Process-wide
    (the backward of a capture runs on autograd's device thread)."""
    global _tally
    prev, _tally = _tally, dict.fromkeys(launches, 0)
    try:
        yield _tally
    finally:
        _tally = prev


def add_launches(counts):
    """Launches that ran: a replayed graph's tally."""
    for kind, n in counts.items():
        launches[kind] += n


def _scale(q, scale):
    return scale if scale is not None else 1.0 / q.shape[-1] ** 0.5


def _scores(q, k, mask, causal, scale):
    """fp32 scores of the scaled q against k, masked as the kernels mask."""
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if mask is not None:
        s = s + mask[:, None, None, :].float()
    if causal:
        keep = torch.ones(q.shape[2], k.shape[2], dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(keep, s, NEG_INF)
    return s


def mha_reference(q, k, v, mask=None, causal=False, scale=None,
                  return_lse=False):
    """Dense attention: softmax in fp32, normalised by division (a row whose
    keys are all masked at -1e9 stays finite). Returns o in q's dtype and,
    with ``return_lse``, the per-row logsumexp ``[B, H, T, 1]`` fp32: K1's
    function, its plain version."""
    s = _scores(q, k, mask, causal, _scale(q, scale))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(e / l, v.float()).to(q.dtype)
    if return_lse:
        return o, m + torch.log(l)
    return o


def flash_bwd_reference(q, k, v, mask, lse, delta, do, causal=False,
                        scale=None):
    """K2's function: (dq, dk, dv) in the inputs' dtype. P is recomputed
    from the saved lse, clamped at 0 as the kernels clamp it (s <= lse in
    exact arithmetic; the clamp guards fully masked rows)."""
    scale = _scale(q, scale)
    s = _scores(q, k, mask, causal, scale)
    p = torch.exp(torch.clamp(s - lse, max=0.0))
    do32 = do.float()
    dv = torch.matmul(p.transpose(-1, -2), do32)
    dp = torch.matmul(do32, v.float().transpose(-1, -2))
    ds = p * (dp - delta)
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float() * scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def accumulated_magnitudes(q, k, v, mask, lse, delta, do, causal=False,
                           scale=None):
    """For each output element of K1 and K2, the sum of the absolute values
    of the fp32 terms the kernels add up: (o, dq, dk, dv) magnitudes, from
    the plain computation with every factor made non-negative (for ds = p *
    (dp - delta), p * (|do| |v|^T + |delta|), which also covers the
    cancellation inside dp - delta). Summing the same terms in another
    order moves a result by a small multiple of this, so it scales the card
    checks' per-element limits."""
    scale = _scale(q, scale)
    s = _scores(q, k, mask, causal, scale)
    p = torch.exp(torch.clamp(s - lse, max=0.0))
    do_abs = do.float().abs()
    ds = p * (torch.matmul(do_abs, v.float().abs().transpose(-1, -2))
              + delta.abs())
    return (torch.matmul(p, v.float().abs()),
            torch.matmul(ds, k.float().abs()) * scale,
            torch.matmul(ds.transpose(-1, -2), q.float().abs() * scale),
            torch.matmul(p.transpose(-1, -2), do_abs))


def _bwd_mode(t_kv, d, dtype):
    """'fused' (K2a) or 'split' (K2b): the JAX package's choice at the same
    shape. ``DS_TPU_FLASH_BWD`` overrides; otherwise 'split' when the fused
    backward's resident set, ``t_kv * d * (4 * itemsize + 8)`` bytes, is
    over 6 MiB."""
    mode = os.environ.get("DS_TPU_FLASH_BWD", "auto")
    if mode in ("fused", "split"):
        return mode
    itemsize = torch.empty((), dtype=dtype).element_size()
    resident = t_kv * d * (4 * itemsize + 2 * 4)
    return "split" if resident > _FUSED_BWD_BYTES else "fused"


def flash_signature(b, h, t_q, t_kv, d, dtype, causal):
    """The autotune signature of a flash-attention shape, the JAX
    package's format (``b8_h16_tq1024_tkv1024_d64_bfloat16_c1``)."""
    return "b{}_h{}_tq{}_tkv{}_d{}_{}_c{}".format(
        b, h, t_q, t_kv, d, str(dtype).replace("torch.", ""),
        int(bool(causal)))


def _flash_bwd_mode(q, k, v, mask, lse, delta, do, causal, scale):
    """K2's mode on the card: ``DS_TPU_FLASH_BWD`` when set, else the
    ``flash_attention`` family's choice for this signature
    (``ops/autotuner.py``: the bundled table of modes measured on the card,
    the user cache, a sweep of both under ``DS_TPU_AUTOTUNE=1``), the 6 MiB
    rule (``_bwd_mode``) where no row exists. No sweep runs during a graph
    capture."""
    mode = os.environ.get("DS_TPU_FLASH_BWD", "auto")
    if mode in ("fused", "split"):
        return mode
    from deepspeed_tpu_torch.ops import autotuner
    B, H, Tq, D = q.shape
    sig = flash_signature(B, H, Tq, k.shape[2], D, q.dtype, causal)

    def make_run(cand):
        def run():
            dkdv, dq_only, _ = _bwd_kernels(q, k, v, mask, lse, delta, do,
                                            causal, scale)
            if cand == "fused":
                dkdv(torch.zeros(B, H, Tq, D, dtype=torch.float32,
                                 device=q.device))
            else:
                dkdv()
                dq_only()
        return run

    cands = [] if autotuner.capturing() else ["fused", "split"]
    return autotuner.autotune("flash_attention", sig, cands, make_run,
                              default=_bwd_mode(k.shape[2], D, q.dtype),
                              repeats=20, device=q.device)


def _kernel(name):
    fn = _fns.get(name)
    if fn is None:
        from deepspeed_tpu_torch.op_builder import load
        fn = getattr(load("flash_attention"), name)
        # tensors..., B, H, Tq, Tk, D, dtype, scale, causal[, fused], stream
        n_ptr = {"ds_flash_fwd": 6, "ds_flash_bwd_dkdv": 10,
                 "ds_flash_bwd_dq": 8}[name]
        fused = [ctypes.c_int] if name == "ds_flash_bwd_dkdv" else []
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + \
            [ctypes.c_float, ctypes.c_int] + fused + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(q, k, v, mask, extra=()):
    """Shapes, and on the card what the kernels take. Returns the mask as a
    contiguous fp32 tensor (or None)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention: q, k, v must be [B, H, T, D]; got "
                         "{}, {}, {}".format(tuple(q.shape), tuple(k.shape),
                                             tuple(v.shape)))
    B, H, _, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError("flash attention: shapes disagree: q {}, k {}, v "
                         "{}".format(tuple(q.shape), tuple(k.shape),
                                     tuple(v.shape)))
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash attention: q, k, v dtypes differ: {}, {}, "
                        "{}".format(q.dtype, k.dtype, v.dtype))
    if mask is not None and tuple(mask.shape) != (B, k.shape[2]):
        raise ValueError("flash attention: mask must be [B, T_kv] = {}, got "
                         "{}".format((B, k.shape[2]), tuple(mask.shape)))
    tensors = [("q", q), ("k", k), ("v", v)] + list(extra)
    if mask is not None:
        tensors.append(("mask", mask))
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError("flash attention: {} on {}, q on {}".format(
                name, t.device, q.device))
    if q.device.type == "cpu":
        return mask
    if q.device.type != "cuda":
        raise ValueError("flash attention: unsupported device {}".format(
            q.device))
    if q.dtype not in _DTYPE_CODE:
        raise TypeError("flash attention: the kernels take float32, bfloat16 "
                        "or float16, got {}".format(q.dtype))
    if D != HEAD_DIM:
        raise ValueError("flash attention: the kernels take head_dim {}, got "
                         "{}".format(HEAD_DIM, D))
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError("flash attention: {} must be contiguous".format(
                name))
        if t.data_ptr() % 16:
            raise ValueError("flash attention: {} must be 16-byte "
                             "aligned".format(name))
    if mask is not None:
        mask = mask.float().contiguous()
    return mask


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(q):
    return torch.cuda.current_stream(q.device).cuda_stream


def flash_fwd(q, k, v, mask=None, causal=False, scale=None):
    """K1: (o in q's dtype, lse ``[B, H, T, 1]`` fp32). On CPU tensors the
    plain version; on CUDA tensors the kernel, or an error for what it does
    not take (dtype other than fp32/bf16/fp16, D != 64, non-contiguous
    tensors, mixed devices)."""
    with hidden():
        mask32 = _check(q, k, v, mask)
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, mask, causal, scale, return_lse=True)
    with hidden():
        B, H, Tq, D = q.shape
        o = torch.empty_like(q)
        lse = torch.empty(B, H, Tq, 1, dtype=torch.float32, device=q.device)
        err = _kernel("ds_flash_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask32),
            o.data_ptr(), lse.data_ptr(), B, H, Tq, k.shape[2], D,
            _DTYPE_CODE[q.dtype], float(scale), int(bool(causal)),
            _stream(q))
    if err != 0:
        raise RuntimeError("flash attention forward kernel launch failed: "
                           "CUDA error {}".format(err))
    _count("flash_fwd")
    charge(mha_reference, q, k, v, mask, causal, scale, return_lse=True)
    return o, lse


def flash_bwd(q, k, v, mask, lse, delta, do, causal=False, scale=None,
              mode=None):
    """K2: (dq, dk, dv) in the inputs' dtype from the forward's lse and
    ``delta = rowsum(dO * O)`` (both ``[B, H, T, 1]`` fp32). ``mode`` is
    'fused' (K2a) or 'split' (K2b); None asks ``_flash_bwd_mode``. On CPU
    tensors the plain version (the same function either way)."""
    with hidden():
        mask32 = _check(q, k, v, mask, (("lse", lse), ("delta", delta),
                                        ("do", do)))
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, mask, lse, delta, do, causal,
                                   scale)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("flash attention: do must match q ({}, {}), got {}, "
                         "{}".format(tuple(q.shape), q.dtype,
                                     tuple(do.shape), do.dtype))
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (B, H, Tq, 1) or t.dtype != torch.float32:
            raise ValueError("flash attention: {} must be [B, H, T, 1] "
                             "float32, got {} {}".format(
                                 name, tuple(t.shape), t.dtype))
    if mode is None:
        with hidden():  # a sweep's launches are not the step's work
            mode = _flash_bwd_mode(q, k, v, mask32, lse, delta, do, causal,
                                   scale)
    if mode not in ("fused", "split"):
        raise ValueError("flash attention: mode must be 'fused' or 'split', "
                         "got {!r}".format(mode))
    with hidden():
        dkdv, dq_only, (dq, dk, dv) = _bwd_kernels(
            q, k, v, mask32, lse, delta, do, causal, scale)
        if mode == "fused":
            dq32 = torch.zeros(B, H, Tq, D, dtype=torch.float32,
                               device=q.device)
            dkdv(dq32)
            _count("flash_bwd_fused")
            dq = dq32.to(q.dtype)
        else:
            dkdv()
            _count("flash_bwd_split")
            dq_only()
            _count("flash_bwd_split")
    charge(flash_bwd_reference, q, k, v, mask, lse, delta, do, causal, scale)
    return dq, dk, dv


def _bwd_kernels(q, k, v, mask, lse, delta, do, causal, scale):
    """K2's kernels as two callables and the (dq, dk, dv) they write: the
    dk/dv kernel (given an fp32 dq accumulator, K2a, which adds dq into it;
    else K2b's first kernel) and K2b's dq kernel. Each raises on a launch
    error and counts nothing (``chip_smoke`` times K2b's two apart)."""
    B, H, Tq, D = q.shape
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    dims = (B, H, Tq, k.shape[2], D, _DTYPE_CODE[q.dtype], float(scale),
            int(bool(causal)))

    def dkdv(dq32=None):
        _raise_on(_kernel("ds_flash_bwd_dkdv")(
            *args, _ptr(dq32), dk.data_ptr(), dv.data_ptr(), *dims,
            int(dq32 is not None), _stream(q)),
            "split backward (dk, dv)" if dq32 is None else "fused backward")

    def dq_only():
        _raise_on(_kernel("ds_flash_bwd_dq")(
            *args, dq.data_ptr(), *dims, _stream(q)), "split backward (dq)")

    return dkdv, dq_only, (dq, dk, dv)


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError("flash attention {} kernel launch failed: CUDA "
                           "error {}".format(what, err))


class _FlashAttention(torch.autograd.Function):
    """K1 forward returning (o, lse); K2 backward with delta = rowsum(dO *
    O) - dlse. ``flash_attention`` takes o only, and then dlse is None."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale):
        ctx.set_materialize_grads(False)
        o, lse = flash_fwd(q, k, v, mask, causal, scale)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, mask, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
        if dlse is not None:
            delta = delta - dlse.float()
        dq, dk, dv = flash_bwd(q, k, v, mask, lse, delta.contiguous(),
                               do.contiguous(), ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, mask=None, causal=False, scale=None):
    """Fused (flash) multi-head attention, differentiable in q, k, v.

    q, k, v: ``[B, H, T, D]``; mask: optional additive ``[B, T_kv]`` (0 keep,
    -1e9 drop); causal: key j visible to query i iff j <= i; scale: default
    1/sqrt(D). Returns ``[B, H, T, D]`` in q's dtype. K1 forward, K2a or K2b
    backward on CUDA tensors; their plain versions on CPU tensors."""
    return flash_attention_with_lse(q, k, v, mask, causal, scale)[0]


def flash_attention_with_lse(q, k, v, mask=None, causal=False, scale=None):
    """``flash_attention`` returning ``(o, lse)``, lse ``[B, H, T, 1]``
    fp32; both outputs are differentiable (module docstring). K1 forward,
    K2a or K2b backward on CUDA tensors; their plain versions on CPU
    tensors."""
    return _FlashAttention.apply(q, k, v, mask, bool(causal),
                                 float(_scale(q, scale)))
