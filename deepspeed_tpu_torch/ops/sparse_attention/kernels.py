"""Block-sparse flash attention: forward (K7a) and backward (K7b).

Counterpart of ``deepspeed_tpu/ops/sparse_attention/kernels.py``. A
``SparsityConfig`` layout ``[H, nb, nb]`` (0/1 per block pair) is lowered on
the host to lookup tables (``build_luts``): for each query block the key
blocks it attends to, and (transposed) for each key block the query blocks
that attend to it, -1 padded. The kernels of ``csrc/sparse_attention.cu``
walk those tables, so only listed blocks are loaded and computed and the
``[T, T]`` scores never exist.

- ``build_luts``: the lowering, in the host C++ OpenMP op
  (``csrc/host/lut.cpp``, built and loaded by ``op_builder.load_host``):
  one parallel pass per direction. A failed build raises; there is no
  numpy fallback. ``build_luts_reference`` is the same function in numpy
  loops, which the tests hold the op to.
- ``build_schedule``: the order in which K7b's bf16 dk/dv kernel takes the
  transposed LUT's rows, largest first (the port's own; the TPU walks its
  grid in order and needs none).
- ``build_fwd_schedule``: K7a's bf16 block-64 items, two query blocks of
  equal LUT rows each where a head has them, largest first (the port's
  own: one CTA serves both blocks, so each key tile it reads feeds twice
  the rows).
- ``block_sparse_attention_reference``: the JAX package's dense ground truth
  (the layout expanded to an element mask, ordinary softmax attention).
- ``sparse_fwd_reference`` / ``sparse_bwd_reference``: the kernels' plain
  versions: (o, lse) with the kernel's edges (``NEG_INF`` scores, ``m_safe``,
  ``l`` clamped at 1e-30: a row with no visible key gives o = 0), and
  (dq, dk, dv) from the saved lse and ``delta = rowsum(dO * O)``.
- ``sparse_fwd`` / ``sparse_bwd``: the kernel wrappers. On CPU tensors they
  compute the plain versions; on CUDA tensors they launch K7a, or K7b fused
  (one launch, dq by atomics) or split (two launches, no atomics), or raise.
  They never fall back.
- ``block_sparse_attention``: the ``torch.autograd.Function`` callers use.
  Its backward computes ``delta``, runs K7b in the mode ``_bwd_mode``
  chooses (``DS_TPU_FLASH_BWD`` overrides, as for K2), and finishes as the
  JAX package's ``_finish_bwd`` does: a zero gradient for the key-padding
  mask, and the bias gradient rebuilt densely one head at a time.

Each lowered layout is cached with its LUTs and schedules on each device, so
a training step uploads no table. Inside ``transformer/kernels/costing.
costing()`` a launch on the card charges the dispatch modes with its plain
version, as K1/K2 do.
"""

import ctypes

import numpy as np
import torch

from deepspeed_tpu_torch.ops.transformer.kernels.attention import (
    _bwd_mode, _ptr, _scale, _stream)
from deepspeed_tpu_torch.ops.transformer.kernels.costing import (charge,
                                                                hidden)

NEG_INF = -1e30
HEAD_DIM = 64  # the head width the CUDA kernels take
BLOCKS = (16, 32, 64)  # the layout blocks the CUDA kernels take

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# Kernel launches since the last reset; chip_smoke.py reads them to show the
# sparse path went through the kernels. The split backward counts its two.
launches = {"sparse_fwd": 0, "sparse_bwd_fused": 0, "sparse_bwd_split": 0}

_fns = {}


def reset_launches():
    for name in launches:
        launches[name] = 0


def build_luts(layout):
    """Lower a ``[H, nb, nb]`` 0/1 layout to (fwd_lut ``[H, nb, max_deg]``,
    bwd_lut ``[H, nb, max_deg_t]``) int32 numpy arrays padded with -1:
    fwd_lut[h, i] lists the active key blocks of query block i, bwd_lut[h,
    j] the query blocks that attend to key block j, in increasing order.
    Runs in the host C++ op; raises when it does not build."""
    from deepspeed_tpu_torch.op_builder import load_host
    op = load_host("lut")
    lay32 = np.ascontiguousarray(np.asarray(layout) != 0, dtype=np.int32)
    h, rows, cols = lay32.shape
    i32p = ctypes.POINTER(ctypes.c_int32)
    src = lay32.ctypes.data_as(i32p)

    def lower(transpose):
        deg = int(op.ds_lut_max_degree(h, rows, cols, src, transpose))
        lut = np.empty((h, cols if transpose else rows, deg), np.int32)
        op.ds_build_lut(h, rows, cols, src, transpose, deg,
                        lut.ctypes.data_as(i32p))
        return lut

    return lower(0), lower(1)


def build_luts_reference(layout):
    """``build_luts`` in numpy loops: the same tables."""
    layout = np.asarray(layout, dtype=bool)
    h = layout.shape[0]

    def rows_to_lut(mat):  # mat: [H, rows, cols] bool
        deg = max(int(mat.sum(-1).max()) if mat.any() else 1, 1)
        lut = np.full((h, mat.shape[1], deg), -1, dtype=np.int32)
        for hi in range(h):
            for r in range(mat.shape[1]):
                cols = np.nonzero(mat[hi, r])[0]
                lut[hi, r, :len(cols)] = cols
        return lut

    return rows_to_lut(layout), rows_to_lut(layout.transpose(0, 2, 1))


def build_schedule(bwd_lut):
    """The order in which K7b's bf16 dk/dv kernel takes the rows of
    ``bwd_lut``: an int32 ``[n_items, 3]`` array of (h, key block, count)
    items, one CTA each, the count being the row's listed query blocks,
    sorted by count, largest first (stable, so ties keep (h, key block)
    order). Every row is one item, an empty one too (its dk and dv are
    zeros)."""
    h, nb, _ = bwd_lut.shape
    counts = (bwd_lut >= 0).sum(-1).astype(np.int32).reshape(-1)
    heads, keys = np.divmod(np.arange(h * nb, dtype=np.int32), nb)
    sched = np.stack([heads, keys, counts], axis=1)
    return sched[np.argsort(-counts, kind="stable")]


def build_fwd_schedule(fwd_lut):
    """The items of K7a's bf16 block-64 kernel over ``fwd_lut``: an int32
    ``[n_items, 4]`` array of (h, query block a, query block b or -1,
    count), one CTA each. Within a head, two query blocks pair only when
    their LUT rows are equal entry for entry (first with second, third with
    fourth, in query-block order, among the blocks that share a row); a
    block left over is an item alone (b = -1). count is the row's listed
    key blocks. Items are sorted by count, largest first (stable, so ties
    keep (h, a) order). Every (h, query block) is in exactly one item."""
    h, nb, _ = fwd_lut.shape
    counts = (fwd_lut >= 0).sum(-1).astype(np.int32)
    items = []
    for hi in range(h):
        waiting = {}  # row bytes -> the query block waiting for its pair
        for i in range(nb):
            key = fwd_lut[hi, i].tobytes()
            a = waiting.pop(key, None)
            if a is None:
                waiting[key] = i
            else:
                items.append((hi, a, i, counts[hi, i]))
        items.extend((hi, a, -1, counts[hi, a]) for a in waiting.values())
    sched = np.array(sorted(items, key=lambda it: it[:2]),
                     dtype=np.int32).reshape(-1, 4)
    return sched[np.argsort(-sched[:, 3], kind="stable")]


class LoweredLayout:
    """One layout lowered for the kernels: the layout, its block, the two
    LUTs, K7b's backward schedule and K7a's forward schedule (numpy), and
    their int32 copies on each device they were used on."""

    def __init__(self, layout, block):
        self.layout = np.asarray(layout)
        self.block = int(block)
        self.fwd_lut, self.bwd_lut = build_luts(self.layout)
        self.bwd_schedule = build_schedule(self.bwd_lut)
        self.fwd_schedule = build_fwd_schedule(self.fwd_lut)
        self._on = {}

    @property
    def density(self):
        """The share of block pairs the layout lists."""
        return float((self.layout != 0).sum()) / self.layout.size

    def luts(self, device):
        """(fwd_lut, bwd_lut, bwd_schedule, fwd_schedule) as contiguous
        int32 tensors on ``device``, uploaded once."""
        key = str(device)
        if key not in self._on:
            self._on[key] = tuple(
                torch.from_numpy(a).to(device)
                for a in (self.fwd_lut, self.bwd_lut, self.bwd_schedule,
                          self.fwd_schedule))
        return self._on[key]

    def element_mask(self, t, device):
        """``[H, T, T]`` bool: key j visible to query i by the layout."""
        with hidden():  # the layout's upload is not the op's work
            blocks = torch.as_tensor(self.layout != 0, device=device)
        return blocks.repeat_interleave(self.block, 1) \
            .repeat_interleave(self.block, 2)[:, :t, :t]


_LAYOUTS = {}


def lower(layout, block):
    """The cached ``LoweredLayout`` of (layout, block): keyed by the layout's
    bytes, so a config's layout is lowered once per process."""
    layout = np.asarray(layout)
    key = (layout.tobytes(), layout.shape, layout.dtype.str, int(block))
    entry = _LAYOUTS.get(key)
    if entry is None:
        entry = _LAYOUTS[key] = LoweredLayout(layout, block)
    return entry


def _masked_scores(q, k, lowered, scale, causal, kpm, kpm_mode, bias,
                   bias_mode):
    """fp32 scores ``[B, H, T, T]``, masked as the kernels mask them: kpm
    and bias added (or, in 'mul' mode, multiplied), then the causal cut and
    every pair of an unlisted block at ``NEG_INF``."""
    t = q.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kpm is not None:
        m = kpm.float()[:, None, None, :]
        s = s * m if kpm_mode == "mul" else s + m
    if bias is not None:
        s = s * bias.float() if bias_mode == "mul" else s + bias.float()
    keep = lowered.element_mask(t, q.device)[None]
    if causal:
        keep = keep & torch.ones(t, t, dtype=torch.bool,
                                 device=q.device).tril()
    return torch.where(keep, s, NEG_INF)


def sparse_fwd_reference(q, k, v, lowered, scale=None, causal=False,
                         kpm=None, kpm_mode="add", bias=None,
                         bias_mode="add"):
    """K7a's function: (o in q's dtype, lse ``[B, H, T, 1]`` fp32), with
    the kernel's edges: m_safe = max(rowmax, NEG_INF / 2), l clamped at
    1e-30, so a row with no visible key gives o = 0."""
    s = _masked_scores(q, k, lowered, _scale(q, scale), causal, kpm,
                       kpm_mode, bias, bias_mode)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=0.5 * NEG_INF)
    e = torch.exp(s - m)
    l = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    o = (torch.matmul(e, v.float()) / l).to(q.dtype)
    return o, m + torch.log(l)


def sparse_bwd_reference(q, k, v, lowered, lse, delta, do, scale=None,
                         causal=False, kpm=None, kpm_mode="add", bias=None,
                         bias_mode="add"):
    """K7b's function: (dq, dk, dv) in the inputs' dtype, from p = exp(s -
    lse) and ds = p * (dp - delta) * scale (times kpm and bias in 'mul'
    mode: the mask scales the score, so it scales the score's gradient)."""
    scale = _scale(q, scale)
    s = _masked_scores(q, k, lowered, scale, causal, kpm, kpm_mode, bias,
                       bias_mode)
    p = torch.exp(s - lse)
    do32 = do.float()
    ds = p * (torch.matmul(do32, v.float().transpose(-1, -2)) - delta) * scale
    if kpm is not None and kpm_mode == "mul":
        ds = ds * kpm.float()[:, None, None, :]
    if bias is not None and bias_mode == "mul":
        ds = ds * bias.float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.transpose(-1, -2), do32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def accumulated_magnitudes(q, k, v, lowered, lse, delta, do, scale=None,
                           causal=False, kpm=None, kpm_mode="add", bias=None,
                           bias_mode="add"):
    """For each output element of K7a and K7b, the sum of the absolute
    values of the fp32 terms the kernels add up: (o, dq, dk, dv)
    magnitudes, from the plain computation with every factor made
    non-negative (ds's magnitude p * (|do| |v|^T + |delta|) * scale, times
    |kpm| and |bias| in 'mul' mode). Summing the same terms in another
    order moves a result by a small multiple of this, so it scales the
    card checks' per-element limits."""
    scale = _scale(q, scale)
    s = _masked_scores(q, k, lowered, scale, causal, kpm, kpm_mode, bias,
                       bias_mode)
    p = torch.exp(s - lse)
    do_abs = do.float().abs()
    ds = p * (torch.matmul(do_abs, v.float().abs().transpose(-1, -2))
              + delta.abs()) * scale
    if kpm is not None and kpm_mode == "mul":
        ds = ds * kpm.float().abs()[:, None, None, :]
    if bias is not None and bias_mode == "mul":
        ds = ds * bias.float().abs()
    return (torch.matmul(p, v.float().abs()),
            torch.matmul(ds, k.float().abs()),
            torch.matmul(ds.transpose(-1, -2), q.float().abs()),
            torch.matmul(p.transpose(-1, -2), do_abs))


def block_sparse_attention_reference(q, k, v, layout, block, scale=None,
                                     causal=False, key_padding_mask=None,
                                     key_padding_mask_mode="add",
                                     attn_bias=None, attn_bias_mode="add"):
    """The JAX package's dense ground truth: the block layout expanded to an
    element mask, ordinary softmax attention in fp32; rows with no active
    block give zeros."""
    b, h, t, d = q.shape
    scale = _scale(q, scale)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_padding_mask is not None:
        m = key_padding_mask.float()[:, None, None, :]
        s = s * m if key_padding_mask_mode == "mul" else s + m
    if attn_bias is not None:
        ab = attn_bias.float()
        s = s * ab if attn_bias_mode == "mul" else s + ab
    if causal:
        cm = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = torch.where(cm, s, NEG_INF)
    dense = lower(layout, block).element_mask(t, q.device)
    s = torch.where(dense[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(dense.any(-1)[None, :, :, None], p, 0.0)
    return torch.matmul(p, v.float()).to(q.dtype)


def _kernel(name):
    fn = _fns.get(name)
    if fn is None:
        from deepspeed_tpu_torch.op_builder import load
        fn = getattr(load("sparse_attention"), name)
        # q, k, v, lut, deg, [sched, n_items,] kpm, bias, <outputs or dout,
        # lse, delta, ...>, B, H, T, D, block, dtype, scale, causal, kpm_mul,
        # bias_mul [, fused], stream
        p, i = ctypes.c_void_p, ctypes.c_int
        head = [p, p, p, p, i]
        tail = [i] * 6 + [ctypes.c_float, i, i, i]
        fn.argtypes = {
            "ds_sparse_fwd": head + [p, i] + [p] * 4 + tail + [p],
            "ds_sparse_bwd_dkdv": head + [p, i] + [p] * 8 + tail + [i, p],
            "ds_sparse_bwd_dq": head + [p] * 6 + tail + [p],
        }[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(q, k, v, lowered, kpm, bias, extra=()):
    """Shapes, and on the card what the kernels take. Returns (kpm, bias)
    as contiguous fp32 tensors (or None) on a CUDA device."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("block-sparse attention: q, k, v must be [B, H, T, "
                         "D] alike; got {}, {}, {}".format(
                             tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("block-sparse attention: q, k, v dtypes differ: {}, "
                        "{}, {}".format(q.dtype, k.dtype, v.dtype))
    B, H, T, D = q.shape
    nb = lowered.layout.shape[1]
    if lowered.layout.shape != (H, nb, nb) or T != nb * lowered.block:
        raise ValueError("block-sparse attention: layout {} at block {} does "
                         "not cover [B, H, T] = {}".format(
                             lowered.layout.shape, lowered.block, (B, H, T)))
    if kpm is not None and tuple(kpm.shape) != (B, T):
        raise ValueError("block-sparse attention: key_padding_mask must be "
                         "[B, T] = {}, got {}".format((B, T),
                                                      tuple(kpm.shape)))
    if bias is not None and tuple(bias.shape) != (B, H, T, T):
        raise ValueError("block-sparse attention: attn_bias must be [B, H, "
                         "T, T] = {}, got {}".format((B, H, T, T),
                                                     tuple(bias.shape)))
    tensors = [("q", q), ("k", k), ("v", v)] + list(extra)
    tensors += [(n, t) for n, t in (("kpm", kpm), ("bias", bias))
                if t is not None]
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError("block-sparse attention: {} on {}, q on "
                             "{}".format(name, t.device, q.device))
    if q.device.type == "cpu":
        return kpm, bias
    if q.device.type != "cuda":
        raise ValueError("block-sparse attention: unsupported device "
                         "{}".format(q.device))
    if q.dtype not in _DTYPE_CODE:
        raise TypeError("block-sparse attention: the kernels take float32, "
                        "bfloat16 or float16, got {}".format(q.dtype))
    if D != HEAD_DIM:
        raise ValueError("block-sparse attention: the kernels take head_dim "
                         "{}, got {}".format(HEAD_DIM, D))
    if lowered.block not in BLOCKS:
        raise ValueError("block-sparse attention: the kernels take blocks "
                         "{}, got {}".format(BLOCKS, lowered.block))
    for name, t in tensors[:3] + list(extra):
        if not t.is_contiguous():
            raise ValueError("block-sparse attention: {} must be "
                             "contiguous".format(name))
        if t.data_ptr() % 16:
            raise ValueError("block-sparse attention: {} must be 16-byte "
                             "aligned".format(name))
    # The forward's block-64 kernel copies 64 mask entries at a time as one
    # 256-byte bulk copy, which needs a 16-byte-aligned start.
    return tuple(None if t is None else _aligned(t.float().contiguous())
                 for t in (kpm, bias))


def _aligned(t):
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _flags(q, lowered, scale, causal, kpm_mode, bias_mode):
    B, H, T, D = q.shape
    return (B, H, T, D, lowered.block, _DTYPE_CODE[q.dtype], float(scale),
            int(bool(causal)), int(kpm_mode == "mul"),
            int(bias_mode == "mul"))


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError("block-sparse attention {} kernel launch failed: "
                           "CUDA error {}".format(what, err))


def sparse_fwd(q, k, v, lowered, scale=None, causal=False, kpm=None,
               kpm_mode="add", bias=None, bias_mode="add"):
    """K7a: (o in q's dtype, lse ``[B, H, T, 1]`` fp32) for a
    ``LoweredLayout``. On CPU tensors the plain version; on CUDA tensors the
    kernel (bf16 at block 64: one CTA per item of ``fwd_schedule``), or an
    error for what it does not take (dtype other than fp32/bf16/fp16, D !=
    64, block not 16/32/64, non-contiguous tensors, mixed devices)."""
    with hidden():
        kpm32, bias32 = _check(q, k, v, lowered, kpm, bias)
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return sparse_fwd_reference(q, k, v, lowered, scale, causal, kpm,
                                    kpm_mode, bias, bias_mode)
    B, H, T, _ = q.shape
    with hidden():
        lut, _, _, sched = lowered.luts(q.device)
        o = torch.empty_like(q)
        lse = torch.empty(B, H, T, 1, dtype=torch.float32, device=q.device)
        err = _kernel("ds_sparse_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lut.data_ptr(),
            lut.shape[2], sched.data_ptr(), sched.shape[0], _ptr(kpm32),
            _ptr(bias32), o.data_ptr(),
            lse.data_ptr(), *_flags(q, lowered, scale, causal, kpm_mode,
                                    bias_mode), _stream(q))
    _raise_on(err, "forward")
    launches["sparse_fwd"] += 1
    charge(sparse_fwd_reference, q, k, v, lowered, scale, causal, kpm,
           kpm_mode, bias, bias_mode)
    return o, lse


def sparse_bwd(q, k, v, lowered, lse, delta, do, scale=None, causal=False,
               kpm=None, kpm_mode="add", bias=None, bias_mode="add",
               mode=None):
    """K7b: (dq, dk, dv) in the inputs' dtype from the forward's lse and
    ``delta = rowsum(dO * O)`` (both ``[B, H, T, 1]`` fp32). ``mode`` is
    'fused' or 'split'; None asks ``_bwd_mode``. On CPU tensors the plain
    version (the same function either way)."""
    with hidden():
        kpm32, bias32 = _check(q, k, v, lowered, kpm, bias,
                               (("lse", lse), ("delta", delta), ("do", do)))
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return sparse_bwd_reference(q, k, v, lowered, lse, delta, do, scale,
                                    causal, kpm, kpm_mode, bias, bias_mode)
    B, H, T, D = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("block-sparse attention: do must match q ({}, {}), "
                         "got {}, {}".format(tuple(q.shape), q.dtype,
                                             tuple(do.shape), do.dtype))
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (B, H, T, 1) or t.dtype != torch.float32:
            raise ValueError("block-sparse attention: {} must be [B, H, T, "
                             "1] float32, got {} {}".format(
                                 name, tuple(t.shape), t.dtype))
    mode = mode or _bwd_mode(T, D, q.dtype)
    if mode not in ("fused", "split"):
        raise ValueError("block-sparse attention: mode must be 'fused' or "
                         "'split', got {!r}".format(mode))
    with hidden():
        out = _sparse_bwd_launch(q, k, v, lowered, lse, delta, do, scale,
                                 causal, kpm32, kpm_mode, bias32, bias_mode,
                                 mode)
    charge(sparse_bwd_reference, q, k, v, lowered, lse, delta, do, scale,
           causal, kpm, kpm_mode, bias, bias_mode)
    return out


def _sparse_bwd_launch(q, k, v, lowered, lse, delta, do, scale, causal,
                       kpm32, kpm_mode, bias32, bias_mode, mode):
    """K7b's launches on the card: (dq, dk, dv)."""
    B, H, T, D = q.shape
    fwd_lut, bwd_lut, sched, _ = lowered.luts(q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    masks = (_ptr(kpm32), _ptr(bias32))
    saved = (do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    flags = _flags(q, lowered, scale, causal, kpm_mode, bias_mode)
    tlut = (bwd_lut.data_ptr(), bwd_lut.shape[2], sched.data_ptr(),
            sched.shape[0])
    if mode == "fused":
        dq32 = torch.zeros(B, H, T, D, dtype=torch.float32, device=q.device)
        err = _kernel("ds_sparse_bwd_dkdv")(
            *common, *tlut, *masks, *saved, dq32.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *flags, 1, _stream(q))
        _raise_on(err, "fused backward")
        launches["sparse_bwd_fused"] += 1
        return dq32.to(q.dtype), dk, dv
    dq = torch.empty_like(q)
    err = _kernel("ds_sparse_bwd_dkdv")(
        *common, *tlut, *masks, *saved, None, dk.data_ptr(), dv.data_ptr(),
        *flags, 0, _stream(q))
    _raise_on(err, "split backward (dk, dv)")
    launches["sparse_bwd_split"] += 1
    err = _kernel("ds_sparse_bwd_dq")(
        *common, fwd_lut.data_ptr(), fwd_lut.shape[2], *masks, *saved,
        dq.data_ptr(), *flags, _stream(q))
    _raise_on(err, "split backward (dq)")
    launches["sparse_bwd_split"] += 1
    return dq, dk, dv


def _bias_grad(q, k, v, do, lse, delta, lowered, scale, causal, kpm,
               kpm_mode, bias, bias_mode):
    """The bias's gradient, rebuilt densely one head at a time (peak
    temporaries ``[B, T, T]``, not ``[B, H, T, T]``), as the JAX package's
    ``_finish_bwd`` does: dS = p * (dp - delta), times the pre-bias score in
    'mul' mode, zero outside the layout and the causal cut."""
    b, h, t, d = q.shape
    valid = lowered.element_mask(t, q.device)
    if causal:
        valid = valid & torch.ones(t, t, dtype=torch.bool,
                                   device=q.device).tril()
    kpm_b = None if kpm is None else kpm.float()[:, None, :]
    out = torch.empty(b, h, t, t, dtype=bias.dtype, device=q.device)
    for hi in range(h):
        s = torch.matmul(q[:, hi].float(), k[:, hi].float().transpose(-1, -2))
        s = s * scale
        if kpm_b is not None:
            s = s * kpm_b if kpm_mode == "mul" else s + kpm_b
        pre_bias = s
        bias_h = bias[:, hi].float()
        s = s * bias_h if bias_mode == "mul" else s + bias_h
        s = torch.where(valid[hi], s, NEG_INF)
        p = torch.exp(s - lse[:, hi])
        dp = torch.matmul(do[:, hi].float(),
                          v[:, hi].float().transpose(-1, -2))
        ds = p * (dp - delta[:, hi])
        g = ds * pre_bias if bias_mode == "mul" else ds
        out[:, hi] = torch.where(valid[hi], g, 0.0)
    return out


class _BlockSparseAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kpm, bias, lowered, scale, causal, kpm_mode,
                bias_mode):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = sparse_fwd(q, k, v, lowered, scale, causal, kpm, kpm_mode,
                            bias, bias_mode)
        ctx.save_for_backward(q, k, v, kpm, bias, o, lse)
        ctx.lowered, ctx.scale, ctx.causal = lowered, scale, causal
        ctx.kpm_mode, ctx.bias_mode = kpm_mode, bias_mode
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kpm, bias, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
        args = (ctx.lowered, lse, delta, do, ctx.scale, ctx.causal, kpm,
                ctx.kpm_mode, bias, ctx.bias_mode)
        dq, dk, dv = sparse_bwd(q, k, v, *args)
        # The key-padding mask is an input mask, never learned: its
        # gradient is defined as zero. The bias may be learned (an rpe).
        dkpm = torch.zeros_like(kpm) if ctx.needs_input_grad[3] else None
        dbias = _bias_grad(q, k, v, do, lse, delta, ctx.lowered, ctx.scale,
                           ctx.causal, kpm, ctx.kpm_mode, bias,
                           ctx.bias_mode) if ctx.needs_input_grad[4] else None
        return dq, dk, dv, dkpm, dbias, None, None, None, None, None


def block_sparse_attention(q, k, v, layout, block, scale=None, causal=False,
                           key_padding_mask=None, key_padding_mask_mode="add",
                           attn_bias=None, attn_bias_mode="add"):
    """Block-sparse multi-head attention steered by a SparsityConfig layout,
    differentiable in q, k, v (and the bias).

    q, k, v: ``[B, H, T, D]``, T a multiple of ``block``
    (``SparseAttentionUtils.pad_to_block_size`` pads). layout: ``[H, T /
    block, T / block]`` 0/1 from ``SparsityConfig.make_layout``. causal:
    also cut each pair with key > query (a unidirectional layout is causal
    only by block). key_padding_mask ``[B, T]`` and attn_bias ``[B, H, T,
    T]`` are added to the scores, or multiply them in 'mul' mode. Returns
    ``[B, H, T, D]`` in q's dtype: K7a forward, K7b backward on CUDA
    tensors, their plain versions on CPU tensors."""
    b, h, t, d = q.shape
    if t % block != 0:
        raise ValueError("Sequence Length, {}, needs to be dividable by "
                         "Block size {}!".format(t, block))
    layout = np.asarray(layout)
    if layout.shape[0] != h:
        raise ValueError("layout heads {} != tensor heads {}".format(
            layout.shape[0], h))
    return _BlockSparseAttention.apply(
        q, k, v, key_padding_mask, attn_bias, lower(layout, block),
        float(_scale(q, scale)), bool(causal), key_padding_mask_mode,
        attn_bias_mode)
