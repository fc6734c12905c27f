"""Flash-decode: length-aware fused cache attention for the slotted KV pool,
over dense or paged planes of fp or int8 keys.

Counterpart of ``deepspeed_tpu/ops/transformer/kernels/decode_attention.py``.
The query is ``S`` rows per slot (1 in decode, a prompt slice in the prefill
lane), the keys are a pre-allocated cache, and each row has its own frontier
``pos[b]``: its keys occupy ``0 .. pos[b]+S-1`` and everything past that is
stale garbage a later write covers. The cache comes in four layouts, one
kernel each (``csrc/decode_attention.cu``, one templated body):

=====  =======================  ==========================================
K3     dense fp plane           k, v ``[B, H, T, D]`` in q's dtype
K4     dense int8 plane         k, v ``[B, H, T, D]`` int8 codes, k_scale,
                                v_scale ``[B, H, T]`` fp32
K5     paged fp arena           k, v ``[P, H, page_len, D]``, block_tbl
                                ``[B, n_lp]`` int32
K6     paged int8 arena         K5's arena of int8 codes, scales
                                ``[P, H, page_len]`` fp32
=====  =======================  ==========================================

In a paged layout, logical page ``j`` of row ``b`` lives in arena page
``block_tbl[b, j]``; the row's logical plane is ``n_lp * page_len`` keys
long. Page 0 is the trash page that freed rows and unmapped logical pages
point at (``inference/paging.py``).

- ``quantize_kv`` / ``dequantize_kv``: the int8 storage format, symmetric
  per-(head, position) scales, bit for bit the JAX package's.
- ``decode_attention_reference`` and its ``_q8``, ``_paged`` and
  ``_paged_q8`` forms: the plain PyTorch versions. The int8 forms
  dequantize to q's dtype, the paged forms gather each row's pages into its
  logical plane, then all run the dense reference. They are the CPU path
  and the yardsticks the kernels are held against.
- ``flash_decode_attention`` and its ``_q8``, ``_paged`` and ``_paged_q8``
  forms: the wrappers. On CPU tensors each computes its plain version; on
  CUDA tensors it launches its kernel or raises. None falls back.
- ``split_plan``, ``decode_partials_reference`` and
  ``combine_partials_reference``: how the kernels cut a row (flash-decoding:
  ``SPLIT_KEYS`` keys per CTA, each writing its partial softmax state, then
  one combine launch that merges the splits in split order), in plain
  PyTorch. ``combine_partials`` runs the combine kernel alone (on CPU
  tensors, its plain version); the wrappers launch it after the split
  kernel, as part of their one counted call.

The wrappers are safe to capture in a CUDA graph (the serving engine
captures its step): their checks read shapes, dtypes and addresses on the
host only, the workspace and the output are ``torch.empty`` (inside a
capture, from the graph's memory pool), nothing synchronises the device,
and the launches (the combine as the split kernel's programmatic
dependent, ``cudaFuncSetAttribute`` for the fp32 kernels' shared memory)
are legal under stream capture.

The kernels take any plane length and any ``page_len >= 1`` (they guard
the ragged last tile and address keys one by one), so the port neither pads
planes to the TPU kernels' 128-position quantum nor falls back to a gather
for pages of another size. The int8 kernels keep k in fp32 for the scores,
as the TPU kernel does, where the plain version dequantizes it to q's dtype
first: in bf16 the two differ by k's rounding.
"""

import contextlib
import ctypes
import threading

import torch

from deepspeed_tpu_torch.analysis.annotations import hot_path

# Query rows and head width the CUDA kernels take (csrc/decode_attention.cu).
MAX_QUERY_ROWS = 64
HEAD_DIM = 64
# Keys per split: the share of a row one CTA covers (kSplitKeys; the
# library is checked against it when it loads).
SPLIT_KEYS = 128

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Scale floor: all-zero rows (unwritten cache positions) quantize to zero
# codes with this scale instead of dividing by zero.
_Q8_EPS = 1e-8

# Kernel launches since the last reset, per kernel (K3 "decode", K4 "q8",
# K5 "paged", K6 "paged_q8"), over every thread of the process;
# chip_smoke.py reads them to show the serving path went through the
# kernel. They count kernels RUN: a launch recorded inside a CUDA graph
# capture (``recording``) counts only in the capture's own tally, and a
# replay adds the tally (``add_launches``). A thread may also count into a
# dict of its own (``counting_into``): each serving engine steps under
# one, so its counts stay exact while other replicas step on other
# threads. Every update holds ``_count_lock``.
launches = {"decode": 0, "q8": 0, "paged": 0, "paged_q8": 0}
_count_lock = threading.Lock()
_local = threading.local()

# C entry point, its pointer arguments and the ints after them, per kernel.
_ENTRIES = {
    "decode": ("ds_decode_attention", 6, 6),
    "q8": ("ds_decode_attention_q8", 8, 6),
    "paged": ("ds_decode_attention_paged", 7, 7),
    "paged_q8": ("ds_decode_attention_paged_q8", 9, 7),
}
_fns = {}


def reset_launches():
    with _count_lock:
        for key in launches:
            launches[key] = 0


def add_launches(counts):
    """Launches that ran (a replayed graph's tally): add ``counts`` to the
    process's launches and to this thread's sink, if it has one."""
    sink = getattr(_local, "sink", None)
    with _count_lock:
        for kind, n in counts.items():
            launches[kind] += n
            if sink is not None:
                sink[kind] += n


def _count(kind):
    """One launch of ``kind`` on this thread: into the tally of the
    capture in progress here, else run (``add_launches``)."""
    tally = getattr(_local, "tally", None)
    if tally is not None:
        tally[kind] += 1
    else:
        add_launches({kind: 1})


@contextlib.contextmanager
def counting_into(sink):
    """Also count this thread's launches (and replays) into ``sink``, a
    dict with the keys of ``launches``, until the block ends."""
    prev = getattr(_local, "sink", None)
    _local.sink = sink
    try:
        yield sink
    finally:
        _local.sink = prev


@contextlib.contextmanager
def recording():
    """A CUDA graph capture on this thread: its launches are recorded, not
    run, so they go to the tally this yields and nowhere else."""
    prev = getattr(_local, "tally", None)
    _local.tally = dict.fromkeys(launches, 0)
    try:
        yield _local.tally
    finally:
        _local.tally = prev


@contextlib.contextmanager
def costing():
    """The perf x-ray's measurement of one eager program run
    (``telemetry/xray.py``): a kernel launched on this thread until the
    block ends adds its flops and bytes (``_kernel_cost``) to the dict
    this yields. The kernels are ctypes launches, invisible to torch's
    dispatch modes, hence the formula."""
    prev = getattr(_local, "cost", None)
    _local.cost = {"flops": 0.0, "bytes": 0.0}
    try:
        yield _local.cost
    finally:
        _local.cost = prev


def _kernel_cost(q, k, pos, T, int8, block_tbl):
    """(flops, bytes) of one decode-kernel call, the formula behind
    PERF.md's bound column: 4*D flops per visible key per query row; q and
    out, the k and v (int8: codes and fp32 scales) of each cached key up
    to its row's frontier, the frontiers and the block table read once.
    Reads the frontiers back: the x-ray calls it outside every capture."""
    B, H, S, D = q.shape
    p = pos.to("cpu", torch.int64)
    keys = torch.clamp(p + S, max=T).sum().item()
    vis = torch.clamp(p[:, None] + torch.arange(S)[None] + 1,
                      max=T).sum().item()
    key_bytes = 2 * (D + 4) if int8 else 2 * D * k.element_size()
    nbytes = 2 * B * H * S * D * q.element_size() + keys * H * key_bytes \
        + 4 * B + (block_tbl.numel() * 4 if block_tbl is not None else 0)
    return 4.0 * D * H * vis, float(nbytes)


# ---------------------------------------------------------------------------
# int8 storage
# ---------------------------------------------------------------------------


@hot_path
def quantize_kv(x):
    """Quantize ``[..., D]`` k/v rows to int8 with per-row symmetric scales.
    Returns ``(codes int8 [..., D], scale fp32 [...])``: the scale is
    ``max(absmax / 127, 1e-8)``, the codes ``x / scale`` rounded half to
    even and clipped to +-127, so ``codes * scale`` reconstructs x to within
    scale / 2 per element."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax / 127.0, min=_Q8_EPS)
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127.0, 127.0)
    return codes.to(torch.int8), scale


@hot_path
def dequantize_kv(codes, scale, dtype=torch.float32):
    """Inverse of ``quantize_kv``: ``codes [..., D]`` int8 with per-row
    ``scale [...]`` back to ``dtype`` (the product in fp32, then cast)."""
    return (codes.float() * scale[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


@hot_path
def decode_attention_reference(q, k, v, pos, scale=None):
    """q: [B, H, S, D] query rows, row b starting at global position
    ``pos[b]`` (its k/v already written at ``pos[b] .. pos[b]+S-1``);
    k, v: [B, H, T, D] cache planes; pos: [B] integer frontiers.
    Key t is visible to query row i iff ``t <= pos[b] + i``. Scores and
    softmax in fp32; the probabilities are cast to q's dtype before the
    value product. Returns [B, H, S, D] in q's dtype."""
    S, D = q.shape[2], q.shape[3]
    T = k.shape[2]
    scale = scale if scale is not None else 1.0 / D ** 0.5
    dev = q.device
    q_pos = pos.to(dev, torch.int64)[:, None] + torch.arange(S, device=dev)
    mask = torch.arange(T, device=dev)[None, None, :] <= q_pos[:, :, None]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * scale
    s = s.masked_fill(~mask[:, None], torch.finfo(torch.float32).min)
    att = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(att, v)


@hot_path
def decode_attention_q8_reference(q, k, v, k_scale, v_scale, pos,
                                  scale=None):
    """int8 plane: dequantize k and v to q's dtype, then the dense
    reference. k, v: [B, H, T, D] int8 codes; k_scale, v_scale: [B, H, T]
    fp32."""
    kf = dequantize_kv(k, k_scale, q.dtype)
    vf = dequantize_kv(v, v_scale, q.dtype)
    return decode_attention_reference(q, kf, vf, pos, scale=scale)


def gather_pages(arena, block_tbl):
    """Row-major logical planes ``[B, H, n_lp * page_len, ...]`` of a page
    arena ``[P, H, page_len, ...]`` through ``block_tbl`` [B, n_lp],
    contiguous as a dense plane is (the products that follow may round
    differently on other strides)."""
    B, n_lp = block_tbl.shape
    g = arena[block_tbl.long()]                      # [B, n_lp, H, p, ...]
    g = g.movedim(2, 1).contiguous()                 # [B, H, n_lp, p, ...]
    return g.reshape((B, arena.shape[1], n_lp * arena.shape[2])
                     + tuple(arena.shape[3:]))


@hot_path
def decode_attention_paged_reference(q, k, v, block_tbl, pos, scale=None):
    """Paged arena: gather each row's pages into its logical plane, then the
    dense reference. k, v: [P, H, page_len, D]; block_tbl: [B, n_lp]."""
    return decode_attention_reference(q, gather_pages(k, block_tbl),
                                      gather_pages(v, block_tbl), pos,
                                      scale=scale)


@hot_path
def decode_attention_paged_q8_reference(q, k, v, k_scale, v_scale,
                                        block_tbl, pos, scale=None):
    """Paged int8 arena: gather codes and scales through the table,
    dequantize, then the dense reference. k_scale, v_scale: [P, H,
    page_len]."""
    return decode_attention_q8_reference(
        q, gather_pages(k, block_tbl), gather_pages(v, block_tbl),
        gather_pages(k_scale, block_tbl), gather_pages(v_scale, block_tbl),
        pos, scale=scale)


# ---------------------------------------------------------------------------
# The kernels' split over the key length, in plain PyTorch
# ---------------------------------------------------------------------------


def split_plan(T, S, split_keys=SPLIT_KEYS):
    """How the kernels cut a plane of ``T`` keys for ``S`` query rows: the
    logical key range ``[s * L, min((s + 1) * L, T))`` of each split ``s``
    (L = ``split_keys``) and the shape ``(n_split, S, D + 2)`` of one (b,
    h)'s partials. A paged plane is cut as its gathered dense twin is
    (``T = n_lp * page_len``): the plan sees logical positions only."""
    n_split = -(-T // split_keys)
    bounds = tuple((s * split_keys, min((s + 1) * split_keys, T))
                   for s in range(n_split))
    return {"bounds": bounds, "partial_shape": (n_split, S, HEAD_DIM + 2)}


def _splits_run(pos, S, T, split_keys):
    """[B, S] splits that hold a key of each query row: those starting at
    or before the row's last key (split 0 always)."""
    rows = pos.long()[:, None] + torch.arange(S, device=pos.device)
    return torch.clamp(torch.clamp(rows, max=T - 1), min=0) // split_keys + 1


def decode_partials_reference(q, k, v, pos, scale=None,
                              split_keys=SPLIT_KEYS):
    """The split kernel's partials: fp32 ``[n_split, B, H, S, D + 2]``
    holding, for split s and query row i over the keys of split s visible
    to i, the unnormalised value sum ``[..., :D]`` = sum_t exp(s_t - m) v_t,
    the max score ``m`` at ``[..., D]`` and the sum ``l`` = sum_t exp(s_t -
    m) at ``[..., D + 1]`` (m = -inf, l = 0, sum 0 where no key is
    visible). Scores ``(scale * q) . k`` in fp32; k and v as given (the
    int8 and paged forms dequantize or gather first)."""
    B, H, S, D = q.shape
    T = k.shape[2]
    scale = scale if scale is not None else 1.0 / D ** 0.5
    dev = q.device
    qf = q.float() * scale
    q_pos = pos.to(dev, torch.int64)[:, None] + torch.arange(S, device=dev)
    out = []
    for lo, hi in split_plan(T, S, split_keys)["bounds"]:
        key = torch.arange(lo, hi, device=dev)
        vis = (key[None, None, :] <= q_pos[:, :, None])[:, None]
        s = torch.matmul(qf, k[:, :, lo:hi].float().transpose(-1, -2))
        s = s.masked_fill(~vis, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(vis, torch.exp(s - torch.where(
            torch.isinf(m), torch.zeros_like(m), m)), torch.zeros_like(s))
        acc = torch.matmul(p, v[:, :, lo:hi].float())
        out.append(torch.cat([acc, m, p.sum(dim=-1, keepdim=True)], dim=-1))
    return torch.stack(out)


def combine_partials_reference(partials, pos, T, dtype,
                               split_keys=SPLIT_KEYS):
    """The combine kernel's result: each (b, h, row)'s partials of the
    splits that hold a key of the row (``_splits_run``; the others are
    never read) merged in split order: ``m = max_s m_s``, ``w_s = exp(m_s -
    m)`` (0 where m_s = -inf), out = sum_s w_s acc_s / sum_s w_s l_s, cast
    to ``dtype``. partials: fp32 ``[n_split, B, H, S, D + 2]``."""
    n_split, B, H, S, P = partials.shape
    D = P - 2
    run = _splits_run(pos.to(partials.device), S, T, split_keys)
    live = (torch.arange(n_split, device=partials.device)[:, None, None]
            < run[None])[:, :, None, :]                     # [n, B, 1, S]
    ms = torch.where(live, partials[..., D], float("-inf"))
    m = ms.amax(dim=0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(partials[0, ..., :D])
    for s in range(n_split):
        w = torch.where(torch.isinf(ms[s]), torch.zeros_like(m),
                        torch.exp(ms[s] - m))
        w = torch.where(live[s], w, torch.zeros_like(w))
        l = l + w * torch.where(live[s], partials[s, ..., D + 1], 0.0)
        acc = acc + w[..., None] * torch.where(live[s][..., None],
                                               partials[s, ..., :D], 0.0)
    return (acc / l[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _library():
    """The built library, checked to split rows as SPLIT_KEYS says."""
    from deepspeed_tpu_torch.op_builder import load
    lib = load("decode_attention")
    if lib.ds_decode_split_keys() != SPLIT_KEYS:
        raise RuntimeError("decode_attention: the library splits rows every "
                           "{} keys, SPLIT_KEYS is {}".format(
                               lib.ds_decode_split_keys(), SPLIT_KEYS))
    return lib


def _kernel(kind):
    fn = _fns.get(kind)
    if fn is None:
        if kind == "combine":
            name, n_ptr, n_int = "ds_decode_combine", 3, 6
            tail = [ctypes.c_void_p]
        else:
            name, n_ptr, n_int = _ENTRIES[kind]
            tail = [ctypes.c_float, ctypes.c_void_p]
        fn = getattr(_library(), name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + \
            tail
        fn.restype = ctypes.c_int
        _fns[kind] = fn
    return fn


def _check_shapes(name, q, k, v, pos, scales=None, block_tbl=None):
    """Shapes and dtypes every layout must agree on, for CPU and CUDA
    tensors alike."""
    dims = [(q, 4, "q"), (k, 4, "k"), (v, 4, "v"), (pos, 1, "pos")]
    if scales is not None:
        dims += [(scales[0], 3, "k_scale"), (scales[1], 3, "v_scale")]
    if block_tbl is not None:
        dims.append((block_tbl, 2, "block_tbl"))
    for t, rank, what in dims:
        if t.dim() != rank:
            raise ValueError("{}: {} must be {}-D, got shape {}".format(
                name, what, rank, tuple(t.shape)))
    B, H, S, D = q.shape
    rows = block_tbl.shape[0] if block_tbl is not None else k.shape[0]
    if k.shape != v.shape or rows != B or k.shape[1] != H or \
            k.shape[3] != D or pos.shape[0] != B:
        raise ValueError("{}: shapes disagree: q {}, k {}, v {}, pos {}{}"
                         .format(name, tuple(q.shape), tuple(k.shape),
                                 tuple(v.shape), tuple(pos.shape),
                                 "" if block_tbl is None else
                                 ", block_tbl {}".format(
                                     tuple(block_tbl.shape))))
    if scales is not None:
        for what, s in zip(("k_scale", "v_scale"), scales):
            if s.shape != k.shape[:3]:
                raise ValueError("{}: {} must be {}, got {}".format(
                    name, what, tuple(k.shape[:3]), tuple(s.shape)))
        if k.dtype != torch.int8 or v.dtype != torch.int8:
            raise TypeError("{}: k and v must be int8 codes, got {}, {}"
                            .format(name, k.dtype, v.dtype))
    elif k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("{}: q, k, v dtypes differ: {}, {}, {}".format(
            name, q.dtype, k.dtype, v.dtype))


def _check_cuda(name, q, k, v, pos, scales=(), block_tbl=None):
    """What the kernels take, on CUDA tensors: all on q's device; q float32
    or bfloat16, D == 64, S <= 64; int8 codes with float32 scales; int32 pos
    and block table; contiguous; the operands read in 16-byte vectors (q, k,
    v) 16-byte aligned, the ones read element by element (scales, pos,
    table) aligned to their element."""
    if q.device.type != "cuda":
        raise ValueError("{}: unsupported device {}".format(name, q.device))
    named = [("q", q), ("k", k), ("v", v), ("pos", pos)]
    named += list(zip(("k_scale", "v_scale"), scales))
    if block_tbl is not None:
        named.append(("block_tbl", block_tbl))
    for what, t in named:
        if t.device != q.device:
            raise ValueError("{}: {} on {}, q on {}".format(
                name, what, t.device, q.device))
    if q.dtype not in _DTYPE_CODE:
        raise TypeError("{}: the kernel takes float32 or bfloat16 queries, "
                        "got {}".format(name, q.dtype))
    B, H, S, D = q.shape
    if D != HEAD_DIM:
        raise ValueError("{}: the kernel takes head_dim {}, got {}".format(
            name, HEAD_DIM, D))
    if S > MAX_QUERY_ROWS:
        raise ValueError("{}: the kernel takes at most {} query rows, got {}"
                         .format(name, MAX_QUERY_ROWS, S))
    for what, t in named:
        if what in ("pos", "block_tbl") and t.dtype != torch.int32:
            raise TypeError("{}: {} must be int32, got {}".format(
                name, what, t.dtype))
        if what.endswith("scale") and t.dtype != torch.float32:
            raise TypeError("{}: {} must be float32, got {}".format(
                name, what, t.dtype))
        if not t.is_contiguous():
            raise ValueError("{}: {} must be contiguous".format(name, what))
        align = 16 if what in ("q", "k", "v") else t.element_size()
        if t.data_ptr() % align:
            raise ValueError("{}: {} must be {}-byte aligned".format(
                name, what, align))


def _workspace(q, T):
    """The partials of one call, fresh on the current stream (two streams'
    calls never share one)."""
    B, H, S, _ = q.shape
    n_split = split_plan(T, S)["partial_shape"][0]
    return torch.empty((n_split, B, H, S, HEAD_DIM + 2), dtype=torch.float32,
                       device=q.device)


def _stream(q):
    return torch.cuda.current_stream(q.device).cuda_stream


def _launch(kind, q, ptrs, ints, T, scale):
    """Launch ``kind``'s split kernel and the combine into a new output on
    the current stream; raises if the C entry refuses or a launch fails,
    and counts the call once. ``T``: the (logical) plane length."""
    out = torch.empty_like(q)
    work = _workspace(q, T)
    B, H, S, D = q.shape
    err = _kernel(kind)(
        q.data_ptr(), *[t.data_ptr() for t in ptrs], work.data_ptr(),
        out.data_ptr(), B, H, S, *ints, D, _DTYPE_CODE[q.dtype], float(scale),
        _stream(q))
    if err != 0:
        raise RuntimeError("decode_attention {} kernel launch failed: CUDA "
                           "error {}".format(kind, err))
    _count(kind)
    cost = getattr(_local, "cost", None)
    if cost is not None:
        paged = kind in ("paged", "paged_q8")
        flops, nbytes = _kernel_cost(
            q, ptrs[0], ptrs[-1], T, kind in ("q8", "paged_q8"),
            ptrs[-2] if paged else None)
        cost["flops"] += flops
        cost["bytes"] += nbytes
    return out


def _on_cpu(name, q, *tensors):
    if q.device.type != "cpu":
        return False
    for t in tensors:
        if t.device.type != "cpu":
            raise ValueError("{}: q on CPU, an operand on {}".format(
                name, t.device))
    return True


@hot_path
def flash_decode_attention(q, k, v, pos, scale=None):
    """Kernel K3: length-aware fused cache attention over a dense plane.

    Same arguments and result as ``decode_attention_reference``. On CPU
    tensors it IS the reference. On CUDA tensors it launches the kernel
    (a CTA per SPLIT_KEYS keys and 4 query rows of each (b, h), keys read
    only up to each row's frontier, then the combine of the splits) on the
    current stream, and raises for what the kernel does not take (see
    ``_check_cuda``)."""
    name = "flash_decode_attention"
    _check_shapes(name, q, k, v, pos)
    if scale is None:
        scale = 1.0 / q.shape[3] ** 0.5
    if _on_cpu(name, q, k, v):
        return decode_attention_reference(q, k, v, pos, scale=scale)
    _check_cuda(name, q, k, v, pos)
    return _launch("decode", q, (k, v, pos), (k.shape[2],), k.shape[2],
                   scale)


@hot_path
def flash_decode_attention_q8(q, k, v, k_scale, v_scale, pos, scale=None):
    """Kernel K4: ``flash_decode_attention`` over int8 codes ``[B, H, T,
    D]`` with fp32 per-(head, position) scales ``[B, H, T]``, dequantized
    in registers while scoring. On CPU tensors it is
    ``decode_attention_q8_reference``."""
    name = "flash_decode_attention_q8"
    _check_shapes(name, q, k, v, pos, scales=(k_scale, v_scale))
    if scale is None:
        scale = 1.0 / q.shape[3] ** 0.5
    if _on_cpu(name, q, k, v, k_scale, v_scale):
        return decode_attention_q8_reference(q, k, v, k_scale, v_scale, pos,
                                             scale=scale)
    _check_cuda(name, q, k, v, pos, scales=(k_scale, v_scale))
    return _launch("q8", q, (k, v, k_scale, v_scale, pos), (k.shape[2],),
                   k.shape[2], scale)


@hot_path
def flash_decode_attention_paged(q, k, v, block_tbl, pos, scale=None):
    """Kernel K5: block-table flash decode over a page arena ``[P, H,
    page_len, D]``; row b's logical page j is arena page
    ``block_tbl[b, j]``. Any ``page_len >= 1``. On CPU tensors it is
    ``decode_attention_paged_reference``."""
    name = "flash_decode_attention_paged"
    _check_shapes(name, q, k, v, pos, block_tbl=block_tbl)
    if scale is None:
        scale = 1.0 / q.shape[3] ** 0.5
    if _on_cpu(name, q, k, v, block_tbl):
        return decode_attention_paged_reference(q, k, v, block_tbl, pos,
                                                scale=scale)
    _check_cuda(name, q, k, v, pos, block_tbl=block_tbl)
    return _launch("paged", q, (k, v, block_tbl, pos),
                   (block_tbl.shape[1], k.shape[2]),
                   block_tbl.shape[1] * k.shape[2], scale)


@hot_path
def flash_decode_attention_paged_q8(q, k, v, k_scale, v_scale, block_tbl,
                                    pos, scale=None):
    """Kernel K6: ``flash_decode_attention_paged`` over int8 code arenas
    with fp32 scale arenas ``[P, H, page_len]``, dequantized as K4 does. On
    CPU tensors it is ``decode_attention_paged_q8_reference``."""
    name = "flash_decode_attention_paged_q8"
    _check_shapes(name, q, k, v, pos, scales=(k_scale, v_scale),
                  block_tbl=block_tbl)
    if scale is None:
        scale = 1.0 / q.shape[3] ** 0.5
    if _on_cpu(name, q, k, v, k_scale, v_scale, block_tbl):
        return decode_attention_paged_q8_reference(
            q, k, v, k_scale, v_scale, block_tbl, pos, scale=scale)
    _check_cuda(name, q, k, v, pos, scales=(k_scale, v_scale),
                block_tbl=block_tbl)
    return _launch("paged_q8", q, (k, v, k_scale, v_scale, block_tbl, pos),
                   (block_tbl.shape[1], k.shape[2]),
                   block_tbl.shape[1] * k.shape[2], scale)


def combine_partials(partials, pos, T, dtype):
    """The combine kernel alone: ``partials`` fp32 ``[n_split, B, H, S, D +
    2]`` as ``decode_partials_reference`` lays them out, ``pos`` [B] int32,
    ``T`` the plane length; returns ``[B, H, S, D]`` in ``dtype``. On CPU
    tensors it is ``combine_partials_reference``; on CUDA tensors it
    launches the kernel the four wrappers launch after their split kernel
    (there counted as part of their call)."""
    name = "combine_partials"
    n_split, B, H, S, P = partials.shape
    if partials.dtype != torch.float32 or P != HEAD_DIM + 2 or \
            pos.shape != (B,) or \
            n_split != split_plan(T, S)["partial_shape"][0]:
        raise ValueError("{}: partials {} {} do not fit pos {} and T {}"
                         .format(name, tuple(partials.shape), partials.dtype,
                                 tuple(pos.shape), T))
    if _on_cpu(name, partials, pos):
        return combine_partials_reference(partials, pos, T, dtype)
    if pos.device != partials.device or pos.dtype != torch.int32 or \
            dtype not in _DTYPE_CODE or not partials.is_contiguous():
        raise ValueError("{}: the kernel takes contiguous partials, int32 pos "
                         "on their device and a float32 or bfloat16 output"
                         .format(name))
    out = torch.empty((B, H, S, HEAD_DIM), dtype=dtype,
                      device=partials.device)
    err = _kernel("combine")(partials.data_ptr(), pos.data_ptr(),
                             out.data_ptr(), B, H, S, T, HEAD_DIM,
                             _DTYPE_CODE[dtype], _stream(out))
    if err != 0:
        raise RuntimeError("decode_attention combine kernel launch failed: "
                           "CUDA error {}".format(err))
    return out
