"""The ctypes binding of ``csrc/transformer_kernels.cu`` (kernels K8, K9,
K10a, K10b and K11) and the checks their wrappers share.

The library is built and loaded at the first launch (``op_builder.load``),
never at import. ``cuda_operands`` decides, from the tensors alone, whether
a wrapper computes its plain version (CPU tensors) or launches its kernel
(CUDA tensors, after checking what the kernel takes); any other device
raises. Each wrapper's work on the card runs under ``costing.hidden()``
and then ``costing.charge``s its plain version (``kernels/costing.py``),
so the perf x-ray counts a step alike on the card and on the CPU.
"""

import ctypes

import torch

from deepspeed_tpu_torch.ops.transformer.kernels.costing import (  # noqa: F401
    charge, hidden)

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_U, _F = ctypes.c_uint, ctypes.c_float
_SIGNATURES = {
    # x, res, bias, gamma, beta, out, mu, rstd, rows, cols, dtype, eps, stream
    "ds_layer_norm_fwd": [_P] * 8 + [_I, _I, _I, _F, _P],
    # s, mask, out, B, H, Tq, Tk, dtype, scale, causal, stream
    "ds_attn_softmax_fwd": [_P] * 3 + [_I] * 5 + [_F, _I, _P],
    # x, bias, out, n, cols, dtype, stream
    "ds_bias_gelu_fwd": [_P] * 3 + [_LL, _I, _I, _P],
    # x, bias, res, out, n, cols, dtype, threshold, scale, k0, k1, stream
    "ds_dropout_fwd": [_P] * 4 + [_LL, _I, _I, _U, _F, _U, _U, _P],
    # g, dx, n, dtype, threshold, scale, k0, k1, stream
    "ds_dropout_bwd": [_P] * 2 + [_LL, _I, _U, _F, _U, _U, _P],
}

_fns = {}


def _kernel(name):
    fn = _fns.get(name)
    if fn is None:
        from deepspeed_tpu_torch.op_builder import load
        fn = getattr(load("transformer_kernels"), name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def launch(name, what, x, *args):
    """Call entry point ``name`` with ``args`` on x's current stream; raise
    RuntimeError naming ``what`` if the launch failed."""
    err = _kernel(name)(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("{} kernel launch failed: CUDA error {}".format(
            what, err))


def ptr(t):
    return None if t is None else t.data_ptr()


def cuda_operands(what, x, others=(), vectors=(), whole_vectors=True):
    """False when ``x`` lies on the CPU (the caller computes the plain
    version); True when it lies on a CUDA device and the kernel takes it.

    ``others`` are further tensors of x's dtype and shape (or None);
    ``vectors`` further per-column tensors (or None), which the caller
    hands the kernel as contiguous fp32. Raises ValueError or TypeError for
    mixed devices, an unsupported device or dtype, a non-contiguous or
    misaligned tensor, or (with ``whole_vectors``, for kernels that read
    rows only in 16-byte vectors) a last dimension that is not a whole
    number of 16-byte vectors."""
    tensors = [t for t in (x,) + tuple(others) + tuple(vectors)
               if t is not None]
    for t in tensors:
        if t.device != x.device:
            raise ValueError("{}: tensors on {} and {}".format(
                what, x.device, t.device))
    for t in others:
        if t is not None and (t.shape != x.shape or t.dtype != x.dtype):
            raise ValueError("{}: operand {} {} does not match x {} "
                             "{}".format(what, tuple(t.shape), t.dtype,
                                         tuple(x.shape), x.dtype))
    cols = x.shape[-1] if x.dim() else 1
    for t in vectors:
        if t is not None and tuple(t.shape) != (cols,):
            raise ValueError("{}: per-column operand of shape {}, expected "
                             "({},)".format(what, tuple(t.shape), cols))
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError("{}: unsupported device {}".format(what, x.device))
    if x.dtype not in DTYPE_CODE:
        raise TypeError("{}: the kernel takes float32, bfloat16 or float16, "
                        "got {}".format(what, x.dtype))
    if x.numel() == 0 or (whole_vectors and (cols * x.element_size()) % 16):
        raise ValueError("{}: the kernel takes a non-empty tensor whose last "
                         "dimension is a multiple of 16 bytes, got shape "
                         "{} {}".format(what, tuple(x.shape), x.dtype))
    for t in [x] + [t for t in others if t is not None]:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("{}: tensors must be contiguous and 16-byte "
                             "aligned".format(what))
    return True


def fp32_vector(t):
    """A per-column parameter as the kernels take it: contiguous, 16-byte
    aligned fp32 (a copy when the tensor is not)."""
    if t is None:
        return None
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
