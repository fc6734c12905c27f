"""Chunked tied-decoder cross-entropy: the LM-head loss.

Counterpart of ``deepspeed_tpu/models/heads.py``. Logits against the tied
``[V, C]`` embedding are computed ``chunk`` tokens at a time, so at most
``chunk x V`` fp32 logits are live at once. The head costs three logit-sized
GEMMs per chunk, not four: the loss is a scalar, so its gradient is known up
to a scalar factor in the forward, which computes dx and dW (accumulated in
fp32 across chunks) beside the loss. The backward is a scalar rescale of
those. A forward under ``torch.no_grad`` computes the loss alone.

The GEMMs are plain products (``torch.mm``) with fp32 results, as the JAX
package leaves them to XLA with ``preferred_element_type=float32``. The
vocabulary is padded to a multiple of 8 for them (pad logits -inf).

The remat variant (``impl="remat"`` or ``DS_TPU_XE_HEAD=remat``, JAX
``_chunked_xe_total_remat``) keeps no gradient from the forward: each
chunk is its own autograd node that saves its inputs only and recomputes
its logits in the backward, so a chunk costs four logit-sized GEMMs
(forward, recompute, dx, dW) and no fp32 ``[V, C]`` dW accumulator lives
through the forward. Autograd sums the chunks' dW in the model dtype, as
the JAX scan's transpose does.
"""

import os

import torch


def _mm_f32(a, b):
    """``a @ b`` with fp32 accumulation and an fp32 result."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _chunk_logits(xi, w, bias_f):
    logits = _mm_f32(xi, w.t())  # [chunk, V] fp32
    if bias_f is not None:
        logits = logits + bias_f
    return logits


class _RematChunkXE(torch.autograd.Function):
    """One chunk's summed supervised-token cross-entropy; the backward
    recomputes the chunk's logits from the saved inputs."""

    @staticmethod
    def forward(ctx, xi, w, bias_f, li, vi, dtype):
        xd = xi.to(dtype)
        logits = _chunk_logits(xd, w, bias_f)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(1, li[:, None])[:, 0]
        ctx.save_for_backward(xi, w, bias_f, li, vi)
        ctx.dtype = dtype
        return ((lse - gold) * vi).sum()

    @staticmethod
    def backward(ctx, g):
        xi, w, bias_f, li, vi = ctx.saved_tensors
        dtype = ctx.dtype
        xd = xi.to(dtype)
        logits = _chunk_logits(xd, w, bias_f)
        lse = torch.logsumexp(logits, dim=-1)
        # g * (softmax - onehot(label)) on supervised rows, in place.
        gv = g * vi
        dl = logits.sub_(lse[:, None]).exp_().mul_(gv[:, None])
        dl.index_put_((torch.arange(xi.shape[0], device=dl.device), li),
                      -gv, accumulate=True)
        dl_cast = dl.to(dtype)
        d_x = d_w = d_b = None
        if ctx.needs_input_grad[0]:
            d_x = (torch.mm(dl_cast, w) if xi.dtype == dtype else
                   _mm_f32(dl_cast, w)).to(xi.dtype)
        if ctx.needs_input_grad[1]:
            d_w = _mm_f32(dl_cast.t(), xd).to(w.dtype)
        if bias_f is not None and ctx.needs_input_grad[2]:
            d_b = dl.sum(dim=0)
        return d_x, d_w, d_b, None, None, None


def _chunked_xe_total_remat(xf, w, bias_f, labels, valid, dtype, chunk):
    """Summed supervised-token XE, chunk by chunk, each chunk recomputed in
    the backward (module docstring)."""
    total = torch.zeros((), dtype=torch.float32, device=xf.device)
    for s0 in range(0, xf.shape[0], chunk):
        s1 = min(s0 + chunk, xf.shape[0])
        total = total + _RematChunkXE.apply(xf[s0:s1], w, bias_f,
                                            labels[s0:s1], valid[s0:s1],
                                            dtype)
    return total


class _ChunkedXE(torch.autograd.Function):
    """Summed supervised-token cross-entropy over row chunks of ``xf``."""

    @staticmethod
    def forward(ctx, xf, w, bias_f, labels, valid, dtype, chunk):
        want_grad = any(ctx.needs_input_grad[:3])
        n = xf.shape[0]
        total = torch.zeros((), dtype=torch.float32, device=xf.device)
        if want_grad:
            dx = torch.empty_like(xf)
            dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
            db = torch.zeros(w.shape[0], dtype=torch.float32,
                             device=w.device) \
                if ctx.needs_input_grad[2] else None
        for s0 in range(0, n, chunk):
            s1 = min(s0 + chunk, n)
            xi = xf[s0:s1].to(dtype)
            li, vi = labels[s0:s1], valid[s0:s1]
            logits = _chunk_logits(xi, w, bias_f)
            lse = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(1, li[:, None])[:, 0]
            total = total + ((lse - gold) * vi).sum()
            if not want_grad:
                continue
            # d(summed loss)/dlogits: (softmax - onehot(label)) on supervised
            # rows, 0 elsewhere; computed in place over the logits.
            dl = logits.sub_(lse[:, None]).exp_().mul_(vi[:, None])
            dl.index_put_((torch.arange(s1 - s0, device=dl.device), li), -vi,
                          accumulate=True)
            dl_cast = dl.to(dtype)
            # A product in x's dtype rounds its fp32 accumulator once, as
            # the fp32 product followed by a cast does.
            dx[s0:s1] = torch.mm(dl_cast, w) if xf.dtype == dtype else \
                _mm_f32(dl_cast, w)
            dw += _mm_f32(dl_cast.t(), xi)
            if db is not None:
                db += dl.sum(dim=0)
        if want_grad:
            ctx.save_for_backward(dx, dw, db)
            ctx.w_dtype = w.dtype
        return total

    @staticmethod
    def backward(ctx, g):
        dx, dw, db = ctx.saved_tensors
        d_x = (g * dx.float()).to(dx.dtype)
        d_w = (g * dw).to(ctx.w_dtype)
        d_b = None if db is None else g * db
        return d_x, d_w, d_b, None, None, None, None


def chunked_tied_softmax_xent(x, wte, labels, dtype, chunk=2048, bias=None,
                              ignore_index=None, reduction="mean", impl=None):
    """Token cross-entropy against a tied ``[V, C]`` embedding decoder.

    x: ``[B, T, C]`` final hidden states; wte: ``[V, C]``; labels: ``[B, T]``
    integer targets, positions equal to ``ignore_index`` (when given)
    excluded from the sum and the count; dtype: the GEMM input dtype (fp32
    accumulation regardless); bias: optional ``[V]`` decoder bias.
    ``reduction="mean"`` returns the scalar mean over supervised tokens,
    ``"sum_count"`` returns (sum, count). ``impl``: "eager" (3 GEMMs a
    chunk, the default) or "remat" (4; module docstring); None reads
    ``DS_TPU_XE_HEAD``."""
    impl = impl or os.environ.get("DS_TPU_XE_HEAD", "eager")
    if impl not in ("eager", "remat"):
        raise ValueError("unknown XE head impl {!r} (eager|remat)".format(impl))
    if reduction not in ("mean", "sum_count"):
        raise ValueError("unknown reduction {!r} (mean|sum_count)".format(
            reduction))
    c = x.shape[-1]
    xf = x.reshape(-1, c)
    vocab = wte.shape[0]
    lf = labels.reshape(-1).to(torch.int64)
    if ignore_index is not None:
        valid = (lf != ignore_index).float()
    else:
        valid = torch.ones(lf.shape, dtype=torch.float32, device=lf.device)
    w = wte.to(dtype)
    bias_f = bias.float() if bias is not None else None
    # Pad the vocabulary to a multiple of 8 (GPT-2's 50257 -> 50264): with
    # an odd leading dimension cuBLAS takes unvectorised (align1) GEMM
    # kernels several times slower. Pad rows of w are 0 and pad logits
    # -inf, so they add exactly nothing to the loss or the gradients.
    pad = -vocab % 8
    if pad:
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
        if bias_f is None:
            bias_f = torch.zeros(vocab, dtype=torch.float32,
                                 device=w.device)
        bias_f = torch.cat([bias_f, torch.full(
            (pad,), float("-inf"), dtype=torch.float32, device=w.device)])
    head = _chunked_xe_total_remat if impl == "remat" else _ChunkedXE.apply
    total = head(xf, w, bias_f, lf.clamp(min=0), valid, dtype, int(chunk))
    count = valid.sum()
    if reduction == "sum_count":
        return total, count
    return total / count.clamp(min=1.0)
