"""DeepSpeedCPULamb: host-memory LAMB for the ZeRO-Offload tier.

Counterpart of ``deepspeed_tpu/ops/lamb/cpu_lamb.py``. The update runs in
the host C++ op ``csrc/host/cpu_lamb.cpp`` (built by
``op_builder.load_host``), through ctypes, with the ``DeepSpeedCPUAdam``
``step_flat`` contract, so the engine's offload pipeline drives it
unchanged. LAMB's trust ratio is a per-tensor statistic: ``step_flat``
takes ``segments``, a list of (offset, size) spans, each one parameter
tensor with its own ratio (one span over the whole buffer by default).
``get_lamb_coeffs()`` returns every ratio of the latest step, across the
engine's chunked calls.

Over ranks that each hold a shard of a tensor (ZeRO's partition over the
data group, tensor parallelism's over the model group) a shard's norms are
not the tensor's. The engine then sets ``norm_reduce`` (the sums of
squares of every rank's shard of each tensor, added over its groups) and
the offload step runs the op's two passes apart: ``norms_flat`` (the
moments, the update vector into a scratch buffer, each span's sums of
squares), one ``norm_reduce`` for the whole step, ``ratio`` per tensor,
then ``apply_flat``. At one rank the two passes are the one-pass op, bit
for bit.

There is no fallback: where the op cannot build, constructing the
optimizer raises. ``lamb_step_reference`` is the plain torch version of the
op's arithmetic, for the tests.
"""

import ctypes

import torch

from deepspeed_tpu_torch.op_builder.builder import (float_ptr, load_host,
                                                   u16_ptr)


def _powf(base, step):
    """``powf(float(base), step)`` as C's correctly rounded float pow gives
    it: the float base raised in double, rounded once to fp32."""
    return torch.tensor(float(torch.tensor(base, dtype=torch.float32)) **
                        float(step), dtype=torch.float32)


def lamb_step_reference(p, g, m, v, step, lr, beta1=0.9, beta2=0.999,
                        eps=1e-8, weight_decay=0.0, bias_correction=True,
                        max_coeff=10.0, min_coeff=0.01):
    """The C++ op's arithmetic on one tensor in plain torch (fp32, the norms
    summed in fp64), in place on ``p``, ``m``, ``v``; returns the trust
    ratio."""
    f32 = torch.float32
    one = torch.tensor(1.0, dtype=f32)
    bc1, bc2 = one, one
    if bias_correction:
        bc1 = one - _powf(beta1, step)
        bc2 = one - _powf(beta2, step)
    b1, b2 = torch.tensor(beta1, dtype=f32), torch.tensor(beta2, dtype=f32)
    m.copy_(b1 * m + (one - b1) * g)
    v.copy_(b2 * v + (one - b2) * g * g)
    upd = (m * (one / bc1)) / (torch.sqrt(v) * (one / torch.sqrt(bc2)) +
                               torch.tensor(eps, dtype=f32))
    if weight_decay > 0.0:
        upd = upd + torch.tensor(weight_decay, dtype=f32) * p
    w_sq = float((p.double() ** 2).sum())
    u_sq = float((upd.double() ** 2).sum())
    ratio = 1.0
    if w_sq > 0.0 and u_sq > 0.0:
        ratio = min(max(float(torch.tensor(w_sq ** 0.5 / u_sq ** 0.5,
                                           dtype=f32)), min_coeff),
                    max_coeff)
    p -= torch.tensor(lr, dtype=f32) * torch.tensor(ratio, dtype=f32) * upd
    return ratio


class DeepSpeedCPULamb(object):
    """LAMB on host buffers (module docstring)."""

    supports_segments = True
    optimizer_id = 0

    def __init__(self, model_params=None, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 max_coeff=10.0, min_coeff=0.01, amsgrad=False):
        if amsgrad:
            raise RuntimeError("CPULamb does not support the AMSGrad "
                               "variant.")
        self.opt_id = DeepSpeedCPULamb.optimizer_id
        DeepSpeedCPULamb.optimizer_id += 1
        self.bias_correction = bias_correction
        self.max_coeff = float(max_coeff)
        self.min_coeff = float(min_coeff)
        self.param_groups = [{"params": model_params, "lr": lr,
                              "betas": tuple(betas), "eps": eps,
                              "weight_decay": weight_decay}]
        self.defaults = {k: v for k, v in self.param_groups[0].items()
                         if k != "params"}
        self.state = {}
        self._step = 0
        self.lamb_coeffs = []
        self._coeffs_step = None  # the step lamb_coeffs belong to
        self._scratch = torch.empty(0, dtype=torch.float32)
        self.ds_opt_lamb = load_host("cpu_lamb")
        self.norm_reduce = None

    def step_flat(self, params, grads, exp_avg, exp_avg_sq, step=None,
                  lr=None, bf16_out=None, segments=None):
        """One LAMB step over contiguous fp32 CPU tensors, in place, one
        trust ratio per (offset, size) span of ``segments``."""
        group = self.param_groups[0]
        if step is None:
            self._step += 1
            step = self._step
        lr = group["lr"] if lr is None else lr
        n = params.numel()
        if segments is None:
            segments = [(0, n)]
        # The engine calls step_flat once per transfer chunk with the same
        # step: the ratios of one step accumulate across those calls.
        if step != self._coeffs_step:
            self.lamb_coeffs = []
            self._coeffs_step = step
        for off, size in segments:
            if off < 0 or off + size > n:
                raise ValueError("step_flat: segment ({}, {}) outside {} "
                                 "elements".format(off, size, n))
            sl = slice(off, off + size)
            self.lamb_coeffs.append(self._step_span(
                params[sl], grads[sl], exp_avg[sl], exp_avg_sq[sl], step,
                lr, None if bf16_out is None else bf16_out[sl]))

    def _step_span(self, p, g, m, v, step, lr, bf16_out):
        group = self.param_groups[0]
        beta1, beta2 = group["betas"]
        n = p.numel()
        if self._scratch.numel() < n:
            self._scratch = torch.empty(n, dtype=torch.float32)
        return float(self.ds_opt_lamb.ds_lamb_step(
            step, lr, beta1, beta2, group["eps"], group["weight_decay"],
            int(self.bias_correction), self.max_coeff, self.min_coeff, n,
            float_ptr(p), float_ptr(g), float_ptr(m), float_ptr(v),
            float_ptr(self._scratch[:n]), u16_ptr(bf16_out)))

    def norms_flat(self, params, grads, exp_avg, exp_avg_sq, scratch, step,
                   segments):
        """Pass 1 over each (offset, size) span of ``segments``: m and v in
        place, the update vector into ``scratch`` (``params``' length);
        returns the spans' [||p||^2, ||update||^2] as a float64 [n, 2]
        tensor."""
        group = self.param_groups[0]
        beta1, beta2 = group["betas"]
        out = torch.zeros(len(segments), 2, dtype=torch.float64)
        for k, (off, size) in enumerate(segments):
            sl = slice(off, off + size)
            self.ds_opt_lamb.ds_lamb_norms(
                step, beta1, beta2, group["eps"], group["weight_decay"],
                int(self.bias_correction), size, float_ptr(params[sl]),
                float_ptr(grads[sl]), float_ptr(exp_avg[sl]),
                float_ptr(exp_avg_sq[sl]), float_ptr(scratch[sl]),
                ctypes.cast(out[k].data_ptr(),
                            ctypes.POINTER(ctypes.c_double)))
        return out

    def ratio(self, w_sq, u_sq):
        """A tensor's trust ratio from its (summed) squares: the op's own
        rounding and clamp."""
        return float(self.ds_opt_lamb.ds_lamb_ratio(
            float(w_sq), float(u_sq), self.max_coeff, self.min_coeff))

    def apply_flat(self, params, scratch, ratios, lr, segments,
                   bf16_out=None):
        """Pass 2: each span of ``segments`` moves by ``lr`` times its
        ratio (``ratios``, one per span) times pass 1's update."""
        for (off, size), r in zip(segments, ratios):
            sl = slice(off, off + size)
            self.ds_opt_lamb.ds_lamb_apply(
                lr, r, size, float_ptr(params[sl]), float_ptr(scratch[sl]),
                u16_ptr(None if bf16_out is None else bf16_out[sl]))

    def get_lamb_coeffs(self):
        return list(self.lamb_coeffs)

    def step(self, closure=None):
        """One step over every parameter with a ``.grad`` (fp32 CPU
        tensors), each its own trust-ratio domain."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._step += 1
        self.lamb_coeffs = []
        self._coeffs_step = self._step
        for gi, group in enumerate(self.param_groups):
            for pi, p in enumerate(group.get("params") or []):
                if p.grad is None:
                    continue
                st = self.state.setdefault((gi, pi), {
                    "exp_avg": torch.zeros_like(p),
                    "exp_avg_sq": torch.zeros_like(p)})
                self.lamb_coeffs.append(self._step_span(
                    p.view(-1), p.grad.reshape(-1), st["exp_avg"].view(-1),
                    st["exp_avg_sq"].view(-1), self._step, group["lr"],
                    None))
        return loss

    def state_dict(self):
        return {"param_groups": [
            {k: v for k, v in g.items() if k != "params"}
            for g in self.param_groups]}

    def load_state_dict(self, sd):
        for group, saved in zip(self.param_groups, sd.get("param_groups", [])):
            group.update(saved)
