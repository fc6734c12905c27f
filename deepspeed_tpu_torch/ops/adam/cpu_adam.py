"""DeepSpeedCPUAdam: host-memory Adam for the ZeRO-Offload tier.

Counterpart of ``deepspeed_tpu/ops/adam/cpu_adam.py``. The update runs in
the host C++ op ``csrc/host/cpu_adam.cpp`` (OpenMP over contiguous fp32
spans, built by ``op_builder.load_host``), called through ctypes, which
releases the GIL for the call. Buffers are contiguous CPU tensors.

- ``step_flat(params, grads, exp_avg, exp_avg_sq, ...)``: one Adam step over
  flat fp32 buffers, in place; ``bf16_out`` (a bfloat16 or 16-bit integer
  tensor) receives the updated parameters rounded to bf16 in the same pass,
  the copy the engine sends back to the card.
- ``l2_norm`` / ``scale_``: the op's ``ds_l2_norm_sq`` and ``ds_scale``.
- ``step()``: the torch-style surface, over ``param_groups`` whose
  parameters are fp32 CPU tensors with ``.grad``; ``fp16_param_groups``
  (bf16 tensors, one per parameter) take the fused copy.

There is no fallback: where the op cannot build, constructing the
optimizer raises. ``adam_step_reference`` is the plain torch version of the
op's arithmetic, for the tests.
"""

import torch

from deepspeed_tpu_torch.op_builder.builder import (float_ptr, load_host,
                                                   u16_ptr)


def _powf(base, step):
    """``powf(float(base), step)`` as C's correctly rounded float pow gives
    it: the float base raised in double, rounded once to fp32."""
    return torch.tensor(float(torch.tensor(base, dtype=torch.float32)) **
                        float(step), dtype=torch.float32)


def adam_step_reference(p, g, m, v, step, lr, beta1=0.9, beta2=0.999,
                        eps=1e-8, weight_decay=0.0, adamw_mode=True,
                        bias_correction=True):
    """The C++ op's arithmetic in plain torch, fp32, in place on ``p``,
    ``m``, ``v``; returns ``p`` rounded to bf16 (the fused copy)."""
    f32 = torch.float32
    one = torch.tensor(1.0, dtype=f32)
    bc1, bc2_sqrt = one, one
    if bias_correction:
        bc1 = one - _powf(beta1, step)
        bc2_sqrt = torch.sqrt(one - _powf(beta2, step))
    step_size = torch.tensor(lr, dtype=f32) / bc1
    b1, b2 = torch.tensor(beta1, dtype=f32), torch.tensor(beta2, dtype=f32)
    grad = g.clone()
    if not adamw_mode and weight_decay > 0.0:
        grad += torch.tensor(weight_decay, dtype=f32) * p
    m.copy_(b1 * m + (one - b1) * grad)
    v.copy_(b2 * v + (one - b2) * grad * grad)
    denom = torch.sqrt(v) / bc2_sqrt + torch.tensor(eps, dtype=f32)
    if adamw_mode and weight_decay > 0.0:
        p -= torch.tensor(lr, dtype=f32) * torch.tensor(weight_decay,
                                                        dtype=f32) * p
    p -= step_size * (m / denom)
    return p.to(torch.bfloat16)


class DeepSpeedCPUAdam(object):
    """Adam/AdamW on host buffers (module docstring)."""

    optimizer_id = 0

    def __init__(self, model_params=None, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 amsgrad=False, adamw_mode=True):
        if amsgrad:
            raise RuntimeError("CPUAdam does not support the AMSGrad "
                               "variant.")
        self.opt_id = DeepSpeedCPUAdam.optimizer_id
        DeepSpeedCPUAdam.optimizer_id += 1
        self.adamw_mode = adamw_mode
        self.bias_correction = bias_correction
        self.param_groups = [{"params": model_params, "lr": lr,
                              "betas": tuple(betas), "eps": eps,
                              "weight_decay": weight_decay}]
        self.defaults = {k: v for k, v in self.param_groups[0].items()
                         if k != "params"}
        self.state = {}
        self._step = 0
        self.ds_opt_adam = load_host("cpu_adam")

    def step_flat(self, params, grads, exp_avg, exp_avg_sq, step=None,
                  lr=None, bf16_out=None):
        """One Adam step over contiguous fp32 CPU tensors of equal length,
        in place. ``step`` defaults to the optimizer's own counter + 1."""
        group = self.param_groups[0]
        if step is None:
            self._step += 1
            step = self._step
        lr = group["lr"] if lr is None else lr
        beta1, beta2 = group["betas"]
        n = params.numel()
        for t in (grads, exp_avg, exp_avg_sq) + \
                (() if bf16_out is None else (bf16_out,)):
            if t.numel() != n:
                raise ValueError("step_flat: buffers of {} and {} "
                                 "elements".format(n, t.numel()))
        args = (step, lr, beta1, beta2, group["eps"], group["weight_decay"],
                int(self.adamw_mode), int(self.bias_correction), n,
                float_ptr(params), float_ptr(grads), float_ptr(exp_avg),
                float_ptr(exp_avg_sq))
        if bf16_out is None:
            self.ds_opt_adam.ds_adam_step(*args)
        else:
            self.ds_opt_adam.ds_adam_step_copy_bf16(*args, u16_ptr(bf16_out))

    def l2_norm(self, t):
        """The 2-norm of a contiguous fp32 CPU tensor (fp64 sum)."""
        return float(self.ds_opt_adam.ds_l2_norm_sq(t.numel(),
                                                     float_ptr(t))) ** 0.5

    def scale_(self, t, alpha):
        """``t *= alpha`` over a contiguous fp32 CPU tensor."""
        self.ds_opt_adam.ds_scale(t.numel(), float(alpha), float_ptr(t))

    def step(self, closure=None, fp16_param_groups=None):
        """One step over every parameter with a ``.grad`` (fp32 CPU
        tensors). ``fp16_param_groups``: per group, a list of bf16 tensors
        that receive the updated parameters (the fused copy)."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._step += 1
        for gi, group in enumerate(self.param_groups):
            for pi, p in enumerate(group.get("params") or []):
                if p.grad is None:
                    continue
                # Keyed by (group, position): stable when the caller
                # rebuilds its parameter list between steps.
                st = self.state.setdefault((gi, pi), {
                    "exp_avg": torch.zeros_like(p),
                    "exp_avg_sq": torch.zeros_like(p)})
                out = None if fp16_param_groups is None else \
                    fp16_param_groups[gi][pi]
                self.step_flat(p.view(-1), p.grad.reshape(-1),
                               st["exp_avg"].view(-1),
                               st["exp_avg_sq"].view(-1), step=self._step,
                               lr=group["lr"],
                               bf16_out=None if out is None else out.view(-1))
        return loss

    def state_dict(self):
        return {"param_groups": [
            {k: v for k, v in g.items() if k != "params"}
            for g in self.param_groups]}

    def load_state_dict(self, sd):
        for group, saved in zip(self.param_groups, sd.get("param_groups", [])):
            group.update(saved)
