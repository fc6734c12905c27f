"""FP16_UnfusedOptimizer: the fp16 wrapper's LAMB entry.

Counterpart of ``deepspeed_tpu/runtime/fp16/unfused_optimizer.py``. It
shares ``FP16_Optimizer``'s scaler, overflow skip, clipping and state
dict; ``step_fused_lamb`` adds LAMB's combined scale: when the group sets
``max_grad_norm``, the global norm of the unscaled gradients divides them
by ``max(norm / max_grad_norm, 1)`` before the moment update. ``step``
takes that path for a LAMB inner optimizer (one with ``max_coeff``) or
with ``fused_lamb_legacy``.
"""

import logging

import torch

from deepspeed_tpu_torch.runtime.fp16.fused_optimizer import FP16_Optimizer
from deepspeed_tpu_torch.runtime.utils import clip_grad_norm_, global_norm

logger = logging.getLogger(__name__)


class FP16_UnfusedOptimizer(FP16_Optimizer):
    def __init__(self, init_optimizer, static_loss_scale=1.0,
                 dynamic_loss_scale=False, dynamic_loss_args=None,
                 verbose=True, mpu=None, clip_grad=0.0,
                 fused_lamb_legacy=False):
        super().__init__(init_optimizer, static_loss_scale=static_loss_scale,
                         dynamic_loss_scale=dynamic_loss_scale,
                         dynamic_loss_args=dynamic_loss_args,
                         verbose=verbose, mpu=mpu, clip_grad=clip_grad)
        self.fused_lamb_legacy = fused_lamb_legacy

    @torch.no_grad()
    def step_fused_lamb(self, params, grads, state, closure=None):
        """LAMB step with the overflow skip and ``max_grad_norm``
        pre-clipping; returns (params, state, overflow)."""
        overflow, prev_scale = self._skip_on_overflow(grads, "LAMB step")
        if overflow:
            return params, state, True
        g = self._unscaled(grads, 1.0 / prev_scale)
        group = self.optimizer.param_groups[0]
        max_grad_norm = float(group.get("max_grad_norm", 0.0) or 0.0)
        if max_grad_norm > 0.0:
            coef = torch.clamp(global_norm(g) / max_grad_norm, min=1.0)
            torch._foreach_div_(g, coef.to(g[0].device))
        if self.clip_grad > 0.0:
            clip_grad_norm_(g, self.clip_grad)
        self.optimizer.update(params, g, state, lr=group["lr"],
                              betas=group.get("betas", (0.9, 0.999)))
        return params, state, False

    def step(self, params, grads, state, closure=None):
        if hasattr(self.optimizer, "max_coeff") or self.fused_lamb_legacy:
            return self.step_fused_lamb(params, grads, state,
                                        closure=closure)
        return super().step(params, grads, state, closure=closure)
