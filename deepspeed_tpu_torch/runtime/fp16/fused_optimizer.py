"""FP16_Optimizer: fp16 training with fp32 master weights and loss scaling.

Counterpart of ``deepspeed_tpu/runtime/fp16/fused_optimizer.py``. The
engine does this itself (``DeepSpeedEngine._take_model_step``); this class
is the standalone API for callers that drive the optimizer by hand. It
wraps an inner optimizer with the ``FusedAdam`` interface (``init_state``,
``update``, ``param_groups``), owns the loss scaler, checks the gradients
for inf/NaN and skips the step (the scaler backs off), unscales and clips,
and updates the fp32 master parameters in place.

As in the JAX package, ``step(params, grads, state)`` returns ``(params,
state, overflow)``; ``params`` are the fp32 masters (a list of tensors),
``grads`` the scaled gradients in any dtype (left unchanged);
``master_copies(params, dtype)`` hands back compute-dtype copies.
"""

import logging

import torch

from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (CreateLossScaler,
                                                          DynamicLossScaler)
from deepspeed_tpu_torch.runtime.utils import clip_grad_norm_, has_overflow

logger = logging.getLogger(__name__)


class FP16_Optimizer(object):
    def __init__(self, init_optimizer, static_loss_scale=1.0,
                 dynamic_loss_scale=False, initial_dynamic_scale=2 ** 32,
                 dynamic_loss_args=None, verbose=True, mpu=None,
                 clip_grad=0.0, fused_adam_legacy=False):
        self.optimizer = init_optimizer
        self.fused_adam_legacy = fused_adam_legacy
        self.clip_grad = clip_grad
        self.mpu = mpu
        self.verbose = verbose
        if dynamic_loss_scale:
            args = dict(dynamic_loss_args or {})
            args.setdefault("init_scale", initial_dynamic_scale)
            self.loss_scaler = DynamicLossScaler(**args)
        else:
            self.loss_scaler = CreateLossScaler(
                dynamic_scaling=False, static_loss_scale=static_loss_scale,
                dynamic_loss_args=None)
        self.overflow = False
        self.skipped_steps = 0

    @property
    def cur_scale(self):
        return self.loss_scaler.loss_scale

    def backward(self, loss, create_graph=False, retain_graph=False):
        """The scaled loss, ``loss * cur_scale``: the caller backpropagates
        it (as the JAX package's caller differentiates it)."""
        return loss * self.loss_scaler.loss_scale

    def init_state(self, params):
        return self.optimizer.init_state(params)

    @staticmethod
    def master_copies(params, dtype):
        """The masters cast to the compute dtype (new tensors)."""
        return [p.detach().to(dtype) for p in params]

    def _unscaled(self, grads, inv_scale):
        return [g.float() * inv_scale for g in grads]

    def _skip_on_overflow(self, grads, what):
        """Check, update the scaler; True (and counted) when skipping."""
        self.overflow = bool(has_overflow(grads))
        prev_scale = self.cur_scale
        self.loss_scaler.update_scale(self.overflow)
        if self.overflow:
            self.skipped_steps += 1
            if self.verbose:
                logger.info("[deepspeed] OVERFLOW! Skipping %s. Attempted "
                            "loss scale: %s, reducing to %s", what,
                            prev_scale, self.cur_scale)
        return self.overflow, prev_scale

    @torch.no_grad()
    def step(self, params, grads, state, closure=None):
        """One step over scaled gradients; returns (params, state,
        overflow). On overflow nothing is updated and the scale drops."""
        overflow, prev_scale = self._skip_on_overflow(grads, "step")
        if overflow:
            return params, state, True
        g = self._unscaled(grads, 1.0 / prev_scale)
        if self.clip_grad > 0.0:
            clip_grad_norm_(g, self.clip_grad)
        group = self.optimizer.param_groups[0]
        self.optimizer.update(params, g, state, lr=group["lr"],
                              betas=group.get("betas", (0.9, 0.999)))
        return params, state, False

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    def state_dict(self):
        sd = {"dynamic_loss_scale": isinstance(self.loss_scaler,
                                               DynamicLossScaler),
              "cur_scale": self.loss_scaler.cur_scale,
              "skipped_steps": self.skipped_steps,
              "overflow": self.overflow,
              "clip_grad": self.clip_grad}
        if isinstance(self.loss_scaler, DynamicLossScaler):
            for k in ("cur_iter", "last_overflow_iter", "scale_factor",
                      "scale_window"):
                sd[k] = getattr(self.loss_scaler, k)
        if hasattr(self.optimizer, "state_dict"):
            sd["optimizer_state_dict"] = self.optimizer.state_dict()
        return sd

    def load_state_dict(self, sd, load_optimizer_states=True):
        self.loss_scaler.cur_scale = sd.get("cur_scale",
                                            self.loss_scaler.cur_scale)
        self.skipped_steps = sd.get("skipped_steps", 0)
        self.overflow = sd.get("overflow", False)
        self.clip_grad = sd.get("clip_grad", self.clip_grad)
        if isinstance(self.loss_scaler, DynamicLossScaler):
            for k in ("cur_iter", "last_overflow_iter", "scale_factor",
                      "scale_window"):
                if k in sd:
                    setattr(self.loss_scaler, k, sd[k])
        if load_optimizer_states and "optimizer_state_dict" in sd and \
                hasattr(self.optimizer, "load_state_dict"):
            self.optimizer.load_state_dict(sd["optimizer_state_dict"])
