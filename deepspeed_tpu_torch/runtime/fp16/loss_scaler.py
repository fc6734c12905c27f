"""Static and dynamic loss scaling.

Counterpart of ``deepspeed_tpu/runtime/fp16/loss_scaler.py``, with the same
hysteresis and scale window. The scaler state (cur_scale, cur_iter,
hysteresis) is host Python scalars; the engine multiplies the loss by
``loss_scale`` before the backward and checks the gradients for overflow
before the step.
"""

INITIAL_LOSS_SCALE = "init_scale"
SCALE_WINDOW = "scale_window"
DELAYED_SHIFT = "delayed_shift"
MIN_LOSS_SCALE = "min_scale"


class LossScalerBase:
    """Holds cur_scale; the engine multiplies the loss by ``loss_scale``."""

    def __init__(self, cur_scale):
        self.cur_scale = cur_scale

    @property
    def loss_scale(self):
        return self.cur_scale

    def update_scale(self, overflow):
        pass


class LossScaler(LossScalerBase):
    """Static loss scaler."""

    def __init__(self, scale=1):
        super(LossScaler, self).__init__(scale)


class DynamicLossScaler(LossScalerBase):
    """Dynamic loss scaler: ×2 after ``scale_window`` clean iters, ÷2 on
    overflow with hysteresis, floored at ``min_scale``
    (reference loss_scaler.py:91-210).
    """

    def __init__(self,
                 init_scale=2 ** 32,
                 scale_factor=2.0,
                 scale_window=1000,
                 min_scale=1,
                 delayed_shift=1,
                 consecutive_hysteresis=False):
        super(DynamicLossScaler, self).__init__(init_scale)
        self.cur_iter = 0
        self.last_overflow_iter = -1
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.min_scale = min_scale
        self.delayed_shift = delayed_shift
        self.cur_hysteresis = delayed_shift
        self.consecutive_hysteresis = consecutive_hysteresis

    def update_scale(self, overflow):
        if overflow:
            if self.delayed_shift == 1 or self.cur_hysteresis == 1:
                self.cur_scale = max(self.cur_scale / self.scale_factor,
                                     self.min_scale)
            else:
                self.cur_hysteresis -= 1
            self.last_overflow_iter = self.cur_iter
        else:
            if self.consecutive_hysteresis:
                self.cur_hysteresis = self.delayed_shift
            if (self.cur_iter - self.last_overflow_iter) % self.scale_window == 0:
                if not self.consecutive_hysteresis:
                    self.cur_hysteresis = self.delayed_shift
                self.cur_scale *= self.scale_factor
        self.cur_iter += 1


def CreateLossScaler(dynamic_scaling, static_loss_scale, dynamic_loss_args):
    """Build a scaler from ds_config-derived values (reference arg plumbing)."""
    if dynamic_scaling:
        if dynamic_loss_args is None:
            return DynamicLossScaler()
        return DynamicLossScaler(
            init_scale=dynamic_loss_args.get("INITIAL_LOSS_SCALE", 2 ** 32),
            scale_window=dynamic_loss_args.get("SCALE_WINDOW", 1000),
            delayed_shift=dynamic_loss_args.get("DELAYED_SHIFT", 1),
            min_scale=dynamic_loss_args.get("MIN_LOSS_SCALE", 1),
        )
    return LossScaler(scale=static_loss_scale)
