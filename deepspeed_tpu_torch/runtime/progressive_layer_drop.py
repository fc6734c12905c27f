"""The progressive layer drop schedule.

Counterpart of ``deepspeed_tpu/runtime/progressive_layer_drop.py`` (the
reference's): theta(t) = (1 - theta_bar) exp(-gamma t) + theta_bar. The
engine passes ``progressive_layer_drop=True, pld_theta=get_theta()`` to
each forward and advances the schedule at every model step.
"""

import numpy as np

from deepspeed_tpu_torch.utils.logging import logger


class ProgressiveLayerDrop(object):
    def __init__(self, theta=0.5, gamma=0.001):
        super().__init__()
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0
        logger.info("Enabled progressive layer dropping (theta = %s)", theta)

    def get_state(self):
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}

    def get_theta(self):
        return self.current_theta

    def update_state(self, global_step):
        def _prob(x, gamma, p):
            return (1.0 - p) * np.exp(-gamma * x) + p

        self.current_theta = _prob(global_step, self.gamma, self.theta)
