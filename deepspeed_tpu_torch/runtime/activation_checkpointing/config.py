"""The ``activation_checkpointing`` block of a ds_config.

Counterpart of ``deepspeed_tpu/runtime/activation_checkpointing/config.py``:
the same keys and defaults (``partition_activations``,
``number_checkpoints``, ``contiguous_memory_optimization``,
``synchronize_checkpoint_boundary``, ``profile``, ``cpu_checkpointing``),
read by ``checkpointing.configure`` (``checkpointing.py`` says what each
does here).
"""

import json

from deepspeed_tpu_torch.runtime.config_utils import get_scalar_param

ACT_CHKPT = "activation_checkpointing"

# (json key == attribute name, default): the ds_config.json contract.
_SCHEMA = (
    ("partition_activations", False),
    ("number_checkpoints", None),
    ("contiguous_memory_optimization", False),
    ("synchronize_checkpoint_boundary", False),
    ("profile", False),
    ("cpu_checkpointing", False),
)

ACT_CHKPT_DEFAULT = {key: default for key, default in _SCHEMA}


class DeepSpeedActivationCheckpointingConfig(object):
    def __init__(self, param_dict):
        sub = param_dict.get(ACT_CHKPT, ACT_CHKPT_DEFAULT)
        for key, default in _SCHEMA:
            setattr(self, key, get_scalar_param(sub, key, default))

    def repr(self):
        return self.__dict__

    def __repr__(self):
        return json.dumps(self.__dict__, sort_keys=True, indent=4)
