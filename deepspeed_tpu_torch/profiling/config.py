"""The ``flops_profiler`` block of a ds_config.

Counterpart of ``deepspeed_tpu/profiling/config.py`` (reference
``deepspeed/profiling/config.py`` and ``constants.py``): ``enabled``,
``start_step``, ``end_step``, ``module_depth`` and ``top_modules``, with the
same defaults.
"""

from deepspeed_tpu_torch.runtime.config_utils import get_scalar_param

FLOPS_PROFILER = "flops_profiler"

FLOPS_PROFILER_ENABLED = "enabled"
FLOPS_PROFILER_ENABLED_DEFAULT = False

FLOPS_PROFILER_START_STEP = "start_step"
FLOPS_PROFILER_START_STEP_DEFAULT = 5

FLOPS_PROFILER_END_STEP = "end_step"
FLOPS_PROFILER_END_STEP_DEFAULT = FLOPS_PROFILER_START_STEP_DEFAULT + 1

FLOPS_PROFILER_MODULE_DEPTH = "module_depth"
FLOPS_PROFILER_MODULE_DEPTH_DEFAULT = -1

FLOPS_PROFILER_TOP_MODULES = "top_modules"
FLOPS_PROFILER_TOP_MODULES_DEFAULT = 3


class DeepSpeedFlopsProfilerConfig(object):
    def __init__(self, param_dict):
        self.enabled = None
        self.start_step = None
        self.end_step = None
        self.module_depth = None
        self.top_modules = None

        flops_profiler_dict = param_dict.get(FLOPS_PROFILER, {})
        self._initialize(flops_profiler_dict)

    def _initialize(self, flops_profiler_dict):
        self.enabled = get_scalar_param(flops_profiler_dict,
                                        FLOPS_PROFILER_ENABLED,
                                        FLOPS_PROFILER_ENABLED_DEFAULT)
        self.start_step = get_scalar_param(flops_profiler_dict,
                                           FLOPS_PROFILER_START_STEP,
                                           FLOPS_PROFILER_START_STEP_DEFAULT)
        self.end_step = get_scalar_param(flops_profiler_dict,
                                         FLOPS_PROFILER_END_STEP,
                                         FLOPS_PROFILER_END_STEP_DEFAULT)
        self.module_depth = get_scalar_param(flops_profiler_dict,
                                             FLOPS_PROFILER_MODULE_DEPTH,
                                             FLOPS_PROFILER_MODULE_DEPTH_DEFAULT)
        self.top_modules = get_scalar_param(flops_profiler_dict,
                                            FLOPS_PROFILER_TOP_MODULES,
                                            FLOPS_PROFILER_TOP_MODULES_DEFAULT)

    def repr(self):
        return self.__dict__

    def __repr__(self):
        import json
        return json.dumps(self.__dict__, sort_keys=True, indent=4)
