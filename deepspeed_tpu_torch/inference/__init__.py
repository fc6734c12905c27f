from deepspeed_tpu_torch.inference.config import InferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.inference.faults import Fault, FaultPlan, InjectedFault
from deepspeed_tpu_torch.inference.resilience import (HEALTH_STATES,
                                                      EngineDeadError,
                                                      EngineDraining,
                                                      NumericsError)
from deepspeed_tpu_torch.inference.scheduler import (QueueFull, Request,
                                                     Scheduler)

__all__ = ["InferenceConfig", "InferenceEngine", "Fault", "FaultPlan",
           "InjectedFault", "HEALTH_STATES", "EngineDeadError",
           "EngineDraining", "NumericsError", "QueueFull", "Request",
           "Scheduler"]
