from deepspeed_tpu_torch.inference.config import InferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine, MeshDivergence
from deepspeed_tpu_torch.inference.faults import Fault, FaultPlan, InjectedFault
from deepspeed_tpu_torch.inference.fleet import FleetRequest, ServingFleet
from deepspeed_tpu_torch.inference.frontdoor import (FrontDoor,
                                                     FrontDoorConfig,
                                                     PriorityClass,
                                                     TenantPolicy, TokenStream)
from deepspeed_tpu_torch.inference.kv_hierarchy import PrefixDirectory
from deepspeed_tpu_torch.inference.resilience import (HEALTH_STATES,
                                                      EngineDeadError,
                                                      EngineDraining,
                                                      NumericsError)
from deepspeed_tpu_torch.inference.router import CircuitBreaker, Router
from deepspeed_tpu_torch.inference.scheduler import (QueueFull, Request,
                                                     Scheduler)

__all__ = ["InferenceConfig", "InferenceEngine", "Fault", "FaultPlan",
           "InjectedFault", "FleetRequest", "ServingFleet", "FrontDoor",
           "FrontDoorConfig", "PriorityClass", "TenantPolicy", "TokenStream",
           "PrefixDirectory", "HEALTH_STATES", "EngineDeadError",
           "EngineDraining", "NumericsError", "CircuitBreaker", "Router",
           "QueueFull", "Request", "Scheduler", "MeshDivergence"]
