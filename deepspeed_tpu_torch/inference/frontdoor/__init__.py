"""Streaming, SLO-aware serving front door.

Counterpart of ``deepspeed_tpu/inference/frontdoor/``: the same modules
with the imports changed.

The layer between callers and the engine/fleet surface: per-token
streaming (``FrontDoor.stream``), priority classes with TTFT-budget
admission, per-tenant token-bucket rate limits + a weighted fair queue,
deadline-aware shedding, and batch preemption into the kv_hierarchy's
``swapped`` phase. Composes ONLY primitives that already exist below it
— the scheduler's structured QueueFull, the engine's swap machinery,
the fleet's failover-stitched FleetRequest — and adds no new device
code: it adds no program key and captures no graph, so compile_count
stays what the target's own contract gives (``inference/engine.py``).
"""

from deepspeed_tpu_torch.inference.frontdoor.admission import AdmissionController
from deepspeed_tpu_torch.inference.frontdoor.classes import (
    DEFAULT_CLASSES,
    FrontDoorConfig,
    PriorityClass,
    TenantPolicy,
    TokenBucket,
)
from deepspeed_tpu_torch.inference.frontdoor.frontdoor import (
    FrontDoor,
    FrontDoorHandle,
)
from deepspeed_tpu_torch.inference.frontdoor.stream import TokenStream

__all__ = [
    "AdmissionController",
    "DEFAULT_CLASSES",
    "FrontDoor",
    "FrontDoorConfig",
    "FrontDoorHandle",
    "PriorityClass",
    "TenantPolicy",
    "TokenBucket",
    "TokenStream",
]
