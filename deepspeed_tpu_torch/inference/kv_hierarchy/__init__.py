"""deepspeed_tpu_torch.inference.kv_hierarchy: the KV memory tiers.

Counterpart of ``deepspeed_tpu/inference/kv_hierarchy/``, int8 tier only:
the k/v planes hold int8 codes with fp32 per-(head, position) scales
(``ops/transformer/kernels/decode_attention.quantize_kv``), attended by
kernels K4 (dense) and K6 (paged). The shared-prefix cache and host
offload come with a later slice: the config keys that switch them on raise
NotImplementedError.
"""

from deepspeed_tpu_torch.inference.kv_hierarchy.hierarchy import (  # noqa: F401
    HierarchySpec,
    KVHierarchy,
    spec_from_config,
)
