from deepspeed_tpu_torch.moe.layer import Experts, MoE
from deepspeed_tpu_torch.moe.sharded_moe import top1gating, top2gating
from deepspeed_tpu_torch.moe.utils import (is_moe_param_path,
                                           split_moe_param_groups)

__all__ = ["MoE", "Experts", "top1gating", "top2gating",
           "is_moe_param_path", "split_moe_param_groups"]
