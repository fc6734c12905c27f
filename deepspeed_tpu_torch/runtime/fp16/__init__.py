from deepspeed_tpu_torch.runtime.fp16.fused_optimizer import FP16_Optimizer
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (CreateLossScaler,
                                                          DynamicLossScaler,
                                                          LossScaler,
                                                          LossScalerBase)
from deepspeed_tpu_torch.runtime.fp16.unfused_optimizer import (
    FP16_UnfusedOptimizer)

__all__ = ["CreateLossScaler", "DynamicLossScaler", "FP16_Optimizer",
           "FP16_UnfusedOptimizer", "LossScaler", "LossScalerBase"]
