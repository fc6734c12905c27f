from deepspeed_tpu_torch.inference.adapters.gpt2 import GPT2Adapter
from deepspeed_tpu_torch.inference.adapters.longcontext import \
    LongContextAdapter
from deepspeed_tpu_torch.inference.adapters.moe import MoEAdapter, MoECfg
from deepspeed_tpu_torch.inference.adapters.protocol import ModelAdapter

__all__ = ["ModelAdapter", "GPT2Adapter", "MoEAdapter", "MoECfg",
           "LongContextAdapter"]
