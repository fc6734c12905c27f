from deepspeed_tpu_torch.models.bert import (BertConfig, BertForPreTraining,
                                             BertModel)
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, GPT2LMHeadModel,
                                             params_from_jax)

__all__ = ["BertConfig", "BertForPreTraining", "BertModel", "GPT2Config",
           "GPT2LMHeadModel", "params_from_jax"]
