"""Module injection and checkpoint import (mirrors
``deepspeed_tpu.module_inject``)."""

from deepspeed_tpu_torch.module_inject.replace_module import (  # noqa: F401
    pack_bert_layer, replace_attn_with_sparse, replace_module,
    replace_transformer_layer, revert_transformer_layer, unpack_bert_layer)
from deepspeed_tpu_torch.module_inject.torch_checkpoint import (  # noqa: F401
    import_bert_state_dict, import_gpt2_state_dict,
    import_reference_checkpoint, load_torch_file)
