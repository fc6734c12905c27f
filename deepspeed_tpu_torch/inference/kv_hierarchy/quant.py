"""int8 KV quantization, re-exported from the decode-attention kernel
module, where the math lives (``models/generation.py`` imports that module;
an import in the other direction would be circular). Counterpart of
``deepspeed_tpu/inference/kv_hierarchy/quant.py``: symmetric per-(head,
position) absmax scaling, see ``quantize_kv`` / ``dequantize_kv`` there.
"""

from deepspeed_tpu_torch.ops.transformer.kernels.decode_attention import (  # noqa: F401,E501
    dequantize_kv,
    quantize_kv,
)
