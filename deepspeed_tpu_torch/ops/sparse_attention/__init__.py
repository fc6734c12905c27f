"""Block-sparse attention (mirrors ``deepspeed_tpu.ops.sparse_attention``):
the sparsity configs, kernels K7a/K7b and the modules built on them."""

from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (  # noqa: F401
    BigBirdSparsityConfig, BSLongformerSparsityConfig, DenseSparsityConfig,
    FixedSparsityConfig, SparsityConfig, VariableSparsityConfig)
from deepspeed_tpu_torch.ops.sparse_attention.kernels import (  # noqa: F401
    block_sparse_attention, block_sparse_attention_reference, build_luts)
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (  # noqa: F401
    SparseSelfAttention, sparse_self_attention)
from deepspeed_tpu_torch.ops.sparse_attention.bert_sparse_self_attention \
    import BertSparseSelfAttention  # noqa: F401
from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils import (  # noqa: F401
    SparseAttentionUtils)
