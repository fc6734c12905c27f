"""LongContextAdapter: block-sparse decode past a length threshold.

Counterpart of ``deepspeed_tpu/inference/adapters/longcontext.py``. GPT-2
weights, long-context attention policy: query positions below
``threshold`` use the full causal mask, positions at or past it see only
the fixed local + stride block layout (``FixedSparsityConfig``,
unidirectional, from ``ops/sparse_attention/sparsity_config.py``). The
mask lives in the einsum attention path of ``models/generation.py``
(``_GenCfg.use_flash_decode`` False and its ``sparse_*`` fields), which
this adapter selects; it inherits GPT2Adapter's delegating methods. No
kernel runs on that path: the stock GPT-2 adapter keeps K3-K6.

Composition with the KV hierarchy is config-level: host offload keeps
cold slots' planes off the card while the active window decodes
block-sparse, and a paged pool is gathered back to logical planes before
the mask applies.

The JAX adapter falls back to sequence-parallel dense attention (its
``ring`` mode) when its mesh carries a ``seq`` axis. The port serves on
one card: ``bind`` refuses a mesh, naming the sequence-parallel slice.
"""

import dataclasses
from typing import ClassVar

from deepspeed_tpu_torch.inference.adapters.gpt2 import GPT2Adapter


@dataclasses.dataclass(frozen=True)
class LongContextAdapter(GPT2Adapter):
    """GPT-2 decode with block-sparse attention above a length threshold.
    ``mode`` is always 'block_sparse': the JAX package's 'ring' mode waits
    for sequence parallelism (module docstring)."""

    mode: ClassVar[str] = "block_sparse"
    name: ClassVar[str] = "longcontext"

    @classmethod
    def from_model(cls, model, threshold=4096, block=64, num_local_blocks=4,
                   num_global_blocks=1):
        """Adapter from a GPT2LMHeadModel or GPT2Config. ``threshold`` is
        the query position where attention turns block-sparse; ``block``
        / ``num_local_blocks`` / ``num_global_blocks`` are the
        FixedSparsityConfig geometry. The einsum attention path is forced
        on: the sparse mask needs it."""
        if threshold <= 0:
            raise ValueError("threshold must be > 0, got {}".format(threshold))
        gcfg = GPT2Adapter.from_model(model).gcfg
        return cls(gcfg._replace(use_flash_decode=False,
                                 sparse_block=int(block),
                                 sparse_num_local=int(num_local_blocks),
                                 sparse_num_global=int(num_global_blocks),
                                 sparse_threshold=int(threshold)))

    @property
    def threshold(self):
        return self.gcfg.sparse_threshold

    def bind(self, config, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "LongContextAdapter: the ring fallback over a 'seq' mesh "
                "axis is not ported (ROADMAP Queue 1 item 10)")
        adapter = self
        if config is not None and not getattr(config, "sparse_decode", True):
            # The A/B switch: dense einsum decode, threshold 0.
            adapter = dataclasses.replace(
                adapter, gcfg=adapter.gcfg._replace(sparse_threshold=0))
        # The paged stamp, as GPT2Adapter.bind.
        return GPT2Adapter.bind(adapter, config)

    def observe(self, snap, registry):
        registry.gauge("sparse_decode_threshold").set(
            float(self.gcfg.sparse_threshold))
