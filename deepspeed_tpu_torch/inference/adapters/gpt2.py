"""GPT2Adapter: ``models/generation.py`` behind the adapter protocol.

Counterpart of ``deepspeed_tpu/inference/adapters/gpt2.py``: the one place
inside ``inference/`` that imports ``models.generation``; the engine, the
fleet and the MoE adapter take the names they need from here.

Over a mesh's 'model' axis the adapter of a rank carries its ``tp``
(``bind``) and serves its shard (``prepare_params``, ``param_shardings``)
as ``generation.serving_rule`` cuts it.
"""

import dataclasses
from typing import Any, ClassVar

import numpy as np

from deepspeed_tpu_torch.analysis.annotations import hot_path
from deepspeed_tpu_torch.inference.adapters.protocol import (ModelAdapter,
                                                             mesh_tp,
                                                             shard_tree)
from deepspeed_tpu_torch.models import generation
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, params_from_jax

# The model source's names the rest of inference/ uses, re-exported from
# the one module that imports it (graftlint's ADAPTER rule).
ServingWeights = generation.ServingWeights
EinsumAttention = generation.EinsumAttention
einsum_attention = generation.einsum_attention
row_parallel = generation.row_parallel
serving_rule = generation.serving_rule


@dataclasses.dataclass(frozen=True)
class GPT2Adapter(ModelAdapter):
    """Dense GPT-2 decode: delegates to models/generation.py."""

    gcfg: generation._GenCfg
    # This rank's model-group context (``bind`` over a mesh), or None.
    tp: Any = dataclasses.field(default=None, compare=False)
    name: ClassVar[str] = "gpt2"

    @classmethod
    def from_model(cls, model, use_flash_decode=None):
        """Adapter from a GPT2LMHeadModel or GPT2Config. Its attention is
        the decode kernels K3-K6 (``use_flash_decode`` None or True); the
        einsum path is the long-context adapter's alone."""
        if use_flash_decode is not None and not use_flash_decode:
            raise NotImplementedError(
                "GPT2Adapter: use_flash_decode=False is not ported: the "
                "stock adapter's one attention path is K3-K6 (the einsum "
                "path serves LongContextAdapter)")
        return cls(generation.as_gencfg(getattr(model, "config", model)))

    @property
    def _attn(self):
        return generation.einsum_attention_of(self.gcfg)

    def cache_spec(self):
        return self.gcfg

    def bind(self, config, mesh=None):
        """Stamp the page length of a paged pool (``inference.paged_kv``)
        into the cache spec (0 for a dense pool), and this rank's ``tp``
        over ``mesh``."""
        adapter = self
        tp = mesh_tp(mesh)
        if tp is not None:
            adapter = dataclasses.replace(adapter, tp=tp)
        if config is None:
            return adapter
        page_len = int(config.kv_page_len) if config.paged_kv else 0
        if page_len == adapter.gcfg.kv_page_len:
            return adapter
        return dataclasses.replace(
            adapter, gcfg=adapter.gcfg._replace(kv_page_len=page_len))

    def prepare_params(self, params, device):
        """A flax GPT-2 tree of numpy arrays as the serving weights (the
        config from the cache spec and the tree's vocabulary); this rank's
        shard under ``tp``."""
        g = self.gcfg
        cfg = GPT2Config(vocab_size=int(np.shape(params["wte"])[0]),
                         n_positions=g.n_positions, n_embd=g.n_embd,
                         n_layer=g.n_layer, n_head=g.n_head,
                         layer_norm_epsilon=g.layer_norm_epsilon,
                         dtype=g.dtype)
        return generation.ServingWeights(params_from_jax(params, cfg, device),
                                         self.tp)

    def param_shardings(self, mesh, params):
        tp = mesh_tp(mesh)
        if tp is None:
            return None
        return shard_tree(params, generation.serving_rule(self.gcfg, tp.size),
                          tp)

    def init_cache(self, batch, max_len, dtype=None, device=None):
        return generation.init_cache(self.gcfg, batch, max_len, dtype, device)

    @hot_path
    def prefill_append(self, params, ids, cache, n_valid=None):
        return generation.append_forward(params, ids, cache, n_valid=n_valid,
                                         attn=self._attn)

    @hot_path
    def decode_step(self, params, tok, cache):
        return generation.decode_step(params, tok, cache, attn=self._attn)

    @hot_path
    def verify_forward(self, params, ids, cache):
        return generation.verify_forward(params, ids, cache, attn=self._attn)

    @hot_path
    def ngram_draft(self, toks, pos, n, k):
        return generation.ngram_draft(toks, pos, n, k)

    @hot_path
    def accept_counts(self, draft, choices, ok=None):
        return generation.accept_counts(draft, choices, ok=ok)
