"""GPT2Adapter: ``models/generation.py`` behind the adapter protocol.

Counterpart of ``deepspeed_tpu/inference/adapters/gpt2.py``: the one place
inside ``inference/`` that imports ``models.generation``.
"""

import dataclasses
from typing import ClassVar

from deepspeed_tpu_torch.inference.adapters.protocol import ModelAdapter
from deepspeed_tpu_torch.models import generation


@dataclasses.dataclass(frozen=True)
class GPT2Adapter(ModelAdapter):
    """Dense GPT-2 decode: delegates to models/generation.py."""

    gcfg: generation._GenCfg
    name: ClassVar[str] = "gpt2"

    @classmethod
    def from_model(cls, model):
        """Adapter from a GPT2LMHeadModel or GPT2Config."""
        return cls(generation.as_gencfg(getattr(model, "config", model)))

    def cache_spec(self):
        return self.gcfg

    def bind(self, config):
        """Stamp the page length of a paged pool (``inference.paged_kv``)
        into the cache spec; 0 for a dense pool."""
        if config is None:
            return self
        page_len = int(config.kv_page_len) if config.paged_kv else 0
        if page_len == self.gcfg.kv_page_len:
            return self
        return dataclasses.replace(
            self, gcfg=self.gcfg._replace(kv_page_len=page_len))

    def init_cache(self, batch, max_len, dtype=None, device=None):
        return generation.init_cache(self.gcfg, batch, max_len, dtype, device)

    def prefill_append(self, params, ids, cache, n_valid=None):
        return generation.append_forward(params, ids, cache, n_valid=n_valid)

    def decode_step(self, params, tok, cache):
        return generation.decode_step(params, tok, cache)

    def verify_forward(self, params, ids, cache):
        return generation.verify_forward(params, ids, cache)

    def ngram_draft(self, toks, pos, n, k):
        return generation.ngram_draft(toks, pos, n, k)

    def accept_counts(self, draft, choices, ok=None):
        return generation.accept_counts(draft, choices, ok=ok)
