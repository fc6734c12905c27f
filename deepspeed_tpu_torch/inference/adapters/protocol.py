"""ModelAdapter: the engine<->model contract.

Counterpart of ``deepspeed_tpu/inference/adapters/protocol.py``. The serving
engine never imports a model module; every model computation it performs
goes through these methods. ``params`` is whatever the adapter's model
holds its weights in (for GPT-2, the port's ``GPT2LMHeadModel``).

Contract kept from the JAX package: the cache is a dict with per-row
frontier ``pos`` [B] and k/v planes ``[layers, B, heads, plane_len,
head_dim]`` (or, paged, page arenas with a ``block_tbl``; int8 planes come
with ``k_scale``/``v_scale``: see ``inference/kv_pool.py``); positions past
a row's frontier may hold garbage that is masked or overwritten before the
frontier reaches them; and row b's logits depend only on row b's tokens and
frontier.

``observe`` publishes an adapter's own gauges after each step's harvest
(a no-op for GPT-2, as in the JAX package).

Speculation adds three methods: ``verify_forward`` scores a slot's frontier
token and its drafts in one forward without moving the frontier,
``ngram_draft`` drafts from the slot's own tokens, and ``accept_counts``
applies the accept rule.
"""


class ModelAdapter:
    """Base protocol: the engine calls only these methods on the model."""

    name = "adapter"

    def cache_spec(self):
        """Shape/dtype spec of the KV cache (``n_layer / n_head / n_embd /
        n_positions / dtype / layer_norm_epsilon / kv_page_len``, the last
        > 0 when the engine serves a paged pool)."""
        raise NotImplementedError

    def init_cache(self, batch, max_len, dtype=None, device=None):
        """Zeroed cache dict for ``batch`` rows of plane length
        ``max_len`` on ``device`` (default ``cuda``)."""
        raise NotImplementedError

    def prefill_append(self, params, ids, cache, n_valid=None):
        """Append ``ids`` [B, S] at each row's frontier; the frontier
        advances by ``n_valid`` [B] (default S). Returns (fp32 logits
        [B, S, V], advanced cache)."""
        raise NotImplementedError

    def decode_step(self, params, tok, cache):
        """Feed ``tok`` [B] at each row's frontier. Returns (fp32 logits
        [B, V], advanced cache)."""
        raise NotImplementedError

    def verify_forward(self, params, ids, cache):
        """Score ``ids`` [B, S] at each row's frontier, writing their k/v,
        WITHOUT advancing it. Returns (fp32 logits [B, S, V], cache with
        ``pos`` unchanged)."""
        raise NotImplementedError

    def ngram_draft(self, toks, pos, n, k):
        """Draft ``k`` tokens per row from the token ring ``toks`` [B, T]
        up to each frontier ``pos`` [B] by ``n``-gram lookup. Returns
        int64 [B, k]."""
        raise NotImplementedError

    def accept_counts(self, draft, choices, ok=None):
        """Tokens accepted per row, 1..K+1, from drafts [B, K] and the
        model's choices [B, K+1]; ``ok`` vetoes agreement."""
        raise NotImplementedError

    def bind(self, config):
        """The adapter specialised to an engine's InferenceConfig; ``self``
        when nothing changes."""
        return self

    def observe(self, snap, registry):
        """Publish adapter gauges from a step's harvest (the host copy of
        the pool's per-slot fields) into a telemetry MetricsRegistry.
        Called once per engine step, after the harvest: host-only, no
        device read. GPT-2 has none."""
        return None
