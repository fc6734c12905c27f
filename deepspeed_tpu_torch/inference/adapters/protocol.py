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
(a no-op for GPT-2, as in the JAX package). ``aux_state`` names extra
pool-resident state under ``aux_`` keys (the MoE adapter's expert-load
counters): global, not per slot, threaded through every step program in
the cache dict, copied into the step's one harvest read and excluded from
slot records (``inference/kv_pool.py``). ``prepare_params`` turns the
parameter tree an engine is given without a model into what the forward
reads.

Speculation adds three methods: ``verify_forward`` scores a slot's frontier
token and its drafts in one forward without moving the frontier,
``ngram_draft`` drafts from the slot's own tokens, and ``accept_counts``
applies the accept rule.

Over a mesh (``parallel/mesh.Mesh``) the engine runs one process per rank,
and "sharded" means "this rank's shard": ``bind(config, mesh)`` returns
the adapter of this rank (its ``tp``, the model group's ``TPContext``, or
None: replicated), and ``param_shardings(mesh, params)`` cuts this rank's
shard out of a full parameter tree of numpy arrays (``shard_tree``).
"""

import numpy as np

from deepspeed_tpu_torch.parallel import mesh as mesh_lib
from deepspeed_tpu_torch.parallel.tensor_parallel import TPContext


def mesh_tp(mesh):
    """The ``TPContext`` of a serving rank on ``mesh``: its model group
    (None without a process group: the context can cut shards but not
    reduce), mp and model rank; None when the model axis is 1 wide or
    there is no mesh."""
    if mesh is None or mesh_lib.mp_size(mesh) <= 1:
        return None
    return TPContext(mesh.mp_group, mesh_lib.mp_size(mesh), mesh.mp_rank)


def shard_tree(tree, rule, tp, path=()):
    """This rank's shard of a nested dict of arrays: ``rule(path, shape)``
    gives a leaf's (dim, order) on the model axis, or None (replicated);
    ``order(rank, mp)`` the indices the rank holds, or None for the
    contiguous block."""
    out = {}
    for key, val in tree.items():
        here = path + (key,)
        if isinstance(val, dict):
            out[key] = shard_tree(val, rule, tp, here)
            continue
        arr = np.asarray(val)
        cut = rule(here, arr.shape)
        if cut is None:
            out[key] = arr
            continue
        dim, order = cut
        if order is not None:
            idx = order(tp.rank, tp.size).numpy()
        else:
            per = arr.shape[dim] // tp.size
            idx = np.arange(tp.rank * per, (tp.rank + 1) * per)
        out[key] = np.take(arr, idx, axis=dim)
    return out


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

    def bind(self, config, mesh=None):
        """The adapter specialised to an engine's InferenceConfig and this
        rank of ``mesh``; ``self`` when nothing changes (an adapter that
        shards nothing serves replicated on every rank)."""
        return self

    def aux_state(self):
        """Extra pool-resident state: {``aux_``-prefixed name: (shape,
        torch dtype)}, allocated zeroed beside the pool (module
        docstring)."""
        return {}

    def prepare_params(self, params, device):
        """What the forward reads, from a parameter tree of numpy arrays
        (an engine built with ``model=None``)."""
        raise NotImplementedError(
            "{} serves a model's own weights: pass the model".format(
                type(self).__name__))

    def param_shardings(self, mesh, params):
        """This rank's shard of the full parameter tree ``params`` on
        ``mesh``; None when the adapter shards nothing."""
        return None

    def observe(self, snap, registry):
        """Publish adapter gauges from a step's harvest (the host copy of
        the pool's per-slot fields) into a telemetry MetricsRegistry.
        Called once per engine step, after the harvest: host-only, no
        device read. GPT-2 has none."""
        return None
