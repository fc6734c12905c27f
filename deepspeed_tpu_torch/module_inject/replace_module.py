"""Module injection: swap stock BERT layers for the fused
``DeepSpeedTransformerLayer``, and back; swap a BERT's attention for the
block-sparse one.

Counterpart of ``deepspeed_tpu/module_inject/replace_module.py``
(reference ``deepspeed/module_inject/replace_module.py``). The port keeps
the JAX package's form: surgery on the flax-named state, a nested dict
whose leaves are numpy arrays or tensors (``runtime.utils.flax_tree`` gives
one, ``load_flax_tree`` takes one). Each HF-BERT layer subtree (``attention
/ intermediate / output``, flax ``kernel [in, out]``) is packed into the
fused layer's 12 tensors (q, k and v concatenated, ``[out, in]``);
``revert_transformer_layer`` unpacks them bit for bit. The fused layer runs
K1/K2a, K8, K10a/K10b and K11 on the card.

``replace_attn_with_sparse`` keeps the JAX contract: a model that exposes
its attention choice (an ``attention_module`` attribute, as the plain BERT
layers of ``models/bert.py`` do) gets the block-sparse attention of
``BertSparseSelfAttention`` with the given ``SparsityConfig``, and any other
model raises TypeError. Torch modules are mutable, so the swap is in place.
"""

import dataclasses

import numpy as np
import torch

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.ops.transformer import (DeepSpeedTransformerConfig,
                                                 DeepSpeedTransformerLayer)


def _is_hf_bert_layer(tree):
    return (isinstance(tree, dict) and
            {"attention", "intermediate", "output"} <= set(tree.keys()))


def _is_ds_layer(tree):
    return (isinstance(tree, dict) and
            {"attn_qkvw", "inter_w", "norm_w"} <= set(tree.keys()))


def _t(x):
    if isinstance(x, torch.Tensor):
        return x.t().contiguous()
    return np.transpose(np.asarray(x))


def _cat(xs):
    if isinstance(xs[0], torch.Tensor):
        return torch.cat(xs, dim=0)
    return np.concatenate([np.asarray(x) for x in xs], axis=0)


def _split3(x):
    if isinstance(x, torch.Tensor):
        return [p.contiguous() for p in torch.chunk(x, 3, dim=0)]
    return np.split(np.asarray(x), 3, axis=0)


def pack_bert_layer(layer):
    """An HF-BERT layer's subtree -> the fused layer's 12 tensors:
    ``attn_qkvw = cat(q, k, v)`` along the output dimension, every kernel
    turned from flax's ``[in, out]`` to the fused layer's ``[out, in]``."""
    att = layer["attention"]
    sa, ao = att["self"], att["output"]

    def wt(p):
        return _t(p["kernel"])

    return {
        "attn_qkvw": _cat([wt(sa["query"]), wt(sa["key"]), wt(sa["value"])]),
        "attn_qkvb": _cat([sa["query"]["bias"], sa["key"]["bias"],
                           sa["value"]["bias"]]),
        "attn_ow": wt(ao["dense"]),
        "attn_ob": ao["dense"]["bias"],
        "attn_nw": ao["LayerNorm"]["scale"],
        "attn_nb": ao["LayerNorm"]["bias"],
        "inter_w": wt(layer["intermediate"]["dense"]),
        "inter_b": layer["intermediate"]["dense"]["bias"],
        "output_w": wt(layer["output"]["dense"]),
        "output_b": layer["output"]["dense"]["bias"],
        "norm_w": layer["output"]["LayerNorm"]["scale"],
        "norm_b": layer["output"]["LayerNorm"]["bias"],
    }


def unpack_bert_layer(ds):
    """The inverse of ``pack_bert_layer``. Raises ValueError when
    ``attn_qkvw`` is not ``[3 H, H]`` for the layer's width H."""
    h = ds["attn_ow"].shape[0]
    if tuple(ds["attn_qkvw"].shape) != (3 * h, h):
        raise ValueError("attn_qkvw shape {} inconsistent with hidden {}"
                         .format(tuple(ds["attn_qkvw"].shape), h))
    qw, kw, vw = _split3(ds["attn_qkvw"])
    qb, kb, vb = _split3(ds["attn_qkvb"])

    def dense(w_out_in, b):
        return {"kernel": _t(w_out_in), "bias": b}

    return {
        "attention": {
            "self": {
                "query": dense(qw, qb),
                "key": dense(kw, kb),
                "value": dense(vw, vb),
            },
            "output": {
                "dense": dense(ds["attn_ow"], ds["attn_ob"]),
                "LayerNorm": {"scale": ds["attn_nw"], "bias": ds["attn_nb"]},
            },
        },
        "intermediate": {"dense": dense(ds["inter_w"], ds["inter_b"])},
        "output": {
            "dense": dense(ds["output_w"], ds["output_b"]),
            "LayerNorm": {"scale": ds["norm_w"], "bias": ds["norm_b"]},
        },
    }


def replace_module(params, predicate, transform):
    """Wherever ``predicate(subtree)`` holds, ``transform(subtree)``;
    recurse into the other dicts; leave the other leaves as they are."""
    if predicate(params):
        return transform(params)
    if isinstance(params, dict):
        return {k: replace_module(v, predicate, transform)
                for k, v in params.items()}
    return params


def replace_transformer_layer(orig_layer_impl=None, model=None, params=None,
                              micro_batch_size=-1, bert_config=None,
                              seed=-1, max_seq_length=512, preln=False,
                              fp16=True, training=True, dtype=None,
                              device=None):
    """Pack every HF-BERT layer subtree of ``params`` into the fused layer's
    layout. Returns (a ``DeepSpeedTransformerLayer`` for the config, its
    weights left for a loader, and the packed tree): load a layer's subtree
    into it with ``runtime.utils.load_flax_tree``.

    ``bert_config`` needs hidden_size and num_attention_heads, and may give
    intermediate_size, hidden_dropout_prob, attention_probs_dropout_prob and
    num_hidden_layers (HF duck typing, as the reference). The layer computes
    in ``dtype``, by default fp16 with ``fp16`` and fp32 without (the JAX
    package's choice); ``device`` defaults to ``cuda``."""
    if params is None:
        raise ValueError("params tree is required (the layers' weights are "
                         "taken from it)")
    if dtype is None:
        dtype = torch.float16 if fp16 else torch.float32
    cfg = DeepSpeedTransformerConfig(
        batch_size=micro_batch_size,
        hidden_size=bert_config.hidden_size,
        intermediate_size=getattr(bert_config, "intermediate_size",
                                  4 * bert_config.hidden_size),
        heads=bert_config.num_attention_heads,
        attn_dropout_ratio=getattr(bert_config,
                                   "attention_probs_dropout_prob", 0.1),
        hidden_dropout_ratio=getattr(bert_config, "hidden_dropout_prob", 0.1),
        num_hidden_layers=getattr(bert_config, "num_hidden_layers", -1),
        seed=seed,
        fp16=fp16,
        pre_layer_norm=preln,
        training=training,
        dtype=dtype,
    )
    layer = DeepSpeedTransformerLayer(cfg, resolve_device(device), seed=None)
    new_params = replace_module(params, _is_hf_bert_layer, pack_bert_layer)
    return layer, new_params


def revert_transformer_layer(orig_layer_impl=None, model=None, params=None,
                             config=None, preln=False):
    """The inverse swap: every fused-layer subtree back to the HF
    layout."""
    if params is None:
        raise ValueError("params tree is required")
    return replace_module(params, _is_ds_layer, unpack_bert_layer)


def replace_attn_with_sparse(model, max_position, sparsity_config=None):
    """Swap, in place, the attention of every layer of ``model`` that
    exposes its choice (an ``attention_module`` attribute) for the
    block-sparse attention of ``BertSparseSelfAttention`` under
    ``sparsity_config`` (default ``FixedSparsityConfig(num_heads)``), and
    return the model. The layers keep their query/key/value projections, so
    the parameters keep their names; every config the model shares becomes a
    copy with ``sparse_attention_config`` set, so the swapped model computes
    what one built with ``BertConfig(sparse_attention_config=...)`` does.
    ``max_position`` is the reference's argument: the position table is
    not touched (``SparseAttentionUtils.extend_position_embedding`` grows
    it). Raises TypeError for a model whose layers do not expose their
    attention."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        FixedSparsityConfig, SparseSelfAttention)
    layers = [m for m in model.modules()
              if hasattr(m, "attention_module")] \
        if isinstance(model, torch.nn.Module) else []
    if not layers:
        raise TypeError(
            "model {} does not expose an 'attention_module' in its layers; "
            "construct it with BertSparseSelfAttention directly, or as "
            "BertConfig(use_fused_layer=False, sparse_attention_config=...)"
            .format(type(model).__name__))
    old = getattr(model, "config", None)
    sc = sparsity_config or FixedSparsityConfig(
        num_heads=getattr(old, "num_attention_heads", 4))
    copies = {}
    for m in model.modules():
        cfg = getattr(m, "config", None)
        if dataclasses.is_dataclass(cfg) and \
                hasattr(cfg, "sparse_attention_config"):
            if id(cfg) not in copies:
                copies[id(cfg)] = dataclasses.replace(
                    cfg, sparse_attention_config=sc)
            m.config = copies[id(cfg)]
    for m in layers:
        m.attention_module = SparseSelfAttention(sc)
    return model
