"""Import torch-format checkpoints of the reference (DeepSpeed or
HuggingFace) into the flax-named trees the port's models load.

Counterpart of ``deepspeed_tpu/module_inject/torch_checkpoint.py``. A
reference user brings either a DeepSpeed save directory (``latest`` and
``<tag>/mp_rank_XX_model_states.pt``, whose ``"module"`` entry is the
model's ``state_dict()``) or a bare HF state dict. The importers return
nested dicts of numpy arrays under the JAX package's names, which
``models.gpt2.params_from_jax`` and ``models.bert.params_from_jax`` take.

GPT-2 (HF ``GPT2LMHeadModel``): the tree mirrors HF's names (wte, wpe,
h_N/{ln_1, attn/{c_attn, c_proj}, ln_2, mlp/{c_fc, c_proj}}, ln_f); HF's
Conv1D weight is ``[in, out]``, a flax kernel's layout, so nothing is
transposed; LayerNorm ``weight`` becomes ``scale``; ``lm_head.weight`` is
tied to ``wte`` and dropped.

``load_torch_file`` reads torch's serialization and this repo's own
numpy-pickle checkpoint files (the JAX package's and the port's engines
write those): a file format, so a file torch cannot read is tried as a
pickle.
"""

import os
import pickle
import re
import zipfile

import numpy as np
import torch

__all__ = [
    "load_torch_file",
    "import_bert_state_dict",
    "import_gpt2_state_dict",
    "import_reference_checkpoint",
]


def load_torch_file(path):
    """Load a checkpoint file with every tensor as a numpy array: torch's
    zipfile (``torch.save``) or legacy serialization, or this repo's
    numpy-pickle files. A zipfile torch rejects raises torch's error."""
    if zipfile.is_zipfile(path):
        obj = torch.load(path, map_location="cpu", weights_only=False)
        return _to_numpy(obj)
    try:
        # Legacy torch serialization has no cheap magic check.
        obj = torch.load(path, map_location="cpu", weights_only=False)
        return _to_numpy(obj)
    except (pickle.UnpicklingError, RuntimeError, ValueError) as torch_err:
        try:
            with open(path, "rb") as f:
                return pickle.load(f)
        except Exception as e:
            raise e from torch_err


def _to_numpy(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16
            t = t.float()
        return t.numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def _strip_prefixes(state_dict, prefixes=("module.", "transformer.")):
    """Drop wrapper prefixes ('module.' from DDP-style wrapping,
    'transformer.' from GPT2LMHeadModel) so keys start at the model root;
    tensors become numpy arrays."""
    out = {}
    for key, val in state_dict.items():
        for pre in prefixes:
            if key.startswith(pre):
                key = key[len(pre):]
        out[key] = _to_numpy(val)
    return out


def import_gpt2_state_dict(state_dict, dtype=np.float32):
    """An HF-style GPT-2 ``state_dict`` -> the flax-named tree
    ``models.gpt2.params_from_jax`` takes (numpy leaves). Raises KeyError
    for a missing entry: a partial load would train from garbage."""
    sd = _strip_prefixes(state_dict)
    params = {
        "wte": np.asarray(sd["wte.weight"], dtype),
        "wpe": np.asarray(sd["wpe.weight"], dtype),
        "ln_f": {
            "scale": np.asarray(sd["ln_f.weight"], dtype),
            "bias": np.asarray(sd["ln_f.bias"], dtype),
        },
    }
    layer_ids = sorted({
        int(m.group(1))
        for m in (re.match(r"h\.(\d+)\.", k) for k in sd)
        if m
    })
    if not layer_ids:
        raise KeyError("no transformer blocks (h.N.*) in state dict")
    for i in layer_ids:
        pre = "h.{}.".format(i)
        params["h_{}".format(i)] = {
            "ln_1": {
                "scale": np.asarray(sd[pre + "ln_1.weight"], dtype),
                "bias": np.asarray(sd[pre + "ln_1.bias"], dtype),
            },
            "attn": {
                # HF Conv1D weight is [in, out] == flax Dense kernel.
                "c_attn": {
                    "kernel": np.asarray(sd[pre + "attn.c_attn.weight"],
                                         dtype),
                    "bias": np.asarray(sd[pre + "attn.c_attn.bias"], dtype),
                },
                "c_proj": {
                    "kernel": np.asarray(sd[pre + "attn.c_proj.weight"],
                                         dtype),
                    "bias": np.asarray(sd[pre + "attn.c_proj.bias"], dtype),
                },
            },
            "ln_2": {
                "scale": np.asarray(sd[pre + "ln_2.weight"], dtype),
                "bias": np.asarray(sd[pre + "ln_2.bias"], dtype),
            },
            "mlp": {
                "c_fc": {
                    "kernel": np.asarray(sd[pre + "mlp.c_fc.weight"], dtype),
                    "bias": np.asarray(sd[pre + "mlp.c_fc.bias"], dtype),
                },
                "c_proj": {
                    "kernel": np.asarray(sd[pre + "mlp.c_proj.weight"],
                                         dtype),
                    "bias": np.asarray(sd[pre + "mlp.c_proj.bias"], dtype),
                },
            },
        }
    return params


def import_bert_state_dict(state_dict, dtype=np.float32):
    """An HF-style BERT ``state_dict`` (BertForPreTraining naming) ->
    the flax-named tree ``models.bert.params_from_jax`` takes for the
    fused encoder (``use_fused_layer=True``).

    torch Linear weights are ``[out, in]``, the fused layer's orientation
    (``attn_qkvw = cat(q, k, v)`` along the output dimension, as
    ``replace_module.pack_bert_layer`` packs it), so the encoder's weights
    copy without a transpose; the flax Dense heads (pooler, transform,
    seq_relationship) are transposed. ``cls.predictions.decoder.weight`` is tied to the word
    embeddings and dropped; ``cls.predictions.bias`` becomes mlm_bias."""
    sd = _strip_prefixes(state_dict, prefixes=("module.",))

    def arr(key):
        return np.asarray(sd[key], dtype)

    def linear_t(prefix):  # torch Linear -> flax Dense
        return {"kernel": arr(prefix + ".weight").T,
                "bias": arr(prefix + ".bias")}

    bert = {
        "embeddings": {
            "word_embeddings": arr("bert.embeddings.word_embeddings.weight"),
            "position_embeddings": arr(
                "bert.embeddings.position_embeddings.weight"),
            "token_type_embeddings": arr(
                "bert.embeddings.token_type_embeddings.weight"),
            "LayerNorm": {
                "scale": arr("bert.embeddings.LayerNorm.weight"),
                "bias": arr("bert.embeddings.LayerNorm.bias"),
            },
        },
        "pooler": linear_t("bert.pooler.dense"),
    }
    layer_ids = sorted({
        int(m.group(1))
        for m in (re.match(r"bert\.encoder\.layer\.(\d+)\.", k) for k in sd)
        if m
    })
    if not layer_ids:
        raise KeyError("no encoder layers (bert.encoder.layer.N.*) in "
                       "state dict")
    for i in layer_ids:
        pre = "bert.encoder.layer.{}.".format(i)
        bert["layer_{}".format(i)] = {
            "attn_qkvw": np.concatenate(
                [arr(pre + "attention.self.query.weight"),
                 arr(pre + "attention.self.key.weight"),
                 arr(pre + "attention.self.value.weight")], axis=0),
            "attn_qkvb": np.concatenate(
                [arr(pre + "attention.self.query.bias"),
                 arr(pre + "attention.self.key.bias"),
                 arr(pre + "attention.self.value.bias")]),
            "attn_ow": arr(pre + "attention.output.dense.weight"),
            "attn_ob": arr(pre + "attention.output.dense.bias"),
            "attn_nw": arr(pre + "attention.output.LayerNorm.weight"),
            "attn_nb": arr(pre + "attention.output.LayerNorm.bias"),
            "inter_w": arr(pre + "intermediate.dense.weight"),
            "inter_b": arr(pre + "intermediate.dense.bias"),
            "output_w": arr(pre + "output.dense.weight"),
            "output_b": arr(pre + "output.dense.bias"),
            "norm_w": arr(pre + "output.LayerNorm.weight"),
            "norm_b": arr(pre + "output.LayerNorm.bias"),
        }
    return {
        "bert": bert,
        "transform": linear_t("cls.predictions.transform.dense"),
        "transform_LayerNorm": {
            "scale": arr("cls.predictions.transform.LayerNorm.weight"),
            "bias": arr("cls.predictions.transform.LayerNorm.bias"),
        },
        "mlm_bias": arr("cls.predictions.bias"),
        "seq_relationship": linear_t("cls.seq_relationship"),
    }


def import_reference_checkpoint(load_dir, tag=None, mp_rank=0,
                                importer=import_gpt2_state_dict,
                                dtype=np.float32):
    """Load a reference DeepSpeed save directory into a flax-named tree.

    Reads the tag from ``latest`` when ``tag`` is None, then
    ``<tag>/mp_rank_XX_model_states.pt``, and converts its ``"module"``
    state dict with ``importer``. Returns (params, client_state), the
    client state holding the file's other entries (global_steps, the LR
    scheduler, ...). Raises KeyError when the file has no ``"module"``."""
    if tag is None:
        with open(os.path.join(load_dir, "latest")) as f:
            tag = f.read().strip()
    path = os.path.join(load_dir, str(tag),
                        "mp_rank_{:02d}_model_states.pt".format(mp_rank))
    ckpt = load_torch_file(path)
    module = ckpt.get("module")
    if module is None:
        raise KeyError("{} has no 'module' entry".format(path))
    params = importer(module, dtype=dtype)
    client = {k: v for k, v in ckpt.items() if k != "module"}
    return params, client
