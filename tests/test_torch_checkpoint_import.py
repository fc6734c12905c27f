"""Checkpoint import in the port against the JAX package, on the CPU.

GPT-2 and BERT state dicts in the reference's (HuggingFace) names are built
by the test from a tiny port model's weights (made from a seed) and saved
with ``torch.save``: both packages' importers turn them into the same
flax-named trees, leaf for leaf and bit for bit, which are the weights they
came from; the imported GPT-2 gives its source model's logits exactly.
``import_reference_checkpoint`` reads ``latest`` or a given tag,
``load_torch_file`` reads this repo's numpy-pickle files, and a file
without ``"module"`` raises KeyError.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from deepspeed_tpu import module_inject as J
from deepspeed_tpu_torch import module_inject as T
from deepspeed_tpu_torch.models import (BertConfig, BertForPreTraining,
                                        GPT2Config, GPT2LMHeadModel)
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime.utils import flax_tree

torch.set_num_threads(1)


def _gpt2():
    cfg = GPT2Config.tiny(dtype=torch.float32)
    return cfg, GPT2LMHeadModel(cfg, device="cpu")


def hf_gpt2_state_dict(tree):
    """The reference's GPT-2 names (Conv1D weights ``[in, out]``, as flax
    kernels) and the tied ``lm_head``, as torch tensors."""
    sd = {"transformer.wte.weight": tree["wte"],
          "transformer.wpe.weight": tree["wpe"],
          "transformer.ln_f.weight": tree["ln_f"]["scale"],
          "transformer.ln_f.bias": tree["ln_f"]["bias"],
          "lm_head.weight": tree["wte"]}
    i = 0
    while "h_{}".format(i) in tree:
        b, pre = tree["h_{}".format(i)], "transformer.h.{}.".format(i)
        for ln in ("ln_1", "ln_2"):
            sd[pre + ln + ".weight"] = b[ln]["scale"]
            sd[pre + ln + ".bias"] = b[ln]["bias"]
        for blk, names in (("attn", ("c_attn", "c_proj")),
                           ("mlp", ("c_fc", "c_proj"))):
            for n in names:
                sd[pre + blk + "." + n + ".weight"] = b[blk][n]["kernel"]
                sd[pre + blk + "." + n + ".bias"] = b[blk][n]["bias"]
        i += 1
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def hf_bert_state_dict(tree):
    """The reference's BertForPreTraining names (torch Linear ``[out,
    in]``) from a fused-layer flax tree."""
    bert = tree["bert"]
    emb = bert["embeddings"]
    sd = {"bert.embeddings.word_embeddings.weight": emb["word_embeddings"],
          "bert.embeddings.position_embeddings.weight":
              emb["position_embeddings"],
          "bert.embeddings.token_type_embeddings.weight":
              emb["token_type_embeddings"],
          "bert.embeddings.LayerNorm.weight": emb["LayerNorm"]["scale"],
          "bert.embeddings.LayerNorm.bias": emb["LayerNorm"]["bias"],
          "bert.pooler.dense.weight": bert["pooler"]["kernel"].T,
          "bert.pooler.dense.bias": bert["pooler"]["bias"],
          "cls.predictions.transform.dense.weight":
              tree["transform"]["kernel"].T,
          "cls.predictions.transform.dense.bias": tree["transform"]["bias"],
          "cls.predictions.transform.LayerNorm.weight":
              tree["transform_LayerNorm"]["scale"],
          "cls.predictions.transform.LayerNorm.bias":
              tree["transform_LayerNorm"]["bias"],
          "cls.predictions.bias": tree["mlm_bias"],
          "cls.predictions.decoder.weight": emb["word_embeddings"],
          "cls.seq_relationship.weight": tree["seq_relationship"]["kernel"].T,
          "cls.seq_relationship.bias": tree["seq_relationship"]["bias"]}
    i = 0
    while "layer_{}".format(i) in bert:
        ds, pre = bert["layer_{}".format(i)], \
            "bert.encoder.layer.{}.".format(i)
        for n, w, b in zip(("query", "key", "value"),
                           np.split(ds["attn_qkvw"], 3),
                           np.split(ds["attn_qkvb"], 3)):
            sd[pre + "attention.self." + n + ".weight"] = w
            sd[pre + "attention.self." + n + ".bias"] = b
        for path, w, b in (("attention.output.dense", "attn_ow", "attn_ob"),
                           ("attention.output.LayerNorm", "attn_nw",
                            "attn_nb"),
                           ("intermediate.dense", "inter_w", "inter_b"),
                           ("output.dense", "output_w", "output_b"),
                           ("output.LayerNorm", "norm_w", "norm_b")):
            sd[pre + path + ".weight"] = ds[w]
            sd[pre + path + ".bias"] = ds[b]
        i += 1
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def _leaves(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_leaves(val, prefix + key + "."))
        else:
            out[prefix + key] = val
    return out


def _assert_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.dtype == w.dtype == np.float32, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _save(dirname, tag, module, **client):
    os.makedirs(os.path.join(dirname, tag))
    torch.save(dict(client, module=module),
               os.path.join(dirname, tag, "mp_rank_00_model_states.pt"))


def test_gpt2_state_dict_imports_as_jax_does_and_gives_the_same_logits(
        tmp_path):
    cfg, model = _gpt2()
    tree = flax_tree(model)
    sd = hf_gpt2_state_dict(tree)
    got = T.import_gpt2_state_dict(sd)
    _assert_equal(got, J.import_gpt2_state_dict(
        {k: v.numpy() for k, v in sd.items()}))
    _assert_equal(got, tree)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(2, 16)))
    imported = tgpt2.params_from_jax(got, cfg, device="cpu")
    with torch.no_grad():
        assert torch.equal(imported(ids), model(ids))


def test_bert_state_dict_imports_as_jax_does(tmp_path):
    model = BertForPreTraining(BertConfig.tiny(dtype=torch.float32),
                               device="cpu")
    tree = flax_tree(model)
    sd = hf_bert_state_dict(tree)
    path = str(tmp_path / "bert.pt")
    torch.save({"module." + k: v for k, v in sd.items()}, path)
    loaded = T.load_torch_file(path)
    got = T.import_bert_state_dict(loaded)
    _assert_equal(got, J.import_bert_state_dict(J.load_torch_file(path)))
    _assert_equal(got, tree)


@pytest.mark.parametrize("tag", [None, "global_step3"])
def test_reference_checkpoint_with_latest_or_a_tag(tmp_path, tag):
    _, model = _gpt2()
    tree = flax_tree(model)
    d = str(tmp_path)
    _save(d, "global_step3", hf_gpt2_state_dict(tree), global_steps=3,
          lr_scheduler={"last_lr": 1e-4})
    _save(d, "global_step1", {}, global_steps=1)  # not what latest names
    with open(os.path.join(d, "latest"), "w") as f:
        f.write("global_step3")
    params, client = T.import_reference_checkpoint(d, tag=tag)
    jparams, jclient = J.import_reference_checkpoint(d, tag=tag)
    _assert_equal(params, tree)
    _assert_equal(params, jparams)
    assert client == jclient == {"global_steps": 3,
                                 "lr_scheduler": {"last_lr": 1e-4}}


def test_numpy_pickle_files_and_a_missing_module(tmp_path):
    """This repo's own checkpoint files are numpy pickles: they load
    through the same reader; a file without 'module' raises KeyError, as
    in JAX, and so does a state dict without its blocks."""
    d = tmp_path / "ck"
    os.makedirs(d / "t")
    with open(d / "t" / "mp_rank_00_model_states.pt", "wb") as f:
        pickle.dump({"module": {"w": np.arange(3.0)}, "global_steps": 2}, f)
    got = T.load_torch_file(str(d / "t" / "mp_rank_00_model_states.pt"))
    np.testing.assert_array_equal(got["module"]["w"], np.arange(3.0))
    with open(d / "t" / "mp_rank_00_model_states.pt", "wb") as f:
        pickle.dump({"global_steps": 2}, f)
    for imp in (T, J):
        with pytest.raises(KeyError, match="module"):
            imp.import_reference_checkpoint(str(d), tag="t")
        with pytest.raises(KeyError):
            imp.import_gpt2_state_dict({"wte.weight": np.zeros((8, 4)),
                                        "wpe.weight": np.zeros((8, 4)),
                                        "ln_f.weight": np.ones(4),
                                        "ln_f.bias": np.zeros(4)})
