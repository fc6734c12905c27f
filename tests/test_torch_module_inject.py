"""Module injection in the port against the JAX package, on the CPU in fp32.

The same HF-BERT layer trees (numpy, from a seed) go through both
packages' ``pack_bert_layer`` / ``unpack_bert_layer`` /
``revert_transformer_layer``: every packed and reverted leaf is equal bit
for bit. The fused layer that ``replace_transformer_layer`` returns, loaded
with the packed tree, gives JAX's replaced layer's output and gradients
within 1e-5 of each tensor's max-abs. A dense BERT whose attention
``replace_model_self_attention_with_sparse_self_attention`` swaps computes
the loss and the gradients of a BERT built with ``sparse_attention_config``
bit for bit, and JAX's sparse BERT's loss within 1e-5 relative (its
Pallas kernels in interpret mode). A model that does not expose its
attention raises TypeError.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import module_inject as J
from deepspeed_tpu.models.bert import BertConfig as JBertConfig
from deepspeed_tpu.models.bert import BertForPreTraining as JBert
from deepspeed_tpu_torch import module_inject as T
from deepspeed_tpu_torch.models import BertConfig, BertForPreTraining
from deepspeed_tpu_torch.models.bert import params_from_jax
from deepspeed_tpu_torch.ops.sparse_attention import (
    FixedSparsityConfig, SparseAttentionUtils)
from deepspeed_tpu_torch.runtime.utils import load_flax_tree

torch.set_num_threads(1)

TOL = 1e-5
H, INTER, HEADS = 32, 64, 4


@dataclasses.dataclass
class HFBertConfig:
    hidden_size: int = H
    num_attention_heads: int = HEADS
    intermediate_size: int = INTER
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0
    num_hidden_layers: int = 2


def _hf_layer(seed, h=H, inter=INTER):
    rng = np.random.RandomState(seed)

    def dense(i, o):
        return {"kernel": (rng.randn(i, o) * 0.02).astype(np.float32),
                "bias": (rng.randn(o) * 0.01).astype(np.float32)}

    def ln():
        return {"scale": (1 + 0.1 * rng.randn(h)).astype(np.float32),
                "bias": (0.1 * rng.randn(h)).astype(np.float32)}

    return {"attention": {"self": {"query": dense(h, h), "key": dense(h, h),
                                   "value": dense(h, h)},
                          "output": {"dense": dense(h, h), "LayerNorm": ln()}},
            "intermediate": {"dense": dense(h, inter)},
            "output": {"dense": dense(inter, h), "LayerNorm": ln()}}


def _leaves(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_leaves(val, prefix + key + "."))
        else:
            out[prefix + key] = val
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for name in want:
        g, w = _np(got[name]), _np(want[name])
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _close(got, want, tol=TOL, msg=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * scale,
                               rtol=0, err_msg=msg)


def _tensors(tree):
    return {k: _tensors(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("leaves", ["numpy", "tensor"])
def test_pack_unpack_and_revert_equal_jax_bit_for_bit(leaves):
    hf = {"encoder": {"layer_0": _hf_layer(0), "layer_1": _hf_layer(1)},
          "pooler": {"kernel": np.ones((H, H), np.float32)}}
    src = hf if leaves == "numpy" else _tensors(hf)
    packed = T.pack_bert_layer(src["encoder"]["layer_0"])
    want = jax.tree_util.tree_map(
        np.asarray, J.pack_bert_layer(hf["encoder"]["layer_0"]))
    _assert_trees_equal(packed, want)
    assert tuple(packed["attn_qkvw"].shape) == (3 * H, H)
    _assert_trees_equal(T.unpack_bert_layer(packed), jax.tree_util.tree_map(
        np.asarray, J.unpack_bert_layer(want)))
    cfg = HFBertConfig()
    _, tree = T.replace_transformer_layer(params=src, bert_config=cfg,
                                          device="cpu")
    _, jtree = J.replace_transformer_layer(params=hf, bert_config=cfg)
    _assert_trees_equal(tree, jax.tree_util.tree_map(np.asarray, jtree))
    _assert_trees_equal(T.revert_transformer_layer(params=tree), hf)
    with pytest.raises(ValueError, match="inconsistent"):
        T.unpack_bert_layer(dict(packed, attn_qkvw=packed["attn_qkvw"][:H]))


def test_replace_module_on_nested_trees():
    tree = {"a": {"x": 1}, "b": {"target": True, "v": 2},
            "c": {"d": {"target": True, "v": 3}, "e": [4]}}
    out = T.replace_module(tree,
                           lambda t: isinstance(t, dict) and t.get("target"),
                           lambda t: {"replaced": t["v"]})
    assert out == J.replace_module(
        tree, lambda t: isinstance(t, dict) and t.get("target"),
        lambda t: {"replaced": t["v"]})
    assert out["b"] == {"replaced": 2} and out["c"]["d"] == {"replaced": 3}
    assert out["a"] == {"x": 1} and out["c"]["e"] == [4]
    with pytest.raises(ValueError, match="params"):
        T.replace_transformer_layer(bert_config=HFBertConfig())


def test_replaced_layer_forward_and_grads_match_jax():
    """The port's fused layer, loaded with the packed tree, against JAX's
    replaced layer: output, input gradient and every parameter gradient
    within 1e-5 of their max-abs, with a padding mask."""
    cfg = HFBertConfig()
    hf = {"encoder": {"layer_0": _hf_layer(3)}}
    jlayer, jtree = J.replace_transformer_layer(
        params=hf, bert_config=cfg, fp16=False, training=False)
    layer, tree = T.replace_transformer_layer(
        params=hf, bert_config=cfg, fp16=False, training=False, device="cpu")
    assert layer.config.dtype == torch.float32 and not layer.config.training
    load_flax_tree(layer, tree["encoder"]["layer_0"])
    rng = np.random.RandomState(4)
    x = rng.randn(2, 16, H).astype(np.float32)
    mask = np.zeros((2, 16), np.float32)
    mask[1, 11:] = -1e9
    w = rng.randn(2, 16, H).astype(np.float32)

    def jloss(p, xx):
        out = jlayer.apply({"params": p}, xx, jnp.asarray(mask),
                           deterministic=True)
        return jnp.sum(out * w), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        jtree["encoder"]["layer_0"], jnp.asarray(x))
    layer.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = layer(xt, torch.from_numpy(mask), deterministic=True)
    (out * torch.from_numpy(w)).sum().backward()
    _close(out.detach().numpy(), jout)
    _close(xt.grad.numpy(), jgx, msg="x")
    for name, p in layer.named_parameters():
        _close(p.grad.numpy(), jgp[name], msg=name)


def _sparse_configs():
    from deepspeed_tpu.ops.sparse_attention import FixedSparsityConfig as JF
    kw = dict(use_fused_layer=False, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
    return (JBertConfig.tiny(dtype=jnp.float32, sparse_attention_config=JF(
                num_heads=4, block=32, num_local_blocks=2), **kw),
            BertConfig.tiny(dtype=torch.float32, **kw))


def _batch(seq=128):
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 1024, size=(2, seq))
    mask = np.ones((2, seq), np.int64)
    mask[1, 100:] = 0
    types = np.zeros((2, seq), np.int64)
    types[:, seq // 2:] = 1
    labels = np.where(rng.rand(2, seq) < 0.15, ids, -1)
    labels[:, 1] = ids[:, 1]
    return ids, mask, types, labels, rng.randint(0, 2, size=(2,))


def test_sparse_swap_equals_config_built_model_and_jax():
    """The swapped dense BERT's loss and gradients equal the config-built
    sparse BERT's bit for bit; its loss is JAX's sparse BERT's within 1e-5
    relative."""
    jcfg, dense_cfg = _sparse_configs()
    batch = _batch()
    params = jax.tree_util.tree_map(np.asarray, JBert(jcfg).init(
        jax.random.PRNGKey(0), *(jnp.asarray(a) for a in batch))["params"])
    jloss = JBert(jcfg).apply({"params": params},
                              *(jnp.asarray(a) for a in batch))
    sc = FixedSparsityConfig(num_heads=4, block=32, num_local_blocks=2)
    built = params_from_jax(params, dataclasses.replace(
        dense_cfg, sparse_attention_config=sc), device="cpu")
    swapped = params_from_jax(params, dense_cfg, device="cpu")
    out = SparseAttentionUtils \
        .replace_model_self_attention_with_sparse_self_attention(
            swapped, 128, sc)
    assert out is swapped
    assert dense_cfg.sparse_attention_config is None  # the caller's config
    assert swapped.config.sparse_attention_config is sc
    assert swapped.bert.layer_0.config is swapped.config
    losses = []
    for model in (built, swapped):
        model.requires_grad_(True)
        loss = model(*(torch.from_numpy(a) for a in batch))
        loss.backward()
        losses.append(loss.detach())
    assert torch.equal(losses[0], losses[1])
    for (name, a), (_, b) in zip(built.named_parameters(),
                                 swapped.named_parameters()):
        assert torch.equal(a.grad, b.grad), name
    np.testing.assert_allclose(float(losses[1]), float(jloss), rtol=TOL)


def test_swap_raises_for_a_model_without_the_field():
    """JAX raises TypeError for a model that does not expose its attention;
    so does the port, for a BERT on the fused layer and for any object."""
    fused = BertForPreTraining(BertConfig.tiny(dtype=torch.float32),
                               device="cpu")
    for model in (fused, object()):
        with pytest.raises(TypeError, match="attention_module"):
            T.replace_attn_with_sparse(model, 128)
    with pytest.raises(TypeError, match="attention_module"):
        J.replace_attn_with_sparse(object(), 128)
