"""Port parity for BERT pretraining on the CPU, in fp32.

A tiny ``BertForPreTraining`` is initialised in flax and carried into the
port (``params_from_jax`` or ``model_parameters``). The same numpy batch
(token ids, a 1/0 padding mask, token types, MLM labels with -1 where not
predicted, NSP labels) goes through both. At dropout 0 the MLM + NSP loss
agrees within 1e-5 relative and every gradient within 1e-5 of its tensor's
max-abs, for the fused layer and the plain one; so does a five-step engine
loss trace, and checkpoints load across the packages. At dropout 0.1 the
port's masks are its own (Philox), so the port is held to training
behaviour: a finite loss that falls, and no dropout in ``eval()``. Sparse
BERT (the plain layer on block-sparse attention, T = 128 at blocks of 32)
matches the JAX package's Pallas kernels in interpret mode in both backward
modes: the loss within 1e-5 relative, every gradient within 1e-4 of its
tensor's max-abs, and a three-step engine loss trace.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.models.bert import BertConfig as JConfig
from deepspeed_tpu.models.bert import BertForPreTraining as JModel
from deepspeed_tpu.models.bert import BertModel as JBertModel
from deepspeed_tpu.parallel import mesh as mesh_lib
from deepspeed_tpu_torch.models import (BertConfig, BertForPreTraining,
                                        BertModel)
from deepspeed_tpu_torch.models.bert import params_from_jax
from deepspeed_tpu_torch.runtime.utils import load_flax_tree

torch.set_num_threads(1)

TOL = 1e-5
SEQ = 32
NO_DROPOUT = {"hidden_dropout_prob": 0.0,
              "attention_probs_dropout_prob": 0.0}


def _close(got, want, tol=TOL, msg=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * scale,
                               rtol=0, err_msg=msg)


def _batch(n, seed, vocab=1024, seq=SEQ):
    """(ids, mask, token types, MLM labels, NSP labels) as BERT pretraining
    feeds them: every other row padded after a random length, 15% of the
    real positions predicted, token type 1 on the second half."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, size=(n, seq))
    mask = np.ones((n, seq), np.int64)
    for row in range(0, n, 2):
        mask[row, rng.randint(seq // 4, seq):] = 0
    types = np.zeros((n, seq), np.int64)
    types[:, seq // 2:] = 1
    labels = np.where((rng.rand(n, seq) < 0.15) & (mask == 1), ids, -1)
    labels[:, 1] = ids[:, 1]  # at least one predicted position per row
    nsp = rng.randint(0, 2, size=(n,))
    return ids, mask, types, labels, nsp


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, prefix + key + "."))
        else:
            out[prefix + key] = np.asarray(val)
    return out


_PARAMS = {}


def _jax_params(fused=True):
    """Fresh device arrays each call: the JAX engine donates its parameter
    buffers."""
    if fused not in _PARAMS:
        cfg = JConfig.tiny(dtype=jnp.float32, use_fused_layer=fused,
                           **NO_DROPOUT)
        batch = [jnp.asarray(a) for a in _batch(2, 0)]
        _PARAMS[fused] = _tree(JModel(cfg).init(jax.random.PRNGKey(0),
                                                *batch)["params"])
    return jax.tree_util.tree_map(jnp.asarray, _PARAMS[fused])


def _port_config(**over):
    return BertConfig.tiny(dtype=torch.float32, **dict(NO_DROPOUT, **over))


@pytest.mark.parametrize("fused", [True, False])
def test_pretraining_loss_and_every_grad_match_jax(fused):
    params = _jax_params(fused)
    jmodel = JModel(JConfig.tiny(dtype=jnp.float32, use_fused_layer=fused,
                                 **NO_DROPOUT))
    batch = _batch(4, 1)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.apply({"params": p},
                               *(jnp.asarray(a) for a in batch)))(params)
    model = params_from_jax(_tree(params),
                            _port_config(use_fused_layer=fused), device="cpu")
    model.requires_grad_(True)
    loss = model(*(torch.from_numpy(a) for a in batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    want = _flat(_tree(jgrads))
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    largest = max(float(np.abs(w).max()) for w in want.values())
    for name in want:
        if name.endswith("key.bias"):
            # Zero in exact arithmetic (a row's scores all shift by q.b, and
            # softmax ignores a shift): both packages give rounding noise.
            for g in (got[name], want[name]):
                assert float(np.abs(g).max()) < TOL * largest, name
            continue
        _close(got[name], want[name], msg=name)


def test_logits_without_labels_match_jax():
    params = _jax_params()
    ids, mask, types, _, _ = _batch(2, 2)
    jmodel = JModel(JConfig.tiny(dtype=jnp.float32, **NO_DROPOUT))
    jlogits, jnsp = jmodel.apply({"params": params}, jnp.asarray(ids),
                                 jnp.asarray(mask), jnp.asarray(types))
    model = params_from_jax(_tree(params), _port_config(), device="cpu")
    with torch.no_grad():
        logits, nsp = model(torch.from_numpy(ids), torch.from_numpy(mask),
                            torch.from_numpy(types))
    assert logits.dtype == torch.float32 and logits.shape == (2, SEQ, 1024)
    _close(logits.numpy(), jlogits)
    _close(nsp.numpy(), jnsp)


def test_encoder_matches_jax_and_ignores_padded_tokens():
    """``BertModel`` (sequence output, pooled [CLS], the word table) from
    the JAX package's encoder parameters; the content of padded positions
    does not reach the real ones."""
    ids, mask, types, _, _ = _batch(2, 3)
    jmodel = JBertModel(JConfig.tiny(dtype=jnp.float32, **NO_DROPOUT))
    jargs = [jnp.asarray(a) for a in (ids, mask, types)]
    params = _tree(jmodel.init(jax.random.PRNGKey(1), *jargs)["params"])
    jseq, jpooled, _ = jmodel.apply({"params": params}, *jargs)
    model = BertModel(_port_config(), device="cpu", seed=None)
    load_flax_tree(model, params)
    ids2 = np.where(mask == 1, ids, (ids + 7) % 1024)
    with torch.no_grad():
        seq, pooled, wte = model(*(torch.from_numpy(a)
                                   for a in (ids, mask, types)))
        seq2, _, _ = model(*(torch.from_numpy(a) for a in (ids2, mask, types)))
    _close(seq.numpy(), jseq)
    _close(pooled.numpy(), jpooled)
    assert wte is model.embeddings.word_embeddings
    real = torch.from_numpy(mask == 1)
    torch.testing.assert_close(seq2[real], seq[real], rtol=0, atol=1e-6)
    assert not torch.equal(seq2, seq)
    again = BertModel(_port_config(), device="cpu", seed=4)
    assert float(again.pooler.kernel.std()) == pytest.approx(0.02, rel=0.05)


def test_config_sizes_and_unported_paths():
    for name in ("bert_base", "bert_large", "tiny"):
        ours, theirs = getattr(BertConfig, name)(), getattr(JConfig, name)()
        fields = [f.name for f in dataclasses.fields(JConfig)
                  if f.name != "dtype"]
        assert [getattr(ours, f) for f in fields] == \
            [getattr(theirs, f) for f in fields]
        assert ours.num_params() == theirs.num_params()
    ids = torch.zeros(1, 8, dtype=torch.int64)
    # Sequence-shardable without a seq line: serial (the JAX model outside
    # shard_map), the plain model's logits.
    plain = BertForPreTraining(_port_config(use_fused_layer=False),
                               device="cpu")
    sharded = BertForPreTraining(_port_config(sequence_parallel_axis="seq",
                                              use_fused_layer=False),
                                 device="cpu")
    sharded.load_state_dict(plain.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(sharded(ids)[0], plain(ids)[0], rtol=0,
                                   atol=0)
    # The JAX package's configuration errors, in its order.
    for over, match in (({"sequence_parallel_axis": "seq"}, "sequence_par"),
                        ({"sparse_attention_config": object()},
                         "use_fused_layer=False"),
                        ({"sparse_attention_config": object(),
                          "sequence_parallel_axis": "seq",
                          "use_fused_layer": False}, "sequence paral")):
        with pytest.raises(ValueError, match=match):
            BertForPreTraining(_port_config(**over), device="cpu")(ids)
    if not torch.cuda.is_available():  # the default device is the GPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BertForPreTraining(_port_config())


CONFIG = {"train_batch_size": 4, "steps_per_print": 100,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 1e-2, "weight_decay": 0.01}},
          "scheduler": {"type": "WarmupLR",
                        "params": {"warmup_min_lr": 1e-3,
                                   "warmup_max_lr": 1e-2,
                                   "warmup_num_steps": 3}},
          "gradient_clipping": 1.0}


def _jax_engine(params):
    mesh = mesh_lib.build_mesh(num_dp=1, devices=jax.devices()[:1])
    return jds.initialize(model=JModel(JConfig.tiny(dtype=jnp.float32,
                                                    **NO_DROPOUT)),
                          model_parameters=params, config_params=CONFIG,
                          mesh=mesh)[0]


def _port_engine(params, **over):
    return tds.initialize(
        model=BertForPreTraining(_port_config(**over), device="cpu",
                                 seed=None),
        model_parameters=_tree(params), config_params=CONFIG,
        device="cpu")[0]


def _step(engine, seed):
    """forward/backward/step on one batch (the loop of DeepSpeed's BERT
    example): the mask as integers, the labels as given."""
    ids, mask, types, labels, nsp = _batch(4, seed)
    loss = engine(ids, mask, types, labels, nsp)
    engine.backward(loss)
    engine.step()
    return float(loss.detach() if isinstance(loss, torch.Tensor) else loss)


def test_engine_five_step_loss_trace_matches_jax():
    params = _jax_params()
    jeng, teng = _jax_engine(params), _port_engine(params)
    jl = [_step(jeng, 10 + i % 2) for i in range(5)]
    tl = [_step(teng, 10 + i % 2) for i in range(5)]
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert jl[-1] < jl[0]
    assert teng.global_steps == jeng.global_steps == 5


def test_engine_trains_with_dropout_and_evaluates_without():
    """At dropout 0.1 (the BertConfig default) the engine turns dropout on
    and seeds it from its generator: the loss is finite and falls on a
    repeated batch, two training forwards differ, ``train_batch`` equals
    forward/backward/step, and ``eval()`` turns dropout off."""
    params = _jax_params()
    over = {"hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1}
    a, b = _port_engine(params, **over), _port_engine(params, **over)
    batch = _batch(4, 20)
    losses = []
    for _ in range(8):
        losses.append(float(a.train_batch(batch=batch)))
        assert _step(b, 20) == losses[-1]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    for p, q in zip(a.module.parameters(), b.module.parameters()):
        assert torch.equal(p, q)
    with torch.no_grad():
        assert float(a(*batch)) != float(a(*batch))
    a.eval()
    assert float(a(*batch)) == float(a(*batch))


def test_embeddings_dropout_is_the_kernels_function():
    """The embeddings' dropout is K10a's function of the seed (the same
    mask on the CPU and the card): zero exactly where the mask drops, the
    plain embeddings times 1 / (1 - rate) elsewhere; no seed, no dropout."""
    from deepspeed_tpu_torch.ops.transformer.kernels import dropout as tdrop
    cfg = BertConfig.tiny(dtype=torch.float32, hidden_dropout_prob=0.25)
    emb = BertModel(cfg, device="cpu", seed=0).embeddings
    ids, _, types, _, _ = (torch.from_numpy(a) for a in _batch(2, 5))
    with torch.no_grad():
        plain, _ = emb(ids, types)
        dropped, _ = emb(ids, types, seed=123)
    assert torch.equal(dropped, tdrop.dropout_reference(plain, 0.25, 123))
    keep = tdrop.dropout_mask(plain.shape, 0.25, 123, "cpu")
    assert bool((dropped[~keep] == 0).all()) and bool((~keep).any())
    assert not torch.equal(dropped, plain)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_loads_across_packages(tmp_path, direction):
    """Two steps in one package, save; a fresh engine of the other package
    loads it; the next steps' losses match the saver's own."""
    params = _jax_params()
    src, dst = _jax_engine(params), _port_engine(params)
    if direction == "port_to_jax":
        src, dst = dst, src
    for i in range(2):
        _step(src, i)
    src.save_checkpoint(str(tmp_path), tag="bert2")
    path, client = dst.load_checkpoint(str(tmp_path))
    assert path is not None and client == {}
    assert dst.global_steps == src.global_steps == 2
    want = [_step(src, i) for i in range(2, 4)]
    got = [_step(dst, i) for i in range(2, 4)]
    np.testing.assert_allclose(got, want, rtol=TOL)


# Sparse BERT: the plain layer on block-sparse attention (kernels K7a/K7b on
# the card, their plain versions here), at T = 128 with blocks of 32.
SPARSE_SEQ = 128


def _sparse_configs(**over):
    from deepspeed_tpu.ops.sparse_attention import FixedSparsityConfig as JF
    from deepspeed_tpu_torch.ops.sparse_attention import (
        FixedSparsityConfig as TF)
    kw = dict(use_fused_layer=False, **dict(NO_DROPOUT, **over))
    return (JConfig.tiny(dtype=jnp.float32, sparse_attention_config=JF(
                num_heads=4, block=32, num_local_blocks=2), **kw),
            BertConfig.tiny(dtype=torch.float32, sparse_attention_config=TF(
                num_heads=4, block=32, num_local_blocks=2), **kw))


_SPARSE_PARAMS = {}


def _sparse_jax_params():
    if not _SPARSE_PARAMS:
        jcfg, _ = _sparse_configs()
        batch = [jnp.asarray(a) for a in _batch(2, 0, seq=SPARSE_SEQ)]
        _SPARSE_PARAMS["p"] = _tree(JModel(jcfg).init(
            jax.random.PRNGKey(0), *batch)["params"])
    return jax.tree_util.tree_map(jnp.asarray, _SPARSE_PARAMS["p"])


@pytest.mark.parametrize("bwd", ["fused", "split"])
def test_sparse_pretraining_loss_and_every_grad_match_jax(monkeypatch, bwd):
    """The loss within 1e-5 relative and every gradient within 1e-4 of its
    tensor's max-abs, the JAX side on its Pallas kernels in interpret
    mode (both backward modes), the port on the plain versions."""
    monkeypatch.setenv("DS_TPU_FLASH_BWD", bwd)
    jcfg, tcfg = _sparse_configs()
    params = _sparse_jax_params()
    batch = _batch(2, 1, seq=SPARSE_SEQ)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JModel(jcfg).apply({"params": p},
                                     *(jnp.asarray(a) for a in batch)))(
        params)
    model = params_from_jax(_tree(params), tcfg, device="cpu")
    model.requires_grad_(True)
    loss = model(*(torch.from_numpy(a) for a in batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    want = _flat(_tree(jgrads))
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    largest = max(float(np.abs(w).max()) for w in want.values())
    for name in want:
        if name.endswith("key.bias"):  # zero in exact arithmetic, as above
            for g in (got[name], want[name]):
                assert float(np.abs(g).max()) < 1e-4 * largest, name
            continue
        _close(got[name], want[name], tol=1e-4, msg=name)


def test_sparse_engine_three_step_loss_trace_matches_jax():
    jcfg, tcfg = _sparse_configs()
    params = _sparse_jax_params()
    mesh = mesh_lib.build_mesh(num_dp=1, devices=jax.devices()[:1])
    sparse_config = dict(CONFIG, sparse_attention={"mode": "fixed",
                                                   "block": 32})
    jeng = jds.initialize(model=JModel(jcfg), model_parameters=params,
                          config_params=sparse_config, mesh=mesh)[0]
    teng = tds.initialize(
        model=BertForPreTraining(tcfg, device="cpu", seed=None),
        model_parameters=_tree(params), config_params=sparse_config,
        device="cpu")[0]
    assert teng.sparse_attention() == jeng.sparse_attention()

    def step(engine, seed):
        ids, mask, types, labels, nsp = _batch(4, seed, seq=SPARSE_SEQ)
        loss = engine(ids, mask, types, labels, nsp)
        engine.backward(loss)
        engine.step()
        return float(loss.detach() if isinstance(loss, torch.Tensor)
                     else loss)

    jl = [step(jeng, 30 + i % 2) for i in range(3)]
    tl = [step(teng, 30 + i % 2) for i in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert jl[-1] < jl[0]


def test_sparse_bert_trains_with_dropout_on_the_context():
    """At dropout 0.1 the sparse layer's attention dropout is K10a's on the
    context output: the loss is finite and falls, two training forwards
    differ, and eval() is deterministic."""
    _, tcfg = _sparse_configs(hidden_dropout_prob=0.1,
                              attention_probs_dropout_prob=0.1)
    engine = tds.initialize(
        model=BertForPreTraining(tcfg, device="cpu", seed=0),
        config_params=CONFIG, device="cpu")[0]
    batch = _batch(4, 40, seq=SPARSE_SEQ)
    losses = [float(engine.train_batch(batch=batch)) for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    with torch.no_grad():
        assert float(engine(*batch)) != float(engine(*batch))
        engine.eval()
        assert float(engine(*batch)) == float(engine(*batch))
