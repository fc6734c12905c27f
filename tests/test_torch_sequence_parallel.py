"""Port parity for sequence parallelism through the engine: tiny GPT-2 and
BERT trained with their tokens split over gloo ranks on the CPU (one
launch of four ranks of ``tests/torch_dist_worker.py``; the
``sequence_parallel`` block shapes the grid: size 4 is sp 4, size 2 is dp 2
x sp 2) against the JAX engine training the same flax weights serially on
one virtual device, and against the port's own serial engine.

Everything computes in fp32 at dropout 0, AdamW at lr 1e-2 with eps 1e-3
(the training rule of ``test_torch_offload.py``: eps 1e-8 turns Adam's
first steps into sign(g), where fp32 summation noise of near-zero
gradients decides the sign). Tolerances: every step's loss within 1e-5
relative of serial; the gradients of the first update within 1e-4 of each
tensor's max-abs; the masters after the run within 1e-5 of each tensor's
max-abs or 1e-3 lr (the training rule of ``test_torch_offload.py``). A
tensor's max-abs is floored at 1e-4 of the largest tensor's (BERT's key
bias gets a gradient that is 0 in exact arithmetic: summation noise of
1e-9 against 1e-13, which Adam scales to the update's size).

Also as the JAX tests: Ulysses mode, ZeRO-2 (bf16 config, fp32 compute;
also with ``cpu_offload``, each rank its host partition),
fp16 with gradient accumulation, ``pg_correctness_test``, the eval loss,
the refusals (a token dim sp does not divide, a model that is not
sequence-shardable, a user mesh without a 'seq' axis, BERT's fused layer),
and the collectives of a step against the schedule; a checkpoint saved
under sequence parallelism loads in the JAX engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.models.bert import BertConfig as JBertConfig
from deepspeed_tpu.models.bert import BertForPreTraining as JBert
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2
from deepspeed_tpu.parallel import mesh as jmesh
from tests.torch_dist_worker import start_ranks, wait_ranks

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
WEIGHT_TOL = 1e-5
WORLD, STEPS, BATCH, SEQ = 4, 4, 8, 32
NO_DROP = {"hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
           "use_fused_layer": False}


def _config(extra=None):
    cfg = {"train_batch_size": BATCH, "steps_per_print": 1000,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-2,
                                                     "eps": 1e-3}}}
    cfg.update(extra or {})
    return cfg


def _sp(size, extra=None):
    return _config(dict({"sequence_parallel": {"enabled": True,
                                               "size": size}},
                        **(extra or {})))


def _tree(p):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), p)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


IDS = np.random.RandomState(0).randint(0, 1024, size=(BATCH, SEQ))
EVAL_IDS = np.random.RandomState(3).randint(0, 1024, size=(BATCH, SEQ))


def _bert_batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 1024, size=(BATCH, SEQ))
    mask = (rng.rand(BATCH, SEQ) > 0.1).astype(np.int64)
    mask[:, 0] = 1
    labels = np.where(rng.rand(BATCH, SEQ) < 0.15, ids, -1)
    nsp = rng.randint(0, 2, size=(BATCH,))
    return ids, mask, None, labels, nsp


def _gpt2_params():
    cfg = JGPT2Config.tiny(dtype=jnp.float32, use_flash_attention=False)
    return _tree(JGPT2(cfg).init(jax.random.PRNGKey(0),
                                 jnp.asarray(IDS[:2]))["params"])


def _bert_params():
    cfg = JBertConfig.tiny(dtype=jnp.float32, **NO_DROP)
    b = _bert_batch()
    return _tree(JBert(cfg).init(jax.random.PRNGKey(1), jnp.asarray(b[0][:2]),
                                 jnp.asarray(b[1][:2]))["params"])


def _jax_serial(model, params, batch, steps, config):
    """The JAX engine on one device: per-step losses, the first backward's
    gradients, the final parameters."""
    engine = jds.initialize(
        model=model, config_params=config,
        model_parameters=jax.tree_util.tree_map(jnp.asarray, params),
        mesh=jmesh.build_mesh(devices=jax.devices()[:1]))[0]
    engine.compute_dtype = jnp.float32
    args = tuple(None if x is None else jnp.asarray(x) for x in batch)
    losses, grads = [], None
    for _ in range(steps):
        loss = engine(*args)  # the forward computes the gradients too
        if grads is None:
            grads = _flat(_tree(engine._cached_grads))
        engine.backward(loss)
        engine.step()
        losses.append(float(loss))
    return losses, grads, _flat(_tree(engine.params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sp")
    gp, bp = _gpt2_params(), _bert_params()
    gcfg = {"sequence_parallel_axis": "seq"}
    gpt2 = dict(kind="sp_train", model="gpt2", params=gp,
                batches=[(IDS, IDS)] * STEPS, fp32_compute=True, micro=True)
    bert = dict(kind="sp_train", model="bert", params=bp,
                batches=[_bert_batch()] * 3, fp32_compute=True, micro=True)
    bad_ids = np.zeros((BATCH, SEQ + 1), np.int64)
    fp16_micro = [(x, x) for x in (np.random.RandomState(s).randint(
        0, 1024, size=(4, SEQ)) for s in range(6))]
    tasks = [
        dict(gpt2, name="sp4", cfg=gcfg, config=_sp(4), eval=(EVAL_IDS,
                                                               EVAL_IDS),
             save=str(root / "ck")),
        dict(gpt2, name="grid", cfg=gcfg, config=_sp(2), micro=False),
        dict(gpt2, name="uly", cfg=dict(gcfg,
                                        sequence_parallel_mode="ulysses"),
             config=_sp(4)),
        dict(gpt2, name="zero2", cfg=gcfg, config=_sp(2, {
            "bf16": {"enabled": True}, "zero_optimization": {"stage": 2}})),
        dict(gpt2, name="zero2_offload", cfg=gcfg, config=_sp(2, {
            "bf16": {"enabled": True},
            "zero_optimization": {"stage": 2, "cpu_offload": True}})),
        dict(gpt2, name="fp16_gas", cfg=gcfg, fp32_compute=False,
             batches=fp16_micro, config=_sp(4, {
                 "train_micro_batch_size_per_gpu": 4,
                 "gradient_accumulation_steps": 2,
                 "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
                 "fp16": {"enabled": True, "initial_scale_power": 8}})),
        dict(gpt2, name="pg", cfg=gcfg, config=_sp(4), pg=True,
             batches=[(IDS, IDS)]),
        dict(gpt2, name="tokens", cfg=gcfg, config=_sp(4),
             batches=[(bad_ids, bad_ids)]),
        dict(gpt2, name="serial_model", cfg={}, config=_sp(4)),
        dict(gpt2, name="no_seq_mesh", cfg=gcfg, mesh={"num_dp": WORLD},
             config=_config({"sequence_parallel": {"enabled": True}})),
        dict(bert, name="bert", cfg=dict(NO_DROP,
                                         sequence_parallel_axis="seq"),
             config=_sp(4, {"optimizer": {"type": "Adam", "params": {
                 "lr": 1e-3, "eps": 1e-3}}})),
        dict(bert, name="bert_fused", cfg={"sequence_parallel_axis": "seq",
                                           "hidden_dropout_prob": 0.0,
                                           "attention_probs_dropout_prob":
                                               0.0},
             params=None, config=_sp(4)),
    ]
    proc = start_ranks(WORLD, tasks, str(root / "w4"))
    jgpt2 = _jax_serial(JGPT2(JGPT2Config.tiny(
        dtype=jnp.float32, use_flash_attention=False)), gp, (IDS, IDS),
        STEPS, _config())
    jbert = _jax_serial(JBert(JBertConfig.tiny(dtype=jnp.float32,
                                               **NO_DROP)), bp,
                        _bert_batch(), 3, _config({"optimizer": {
                            "type": "Adam", "params": {"lr": 1e-3,
                                                       "eps": 1e-3}}}))
    return {"ranks": [r for r in wait_ranks(proc)], "jgpt2": jgpt2,
            "jbert": jbert, "gpt2_params": gp, "root": root}


def _rank0(runs, name):
    return runs["ranks"][0][name]


def _close_tree(got, want, tol, atol=0.0):
    """Each tensor within ``tol`` of its max-abs (floored at 1e-4 of the
    largest tensor's: a gradient that is 0 in exact arithmetic, as a key
    bias's, is summation noise), or within ``atol``."""
    floor = 1e-4 * max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        g = np.asarray(got[name])
        limit = max(tol * max(float(np.abs(w).max()), floor, 1e-30), atol)
        assert np.abs(g - w).max() <= limit, (name, np.abs(g - w).max(),
                                              limit)


def _held_to_serial(runs, name, want, lr=1e-2):
    jlosses, jgrads, jparams = want
    for rank in runs["ranks"]:
        r = rank[name]
        np.testing.assert_allclose(r["losses"], jlosses, rtol=LOSS_RTOL)
        _close_tree(r["grads"], jgrads, GRAD_TOL)
        _close_tree(r["masters"], jparams, WEIGHT_TOL, atol=1e-3 * lr)


def test_sp_mesh_rebuilt_from_config(runs):
    for name, sp in (("sp4", 4), ("grid", 2)):
        coords = sorted(tuple(r[name]["coords"]) for r in runs["ranks"])
        assert coords == sorted((d, s, sp) for d in range(WORLD // sp)
                                for s in range(sp))


def test_sp_loss_and_gradients_match_serial(runs):
    """sp 4: the same function on another decomposition; the gradients of
    the first update (after the mean over the seq line) equal the serial
    gradients, which an sp-times scale fault would miss in the losses
    (Adam is scale-invariant) but not here."""
    _held_to_serial(runs, "sp4", runs["jgpt2"])


def test_sp_composes_with_dp(runs):
    _held_to_serial(runs, "grid", runs["jgpt2"])


def test_sp_ulysses_mode_matches_serial(runs):
    _held_to_serial(runs, "uly", runs["jgpt2"])


def test_sp_composes_with_zero2(runs):
    """ZeRO-2 (bf16 config, fp32 compute): the seq line's mean before the
    reduce-scatter over 'data'; losses and full masters as serial."""
    jlosses, _, jparams = runs["jgpt2"]
    for rank in runs["ranks"]:
        r = rank["zero2"]
        np.testing.assert_allclose(r["losses"], jlosses, rtol=LOSS_RTOL)
        _close_tree(r["masters"], jparams, WEIGHT_TOL)


def test_sp_composes_with_zero2_offload(runs):
    """ZeRO-2 + cpu_offload over sp 2 x dp 2 (bf16 config, fp32 compute):
    each rank's host partition steps on the gradients' mean over the seq
    line and then 'data', so the losses and the full masters are the
    serial run's (a rank stepping on its own token shard's gradient would
    part from it, and the seq ranks' masters from each other)."""
    jlosses, _, jparams = runs["jgpt2"]
    for rank in runs["ranks"]:
        r = rank["zero2_offload"]
        np.testing.assert_allclose(r["losses"], jlosses, rtol=LOSS_RTOL)
        _close_tree(r["masters"], jparams, WEIGHT_TOL)


def test_sp_composes_with_fp16_and_grad_accumulation(runs):
    r = _rank0(runs, "fp16_gas")
    assert r["skipped"] == 0
    boundary = r["losses"][1::2]
    assert all(np.isfinite(boundary)) and boundary[-1] < boundary[0] + 0.05


def test_sp_pg_correctness_check_passes(runs):
    for rank in runs["ranks"]:
        assert "error" not in rank["pg"] and np.isfinite(rank["pg"]["losses"]
                                                         ).all()


def test_sp_rejects_indivisible_token_dim(runs):
    for rank in runs["ranks"]:
        assert "not divisible by sp" in rank["tokens"]["error"]


def test_sp_requires_sequence_shardable_model(runs):
    for rank in runs["ranks"]:
        assert "sequence-shardable" in rank["serial_model"]["error"]


def test_sp_user_mesh_must_have_seq_axis(runs):
    for rank in runs["ranks"]:
        assert "'seq' axis" in rank["no_seq_mesh"]["error"]


def test_bert_sp_loss_matches_serial(runs):
    """BERT MLM + NSP at sp 4: the ring with the rotating padding mask, the
    count-weighted MLM mean, [CLS] from shard 0, the NSP loss once."""
    _held_to_serial(runs, "bert", runs["jbert"], lr=1e-3)


def test_bert_sp_rejects_fused_layer(runs):
    for rank in runs["ranks"]:
        assert "use_fused_layer" in rank["bert_fused"]["error"]


def test_sp_eval_loss_matches_serial_model(runs):
    r = _rank0(runs, "sp4")
    model = GPT2LMHeadModel(GPT2Config.tiny(dtype=torch.float32),
                            device="cpu", seed=None)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(r["masters"][n]))
        want = float(model(torch.from_numpy(EVAL_IDS),
                           labels=torch.from_numpy(EVAL_IDS)))
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank["sp4"]["eval"], want, rtol=LOSS_RTOL)


def test_sp_step_collectives_follow_the_schedule(runs):
    """Per rank and training step (2 layers, N seq ranks): each layer's
    ring shifts k/v N - 1 times forward and backward and dk/dv N times, one
    label shift; the loss psum forward and backward, then the gradients'
    mean over the seq line (one bucket), over 'data' too in the grid, and
    ``train_batch``'s loss mean over 'data'. Ulysses runs four all-to-alls
    a layer."""
    for name, n, reduces in (("sp4", 4, 3), ("grid", 2, 5)):
        for rank in runs["ranks"]:
            st = rank[name]["step_stats"]
            assert st["ring_shift"] == 2 * (3 * (n - 1) + 1) + 1
            assert st["all_reduce"] == reduces
    for rank in runs["ranks"]:
        st = rank["uly"]["step_stats"]
        assert st["all_to_all"] == 2 * 4 and st["ring_shift"] == 1


def test_sp_checkpoint_loads_in_the_jax_engine(runs):
    """Saved under sp 4 (the seq line's rank 0 writes), loaded serially by
    the JAX engine: the same parameters."""
    jeng = jds.initialize(
        model=JGPT2(JGPT2Config.tiny(dtype=jnp.float32,
                                     use_flash_attention=False)),
        config_params=_config(), model_parameters=jax.tree_util.tree_map(
            jnp.asarray, runs["gpt2_params"]),
        mesh=jmesh.build_mesh(devices=jax.devices()[:1]))[0]
    path, _ = jeng.load_checkpoint(str(runs["root"] / "ck"), tag="sp")
    assert path is not None and jeng.global_steps == STEPS
    _close_tree(_flat(_tree(jeng.params)), _rank0(runs, "sp4")["masters"],
                0.0)
    port = tds.initialize(
        model=GPT2LMHeadModel(GPT2Config.tiny(dtype=torch.float32),
                              device="cpu", seed=None),
        model_parameters=runs["gpt2_params"], config_params=_config(),
        device="cpu")[0]
    assert port.load_checkpoint(str(runs["root"] / "ck"), tag="sp")[0]
    _close_tree({n: p.detach().numpy() for n, p in zip(port._names,
                                                       port._params)},
                _rank0(runs, "sp4")["masters"], 0.0)


@pytest.mark.parametrize("extra,axes,match", [
    ({"sparse_gradients": True}, (1, 1, 2, 1), "sparse_gradients"),
    ({}, (1, 1, 2, 2), "item 10")])
def test_sp_refusals(extra, axes, match):
    """Sequence parallelism with sparse gradients (as in JAX) or over
    tensor-parallel ranks is refused while the engine is built, before any
    collective (stand-in groups)."""
    from deepspeed_tpu_torch.parallel import mesh as tmesh

    grid = tmesh.Mesh(axes, 0, None, mp_group=object(), sp_group=object())
    with pytest.raises(NotImplementedError, match=match):
        tds.initialize(model=GPT2LMHeadModel(GPT2Config.tiny(
            dtype=torch.float32, sequence_parallel_axis="seq"),
            device="cpu"), device="cpu", mesh=grid,
            config_params=_sp(2, extra))
