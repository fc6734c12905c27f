"""Port parity for tensor parallelism: tiny GPT-2 over 4 gloo ranks on the
CPU (mp 2 x dp 2, started by the port's launcher through
``tests/torch_dist_worker.py``) against the JAX engine on a 4-device mp 2
x dp 2 mesh of the conftest's virtual devices (GSPMD sharding by
``DEFAULT_TP_RULES``), on the same numpy batches and flax weights.

Both compute in fp32 at dropout 0 with gradient clipping at 0.1 (the
norm clips every step), AdamW eps 1e-3 (the training rule of
``test_torch_offload.py``). The port's attention is ``flash_attention``
(its plain version on the CPU), the JAX engine's the einsum path: the
same function.

Tolerances: losses within 1e-5 relative, every step; fp32 masters within
1e-5 of each tensor's max-abs.

Also: each rank's shard shapes against the JAX arrays' shards; the port's
``c_attn`` shard holds the rank's heads of q, k and v (``tp_shard_tree``),
where JAX's holds a contiguous column block, so shards are compared by
shape and the gathered leaves by value; the port's own dp-4 run on the
same batches; ZeRO-3 x TP leaving each rank 1/(mp dp) of ``c_attn``
(against the JAX ZeRO-3 x TP engine's losses); a TP checkpoint saved by
the port at mp 2 x dp 2 loaded by the JAX engine at dp 4, and one saved
by the JAX engine at mp 2 x dp 2 loaded by the port at mp 4; the
refusals (``n_head % mp``, offload over model ranks, the 'seq' axis).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2
from deepspeed_tpu.parallel import mesh as jmesh
from tests.torch_dist_worker import start_ranks, wait_ranks

from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.parallel import mesh as tmesh
from deepspeed_tpu_torch.parallel.tensor_parallel import (TPContext,
                                                          apply_rules)

torch.set_num_threads(1)

TOL = 1e-5
STEPS = 4


def _config(stage=None, extra=None):
    cfg = {"train_batch_size": 8, "steps_per_print": 1000,
           "optimizer": {"type": "AdamW", "params": {
               "lr": 1e-2, "eps": 1e-3, "weight_decay": 0.01}},
           "gradient_clipping": 0.1}
    if stage is not None:
        cfg.update({"bf16": {"enabled": True},
                    "zero_optimization": {"stage": stage}})
    cfg.update(extra or {})
    return cfg


def _tree(p):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), p)


def _flat(tree, prefix=""):
    """{dotted name: leaf} (leaves as they are)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


BATCHES = [(b, b) for b in (np.random.RandomState(s).randint(
    0, 1024, size=(8, 16)) for s in (0, 1, 0, 1))]


def _params():
    ids = np.random.RandomState(0).randint(0, 1024, size=(2, 16))
    cfg = JGPT2Config.tiny(dtype=jnp.float32, use_flash_attention=False)
    return _tree(JGPT2(cfg).init(jax.random.PRNGKey(0),
                                 jnp.asarray(ids))["params"])


def _jax_engine(params, config, mp, dp, fp32=False):
    mesh = jmesh.build_mesh(devices=jax.devices()[:mp * dp], num_mp=mp,
                            num_dp=dp)
    model = JGPT2(JGPT2Config.tiny(dtype=jnp.float32,
                                   use_flash_attention=False))
    engine = jds.initialize(model=model, model_parameters=jax.tree_util
                            .tree_map(jnp.asarray, params),
                            config_params=config, mesh=mesh)[0]
    if fp32:
        engine.compute_dtype = jnp.float32
    return engine


def _jax_train(engine, batches, save=None, save_after=None):
    losses = []
    for i, b in enumerate(batches):
        if save is not None and i == save_after:
            engine.save_checkpoint(save, tag="ck")
        loss = engine(*b)
        engine.backward(loss)
        engine.step()
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    params = _params()
    jeng = _jax_engine(params, _config(), 2, 2)
    jax_losses = _jax_train(jeng, BATCHES, save=str(root / "jax_tp"),
                            save_after=2)
    jz = _jax_engine(params, _config(3), 2, 2, fp32=True)
    jax_z3 = _jax_train(jz, BATCHES[:2])
    shard_shapes = {n: a.addressable_shards[0].data.shape
                    for n, a in _flat(jeng.params).items()}
    z3_frac = jz.params["h_0"]["attn"]["c_attn"]["kernel"] \
        .addressable_shards[0].data.size / (64 * 192)
    tasks = [
        dict(name="tp", kind="tp", mp=2, params=params, config=_config(),
             batches=BATCHES, save=str(root / "port_tp"), save_after=2),
        dict(name="dp", kind="tp", mp=1, params=params, config=_config(),
             batches=BATCHES),
        dict(name="z3", kind="tp", mp=2, params=params, config=_config(3),
             batches=BATCHES[:2]),
        dict(name="load_jax", kind="tp", mp=4, params=params,
             config=_config(), batches=BATCHES[2:],
             load=str(root / "jax_tp")),
        dict(name="offload", kind="tp_offload", params=params,
             ids=BATCHES[0][0][:2])]
    ranks = wait_ranks(start_ranks(4, tasks, str(root / "w4")))
    return {"root": root, "params": params, "jax": jax_losses,
            "jax_params": _flat(_tree(jeng.params)), "jax_z3": jax_z3,
            "shards": shard_shapes, "z3_frac": z3_frac, "ranks": ranks}


def test_loss_trajectory_matches_jax_and_dp(runs):
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["tp"]["losses"], runs["jax"], rtol=TOL)
        np.testing.assert_allclose(r["tp"]["losses"], r["dp"]["losses"],
                                   rtol=TOL)
    assert runs["jax"][-1] < runs["jax"][0]


def test_masters_match_jax(runs):
    want = runs["jax_params"]
    for r in runs["ranks"]:
        got = r["tp"]["masters"]
        assert set(got) == set(want)
        for n in want:
            scale = np.abs(want[n]).max()
            assert np.abs(got[n] - want[n]).max() <= TOL * scale, n


def test_shard_shapes_equal_jax(runs):
    """Every leaf's local shape is the JAX array's shard shape: 'model' on
    the rule's dim, replicated leaves whole."""
    for r in runs["ranks"]:
        assert r["tp"]["shards"] == {n: tuple(s) for n, s in
                                     runs["shards"].items()}


def test_shards_hold_the_ranks_heads(runs):
    """A rank's shards are ``tp_shard_tree`` of the full masters: its
    heads of q, k and v in ``c_attn``, column and row blocks elsewhere;
    two steps in, each rank holds exactly that."""
    cfg = GPT2Config.tiny(dtype=torch.float32)
    for r in runs["ranks"]:
        tp = r["tp"]
        want = _flat(tp_shard_tree(_nest(tp["masters"]), cfg,
                                   tp["mp_rank"], 2))
        for n, local in tp["local"].items():
            np.testing.assert_array_equal(local, want[n])


def tp_shard_tree(tree, config, rank, mp):
    """The test's own cut of rank ``rank``'s tensor-parallel shards from a
    full flax GPT-2 tree over ``mp`` ranks (independent of the port's
    ``apply_rules``): ``c_attn`` the rank's heads of q, k and v, ``c_fc`` a
    column block, both ``c_proj`` kernels a row block, other leaves whole."""
    C = config.n_embd
    per = C // mp
    qkv = np.concatenate([np.arange(part * C + rank * per,
                                    part * C + (rank + 1) * per)
                          for part in range(3)])

    def cut(name, leaf):
        leaf = np.asarray(leaf)
        if name.endswith("attn/c_attn/kernel"):
            return leaf[:, qkv]
        if name.endswith("attn/c_attn/bias"):
            return leaf[qkv]
        if name.endswith("mlp/c_fc/kernel"):
            n = leaf.shape[1] // mp
            return leaf[:, rank * n:(rank + 1) * n]
        if name.endswith("mlp/c_fc/bias") or name.endswith("c_proj/kernel"):
            n = leaf.shape[0] // mp
            return leaf[rank * n:(rank + 1) * n]
        return leaf

    def walk(node, path):
        return {k: walk(v, path + (k,)) if isinstance(v, dict) else
                cut("/".join(path + (k,)), v) for k, v in node.items()}

    return walk(tree, ())


def _nest(flat):
    tree = {}
    for name, v in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def test_tp_collectives_per_step(runs):
    """Two all-reduces a block forward and two backward over the model
    group, the data group's gradient all-reduce, the model and pipe norm
    and nothing else: 4 x 2 blocks + 1 + 1 per step."""
    for r in runs["ranks"]:
        assert set(r["tp"]["all_reduces"]) == {4 * 2 + 1 + 1}


def test_zero3_composes_with_tp(runs):
    """ZeRO-3 x TP: c_attn's kernel keeps 'model' on its columns and takes
    'data' on its rows, so each rank holds 1/(mp dp) of it, as the JAX
    shards do; the losses equal the JAX ZeRO-3 x TP engine's."""
    assert runs["z3_frac"] == pytest.approx(1.0 / 4)
    for r in runs["ranks"]:
        shape = r["z3"]["zero_shards"]["h_0.attn.c_attn.kernel"]
        assert shape == (32, 96)
        np.testing.assert_allclose(r["z3"]["losses"], runs["jax_z3"],
                                   rtol=TOL)


def test_port_tp_checkpoint_loads_in_jax_at_dp4(runs):
    """The port saved at mp 2 x dp 2 after 2 steps (the JAX full layout);
    the JAX engine at dp 4 loads it and continues as the port did."""
    eng = _jax_engine(runs["params"], _config(), 1, 4)
    path, _ = eng.load_checkpoint(str(runs["root"] / "port_tp"))
    assert path is not None and eng.global_steps == 2
    got = _jax_train(eng, BATCHES[2:])
    np.testing.assert_allclose(got, runs["ranks"][0]["tp"]["losses"][2:],
                               rtol=TOL)


def test_jax_tp_checkpoint_loads_in_port_at_mp4(runs):
    for r in runs["ranks"]:
        assert r["load_jax"]["loaded"]
        np.testing.assert_allclose(r["load_jax"]["losses"], runs["jax"][2:],
                                   rtol=TOL)


def test_offload_over_model_ranks_is_refused(runs):
    """ZeRO-Offload over 4 model ranks builds and trains: each rank's host
    master holds its own shard of every leaf (the c_attn kernel's quarter
    of the columns), and the ranks' losses agree (the parity against the
    JAX offload engine: ``tests/test_torch_offload_ranks.py``)."""
    losses = [r["offload"]["losses"] for r in runs["ranks"]]
    assert all(np.isfinite(x).all() for x in losses)
    assert all(x == losses[0] for x in losses)
    for r in runs["ranks"]:
        off = r["offload"]
        assert off["host_elems"] == off["local_elems"] < off["full_elems"]


def test_n_head_not_divisible_by_mp_is_refused():
    model = GPT2LMHeadModel(GPT2Config.tiny(dtype=torch.float32),
                            device="cpu", seed=0)
    with pytest.raises(ValueError, match="n_head=4"):
        apply_rules(model, TPContext(None, 3, 0))


def test_seq_axis_is_refused_model_and_pipe_accepted():
    """Every axis is taken now (the seq axis by sequence parallelism); a
    pipeline over 'seq' stays refused (test_torch_pipe.py)."""
    seq = tmesh.build_mesh(num_sp=2, world_size=2, rank=1)
    assert seq.shape["seq"] == 2 and seq.sp_rank == 1
    mesh = tmesh.build_mesh(num_mp=2, num_pp=2, world_size=8, rank=5)
    assert mesh.shape == {"pipe": 2, "data": 2, "seq": 1, "model": 2}
    assert (mesh.pp_rank, mesh.dp_rank, mesh.mp_rank) == (1, 0, 1)
    assert mesh.line("model") == [4, 5] and mesh.line("pipe") == [1, 5]


def test_tp_shard_tree_cuts_heads():
    """``tp_shard_tree`` puts head h's q, k and v columns on rank h //
    (H / mp), and the row blocks of both c_proj kernels on their ranks."""
    C, H = 64, 4
    tree = {"h_0": {"attn": {"c_attn": {
        "kernel": np.arange(C * 3 * C, dtype=np.float32).reshape(C, 3 * C),
        "bias": np.arange(3 * C, dtype=np.float32)},
        "c_proj": {"kernel": np.arange(C * C, dtype=np.float32)
                   .reshape(C, C)}}}}
    cfg = GPT2Config.tiny(dtype=torch.float32)
    assert cfg.n_head == H
    got = tp_shard_tree(tree, cfg, 1, 2)["h_0"]["attn"]
    cols = np.concatenate([np.arange(p * C + 32, p * C + 64)
                           for p in range(3)])
    np.testing.assert_array_equal(got["c_attn"]["bias"], cols)
    np.testing.assert_array_equal(got["c_attn"]["kernel"],
                                  tree["h_0"]["attn"]["c_attn"]["kernel"]
                                  [:, cols])
    np.testing.assert_array_equal(got["c_proj"]["kernel"],
                                  tree["h_0"]["attn"]["c_proj"]["kernel"]
                                  [32:])


def test_zero3_with_stored_shards_is_refused():
    """Rule leaves the model does not compute split are stored sharded and
    gathered for use; ZeRO-3 over them is refused (ROADMAP item 6), while
    the engine is built and before any collective: a grid with stand-in
    groups suffices."""
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models.simple import LinearStack

    grid = tmesh.Mesh((1, 2, 1, 2), 0, object(), mp_group=object())
    model = LinearStack(input_dim=6, hidden_dim=6, output_dim=8,
                        num_layers=2, device="cpu")
    model.tp_rules = ((r".*kernel$", 1),)
    with pytest.raises(NotImplementedError, match="item 6"):
        tds.initialize(model=model, device="cpu", mesh=grid, config_params=
                       _config(3, {"train_batch_size": 4}))
