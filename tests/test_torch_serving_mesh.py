"""Port parity: serving over a mesh's 'model' axis, tiny GPT-2 (4 heads)
over gloo ranks on the CPU (mp 2 on 2 ranks, mp 4 on 4, started by the
port's launcher through ``tests/torch_dist_worker.py``), against the JAX
``InferenceEngine`` on the same flax weights.

- Greedy streams equal the JAX engine's token for token in fp32, on the
  dense, int8, paged and paged int8 pools, with speculation off and on
  (the JAX engine's speculating streams are its plain ones).
- Each rank's k/v planes (and int8 scale planes) hold H/mp heads, and its
  pool's bytes are one process's planes over mp; ``compile_count`` equals
  one process's.
- Sampled streams at mp 2 equal the port's own one-process engine's (its
  (seed, position) draw cannot match JAX's threefry).
- A rank given a different request raises ``MeshDivergence`` on every
  rank, before any step, and hangs nowhere.
- Every refused composition raises a ValueError naming ROADMAP Queue 1
  item 19 (the long-context adapter's mesh: item 10).
"""

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.inference import InferenceEngine
from deepspeed_tpu_torch.inference.adapters import (GPT2Adapter,
                                                    LongContextAdapter)
from deepspeed_tpu_torch.models import GPT2Config
from deepspeed_tpu_torch.models.generation import ServingWeights
from deepspeed_tpu_torch.models.gpt2 import params_from_jax
from deepspeed_tpu_torch.parallel.mesh import build_mesh
from deepspeed_tpu_torch.parallel.tensor_parallel import TPContext
from tests.test_torch_inference import models, prompts
from tests.torch_dist_worker import start_ranks, wait_ranks

torch.set_num_threads(1)

SERVE = {"max_slots": 2, "max_len": 64, "chunk_size": 4, "prefill_chunk": 8}
POOLS = {"dense": {}, "int8": {"int8_kv": True},
         "paged": {"paged_kv": True, "kv_page_len": 8},
         "paged_int8": {"paged_kv": True, "kv_page_len": 8, "int8_kv": True}}
SPEC = {"spec_decode": True, "spec_k": 4, "spec_ngram": 3}
MAX_NEW = 6
SAMPLED = {"temperature": 0.9, "top_k": 20, "seed": 7}
# Three requests over two slots (a freed slot refills); one prompt tiled,
# so the drafter finds matches.
PROMPTS = prompts([5, 9]) + [np.tile(prompts([4], seed=8)[0], 3)]
REFUSED = {"step_budget_s": {"step_budget_s": 1.0},
           "fault_injection": {"fault_injection": True},
           "prefix_cache": {"prefix_cache": True, "prefix_slots": 2,
                            "prefix_len": 8, "min_prefix_len": 4},
           "host_offload": {"host_offload": True, "swap_slots": 2}}


def _config(pool, spec):
    return dict(SERVE, **POOLS[pool], **(SPEC if spec else {}))


def _cases():
    cases = [{"name": "{}_{}".format(pool, spec), "config": _config(pool,
                                                                   spec)}
             for pool in POOLS for spec in (False, True)]
    cases.append({"name": "sampled", "config": SERVE, "submit": SAMPLED})
    cases.append({"name": "xray", "config": dict(SERVE, perf_xray=True)})
    cases.append({"name": "diverge", "config": SERVE, "diverge": True})
    cases += [{"name": "refuse_" + k, "config": dict(SERVE, **v),
               "refuse": True} for k, v in REFUSED.items()]
    cases.append({"name": "refuse_deadline", "config": SERVE,
                  "refuse": True, "submit": {"deadline_ms": 1000.0}})
    cases.append({"name": "refuse_timeout", "config": SERVE,
                  "refuse": True, "run": {"timeout_s": 10.0}})
    return cases


def _port_one(pool, spec, **submit):
    _, _, tree = models()
    eng = init_inference(GPT2Config.tiny(dtype=torch.float32), tree,
                         config=_config(pool, spec), device="cpu")
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW, **submit)
            for p in PROMPTS]
    eng.run()
    return eng, [r.tokens for r in reqs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_mesh")
    _, _, tree = models()
    procs = {mp: start_ranks(mp, [{
        "name": "serve", "kind": "serve", "mp": mp, "params": tree,
        "prompts": PROMPTS, "max_new": MAX_NEW,
        "cases": _cases() if mp == 2 else _cases()[:len(POOLS) * 2]}],
        str(root / "mp{}".format(mp))) for mp in (2, 4)}
    jmodel, params, _ = models()
    want = {}
    for pool in POOLS:
        jeng = JEngine(jmodel, params, config=dict(
            _config(pool, False), use_flash_decode=False, telemetry=False,
            perf_xray=False))
        reqs = [jeng.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
        jeng.run()
        want[pool] = [list(map(int, r.tokens)) for r in reqs]
    ranks = {mp: [r["serve"] for r in wait_ranks(proc, timeout=240)]
             for mp, proc in procs.items()}
    return want, ranks


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("mp", [2, 4])
def test_greedy_streams_equal_the_jax_engine(runs, mp, pool, spec):
    want, ranks = runs
    for r in ranks[mp]:
        got = r["{}_{}".format(pool, spec)]
        assert got["raised"] is None
        assert got["tokens"] == want[pool], (mp, pool, spec, r["mp_rank"])


@pytest.mark.parametrize("mp", [2, 4])
def test_each_rank_holds_its_heads(runs, mp):
    """H/mp heads of every k/v plane and int8 scale plane on each rank,
    and the planes' bytes one process's over mp."""
    _, ranks = runs
    for pool in POOLS:
        one, _ = _port_one(pool, False)
        k1 = tuple(one._pool["k"].shape)
        plane_bytes = sum(one._pool[n].numel() * one._pool[n].element_size()
                          for n in ("k", "v", "k_scale", "v_scale")
                          if n in one._pool)
        other = one.metrics()["kv_hbm_bytes"] - plane_bytes
        for r in ranks[mp]:
            got = r["{}_False".format(pool)]
            assert got["k_shape"] == k1[:2] + (k1[2] // mp,) + k1[3:]
            if "int8" in pool:
                assert got["scale_shape"] == got["k_shape"][:-1]
            assert got["kv_hbm_bytes"] == plane_bytes // mp + other


@pytest.mark.parametrize("mp", [2, 4])
def test_compile_count_equals_one_process(runs, mp):
    _, ranks = runs
    for pool in POOLS:
        for spec in (False, True):
            one, _ = _port_one(pool, spec)
            for r in ranks[mp]:
                assert r["{}_{}".format(pool, spec)]["compile_count"] == \
                    one.compile_count


def test_sampled_streams_equal_one_process(runs):
    _, ranks = runs
    _, want = _port_one("dense", False, **SAMPLED)
    for r in ranks[2]:
        assert r["sampled"]["tokens"] == want


def test_perf_xray_over_the_mesh(runs):
    """The perf x-ray measures each key's first run on every rank (the
    reduces inside its cost modes) and changes no token."""
    want, ranks = runs
    for r in ranks[2]:
        assert r["xray"]["tokens"] == want["dense"]
        assert r["xray"]["xray_keys"] >= 1


def test_a_diverging_rank_raises_on_every_rank(runs):
    """Rank 1 was given another first prompt: both ranks raise at run()'s
    first digest, before any step (no token emitted), and neither hangs
    (the launch ended within its timeout)."""
    _, ranks = runs
    for r in ranks[2]:
        got = r["diverge"]
        assert got["raised"] and "queued" in got["raised"]
        assert got["tokens"] == [[]] * len(PROMPTS)


def test_refused_compositions_name_their_item(runs):
    _, ranks = runs
    for r in ranks[2]:
        for name in list(REFUSED) + ["deadline", "timeout"]:
            msg = r["refuse_" + name]
            assert msg is not None and "item 19" in msg, (name, msg)


def test_mesh_axes_and_groups_refused():
    """The serving mesh's 'pipe' and 'seq' axes, a 'model' axis without a
    process group, and the long-context adapter over any mesh raise, each
    naming its item; the checks need no process group."""
    _, _, tree = models()
    cfg = GPT2Config.tiny(dtype=torch.float32)
    for kw in ({"num_pp": 2}, {"num_sp": 2}):
        with pytest.raises(ValueError, match="item 19"):
            init_inference(cfg, tree, config=SERVE, device="cpu",
                           mesh=build_mesh(world_size=2, rank=0, **kw))
    with pytest.raises(ValueError, match="process group"):
        init_inference(cfg, tree, config=SERVE, device="cpu",
                       mesh=build_mesh(num_mp=2, world_size=2, rank=0))
    adapter = LongContextAdapter.from_model(cfg, threshold=32, block=8,
                                            num_local_blocks=2)
    with pytest.raises(NotImplementedError, match="item 10"):
        InferenceEngine(cfg, tree, config=SERVE, device="cpu",
                        adapter=adapter,
                        mesh=build_mesh(world_size=2, rank=0))


@pytest.mark.parametrize("mp", [2, 4])
def test_param_shardings_are_the_serving_shards(mp):
    """``GPT2Adapter.param_shardings`` cuts the JAX tree as the serving
    weights hold it: ``c_attn`` by the rank's heads of q, k and v, the
    MLP's ``c_fc`` by columns, both ``c_proj`` kernels by rows, the rest
    replicated; ``params_from_jax`` with a model context keeps the same
    shards."""
    _, _, tree = models()
    cfg = GPT2Config.tiny(dtype=torch.float32)
    full = params_from_jax(tree, cfg, "cpu")
    adapter = GPT2Adapter.from_model(cfg)
    for rank in range(mp):
        mesh = build_mesh(num_mp=mp, world_size=mp, rank=rank)
        tp = TPContext(None, mp, rank)
        shard = adapter.param_shardings(mesh, tree)
        weights = ServingWeights(full, tp)
        cut = params_from_jax(tree, cfg, "cpu", tp=tp)
        for i, blk in enumerate(weights.blocks()):
            h = shard["h_{}".format(i)]
            for part, names in (("attn", ("c_attn", "c_proj")),
                                ("mlp", ("c_fc", "c_proj"))):
                for name in names:
                    got = getattr(getattr(blk, part), name)
                    mine = getattr(getattr(cut.blocks()[i], part), name)
                    for leaf in ("kernel", "bias"):
                        np.testing.assert_array_equal(
                            getattr(got, leaf).numpy(), h[part][name][leaf])
                        np.testing.assert_array_equal(
                            getattr(mine, leaf).detach().numpy(),
                            h[part][name][leaf])
            assert blk.attn.tp is tp and blk.mlp.tp is tp
        np.testing.assert_array_equal(shard["wte"], tree["wte"])
        c = cfg.n_embd
        assert shard["h_0"]["attn"]["c_attn"]["kernel"].shape == \
            (c, 3 * c // mp)
    assert adapter.param_shardings(None, tree) is None
    assert jax.tree_util.tree_structure(shard) == \
        jax.tree_util.tree_structure(tree)
