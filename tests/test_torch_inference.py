"""Port parity: deepspeed_tpu_torch's serving stack against the JAX
package's, on the CPU.

- the scheduler's FIFO admission, eviction and backpressure, mirroring the
  JAX package's scheduler tests;
- a staggered stream of mixed-length requests through the port's
  InferenceEngine emits the same greedy tokens as the JAX InferenceEngine
  on the same weights;
- a sampled request's stream depends only on its seed and positions, not
  on its slot or its neighbours; top_k=1 sampling is greedy;
- every setting the port does not implement yet raises (the perf x-ray,
  the MoE adapter, the legacy bucket path); the KV hierarchy's settings (prefix
  cache, host offload, the capacity budget) build engines that report
  them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu.models.gpt2 import GPT2Config as JConfig
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JModel
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.inference import (InferenceConfig, QueueFull,
                                           Scheduler, kv_pool)
from deepspeed_tpu_torch.models import GPT2Config
from deepspeed_tpu_torch.models.generation import as_gencfg

torch.set_num_threads(1)

SERVE = {"max_slots": 3, "max_len": 64, "chunk_size": 4, "prefill_chunk": 8}
_CACHE = {}


def models():
    if not _CACHE:
        jcfg = JConfig.tiny(dropout=0.0, dtype=jnp.float32,
                            use_flash_attention=False)
        jmodel = JModel(jcfg)
        ids = np.random.RandomState(0).randint(0, jcfg.vocab_size, (2, 12))
        params = jmodel.init(jax.random.PRNGKey(0),
                             jnp.asarray(ids))["params"]
        _CACHE.update(jmodel=jmodel, params=params,
                      tree=jax.tree_util.tree_map(np.asarray, params))
    return _CACHE["jmodel"], _CACHE["params"], _CACHE["tree"]


def port_engine(**overrides):
    _, _, tree = models()
    return init_inference(GPT2Config.tiny(dtype=torch.float32), tree,
                          config=dict(SERVE, **overrides), device="cpu")


def prompts(lengths, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 1024, size=n).astype(np.int32) for n in lengths]


# ------------------------------------------------------------- scheduler


def test_scheduler_fifo_admission_and_eviction():
    s = Scheduler(num_slots=2, max_queue=8)
    reqs = [s.submit(np.array([i]), 4, 0.0, 0, -1, 0) for i in range(4)]
    pairs = s.admissions()
    assert [(r.rid, slot) for r, slot in pairs] == [(0, 0), (1, 1)]
    assert [r.rid for r in s.queue] == [2, 3]
    assert s.admissions() == []
    s.complete(0)
    assert reqs[0].done and reqs[0].slot is None
    pairs = s.admissions()
    assert [(r.rid, slot) for r, slot in pairs] == [(2, 0)]
    assert s.occupancy() == 1.0
    for slot in list(s.running):
        s.complete(slot)
    assert not s.idle
    pairs = s.admissions()
    assert [r.rid for r, _ in pairs] == [3]
    s.complete(pairs[0][1])
    assert s.idle


def test_scheduler_backpressure():
    s = Scheduler(num_slots=1, max_queue=2)
    s.submit(np.array([1]), 1, 0.0, 0, -1, 0)
    s.submit(np.array([2]), 1, 0.0, 0, -1, 0)
    with pytest.raises(QueueFull) as info:
        s.submit(np.array([3]), 1, 0.0, 0, -1, 0)
    assert info.value.queue_depth == 2
    s.admissions()
    s.submit(np.array([3]), 1, 0.0, 0, -1, 0)


# ---------------------------------------------------------------- engine


def _staggered(submit, step, run):
    """Three requests, two steps, three more (one finishing at its first
    token), then run to idle; returns the handles."""
    ps = prompts([5, 19, 9, 26, 3, 12])
    budgets = [10, 6, 12, 7, 1, 9]
    reqs = [submit(p, n) for p, n in zip(ps[:3], budgets[:3])]
    step()
    step()
    reqs += [submit(p, n) for p, n in zip(ps[3:], budgets[3:])]
    run()
    return reqs


def test_engine_greedy_streams_match_jax_engine():
    jmodel, params, _ = models()
    jeng = JEngine(jmodel, params, config=dict(SERVE, telemetry=False,
                                               perf_xray=False))
    want = _staggered(lambda p, n: jeng.submit(p, max_new_tokens=n),
                      jeng.step, jeng.run)
    teng = port_engine()
    got = _staggered(lambda p, n: teng.submit(p, max_new_tokens=n),
                     teng.step, teng.run)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [len(r.tokens) for r in got] == [10, 6, 12, 7, 1, 9]
    m = teng.metrics()
    assert m["tokens_out"] == 45 and m["requests_completed"] == 6
    assert m["prefills"] == 6 and m["prefill_tokens"] == 74


def test_sampled_stream_independent_of_slot_and_neighbours():
    p = prompts([11])[0]
    alone = port_engine()
    a = alone.submit(p, max_new_tokens=12, temperature=0.9, top_k=20, seed=7)
    alone.run()
    crowded = port_engine()
    for q in prompts([4, 17], seed=5):
        crowded.submit(q, max_new_tokens=9, temperature=1.3, seed=1)
    b = crowded.submit(p, max_new_tokens=12, temperature=0.9, top_k=20,
                       seed=7)
    crowded.run()
    assert b.tokens == a.tokens
    assert len(set(a.tokens)) > 1  # really sampled, not a greedy repeat


def test_top_k_one_sampling_is_greedy():
    eng = port_engine()
    p = prompts([13], seed=9)[0]
    greedy = eng.submit(p, max_new_tokens=10)
    sampled = eng.submit(p, max_new_tokens=10, temperature=1.5, top_k=1,
                         seed=4)
    eng.run()
    assert sampled.tokens == greedy.tokens


@pytest.mark.parametrize("setting", [
    {"spec_decode": True, "chunked_prefill": False},
    {"expert_parallel": False, "use_flash_decode": False},
    {"chunked_prefill": False}, {"perf_xray": True, "prefill_buckets": [32]},
    {"use_flash_decode": False}, {"sparse_decode": False,
                                  "chunked_prefill": False},
    {"telemetry": True, "trace_ring": 16, "use_flash_decode": False},
    {"prefill_buckets": [16, 64]}])
def test_unported_settings_raise(setting):
    with pytest.raises(NotImplementedError):
        InferenceConfig.from_dict(setting)


@pytest.mark.parametrize("setting", [
    {"expert_parallel": False}, {"xray_sample_every": 0},
    {"sparse_decode": False}, {"perf_xray": True, "xray_sample_every": 16},
    {"telemetry": True, "trace_ring": 16, "xray_sample_every": 16}])
def test_lifted_settings_parse(setting):
    """The x-ray's and the adapters' keys are real fields now (they were
    refused until those slices): each parses to its value, and a negative
    sampling period is refused as in the JAX config."""
    cfg = InferenceConfig.from_dict(setting)
    for k, v in setting.items():
        assert getattr(cfg, k) == v
    with pytest.raises(ValueError, match="xray_sample_every"):
        InferenceConfig.from_dict({"xray_sample_every": -1})


@pytest.mark.parametrize("setting", [
    {"paged_kv": True, "prefix_cache": True},
    {"int8_kv": True, "host_offload": True}, {"prefix_cache": True},
    {"host_offload": True}, {"hbm_budget_bytes": 1 << 30},
    {"spec_decode": True, "prefix_cache": True}],
    ids=["paged_prefix", "int8_offload", "prefix", "offload", "budget",
         "spec_prefix"])
def test_hierarchy_settings_build_engines(setting):
    """The KV hierarchy's settings parse and build a CPU engine whose
    metrics() report the tiers that are on. A budget alone turns no tier
    on: as in the JAX engine, metrics() then has no hierarchy keys."""
    cfg = InferenceConfig.from_dict(dict(SERVE, **setting))
    eng = port_engine(**setting)
    assert eng.config == cfg
    m = eng.metrics()
    if setting == {"hbm_budget_bytes": 1 << 30}:
        assert cfg.hbm_budget_bytes == 1 << 30 and "prefix_cache" not in m
        assert not eng.metrics()["int8_kv"] and eng._hier is None
        return
    assert m["prefix_cache"] == bool(setting.get("prefix_cache"))
    assert m["host_offload"] == bool(setting.get("host_offload"))
    assert m["int8_kv"] == bool(setting.get("int8_kv"))
    assert m["paged_kv"] == bool(setting.get("paged_kv"))
    assert m["spec_decode"] == bool(setting.get("spec_decode"))
    assert m["prefix_hits"] == m["swap_outs"] == m["slots_swapped"] == 0


def test_jax_default_block_parses_and_unknown_keys_raise():
    """A ds_config inference block at the JAX package's defaults parses,
    with the settings the port reads carried over; a key neither package
    knows is an error."""
    from deepspeed_tpu.inference.config import INFERENCE_DEFAULTS
    cfg = InferenceConfig.from_dict(dict(INFERENCE_DEFAULTS, max_slots=5,
                                         use_flash_decode=True))
    assert cfg.max_slots == 5 and cfg.prefill_chunk == 32
    assert cfg.max_len == INFERENCE_DEFAULTS["max_len"]
    with pytest.raises(ValueError, match="unknown"):
        InferenceConfig.from_dict({"max_slot": 4})


def test_pool_views_alias_the_planes_and_harvest_unpacks():
    gcfg = GPT2Config.tiny(dtype=torch.float32)
    pool = kv_pool.init_pool(as_gencfg(gcfg), 3, 16, slack=4, device="cpu")
    assert pool["k"].shape == (gcfg.n_layer, 3, gcfg.n_head, 20, 16)
    # The planes whole, seen as an arena of one page per slot, and the
    # one-row table [[slot]]; the slot may be a device tensor.
    view = kv_pool.slot_cache_view(pool, torch.tensor([1]),
                                   torch.tensor([0], dtype=torch.int32))
    assert view["k"] is pool["k"] and view["block_tbl"].tolist() == [[1]]
    assert view["block_tbl"].dtype == torch.int32
    view["k"][0, view["block_tbl"][0, 0], 0, 5] = 7.0
    assert pool["k"][0, 1, 0, 5, 0] == 7.0  # the slot's plane, in place
    pool["pos"][2], pool["active"][2], pool["last_tok"][0] = 9, True, 42
    toks = torch.arange(6).reshape(2, 3, 1)  # [chunk, slots, lanes]
    # Fill the step's harvest buffer as the step program does; one copy.
    harvest = kv_pool.step_harvest(3, 2, "cpu")
    for name in ("pos", "active", "last_tok"):
        harvest.dev[name].copy_(pool[name])
    harvest.dev["toks"].copy_(toks)
    harvest.dev["valid"].copy_(toks > 2)
    harvest.dev["first"].fill_(-1)
    snap = harvest.read()
    assert snap["first"].tolist() == [-1]
    assert snap["pos"].tolist() == [0, 0, 9]
    assert snap["last_tok"].tolist() == [42, 0, 0]
    assert snap["toks"].tolist() == toks.tolist()
    assert snap["valid"].dtype == bool and snap["valid"].sum() == 3
    assert kv_pool.free_slots(snap) == [0, 1]
    assert kv_pool.max_active_frontier(snap) == 9
    assert kv_pool.pool_nbytes(pool) > 2 * pool["k"].numel() * 4


def test_submit_rejects_what_the_pool_cannot_hold():
    eng = port_engine()
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(np.zeros(60, np.int32), max_new_tokens=8)
    with pytest.raises(ValueError, match="token ids"):
        eng.submit(np.array([3, 1024]), max_new_tokens=2)
    with pytest.raises(ValueError, match="spec_decode"):
        eng.submit(np.zeros(4, np.int32), spec_decode=True)
