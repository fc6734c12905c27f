"""Port parity: the adapter conformance kit (deepspeed_tpu_torch.inference
.adapters) against the JAX package's, on the CPU.

The contracts are those of the JAX package's ``test_adapters.py``, for
each adapter kind (GPT-2, MoE, long-context):

1. CHUNK-VS-WHOLE PREFILL: a prompt in chunks lands the same frontier,
   the same last logits and the same greedy continuation as one append.
2. DEEP FRONTIER + n_valid: the frontier advances by n_valid only, and
   stale positions written past it are invisible once overwritten.
3. VERIFY ROLLBACK: a rejected verify leaves no trace.
4. THE ENGINE: a mixed greedy/sampled, spec-on/spec-off workload through
   the port engine gives the JAX engine's greedy streams token for token,
   reproduces sampled streams on resubmit and meets at most the 8 program
   keys (the port's form of "one compiled program").
5. CAPTURE/RESTORE: a slot record excludes the adapter's ``aux_`` state,
   which the pool keeps, the harvest reads and recovery zeroes in place.

Plus the primitives' logits against the JAX adapters' (within 1e-5 of
the largest absolute value: MoE, and long-context across its block-sparse
threshold), the MoE gauges equal to the JAX engine's, the refusals (int8,
prefix and paged pools for MoE; a mesh: ROADMAP items 6 and 10), and the
long-context pins: dense below the threshold, the capacity pin under host
offload, ``sparse_decode=False`` dense.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu.inference as ji
from deepspeed_tpu.inference.adapters import (GPT2Adapter as JGPT2,
                                              LongContextAdapter as JLC,
                                              MoEAdapter as JMoE)
from deepspeed_tpu_torch.inference import (Fault, FaultPlan,
                                           InferenceConfig, InferenceEngine,
                                           ServingFleet)
from deepspeed_tpu_torch.inference.adapters import (GPT2Adapter,
                                                    LongContextAdapter,
                                                    ModelAdapter, MoEAdapter,
                                                    moe)
from deepspeed_tpu_torch.inference.kv_hierarchy import offload
from deepspeed_tpu_torch.inference.kv_pool import reset_pool
from deepspeed_tpu_torch.models import GPT2Config, params_from_jax
from deepspeed_tpu_torch.models.generation import ServingWeights
from deepspeed_tpu_torch.parallel.mesh import build_mesh
from tests.test_torch_inference import models

torch.set_num_threads(1)

KINDS = ("gpt2", "moe", "longcontext")
MOE = dict(vocab_size=256, n_layer=2, n_head=2, n_embd=32, n_positions=128,
           n_experts=4)
ENGINE = {"max_slots": 3, "max_len": 64, "chunk_size": 4, "prefill_chunk": 8}

_ADAPTERS = {}


def adapter_of(kind):
    """((port adapter, port params), (JAX adapter, JAX params), vocab),
    memoized; the long-context threshold sits above every sequence the
    kit builds, as in the JAX kit."""
    if kind not in _ADAPTERS:
        if kind == "moe":
            ja = JMoE.from_config(**MOE)
            jp = ja.init_params(jax.random.PRNGKey(0))
            tree = jax.tree_util.tree_map(np.asarray, jp)
            ta = MoEAdapter.from_config(**MOE)
            tp = moe.params_from_jax(tree, ta.gcfg, "cpu")
            vocab = MOE["vocab_size"]
        else:
            jmodel, jp, tree = models()
            cfg = GPT2Config.tiny(dtype=torch.float32)
            tp = ServingWeights(params_from_jax(tree, cfg, "cpu"))
            vocab = cfg.vocab_size
            if kind == "gpt2":
                ja = JGPT2.from_model(jmodel, use_flash_decode=False)
                ta = GPT2Adapter.from_model(cfg)
            else:
                ja = JLC.from_model(jmodel, threshold=96, block=8,
                                    num_local_blocks=2)
                ta = LongContextAdapter.from_model(cfg, threshold=96,
                                                   block=8,
                                                   num_local_blocks=2)
        _ADAPTERS[kind] = ((ta, tp), (ja, jp, tree), vocab)
    return _ADAPTERS[kind]


def ids_of(vocab, n, seed=5):
    return np.random.RandomState(seed).randint(0, vocab, size=(1, n))


def greedy_decode(adapter, params, tok, cache, steps):
    out = []
    for _ in range(steps):
        logits, cache = adapter.decode_step(params, torch.tensor([tok]),
                                            cache)
        tok = int(torch.argmax(logits[0]))
        out.append(tok)
    return out, cache


def _cache(adapter, n):
    return adapter.init_cache(1, n, device="cpu")


def test_protocol_required_surface_raises_unimplemented():
    base = ModelAdapter()
    with pytest.raises(NotImplementedError):
        base.cache_spec()
    with pytest.raises(NotImplementedError):
        base.init_cache(1, 8)
    with pytest.raises(NotImplementedError):
        base.prepare_params({}, "cpu")
    assert base.bind(None) is base
    assert base.aux_state() == {}
    assert base.param_shardings(None, None) is None
    assert base.observe(None, None) is None
    # Over a mesh an adapter that shards nothing serves replicated: this
    # rank's adapter is itself and its shard is the whole tree.
    mesh = build_mesh(num_mp=2, world_size=2, rank=1)
    assert base.bind(None, mesh) is base
    assert base.param_shardings(mesh, {"w": np.zeros(4)}) is None


@pytest.mark.parametrize("kind", KINDS)
def test_adapter_is_hashable_static_arg(kind):
    (adapter, _), _, _ = adapter_of(kind)
    assert hash(adapter) == hash(adapter)
    assert adapter == type(adapter)(**{
        f.name: getattr(adapter, f.name)
        for f in dataclasses.fields(adapter)})


@pytest.mark.parametrize("kind", KINDS)
def test_chunk_vs_whole_prefill_parity(kind):
    (adapter, params), _, vocab = adapter_of(kind)
    ids = torch.as_tensor(ids_of(vocab, 12))
    whole = _cache(adapter, 32)
    logits_w, whole = adapter.prefill_append(params, ids, whole)
    chunked = _cache(adapter, 32)
    for lo in (0, 4, 8):
        logits_c, chunked = adapter.prefill_append(params, ids[:, lo:lo + 4],
                                                   chunked)
    assert int(whole["pos"][0]) == int(chunked["pos"][0]) == 12
    np.testing.assert_allclose(logits_w[:, -1].numpy(),
                               logits_c[:, -1].numpy(), rtol=2e-5,
                               atol=2e-5)
    tok = int(torch.argmax(logits_w[0, -1]))
    assert tok == int(torch.argmax(logits_c[0, -1]))
    assert greedy_decode(adapter, params, tok, whole, 5)[0] == \
        greedy_decode(adapter, params, tok, chunked, 5)[0]


@pytest.mark.parametrize("kind", KINDS)
def test_append_at_deep_frontier_with_n_valid(kind):
    (adapter, params), _, vocab = adapter_of(kind)
    ids = torch.as_tensor(ids_of(vocab, 28, seed=7))
    clean = _cache(adapter, 48)
    logits, clean = adapter.prefill_append(params, ids, clean)
    want, _ = greedy_decode(adapter, params,
                            int(torch.argmax(logits[0, -1])), clean, 4)
    garbage = torch.as_tensor(ids_of(vocab, 2, seed=99))
    staged = _cache(adapter, 48)
    _, staged = adapter.prefill_append(params, ids[:, :24], staged)
    tail = torch.cat([ids[:, 24:26], garbage], dim=1)
    _, staged = adapter.prefill_append(params, tail, staged,
                                       n_valid=torch.tensor([2]))
    assert int(staged["pos"][0]) == 26
    logits, staged = adapter.prefill_append(params, ids[:, 26:28], staged)
    got, _ = greedy_decode(adapter, params,
                           int(torch.argmax(logits[0, -1])), staged, 4)
    assert got == want


@pytest.mark.parametrize("kind", KINDS)
def test_verify_rollback_is_invisible(kind):
    (adapter, params), _, vocab = adapter_of(kind)
    ids = torch.as_tensor(ids_of(vocab, 10, seed=3))

    def stream(speculate):
        cache = _cache(adapter, 32)
        logits, cache = adapter.prefill_append(params, ids, cache)
        toks = [int(torch.argmax(logits[0, -1]))]
        head, cache = greedy_decode(adapter, params, toks[0], cache, 2)
        toks += head
        if speculate:
            pos0 = int(cache["pos"][0])
            draft = torch.tensor([[toks[-1]] +
                                  ids_of(vocab, 2, seed=42)[0].tolist()])
            vlogits, cache = adapter.verify_forward(params, draft, cache)
            assert vlogits.shape[1] == 3
            assert int(cache["pos"][0]) == pos0
        tail, cache = greedy_decode(adapter, params, toks[-1], cache, 4)
        return toks + tail

    assert stream(True) == stream(False)


@pytest.mark.parametrize("kind", ["moe", "longcontext"])
def test_primitive_logits_equal_jax(kind):
    """A whole-prompt append then three decode steps through the port
    adapter and the JAX one on the same weights: logits within 1e-5 of
    the largest absolute value (the long-context adapter with a threshold
    the prompt crosses, so the block-sparse mask is exercised)."""
    (ta, tp), (ja, jp, _), vocab = adapter_of(kind)
    if kind == "longcontext":
        jmodel = models()[0]
        ja = JLC.from_model(jmodel, threshold=16, block=8,
                            num_local_blocks=2)
        ta = LongContextAdapter.from_model(
            GPT2Config.tiny(dtype=torch.float32), threshold=16, block=8,
            num_local_blocks=2)
    ids = ids_of(vocab, 40, seed=11).astype(np.int32)
    tc, jc = _cache(ta, 64), ja.init_cache(1, 64)
    tl, tc = ta.prefill_append(tp, torch.as_tensor(ids), tc)
    jl, jc = ja.prefill_append(jp, jax.numpy.asarray(ids), jc)
    pairs = [(tl.numpy(), np.asarray(jl))]
    tok = int(np.argmax(np.asarray(jl)[0, -1]))
    for _ in range(3):
        tl, tc = ta.decode_step(tp, torch.tensor([tok]), tc)
        jl, jc = ja.decode_step(jp, jax.numpy.asarray([tok], np.int32), jc)
        pairs.append((tl.numpy(), np.asarray(jl)))
        tok = int(np.argmax(np.asarray(jl)[0]))
    for got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    if kind == "moe":
        for name in ("aux_moe_load", "aux_moe_routed", "aux_moe_dropped"):
            np.testing.assert_array_equal(tc[name].numpy(),
                                          np.asarray(jc[name]))


# ------------------------------------------------------- engine parity


def engines_of(kind, **kw):
    """(port engine, JAX engine) over the same weights."""
    (ta, tp), (ja, jp, tree), _ = adapter_of(kind)
    cfg = dict(ENGINE, **kw)
    jeng = ji.InferenceEngine(None, jp, config=dict(
        cfg, use_flash_decode=False, perf_xray=False), adapter=ja)
    teng = InferenceEngine(None, tree, config=cfg, device="cpu", adapter=ta)
    return teng, jeng


def _mixed(vocab):
    rng = np.random.RandomState(17)
    lens = [5, 9, 6, 12, 7, 8]
    prompts = [rng.randint(0, vocab, size=(n,)).astype(np.int32)
               for n in lens]
    kws = []
    for i in range(len(lens)):
        kw = {"max_new_tokens": 5 + (i % 3)}
        if i % 2:
            kw["temperature"] = 0.7
            kw["seed"] = 100 + i
        if i % 3 == 0:
            kw["spec_decode"] = False
        kws.append(kw)
    return prompts, kws


@pytest.mark.parametrize("kind", KINDS)
def test_engine_mixed_workload_keys_and_parity(kind):
    _, _, vocab = adapter_of(kind)
    teng, jeng = engines_of(kind, spec_decode=True, spec_k=2, spec_ngram=2)
    assert teng.metrics()["adapter"] == jeng.metrics()["adapter"]
    prompts, kws = _mixed(vocab)
    out = {}
    for name, eng in (("port", teng), ("jax", jeng)):
        reqs = []
        for p, kw in zip(prompts, kws):
            reqs.append(eng.submit(p, **kw))
            eng.step()
        eng.run()
        out[name] = reqs
    assert teng.compile_count <= 8
    for i, (t, j) in enumerate(zip(out["port"], out["jax"])):
        assert len(t.tokens) == 5 + (i % 3)
        if i % 2 == 0:
            assert [int(x) for x in t.tokens] == [int(x) for x in j.tokens]
    keys = sorted(teng._programs)
    redo = teng.submit(prompts[1], max_new_tokens=6, temperature=0.7,
                       seed=101)
    teng.run()
    assert redo.tokens == out["port"][1].tokens
    assert sorted(teng._programs) == keys


@pytest.mark.parametrize("kind", KINDS)
def test_capture_restore_round_trip_excludes_aux(kind):
    _, _, vocab = adapter_of(kind)
    teng, _ = engines_of(kind)
    for n in (6, 9):
        teng.submit(ids_of(vocab, n, seed=n)[0], max_new_tokens=8)
    teng.step()
    teng.step()
    pool = teng._pool
    rec = offload.capture_slot(pool, 0)
    assert not any(k.startswith("aux_") for k in rec)
    offload.restore_slot(pool, 1, rec)
    torch.testing.assert_close(pool["k"][:, 1], rec["k"], rtol=0, atol=0)
    torch.testing.assert_close(pool["v"][:, 1], rec["v"], rtol=0, atol=0)
    for name in ("pos", "last_tok", "active"):
        assert torch.equal(pool[name][1], rec[name])
    for name, val in offload.capture_slots(pool, [0, 1])[0].items():
        assert torch.equal(val, rec[name])
    if kind == "moe":
        assert teng._last_snap["aux_moe_load"].shape == (4,)
        load = pool["aux_moe_load"]
        assert float(load.sum()) > 0
        np.testing.assert_array_equal(teng._last_snap["aux_moe_load"],
                                      load.numpy())
        # Recovery's in-place reset zeroes the counters and rebinds
        # nothing (the graphs hold the address).
        reset_pool(pool)
        assert pool["aux_moe_load"] is load and float(load.sum()) == 0


def test_moe_expert_gauges_and_no_drops_equal_jax():
    _, _, vocab = adapter_of("moe")
    teng, jeng = engines_of("moe")
    gauges = {}
    for name, eng in (("port", teng), ("jax", jeng)):
        reqs = [eng.submit(ids_of(vocab, n, seed=n)[0], max_new_tokens=6)
                for n in (6, 10, 7)]
        eng.run()
        reg = eng.telemetry
        gauges[name] = {
            "load": [reg.gauge("moe_expert_load", expert=str(i)).value
                     for i in range(4)],
            "routed": reg.gauge("moe_tokens_routed").value,
            "dropped": reg.gauge("moe_tokens_dropped").value,
            "drop_rate": reg.gauge("moe_drop_rate").value,
            "factor": reg.gauge("moe_capacity_factor").value,
            "imbalance": reg.gauge("moe_expert_load_imbalance").value,
            "tokens": [list(map(int, r.tokens)) for r in reqs]}
    t = gauges["port"]
    assert sum(t["load"]) > 0 and t["routed"] > 0
    assert t["dropped"] == 0.0 and t["drop_rate"] == 0.0
    assert t["factor"] == 4.0 and t["imbalance"] >= 1.0
    assert t == gauges["jax"]
    assert "moe_expert_load" in teng.prometheus()
    # K3-K6 never run in an MoE forward (its attention is the einsum).
    assert all(n == 0 for n in teng.launches.values())


def test_moe_recovery_replays_bit_for_bit():
    """A fatal step fault on an MoE engine: the pool (aux counters too)
    is reset in place and every stream equals the fault-free run."""
    _, _, vocab = adapter_of("moe")
    ref, _ = engines_of("moe")
    prompts = [ids_of(vocab, n, seed=n)[0] for n in (6, 10, 7)]
    want = [ref.submit(p, max_new_tokens=8) for p in prompts]
    ref.run()
    eng, _ = engines_of("moe", fault_injection=True)
    got = [eng.submit(p, max_new_tokens=8) for p in prompts]
    eng.step()
    eng.inject_faults(FaultPlan(faults=(Fault("raise", step=0),)))
    eng.run()
    assert len(eng.recovery_log) == 1
    assert [r.tokens for r in got] == [r.tokens for r in want]


def test_moe_fleet_shares_weights_and_streams_equal():
    (ta, _), (_, _, tree), vocab = adapter_of("moe")
    ref, _ = engines_of("moe")
    prompts = [ids_of(vocab, n, seed=n)[0] for n in (6, 10, 7, 5)]
    want = [ref.submit(p, max_new_tokens=6) for p in prompts]
    ref.run()
    fleet = ServingFleet(None, tree, n_replicas=2, start=False,
                         device="cpu", adapter=ta,
                         config=dict(ENGINE, max_queue=32))
    try:
        frs = [fleet.submit(p, max_new_tokens=6) for p in prompts]
        assert fleet.wait_idle(timeout_s=60.0)
        assert [fr.tokens for fr in frs] == [r.tokens for r in want]
        e0, e1 = (rep.engine for rep in fleet.replicas)
        assert e0._params is e1._params
        assert e0.adapter.name == "moe"
    finally:
        fleet.close()


def test_moe_rejects_hierarchy_tiers():
    (adapter, params), _, vocab = adapter_of("moe")
    cache = _cache(adapter, 16)
    bad = dict(cache, k=cache["k"].to(torch.int8),
               v=cache["v"].to(torch.int8))
    with pytest.raises(ValueError, match="plain fp"):
        adapter.prefill_append(params, torch.as_tensor(ids_of(vocab, 4)),
                               bad)
    for setting in ({"int8_kv": True}, {"prefix_cache": True},
                    {"paged_kv": True}):
        with pytest.raises(ValueError):
            adapter.bind(InferenceConfig(**dict(ENGINE, **setting)))


# ----------------------------------------------- long-context specifics


def _lc_engines(threshold, max_slots=3, **kw):
    jmodel, jp, tree = models()
    cfg = GPT2Config.tiny(dtype=torch.float32)
    config = dict(ENGINE, max_slots=max_slots, **kw)
    ta = LongContextAdapter.from_model(cfg, threshold=threshold, block=8,
                                       num_local_blocks=2)
    ja = JLC.from_model(jmodel, threshold=threshold, block=8,
                        num_local_blocks=2)
    teng = InferenceEngine(cfg, tree, config=config, device="cpu",
                           adapter=ta)
    jeng = ji.InferenceEngine(None, jp, config=dict(
        config, use_flash_decode=False, perf_xray=False), adapter=ja)
    return teng, jeng


def _prompts(lengths, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 1024, size=n).astype(np.int32) for n in lengths]


def _serve(eng, prompts, news):
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    eng.run()
    return [[int(t) for t in r.tokens] for r in reqs]


def test_longcontext_below_threshold_token_identical_to_dense():
    teng, jeng = _lc_engines(32)
    assert teng.metrics()["adapter"] == "longcontext"
    dense = InferenceEngine(GPT2Config.tiny(dtype=torch.float32),
                            models()[2], config=ENGINE, device="cpu")
    prompts = _prompts([5, 9, 6])
    got = _serve(teng, prompts, [8] * 3)
    assert got == _serve(dense, prompts, [8] * 3)
    assert got == _serve(jeng, prompts, [8] * 3)
    assert all(n == 0 for n in teng.launches.values())
    assert teng.compile_count <= 8


def test_longcontext_capacity_pin_sparse_decode_with_host_offload():
    teng, jeng = _lc_engines(32, max_slots=2, host_offload=True,
                             swap_slots=8)
    prompts = _prompts([8, 6, 7, 9], seed=21)
    news = [40, 38, 36, 34]
    got = _serve(teng, prompts, news)
    assert [len(t) for t in got] == news
    m = teng.metrics()
    assert m["swap_outs"] >= 1 and m["swap_ins"] >= 1
    assert teng.telemetry.gauge("sparse_decode_threshold").value == 32.0
    assert got == _serve(jeng, prompts, news)


def test_longcontext_no_sparse_decode_flag_is_dense():
    teng, jeng = _lc_engines(16, max_slots=2, sparse_decode=False)
    assert teng.adapter.threshold == 0
    prompts = _prompts([7], seed=4)
    got = _serve(teng, prompts, [30])
    assert got == _serve(jeng, prompts, [30])
    dense = InferenceEngine(GPT2Config.tiny(dtype=torch.float32),
                            models()[2], config=dict(ENGINE, max_slots=2),
                            device="cpu")
    assert got == _serve(dense, prompts, [30])


def test_longcontext_paged_int8_pool_gathers_and_dequantizes():
    """The einsum path over a paged int8 pool (gathered through the table,
    dequantized before the mask): the JAX long-context engine's streams
    on the same pool."""
    teng, jeng = _lc_engines(16, paged_kv=True, kv_page_len=8,
                             int8_kv=True)
    prompts = _prompts([9, 6, 12], seed=8)
    assert _serve(teng, prompts, [20] * 3) == _serve(jeng, prompts,
                                                     [20] * 3)


def test_longcontext_ring_fallback_on_seq_mesh_is_refused():
    cfg = GPT2Config.tiny(dtype=torch.float32)
    adapter = LongContextAdapter.from_model(cfg, threshold=32, block=8,
                                            num_local_blocks=2)
    with pytest.raises(NotImplementedError, match="item 10"):
        adapter.bind(InferenceConfig(), object())
    assert adapter.bind(InferenceConfig(), None).mode == "block_sparse"
    with pytest.raises(NotImplementedError, match="use_flash_decode"):
        GPT2Adapter.from_model(cfg, use_flash_decode=False)
