"""Port parity: the serving engine's step program and its compile_count
contract, against the JAX package's engine, on the CPU.

The port's step is one program per key (prefill lane present, any row
samples, any row filters top-k; ``inference/engine.py``), captured as a
CUDA graph on the card and run eagerly here, where the keys are recorded
alike. The JAX engine compiles one program whatever the mix:

- a canned mix of prompt lengths trickled in while slots churn (the mix of
  the JAX ``test_compile_count_regression_guard``) adds no program after
  warm-up, in the dense, paged and paged int8 layouts, and its greedy
  tokens equal the JAX engine's;
- a sampled row and a top-k row add exactly their new keys;
- the prefill lane, whose slot, frontier, slice length and request facts
  are tensors, writes the planes and per-slot fields the JAX lane writes,
  for a mid-prompt and a final slice, dense and paged;
- the pool's tensors and the step's input and harvest buffers keep their
  addresses across steps (a captured graph replays against them).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu.inference.engine import (
    _mixed_step_program as jax_mixed_step)
from deepspeed_tpu_torch.inference import kv_pool
from deepspeed_tpu_torch.inference.engine import _prefill_lane
from tests.test_torch_inference import SERVE, models, port_engine, prompts

torch.set_num_threads(1)

LAYOUTS = {"dense": {}, "paged": {"paged_kv": True, "kv_page_len": 8},
           "paged_int8": {"paged_kv": True, "kv_page_len": 8,
                          "int8_kv": True}}
GREEDY_KEYS = {(True, False, False), (False, False, False)}


def jax_engine(**extra):
    jmodel, params, _ = models()
    return JEngine(jmodel, params, config=dict(
        SERVE, max_queue=32, use_flash_decode=False, telemetry=False,
        perf_xray=False, **extra))


def _canned_mix(submit, step, run):
    """The JAX ``test_compile_count_regression_guard`` stream: short,
    boundary and long prompts (prefill_chunk 8), three at once, then the
    rest one per step while slots churn."""
    lens = [3, 7, 8, 9, 16, 33, 40, 5]
    news = [5, 4, 6, 3, 5, 4, 6, 5]
    ps = prompts(lens)
    reqs = [submit(ps[i], news[i]) for i in range(3)]
    step()
    for i in range(3, len(ps)):
        reqs.append(submit(ps[i], news[i]))
        step()
    run()
    return reqs


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_prompt_length_mix_adds_no_program_after_warmup(layout):
    eng = port_engine(max_queue=32, **LAYOUTS[layout])
    # Warm-up: one request through its prefill lane and, a step later,
    # its decode lane alone meets both greedy keys.
    eng.submit(prompts([3], seed=8)[0], max_new_tokens=9)
    eng.run()
    assert set(eng._programs) == GREEDY_KEYS
    warm = eng.compile_count
    assert warm == 2
    got = _canned_mix(lambda p, n: eng.submit(p, max_new_tokens=n),
                      eng.step, eng.run)
    assert eng.compile_count == warm, \
        "a prompt-length mix added a program: {}".format(eng._programs)
    m = eng.metrics()
    assert m["compile_count"] == warm
    assert m["graph_replays"] == m["chunks"] - warm
    assert m["capture_ms"] == 0.0 and m["graph_pool_bytes"] == 0  # CPU
    jeng = jax_engine(**LAYOUTS[layout])
    want = _canned_mix(lambda p, n: jeng.submit(p, max_new_tokens=n),
                       jeng.step, jeng.run)
    assert jeng.compile_count == 1
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [len(r.tokens) for r in got] == [5, 4, 6, 3, 5, 4, 6, 5]
    if eng.kv_page_stats() is not None:
        assert eng.kv_page_stats()["pages_in_use"] == 0


def test_sampled_and_top_k_rows_add_exactly_their_keys():
    eng = port_engine(max_queue=32)
    ps = prompts([11, 4, 9, 13, 6, 10], seed=17)
    eng.submit(ps[0], max_new_tokens=9)
    eng.run()
    assert set(eng._programs) == GREEDY_KEYS
    # A sampled row: its final slice samples, then its decode steps do.
    eng.submit(ps[1], max_new_tokens=9, temperature=0.8, seed=3)
    eng.run()
    sampled = {(True, True, False), (False, True, False)}
    assert set(eng._programs) == GREEDY_KEYS | sampled
    assert eng.compile_count == 4
    # A top-k row (sampling too).
    eng.submit(ps[2], max_new_tokens=9, temperature=0.8, top_k=5, seed=4)
    eng.run()
    top_k = {(True, True, True), (False, True, True)}
    assert set(eng._programs) == GREEDY_KEYS | sampled | top_k
    assert eng.compile_count == 6
    # Greedy, sampled and top-k rows together meet only known keys.
    for i, p in enumerate(ps[3:]):
        kw = [{}, {"temperature": 1.1, "seed": 9},
              {"temperature": 0.7, "top_k": 3, "seed": 2}][i]
        eng.submit(p, max_new_tokens=6, **kw)
        eng.step()
    eng.run()
    assert eng.compile_count == 6
    m = eng.metrics()
    assert m["graph_replays"] == m["chunks"] - 6


def _put(jpool, tpool, name, value):
    jpool[name] = jnp.asarray(value, dtype=jpool[name].dtype)
    tpool[name].copy_(torch.as_tensor(np.asarray(value)).to(
        tpool[name].dtype))


def _lane_state(jeng, teng, seed):
    """The same random pool in both engines: planes (and, paged, a
    shuffled block table) and per-slot fields."""
    rng = np.random.RandomState(seed)
    jpool, tpool = dict(jeng._pool), teng._pool
    T = tpool["k"].shape[3]
    for name in ("k", "v"):
        shape = tpool[name].shape
        # The JAX plane is the port's (max_len + slack, not padded).
        assert jpool[name].shape[:3] == shape[:3]
        assert jpool[name].shape[3] == T
        _put(jpool, tpool, name, rng.standard_normal(shape).astype(
            np.float32))
    if "block_tbl" in tpool:
        tbl = tpool["block_tbl"]
        perm = rng.permutation(tpool["k"].shape[1] - 1) + 1
        _put(jpool, tpool, "block_tbl",
             perm[:tbl.numel()].reshape(tuple(tbl.shape)).astype(np.int32))
    S = tpool["pos"].shape[0]
    _put(jpool, tpool, "pos", rng.randint(0, 40, S).astype(np.int32))
    _put(jpool, tpool, "last_tok", rng.randint(0, 1024, S))
    _put(jpool, tpool, "active", np.array([True, False, True]))
    _put(jpool, tpool, "remaining", rng.randint(1, 9, S).astype(np.int32))
    _put(jpool, tpool, "eos", np.array([-1, 7, 2]))
    _put(jpool, tpool, "temp", np.array([0.5, 0.0, 1.2], np.float32))
    _put(jpool, tpool, "top_k", np.array([0, 4, 0], np.int32))
    _put(jpool, tpool, "seed", np.array([5, 6, 7]))
    return jpool


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_traced_prefill_lane_writes_what_the_jax_lane_writes(layout):
    jeng = jax_engine(**LAYOUTS[layout])
    teng = port_engine(**LAYOUTS[layout])
    jpool = _lane_state(jeng, teng, seed=31)
    C = SERVE["prefill_chunk"]
    prompt = prompts([21], seed=19)[0]
    inp = kv_pool.step_inputs(SERVE["max_slots"], C, "cpu")
    # (frontier, n_valid, done, max_new, eos, temp, top_k, seed): a
    # mid-prompt slice of a sampled request (nothing but pos installs),
    # then the final, ragged slice of a greedy one.
    for frontier, n, done, max_new, eos, temp, top_k, seed in (
            (8, 8, False, 6, -1, 0.7, 5, 11), (16, 5, True, 6, 3, 0.0, 0, 12)):
        ids = np.zeros((1, C), np.int64)
        ids[0, :n] = prompt[frontier:frontier + n]
        jpool, jfirst, _, _ = jax_mixed_step(
            jeng._params, jeng._adapter, 0, None, jpool,
            jnp.asarray(ids, jnp.int32), jnp.int32(1), jnp.int32(frontier),
            jnp.int32(n), jnp.asarray(done), jnp.asarray(False),
            jnp.int32(max_new), jnp.int32(eos), jnp.float32(temp),
            jnp.int32(top_k), jnp.uint32(seed))
        kv_pool.clear_step_inputs(inp)
        h = inp.host
        h["ids"][...] = ids
        h["slot"][0], h["frontier"][0], h["n_valid"][0] = 1, frontier, n
        h["done"][0], h["max_new"][0], h["eos"][0] = done, max_new, eos
        h["temp"][0], h["top_k"][0], h["seed"][0] = temp, top_k, seed
        inp.upload()
        with torch.no_grad():
            first = _prefill_lane(teng._params, teng._adapter, teng._pool,
                                  inp.dev, temp > 0, top_k > 0)
        assert first.tolist() == [int(jfirst)]
        assert (first.item() >= 0) == done
        tpool = teng._pool
        for name in ("pos", "last_tok", "active", "remaining", "eos", "temp",
                     "top_k", "seed"):
            np.testing.assert_array_equal(
                tpool[name].numpy(),
                np.asarray(jpool[name]).astype(tpool[name].numpy().dtype),
                err_msg=name)
        for name in ("k", "v"):
            np.testing.assert_allclose(tpool[name].numpy(),
                                       np.asarray(jpool[name]), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
        assert tpool["pos"][1] == frontier + n


@pytest.mark.parametrize("layout", ["dense", "paged_int8"])
def test_pool_and_step_buffers_keep_their_addresses(layout):
    eng = port_engine(**LAYOUTS[layout])
    pool = eng._pool
    tensors = dict(pool)
    tensors.update(("in_" + k, t) for k, t in eng._inputs.dev.items())
    tensors.update(("out_" + k, t) for k, t in eng._harvest.dev.items())
    ptrs = {name: t.data_ptr() for name, t in tensors.items()}
    ps = prompts([12, 5, 20, 9], seed=23)
    reqs = [eng.submit(p, max_new_tokens=7,
                       temperature=0.9 if i == 1 else 0.0, seed=i)
            for i, p in enumerate(ps)]
    steps = 0
    while not eng.idle:
        eng.step()
        steps += 1
        assert eng._pool is pool
        assert all(pool[name] is tensors[name] for name in pool)
        assert {name: t.data_ptr() for name, t in tensors.items()} == ptrs
    assert steps > 4 and all(len(r.tokens) == 7 for r in reqs)
