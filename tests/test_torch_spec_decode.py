"""Port parity: speculative decoding against the JAX package, on the CPU.

The contracts of the JAX package's ``tests/unit/test_spec_decode.py``, held
on the port at tiny fp32 sizes with the same numpy inputs and the weights
carried across by ``params_from_jax``:

- the primitives: ``ngram_draft`` (most recent match, no-match fallback,
  frontier mask, continuation clip) and ``accept_counts`` (prefix rule,
  veto) equal the JAX functions exactly; ``verify_forward`` gives the JAX
  logits and planes on dense, int8, paged and paged int8 caches, leaves the
  frontier where it was, and scores what stepwise ``decode_step`` scores;
  a verify or ring write past the plane raises;
- the step program: from one random pool, the port's spec step (prefill
  lane and draft/verify decode lane) writes the JAX program's harvest,
  per-slot fields, token ring and planes;
- the engine: greedy streams equal the JAX spec engine's and the port's
  ``generate()`` token for token across chunk sizes and draft lengths;
  sampled streams are the same with speculation on and off; EOS cuts
  inside the accepted prefix; requests that opt out ride the same
  programs; acceptance exceeds one token per step on a repetitive prompt
  and the accept statistics equal the JAX engine's; paged engines drain;
- config: validation, ``resolved_spec_decode``, the submit guard and the
  plane slack floor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu.inference import kv_pool as jkv
from deepspeed_tpu.inference.engine import (
    _mixed_step_program as jax_mixed_step)
from deepspeed_tpu.inference.kv_hierarchy import HierarchySpec as JHier
from deepspeed_tpu.models import generation as jgen
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.inference import InferenceConfig, kv_pool
from deepspeed_tpu_torch.inference.engine import (
    _mixed_step_program, _spec_decode_chunk_program)
from deepspeed_tpu_torch.inference.kv_hierarchy import HierarchySpec
from deepspeed_tpu_torch.models import GPT2Config
from deepspeed_tpu_torch.models import generation as tgen
from tests.test_torch_generation import models as gen_models
from tests.test_torch_inference import SERVE, models, port_engine, prompts
from tests.test_torch_serving_graph import LAYOUTS, _lane_state, _put

torch.set_num_threads(1)

SPEC = {"spec_decode": True, "spec_k": 4, "spec_ngram": 3}


def jax_engine(**extra):
    jmodel, params, _ = models()
    return JEngine(jmodel, params, config=dict(
        SERVE, max_queue=32, use_flash_decode=False, telemetry=False,
        perf_xray=False, **extra))


def rep_prompt(phrase=4, reps=5, seed=0):
    """One short random phrase tiled: the drafter's best case."""
    rng = np.random.RandomState(seed)
    return np.tile(rng.randint(0, 1024, size=(phrase,)),
                   reps).astype(np.int32)


def port_greedy(prompt, n):
    _, _, port = gen_models()
    return tgen.generate(port, np.asarray(prompt)[None], n,
                         temperature=0.0)[0].tolist()


def _serve(eng, reqs):
    """Submit (prompt, kwargs) pairs, run to idle; the token lists."""
    handles = [eng.submit(p, **kw) for p, kw in reqs]
    eng.run()
    return [h.tokens for h in handles]


# ------------------------------------------------------------- primitives


@pytest.mark.parametrize("n,k", [(1, 1), (2, 3), (3, 4), (4, 2)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_draft_matches_jax_on_seeded_rings(seed, n, k):
    """Rings over a 3-token vocabulary (many matches, many of them past the
    frontier) at frontiers from 0 to the ring's last entry."""
    rng = np.random.RandomState(seed)
    B, T = 12, 24
    toks = rng.randint(0, 3, size=(B, T)).astype(np.int32)
    pos = rng.randint(0, T, size=B).astype(np.int32)
    pos[:3] = [0, T - 1, n - 1]
    want = np.asarray(jgen.ngram_draft(jnp.asarray(toks), jnp.asarray(pos),
                                       n, k))
    got = tgen.ngram_draft(torch.from_numpy(toks).long(),
                           torch.from_numpy(pos), n, k)
    assert got.dtype == torch.int64 and tuple(got.shape) == (B, k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ngram_draft_most_recent_match_fallback_mask_and_clip():
    """The JAX test's rows: the most recent of two matches wins; no match
    drafts the frontier token; a match past the frontier is ignored; a
    match just below the frontier drafts its clipped continuation."""
    T, fill = 16, 100
    rows = np.full((4, T), fill, np.int64) + np.arange(4 * T).reshape(4, T)
    rows[0, :10] = [1, 2, 9, 9, 1, 2, 7, 8, 1, 2]
    rows[1, :4] = [3, 4, 5, 6]
    rows[2, :8] = [9, 8, 7, 6, 1, 2, 1, 2]
    rows[3, :4] = [1, 2, 1, 2]
    pos = np.array([9, 3, 5, 3], np.int32)
    got = tgen.ngram_draft(torch.from_numpy(rows), torch.from_numpy(pos),
                           2, 3).numpy()
    want = np.asarray(jgen.ngram_draft(jnp.asarray(rows, jnp.int32),
                                       jnp.asarray(pos), 2, 3))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[7, 8, 1], [6, 6, 6], [2, 2, 2],
                                        [1, 2, 2]])


@pytest.mark.parametrize("veto", [None, "row", "lane"])
def test_accept_counts_match_jax(veto):
    rng = np.random.RandomState(4)
    B, K = 32, 4
    choices = rng.randint(0, 2, size=(B, K + 1))
    # Mostly agreeing drafts with a flipped token somewhere.
    draft = np.where(rng.rand(B, K) < 0.2, 1 - choices[:, :K],
                     choices[:, :K])
    ok = None
    if veto == "row":
        ok = rng.rand(B, 1) < 0.7
    elif veto == "lane":
        ok = rng.rand(B, K) < 0.9
    want = np.asarray(jgen.accept_counts(
        jnp.asarray(draft), jnp.asarray(choices),
        ok=None if ok is None else jnp.asarray(ok)))
    got = tgen.accept_counts(torch.from_numpy(draft),
                             torch.from_numpy(choices),
                             ok=None if ok is None else torch.from_numpy(ok))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 1 and got.max() <= K + 1
    if veto == "row":
        assert (got.numpy()[~ok[:, 0]] == 1).all()


def _caches(layout, B=3, max_len=32, slack=8, page_len=8):
    """Matching pools of both packages for ``layout`` (paged: the same
    shuffled block table), as caches over every slot."""
    jcfg, _, port = gen_models()
    int8 = "int8" in layout
    page_len = page_len if "paged" in layout else 0
    jpool = jkv.init_pool(jgen.as_gencfg(jcfg, use_flash_decode=False), B,
                          max_len, slack=slack,
                          hier=JHier(int8=True) if int8 else None,
                          page_len=page_len)
    tpool = kv_pool.init_pool(tgen.as_gencfg(port.config), B, max_len,
                              slack=slack, device="cpu",
                              hier=HierarchySpec(int8=int8),
                              page_len=page_len)
    if page_len:
        tbl = tpool["block_tbl"]
        perm = np.random.RandomState(6).permutation(tbl.numel()) + 1
        _put(jpool, tpool, "block_tbl",
             perm.reshape(tuple(tbl.shape)).astype(np.int32))
    return jkv.cache_view(jpool), kv_pool.cache_view(tpool)


def _assert_planes(jcache, tcache):
    for name in ("k", "v", "k_scale", "v_scale"):
        if name not in tcache:
            continue
        got, want = tcache[name].numpy(), np.asarray(jcache[name])
        if got.dtype == np.int8:
            # One k/v rounding apart, a code may land one step over.
            assert np.abs(got.astype(np.int32) - want).max() <= 1, name
        else:
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), \
                name


@pytest.mark.parametrize("layout", ["dense", "int8", "paged", "paged_int8"])
def test_verify_forward_matches_jax_and_stepwise_decode(layout):
    """A ragged prefill (n_valid 8, 5, 3), then one verify of S = 5 rows:
    the JAX logits within 1e-5 of their max-abs, the JAX planes, the
    frontier unmoved; the same rows through five decode_steps give the
    verify's logits (GEMM shapes differ: 1e-4 relative) and argmax, and
    write the same k/v."""
    jcfg, params, port = gen_models()
    jg = jgen.as_gencfg(jcfg, use_flash_decode=False)
    jcache, tcache = _caches(layout)
    rng = np.random.RandomState(7)
    ids = rng.randint(0, 1024, (3, 8))
    nv = np.array([8, 5, 3], np.int32)
    _, jcache = jgen.append_forward(params, jg, jnp.asarray(ids), jcache,
                                    n_valid=jnp.asarray(nv))
    _, tcache = tgen.append_forward(port, torch.from_numpy(ids), tcache,
                                    n_valid=torch.from_numpy(nv))
    stepwise = {name: t.clone() for name, t in tcache.items()}
    vids = rng.randint(0, 1024, (3, 5))
    jl, jver = jgen.verify_forward(params, jg, jnp.asarray(vids), jcache)
    tl, tver = tgen.verify_forward(port, torch.from_numpy(vids), tcache)
    jl = np.asarray(jl)
    assert np.abs(tl.numpy() - jl).max() <= 1e-5 * np.abs(jl).max()
    assert tver["pos"] is tcache["pos"]
    np.testing.assert_array_equal(tver["pos"].numpy(), nv)
    np.testing.assert_array_equal(np.asarray(jver["pos"]), nv)
    _assert_planes(jver, tver)
    for i in range(5):
        sl, stepwise = tgen.decode_step(port, torch.from_numpy(vids[:, i]),
                                        stepwise)
        np.testing.assert_allclose(sl.numpy(), tl[:, i].numpy(), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_array_equal(sl.argmax(-1).numpy(),
                                      tl[:, i].argmax(-1).numpy())
    np.testing.assert_array_equal(stepwise["pos"].numpy(), nv + 5)
    for name in ("k", "v", "k_scale", "v_scale"):
        if name in tver:
            a, b = stepwise[name].float(), tver[name].float()
            assert float((a - b).abs().max()) <= 1e-5 * max(
                float(b.abs().max()), 1.0), name


def test_verify_and_ring_writes_past_the_plane_raise():
    """No clamp: a verify that would write past the plane, and a ring write
    past the ring, raise (an IndexError here, a device-side assert on the
    card) rather than land on live positions."""
    _, _, port = gen_models()
    cache = tgen.init_cache(tgen.as_gencfg(port.config), 1, 16,
                            device="cpu")
    cache["pos"][0] = 12
    with pytest.raises(IndexError):
        tgen.verify_forward(port, torch.zeros(1, 5, dtype=torch.int64),
                            cache)
    # A frozen row as deep as the verify's k/v writes allow: its ring
    # write one past them runs off a ring of the plane's length.
    eng = port_engine(**SPEC)
    pool = eng._pool
    plane = pool["toks"].shape[1]
    assert pool["k"].shape[3] == plane
    pool["pos"][0] = plane - 5
    harvest = kv_pool.step_harvest(SERVE["max_slots"], 1, "cpu", lanes=5)
    with torch.no_grad(), pytest.raises(IndexError):
        _spec_decode_chunk_program(eng._params, eng.adapter, 1, 4, 3, pool,
                                   harvest.dev, False, False)


# ----------------------------------------------------------- the program


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_spec_step_program_writes_what_the_jax_program_writes(layout):
    """From one random pool (planes, table, per-slot fields, a ring of
    tiled phrases, one slot opted out), two spec steps of the mixed
    program with the prefill lane finishing a prompt: the harvests, the
    first token, the per-slot fields, the ring and the planes equal the
    JAX program's (greedy rows: the samplers' bits differ)."""
    jeng = jax_engine(**dict(SPEC, **LAYOUTS[layout]))
    teng = port_engine(**dict(SPEC, **LAYOUTS[layout]))
    jpool = _lane_state(jeng, teng, seed=41)
    tpool = teng._pool
    rng = np.random.RandomState(43)
    ring = np.tile(rng.randint(0, 1024, (3, 5)), (1, 15))[:,
                                                          :tpool["toks"]
                                                          .shape[1]]
    _put(jpool, tpool, "toks", ring)
    _put(jpool, tpool, "temp", np.zeros(3, np.float32))
    _put(jpool, tpool, "top_k", np.zeros(3, np.int32))
    _put(jpool, tpool, "remaining", np.array([9, 3, 2], np.int32))
    _put(jpool, tpool, "spec", np.array([True, True, False]))
    C = SERVE["prefill_chunk"]
    prompt = prompts([13], seed=21)[0]
    ids = np.zeros((1, C), np.int64)
    ids[0, :5] = prompt[8:13]
    chunk = 2
    jpool, jfirst, jtoks, jvalid = jax_mixed_step(
        jeng._params, jeng._adapter, chunk, (4, 3), jpool,
        jnp.asarray(ids, jnp.int32), jnp.int32(1), jnp.int32(8),
        jnp.int32(5), jnp.asarray(True), jnp.asarray(True), jnp.int32(6),
        jnp.int32(-1), jnp.float32(0.0), jnp.int32(0), jnp.uint32(3))
    inp = kv_pool.step_inputs(SERVE["max_slots"], C, "cpu")
    h = inp.host
    h["ids"][...] = ids
    h["slot"][0], h["frontier"][0], h["n_valid"][0] = 1, 8, 5
    h["done"][0], h["spec"][0], h["max_new"][0] = True, True, 6
    h["seed"][0] = 3
    inp.upload()
    harvest = kv_pool.step_harvest(SERVE["max_slots"], chunk, "cpu", lanes=5)
    with torch.no_grad():
        _mixed_step_program(teng._params, teng.adapter, chunk, (4, 3), tpool,
                            inp.dev, harvest.dev, True, False, False)
    snap = harvest.read()
    assert snap["first"].tolist() == [int(jfirst)]
    np.testing.assert_array_equal(snap["valid"], np.asarray(jvalid))
    np.testing.assert_array_equal(snap["toks"], np.asarray(jtoks))
    assert snap["valid"].sum() > chunk  # the harvest holds every lane
    for name in ("pos", "last_tok", "active", "remaining", "spec", "toks"):
        np.testing.assert_array_equal(
            tpool[name].numpy(),
            np.asarray(jpool[name]).astype(tpool[name].numpy().dtype),
            err_msg=name)
    for name in ("k", "v"):
        np.testing.assert_allclose(tpool[name].numpy(),
                                   np.asarray(jpool[name]), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


# ------------------------------------------------------------- the engine


_JAX_STREAMS = {}


def _jax_streams(reqs, **extra):
    key = repr((reqs, sorted(extra.items())))
    if key not in _JAX_STREAMS:
        jeng = jax_engine(**extra)
        out = _serve(jeng, reqs)
        _JAX_STREAMS[key] = (out, jeng.metrics(), jeng._accept_hist.copy())
    return _JAX_STREAMS[key]


@pytest.mark.parametrize("spec_k", [1, 2, 4])
@pytest.mark.parametrize("chunk_size", [1, 4])
def test_greedy_streams_match_jax_spec_engine_and_generate(spec_k,
                                                           chunk_size):
    """Rejection rollback is invisible wherever it lands: a repetitive
    prompt (drafts mostly accepted) and a random one (mostly rejected)."""
    reqs = [(rep_prompt(phrase=3, reps=4, seed=2), {"max_new_tokens": 15}),
            (prompts([17])[0], {"max_new_tokens": 12})]
    extra = dict(SPEC, spec_k=spec_k, chunk_size=chunk_size)
    want, _, _ = _jax_streams([(p.tolist(), kw) for p, kw in reqs], **extra)
    got = _serve(port_engine(**extra), reqs)
    assert got == want
    assert got == [port_greedy(p, kw["max_new_tokens"]) for p, kw in reqs]


def test_sampled_streams_identical_spec_on_and_off():
    """Every choice is drawn at its own (seed, position): the verify lane's
    draws are the plain lane's, so the streams are the same, not merely
    alike."""
    reqs = [(rep_prompt(seed=1), dict(max_new_tokens=14, temperature=0.8,
                                      top_k=20, seed=5)),
            (rep_prompt(phrase=3, seed=6), dict(max_new_tokens=11,
                                                temperature=1.1, seed=9)),
            (prompts([10])[0], {"max_new_tokens": 9})]
    on = _serve(port_engine(**SPEC), reqs)
    off = _serve(port_engine(), reqs)
    assert on == off
    assert len(set(on[0])) > 1


def _verify_groups(eng, prompt, n):
    """Serve one greedy request step by step; the tokens each verify (one
    of a step's chunk_size) accepted for it."""
    req = eng.submit(prompt, max_new_tokens=n)
    groups = []
    while not eng.idle:
        slot = req.slot
        eng.step()
        if slot is None:
            continue
        snap = eng._last_snap
        for toks, valid in zip(snap["toks"][:, slot],
                               snap["valid"][:, slot]):
            if valid.any():
                groups.append(toks[valid].tolist())
    return req.tokens, groups


def test_eos_truncation_within_the_accepted_prefix():
    """An EOS that a verify accepts as a draft, with more drafts after it,
    ends the stream AT the EOS, as the plain lane emits it; the JAX spec
    engine stops at the same token. (This prompt's greedy stream holds
    such a token: the first occurrence of a token inside a verify that
    accepted 5.)"""
    p = prompts([5], seed=5)[0]
    free, groups = _verify_groups(port_engine(**SPEC), p, 20)
    assert free == port_greedy(p, 20)
    at, cases = 1, []  # the first token comes from the prefill lane
    for g in groups:
        # (offset in the verify's accepted tokens, index in the stream)
        cases += [(i - at, i) for i in range(at, at + len(g) - 1)
                  if free.index(free[i]) == i]
        at += len(g)
    offset, i = max(cases)
    assert offset > 0  # a drafted token, not the verify's first choice
    eos, want = free[i], free[:i + 1]
    eng = port_engine(**SPEC)
    got = _serve(eng, [(p, dict(max_new_tokens=20, eos_token_id=eos))])
    assert got == [want] and len(want) < 20
    assert _jax_streams([(p.tolist(), dict(max_new_tokens=20,
                                           eos_token_id=eos))],
                        **SPEC)[0] == [want]


def test_budget_cuts_an_accepted_draft():
    """A budget that ends inside a verify that would accept more: the
    stream stops at the budget, equal to generate()'s prefix and the JAX
    spec engine's."""
    p = rep_prompt()
    free, groups = _verify_groups(port_engine(**SPEC), p, 20)
    done = 1 + sum(len(g) for g in groups[:next(
        i for i, g in enumerate(groups) if len(g) > 2)])
    n = done + 1  # one token into the long step
    got = _serve(port_engine(**SPEC), [(p, {"max_new_tokens": n})])
    assert got == [free[:n]]
    assert _jax_streams([(p.tolist(), {"max_new_tokens": n})],
                        **SPEC)[0] == [free[:n]]


def test_opted_out_requests_ride_the_same_programs():
    """submit(spec_decode=False) vetoes agreement through the slot's spec
    field: one token per step beside a speculating neighbour, in the same
    programs (compile_count and keys equal a spec-off engine's on the
    same traffic, sampled rows included)."""
    reqs = [(rep_prompt(), {"max_new_tokens": 16}),
            (prompts([9])[0], dict(max_new_tokens=10, spec_decode=False)),
            (rep_prompt(seed=4), dict(max_new_tokens=8, temperature=0.9,
                                      seed=2, spec_decode=False))]
    spec = port_engine(**SPEC)
    got = _serve(spec, reqs)
    plain = port_engine()
    want = _serve(plain, [(p, {k: v for k, v in kw.items()
                               if k != "spec_decode"}) for p, kw in reqs])
    assert got == want
    assert got[0] == port_greedy(reqs[0][0], 16)
    assert spec.compile_count == plain.compile_count
    assert sorted(spec._programs) == sorted(plain._programs)


def test_acceptance_and_accept_statistics_match_jax():
    """On a repetitive prompt the drafter finds the phrase: more than one
    token per occupied step; the histogram and the accept metrics equal the
    JAX engine's on the same greedy stream."""
    reqs = [(rep_prompt(), {"max_new_tokens": 20}),
            (prompts([7])[0], {"max_new_tokens": 6})]
    eng = port_engine(**SPEC)
    got = _serve(eng, reqs)
    want, jm, jhist = _jax_streams([(p.tolist(), kw) for p, kw in reqs],
                                   **SPEC)
    assert got == want
    np.testing.assert_array_equal(eng._accept_hist, jhist)
    m = eng.metrics()
    for key in ("spec_decode", "spec_k", "spec_ngram",
                "accepted_per_step_mean", "accepted_per_step_p50",
                "accepted_per_step_p99", "draft_accept_rate"):
        assert m[key] == jm[key], key
    assert m["accepted_per_step_mean"] > 1.0 and m["draft_accept_rate"] > 0
    assert m["accepted_per_step_p99"] <= 5 and m["tokens_out"] == 26


def test_nonspec_engine_metrics_omit_accept_stats():
    eng = port_engine()
    _serve(eng, [(prompts([5])[0], {"max_new_tokens": 3})])
    m = eng.metrics()
    assert m["spec_decode"] is False
    assert not {"spec_k", "spec_ngram", "accepted_per_step_mean",
                "accepted_per_step_p50", "accepted_per_step_p99",
                "draft_accept_rate"} & set(m)
    assert eng._harvest.dev["toks"].shape[2] == 1 and "toks" not in eng._pool


def test_plane_slack_floor_covers_verify_and_ring_writes():
    """slack = max(prefill_chunk, spec_k + 1): at prefill_chunk 2 a request
    that fills max_len drives its frontier to max_len - 1, where its frozen
    verifies write k/v through max_len + 3 and ring entries through max_len
    + 4, the plane's last; nothing raises and the stream is generate()'s."""
    eng = port_engine(**dict(SPEC, prefill_chunk=2))
    assert eng._pool["k"].shape[3] == 64 + 5
    assert tuple(eng._pool["toks"].shape) == (3, 64 + 5)
    p = rep_prompt(phrase=5, reps=8, seed=8)
    got = _serve(eng, [(p, {"max_new_tokens": 24})])
    assert got == [port_greedy(p, 24)]
    assert eng._pool["pos"].max() == 63
    eng = port_engine(**dict(SPEC, prefill_chunk=8))
    assert eng._pool["k"].shape[3] == 64 + 8
    assert tuple(eng._pool["toks"].shape) == (3, 64 + 8)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_paged_spec_engine_equals_dense_and_drains(int8):
    """Paged spec serving maps its verify look-ahead (chunk x (spec_k + 1)
    positions) and gives the dense spec engine's greedy and sampled streams
    (K5 does K3's arithmetic, K6 K4's); every page returns."""
    reqs = [(rep_prompt(seed=10), {"max_new_tokens": 18}),
            (prompts([19])[0], dict(max_new_tokens=11, temperature=0.7,
                                    seed=3)),
            (rep_prompt(phrase=6, seed=11), {"max_new_tokens": 14}),
            (prompts([4])[0], dict(max_new_tokens=7, spec_decode=False))]
    extra = dict(SPEC, int8_kv=int8)
    dense = _serve(port_engine(**extra), reqs)
    paged = port_engine(**dict(extra, paged_kv=True, kv_page_len=8))
    assert _serve(paged, reqs) == dense
    assert paged.kv_page_stats()["pages_in_use"] == 0
    assert paged._pager.outstanding() == 0
    assert paged.metrics()["accepted_per_step_mean"] > 1.0


def test_paged_look_ahead_stays_inside_the_reservation():
    """The verify look-ahead (chunk x (spec_k + 1) = 20 positions) reaches
    past a short request's bound (prompt + budget + slack = 23 positions,
    3 pages of 8); mapping stops at the bound, so an arena of exactly that
    reservation serves the request, the same stream as the dense engine."""
    p = rep_prompt(phrase=5, reps=1, seed=12)
    eng = port_engine(**dict(SPEC, paged_kv=True, kv_page_len=8,
                             kv_pages=3))
    got = _serve(eng, [(p, {"max_new_tokens": 10})])
    assert got == _serve(port_engine(**SPEC), [(p, {"max_new_tokens": 10})])
    assert eng.kv_page_stats()["pages_in_use"] == 0


# ----------------------------------------------------------------- config


def test_config_validation_and_resolution(monkeypatch):
    for field in ("spec_k", "spec_ngram"):
        with pytest.raises(ValueError, match=field):
            InferenceConfig(**{field: 0})
    cfg = InferenceConfig.from_dict({"spec_decode": True, "spec_k": 2,
                                     "spec_ngram": 1})
    assert (cfg.spec_k, cfg.spec_ngram) == (2, 1)
    # The port serves only the chunked path: turning it off still raises.
    with pytest.raises(NotImplementedError, match="chunked_prefill"):
        InferenceConfig.from_dict({"chunked_prefill": False,
                                   "spec_decode": True})
    monkeypatch.delenv("DS_TPU_SPEC_DECODE", raising=False)
    assert InferenceConfig().resolved_spec_decode() is False
    monkeypatch.setenv("DS_TPU_SPEC_DECODE", "1")
    assert InferenceConfig().resolved_spec_decode() is True
    assert InferenceConfig(spec_decode=False).resolved_spec_decode() is False
    # A ds_config that leaves the switch to the environment speculates.
    _, _, tree = models()
    eng = init_inference(GPT2Config.tiny(dtype=torch.float32), tree,
                         config={"inference": dict(SERVE, spec_k=2)},
                         device="cpu")
    assert eng.metrics()["spec_k"] == 2 and "toks" in eng._pool
    for off in ("0", "false"):
        monkeypatch.setenv("DS_TPU_SPEC_DECODE", off)
        assert InferenceConfig().resolved_spec_decode() is False


def test_submit_spec_on_nonspec_engine_raises():
    """Speculation cannot be granted to one request of an engine built
    without it: the slack, the ring and the program were sized without."""
    eng = port_engine()
    with pytest.raises(ValueError, match="spec_decode"):
        eng.submit(prompts([5])[0], max_new_tokens=4, spec_decode=True)
    assert eng.submit(prompts([5])[0], max_new_tokens=4,
                      spec_decode=False).spec is False
