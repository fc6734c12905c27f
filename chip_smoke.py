"""Chip smoke for the PyTorch/CUDA port (deepspeed_tpu_torch) on one H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit. It imports nothing of JAX or of the JAX package. Phases, each
of which exits non-zero on failure:

1. environment: card name and power limit (nvidia-smi), torch and CUDA
   versions; no CUDA device means exit 1 with no result;
2. build: every kernel in deepspeed_tpu_torch/csrc with nvcc, one process
   per source, started together; the ptxas report of each kernel;
3. kernel vs plain: K3 (flash-decode attention) against its plain PyTorch
   version on the card, bf16 and fp32, at the serving path's shapes, with
   ragged frontiers and large finite garbage past them, each element held
   to its own limit (see TOL); times the kernel,
   the plain version and torch's scaled_dot_product_attention (a yardstick
   only: the port never calls it) with CUDA events, beside the bound;
4. serving at full width: GPT-2 medium, bf16, seeded weights, through
   init_inference; 24 requests of 64/256 prompt tokens and 96 new tokens;
   the kernel's launch count is reset just before and read just after, and
   must equal n_layer x (decode steps + prefill lanes) as the engine counted
   them;
5. greedy consistency: fp32, full width, 4 layers: the engine's greedy
   streams must equal the port's own generate() token for token;
6. K1/K2a/K2b vs plain: the flash-attention kernels of the training path
   against their plain versions (``mha_reference`` /
   ``flash_bwd_reference``) on the card, at the training shape (B=8, H=16,
   T=1024, D=64, causal) in bf16 and fp16, fp32 at B=2 (also against
   autograd through the dense reference), a non-causal case with an
   additive mask, a ragged T=1000 and T=64; each element held to its own
   limit (see FLASH_TOL); times the kernels, the plain versions and
   torch's scaled_dot_product_attention (a yardstick only) beside the
   bound;
7. training at full width: GPT-2 medium, bf16, seeded weights, through
   initialize / train_batch on batches of 8 x 1024; the loss must be finite
   and fall; the kernels' launch counts are reset just before the counted
   steps and read just after, and must equal n_layer x steps (K2b: two per
   layer, in the steps run with the split backward); then a profiler
   window of 2 steps;
8. training consistency: fp32, full width, 2 layers, B=2, T=256: one
   train_batch on the card (kernels) against the port on the CPU (plain
   versions): loss, every gradient and every updated parameter;
9. the kernels line, then the result line.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from deepspeed_tpu_torch import init_inference, initialize  # noqa: E402
from deepspeed_tpu_torch.inference.kv_pool import plane_len_for  # noqa: E402
from deepspeed_tpu_torch.models import (  # noqa: E402
    GPT2Config, GPT2LMHeadModel)
from deepspeed_tpu_torch.models import generation  # noqa: E402
from deepspeed_tpu_torch.op_builder import build_all, build_log  # noqa: E402
from deepspeed_tpu_torch.ops.transformer.kernels import (  # noqa: E402
    attention as at)
from deepspeed_tpu_torch.ops.transformer.kernels import (  # noqa: E402
    decode_attention as da)

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and the
# flop rate for each input type (bf16 on the tensor cores; fp32 outside
# them).
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}

# Serving configuration: the JAX package's own serving benchmark
# (bench.py: max_slots=16, max_len=1024, chunk_size=16).
SERVE = {"max_slots": 16, "max_len": 1024, "chunk_size": 16,
         "prefill_chunk": 32}
N_REQUESTS, NEW_TOKENS, PROMPT_LENS = 24, 96, (64, 256)

# Kernel-vs-plain tolerances, (atol, rtol): each element must satisfy
# |out - ref| <= atol + rtol * (|ref| + spread), spread = sqrt(sum_t p_t^2
# v_t^2) over the row's visible keys (fp32 probabilities p). fp32 differs
# only in summation order. In bf16 both round the output (one ulp, at most
# 2**-7 of |ref|), and the reference rounds each probability to bf16
# before the value product (2**-9 relative, random in sign across keys:
# an error of order 2**-9 * spread, which stays large where the output
# cancels to near zero). A row's output shrinks like 1/sqrt(visible keys),
# about 0.05 at a 1000-key frontier, and the limit shrinks with it: one key
# dropped at such a frontier exceeds it.
TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (2e-3, 2.0 ** -7)}

# Greedy consistency: the engine (16-row batches) and generate (1 row)
# multiply through different GEMM shapes, so fp32 logits may differ in the
# last bits. A token mismatch is tolerated only where the reference's
# top-1/top-2 logit gap is below this.
NEAR_TIE = 1e-4

# K1/K2 against their plain versions: each element must satisfy
# |out - ref| <= rtol * |ref| + FLASH_ACC * mag, where mag is the sum of
# the absolute values of the fp32 terms the kernel adds up for that element
# (attention.accumulated_magnitudes). Kernel and plain version compute in
# fp32 from the same inputs (for K2 the same lse and delta), so they differ
# by the order of their sums, at most about n * 2**-24 of mag for n terms
# (n <= 1024 keys here: 2**-14), atomics included; and by one rounding of
# the output to its dtype: rtol is one ulp (bf16 2**-7, fp16 2**-10 of
# |ref|; 0 for fp32). lse: 1e-5 of (1 + |lse|). One 64-key tile dropped
# moves an element by about 1/16 of mag, some 4000 times the limit.
FLASH_ACC = 2.0 ** -14
FLASH_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
              torch.float16: 2.0 ** -10}
# fp32 kernels against autograd through the dense reference: the backward's
# delta is summed in another order too, so 1e-4 of each tensor's max-abs.
FLASH_AUTOGRAD_TOL = 1e-4

# The training cell: the JAX package's headline measurement
# (bench.py:_measure_gpt2, batch 8 x 1024, GPT-2 medium, bf16, AdamW 1e-4,
# dropout 0, no ZeRO).
TRAIN_CONFIG = {"train_batch_size": 8,
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
                "bf16": {"enabled": True}}
TRAIN_B, TRAIN_T = 8, 1024
TRAIN_WARM, TRAIN_TIMED, TRAIN_SPLIT = 2, 10, 2

# Card-vs-CPU training step, fp32 on both sides: losses within 1e-5
# relative; each gradient within GRAD_TOL of its tensor's max-abs (the
# card's products and the kernels sum in another order than the CPU's).
# An updated parameter moves by lr * m / (sqrt(v) + eps), about lr * sign(g)
# at step 1: where |g| is within summation noise of 0 its sign, and so the
# update, may differ by up to 2 lr; elsewhere the update agrees to 1e-3 lr,
# plus two fp32 ulps of the parameter (2**-22 |p|: the two updated values
# may round to neighbouring floats, e.g. around a LayerNorm scale of 1).
GRAD_TOL = 1e-4

PLANE = plane_len_for(SERVE["max_len"], SERVE["prefill_chunk"])


def fail(msg):
    print("chip_smoke: FAILED: " + msg, file=sys.stderr)
    sys.exit(1)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=30, warmup=3):
    """Median milliseconds of ``fn`` over ``reps`` launches, each bracketed
    by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ----------------------------------------------------------------- phases


def phase_env():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the chip smoke needs a GPU")
    card = card_line()
    print("card: {} | torch {} | cuda {}".format(
        card, torch.__version__, torch.version.cuda))
    # fp32 products stay fp32 (the LM head and the fp32 reference).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    t0 = time.perf_counter()
    built = build_all()
    print("build: {:.2f} s ({})".format(
        time.perf_counter() - t0,
        ", ".join("{} {:.2f} s".format(n, s) for n, s in built.items())
        or "cached"))
    for name in ("decode_attention", "flash_attention"):
        for line in _ptxas_summary(build_log(name)):
            print("ptxas {}: {}".format(name, line))


_TYPE_NAMES = {"f": "fp32", "__nv_bfloat16": "bf16", "__half": "fp16"}


def _ptxas_summary(log):
    """One line per compiled kernel from nvcc's -Xptxas=-v report: the
    kernel, its type (and K2's dq flag), registers, spill stores."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"entry function '\S*?\d+([a-z_]+_kernel)I\d*"
                      r"(\w+?)(Lb[01])?E", line)
        if m:
            name = "{}<{}{}>".format(m.group(1),
                                      _TYPE_NAMES.get(m.group(2), m.group(2)),
                                      ", dq" if m.group(3) == "Lb1" else "")
            spill = "?"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append("{}: {} registers, {} B spill stores".format(
                name, m.group(1), spill))
            name = None
    return out


def _case(B, S, frontiers, dtype, seed):
    """q, k, v, pos on the card; positions past each row's frontier hold
    large finite garbage."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    H, D, T = 16, 64, PLANE
    q = torch.randn(B, H, S, D, device="cuda", generator=g).to(dtype)
    k = torch.randn(B, H, T, D, device="cuda", generator=g)
    v = torch.randn(B, H, T, D, device="cuda", generator=g)
    pos = torch.tensor(frontiers, dtype=torch.int32, device="cuda")
    stale = torch.arange(T, device="cuda")[None, :] > \
        (pos[:, None].long() + S - 1)
    garbage = 3e4 * torch.sign(torch.randn(B, H, T, D, device="cuda",
                                           generator=g))
    k = torch.where(stale[:, None, :, None], garbage, k).to(dtype)
    v = torch.where(stale[:, None, :, None], -garbage, v).to(dtype)
    return q, k, v, pos


def _spread(q, k, v, pos, scale):
    """sqrt(sum_t p_t^2 v_t^2) per output element, fp32 probabilities
    over each row's visible keys (the scale of the bf16 probability
    rounding error; see TOL)."""
    S, T = q.shape[2], k.shape[2]
    q_pos = pos.long()[:, None] + torch.arange(S, device=q.device)
    mask = torch.arange(T, device=q.device)[None, None, :] <= q_pos[:, :, None]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s.masked_fill(~mask[:, None], float("-inf")), dim=-1)
    return torch.matmul(p * p, v.float() ** 2).sqrt()


def _bound(q, k, pos):
    """(bound ms, 'bytes' or 'operations') for one call: q, out and the
    K/V rows up to each frontier read once; 4*D flops per visible key per
    query row."""
    B, H, S, D = q.shape
    T = k.shape[2]
    item = q.element_size()
    keys = np.minimum(pos.cpu().numpy().astype(np.int64) + S, T)
    nbytes = 2 * B * H * S * D * item + 2 * int(keys.sum()) * H * D * item \
        + 4 * B
    vis = np.minimum(pos.cpu().numpy()[:, None].astype(np.int64)
                     + np.arange(S)[None] + 1, T)
    flops = 4 * D * H * int(vis.sum())
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels():
    """K3 against its plain version; returns the variant rows."""
    T = PLANE
    decode_pos = [0, 1, 31, 32, 33, 63, 64, 127, 128, 500, 511, 700, 1000,
                  1023, T - 2, T - 1]
    cases = [("decode", 16, 1, decode_pos)]
    cases += [("prefill_lane", 1, 32, [p]) for p in (0, 31, 32, 500, T - 32)]
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, B, S, frontiers in cases:
            q, k, v, pos = _case(B, S, frontiers, dtype, seed=len(rows))
            scale = 1.0 / 8.0
            out = da.flash_decode_attention(q, k, v, pos, scale=scale)
            ref = da.decode_attention_reference(q, k, v, pos, scale=scale)
            torch.cuda.synchronize()
            if out.shape != ref.shape or not torch.isfinite(out).all():
                fail("K3 output not finite or wrong shape at {} {}".format(
                    name, dtype))
            atol, rtol = TOL[dtype]
            diff = (out.float() - ref.float()).abs()
            limit = atol + rtol * (ref.float().abs()
                                   + _spread(q, k, v, pos, scale))
            ratio = float((diff / limit).max())
            row = {"case": name, "dtype": str(dtype).split(".")[-1],
                   "B": B, "S": S, "T": T, "pos": frontiers,
                   "max_abs_err": float(diff.max()), "atol": atol,
                   "rtol": rtol, "max_err_over_limit": ratio}
            if ratio > 1.0:
                # Where: (b, h, query row, column) of the worst element,
                # its row's frontier, and the two values.
                worst = int((diff / limit).flatten().argmax())
                at_ = tuple(int(i) for i in
                            np.unravel_index(worst, tuple(diff.shape)))
                row["worst"] = {"index": list(at_),
                                "frontier": frontiers[at_[0]],
                                "out": float(out.float()[at_]),
                                "ref": float(ref.float()[at_])}
                print(json.dumps(row))
                fail("K3 disagrees with its plain version")
            if frontiers in ([500], decode_pos):
                mask = torch.arange(T, device="cuda")[None, None, :] <= \
                    (pos[:, None, None].long()
                     + torch.arange(S, device="cuda")[None, :, None])
                mask = mask[:, None]
                row["ms"] = cuda_ms(
                    lambda: da.flash_decode_attention(q, k, v, pos, scale))
                row["plain_ms"] = cuda_ms(
                    lambda: da.decode_attention_reference(q, k, v, pos, scale))
                row["library_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, scale=scale))
                row["bound_ms"], row["bound_by"] = _bound(q, k, pos)
            rows.append(row)
            print("K3 " + json.dumps(row))
    return rows


def _prompts(n, vocab, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=PROMPT_LENS[i % 2]) for i in range(n)]


def phase_serve(card):
    cfg = GPT2Config.gpt2_medium(dtype=torch.bfloat16)
    model = GPT2LMHeadModel(cfg, device="cuda", seed=0)
    engine = init_inference(model, config=SERVE)
    reqs = []
    for i, p in enumerate(_prompts(N_REQUESTS, cfg.vocab_size, seed=0)):
        sampled = i % 6 == 5
        reqs.append(engine.submit(
            p, max_new_tokens=NEW_TOKENS,
            temperature=0.8 if sampled else 0.0,
            top_k=50 if sampled else None, seed=i))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    da.reset_launches()
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = da.launches
    m = engine.metrics()
    for r in reqs:
        toks = np.asarray(r.tokens)
        if len(toks) != NEW_TOKENS or toks.min() < 0 or \
                toks.max() >= cfg.vocab_size:
            fail("request {} returned {} tokens (range {}..{})".format(
                r.rid, len(toks), toks.min(), toks.max()))
    want = cfg.n_layer * (m["decode_steps"] + m["prefill_lanes"])
    if launches == 0 or launches != want:
        fail("K3 launches {} != n_layer x (decode steps + prefill lanes) "
             "= {}".format(launches, want))
    line = {"serve": "gpt2-medium bf16", "requests": N_REQUESTS,
            "new_tokens": NEW_TOKENS, "wall_s": wall,
            "tokens_out": m["tokens_out"],
            "tokens_per_s": m["tokens_out"] / wall,
            "ttft_p50_ms": m["ttft_p50_ms"], "ttft_p99_ms": m["ttft_p99_ms"],
            "steps": m["chunks"], "mean_step_ms": wall / m["chunks"] * 1e3,
            "decode_steps": m["decode_steps"],
            "prefill_lanes": m["prefill_lanes"], "k3_launches": launches,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "card": card}
    print("serve " + json.dumps(line))
    phase_profile(engine, cfg)
    return launches


def phase_profile(engine, cfg, warm=4, window=3):
    """Where a mixed step's time goes: torch.profiler over ``window``
    steps of a full pool (16 fresh requests, ``warm`` steps in)."""
    for i, p in enumerate(_prompts(SERVE["max_slots"], cfg.vocab_size, 2)):
        engine.submit(p, max_new_tokens=48, seed=i)
    for _ in range(warm):
        engine.step()
    print("profile " + json.dumps(_profile(engine.step, window)))


def _profile(step, window):
    """torch.profiler over ``window`` calls of ``step``: device time by
    kernel name per call and the device's busy share of the wall clock."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(window):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue  # host ops: their device time is their kernels'
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0:
            kernels[evt.key] = (dev_us / 1e3 / window, evt.count // window)
    busy = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "window_steps": window, "step_ms": wall_ms / window,
        "device_busy_ms_per_step": busy if kernels else "not measured",
        "device_busy_share": busy * window / wall_ms if kernels else None,
        "top_kernels_ms_per_step": [
            {"name": k[:80], "ms": ms, "calls": n} for k, (ms, n) in top]}


def _gap(model, ids):
    """Top-1 minus top-2 fp32 logit for the token after ``ids``."""
    cache = generation.init_cache(generation.as_gencfg(model.config), 1,
                                  len(ids), device="cuda")
    logits, _ = generation.prefill_forward(
        model, torch.as_tensor(ids, device="cuda")[None], cache)
    top = torch.topk(logits[0, -1], 2).values
    return float(top[0] - top[1])


def phase_greedy():
    cfg = GPT2Config(n_embd=1024, n_layer=4, n_head=16, dtype=torch.float32)
    model = GPT2LMHeadModel(cfg, device="cuda", seed=1)
    engine = init_inference(model, config=dict(SERVE, max_slots=4))
    prompts = _prompts(4, cfg.vocab_size, seed=1)
    new = 32
    outs = engine.generate(prompts, max_new_tokens=new)
    exact = 0
    for p, got in zip(prompts, outs):
        ref = generation.generate(model, p[None], new,
                                  temperature=0.0)[0].tolist()
        if got == ref:
            exact += 1
            continue
        j = next(i for i, (a, b) in enumerate(zip(got, ref)) if a != b)
        gap = _gap(model, np.concatenate([p, ref[:j]]))
        print("greedy: divergence at token {}, top-1/top-2 gap {:.3e}".format(
            j, gap))
        if gap >= NEAR_TIE:
            fail("greedy streams differ at a clear argmax (gap {:.3e})".format(
                gap))
    print("greedy: {}/{} streams identical to generate()".format(
        exact, len(prompts)))


def _flash_inputs(B, T, dtype, masked, seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q, k, v, do = (torch.randn(B, 16, T, 64, device="cuda", generator=g)
                   .to(dtype) for _ in range(4))
    mask = None
    if masked:  # about one key in ten dropped; key 0 kept, so no row is
        # fully masked (such a row's lse, ~ -1e9 at an fp32 ulp of 64, loses
        # its log-sum bits in both packages)
        drop = torch.rand(B, T, device="cuda", generator=g) < 0.1
        drop[:, 0] = False
        mask = torch.where(drop, -1e9, 0.0)
    return q, k, v, do, mask


def _flash_bound(q, causal, backward):
    """(bound ms, 'bytes' or 'operations'): every input read once, every
    output written once; 4 * D flops per visible (query, key) pair forward
    (two products), 10 * D backward (five)."""
    B, H, T, D = q.shape
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    plane = B * H * T * D * q.element_size()
    rows = B * H * T * 4
    if backward:  # q, k, v, do, lse, delta in; dq, dk, dv out
        flops, nbytes = 10 * D * pairs, 7 * plane + 2 * rows
    else:  # q, k, v in; o, lse out
        flops, nbytes = 4 * D * pairs, 4 * plane + rows
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _err(out, ref, limit):
    """(max abs error, max error / limit); an exact element scores 0 even
    where its limit is 0."""
    diff = (out.float() - ref.float()).abs()
    ratio = torch.where(diff == 0, 0.0, diff / limit)
    return float(diff.max()), float(ratio.max())


def _flash_case(name, B, T, dtype, causal, masked, seed, timed=False):
    """K1, K2a and K2b on one input against their plain versions; returns
    the case's row (errors, and with ``timed`` the times)."""
    q, k, v, do, mask = _flash_inputs(B, T, dtype, masked, seed)
    o, lse = at.flash_fwd(q, k, v, mask, causal)
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    fused = at.flash_bwd(q, k, v, mask, lse, delta, do, causal, mode="fused")
    split = at.flash_bwd(q, k, v, mask, lse, delta, do, causal, mode="split")
    ro, rlse = at.mha_reference(q, k, v, mask, causal, return_lse=True)
    refs = at.flash_bwd_reference(q, k, v, mask, lse, delta, do, causal)
    mags = at.accumulated_magnitudes(q, k, v, mask, lse, delta, do, causal)
    torch.cuda.synchronize()
    rtol = FLASH_RTOL[dtype]
    row = {"case": name, "dtype": str(dtype).split(".")[-1], "B": B,
           "H": 16, "T": T, "causal": causal, "mask": masked}
    outs = {"K1": [(o, ro, rtol * ro.float().abs() + FLASH_ACC * mags[0]),
                   (lse, rlse, 1e-5 * (1 + rlse.abs()))]}
    for kernel, grads in (("K2a", fused), ("K2b", split)):
        outs[kernel] = [(g, r, rtol * r.float().abs() + FLASH_ACC * m)
                        for g, r, m in zip(grads, refs, mags[1:])]
    for kernel, triples in outs.items():
        if not all(bool(torch.isfinite(x).all()) and x.shape == r.shape
                   for x, r, _ in triples):
            fail("{} output not finite or wrong shape at {}".format(kernel,
                                                                    name))
        errs = [_err(*t) for t in triples]
        row[kernel] = {"max_abs_err": max(e[0] for e in errs),
                       "max_err_over_limit": max(e[1] for e in errs)}
        if row[kernel]["max_err_over_limit"] > 1.0:
            print("flash " + json.dumps(row))
            fail("{} disagrees with its plain version at {}".format(kernel,
                                                                    name))
    if dtype == torch.float32:
        row["autograd_max_err_over_limit"] = _flash_vs_autograd(
            q, k, v, do, mask, causal, o, fused, split)
    if timed:
        row.update(_flash_times(q, k, v, do, lse, delta, causal))
    print("flash " + json.dumps(row))
    return row


def _flash_vs_autograd(q, k, v, do, mask, causal, o, fused, split):
    """fp32: the kernels against autograd through mha_reference."""
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = at.mha_reference(*leaves, mask=mask, causal=causal)
    want = torch.autograd.grad(ref, leaves, do)
    worst = 0.0
    for got, exp in [(o, ref.detach())] + list(zip(fused, want)) + \
            list(zip(split, want)):
        limit = FLASH_AUTOGRAD_TOL * exp.abs().max()
        worst = max(worst, _err(got, exp, limit)[1])
    if worst > 1.0:
        fail("fp32 flash attention disagrees with autograd through the "
             "dense reference (ratio {:.3f})".format(worst))
    return worst


def _flash_times(q, k, v, do, lse, delta, causal):
    """CUDA-event medians at the training shape: the kernels, their plain
    versions, torch's scaled_dot_product_attention (forward, and forward +
    backward minus forward; a yardstick the port never calls), and the
    bounds."""
    t = {
        "K1_ms": cuda_ms(lambda: at.flash_fwd(q, k, v, None, causal)),
        "K2a_ms": cuda_ms(lambda: at.flash_bwd(q, k, v, None, lse, delta, do,
                                               causal, mode="fused")),
        "K2b_ms": cuda_ms(lambda: at.flash_bwd(q, k, v, None, lse, delta, do,
                                               causal, mode="split")),
        "plain_fwd_ms": cuda_ms(
            lambda: at.mha_reference(q, k, v, None, causal, return_lse=True)),
        "plain_bwd_ms": cuda_ms(lambda: at.flash_bwd_reference(
            q, k, v, None, lse, delta, do, causal)),
        "library_fwd_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal)),
    }
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]

    def fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
        torch.autograd.grad(out, leaves, do)

    t["library_bwd_ms"] = cuda_ms(fwd_bwd) - t["library_fwd_ms"]
    t["bound_fwd_ms"], t["bound_fwd_by"] = _flash_bound(q, causal, False)
    t["bound_bwd_ms"], t["bound_bwd_by"] = _flash_bound(q, causal, True)
    return t


def phase_flash():
    """K1/K2a/K2b against their plain versions; returns the case rows, the
    first being the timed training shape (bf16)."""
    cases = [("train", 8, 1024, torch.bfloat16, True, False),
             ("train", 8, 1024, torch.float16, True, False),
             ("train_fp32", 2, 1024, torch.float32, True, False),
             ("noncausal_mask", 2, 1024, torch.bfloat16, False, True),
             ("ragged", 2, 1000, torch.bfloat16, True, False),
             ("ragged_fp32_mask", 2, 1000, torch.float32, True, True),
             ("one_tile", 8, 64, torch.bfloat16, True, False)]
    return [_flash_case(*case, seed=i, timed=i == 0)
            for i, case in enumerate(cases)]


def phase_train(card):
    """GPT-2 medium training through initialize / train_batch; returns the
    kernels' launch counts over the counted steps."""
    cfg = GPT2Config.gpt2_medium(dtype=torch.bfloat16, dropout=0.0)
    model = GPT2LMHeadModel(cfg, device="cuda", seed=0)
    engine, _, _, _ = initialize(model=model, config_params=TRAIN_CONFIG)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(TRAIN_B, TRAIN_T))).to("cuda")
    batch = (ids, ids)  # labels = ids; the same batch every step
    losses = [engine.train_batch(batch) for _ in range(TRAIN_WARM)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    at.reset_launches()
    t0 = time.perf_counter()
    losses += [engine.train_batch(batch) for _ in range(TRAIN_TIMED)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    os.environ["DS_TPU_FLASH_BWD"] = "split"
    try:
        t1 = time.perf_counter()
        losses += [engine.train_batch(batch) for _ in range(TRAIN_SPLIT)]
        torch.cuda.synchronize()
        split_wall = time.perf_counter() - t1
    finally:
        del os.environ["DS_TPU_FLASH_BWD"]
    launches = dict(at.launches)
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        fail("non-finite training loss: {}".format(losses))
    if not losses[4] < losses[0]:
        fail("the loss did not fall over the first 5 steps: {}".format(
            losses[:5]))
    want = {"flash_fwd": cfg.n_layer * (TRAIN_TIMED + TRAIN_SPLIT),
            "flash_bwd_fused": cfg.n_layer * TRAIN_TIMED,
            "flash_bwd_split": 2 * cfg.n_layer * TRAIN_SPLIT}
    if launches != want:
        fail("kernel launches {} != n_layer x steps {}".format(launches,
                                                               want))
    tokens = TRAIN_B * TRAIN_T
    print("train " + json.dumps({
        "train": "gpt2-medium bf16 AdamW", "batch": TRAIN_B, "seq": TRAIN_T,
        "timed_steps": TRAIN_TIMED, "tokens_per_s": tokens * TRAIN_TIMED /
        wall, "mean_step_ms": wall / TRAIN_TIMED * 1e3,
        "split_bwd_step_ms": split_wall / TRAIN_SPLIT * 1e3,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
        "launches": launches, "card": card}))
    print("train_profile " + json.dumps(
        _profile(lambda: engine.train_batch(batch), 2)))
    return launches


def phase_train_consistency():
    """One fp32 train_batch on the card against the same on the CPU."""
    cfg = GPT2Config(n_embd=1024, n_layer=2, n_head=16, dtype=torch.float32,
                     dropout=0.0)
    config = {"train_batch_size": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}}}
    lr = config["optimizer"]["params"]["lr"]
    ids = np.random.RandomState(3).randint(0, cfg.vocab_size, size=(2, 256))
    cpu_model = GPT2LMHeadModel(cfg, device="cpu", seed=2)
    card_model = GPT2LMHeadModel(cfg, device="cuda", seed=None)
    card_model.load_state_dict(cpu_model.state_dict())
    runs = []
    for model, device in ((card_model, "cuda"), (cpu_model, "cpu")):
        engine, _, _, _ = initialize(model=model, config_params=config,
                                     device=device)
        loss = engine(ids, ids)
        engine.backward(loss)
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in model.named_parameters()}
        engine.step()
        params = {n: p.detach().cpu().clone()
                  for n, p in model.named_parameters()}
        runs.append((float(loss.detach()), grads, params))
    (loss_c, g_c, p_c), (loss_h, g_h, p_h) = runs
    loss_err = abs(loss_c - loss_h) / abs(loss_h)
    grad_ratio = max(float((g_c[n] - g_h[n]).abs().max() /
                           (GRAD_TOL * g_h[n].abs().max())) for n in g_h)
    param_ratio = 0.0
    for n in p_h:
        noisy = g_h[n].abs() <= 10 * GRAD_TOL * g_h[n].abs().max()
        limit = torch.where(noisy, 2.0 * lr, 1e-3 * lr) + \
            2.0 ** -22 * p_h[n].abs()
        param_ratio = max(param_ratio,
                          float(((p_c[n] - p_h[n]).abs() / limit).max()))
    line = {"train_consistency": "fp32 width 1024, 2 layers, B2 T256",
            "loss_card": loss_c, "loss_cpu": loss_h, "loss_rel_err": loss_err,
            "grad_max_err_over_limit": grad_ratio,
            "param_max_err_over_limit": param_ratio}
    print("train_consistency " + json.dumps(line))
    if loss_err > 1e-5 or grad_ratio > 1.0 or param_ratio > 1.0:
        fail("the card's training step disagrees with the CPU's")


def _flash_kernel_rows(flash_rows, launches):
    timed = flash_rows[0]
    shape = "B8 H16 T1024 D64 bf16 causal"
    common = {"route": "cuda",
              "source": "deepspeed_tpu_torch/csrc/flash_attention.cu",
              "shape": shape}
    specs = [
        ("flash_attention_fwd", "K1", "flash_fwd",
         "deepspeed_tpu/ops/transformer/kernels/attention.py:249",
         "K1_ms", "plain_fwd_ms", "library_fwd_ms", "fwd"),
        ("flash_attention_bwd_fused", "K2a", "flash_bwd_fused",
         "deepspeed_tpu/ops/transformer/kernels/attention.py:550",
         "K2a_ms", "plain_bwd_ms", "library_bwd_ms", "bwd"),
        ("flash_attention_bwd_split", "K2b", "flash_bwd_split",
         "deepspeed_tpu/ops/transformer/kernels/attention.py:428",
         "K2b_ms", "plain_bwd_ms", "library_bwd_ms", "bwd"),
    ]
    rows = []
    for name, kernel, counter, replaces, ms, plain, lib, way in specs:
        rows.append(dict(
            common, name=name, replaces=replaces,
            launches=launches[counter],
            max_abs_err=max(r[kernel]["max_abs_err"] for r in flash_rows),
            max_err_over_limit=max(r[kernel]["max_err_over_limit"]
                                   for r in flash_rows),
            ms=timed[ms], plain_ms=timed[plain],
            bound_ms=timed["bound_{}_ms".format(way)],
            bound_by=timed["bound_{}_by".format(way)],
            library_ms=timed[lib]))
    return rows


def main():
    card = phase_env()
    phase_build()
    rows = phase_kernels()
    flash_rows = phase_flash()
    launches = phase_serve(card)
    phase_greedy()
    train_launches = phase_train(card)
    phase_train_consistency()
    main_row = rows[0]  # bf16 decode: the shape the decode lane runs most
    kernels = [{
        "name": "decode_attention", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/decode_attention.cu",
        "replaces": "deepspeed_tpu/ops/transformer/kernels/"
                    "decode_attention.py:181",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_err_over_limit": max(r["max_err_over_limit"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": "B16 H16 S1 T{} D64 bf16".format(PLANE)}]
    kernels += _flash_kernel_rows(flash_rows, train_launches)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
