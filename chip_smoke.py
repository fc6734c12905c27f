"""Chip smoke for the PyTorch/CUDA port (deepspeed_tpu_torch) on one H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit. It imports nothing of JAX or of the JAX package. Phases, each
of which exits non-zero on failure:

1. environment: card name and power limit (nvidia-smi), torch and CUDA
   versions; no CUDA device means exit 1 with no result;
2. build: every kernel in deepspeed_tpu_torch/csrc with nvcc, one process
   per source, started together; the ptxas report of each kernel;
3. kernel vs plain: K3 (flash-decode attention: a split kernel per
   da.SPLIT_KEYS keys of each row, then a combine launch) against its
   plain PyTorch version on the card, bf16 and fp32, at the serving path's
   shapes (the decode lane S1, the speculative verify lane B16 S5 at
   VERIFY_POS, whose row groups of 4 and 1 stop in different splits at
   frontiers 124-127, the prefill lane S32 also with rows just before, at
   and after a split boundary), with ragged frontiers and large finite
   garbage past them, each element held to its own limit (see TOL); times
   the kernel,
   the plain version and torch's scaled_dot_product_attention (a yardstick
   only: the port never calls it) with CUDA events, beside the bound; the
   combine kernel alone against its plain version on the plain partials of
   the decode case (COMBINE_RTOL), and timed there;
   then K4 (int8 plane), K5 (page arena) and K6 (int8 page arena) against
   their plain versions at the same shapes (the verify lane too), in bf16
   and fp32, through a shuffled block table whose unmapped logical pages
   point at a trash page, with garbage in the trash page, in unmapped
   pages and past every frontier (int8: TOL plus the score shift set out there), K5 and K6 also
   at pages of ODD_PAGE_LEN, which do not divide the split, and at the
   dense pools' prefill lane as the engine builds it (slot_cache_view of a
   pool of SERVE's slots, every slot's plane filled: one page of PLANE
   positions per slot and the table [[LANE_SLOT]]); K5 must equal K3 on the
   gathered plane, and K6 K4, bit for bit; times each kernel and
   its plain version beside the bound (no single PyTorch call computes
   paged or int8 decode attention: library_ms is null);
   then the decode-kernel stress: K3, K4, K5 and K6 at the bf16 decode case
   over STRESS_SEEDS fresh seeds each, every case held to its limit (and K5
   = K3, K6 = K4 bit for bit); the count of cases over the limit per
   kernel, and the worst element of any; then the poison run: K3's first
   case repeated POISON_REPEATS times with its output buffer filled with
   NaN or 1e4 before each launch, the keys and values of the frontier's
   tile past the frontier set to 1e4 and every later tile to NaN, the last
   POISON_CONCURRENT repeats beside K3 launches on a second stream;
4. serving at full width: GPT-2 medium, bf16, seeded weights, through
   init_inference; 24 requests of 64/256 prompt tokens and 96 new tokens;
   each step is its key's program (prefill lane present, any row samples,
   any row filters top-k), captured as a CUDA graph at the key's first
   step and replayed at every later one; each serving path's kernel launch
   counts are reset just before it and read just after (replays add the
   launches their graph holds), and must equal n_layer x decode steps for
   the decode lane's kernel plus n_layer x prefill lanes for the prefill
   lane's (which reaches its slot through a one-row block table: the paged
   kernels), the other decode kernels' 0; compile_count (one graph per
   key met) must be at most 8 and graph_replays the steps less
   compile_count. Paths: the dense pool (K3; its prefill lane
   K5); the slice's main path, the paged int8 pool at 128-position pages
   (K6; every page returned after the run); then two arms of 4 requests:
   paged alone (K5) and int8 alone (K4; its prefill lane K6). The dense
   and the paged int8 runs are each followed by a profiler window; then
   speculative decoding (SPEC: spec_k 4, spec_ngram 3) on the JAX bench's
   stream for it (each request tiles its own random 8-token phrase; every
   fourth opts out), with the same checks and each path's accept
   statistics: the dense pool (K3 at S5 in the verify lane; profiled), the
   same stream with speculation off (its program keys must be the
   speculating run's), the paged int8 pool (K6), and 4-request arms paged
   (K5) and int8 (K4); then a graph-served engine against the same step
   program run eagerly, dense and paged int8, without and with
   speculation: every step's harvest and the whole pool (the token ring
   too) after GRAPH_CHECK_STEPS steps, bit for bit (a speculating paged
   pool may differ only where no read sees: page 0, and ring entries past
   a row's frontier);
4a. telemetry on the serving path (phase_telemetry): the dense serve
   path's stream on two engines, telemetry on and off, each warmed by the
   stream (its captures inside the warm-up, whose TTFT is reported for the
   requests whose first token came in a capturing step apart from the
   rest), then marked warm and served in turns A B B A: equal streams,
   programs and K3/K5 launch counts, recompiles 0, the lifecycle and step
   spans, the trace file through validate_trace, every Prometheus counter
   moving by its metrics() window value; a fresh engine captures its keys
   while a thread scrapes its PrometheusEndpoint every 5 ms (streams equal
   the unscraped engine's); a profile_window capture holds K3 and the
   ``inference/mixed_step`` scope; the host time inside telemetry calls,
   timed call by call on a fifth turn, must stay under 5% of the median
   step (the on/off step difference is reported, not gated);
4b. the sustained-load harness (phase_sustained): GPT-2 medium over a
   dense int8 pool (K4, prefill lane K6) driven open loop by loadgen's
   SustainedRunner with the JAX bench's sustained workload (96 Poisson
   arrivals at 12/s), its report (goodput, SLO attainment, TTFT/ITL and
   queue-wait percentiles, the windows' queue depth), a saturation sweep
   and the gate's A/A self-check; fails on a lost request, a recompile
   after warm-up or a non-finite number;
5. greedy consistency: fp32, full width, 4 layers: the engine's greedy
   streams must equal the port's own generate() token for token; the paged
   engine's must equal the dense engine's exactly, and the paged int8
   engine's the dense int8 engine's; with speculation, on tiled and
   random prompts, the streams against generate() and the spec-off
   engine, a request whose budget ends inside a verify that accepted
   drafts, and one whose EOS is an accepted draft with accepted tokens
   after it, searched for over generated candidates (a mismatch is
   allowed only at a top-1/top-2 gap below NEAR_TIE);
6. K1/K2a/K2b vs plain: the flash-attention kernels of the training path
   against their plain versions (``mha_reference`` /
   ``flash_bwd_reference``) on the card, at the training shape (B=8, H=16,
   T=1024, D=64, causal) in bf16 and fp16, fp32 at B=2 (also against
   autograd through the dense reference), the BERT-large shape (B=16,
   H=16, T=512, D=64, bf16, non-causal, every other row padded as the BERT
   batches are), a non-causal case with a random additive mask, a ragged
   T=1000 and T=64; each element held to its own limit (see FLASH_TOL);
   times the kernels (K2b's two kernels also apart), the plain versions and
   torch's scaled_dot_product_attention (a yardstick only) beside the
   bound, at the training and the BERT shapes;
7. training at full width: GPT-2 medium, bf16, seeded weights, through
   initialize / train_batch on batches of 8 x 1024; the loss must be finite
   and fall; the kernels' launch counts are reset just before the counted
   steps and read just after, and must equal n_layer x steps (K2b: two per
   layer, in the steps run with the split backward); then a profiler
   window of 2 steps;
7a. the training breakdown (phase_train_breakdown): the same setting for
   4 steps with wall_clock_breakdown and memory_breakdown on, off and off
   again, from one seed (K2a's dq atomics make its runs differ from step
   2 on: their first losses must be equal), then on and off with the
   split backward (K2b, no atomics): those losses equal bit for bit; each
   phase's median ms, the allocator's MA/Max_MA, and whether tensorboard
   imports;
8. training consistency: fp32, full width, 2 layers, B=2, T=256: one
   train_batch on the card (kernels) against the port on the CPU (plain
   versions): loss, every gradient and every updated parameter;
9. K8/K10a/K10b/K11 vs plain: the fused layer's row kernels (LayerNorm,
   dropout and its replay, bias + GELU) against their plain versions on
   the card, at the BERT-large path's shapes, in bf16, fp16 and fp32; K8
   and K11 each element held to its own limit (see ROW_TOL), the dropout
   kernels equal to the plain version bit for bit; times the kernels, the
   plain versions and one PyTorch call each (a yardstick only) beside the
   bound; then K9 (the standalone attn_softmax): its launch count reset,
   the op driven through its entry point (forward and backward at the BERT
   and GPT-2 score shapes), the count read; K9 against its plain version
   in every case of SOFTMAX_CASES (ROW_TOL), timed beside torch.softmax (a
   yardstick only) and the bound at the first two; the op's gradient
   through autograd on the card against the CPU;
10. BERT-large pretraining at full width: bf16, seeded weights, batches of
   16 x 512 with padded rows, through initialize and forward / backward /
   step at dropout 0.1 (2 warm-up and 10 timed steps), 2 steps at dropout
   0, then one train_batch; the loss must be finite and fall; the launch
   counts of K1, K2a, K8, K10a, K10b and K11 are reset just before and read
   just after, and must equal n_layer x steps x the kernel's sites per
   layer, plus the embeddings' dropout once per step; then a profiler
   window of 2 steps;
11. BERT consistency: fp32, full width, 2 layers, B=2, T=128, dropout 0.1:
   one step on the card (kernels) against the port on the CPU (plain
   versions, the same dropout masks): loss, every gradient and every
   updated parameter;
12. K7a/K7b vs plain: the block-sparse attention kernels (forward, fused
   backward, split backward) against their plain versions
   (``sparse_fwd_reference`` / ``sparse_bwd_reference``) on the card, each
   element held to its own limit (see SPARSE_ACC): at the sparse BERT
   path's shape (B=2, H=16, T=4096, D=64, bf16, the Fixed layout at block
   64, bidirectional, every other row padded), the unidirectional Fixed
   layout with the causal cut, BigBird with two global blocks (K7a's
   block-64 kernel runs pairs of query blocks with equal LUT rows and
   single blocks in one launch; each block-64 case prints its pair and
   single item counts: the path's layout is all pairs, the causal one all
   single blocks), fp32 at B=1 T=1024, blocks 16 and 32 on
   random layouts with empty rows and columns (-1 LUT entries), the
   key-padding mask and the bias in 'mul' mode, and fp16; times the
   kernels, the plain versions and torch's scaled_dot_product_attention
   with the layout expanded to a dense mask (a yardstick only) beside the
   bound, at the path's shape; then the split-default shape (B=1, H=16,
   T=8192, D=64, bf16), where the wrappers pick the split backward
   themselves: K2b (causal) and K7b split (Fixed, block 64, padding mask)
   once each against their plain versions (see LONG_ACC), then timed
   beside SDPA's backward and the bound;
13. sparse BERT-large pretraining at full width: T=4096, batch 2, the Fixed
   layout at block 64, bf16, seeded weights, through initialize and
   forward / backward / step at dropout 0.1 (2 warm-up and 10 timed steps
   with the fused backward, 2 with the split); the loss must be finite and
   fall; the launch counts of K7a, K7b, K10a/K10b are reset just before
   the counted steps and read just after (K1/K2, K8, K11 must be 0); then a
   profiler window of 2 steps;
14. sparse BERT consistency: fp32, full width, 2 layers, B=2, T=512, block
   64, dropout 0.1: one step on the card (kernels) against the port on
   the CPU (plain versions);
15. the kernels line, then the result line.
"""

import collections
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from deepspeed_tpu_torch import init_inference, initialize  # noqa: E402
from deepspeed_tpu_torch.inference import InferenceEngine  # noqa: E402
from deepspeed_tpu_torch.inference.kv_hierarchy import (  # noqa: E402
    HierarchySpec)
from deepspeed_tpu_torch.inference.kv_pool import (  # noqa: E402
    init_pool, paged_plane_len, plane_len_for, slot_cache_view)
from deepspeed_tpu_torch.loadgen import (  # noqa: E402
    SLO, SustainedRunner, WorkloadSpec, build_report, regression_gate,
    saturation_sweep)
from deepspeed_tpu_torch.models import (  # noqa: E402
    BertConfig, BertForPreTraining, GPT2Config, GPT2LMHeadModel)
from deepspeed_tpu_torch.models import generation  # noqa: E402
from deepspeed_tpu_torch.op_builder import (  # noqa: E402
    build_all, build_log, sources)
from deepspeed_tpu_torch.ops.sparse_attention import (  # noqa: E402
    BigBirdSparsityConfig, FixedSparsityConfig)
from deepspeed_tpu_torch.ops.sparse_attention import (  # noqa: E402
    kernels as sk)
from deepspeed_tpu_torch.ops.transformer.kernels import (  # noqa: E402
    attention as at)
from deepspeed_tpu_torch.ops.transformer.kernels import (  # noqa: E402
    decode_attention as da)
from deepspeed_tpu_torch.ops.transformer.kernels import (  # noqa: E402
    dropout as dr)
from deepspeed_tpu_torch.ops.transformer.kernels import (  # noqa: E402
    gelu as ge)
from deepspeed_tpu_torch.ops.transformer.kernels import (  # noqa: E402
    layer_norm as ln)
from deepspeed_tpu_torch.ops.transformer.kernels import (  # noqa: E402
    softmax as sm)
from deepspeed_tpu_torch.telemetry import (  # noqa: E402
    PROFILE_DIR_ENV, PrometheusEndpoint, TensorBoardScalarWriter,
    profile_window, validate_trace)

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
# K4/K6 against their plain versions add the score shift. The kernels keep
# k in fp32 (codes x scale) for the scores, as the TPU kernel does; the
# plain version rounds k to q's dtype first, which moves score t by the
# known d_t = scale * q . (k32_t - kq_t). A softmax whose scores move by d
# moves its output by sum_t p_t d_t (v_t - out) to first order, and by at
# most max_t d_t^2 (sum_t p_t |v_t| + |out|) beyond it; the limit adds both,
# per element. In fp32 both dequantize alike (the same fp32 product), d is
# 0, and K3's fp32 limit holds. (A worst-case term, 2**-8 of every |q_d
# k_td|, would be some 10x looser than K3's bf16 limit: a CPU simulation at
# the decode shape puts a dropped 32-key tile at a 1000-key frontier at
# 1.7-5x that limit, and at 12-33x this one, a correct result at 0.5-0.6.)

# Greedy consistency: the engine (16-row batches) and generate (1 row)
# multiply through different GEMM shapes, so fp32 logits may differ in the
# last bits. A token mismatch is tolerated only where the reference's
# top-1/top-2 logit gap is below this.
NEAR_TIE = 1e-4
# Phase 5's search for an EOS inside an accepted draft (_eos_case): random
# base prompts, the greedy span generated from each, the new tokens of each
# candidate request, candidates served at once and at most in all.
EOS_BASES, EOS_SPAN, EOS_NEW, EOS_BATCH, EOS_TRIES = 48, 128, 24, 4, 16

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
# card's products and the kernels sum in another order than the CPU's). A
# tensor whose max-abs gradient is below GRAD_TOL of the model's largest is
# zero in exact arithmetic and rounding noise on both sides (the plain BERT
# layer's key bias: softmax ignores a shift of a row's scores): it is held
# to GRAD_TOL of the largest gradient, and its update is all noise.
# An updated parameter moves by lr * m / (sqrt(v) + eps), about lr * sign(g)
# at step 1: where |g| is within summation noise of 0 its sign, and so the
# update, may differ by up to 2 lr; elsewhere the update agrees to 1e-3 lr,
# plus two fp32 ulps of the parameter (2**-22 |p|: the two updated values
# may round to neighbouring floats, e.g. around a LayerNorm scale of 1).
GRAD_TOL = 1e-4

# K8 and K11 against their plain versions: |out - ref| <= atol + rtol *
# |ref| per element. Both compute in fp32 from the same inputs and differ in
# summation order and FMA contraction (a few fp32 ulps of terms of order 1:
# atol), then may round to neighbouring values of the output type (rtol:
# one ulp, bf16 2**-7, fp16 2**-10; fp32 2**-20). mu and rstd: 1e-5
# relative. The dropout kernels must equal their plain version exactly: the
# same Philox bits, products and sums rounded as the plain version rounds
# them (no FMA contraction).
ROW_TOL = {torch.float32: (2e-6, 2.0 ** -20),
           torch.bfloat16: (2e-6, 2.0 ** -7),
           torch.float16: (2e-6, 2.0 ** -10)}
# Arithmetic per element, for the operations bound (at the fp32 rate outside
# the tensor cores): K8 about 8 (bias, residual, centre, square, sum,
# scale, affine), K11 about 20 (bias, the cubic, tanh, the product), the
# dropout about 30 (Philox-4x32-10: ten rounds of two 32-bit multiplies
# with high words and four xors per four elements, the compare, two
# products, the sums).
ROW_OPS = {"layer_norm": 8, "bias_gelu": 20, "dropout_fwd": 30,
           "dropout_bwd": 28, "attn_softmax": 10}

# The BERT cell: the JAX package's BERT-large measurement
# (bench.py:_measure_bert, dense: batch 16 x 512, BERT-large, bf16, AdamW
# 1e-4), at the published dropout 0.1 (BertConfig's default) so that the
# dropout kernels run, with half the rows padded after 128-511 tokens.
BERT_CONFIG = {"train_batch_size": 16,
               "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
               "bf16": {"enabled": True}}
BERT_B, BERT_T = 16, 512
BERT_WARM, BERT_TIMED, BERT_DET = 2, 10, 2
# Kernel launches per layer per step at dropout > 0 (and at dropout 0):
# K8 the two post-LN LayerNorms (their bias + residual variant at dropout
# 0), K10a/K10b the attention context, attention output and FF output
# dropouts, K11 the FF1 epilogue, K1/K2a the attention.
BERT_SITES = {"layer_norm_plain": (2, 0), "layer_norm_bias_residual": (0, 2),
              "dropout_fwd": (3, 0), "dropout_bwd": (3, 0), "bias_gelu": (1, 1),
              "flash_fwd": (1, 1), "flash_bwd_fused": (1, 1),
              "flash_bwd_split": (0, 0), "sparse_fwd": (0, 0),
              "sparse_bwd_fused": (0, 0), "sparse_bwd_split": (0, 0)}
# ... and per step at dropout > 0, outside the layers: K10a/K10b for the
# embeddings' dropout.
BERT_STEP_SITES = {"dropout_fwd": 1, "dropout_bwd": 1}

# K9 (the standalone attn_softmax op; no model path calls it, as in the JAX
# package): (case, [B, H, T_q, T_k], dtype, causal, mask, timed). Timed:
# BERT-large's score shape with its padding mask, GPT-2 medium's causal
# scores; then a long row (T_k 4096: the CTA path), fp32 and fp16, a
# ragged row and the longest the tests take. Each element held to ROW_TOL
# (K9 computes in fp32 like K8/K11; one output ulp). The autograd check
# runs the op's backward on the card against the CPU at SOFTMAX_AUTOGRAD.
SOFTMAX_CASES = [
    ("bert", (BERT_B, 16, BERT_T, BERT_T), torch.bfloat16, False, True, True),
    ("gpt2", (TRAIN_B, 16, TRAIN_T, TRAIN_T), torch.bfloat16, True, False,
     True),
    ("long", (1, 16, 64, 4096), torch.bfloat16, False, True, False),
    ("bert_fp32", (2, 16, BERT_T, BERT_T), torch.float32, False, True, False),
    ("gpt2_fp16_mask", (2, 16, TRAIN_T, TRAIN_T), torch.float16, True, True,
     False),
    ("ragged_fp16", (2, 4, 33, 1001), torch.float16, False, True, False),
    ("longest_fp32", (1, 2, 8, 8192), torch.float32, False, True, False)]
SOFTMAX_SCALE = 0.125
SOFTMAX_AUTOGRAD = (2, 4, 64, 200)

# The sparse BERT cell: the JAX package's sparse BERT measurement
# (bench.py:_measure_bert(sparse=True), bench.py:848-857: BERT-large with
# max_position_embeddings 4096, batch 2 x 4096, FixedSparsityConfig(
# num_heads=16, block=64, attention="bidirectional"), bf16, AdamW 1e-4), at
# the published dropout 0.1 (the JAX bench runs 0) so that K10a/K10b run,
# with every other row padded after 1024-4095 tokens.
SPARSE_BERT_CONFIG = {"train_batch_size": 2,
                      "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
                      "bf16": {"enabled": True}}
SPARSE_B, SPARSE_T, SPARSE_BLOCK = 2, 4096, 64
SPARSE_WARM, SPARSE_TIMED, SPARSE_SPLIT = 2, 10, 2
# K7a/K7b against their plain versions: FLASH_TOL's form, |out - ref| <=
# rtol * |ref| + SPARSE_ACC * mag (mag: sk.accumulated_magnitudes). An
# element sums at most 4096 terms here (a global key block's dk/dv over
# every query of the sequence), so the order of the sums moves it by at
# most 4096 * 2**-24 of mag; the bf16 kernels' P and dS enter the products
# as hi + lo bf16 (2**-17 of each term). One 64-key block dropped from a
# row of 19 moves an element by some 1/19 of mag, about 200 times the
# limit.
SPARSE_ACC = 2.0 ** -12
# The split-default shape (phase 12): T = 8192, where the fused backward's
# resident set is over the 6 MiB budget. An element there sums up to 8192
# terms (a key's dk/dv over every query), so the order of the sums moves it
# by at most 8192 * 2**-24 of mag: FLASH_TOL's form at n = 8192.
SPLIT_DEFAULT_T = 8192
LONG_ACC = 2.0 ** -11

PLANE = plane_len_for(SERVE["max_len"], SERVE["prefill_chunk"])
# The paged pool of the slice's main path: the JAX package's default page
# length; the logical plane is PLANE rounded up to whole pages (9 pages).
PAGE_LEN = 128
PAGED = {"paged_kv": True, "kv_page_len": PAGE_LEN}
PAGED_PLANE = paged_plane_len(SERVE["max_len"], SERVE["prefill_chunk"],
                              PAGE_LEN)
# Serving paths: (line label, config beyond SERVE, the kernel of its decode
# lane, the kernel of its prefill lane (keys of decode_attention.launches),
# requests, profiled). The prefill lane reaches its slot through a one-row
# block table in every layout, so over dense planes it runs the paged
# kernels (K5 for K3's planes, K6 for K4's).
SERVE_PATHS = [("serve", {}, "decode", "paged", N_REQUESTS, True),
               ("serve_paged_int8", dict(PAGED, int8_kv=True), "paged_q8",
                "paged_q8", N_REQUESTS, True),
               ("serve_paged", PAGED, "paged", "paged", 4, False),
               ("serve_int8", {"int8_kv": True}, "q8", "paged_q8", 4, False)]
# Speculative decoding, as the JAX package's serving benchmark runs it
# (bench.py _measure_serving: spec_decode on, spec_k 4, spec_ngram 3), on
# that benchmark's stream for it: request i tiles its own random
# SPEC_PHRASE-token phrase to PROMPT_LENS[i % 2] tokens (bench.py:1098-1103).
# Every fourth request opts out (submit(spec_decode=False)).
SPEC = {"spec_decode": True, "spec_k": 4, "spec_ngram": 3}
SPEC_PHRASE = 8
VERIFY_S = SPEC["spec_k"] + 1
# Serving paths with speculation, on the tiled stream, as SERVE_PATHS: the
# dense pool (K3 at S = VERIFY_S), the same stream with speculation off
# (the JAX bench's --no-spec-decode A/B; both profiled), the paged int8
# pool (K6), and two 4-request arms: paged (K5) and int8 (K4).
SPEC_PATHS = [("serve_spec", SPEC, "decode", "paged", N_REQUESTS, True),
              ("serve_spec_off", {}, "decode", "paged", N_REQUESTS, True),
              ("serve_paged_int8_spec", dict(PAGED, int8_kv=True, **SPEC),
               "paged_q8", "paged_q8", N_REQUESTS, False),
              ("serve_paged_spec", dict(PAGED, **SPEC), "paged", "paged", 4,
               False),
              ("serve_int8_spec", dict(SPEC, int8_kv=True), "q8", "paged_q8",
               4, False)]
# The step program's keys: (prefill lane present, any row samples, any row
# filters top-k); an engine captures one CUDA graph per key it meets.
MAX_PROGRAMS = 8
# Graph-served against eager: requests and the steps compared.
GRAPH_CHECK_REQUESTS, GRAPH_CHECK_STEPS = 8, 12
# Fresh seeds per decode kernel in the stress run (ROADMAP Queue 3).
STRESS_SEEDS = 200
# The poison run: K3's one mismatch (phase 3's first case, bf16 decode,
# seed 0) repeated with its output and the plane past each frontier
# poisoned, the last POISON_CONCURRENT repeats beside launches on a second
# stream.
POISON_REPEATS, POISON_CONCURRENT = 300, 100
# The decode frontiers of phase 3: 0 to the plane's end, straddling tiles.
DECODE_POS = [0, 1, 31, 32, 33, 63, 64, 127, 128, 500, 511, 700, 1000, 1023,
              PLANE - 2, PLANE - 1]
# The prefill lane's frontiers (B1 S32): its first rows, 500 (timed), the
# plane's end, and the 32 rows starting just before, at and after a split
# boundary (the kernels cut each row every da.SPLIT_KEYS keys).
PREFILL_POS = [0, 31, 32, 500, PLANE - 32, da.SPLIT_KEYS - 1, da.SPLIT_KEYS,
               da.SPLIT_KEYS + 1]
# The verify lane's frontiers (B16 S5): its first rows; 123-127, where the
# split kernel's row group of 4 (rows 0-3) and of 1 (row 4) stop in
# different splits at 124-127; the same around the second split boundary;
# 500 and 1000; and the plane's end (PLANE - 5: the deepest frontier at
# which 5 rows fit the plane).
VERIFY_POS = [0, 1, 63, 123, 124, 125, 126, 127, 128, 2 * da.SPLIT_KEYS - 4,
              2 * da.SPLIT_KEYS - 3, 500, 700, 1000, PLANE - 6, PLANE - 5]
# A page length that does not divide da.SPLIT_KEYS: pages straddle the
# splits (phase 3's paged cases at the decode and prefill shapes).
ODD_PAGE_LEN = 48
# The dense pools' prefill lane in phase 3: the slot it reaches through
# slot_cache_view's one-row table (not 0, so a wrong row shows).
LANE_SLOT = 5
# The combine kernel against its plain version on the same partials (fp32
# out): both merge the splits in split order in fp32 and differ in exp's
# last bits and FMA contraction, a few fp32 ulps of the row's largest term.
COMBINE_RTOL = 1e-6

# cuda_ms's spin before each timed launch: about 1 ms at the H100's
# clock, longer than the host takes to enqueue what is timed (SDPA's
# forward and backward through autograd takes longer than 0.1 ms to
# enqueue; behind a shorter spin its time would include the host's).
SPIN_CYCLES = 2_000_000

# Telemetry on the serving path (phase_telemetry): the spans every served
# request and step must leave, the Prometheus scrape interval of the
# capture check, its requests, and the bound on the host time spent in
# telemetry calls, as a share of the median step (the JAX package's 5%).
TELEMETRY_SPANS = ("request/queued", "request/prefill", "request/decode",
                   "request", "step/mixed", "step/harvest")
SCRAPE_EVERY_S, SCRAPE_REQUESTS = 0.005, 4
TELEMETRY_HOST_SHARE = 0.05
# The sustained-load run (phase_sustained): the JAX package's TPU setting
# of ``bench.py --sustained`` (bench.py:1346-1360) less the prefix and
# offload tiers, which the port does not have yet: a dense int8 pool
# (K4 in the decode lane, K6 in the prefill lane). The sweep's rates are
# cut to what this engine sustains (PERF.md).
SUSTAINED_SERVE = {"max_slots": 16, "max_len": 1024, "chunk_size": 16,
                   "max_queue": 128, "int8_kv": True}
SUSTAINED_LOAD = dict(arrival="poisson", rate=12.0, n_requests=96,
                      prompt_dist="lognormal", prompt_mean=64,
                      prompt_max=256, output_dist="lognormal",
                      output_mean=96, output_min=8, output_max=256,
                      prefix_pool=4, prefix_tokens=32, vocab_size=50257,
                      seed=17)
SUSTAINED_WINDOW_S = 2.0
SUSTAINED_SLO = SLO(ttft_p99_ms=1500.0, itl_p99_ms=150.0)
SWEEP_RATES, SWEEP_REQUESTS = (1.0, 2.0, 4.0), 16
# The training breakdown (phase_train_breakdown): phase_train's setting,
# steps with the timers on and off from one seed, fused and split.
BREAKDOWN_STEPS = 4
BREAKDOWN = {"wall_clock_breakdown": True, "memory_breakdown": True,
             "steps_per_print": 1}
BREAKDOWN_TIMERS = ("forward", "backward", "backward_inner", "step")


def fail(msg):
    print("chip_smoke: FAILED: " + msg, file=sys.stderr)
    sys.exit(1)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=30, warmup=3, cold=False):
    """Median milliseconds of ``fn`` over ``reps`` launches, each bracketed
    by CUDA events. Each event pair and launch is enqueued behind a spin of
    the card (``torch.cuda._sleep``), so the interval holds the kernel's
    time, not the host's time to enqueue it. ``cold``: flush the 50 MB L2
    cache before each launch by reading 128 MB (a flush by writing would
    leave dirty lines for the timed kernel to write back); on the training
    step a row kernel reads activations that the GEMMs in between have
    pushed out of L2."""
    scratch = torch.ones(32 * 2 ** 20, device="cuda") if cold else None
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if cold:
            scratch.sum()
        torch.cuda._sleep(SPIN_CYCLES)
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
    for name in sources():
        for line in _ptxas_summary(build_log(name)):
            print("ptxas {}: {}".format(name, line))


_TYPE_NAMES = {"f": "fp32", "__nv_bfloat16": "bf16", "__half": "fp16"}


def _template_args(mangled):
    """The template arguments at the start of a mangled argument list:
    (type names, ints, bools) from ``f``, ``<n><name>``, ``Li<n>E`` and
    ``Lb<0|1>E`` tokens, up to the closing ``E``."""
    types, ints, bools = [], [], []
    while mangled and mangled[0] != "E":
        m = re.match(r"L([bi])(\d+)E|(\d+)|([a-z])", mangled)
        if m is None:  # a token this report does not name
            break
        if m.group(1):
            (ints if m.group(1) == "i" else bools).append(int(m.group(2)))
            mangled = mangled[m.end():]
        elif m.group(3):
            n = int(m.group(3))
            types.append(mangled[m.end():m.end() + n])
            mangled = mangled[m.end() + n:]
        else:
            types.append(m.group(4))
            mangled = mangled[1:]
    return types, ints, bools


def _ptxas_summary(log):
    """One line per compiled kernel from nvcc's -Xptxas=-v report: the
    kernel, its type and template flags (K2's and K7b's dq flag, K8's
    vectors per lane, the sparse kernels' block, the decode split kernel's
    int8 and paged flags), registers, spill stores."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"entry function '\S*?\d+([a-z_]+_kernel)(?:I(\w+))?"
                      r"'?", line)
        if m:
            types, ints, bools = _template_args(m.group(2) or "")
            args = [_TYPE_NAMES.get(t, t) for t in types] + \
                [str(i) for i in ints]
            if m.group(1) == "decode_split_kernel":
                args += [what for what, on in zip(("int8", "paged"), bools)
                         if on]
            elif m.group(1) == "softmax_row_kernel":
                args.append("vec" if bools == [1] else "scalar")
            elif bools == [1]:
                args.append("dq")
            name = m.group(1) + ("<{}>".format(", ".join(args)) if args
                                 else "")
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


def _case(B, S, frontiers, dtype, seed, T=PLANE):
    """q, k, v, pos on the card; positions past each row's frontier hold
    large finite garbage."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    H, D = 16, 64
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


def _probs(q, k, pos, scale):
    """fp32 probabilities over each row's visible keys."""
    S, T = q.shape[2], k.shape[2]
    q_pos = pos.long()[:, None] + torch.arange(S, device=q.device)
    mask = torch.arange(T, device=q.device)[None, None, :] <= q_pos[:, :, None]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.softmax(s.masked_fill(~mask[:, None], float("-inf")), dim=-1)


def _spread(q, k, v, pos, scale):
    """sqrt(sum_t p_t^2 v_t^2) per output element, fp32 probabilities
    over each row's visible keys (the scale of the bf16 probability
    rounding error; see TOL)."""
    p = _probs(q, k, pos, scale)
    return torch.matmul(p * p, v.float() ** 2).sqrt()


def _bound(q, pos, T, key_bytes, extra_bytes=0):
    """(bound ms, 'bytes' or 'operations') for one call: q and out, the
    ``key_bytes`` of each cached key (per head) up to each frontier and the
    frontiers read once, plus ``extra_bytes`` (a block table's entries);
    4*D flops per visible key per query row."""
    B, H, S, D = q.shape
    item = q.element_size()
    keys = np.minimum(pos.cpu().numpy().astype(np.int64) + S, T)
    nbytes = 2 * B * H * S * D * item + int(keys.sum()) * H * key_bytes \
        + 4 * B + extra_bytes
    vis = np.minimum(pos.cpu().numpy()[:, None].astype(np.int64)
                     + np.arange(S)[None] + 1, T)
    flops = 4 * D * H * int(vis.sum())
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels():
    """K3 against its plain version; returns the variant rows."""
    T = PLANE
    decode_pos = DECODE_POS
    cases = [("decode", 16, 1, decode_pos),
             ("verify", 16, VERIFY_S, VERIFY_POS)]
    cases += [("prefill_lane", 1, 32, [p]) for p in PREFILL_POS]
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
            if frontiers in ([500], decode_pos, VERIFY_POS):
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
                row["bound_ms"], row["bound_by"] = _bound(
                    q, pos, T, 2 * q.shape[3] * q.element_size())
            rows.append(row)
            print("K3 " + json.dumps(row))
    rows[0]["combine"] = _combine_check()
    return rows


def _combine_check():
    """The combine kernel (``da.combine_partials``) against its plain
    version on the plain partials of the bf16 decode case, the splits that
    hold no key of a row filled with NaN (the kernel must not read them),
    fp32 out,
    each element within COMBINE_RTOL of its row's largest |value|; timed
    at that case with a bf16 output, beside the bound of the partials it
    reads and the output it writes."""
    q, k, v, pos = _case(16, 1, DECODE_POS, torch.bfloat16, seed=0)
    S = q.shape[2]
    part = da.decode_partials_reference(q, k, v, pos, scale=1.0 / 8.0)
    run = da._splits_run(pos, S, PLANE, da.SPLIT_KEYS)
    unused = torch.arange(part.shape[0], device="cuda")[:, None, None] >= \
        run[None]
    part.masked_fill_(unused[:, :, None, :, None], float("nan"))
    out = da.combine_partials(part, pos, PLANE, torch.float32)
    ref = da.combine_partials_reference(part, pos, PLANE, torch.float32)
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        fail("the combine kernel's output is not finite or of wrong shape")
    diff = (out - ref).abs()
    limit = COMBINE_RTOL * ref.abs().amax(dim=-1, keepdim=True)
    row = {"case": "decode B16 H16 S1 T{} partials".format(PLANE),
           "splits_run": int(run.sum()), "max_abs_err": float(diff.max()),
           "rtol_of_row_max": COMBINE_RTOL,
           "max_err_over_limit": float((diff / limit).max())}
    if row["max_err_over_limit"] > 1.0:
        print("combine " + json.dumps(row))
        fail("the combine kernel disagrees with its plain version")
    row["ms"] = cuda_ms(lambda: da.combine_partials(part, pos, PLANE,
                                                    torch.bfloat16))
    B, H, _, D = q.shape
    nbytes = int(run.sum()) * H * (D + 2) * 4 + B * H * S * D * 2 + 4 * B
    row["bound_ms"] = nbytes / HBM_BYTES_S * 1e3
    print("combine " + json.dumps(row))
    return row


# ------------------------------------- K4, K5, K6: int8 and paged decode

# (kernel, its name in the kernels line): the launches key, the table id.
DECODE_VARIANTS = [("q8", "K4"), ("paged", "K5"), ("paged_q8", "K6")]
DECODE_KEYS = [("decode", "K3")] + DECODE_VARIANTS


def _q8_case(B, S, frontiers, dtype, seed, T=PLANE):
    """``_case`` with k and v quantized (``quantize_kv`` of the planes in
    ``dtype``, as the serving path quantizes): q, codes k, v, scales k, v,
    pos."""
    q, k, v, pos = _case(B, S, frontiers, dtype, seed, T)
    (kc, ks), (vc, vs) = da.quantize_kv(k), da.quantize_kv(v)
    return q, kc, vc, ks, vs, pos


def _paged(planes, pos, S, seed, page_len=PAGE_LEN):
    """Scatter logical planes ``[B, H, T, ...]`` (keys, codes or scales; T
    a multiple of ``page_len``) into page arenas of ``page_len`` positions
    through one shuffled block table: row b's
    logical pages up to its frontier's page map to distinct shuffled pages,
    the rest to the trash page 0. The trash page and 4 pages no row maps
    hold large finite garbage. Returns (arenas, table)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 7919)
    B = pos.shape[0]
    n_lp = planes[0].shape[2] // page_len
    n_pages = B * n_lp + 5
    tbl = torch.randperm(n_pages - 1, device="cuda",
                         generator=g)[:B * n_lp].reshape(B, n_lp) + 1
    last = (pos.long() + S - 1) // page_len
    mapped = torch.arange(n_lp, device="cuda")[None] <= last[:, None]
    tbl = torch.where(mapped, tbl, 0).to(torch.int32).contiguous()
    arenas = []
    for plane in planes:
        tail = tuple(plane.shape[3:])
        shape = (n_pages, plane.shape[1], page_len) + tail
        if plane.dtype == torch.int8:
            arena = torch.randint(-127, 128, shape, device="cuda",
                                  generator=g, dtype=torch.int8)
        elif not tail:  # a scale plane: large positive garbage
            arena = 1e3 * (1.0 + torch.rand(shape, device="cuda",
                                            generator=g))
        else:
            arena = (3e4 * torch.sign(torch.randn(
                shape, device="cuda", generator=g))).to(plane.dtype)
        rows = plane.reshape((B, plane.shape[1], n_lp, page_len) + tail)
        arena[tbl[mapped].long()] = rows.movedim(2, 1)[mapped]
        arenas.append(arena.contiguous())
    return arenas, tbl


def _variant(kind, B, S, frontiers, dtype, seed, scale=1.0 / 8.0,
             page_len=PAGE_LEN):
    """One case of decode kernel ``kind`` (a key of DECODE_KEYS) on the
    card: launches of the kernel, its plain version and its dense twin
    (K3 on the gathered plane for K5, K4 for K6), the fp32 planes its limit
    is computed from, and what its bound counts. Paged kinds use pages of
    ``page_len`` positions."""
    item = dtype.itemsize
    if kind in ("decode", "q8"):
        T, extra = PLANE, 0
        if kind == "decode":
            q, k, v, pos = _case(B, S, frontiers, dtype, seed)
            ops, kv = (k, v), (k, v)
        else:
            q, kc, vc, ks, vs, pos = _q8_case(B, S, frontiers, dtype, seed)
            ops = (kc, vc, ks, vs)
            kv = (da.dequantize_kv(kc, ks), da.dequantize_kv(vc, vs))
        twin = None
    else:
        T = paged_plane_len(SERVE["max_len"], SERVE["prefill_chunk"],
                            page_len)
        if kind == "paged":
            q, k, v, pos = _case(B, S, frontiers, dtype, seed, T)
            planes = (k, v)
        else:
            q, kc, vc, ks, vs, pos = _q8_case(B, S, frontiers, dtype, seed, T)
            planes = (kc, vc, ks, vs)
        arenas, tbl = _paged(planes, pos, S, seed, page_len)
        ops = tuple(arenas) + (tbl,)
        g = [da.gather_pages(a, tbl) for a in arenas]
        kv = g if kind == "paged" else \
            (da.dequantize_kv(g[0], g[2]), da.dequantize_kv(g[1], g[3]))
        dense = da.flash_decode_attention if kind == "paged" else \
            da.flash_decode_attention_q8

        def twin():
            return dense(q, *g, pos, scale)
        # The table entries up to each row's frontier page.
        extra = 4 * int(((pos.long() + S - 1) // page_len + 1).sum())
    kernel, plain = {
        "decode": (da.flash_decode_attention, da.decode_attention_reference),
        "q8": (da.flash_decode_attention_q8,
               da.decode_attention_q8_reference),
        "paged": (da.flash_decode_attention_paged,
                  da.decode_attention_paged_reference),
        "paged_q8": (da.flash_decode_attention_paged_q8,
                     da.decode_attention_paged_q8_reference)}[kind]
    q8 = kind in ("q8", "paged_q8")
    return {"q": q, "pos": pos, "T": T, "kv": kv, "q8": q8,
            "key_bytes": 2 * 64 + 8 if q8 else 2 * 64 * item,
            "extra": extra, "twin": twin,
            "kernel": lambda: kernel(q, *ops, pos, scale),
            "plain": lambda: plain(q, *ops, pos, scale)}


def _lane_variant(kind, frontier, dtype, seed, scale=1.0 / 8.0):
    """The dense pools' prefill lane as the engine runs it: one layer of a
    pool of SERVE's slots (``init_pool``; int8 codes and scales for
    ``kind`` "paged_q8"), every slot's plane filled (garbage past each
    frontier), viewed by ``slot_cache_view`` at slot LANE_SLOT: the planes
    as an arena of one PLANE-long page per slot and the table
    [[LANE_SLOT]]. K5 (K6) there against its plain version, and against K3
    (K4) on the slot's own plane bit for bit. The ``_variant`` dict."""
    slots, S = SERVE["max_slots"], SERVE["prefill_chunk"]
    q8 = kind == "paged_q8"
    gcfg = generation.as_gencfg(GPT2Config(n_layer=1, n_head=16,
                                           n_embd=1024, dtype=dtype))
    pool = init_pool(gcfg, slots, SERVE["max_len"], slack=S, device="cuda",
                     hier=HierarchySpec(int8=q8))
    q, k, v, pos = _case(slots, S, [frontier] * slots, dtype, seed)
    if q8:
        (kc, ks), (vc, vs) = da.quantize_kv(k), da.quantize_kv(v)
        for name, t in (("k", kc), ("v", vc), ("k_scale", ks),
                        ("v_scale", vs)):
            pool[name][0].copy_(t)
    else:
        pool["k"][0].copy_(k)
        pool["v"][0].copy_(v)
    at = slice(LANE_SLOT, LANE_SLOT + 1)
    q, pos = q[at].contiguous(), pos[at]
    view = slot_cache_view(pool, torch.tensor([LANE_SLOT], device="cuda"),
                           pos)
    names = ("k", "v", "k_scale", "v_scale") if q8 else ("k", "v")
    arenas = [view[name][0] for name in names]
    tbl = view["block_tbl"]
    own = [a[at] for a in arenas]  # the slot's own plane
    if q8:
        kernel, plain, dense = (da.flash_decode_attention_paged_q8,
                                da.decode_attention_paged_q8_reference,
                                da.flash_decode_attention_q8)
        kv = (da.dequantize_kv(own[0], own[2]),
              da.dequantize_kv(own[1], own[3]))
    else:
        kernel, plain, dense = (da.flash_decode_attention_paged,
                                da.decode_attention_paged_reference,
                                da.flash_decode_attention)
        kv = own
    return {"q": q, "pos": pos, "T": PLANE, "kv": kv, "q8": q8,
            "key_bytes": 2 * 64 + 8 if q8 else 2 * 64 * dtype.itemsize,
            "extra": 4, "twin": lambda: dense(q, *own, pos, scale),
            "kernel": lambda: kernel(q, *arenas, tbl, pos, scale),
            "plain": lambda: plain(q, *arenas, tbl, pos, scale)}


def _decode_limit(c, ref, dtype, scale=1.0 / 8.0):
    """Each element's limit: TOL's, plus for K4/K6 the score shift (see
    TOL)."""
    q, pos = c["q"], c["pos"]
    k, v = (t.float() for t in c["kv"])
    atol, rtol = TOL[dtype]
    p = _probs(q, k, pos, scale)
    limit = atol + rtol * (ref.float().abs()
                           + torch.matmul(p * p, v ** 2).sqrt())
    if c["q8"]:
        v = v.to(dtype).float()  # both round v to q's dtype
        out = ref.float()
        d = torch.matmul(q.float(), (k - k.to(dtype).float())
                         .transpose(-1, -2)) * scale
        pd = p * d
        d_max = (d.abs() * (p > 0)).amax(-1, keepdim=True)
        limit = limit + (torch.matmul(pd, v)
                         - out * pd.sum(-1, keepdim=True)).abs() \
            + d_max ** 2 * (torch.matmul(p, v.abs()) + out.abs())
    return limit


def _decode_check(label, c, dtype, frontiers):
    """Run one case: the kernel against its plain version (per element,
    ``_decode_limit``) and against its dense twin (bit for bit). Returns
    the row; a row over its limit or unequal to its twin carries the worst
    element and ``"ok": False``."""
    out, ref = c["kernel"](), c["plain"]()
    twin = c["twin"]() if c["twin"] is not None else None
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        fail("{} output not finite or wrong shape ({})".format(label, dtype))
    diff = (out.float() - ref.float()).abs()
    limit = _decode_limit(c, ref, dtype)
    ratio = float((diff / limit).max())
    row = {"dtype": str(dtype).split(".")[-1], "max_abs_err": float(diff.max()),
           "max_err_over_limit": ratio, "ok": ratio <= 1.0}
    if twin is not None:
        row["equal_to_dense_twin"] = bool(torch.equal(out, twin))
        row["ok"] = row["ok"] and row["equal_to_dense_twin"]
    if ratio > 1.0:
        worst = int((diff / limit).flatten().argmax())
        at_ = tuple(int(i) for i in np.unravel_index(worst, tuple(diff.shape)))
        row["worst"] = {"index": list(at_), "frontier": frontiers[at_[0]],
                        "out": float(out.float()[at_]),
                        "ref": float(ref.float()[at_])}
    return row


def phase_decode_variants():
    """K4, K5 and K6 against their plain versions at phase 3's cases, K5
    and K6 also against their dense twins bit for bit, K5 and K6 also at
    pages of ODD_PAGE_LEN (the decode and verify cases and the prefill lane
    across a split boundary) and at the dense pools' prefill lane
    (``_lane_variant``, PREFILL_POS); times at the decode, verify and the
    frontier-500 prefill cases. Returns {kind: rows}."""
    cases = [("decode", 16, 1, DECODE_POS, PAGE_LEN),
             ("verify", 16, VERIFY_S, VERIFY_POS, PAGE_LEN)]
    cases += [("prefill_lane", 1, 32, [p], PAGE_LEN) for p in PREFILL_POS]
    odd = [("decode_pages{}".format(ODD_PAGE_LEN), 16, 1, DECODE_POS,
            ODD_PAGE_LEN),
           ("verify_pages{}".format(ODD_PAGE_LEN), 16, VERIFY_S, VERIFY_POS,
            ODD_PAGE_LEN)]
    odd += [("prefill_lane_pages{}".format(ODD_PAGE_LEN), 1, 32,
             [da.SPLIT_KEYS + d], ODD_PAGE_LEN) for d in (-1, 0, 1)]
    rows = {}
    for kind, label in DECODE_VARIANTS:
        for dtype in (torch.bfloat16, torch.float32):
            for name, B, S, frontiers, page_len in \
                    cases + (odd if kind != "q8" else []):
                c = _variant(kind, B, S, frontiers, dtype,
                             seed=100 + len(rows.get(kind, [])),
                             page_len=page_len)
                row = dict(case=name, B=B, S=S, T=c["T"], pos=frontiers,
                           **_decode_check(label, c, dtype, frontiers))
                if kind != "q8":
                    row["page_len"] = page_len
                if not row["ok"]:
                    print(label + " " + json.dumps(row))
                    fail("{} disagrees with its plain version or its dense "
                         "twin at {} {}".format(label, name, dtype))
                if frontiers in ([500], DECODE_POS, VERIFY_POS) and \
                        page_len == PAGE_LEN:
                    row["ms"] = cuda_ms(c["kernel"])
                    row["plain_ms"] = cuda_ms(c["plain"])
                    row["bound_ms"], row["bound_by"] = _bound(
                        c["q"], c["pos"], c["T"], c["key_bytes"], c["extra"])
                    row["library_ms"] = None
                rows.setdefault(kind, []).append(row)
                print(label + " " + json.dumps(row))
                del c
        if kind == "q8":
            continue
        for dtype in (torch.bfloat16, torch.float32):
            for p in PREFILL_POS:
                c = _lane_variant(kind, p, dtype,
                                  seed=100 + len(rows[kind]))
                row = dict(case="dense_prefill_lane_slot{}".format(LANE_SLOT),
                           B=1, S=SERVE["prefill_chunk"], T=PLANE, pos=[p],
                           page_len=PLANE, slots=SERVE["max_slots"],
                           **_decode_check(label, c, dtype, [p]))
                if not row["ok"]:
                    print(label + " " + json.dumps(row))
                    fail("{} disagrees with its plain version or its dense "
                         "twin at the dense prefill lane {} {}".format(
                             label, p, dtype))
                if p == 500:
                    row["ms"] = cuda_ms(c["kernel"])
                    row["plain_ms"] = cuda_ms(c["plain"])
                    row["bound_ms"], row["bound_by"] = _bound(
                        c["q"], c["pos"], c["T"], c["key_bytes"], c["extra"])
                rows[kind].append(row)
                print(label + " " + json.dumps(row))
                del c
    return rows


def phase_stress():
    """K3, K4, K5 and K6 at the bf16 decode case over STRESS_SEEDS fresh
    seeds each; fails if any case is over its limit or unequal to its dense
    twin, after printing every kernel's count."""
    bad = False
    for i, (kind, label) in enumerate(DECODE_KEYS):
        over = unequal = 0
        worst = {"max_err_over_limit": 0.0}
        for n in range(STRESS_SEEDS):
            seed = 10_000 * (i + 1) + n
            c = _variant(kind, 16, 1, DECODE_POS, torch.bfloat16, seed)
            row = _decode_check(label, c, torch.bfloat16, DECODE_POS)
            del c
            over += row["max_err_over_limit"] > 1.0
            unequal += row.get("equal_to_dense_twin") is False
            if row["max_err_over_limit"] >= worst["max_err_over_limit"]:
                worst = dict(row, seed=seed)
        bad = bad or over or unequal
        print("stress " + json.dumps({
            "kernel": label, "case": "decode bf16 B16 S1", "seeds":
            STRESS_SEEDS, "over_limit": over, "unequal_to_dense_twin":
            unequal, "worst": worst}))
    if not _poison_run():
        fail("K3 gave a non-finite output or one over its limit in the "
             "poison run")
    if bad:
        fail("a decode kernel disagreed with its plain version or its dense "
             "twin in the stress run")


def _poison_run():
    """K3's one mismatch (once, at phase 3's first case) hunted with
    sentinels: the case repeated POISON_REPEATS times, the output buffer
    filled with NaN (even repeats) or 1e4 (odd) just before each launch
    (the launch's output reuses the freed block: the caching allocator
    hands a freed block of the same size back on the same stream; the
    count of launches that landed there is printed), the keys and values of
    the frontier's 32-key tile past the frontier set to 1e4 (the kernel
    loads them and must weigh them 0) and of every later tile to NaN (the
    kernel must never load them); the last POISON_CONCURRENT repeats run
    beside K3 launches on a second stream. Returns True when every output
    was finite and within its limit."""
    dtype, scale = torch.bfloat16, 1.0 / 8.0
    q, k, v, pos = _case(16, 1, DECODE_POS, dtype, seed=0)
    ref = da.decode_attention_reference(q, k, v, pos, scale)
    limit = _decode_limit({"q": q, "pos": pos, "kv": (k, v), "q8": False},
                          ref, dtype, scale)
    key = torch.arange(PLANE, device="cuda")[None]
    past = key > pos.long()[:, None]
    beyond = key >= (pos.long()[:, None] // 32 + 1) * 32
    sentinel = torch.where(beyond, float("nan"), 1e4)[:, None, :, None]
    k_p, v_p = (torch.where(past[:, None, :, None], sentinel, t.float())
                .to(dtype) for t in (k, v))
    side_case = _case(16, 1, DECODE_POS, dtype, seed=1)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    landed = non_finite = over = 0
    worst = 0.0
    for i in range(POISON_REPEATS):
        if i >= POISON_REPEATS - POISON_CONCURRENT:
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(4):
                    da.flash_decode_attention(*side_case, scale)
        poison = torch.full_like(q, float("nan") if i % 2 == 0 else 1e4)
        where = poison.data_ptr()
        del poison
        out = da.flash_decode_attention(q, k_p, v_p, pos, scale)
        landed += out.data_ptr() == where
        finite = bool(torch.isfinite(out).all())
        non_finite += not finite
        ratio = float(((out.float() - ref.float()).abs() / limit).max()) \
            if finite else float("inf")
        over += ratio > 1.0
        worst = max(worst, ratio)
    torch.cuda.synchronize()
    print("stress " + json.dumps({
        "kernel": "K3", "case": "poison: decode bf16 B16 S1 seed 0",
        "repeats": POISON_REPEATS, "concurrent": POISON_CONCURRENT,
        "out_poisoned": landed, "non_finite": non_finite,
        "over_limit": over, "worst_err_over_limit": worst}))
    return non_finite == 0 and over == 0


def _prompts(n, vocab, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=PROMPT_LENS[i % 2]) for i in range(n)]


def _tiled_prompts(n, vocab, seed):
    """The speculation stream (SPEC): request i tiles its own random
    SPEC_PHRASE-token phrase to PROMPT_LENS[i % 2] tokens."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        size = PROMPT_LENS[i % 2]
        phrase = rng.randint(0, vocab, size=SPEC_PHRASE)
        out.append(np.tile(phrase, -(-size // SPEC_PHRASE))[:size])
    return out


_SPEC_KEYS = ("spec_k", "spec_ngram", "accepted_per_step_mean",
              "accepted_per_step_p50", "accepted_per_step_p99",
              "draft_accept_rate")


def phase_serve(card, model, label, extra, kernel, lane_kernel, n_requests,
                profile, tiled=False):
    """One serving path through init_inference: ``n_requests`` of the mix
    under SERVE plus ``extra`` (``tiled``: the speculation stream, every
    fourth request opted out of speculation); the decode kernels' launch
    counts are reset just before the run and read just after. The step
    programs: one CUDA graph per key met, captured at its first step, every
    later step a replay. Returns the launch counts and the path's line."""
    cfg = model.config
    engine = init_inference(model, config=dict(SERVE, **extra))
    reqs = []
    prompts = (_tiled_prompts if tiled else _prompts)(
        n_requests, cfg.vocab_size, seed=0)
    for i, p in enumerate(prompts):
        sampled = i % 6 == 5
        reqs.append(engine.submit(
            p, max_new_tokens=NEW_TOKENS,
            temperature=0.8 if sampled else 0.0,
            top_k=50 if sampled else None, seed=i,
            spec_decode=False if tiled and i % 4 == 0 else None))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    da.reset_launches()
    peak_pages = 0
    t0 = time.perf_counter()
    while not engine.idle:
        engine.step()
        if engine.kv_page_stats() is not None:
            peak_pages = max(peak_pages,
                             engine.kv_page_stats()["pages_in_use"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(da.launches)
    m = engine.metrics()
    for r in reqs:
        toks = np.asarray(r.tokens)
        if len(toks) != NEW_TOKENS or toks.min() < 0 or \
                toks.max() >= cfg.vocab_size:
            fail("{}: request {} returned {} tokens (range {}..{})".format(
                label, r.rid, len(toks), toks.min(), toks.max()))
    want = dict.fromkeys(launches, 0)
    want[kernel] += cfg.n_layer * m["decode_steps"]
    want[lane_kernel] += cfg.n_layer * m["prefill_lanes"]
    if launches != want:
        fail("{}: decode kernel launches {} != n_layer x decode steps of {} "
             "plus n_layer x prefill lanes of {}, none of the others: {}"
             .format(label, launches, kernel, lane_kernel, want))
    met = sorted(engine._programs)
    if m["compile_count"] > MAX_PROGRAMS or \
            m["graph_replays"] != m["chunks"] - m["compile_count"]:
        fail("{}: {} steps met keys {}: compile_count {} (at most {}) and "
             "graph_replays {} (should be {})".format(
                 label, m["chunks"], met, m["compile_count"], MAX_PROGRAMS,
                 m["graph_replays"], m["chunks"] - m["compile_count"]))
    line = {label: "gpt2-medium bf16", "requests": n_requests,
            "new_tokens": NEW_TOKENS, "wall_s": wall,
            "tokens_out": m["tokens_out"],
            "tokens_per_s": m["tokens_out"] / wall,
            "ttft_p50_ms": m["ttft_p50_ms"], "ttft_p99_ms": m["ttft_p99_ms"],
            "steps": m["chunks"], "mean_step_ms": wall / m["chunks"] * 1e3,
            "decode_steps": m["decode_steps"],
            "prefill_lanes": m["prefill_lanes"], "kernel": kernel,
            "lane_kernel": lane_kernel, "launches": launches,
            "compile_count": m["compile_count"],
            "graph_replays": m["graph_replays"],
            "program_keys": [list(k) for k in met],
            "capture_ms": m["capture_ms"],
            "graph_pool_bytes": m["graph_pool_bytes"],
            "kv_hbm_bytes": m["kv_hbm_bytes"],
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "card": card}
    if tiled:
        line.update(stream="tiled {}-token phrases, every fourth request "
                    "opted out".format(SPEC_PHRASE),
                    spec_decode=m["spec_decode"],
                    **{key: m[key] for key in _SPEC_KEYS if key in m})
    stats = engine.kv_page_stats()
    if stats is not None:
        if stats["pages_in_use"] != 0:
            fail("{}: {} pages still in use after the run".format(
                label, stats["pages_in_use"]))
        line.update(page_len=stats["page_len"],
                    pages_total=stats["pages_total"],
                    peak_pages_in_use=peak_pages)
    print(label + " " + json.dumps(line))
    if profile:
        phase_profile(engine, cfg, label.replace("serve", "profile"),
                      tiled=tiled)
    return launches, line


class _EagerEngine(InferenceEngine):
    """The engine with every step's program run eagerly: what a
    graph-served engine is held to."""

    def _run_program(self, key):
        self._program(*key)


def phase_graph_vs_eager(model):
    """A graph-served engine against the same step program run eagerly, at
    full width, dense and paged int8, each without and with speculation
    (SPEC, on the tiled stream, every fourth request from the second
    opted out): GRAPH_CHECK_STEPS steps of one mix (every third request
    sampled, one with top-k) must give the same harvest (tokens, validity,
    first tokens, per-slot fields) at every step, and the same pool
    (planes, scales, table, per-slot fields, token ring) after them, bit
    for bit. One exception, printed under "pool_differs": a speculating
    paged pool may differ where no read sees, in its trash page (page 0)
    and in token-ring entries past a row's frontier. The frozen rows of
    freed slots write their spec_k + 1 verify positions into the trash
    page together, a CUDA indexed write with repeated indices keeps any
    one of the values, and those rows read that page back: their choices,
    written to the ring past their frontier, may differ too."""
    cfg = model.config
    for label, extra in (("dense", {}),
                         ("paged_int8", dict(PAGED, int8_kv=True)),
                         ("dense_spec", SPEC),
                         ("paged_int8_spec", dict(PAGED, int8_kv=True,
                                                  **SPEC))):
        spec = "spec_decode" in extra
        prompts = (_tiled_prompts if spec else _prompts)(
            GRAPH_CHECK_REQUESTS, cfg.vocab_size, seed=3)
        runs = []
        for engine in (init_inference(model, config=dict(SERVE, **extra)),
                       _EagerEngine(model, config=dict(SERVE, **extra))):
            for i, p in enumerate(prompts):
                kw = {"temperature": 0.8, "seed": i,
                      "top_k": 50 if i == 2 else None} if i % 3 == 2 else {}
                if spec and i % 4 == 1:
                    kw["spec_decode"] = False
                engine.submit(p, max_new_tokens=NEW_TOKENS, **kw)
            snaps = []
            for _ in range(GRAPH_CHECK_STEPS):
                engine.step()
                snaps.append(engine._last_snap)
            torch.cuda.synchronize()
            runs.append((engine, snaps))
        (graphed, got), (eager, want) = runs
        for step, (a, b) in enumerate(zip(got, want)):
            for name in a:
                if not np.array_equal(a[name], b[name]):
                    fail("graph_vs_eager {}: step {}: {} differs".format(
                        label, step, name))
        pool_diffs = _pool_diffs(graphed, eager, spec, label)
        m = graphed.metrics()
        if m["compile_count"] > MAX_PROGRAMS or \
                m["graph_replays"] != GRAPH_CHECK_STEPS - m["compile_count"]:
            fail("graph_vs_eager {}: compile_count {}, graph_replays {}, "
                 "keys {}".format(label, m["compile_count"],
                                  m["graph_replays"],
                                  sorted(graphed._programs)))
        print("graph_vs_eager " + json.dumps({
            "layout": label, "spec_decode": spec,
            "accepted_per_step_mean": m.get("accepted_per_step_mean"),
            "steps": GRAPH_CHECK_STEPS,
            "compile_count": m["compile_count"],
            "graph_replays": m["graph_replays"],
            "tokens_compared": int(sum(s["valid"].sum() for s in got)),
            "harvests_identical": True, "pool_differs": pool_diffs}))
        del graphed, eager, runs


def _pool_diffs(graphed, eager, spec, label):
    """Compare two engines' pools in full: per tensor that differs, the
    number of differing elements and, for k/v and scales, the pages they
    lie in. Only a speculating paged pool may differ, and only where no
    read sees (``phase_graph_vs_eager``): page 0 of k/v and scales, and
    token-ring entries past a row's frontier. Anything else fails,
    printing the first differing indices."""
    out = {}
    pos = graphed._pool["pos"].long()
    paged = spec and "block_tbl" in graphed._pool
    for name, t in graphed._pool.items():
        idx = (t != eager._pool[name]).nonzero()
        if not len(idx):
            continue
        out[name] = {"elements": len(idx)}
        if name in ("k", "v", "k_scale", "v_scale"):
            out[name]["pages"] = sorted(set(idx[:, 1].tolist()))
            unread = paged and out[name]["pages"] == [0]
        else:
            unread = paged and name == "toks" and bool(
                (idx[:, 1] > pos[idx[:, 0]]).all())
        if not unread:
            fail("graph_vs_eager {}: pool {} differs after {} steps at {} "
                 "elements, first {}".format(label, name, GRAPH_CHECK_STEPS,
                                             len(idx), idx[:8].tolist()))
    return out


def phase_profile(engine, cfg, label, warm=4, window=3, tiled=False):
    """Where a mixed step's time goes: torch.profiler over ``window``
    steps of a full pool (16 fresh requests, ``warm`` steps in; ``tiled``:
    the speculation stream's prompts)."""
    prompts = (_tiled_prompts if tiled else _prompts)(
        SERVE["max_slots"], cfg.vocab_size, 2)
    for i, p in enumerate(prompts):
        engine.submit(p, max_new_tokens=48, seed=i)
    for _ in range(warm):
        engine.step()
    print(label + " " + json.dumps(_profile(engine.step, window)))


def _union_ms(spans):
    """Total length in ms of the union of (start, end) spans in us."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def _profile(step, window):
    """torch.profiler over ``window`` calls of ``step``: device time by
    kernel name per call and the device's busy share of the wall clock.
    Kernels may overlap (the decode kernels' combine is launched as the
    split kernel's programmatic dependent and its span includes its wait),
    so the sum of kernel times overstates busy time: the union of the
    kernels' spans is reported beside it, also for the decode kernels
    alone."""
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
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events()
             if str(getattr(e, "device_type", "")).endswith("CUDA")]
    union = _union_ms(sp[1:] for sp in spans) / window
    decode = _union_ms(sp[1:] for sp in spans
                       if "decode_split_kernel" in sp[0]
                       or "decode_combine_kernel" in sp[0]) / window
    out = {
        "window_steps": window, "step_ms": wall_ms / window,
        "device_busy_ms_per_step": busy if kernels else "not measured",
        "device_busy_share": busy * window / wall_ms if kernels else None,
        "device_busy_union_ms_per_step": union if spans else "not measured",
        "device_busy_union_share": union * window / wall_ms if spans
        else None,
        "top_kernels_ms_per_step": [
            {"name": k[:140], "ms": ms, "calls": n} for k, (ms, n) in top]}
    if decode:
        out["decode_attention_union_ms_per_step"] = decode
    return out


def _parse_prom(text):
    """Prometheus text -> ({name: kind}, {(name, labels): value}), with
    no help from the exporter's own formatting; raises on a line it
    cannot read."""
    kinds, samples = {}, {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("#"):
            _, _, name, kind = line.split()
            kinds[name] = kind
            continue
        head, val = line.rsplit(" ", 1)
        name, labels = head, ()
        if "{" in head:
            name, rest = head.split("{", 1)
            labels = tuple(sorted(
                (kv.split("=", 1)[0], kv.split("=", 1)[1].strip('"'))
                for kv in rest.rstrip("}").split(",")))
        samples[(name, labels)] = float(val)
    return kinds, samples


def _pct(vals, p):
    """Nearest-rank percentile (the registry's and the report's rule)."""
    if not vals:
        return None
    s = sorted(vals)
    return s[min(int(len(s) * p / 100.0), len(s) - 1)]


class _HostClock(object):
    """Seconds the host spends inside the serving engine's telemetry
    calls, by kind, each call timed with perf_counter. ``instrument``
    wraps the engine's span recorder, profiler scopes, timers, counters,
    histograms, recompile detector and adapter hook; a call made from
    inside another timed call counts once, in the outer one."""

    def __init__(self):
        self.s = collections.Counter()
        self._depth = 0

    def _call(self, kind, fn, *args, **kwargs):
        if self._depth:
            return fn(*args, **kwargs)
        self._depth += 1
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            self.s[kind] += time.perf_counter() - t0
            self._depth -= 1

    def wrap(self, kind, fn):
        return lambda *a, **k: self._call(kind, fn, *a, **k)

    def scope(self, kind, make):
        """A context-manager factory whose construction, enter and exit
        are timed (not the body)."""
        clock = self

        class _Scope(object):
            def __init__(self, args, kwargs):
                self.cm = clock._call(kind, make, *args, **kwargs)

            def __enter__(self):
                return clock._call(kind, self.cm.__enter__)

            def __exit__(self, *exc):
                return clock._call(kind, self.cm.__exit__, *exc)

        return lambda *a, **k: _Scope(a, k)

    def proxy(self, kind, obj, methods):
        """``obj`` with ``methods`` timed; other attributes pass."""
        clock = self

        class _Proxy(object):
            def __getattr__(self, name):
                attr = getattr(obj, name)
                return clock.wrap(kind, attr) if name in methods else attr

        return _Proxy()

    def instrument(self, engine):
        tracer = engine.tracer  # the scheduler holds the same recorder
        tracer.span = self.wrap("spans", tracer.span)
        tracer.instant = self.wrap("spans", tracer.instant)
        tracer.timed = self.scope("spans", tracer.timed)
        engine._annotate = self.scope("annotate", engine._annotate)
        timers, proxies = engine.timers, {}

        def timer(name):
            if name not in proxies:
                proxies[name] = self.proxy("timers", timers(name),
                                           ("start", "stop"))
            return proxies[name]

        engine.timers = timer
        bank, clock = engine.counters, self

        class _Bank(object):
            def __getitem__(self, name):
                return clock._call("counters", bank.__getitem__, name)

            def __setitem__(self, name, value):
                clock._call("counters", bank.__setitem__, name, value)

            def window(self, name):
                return clock._call("counters", bank.window, name)

        engine.counters = _Bank()
        engine._lane_steps = self.proxy("counters", engine._lane_steps,
                                        ("inc",))
        for name in ("_ttft_hist", "_itl_hist"):
            setattr(engine, name, self.proxy(
                "histograms", getattr(engine, name), ("observe",)))
        sched = engine._scheduler
        sched._queue_wait = self.proxy("histograms", sched._queue_wait,
                                       ("observe",))
        engine.recompile_detector = self.proxy(
            "recompiles", engine.recompile_detector, ("observe",))
        engine._adapter = self.proxy("adapter", engine._adapter,
                                     ("observe",))


def _serve_turn(engine, prompts, sampled_at=lambda i: i % 6 == 5):
    """Serve ``prompts`` to the end on ``engine``, the requests for which
    ``sampled_at(i)`` holds sampled with top-k 50 (phase_serve's stream:
    every sixth). Returns the per-step host ms, the streams, the tokens
    out, each request's TTFT (s) with whether its first token came in a
    step that captured a graph and whether it waited through one, and
    each capturing step (its ms, the requests still waiting)."""
    reqs = []
    for i, p in enumerate(prompts):
        sampled = sampled_at(i)
        reqs.append(engine.submit(
            p, max_new_tokens=NEW_TOKENS,
            temperature=0.8 if sampled else 0.0,
            top_k=50 if sampled else None, seed=i))
    step_ms, captures, in_capture, delayed = [], [], set(), set()
    while not engine.idle:
        before = engine.compile_count
        waiting = {r.rid for r in reqs if r.first_token_time is None}
        t0 = time.perf_counter()
        engine.step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if engine.compile_count > before:
            first = {r.rid for r in reqs
                     if r.rid in waiting and r.first_token_time is not None}
            in_capture |= first
            delayed |= waiting - first
            captures.append({"step": len(step_ms) - 1,
                             "step_ms": step_ms[-1],
                             "requests_waiting": len(waiting)})
    ttft = [(r.first_token_time - r.submit_time, r.rid in in_capture,
             r.rid in delayed) for r in reqs]
    return {"step_ms": step_ms, "streams": [r.tokens for r in reqs],
            "tokens": sum(len(r.tokens) for r in reqs), "ttft": ttft,
            "captures": captures}


def _ttft_split(turn):
    """TTFT p50/p99 (ms) of a turn's requests: all, those whose first
    token came in a capturing step, those that waited through a capture
    for it, and the rest."""
    def stats(rows):
        ms = [t * 1e3 for t, _, _ in rows]
        return {"n": len(ms), "p50_ms": _pct(ms, 50), "p99_ms": _pct(ms, 99)}

    rows = turn["ttft"]
    return {"all": stats(rows),
            "first_token_in_capturing_step": stats([r for r in rows if r[1]]),
            "waited_through_a_capture": stats([r for r in rows if r[2]]),
            "no_capture": stats([r for r in rows if not r[1] and not r[2]]),
            "captures": turn["captures"]}


def _scraped_serve(model, prompts, sampled_at):
    """A fresh engine serves ``prompts`` while a thread scrapes its
    PrometheusEndpoint every SCRAPE_EVERY_S: the streams, the scrape
    count and the keys captured."""
    engine = init_inference(model, config=dict(SERVE))
    endpoint = PrometheusEndpoint(engine.telemetry, port=0)
    url = "http://{}:{}/metrics".format(endpoint.host, endpoint.port)
    scrapes, errors, stop = [0], [], threading.Event()

    def scrape():
        while not stop.is_set():
            try:
                urllib.request.urlopen(url, timeout=30).read()
                scrapes[0] += 1
            except OSError as e:
                errors.append(repr(e))
            time.sleep(SCRAPE_EVERY_S)

    thread = threading.Thread(target=scrape, name="smoke-scraper")
    try:
        thread.start()
        streams = _serve_turn(engine, prompts, sampled_at)["streams"]
        torch.cuda.synchronize()
    finally:
        stop.set()
        thread.join(timeout=60)
        endpoint.close()
    if thread.is_alive() or errors:
        fail("telemetry: scrape during capture: thread alive {}, errors "
             "{}".format(thread.is_alive(), errors[:3]))
    return streams, scrapes[0], sorted(engine._programs)


def _profile_check(engine, cfg):
    """Three steps of a full pool under profile_window with
    DS_TPU_PROFILE_DIR set: the exported trace must hold K3's kernel and
    the engine's ``inference/mixed_step`` scope."""
    base = tempfile.mkdtemp(prefix="ds_tpu_profile_")
    old = os.environ.get(PROFILE_DIR_ENV)
    os.environ[PROFILE_DIR_ENV] = base
    try:
        for i, p in enumerate(_prompts(SERVE["max_slots"], cfg.vocab_size,
                                       2)):
            engine.submit(p, max_new_tokens=48, seed=i)
        for _ in range(4):
            engine.step()
        with profile_window("serve") as path:
            for _ in range(3):
                engine.step()
        traces = [os.path.join(path, f) for f in os.listdir(path or base)
                  if f.endswith(".json")] if path else []
        if len(traces) != 1:
            fail("telemetry: profile_window wrote {} traces under {}".format(
                len(traces), path))
        with open(traces[0]) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        engine.run()
    finally:
        if old is None:
            del os.environ[PROFILE_DIR_ENV]
        else:
            os.environ[PROFILE_DIR_ENV] = old
        shutil.rmtree(base, ignore_errors=True)
    k3 = sorted(n for n in names if "decode_split_kernel" in n)
    if not k3 or "inference/mixed_step" not in names:
        fail("telemetry: the profile_window trace lacks K3 ({}) or the "
             "inference/mixed_step scope".format(k3[:2]))
    return {"event_names": len(names), "k3_kernels": [n[:100] for n in k3]}


def phase_telemetry(card, model):
    """Telemetry on the serving path (GPT-2 medium bf16, SERVE's dense
    pool, the 24-request stream of phase_serve; K3 and K5): two engines,
    telemetry on and off, each warmed by serving the stream once (every
    key met), then marked warm, then the stream in turns A B B A (A on).
    Checks: the four turns' streams equal; programs equal on and off;
    recompiles 0; the on-engine's spans, its trace file
    (validate_trace), its Prometheus text against metrics() over one
    window; a fresh engine scraped every 5 ms while it captures; a
    profile_window trace; and the host time inside telemetry calls,
    timed call by call on a fifth turn, under TELEMETRY_HOST_SHARE of the
    median step. Reports the TTFT of the warm-up (captures inside it) by
    capturing step and the rest."""
    cfg = model.config
    prompts = _prompts(N_REQUESTS, cfg.vocab_size, seed=0)
    engines = {True: init_inference(model, config=dict(SERVE)),
               False: init_inference(model, config=dict(SERVE,
                                                        telemetry=False))}
    warm_ttft, warm_streams = {}, {}
    for on, engine in engines.items():
        warm = _serve_turn(engine, prompts)
        warm_streams[on] = warm["streams"]
        warm_ttft[on] = dict(_ttft_split(warm),
                             capture_ms=engine.metrics()["capture_ms"])
        engine.recompile_detector.mark_warm()
        engine.metrics(reset=True)
    want = warm_streams[True]
    if warm_streams[False] != want:
        fail("telemetry: the warm-up streams differ on and off")
    turns = []
    prom_check = None
    for turn, on in zip("ABBA", (True, False, False, True)):
        engine = engines[on]
        last = len(turns) == 3
        text0 = engine.prometheus() if last else None
        torch.cuda.synchronize()
        da.reset_launches()
        served = _serve_turn(engine, prompts)
        step_ms, got = served["step_ms"], served["streams"]
        launches = dict(da.launches)
        m = engine.metrics(reset=True)
        if got != want:
            fail("telemetry: turn {} (telemetry {}) served other streams "
                 "than the warm-up".format(len(turns), on))
        expect = dict.fromkeys(launches, 0)
        expect["decode"] += cfg.n_layer * m["decode_steps"]
        expect["paged"] += cfg.n_layer * m["prefill_lanes"]
        if launches != expect:
            fail("telemetry: turn {} launches {} != {}".format(
                len(turns), launches, expect))
        if m["recompiles"] != 0:
            fail("telemetry: {} recompiles after mark_warm (telemetry "
                 "{}); keys {}".format(m["recompiles"], on,
                                       sorted(engine._programs)))
        if last:
            prom_check = _prometheus_window(engine, text0, m)
        turns.append({"turn": turn, "telemetry": on,
                      "median_step_ms": float(np.median(step_ms)),
                      "steps": len(step_ms),
                      "ttft_p50_ms": m["ttft_p50_ms"],
                      "ttft_p99_ms": m["ttft_p99_ms"],
                      "inter_token_p99_ms": m["inter_token_p99_ms"],
                      "queue_wait_p99_ms": m["queue_wait_p99_ms"],
                      "tokens_per_sec": served["tokens"] / sum(step_ms)
                      * 1e3})
    on, off = engines[True], engines[False]
    keys = [list(k) for k in sorted(on._programs)]
    if sorted(on._programs) != sorted(off._programs) or \
            on.compile_count != off.compile_count:
        fail("telemetry: programs on {} and off {}".format(
            sorted(on._programs), sorted(off._programs)))
    counts = on.tracer.span_counts()
    missing = [n for n in TELEMETRY_SPANS if not counts.get(n)]
    if missing or off.tracer.span_counts():
        fail("telemetry: spans {} missing on, {} recorded off".format(
            missing, off.tracer.span_counts()))
    trace_dir = tempfile.mkdtemp(prefix="ds_tpu_trace_")
    try:
        with open(on.write_trace(os.path.join(trace_dir, "t.json"))) as f:
            n_events = validate_trace(json.load(f))
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    # A fresh engine captures its keys under a 5 ms scrape; the warm
    # on-engine serves the same requests unscraped.
    sub, sampled_at = prompts[:SCRAPE_REQUESTS], lambda i: i == 2
    scraped, n_scrapes, scraped_keys = _scraped_serve(model, sub, sampled_at)
    unscraped = _serve_turn(on, sub, sampled_at)["streams"]
    if scraped != unscraped:
        fail("telemetry: the scraped engine's streams differ from the "
             "unscraped engine's")
    # The host time inside telemetry calls, call by call, on a fifth
    # turn of the on-engine; then the profiler window (a profiler session
    # can leave the process's launches slower: it goes last).
    clock = _HostClock()
    clock.instrument(on)
    step_ms = _serve_turn(on, prompts)["step_ms"]
    host_us = {k: v * 1e6 / len(step_ms) for k, v in clock.s.items()}
    profile = _profile_check(on, cfg)
    per_step_us = sum(host_us.values())
    median_on = float(np.median([t["median_step_ms"] for t in turns
                                 if t["telemetry"]]))
    median_off = float(np.median([t["median_step_ms"] for t in turns
                                  if not t["telemetry"]]))
    snap = on.telemetry_snapshot()
    # The timing wrappers refer back to the engine: free it now.
    del on, engines
    gc.collect()
    line = {"telemetry": "gpt2-medium bf16 dense", "requests": N_REQUESTS,
            "turns": turns, "median_step_ms_on": median_on,
            "median_step_ms_off": median_off,
            "on_minus_off_ms": median_on - median_off,
            "host_us_per_step": per_step_us,
            "host_us_per_step_by_kind": host_us,
            "host_share_of_median_step": per_step_us / 1e3 / median_on,
            "instrumented_turn_median_step_ms": float(np.median(step_ms)),
            "warmup_ttft_on": warm_ttft[True],
            "warmup_ttft_off": warm_ttft[False],
            "program_keys": keys, "compile_count": len(keys),
            "recompiles": 0,
            "span_counts": snap["span_counts"],
            "spans_dropped": snap["spans_dropped"],
            "trace_events": n_events, "prometheus": prom_check,
            "scrape": {"requests": len(sub), "scrapes": n_scrapes,
                       "program_keys": [list(k) for k in scraped_keys]},
            "profile_window": profile, "card": card}
    print("telemetry " + json.dumps(line))
    if per_step_us / 1e3 > TELEMETRY_HOST_SHARE * median_on:
        fail("telemetry: {:.1f} us per step in telemetry calls is over "
             "{:.0%} of the median step ({:.2f} ms)".format(
                 per_step_us, TELEMETRY_HOST_SHARE, median_on))
    return line


def _prometheus_window(engine, before, m):
    """Every counter of ``engine.prometheus()`` that metrics() reports
    must have moved by the window's metrics() value since ``before``."""
    kinds0, s0 = _parse_prom(before)
    kinds1, s1 = _parse_prom(engine.prometheus())
    checked = {}
    for name, kind in kinds1.items():
        if kind != "counter":
            continue
        key = name[len("ds_tpu_"):-len("_total")]
        if key not in m:
            continue
        lbl = (("engine", "inference"),)
        moved = s1[(name, lbl)] - s0.get((name, lbl), 0.0)
        if moved != m[key]:
            fail("telemetry: Prometheus {} moved {} over the window, "
                 "metrics() says {}".format(name, moved, m[key]))
        checked[key] = m[key]
    if "tokens_out" not in checked or "chunks" not in checked:
        fail("telemetry: Prometheus lacks the engine's counters: {}".format(
            sorted(kinds1)))
    return {"families": len(kinds1), "counters_checked": checked}


def phase_sustained(card, model):
    """The sustained-load harness on the card (SUSTAINED_SERVE,
    SUSTAINED_LOAD): GPT-2 medium bf16 over a dense int8 pool (K4, its
    prefill lane K6), warmed by two short requests that outlive their
    prefill step (compile_count 2: both greedy keys), then marked warm;
    the open-loop run, its report, the saturation sweep at SWEEP_RATES
    and the gate's A/A self-check. Fails on an accepted request left
    incomplete, a recompile, or a non-finite number."""
    cfg = model.config
    engine = init_inference(model, config=dict(SUSTAINED_SERVE))
    chunk = SUSTAINED_SERVE["chunk_size"]
    engine.generate([np.arange(1, 9), np.arange(9, 17)],
                    max_new_tokens=2 * chunk)
    if engine.compile_count != 2:
        fail("sustained: the warm-up met keys {}".format(
            sorted(engine._programs)))
    engine.recompile_detector.mark_warm()
    engine.metrics(reset=True)

    def run(spec):
        c0 = engine.counters["chunks"]
        lanes0 = engine._lane_steps.value
        da.reset_launches()
        t0 = time.perf_counter()
        res = SustainedRunner(engine, spec, window_seconds=SUSTAINED_WINDOW_S,
                              max_steps=500_000).run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(da.launches)
        decode_steps = (engine.counters["chunks"] - c0) * chunk
        lanes = engine._lane_steps.value - lanes0
        expect = dict.fromkeys(launches, 0)
        expect["q8"] += cfg.n_layer * decode_steps
        expect["paged_q8"] += cfg.n_layer * int(lanes)
        if launches != expect:
            fail("sustained: launches {} != {}".format(launches, expect))
        if res.requests_lost or res.completed != res.submitted:
            fail("sustained: {} accepted, {} completed, {} lost".format(
                res.submitted, res.completed, res.requests_lost))
        rep = build_report(spec, res, SUSTAINED_SLO, platform="gpu",
                           extra={"model": "gpt2-medium bf16",
                                  "serve_cfg": dict(SUSTAINED_SERVE),
                                  "card": card})
        waits = [r.admit_time - r.submit_time
                 for r in (engine.find_request(s["rid"])
                           for s in res.samples if not s["shed"])]
        return rep, {"launches": launches, "wall_s": wall,
                     "queue_wait_p99_ms": _pct(waits, 99) * 1e3}

    spec = WorkloadSpec(**SUSTAINED_LOAD)
    report, facts = run(spec)
    sweep = saturation_sweep(
        lambda rate: run(WorkloadSpec(**dict(
            SUSTAINED_LOAD, rate=rate, n_requests=SWEEP_REQUESTS,
            seed=int(rate) + 1000)))[0], SWEEP_RATES)
    gate = regression_gate(report, report)
    recompiles = engine.metrics()["recompiles"]
    agg = report["aggregate"]
    line = {"sustained": "gpt2-medium bf16, dense int8 pool",
            "serve_cfg": SUSTAINED_SERVE,
            "workload": {k: SUSTAINED_LOAD[k] for k in (
                "arrival", "rate", "n_requests", "prompt_mean",
                "output_mean", "prefix_pool", "seed")},
            "wall_s": agg["wall_s"], "submitted": agg["submitted"],
            "completed": agg["completed"], "shed": agg["shed"],
            "tokens_out": agg["tokens_out"],
            "tokens_per_sec": agg["tokens_per_sec"],
            "goodput_tokens_per_sec": agg["goodput_tokens_per_sec"],
            "slo": SUSTAINED_SLO.to_json(),
            "slo_attainment": agg["slo_attainment"],
            "ttft_p50_ms": agg["ttft_p50_ms"],
            "ttft_p99_ms": agg["ttft_p99_ms"],
            "itl_p50_ms": agg["itl_p50_ms"], "itl_p99_ms": agg["itl_p99_ms"],
            "queue_wait_p99_ms": facts["queue_wait_p99_ms"],
            "queue_depth_per_window": [
                w["queue_depth"] for w in report["timeseries"]["windows"]],
            "ttft_p99_ms_per_window": [
                w["ttft_p99_ms"] for w in report["timeseries"]["windows"]],
            "windows": len(report["timeseries"]["windows"]),
            "max_sustainable_rate": sweep["max_sustainable_rate"],
            "sweep": sweep["rates"], "gate_self_check": gate["pass"],
            "recompiles": recompiles, "launches": facts["launches"],
            "card": card}
    print("sustained " + json.dumps(line))
    if recompiles or not gate["pass"]:
        fail("sustained: {} recompiles; gate A/A pass {}".format(
            recompiles, gate["pass"]))
    numbers = [v for v in (agg["tokens_per_sec"],
                           agg["goodput_tokens_per_sec"], agg["ttft_p50_ms"],
                           agg["ttft_p99_ms"], agg["itl_p50_ms"],
                           agg["itl_p99_ms"], facts["queue_wait_p99_ms"])]
    if not all(v is not None and math.isfinite(v) for v in numbers):
        fail("sustained: a number is missing or not finite: {}".format(
            numbers))
    return line


def _breakdown_run(cfg, ids, extra):
    """BREAKDOWN_STEPS forward/backward/step of phase_train's setting from
    seed 0 with ``extra`` in the ds_config: the losses, the registry
    snapshot and the allocator's MA/Max_MA."""
    model = GPT2LMHeadModel(cfg, device="cuda", seed=0)
    engine, _, _, _ = initialize(model=model, config_params=dict(
        TRAIN_CONFIG, **extra))
    losses = []
    for _ in range(BREAKDOWN_STEPS):
        loss = engine(ids, ids)
        engine.backward(loss)
        engine.step()
        losses.append(float(loss.detach()))
    torch.cuda.synchronize()
    return losses, engine.telemetry.snapshot(), engine.timers.memory_usage()


def phase_train_breakdown(card):
    """phase_train's setting (K1, K2a) for BREAKDOWN_STEPS steps with
    wall_clock_breakdown and memory_breakdown on (steps_per_print 1),
    off, and off again, from seed 0 on one batch; then on and off with
    the split backward (K2b). K2a adds dq by float atomics, whose order
    varies from run to run, so its runs are held to their first loss
    (the forward on equal weights) and the repeat shows the run-to-run
    spread; K2b has no atomics, so with it the losses on and off must be
    equal bit for bit. Reports each phase's median ms (the
    ``timer_seconds`` histograms), the allocator's MA/Max_MA and whether
    TensorBoardScalarWriter finds tensorboard on this machine."""
    cfg = GPT2Config.gpt2_medium(dtype=torch.bfloat16, dropout=0.0)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(TRAIN_B, TRAIN_T))).to("cuda")
    runs = {label: _breakdown_run(cfg, ids, extra) for label, extra in (
        ("off", {}), ("on", BREAKDOWN), ("off_again", {}))}
    os.environ["DS_TPU_FLASH_BWD"] = "split"
    try:
        for label, extra in (("split_off", {}), ("split_on", BREAKDOWN)):
            runs[label] = _breakdown_run(cfg, ids, extra)
    finally:
        del os.environ["DS_TPU_FLASH_BWD"]
    snap = runs["on"][1]
    phases = {name: snap["timer_seconds{timer=" + name + "}"]["p50"] * 1e3
              for name in BREAKDOWN_TIMERS}
    tb_dir = tempfile.mkdtemp(prefix="ds_tpu_tb_")
    try:
        tb_available = TensorBoardScalarWriter(tb_dir).available
    finally:
        shutil.rmtree(tb_dir, ignore_errors=True)
    print("train_breakdown " + json.dumps({
        "train_breakdown": "gpt2-medium bf16 AdamW", "batch": TRAIN_B,
        "seq": TRAIN_T, "steps": BREAKDOWN_STEPS,
        "phase_p50_ms": phases, "memory": runs["on"][2],
        "losses": {label: run[0] for label, run in runs.items()},
        "fused_off_repeats_bit_for_bit":
            runs["off_again"][0] == runs["off"][0],
        "split_on_equals_off_bit_for_bit":
            runs["split_on"][0] == runs["split_off"][0],
        "samples_per_sec": snap["samples_per_sec"],
        "tensorboard_available": tb_available, "card": card}))
    if runs["split_on"][0] != runs["split_off"][0] or \
            runs["on"][0][0] != runs["off"][0][0]:
        fail("train_breakdown: losses with the breakdown on differ from "
             "off: split {} vs {}, fused first {} vs {}".format(
                 runs["split_on"][0], runs["split_off"][0], runs["on"][0][0],
                 runs["off"][0][0]))


def _gap(model, ids):
    """Top-1 minus top-2 fp32 logit for the token after ``ids``."""
    cache = generation.init_cache(generation.as_gencfg(model.config), 1,
                                  len(ids), device="cuda")
    logits, _ = generation.prefill_forward(
        model, torch.as_tensor(ids, device="cuda")[None], cache)
    top = torch.topk(logits[0, -1], 2).values
    return float(top[0] - top[1])


def _held_to(model, prompt, got, ref, what):
    """Phase 5's rule: ``got`` equals ``ref``, or first differs from it
    where ``ref``'s top-1/top-2 fp32 logit gap is below NEAR_TIE (printed;
    a clear argmax fails). True when equal."""
    if got == ref:
        return True
    j = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b),
             min(len(got), len(ref)))
    gap = _gap(model, np.concatenate([prompt, ref[:j]]))
    print("greedy: {}: divergence at token {}, top-1/top-2 gap {:.3e}".format(
        what, j, gap))
    if gap >= NEAR_TIE:
        fail("greedy {}: streams differ at a clear argmax (gap {:.3e})".format(
            what, gap))
    return False


def _spec_groups(engine, prompts, new):
    """Serve ``prompts`` greedily, step by step; each request's tokens and,
    per verify that emitted for it (one of a step's chunk_size), the tokens
    it accepted."""
    reqs = [engine.submit(p, max_new_tokens=new) for p in prompts]
    groups = {r.rid: [] for r in reqs}
    while not engine.idle:
        slots = {r.slot: r for r in reqs if r.slot is not None}
        engine.step()
        snap = engine._last_snap
        for slot, r in slots.items():
            for toks, valid in zip(snap["toks"][:, slot],
                                   snap["valid"][:, slot]):
                if valid.any():
                    groups[r.rid].append(toks[valid].tolist())
    return [r.tokens for r in reqs], [groups[r.rid] for r in reqs]


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
        exact += _held_to(model, p, got, ref, "engine vs generate()")
    print("greedy: {}/{} streams identical to generate()".format(
        exact, len(prompts)))
    # K5 and K6 do K3's and K4's arithmetic: the paged engines' streams are
    # the dense engines' exactly (no near-tie allowance).
    for int8 in (False, True):
        streams = []
        for extra in ({}, PAGED):
            eng = init_inference(model, config=dict(
                SERVE, max_slots=4, int8_kv=int8, **extra))
            streams.append(eng.generate(prompts, max_new_tokens=new))
            del eng
        if streams[0] != streams[1]:
            fail("the paged{} engine's greedy streams differ from the dense "
                 "one's".format(" int8" if int8 else ""))
        print("greedy: paged{} streams identical to dense{} ({} x {} "
              "tokens)".format(" int8" if int8 else "",
                               " int8" if int8 else "", len(prompts), new))
    _greedy_spec(model, new)


def _greedy_spec(model, new):
    """Phase 5 with speculation (SPEC) on tiled and on random prompts (the
    latter phase 5's own): the spec engine's greedy streams against
    generate() and against the spec-off engine under the gap rule (a
    verify computes a position's logits in a GEMM of slots x (spec_k + 1)
    rows, the plain step in one of slots rows). Then, against the first
    run's streams cut there, a request whose budget ends inside a verify
    that accepted more than two tokens; and a request whose EOS is an
    accepted draft with accepted tokens after it (``_eos_case``)."""
    cfg = model.config
    prompts = _tiled_prompts(4, cfg.vocab_size, seed=1) + \
        _prompts(4, cfg.vocab_size, seed=1)
    spec = init_inference(model, config=dict(SERVE, max_slots=4, **SPEC))
    streams, groups = _spec_groups(spec, prompts, new)
    m = spec.metrics()
    off = init_inference(model, config=dict(SERVE, max_slots=4)).generate(
        prompts, max_new_tokens=new)
    vs_gen = vs_off = 0
    for p, got, plain in zip(prompts, streams, off):
        ref = generation.generate(model, p[None], new,
                                  temperature=0.0)[0].tolist()
        vs_gen += _held_to(model, p, got, ref, "spec vs generate()")
        vs_off += _held_to(model, p, got, plain, "spec vs spec off")
    cut_case = None
    for r, gs in enumerate(groups):
        at = 1  # the first token comes from the prefill lane
        for g in gs:
            if cut_case is None and len(g) > 2:
                cut_case = (r, at, len(g))
            at += len(g)
    if cut_case is None:
        fail("greedy spec: no verify accepted more than two tokens")
    r_c, i_c, n_c = cut_case
    eng = init_inference(model, config=dict(SERVE, max_slots=4, **SPEC))
    b = eng.submit(prompts[r_c], max_new_tokens=i_c + 1)
    eng.run()
    _held_to(model, prompts[r_c], b.tokens, streams[r_c][:i_c + 1],
             "spec budget inside an accepted draft")
    if len(b.tokens) != i_c + 1:
        fail("greedy spec: the budget case did not stop there ({} tokens "
             "of {})".format(len(b.tokens), i_c + 1))
    print("greedy_spec " + json.dumps({
        "streams": len(prompts), "new_tokens": new,
        "identical_to_generate": vs_gen, "identical_to_spec_off": vs_off,
        "accepted_per_step_mean": m["accepted_per_step_mean"],
        "draft_accept_rate": m["draft_accept_rate"],
        "eos_case": _eos_case(model, eng),
        "budget_case": {"request": r_c, "token": i_c, "verify_accepted": n_c,
                        "tokens": len(b.tokens)}}))


def _accepts(seq, n, k):
    """Per frontier p of ``seq`` (a prompt and its greedy continuation, one
    list), the tokens a greedy verify there accepts: 1 plus the length of
    the draft prefix that ``seq`` goes on with. The draft is the n-gram
    rule of ``generation.ngram_draft`` on ``seq[:p + 1]``, here in plain
    Python: the k tokens after the most recent earlier end of the trailing
    n-gram, clipped to p; seq[p] k times without one. None where seq ends
    within k tokens of p."""
    last, acc = {}, [None] * len(seq)
    for p in range(n - 1, len(seq)):
        gram = tuple(seq[p - n + 1:p + 1])
        j = last.get(gram)
        last[gram] = p
        if p + k >= len(seq):
            continue
        draft = ([seq[min(j + 1 + a, p)] for a in range(k)]
                 if j is not None else [seq[p]] * k)
        a = 0
        while a < k and draft[a] == seq[p + 1 + a]:
            a += 1
        acc[p] = a + 1
    return acc


def _eos_candidates(prompt, stream, new, n, k):
    """Requests whose greedy stream holds an accepted draft token with
    accepted tokens after it that is the stream's first of its kind (an EOS
    there cuts the accepted prefix). The request ``prompt + stream[:cut]``
    continues greedily with ``stream[cut:]``, so its verifies follow from
    ``_accepts``: returns (lane in its verify, cut, index in the request's
    stream, tokens that verify accepted) for each such token of the
    request's ``new``."""
    seq = list(prompt) + list(stream)
    acc = _accepts(seq, n, k)
    out = []
    for cut in range(len(stream) - new - k):
        start = len(prompt) + cut  # the prefill lane's first token
        p, at = start, 1
        while at < new:
            a = min(acc[p], new - at)
            out += [(lane, cut, at + lane, a) for lane in range(a - 1)
                    if seq[p + 1 + lane] not in seq[start:p + 1 + lane]]
            p, at = p + a, at + a
    return out


def _eos_case(model, eng):
    """A request whose EOS is an accepted draft with accepted tokens after
    it, so the EOS cuts the accepted prefix. On random weights greedy
    streams mostly repeat a token, so a new token seldom sits inside an
    accepted run: the case is searched for. EOS_BASES random prompts are
    continued EOS_SPAN tokens by generate(); every cut of each continuation
    is a candidate request (the base prompt plus the continuation up to the
    cut), its verifies simulated by ``_eos_candidates``. The candidates are
    served, EOS_BATCH at a time (at most EOS_TRIES), on the spec engine
    ``eng`` until one's own verifies hold such a token (a draft lane before
    the last it accepted, its first occurrence in the stream); that token
    is the EOS of a second run, which must stop right after it and equal
    the first run's stream up to it. Fails if no candidate has one."""
    cfg = model.config
    k, n = SPEC["spec_k"], SPEC["spec_ngram"]
    rng = np.random.RandomState(11)
    bases = rng.randint(0, cfg.vocab_size, size=(EOS_BASES, PROMPT_LENS[0]))
    spans = generation.generate(model, bases, EOS_SPAN,
                                temperature=0.0).tolist()
    sims = sorted((-lane, r, cut) for r, (p, s) in enumerate(zip(bases, spans))
                  for lane, cut, _, _ in _eos_candidates(p, s, EOS_NEW, n, k))
    picks = list(dict.fromkeys((r, cut) for _, r, cut in sims))[:EOS_TRIES]
    found, served = None, 0
    for at in range(0, len(picks), EOS_BATCH):
        batch = picks[at:at + EOS_BATCH]
        prompts = [np.concatenate([bases[r], spans[r][:cut]])
                   for r, cut in batch]
        streams, groups = _spec_groups(eng, prompts, EOS_NEW)
        served += len(batch)
        for (r, cut), p, s, gs in zip(batch, prompts, streams, groups):
            _held_to(model, p, s, spans[r][cut:cut + EOS_NEW],
                     "spec EOS candidate vs generate()")
            i = 1  # the first token comes from the prefill lane
            for g in gs:
                for lane in range(len(g) - 1):
                    if s.index(s[i + lane]) == i + lane and (
                            found is None or lane > found[3]):
                        found = (p, s, i + lane, lane, len(g))
                i += len(g)
        if found is not None:
            break
    if found is None:
        fail("greedy spec: none of {} candidate requests ({} simulated) "
             "emitted a new token inside an accepted run".format(
                 served, len(sims)))
    p, s, i, lane, acc = found
    eos = s[i]
    req = eng.submit(p, max_new_tokens=EOS_NEW, eos_token_id=eos)
    eng.run()
    _held_to(model, p, req.tokens, s[:i + 1], "spec EOS in a verify")
    if len(req.tokens) != i + 1 or req.tokens[-1] != eos:
        fail("greedy spec: the EOS case did not stop at the EOS ({} tokens, "
             "EOS {} at {})".format(len(req.tokens), eos, i))
    return {"candidates_simulated": len(sims), "candidates_served": served,
            "token": i, "lane_in_verify": lane, "verify_accepted": acc,
            "cuts_the_accepted_prefix": True, "tokens": len(req.tokens)}


def _flash_inputs(B, T, dtype, masked, seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q, k, v, do = (torch.randn(B, 16, T, 64, device="cuda", generator=g)
                   .to(dtype) for _ in range(4))
    mask = None
    if masked == "padding":  # the BERT batches' (_bert_batch): every
        # other row padded after 128 .. T-1 keys
        lens = torch.randint(128, T, (B,), device="cuda", generator=g)
        drop = torch.arange(T, device="cuda")[None] >= lens[:, None]
        drop[1::2] = False
        mask = torch.where(drop, -1e9, 0.0)
    elif masked:  # about one key in ten dropped; key 0 kept, so no row is
        # fully masked (such a row's lse, ~ -1e9 at an fp32 ulp of 64, loses
        # its log-sum bits in both packages)
        drop = torch.rand(B, T, device="cuda", generator=g) < 0.1
        drop[:, 0] = False
        mask = torch.where(drop, -1e9, 0.0)
    return q, k, v, do, mask


def _flash_bound(q, mask, causal, backward):
    """(bound ms, 'bytes' or 'operations'): every input read once, every
    output written once; 4 * D flops per visible (query, key) pair forward
    (two products), 10 * D backward (five). An additive mask hides no pair
    from the kernels: they add it to every score."""
    B, H, T, D = q.shape
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    plane = B * H * T * D * q.element_size()
    rows = B * H * T * 4
    masks = 0 if mask is None else mask.numel() * mask.element_size()
    if backward:  # q, k, v, do, lse, delta, mask in; dq, dk, dv out
        flops, nbytes = 10 * D * pairs, 7 * plane + 2 * rows + masks
    else:  # q, k, v, mask in; o, lse out
        flops, nbytes = 4 * D * pairs, 4 * plane + rows + masks
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
        row.update(_flash_times(q, k, v, do, mask, lse, delta, causal))
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


def _flash_times(q, k, v, do, mask, lse, delta, causal):
    """CUDA-event medians at a main path's shape: the kernels (K2b's two
    also apart), their plain versions, torch's scaled_dot_product_attention
    (forward, and forward + backward minus forward, with the mask as an
    additive bias in q's dtype; a yardstick the port never calls), and the
    bounds."""
    t = {
        "K1_ms": cuda_ms(lambda: at.flash_fwd(q, k, v, mask, causal)),
        "K2a_ms": cuda_ms(lambda: at.flash_bwd(q, k, v, mask, lse, delta, do,
                                               causal, mode="fused")),
        "K2b_ms": cuda_ms(lambda: at.flash_bwd(q, k, v, mask, lse, delta, do,
                                               causal, mode="split")),
        "plain_fwd_ms": cuda_ms(
            lambda: at.mha_reference(q, k, v, mask, causal, return_lse=True)),
        "plain_bwd_ms": cuda_ms(lambda: at.flash_bwd_reference(
            q, k, v, mask, lse, delta, do, causal)),
    }
    bias = None if mask is None else mask.to(q.dtype)[:, None, None, :]
    t["library_fwd_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=bias, is_causal=causal))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]

    def fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, attn_mask=bias,
                                             is_causal=causal)
        torch.autograd.grad(out, leaves, do)

    t["library_bwd_ms"] = cuda_ms(fwd_bwd) - t["library_fwd_ms"]
    dkdv, dq, _ = at._bwd_kernels(q, k, v, mask, lse, delta, do, causal,
                                  1.0 / q.shape[-1] ** 0.5)
    t["K2b_dkdv_ms"], t["K2b_dq_ms"] = cuda_ms(dkdv), cuda_ms(dq)
    t["bound_fwd_ms"], t["bound_fwd_by"] = _flash_bound(q, mask, causal,
                                                        False)
    t["bound_bwd_ms"], t["bound_bwd_by"] = _flash_bound(q, mask, causal, True)
    return t


def phase_flash():
    """K1/K2a/K2b against their plain versions; returns the case rows, the
    first two being the timed shapes (bf16) of GPT-2 training and of
    BERT-large pretraining."""
    cases = [("train", 8, 1024, torch.bfloat16, True, False),
             ("bert", BERT_B, BERT_T, torch.bfloat16, False, "padding"),
             ("train", 8, 1024, torch.float16, True, False),
             ("train_fp32", 2, 1024, torch.float32, True, False),
             ("noncausal_mask", 2, 1024, torch.bfloat16, False, True),
             ("ragged", 2, 1000, torch.bfloat16, True, False),
             ("ragged_fp32_mask", 2, 1000, torch.float32, True, True),
             ("one_tile", 8, 64, torch.bfloat16, True, False)]
    return [_flash_case(*case, seed=i, timed=i < 2)
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


def _card_vs_cpu(label, what, card_model, cpu_model, config, inputs):
    """One fp32 forward/backward/step on the card against the same on the
    CPU, both engines seeded alike (the same dropout seeds): the loss
    within 1e-5 relative, every gradient within GRAD_TOL of its tensor's
    max-abs, every updated parameter within the limit set out at
    GRAD_TOL."""
    lr = config["optimizer"]["params"]["lr"]
    runs = []
    for model, device in ((card_model, "cuda"), (cpu_model, "cpu")):
        engine, _, _, _ = initialize(model=model, config_params=config,
                                     device=device)
        loss = engine(*inputs)
        engine.backward(loss)
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in model.named_parameters()}
        engine.step()
        params = {n: p.detach().cpu().clone()
                  for n, p in model.named_parameters()}
        runs.append((float(loss.detach()), grads, params))
    (loss_c, g_c, p_c), (loss_h, g_h, p_h) = runs
    loss_err = abs(loss_c - loss_h) / abs(loss_h)
    largest = max(float(g.abs().max()) for g in g_h.values())
    grad_ratio, param_ratio, worst = 0.0, 0.0, None
    for n in g_h:
        scale = float(g_h[n].abs().max())
        if scale < GRAD_TOL * largest:
            scale = largest
        ratio = float((g_c[n] - g_h[n]).abs().max()) / (GRAD_TOL * scale)
        if ratio >= grad_ratio:
            grad_ratio, worst = ratio, n
        noisy = g_h[n].abs() <= 10 * GRAD_TOL * scale
        limit = torch.where(noisy, 2.0 * lr, 1e-3 * lr) + \
            2.0 ** -22 * p_h[n].abs()
        param_ratio = max(param_ratio,
                          float(((p_c[n] - p_h[n]).abs() / limit).max()))
    line = {label: what, "loss_card": loss_c, "loss_cpu": loss_h,
            "loss_rel_err": loss_err, "grad_max_err_over_limit": grad_ratio,
            "worst_grad": worst, "param_max_err_over_limit": param_ratio}
    print(label + " " + json.dumps(line))
    if loss_err > 1e-5 or grad_ratio > 1.0 or param_ratio > 1.0:
        fail("the card's training step disagrees with the CPU's ({})".format(
            label))


def phase_train_consistency():
    """One fp32 GPT-2 train step on the card against the same on the CPU."""
    cfg = GPT2Config(n_embd=1024, n_layer=2, n_head=16, dtype=torch.float32,
                     dropout=0.0)
    config = {"train_batch_size": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}}}
    ids = np.random.RandomState(3).randint(0, cfg.vocab_size, size=(2, 256))
    cpu_model = GPT2LMHeadModel(cfg, device="cpu", seed=2)
    card_model = GPT2LMHeadModel(cfg, device="cuda", seed=None)
    card_model.load_state_dict(cpu_model.state_dict())
    _card_vs_cpu("train_consistency", "fp32 width 1024, 2 layers, B2 T256",
                 card_model, cpu_model, config, (ids, ids))


# ------------------------------------------- the fused layer's row kernels


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _row_bound(kernel, nbytes, n_elem):
    """(bound ms, 'bytes' or 'operations'): the bytes moved (each input
    read once, each output written once) over the HBM rate, or ROW_OPS per
    element over the fp32 rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ROW_OPS[kernel] * n_elem / PEAK_FLOPS[torch.float32] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _row_inputs(dtype, seed):
    """The row kernels' operands at the BERT-large path's shapes: hidden
    activations [B*T, 1024], FF1 outputs [B*T, 4096], the attention
    context [B, 16, T, 64]; the embeddings [B, T, 1024], fp32 in every
    pass (their LayerNorm's output, as the model drops it); fp32
    per-column parameters."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def randn(*shape, scale=1.0, shift=0.0, to=dtype):
        return (shift + scale * torch.randn(*shape, device="cuda",
                                            generator=g)).to(to)

    rows = BERT_B * BERT_T
    f32 = torch.float32
    return {"x": randn(rows, 1024, scale=3.0, shift=0.5),
            "res": randn(rows, 1024), "grad": randn(rows, 1024),
            "ff": randn(rows, 4096, scale=3.0),
            "ctx": randn(BERT_B, 16, BERT_T, 64),
            "ctx_grad": randn(BERT_B, 16, BERT_T, 64),
            "emb": randn(BERT_B, BERT_T, 1024, to=f32),
            "gamma": randn(1024, scale=0.1, shift=1.0, to=f32),
            "beta": randn(1024, scale=0.1, to=f32),
            "bias": randn(1024, to=f32), "ff_bias": randn(4096, to=f32)}


def _row_variants(t, seed):
    """(variant, kernel, launch, plain version, PyTorch yardstick or None,
    operands moved) for every variant the BERT path runs."""
    x, res, gamma, beta, bias = (t[k] for k in ("x", "res", "gamma", "beta",
                                                "bias"))
    ff, ff_bias, ctx, emb = t["ff"], t["ff_bias"], t["ctx"], t["emb"]
    dt = x.dtype
    h = x.shape[-1]
    rate = 0.1
    return [
        ("layer_norm_plain", "layer_norm",
         lambda: ln.ln_fwd(x, gamma, beta),
         lambda: ln.ln_fwd_reference(x, gamma, beta),
         lambda: F.layer_norm(x, (h,), gamma.to(dt), beta.to(dt), 1e-12),
         (x, gamma, beta)),
        ("layer_norm_bias_residual", "layer_norm",
         lambda: ln.ln_fwd(x, gamma, beta, bias, res),
         lambda: ln.ln_fwd_reference(x, gamma, beta, bias, res),
         lambda: F.layer_norm(x + bias.to(dt) + res, (h,), gamma.to(dt),
                              beta.to(dt), 1e-12),
         (x, res, gamma, beta, bias)),
        ("bias_gelu", "bias_gelu",
         lambda: ge.bias_gelu_fwd(ff, ff_bias),
         lambda: ge.bias_gelu_reference(ff, ff_bias),
         lambda: F.gelu(ff + ff_bias.to(dt), approximate="tanh"),
         (ff, ff_bias)),
        ("dropout_fwd_hidden", "dropout_fwd",
         lambda: dr.dropout_fwd(x, bias, res, rate, seed),
         lambda: dr.dropout_reference(x, rate, seed, bias, res),
         lambda: F.dropout(x + bias.to(dt), rate) + res,
         (x, bias, res)),
        ("dropout_fwd_context", "dropout_fwd",
         lambda: dr.dropout_fwd(ctx, None, None, rate, seed + 1),
         lambda: dr.dropout_reference(ctx, rate, seed + 1),
         lambda: F.dropout(ctx, rate), (ctx,)),
        ("dropout_fwd_embeddings", "dropout_fwd",
         lambda: dr.dropout_fwd(emb, None, None, rate, seed + 2),
         lambda: dr.dropout_reference(emb, rate, seed + 2),
         lambda: F.dropout(emb, rate), (emb,)),
        ("dropout_bwd_hidden", "dropout_bwd",
         lambda: dr.dropout_bwd(t["grad"], rate, seed),
         lambda: dr.dropout_bwd_reference(t["grad"], rate, seed),
         None, (t["grad"],)),
        ("dropout_bwd_context", "dropout_bwd",
         lambda: dr.dropout_bwd(t["ctx_grad"], rate, seed + 1),
         lambda: dr.dropout_bwd_reference(t["ctx_grad"], rate, seed + 1),
         None, (t["ctx_grad"],)),
        ("dropout_bwd_embeddings", "dropout_bwd",
         lambda: dr.dropout_bwd(emb, rate, seed + 2),
         lambda: dr.dropout_bwd_reference(emb, rate, seed + 2),
         None, (emb,)),
    ]


def _row_check(variant, kernel, out, ref, dtype):
    """(max abs error, max error / limit) of one variant; fails the run if
    a K8/K11 element is past its limit or a dropout output is not exact."""
    if not isinstance(out, tuple):
        out, ref = (out,), (ref,)
    for o, r in zip(out, ref):
        if o.shape != r.shape or o.dtype != r.dtype or \
                not bool(torch.isfinite(o).all()):
            fail("{} ({}) output of wrong shape or type, or not finite"
                 .format(variant, dtype))
    if kernel.startswith("dropout"):
        err = float((out[0].float() - ref[0].float()).abs().max())
        if err != 0.0:
            fail("{} ({}) differs from its plain version (max abs {}): the "
                 "masks or the rounding disagree".format(variant, dtype, err))
        return err, 0.0
    atol, rtol = ROW_TOL[dtype]
    errs = [_err(out[0], ref[0], atol + rtol * ref[0].float().abs())]
    if kernel == "layer_norm":  # mu and rstd, fp32
        errs += [_err(o, r, 1e-5 * r.abs() + 1e-6)
                 for o, r in zip(out[1:], ref[1:])]
    worst = max(errs, key=lambda e: e[1])
    if worst[1] > 1.0:
        fail("{} ({}) disagrees with its plain version: error/limit {:.3f}"
             .format(variant, dtype, worst[1]))
    return max(e[0] for e in errs), worst[1]


def phase_rows():
    """K8, K10a, K10b and K11 against their plain versions in bf16, fp16
    and fp32; CUDA-event medians (L2 flushed) of each bf16 variant, its
    plain version and its PyTorch yardstick, beside the bound. Returns
    {variant: row}."""
    rows = {}
    for i, dtype in enumerate((torch.bfloat16, torch.float16,
                               torch.float32)):
        t = _row_inputs(dtype, seed=10 + i)
        seed = 2 ** 40 + i
        for variant, kernel, run, plain, lib, moved in _row_variants(t, seed):
            out, ref = run(), plain()
            torch.cuda.synchronize()
            err, ratio = _row_check(variant, kernel, out, ref, dtype)
            row = rows.setdefault(variant, {"kernel": kernel,
                                            "max_abs_err": 0.0,
                                            "max_err_over_limit": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["max_err_over_limit"] = max(row["max_err_over_limit"], ratio)
            if dtype != torch.bfloat16:
                continue
            outs = out if isinstance(out, tuple) else (out,)
            row["shape"] = "x {} {}".format(
                list(moved[0].shape), str(moved[0].dtype).split(".")[-1])
            row["ms"] = cuda_ms(run, cold=True)
            row["plain_ms"] = cuda_ms(plain, cold=True)
            row["library_ms"] = cuda_ms(lib, cold=True) if lib is not None \
                else None
            row["bound_ms"], row["bound_by"] = _row_bound(
                kernel, _nbytes(*moved, *outs), moved[0].numel())
        del t
    for variant, row in rows.items():
        print("rows {} {}".format(variant, json.dumps(row)))
    return rows


def _softmax_inputs(shape, dtype, masked, seed):
    """Scores of spread 3 and, with ``masked``, the BERT batches' padding
    mask (every other batch row padded after 128 .. T_k - 1 keys; shorter
    rows after 1 .. T_k - 1)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    B, _, _, t_k = shape
    s = (3.0 * torch.randn(*shape, device="cuda", generator=g)).to(dtype)
    mask = None
    if masked:
        lens = torch.randint(min(128, t_k - 1), t_k, (B,), device="cuda",
                             generator=g)
        drop = torch.arange(t_k, device="cuda")[None] >= lens[:, None]
        drop[1::2] = False
        mask = torch.where(drop, -1e9, 0.0)
    return s, mask


def phase_softmax():
    """K9: the op through its entry point with its count reset just before
    and read just after (the path's launches), then against its plain
    version in every case, timed at the first two, and its gradient on the
    card against the CPU. Returns (case rows, launches)."""
    path = [_softmax_inputs(shape, dtype, masked, seed=40 + i) + (causal,)
            for i, (_, shape, dtype, causal, masked, timed)
            in enumerate(SOFTMAX_CASES) if timed]
    torch.cuda.synchronize()
    sm.reset_launches()
    for s, mask, causal in path:
        leaf = s.clone().requires_grad_()
        p = sm.attn_softmax(leaf, mask, SOFTMAX_SCALE, causal)
        p.backward(torch.ones_like(p))
        if not bool(torch.isfinite(leaf.grad).all()):
            fail("attn_softmax's gradient is not finite on the card")
    torch.cuda.synchronize()
    launches = sm.launches
    if launches != len(path):
        fail("attn_softmax launched K9 {} times for {} calls".format(
            launches, len(path)))
    del path, leaf, p
    rows = []
    for i, (name, shape, dtype, causal, masked, timed) in \
            enumerate(SOFTMAX_CASES):
        s, mask = _softmax_inputs(shape, dtype, masked, seed=40 + i)

        def run():
            return sm.softmax_fwd(s, mask, SOFTMAX_SCALE, causal)

        def plain():
            return sm.attn_softmax_reference(s, mask, SOFTMAX_SCALE, causal)

        out, ref = run(), plain()
        torch.cuda.synchronize()
        if out.shape != ref.shape or out.dtype != ref.dtype or \
                not bool(torch.isfinite(out).all()):
            fail("K9 output of wrong shape or type, or not finite at "
                 "{}".format(name))
        atol, rtol = ROW_TOL[dtype]
        err, ratio = _err(out, ref, atol + rtol * ref.float().abs())
        row = {"case": name, "shape": list(shape),
               "dtype": str(dtype).split(".")[-1], "causal": causal,
               "mask": "padding" if masked else None, "max_abs_err": err,
               "max_err_over_limit": ratio}
        if ratio > 1.0:
            print("softmax " + json.dumps(row))
            fail("K9 disagrees with its plain version at {}".format(name))
        del out, ref
        if timed:
            row["ms"] = cuda_ms(run, cold=True)
            row["plain_ms"] = cuda_ms(plain, cold=True)
            row["library_ms"] = cuda_ms(lambda: torch.softmax(s, dim=-1),
                                        cold=True)
            row["bound_ms"], row["bound_by"] = _row_bound(
                "attn_softmax", 2 * _nbytes(s) + _nbytes(mask), s.numel())
        print("softmax " + json.dumps(row))
        rows.append(row)
        del s, mask
    g = torch.Generator(device="cuda")
    g.manual_seed(49)
    s = torch.randn(*SOFTMAX_AUTOGRAD, device="cuda", generator=g)
    grad = torch.randn(*SOFTMAX_AUTOGRAD, device="cuda", generator=g)
    mask = torch.where(torch.rand(SOFTMAX_AUTOGRAD[0], SOFTMAX_AUTOGRAD[3],
                                  device="cuda", generator=g) < 0.2, -1e9, 0.0)
    got = []
    for dev in ("cuda", "cpu"):
        leaf = s.to(dev).clone().requires_grad_()
        p = sm.attn_softmax(leaf, mask.to(dev), SOFTMAX_SCALE, True)
        p.backward(grad.to(dev))
        got.append((p.detach().cpu(), leaf.grad.cpu()))
    ratio = max(_err(a, b, FLASH_AUTOGRAD_TOL * b.abs().max())[1]
                for a, b in zip(*got))
    print("softmax " + json.dumps({"case": "autograd card vs cpu",
                                   "shape": list(SOFTMAX_AUTOGRAD),
                                   "dtype": "float32", "causal": True,
                                   "max_err_over_limit": ratio}))
    if ratio > 1.0:
        fail("attn_softmax on the card disagrees with the CPU through "
             "autograd")
    return rows, launches


def _softmax_kernel_row(rows, launches):
    """K9's kernels-line entry: times at BERT-large's score shape (GPT-2's
    under "gpt2"), errors over every case, the phase's own launches."""
    timed_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    bert, gpt2 = rows[0], rows[1]
    entry = {"name": "attn_softmax", "route": "cuda",
             "source": "deepspeed_tpu_torch/csrc/transformer_kernels.cu",
             "replaces": "deepspeed_tpu/ops/transformer/kernels/"
                         "softmax.py:24",
             "launches": launches,
             "launches_note": "the op's own entry point: no model path "
                              "calls it, as in the JAX package",
             "max_abs_err": max(r["max_abs_err"] for r in rows),
             "max_err_over_limit": max(r["max_err_over_limit"]
                                       for r in rows),
             "shape": "[16, 16, 512, 512] bf16, padding mask"}
    entry.update({k: bert[k] for k in timed_keys})
    entry["gpt2"] = dict({k: gpt2[k] for k in timed_keys},
                         shape="[8, 16, 1024, 1024] bf16 causal")
    return entry


# ------------------------------------------------------------------- BERT


def _bert_batch(cfg, B, T, seed, min_len):
    """(ids, 1/0 mask, token types, MLM labels, NSP labels) on the card, as
    bench.py:_measure_bert draws them, with every other row padded after
    min_len..T-1 tokens: labels are the ids at 15% of the real positions
    and -1 elsewhere, token types 0 on the first half and 1 on the
    second."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, size=(B, T))
    mask = np.ones((B, T), np.int64)
    for row in range(0, B, 2):
        mask[row, rng.randint(min_len, T):] = 0
    types = np.zeros((B, T), np.int64)
    types[:, T // 2:] = 1
    labels = np.where((rng.rand(B, T) < 0.15) & (mask == 1), ids, -1)
    nsp = rng.randint(0, 2, size=(B,))
    return tuple(torch.from_numpy(a).to("cuda")
                 for a in (ids, mask, types, labels, nsp))


def _launch_counts():
    return dict(at.launches, **sk.launches,
                layer_norm_plain=ln.launches["plain"],
                layer_norm_bias_residual=ln.launches["bias_residual"],
                dropout_fwd=dr.launches["dropout_fwd"],
                dropout_bwd=dr.launches["dropout_bwd"], bias_gelu=ge.launches)


def _bert_launches(n_layer, n_drop, n_det):
    """The launch counts of n_drop steps at dropout > 0 and n_det at
    dropout 0: n_layer x steps x sites per layer, plus the per-step
    sites."""
    return {k: n_layer * (a * n_drop + b * n_det) +
            BERT_STEP_SITES.get(k, 0) * n_drop
            for k, (a, b) in BERT_SITES.items()}


def _bert_step_flops(cfg, B, T, density=1.0):
    """Model flops of one training step (forward + backward = 3 x
    forward): 2 per weight per token for the encoder, the MLM transform
    and the tied decoder, and 4 T h per token per layer for the scores and
    the context products, times the share of block pairs a sparse layout
    lists (bench.py's density scaling)."""
    h, inter, L = cfg.hidden_size, cfg.intermediate_size, \
        cfg.num_hidden_layers
    weights = L * (4 * h * h + 2 * h * inter) + h * h + cfg.vocab_size * h
    return 3 * B * T * (2 * weights + 4 * L * T * h * density)


def phase_bert(card):
    """BERT-large pretraining through initialize and forward / backward /
    step; returns the kernels' launch counts over the counted steps."""
    cfg = BertConfig.bert_large(dtype=torch.bfloat16)
    model = BertForPreTraining(cfg, device="cuda", seed=0)
    engine, _, _, _ = initialize(model=model, config_params=BERT_CONFIG)
    batch = _bert_batch(cfg, BERT_B, BERT_T, seed=0, min_len=128)

    def step(**kwargs):
        loss = engine(*batch, **kwargs)
        engine.backward(loss)
        engine.step()
        return loss.detach()

    losses = [step() for _ in range(BERT_WARM)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in (at, ln, dr, ge, sk):
        mod.reset_launches()
    # Events between the timed steps: each step's span on the card's
    # timeline (the spread the mean hides).
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(BERT_TIMED + 1)]
    t0 = time.perf_counter()
    marks[0].record()
    for mark in marks[1:]:
        losses.append(step())
        mark.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    t1 = time.perf_counter()
    losses += [step(deterministic=True) for _ in range(BERT_DET)]
    torch.cuda.synchronize()
    det_wall = time.perf_counter() - t1
    losses.append(engine.train_batch(batch=batch))
    torch.cuda.synchronize()
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        fail("non-finite BERT loss: {}".format(losses))
    if not losses[BERT_WARM + BERT_TIMED - 1] < losses[0]:
        fail("the BERT loss did not fall over the timed steps: {}".format(
            losses))
    want = _bert_launches(cfg.num_hidden_layers, BERT_TIMED + 1, BERT_DET)
    if launches != want:
        fail("BERT kernel launches {} != n_layer x steps x sites + the "
             "embeddings' {}".format(launches, want))
    tokens = BERT_B * BERT_T
    step_s = wall / BERT_TIMED
    print("bert_train " + json.dumps({
        "train": "bert-large bf16 AdamW, dropout 0.1", "batch": BERT_B,
        "seq": BERT_T, "timed_steps": BERT_TIMED,
        "tokens_per_s": tokens / step_s,
        "real_tokens_per_s": float(batch[1].sum()) / step_s,
        "mean_step_ms": step_s * 1e3, "step_ms": step_ms,
        "dropout0_step_ms": det_wall / BERT_DET * 1e3,
        "model_tflops_per_s": _bert_step_flops(cfg, BERT_B, BERT_T) /
        step_s / 1e12,
        "peak_mem_bytes": peak, "first_loss": losses[0],
        "last_loss": losses[-1], "losses": losses, "launches": launches,
        "card": card}))
    print("bert_profile " + json.dumps(_profile(step, 2)))
    return launches


def phase_bert_consistency():
    """One fp32 BERT step at dropout 0.1 on the card against the same on
    the CPU: the masks are one function of the seeds on both."""
    cfg = BertConfig.bert_large(num_hidden_layers=2, dtype=torch.float32)
    config = {"train_batch_size": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}}}
    batch = _bert_batch(cfg, 2, 128, seed=3, min_len=32)
    cpu_model = BertForPreTraining(cfg, device="cpu", seed=2)
    card_model = BertForPreTraining(cfg, device="cuda", seed=None)
    card_model.load_state_dict(cpu_model.state_dict())
    for mod in (ln, dr, ge):
        mod.reset_launches()
    _card_vs_cpu("bert_consistency",
                 "fp32 width 1024, 2 layers, B2 T128, dropout 0.1",
                 card_model, cpu_model, config, batch)
    counts, want = _launch_counts(), _bert_launches(2, 1, 0)
    if not all(counts[k] == n for k, n in want.items()
               if not k.startswith("flash")):
        fail("the card's BERT step did not run the row kernels: {} (want "
             "{})".format(counts, want))


# ------------------------------------------------------ block-sparse BERT


def _sparse_layout(kind, block, T, seed):
    """A [16, nb, nb] layout: the Fixed pattern (bidirectional or
    unidirectional), BigBird with two global blocks (their equal rows pair
    in K7a's block-64 schedule, the sliding-window rows stay single), or a
    random one with query block 1 (a row) and key block 2 (a column) empty,
    so that both LUTs hold -1 entries."""
    if kind in ("fixed", "fixed_uni"):
        attention = "bidirectional" if kind == "fixed" else "unidirectional"
        return FixedSparsityConfig(num_heads=16, block=block,
                                   attention=attention).make_layout(T)
    if kind == "bigbird":
        return BigBirdSparsityConfig(num_heads=16, block=block,
                                     num_global_blocks=2,
                                     num_random_blocks=1,
                                     seed=seed).make_layout(T)
    nb = T // block
    layout = (np.random.RandomState(seed).rand(16, nb, nb) < 0.3).astype(
        np.int64)
    layout[:, 1] = 0
    layout[:, :, 2] = 0
    return layout


def _sparse_inputs(B, T, dtype, kpm, bias, seed):
    """q, k, v, dO [B, 16, T, 64] and the masks' keywords on the card. kpm
    'padding': additive, every other row padded after 128 .. T-1 keys (as
    the BERT batches); 'mul': 0/1, about one key in ten dropped. bias 'add':
    N(0, 0.1); 'mul': 1 + U(0, 1) (the scores stay live)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q, k, v, do = (torch.randn(B, 16, T, 64, device="cuda", generator=g)
                   .to(dtype) for _ in range(4))
    kw = {}
    if kpm == "padding":
        lens = torch.randint(128, T, (B,), device="cuda", generator=g)
        drop = torch.arange(T, device="cuda")[None] >= lens[:, None]
        drop[1::2] = False
        kw.update(kpm=torch.where(drop, -1e9, 0.0))
    elif kpm == "mul":
        kw.update(kpm=(torch.rand(B, T, device="cuda", generator=g) > 0.1)
                  .float(), kpm_mode="mul")
    if bias == "add":
        kw.update(bias=0.1 * torch.randn(B, 16, T, T, device="cuda",
                                         generator=g))
    elif bias == "mul":
        kw.update(bias=1.0 + torch.rand(B, 16, T, T, device="cuda",
                                        generator=g), bias_mode="mul")
    return q, k, v, do, kw


def _sparse_bound(q, lowered, kw, backward):
    """(bound ms, 'bytes' or 'operations'): every input read once, every
    output written once (q, k, v, o or dO, dq, dk, dv, lse and delta, the
    masks and one LUT); 4 * D flops per visible (query, key) pair forward,
    10 * D backward, counting the pairs this layout lists (a causal cut
    halves the diagonal blocks and drops those above it)."""
    B, H, T, D = q.shape
    blk = lowered.block
    active = np.argwhere(lowered.layout != 0)  # (h, query block, key block)
    if kw.get("causal"):
        rel = active[:, 1] - active[:, 2]
        pairs = int((rel > 0).sum()) * blk * blk + \
            int((rel == 0).sum()) * blk * (blk + 1) // 2
    else:
        pairs = len(active) * blk * blk
    pairs *= B
    plane = B * H * T * D * q.element_size()
    rows = B * H * T * 4
    masks = _nbytes(kw.get("kpm"), kw.get("bias"))
    if backward:
        flops = 10 * D * pairs
        nbytes = 7 * plane + 2 * rows + masks + lowered.bwd_lut.nbytes
    else:
        flops = 4 * D * pairs
        nbytes = 4 * plane + rows + masks + lowered.fwd_lut.nbytes
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sparse_times(q, k, v, do, lowered, lse, delta, kw):
    """CUDA-event medians at the path's shape: the kernels, their plain
    versions, torch's scaled_dot_product_attention with the layout
    expanded to a dense additive mask plus the key-padding mask (forward,
    and forward + backward minus forward; a yardstick the port never
    calls), and the bounds."""
    t = {
        "K7a_ms": cuda_ms(lambda: sk.sparse_fwd(q, k, v, lowered, **kw)),
        "K7b_fused_ms": cuda_ms(lambda: sk.sparse_bwd(
            q, k, v, lowered, lse, delta, do, mode="fused", **kw)),
        "K7b_split_ms": cuda_ms(lambda: sk.sparse_bwd(
            q, k, v, lowered, lse, delta, do, mode="split", **kw)),
        "plain_fwd_ms": cuda_ms(lambda: sk.sparse_fwd_reference(
            q, k, v, lowered, **kw), reps=10),
        "plain_bwd_ms": cuda_ms(lambda: sk.sparse_bwd_reference(
            q, k, v, lowered, lse, delta, do, **kw), reps=10),
    }
    mask = torch.where(lowered.element_mask(q.shape[2], q.device)[None],
                       0.0, float("-inf"))
    if "kpm" in kw:
        mask = mask + kw["kpm"][:, None, None, :]
    mask = mask.to(q.dtype)
    t["library_fwd_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), reps=10)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]

    def fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        torch.autograd.grad(out, leaves, do)

    t["library_bwd_ms"] = cuda_ms(fwd_bwd, reps=10) - t["library_fwd_ms"]
    del mask, leaves
    t["bound_fwd_ms"], t["bound_fwd_by"] = _sparse_bound(q, lowered, kw,
                                                         False)
    t["bound_bwd_ms"], t["bound_bwd_by"] = _sparse_bound(q, lowered, kw, True)
    return t


def _sparse_case(name, B, T, dtype, kind, block, causal, kpm, bias, seed,
                 timed=False):
    """K7a, K7b fused and K7b split on one input against their plain
    versions; returns the case's row (errors, and with ``timed`` the
    times)."""
    q, k, v, do, kw = _sparse_inputs(B, T, dtype, kpm, bias, seed)
    kw["causal"] = causal
    lowered = sk.lower(_sparse_layout(kind, block, T, seed), block)
    o, lse = sk.sparse_fwd(q, k, v, lowered, **kw)
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    fused = sk.sparse_bwd(q, k, v, lowered, lse, delta, do, mode="fused",
                          **kw)
    split = sk.sparse_bwd(q, k, v, lowered, lse, delta, do, mode="split",
                          **kw)
    ro, rlse = sk.sparse_fwd_reference(q, k, v, lowered, **kw)
    refs = sk.sparse_bwd_reference(q, k, v, lowered, lse, delta, do, **kw)
    mags = sk.accumulated_magnitudes(q, k, v, lowered, lse, delta, do, **kw)
    torch.cuda.synchronize()
    rtol = FLASH_RTOL[dtype]
    row = {"case": name, "dtype": str(dtype).split(".")[-1], "B": B,
           "H": 16, "T": T, "layout": kind, "block": block,
           "density": lowered.density, "causal": causal, "kpm": kpm,
           "bias": bias}
    if block == 64 and dtype == torch.bfloat16:
        # K7a's wgmma kernel: one CTA per item, a pair of query blocks with
        # equal LUT rows or a single block.
        pairs = int((lowered.fwd_schedule[:, 2] >= 0).sum())
        row["fwd_items"] = {"pairs": pairs,
                            "singles": len(lowered.fwd_schedule) - pairs}
    outs = {"K7a": [(o, ro, rtol * ro.float().abs() + SPARSE_ACC * mags[0]),
                    (lse, rlse, 1e-5 * (1 + rlse.abs()))]}
    for kernel, grads in (("K7b_fused", fused), ("K7b_split", split)):
        outs[kernel] = [(g, r, rtol * r.float().abs() + SPARSE_ACC * m)
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
            print("sparse " + json.dumps(row))
            fail("{} disagrees with its plain version at {}".format(kernel,
                                                                    name))
    del ro, rlse, refs, mags, fused, split
    if timed:
        row.update(_sparse_times(q, k, v, do, lowered, lse, delta, kw))
    print("sparse " + json.dumps(row))
    torch.cuda.empty_cache()
    return row


def phase_sparse():
    """K7a/K7b against their plain versions; returns the case rows, the
    first being the timed shape of the sparse BERT path."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("path", SPARSE_B, SPARSE_T, bf16, "fixed", SPARSE_BLOCK, False,
         "padding", None),
        ("fixed_uni_causal", 1, 2048, bf16, "fixed_uni", 64, True, None,
         None),
        ("bigbird_pairs_and_singles", 2, 2048, bf16, "bigbird", 64, False,
         "padding", None),
        ("fp32", 1, 1024, f32, "fixed", 64, False, "padding", "add"),
        ("block16_random", 2, 1024, bf16, "random", 16, False, "padding",
         None),
        ("block32_random_causal", 2, 1024, bf16, "random", 32, True, None,
         None),
        ("mul_masks", 1, 1024, bf16, "fixed", 32, False, "mul", "mul"),
        ("fp16_block16_bias", 1, 512, torch.float16, "random", 16, False,
         "padding", "add"),
    ]
    rows = [_sparse_case(*case, seed=20 + i, timed=i == 0)
            for i, case in enumerate(cases)]
    items = {r["case"]: r["fwd_items"] for r in rows if "fwd_items" in r}
    if not (items["path"]["singles"] == 0
            and items["fixed_uni_causal"]["pairs"] == 0
            and min(items["bigbird_pairs_and_singles"].values()) > 0):
        fail("K7a's block-64 cases do not hold all pairs, all single "
             "blocks, and both in one launch: {}".format(items))
    return rows


def phase_split_default():
    """K2b and K7b split at a shape where ``_bwd_mode`` picks the split
    backward by default (B=1, H=16, T=8192, D=64, bf16: the fused resident
    set, T x 64 x 16 bytes, is over 6 MiB): flash causal, and sparse on the
    Fixed layout at block 64 with the padding mask. Each backward runs once
    through its wrapper in the default mode and is held against its plain
    version (LONG_ACC); then the kernel, SDPA's backward (the yardstick) and
    the bound are timed. Returns {"K2b": row, "K7b_split": row}."""
    B, T = 1, SPLIT_DEFAULT_T
    if at._bwd_mode(T, 64, torch.bfloat16) != "split":
        fail("_bwd_mode does not pick the split backward at T={}".format(T))
    rows = {}
    q, k, v, do, _ = _flash_inputs(B, T, torch.bfloat16, False, 30)
    o, lse = at.flash_fwd(q, k, v, None, True)
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    before = at.launches["flash_bwd_split"]
    grads = at.flash_bwd(q, k, v, None, lse, delta, do, True)
    if at.launches["flash_bwd_split"] != before + 2:
        fail("the default flash backward at T={} did not run K2b".format(T))
    refs = at.flash_bwd_reference(q, k, v, None, lse, delta, do, True)
    mags = at.accumulated_magnitudes(q, k, v, None, lse, delta, do,
                                     True)[1:]
    rows["K2b"] = _long_check("K2b", grads, refs, mags)
    del refs, mags, grads
    torch.cuda.empty_cache()
    rows["K2b"].update(_split_default_times(
        lambda: at.flash_bwd(q, k, v, None, lse, delta, do, True),
        q, k, v, do, None, True, _flash_bound(q, None, True, True)))
    del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()

    q, k, v, do, kw = _sparse_inputs(B, T, torch.bfloat16, "padding", None,
                                     31)
    lowered = sk.lower(_sparse_layout("fixed", SPARSE_BLOCK, T, 31),
                       SPARSE_BLOCK)
    o, lse = sk.sparse_fwd(q, k, v, lowered, **kw)
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    before = sk.launches["sparse_bwd_split"]
    grads = sk.sparse_bwd(q, k, v, lowered, lse, delta, do, **kw)
    if sk.launches["sparse_bwd_split"] != before + 2:
        fail("the default sparse backward at T={} did not run K7b "
             "split".format(T))
    refs = sk.sparse_bwd_reference(q, k, v, lowered, lse, delta, do, **kw)
    mags = sk.accumulated_magnitudes(q, k, v, lowered, lse, delta, do,
                                     **kw)[1:]
    rows["K7b_split"] = _long_check("K7b_split", grads, refs, mags)
    del refs, mags, grads
    torch.cuda.empty_cache()
    mask = torch.where(lowered.element_mask(T, q.device)[None], 0.0,
                       float("-inf"))
    mask = (mask + kw["kpm"][:, None, None, :]).to(q.dtype)
    rows["K7b_split"].update(_split_default_times(
        lambda: sk.sparse_bwd(q, k, v, lowered, lse, delta, do, **kw),
        q, k, v, do, mask, False, _sparse_bound(q, lowered, kw, True)))
    rows["K7b_split"]["density"] = lowered.density
    del mask
    torch.cuda.empty_cache()
    for name, row in rows.items():
        print("split_default " + json.dumps(dict(row, kernel=name)))
    return rows


def _long_check(kernel, grads, refs, mags):
    """(dq, dk, dv) against the plain version at LONG_ACC, each output held
    to its own accumulated magnitudes (``mags``: dq's, dk's, dv's); fails
    above 1."""
    torch.cuda.synchronize()
    errs = []
    for g, r, m in zip(grads, refs, mags):
        if not (bool(torch.isfinite(g).all()) and g.shape == r.shape):
            fail("{} output not finite or wrong shape at T={}".format(
                kernel, SPLIT_DEFAULT_T))
        errs.append(_err(g, r, FLASH_RTOL[g.dtype] * r.float().abs() +
                         LONG_ACC * m))
    row = {"shape": "B1 H16 T{} D64 bf16".format(SPLIT_DEFAULT_T),
           "max_abs_err": max(e[0] for e in errs),
           "max_err_over_limit": max(e[1] for e in errs),
           "err_over_limit": dict(zip(("dq", "dk", "dv"),
                                      (e[1] for e in errs)))}
    if row["max_err_over_limit"] > 1.0:
        print("split_default " + json.dumps(dict(row, kernel=kernel)))
        fail("{} disagrees with its plain version at T={}".format(
            kernel, SPLIT_DEFAULT_T))
    return row


def _split_default_times(kernel, q, k, v, do, mask, causal, bound):
    """The kernel's and SDPA's backward (forward + backward - forward, the
    mask as an additive bias) in ms, and the bound."""
    t = {"ms": cuda_ms(kernel, reps=10)}
    fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal), reps=10)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]

    def fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                             is_causal=causal)
        torch.autograd.grad(out, leaves, do)

    t["library_ms"] = cuda_ms(fwd_bwd, reps=10) - fwd
    t["bound_ms"], t["bound_by"] = bound
    return t


def _sparse_bert_config(**kw):
    return BertConfig.bert_large(
        use_fused_layer=False, sparse_attention_config=FixedSparsityConfig(
            num_heads=16, block=SPARSE_BLOCK, attention="bidirectional"),
        **kw)


def phase_bert_sparse(card):
    """Sparse BERT-large pretraining at T=4096 through initialize and
    forward / backward / step; returns the kernels' launch counts over the
    counted steps."""
    cfg = _sparse_bert_config(max_position_embeddings=SPARSE_T,
                              dtype=torch.bfloat16)
    model = BertForPreTraining(cfg, device="cuda", seed=0)
    engine, _, _, _ = initialize(model=model,
                                 config_params=SPARSE_BERT_CONFIG)
    batch = _bert_batch(cfg, SPARSE_B, SPARSE_T, seed=0,
                        min_len=SPARSE_T // 4)

    def step():
        loss = engine(*batch)
        engine.backward(loss)
        engine.step()
        return loss.detach()

    losses = [step() for _ in range(SPARSE_WARM)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in (at, ln, dr, ge, sk):
        mod.reset_launches()
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(SPARSE_TIMED + 1)]
    t0 = time.perf_counter()
    marks[0].record()
    for mark in marks[1:]:
        losses.append(step())
        mark.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    os.environ["DS_TPU_FLASH_BWD"] = "split"
    try:
        t1 = time.perf_counter()
        losses += [step() for _ in range(SPARSE_SPLIT)]
        torch.cuda.synchronize()
        split_wall = time.perf_counter() - t1
    finally:
        del os.environ["DS_TPU_FLASH_BWD"]
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        fail("non-finite sparse BERT loss: {}".format(losses))
    if not losses[SPARSE_WARM + SPARSE_TIMED - 1] < losses[0]:
        fail("the sparse BERT loss did not fall over the timed steps: "
             "{}".format(losses))
    L, steps = cfg.num_hidden_layers, SPARSE_TIMED + SPARSE_SPLIT
    want = {k: 0 for k in launches}
    want.update(sparse_fwd=L * steps, sparse_bwd_fused=L * SPARSE_TIMED,
                sparse_bwd_split=2 * L * SPARSE_SPLIT,
                dropout_fwd=(3 * L + 1) * steps,
                dropout_bwd=(3 * L + 1) * steps)
    if launches != want:
        fail("sparse BERT kernel launches {} != n_layer x steps x sites + "
             "the embeddings' {}".format(launches, want))
    density = sk.lower(cfg.sparse_attention_config.make_layout(SPARSE_T),
                       SPARSE_BLOCK).density
    tokens = SPARSE_B * SPARSE_T
    step_s = wall / SPARSE_TIMED
    print("bert_sparse_train " + json.dumps({
        "train": "bert-large sparse (Fixed, block 64) bf16 AdamW, dropout "
                 "0.1", "batch": SPARSE_B, "seq": SPARSE_T,
        "density": density, "timed_steps": SPARSE_TIMED,
        "tokens_per_s": tokens / step_s,
        "real_tokens_per_s": float(batch[1].sum()) / step_s,
        "mean_step_ms": step_s * 1e3, "step_ms": step_ms,
        "split_bwd_step_ms": split_wall / SPARSE_SPLIT * 1e3,
        "model_tflops_per_s": _bert_step_flops(cfg, SPARSE_B, SPARSE_T,
                                               density) / step_s / 1e12,
        "peak_mem_bytes": peak, "first_loss": losses[0],
        "last_loss": losses[-1], "losses": losses, "launches": launches,
        "card": card}))
    print("bert_sparse_profile " + json.dumps(_profile(step, 2)))
    return launches


def phase_bert_sparse_consistency():
    """One fp32 sparse BERT step at dropout 0.1 on the card (K7a, K7b
    fused) against the same on the CPU (plain versions)."""
    cfg = _sparse_bert_config(num_hidden_layers=2, dtype=torch.float32)
    config = {"train_batch_size": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}}}
    batch = _bert_batch(cfg, 2, 512, seed=4, min_len=128)
    cpu_model = BertForPreTraining(cfg, device="cpu", seed=2)
    card_model = BertForPreTraining(cfg, device="cuda", seed=None)
    card_model.load_state_dict(cpu_model.state_dict())
    sk.reset_launches()
    _card_vs_cpu("bert_sparse_consistency",
                 "fp32 width 1024, 2 layers, B2 T512, Fixed block 64, "
                 "dropout 0.1", card_model, cpu_model, config, batch)
    if sk.launches != {"sparse_fwd": 2, "sparse_bwd_fused": 2,
                       "sparse_bwd_split": 0}:
        fail("the card's sparse BERT step did not run K7a/K7b once per "
             "layer: {}".format(sk.launches))


def _sparse_kernel_rows(rows, launches, split_rows):
    """K7a and K7b fused / split: times at the sparse BERT path's shape,
    errors over every case, launches from the sparse BERT run; K7b split's
    entry carries the split-default shape's under "split_default"."""
    timed = rows[0]
    specs = [("block_sparse_attention_fwd", "K7a", "sparse_fwd", 133,
              "K7a_ms", "plain_fwd_ms", "library_fwd_ms", "fwd"),
             ("block_sparse_attention_bwd_fused", "K7b_fused",
              "sparse_bwd_fused", 241, "K7b_fused_ms", "plain_bwd_ms",
              "library_bwd_ms", "bwd"),
             ("block_sparse_attention_bwd_split", "K7b_split",
              "sparse_bwd_split", 208, "K7b_split_ms", "plain_bwd_ms",
              "library_bwd_ms", "bwd")]
    shape = ("B{} H16 T{} D64 bf16, Fixed layout block {} bidirectional "
             "(density {:.3f}), additive padding mask".format(
                 SPARSE_B, SPARSE_T, SPARSE_BLOCK, timed["density"]))
    out = [{"name": name, "route": "cuda",
            "source": "deepspeed_tpu_torch/csrc/sparse_attention.cu",
             "replaces": "deepspeed_tpu/ops/sparse_attention/kernels.py:{}"
                         .format(line),
             "launches": launches[counter],
             "max_abs_err": max(r[kernel]["max_abs_err"] for r in rows),
             "max_err_over_limit": max(r[kernel]["max_err_over_limit"]
                                       for r in rows),
             "ms": timed[ms], "plain_ms": timed[plain],
             "bound_ms": timed["bound_{}_ms".format(way)],
             "bound_by": timed["bound_{}_by".format(way)],
             "library_ms": timed[lib], "shape": shape}
           for name, kernel, counter, line, ms, plain, lib, way in specs]
    out[0]["design"] = (
        "block 64 bf16: fwd_wgmma_kernel, one CTA per pair of query blocks "
        "with equal LUT rows (forward schedule), a TMA producer warpgroup "
        "and two wgmma consumer warpgroups sharing each swizzled K/V tile; "
        "blocks 16/32 bf16: fwd_async_kernel (cp.async ring, ldmatrix, "
        "mma.sync); fp32/fp16: fwd_kernel (FMA)")
    out[0]["fwd_items"] = timed["fwd_items"]
    out[2]["split_default"] = split_rows["K7b_split"]
    return out


def _flash_kernel_rows(flash_rows, launches, bert_launches, split_rows):
    """K1/K2a/K2b: times at GPT-2 training's shape, launches from its run;
    under "bert" the times at BERT-large's shape and the launches from the
    BERT run; K2b's entry also gives its two kernels' own times (dkdv_ms,
    dq_ms) and the split-default shape's under "split_default"."""
    timed, bert = flash_rows[0], flash_rows[1]
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
            launches_bert=bert_launches[counter],
            bert={"shape": "B16 H16 T512 D64 bf16 non-causal, padding mask",
                  "launches": bert_launches[counter], "ms": bert[ms],
                  "plain_ms": bert[plain], "library_ms": bert[lib],
                  "bound_ms": bert["bound_{}_ms".format(way)],
                  "bound_by": bert["bound_{}_by".format(way)]},
            max_abs_err=max(r[kernel]["max_abs_err"] for r in flash_rows),
            max_err_over_limit=max(r[kernel]["max_err_over_limit"]
                                   for r in flash_rows),
            ms=timed[ms], plain_ms=timed[plain],
            bound_ms=timed["bound_{}_ms".format(way)],
            bound_by=timed["bound_{}_by".format(way)],
            library_ms=timed[lib]))
    k2b = rows[2]
    k2b.update(dkdv_ms=timed["K2b_dkdv_ms"], dq_ms=timed["K2b_dq_ms"],
               split_default=split_rows["K2b"])
    k2b["bert"].update(dkdv_ms=bert["K2b_dkdv_ms"], dq_ms=bert["K2b_dq_ms"])
    return rows


def _row_kernel_rows(rows, launches):
    """The kernels-line entries of K8, K10a, K10b and K11: times of the
    variant the timed BERT steps run most (the others under "variants"),
    errors over every variant and dtype, launches from the BERT run."""
    kernels_py = "deepspeed_tpu/ops/transformer/kernels/"
    specs = [("layer_norm", "layer_norm_plain", "layer_norm.py:34",
              launches["layer_norm_plain"] +
              launches["layer_norm_bias_residual"]),
             ("dropout_fwd", "dropout_fwd_hidden", "dropout.py:30",
              launches["dropout_fwd"]),
             ("dropout_bwd", "dropout_bwd_hidden", "dropout.py:142",
              launches["dropout_bwd"]),
             ("bias_gelu", "bias_gelu", "gelu.py:34", launches["bias_gelu"])]
    timed_keys = ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
                  "bound_by")
    out = []
    for name, main, replaces, n in specs:
        mine = {v: r for v, r in rows.items() if r["kernel"] == name}
        entry = {"name": name, "route": "cuda",
                 "source": "deepspeed_tpu_torch/csrc/transformer_kernels.cu",
                 "replaces": kernels_py + replaces, "launches": n,
                 "max_abs_err": max(r["max_abs_err"] for r in mine.values()),
                 "max_err_over_limit": max(r["max_err_over_limit"]
                                           for r in mine.values())}
        entry.update({k: mine[main][k] for k in timed_keys})
        others = {v: {k: r[k] for k in timed_keys}
                  for v, r in mine.items() if v != main}
        if others:
            entry["variants"] = others
        out.append(entry)
    return out


def _spec_launches(line, path, n_layer):
    """A speculating serve path's launches of its decode kernel, from its
    line (``phase_serve`` has checked them against the counts): n_layer
    per verify step at S = VERIFY_S, and n_layer per prefill lane at S =
    prefill_chunk where the lane runs the same kernel (paged pools)."""
    return {"launches": n_layer * line["decode_steps"],
            "prefill_lane_launches": (n_layer * line["prefill_lanes"]
                                      if path[3] == path[2] else 0)}


def _verify_row(rows, shape, launches):
    """A decode kernel at the verify lane's shape (the bf16 B16 S VERIFY_S
    case of ``rows``): its times and bound, and from the serving path with
    speculation its launches at that shape and, apart, those of the path's
    prefill lanes (``_spec_launches``), under "verify" in the kernel's
    entry."""
    row = next(r for r in rows if r["case"] == "verify"
               and r["dtype"] == "bfloat16" and "ms" in r)
    out = {key: row.get(key) for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms",
                                         "max_abs_err", "max_err_over_limit")}
    out.update(shape=shape, pos=row["pos"], **launches)
    return out


def _decode_variant_rows(rows, launches, verify_launches):
    """The kernels-line entries of K4, K5 and K6: times at the bf16 decode
    case, errors over every case and dtype, launches from each one's
    serving path (K6 the slice's main path, K5 and K4 its two arms); under
    "verify" the same at the verify lane's shape, with the launches of the
    speculating paths."""
    specs = {"q8": ("decode_attention_q8", 312,
                    "B16 H16 S1 T{} D64, int8 codes + fp32 scales, bf16 q"
                    .format(PLANE)),
             "paged": ("decode_attention_paged", 676,
                       "B16 H16 S1, {} pages of {} (T{}) D64 bf16".format(
                           PAGED_PLANE // PAGE_LEN, PAGE_LEN, PAGED_PLANE)),
             "paged_q8": ("decode_attention_paged_q8", 682,
                          "B16 H16 S1, {} pages of {} (T{}) D64, int8 codes "
                          "+ fp32 scales, bf16 q".format(
                              PAGED_PLANE // PAGE_LEN, PAGE_LEN,
                              PAGED_PLANE))}
    out = []
    for kind, _ in DECODE_VARIANTS:
        name, line, shape = specs[kind]
        main_row = rows[kind][0]  # bf16 decode
        out.append({
            "name": name, "route": "cuda",
            "source": "deepspeed_tpu_torch/csrc/decode_attention.cu",
            "replaces": "deepspeed_tpu/ops/transformer/kernels/"
                        "decode_attention.py:{}".format(line),
            "launches": launches[kind],
            "max_abs_err": max(r["max_abs_err"] for r in rows[kind]),
            "max_err_over_limit": max(r["max_err_over_limit"]
                                      for r in rows[kind]),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes int8 or paged "
                            "decode attention",
            "shape": shape,
            "verify": _verify_row(rows[kind], shape.replace(
                "S1", "S{}".format(VERIFY_S)), verify_launches[kind])})
    return out


def main():
    card = phase_env()
    phase_build()
    rows = phase_kernels()
    variant_rows = phase_decode_variants()
    phase_stress()
    flash_rows = phase_flash()
    row_rows = phase_rows()
    softmax_rows, softmax_launches = phase_softmax()
    model = GPT2LMHeadModel(GPT2Config.gpt2_medium(dtype=torch.bfloat16),
                            device="cuda", seed=0)
    serve = {path[0]: phase_serve(card, model, *path)[0]
             for path in SERVE_PATHS}
    spec = {path[0]: phase_serve(card, model, *path, tiled=True)
            for path in SPEC_PATHS}
    on, off = spec["serve_spec"][1], spec["serve_spec_off"][1]
    if on["program_keys"] != off["program_keys"]:
        fail("serve_spec met the keys {} and serve_spec_off {}: speculation "
             "must not add a program".format(on["program_keys"],
                                             off["program_keys"]))
    phase_graph_vs_eager(model)
    phase_telemetry(card, model)
    phase_sustained(card, model)
    n_layer = model.config.n_layer
    del model
    # Each decode kernel's launches on its own path's decode and prefill
    # lanes: K3 dense, K6 paged int8 (the slice's main path), K5 and K4
    # their arms; with speculation (S = VERIFY_S), the same from SPEC_PATHS.
    serve_launches = {path[2]: serve[path[0]][path[2]]
                      for path in SERVE_PATHS}
    verify_launches = {path[2]: _spec_launches(spec[path[0]][1], path,
                                               n_layer)
                       for path in SPEC_PATHS if path[1]}
    launches = serve_launches["decode"]
    phase_greedy()
    train_launches = phase_train(card)
    phase_train_breakdown(card)
    phase_train_consistency()
    bert_launches = phase_bert(card)
    phase_bert_consistency()
    sparse_rows = phase_sparse()
    split_rows = phase_split_default()
    sparse_launches = phase_bert_sparse(card)
    phase_bert_sparse_consistency()
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
        "shape": "B16 H16 S1 T{} D64 bf16".format(PLANE),
        "verify": _verify_row(rows, "B16 H16 S{} T{} D64 bf16".format(
            VERIFY_S, PLANE), verify_launches["decode"]),
        "split_keys": da.SPLIT_KEYS,
        "combine": {key: main_row["combine"][key] for key in (
            "ms", "bound_ms", "max_abs_err", "max_err_over_limit")}}]
    kernels += _decode_variant_rows(variant_rows, serve_launches,
                                    verify_launches)
    kernels += _flash_kernel_rows(flash_rows, train_launches, bert_launches,
                                  split_rows)
    kernels += _row_kernel_rows(row_rows, bert_launches)
    kernels.append(_softmax_kernel_row(softmax_rows, softmax_launches))
    kernels += _sparse_kernel_rows(sparse_rows, sparse_launches, split_rows)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
