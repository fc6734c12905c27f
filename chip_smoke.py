"""Chip smoke for the PyTorch/CUDA port (deepspeed_tpu_torch) on one H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit. It imports nothing of JAX or of the JAX package. Phases, each
of which exits non-zero on failure:

1. environment: card name and power limit (nvidia-smi), torch and CUDA
   versions, then ``deepspeed_tpu_torch.env_report``; no CUDA device means
   exit 1 with no result;
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
   paged or int8 decode attention: library_ms is null); then the fleet
   phases' shapes (FLEET_SERVE: 8 slots, a plane of 528 positions):
   K3 in the decode lane (S1) and the verify lane (S3), K5 in the dense
   pools' prefill lane (S16), K6 in the paged int8 pass's decode, verify
   and prefill lanes, bf16, against their plain versions and dense twins;
   then the decode-kernel stress: K3, K4, K5 and K6 at the bf16 decode case
   over STRESS_SEEDS fresh seeds each, every case held to its limit (and K5
   = K3, K6 = K4 bit for bit); the count of cases over the limit per
   kernel, and the worst element of any; then the poison run: K3's first
   case repeated POISON_REPEATS times with its output buffer filled with
   NaN or 1e4 before each launch, the keys and values of the frontier's
   tile past the frontier set to 1e4 and every later tile to NaN, the last
   POISON_CONCURRENT repeats beside K3 launches on a second stream;
4. serving at full width: GPT-2 medium, bf16, seeded weights, through
   init_inference; N_REQUESTS (18) requests of 64/256 prompt tokens and
   96 new tokens;
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
4c. crash-only resilience (phase_resilience), GPT-2 medium bf16 (its
   width, SHORT_LAYERS of its layers, for the smoke's time) on SERVE with
   fault injection on: (i) the recovery invariant: a mixed stream
   of 16 requests (64/256 prompt tokens, 96 new; every fourth opted out
   of speculation, every third sampled, one with top-k) on the dense
   speculating pool (K3 at S5, prefill lane K5) and the paged int8 pool
   (K6), fault-free, then with a raise and with a nan fault fired at the
   first step after a request decodes: no request lost, replays equal
   to the recovery log's count, compile_count unchanged and no recompile
   after mark_warm(), no pool tensor rebound (data_ptr), every page
   returned, healthy, the decode kernels' launches n_layer x decode steps
   and prefill lanes plus the faulted step's own (a nan step ran its
   program, a raise step none), and every stream equal to the fault-free
   run's under phase 5's gap rule (sampled ones over the Gumbel-max
   scores; the replay re-derives the delivered tokens through the decode
   lane, so the streams should be equal outright), with the tokens
   matched and the requests whose re-derivation disagreed (replayed from
   prompt + delivered tokens instead); (ii) after a recovery, a
   graph-served engine against the same program run eagerly, as in
   phase_graph_vs_eager, bit for bit; (iii) a 1.0 s stall under a 0.5 s
   step budget: degraded, then healthy after one clean step (the
   warm-up's stalls, from its captures, are reported); (iv) at
   recovery_max_retries 1 a 10-step raise ends in EngineDeadError from
   InjectedFault, after which submit, step, drain and undrain refuse;
   (v) on paged int8 engines, a decoding request cancelled keeps its
   tokens, the other streams equal the uncancelled run's, every page
   comes back; drain() with queued work settles idle and refuses
   submit() until undrain(); one ``resilience`` line;
4d. chaos (phase_chaos): the JAX ``bench.py --chaos`` TPU setting, a
   dense bf16 pool (K3, prefill lane K5) under 64 Poisson arrivals at
   12/s through loadgen's SustainedRunner with one raise armed after
   1 s: fails unless the fault fired, the engine recovered, healthy,
   with no request lost, a finite recovery time, no capture after
   warm-up and exact K3/K5 launch counts; the ``chaos`` line carries
   the report's chaos section (recovery time, SLO attainment during and
   outside recovery), TTFT p50/p99 and tokens/s;
4e. the KV hierarchy (phase_hierarchy), GPT-2 medium bf16 (its width,
   SHORT_LAYERS of its layers) on SERVE with
   the prefix cache (8 rows of 64, matches of at least 8) and host
   offload (8 swap slots): 32 requests over 4 shared 48-token system
   prompts with tails of 16-208 tokens, 96 new tokens, every sixth
   sampled (more requests than slots, so sessions swap): (i) dense bf16
   with the tiers on and off: every stream held to the other by phase 5's
   gap rule (sampled ones over the Gumbel-max scores; the count of
   bit-equal streams printed), hits, inserts, swap-outs and swap-ins each
   at least 1, fewer prefill lanes, exact K3/K5 launches, every capture a
   key met for the first time, no pool tensor rebound; (iii) once every
   slot is busy, a decoding slot captured, scribbled over and restored on
   the live pool: the whole pool byte for byte; (iv) on the same engine, a
   raise once a session is swapped out: nothing lost, the streams held to
   the fault-free run's, compile_count unchanged, no recompile; (ii) the
   JAX bench default (paged int8 at pages of 128, speculation; K6, its
   round trip too) against dense int8 with the same tiers (K4, prefill
   lane K6): token for token; (v) graph against eager over
   HIER_GRAPH_STEPS steps of HIER_GRAPH_REQUESTS requests with hits,
   swap-outs and swap-ins, dense and
   paged int8 with speculation, bit for bit; (vi) swap-out and swap-in
   ms p50/p99, bytes and GB/s (CUDA events around the copies), TTFT and
   admit-to-first-token p50 of hits and misses; one ``hierarchy`` line;
4f. the sustained run with the JAX ``bench.py --sustained`` TPU setting
   in full (phase_sustained_hier: dense int8 with the prefix cache and
   host offload; K4, prefill lane K6) under phase_sustained's arrivals:
   hit rate, swaps, TTFT p50/p99, goodput, attainment, effective slots;
   fails on a lost request, a recompile or launches off the run's steps;
4g. the serving fleet (phase_fleet): the JAX ``bench.py --fleet-smoke``
   TPU setting (FLEET_SERVE: 8 slots, max_len 512, chunk 8, prefill
   chunk 16, speculation at spec_k 2, the prefix cache) on 24 requests
   over two shared 24-token templates, 48 new tokens: (i) one warm engine
   (the reference, and the tokens/s a fleet is compared with); (ii) two
   replicas on the card, each on its own stream and thread, affinity
   off, fault-free, then FLEET_SHIPMENTS prefix rows shipped replica to
   replica, timed and byte-equal; (iii) two replicas, affinity on: once
   replica 0 owns a request with tokens delivered, a raise kills it
   (recovery_max_retries 0) while the second half arrives: none lost,
   every stream held to (i) by phase 5's rule (sampled ones over the
   Gumbel-max scores), the warm survivor captures nothing and rebinds no
   pool tensor, each replica's own K3/K5 launches n_layer x its steps,
   the fleet healthy, the autopsy's failover arrow from replica0 to
   another replica with no hop gap; (iv) the first 8 requests on paged
   int8 pools (K6) with a prefill-role and a mixed replica (handoffs
   captured page by page, a prefix-page shipment byte-equal); one
   ``fleet`` line with each transfer's ms and GB/s;
4h. disaggregated serving (phase_disagg): the JAX ``bench.py --disagg``
   TPU setting (DISAGG_SERVE, DISAGG_LOAD: 32 Poisson arrivals at 12/s,
   lognormal prompts of mean 192), one prefill and two decode replicas
   against the same three all mixed, each warmed on one thread (every
   replica meets its keys) and driven open loop by SustainedRunner on
   the stepping threads: none lost or shed, no fallback, no prefill lane
   on a decode replica, no capture after warm-up, launches exact per
   replica, every greedy stream held to one engine's by phase 5's rule;
   the ITL and TTFT A/B is reported, not gated; one ``disagg`` line;
4i. the SLO front door (phase_frontdoor): the JAX ``bench.py
   --frontdoor-smoke`` TPU setting (FRONTDOOR_SERVE, FRONTDOOR_LOAD: two
   tenants, interactive at 4/s and batch ramping 4 to 24/s, 144 requests),
   a warm engine driven open loop with and without a FrontDoor (an
   interactive class with a 1500 ms budget and weight 4, a preemptible
   batch class, batch headroom 0.25): none lost, no capture after
   mark_warm(), batch completing, K3/K5 launches n_layer x the decode
   steps and prefill lanes; interactive TTFT/ITL p50/p99 and attainment,
   batch TTFT p99, sheds by reason, preemptions per side, reported;
4j. the front door's resilience (phase_frontdoor_resilience): a decoding
   request preempted, held and released on one engine, and one preempted
   on replica 0 of a warm two-replica fleet behind a FrontDoor before
   replica 0 is killed, its streams consumed round-robin through the
   kill: every stream bit-equal to its undisturbed run, none lost, no
   capture on the survivor;
4k. the adapters (phase_adapters) at GPT-2 medium's widths: MoE
   (MOE_CFG: 4 layers, for the smoke's time, of 8 experts of d_ff 4096
   made on the card) and long context
   (LONG_CFG over the model): graph-served equals eager bit for bit;
   MoE routes n_layer x the tokens its programs touched and drops none,
   launches no K3-K6 and agrees with the CPU at 2 layers in fp32; long
   context below its threshold equals the dense einsum bit for bit and is
   reported against GPT-2's K3 streams, serves prompts across it, and
   with sparse_decode=False equals the dense einsum; tokens/s and mean
   step of each, and GPT-2 on the MoE's stream;
4l. the perf x-ray (phase_xray): the dense serve stream on an engine
   with perf_xray on and one with it off: every key met has a record
   with flops > 0, bytes and graph-pool bytes, MFU and MBU of sampled
   records in (0, 1], no recompile after mark_warm(); the median step on
   and off in turns; a two-replica fleet's sections;
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
   T=1000 and T=64, the model-parallel arms' shapes (phase 16: B=8 H=8
   on each tensor-parallel rank, B=2 H=16 a pipeline micro-batch, T=1024,
   bf16, causal) and GPT-2 XL's (B=2 H=25); each element held to its own
   limit (see FLASH_TOL); times the kernels (K2b's two kernels also
   apart), the plain versions and torch's scaled_dot_product_attention (a
   yardstick only) beside the bound, at the training, the BERT, the
   model-parallel and GPT-2 XL's shapes;
7. training at full width: GPT-2 medium, bf16, seeded weights, through
   initialize / train_batch on batches of 8 x 1024; the loss must be finite
   and fall; the kernels' launch counts are reset just before the counted
   steps and read just after, and must equal n_layer x steps (K2b: two per
   layer, in the steps run with the split backward); then a profiler
   window of 2 steps; then the ``amp`` block's step against the bf16
   block's from the same weights (AMP_LAYERS layers, K2b): bf16 compute,
   the loss and every master bit for bit (``train_amp``);
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
14a. module injection and the tooling (phase_tooling): the host C++ LUT
   op's tables equal the numpy lowering's for sparse BERT's layout and a
   BigBird one (phases 12 and 13 ran on the op's tables), both timed at 16
   heads and 512 blocks a side (``lut_op``); BERT-large's 24 layers in the
   HF flax layout from a seed through ``replace_transformer_layer``, one
   bf16 training step of the injected fused layers at 16 x 512 and
   dropout 0.1 (K1 = 24, K2 24 fused or 48 split by the autotuner's
   choice, K8 48, K10a/K10b 72 each, K11 24), their fp32 forward of 2
   sequences within INJECT_TOL of the HF-style plain forward, and the
   revert equal to the HF tree bit for bit (``module_inject``); a dense
   plain-layer BERT-large swapped by
   ``replace_model_self_attention_with_sparse_self_attention`` gives the
   first training loss of the BERT built with ``sparse_attention_config``
   bit for bit at 2 x 4096, launching K7a 24 and K7b 24 (``sparse_swap``);
   GPT-2 medium saved with ``torch.save`` in the reference's names under
   ``<dir>/latest`` and loaded by ``import_reference_checkpoint`` gives
   the greedy tokens of the model it came from (``checkpoint_import``);
   the flops profiler on one GPT-2 medium training step (8 x 1024 bf16),
   its total beside the model-flops formula and its printed profile
   (``flops_profile``, ``flops_profile_text``), then at 4 layers and fp32
   the profiled step's flops and bytes and the x-ray's train_step record
   on the card equal to the CPU's for GPT-2 and for the fused BERT at
   dropout 0.1 (``profiler_card_vs_cpu``); ``DS_TPU_AUTOTUNE=force`` sweeps K2a
   against K2b at the autotune table's four signatures, the rows pass
   ``validate_table``, and a graph captured under ``DS_TPU_AUTOTUNE=1``
   at a signature no table holds sweeps nothing (``autotune``);
15. data-parallel ZeRO (phase_data_parallel): DP_RANKS rank processes on
   cuda:0, started with the launcher's environment contract (RANK,
   WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and joined over gloo
   (NCCL refuses two ranks on one device), each with a DP_TIMEOUT_S
   rendezvous and collective timeout and waited for as long: GPT-2 medium
   bf16 at full width, DP_LAYERS of its 24 layers, AdamW 1e-4, dropout 0,
   4 x 1024 tokens
   per rank (the global 8 x 1024 of phase 7), ZeRO stages 0-3, each
   DP_WARM steps then DP_TIMED timed ones through train_batch; a
   ``data_parallel`` line per rank and stage (tokens/s, mean step ms,
   peak device memory, K1/K2a/K2b launches per step read over the timed
   steps, stage-3 gathers and collective bytes per step); fails unless
   each rank launches K1 and K2a n_layer times a step, stage 3 gathers
   1 + 2 n_layer times a step, the ranks' mean losses agree and the peak
   memory at stages 1 and 3 is below stage 0's; then the fp32 arm (4
   layers, width 1024, B4 T256 over the ranks, compute dtype fp32): each
   stage's step against one process on the whole batch (the loss within
   1e-5 relative, the masters under the training rule), and a stage-2
   elastic checkpoint saved by the ranks, loaded by one process, the next
   step of each held the same way (``data_parallel_check``); then one
   ZeRO-2 step as a one-rank NCCL group against the same step without a
   group, and the NCCL reduce-scatter and all-gather on CUDA tensors
   (``data_parallel_nccl``). Slice 18's arms in the same rank processes
   (DP_ARMS, at stage 2 and DP_ARM_LAYERS, 4 of the 24 layers): ZeRO-Offload
   with the host Adam (each rank its partition of the masters and moments
   on the host), Lamb on the card and Lamb on the host, each a
   ``data_parallel`` line with its host step's phases, failing unless K1
   and K2a run 24 times a step on each rank, the ranks' losses agree and
   each arm ran its optimizer; then each arm's fp32 step (4 layers)
   against one process, the loss within 1e-5 relative and the masters
   under the training rule;
16. model parallelism (phase_model_parallel): MP_RANKS rank processes of
   this script on cuda:0, started by the port's launcher
   (``deepspeed_tpu_torch.launcher.launch``) and joined over gloo, each
   with an MP_TIMEOUT_S rendezvous and collective timeout; GPT-2 medium
   bf16 at full width, MP_LAYERS of its 24 layers, AdamW 1e-4, dropout 0,
   the global 8 x
   1024: tensor parallelism (mp 2, each rank 8 of the 16 heads and half of
   every c_attn, c_fc and c_proj kernel) through ``train_batch``, then the
   1F1B pipeline (2 stages of MP_LAYERS / 2 blocks, 4 micro-batches of 2 x
   1024, the
   tied embedding) through ``train_batch(data_iter=...)``, each MP_WARM
   steps then MP_TIMED timed ones; a ``model_parallel`` line per rank and
   arm (tokens/s, mean step ms, peak device memory, K1/K2a launches,
   all-reduce, p2p and tied-gradient bytes per step); fails unless K1 and
   K2a run MP_LAYERS times a step on each TP rank and MP_LAYERS / 2 x 4 on
   each stage, and
   the ranks' losses agree; then the fp32 arm (4 layers, width 1024, B4
   T256): a TP step and a PP step (2 micro-batches) each against one
   process on the same card, the loss within 1e-5 relative, the masters
   under the training rule (``model_parallel_check``). Slice 18's compiled
   pipeline in the same rank processes: ``gpt2_pipeline(compiled=True)``
   at all CP_LAYERS layers (12 blocks a stage, stacked), the same 4
   micro-batches, MP_WARM then MP_TIMED steps; a ``model_parallel`` line
   per rank (tokens/s, step ms, peak memory, launches, p2p bytes, graph
   captures after step 1 and in all, replays a step, allocated bytes after
   each timed step), failing unless K1 = 96 and K2a = 48 a stage and step
   (the tick and its recompute), the tick graphs were captured twice in
   step 1 and never again, replayed 8 times a step, with no growth of the
   allocated bytes; then the same engine with its graphs against it run
   eagerly, under K2b at MP_LAYERS layers and dropout CP_DROPOUT,
   CP_GRAPH_STEPS steps: losses and every parameter bit for bit, and one
   step at dropout 0 giving another loss (``model_parallel_graph``); then
   its fp32 check (4 layers) against the interpreter: losses within 1e-5
   relative, the stage's parameters under the training rule. Slice 19's
   arms in the same rank processes: serving over the two as model ranks
   (``init_inference(mesh=build_mesh(num_mp=2))``: GPT-2 medium bf16 at
   full depth, 8 heads a rank, N_REQUESTS of TP_PROMPT tokens under SERVE;
   a ``model_parallel_serve`` line per rank with tokens/s beside one
   process's on the same rank, K3 = 24 x decode steps and K5 = 24 x prefill
   lanes, compile_count, the captured segments, exactly one plus two a
   layer and forward of each program met and none after the last capture,
   the allocated bytes flat after it, the all-reduces a step and the pool's
   bytes against one process's), failing unless the ranks' streams are
   identical and, where one parts from one process's, the logits there
   agree within TP_BF16_TOL; the fp32 check (4 layers) against one process
   under phase 5's rule; the segmented programs against eager at MP_LAYERS
   layers bit for bit; expert-parallel MoE serving of MOE_CFG (4 experts a
   rank; bf16 timed; in fp32 with and without expert parallelism against
   one process, the expert load gauges equal); MoE training (MOE_TRAIN:
   mp 2 and dp 2 with global gating, each timed; the fp32 check where
   capacity drops tokens against one process, losses 1e-5 relative, the
   parameters under the training rule);
17. sequence parallelism and 1-bit Adam (phase_sequence_parallel):
   SP_RANKS rank processes of this script on cuda:0, started by the port's
   launcher and joined over gloo (SP_TIMEOUT_S): GPT-2 medium bf16 at full
   width, SP_WIDTH's 4 layers (n_positions SP_T), AdamW 1e-4, dropout 0,
   one global
   B1 x SP_T sequence split into SP_T / 2 tokens a rank through
   ``initialize(config_params={"sequence_parallel": ...})`` and
   ``train_batch``, the ring and then Ulysses, each one warm and one timed
   step; a ``sequence_parallel`` line per rank and mode (tokens/s, step
   ms, peak device memory, K1/K2a/K2b launches, ring-shift, all-to-all and
   all-reduce calls and bytes), failing unless launches and collectives
   equal the schedule's (``_sp_schedule``) and every loss is finite; then
   1-bit Adam over the two as data ranks (B4 x T1024 a rank, freeze_step
   ONEBIT_FREEZE): a warm-up step, a timed dense step and the first
   compressed step, an ``onebit`` line per rank, failing unless the dense
   step all-reduces the fp32 gradients, the compressed step exchanges only
   the packed signs and scales (``_onebit_bytes``: n/8 bytes a padded leaf
   through the all-to-all) with no gradient all-reduce, and K1 = K2a = 24
   a step; then the fp32 arms (4 layers at width 1024): an SP step (ring,
   Ulysses, T SP_CHECK_T) against one process (loss 1e-5 relative,
   gradients GRAD_TOL of each tensor's max-abs), and 1-bit Adam dp 2
   through its freeze, card against the CPU (losses 1e-5 relative, masters
   under the training rule but for the key third's server chunks of
   ``c_attn.bias``); then, in this process, activation checkpointing: 24
   GPT-2 medium blocks at dropout 0.1 through
   ``checkpointing.checkpoint``, with and without ``cpu_checkpointing``,
   gradients bit-equal to the plain stack's (K2b), peak device memory
   beside the plain stack's (``activation_checkpointing`` line);
18. the kernels line (each decode kernel's entry also carries its
   launches in the hierarchy phase's runs, per replica in the fleet
   phases' runs, and its rows at the fleet's shapes; K1/K2a/K2b theirs
   per rank and stage in the data-parallel run, per rank in the
   model-parallel arms and in the sequence-parallel and 1-bit arms, and
   their errors and times at the ring block's shape under global
   statistics), then the result line.
"""

import collections
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import types
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from deepspeed_tpu_torch import init_inference, initialize  # noqa: E402
from deepspeed_tpu_torch.inference import (  # noqa: E402
    EngineDeadError, EngineDraining, Fault, FaultPlan, FrontDoor,
    FrontDoorConfig, InferenceEngine, InjectedFault, PriorityClass,
    ServingFleet, TenantPolicy)
from deepspeed_tpu_torch.inference.adapters import (  # noqa: E402
    LongContextAdapter, MoEAdapter)
from deepspeed_tpu_torch.inference.kv_hierarchy import (  # noqa: E402
    HierarchySpec, capture_slot, capture_slot_paged, record_nbytes,
    restore_slot, restore_slot_paged)
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
from deepspeed_tpu_torch.ops.adam.cpu_adam import (  # noqa: E402
    DeepSpeedCPUAdam)
from deepspeed_tpu_torch.ops.lamb.cpu_lamb import (  # noqa: E402
    DeepSpeedCPULamb)
from deepspeed_tpu_torch.ops.sampling import (  # noqa: E402
    positional_uniform)
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
from deepspeed_tpu_torch.runtime.dataloader import (  # noqa: E402
    RepeatingLoader)
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
# N_REQUESTS is more than SERVE's 16 slots, so every serving path queues
# requests and refills the slots (and pages) that finished ones free; the
# serving paths' depth, kept so the whole smoke stays inside its limit.
N_REQUESTS, NEW_TOKENS, PROMPT_LENS = 18, 96, (64, 256)

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
# The amp block's step pair (phase_train): GPT-2 medium's width at 4 layers.
AMP_LAYERS = 4

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
# Graph-served against eager: requests and the steps compared (12 steps
# until the smoke's time limit cut them to 8).
GRAPH_CHECK_REQUESTS, GRAPH_CHECK_STEPS = 8, 8
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
# The telemetry turns serve the serve path's first TELEMETRY_REQUESTS
# requests (every key met; 8 since PR 22, from N_REQUESTS, for the smoke's
# time: seven turns of the stream).
TELEMETRY_REQUESTS = 8
# The sustained-load run (phase_sustained): the JAX package's TPU setting
# of ``bench.py --sustained`` (bench.py:1346-1360) less the prefix and
# offload tiers (phase_sustained_hier runs it in full): a dense int8 pool
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
# The saturation sweep's rates and requests a rate (16 until the smoke's
# time limit cut them to 8, and to 4 since: the sweep's arrivals are most
# of its time).
SWEEP_RATES, SWEEP_REQUESTS = (1.0, 2.0, 4.0), 4
# The KV hierarchy (phase_hierarchy): SERVE plus the JAX package's
# defaults of the prefix tier (8 rows of 64 positions, matches of at least
# 8) and host offload (8 swapped sessions); HIER_REQUESTS requests over
# HIER_PROMPTS shared HIER_SYSTEM-token system prompts with random tails of
# HIER_TAILS tokens, NEW_TOKENS each, every sixth sampled: more requests
# than slots, so sessions swap. (v) serves the first HIER_GRAPH_REQUESTS
# of the stream for HIER_GRAPH_STEPS steps: one waits for a slot, so one
# session swaps out and, once a slot frees (step 16 of the dense run),
# back in.
HIER = {"prefix_cache": True, "prefix_slots": 8, "prefix_len": 64,
        "min_prefix_len": 8, "host_offload": True, "swap_slots": 8}
HIER_REQUESTS, HIER_PROMPTS, HIER_SYSTEM, HIER_TAILS = 32, 4, 48, (16, 208)
HIER_GRAPH_REQUESTS, HIER_GRAPH_STEPS = 17, 24
# The sustained run with the whole JAX TPU setting (bench.py:1350-1352):
# SUSTAINED_SERVE with the prefix cache and host offload.
SUSTAINED_HIER_SERVE = dict(SUSTAINED_SERVE, prefix_cache=True,
                            host_offload=True)
# Crash-only resilience (phase_resilience): the recovery invariant's mixed
# stream at full width on SERVE with fault injection on: RESILIENCE_REQUESTS
# requests of PROMPT_LENS prompt and NEW_TOKENS new tokens, every fourth
# opted out of speculation, every third sampled (the first of those with
# top-k), on the dense speculating pool (K3 at S5, prefill lane K5) and the
# paged int8 pool (K6); each fault kind fires at the first step after a
# request starts decoding.
RESILIENCE_POOLS = [("dense_spec", SPEC, "decode", "paged"),
                    ("paged_int8", dict(PAGED, int8_kv=True), "paged_q8",
                     "paged_q8")]
RESILIENCE_KINDS = ("raise", "nan")
RESILIENCE_REQUESTS = 16
# The depth of the model the resilience and hierarchy phases serve (main).
SHORT_LAYERS = 8
# Detection: a stall of STALL_S under a watchdog budget of STALL_BUDGET_S.
# Bounds: a raise lasting DEAD_FAULT_STEPS steps at recovery_max_retries 1.
STALL_S, STALL_BUDGET_S = 1.0, 0.5
DEAD_FAULT_STEPS = 10
# The chaos run (phase_chaos): the JAX package's TPU setting of
# ``bench.py --chaos`` (bench.py:1504-1513): a dense bf16 pool (K3, prefill
# lane K5), 64 Poisson arrivals at 12/s, one raise two steps after the
# plan is armed at CHAOS_AFTER_S.
CHAOS_SERVE = {"max_slots": 16, "max_len": 1024, "chunk_size": 16,
               "max_queue": 128, "fault_injection": True}
CHAOS_LOAD = dict(arrival="poisson", rate=12.0, n_requests=64,
                  prompt_dist="lognormal", prompt_mean=64, prompt_max=256,
                  output_dist="lognormal", output_mean=96, output_min=8,
                  output_max=256, vocab_size=50257, seed=23)
CHAOS_WINDOW_S, CHAOS_AFTER_S = 2.0, 1.0
CHAOS_SLO = SLO(ttft_p99_ms=1500.0, itl_p99_ms=150.0)
# The serving fleet (phase_fleet): the JAX ``bench.py --fleet-smoke`` TPU
# setting (bench.py:1663-1672): 2 replicas of 8 slots, max_len 512, chunk 8,
# prefill_chunk 16, speculation (spec_k 2, spec_ngram 2), the prefix cache
# (8 rows of 64, matches of 8); FLEET_REQUESTS requests over two shared
# FLEET_TEMPLATE-token templates, FLEET_NEW new tokens each; the kill run
# with fault injection and recovery_max_retries 0; a short pass of the first
# FLEET_PAGED_REQUESTS on paged int8 pools (K6). A replica meets FLEET_KEYS.
FLEET_SERVE = {"max_slots": 8, "max_len": 512, "chunk_size": 8,
               "prefill_chunk": 16, "max_queue": 64, "spec_decode": True,
               "spec_k": 2, "spec_ngram": 2, "prefix_cache": True,
               "prefix_slots": 8, "prefix_len": 64, "min_prefix_len": 8}
FLEET_CHAOS = {"fault_injection": True, "recovery_max_retries": 0}
FLEET_PAGED = {"paged_kv": True, "kv_page_len": 128, "int8_kv": True}
FLEET_REQUESTS, FLEET_NEW, FLEET_TEMPLATE = 24, 48, 24
FLEET_PAGED_REQUESTS = 8
# One engine and the fault-free fleet each serve the stream this many times
# back to back (each wave drained before the next), so their tokens/s is
# read over some seconds and its spread over the waves shows.
FLEET_WAVES = 3
# Prefix rows shipped one replica to the other, timed (phase_fleet (ii)).
FLEET_SHIPMENTS = 8
FLEET_KEYS = [(False, False, False), (False, True, False),
              (True, False, False), (True, True, False)]
# The fleet's kernel shapes (phase_decode_variants): its plane, its verify
# lane's rows, and frontiers at the splits and the plane's end.
FLEET_PLANE = plane_len_for(FLEET_SERVE["max_len"],
                            FLEET_SERVE["prefill_chunk"])
FLEET_VERIFY_S = FLEET_SERVE["spec_k"] + 1
FLEET_DECODE_POS = [0, 1, 127, 128, 255, 256, 500, FLEET_PLANE - 1]
FLEET_VERIFY_POS = [0, 125, 126, 127, 253, 254, 500,
                    FLEET_PLANE - FLEET_VERIFY_S]
FLEET_LANE_POS = [0, 127, 128, 500, FLEET_PLANE - FLEET_SERVE[
    "prefill_chunk"]]
# Disaggregated serving (phase_disagg): the JAX ``bench.py --disagg`` TPU
# setting (bench.py:1908-1915): 1 prefill + 2 decode replicas against the
# same 3 all mixed, Poisson arrivals at 12/s (32 since PR 22, from the
# bench's 64, for the smoke's time), lognormal prompts (mean 192, max 384),
# 48 new tokens, seed 23; SLO TTFT p99 2 s, ITL p99 200 ms.
DISAGG_SERVE = {"max_slots": 8, "max_len": 512, "chunk_size": 8,
                "prefill_chunk": 16, "max_queue": 128}
DISAGG_ROLES = ("prefill", "decode", "decode")
DISAGG_LOAD = dict(arrival="poisson", rate=12.0, n_requests=32,
                   prompt_dist="lognormal", prompt_mean=192, prompt_max=384,
                   output_dist="fixed", output_mean=48, output_max=48,
                   vocab_size=50257, seed=23)
DISAGG_WINDOW_S = 2.0
# After the timed A/B, this many of the stream's prompts go through the
# disaggregated fleet again, untimed, with the transports timed.
DISAGG_PROBE_REQUESTS = 8
DISAGG_SLO = SLO(ttft_p99_ms=2000.0, itl_p99_ms=200.0)
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
    from deepspeed_tpu_torch import env_report
    env_report.main()
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


def _case(B, S, frontiers, dtype, seed, T=PLANE, H=16):
    """q, k, v, pos on the card (``H`` heads); positions past each row's
    frontier hold large finite garbage."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    D = 64
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
             page_len=PAGE_LEN, serve=SERVE, H=16):
    """One case of decode kernel ``kind`` (a key of DECODE_KEYS) on the
    card: launches of the kernel, its plain version and its dense twin
    (K3 on the gathered plane for K5, K4 for K6), the fp32 planes its limit
    is computed from, and what its bound counts. Paged kinds use pages of
    ``page_len`` positions; the plane is the one ``serve``'s max_len and
    prefill_chunk give."""
    item = dtype.itemsize
    if kind in ("decode", "q8"):
        T, extra = plane_len_for(serve["max_len"], serve["prefill_chunk"]), 0
        if kind == "decode":
            q, k, v, pos = _case(B, S, frontiers, dtype, seed, T, H)
            ops, kv = (k, v), (k, v)
        else:
            q, kc, vc, ks, vs, pos = _q8_case(B, S, frontiers, dtype, seed,
                                              T)
            ops = (kc, vc, ks, vs)
            kv = (da.dequantize_kv(kc, ks), da.dequantize_kv(vc, vs))
        twin = None
    else:
        T = paged_plane_len(serve["max_len"], serve["prefill_chunk"],
                            page_len)
        if kind == "paged":
            q, k, v, pos = _case(B, S, frontiers, dtype, seed, T, H)
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


def _lane_variant(kind, frontier, dtype, seed, scale=1.0 / 8.0,
                  serve=SERVE, H=16):
    """The dense pools' prefill lane as the engine runs it: one layer of a
    pool of ``serve``'s slots (``init_pool``; int8 codes and scales for
    ``kind`` "paged_q8"), every slot's plane filled (garbage past each
    frontier), viewed by ``slot_cache_view`` at slot LANE_SLOT: the planes
    as an arena of one plane-long page per slot and the table
    [[LANE_SLOT]]. K5 (K6) there against its plain version, and against K3
    (K4) on the slot's own plane bit for bit. The ``_variant`` dict."""
    slots, S = serve["max_slots"], serve["prefill_chunk"]
    T = plane_len_for(serve["max_len"], S)
    q8 = kind == "paged_q8"
    gcfg = generation.as_gencfg(GPT2Config(n_layer=1, n_head=H,
                                           n_embd=64 * H, dtype=dtype))
    pool = init_pool(gcfg, slots, serve["max_len"], slack=S, device="cuda",
                     hier=HierarchySpec(int8=q8))
    q, k, v, pos = _case(slots, S, [frontier] * slots, dtype, seed, T, H)
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
    return {"q": q, "pos": pos, "T": T, "kv": kv, "q8": q8,
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
    rows["fleet_shapes"] = _fleet_shape_rows()
    return rows


def phase_tp_kernels():
    """K3 and K5 at a tensor-parallel model rank's shapes, bf16: GPT-2
    medium's 16 heads over MP_RANKS ranks (H8), K3 on the decode rows (B16
    S1, DECODE_POS), K5 on B16 S1 through pages of PAGE_LEN and on the
    dense pool's prefill lane (frontier 500); each against its plain
    version and its dense twin, timed beside its bound and SDPA on the
    same (gathered) planes with a bool mask. Returns {kind: rows}."""
    H, dtype, scale = 16 // MP_RANKS, torch.bfloat16, 1.0 / 8.0
    cases = [("decode", "K3", "tp_rank_decode",
              lambda seed: _variant("decode", 16, 1, DECODE_POS, dtype, seed,
                                    H=H)),
             ("paged", "K5", "tp_rank_paged_decode",
              lambda seed: _variant("paged", 16, 1, DECODE_POS, dtype, seed,
                                    H=H)),
             ("paged", "K5", "tp_rank_dense_prefill_lane",
              lambda seed: _lane_variant("paged", 500, dtype, seed, H=H))]
    out = {}
    for seed, (kind, label, name, make) in enumerate(cases):
        c = make(600 + seed)
        q, pos = c["q"], c["pos"]
        frontiers = pos.tolist()
        row = dict(case=name, B=int(q.shape[0]), H=H, S=int(q.shape[2]),
                   T=c["T"], pos=frontiers,
                   **_decode_check(label, c, dtype, frontiers))
        if not row["ok"]:
            print(label + " " + json.dumps(row))
            fail("{} disagrees with its plain version or its dense twin at "
                 "{}".format(label, name))
        k, v = c["kv"]
        S, T = q.shape[2], k.shape[2]
        mask = (torch.arange(T, device="cuda")[None, None, :] <=
                (pos[:, None, None].long() +
                 torch.arange(S, device="cuda")[None, :, None]))[:, None]
        row["ms"] = cuda_ms(c["kernel"])
        row["plain_ms"] = cuda_ms(c["plain"])
        row["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale))
        row["bound_ms"], row["bound_by"] = _bound(
            q, pos, c["T"], c["key_bytes"], c["extra"])
        out.setdefault(kind, []).append(row)
        print(label + " " + json.dumps(row))
        del c
    return out


def _fleet_shape_rows():
    """The decode kernels at the fleet phases' shapes (FLEET_SERVE: 8
    slots, a plane of FLEET_PLANE positions, verify at S FLEET_VERIFY_S,
    prefill lanes of 16), bf16, against their plain versions (and K5/K6
    against their dense twins): K3 in the decode and verify lanes, K5 in
    the dense pools' prefill lane, K6 in the paged int8 pass's decode,
    verify and prefill lanes; timed at frontier 500 (the lane) and at the
    decode and verify frontier sets. Returns {kind: rows}."""
    B, S_lane = FLEET_SERVE["max_slots"], FLEET_SERVE["prefill_chunk"]
    dtype = torch.bfloat16
    cases = [("decode", "K3", "fleet_decode", B, 1, FLEET_DECODE_POS),
             ("decode", "K3", "fleet_verify", B, FLEET_VERIFY_S,
              FLEET_VERIFY_POS),
             ("paged_q8", "K6", "fleet_paged_decode", B, 1,
              FLEET_DECODE_POS),
             ("paged_q8", "K6", "fleet_paged_verify", B, FLEET_VERIFY_S,
              FLEET_VERIFY_POS)]
    cases += [("paged_q8", "K6", "fleet_paged_prefill_lane", 1, S_lane, [p])
              for p in FLEET_LANE_POS]
    out = {}
    for seed, (kind, label, name, Bc, S, frontiers) in enumerate(cases):
        c = _variant(kind, Bc, S, frontiers, dtype, seed=300 + seed,
                     page_len=FLEET_PAGED["kv_page_len"], serve=FLEET_SERVE)
        out.setdefault(kind, []).append(_fleet_shape_row(
            label, name, c, dtype, frontiers, S))
    for seed, p in enumerate(FLEET_LANE_POS):
        c = _lane_variant("paged", p, dtype, seed=400 + seed,
                          serve=FLEET_SERVE)
        out.setdefault("paged", []).append(_fleet_shape_row(
            "K5", "fleet_dense_prefill_lane_slot{}".format(LANE_SLOT), c,
            dtype, [p], S_lane))
    return out


def _fleet_shape_row(label, name, c, dtype, frontiers, S):
    row = dict(case=name, B=int(c["q"].shape[0]), S=S, T=c["T"],
               pos=frontiers, **_decode_check(label, c, dtype, frontiers))
    if not row["ok"]:
        print(label + " " + json.dumps(row))
        fail("{} disagrees with its plain version or its dense twin at the "
             "fleet's shape {}".format(label, name))
    if len(frontiers) > 1 or frontiers == [500]:
        row["ms"] = cuda_ms(c["kernel"])
        row["plain_ms"] = cuda_ms(c["plain"])
        row["bound_ms"], row["bound_by"] = _bound(
            c["q"], c["pos"], c["T"], c["key_bytes"], c["extra"])
    print(label + " " + json.dumps(row))
    return row


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
    pool, TELEMETRY_REQUESTS of phase_serve's stream; K3 and K5): two
    engines,
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
    prompts = _prompts(TELEMETRY_REQUESTS, cfg.vocab_size, seed=0)
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


def _resilience_submit(engine, prompts):
    """The recovery invariant's mixed stream (RESILIENCE_POOLS): every
    fourth request opted out of speculation, every third sampled, the
    first of those with top-k. Returns the requests and each one's
    sampling parameters (None for greedy) for the gap rule."""
    reqs, sampling = [], []
    for i, p in enumerate(prompts):
        kw = {"spec_decode": False} if i % 4 == 0 else {}
        samp = None
        if i % 3 == 2:
            samp = (0.8, 50 if i == 2 else 0, i)
            kw.update(temperature=samp[0], top_k=samp[1] or None,
                      seed=samp[2])
        reqs.append(engine.submit(p, max_new_tokens=NEW_TOKENS, **kw))
        sampling.append(samp)
    return reqs, sampling


def _resilience_run(engine, prompts, kind, label):
    """The mixed stream on ``engine`` to idle; with ``kind``, a fault of
    that kind armed once a request decodes, firing at the next step. The
    decode kernels' launches and the engine's counters are read over the
    run. Returns the requests, their sampling, and the run's facts."""
    engine.metrics(reset=True)
    replays0 = engine.graph_replays
    log0 = len(engine.recovery_log)
    addrs = {name: t.data_ptr() for name, t in engine._pool.items()}
    torch.cuda.synchronize()
    da.reset_launches()
    t0 = time.perf_counter()
    reqs, sampling = _resilience_submit(engine, prompts)
    fault_lane, delivered = False, 0
    if kind is not None:
        while not any(r.phase == "decoding" for r in reqs):
            engine.step()
        # Every request holds a slot by now (RESILIENCE_REQUESTS <= the
        # slots), so the faulted step has a prefill lane iff one prefills;
        # it delivers no token.
        fault_lane = any(r.phase == "prefilling" for r in reqs)
        delivered = sum(len(r.tokens) for r in reqs)
        engine.inject_faults(FaultPlan(faults=(Fault(kind, step=0),)))
    while not engine.idle:
        engine.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(da.launches)
    m = engine.metrics()
    lost = [r.rid for r in reqs if r.phase != "done" or
            len(r.tokens) != NEW_TOKENS]
    if lost:
        fail("resilience {} {}: requests {} lost or short".format(
            label, kind, lost))
    moved = [name for name, t in engine._pool.items()
             if t.data_ptr() != addrs[name]]
    if moved:
        fail("resilience {} {}: pool tensors rebound: {}".format(
            label, kind, moved))
    # A nan step ran its program (its harvest was discarded, uncounted);
    # a raise step ran none.
    ran = kind == "nan"
    return reqs, sampling, {
        "wall_s": wall, "launches": launches, "metrics": m,
        "recoveries": engine.recovery_log[log0:],
        "programs_run": engine.graph_replays - replays0,
        "tokens_delivered_before_fault": delivered,
        "extra_decode_steps": engine.config.chunk_size if ran else 0,
        "extra_lanes": int(ran and fault_lane)}


def _resilience_invariant(model, label, extra, kernel, lane_kernel):
    """Part (i) of phase_resilience on one pool: a fault-free run of the
    mixed stream (it meets the keys; then mark_warm()), then one run per
    fault kind on the same engine, each held to the fault-free run."""
    cfg = model.config
    engine = init_inference(model, config=dict(
        SERVE, fault_injection=True, **extra))
    prompts = _tiled_prompts(RESILIENCE_REQUESTS, cfg.vocab_size, seed=7)
    ref, sampling, clean = _resilience_run(engine, prompts, None, label)
    engine.recompile_detector.mark_warm()
    programs = engine.compile_count
    out = {}
    for kind in RESILIENCE_KINDS:
        reqs, _, facts = _resilience_run(engine, prompts, kind, label)
        m, recs = facts["metrics"], facts["recoveries"]
        what = "resilience {} {}".format(label, kind)
        if len(recs) != 1 or sum(r.replays for r in reqs) != \
                recs[0]["replayed"] or m["recoveries"] != 1 or \
                m["faults_injected"] != 1:
            fail("{}: recoveries {}, replays {}, metrics {}".format(
                what, recs, [r.replays for r in reqs],
                {k: m[k] for k in ("recoveries", "faults_injected",
                                   "requests_replayed")}))
        if engine.compile_count != programs or m["recompiles"] or \
                facts["programs_run"] != m["chunks"] + (kind == "nan"):
            fail("{}: compile_count {} (fault-free {}), recompiles {}, "
                 "programs replayed {} over {} harvested steps".format(
                     what, engine.compile_count, programs, m["recompiles"],
                     facts["programs_run"], m["chunks"]))
        stats = engine.kv_page_stats()
        if (stats is not None and stats["pages_in_use"]) or \
                engine.health != "healthy":
            fail("{}: pages {} in use, health {}".format(
                what, stats and stats["pages_in_use"], engine.health))
        want = dict.fromkeys(facts["launches"], 0)
        want[kernel] += cfg.n_layer * (m["decode_steps"] +
                                       facts["extra_decode_steps"])
        want[lane_kernel] += cfg.n_layer * (m["prefill_lanes"] +
                                            facts["extra_lanes"])
        if facts["launches"] != want:
            fail("{}: decode kernel launches {} != {}".format(
                what, facts["launches"], want))
        matched = []
        for p, got, want_r, samp in zip(prompts, reqs, ref, sampling):
            _held_to(model, p, got.tokens, want_r.tokens,
                     "{} request {}".format(what, got.rid), samp)
            matched.append(next((i for i, (a, b) in enumerate(
                zip(got.tokens, want_r.tokens)) if a != b), NEW_TOKENS))
        out[kind] = {
            "recovery_ms": recs[0]["duration_s"] * 1e3,
            "error": recs[0]["error"].split(":")[0],
            "replayed": recs[0]["replayed"],
            "tokens_delivered_before_fault":
                facts["tokens_delivered_before_fault"],
            "replay_fallbacks": sum(r.folded > 0 for r in reqs),
            "tokens_matched": matched,
            "streams_identical": sum(t == NEW_TOKENS for t in matched),
            "launches": facts["launches"], "steps": m["chunks"],
            "wall_s": facts["wall_s"]}
    line = {"pool": label, "kernel": kernel, "lane_kernel": lane_kernel,
            "fault_free": {"steps": clean["metrics"]["chunks"],
                           "wall_s": clean["wall_s"]},
            "compile_count": programs,
            "program_keys": [list(k) for k in sorted(engine._programs)],
            "kinds": out}
    del engine
    return line


def _recovered_graph_vs_eager(model, label, extra):
    """Part (ii): a graph-served engine and the same program run eagerly
    through the same history (phase_graph_vs_eager's mix, a raise fault
    once a request decodes, the recovery), then GRAPH_CHECK_STEPS more
    steps: every harvest, and the pool after them, bit for bit (with that
    phase's trash-page exception for a speculating paged pool)."""
    cfg = model.config
    spec = "spec_decode" in extra
    prompts = (_tiled_prompts if spec else _prompts)(
        GRAPH_CHECK_REQUESTS, cfg.vocab_size, seed=3)
    conf = dict(SERVE, fault_injection=True, **extra)
    runs = []
    for engine in (init_inference(model, config=conf),
                   _EagerEngine(model, config=conf)):
        reqs = []
        for i, p in enumerate(prompts):
            kw = {"temperature": 0.8, "seed": i,
                  "top_k": 50 if i == 2 else None} if i % 3 == 2 else {}
            if spec and i % 4 == 1:
                kw["spec_decode"] = False
            reqs.append(engine.submit(p, max_new_tokens=NEW_TOKENS, **kw))
        while not any(r.phase == "decoding" for r in reqs):
            engine.step()
        engine.inject_faults(FaultPlan(faults=(Fault("raise", step=0),)))
        engine.step()
        if len(engine.recovery_log) != 1:
            fail("graph_vs_eager after recovery {}: no recovery".format(
                label))
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
                fail("graph_vs_eager after recovery {}: step {}: {} "
                     "differs".format(label, step, name))
    diffs = _pool_diffs(graphed, eager, spec, label)
    m = graphed.metrics()
    if graphed.graph_replays != m["chunks"] - graphed.compile_count:
        fail("graph_vs_eager after recovery {}: graph_replays {} over {} "
             "steps, compile_count {}".format(
                 label, graphed.graph_replays, m["chunks"],
                 graphed.compile_count))
    return {"layout": label, "steps": GRAPH_CHECK_STEPS,
            "replayed": graphed.recovery_log[0]["replayed"],
            "compile_count": graphed.compile_count,
            "tokens_compared": int(sum(s["valid"].sum() for s in got)),
            "harvests_identical": True, "pool_differs": diffs}


def _resilience_detection(model):
    """Part (iii): a STALL_S stall under a STALL_BUDGET_S watchdog on the
    dense pool gives ``degraded``, one clean step ``healthy``, and counts
    a stall. The warm-up's captures may trip the budget themselves: their
    stalls are reported, not failed."""
    cfg = model.config
    engine = init_inference(model, config=dict(
        SERVE, fault_injection=True, step_budget_s=STALL_BUDGET_S))
    chunk = SERVE["chunk_size"]
    engine.generate([np.arange(1, 9), np.arange(9, 17)],
                    max_new_tokens=2 * chunk)
    warm = engine.metrics(reset=True)
    engine.generate([np.arange(1, 9)], max_new_tokens=chunk)
    healthy_after_warm = engine.health
    prompts = _prompts(2, cfg.vocab_size, seed=11)
    reqs = [engine.submit(p, max_new_tokens=2 * chunk) for p in prompts]
    engine.inject_faults(FaultPlan(faults=(
        Fault("stall", step=0, stall_s=STALL_S),)))
    t0 = time.perf_counter()
    engine.step()
    stalled_s = time.perf_counter() - t0
    after_stall = engine.health
    engine.step()
    after_clean = engine.health
    engine.run()
    m = engine.metrics()
    if after_stall != "degraded" or after_clean != "healthy" or \
            m["step_stalls"] < 1 or not all(r.done for r in reqs):
        fail("resilience detection: health {} after the stall, {} after "
             "a clean step, {} stalls".format(after_stall, after_clean,
                                              m["step_stalls"]))
    engine.close()
    return {"budget_s": STALL_BUDGET_S, "stall_s": STALL_S,
            "stalled_step_s": stalled_s, "step_stalls": m["step_stalls"],
            "warmup_step_stalls": warm["step_stalls"],
            "warmup_capture_ms": warm["capture_ms"],
            "health_after_warmup": healthy_after_warm,
            "health_after_stall": after_stall,
            "health_after_clean_step": after_clean}


def _resilience_bounds(model):
    """Part (iv): at recovery_max_retries 1, a raise lasting
    DEAD_FAULT_STEPS steps ends the engine: EngineDeadError chained to
    InjectedFault, then submit, step, drain and undrain refuse; close()
    twice is fine."""
    cfg = model.config
    engine = init_inference(model, config=dict(
        SERVE, fault_injection=True, recovery_max_retries=1))
    p = _prompts(1, cfg.vocab_size, seed=13)[0]
    engine.submit(p, max_new_tokens=8)
    engine.inject_faults(FaultPlan(faults=(
        Fault("raise", step=0, duration_steps=DEAD_FAULT_STEPS),)))
    try:
        engine.run()
        fail("resilience bounds: a persistent fault did not end the engine")
    except EngineDeadError as exc:
        cause = type(exc.__cause__).__name__
        if not isinstance(exc.__cause__, InjectedFault):
            fail("resilience bounds: EngineDeadError from {}".format(cause))
    refused = []
    for name, call in (("submit", lambda: engine.submit(p)),
                       ("step", engine.step), ("drain", engine.drain),
                       ("undrain", engine.undrain)):
        try:
            call()
        except EngineDeadError:
            refused.append(name)
    if len(refused) != 4 or engine.health != "dead":
        fail("resilience bounds: a dead engine accepted {}".format(
            sorted({"submit", "step", "drain", "undrain"} - set(refused))))
    engine.close()
    engine.close()
    return {"max_retries": 1, "fault_steps": DEAD_FAULT_STEPS,
            "cause": cause, "recoveries": len(engine.recovery_log),
            "refused": refused, "health": engine.health}


def _resilience_cancel_drain(model):
    """Part (v): on graph-served paged int8 engines (K6), cancel one
    decoding request: it keeps its tokens and stops emitting, the other
    streams equal the run without the cancel (gap rule), every page comes
    back. Then drain() with queued work settles idle under ``draining``,
    submit() raises EngineDraining, undrain() reopens."""
    cfg = model.config
    conf = dict(SERVE, int8_kv=True, **PAGED)
    prompts = _prompts(GRAPH_CHECK_REQUESTS, cfg.vocab_size, seed=17)
    streams = []
    for cancel in (False, True):
        engine = init_inference(model, config=conf)
        reqs = [engine.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
        victim = reqs[0]
        while len(victim.tokens) < 2:
            engine.step()
        kept = None
        if cancel:
            if not engine.cancel(victim) or engine.cancel(victim):
                fail("resilience cancel: cancel() did not return True, "
                     "then False")
            kept = list(victim.tokens)
        engine.run()
        if cancel and (victim.tokens != kept or victim.phase != "cancelled"):
            fail("resilience cancel: the cancelled request went on "
                 "emitting ({} -> {} tokens)".format(len(kept),
                                                     len(victim.tokens)))
        stats = engine.kv_page_stats()
        if stats["pages_in_use"] or engine._pager.outstanding():
            fail("resilience cancel: {} pages in use, {} reserved".format(
                stats["pages_in_use"], engine._pager.outstanding()))
        streams.append([r.tokens for r in reqs])
        if not cancel:
            del engine
    identical = 0
    for i, (p, a, b) in enumerate(zip(prompts[1:], streams[0][1:],
                                      streams[1][1:])):
        identical += _held_to(model, p, b, a,
                              "cancel: request {}".format(i + 1))
    # Drain with queued work on the engine that served the cancel.
    queued = [engine.submit(p, max_new_tokens=NEW_TOKENS // 4)
              for p in prompts + prompts]
    done = engine.drain()
    health = engine.health
    try:
        engine.submit(prompts[0])
        fail("resilience drain: submit() accepted while draining")
    except EngineDraining:
        pass
    if not engine.idle or health != "draining" or \
            {r.rid for r in done} != {r.rid for r in queued}:
        fail("resilience drain: idle {}, health {}, {} of {} done".format(
            engine.idle, health, len(done), len(queued)))
    engine.undrain()
    again = engine.submit(prompts[0], max_new_tokens=4)
    engine.run()
    if not again.done or engine.health != "healthy":
        fail("resilience drain: undrain() did not reopen the engine")
    return {"cancelled_after_tokens": len(streams[1][0]),
            "streams_identical_to_uncancelled": identical,
            "others": len(prompts) - 1, "drained": len(done),
            "health_while_drained": health}


def phase_resilience(card, model):
    """Crash-only resilience on the serving path at full width (module
    docstring, phase 4c): (i) the recovery invariant on each of
    RESILIENCE_POOLS and RESILIENCE_KINDS; (ii) a recovered graph-served
    engine against the eager program; (iii) stall detection; (iv) the
    retry bound; (v) cancel and drain. Prints one ``resilience`` line."""
    pools = [_resilience_invariant(model, *pool) for pool in RESILIENCE_POOLS]
    gve = [_recovered_graph_vs_eager(model, label, extra)
           for label, extra, _, _ in RESILIENCE_POOLS]
    line = {"resilience": "gpt2-medium bf16, {} layers".format(
                model.config.n_layer), "serve_cfg": SERVE,
            "requests": RESILIENCE_REQUESTS, "new_tokens": NEW_TOKENS,
            "pools": pools, "graph_vs_eager_after_recovery": gve,
            "detection": _resilience_detection(model),
            "bounds": _resilience_bounds(model),
            "cancel_drain": _resilience_cancel_drain(model), "card": card}
    print("resilience " + json.dumps(line))
    return line


def phase_chaos(card, model):
    """The chaos run (CHAOS_SERVE, CHAOS_LOAD): GPT-2 medium bf16 over a
    dense pool (K3, prefill lane K5), warmed on both greedy keys, marked
    warm, then driven open loop by loadgen's SustainedRunner with one
    raise fault armed at CHAOS_AFTER_S. Fails unless the fault fired, the
    engine recovered, no request was lost, the recovery time is finite,
    the engine ends healthy, no graph was captured after warm-up, and the
    decode kernels' launches are n_layer x the run's decode steps (K3)
    and prefill lanes (K5). Prints the report's ``chaos`` section."""
    cfg = model.config
    engine = init_inference(model, config=dict(CHAOS_SERVE))
    chunk = CHAOS_SERVE["chunk_size"]
    engine.generate([np.arange(1, 9), np.arange(9, 17)],
                    max_new_tokens=2 * chunk)
    if engine.compile_count != 2:
        fail("chaos: the warm-up met keys {}".format(sorted(engine._programs)))
    engine.recompile_detector.mark_warm()
    engine.metrics(reset=True)
    spec = WorkloadSpec(**CHAOS_LOAD)
    plan = FaultPlan(faults=(Fault("raise", step=2),))
    c0, lanes0 = engine.counters["chunks"], engine._lane_steps.value
    torch.cuda.synchronize()
    da.reset_launches()
    res = SustainedRunner(engine, spec, window_seconds=CHAOS_WINDOW_S,
                          max_steps=500_000, chaos_plan=plan,
                          chaos_after_s=CHAOS_AFTER_S).run()
    torch.cuda.synchronize()
    launches = dict(da.launches)
    want = dict.fromkeys(launches, 0)
    want["decode"] += cfg.n_layer * (engine.counters["chunks"] - c0) * chunk
    want["paged"] += cfg.n_layer * int(engine._lane_steps.value - lanes0)
    report = build_report(spec, res, CHAOS_SLO, platform="gpu",
                          extra={"model": "gpt2-medium bf16",
                                 "serve_cfg": dict(CHAOS_SERVE),
                                 "card": card})
    chaos, agg = report["chaos"], report["aggregate"]
    post = engine.metrics()
    line = {"chaos": "gpt2-medium bf16, dense pool",
            "serve_cfg": CHAOS_SERVE,
            "workload": {k: CHAOS_LOAD[k] for k in (
                "arrival", "rate", "n_requests", "prompt_mean",
                "output_mean", "seed")},
            "fault": {"kind": "raise", "step": 2,
                      "armed_after_s": CHAOS_AFTER_S},
            "recovery_time_s": chaos["recovery_time_s"],
            "recoveries": chaos["recoveries"],
            "faults_injected": chaos["faults_injected"],
            "requests_lost": chaos["requests_lost"],
            "requests_replayed": sum(r["replayed"] for r in res.recovery),
            "recovery_intervals": chaos["recovery_intervals"],
            "requests_during_recovery": chaos["requests_during_recovery"],
            "slo": CHAOS_SLO.to_json(),
            "slo_attainment_during_recovery":
                chaos["slo_attainment_during_recovery"],
            "slo_attainment_outside_recovery":
                chaos["slo_attainment_outside_recovery"],
            "slo_attainment": agg["slo_attainment"],
            "ttft_p50_ms": agg["ttft_p50_ms"],
            "ttft_p99_ms": agg["ttft_p99_ms"],
            "itl_p99_ms": agg["itl_p99_ms"],
            "tokens_per_sec": agg["tokens_per_sec"],
            "submitted": agg["submitted"], "completed": agg["completed"],
            "shed": agg["shed"], "wall_s": agg["wall_s"],
            "compile_count": post["compile_count"],
            "recompiles": post["recompiles"], "health": engine.health,
            "launches": launches, "card": card}
    print("chaos " + json.dumps(line))
    if chaos["faults_injected"] < 1 or chaos["recoveries"] < 1 or \
            chaos["requests_lost"] or \
            not math.isfinite(chaos["recovery_time_s"]) or \
            engine.health != "healthy" or not engine.idle or \
            post["compile_count"] != 2 or post["recompiles"]:
        fail("chaos: the recovery invariant does not hold (line above)")
    if launches != want:
        fail("chaos: launches {} != {}".format(launches, want))
    return line


def _hier_prompts(vocab, seed):
    """The hierarchy stream: HIER_REQUESTS prompts, request i the shared
    HIER_SYSTEM-token system prompt i % HIER_PROMPTS followed by its own
    random tail of HIER_TAILS tokens."""
    rng = np.random.RandomState(seed)
    systems = [rng.randint(0, vocab, size=HIER_SYSTEM)
               for _ in range(HIER_PROMPTS)]
    return [np.concatenate([systems[i % HIER_PROMPTS], rng.randint(
        0, vocab, size=rng.randint(HIER_TAILS[0], HIER_TAILS[1] + 1))])
        for i in range(HIER_REQUESTS)]


class _HierProbe(object):
    """Watches one engine's hierarchy: which admissions hit the prefix
    store, and every swap-out capture and swap-in restore with its bytes
    and its device time (CUDA events around the copies; a capture waits
    for its copies, a restore is timed after the step that waited)."""

    def __init__(self, engine):
        self.hits, self.captures, self.restores = {}, [], []
        hier, probe = engine._hier, self
        on_admit = hier.on_admit
        capture = engine._capture_slot_record
        restore = engine._restore_slot_record

        def admit(pool, req, slot):
            on_admit(pool, req, slot)
            probe.hits[req.rid] = req.cursor > 0

        def timed(kind, fn, *args):
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            marks[0].record()
            out = fn(*args)
            marks[1].record()
            rec = out if kind is probe.captures else args[2]
            kind.append((marks, sum(v.nbytes for v in rec.values()),
                         out is not False))
            return out

        hier.on_admit = admit
        engine._capture_slot_record = lambda slot: timed(
            probe.captures, capture, slot)
        engine._restore_slot_record = lambda slot, req, rec: timed(
            probe.restores, restore, slot, req, rec)

    def transfers(self):
        """ms p50/p99, bytes per record and GB/s (median bytes over
        median ms) of the swap-outs and swap-ins that ran."""
        torch.cuda.synchronize()
        out = {}
        for name, rows in (("swap_out", self.captures),
                           ("swap_in", self.restores)):
            ms = [a.elapsed_time(b) for (a, b), _, ran in rows if ran]
            nbytes = [n for _, n, ran in rows if ran]
            med = _pct(ms, 50)
            out[name] = {"n": len(ms), "ms_p50": med,
                         "ms_p99": _pct(ms, 99),
                         "bytes_p50": _pct(nbytes, 50),
                         "gb_per_s": (_pct(nbytes, 50) / med / 1e6
                                      if ms and med else None)}
        return out


def _hier_submit(engine, prompts):
    """Submit the hierarchy stream, every sixth request sampled (top-k
    50); returns the requests and each one's sampling (None: greedy)."""
    reqs, sampling = [], []
    for i, p in enumerate(prompts):
        samp = (0.8, 50, i) if i % 6 == 5 else None
        kw = {} if samp is None else {"temperature": samp[0],
                                      "top_k": samp[1], "seed": samp[2]}
        reqs.append(engine.submit(p, max_new_tokens=NEW_TOKENS, **kw))
        sampling.append(samp)
    return reqs, sampling


def _hier_run(engine, prompts, label, kernel, lane_kernel, fault=False,
              roundtrip=False):
    """The hierarchy stream to idle on ``engine``: the decode kernels'
    launches and the counters over the run, the pool's addresses before
    and after; ``fault``: a raise armed once a session is swapped out;
    ``roundtrip``: the byte-exact capture/restore check on the live pool
    once every slot is busy (``_roundtrip``). Fails on a lost request,
    launches off n_layer x decode steps (``kernel``) and prefill lanes
    (``lane_kernel``), a rebound pool tensor or a graph captured for a key
    met before."""
    cfg = engine._params.config
    engine.metrics(reset=True)
    replays0, programs0 = engine.graph_replays, engine.compile_count
    addrs = {name: t.data_ptr() for name, t in engine._pool.items()}
    met, new_keys, run_program = set(), set(), engine._run_program

    def run(key):
        # The keys this run's steps met, and those met for the first time.
        met.add(key)
        if key not in engine._programs:
            new_keys.add(key)
        run_program(key)

    engine._run_program = run
    torch.cuda.synchronize()
    da.reset_launches()
    t0 = time.perf_counter()
    reqs, sampling = _hier_submit(engine, prompts)
    checked, swapped_at_fault = None, None
    while not engine.idle:
        sched = engine._scheduler
        if fault and sched.swapped and swapped_at_fault is None:
            swapped_at_fault = len(sched.swapped)
            engine.inject_faults(FaultPlan(faults=(Fault("raise",
                                                         step=0),)))
        if roundtrip and checked is None and \
                len(sched.running) == SERVE["max_slots"] and \
                any(r.phase == "decoding" for r in sched.running.values()):
            checked = _roundtrip(engine, label)
        engine.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del engine._run_program
    launches = dict(da.launches)
    m = engine.metrics()
    lost = [r.rid for r in reqs
            if r.phase != "done" or len(r.tokens) != NEW_TOKENS]
    if lost:
        fail("hierarchy {}: requests {} lost or short".format(label, lost))
    want = dict.fromkeys(launches, 0)
    want[kernel] += cfg.n_layer * m["decode_steps"]
    want[lane_kernel] += cfg.n_layer * m["prefill_lanes"]
    if launches != want:
        fail("hierarchy {}: decode kernel launches {} != {}".format(
            label, launches, want))
    moved = [n for n, t in engine._pool.items() if t.data_ptr() != addrs[n]]
    replays = engine.graph_replays - replays0
    new = engine.compile_count - programs0
    # Every capture is a key met for the first time: no hit, swap, copy
    # or recovery captured a graph or added a key.
    if moved or new != len(new_keys) or replays + new != m["chunks"] or \
            not met <= set(engine._programs) or \
            m["compile_count"] > MAX_PROGRAMS:
        fail("hierarchy {}: pool tensors rebound {}, {} steps = {} replays "
             "+ {} captures, keys met {} (new {}), programs {}".format(
                 label, moved, m["chunks"], replays, new, sorted(met),
                 sorted(new_keys), sorted(engine._programs)))
    if roundtrip and not checked:
        fail("hierarchy {}: the round trip never ran".format(label))
    if fault and swapped_at_fault is None:
        fail("hierarchy {}: no session was ever swapped out".format(label))
    return reqs, sampling, {"wall_s": wall, "launches": launches,
                            "metrics": m, "captures": new,
                            "keys_met": [list(k) for k in sorted(met)],
                            "roundtrip": checked,
                            "swapped_at_fault": swapped_at_fault}


def _roundtrip(engine, label):
    """(iii): capture a decoding slot's record, scribble over its
    footprint (planes or live pages, scales, ring, every per-slot field),
    restore it in place; the whole pool must equal a copy taken before,
    byte for byte, and the run goes on. Returns what was checked."""
    pool = engine._pool
    req = next(r for r in engine._scheduler.running.values()
               if r.phase == "decoding")
    slot, pager = req.slot, engine._pager
    pages = pager.row_pages(slot) if pager is not None else None
    before = {name: t.clone() for name, t in pool.items()}
    record = capture_slot(pool, slot) if pages is None else \
        capture_slot_paged(pool, slot, pages)
    at = slot if pages is None else pages
    for name in ("k", "v", "k_scale", "v_scale"):
        if name in pool:
            pool[name][:, at] = 0
    for name in ("pos", "last_tok", "active", "remaining", "eos", "temp",
                 "top_k", "seed", "spec", "toks"):
        if name in pool:
            pool[name][slot] = 0
    if pages is None:
        restore_slot(pool, slot, record)
    else:
        restore_slot_paged(pool, slot, record, pages)
    torch.cuda.synchronize()
    differ = [name for name, t in pool.items()
              if not torch.equal(t, before[name])]
    if differ:
        fail("hierarchy {}: capture/restore of slot {} changed {}".format(
            label, slot, differ))
    del before
    torch.cuda.empty_cache()
    return {"slot": slot, "pages": len(pages) if pages else None,
            "record_bytes": sum(v.nbytes for v in record.values()),
            "pool_tensors_equal": len(pool)}


def _held_streams(model, prompts, got, ref, sampling, what):
    """Phase 5's rule over two runs' requests (sampled ones over their
    Gumbel-max scores); returns how many are bit-equal."""
    return sum(_held_to(model, p, a.tokens, b.tokens,
                        "{} request {}".format(what, a.rid), samp)
               for p, a, b, samp in zip(prompts, got, ref, sampling))


def _ttft_hit_miss(reqs, probe):
    """TTFT p50 of the requests whose admission hit the prefix store and
    of those that missed, and of the part of it spent in a slot (admit ->
    first token: the prefill lanes), which queue waits do not blur."""
    out = {}
    for hit, name in ((True, "hit"), (False, "miss")):
        rs = [r for r in reqs if probe.hits.get(r.rid, False) == hit]
        out[name] = {
            "n": len(rs),
            "ttft_p50_ms": _pct([(r.first_token_time - r.submit_time) * 1e3
                                 for r in rs], 50),
            "admit_to_first_p50_ms": _pct(
                [(r.first_token_time - r.admit_time) * 1e3 for r in rs],
                50)}
    return out


def _hier_facts(m):
    return {key: m[key] for key in (
        "prefix_hits", "prefix_misses", "prefix_inserts", "prefix_evictions",
        "prefix_hit_rate", "swap_outs", "swap_ins", "effective_slots",
        "kv_bytes_per_slot", "prefix_store_bytes", "steps", "chunks",
        "prefill_lanes", "decode_steps", "compile_count") if key in m}


def phase_hierarchy(card, model):
    """The KV hierarchy on the serving path at full width (HIER on SERVE,
    the stream of ``_hier_prompts``): (i) dense bf16 with the tiers on and
    off, (ii) the JAX bench default (paged int8 + prefix + offload +
    speculation) against dense int8 with the same tiers, (iii) the
    capture/restore round trip on both live pools, (iv) a raise while
    sessions are swapped out, (v) graph against eager after hits and
    swaps; prints one ``hierarchy`` line with the swap and TTFT timings
    (vi)."""
    cfg = model.config
    prompts = _hier_prompts(cfg.vocab_size, seed=5)
    line = {"hierarchy": "gpt2-medium bf16, {} layers".format(cfg.n_layer),
            "serve_cfg": dict(SERVE, **HIER),
            "stream": "{} requests over {} shared {}-token system prompts, "
                      "tails {}-{}, {} new tokens, every sixth sampled"
                      .format(HIER_REQUESTS, HIER_PROMPTS, HIER_SYSTEM,
                              HIER_TAILS[0], HIER_TAILS[1], NEW_TOKENS),
            "card": card}
    # (i) dense bf16, the tiers on and off.
    off = init_inference(model, config=dict(SERVE))
    ref, sampling, f_off = _hier_run(off, prompts, "dense_off", "decode",
                                     "paged")
    del off
    on = init_inference(model, config=dict(SERVE, fault_injection=True,
                                           **HIER))
    probe = _HierProbe(on)
    got, _, f_on = _hier_run(on, prompts, "dense", "decode", "paged",
                             roundtrip=True)
    m_on, m_off = f_on["metrics"], f_off["metrics"]
    equal = _held_streams(model, prompts, got, ref, sampling, "dense")
    if min(m_on[k] for k in ("swap_outs", "swap_ins", "prefix_hits",
                             "prefix_inserts")) < 1 or \
            m_on["prefill_lanes"] >= m_off["prefill_lanes"]:
        fail("hierarchy dense: {} against {} prefill lanes off".format(
            _hier_facts(m_on), m_off["prefill_lanes"]))
    line["dense"] = dict(
        _hier_facts(m_on), wall_s=f_on["wall_s"],
        wall_s_off=f_off["wall_s"], prefill_lanes_off=m_off["prefill_lanes"],
        steps_off=m_off["chunks"], launches=f_on["launches"],
        launches_off=f_off["launches"],
        keys_met=f_on["keys_met"], keys_met_off=f_off["keys_met"],
        compile_count_off=m_off["compile_count"],
        streams_bit_equal=equal, streams=len(got),
        ttft_p50_ms=m_on["ttft_p50_ms"], ttft_p50_ms_off=m_off["ttft_p50_ms"],
        ttft=_ttft_hit_miss(got, probe), transfers=probe.transfers(),
        roundtrip=f_on["roundtrip"])
    # (iv) a raise while sessions are swapped out, on the same engine.
    on.recompile_detector.mark_warm()
    programs = on.compile_count
    again, _, f_fault = _hier_run(on, prompts, "dense_fault", "decode",
                                  "paged", fault=True)
    m_f = f_fault["metrics"]
    if len(on.recovery_log) != 1 or m_f["recoveries"] != 1 or \
            on.compile_count != programs or m_f["recompiles"] or \
            on.health != "healthy":
        fail("hierarchy dense_fault: recoveries {}, compile_count {} "
             "(before {}), recompiles {}, health {}".format(
                 on.recovery_log, on.compile_count, programs,
                 m_f["recompiles"], on.health))
    line["fault"] = {
        "replayed": on.recovery_log[0]["replayed"],
        "recovery_ms": on.recovery_log[0]["duration_s"] * 1e3,
        "swapped_at_fault": f_fault["swapped_at_fault"],
        "launches": f_fault["launches"],
        "streams_bit_equal": _held_streams(model, prompts, again, got,
                                           sampling, "dense_fault"),
        "compile_count": on.compile_count, **_hier_facts(m_f)}
    del on, probe
    gc.collect()
    torch.cuda.empty_cache()
    # (ii) the JAX bench default against dense int8 with the same tiers.
    streams = {}
    for label, extra, kernel in (("paged_int8_spec", PAGED, "paged_q8"),
                                 ("dense_int8_spec", {}, "q8")):
        engine = init_inference(model, config=dict(
            SERVE, int8_kv=True, **SPEC, **HIER, **extra))
        probe = _HierProbe(engine)
        reqs, _, facts = _hier_run(engine, prompts, label, kernel,
                                   "paged_q8", roundtrip=extra == PAGED)
        streams[label] = [r.tokens for r in reqs]
        stats = engine.kv_page_stats()
        line[label] = dict(_hier_facts(facts["metrics"]),
                           wall_s=facts["wall_s"],
                           launches=facts["launches"],
                           accepted_per_step_mean=facts["metrics"][
                               "accepted_per_step_mean"],
                           keys_met=facts["keys_met"],
                           transfers=probe.transfers(),
                           roundtrip=facts["roundtrip"])
        if stats is not None:
            line[label]["pages_in_use_after"] = stats["pages_in_use"]
        del engine, probe
        gc.collect()
        torch.cuda.empty_cache()
    differ = [i for i, (a, b) in enumerate(zip(streams["paged_int8_spec"],
                                               streams["dense_int8_spec"]))
              if a != b]
    line["paged_int8_equals_dense_int8"] = not differ
    if differ:
        print("hierarchy " + json.dumps(line))
        fail("hierarchy: paged int8 differs from dense int8 in requests "
             "{}".format(differ))
    # (v) graph against eager after hits and swaps.
    line["graph_vs_eager"] = [_hier_graph_vs_eager(model, prompts, label,
                                                   extra)
                              for label, extra in (
                                  ("dense", {}),
                                  ("paged_int8_spec", dict(
                                      PAGED, int8_kv=True, **SPEC)))]
    print("hierarchy " + json.dumps(line))
    return line


def _hier_graph_vs_eager(model, prompts, label, extra):
    """(v): a graph-served hierarchy engine and the same program run
    eagerly, HIER_GRAPH_STEPS steps of the hierarchy stream's first
    HIER_GRAPH_REQUESTS requests: every harvest
    and, after them, the whole pool bit for bit (phase_graph_vs_eager's
    exception for a speculating paged pool); the run must have hit the
    prefix store, swapped a session out and back in."""
    config = dict(SERVE, **HIER, **extra)
    runs = []
    for engine in (init_inference(model, config=config),
                   _EagerEngine(model, config=config)):
        _hier_submit(engine, prompts[:HIER_GRAPH_REQUESTS])
        snaps = []
        for _ in range(HIER_GRAPH_STEPS):
            engine.step()
            snaps.append(engine._last_snap)
        torch.cuda.synchronize()
        runs.append((engine, snaps))
    (graphed, got), (eager, want) = runs
    for step, (a, b) in enumerate(zip(got, want)):
        for name in a:
            if not np.array_equal(a[name], b[name]):
                fail("hierarchy graph_vs_eager {}: step {}: {} differs"
                     .format(label, step, name))
    diffs = _pool_diffs(graphed, eager, "spec_decode" in extra,
                        "hierarchy " + label)
    m = graphed.metrics()
    if min(m["prefix_hits"], m["swap_outs"], m["swap_ins"]) < 1 or \
            m["graph_replays"] != HIER_GRAPH_STEPS - m["compile_count"]:
        fail("hierarchy graph_vs_eager {}: {} in {} steps, graph_replays "
             "{}".format(label, _hier_facts(m), HIER_GRAPH_STEPS,
                         m["graph_replays"]))
    out = {"layout": label, "steps": HIER_GRAPH_STEPS,
           "requests": HIER_GRAPH_REQUESTS,
           "prefix_hits": m["prefix_hits"], "swap_outs": m["swap_outs"],
           "swap_ins": m["swap_ins"], "compile_count": m["compile_count"],
           "harvests_identical": True, "pool_differs": diffs}
    del graphed, eager, runs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_sustained_hier(card, model):
    """The JAX ``bench.py --sustained`` TPU setting in full
    (SUSTAINED_HIER_SERVE: the dense int8 pool with the prefix cache and
    host offload; K4, prefill lane K6) under the sustained run's arrivals
    (SUSTAINED_LOAD), warmed as phase_sustained's, then marked warm. Fails
    on a lost request, a recompile, launches off the run's decode steps
    and lanes, or a non-finite number."""
    cfg = model.config
    engine = init_inference(model, config=dict(SUSTAINED_HIER_SERVE))
    chunk = SUSTAINED_HIER_SERVE["chunk_size"]
    engine.generate([np.arange(1, 9), np.arange(9, 17)],
                    max_new_tokens=2 * chunk)
    engine.recompile_detector.mark_warm()
    engine.metrics(reset=True)
    c0, lanes0 = engine.counters["chunks"], engine._lane_steps.value
    torch.cuda.synchronize()
    da.reset_launches()
    spec = WorkloadSpec(**SUSTAINED_LOAD)
    res = SustainedRunner(engine, spec, window_seconds=SUSTAINED_WINDOW_S,
                          max_steps=500_000).run()
    torch.cuda.synchronize()
    launches = dict(da.launches)
    want = dict.fromkeys(launches, 0)
    want["q8"] += cfg.n_layer * (engine.counters["chunks"] - c0) * chunk
    want["paged_q8"] += cfg.n_layer * int(engine._lane_steps.value - lanes0)
    m = engine.metrics()
    agg = build_report(spec, res, SUSTAINED_SLO, platform="gpu",
                       extra={"card": card})["aggregate"]
    line = {"sustained_hier": "gpt2-medium bf16, dense int8 pool, prefix "
                              "cache and host offload",
            "serve_cfg": SUSTAINED_HIER_SERVE,
            "workload": {k: SUSTAINED_LOAD[k] for k in (
                "arrival", "rate", "n_requests", "prompt_mean",
                "output_mean", "prefix_pool", "prefix_tokens", "seed")},
            "submitted": agg["submitted"], "completed": agg["completed"],
            "shed": agg["shed"], "requests_lost": res.requests_lost,
            "wall_s": agg["wall_s"], "tokens_per_sec": agg["tokens_per_sec"],
            "goodput_tokens_per_sec": agg["goodput_tokens_per_sec"],
            "slo": SUSTAINED_SLO.to_json(),
            "slo_attainment": agg["slo_attainment"],
            "ttft_p50_ms": agg["ttft_p50_ms"],
            "ttft_p99_ms": agg["ttft_p99_ms"],
            "itl_p50_ms": agg["itl_p50_ms"], "itl_p99_ms": agg["itl_p99_ms"],
            "prefix_hit_rate": (res.prefix_hits / float(
                res.prefix_hits + res.prefix_misses) if
                res.prefix_hits + res.prefix_misses else None),
            "prefix_hits": res.prefix_hits,
            "prefix_misses": res.prefix_misses,
            "swap_outs": res.swap_outs, "swap_ins": res.swap_ins,
            "effective_slots": m["effective_slots"],
            "compile_count": m["compile_count"],
            "recompiles": m["recompiles"], "launches": launches,
            "card": card}
    print("sustained_hier " + json.dumps(line))
    if res.requests_lost or res.completed != res.submitted or \
            m["recompiles"] or not engine.idle:
        fail("sustained_hier: a request was lost or a key recompiled "
             "(line above)")
    if launches != want:
        fail("sustained_hier: launches {} != {}".format(launches, want))
    numbers = (agg["tokens_per_sec"], agg["goodput_tokens_per_sec"],
               agg["ttft_p50_ms"], agg["ttft_p99_ms"], agg["itl_p99_ms"])
    if not all(v is not None and math.isfinite(v) for v in numbers):
        fail("sustained_hier: a number is missing or not finite: {}".format(
            numbers))
    return line


# ------------------------------------------------------------ the fleet


def _fleet_requests(vocab):
    """The JAX ``--fleet-smoke`` stream (bench.py:1690-1704): request i is
    one of two shared FLEET_TEMPLATE-token templates with a 4-8 token
    tail, FLEET_NEW new tokens, greedy and sampled (temperature 0.7)
    alternating, every third opted out of speculation."""
    rng = np.random.RandomState(11)
    templates = rng.randint(0, vocab, size=(2, FLEET_TEMPLATE))
    return [{"prompt": np.concatenate([templates[i % 2], rng.randint(
                0, vocab, size=4 + i % 5)]),
             "max_new_tokens": FLEET_NEW,
             "temperature": 0.0 if i % 2 == 0 else 0.7,
             "seed": 1000 + i, "spec_decode": i % 3 != 0}
            for i in range(FLEET_REQUESTS)]


def _fleet_submit(target, reqs):
    return [target.submit(r["prompt"], max_new_tokens=r["max_new_tokens"],
                          temperature=r["temperature"], seed=r["seed"],
                          spec_decode=r["spec_decode"]) for r in reqs]


def _fleet_sampling(r):
    """``_held_to``'s sampling argument for one request of the stream."""
    return (r["temperature"], 0, r["seed"]) if r["temperature"] > 0 else None


def _warm_keys(engine, vocab):
    """Let ``engine`` meet every key of the fleet streams (prefill lane or
    not, any row sampling or not) on two requests of its own: a long
    greedy one and a shorter sampled one admitted with it, neither
    speculating (so each step emits chunk_size tokens and the order of
    the keys is fixed). Then mark it warm."""
    rng = np.random.RandomState(29)
    engine.submit(rng.randint(0, vocab, size=20), max_new_tokens=48,
                  spec_decode=False)
    engine.submit(rng.randint(0, vocab, size=20), max_new_tokens=20,
                  temperature=0.7, seed=5, spec_decode=False)
    engine.run()
    if sorted(engine._programs) != FLEET_KEYS:
        fail("fleet: the warm-up met keys {}".format(sorted(engine._programs)))
    engine.recompile_detector.mark_warm()


class _Observed(object):
    """A histogram that also keeps every value it observes in ``sink``."""

    def __init__(self, hist, sink):
        self._hist, self._sink = hist, sink

    def observe(self, value):
        self._sink.append(value)
        self._hist.observe(value)

    def __getattr__(self, name):
        return getattr(self._hist, name)


class _FleetProbe(object):
    """Times the fleet's transports on every replica: a prefix row's
    capture (``export_prefix``: host clock, it waits for its copies) and
    restore (``adopt_prefix``: CUDA events on the acceptor's stream), a
    step's handoff capture (``_capture_handoffs``: host clock over its one
    synchronization) and a handoff's restore (``adopt_handoff``: CUDA
    events on the acceptor's stream), each with its bytes. Put only on
    untimed runs: its wrappers run on the side that ships."""

    def __init__(self, fleet):
        self.exports, self.adopts = [], []
        self.captures, self.restores = [], []
        # Capture to adoption, seconds, as the donor's histogram observes
        # it (the runner's collector windows the histogram itself).
        self.latency = []
        for rep in fleet.replicas:
            self._wrap(rep.engine)

    def _wrap(self, eng):
        probe = self
        export, adopt = eng.export_prefix, eng.adopt_prefix
        capture, adopt_h = eng._capture_handoffs, eng.adopt_handoff
        eng._handoff_latency_hist = _Observed(eng._handoff_latency_hist,
                                              probe.latency)

        def timed_export(tokens):
            t0 = time.perf_counter()
            out = export(tokens)
            if out is not None:
                probe.exports.append(((time.perf_counter() - t0) * 1e3,
                                      sum(v.nbytes for v in out[1].values())))
            return out

        def on_stream(fn, *args):
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            marks[0].record(eng._stream)
            out = fn(*args)
            marks[1].record(eng._stream)
            return out, marks

        def timed_adopt(tokens, record):
            ok, marks = on_stream(adopt, tokens, record)
            if ok:
                probe.adopts.append((marks, sum(v.nbytes
                                                for v in record.values())))
            return ok

        def timed_capture():
            n0 = eng.counters["handoff_bytes_shipped"]
            h0 = eng.counters["handoffs"]
            t0 = time.perf_counter()
            capture()
            if eng.counters["handoffs"] > h0:
                probe.captures.append((
                    (time.perf_counter() - t0) * 1e3,
                    eng.counters["handoff_bytes_shipped"] - n0,
                    eng.counters["handoffs"] - h0))

        def timed_adopt_handoff(spec, record):
            req, marks = on_stream(adopt_h, spec, record)
            if req is not None:
                probe.restores.append((marks, sum(v.nbytes
                                                  for v in record.values())))
            return req

        eng.export_prefix, eng.adopt_prefix = timed_export, timed_adopt
        eng._capture_handoffs = timed_capture
        eng.adopt_handoff = timed_adopt_handoff

    @staticmethod
    def _summary(ms, nbytes):
        med_ms, med_b = _pct(ms, 50), _pct(nbytes, 50)
        return {"n": len(ms), "ms_p50": med_ms, "ms_p99": _pct(ms, 99),
                "bytes_p50": med_b,
                "gb_per_s": med_b / med_ms / 1e6 if ms and med_ms else None}

    def report(self):
        """Per transport: count, ms p50/p99, bytes p50, GB/s (median bytes
        over median ms); a prefix row's and a handoff's shipment as the
        sum of its two medians."""
        torch.cuda.synchronize()
        out = {}
        for name, rows in (("prefix_adopt", self.adopts),
                           ("handoff_restore", self.restores)):
            out[name] = self._summary([a.elapsed_time(b) for (a, b), _
                                       in rows], [n for _, n in rows])
        out["prefix_export"] = self._summary([t for t, _ in self.exports],
                                             [n for _, n in self.exports])
        per = [(t / k, n / k) for t, n, k in self.captures]
        out["handoff_capture"] = dict(
            self._summary([t for t, _ in per], [n for _, n in per]),
            steps=len(self.captures))
        out["handoff_latency_ms"] = {
            "n": len(self.latency),
            "p50": _ms(_pct(self.latency, 50)),
            "p99": _ms(_pct(self.latency, 99))}
        for ship, a, b in (("prefix_shipment", "prefix_export",
                            "prefix_adopt"),
                           ("handoff_shipment", "handoff_capture",
                            "handoff_restore")):
            if out[a]["n"] and out[b]["n"]:
                ms = out[a]["ms_p50"] + out[b]["ms_p50"]
                out[ship] = {"ms_p50": ms, "gb_per_s":
                             out[b]["bytes_p50"] / ms / 1e6}
        return out


def _launch_marks(fleet):
    """Zero each replica's own launch counts and note its steps and prefill
    lanes so far: ``_exact_replica_launches`` counts from here."""
    marks = []
    for rep in fleet.replicas:
        eng = rep.engine
        for kind in eng.launches:
            eng.launches[kind] = 0
        marks.append((eng.counters["chunks"], eng._lane_steps.value))
    return marks


def _exact_replica_launches(fleet, marks, kernel, lane_kernel, label):
    """Each replica's own decode-kernel launches since ``_launch_marks``:
    n_layer x chunk_size per step of its decode lane (``kernel``; a
    speculating lane verifies once per decode step) and n_layer per
    prefill lane (``lane_kernel``), the others 0. A dead replica's faulted
    step ran no program. Returns {replica: launches}."""
    out = {}
    for rep, (c0, lanes0) in zip(fleet.replicas, marks):
        eng = rep.engine
        n_layer = eng._params.config.n_layer
        want = dict.fromkeys(eng.launches, 0)
        want[kernel] += n_layer * (eng.counters["chunks"] - c0) * \
            eng.config.chunk_size
        want[lane_kernel] += n_layer * int(eng._lane_steps.value - lanes0)
        if eng.launches != want:
            fail("{}: replica {} launched {}, its steps say {}".format(
                label, rep.rid, eng.launches, want))
        out[rep.rid] = dict(eng.launches)
    return out


def _held_fleet(model, reqs, got, ref, what):
    """Phase 5's rule over every stream (sampled ones over their
    Gumbel-max scores); returns how many are bit-equal."""
    return sum(_held_to(model, r["prompt"], g, w,
                        "{} request {}".format(what, i), _fleet_sampling(r))
               for i, (r, g, w) in enumerate(zip(reqs, got, ref)))


def _ms(seconds):
    return None if seconds is None else seconds * 1e3


def _fleet_lost(frs, new):
    return [i for i, fr in enumerate(frs)
            if fr.phase != "done" or len(fr.tokens) != new]


def _fleet_unharmed(fleet, label):
    """The facts of a fleet run with no fault injected: no failover, every
    replica alive, the fleet healthy. The fleet fails a replica over on
    any error out of its step and the survivors finish its streams, so
    the streams alone would not show such a death: fail on it here."""
    facts = {"failovers": fleet.failovers,
             "all_alive": all(rep.alive for rep in fleet.replicas),
             "fleet_health": fleet.health}
    if facts != {"failovers": 0, "all_alive": True,
                 "fleet_health": "healthy"}:
        fail("{}: a replica failed with no fault injected: {}; causes {}"
             .format(label, facts, {rep.rid: repr(rep.cause)
                                    for rep in fleet.replicas}))
    return facts


def _serve_waves(submit, settle, reqs):
    """FLEET_WAVES times: submit the stream, settle it. Returns the
    handles wave by wave and each wave's wall clock, synchronized."""
    waves, walls = [], []
    for _ in range(FLEET_WAVES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        waves.append(submit(reqs))
        settle()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return waves, walls


def _wave_rates(walls):
    tokens = FLEET_REQUESTS * FLEET_NEW
    return {"waves": len(walls), "wall_s": sum(walls), "wave_wall_s": walls,
            "tokens_per_sec": tokens * len(walls) / sum(walls),
            "wave_tokens_per_sec_min": tokens / max(walls),
            "wave_tokens_per_sec_max": tokens / min(walls)}


def phase_fleet(card, model):
    """The JAX ``--fleet-smoke`` TPU setting (FLEET_SERVE, the stream of
    ``_fleet_requests``) at full width: (i) one engine, warm, serves the
    stream FLEET_WAVES times back to back (its first wave is the
    reference every stream is held to; the waves' tokens/s is what a
    fleet is compared with); (ii) two replicas, prefix affinity off,
    fault-free, the same waves, then the prefix-row transport timed
    alone; (iii) two replicas, affinity on: once
    replica 0 owns a request with tokens delivered, a ``raise`` kills it
    (recovery_max_retries 0) while the second half of the stream arrives;
    (iv) a short pass on a paged int8 fleet with a prefill-role replica
    (K6; prefix pages shipped, handoffs captured page by page), and an
    explicit prefix-page adoption checked byte for byte. Fails on a lost
    request, a stream off its reference by phase 5's rule, a capture on a
    warm replica, a rebound pool tensor on the survivor, per-replica
    launches off their steps, a replica failed in a run with no fault
    injected (or in the kill run, of anything but the injected fault), an
    unhealthy fleet at exit, or an autopsy whose failover arrow does not
    cross replicas. One ``fleet`` line."""
    vocab = model.config.vocab_size
    reqs = _fleet_requests(vocab)
    line = {"fleet": "gpt2-medium bf16, 2 replicas on one card",
            "serve_cfg": FLEET_SERVE, "card": card,
            "stream": "{} requests, 2 shared {}-token templates + 4-8 token "
                      "tails, {} new tokens, greedy / sampled alternating, "
                      "every third without speculation".format(
                          FLEET_REQUESTS, FLEET_TEMPLATE, FLEET_NEW)}
    # (i) one engine.
    eng = InferenceEngine(model, config=dict(FLEET_SERVE))
    _warm_keys(eng, vocab)
    waves, walls = _serve_waves(lambda rs: _fleet_submit(eng, rs), eng.run,
                                reqs)
    ref = [h.tokens for h in waves[0]]
    if any(len(t) != FLEET_NEW for t in ref):
        fail("fleet: the single engine's streams are short")
    line["single_engine"] = dict(_wave_rates(walls), streams_bit_equal=sum(
        _held_fleet(model, reqs, [h.tokens for h in wave], ref,
                    "one engine, wave {}".format(k))
        for k, wave in enumerate(waves[1:], 1)))
    del eng, waves
    # (ii) two replicas, affinity off, fault-free.
    fleet = ServingFleet(model, n_replicas=2, config=dict(FLEET_SERVE),
                         prefix_affinity=False, start=False,
                         window_seconds=2.0)
    try:
        for rep in fleet.replicas:
            _warm_keys(rep.engine, vocab)
        fleet.metrics(reset=True)
        fleet.start()

        def settle():
            if not fleet.wait_idle(timeout_s=300.0):
                fail("fleet affinity off: did not settle")

        waves, walls = _serve_waves(lambda rs: _fleet_submit(fleet, rs),
                                    settle, reqs)
        frs = [fr for wave in waves for fr in wave]
        if _fleet_lost(frs, FLEET_NEW):
            fail("fleet affinity off: lost {}".format(_fleet_lost(
                frs, FLEET_NEW)))
        m = fleet.metrics()
        line["affinity_off"] = dict(
            _wave_rates(walls),
            speedup_over_one_engine=line["single_engine"]["wall_s"]
            / sum(walls),
            fleet_prefix_hit_rate=fleet.prefix_hit_rate(),
            prefill_tokens=fleet.counters["prefill_tokens"],
            owners=[fr.replica_id for fr in waves[0]],
            recompiles=[r["recompiles"] for r in m["replicas"].values()],
            streams_bit_equal=sum(
                _held_fleet(model, reqs, [fr.tokens for fr in wave], ref,
                            "fleet affinity off, wave {}".format(k))
                for k, wave in enumerate(waves)),
            **_fleet_unharmed(fleet, "fleet affinity off"))
        if any(line["affinity_off"]["recompiles"]):
            fail("fleet affinity off: a warm replica captured a program")
        line["row_shipment"] = _ship_rows(fleet, [int(t) for t in reqs[0][
            "prompt"][:FLEET_TEMPLATE]])
    finally:
        fleet.close()
    del fleet
    gc.collect()
    torch.cuda.empty_cache()
    line["kill"] = _fleet_kill(model, reqs, ref, vocab)
    line["paged_int8"] = _fleet_paged(model, reqs, vocab)
    print("fleet " + json.dumps(line))
    return line


def _ship_rows(fleet, template):
    """The prefix-row transport alone, timed: FLEET_SHIPMENTS times, the
    replica holding ``template``'s row exports it and the other, its store
    emptied first (derived state; the engine is idle), adopts it; each
    adopted row re-exported must equal the record byte for byte. Under
    each replica's lock in turn, as the fleet ships."""
    probe = _FleetProbe(fleet)
    reps = fleet.replicas
    with reps[0].lock:
        first = reps[0].engine.export_prefix(template)
    src, dst = (reps[0], reps[1]) if first is not None else \
        (reps[1], reps[0])
    equal = 0
    for _ in range(FLEET_SHIPMENTS):
        with src.lock:
            out = src.engine.export_prefix(template)
        if out is None:
            fail("fleet: no replica holds the template's prefix row")
        matched, record = out
        with dst.lock:
            dst.engine._hier.store.reset()
            if not dst.engine.adopt_prefix(matched, record):
                fail("fleet: the acceptor refused a prefix row")
            back = dst.engine.export_prefix(list(matched))
        equal += back is not None and all(
            torch.equal(back[1][n], record[n]) for n in record)
    facts = dict(probe.report(), tokens=len(matched),
                 byte_equal=equal, shipments=FLEET_SHIPMENTS)
    for key in ("handoff_restore", "handoff_capture", "handoff_latency_ms"):
        del facts[key]
    if equal != FLEET_SHIPMENTS:
        fail("fleet: a shipped prefix row differs from its record")
    return facts


def _fleet_kill(model, reqs, ref, vocab):
    """(iii) of phase_fleet."""
    fleet = ServingFleet(model, n_replicas=2, config=dict(
        FLEET_SERVE, **FLEET_CHAOS), start=False, window_seconds=2.0)
    try:
        for rep in fleet.replicas:
            _warm_keys(rep.engine, vocab)
        survivor = fleet.replicas[1].engine
        programs = survivor.compile_count
        addrs = {n: t.data_ptr() for n, t in survivor._pool.items()}
        fleet.metrics(reset=True)
        marks = _launch_marks(fleet)
        half = FLEET_REQUESTS // 2
        fleet.start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wave1 = _fleet_submit(fleet, reqs[:half])
        deadline = time.time() + 120.0
        while not any(fr.replica_id == 0 and fr.tokens and not fr.done
                      for fr in wave1):
            if time.time() > deadline:
                fail("fleet: replica 0 never owned a request mid-stream")
            time.sleep(0.001)
        at_kill = [{"fid": fr.fid, "tokens_delivered": len(fr.tokens)}
                   for fr in wave1 if fr.replica_id == 0 and not fr.done]
        fleet.inject_faults(FaultPlan(faults=(Fault("raise", step=0),)),
                            replica=0)
        frs = wave1 + _fleet_submit(fleet, reqs[half:])
        if not fleet.wait_idle(timeout_s=300.0):
            fail("fleet kill: did not settle")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lost = _fleet_lost(frs, FLEET_NEW)
        m = fleet.metrics()
        agg = m["fleet"]
        moved = [fr for fr in frs if fr.failovers > 0]
        facts = {
            "wall_s": wall, "tokens_per_sec": FLEET_REQUESTS * FLEET_NEW
            / wall, "requests_lost": len(lost), "mid_stream_at_kill": at_kill,
            "failovers": fleet.failovers, "moved": len(moved),
            "dead_replicas": [r.rid for r in fleet.replicas if not r.alive],
            "fleet_health_at_exit": fleet.health,
            "fleet_prefix_hit_rate": fleet.prefix_hit_rate(),
            "prefix_hits": agg["prefix_hits"],
            "prefix_misses": agg["prefix_misses"],
            "prefix_adoptions": agg["prefix_adoptions"],
            "prefix_bytes_shipped": agg["prefix_bytes_shipped"],
            "affinity_routed": agg["affinity_routed"],
            "prefill_tokens": fleet.counters["prefill_tokens"],
            "survivor_compile_count": survivor.compile_count,
            "survivor_recompiles": m["replicas"][1]["recompiles"],
            "replayed_resyncs": survivor.counters["requests_replayed"],
            "causes": {rep.rid: repr(rep.cause) for rep in fleet.replicas}}
        if lost:
            fail("fleet kill: lost {}".format(lost))
        facts["launches"] = _exact_replica_launches(
            fleet, marks, "decode", "paged", "fleet kill")
        facts["streams_bit_equal"] = _held_fleet(
            model, reqs, [fr.tokens for fr in frs], ref, "fleet kill")
        moved_addrs = [n for n, t in survivor._pool.items()
                       if t.data_ptr() != addrs[n]]
        # Replica 0 died of the injected fault (recovery_max_retries 0),
        # and nothing else failed a replica.
        cause = fleet.replicas[0].cause
        if not isinstance(cause, EngineDeadError) or \
                not isinstance(cause.__cause__, InjectedFault) or \
                any(rep.cause is not None for rep in fleet.replicas[1:]):
            print("fleet " + json.dumps(facts))
            fail("fleet kill: a replica failed of something other than the "
                 "injected fault: {}".format(facts["causes"]))
        if not moved or fleet.failovers < 1 or \
                facts["dead_replicas"] != [0] or fleet.health != "healthy" \
                or survivor.compile_count != programs or \
                facts["survivor_recompiles"] or moved_addrs:
            print("fleet " + json.dumps(facts))
            fail("fleet kill: the failover invariant does not hold (moved "
                 "{}, pool tensors rebound {})".format(len(moved),
                                                      moved_addrs))
        tree = fleet.explain(moved[0])
        names = [h["name"] for h in tree["hops"]]
        sites = {h["name"]: h["site"] for h in tree["hops"]}
        facts["autopsy"] = {"hops": len(names), "failover_out": sites.get(
            "request/failover_out"), "failover_in": sites.get(
            "request/failover_in"), "hop_gaps": tree["hop_gaps"],
            "terminal": tree["terminal"]}
        if sites.get("request/failover_out") != "replica0" or \
                sites.get("request/failover_in") in (None, "replica0") or \
                tree["hop_gaps"] or \
                not tree["terminal"].get("lost_then_replayed"):
            print("fleet " + json.dumps(facts))
            fail("fleet kill: the autopsy's failover arrow does not cross "
                 "replicas")
        return facts
    finally:
        fleet.close()
        del fleet
        gc.collect()
        torch.cuda.empty_cache()


def _fleet_paged(model, reqs, vocab):
    """(iv) of phase_fleet: the first FLEET_PAGED_REQUESTS of the stream
    on paged int8 pools with a prefill-role and a mixed replica, stepped
    on this thread (submit, two fleet steps, next), against one paged
    int8 engine; then an explicit prefix-page adoption, re-exported byte
    for byte."""
    cfg = dict(FLEET_SERVE, **FLEET_PAGED)
    reqs = reqs[:FLEET_PAGED_REQUESTS]
    eng = InferenceEngine(model, config=dict(cfg))
    handles = _fleet_submit(eng, reqs)
    eng.run()
    ref = [h.tokens for h in handles]
    del eng, handles
    fleet = ServingFleet(model, n_replicas=2, config=cfg,
                         roles=("prefill", "mixed"), start=False,
                         window_seconds=2.0)
    try:
        probe = _FleetProbe(fleet)
        marks = _launch_marks(fleet)
        frs = []
        for r in reqs:
            frs += _fleet_submit(fleet, [r])
            fleet.step()
            fleet.step()
        if not fleet.wait_idle(timeout_s=300.0):
            fail("fleet paged int8: did not settle")
        if _fleet_lost(frs, FLEET_NEW):
            fail("fleet paged int8: lost {}".format(_fleet_lost(
                frs, FLEET_NEW)))
        agg = fleet.metrics()["fleet"]
        facts = {"roles": ["prefill", "mixed"],
                 "requests": FLEET_PAGED_REQUESTS,
                 "handoffs": agg["handoffs"],
                 "handoffs_in": agg["handoffs_in"],
                 "handoff_fallbacks": agg["handoff_fallbacks"],
                 "prefix_adoptions": agg["prefix_adoptions"],
                 "affinity_routed": agg["affinity_routed"],
                 "fleet_prefix_hit_rate": fleet.prefix_hit_rate(),
                 "launches": _exact_replica_launches(
                     fleet, marks, "paged_q8", "paged_q8",
                     "fleet paged int8"),
                 "streams_bit_equal": _held_fleet(
                     model, reqs, [fr.tokens for fr in frs], ref,
                     "fleet paged int8"),
                 **_fleet_unharmed(fleet, "fleet paged int8")}
        if agg["handoffs"] < 1 or agg["handoffs"] != agg["handoffs_in"] \
                or agg["handoff_fallbacks"]:
            fail("fleet paged int8: handoffs {}".format(facts))
        # An explicit shipment of a template's prefix pages, from the
        # replica that holds it to one that does not (or, when both do,
        # each re-exported), byte for byte.
        template = [int(t) for t in reqs[0]["prompt"][:FLEET_TEMPLATE]]
        engines = [rep.engine for rep in fleet.replicas]
        held = [e.export_prefix(template) for e in engines]
        donor = next(i for i, h in enumerate(held) if h is not None)
        matched, record = held[donor]
        acceptor = engines[1 - donor]
        if held[1 - donor] is None:
            if not acceptor.adopt_prefix(matched, record):
                fail("fleet paged int8: the acceptor refused the pages")
        back = acceptor.export_prefix(list(matched))
        same = back is not None and tuple(back[0]) == tuple(matched) and \
            all(torch.equal(back[1][n], record[n]) for n in record)
        facts["page_shipment"] = {
            "tokens": len(matched), "bytes": record_nbytes(record),
            "int8": record["pk"].dtype == torch.int8,
            "adopted": held[1 - donor] is None, "byte_equal": same}
        facts["transfers"] = probe.report()
        if not same:
            fail("fleet paged int8: shipped prefix pages differ")
        return facts
    finally:
        fleet.close()
        del fleet
        gc.collect()
        torch.cuda.empty_cache()


def _disagg_side(card, model, roles, spec, reqs):
    """One side of phase_disagg: a 3-replica fleet (``roles``; None all
    mixed) warmed on this thread by six requests of the stream's mean
    prompt length (every replica meets its keys: a prefill replica the
    lane key, a decode replica the lane-free one, a mixed replica both),
    marked warm, then driven open loop by loadgen's SustainedRunner on
    the stepping threads; a disaggregated side then times its handoffs
    on an untimed pass (``_probe_handoffs``). Fails if a replica failed.
    Returns (line, the streams in submission order)."""
    vocab = model.config.vocab_size
    fleet = ServingFleet(model, n_replicas=3, config=dict(DISAGG_SERVE),
                         roles=roles, start=False,
                         window_seconds=DISAGG_WINDOW_S)
    label = "disagg" if roles else "mixed"
    try:
        rng = np.random.RandomState(7)
        for i in range(6):
            fleet.submit(rng.randint(0, vocab, size=DISAGG_LOAD[
                "prompt_mean"]), max_new_tokens=DISAGG_LOAD["output_mean"])
        if not fleet.wait_idle(timeout_s=300.0):
            fail("{}: the warm-up did not settle".format(label))
        want = {"prefill": [(True, False, False)],
                "decode": [(False, False, False)],
                "mixed": [(False, False, False), (True, False, False)]}
        for rep in fleet.replicas:
            if sorted(rep.engine._programs) != want[rep.engine.role]:
                fail("{}: replica {} ({}) met keys {} in the warm-up".format(
                    label, rep.rid, rep.engine.role,
                    sorted(rep.engine._programs)))
            rep.engine.recompile_detector.mark_warm()
        fleet.metrics(reset=True)
        marks = _launch_marks(fleet)
        handles = []
        submit = fleet.submit

        def recording(prompt, **kw):
            fr = submit(prompt, **kw)
            handles.append((tuple(int(t) for t in prompt), fr))
            return fr

        fleet.submit = recording
        fleet.start()
        res = SustainedRunner(fleet, spec, window_seconds=DISAGG_WINDOW_S,
                              max_steps=5_000_000).run()
        torch.cuda.synchronize()
        report = build_report(spec, res, DISAGG_SLO, platform="gpu",
                              extra={"model": "gpt2-medium bf16",
                                     "roles": list(roles or ()),
                                     "card": card})
        agg, m = report["aggregate"], fleet.metrics()
        line = {
            "roles": [rep.engine.role for rep in fleet.replicas],
            "submitted": agg["submitted"], "completed": agg["completed"],
            "shed": agg["shed"], "requests_lost": res.requests_lost,
            "wall_s": agg["wall_s"], "tokens_per_sec": agg["tokens_per_sec"],
            "ttft_p50_ms": agg["ttft_p50_ms"],
            "ttft_p99_ms": agg["ttft_p99_ms"],
            "itl_p50_ms": agg["itl_p50_ms"], "itl_p99_ms": agg["itl_p99_ms"],
            "slo_attainment": agg["slo_attainment"],
            "disagg": report["disagg"],
            "prefill_lanes": [r["prefill_lanes"]
                              for r in m["replicas"].values()],
            "recompiles": [r["recompiles"] for r in m["replicas"].values()],
            "compile_counts": fleet.compile_counts}
        line["launches"] = _exact_replica_launches(fleet, marks, "decode",
                                                   "paged", label)
        line.update(_fleet_unharmed(fleet, label))
        decode_lanes = [r for rep, r in zip(fleet.replicas,
                                            line["prefill_lanes"])
                        if rep.engine.role == "decode"]
        if res.requests_lost or agg["shed"] or \
                agg["completed"] != DISAGG_LOAD["n_requests"] or \
                any(line["recompiles"]) or any(decode_lanes) or \
                report["disagg"]["handoff_fallbacks"] or \
                (roles and report["disagg"]["handoffs"] < 1):
            print("disagg " + json.dumps(line))
            fail("{}: zero lost, no fallback, no capture after warm-up and "
                 "no prefill lane on a decode replica do not all hold".format(
                     label))
        got = {prompt: fr.tokens for prompt, fr in handles}
        if roles:
            line["transfers"] = _probe_handoffs(model, fleet, reqs, got,
                                                label)
        return line, [got.get(tuple(int(t) for t in r)) for r in reqs]
    finally:
        fleet.close()
        del fleet
        gc.collect()
        torch.cuda.empty_cache()


def _probe_handoffs(model, fleet, reqs, got, label):
    """After the timed run, untimed: the first DISAGG_PROBE_REQUESTS
    prompts again through the same fleet with the transports timed
    (``_FleetProbe``), so the A/B's two sides run the same code. Each
    stream is held by phase 5's rule to the timed run's on the same
    prompt; every prompt hands off, none falls back, no replica fails."""
    probe = _FleetProbe(fleet)
    h0 = fleet.counters["handoffs"]
    prompts = reqs[:DISAGG_PROBE_REQUESTS]
    frs = [fleet.submit(p, max_new_tokens=DISAGG_LOAD["output_mean"])
           for p in prompts]
    if not fleet.wait_idle(timeout_s=300.0):
        fail("{}: the handoff probe did not settle".format(label))
    handoffs = fleet.counters["handoffs"] - h0
    if _fleet_lost(frs, DISAGG_LOAD["output_mean"]) or \
            handoffs != DISAGG_PROBE_REQUESTS or \
            fleet.counters["handoff_fallbacks"]:
        fail("{}: the handoff probe lost {} or handed off {} of {}".format(
            label, _fleet_lost(frs, DISAGG_LOAD["output_mean"]), handoffs,
            DISAGG_PROBE_REQUESTS))
    equal = sum(_held_to(model, p, fr.tokens, got[tuple(int(t) for t in p)],
                         "{} handoff probe {}".format(label, i))
                for i, (p, fr) in enumerate(zip(prompts, frs)))
    _fleet_unharmed(fleet, label + " handoff probe")
    return dict(probe.report(), requests=DISAGG_PROBE_REQUESTS,
                streams_bit_equal=equal)


def phase_disagg(card, model):
    """The JAX ``--disagg`` TPU setting (bench.py:1908-1915; DISAGG_SERVE,
    DISAGG_LOAD): one prefill and two decode replicas against the same
    three replicas all mixed, each side warmed then driven open loop; the
    greedy streams of both sides held by phase 5's rule to one engine's on
    the same prompts. The A/B is reported, not gated: on one card the
    three replicas share the SMs and the host, so it answers another
    question than on three chips. One ``disagg`` line."""
    spec = WorkloadSpec(**DISAGG_LOAD)
    reqs = [r.prompt for r in spec.requests()]
    eng = InferenceEngine(model, config=dict(DISAGG_SERVE))
    handles = [eng.submit(p, max_new_tokens=DISAGG_LOAD["output_mean"])
               for p in reqs]
    eng.run()
    ref = [h.tokens for h in handles]
    del eng, handles
    line = {"disagg": "gpt2-medium bf16, 3 replicas on one card",
            "serve_cfg": DISAGG_SERVE, "card": card,
            "workload": {k: DISAGG_LOAD[k] for k in (
                "arrival", "rate", "n_requests", "prompt_dist",
                "prompt_mean", "prompt_max", "output_mean", "seed")},
            "slo": DISAGG_SLO.to_json()}
    for side, roles in (("disagg", DISAGG_ROLES), ("mixed", None)):
        facts, got = _disagg_side(card, model, roles, spec, reqs)
        if any(g is None for g in got):
            fail("{}: a stream is missing".format(side))
        facts["streams_bit_equal"] = sum(
            _held_to(model, p, g, w, "{} request {}".format(side, i))
            for i, (p, g, w) in enumerate(zip(reqs, got, ref)))
        line[side] = facts
    d, x = line["disagg"], line["mixed"]
    line["itl_p99_ratio_disagg_over_mixed"] = (
        d["itl_p99_ms"] / x["itl_p99_ms"] if x["itl_p99_ms"] else None)
    line["ttft_p99_ratio_disagg_over_mixed"] = (
        d["ttft_p99_ms"] / x["ttft_p99_ms"] if x["ttft_p99_ms"] else None)
    print("disagg " + json.dumps(line))
    return line


# --------------------------- the rest of serving: front door, adapters, x-ray
#
# The front door (phase_frontdoor): the JAX ``bench.py --frontdoor-smoke``
# TPU setting (bench.py:2080-2092, 2133-2145) at full width, with and without
# the front door on the same offered load.
FRONTDOOR_SERVE = {"max_slots": 16, "max_len": 1024, "chunk_size": 16,
                   "max_queue": 256, "host_offload": True}
FRONTDOOR_LOAD = dict(tenants=("tenant_a", "tenant_b"), seed=29,
                      interactive_rate=4.0, interactive_n=24,
                      batch_rate=24.0, batch_ramp_from=4.0, batch_n=48,
                      prompt_dist="lognormal", prompt_mean=64,
                      prompt_max=256, output_dist="lognormal",
                      output_mean=64, output_min=16, output_max=128)
FRONTDOOR_BUDGET_MS = 1500.0
FRONTDOOR_WINDOW_S = 2.0
FRONTDOOR_KEYS = [(False, False, False), (True, False, False)]
# The front door's resilience (phase_frontdoor_resilience): the fleet
# setting with host offload (the preempted session's parking spot) and a
# queue of FD_PREEMPT_QUEUE, so that an interactive burst one request past
# the target queues' room meets QueueFull and the front door parks batch
# (``FrontDoor._maybe_preempt``). One engine serves FD_PREEMPT_BATCH batch
# streams (its slots) and a burst of FD_PREEMPT_QUEUE + 1; two replicas
# serve 2 x FD_PREEMPT_BATCH and a burst of 2 x FD_PREEMPT_QUEUE + 1.
FD_PREEMPT_QUEUE = 2
FD_FLEET_SERVE = dict(FLEET_SERVE, host_offload=True, swap_slots=8,
                      max_queue=FD_PREEMPT_QUEUE)
FD_PREEMPT_BATCH = FLEET_SERVE["max_slots"]
# The adapters (phase_adapters) at GPT-2 medium's widths on a dense pool
# of 16 slots: MoE with 8 experts of d_ff 4096 in each of 4 layers (the
# depth cut for the smoke's time; about 0.54 GB of bf16 expert stacks),
# and
# the long-context adapter with its block-sparse mask from position 512
# (blocks of 64, 4 local, 1 global).
MOE_CFG = dict(vocab_size=50257, n_layer=4, n_head=16, n_embd=1024,
               n_positions=1024, n_experts=8, d_ff=4096, capacity_factor=0,
               dtype=torch.bfloat16)
LONG_CFG = dict(threshold=512, block=64, num_local_blocks=4,
                num_global_blocks=1)
LONG_ATTN = generation.EinsumAttention(
    LONG_CFG["block"], LONG_CFG["num_local_blocks"],
    LONG_CFG["num_global_blocks"], LONG_CFG["threshold"])
# The long-context gates in fp32 (``_longcontext_fp32``): phase 5's model
# (4 layers at GPT-2 medium's width, seed 1) under its gap rule.
LONG_FP32 = dict(n_embd=1024, n_layer=4, n_head=16, dtype=torch.float32)
# bf16 at full width: the largest difference of two teacher-forced fp32
# logit tables over the same tokens, over the largest logit (the einsum
# path against K3, and the einsum path with the sparse mask against the
# plain fp32 reference): 1.7x the largest reading on an H100 (0.0172, the
# einsum against K3; K3 itself reads 0.0165 against the plain fp32
# reference, so the difference is bf16 rounding).
LONG_BF16_TOL = 0.03
ADAPTER_REQUESTS = 4
ADAPTER_NEW = 64
# Prompts that cross position 512 (the threshold) while they prefill or
# decode, and prompts that stay below it with their new tokens.
LONG_LENS, SHORT_LENS = (480, 560), (64, 200)
# The perf x-ray (phase_xray): the dense serve path's stream, its first
# XRAY_REQUESTS requests (every program key still met: request 5 samples
# with top-k; 8 since PR 22, for the smoke's time), with every fourth
# replayed step timed.
XRAY_SAMPLE_EVERY = 4
XRAY_REQUESTS = 8
# ... each NEW_TOKENS / 2 new tokens (NEW_TOKENS until the smoke's time
# limit cut them: the turns still meet every key, and a 1-in-4 sample
# still times a dozen steps).
XRAY_NEW = NEW_TOKENS // 2


def _frontdoor_side(card, model, frontdoor):
    """One side of the front-door A/B: a warm engine (both keys met, then
    marked warm), driven open loop by SustainedRunner with the
    mixed-tenant workload, through a FrontDoor or straight into the
    engine. K3/K5 counts are reset just before the run and read just
    after. Returns its facts."""
    cfg = model.config
    engine = init_inference(model, config=dict(FRONTDOOR_SERVE))
    engine.generate([np.arange(1, 41)], max_new_tokens=40)
    if sorted(engine._programs) != FRONTDOOR_KEYS:
        fail("frontdoor: the warm-up met keys {}".format(
            sorted(engine._programs)))
    engine.recompile_detector.mark_warm()
    engine.metrics(reset=True)
    target = engine
    if frontdoor:
        target = FrontDoor(engine, FrontDoorConfig(
            classes=(PriorityClass("interactive",
                                   ttft_budget_ms=FRONTDOOR_BUDGET_MS,
                                   weight=4.0, shed_on_budget=False),
                     PriorityClass("batch", weight=1.0, preemptible=True)),
            tenants=(TenantPolicy("tenant_a"), TenantPolicy("tenant_b")),
            batch_headroom=0.25))
    spec = WorkloadSpec.mixed_tenants(vocab_size=cfg.vocab_size,
                                      **FRONTDOOR_LOAD)
    slo = SLO(ttft_p99_ms=FRONTDOOR_BUDGET_MS, itl_p99_ms=None)
    class_slos = {"interactive": slo,
                  "batch": SLO(ttft_p99_ms=None, itl_p99_ms=None)}
    # The runner's collector windows the registry, so the steps are read
    # as differences of the cumulative counts.
    chunks0, lanes0 = engine.counters["chunks"], engine._lane_steps.value
    torch.cuda.synchronize()
    da.reset_launches()
    result = SustainedRunner(target, spec, window_seconds=FRONTDOOR_WINDOW_S,
                             max_steps=500_000).run()
    torch.cuda.synchronize()
    launches = dict(da.launches)
    m = engine.metrics()
    m["decode_steps"] = (engine.counters["chunks"] - chunks0) * \
        FRONTDOOR_SERVE["chunk_size"]
    m["prefill_lanes"] = int(engine._lane_steps.value - lanes0)
    report = build_report(spec, result, slo, platform="cuda",
                          class_slos=class_slos)
    fd = report["frontdoor"]
    inter, batch = fd["classes"]["interactive"], fd["classes"]["batch"]
    side = "frontdoor" if frontdoor else "no frontdoor"
    want = dict.fromkeys(launches, 0)
    want["decode"] = cfg.n_layer * m["decode_steps"]
    want["paged"] = cfg.n_layer * m["prefill_lanes"]
    facts = {
        "requests": result.submitted, "completed": result.completed,
        "requests_lost": result.requests_lost, "wall_s": result.wall_s,
        "tokens_out": result.tokens_out,
        "interactive_ttft_p50_ms": inter["ttft_p50_ms"],
        "interactive_ttft_p99_ms": inter["ttft_p99_ms"],
        "interactive_itl_p50_ms": inter["itl_p50_ms"],
        "interactive_itl_p99_ms": inter["itl_p99_ms"],
        "interactive_attainment": inter["slo_attainment"],
        "batch_ttft_p99_ms": batch["ttft_p99_ms"],
        "batch_completed": batch["completed"],
        "sheds_by_reason": fd["sheds_by_reason"],
        "preemptions": fd["preemptions"],
        "preempt_resumes": fd["preempt_resumes"],
        "recompiles": m["recompiles"], "compile_count": m["compile_count"],
        "decode_steps": m["decode_steps"],
        "prefill_lanes": m["prefill_lanes"], "launches": launches}
    if frontdoor:
        facts["frontdoor_stats"] = target.metrics()["frontdoor"]["stats"]
    if result.requests_lost:
        fail("frontdoor ({}): {} requests lost".format(
            side, result.requests_lost))
    if m["recompiles"]:
        fail("frontdoor ({}): {} captures after mark_warm()".format(
            side, m["recompiles"]))
    if not batch["completed"]:
        fail("frontdoor ({}): the batch class never completed".format(side))
    if launches != want:
        fail("frontdoor ({}): decode kernel launches {} != {} (n_layer x "
             "the decode steps and prefill lanes the counters report)"
             .format(side, launches, want))
    del target, engine
    gc.collect()
    torch.cuda.empty_cache()
    return facts


def phase_frontdoor(card, model):
    """The front-door A/B (FRONTDOOR_SERVE, FRONTDOOR_LOAD): the same
    offered load with and without the front door. Fails on a lost
    request, a capture after mark_warm(), a batch class that never
    completes, or K3/K5 counts off the steps; the interactive budget is
    reported as attainment, not gated. One ``frontdoor`` line."""
    line = {"frontdoor": "gpt2-medium bf16, mixed tenants, one engine",
            "serve_cfg": FRONTDOOR_SERVE, "card": card,
            "budget_ms": FRONTDOOR_BUDGET_MS,
            "workload": {k: v for k, v in FRONTDOOR_LOAD.items()
                         if k != "tenants"}}
    line["with"] = _frontdoor_side(card, model, True)
    line["without"] = _frontdoor_side(card, model, False)
    w, wo = line["with"], line["without"]
    line["interactive_ttft_p99_ratio_with_over_without"] = (
        w["interactive_ttft_p99_ms"] / wo["interactive_ttft_p99_ms"]
        if wo["interactive_ttft_p99_ms"] else None)
    print("frontdoor " + json.dumps(line))
    return line


def _fd_config():
    return FrontDoorConfig(classes=(
        PriorityClass("interactive", ttft_budget_ms=60_000.0, weight=4.0),
        PriorityClass("batch", weight=1.0, preemptible=True)))


def _drain_streams(streams, got):
    """Consume every stream round-robin into ``got`` (the harshest order
    for a cursor)."""
    live = set(range(len(streams)))
    while live:
        for i in sorted(live):
            try:
                got[i].append(int(next(streams[i])))
            except StopIteration:
                live.discard(i)
    return got


def _bit_equal(reqs, got, ref, what):
    """Every stream equal to its undisturbed run, outright."""
    bad = [i for i, (g, w) in enumerate(zip(got, ref)) if list(g) != list(w)]
    if bad:
        fail("{}: streams {} differ from the undisturbed run".format(
            what, bad))
    return len(reqs)


def _fd_streams(fd, reqs, priority):
    return [fd.stream(r["prompt"], priority=priority,
                      max_new_tokens=r["max_new_tokens"],
                      temperature=r["temperature"], seed=r["seed"],
                      spec_decode=r["spec_decode"]) for r in reqs]


def _fd_burst(fd, batch, burst):
    """Step ``fd`` until two of the ``batch`` streams decode, then stream
    ``burst`` as interactive: its dispatch meets QueueFull and the front
    door parks batch itself (``_maybe_preempt``). Returns the burst's
    streams and the handles parked."""
    for _ in range(400):
        if sum(s.handle.phase == "decoding" and len(s.handle.tokens) > 0
               for s in batch) >= 2:
            break
        fd.step()
    else:
        fail("frontdoor_resilience: the batch streams never decoded")
    streams = _fd_streams(fd, burst, "interactive")
    parked = list(fd._preempted)
    if not parked or any(h.phase != "swapped" for h in parked):
        fail("frontdoor_resilience: the interactive burst parked no batch "
             "request ({} held)".format(len(parked)))
    return streams, parked


def _fd_reference(model, reqs):
    """One engine's undisturbed streams of ``reqs`` (warm, no front door,
    a queue that takes them all)."""
    eng = InferenceEngine(model, config=dict(
        FD_FLEET_SERVE, max_queue=FLEET_SERVE["max_queue"]))
    _warm_keys(eng, model.config.vocab_size)
    hs = _fleet_submit(eng, reqs)
    eng.run()
    ref = [list(map(int, h.tokens)) for h in hs]
    del eng, hs
    return ref


def phase_frontdoor_resilience(card, model):
    """The front door's own preemption, held to bit-equal resumption. (i)
    One engine (FD_FLEET_SERVE), warm, behind a FrontDoor: FD_PREEMPT_BATCH
    batch streams, then an interactive burst one past the queue's room;
    the front door parks batch (``_maybe_preempt``), holds it while the
    burst is served (the parked streams do not move), releases it
    (``_maybe_release``) and it resumes; every stream equals the
    undisturbed run's bit for bit, and nothing is captured after warm-up.
    (ii) Two replicas behind a FrontDoor, warm: the same on twice the
    streams; while a request the front door parked is held, its replica
    is killed; the streams, consumed round-robin through the kill, equal
    one engine's undisturbed streams bit for bit (no token twice, none
    dropped), the parked request is re-homed, nothing is lost and the warm
    survivor captures nothing. One ``frontdoor_resilience`` line."""
    vocab = model.config.vocab_size
    reqs = _fleet_requests(vocab)
    line = {"frontdoor_resilience": "gpt2-medium bf16",
            "serve_cfg": FD_FLEET_SERVE, "card": card}
    # (i) one engine: the front door parks, holds and releases.
    n_b, n_i = FD_PREEMPT_BATCH, FD_PREEMPT_QUEUE + 1
    sub = reqs[:n_b + n_i]
    ref = _fd_reference(model, sub)
    eng = InferenceEngine(model, config=dict(FD_FLEET_SERVE))
    _warm_keys(eng, vocab)
    fd = FrontDoor(eng, _fd_config())
    streams = _fd_streams(fd, sub[:n_b], "batch")
    burst, parked = _fd_burst(fd, streams, sub[n_b:])
    streams += burst
    held = [len(h.tokens) for h in parked]
    steps_held = 0
    while fd._preempted:
        if steps_held == 400 or [len(h.tokens) for h in parked] != held \
                or any(h.phase != "swapped" for h in parked):
            fail("frontdoor_resilience: a parked stream moved while held, "
                 "or the hold never lifted")
        fd.step()
        steps_held += 1
    got = _drain_streams(streams, [[] for _ in streams])
    stats = fd.metrics()["frontdoor"]["stats"]
    line["preempt_release"] = {
        "requests": len(sub), "batch": n_b, "burst": n_i,
        "parked_by_the_burst": len(parked), "held_at_tokens": held,
        "steps_held": steps_held,
        "frontdoor_preemptions": stats["preemptions"],
        "frontdoor_preempt_releases": stats["preempt_releases"],
        "engine_preemptions": eng.counters["preemptions"],
        "engine_preempt_resumes": eng.counters["preempt_resumes"],
        "recompiles": eng.recompile_detector.recompiles.value,
        "streams_bit_equal": _bit_equal(sub, got, ref,
                                        "frontdoor_resilience preempt")}
    if not (stats["preemptions"] == stats["preempt_releases"] ==
            eng.counters["preemptions"] ==
            eng.counters["preempt_resumes"] >= len(parked)) or \
            line["preempt_release"]["recompiles"]:
        print("frontdoor_resilience " + json.dumps(line))
        fail("frontdoor_resilience: preemptions, releases and resumes "
             "disagree, or a capture after warm-up")
    del fd, eng, streams
    # (ii) two replicas: the front door parks; the parked request's
    # replica is killed while it is held.
    n_b, n_i = 2 * FD_PREEMPT_BATCH, 2 * FD_PREEMPT_QUEUE + 1
    sub = reqs[:n_b + n_i]
    ref = _fd_reference(model, sub)
    fleet = ServingFleet(model, n_replicas=2, config=dict(
        FD_FLEET_SERVE, **FLEET_CHAOS), start=False, window_seconds=2.0)
    try:
        for rep in fleet.replicas:
            _warm_keys(rep.engine, vocab)
        fd = FrontDoor(fleet, _fd_config())
        streams = _fd_streams(fd, sub[:n_b], "batch")
        burst, parked = _fd_burst(fd, streams, sub[n_b:])
        streams += burst
        victim = parked[0]
        dead = victim._req.replica_id
        survivor = fleet.replicas[1 - dead].engine
        programs = survivor.compile_count
        # Consume what every stream already holds: the kill lands mid-way
        # through streams being read.
        got = [[] for _ in streams]
        for i, s in enumerate(streams):
            for _ in range(len(s.handle.tokens)):
                got[i].append(int(next(s)))
        fleet.inject_faults(FaultPlan(faults=(Fault("raise", step=0),)),
                            replica=dead)
        _drain_streams(streams, got)
        frs = [s.handle._req for s in streams]
        lost = _fleet_lost(frs, FLEET_NEW)
        facts = {"requests": len(sub), "batch": n_b, "burst": n_i,
                 "parked_by_the_burst": len(parked), "killed_replica": dead,
                 "requests_lost": len(lost),
                 "parked_failovers": victim._req.failovers,
                 "failovers": fleet.failovers,
                 "dead_replicas": [r.rid for r in fleet.replicas
                                   if not r.alive],
                 "survivor_recompiles":
                     survivor.recompile_detector.recompiles.value,
                 "survivor_compile_count": survivor.compile_count,
                 "frontdoor_stats": fd.metrics()["frontdoor"]["stats"]}
        if lost or victim._req.failovers < 1 or \
                facts["dead_replicas"] != [dead] or \
                survivor.compile_count != programs or \
                facts["survivor_recompiles"] or \
                facts["frontdoor_stats"]["preemptions"] < 1:
            print("frontdoor_resilience " + json.dumps(facts))
            fail("frontdoor_resilience: the request the front door parked "
                 "did not survive the kill cleanly")
        facts["streams_bit_equal"] = _bit_equal(
            sub, got, ref, "frontdoor_resilience kill")
        line["preempt_kill"] = facts
    finally:
        fleet.close()
        del fleet
        gc.collect()
        torch.cuda.empty_cache()
    print("frontdoor_resilience " + json.dumps(line))
    return line


def _graph_vs_eager_adapter(label, build, prompts, new):
    """A graph-served engine against the same program run eagerly
    (``build(eager)`` makes either): every harvest (``aux_`` counters too)
    and the pool after GRAPH_CHECK_STEPS steps, bit for bit."""
    runs = []
    for eager in (False, True):
        engine = build(eager)
        for i, p in enumerate(prompts):
            kw = {"temperature": 0.8, "seed": i} if i % 3 == 2 else {}
            engine.submit(p, max_new_tokens=new, **kw)
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
                fail("adapters {}: graph vs eager: step {}: {} differs"
                     .format(label, step, name))
    _pool_diffs(graphed, eager, False, "adapters " + label)
    return {"steps": GRAPH_CHECK_STEPS,
            "compile_count": graphed.compile_count,
            "graph_replays": graphed.graph_replays,
            "harvests_and_pool_identical": True}


def _timed_serve(engine, prompts, new):
    """Serve ``prompts`` (greedy) to the end; K3-K6 counts reset just
    before and read just after. Returns (streams, facts)."""
    torch.cuda.synchronize()
    da.reset_launches()
    hs = [engine.submit(p, max_new_tokens=new) for p in prompts]
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = engine.metrics()
    return [list(map(int, h.tokens)) for h in hs], {
        "wall_s": wall, "tokens_out": m["tokens_out"],
        "tokens_per_s": m["tokens_out"] / wall,
        "steps": m["chunks"], "mean_step_ms": wall / m["chunks"] * 1e3,
        "compile_count": m["compile_count"], "launches": dict(da.launches)}


def _moe_consistency():
    """A 2-layer fp32 MoE forward (append, then decode steps) on the card
    against the same on the CPU from the same weights: logits within
    GRAD_TOL of their max-abs, as the *_consistency phases hold
    gradients."""
    torch.backends.cuda.matmul.allow_tf32 = False
    a = MoEAdapter.from_config(**dict(MOE_CFG, n_layer=2,
                                      dtype=torch.float32))
    cpu = a.init_params(seed=5, device="cpu")
    card = a.prepare_params(_to_device(cpu, "cuda"), "cuda")
    ids = np.random.RandomState(7).randint(0, MOE_CFG["vocab_size"],
                                           size=(2, 96))
    worst = 0.0
    outs = []
    for params, dev in ((card, "cuda"), (cpu, "cpu")):
        cache = a.init_cache(2, 128, device=dev)
        logits, cache = a.prefill_append(
            params, torch.as_tensor(ids, device=dev), cache)
        seq = [logits[:, -1].float().cpu()]
        tok = torch.as_tensor(ids[:, -1], device=dev)
        for _ in range(4):
            logits, cache = a.decode_step(params, tok, cache)
            seq.append(logits.float().cpu())
        outs.append(seq)
    for c, h in zip(*outs):
        worst = max(worst, float((c - h).abs().max())
                    / (GRAD_TOL * float(h.abs().max())))
    if worst > 1.0:
        fail("adapters moe: card vs CPU logits off by {:.3g} of the "
             "limit".format(worst))
    return {"what": "fp32 MoE, 2 layers, B2 T96 + 4 decode steps",
            "max_err_over_limit": worst}


def _to_device(ns, device):
    """A copy of an MoE weights namespace on ``device``."""
    if torch.is_tensor(ns):
        return ns.to(device)
    if isinstance(ns, list):
        return [_to_device(v, device) for v in ns]
    if isinstance(ns, types.SimpleNamespace):
        return types.SimpleNamespace(**{k: _to_device(v, device)
                                        for k, v in vars(ns).items()})
    return ns


def _teacher_logits(model, ids, attn):
    """fp32 logits at every position of ``ids`` through GPT-2's forward,
    the decode kernels (``attn`` None) or the einsum path, in slices of
    the kernels' query-row limit."""
    dev = model.wte.device
    ids = torch.as_tensor(ids, device=dev)[None]
    cache = generation.init_cache(generation.as_gencfg(model.config), 1,
                                  ids.shape[1], device=dev)
    out = []
    for s in range(0, ids.shape[1], da.MAX_QUERY_ROWS):
        logits, cache = generation._forward(
            model, ids[:, s:s + da.MAX_QUERY_ROWS], cache, attn=attn)
        out.append(logits[0].float())
    return torch.cat(out)


def _plain_logits(model, ids, sparse=False):
    """fp32 logits at every position of ``ids`` (one sequence) by a plain
    full-sequence GPT-2 forward, written apart from models/generation.py:
    the weights taken to fp32, one [T, T] mask (causal; with ``sparse``,
    query positions from LONG_CFG's threshold on see only the key blocks
    that FixedSparsityConfig's unidirectional layout shows their block),
    softmax attention in fp32."""
    cfg = model.config
    T, C = len(ids), cfg.n_embd
    nh, hd = cfg.n_head, C // cfg.n_head
    mask = np.tril(np.ones((T, T), dtype=bool))
    if sparse:
        blk, thr = LONG_CFG["block"], LONG_CFG["threshold"]
        layout = np.asarray(FixedSparsityConfig(
            num_heads=1, block=blk,
            num_local_blocks=LONG_CFG["num_local_blocks"],
            num_global_blocks=LONG_CFG["num_global_blocks"],
            attention="unidirectional").make_layout(-(-T // blk) * blk)[0],
            dtype=bool)
        b = np.arange(T) // blk
        mask[thr:] &= layout[b[thr:, None], b[None, :]]
    dev = model.wte.device
    mask = torch.as_tensor(mask, device=dev)

    def lin(h, p):
        return h @ p.kernel.float() + p.bias.float()

    def norm(h, p):
        return F.layer_norm(h, (C,), p.scale.float(), p.bias.float(),
                            cfg.layer_norm_epsilon)

    idx = torch.as_tensor(np.asarray(ids), device=dev, dtype=torch.int64)
    x = model.wte[idx].float() + model.wpe[:T].float()
    for blk in model.blocks():
        q, k, v = lin(norm(x, blk.ln_1), blk.attn.c_attn).split(C, dim=-1)
        q, k, v = (t.reshape(T, nh, hd).transpose(0, 1) for t in (q, k, v))
        att = (q @ k.transpose(1, 2)) / float(hd) ** 0.5
        att = torch.softmax(att.masked_fill(~mask, float("-inf")), dim=-1)
        y = (att @ v).transpose(0, 1).reshape(T, C)
        x = x + lin(y, blk.attn.c_proj)
        h = F.gelu(lin(norm(x, blk.ln_2), blk.mlp.c_fc), approximate="tanh")
        x = x + lin(h, blk.mlp.c_proj)
    return norm(x, model.ln_f) @ model.wte.float().t()


def _rel_diff(a, b):
    return float((a - b).abs().max() / a.abs().max())


def _held_plain(model, prompt, got, sparse, what):
    """A greedy stream held teacher-forced to ``_plain_logits``: at every
    new position the token taken is the reference's argmax, or scores
    within NEAR_TIE of it (printed; a clear choice fails). Returns
    (positions at a near tie, the einsum path's teacher-forced logits over
    the reference's, largest difference over the largest)."""
    ids = np.concatenate([prompt, got])
    ref = _plain_logits(model, ids, sparse)
    n = len(prompt)
    tok = torch.as_tensor(np.asarray(got), device=ref.device,
                          dtype=torch.int64)
    rows = ref[n - 1:n - 1 + len(got)]
    short = rows.max(dim=-1).values - rows.gather(1, tok[:, None])[:, 0]
    worst = float(short.max())
    if worst >= NEAR_TIE:
        j = int(short.argmax())
        fail("{}: token {} scores {:.3e} below the plain reference's "
             "argmax (a clear choice)".format(what, j, worst))
    ties = int((short > 0).sum())
    if ties:
        print("{}: {} tokens at a near tie of the plain reference "
              "(largest shortfall {:.3e})".format(what, ties, worst))
    attn = LONG_ATTN if sparse else generation.EinsumAttention(0, 0, 0, 0)
    return ties, _rel_diff(ref, _teacher_logits(model, ids, attn))


def _einsum_vs_k3(model, prompts, got, ref):
    """bf16, full width: the long-context streams below the threshold
    (einsum attention) against GPT2Adapter's (K3): how many are
    bit-equal, where each other first parts and K3's top-1/top-2 gap
    there, and over each K3 stream (prompt and tokens teacher-forced) the
    einsum path's fp32 logits against K3's, and K3's against the plain
    fp32 reference, each as the largest difference over the largest
    logit. The first is gated at LONG_BF16_TOL: the kernels and the einsum
    round the probabilities to bf16 at different scales (K3 per 128-key
    split, the einsum after the softmax), so the streams may part where
    the logits are that close; ``_longcontext_fp32`` holds the two paths
    to each other in fp32."""
    attn = generation.EinsumAttention(0, 0, 0, 0)
    parts, worst, k3_plain = [], 0.0, 0.0
    for i, (p, g, w) in enumerate(zip(prompts, got, ref)):
        ids = np.concatenate([p, w])
        a = _teacher_logits(model, ids, None)
        b = _teacher_logits(model, ids, attn)
        worst = max(worst, _rel_diff(a, b))
        k3_plain = max(k3_plain, _rel_diff(_plain_logits(model, ids), a))
        if g != w:
            j = next((k for k, (x, y) in enumerate(zip(g, w)) if x != y),
                     min(len(g), len(w)))
            row = a[len(p) - 1 + j]
            top = torch.topk(row, 2).values
            parts.append({"request": i, "token": j,
                          "k3_gap": float(top[0] - top[1]),
                          "logit_diff_there": float(
                              (row - b[len(p) - 1 + j]).abs().max())})
    out = {"bit_equal": len(prompts) - len(parts), "parted": parts,
           "teacher_forced_max_logit_diff_over_max": worst,
           "k3_vs_plain_fp32_over_max": k3_plain, "limit": LONG_BF16_TOL}
    if worst > LONG_BF16_TOL:
        print("adapters longcontext " + json.dumps(out))
        fail("adapters longcontext: the einsum path's logits {:.4g} of the "
             "largest from K3's (limit {})".format(worst, LONG_BF16_TOL))
    return out


def _crossing_vs_plain(model, prompts, got):
    """bf16, full width: over each crossing stream (prompt and tokens
    teacher-forced) the einsum path with the sparse mask against the plain
    fp32 reference with the same block layout, largest difference over
    the largest logit, gated at LONG_BF16_TOL."""
    worst = 0.0
    for p, g in zip(prompts, got):
        ids = np.concatenate([p, g])
        worst = max(worst, _rel_diff(_plain_logits(model, ids, True),
                                     _teacher_logits(model, ids, LONG_ATTN)))
    if worst > LONG_BF16_TOL:
        fail("adapters longcontext: across the threshold the sparse einsum "
             "path's logits {:.4g} of the largest from the plain "
             "reference's (limit {})".format(worst, LONG_BF16_TOL))
    return {"teacher_forced_max_logit_diff_over_max": worst,
            "limit": LONG_BF16_TOL}


def _longcontext_fp32(shorts, longs):
    """fp32, phase 5's model (LONG_FP32, seed 1), the long-context
    adapter (LONG_CFG) on SERVE: below the threshold its greedy streams
    equal GPT2Adapter's (K3) under phase 5's gap rule (``_held_to``);
    every stream, below and across the threshold, is held teacher-forced
    to the plain reference (``_held_plain``: dense below, the block
    layout across) under the same rule; the einsum path's teacher-forced
    logits are within GRAD_TOL of the largest of K3's and of the plain
    reference's."""
    model = GPT2LMHeadModel(GPT2Config(**LONG_FP32), device="cuda", seed=1)
    adapter = LongContextAdapter.from_model(model, **LONG_CFG)
    got_s = InferenceEngine(model, config=dict(SERVE), adapter=adapter) \
        .generate(shorts, max_new_tokens=ADAPTER_NEW)
    got_l = InferenceEngine(model, config=dict(SERVE), adapter=adapter) \
        .generate(longs, max_new_tokens=ADAPTER_NEW)
    ref = init_inference(model, config=dict(SERVE)).generate(
        shorts, max_new_tokens=ADAPTER_NEW)
    attn = generation.EinsumAttention(0, 0, 0, 0)
    vs_k3 = ties = 0
    diffs = {"vs_k3": 0.0, "vs_plain_below": 0.0, "vs_plain_across": 0.0}
    for i, (p, g, w) in enumerate(zip(shorts, got_s, ref)):
        vs_k3 += _held_to(model, p, g, w,
                          "adapters longcontext fp32 request {}".format(i))
        ids = np.concatenate([p, w])
        diffs["vs_k3"] = max(diffs["vs_k3"], _rel_diff(
            _teacher_logits(model, ids, None),
            _teacher_logits(model, ids, attn)))
        n, d = _held_plain(model, p, g, False,
                           "adapters longcontext fp32 below, request "
                           "{}".format(i))
        ties += n
        diffs["vs_plain_below"] = max(diffs["vs_plain_below"], d)
    for i, (p, g) in enumerate(zip(longs, got_l)):
        n, d = _held_plain(model, p, g, True,
                           "adapters longcontext fp32 across, request "
                           "{}".format(i))
        ties += n
        diffs["vs_plain_across"] = max(diffs["vs_plain_across"], d)
    if max(diffs.values()) > GRAD_TOL:
        fail("adapters longcontext fp32: teacher-forced logits {} of the "
             "largest (limit {})".format(diffs, GRAD_TOL))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"what": "fp32, 4 layers at width 1024, seed 1",
            "streams_below": len(shorts), "streams_across": len(longs),
            "below_equal_to_k3": vs_k3, "near_ties_vs_plain": ties,
            "teacher_forced_max_logit_diff_over_max": diffs,
            "limit": GRAD_TOL}


def phase_adapters(card, model):
    """The MoE and long-context adapters at GPT-2 medium's widths, dense
    pools of SERVE's 16 slots. MoE (MOE_CFG, weights made on the card from
    seed 0): graph-served equals eager bit for bit (harvests, the aux
    counters, the pool after GRAPH_CHECK_STEPS steps); a greedy serve
    drops no token, routes n_layer x the tokens its programs touched
    (every slot of every decode step, every prefill column), launches no
    K3-K6; a 2-layer fp32 forward agrees with the CPU's. Long context
    (LONG_CFG over ``model``): graph equals eager; below the threshold
    its teacher-forced logits are held to GPT2Adapter's (K3) and across
    it to the plain reference with the same block layout, both within
    LONG_BF16_TOL (``_einsum_vs_k3``, ``_crossing_vs_plain``); in fp32 at
    4 layers its streams are held to K3's and to the plain reference under
    phase 5's gap rule (``_longcontext_fp32``); ``sparse_decode=False``
    equals the dense einsum bit for bit. Each adapter's tokens/s and mean
    step. One ``adapters`` line."""
    cfg = model.config
    rng = np.random.RandomState(13)
    line = {"adapters": "gpt2-medium widths bf16, dense pool",
            "serve_cfg": SERVE, "card": card}
    # MoE.
    moe_adapter = MoEAdapter.from_config(**MOE_CFG)
    weights = moe_adapter.init_params(seed=0, device="cuda")
    prompts = [rng.randint(0, cfg.vocab_size, size=PROMPT_LENS[i % 2])
               for i in range(ADAPTER_REQUESTS)]

    def build_moe(eager):
        cls = _EagerEngine if eager else InferenceEngine
        return cls(None, weights, config=dict(SERVE), adapter=moe_adapter)

    moe = {"cfg": {k: v for k, v in MOE_CFG.items() if k != "dtype"},
           "expert_bytes": sum(
               b.experts.w1.numel() + b.experts.w2.numel()
               for b in weights.blocks) * 2,
           "graph_vs_eager": _graph_vs_eager_adapter(
               "moe", build_moe, prompts[:4], ADAPTER_NEW)}
    engine = build_moe(False)
    _, facts = _timed_serve(engine, prompts, ADAPTER_NEW)
    m = engine.metrics()
    reg = engine.telemetry
    routed = reg.gauge("moe_tokens_routed").value
    dropped = reg.gauge("moe_tokens_dropped").value
    touched = m["chunks"] * SERVE["chunk_size"] * SERVE["max_slots"] + \
        m["prefill_lanes"] * SERVE["prefill_chunk"]
    facts.update(routed=routed, dropped=dropped,
                 routed_want=MOE_CFG["n_layer"] * touched,
                 expert_load=[reg.gauge("moe_expert_load",
                                        expert=str(i)).value
                              for i in range(MOE_CFG["n_experts"])],
                 load_imbalance=reg.gauge(
                     "moe_expert_load_imbalance").value)
    moe["serve"] = facts
    if dropped != 0 or routed != MOE_CFG["n_layer"] * touched:
        fail("adapters moe: routed {} (want {}), dropped {}".format(
            routed, MOE_CFG["n_layer"] * touched, dropped))
    if any(facts["launches"].values()):
        fail("adapters moe: K3-K6 launched {}".format(facts["launches"]))
    del engine, weights
    gc.collect()
    torch.cuda.empty_cache()
    # GPT-2 medium (K3, lane K5) on the same stream: the dense step the
    # MoE step is compared with.
    _, moe["gpt2_same_stream"] = _timed_serve(
        init_inference(model, config=dict(SERVE)), prompts, ADAPTER_NEW)
    moe["consistency"] = _moe_consistency()
    line["moe"] = moe
    # Long context.
    long_adapter = LongContextAdapter.from_model(model, **LONG_CFG)
    longs = [rng.randint(0, cfg.vocab_size, size=LONG_LENS[i % 2])
             for i in range(ADAPTER_REQUESTS)]
    shorts = [rng.randint(0, cfg.vocab_size, size=SHORT_LENS[i % 2])
              for i in range(ADAPTER_REQUESTS)]

    def build_long(eager, adapter=long_adapter, **extra):
        cls = _EagerEngine if eager else InferenceEngine
        return cls(model, config=dict(SERVE, **extra), adapter=adapter)

    lc = {"cfg": LONG_CFG, "graph_vs_eager": _graph_vs_eager_adapter(
        "longcontext", build_long, longs[:4], ADAPTER_NEW)}
    got_long, lc["serve_crossing"] = _timed_serve(build_long(False), longs,
                                                  ADAPTER_NEW)
    got, lc["serve_below"] = _timed_serve(build_long(False), shorts,
                                          ADAPTER_NEW)
    ref, lc["gpt2_below"] = _timed_serve(
        init_inference(model, config=dict(SERVE)), shorts, ADAPTER_NEW)
    lc["against_gpt2_k3"] = _einsum_vs_k3(model, shorts, got, ref)
    for name in ("serve_crossing", "serve_below"):
        if any(lc[name]["launches"].values()):
            fail("adapters longcontext: K3-K6 launched {}".format(
                lc[name]["launches"]))
    if any(len(t) != ADAPTER_NEW for t in got_long):
        fail("adapters longcontext: a crossing stream is short")
    lc["crossing_against_plain"] = _crossing_vs_plain(model, longs, got_long)
    lc["fp32"] = _longcontext_fp32(shorts, longs)
    dense_einsum = LongContextAdapter.from_model(
        model, **dict(LONG_CFG, threshold=10 ** 6))
    off, _ = _timed_serve(build_long(False, sparse_decode=False),
                          longs[:4], ADAPTER_NEW)
    want, _ = _timed_serve(build_long(False, dense_einsum), longs[:4],
                           ADAPTER_NEW)
    lc["sparse_decode_off_bit_equal"] = _bit_equal(
        longs[:4], off, want, "adapters longcontext sparse_decode=False")
    line["longcontext"] = lc
    print("adapters " + json.dumps(line))
    return line


def _step_ms(engine, prompts, new):
    """Serve ``prompts`` stepping by hand; the median step in ms (device
    work included: each step ends in its harvest read)."""
    for i, p in enumerate(prompts):
        sampled = i % 6 == 5
        engine.submit(p, max_new_tokens=new,
                      temperature=0.8 if sampled else 0.0,
                      top_k=50 if sampled else None, seed=i)
    times = []
    while not engine.idle:
        t0 = time.perf_counter()
        engine.step()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def phase_xray(card, model):
    """The perf x-ray on the dense GPT-2 medium engine (SERVE,
    ``perf_xray`` on, 1 in XRAY_SAMPLE_EVERY steps timed): the serve
    path's stream once (its keys met and measured on their eager first
    runs), mark_warm(), the stream again; every key met has a record with
    flops > 0, bytes and graph-pool bytes; MFU and MBU of every sampled
    record lie in (0, 1]; no recompile; the median step with the x-ray on
    against an engine with it off, on the same stream. Then two replicas
    (FLEET_SERVE, warm) give one section per replica. One ``xray``
    line."""
    cfg = model.config
    prompts = _prompts(XRAY_REQUESTS, cfg.vocab_size, seed=0)
    on = init_inference(model, config=dict(SERVE, perf_xray=True,
                                           xray_sample_every=XRAY_SAMPLE_EVERY))
    off = init_inference(model, config=dict(SERVE))
    for engine in (on, off):
        _step_ms(engine, prompts, XRAY_NEW)
        engine.recompile_detector.mark_warm()
    ms = {"off_1": _step_ms(off, prompts, XRAY_NEW),
          "on_1": _step_ms(on, prompts, XRAY_NEW),
          "on_2": _step_ms(on, prompts, XRAY_NEW),
          "off_2": _step_ms(off, prompts, XRAY_NEW)}
    sec = on.perf_xray()
    keys = sorted(on._programs)
    recs = sec["programs"]
    rows = [{"key": r["input_shapes"][:3], "calls": r["calls"],
             "tokens": r["tokens"], "flops": r["flops"],
             "kernel_flops": r["kernel_flops"],
             "bytes_accessed": r["bytes_accessed"],
             "kernel_bytes": r["kernel_bytes"],
             "graph_pool_bytes": r["graph_pool_bytes"],
             "sampled_step_ms": _ms(r["sampled_step_seconds"]),
             "mfu": r["mfu"], "mbu": r["mbu"]} for r in recs]
    line = {"xray": "gpt2-medium bf16 dense", "serve_cfg": SERVE,
            "card": card, "keys": [list(k) for k in keys],
            "records": rows, "totals": sec["totals"], "hbm": sec["hbm"],
            "decomposition": sec["decomposition"],
            "recompiles": on.metrics()["recompiles"],
            "median_step_ms": ms,
            "xray_cost_share": (ms["on_1"] + ms["on_2"]) /
            (ms["off_1"] + ms["off_2"]) - 1.0}
    sampled = [r for r in recs if r["mfu"] is not None]
    if len(recs) != len(keys) or any(
            r["flops"] <= 0 or r["bytes_accessed"] <= 0 or
            r["graph_pool_bytes"] <= 0 for r in recs):
        print("xray " + json.dumps(line))
        fail("xray: a key met has no full record")
    if not sampled or any(not (0 < r["mfu"] <= 1 and 0 < r["mbu"] <= 1)
                          for r in sampled):
        print("xray " + json.dumps(line))
        fail("xray: MFU/MBU outside (0, 1]")
    if line["recompiles"]:
        fail("xray: {} recompiles with the x-ray on".format(
            line["recompiles"]))
    del on, off
    fleet = ServingFleet(model, n_replicas=2, config=dict(
        FLEET_SERVE, perf_xray=True), start=False)
    try:
        for rep in fleet.replicas:
            _warm_keys(rep.engine, cfg.vocab_size)
        per = fleet.perf_xray()
        line["fleet"] = {str(rid): len(s["programs"])
                         for rid, s in per.items()}
        if sorted(per) != [0, 1] or any(
                len(s["programs"]) != len(FLEET_KEYS) or
                any(p["flops"] <= 0 for p in s["programs"])
                for s in per.values()):
            fail("xray: the fleet's sections {}".format(line["fleet"]))
    finally:
        fleet.close()
        del fleet
        gc.collect()
        torch.cuda.empty_cache()
    print("xray " + json.dumps(line))
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


def _gap(model, ids, sampling=None):
    """Top-1 minus top-2 fp32 logit for the token after ``ids``; with
    ``sampling`` (temperature, top_k, seed), of the scores the Gumbel-max
    draw compares there (``ops.sampling.sample_rows``: the top-k filtered
    logits over the temperature plus the Gumbel noise of (seed, position
    len(ids)))."""
    cache = generation.init_cache(generation.as_gencfg(model.config), 1,
                                  len(ids), device="cuda")
    logits, _ = generation.prefill_forward(
        model, torch.as_tensor(ids, device="cuda")[None], cache)
    scores = logits[0, -1].float()
    if sampling is not None:
        temp, top_k, seed = sampling
        if top_k > 0:
            kth = torch.topk(scores, top_k).values[-1]
            scores = scores.masked_fill(scores < kth, float("-inf"))
        u = positional_uniform(
            torch.tensor([seed], device="cuda"),
            torch.tensor([len(ids)], device="cuda"), scores.numel())[0]
        scores = scores / max(temp, 1e-6) - torch.log(-torch.log(u))
    top = torch.topk(scores, 2).values
    return float(top[0] - top[1])


def _held_to(model, prompt, got, ref, what, sampling=None):
    """Phase 5's rule: ``got`` equals ``ref``, or first differs from it
    where ``ref``'s top-1/top-2 gap is below NEAR_TIE (printed; a clear
    choice fails): of the fp32 logits, or with ``sampling`` of the
    Gumbel-max scores (``_gap``). True when equal."""
    if got == ref:
        return True
    j = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b),
             min(len(got), len(ref)))
    gap = _gap(model, np.concatenate([prompt, ref[:j]]), sampling)
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


def _flash_inputs(B, T, dtype, masked, seed, H=16):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q, k, v, do = (torch.randn(B, H, T, 64, device="cuda", generator=g)
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


def _flash_case(name, B, T, dtype, causal, masked, seed, timed=False, H=16):
    """K1, K2a and K2b on one input against their plain versions; returns
    the case's row (errors, and with ``timed`` the times)."""
    q, k, v, do, mask = _flash_inputs(B, T, dtype, masked, seed, H=H)
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
           "H": H, "T": T, "causal": causal, "mask": masked}
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


def _global_stats_case(name, causal, seed):
    """K1 and K2a/K2b as a ring block runs them (B1 H16, SP_FLASH_T
    queries against a block of SP_FLASH_T keys, bf16): K1's o and lse of
    the block against their plain version, then the block's backward under
    the GLOBAL statistics of an output merged with a second block's partial
    (lse over both, delta = rowsum(dO * O)) against its plain version with
    the same lse and delta; timed there (``_flash_times``: SDPA's times are
    the single-block call's)."""
    from deepspeed_tpu_torch.ops.transformer.ring_attention import _merge

    q, k, v, do, _ = _flash_inputs(1, SP_FLASH_T, torch.bfloat16, False,
                                   seed)
    _, k2, v2, _, _ = _flash_inputs(1, SP_FLASH_T, torch.bfloat16, False,
                                    seed + 1)
    o1, lse1 = at.flash_fwd(q, k, v, None, causal)
    o2, lse2 = at.flash_fwd(q, k2, v2, None, False)
    o, lse = _merge(o1.float(), lse1, o2.float(), lse2)
    o = o.to(q.dtype)
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    fused = at.flash_bwd(q, k, v, None, lse, delta, do, causal, mode="fused")
    split = at.flash_bwd(q, k, v, None, lse, delta, do, causal, mode="split")
    ro, rlse = at.mha_reference(q, k, v, None, causal, return_lse=True)
    refs = at.flash_bwd_reference(q, k, v, None, lse, delta, do, causal)
    mags = at.accumulated_magnitudes(q, k, v, None, lse, delta, do, causal)
    mags1 = at.accumulated_magnitudes(q, k, v, None, lse1, delta, do,
                                      causal)
    torch.cuda.synchronize()
    rtol = FLASH_RTOL[torch.bfloat16]
    row = {"case": name, "dtype": "bfloat16", "B": 1, "H": 16,
           "T": SP_FLASH_T, "causal": causal, "mask": False,
           "statistics": "global (merged with a second block)"}
    outs = {"K1": [(o1, ro, rtol * ro.float().abs() + FLASH_ACC * mags1[0]),
                   (lse1, rlse, 1e-5 * (1 + rlse.abs()))]}
    for kernel, grads in (("K2a", fused), ("K2b", split)):
        outs[kernel] = [(g, r, rtol * r.float().abs() + FLASH_ACC * m)
                        for g, r, m in zip(grads, refs, mags[1:])]
    for kernel, triples in outs.items():
        if not all(bool(torch.isfinite(x).all()) for x, _, _ in triples):
            fail("{} output not finite at {}".format(kernel, name))
        errs = [_err(*t) for t in triples]
        row[kernel] = {"max_abs_err": max(e[0] for e in errs),
                       "max_err_over_limit": max(e[1] for e in errs)}
        if row[kernel]["max_err_over_limit"] > 1.0:
            print("flash " + json.dumps(row))
            fail("{} disagrees with its plain version under global "
                 "statistics at {}".format(kernel, name))
    row.update(_flash_times(q, k, v, do, None, lse, delta, causal))
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
    BERT-large pretraining, then the model-parallel arms' (MP_FLASH_CASES,
    timed), the last GPT-2 XL's (the offload cell, timed), and
    flash_attention_with_lse's rows (phase_flash_lse)."""
    cases = [("train", 8, 1024, torch.bfloat16, True, False),
             ("bert", BERT_B, BERT_T, torch.bfloat16, False, "padding"),
             ("train", 8, 1024, torch.float16, True, False),
             ("train_fp32", 2, 1024, torch.float32, True, False),
             ("noncausal_mask", 2, 1024, torch.bfloat16, False, True),
             ("ragged", 2, 1000, torch.bfloat16, True, False),
             ("ragged_fp32_mask", 2, 1000, torch.float32, True, True),
             ("one_tile", 8, 64, torch.bfloat16, True, False)]
    rows = [_flash_case(*case, seed=i, timed=i < 2)
            for i, case in enumerate(cases)]
    rows += [_flash_case(name, B, MP_T, torch.bfloat16, True, False,
                         seed=len(cases) + 1 + j, timed=True, H=H)
             for j, (name, B, H) in enumerate(MP_FLASH_CASES)]
    rows.append(_flash_case("gpt2_xl", 2, 1024, torch.bfloat16, True, False,
                            seed=len(cases), timed=True, H=25))
    rows += [_global_stats_case(name, causal, seed=40 + i)
             for i, (name, causal) in enumerate(SP_FLASH_CASES)]
    return rows, phase_flash_lse()


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
    del engine, model
    _amp_pair(cfg, batch, card)
    return launches


def _amp_pair(cfg, batch, card):
    """The ``amp`` block's step against the bf16 block's (the JAX engine's
    mapping: bf16 compute on fp32 masters), from the same seeded weights
    at AMP_LAYERS of the model's layers, under K2b (K2a's dq atomics make
    two fused runs differ): the loss and every master after the step bit
    for bit, outside the counted steps."""
    cfg = dataclasses.replace(cfg, n_layer=AMP_LAYERS)
    runs = []
    os.environ["DS_TPU_FLASH_BWD"] = "split"
    try:
        for extra in ({"bf16": {"enabled": True}}, {"amp": {"enabled": True}}):
            config = {k: v for k, v in TRAIN_CONFIG.items() if k != "bf16"}
            config.update(extra)
            engine, _, _, _ = initialize(
                model=GPT2LMHeadModel(cfg, device="cuda", seed=0),
                config_params=config)
            loss = engine.train_batch(batch)
            runs.append((engine.compute_dtype, float(loss),
                         [p.detach().clone() for p in engine._params]))
            del engine
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        del os.environ["DS_TPU_FLASH_BWD"]
    (dt_b, loss_b, p_b), (dt_a, loss_a, p_a) = runs
    equal = sum(1 for a, b in zip(p_a, p_b) if torch.equal(a, b))
    row = {"amp": "O1 vs the bf16 block, one step, K2b, {} layers".format(
               AMP_LAYERS), "compute_dtype":
           str(dt_a), "loss_amp": loss_a, "loss_bf16": loss_b,
           "masters_equal": equal, "masters": len(p_b), "card": card}
    print("train_amp " + json.dumps(row))
    if dt_a != torch.bfloat16 or loss_a != loss_b or equal != len(p_b):
        fail("amp: its step is not the bf16 block's bit for bit: {}".format(
            row))


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


# ------------------------------------------------- ZeRO-Offload (slice 14)

# The offload cell: the JAX package's capacity run (bench.py main_xl): GPT-2
# XL (48 x 1600, 25 heads), remat, dropout 0, bf16, B2 x T1024, Adam 1e-4,
# ZeRO stage 2 + cpu_offload; fed by the engine's dataloader over random
# token rows (numpy, seed 0). wall_clock_breakdown times forward, backward
# and step (each bracketed by a synchronize); steps_per_print is out of
# reach so no report resets the timers.
OFFLOAD_CONFIG = {"train_batch_size": 2,
                  "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
                  "bf16": {"enabled": True},
                  "zero_optimization": {"stage": 2, "cpu_offload": True},
                  "wall_clock_breakdown": True, "steps_per_print": 10 ** 9}
OFFLOAD_B, OFFLOAD_T, OFFLOAD_ROWS = 2, 1024, 16
# Two timed steps: the host-bound arms' depth, kept so the whole smoke
# stays well inside its time limit on a loaded host.
OFFLOAD_WARM, OFFLOAD_TIMED = 1, 2
# The arms beside it (device Adam, stream_gradients) time one step: they
# are there for their peak device memory, which the warm step already
# reaches.
DEVICE_ADAM_WARM, DEVICE_ADAM_TIMED = 1, 1
# Each arm's first train_batch is a warm step: a batch signature's first
# train_batch runs under the x-ray's cost modes (telemetry/xray.py), which
# hold more device memory than a plain step.
STREAM_WARM, STREAM_TIMED = 1, 1
# Host bytes per parameter the offload arms hold at once: master, m, v
# (fp32), the bf16 copy-out and staging (pinned), the streaming arm's bf16
# buffer (the first step's fp32 staging is freed with that step); GPT-2
# large when the host has less (GPT-2 large, 774 M parameters, also has
# head width 64).
OFFLOAD_HOST_BYTES_PER_PARAM = 4 * 3 + 2 * 2 + 2
# Host-op rates: elements per buffer for the cpu_adam / cpu_lamb timings
# (256 MB fp32 buffers, 1 GB for the four: past the host's caches).
HOST_OP_ELEMS = 2 ** 26
# Bytes each host op moves per element: Adam reads p, g, m, v and writes p,
# m, v (28), the fused copy adds a bf16 write (30); LAMB's two passes read
# p, g, m, v and write m, v, the update, then read p and the update and
# write p (40), with the copy 42.
HOST_OP_BYTES = {"cpu_adam": 28, "cpu_adam_copy_bf16": 30, "cpu_lamb": 40,
                 "cpu_lamb_copy_bf16": 42}


def _host_cpu():
    """The host CPU's model name (lscpu), its logical CPUs, torch's intra-op
    threads and OMP_NUM_THREADS (the OpenMP ops' default is every logical
    CPU)."""
    fields = {}
    lscpu = shutil.which("lscpu")
    if lscpu:
        for line in subprocess.run([lscpu], capture_output=True,
                                   text=True).stdout.splitlines():
            key, _, val = line.partition(":")
            fields[key.strip()] = val.strip()
    model = fields.get("Model name", "not reported")
    if model in ("unknown", "not reported"):
        # A virtual machine may hide the name: vendor, family and model.
        model = "{} family {} model {} ({})".format(
            fields.get("Vendor ID"), fields.get("CPU family"),
            fields.get("Model"), "lscpu gives no model name")
    return {"cpu": model, "logical_cpus": os.cpu_count(),
            "torch_threads": torch.get_num_threads(),
            "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS")}


def _proc_kb(path, key):
    with open(path) as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1])
    return 0


def _host_gb():
    """The process's resident set now (VmRSS) and its peak so far
    (getrusage's ru_maxrss), GB."""
    import resource
    return {"rss_gb": _proc_kb("/proc/self/status", "VmRSS") / 2 ** 20,
            "rss_peak_gb": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 2 ** 20}


def _offload_rows(vocab):
    ids = np.random.RandomState(0).randint(0, vocab,
                                           size=(OFFLOAD_ROWS, OFFLOAD_T))
    return [(row, row) for row in ids]


def _offload_arm(cfg, label, zero, warm, timed, card, main_path=False):
    """Train ``cfg`` (seed 0) through initialize(training_data=...) and
    train_batch(data_iter=RepeatingLoader(loader)): ``warm`` steps, then
    ``timed`` each ending in a synchronize. Returns the arm's line. On the
    main path the kernels' launch counts are reset just before the timed
    steps and read just after them. A streamed arm then runs one more
    step by hand (forward, backward, step: its first with the streamed
    backward) and fails if any .grad is left after the backward."""
    t_arm = time.perf_counter()
    model = GPT2LMHeadModel(cfg, device="cuda", seed=0)
    config = dict(OFFLOAD_CONFIG, zero_optimization=zero)
    engine, _, loader, _ = initialize(model=model, config_params=config,
                                      training_data=_offload_rows(
                                          cfg.vocab_size))
    it = RepeatingLoader(loader)
    losses = [engine.train_batch(data_iter=it) for _ in range(warm)]
    if zero.get("stream_gradients"):
        ids, labels = next(it)
        loss = engine(ids, labels)
        engine.backward(loss)
        left = [n for n, p in zip(engine._names, engine._params)
                if p.grad is not None]
        if left:
            fail("{}: {} gradients left on the card after a streamed "
                 "backward ({} ...)".format(label, len(left), left[:3]))
        engine.step()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in ("forward", "backward", "step"):
        engine.timers(name).elapsed(reset=True)
    if main_path:
        at.reset_launches()
    steps, timings = [], []
    per_step = {name: [] for name in ("forward", "backward", "step")}
    # The collector's passes inside the timed steps (generation, seconds,
    # step): the earlier phases leave a large heap, whose full passes show
    # up as host time in whatever phase they interrupt.
    gc_passes, gc_t0 = [], []

    def on_gc(phase, info):
        if phase == "start":
            gc_t0[:] = [time.perf_counter()]
        elif gc_t0:
            gc_passes.append({"gen": info["generation"], "step": len(steps),
                              "s": time.perf_counter() - gc_t0[0]})

    gc.callbacks.append(on_gc)
    try:
        for _ in range(timed):
            t0 = time.perf_counter()
            losses.append(engine.train_batch(data_iter=it))
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
            timings.append(engine.offload_timing())
            for name, ms in per_step.items():
                ms.append(engine.timers(name).elapsed(reset=True) * 1e3)
    finally:
        gc.callbacks.remove(on_gc)
    launches = dict(at.launches)
    phases = {name: float(np.mean(ms)) for name, ms in per_step.items()}
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        fail("{}: non-finite loss {}".format(label, losses))
    mean_s = float(np.mean(steps))
    line = {
        "arm": label, "model": "gpt2 {} x {}, {} heads, remat".format(
            cfg.n_layer, cfg.n_embd, cfg.n_head),
        "params": cfg.num_params(), "batch": OFFLOAD_B, "seq": OFFLOAD_T,
        "zero": zero, "optimizer": type(engine.optimizer).__name__,
        "timed_steps": timed, "step_s": steps, "mean_step_s": mean_s,
        "tokens_per_s": OFFLOAD_B * OFFLOAD_T / mean_s,
        "phase_ms": phases, "phase_ms_per_step": per_step,
        "gc_passes_timed": gc_passes,
        "gc_full_pass_s": sum(g["s"] for g in gc_passes if g["gen"] == 2),
        "peak_device_bytes":
            torch.cuda.max_memory_allocated(), "losses": losses,
        "offload_timing": timings, "host": _host_gb(),
        "arm_s": time.perf_counter() - t_arm, "card": card}
    if main_path:
        line["launches"] = launches
    del engine, model, it, loader
    gc.collect()
    torch.cuda.empty_cache()
    return line


def _host_op_rates():
    """cpu_adam and cpu_lamb over HOST_OP_ELEMS-element fp32 buffers
    (median of 3 after one warm call; LAMB as one tensor), beside the
    host's copy rate (torch's copy of a 4 x HOST_OP_ELEMS fp32 buffer:
    read + write);
    GB/s = HOST_OP_BYTES per element over the time."""
    n = HOST_OP_ELEMS
    p, g, m, v = (torch.randn(n) for _ in range(4))
    out16 = torch.empty(n, dtype=torch.bfloat16)
    adam, lamb = DeepSpeedCPUAdam(lr=1e-4), DeepSpeedCPULamb(lr=1e-4)
    runs = {
        "cpu_adam": lambda: adam.step_flat(p, g, m, v, step=1),
        "cpu_adam_copy_bf16": lambda: adam.step_flat(p, g, m, v, step=1,
                                                     bf16_out=out16),
        "cpu_lamb": lambda: lamb.step_flat(p, g, m, v, step=1),
        "cpu_lamb_copy_bf16": lambda: lamb.step_flat(p, g, m, v, step=1,
                                                     bf16_out=out16)}
    rows = {}
    for name, fn in runs.items():
        fn()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        s = float(np.median(times))
        rows[name] = {"ms": s * 1e3, "gb_s": HOST_OP_BYTES[name] * n / s /
                      1e9}
    src, dst = torch.randn(4 * n), torch.empty(4 * n)
    dst.copy_(src)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        dst.copy_(src)
        times.append(time.perf_counter() - t0)
    rows["host_copy_gb_s"] = 2 * src.numel() * 4 / float(np.median(
        times)) / 1e9
    rows["elements"] = n
    return rows


def phase_offload(card):
    """ZeRO-Offload training at full width (the slice's main path): GPT-2
    XL (or GPT-2 large where the host lacks the memory, said in the line)
    with the fp32 master and Adam's moments in host memory, updated by the
    host C++ Adam chunk by chunk (OFFLOAD_WARM + OFFLOAD_TIMED steps; K1
    twice per layer and step under remat, K2a once); the same model on the
    device's FusedAdam (no offload) and with stream_gradients beside it.
    Fails unless every loss is finite, the launches are exact, the offload
    arm's peak device memory is below the device-Adam arm's and the
    streamed arm's below the offload arm's, and no gradient stays on the
    card after a streamed backward. Returns the main path's launches."""
    avail_gb = _proc_kb("/proc/meminfo", "MemAvailable") / 2 ** 20
    need_gb = GPT2Config.gpt2_xl().num_params() * \
        OFFLOAD_HOST_BYTES_PER_PARAM / 2 ** 30
    kw = dict(dtype=torch.bfloat16, dropout=0.0, remat=True)
    cfg, why = GPT2Config.gpt2_xl(**kw), None
    if avail_gb < 1.25 * need_gb:
        cfg = GPT2Config.gpt2_large(**kw)
        why = "host MemAvailable {:.1f} GB < 1.25 x {:.1f} GB".format(
            avail_gb, need_gb)
    host = dict(_host_cpu(), mem_available_gb=avail_gb,
                host_bytes_needed_gb=need_gb, reduced_to_large=why)
    print("offload_host " + json.dumps(host))
    torch.cuda.empty_cache()
    main = _offload_arm(cfg, "offload", OFFLOAD_CONFIG["zero_optimization"],
                        OFFLOAD_WARM, OFFLOAD_TIMED, card, main_path=True)
    launches = main.pop("launches")
    want = {"flash_fwd": 2 * cfg.n_layer * OFFLOAD_TIMED,
            "flash_bwd_fused": cfg.n_layer * OFFLOAD_TIMED,
            "flash_bwd_split": 0}
    main["launches"] = launches
    main["launches_expected"] = want
    print("offload " + json.dumps(main))
    if launches != want:
        fail("offload: kernel launches {} != {} (K1 twice per layer and "
             "step under remat, K2a once)".format(launches, want))
    device = _offload_arm(cfg, "device_adam", {"stage": 2}, DEVICE_ADAM_WARM,
                          DEVICE_ADAM_TIMED, card)
    print("offload_device_adam " + json.dumps(device))
    streamed = _offload_arm(cfg, "stream_gradients", dict(
        OFFLOAD_CONFIG["zero_optimization"], stream_gradients=True),
        STREAM_WARM, STREAM_TIMED, card)
    print("offload_stream " + json.dumps(streamed))
    rates = _host_op_rates()
    print("host_ops " + json.dumps(dict(rates, host=host["cpu"],
                                        logical_cpus=host["logical_cpus"],
                                        card=card)))
    peaks = [a["peak_device_bytes"] for a in (device, main, streamed)]
    if not peaks[1] < peaks[0]:
        fail("offload: peak device memory {} not below the device-Adam "
             "run's {}".format(peaks[1], peaks[0]))
    if not peaks[2] < peaks[1]:
        fail("offload: stream_gradients' peak device memory {} not below "
             "plain offload's {}".format(peaks[2], peaks[1]))
    return launches


def _offload_step_pair(config, cfg, ids, steps):
    """The same run on the card and on the CPU from the same fp32 weights:
    (loss, fp32 masters by name, skipped steps) per device; the masters are
    read from the host state (or from the module where nothing is
    offloaded). The card runs until its first applied step, at most
    ``steps``; the CPU then runs as many."""
    cpu_model = GPT2LMHeadModel(cfg, device="cpu", seed=2)
    state = cpu_model.state_dict()
    out = []
    for device in ("cuda", "cpu"):
        model = cpu_model if device == "cpu" else \
            GPT2LMHeadModel(cfg, device="cuda", seed=None)
        if device == "cuda":
            model.load_state_dict(state)
        engine, _, _, _ = initialize(model=model, config_params=config,
                                     device=device)
        for _ in range(steps):
            loss = engine(ids, ids)
            engine.backward(loss)
            if config["zero_optimization"].get("stream_gradients") and \
                    any(p.grad is not None for p in engine._params):
                fail("a streamed backward left a gradient on {}".format(
                    device))
            engine.step()
            if device == "cuda" and engine.skipped_steps < \
                    engine.global_steps:
                steps = engine.global_steps
                break
        if engine._offload is not None:
            masters = dict(zip(engine._names, engine._offload.views(
                engine._offload.master)))
        else:
            masters = dict(zip(engine._names, engine._params))
        out.append((float(loss.detach()), {
            n: t.detach().float().cpu().clone() for n, t in masters.items()},
            engine.skipped_steps))
    return out


def _update_ratio(got, want, noisy, lr):
    """The worst |got - want| over the training rule's limit (GRAD_TOL):
    1e-3 lr where the gradient is clear of 0, 2 lr where it is within
    noise of 0, plus two fp32 ulps of the parameter (``lr``: the rate
    times the applied steps)."""
    worst = 0.0
    for n in want:
        limit = torch.where(noisy[n], 2.0 * lr, 1e-3 * lr) + \
            2.0 ** -22 * want[n].abs()
        worst = max(worst, float(((got[n] - want[n]).abs() / limit).max()))
    return worst


def phase_offload_consistency():
    """One offload step card vs CPU at GPT-2 medium widths (4 layers, fp32
    compute, B2 T256): offload Adam, offload LAMB, stream_gradients (fp32
    masters, so stage 0 with cpu_offload, which the JAX config accepts
    without fp16/bf16), and fp16 (stage 2 + cpu_offload) from a loss scale
    of 2**20 until its first applied step; the loss within 1e-5 relative,
    the masters under the training rule (GRAD_TOL), equal skip counts. On
    the card, offload Adam against the device FusedAdam under the same
    rule."""
    cfg = GPT2Config(n_embd=1024, n_layer=4, n_head=16, dtype=torch.float32,
                     dropout=0.0)
    ids = np.random.RandomState(3).randint(0, cfg.vocab_size, size=(2, 256))
    lr = 1e-4
    ref = GPT2LMHeadModel(cfg, device="cpu", seed=2).requires_grad_(True)
    t_ids = torch.from_numpy(ids)
    ref(t_ids, labels=t_ids).backward()
    largest = max(float(p.grad.abs().max()) for p in ref.parameters())
    noisy = {}
    for n, p in ref.named_parameters():
        scale = max(float(p.grad.abs().max()), GRAD_TOL * largest)
        noisy[n] = p.grad.abs() <= 10 * GRAD_TOL * scale
    del ref

    def config(opt, zero, fp16=False):
        c = {"train_batch_size": 2,
             "optimizer": {"type": opt, "params": {"lr": lr}},
             "zero_optimization": zero}
        if fp16:
            c["fp16"] = {"enabled": True, "initial_scale_power": 20}
        return c

    offload0 = {"stage": 0, "cpu_offload": True}
    arms = [("offload_adam", config("Adam", offload0), 1),
            ("offload_lamb", config("Lamb", offload0), 1),
            ("stream_gradients", config("Adam", dict(
                offload0, stream_gradients=True)), 1),
            ("fp16_overflow_skip", config("Adam", {
                "stage": 2, "cpu_offload": True}, fp16=True), 10)]
    rows = {}
    for label, c, steps in arms:
        (lc, mc, sc), (lh, mh, sh) = _offload_step_pair(c, cfg, ids, steps)
        rows[label] = {"loss_card": lc, "loss_cpu": lh,
                       "loss_rel_err": abs(lc - lh) / abs(lh),
                       "skipped": [sc, sh],
                       "param_max_err_over_limit": _update_ratio(
                           mc, mh, noisy, lr)}
        if label == "fp16_overflow_skip" and not 1 <= sc < steps:
            fail("offload fp16: {} skipped steps of at most {} (want at "
                 "least one skip, then an applied step)".format(sc, steps))
        if label == "offload_adam":
            device = _offload_step_pair(config("Adam", {"stage": 0}), cfg,
                                        ids, 1)[0]
            rows["offload_vs_device_adam_card"] = {
                "loss_rel_err": abs(lc - device[0]) / abs(device[0]),
                "param_max_err_over_limit": _update_ratio(
                    mc, device[1], noisy, lr)}
    print("offload_consistency " + json.dumps(rows))
    for label, row in rows.items():
        if row["loss_rel_err"] > 1e-5 or \
                row["param_max_err_over_limit"] > 1.0 or \
                len(set(row.get("skipped", [0]))) != 1:
            fail("offload_consistency: {} disagrees: {}".format(label, row))


# ------------------------------------------------- data parallelism

# Data-parallel ZeRO (phase_data_parallel): GPT-2 medium bf16 at full width
# (DP_LAYERS of its layers), AdamW 1e-4, dropout 0, DP_B x DP_T tokens per
# rank: over
# DP_RANKS ranks the global 8 x 1024 of phase_train and of the JAX
# bench.py:767-789 config (which turns on stage 2 over more than one
# device). The ranks share cuda:0 over gloo (NCCL refuses two ranks on one
# device: "Duplicate GPU detected"), so the collectives go through the
# host and the tokens/s measure the plumbing, not ZeRO's communication.
DP_RANKS, DP_B, DP_T = 2, 4, 1024
# One timed step a stage (and the memory breakdown's one more): the
# host-staged steps' depth, kept so the whole smoke stays well inside its
# time limit on a loaded host.
DP_WARM, DP_TIMED = 1, 1
DP_STAGES = (0, 1, 2, 3)
# GPT-2 medium's width at 4 of its 24 layers in the data- and
# model-parallel phases' ZeRO, TP and interpreter pipeline arms: their
# host-staged collectives scale with the parameters, and the smoke must
# stay inside its time limit with the sequence-parallel phase and the
# offload, Lamb and compiled-pipeline arms at full depth beside them.
# Every path and kernel check stays.
DP_LAYERS = MP_LAYERS = 4
# The rendezvous and every collective of a rank, and the wait for a rank.
DP_TIMEOUT_S = 600
# The fp32 arm: phase 5's reduced depth (4 layers, width 1024), a global
# batch of DP_CHECK_B x DP_CHECK_T over the ranks, one step per stage
# against one process; then an elastic stage-2 checkpoint saved by the
# ranks, loaded by one process, and the next step of each.
DP_CHECK_B, DP_CHECK_T = 4, 256


# ZeRO-Offload and Lamb over the data ranks (their arms of
# phase_data_parallel's launch): GPT-2 medium bf16 at full width and
# DP_ARM_LAYERS of its 24 layers (the depth cut for the smoke's time), ZeRO
# stage 2 over DP_RANKS ranks, 4 x 1024 tokens a rank;
# offload Adam and host Lamb keep each rank's partition of the masters and
# moments on the host, device Lamb on the card. Each arm DP_WARM steps and
# DP_TIMED timed ones, then its fp32 check (DP_CHECK_B x DP_CHECK_T over the
# ranks against one process, the loss within 1e-5 relative).
DP_ARM_LAYERS = 4
DP_ARMS = (("offload", "Adam", True), ("lamb", "Lamb", False),
           ("lamb_host", "Lamb", True))


def _dp_arm_config(arm, micro):
    _, opt, offload = next(a for a in DP_ARMS if a[0] == arm)
    return _dp_config(2, micro, {
        "optimizer": {"type": opt, "params": {"lr": 1e-4}},
        "zero_optimization": {"stage": 2, "cpu_offload": offload}})


def _dp_config(stage, micro, extra=None):
    cfg = {"train_micro_batch_size_per_gpu": micro, "steps_per_print": 1000,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
           "bf16": {"enabled": True},
           "zero_optimization": {"stage": stage}}
    cfg.update(extra or {})
    return cfg


def _dp_ids(B, T, vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, T))


def _dp_full_masters(engine):
    """Every leaf's fp32 master by name (an all-gather when partitioned)."""
    fulls = engine._zero.full_masters() if engine._zero is not None else \
        [p.detach().float() for p in engine._params]
    return {n: f.detach().float().cpu() for n, f in zip(engine._names,
                                                        fulls)}


def _dp_timed_stage(cfg, stage, rank, world, device, arm=None):
    """One stage (or, with ``arm``, one of DP_ARMS at stage 2) at full width
    on this rank: DP_WARM steps (the x-ray's first-signature step among
    them), then DP_TIMED timed steps with the launch counts, gathers and
    collective bytes reset just before and read just after, and the peak
    device memory over them; an offload arm adds its host step's phases."""
    from deepspeed_tpu_torch.parallel import comm

    t_build = time.perf_counter()
    model = GPT2LMHeadModel(cfg, device=device, seed=0)
    config = _dp_arm_config(arm, DP_B) if arm else _dp_config(stage, DP_B)
    engine, _, _, _ = initialize(
        model=model, config_params=config, device=device,
        dist_init_required=False)
    ids = _dp_ids(DP_B * world, DP_T, cfg.vocab_size, 0)
    mine = torch.from_numpy(ids[rank * DP_B:(rank + 1) * DP_B]).to(device)
    t_warm = time.perf_counter()
    losses = [float(engine.train_batch((mine, mine)))
              for _ in range(DP_WARM)]
    warm_s = time.perf_counter() - t_warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    at.reset_launches()
    comm.reset_stats()
    gathers = engine.zero_gathers()
    t0 = time.perf_counter()
    losses += [engine.train_batch((mine, mine)) for _ in range(DP_TIMED)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row = {"stage": stage, "rank": rank,
           "tokens_per_s": DP_B * DP_T * DP_TIMED / wall,
           "global_tokens_per_s": DP_B * DP_T * world * DP_TIMED / wall,
           "mean_step_ms": wall / DP_TIMED * 1e3,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches_per_step": {k: v / DP_TIMED
                                 for k, v in at.launches.items()},
           "gathers_per_step": (engine.zero_gathers() - gathers) / DP_TIMED,
           "collective_bytes_per_step": comm.stats["bytes"] / DP_TIMED,
           "collective_calls_per_step": comm.stats["calls"] / DP_TIMED,
           "losses": [float(x) for x in losses],
           "build_s": t_warm - t_build, "warm_s": warm_s}
    if arm:
        row.update(arm=arm, n_layer=cfg.n_layer,
                   optimizer=type(engine.optimizer).__name__,
                   host_step=engine.offload_timing(),
                   host_state_elems=None if engine._offload is None else
                   engine._offload.total)
    else:
        row["memory"] = _dp_memory_phases(engine, mine)
    row["stage_s"] = time.perf_counter() - t_build
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _dp_memory_phases(engine, ids):
    """One more step after the timed ones, taken apart: the device bytes
    allocated before it (the training state), and the peak and what stays
    allocated over its forward, backward and step."""
    mem = torch.cuda
    out = {"state_bytes": mem.memory_allocated()}
    loss = None
    for name in ("forward", "backward", "step"):
        mem.reset_peak_memory_stats()
        if name == "forward":
            loss = engine(ids, ids)
        elif name == "backward":
            engine.backward(loss)
        else:
            engine.step()
        mem.synchronize()
        out[name + "_peak_bytes"] = mem.max_memory_allocated()
        out["after_" + name + "_bytes"] = mem.memory_allocated()
    return out


def _dp_check(cfg, stage, rank, world, device, ckpt=None, arm=None):
    """The fp32 arm at one stage: one step at dp ``world`` against one
    process on the whole global batch (rank 0 runs it, on the same card),
    the loss within 1e-5 relative and the masters under the training rule
    (``_update_ratio``, the reference's gradients deciding what is noise);
    with ``ckpt``, the ranks save an elastic checkpoint after the step, one
    process loads it, and the next step of each is held to the same rule.
    Both engines compute in fp32 (ZeRO's config needs bf16; as the JAX
    pg_correctness_test reference, the engine's compute dtype is set to
    fp32 before its first forward)."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.parallel import mesh as mesh_lib

    def config(micro):
        return _dp_arm_config(arm, micro) if arm else \
            _dp_config(stage, micro)

    micro = DP_CHECK_B // world
    batches = [_dp_ids(DP_CHECK_B, DP_CHECK_T, cfg.vocab_size, 3 + i)
               for i in range(2)]
    engine, _, _, _ = initialize(
        model=GPT2LMHeadModel(cfg, device=device, seed=2),
        config_params=config(micro), device=device,
        dist_init_required=False)
    engine.compute_dtype = torch.float32

    def step(eng, ids, lo, hi):
        part = torch.from_numpy(ids[lo:hi]).to(device)
        loss = eng(part, part)
        eng.backward(loss)
        grads = None
        if eng._zero is None:
            grads = {n: p.grad.detach().float().cpu().clone()
                     for n, p in zip(eng._names, eng._params)}
        eng.step()
        return loss.detach().float(), grads

    def mean(loss):
        """The group's mean of a rank's loss (a host tensor: gloo)."""
        t = loss.cpu().reshape(1).clone()
        dist.all_reduce(t)
        return float(t) / world

    lo, hi = rank * micro, (rank + 1) * micro
    losses = [mean(step(engine, batches[0], lo, hi)[0])]
    got = [_dp_full_masters(engine)]
    if ckpt is not None:
        engine.save_checkpoint(ckpt, tag="dp")
        losses.append(mean(step(engine, batches[1], lo, hi)[0]))
        got.append(_dp_full_masters(engine))
    row = None
    if rank == 0:
        # One process on the whole batch: a grid without a process group.
        solo = mesh_lib.Mesh((1, 1, 1, 1), 0, None)
        ref, _, _, _ = initialize(
            model=GPT2LMHeadModel(cfg, device=device, seed=2),
            config_params=config(DP_CHECK_B), device=device,
            dist_init_required=False, mesh=solo)
        ref.compute_dtype = torch.float32
        loss, grads = step(ref, batches[0], 0, DP_CHECK_B)
        row = _dp_rule_row(stage, losses[0], float(loss), got[0],
                           _dp_full_masters(ref), grads, 1e-4)
        if arm:
            row["arm"] = arm
        del ref
        if ckpt is not None:
            loaded, _, _, _ = initialize(
                model=GPT2LMHeadModel(cfg, device=device, seed=None),
                config_params=_dp_config(stage, DP_CHECK_B), device=device,
                dist_init_required=False, mesh=solo)
            loaded.compute_dtype = torch.float32
            path, _ = loaded.load_checkpoint(ckpt, tag="dp")
            if path is None or loaded.global_steps != 1:
                fail("data_parallel: the elastic checkpoint did not load at "
                     "dp 1")
            loss, grads = step(loaded, batches[1], 0, DP_CHECK_B)
            row["checkpoint"] = _dp_rule_row(
                stage, losses[1], float(loss), got[1],
                _dp_full_masters(loaded), grads, 2e-4)
            del loaded
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return row


def _dp_rule_row(stage, loss_dp, loss_one, got, want, grads, lr):
    largest = max(float(g.abs().max()) for g in grads.values())
    noisy = {}
    for n, g in grads.items():
        scale = max(float(g.abs().max()), GRAD_TOL * largest)
        noisy[n] = g.abs() <= 10 * GRAD_TOL * scale
    return {"stage": stage, "loss_dp": loss_dp, "loss_one": loss_one,
            "loss_rel_err": abs(loss_dp - loss_one) / abs(loss_one),
            "param_max_err_over_limit": _update_ratio(got, want, noisy, lr)}


def dp_rank(workdir):
    """One rank of phase_data_parallel: started by it with the launcher's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT);
    joins the gloo group, runs the full-width stages and the fp32 arm and
    writes its rows to ``<workdir>/rank_<r>.json``."""
    from deepspeed_tpu_torch.utils.distributed import init_distributed

    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    device = spec["device"]
    init_distributed(dist_backend="gloo", timeout=DP_TIMEOUT_S,
                     device=device, verbose=False)
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    if device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = GPT2Config(dtype=torch.bfloat16, dropout=0.0, **spec["width"])
    rows = [_dp_timed_stage(cfg, s, rank, world, device)
            for s in spec["stages"]]
    arm_cfg = dataclasses.replace(cfg, n_layer=spec["arm_layers"])
    rows += [_dp_timed_stage(arm_cfg, 2, rank, world, device, arm=a[0])
             for a in DP_ARMS]
    check_cfg = GPT2Config(dtype=torch.float32, dropout=0.0,
                           **spec["check_width"])
    t0 = time.perf_counter()
    checks = [_dp_check(check_cfg, s, rank, world, device,
                        ckpt=os.path.join(workdir, "ckpt") if s == 2
                        else None) for s in spec["stages"]]
    checks += [_dp_check(check_cfg, 2, rank, world, device, arm=a[0])
               for a in DP_ARMS]
    if checks[0] is not None:
        checks[0]["arm_s"] = time.perf_counter() - t0
    with open(os.path.join(workdir, "rank_{}.json".format(rank)), "w") as f:
        json.dump({"rows": rows, "checks": checks}, f)
    dist.destroy_process_group()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_launch(spec, workdir):
    """Start DP_RANKS rank processes of ``dp_rank`` with the launcher's
    environment contract (every rank on the one card) and wait for them,
    each within DP_TIMEOUT_S; a rank that fails or times out fails the
    phase (the others are killed)."""
    with open(os.path.join(workdir, "spec.json"), "w") as f:
        json.dump(spec, f)
    here = os.path.dirname(os.path.abspath(__file__))
    port = str(_free_port())
    procs = []
    for r in range(DP_RANKS):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(DP_RANKS),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke as c; "
             "c.dp_rank({!r})".format(workdir)], cwd=here, env=env))
    deadline = time.monotonic() + DP_TIMEOUT_S
    failed = None
    for r, p in enumerate(procs):
        try:
            rc = p.wait(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            rc = "timeout"
        if rc != 0 and failed is None:
            failed = (r, rc)
            for q in procs:
                if q.poll() is None:
                    q.kill()
    for p in procs:
        p.wait()
    if failed is not None:
        fail("data_parallel: rank {} ended with {}".format(*failed))
    out = []
    for r in range(DP_RANKS):
        with open(os.path.join(workdir, "rank_{}.json".format(r))) as f:
            out.append(json.load(f))
    return out


def _nccl_arm(device, backend="nccl"):
    """One ZeRO-2 step of a 2-layer fp32 GPT-2 at width 1024 as a one-rank
    NCCL group (partitioned over one rank: the reduce-scatter, all-gather
    and all-reduce run as NCCL calls on CUDA tensors), against the same
    step without a process group (no partition, no collective)."""
    import datetime

    import torch.distributed as dist

    from deepspeed_tpu_torch.parallel import comm
    from deepspeed_tpu_torch.parallel.mesh import Mesh

    # init_distributed starts no group for one rank (as the JAX package):
    # the one-rank group is made here.
    store = tempfile.mkdtemp()
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(store, "store"),
        rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    cfg = GPT2Config(n_embd=1024, n_layer=2, n_head=16, dtype=torch.float32,
                     dropout=0.0)
    ids = torch.from_numpy(_dp_ids(2, 256, cfg.vocab_size, 5)).to(device)
    out = []
    try:
        for grouped in (True, False):
            mesh = None if grouped else Mesh((1, 1, 1, 1), 0, None)
            engine, _, _, _ = initialize(
                model=GPT2LMHeadModel(cfg, device=device, seed=4),
                config_params=_dp_config(2, 2), device=device,
                dist_init_required=False, mesh=mesh)
            engine.compute_dtype = torch.float32
            comm.reset_stats()
            loss = engine(ids, ids)
            engine.backward(loss)
            engine.step()
            out.append((float(loss.detach()), dict(comm.stats),
                        engine.dp_group is not None,
                        _dp_full_masters(engine)))
            del engine
        # Over one rank no leaf is partitioned (the JAX rule at dp 1), so
        # the step's collective is the all-reduce: the reduce-scatter and
        # all-gather the partitioned steps call run here on CUDA tensors.
        flat = torch.randn(3 * 2 ** 20, device=device)
        group = dist.group.WORLD
        comm.reset_stats()
        same = bool(torch.equal(comm.reduce_scatter(flat, group), flat)) and \
            bool(torch.equal(comm.all_gather(flat, group), flat))
        direct = {k: comm.stats[k] for k in comm.KINDS}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    (l_nccl, stats, grouped, m_nccl), (l_one, _, _, m_one) = out
    worst = max(float((m_nccl[n] - m_one[n]).abs().max() /
                      (1e-3 * 1e-4 + 2.0 ** -22 * m_one[n].abs().max()))
                for n in m_one)
    row = {"backend": backend, "world": 1, "grouped": grouped,
           "step_collectives": {k: stats[k] for k in comm.KINDS},
           "step_collective_bytes": stats["bytes"],
           "direct_collectives": direct, "direct_equal": same,
           "loss": l_nccl, "loss_rel_err": abs(l_nccl - l_one) / abs(l_one),
           "param_max_err_over_1e-3_lr": worst}
    if not grouped or stats["all_reduce"] < 1 or not same or \
            direct["reduce_scatter"] != 1 or direct["all_gather"] != 1:
        fail("data_parallel: the NCCL arm's collectives did not run or "
             "disagree: {}".format(row))
    if row["loss_rel_err"] > 1e-5 or worst > 1.0:
        fail("data_parallel: the NCCL step disagrees with one process: "
             "{}".format(row))
    return row


def phase_data_parallel(card):
    """ZeRO stages 0-3 over DP_RANKS gloo ranks on the card (module
    docstring, phase 15); returns each stage's per-rank K1/K2a/K2b
    launches per step."""
    gc.collect()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    workdir = tempfile.mkdtemp()
    try:
        ranks = _dp_launch({
            "device": "cuda:0", "stages": list(DP_STAGES),
            "arm_layers": DP_ARM_LAYERS,
            "width": {"n_embd": 1024, "n_layer": DP_LAYERS, "n_head": 16},
            "check_width": {"n_embd": 1024, "n_layer": 4, "n_head": 16}},
            workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    rows = [row for r in ranks for row in r["rows"]]
    by = {(row.get("arm", row["stage"]), row["rank"]): row for row in rows}
    for row in rows:
        print("data_parallel " + json.dumps(dict(row, card=card)))
        n_layer = row.get("n_layer", DP_LAYERS)
        per = row["launches_per_step"]
        if per["flash_fwd"] != n_layer or per["flash_bwd_fused"] != n_layer \
                or per["flash_bwd_split"] != 0:
            fail("data_parallel: rank {} stage {} launched {} per step "
                 "(want K1 and K2a {} each)".format(
                     row["rank"], row.get("arm", row["stage"]), per, n_layer))
        if not np.isfinite(row["losses"]).all():
            fail("data_parallel: non-finite loss {}".format(row))
        want = 1 + 2 * n_layer if row["stage"] == 3 else 0
        if row["gathers_per_step"] != want:
            fail("data_parallel: stage {} gathered {} times a step (want "
                 "{})".format(row["stage"], row["gathers_per_step"], want))
    for r in range(DP_RANKS):
        for key in (0,) + tuple(a[0] for a in DP_ARMS):
            if by[(key, r)]["losses"] != by[(key, 0)]["losses"]:
                fail("data_parallel: the ranks' {} mean losses differ"
                     .format(key))
        for arm, opt, offload in DP_ARMS:
            row = by[(arm, r)]
            if (row["host_step"] is not None) != offload or \
                    row["optimizer"] != ("DeepSpeedCPU" if offload else
                                         "Fused") + opt:
                fail("data_parallel: arm {} ran {} (host step {})".format(
                    arm, row["optimizer"], row["host_step"]))
        for s in (1, 3):
            if not by[(s, r)]["peak_mem_bytes"] < by[(0, r)][
                    "peak_mem_bytes"]:
                fail("data_parallel: rank {} stage {} peak {} is not below "
                     "stage 0's {}".format(r, s, by[(s, r)]["peak_mem_bytes"],
                                           by[(0, r)]["peak_mem_bytes"]))
    checks = [c for c in ranks[0]["checks"] if c is not None]
    if sorted(c["arm"] for c in checks if "arm" in c) != \
            sorted(a[0] for a in DP_ARMS):
        fail("data_parallel: an arm's check did not run: {}".format(checks))
    print("data_parallel_check " + json.dumps(
        {"fp32": "width 1024, 4 layers, B{} T{} over {} ranks vs one "
                 "process (stages 0-3; offload Adam, device Lamb and host "
                 "Lamb at stage 2)".format(DP_CHECK_B, DP_CHECK_T, DP_RANKS),
         "stages": checks, "card": card}))
    for c in checks + [c["checkpoint"] for c in checks
                       if "checkpoint" in c]:
        if c["loss_rel_err"] > 1e-5 or c["param_max_err_over_limit"] > 1.0:
            fail("data_parallel: dp {} disagrees with one process at stage "
                 "{}: {}".format(DP_RANKS, c["stage"], c))
    if not any("checkpoint" in c for c in checks):
        fail("data_parallel: no elastic checkpoint was checked")
    nccl = _nccl_arm("cuda:0")
    print("data_parallel_nccl " + json.dumps(dict(nccl, card=card)))
    return {s: [by[(s, r)]["launches_per_step"] for r in range(DP_RANKS)]
            for s in DP_STAGES + tuple(a[0] for a in DP_ARMS)}


# ------------------------------------------------- model parallelism

# Model parallelism (phase_model_parallel): GPT-2 medium bf16 at full width
# (MP_LAYERS of its layers), AdamW 1e-4, dropout 0, the training cell's
# global 8 x 1024
# (JAX bench.py:767-789), over MP_RANKS gloo ranks on cuda:0 started by
# the port's launcher: tensor parallelism (mp 2, each rank the whole
# batch) and the 1F1B pipeline (2 stages, MP_GAS micro-batches of
# MP_B / MP_GAS, the tied embedding). Collectives and p2p go through the
# host: their times measure the plumbing, not NVLink.
MP_RANKS, MP_B, MP_T, MP_GAS = 2, 8, 1024, 4
# K1/K2a's inputs in those arms (phase_flash holds them there): (case, B,
# H) of a TP rank (the batch, half of GPT-2 medium's 16 heads) and of a PP
# micro-batch.
MP_FLASH_CASES = (("mp_tp_rank", MP_B, 16 // MP_RANKS),
                  ("mp_pp_micro", MP_B // MP_GAS, 16))
MP_WARM, MP_TIMED = 1, 2
MP_TIMEOUT_S = 900
# The fp32 arm: 4 layers at width 1024, a global batch of MP_CHECK_B x
# MP_CHECK_T; TP one step, PP one step of 2 micro-batches, each against
# one process on the same card.
MP_CHECK_B, MP_CHECK_T, MP_CHECK_GAS = 4, 256, 2


# The compiled pipeline (its arm of phase_model_parallel's launch): GPT-2
# medium bf16 at full width and depth, CP_LAYERS / MP_RANKS blocks a stage
# stacked, the untied head, the same MP_GAS micro-batches of MP_B / MP_GAS
# x MP_T; each stage's tick programs CUDA graphs. The graph-vs-eager pair
# runs under K2b at MP_LAYERS layers and dropout CP_DROPOUT (GPT2Config's
# default), CP_GRAPH_STEPS steps each; the fp32 arm is the compiled engine
# against the interpreter under the other fp32 checks' rule (losses 1e-5
# relative, every parameter of the stage under the training rule),
# MP_CHECK_GAS micro-batches, CP_CHECK_STEPS steps.
CP_LAYERS = 24
CP_GRAPH_STEPS = CP_CHECK_STEPS = 2
CP_DROPOUT = 0.1


def _mp_config(micro, gas=1):
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": gas, "steps_per_print": 1000,
            "gradient_clipping": 1.0, "bf16": {"enabled": True},
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}}}


def _mp_counters():
    from deepspeed_tpu_torch.parallel import comm
    from deepspeed_tpu_torch.runtime.pipe import engine as pe
    from deepspeed_tpu_torch.runtime.pipe import p2p

    at.reset_launches()
    comm.reset_stats()
    p2p.reset_stats()
    pe.reset_stats()


def _mp_read(steps):
    from deepspeed_tpu_torch.parallel import comm
    from deepspeed_tpu_torch.runtime.pipe import engine as pe
    from deepspeed_tpu_torch.runtime.pipe import p2p

    return {"launches_per_step": {k: v / steps
                                  for k, v in at.launches.items()},
            "all_reduce_bytes_per_step": comm.stats["all_reduce_bytes"] /
            steps,
            "all_reduce_calls_per_step": comm.stats["all_reduce"] / steps,
            "broadcast_bytes_per_step": comm.stats["broadcast_bytes"] / steps,
            "p2p_bytes_per_step": (p2p.stats["send_bytes"] +
                                   p2p.stats["recv_bytes"]) / steps,
            "p2p_calls_per_step": (p2p.stats["sends"] + p2p.stats["recvs"]) /
            steps,
            "tied_bytes_per_step": pe.stats["tied_bytes"] / steps}


def _mp_timed(run, cfg, rank, world, device):
    """One arm at full width on this rank: MP_WARM steps (the x-ray's
    first-signature step among them), then MP_TIMED timed ones with the
    launch counts, collective, p2p and tied bytes reset just before and
    read just after, and the peak device memory over them."""
    from deepspeed_tpu_torch.models.gpt2 import gpt2_pipeline
    from deepspeed_tpu_torch.parallel.mesh import build_mesh

    t_build = time.perf_counter()
    ids = torch.from_numpy(_dp_ids(MP_B, MP_T, cfg.vocab_size, 0)).to(device)
    if run == "tp":
        engine, _, _, _ = initialize(
            model=GPT2LMHeadModel(cfg, device=device, seed=0),
            config_params=_mp_config(MP_B), device=device,
            mesh=build_mesh(num_mp=world), dist_init_required=False)

        def step():
            return float(engine.train_batch((ids, ids)))
    else:
        engine, _, _, _ = initialize(
            model=gpt2_pipeline(cfg, num_stages=world),
            config_params=_mp_config(MP_B // MP_GAS, MP_GAS), device=device,
            mesh=build_mesh(num_pp=world), dist_init_required=False)
        mb = MP_B // MP_GAS
        micro = [(ids[i * mb:(i + 1) * mb],) * 2 for i in range(MP_GAS)]

        def step():
            return engine.train_batch(data_iter=iter(micro))
    held = sum(p.numel() for p in engine._params)
    t_warm = time.perf_counter()
    losses = [step() for _ in range(MP_WARM)]
    warm_s = time.perf_counter() - t_warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _mp_counters()
    t0 = time.perf_counter()
    losses += [step() for _ in range(MP_TIMED)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row = {"run": run, "rank": rank, "params_held": held,
           "tokens_per_s": MP_B * MP_T * MP_TIMED / wall,
           "mean_step_ms": wall / MP_TIMED * 1e3,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "state_bytes": torch.cuda.memory_allocated(),
           "losses": losses, "build_s": t_warm - t_build, "warm_s": warm_s}
    row.update(_mp_read(MP_TIMED))
    row["arm_s"] = time.perf_counter() - t_build
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _cp_engine(cfg, device, world, micro, gas, compiled=True):
    from deepspeed_tpu_torch.models.gpt2 import gpt2_pipeline
    from deepspeed_tpu_torch.parallel.mesh import build_mesh

    engine, _, _, _ = initialize(
        model=gpt2_pipeline(cfg, num_stages=world, tied=False,
                            compiled=compiled),
        config_params=_mp_config(micro, gas), device=device,
        mesh=build_mesh(num_pp=world), dist_init_required=False)
    return engine


def _cp_micro(B, T, gas, vocab, seed, device):
    ids = torch.from_numpy(_dp_ids(B, T, vocab, seed)).to(device)
    mb = B // gas
    return [(ids[i * mb:(i + 1) * mb],) * 2 for i in range(gas)]


def _cp_timed(cfg, rank, world, device):
    """The compiled pipeline at full width and depth on this rank: MP_WARM
    steps (the tick programs' warm-up and capture), then MP_TIMED timed
    ones with the launches, p2p bytes, graph replays and the allocated
    bytes after each step read over them."""
    t_build = time.perf_counter()
    engine = _cp_engine(cfg, device, world, MP_B // MP_GAS, MP_GAS)
    micro = _cp_micro(MP_B, MP_T, MP_GAS, cfg.vocab_size, 0, device)
    held = sum(p.numel() for p in engine._params)
    t_warm = time.perf_counter()
    losses = [engine.train_batch(data_iter=iter(micro))
              for _ in range(MP_WARM)]
    warm_s = time.perf_counter() - t_warm
    captures = engine.graph_captures
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _mp_counters()
    replays = engine.graph_replays
    allocated = []
    t0 = time.perf_counter()
    for _ in range(MP_TIMED):
        losses.append(engine.train_batch(data_iter=iter(micro)))
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated())
    wall = time.perf_counter() - t0
    row = {"run": "compiled", "rank": rank, "n_layer": cfg.n_layer,
           "blocks_per_stage": engine._blocks_per_stage, "params_held": held,
           "tokens_per_s": MP_B * MP_T * MP_TIMED / wall,
           "mean_step_ms": wall / MP_TIMED * 1e3,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "allocated_after_timed_steps": allocated,
           "graph_captures_step1": captures,
           "graph_captures": engine.graph_captures,
           "graph_replays_per_step": (engine.graph_replays - replays) /
           MP_TIMED, "losses": losses, "build_s": t_warm - t_build,
           "warm_s": warm_s}
    row.update(_mp_read(MP_TIMED))
    row["arm_s"] = time.perf_counter() - t_build
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _cp_graph_vs_eager(cfg, rank, world, device):
    """The compiled engine with its tick graphs against the same engine run
    eagerly (``_graphs`` off), from the same seeded weights, under K2b, at
    dropout CP_DROPOUT: every loss and every parameter of the stage after
    CP_GRAPH_STEPS steps, bit for bit (each tick draws fresh seeds, so a
    replay that redrew its capture's masks would part from eager). A third
    run, one eager step at dropout 0, shows the masks were drawn (its loss
    differs)."""
    micro = _cp_micro(MP_B, MP_T, MP_GAS, cfg.vocab_size, 1, device)
    runs = []
    os.environ["DS_TPU_FLASH_BWD"] = "split"
    try:
        for graphs, rate, steps in ((True, CP_DROPOUT, CP_GRAPH_STEPS),
                                    (False, CP_DROPOUT, CP_GRAPH_STEPS),
                                    (False, 0.0, 1)):
            engine = _cp_engine(dataclasses.replace(cfg, dropout=rate),
                                device, world, MP_B // MP_GAS, MP_GAS)
            engine._graphs = graphs
            at.reset_launches()
            losses = [engine.train_batch(data_iter=iter(micro))
                      for _ in range(steps)]
            runs.append((losses, [p.detach().clone() for p in
                                  engine._params], engine.graph_captures,
                         dict(at.launches)))
            del engine
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        del os.environ["DS_TPU_FLASH_BWD"]
    (lg, pg, cg, ng), (le, pe, ce, ne), (l0, _, _, _) = runs
    return {"rank": rank, "n_layer": cfg.n_layer, "steps": CP_GRAPH_STEPS,
            "dropout": CP_DROPOUT, "losses_graph": lg, "losses_eager": le,
            "loss_no_dropout": l0[0],
            "params_equal": sum(1 for a, b in zip(pg, pe)
                                if torch.equal(a, b)),
            "params": len(pg), "captures": [cg, ce],
            "launches": [ng, ne]}


def _cp_check(cfg, rank, world, device):
    """The fp32 arm: the compiled engine against the interpreter from the
    same seeded layers, CP_CHECK_STEPS steps of MP_CHECK_GAS micro-batches
    of MP_CHECK_B / MP_CHECK_GAS x MP_CHECK_T: every loss, and every
    parameter of this stage's layers after the steps under the training
    rule (the interpreter's first gradients mark the leaves within noise
    of 0)."""
    micro = _cp_micro(MP_CHECK_B, MP_CHECK_T, MP_CHECK_GAS, cfg.vocab_size,
                      3, device)
    losses, flat, grads = {}, {}, []
    for compiled in (True, False):
        engine = _cp_engine(cfg, device, world, MP_CHECK_B // MP_CHECK_GAS,
                            MP_CHECK_GAS, compiled=compiled)
        if not compiled:
            real = engine._update

            def spy(g, inv_scale, skip=(), real=real, engine=engine):
                if not grads:
                    grads.append(_pipe_flat(engine, cfg, [
                        t.detach().float() * inv_scale for t in g]))
                return real(g, inv_scale, skip)
            engine._update = spy
        losses[compiled] = [engine.train_batch(data_iter=iter(micro))
                            for _ in range(CP_CHECK_STEPS)]
        flat[compiled] = _pipe_flat(engine, cfg)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    row = _mp_rule_row("compiled", losses[True][-1], losses[False][-1],
                       flat[True], flat[False], grads[0],
                       1e-4 * CP_CHECK_STEPS)
    row.update(rank=rank, losses_compiled=losses[True],
               losses_interpreter=losses[False],
               loss_rel_err=max(abs(a - b) / abs(b) for a, b in zip(
                   losses[True], losses[False])))
    return row


def _mp_rule_row(run, loss, loss_one, got, want, grads, lr):
    largest = max(float(g.abs().max()) for g in grads.values())
    noisy = {}
    for n in want:
        scale = max(float(grads[n].abs().max()), GRAD_TOL * largest)
        noisy[n] = grads[n].abs() <= 10 * GRAD_TOL * scale
    return {"run": run, "loss": loss, "loss_one": loss_one,
            "loss_rel_err": abs(loss - loss_one) / abs(loss_one),
            "leaves": len(want),
            "param_max_err_over_limit": _update_ratio(got, want, noisy, lr)}


def _mp_reference(cfg, params, batches, device):
    """One process on the card (a grid without a process group): one step
    over ``batches`` (gradient accumulation over them); its mean loss, the
    fp32 masters and the step's gradients by name."""
    from deepspeed_tpu_torch.parallel import mesh as mesh_lib

    solo = mesh_lib.Mesh((1, 1, 1, 1), 0, None)
    ref, _, _, _ = initialize(
        model=GPT2LMHeadModel(cfg, device=device, seed=None),
        model_parameters=params, device=device, mesh=solo,
        config_params=_mp_config(batches[0].shape[0], len(batches)),
        dist_init_required=False)
    ref.compute_dtype = torch.float32
    losses = []
    for i, ids in enumerate(batches):
        loss = ref(ids, ids)
        ref.backward(loss)
        if i == len(batches) - 1:
            grads = {n: p.grad.detach().float().cpu().clone()
                     for n, p in zip(ref._names, ref._params)}
        ref.step()
        losses.append(float(loss.detach()))
    want = {n: p.detach().float().cpu() for n, p in zip(ref._names,
                                                         ref._params)}
    del ref
    return float(np.mean(losses)), want, grads


def _pipe_flat(engine, cfg, tensors=None):
    """This stage's layers' full fp32 weights (or the per-parameter
    ``tensors``, e.g. gradients) under GPT2LMHeadModel's names (the tied
    head's copy as ``wte``/``wpe``)."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + k + ".")
            else:
                out[path + k] = torch.from_numpy(v)

    for idx in sorted(engine._layer_params):
        if not engine._layer_params[idx]:
            continue
        tree = engine._layer_full(idx, engine._params if tensors is None
                                  else tensors)
        if 1 <= idx <= cfg.n_layer:
            walk(tree["Block_0"], "h_{}.".format(idx - 1))
        else:
            walk(tree, "")
    return out


def _mp_check(run, cfg, rank, world, device):
    """The fp32 arm of ``run``: one step over the ranks against one process
    on the same card, from the same weights (phase 5's training rule;
    TP's masters gathered, the reference on rank 0; PP's each stage's
    layers, the reference on each rank)."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.models.gpt2 import (gpt2_layer_params,
                                                 gpt2_pipeline)
    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    from deepspeed_tpu_torch.runtime.utils import flax_tree

    params = flax_tree(GPT2LMHeadModel(cfg, device="cpu", seed=2))
    ids = torch.from_numpy(_dp_ids(MP_CHECK_B, MP_CHECK_T, cfg.vocab_size,
                                   3)).to(device)
    if run == "tp":
        engine, _, _, _ = initialize(
            model=GPT2LMHeadModel(cfg, device=device, seed=None),
            model_parameters=params, config_params=_mp_config(MP_CHECK_B),
            device=device, mesh=build_mesh(num_mp=world),
            dist_init_required=False)
        engine.compute_dtype = torch.float32
        loss = engine(ids, ids)
        engine.backward(loss)
        engine.step()
        loss = float(loss.detach())
        got = {n: f.cpu() for n, f in zip(engine._names,
                                          engine._full_masters())}
        batches = [ids]
    else:
        mb = MP_CHECK_B // MP_CHECK_GAS
        batches = [ids[i * mb:(i + 1) * mb] for i in range(MP_CHECK_GAS)]
        engine, _, _, _ = initialize(
            model=gpt2_pipeline(cfg, num_stages=world),
            model_parameters=gpt2_layer_params(params, cfg),
            config_params=_mp_config(mb, MP_CHECK_GAS), device=device,
            mesh=build_mesh(num_pp=world), dist_init_required=False)
        loss = engine.train_batch(data_iter=iter([(b, b) for b in batches]))
        got = _pipe_flat(engine, cfg)
    del engine
    row = None
    if rank == 0 or run == "pp":
        loss_one, want, grads = _mp_reference(cfg, params, batches, device)
        want = {n: want[n] for n in got}
        row = _mp_rule_row(run, loss, loss_one, got, want, grads, 1e-4)
        row["rank"] = rank
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return row


# ------------------------------------- serving and MoE over the model ranks

# Tensor-parallel serving (its arm of phase_model_parallel's launch): the
# serve path's model (GPT-2 medium bf16 at full width and depth, seed 0;
# 8 of its 16 heads a rank) on the dense pool under SERVE, N_REQUESTS
# requests of TP_PROMPT tokens (one prefill lane each: the host-staged
# exchange, about 1 ms an all-reduce and 48 a forward, sets the arm's time,
# and 64/256-token prompts would take 95 steps), TP_NEW new (for the smoke's
# time), every sixth sampled, over MP_RANKS model ranks. Each step is a chain of captured
# segments split at the all-reduces of the row-parallel projections, two a
# layer and forward. Held to one process's streams on the same rank and
# requests: where a stream first parts from it, the ranks' teacher-forced
# fp32 logits there within TP_BF16_TOL of one process's largest (a choice
# flips only where the gap is inside the logits' difference). The fp32
# check at TP_CHECK_WIDTH: the ranks' streams against one process's under
# phase 5's rule (NEAR_TIE). Graph vs eager: the same two ranks, the bf16
# model at MP_LAYERS layers, GRAPH_CHECK_STEPS steps of
# phase_graph_vs_eager's dense mix, bit for bit.
TP_BF16_TOL = LONG_BF16_TOL
TP_PROMPT, TP_NEW = 32, 32
TP_CHECK_WIDTH = {"n_embd": 1024, "n_layer": 4, "n_head": 16}
TP_CHECK_REQUESTS, TP_CHECK_NEW = 6, 32
# Expert-parallel MoE serving: MOE_CFG over the model ranks (4 of the 8
# experts a rank), ADAPTER_REQUESTS x ADAPTER_NEW in bf16, timed; in fp32 at
# EP_CHECK_LAYERS the ranks' greedy streams with and without expert
# parallelism against one process's (phase 5's rule), and the expert load
# gauges equal.
EP_CHECK_NEW, EP_CHECK_LAYERS = 32, 2
# MoE training (its arm of the launch): the JAX test's model at width 1024,
# MOE_TRAIN["blocks"] blocks of a dense layer and an MoE of 8 experts of a
# 1024 -> 4096 -> 1024 tanh-GELU MLP (top-1, capacity factor 1.25, the aux
# loss at 0.01), B8 x T1024 tokens of random features, bf16 on fp32
# masters, AdamW 1e-4: mp 2 (4 experts a rank, each rank the batch) and
# dp 2 (each rank half, gated over the global batch). The fp32 check: one
# of the blocks, B4 x T256 at capacity factor 0.5 (tokens drop),
# MOE_CHECK_STEPS steps of each arm against one process on the whole
# batch: losses 1e-5 relative, every gathered parameter under the training
# rule.
MOE_TRAIN = dict(width=1024, ffn=4096, experts=8, blocks=4, classes=16,
                 capacity_factor=1.25, B=8, T=1024)
MOE_CHECK = dict(B=4, T=256, capacity_factor=0.5, blocks=1)
MOE_CHECK_STEPS = 2


def _submit_mix(engine, prompts, new):
    """phase_serve's mix: every sixth request sampled (0.8, top-k 50)."""
    return [engine.submit(p, max_new_tokens=new,
                          temperature=0.8 if i % 6 == 5 else 0.0,
                          top_k=50 if i % 6 == 5 else None, seed=i)
            for i, p in enumerate(prompts)]


def _segments_want(engine):
    """The segments the programs met should hold: one, plus one per
    all-reduce (two a layer for each forward a program runs: chunk_size
    decode iterations, and the prefill lane's where the key has it)."""
    n_layer = engine._gcfg.n_layer
    return sum(1 + 2 * n_layer * (engine.config.chunk_size + int(lane))
               for lane, _, _ in engine._programs)


def _tf_logits(weights, cfg, ids, device, tp=None):
    """Teacher-forced fp32 logits of the token after ``ids`` (a fresh
    one-row cache of this rank's heads)."""
    from deepspeed_tpu_torch.parallel.mesh import kv_heads
    heads = kv_heads(cfg.n_head, tp.size, tp.rank)[1] if tp is not None \
        else cfg.n_head
    shape = (cfg.n_layer, 1, heads, len(ids), cfg.n_embd // cfg.n_head)
    cache = {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "pos": torch.zeros(1, dtype=torch.int32, device=device)}
    logits, _ = generation.prefill_forward(
        weights, torch.as_tensor(np.asarray(ids), device=device)[None],
        cache)
    return logits[0, -1].float()


def _parted(prompts, got, ref):
    """(request, first index where ``got`` parts from ``ref``, context)
    for each stream that parts."""
    out = []
    for i, (p, g, r) in enumerate(zip(prompts, got, ref)):
        if g != r:
            j = next((k for k, (a, b) in enumerate(zip(g, r)) if a != b),
                     min(len(g), len(r)))
            out.append((i, j, np.concatenate([p, np.asarray(r[:j])])))
    return out


def _agree(streams, group=None):
    """Fail-safe lockstep: every rank's ``streams`` are the same (before
    any collective that depends on them); raises where they differ."""
    from deepspeed_tpu_torch.parallel import comm
    seen = comm.all_gather_object(json.dumps(streams), group)
    if len(set(seen)) != 1:
        raise RuntimeError("the ranks' streams differ")


def _tp_serve(rank, world, device, spec):
    """The tensor-parallel serving arm at full width (above): its row."""
    from deepspeed_tpu_torch.inference.kv_pool import pool_nbytes
    from deepspeed_tpu_torch.parallel import comm
    from deepspeed_tpu_torch.parallel.mesh import build_mesh

    t_build = time.perf_counter()
    cfg = GPT2Config(dtype=torch.bfloat16, **spec["tp_width"])
    model = GPT2LMHeadModel(cfg, device=device, seed=0)
    mesh = build_mesh(num_mp=world)
    one_pool = init_pool(generation.as_gencfg(cfg), SERVE["max_slots"],
                         SERVE["max_len"], slack=SERVE["prefill_chunk"],
                         device=device)
    one_bytes = pool_nbytes(one_pool)
    del one_pool
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=spec["tp_prompt"])
               for _ in range(spec["tp_requests"])]
    # One process's streams on the same requests, and its step time.
    one = init_inference(model, config=SERVE, device=device)
    ref = _submit_mix(one, prompts, spec["tp_new"])
    t0 = time.perf_counter()
    one.run()
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    one_steps = one.metrics()["chunks"]
    ref = [r.tokens for r in ref]
    del one
    engine = init_inference(model, config=SERVE, device=device, mesh=mesh)
    reqs = _submit_mix(engine, prompts, spec["tp_new"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    da.reset_launches()
    comm.reset_stats()
    steps = []
    t0 = time.perf_counter()
    while not engine.idle:
        engine.step()
        steps.append((engine.compile_count, engine.graph_segments,
                      torch.cuda.memory_allocated()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = engine.metrics()
    launches = dict(da.launches)
    reduces = dict(comm.stats)
    streams = [r.tokens for r in reqs]
    _agree(streams)
    # The step that captured the last program met; none after it.
    warm = min(i for i, s in enumerate(steps) if s[0] == steps[-1][0])
    # Where a stream parts from one process's: the logits there.
    parted = []
    one = generation.ServingWeights(model)
    for i, j, ctx in _parted(prompts, streams, ref):
        tp_l = _tf_logits(engine._params, cfg, ctx, device, engine._tp)
        one_l = _tf_logits(one, cfg, ctx, device)
        parted.append({"request": i, "at": j,
                       "logit_err_over_largest": float(
                           (tp_l - one_l).abs().max() / one_l.abs().max())})
    ctx = np.concatenate([prompts[0], np.asarray(streams[0][:-1])])
    tp_l = _tf_logits(engine._params, cfg, ctx, device, engine._tp)
    one_l = _tf_logits(one, cfg, ctx, device)
    row = {"arm": "tp_serve", "rank": rank, "mp": world,
           "requests": len(prompts), "prompt_tokens": spec["tp_prompt"],
           "new_tokens": spec["tp_new"],
           "wall_s": wall, "tokens_out": m["tokens_out"],
           "tokens_per_s": m["tokens_out"] / wall,
           "one_process_tokens_per_s": m["tokens_out"] / one_wall,
           "one_process_mean_step_ms": one_wall / one_steps * 1e3,
           "streams_identical_to_one_process": len(prompts) - len(parted),
           "steps": m["chunks"], "mean_step_ms": wall / m["chunks"] * 1e3,
           "decode_steps": m["decode_steps"],
           "prefill_lanes": m["prefill_lanes"],
           "launches": launches,
           "compile_count": m["compile_count"],
           "graph_replays": m["graph_replays"],
           "graph_segments": m["graph_segments"],
           "graph_segments_want": _segments_want(engine),
           "warm_step": warm,
           "segments_after_warm": sorted({s[1] for s in steps[warm:]}),
           "allocated_after_warm": sorted({s[2] for s in steps[warm + 1:]}),
           "capture_ms": m["capture_ms"],
           "all_reduce_calls_per_step": reduces["all_reduce"] / m["chunks"],
           "all_reduce_bytes_per_step": reduces["all_reduce_bytes"] /
           m["chunks"],
           "all_reduce_calls_per_forward":
           reduces["all_reduce"] / max(m["decode_steps"] +
                                       m["prefill_lanes"], 1),
           "kv_hbm_bytes": m["kv_hbm_bytes"],
           "kv_hbm_bytes_one_process": one_bytes,
           "kv_heads": int(engine._pool["k"].shape[2]),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "streams": streams, "parted": parted,
           "logit_err_over_largest_request0": float(
               (tp_l - one_l).abs().max() / one_l.abs().max()),
           "ttft_p50_ms": m["ttft_p50_ms"]}
    del engine, one, model
    gc.collect()
    torch.cuda.empty_cache()
    row["arm_s"] = time.perf_counter() - t_build
    return row


def _tp_serve_check(rank, world, device, spec):
    """fp32 at TP_CHECK_WIDTH: the ranks' streams and one process's (phase
    5's rule; the gaps where they part, of one process's logits)."""
    from deepspeed_tpu_torch.parallel.mesh import build_mesh

    cfg = GPT2Config(dtype=torch.float32, **spec["tp_check_width"])
    model = GPT2LMHeadModel(cfg, device=device, seed=1)
    prompts = _prompts(TP_CHECK_REQUESTS, cfg.vocab_size, seed=1)
    tp = init_inference(model, config=SERVE, device=device,
                        mesh=build_mesh(num_mp=world))
    got = _submit_mix(tp, prompts, TP_CHECK_NEW)
    tp.run()
    one = init_inference(model, config=SERVE, device=device)
    want = _submit_mix(one, prompts, TP_CHECK_NEW)
    one.run()
    got, want = [r.tokens for r in got], [r.tokens for r in want]
    _agree(got)
    gaps = []
    for i, j, ctx in _parted(prompts, got, want):
        samp = (0.8, 50, i) if i % 6 == 5 else None
        gaps.append({"request": i, "at": j,
                     "gap": _gap(model, ctx, samp)})
    del tp, one, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"arm": "tp_serve_fp32", "rank": rank,
            "requests": len(prompts), "identical": len(prompts) - len(gaps),
            "parted": gaps}


def _tp_graph_vs_eager(rank, world, device, spec):
    """The segmented programs against the same programs run eagerly, on
    the same ranks: every step's harvest and the pool after them, bit for
    bit."""
    from deepspeed_tpu_torch.parallel.mesh import build_mesh

    cfg = GPT2Config(dtype=torch.bfloat16, **spec["tp_graph_width"])
    model = GPT2LMHeadModel(cfg, device=device, seed=0)
    mesh = build_mesh(num_mp=world)
    prompts = _prompts(GRAPH_CHECK_REQUESTS, cfg.vocab_size, seed=3)
    runs = []
    for engine in (init_inference(model, config=SERVE, device=device,
                                  mesh=mesh),
                   _EagerEngine(model, config=SERVE, device=device,
                                mesh=mesh)):
        for i, p in enumerate(prompts):
            kw = {"temperature": 0.8, "seed": i,
                  "top_k": 50 if i == 2 else None} if i % 3 == 2 else {}
            engine.submit(p, max_new_tokens=NEW_TOKENS, **kw)
        snaps = []
        for _ in range(GRAPH_CHECK_STEPS):
            engine.step()
            snaps.append(engine._last_snap)
        torch.cuda.synchronize()
        runs.append((engine, snaps))
    (graphed, got), (eager, want) = runs
    harvest_equal = all(np.array_equal(a[n], b[n]) for a, b in
                        zip(got, want) for n in a)
    pool_differs = [n for n in graphed._pool
                    if not torch.equal(graphed._pool[n], eager._pool[n])]
    row = {"arm": "tp_graph_vs_eager", "rank": rank,
           "steps": GRAPH_CHECK_STEPS, "n_layer": cfg.n_layer,
           "harvests_identical": harvest_equal, "pool_differs": pool_differs,
           "tokens_compared": int(sum(s["valid"].sum() for s in got)),
           "compile_count": graphed.compile_count,
           "graph_segments": graphed.graph_segments,
           "graph_segments_want": _segments_want(graphed),
           "graph_replays": graphed.graph_replays}
    del graphed, eager, runs, model
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _moe_gauges(engine):
    return {k: v for k, v in engine.telemetry.snapshot().items()
            if k.startswith("moe_")}


def _moe_streams(engine, prompts, new):
    reqs = [engine.submit(p, max_new_tokens=new) for p in prompts]
    engine.run()
    return [r.tokens for r in reqs]


def _moe_gap(adapter, weights, ids, device):
    cache = adapter.init_cache(1, len(ids), device=device)
    logits, _ = adapter.prefill_append(
        weights, torch.as_tensor(np.asarray(ids), device=device)[None],
        cache)
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def _ep_serve(rank, world, device, spec):
    """Expert-parallel MoE serving (above): the bf16 timed row and the fp32
    check's row."""
    from deepspeed_tpu_torch.parallel import comm
    from deepspeed_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(num_mp=world)
    moe_cfg = dict(MOE_CFG, **spec["moe_width"])
    adapter = MoEAdapter.from_config(**moe_cfg)
    weights = adapter.init_params(seed=0, device=device)
    prompts = _prompts(ADAPTER_REQUESTS, moe_cfg["vocab_size"], seed=2)
    engine = InferenceEngine(None, weights, config=SERVE, device=device,
                             adapter=adapter, mesh=mesh)
    reqs = [engine.submit(p, max_new_tokens=spec["moe_new"])
            for p in prompts]
    torch.cuda.synchronize()
    da.reset_launches()
    comm.reset_stats()
    t0 = time.perf_counter()
    while not engine.idle:
        engine.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = engine.metrics()
    launches, reduces = dict(da.launches), dict(comm.stats)
    streams = [r.tokens for r in reqs]
    _agree(streams)
    timed = {"arm": "ep_serve", "rank": rank, "mp": world,
             "requests": len(prompts), "new_tokens": spec["moe_new"],
             "tokens_per_s": m["tokens_out"] / wall,
             "mean_step_ms": wall / m["chunks"] * 1e3, "steps": m["chunks"],
             "experts_held": int(engine._params.blocks[0].experts.w1
                                 .shape[0]),
             "kv_heads": int(engine._pool["k"].shape[2]),
             "compile_count": m["compile_count"],
             "graph_segments": m["graph_segments"],
             "all_reduce_calls_per_step": reduces["all_reduce"] /
             m["chunks"],
             "launches": launches, "gauges": _moe_gauges(engine)}
    del engine, weights
    a32 = MoEAdapter.from_config(**dict(moe_cfg, dtype=torch.float32,
                                        n_layer=min(moe_cfg["n_layer"],
                                                    EP_CHECK_LAYERS)))
    w32 = a32.init_params(seed=1, device=device)
    out = {}
    for name, config, on in (("ep", SERVE, mesh),
                             ("no_ep", dict(SERVE, expert_parallel=False),
                              mesh), ("one", SERVE, None)):
        eng = InferenceEngine(None, w32, config=config, device=device,
                              adapter=a32, mesh=on)
        out[name] = {"streams": _moe_streams(eng, prompts, EP_CHECK_NEW),
                     "gauges": _moe_gauges(eng),
                     "experts_held": int(eng._params.blocks[0].experts.w1
                                         .shape[0])}
        del eng
    gaps = {}
    for name in ("ep", "no_ep"):
        gaps[name] = [{"request": i, "at": j,
                       "gap": _moe_gap(a32, w32, ctx, device)}
                      for i, j, ctx in _parted(prompts, out[name]["streams"],
                                               out["one"]["streams"])]
    del w32
    gc.collect()
    torch.cuda.empty_cache()
    check = {"arm": "ep_serve_fp32", "rank": rank,
             "identical": {n: len(prompts) - len(gaps[n]) for n in gaps},
             "parted": gaps,
             "gauges_equal": {n: out[n]["gauges"] == out["one"]["gauges"]
                              for n in ("ep", "no_ep")},
             "experts_held": {n: out[n]["experts_held"] for n in out}}
    return timed, check


def _moe_train_model(blocks, width, ffn, experts, classes, capacity_factor):
    """The JAX ``test_moe_model_trains_with_engine`` model grown to
    ``blocks`` blocks (flax names: ``Dense_i``, ``MoE_i``, the head
    ``Dense_<blocks>``); x [B, T, width] features, y [B, T] labels; the
    mean cross-entropy plus 0.01 x the blocks' aux losses."""
    from torch import nn

    from deepspeed_tpu_torch.moe import MoE

    class Dense(nn.Module):
        def __init__(self, n_in, n_out):
            super().__init__()
            self.kernel = nn.Parameter(torch.randn(n_in, n_out) *
                                       n_in ** -0.5)
            self.bias = nn.Parameter(torch.zeros(n_out))

        def forward(self, x):
            return x.to(self.kernel.dtype) @ self.kernel + self.bias

    class _MLP(nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = Dense(width, ffn)
            self.Dense_1 = Dense(ffn, width)

        def forward(self, x):
            return self.Dense_1(F.gelu(self.Dense_0(x), approximate="tanh"))

    class Model(nn.Module):
        def __init__(self):
            super().__init__()
            for i in range(blocks):
                setattr(self, "Dense_{}".format(i), Dense(width, width))
                setattr(self, "MoE_{}".format(i), MoE(
                    width, _MLP, num_experts=experts, k=1,
                    capacity_factor=capacity_factor))
            setattr(self, "Dense_{}".format(blocks), Dense(width, classes))

        def forward(self, x, y):
            h, aux = x, 0.0
            for i in range(blocks):
                h = getattr(self, "Dense_{}".format(i))(h)
                out, l_aux, _ = getattr(self, "MoE_{}".format(i))(h)
                h, aux = h + out, aux + l_aux
            logits = getattr(self, "Dense_{}".format(blocks))(h).float()
            return F.cross_entropy(logits.reshape(-1, classes),
                                   y.reshape(-1).long()) + 0.01 * aux

    return Model()


def _moe_batch(B, T, width, classes, seed, device):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(B, T, width).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, classes, size=(B, T)))
    return x.to(device), y.to(device)


def _moe_engine(arm, world, params, micro, device, capacity_factor, kw):
    """The training engine of ``arm`` over the ranks: mp 2 or dp 2 on
    ``_moe_train_model``'s model of ``kw`` (MOE_TRAIN's keys)."""
    from deepspeed_tpu_torch.parallel.mesh import build_mesh

    model = _moe_train_model(kw["blocks"], kw["width"], kw["ffn"],
                             kw["experts"], kw["classes"], capacity_factor)
    mesh = build_mesh(num_mp=world if arm == "mp2" else 1)
    engine, _, _, _ = initialize(
        model=model, model_parameters=params, config_params=_mp_config(micro),
        device=device, mesh=mesh, dist_init_required=False)
    return engine


def _moe_step(engine, x, y):
    """One step on this rank's rows; the data group's mean loss."""
    from deepspeed_tpu_torch.parallel import comm
    dp, r = engine.dp_world_size, engine.dp_rank
    per = x.shape[0] // dp
    loss = engine(x[r * per:(r + 1) * per], y[r * per:(r + 1) * per])
    engine.backward(loss)
    engine.step()
    mean = loss.detach().float().reshape(1).clone()
    if dp > 1:
        comm.all_reduce(mean, engine.dp_group, mean=True)
    return float(mean)


def _moe_train(rank, world, device, spec):
    """MoE training (above): a timed row per arm, then the fp32 check's."""
    from deepspeed_tpu_torch.parallel import comm
    from deepspeed_tpu_torch.runtime.utils import flax_tree

    kw = dict(MOE_TRAIN, **spec["moe_train"])
    torch.manual_seed(0)
    with torch.device(device):
        params = flax_tree(_moe_train_model(
            kw["blocks"], kw["width"], kw["ffn"], kw["experts"],
            kw["classes"], kw["capacity_factor"]))
    x, y = _moe_batch(kw["B"], kw["T"], kw["width"], kw["classes"], 4,
                      device)
    rows = []
    for arm in ("mp2", "dp2"):
        t_build = time.perf_counter()
        micro = kw["B"] if arm == "mp2" else kw["B"] // world
        engine = _moe_engine(arm, world, params, micro, device,
                             kw["capacity_factor"], kw)
        losses = [_moe_step(engine, x, y) for _ in range(MP_WARM)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        comm.reset_stats()
        t0 = time.perf_counter()
        losses += [_moe_step(engine, x, y) for _ in range(MP_TIMED)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows.append({
            "arm": "moe_train_" + arm, "rank": rank,
            "tokens": kw["B"] * kw["T"], "losses": losses,
            "mean_step_ms": wall / MP_TIMED * 1e3,
            "tokens_per_s": kw["B"] * kw["T"] * MP_TIMED / wall,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "expert_shapes": {n: list(p.shape) for n, p in
                              zip(engine._names, engine._params)
                              if ".experts." in n and n.startswith("MoE_0")},
            "all_reduce_bytes_per_step": comm.stats["all_reduce_bytes"] /
            MP_TIMED,
            "all_gather_bytes_per_step": comm.stats["all_gather_bytes"] /
            MP_TIMED,
            "arm_s": time.perf_counter() - t_build})
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return rows + _moe_train_check(rank, world, device, spec)


def _moe_train_check(rank, world, device, spec):
    """The fp32 check (above): each arm's losses and gathered parameters
    after MOE_CHECK_STEPS steps against one process on the whole batch
    (rank 0 holds the reference)."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.parallel import mesh as mesh_lib
    from deepspeed_tpu_torch.runtime.utils import flax_tree

    kw = dict(MOE_TRAIN, **spec["moe_train"])
    kw["blocks"] = min(kw["blocks"], MOE_CHECK["blocks"])
    cf = MOE_CHECK["capacity_factor"]
    B, T = spec.get("moe_check_bt", (MOE_CHECK["B"], MOE_CHECK["T"]))
    torch.manual_seed(1)
    with torch.device(device):
        params = flax_tree(_moe_train_model(
            kw["blocks"], kw["width"], kw["ffn"], kw["experts"],
            kw["classes"], cf))
    x, y = _moe_batch(B, T, kw["width"], kw["classes"], 5, device)
    got = {}
    for arm in ("mp2", "dp2"):
        engine = _moe_engine(arm, world, params,
                             B if arm == "mp2" else B // world, device, cf,
                             kw)
        engine.compute_dtype = torch.float32
        losses = [_moe_step(engine, x, y) for _ in range(MOE_CHECK_STEPS)]
        got[arm] = (losses, {n: f.cpu() for n, f in
                             zip(engine._names, engine._full_masters())})
        del engine
    rows = []
    if rank == 0:
        solo = mesh_lib.Mesh((1, 1, 1, 1), 0, None)
        model = _moe_train_model(kw["blocks"], kw["width"], kw["ffn"],
                                 kw["experts"], kw["classes"], cf)
        ref, _, _, _ = initialize(
            model=model, model_parameters=params, device=device, mesh=solo,
            config_params=_mp_config(B), dist_init_required=False)
        ref.compute_dtype = torch.float32
        want_losses = []
        for i in range(MOE_CHECK_STEPS):
            loss = ref(x, y)
            ref.backward(loss)
            if i == 0:
                # The first gradients mark the leaves within noise of 0
                # (as _cp_check's).
                grads = {n: p.grad.detach().float().cpu().clone()
                         for n, p in zip(ref._names, ref._params)}
            ref.step()
            want_losses.append(float(loss.detach()))
        want = {n: p.detach().float().cpu() for n, p in zip(ref._names,
                                                             ref._params)}
        del ref
        # Top-1 slots a layer against the tokens it routes: fewer slots
        # than tokens, so every layer drops.
        slots = kw["experts"] * -(-int(B * T * cf) // kw["experts"])
        for arm, (losses, masters) in got.items():
            row = _mp_rule_row("moe_" + arm, losses[-1], want_losses[-1],
                               masters, want, grads,
                               1e-4 * MOE_CHECK_STEPS)
            worst = max(want, key=lambda n: _mp_rule_row(
                "", 0.0, 1.0, {n: masters[n]}, {n: want[n]}, grads,
                1e-4 * MOE_CHECK_STEPS)["param_max_err_over_limit"])
            row.update(worst_leaf=worst, losses=losses,
                       losses_one=want_losses,
                       loss_rel_err=max(abs(a - b) / abs(b) for a, b in
                                        zip(losses, want_losses)),
                       capacity_factor=cf, tokens=B * T,
                       expert_slots=slots, rank=rank)
            rows.append(row)
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return rows


def mp_rank(workdir):
    """One rank of phase_model_parallel, started by the port's launcher
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): joins the
    gloo group, runs the TP and PP arms at full width and their fp32
    checks, and writes its rows to ``<workdir>/rank_<r>.json``."""
    from deepspeed_tpu_torch.utils.distributed import init_distributed

    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    device = spec["device"]
    init_distributed(dist_backend="gloo", timeout=MP_TIMEOUT_S,
                     device=device, verbose=False)
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPT2Config(dtype=torch.bfloat16, dropout=0.0, **spec["width"])
    rows = [_mp_timed(run, cfg, rank, world, device)
            for run in ("tp", "pp")]
    rows.append(_cp_timed(dataclasses.replace(cfg, n_layer=CP_LAYERS), rank,
                          world, device))
    t0 = time.perf_counter()
    graph = _cp_graph_vs_eager(cfg, rank, world, device)
    graph["arm_s"] = time.perf_counter() - t0
    check_cfg = GPT2Config(dtype=torch.float32, dropout=0.0,
                           **spec["check_width"])
    t0 = time.perf_counter()
    checks = [_mp_check(run, check_cfg, rank, world, device)
              for run in ("tp", "pp")]
    checks.append(_cp_check(check_cfg, rank, world, device))
    check_s = time.perf_counter() - t0
    # Serving over the model ranks, expert-parallel MoE serving, MoE
    # training.
    t0 = time.perf_counter()
    serving = [_tp_serve(rank, world, device, spec),
               _tp_serve_check(rank, world, device, spec),
               _tp_graph_vs_eager(rank, world, device, spec)]
    serve_s = [time.perf_counter() - t0]
    serving += _ep_serve(rank, world, device, spec)
    serve_s.append(time.perf_counter() - t0 - serve_s[0])
    t0 = time.perf_counter()
    moe = _moe_train(rank, world, device, spec)
    with open(os.path.join(workdir, "rank_{}.json".format(rank)), "w") as f:
        json.dump({"rows": rows, "checks": checks, "graph": graph,
                   "check_s": check_s, "serving": serving,
                   "serve_s": serve_s, "moe": moe,
                   "moe_s": time.perf_counter() - t0}, f)
    dist.destroy_process_group()


def _mp_launch(spec, workdir):
    """MP_RANKS rank processes of ``mp_rank`` (``_rank_launch``)."""
    return _rank_launch("model-parallel-rank", spec, workdir, MP_RANKS,
                        MP_TIMEOUT_S, "model_parallel")


def phase_model_parallel(card):
    """Tensor parallelism and the pipeline over MP_RANKS gloo ranks on the
    card (module docstring, phase 16); returns each arm's per-rank
    K1/K2a/K2b launches per step."""
    gc.collect()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    workdir = tempfile.mkdtemp()
    n_layer = MP_LAYERS
    try:
        ranks = _mp_launch({
            "device": "cuda:0",
            "width": {"n_embd": 1024, "n_layer": n_layer, "n_head": 16},
            "check_width": {"n_embd": 1024, "n_layer": 4, "n_head": 16},
            "tp_width": {"n_embd": 1024, "n_layer": 24, "n_head": 16},
            "tp_requests": N_REQUESTS, "tp_new": TP_NEW,
            "tp_prompt": TP_PROMPT,
            "tp_check_width": TP_CHECK_WIDTH,
            "tp_graph_width": {"n_embd": 1024, "n_layer": n_layer,
                               "n_head": 16},
            "moe_width": {}, "moe_new": ADAPTER_NEW, "moe_train": {}},
            workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    # K1 and K2a a step and rank; the compiled ticks run K1 twice a block
    # and micro-batch (the forward tick and the backward's recompute).
    blocks = CP_LAYERS // MP_RANKS * MP_GAS
    want = {"tp": (n_layer, n_layer),
            "pp": (n_layer // MP_RANKS * MP_GAS,) * 2,
            "compiled": (2 * blocks, blocks)}
    by = {}
    for r in ranks:
        for row in r["rows"]:
            by[(row["run"], row["rank"])] = row
            print("model_parallel " + json.dumps(dict(row, card=card)))
            per = row["launches_per_step"]
            if (per["flash_fwd"], per["flash_bwd_fused"]) != \
                    want[row["run"]] or per["flash_bwd_split"] != 0:
                fail("model_parallel: rank {} {} launched {} per step (want "
                     "K1, K2a {})".format(row["rank"], row["run"], per,
                                          want[row["run"]]))
            if not np.isfinite(row["losses"]).all():
                fail("model_parallel: non-finite loss {}".format(row))
    for run in ("tp", "pp", "compiled"):
        if len({tuple(by[(run, r)]["losses"]) for r in range(MP_RANKS)}) != 1:
            fail("model_parallel: the ranks' {} losses differ".format(run))
    for r in range(MP_RANKS):
        row = by[("compiled", r)]
        mem = row["allocated_after_timed_steps"]
        if row["graph_captures_step1"] != 2 or row["graph_captures"] != 2 \
                or row["graph_replays_per_step"] != 2 * MP_GAS or \
                len(set(mem)) != 1:
            fail("model_parallel: rank {}'s tick graphs: captures {} after "
                 "step 1, {} in all (want 2, no re-capture), {} replays a "
                 "step (want {}), allocated bytes {} (want no growth)".format(
                     r, row["graph_captures_step1"], row["graph_captures"],
                     row["graph_replays_per_step"], 2 * MP_GAS, mem))
    graphs = [r["graph"] for r in ranks]
    print("model_parallel_graph " + json.dumps(
        {"compiled": "graph vs eager, K2b, width 1024, {} layers, {} "
                     "steps, dropout {}".format(n_layer, CP_GRAPH_STEPS,
                                                CP_DROPOUT),
         "ranks": graphs, "card": card}))
    for g in graphs:
        if g["losses_graph"] != g["losses_eager"] or \
                g["params_equal"] != g["params"] or g["captures"] != [2, 0] \
                or g["launches"][0] != g["launches"][1] or \
                g["loss_no_dropout"] == g["losses_graph"][0]:
            fail("model_parallel: the compiled pipeline's graphs are not "
                 "eager bit for bit: {}".format(g))
    checks = [c for r in ranks for c in r["checks"] if c is not None]
    print("model_parallel_check " + json.dumps(
        {"fp32": "width 1024, 4 layers, B{} T{}: TP mp {} and PP {} stages "
                 "(gas {}) vs one process".format(
                     MP_CHECK_B, MP_CHECK_T, MP_RANKS, MP_RANKS,
                     MP_CHECK_GAS),
         "compiled": "the compiled pipeline vs the interpreter, {} steps, "
                     "the same rule".format(CP_CHECK_STEPS),
         "runs": checks, "check_s": [r["check_s"] for r in ranks],
         "card": card}))
    if sorted({c["run"] for c in checks}) != ["compiled", "pp", "tp"]:
        fail("model_parallel: a check did not run: {}".format(checks))
    for c in checks:
        if c["loss_rel_err"] > 1e-5 or c["param_max_err_over_limit"] > 1.0:
            fail("model_parallel: {} disagrees with its reference (one "
                 "process; the compiled pipeline: the interpreter): {}"
                 .format(c["run"], c))
    out = {run: [by[(run, r)]["launches_per_step"]
                 for r in range(MP_RANKS)]
           for run in ("tp", "pp", "compiled")}
    out["serve"] = _model_parallel_serving(ranks, card)
    _model_parallel_moe(ranks, card)
    print("model_parallel_seconds " + json.dumps(
        [{"rank": i, "checks_s": r["check_s"],
          "tp_serve_and_ep_serve_s": r["serve_s"], "moe_train_s": r["moe_s"]}
         for i, r in enumerate(ranks)]))
    return out


def _model_parallel_serving(ranks, card):
    """Check and print the serving arms of phase_model_parallel's ranks;
    returns each rank's tensor-parallel serving row (its K3/K5 launches)."""
    rows = {(r["arm"], r["rank"]): r for k in ranks for r in k["serving"]}
    serve = [rows[("tp_serve", r)] for r in range(MP_RANKS)]
    for row in serve:
        shown = {k: v for k, v in row.items() if k != "streams"}
        print("model_parallel_serve " + json.dumps(dict(shown, card=card)))
        n_layer = 24
        want = dict.fromkeys(row["launches"], 0)
        want["decode"] += n_layer * row["decode_steps"]
        want["paged"] += n_layer * row["prefill_lanes"]
        if row["launches"] != want:
            fail("model_parallel serve: rank {} launched {} (want K3 = "
                 "n_layer x decode steps, K5 = n_layer x prefill lanes: "
                 "{})".format(row["rank"], row["launches"], want))
        if row["compile_count"] > MAX_PROGRAMS or \
                row["graph_replays"] != row["steps"] - row["compile_count"] \
                or row["graph_segments"] != row["graph_segments_want"] or \
                len(row["segments_after_warm"]) != 1 or \
                len(row["allocated_after_warm"]) > 1:
            fail("model_parallel serve: rank {}'s programs: compile_count {}"
                 ", replays {} over {} steps, segments {} (want {}), "
                 "segments after the last capture {}, allocated bytes {} "
                 "(want no growth)".format(
                     row["rank"], row["compile_count"], row["graph_replays"],
                     row["steps"], row["graph_segments"],
                     row["graph_segments_want"], row["segments_after_warm"],
                     row["allocated_after_warm"]))
        if row["kv_heads"] != 16 // MP_RANKS:
            fail("model_parallel serve: rank {} holds {} heads".format(
                row["rank"], row["kv_heads"]))
        for p in row["parted"] + [{"logit_err_over_largest": row[
                "logit_err_over_largest_request0"]}]:
            if p["logit_err_over_largest"] > TP_BF16_TOL:
                fail("model_parallel serve: rank {}'s logits off one "
                     "process's by {} of the largest (limit {})".format(
                         row["rank"], p, TP_BF16_TOL))
    if serve[0]["streams"] != serve[1]["streams"]:
        fail("model_parallel serve: the ranks' streams differ")
    for r in range(MP_RANKS):
        check = rows[("tp_serve_fp32", r)]
        graph = rows[("tp_graph_vs_eager", r)]
        timed, ep = rows[("ep_serve", r)], rows[("ep_serve_fp32", r)]
        for what, row in (("model_parallel_serve_check", check),
                          ("model_parallel_serve_graph", graph),
                          ("model_parallel_moe_serve", timed),
                          ("model_parallel_moe_serve_check", ep)):
            print(what + " " + json.dumps(dict(row, card=card)))
        gaps = [p["gap"] for p in check["parted"]] + \
            [p["gap"] for n in ep["parted"] for p in ep["parted"][n]]
        if any(g >= NEAR_TIE for g in gaps):
            fail("model_parallel serve: a stream parts from one process's "
                 "at a clear choice: {} {}".format(check, ep))
        if not graph["harvests_identical"] or graph["pool_differs"] or \
                graph["graph_segments"] != graph["graph_segments_want"]:
            fail("model_parallel serve: the segmented programs are not "
                 "eager bit for bit: {}".format(graph))
        if not all(ep["gauges_equal"].values()) or ep["experts_held"] != {
                "ep": MOE_CFG["n_experts"] // MP_RANKS,
                "no_ep": MOE_CFG["n_experts"],
                "one": MOE_CFG["n_experts"]}:
            fail("model_parallel moe serve: {}".format(ep))
        if timed["launches"] != dict.fromkeys(timed["launches"], 0):
            fail("model_parallel moe serve: a decode kernel ran: {}".format(
                timed["launches"]))
    return [row["launches"] for row in serve]


def _model_parallel_moe(ranks, card):
    """Check and print the MoE training arms of phase_model_parallel."""
    rows = [r for k in ranks for r in k["moe"]]
    by = {(r.get("arm", r.get("run")), r["rank"]): r for r in rows}
    for arm in ("moe_train_mp2", "moe_train_dp2"):
        for r in range(MP_RANKS):
            row = by[(arm, r)]
            print("model_parallel_moe_train " + json.dumps(dict(row,
                                                                card=card)))
            if not np.isfinite(row["losses"]).all():
                fail("model_parallel moe: non-finite loss {}".format(row))
            held = {tuple(s)[0] for s in row["expert_shapes"].values()}
            want = MOE_TRAIN["experts"] // (MP_RANKS if arm.endswith("mp2")
                                            else 1)
            if held != {want}:
                fail("model_parallel moe: {} rank {} holds {} experts "
                     "(want {})".format(arm, r, held, want))
        if len({tuple(by[(arm, r)]["losses"])
                for r in range(MP_RANKS)}) != 1:
            fail("model_parallel moe: the ranks' {} losses differ".format(
                arm))
    checks = [r for r in rows if "param_max_err_over_limit" in r]
    print("model_parallel_moe_train_check " + json.dumps(
        {"fp32": "width {}, {} blocks, B{} T{}, capacity factor {}, {} "
                 "steps: mp {} and dp {} vs one process".format(
                     MOE_TRAIN["width"], MOE_CHECK["blocks"],
                     MOE_CHECK["B"], MOE_CHECK["T"],
                     MOE_CHECK["capacity_factor"], MOE_CHECK_STEPS,
                     MP_RANKS, MP_RANKS),
         "runs": checks, "card": card}))
    if sorted(c["run"] for c in checks) != ["moe_dp2", "moe_mp2"]:
        fail("model_parallel moe: a check did not run: {}".format(checks))
    for c in checks:
        if c["loss_rel_err"] > 1e-5 or c["param_max_err_over_limit"] > 1.0 \
                or c["expert_slots"] >= c["tokens"]:
            fail("model_parallel moe: {} disagrees with one process: {}"
                 .format(c["run"], c))


# ------------------------------------------ sequence parallelism, 1-bit Adam

# Sequence parallelism and 1-bit Adam (phase_sequence_parallel): SP_RANKS
# gloo ranks on cuda:0 started by the port's launcher. GPT-2 medium bf16 at
# full width, 4 of its 24 layers (the depth cut for the smoke's time;
# n_positions SP_T, so only the position table grows), AdamW
# 1e-4, dropout 0: one global B1 x SP_T sequence, SP_T / 2
# tokens a rank, through the ring and then Ulysses; then 1-bit Adam over
# the two as data ranks at the data-parallel cell's B4 x T1024 a rank.
# Collectives go through the host (gloo): their times measure the
# plumbing, not NVLink.
SP_RANKS, SP_T = 2, 8192
SP_WIDTH = {"n_embd": 1024, "n_layer": 4, "n_head": 16}
SP_CHECK_WIDTH = {"n_embd": 1024, "n_layer": 4, "n_head": 16}
SP_TIMEOUT_S = 300
# The ring's K1/K2 inputs (phase_flash holds them there): B1 H16, a block
# of SP_T / SP_RANKS keys, under the merged output's global lse and delta.
SP_FLASH_T = SP_T // SP_RANKS
SP_FLASH_CASES = (("sp_ring_causal", True), ("sp_ring_full", False))
# 1-bit: the warm-up step (the x-ray's first-signature step among them),
# one more dense step (timed) and the first compressed one (timed).
ONEBIT_B, ONEBIT_T, ONEBIT_FREEZE = 4, 1024, 2
# The fp32 arms: 4 layers at width 1024. SP: T SP_CHECK_T, ring and
# Ulysses, one step each against one process. 1-bit: dp 2, freeze 2, 4
# steps of B2 x T128 a rank, card against the CPU.
SP_CHECK_T = 2048
ONEBIT_CHECK = dict(B=2, T=128, steps=4, freeze=2, lr=1e-5, eps=1e-3)
# The share of elements whose exchanged momentum may take the other sign on
# the card and the CPU: those whose gradient lies within fp32 summation
# noise of 0 (0.24% read on the card; the loss and every other element are
# held tightly).
ONEBIT_FLIP_SHARE = 1e-2
# Activation checkpointing: GPT-2 medium blocks at dropout 0.1, B8 x T1024.
ACKPT_B, ACKPT_T = 8, 1024


def _sp_config(extra=None):
    cfg = {"train_batch_size": 1, "steps_per_print": 1000,
           "gradient_clipping": 1.0, "bf16": {"enabled": True},
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
           "sequence_parallel": {"enabled": True, "size": SP_RANKS}}
    cfg.update(extra or {})
    return cfg


def _onebit_config(micro, freeze, bf16=True, eps=1e-8, lr=1e-4):
    cfg = {"train_micro_batch_size_per_gpu": micro, "steps_per_print": 1000,
           "optimizer": {"type": "OneBitAdam", "params": {
               "lr": lr, "freeze_step": freeze, "eps": eps}}}
    if bf16:
        cfg["bf16"] = {"enabled": True}
    return cfg


def _sp_counters():
    from deepspeed_tpu_torch.parallel import comm

    at.reset_launches()
    comm.reset_stats()


def _sp_read():
    from deepspeed_tpu_torch.parallel import comm

    return {"launches": dict(at.launches),
            "collectives": {k: v for k, v in comm.stats.items() if v}}


def _sp_schedule(mode, rank, cfg):
    """The schedule's K1/K2 launches and collectives of one SP training step
    on ``rank`` (B1, SP_T / SP_RANKS tokens a rank, bf16): the causal ring
    runs the blocks of shards 0 .. rank (K2a: a 4096-key block's fused
    backward fits its 6 MiB), shifts k/v (stacked) once forward and once
    backward and dk/dv (fp32) twice a layer; Ulysses runs one K1 and the
    split K2b (two launches; 8192 keys) a layer, and four all-to-alls
    (q, k, v stacked in, o out, and their reverses). Both shift the next
    shard's first label once, psum the loss and its count forward and
    backward, and take the gradients' mean over the seq line (one fp32
    bucket)."""
    L, H, D = cfg.n_layer, cfg.n_head, cfg.n_embd // cfg.n_head
    plane = SP_T // SP_RANKS * H * D * 2  # one bf16 k, v or q shard
    n = SP_RANKS
    params = cfg.num_params()
    common = {"all_reduce": 3, "all_reduce_bytes": 2 * 8 + 4 * params}
    if mode == "ring":
        blocks = rank + 1
        launches = {"flash_fwd": L * blocks, "flash_bwd_fused": L * blocks,
                    "flash_bwd_split": 0}
        coll = dict(common, ring_shift=L * (2 * (n - 1) + n) + 1,
                    ring_shift_bytes=L * (2 * (n - 1) * 2 * plane +
                                          n * 2 * 2 * plane) + 8)
    else:
        launches = {"flash_fwd": L, "flash_bwd_fused": 0,
                    "flash_bwd_split": 2 * L}
        coll = dict(common, ring_shift=1, ring_shift_bytes=8,
                    all_to_all=4 * L, all_to_all_bytes=L * 8 * plane)
    coll["calls"] = sum(v for k, v in coll.items()
                        if not k.endswith("bytes"))
    coll["bytes"] = sum(v for k, v in coll.items() if k.endswith("_bytes"))
    return launches, coll


def _sp_timed(mode, cfg, rank, world, device):
    """One SP arm at full width on this rank: a warm step (the x-ray's
    first-signature step), then one timed step with the launch counts and
    collectives reset just before and read just after, and the peak device
    memory over it."""
    t_build = time.perf_counter()
    mcfg = dataclasses.replace(cfg, sequence_parallel_axis="seq",
                               sequence_parallel_mode=mode)
    engine, _, _, _ = initialize(
        model=GPT2LMHeadModel(mcfg, device=device, seed=0),
        config_params=_sp_config(), device=device, dist_init_required=False)
    ids = torch.from_numpy(_dp_ids(1, SP_T, cfg.vocab_size, 5)).to(device)
    t_warm = time.perf_counter()
    losses = [float(engine.train_batch((ids, ids)))]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_warm
    torch.cuda.reset_peak_memory_stats()
    _sp_counters()
    t0 = time.perf_counter()
    losses.append(float(engine.train_batch((ids, ids))))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row = {"arm": "sequence_parallel", "mode": mode, "rank": rank,
           "tokens_per_s": SP_T / wall,
           "tokens_per_s_per_rank": SP_T // SP_RANKS / wall,
           "mean_step_ms": wall * 1e3,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "losses": losses, "build_s": t_warm - t_build, "warm_s": warm_s}
    row.update(_sp_read())
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    row["arm_s"] = time.perf_counter() - t_build
    return row


def _onebit_bytes(cfg, world):
    """Per rank and step: the dense warm-up all-reduce (the fp32 gradient
    bucket and the loss) and the compressed exchange: the packed signs of
    every leaf padded by ``corrected_size`` (n/8 through the all-to-all,
    n/(8W) through the server all-gather) and two fp32 scales a leaf."""
    from deepspeed_tpu_torch.runtime.custom_collectives import corrected_size

    sizes = _gpt2_leaf_sizes(cfg)
    padded = [corrected_size(n, world) for n in sizes]
    return {"dense_all_reduce_bytes": 4 * sum(sizes) + 4,
            "all_to_all_bytes": sum(padded) // 8,
            "all_gather_bytes": sum(padded) // (8 * world) +
            2 * 4 * len(sizes), "all_reduce_bytes": 4,
            "fp32_all_reduce_bytes": 4 * sum(sizes), "leaves": len(sizes)}


def _gpt2_leaf_sizes(cfg):
    C, L = cfg.n_embd, cfg.n_layer
    block = [C, C, 3 * C * C, 3 * C, C * C, C, C, C, 4 * C * C, 4 * C,
             4 * C * C, C]
    return [cfg.vocab_size * C, cfg.n_positions * C] + block * L + [C, C]


def _onebit_timed(cfg, rank, world, device):
    """1-bit Adam over ``world`` data ranks at full width: the warm-up step,
    a timed dense step, the first compressed step timed; per timed step the
    wall clock, the launches and the collectives."""
    t_build = time.perf_counter()
    engine, _, _, _ = initialize(
        model=GPT2LMHeadModel(cfg, device=device, seed=0),
        config_params=_onebit_config(ONEBIT_B, ONEBIT_FREEZE),
        device=device, dist_init_required=False)
    ids = torch.from_numpy(_dp_ids(ONEBIT_B, ONEBIT_T, cfg.vocab_size,
                                   11 + rank)).to(device)
    losses = [float(engine.train_batch((ids, ids)))]
    steps = {}
    for phase in ("dense", "compressed"):
        torch.cuda.synchronize()
        frozen = engine.optimizer.adam_freeze_key
        _sp_counters()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch((ids, ids))))
        torch.cuda.synchronize()
        steps[phase] = dict(_sp_read(), step_ms=(time.perf_counter() - t0)
                            * 1e3, frozen_before=frozen)
    row = {"arm": "onebit", "rank": rank, "losses": losses, "steps": steps,
           "tokens_per_s_compressed": ONEBIT_B * ONEBIT_T * world /
           steps["compressed"]["step_ms"] * 1e3,
           "tokens_per_s_dense": ONEBIT_B * ONEBIT_T * world /
           steps["dense"]["step_ms"] * 1e3,
           "enable_backward_allreduce": engine.enable_backward_allreduce}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    row["arm_s"] = time.perf_counter() - t_build
    return row


def _grads_of_first_update(engine):
    """A dict that gets the (unscaled) gradients the engine's first update
    is given, by name."""
    got = {}
    real = engine._update

    def spy(grads, inv_scale, skip=()):
        if not got:
            got.update({n: (g.detach().float() * inv_scale).cpu()
                        for n, g in zip(engine._names, grads)})
        return real(grads, inv_scale, skip)

    engine._update = spy
    return got


def _sp_check(mode, cfg, params, rank, device):
    """fp32: one SP step (``mode``) over the ranks against one process on
    the card from the same weights: the loss within 1e-5 relative, the
    gradients within GRAD_TOL of each tensor's max-abs."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.parallel import mesh as mesh_lib

    ids = torch.from_numpy(_dp_ids(1, SP_CHECK_T, cfg.vocab_size, 6)).to(
        device)
    config = {"train_batch_size": 1, "steps_per_print": 1000,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}}}
    mcfg = dataclasses.replace(cfg, sequence_parallel_axis="seq",
                               sequence_parallel_mode=mode)
    engine, _, _, _ = initialize(
        model=GPT2LMHeadModel(mcfg, device=device, seed=None),
        model_parameters=params, device=device, dist_init_required=False,
        config_params=dict(config, sequence_parallel={"enabled": True,
                                                      "size": SP_RANKS}))
    got = _grads_of_first_update(engine)
    loss = float(engine.train_batch((ids, ids)))
    del engine
    solo = mesh_lib.Mesh((1, 1, 1, 1), 0, None)
    ref, _, _, _ = initialize(
        model=GPT2LMHeadModel(cfg, device=device, seed=None),
        model_parameters=params, device=device, mesh=solo,
        config_params=config, dist_init_required=False)
    want = _grads_of_first_update(ref)
    loss_one = float(ref.train_batch((ids, ids)))
    del ref
    largest = max(float(g.abs().max()) for g in want.values())
    ratio = max(float((got[n] - w).abs().max()) /
                (GRAD_TOL * max(float(w.abs().max()), GRAD_TOL * largest))
                for n, w in want.items())
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return {"arm": "sequence_parallel_check", "mode": mode, "rank": rank,
            "loss": loss, "loss_one": loss_one,
            "loss_rel_err": abs(loss - loss_one) / abs(loss_one),
            "grad_max_err_over_limit": ratio, "leaves": len(want)}


def _onebit_run(cfg, params, rank, world, device):
    """fp32 1-bit Adam over ``world`` data ranks on ``device``: the losses,
    the masters by name after ONEBIT_CHECK["steps"] steps, the exchanged
    momentum of each compressed step and the frozen second moment (CPU
    copies), and whether the run reached the compressed phase."""
    c = ONEBIT_CHECK
    engine, _, _, _ = initialize(
        model=GPT2LMHeadModel(cfg, device=device, seed=None),
        model_parameters=params, device=device, dist_init_required=False,
        config_params=_onebit_config(c["B"], c["freeze"], bf16=False,
                                     eps=c["eps"], lr=c["lr"]))
    ids = torch.from_numpy(_dp_ids(c["B"], c["T"], cfg.vocab_size,
                                   21 + rank)).to(device)
    losses, momenta = [], []
    for step in range(c["steps"]):
        losses.append(float(engine.train_batch((ids, ids))))
        if step >= c["freeze"]:
            momenta.append({n: m.detach().cpu().clone() for n, m in zip(
                engine._names, engine.opt_state["exp_avg"])})
    masters = {n: p.detach().float().cpu().clone()
               for n, p in zip(engine._names, engine._params)}
    v = {n: t.detach().cpu().clone() for n, t in zip(
        engine._names, engine.opt_state["exp_avg_sq"])}
    frozen = engine.optimizer.adam_freeze_key
    del engine
    return {"losses": losses, "masters": masters, "momenta": momenta,
            "v": v, "frozen": frozen}


def _onebit_check(cfg, params, rank, world, device):
    """The same 1-bit run on the card and on the CPU (both over the gloo
    group): every loss within 1e-5 relative, the masters under the training
    rule (1e-3 lr a step plus two ulps). 1-bit quantization is a sign: an
    element whose compensated momentum lies within fp32 noise of 0 can
    take the other sign in the two runs and so a whole step the other way.
    Such an element (its exchanged momenta's signs differ in some
    compressed step) is held to those steps, lr (|m_card| + |m_cpu|) /
    (sqrt(v) + eps) each; their share of the elements (and the tensors with the most) is
    reported and held under ONEBIT_FLIP_SHARE.
    The server chunks of each ``c_attn.bias`` that hold its key third are
    left out: that gradient is 0 in exact arithmetic, so those signs are
    noise and move their chunk's server scale. The rate is low enough
    (ONEBIT_CHECK) that the flips move the loss by less than 1e-5."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.runtime.custom_collectives import corrected_size

    c = ONEBIT_CHECK
    t0 = time.perf_counter()
    card = _onebit_run(cfg, params, rank, world, device)
    gc.collect()
    torch.cuda.empty_cache()
    cpu = _onebit_run(cfg, params, rank, world, "cpu")
    C = cfg.n_embd
    chunk = corrected_size(3 * C, world) // world
    keys = range(C // chunk, (2 * C - 1) // chunk + 1)
    keep = torch.tensor([i for i in range(3 * C) if i // chunk not in keys],
                        dtype=torch.int64)
    rule = 1e-3 * c["lr"] * c["steps"]
    worst, excluded, flipped, total, by_tensor = 0.0, 0, 0, 0, {}
    for n, want in cpu["masters"].items():
        got = card["masters"][n]
        flip = torch.zeros(want.shape, dtype=torch.bool)
        allow = torch.zeros(want.shape)
        step = c["lr"] / (torch.minimum(card["v"][n], cpu["v"][n]).sqrt()
                          + c["eps"])
        for mc, mh in zip(card["momenta"], cpu["momenta"]):
            flip |= (mc[n] >= 0) != (mh[n] >= 0)
            allow += step * (mc[n].abs() + mh[n].abs())
        limit = rule + 2.0 ** -22 * want.abs() + torch.where(flip, allow,
                                                             0.0)
        if n.endswith("attn.c_attn.bias"):
            excluded += want.numel() - keep.numel()
            if not keep.numel():
                continue
            got, want, limit, flip = got[keep], want[keep], limit[keep], \
                flip[keep]
        flipped += int(flip.sum())
        by_tensor[n] = int(flip.sum())
        total += want.numel()
        worst = max(worst, float(((got - want).abs() / limit).max()))
    dist.barrier()
    return {"arm": "onebit_check", "rank": rank,
            "losses_card": card["losses"], "losses_cpu": cpu["losses"],
            "loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(
                card["losses"], cpu["losses"])),
            "param_max_err_over_limit": worst, "flipped_elements": flipped,
            "flipped_share": flipped / total,
            "most_flipped": sorted(by_tensor.items(), key=lambda kv: -kv[1])[
                :3], "excluded_elements": excluded,
            "frozen": [card["frozen"], cpu["frozen"]],
            "check_s": time.perf_counter() - t0}


def sp_rank(workdir):
    """One rank of phase_sequence_parallel, started by the port's launcher:
    joins the gloo group, runs the SP arms (ring, Ulysses) and the 1-bit arm
    at full width, then their fp32 checks, and writes its rows to
    ``<workdir>/rank_<r>.json``."""
    from deepspeed_tpu_torch.runtime.utils import flax_tree
    from deepspeed_tpu_torch.utils.distributed import init_distributed

    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    device = spec["device"]
    init_distributed(dist_backend="gloo", timeout=SP_TIMEOUT_S,
                     device=device, verbose=False)
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPT2Config(dtype=torch.bfloat16, dropout=0.0, n_positions=SP_T,
                     **spec["width"])
    rows = [_sp_timed(mode, cfg, rank, world, device)
            for mode in ("ring", "ulysses")]
    rows.append(_onebit_timed(GPT2Config(dtype=torch.bfloat16, dropout=0.0,
                                         **spec["width"]),
                              rank, world, device))
    t0 = time.perf_counter()
    check_cfg = GPT2Config(dtype=torch.float32, dropout=0.0,
                           n_positions=SP_CHECK_T, **spec["check_width"])
    params = flax_tree(GPT2LMHeadModel(check_cfg, device="cpu", seed=2))
    checks = [_sp_check(mode, check_cfg, params, rank, device)
              for mode in ("ring", "ulysses")]
    ob_cfg = GPT2Config(dtype=torch.float32, dropout=0.0,
                        n_positions=ONEBIT_CHECK["T"],
                        **spec["check_width"])
    checks.append(_onebit_check(ob_cfg, flax_tree(GPT2LMHeadModel(
        ob_cfg, device="cpu", seed=3)), rank, world, device))
    with open(os.path.join(workdir, "rank_{}.json".format(rank)), "w") as f:
        json.dump({"rows": rows, "checks": checks,
                   "check_s": time.perf_counter() - t0}, f)
    dist.destroy_process_group()


def _rank_launch(flag, spec, workdir, n, timeout, label):
    """``n`` rank processes of this script with ``--<flag>=<workdir>``,
    started by the port's launcher (``deepspeed_tpu_torch.launcher.launch``:
    one process per entry of world_info, every rank told to use cuda:0),
    waited for within ``timeout``; a failed rank fails the launch and the
    phase (at the timeout the launcher's process group is killed)."""
    import base64
    import signal

    with open(os.path.join(workdir, "spec.json"), "w") as f:
        json.dump(spec, f)
    here = os.path.dirname(os.path.abspath(__file__))
    info = base64.urlsafe_b64encode(json.dumps(
        {"localhost": list(range(n))}).encode()).decode()
    env = dict(os.environ, PYTHONPATH=here + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
         "--world_info={}".format(info),
         "--master_port={}".format(_free_port()),
         os.path.abspath(__file__), "--{}={}".format(flag, workdir)],
        cwd=here, env=env, start_new_session=True)
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        rc = "timeout"
    if rc != 0:
        fail("{}: the launch ended with {}".format(label, rc))
    out = []
    for r in range(n):
        with open(os.path.join(workdir, "rank_{}.json".format(r))) as f:
            out.append(json.load(f))
    return out


def _ackpt_stack(cfg, x0, seeds, run):
    """The blocks on ``x0`` plain or each through ``checkpoint`` (with
    ``cpu_checkpointing`` for run "cpu"): every gradient, and the peak
    device memory of the forward and backward."""
    from deepspeed_tpu_torch.runtime.activation_checkpointing import (
        checkpointing)

    checkpointing.configure(checkpoint_in_cpu=run == "cpu")
    blocks = _ACKPT_MODEL.blocks()
    for p in _ACKPT_MODEL.parameters():
        p.grad = None
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    x = x0.clone().requires_grad_()
    h = x
    for blk, seed in zip(blocks, seeds):
        h = blk(h, cfg, seed) if run == "plain" else \
            checkpointing.checkpoint(blk, h, cfg, seed)
    h.float().square().mean().backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    grads = [x.grad] + [p.grad.clone() for p in _ACKPT_MODEL.parameters()
                        if p.grad is not None]
    return grads, torch.cuda.max_memory_allocated() - base, ms


_ACKPT_MODEL = None


def _activation_checkpointing(card):
    """GPT-2 medium's 24 blocks at dropout 0.1 (bf16, B8 x T1024) through
    ``checkpointing.checkpoint``, with and without ``cpu_checkpointing``:
    every gradient bit-equal to the plain stack's (K2b: K2a adds dq by
    atomics, whose order differs run to run), peak device memory beside
    the plain stack's."""
    global _ACKPT_MODEL
    from deepspeed_tpu_torch.runtime.activation_checkpointing import (
        checkpointing)

    cfg = GPT2Config.gpt2_medium(dtype=torch.bfloat16, dropout=0.1)
    _ACKPT_MODEL = GPT2LMHeadModel(cfg, device="cuda", seed=0)
    _ACKPT_MODEL.requires_grad_(True)
    g = torch.Generator(device="cuda")
    g.manual_seed(9)
    x0 = (torch.randn(ACKPT_B, ACKPT_T, cfg.n_embd, device="cuda",
                      generator=g) * 0.5).to(torch.bfloat16)
    seeds = list(range(100, 100 + cfg.n_layer))
    saved = os.environ.get("DS_TPU_FLASH_BWD")
    os.environ["DS_TPU_FLASH_BWD"] = "split"
    try:
        runs = {run: _ackpt_stack(cfg, x0, seeds, run)
                for run in ("plain", "ckpt", "cpu")}
    finally:
        checkpointing.configure(checkpoint_in_cpu=False)
        if saved is None:
            os.environ.pop("DS_TPU_FLASH_BWD")
        else:
            os.environ["DS_TPU_FLASH_BWD"] = saved
    plain = runs["plain"][0]
    equal = {run: len(runs[run][0]) == len(plain) and all(
        torch.equal(a, b) for a, b in zip(runs[run][0], plain))
        for run in ("ckpt", "cpu")}
    line = {"shape": "24 GPT-2 medium blocks, B{} T{} bf16, dropout 0.1"
            .format(ACKPT_B, ACKPT_T), "grads_bit_equal": equal,
            "tensors": len(plain),
            "peak_bytes": {run: r[1] for run, r in runs.items()},
            "ms": {run: r[2] for run, r in runs.items()}, "card": card}
    print("activation_checkpointing " + json.dumps(line))
    _ACKPT_MODEL = None
    gc.collect()
    torch.cuda.empty_cache()
    if not all(equal.values()):
        fail("activation_checkpointing: gradients differ from the plain "
             "stack's: {}".format(equal))
    if not runs["ckpt"][1] < runs["plain"][1]:
        fail("activation_checkpointing: no device memory saved")


def phase_sequence_parallel(card):
    """Sequence parallelism and 1-bit Adam over SP_RANKS gloo ranks on the
    card, then activation checkpointing in this process (module docstring,
    phase 17); returns each arm's per-rank K1/K2a/K2b launches per step."""
    gc.collect()
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp()
    try:
        ranks = _rank_launch("sequence-parallel-rank", {
            "device": "cuda:0", "width": SP_WIDTH,
            "check_width": SP_CHECK_WIDTH}, workdir, SP_RANKS, SP_TIMEOUT_S,
            "sequence_parallel")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    sp_cfg = GPT2Config(n_positions=SP_T, **SP_WIDTH)
    ob_cfg = GPT2Config(**SP_WIDTH)
    want_ob = _onebit_bytes(ob_cfg, SP_RANKS)
    out = {}
    for r in ranks:
        for row in r["rows"]:
            print("{} {}".format(row["arm"], json.dumps(dict(row,
                                                             card=card))))
            if not np.isfinite(row["losses"]).all():
                fail("{}: non-finite loss {}".format(row["arm"], row))
            if row["arm"] == "sequence_parallel":
                launches, coll = _sp_schedule(row["mode"], row["rank"],
                                              sp_cfg)
                if row["launches"] != launches or row["collectives"] != coll:
                    fail("sequence_parallel: rank {} {} ran {} and {} (the "
                         "schedule: {} and {})".format(
                             row["rank"], row["mode"], row["launches"],
                             row["collectives"], launches, coll))
                out.setdefault(row["mode"], {})[row["rank"]] = \
                    row["launches"]
            else:
                _onebit_gate(row, want_ob, ob_cfg.n_layer)
                out.setdefault("onebit", {})[row["rank"]] = \
                    row["steps"]["compressed"]["launches"]
    for mode in ("ring", "ulysses"):
        if len({tuple(row["losses"]) for r in ranks for row in r["rows"]
                if row.get("mode") == mode}) != 1:
            fail("sequence_parallel: the ranks' {} losses differ".format(
                mode))
    checks = [c for r in ranks for c in r["checks"]]
    print("sequence_parallel_check " + json.dumps(
        {"fp32": "width 1024, 4 layers: SP {} ranks at T{} (ring, Ulysses) "
                 "vs one process; 1-bit Adam dp {} ({} steps of B{} T{} a "
                 "rank, freeze {}) card vs CPU".format(
                     SP_RANKS, SP_CHECK_T, SP_RANKS, ONEBIT_CHECK["steps"],
                     ONEBIT_CHECK["B"], ONEBIT_CHECK["T"],
                     ONEBIT_CHECK["freeze"]),
         "runs": checks, "check_s": [r["check_s"] for r in ranks],
         "card": card}))
    for c in checks:
        if c["loss_rel_err"] > 1e-5 or \
                c.get("grad_max_err_over_limit", 0.0) > 1.0 or \
                c.get("param_max_err_over_limit", 0.0) > 1.0:
            fail("{} disagrees: {}".format(c["arm"], c))
        if c["arm"] == "onebit_check" and (
                c["frozen"] != [True, True] or
                c["flipped_share"] > ONEBIT_FLIP_SHARE):
            fail("onebit_check: the runs did not reach the compressed "
                 "phase, or too many signs differ: {}".format(c))
    _activation_checkpointing(card)
    return {run: [per[r] for r in range(SP_RANKS)]
            for run, per in out.items()}


def _onebit_gate(row, want, n_layer):
    """The 1-bit arm's steps against the formulas: the dense step
    all-reduces the gradients (one fp32 bucket) and the loss; the first
    compressed step exchanges only packed signs and scales (no gradient
    all-reduce: the one all-reduce is the 4-byte loss mean); K1 and K2a
    n_layer times a step."""
    dense = row["steps"]["dense"]["collectives"]
    comp = row["steps"]["compressed"]["collectives"]
    bad = []
    if row["steps"]["dense"]["frozen_before"] or \
            not row["steps"]["compressed"]["frozen_before"]:
        bad.append("the phases")
    if dense.get("all_reduce_bytes") != want["dense_all_reduce_bytes"] or \
            dense.get("all_to_all", 0):
        bad.append("dense step collectives {}".format(dense))
    if (comp.get("all_reduce"), comp.get("all_reduce_bytes")) != (1, 4) or \
            comp.get("all_to_all_bytes") != want["all_to_all_bytes"] or \
            comp.get("all_gather_bytes") != want["all_gather_bytes"]:
        bad.append("compressed step collectives {} (want {})".format(
            comp, want))
    for phase in ("dense", "compressed"):
        n = row["steps"][phase]["launches"]
        if (n["flash_fwd"], n["flash_bwd_fused"], n["flash_bwd_split"]) != \
                (n_layer, n_layer, 0):
            bad.append("{} launches {}".format(phase, n))
    if bad:
        fail("onebit: rank {}: {}".format(row["rank"], "; ".join(bad)))


def _lse_case(name, B, H, T, dtype, seed):
    """flash_attention_with_lse (K1, then K2 with delta = rowsum(dO * O) -
    dlse) against its plain version on the same inputs: o and the
    gradients under FLASH_TOL's limits (the magnitudes take |delta|, which
    covers dlse), the lse within 1e-5 of (1 + |lse|); fp32 also against
    autograd through mha_reference with return_lse."""
    q, k, v, do, _ = _flash_inputs(B, T, dtype, False, seed, H=H)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 1)
    dlse = torch.randn(B, H, T, 1, device="cuda", generator=g)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = at.launches["flash_fwd"]
    o, lse = at.flash_attention_with_lse(*leaves, causal=True)
    launched = at.launches["flash_fwd"] - before
    grads = torch.autograd.grad((o, lse), leaves, (do, dlse))
    ro, rlse = at.mha_reference(q, k, v, None, True, return_lse=True)
    delta = (do.float() * o.detach().float()).sum(dim=-1, keepdim=True) - \
        dlse
    refs = at.flash_bwd_reference(q, k, v, None, lse.detach(), delta, do,
                                  True)
    mags = at.accumulated_magnitudes(q, k, v, None, lse.detach(), delta, do,
                                     True)
    rtol = FLASH_RTOL[dtype]
    triples = [(o, ro, rtol * ro.float().abs() + FLASH_ACC * mags[0]),
               (lse, rlse, 1e-5 * (1 + rlse.abs()))] + [
        (x, r, rtol * r.float().abs() + FLASH_ACC * m)
        for x, r, m in zip(grads, refs, mags[1:])]
    errs = [_err(x.detach(), r, lim) for x, r, lim in triples]
    row = {"case": name, "dtype": str(dtype).split(".")[-1], "B": B, "H": H,
           "T": T, "seed": seed, "K1_with_lse_launches": launched,
           "max_abs_err": max(e[0] for e in errs),
           "max_err_over_limit": max(e[1] for e in errs),
           "err_over_limit": dict(zip(("o", "lse", "dq", "dk", "dv"),
                                      (e[1] for e in errs)))}
    if dtype == torch.float32:
        ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        ro2, rl2 = at.mha_reference(*ref_leaves, causal=True,
                                    return_lse=True)
        want = torch.autograd.grad((ro2, rl2), ref_leaves, (do, dlse))
        row["autograd_max_err_over_limit"] = max(
            _err(x, w, FLASH_AUTOGRAD_TOL * w.abs().max())[1]
            for x, w in zip(grads, want))
    print("flash_lse " + json.dumps(row))
    if launched != 1 or row["max_err_over_limit"] > 1.0 or \
            row.get("autograd_max_err_over_limit", 0.0) > 1.0:
        fail("flash_attention_with_lse disagrees with its plain version "
             "at {}: {}".format(name, row))
    return row


def phase_flash_lse(bf16_seeds=(11,), repeats=1):
    """flash_attention_with_lse at GPT-2 medium's training shape (B8 H16
    T1024, bf16, causal) and in fp32 (B2), both against their plain
    versions; the bf16 case on each of ``bf16_seeds``, ``repeats`` times
    (K2a adds dq by atomics, so a repeat sums in another order)."""
    rows = [_lse_case("gpt2_medium", 8, 16, 1024, torch.bfloat16, seed)
            for seed in bf16_seeds for _ in range(repeats)]
    return rows + [_lse_case("fp32", 2, 16, 1024, torch.float32, 12)]


def _flash_kernel_rows(flash_rows, launches, bert_launches, split_rows,
                       offload_launches, lse_rows, dp_launches, mp_launches,
                       sp_launches):
    """K1/K2a/K2b: times at GPT-2 training's shape, launches from its run;
    under "bert" the times at BERT-large's shape and the launches from the
    BERT run; under "offload" GPT-2 XL's shape and the offload run's
    launches; under "data_parallel" each ZeRO stage's launches per step of
    each rank (the data-parallel run: the times are the GPT-2 shape's, B4
    per rank halving B8); under "model_parallel" each arm's launches per
    step of each rank (TP runs H8 per rank at B8, PP B2 micro-batches) and
    under "cases" the errors and times at those two shapes (for K2b, which
    those arms do not run, its errors and times there too); K2b's entry
    also gives its two
    kernels' own times (dkdv_ms, dq_ms) and the split-default shape's under
    "split_default"; K1's, flash_attention_with_lse's check under
    "with_lse" (no main path calls it); under "sequence_parallel" each
    SP arm's (ring, Ulysses) and the 1-bit arm's launches per step of each
    rank, and the errors and times under global statistics at the ring
    block's shape (SP_FLASH_CASES)."""
    by_case = {r["case"]: r for r in flash_rows}
    timed, bert, xl = flash_rows[0], flash_rows[1], by_case["gpt2_xl"]
    mp_rows = {r["case"]: r for r in flash_rows
               if r["case"] in {c[0] for c in MP_FLASH_CASES}}
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
            offload={"shape": "B2 H25 T1024 D64 bf16 causal (GPT-2 XL, "
                              "remat: K1 twice per layer and step)",
                     "launches": offload_launches[counter], "ms": xl[ms],
                     "plain_ms": xl[plain], "library_ms": xl[lib],
                     "bound_ms": xl["bound_{}_ms".format(way)],
                     "bound_by": xl["bound_{}_by".format(way)]},
            data_parallel={
                "shape": "B4 H16 T1024 D64 bf16 causal per rank (GPT-2 "
                         "medium, {} ranks on one card: stages 0-3 at {} "
                         "layers; the offload Adam, device Lamb and host "
                         "Lamb arms at stage 2 and {} layers)".format(
                             DP_RANKS, DP_LAYERS, DP_ARM_LAYERS),
                "launches_per_step": {
                    "stage{}".format(key) if isinstance(key, int) else key:
                    [r[counter] for r in ranks]
                    for key, ranks in dp_launches.items()}},
            model_parallel={
                "shape": "TP: B8 H8 T1024 D64 bf16 causal per rank (mp "
                         "2); PP: B2 H16 T1024 per micro-batch, {} blocks "
                         "a stage, 4 micro-batches; compiled: the same "
                         "micro-batches, {} blocks a stage, K1 twice a "
                         "block (the tick and its recompute) (GPT-2 "
                         "medium, {} ranks on one card)".format(
                             MP_LAYERS // MP_RANKS, CP_LAYERS // MP_RANKS,
                             MP_RANKS),
                "launches_per_step": {
                    run: [r[counter] for r in ranks]
                    for run, ranks in mp_launches.items()},
                "cases": {
                    case: {"shape": "B{} H{} T{} D64 bf16 causal".format(
                               r["B"], r["H"], r["T"]),
                           "max_abs_err": r[kernel]["max_abs_err"],
                           "max_err_over_limit":
                               r[kernel]["max_err_over_limit"],
                           "ms": r[ms], "plain_ms": r[plain],
                           "library_ms": r[lib],
                           "bound_ms": r["bound_{}_ms".format(way)],
                           "bound_by": r["bound_{}_by".format(way)]}
                    for case, r in mp_rows.items()}},
            sequence_parallel={
                "shape": "ring: B1 H16, {} queries a rank against blocks of "
                         "{} keys, bf16, global lse and delta; Ulysses: B1 "
                         "H8 T{} a rank; 1-bit: B{} H16 T{} a rank (GPT-2 "
                         "medium, {} ranks on one card)".format(
                             SP_FLASH_T, SP_FLASH_T, SP_T, ONEBIT_B,
                             ONEBIT_T, SP_RANKS),
                "launches_per_step": {
                    run: [r[counter] for r in ranks]
                    for run, ranks in sp_launches.items()},
                "cases": {
                    case: {"shape": "B1 H16 T{} D64 bf16 {}".format(
                               SP_FLASH_T,
                               "causal" if by_case[case]["causal"]
                               else "full"),
                           "max_abs_err": by_case[case][kernel][
                               "max_abs_err"],
                           "max_err_over_limit": by_case[case][kernel][
                               "max_err_over_limit"],
                           "ms": by_case[case][ms],
                           "plain_ms": by_case[case][plain],
                           "library_ms": by_case[case][lib],
                           "bound_ms": by_case[case][
                               "bound_{}_ms".format(way)],
                           "bound_by": by_case[case][
                               "bound_{}_by".format(way)]}
                    for case, _ in SP_FLASH_CASES}},
            max_abs_err=max(r[kernel]["max_abs_err"] for r in flash_rows),
            max_err_over_limit=max(r[kernel]["max_err_over_limit"]
                                   for r in flash_rows),
            ms=timed[ms], plain_ms=timed[plain],
            bound_ms=timed["bound_{}_ms".format(way)],
            bound_by=timed["bound_{}_by".format(way)],
            library_ms=timed[lib]))
    rows[0]["with_lse"] = {
        "check_launches": sum(r["K1_with_lse_launches"] for r in lse_rows),
        "max_err_over_limit": max(r["max_err_over_limit"]
                                  for r in lse_rows),
        "cases": lse_rows}
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


# ---------------------------------------------------------------------------
# The module-injection and tooling slice (phase_tooling)
# ---------------------------------------------------------------------------

# The LUT op's timing: the sparse BERT layout's pattern (Fixed, block 64) at
# 16 heads and 512 blocks a side (T 32768), against the numpy lowering.
LUT_TIMING_T = 32768
LUT_TIMING_REPEATS = 5
# The injected BERT-large: its HF layer trees made from this seed; one bf16
# training step at the BERT cell's shape and dropout; the fp32 forward of
# INJECT_CHECK_B sequences held to the HF-style plain forward within
# INJECT_TOL of the output's max-abs (24 layers of the same fp32 products
# summed in another order: K1's online softmax, the fused epilogues).
INJECT_SEED = 5
INJECT_CHECK_B = 2
INJECT_TOL = 1e-4
# The checkpoint import: greedy tokens of the imported GPT-2 medium.
CKPT_PROMPTS, CKPT_PROMPT_T, CKPT_NEW = 2, 32, 16
# The profiler's card-vs-CPU count: 4 layers at full width, fp32.
PROFILE_CHECK_LAYERS = 4
PROFILE_CHECK = {"gpt2": (2, 256), "bert": (2, 128)}
# The autotuner's table signatures, (name, B, H, T, causal), bf16 D64: the
# JAX table's three (GPT-2 XL's B2 H25 T1024, B4 H16 T2048, GPT-2 medium's
# B8 H16 T1024, causal) and the BERT cell's B16 H16 T512 (not causal).
AUTOTUNE_SIGS = (("gpt2_xl", 2, 25, 1024, True),
                 ("b4_t2048", 4, 16, 2048, True),
                 ("gpt2_medium", 8, 16, 1024, True),
                 ("bert", 16, 16, 512, False))
AUTOTUNE_REPEATS = 20
AUTOTUNE_CAPTURE_SIG = (1, 16, 256, True)  # a signature no table holds
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))


def _lut_op_check():
    """The host C++ LUT op against the numpy lowering: sparse BERT's
    layout (SPARSE_T, block SPARSE_BLOCK) and phase_sparse's BigBird,
    exactly; both timed on this host at LUT_TIMING_T."""
    layouts = {
        "sparse_bert": _sparse_bert_config().sparse_attention_config
        .make_layout(SPARSE_T),
        "bigbird": BigBirdSparsityConfig(
            num_heads=16, block=SPARSE_BLOCK, num_random_blocks=2,
            num_global_blocks=2, seed=3).make_layout(SPARSE_T)}
    for name, layout in layouts.items():
        for got, want in zip(sk.build_luts(layout),
                             sk.build_luts_reference(layout)):
            if got.dtype != want.dtype or got.shape != want.shape or \
                    not np.array_equal(got, want):
                fail("lut op: {} tables differ from the numpy lowering"
                     .format(name))
    big = FixedSparsityConfig(num_heads=16, block=SPARSE_BLOCK,
                              attention="bidirectional").make_layout(
                                  LUT_TIMING_T)
    op_s = []
    for _ in range(LUT_TIMING_REPEATS):
        t0 = time.perf_counter()
        got = sk.build_luts(big)
        op_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    want = sk.build_luts_reference(big)
    numpy_s = time.perf_counter() - t0
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        fail("lut op: the timed layout's tables differ")
    row = {"layout": "Fixed block {} H16 nb {}".format(
        SPARSE_BLOCK, big.shape[1]), "cells": int(big.size),
        "op_ms": float(np.median(op_s)) * 1e3, "numpy_ms": numpy_s * 1e3,
        "speedup": numpy_s / float(np.median(op_s)),
        "checked": sorted(layouts), "host_cpus": os.cpu_count()}
    print("lut_op " + json.dumps(row))
    return row


def _hf_bert_tree(cfg, seed):
    """BERT layers in the HF flax layout (``kernel [in, out]``) as CPU
    tensors, drawn on the card from a seeded generator (the host's
    single-threaded draw of 300 M values takes seconds): kernels N(0,
    0.02), biases N(0, 0.01), LayerNorm scales 1 + N(0, 0.1), shifts N(0,
    0.1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    h, inter = cfg.hidden_size, cfg.intermediate_size

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g).cpu()

    def dense(i, o):
        return {"kernel": randn(i, o) * 0.02, "bias": randn(o) * 0.01}

    def ln():
        return {"scale": 1.0 + 0.1 * randn(h), "bias": 0.1 * randn(h)}

    return {"encoder": {"layer_{}".format(i): {
        "attention": {"self": {"query": dense(h, h), "key": dense(h, h),
                               "value": dense(h, h)},
                      "output": {"dense": dense(h, h), "LayerNorm": ln()}},
        "intermediate": {"dense": dense(h, inter)},
        "output": {"dense": dense(inter, h), "LayerNorm": ln()}}
        for i in range(cfg.num_hidden_layers)}}


class _InjectedEncoder(torch.nn.Module):
    """The injected fused layers in a stack, with a regression loss (the
    engine's module returns its loss)."""

    def __init__(self, layers):
        super().__init__()
        self.layers = torch.nn.ModuleList(layers)

    def forward(self, x, mask, target, deterministic=True, generator=None):
        for layer in self.layers:
            x = layer(x, mask, deterministic=deterministic,
                      generator=generator)
        return F.mse_loss(x.float(), target)


def _hf_plain_forward(tree, cfg, x, mask):
    """The HF BERT layers' post-LN forward in plain fp32 torch from the HF
    tree, with the fused layer's tanh GELU (HF's ``gelu_new``)."""
    B, T, H = x.shape
    nh = cfg.num_attention_heads
    eps = cfg.layer_norm_eps

    def d(p, v):
        return v @ p["kernel"].cuda() + p["bias"].cuda()

    def lnorm(z, p):
        return F.layer_norm(z, (H,), p["scale"].cuda(), p["bias"].cuda(),
                            eps)

    for i in range(cfg.num_hidden_layers):
        lp = tree["encoder"]["layer_{}".format(i)]
        sa = lp["attention"]["self"]
        q, k, v = (d(sa[n], x).reshape(B, T, nh, H // nh).transpose(1, 2)
                   for n in ("query", "key", "value"))
        s = q @ k.transpose(-1, -2) / (H // nh) ** 0.5 + mask[:, None, None]
        ctx = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(B, T, H)
        a = lnorm(d(lp["attention"]["output"]["dense"], ctx) + x,
                  lp["attention"]["output"]["LayerNorm"])
        f = F.gelu(d(lp["intermediate"]["dense"], a), approximate="tanh")
        x = lnorm(d(lp["output"]["dense"], f) + a, lp["output"]["LayerNorm"])
    return x


def _inject_bert(card):
    """BERT-large's layers in the HF layout through
    ``replace_transformer_layer``: one bf16 training step of the injected
    fused layers on the card (K1, K2, K8, K10a/K10b, K11 counted), their
    fp32 forward against the HF-style plain forward, and the revert bit
    for bit."""
    from deepspeed_tpu_torch.module_inject import (
        replace_transformer_layer, revert_transformer_layer)
    from deepspeed_tpu_torch.ops.transformer import DeepSpeedTransformerLayer
    from deepspeed_tpu_torch.runtime.utils import load_flax_tree
    cfg = BertConfig.bert_large()
    L, H = cfg.num_hidden_layers, cfg.hidden_size
    tree = _hf_bert_tree(cfg, INJECT_SEED)
    t0 = time.perf_counter()
    proto, packed = replace_transformer_layer(
        params=tree, bert_config=cfg, fp16=False, dtype=torch.bfloat16,
        training=True, device="cuda")
    pack_s = time.perf_counter() - t0
    layers = []
    for i in range(L):
        layer = DeepSpeedTransformerLayer(proto.config, "cuda", seed=None)
        load_flax_tree(layer, packed["encoder"]["layer_{}".format(i)])
        layers.append(layer)
    reverted = revert_transformer_layer(params=packed)
    pairs = []

    def walk(a, b, path):
        if isinstance(a, dict):
            if set(a) != set(b):
                fail("revert_transformer_layer: keys differ at " + path)
            for k in a:
                walk(a[k], b[k], path + "." + k)
        else:
            pairs.append((path, a, b))

    walk(tree, reverted, "")
    bad = [p for p, a, b in pairs if not torch.equal(a, b)]
    if bad:
        fail("revert_transformer_layer is not bit for bit: {}".format(
            bad[:3]))
    engine, _, _, _ = initialize(model=_InjectedEncoder(layers),
                                 config_params=BERT_CONFIG, device="cuda")
    ids, mask01 = _bert_batch(cfg, BERT_B, BERT_T, seed=INJECT_SEED,
                              min_len=BERT_T // 4)[:2]
    add_mask = (1.0 - mask01.float()) * -1e9
    g = torch.Generator(device="cuda").manual_seed(INJECT_SEED)
    x = torch.randn(BERT_B, BERT_T, H, device="cuda", generator=g)
    target = torch.randn(BERT_B, BERT_T, H, device="cuda", generator=g)
    mode = at._flash_bwd_mode(*(torch.empty(BERT_B, cfg.num_attention_heads,
                                            BERT_T, 64, device="cuda",
                                            dtype=torch.bfloat16)
                                for _ in range(3)),
                              None, None, None, None, False, 0.125)
    for mod in (at, ln, dr, ge, sk):
        mod.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = engine(x, add_mask, target)
    engine.backward(loss)
    engine.step()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = _launch_counts()
    want = {k: 0 for k in launches}
    want.update(flash_fwd=L, layer_norm_plain=2 * L, dropout_fwd=3 * L,
                dropout_bwd=3 * L, bias_gelu=L)
    want["flash_bwd_" + mode] = L if mode == "fused" else 2 * L
    if launches != want:
        fail("injected BERT launches {} != {}".format(launches, want))
    loss = float(loss.detach())
    if not math.isfinite(loss):
        fail("injected BERT: non-finite loss {}".format(loss))
    del engine
    # The fp32 forward of the same weights against the plain one.
    cfg32 = dataclasses.replace(proto.config, dtype=torch.float32,
                                training=False)
    layers32 = []
    for i in range(L):
        layer = DeepSpeedTransformerLayer(cfg32, "cuda", seed=None)
        load_flax_tree(layer, packed["encoder"]["layer_{}".format(i)])
        layers32.append(layer)
    xs, ms = x[:INJECT_CHECK_B], add_mask[:INJECT_CHECK_B]
    with torch.no_grad():
        h = xs
        for layer in layers32:
            h = layer(h, ms, deterministic=True)
        ref = _hf_plain_forward(tree, cfg, xs, ms)
    err = float((h - ref).abs().max())
    scale = float(ref.abs().max())
    if not err <= INJECT_TOL * scale:
        fail("injected BERT fp32 forward {} from the HF-style plain forward "
             "(limit {})".format(err, INJECT_TOL * scale))
    row = {"layers": L, "batch": BERT_B, "seq": BERT_T, "dtype": "bf16",
           "dropout": cfg.hidden_dropout_prob, "pack_s": pack_s,
           "step_ms": step_s * 1e3, "loss": loss,
           "launches": launches, "bwd_mode": mode,
           "fp32_forward_max_abs_err": err, "fp32_forward_max_abs": scale,
           "revert_leaves_equal": len(pairs), "card": card}
    print("module_inject " + json.dumps(row))
    del layers, layers32
    return launches


def _sparse_swap(card):
    """A dense plain-layer BERT-large swapped by
    ``replace_model_self_attention_with_sparse_self_attention`` against the
    BERT built with ``sparse_attention_config``, from one seed: the first
    training loss (dropout 0.1, one generator seed) bit for bit, K7a and
    K7b launched by the swapped model."""
    from deepspeed_tpu_torch.ops.sparse_attention import SparseAttentionUtils
    cfg = _sparse_bert_config(max_position_embeddings=SPARSE_T,
                              dtype=torch.bfloat16)
    dense_cfg = dataclasses.replace(cfg, sparse_attention_config=None)
    batch = _bert_batch(cfg, SPARSE_B, SPARSE_T, seed=1,
                        min_len=SPARSE_T // 4)
    out = {}
    for name in ("built", "swapped"):
        if name == "built":
            model = BertForPreTraining(cfg, device="cuda", seed=0)
        else:
            model = BertForPreTraining(dense_cfg, device="cuda", seed=0)
            SparseAttentionUtils \
                .replace_model_self_attention_with_sparse_self_attention(
                    model, SPARSE_T, cfg.sparse_attention_config)
        model.requires_grad_(True)
        for mod in (at, ln, dr, ge, sk):
            mod.reset_launches()
        loss = model(*batch, deterministic=False,
                     generator=torch.Generator().manual_seed(0))
        loss.backward()
        torch.cuda.synchronize()
        out[name] = (loss.detach(), _launch_counts())
        del model, loss
    (l0, _), (l1, launches) = out["built"], out["swapped"]
    if not torch.equal(l0, l1):
        fail("sparse swap: loss {} != the config-built model's {}".format(
            float(l1), float(l0)))
    L = cfg.num_hidden_layers
    mode = at._bwd_mode(SPARSE_T, 64, torch.bfloat16)
    if launches["sparse_fwd"] != L or \
            launches["sparse_bwd_" + mode] != (L if mode == "fused" else 2 * L):
        fail("sparse swap: K7 launches {}".format(launches))
    row = {"layers": L, "batch": SPARSE_B, "seq": SPARSE_T,
           "loss": float(l1), "loss_bits_equal": True,
           "launches": {k: v for k, v in launches.items() if v},
           "card": card}
    print("sparse_swap " + json.dumps(row))
    return launches


def _hf_gpt2_state_dict(tree):
    """The reference's GPT-2 names (HF Conv1D weights are flax's [in,
    out]) as CPU tensors, the tied lm_head beside them."""
    sd = {"transformer.wte.weight": tree["wte"],
          "transformer.wpe.weight": tree["wpe"],
          "transformer.ln_f.weight": tree["ln_f"]["scale"],
          "transformer.ln_f.bias": tree["ln_f"]["bias"],
          "lm_head.weight": tree["wte"]}
    i = 0
    while "h_{}".format(i) in tree:
        b, pre = tree["h_{}".format(i)], "transformer.h.{}.".format(i)
        for n in ("ln_1", "ln_2"):
            sd[pre + n + ".weight"] = b[n]["scale"]
            sd[pre + n + ".bias"] = b[n]["bias"]
        for blk, names in (("attn", ("c_attn", "c_proj")),
                           ("mlp", ("c_fc", "c_proj"))):
            for n in names:
                sd[pre + blk + "." + n + ".weight"] = b[blk][n]["kernel"]
                sd[pre + blk + "." + n + ".bias"] = b[blk][n]["bias"]
        i += 1
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def _checkpoint_import(card):
    """GPT-2 medium saved with torch.save in the reference's names under
    <dir>/latest, loaded by ``import_reference_checkpoint``: its greedy
    tokens equal the model it came from."""
    from deepspeed_tpu_torch.module_inject import import_reference_checkpoint
    from deepspeed_tpu_torch.models.gpt2 import params_from_jax
    from deepspeed_tpu_torch.runtime.utils import flax_tree
    cfg = GPT2Config.gpt2_medium(dtype=torch.bfloat16)
    model = GPT2LMHeadModel(cfg, device="cuda", seed=0)
    os.makedirs(os.path.join(REPO_ROOT, "build"), exist_ok=True)
    d = tempfile.mkdtemp(prefix="ckpt_import_",
                         dir=os.path.join(REPO_ROOT, "build"))
    try:
        tag = "global_step7"
        os.makedirs(os.path.join(d, tag))
        t0 = time.perf_counter()
        torch.save({"module": _hf_gpt2_state_dict(flax_tree(model)),
                    "global_steps": 7},
                   os.path.join(d, tag, "mp_rank_00_model_states.pt"))
        with open(os.path.join(d, "latest"), "w") as f:
            f.write(tag)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        params, client = import_reference_checkpoint(d)
        imported = params_from_jax(params, cfg, device="cuda")
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if client.get("global_steps") != 7:
        fail("checkpoint import: client state {}".format(client))
    prompts = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, size=(CKPT_PROMPTS, CKPT_PROMPT_T)))
    want = generation.generate(model, prompts, CKPT_NEW, temperature=0.0)
    got = generation.generate(imported, prompts, CKPT_NEW, temperature=0.0)
    if not torch.equal(got, want):
        fail("checkpoint import: greedy tokens differ")
    print("checkpoint_import " + json.dumps({
        "model": "gpt2-medium", "save_s": save_s, "load_s": load_s,
        "prompts": CKPT_PROMPTS, "new_tokens": CKPT_NEW,
        "tokens_equal": True, "card": card}))


def _profiled(model, config, batch, device):
    engine, _, _, _ = initialize(model=model, config_params=config,
                                 device=device)
    engine.train_batch(batch)
    prof = engine.flops_profile
    rec = [r for r in engine.perf_xray()["programs"]
           if r["program"] == "train_step"][0]
    return prof, rec


def _profiler_check(card):
    """The flops profiler on GPT-2 medium's training step (bf16, the
    training cell's batch), one profiled step outside any timed window;
    then, at PROFILE_CHECK_LAYERS layers and fp32, the profiled step's
    flops and bytes and the x-ray's train_step record on the card equal
    the CPU's, for GPT-2 (K1/K2) and the fused BERT at dropout 0.1 (K1/K2,
    K8, K10, K11). Each batch is on its device before the step: an upload
    inside the step would count on the card's side only."""
    prof_cfg = {"flops_profiler": {"enabled": True, "start_step": 0,
                                   "end_step": 0, "module_depth": 2,
                                   "top_modules": 3}}
    cfg = GPT2Config.gpt2_medium(dtype=torch.bfloat16, dropout=0.0)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(TRAIN_B, TRAIN_T))).to("cuda")
    t0 = time.perf_counter()
    prof, rec = _profiled(GPT2LMHeadModel(cfg, device="cuda", seed=0),
                          dict(TRAIN_CONFIG, **prof_cfg), (ids, ids), "cuda")
    step_s = time.perf_counter() - t0
    h, L, V = cfg.n_embd, cfg.n_layer, cfg.vocab_size
    weights = L * 12 * h * h + V * h
    formula = 3 * TRAIN_B * TRAIN_T * (2 * weights + 4 * L * TRAIN_T * h)
    if not prof["flops"] > 0 or prof["steps"] != 1:
        fail("flops profiler: {}".format({k: prof[k] for k in (
            "flops", "steps")}))
    if abs(sum(f for _, f, _ in prof["modules"]) - prof["flops"]) > 0:
        fail("flops profiler: the module rows do not sum to the total")
    print("flops_profile " + json.dumps({
        "model": "gpt2-medium bf16", "batch": TRAIN_B, "seq": TRAIN_T,
        "flops": prof["flops"], "bytes_accessed": prof["bytes_accessed"],
        "model_flops_formula": formula,
        "flops_over_formula": prof["flops"] / formula,
        "xray_train_step_flops": rec["flops"], "params": prof["params"],
        "profiled_step_s": step_s, "modules_depth2": len(prof["modules"]),
        "card": card}))
    print("flops_profile_text " + json.dumps(prof["text"]))
    rows = {}
    for name, (B, T) in PROFILE_CHECK.items():
        counts = {}
        for device in ("cuda", "cpu"):
            if name == "gpt2":
                c = dataclasses.replace(GPT2Config.gpt2_medium(
                    dtype=torch.float32, dropout=0.0),
                    n_layer=PROFILE_CHECK_LAYERS)
                x = torch.from_numpy(np.random.RandomState(1).randint(
                    0, c.vocab_size, size=(B, T))).to(device)
                model, batch = GPT2LMHeadModel(c, device=device, seed=0), \
                    (x, x)
                config = {"train_batch_size": B, "optimizer": {
                    "type": "AdamW", "params": {"lr": 1e-4}}}
            else:
                c = BertConfig.bert_large(dtype=torch.float32,
                                          num_hidden_layers=
                                          PROFILE_CHECK_LAYERS)
                model = BertForPreTraining(c, device=device, seed=0)
                batch = tuple(t.to(device) for t in _bert_batch(
                    c, B, T, seed=2, min_len=T // 4))
                config = {"train_batch_size": B, "optimizer": {
                    "type": "AdamW", "params": {"lr": 1e-4}}}
            for mod in (at, ln, dr, ge, sk):
                mod.reset_launches()
            p, r = _profiled(model, dict(config, **prof_cfg), batch, device)
            counts[device] = {"profiler_flops": p["flops"],
                              "profiler_bytes": p["bytes_accessed"],
                              "xray_flops": r["flops"],
                              "xray_bytes": r["bytes_accessed"],
                              "launches": {k: v for k, v in
                                           _launch_counts().items() if v}}
            del model
        card_c, cpu_c = counts["cuda"], counts["cpu"]
        if not card_c["launches"]:
            fail("profiler check {}: no kernel ran on the card".format(name))
        for key in ("profiler_flops", "xray_flops", "profiler_bytes",
                    "xray_bytes"):
            if card_c[key] != cpu_c[key]:
                fail("profiler check {}: {} on the card {} != the CPU's {}"
                     .format(name, key, card_c[key], cpu_c[key]))
        rows[name] = dict(card=card_c, cpu=cpu_c, batch=B, seq=T)
    print("profiler_card_vs_cpu " + json.dumps(rows))


def _autotune_sweep():
    """``DS_TPU_AUTOTUNE=force`` sweeps K2a/K2b at AUTOTUNE_SIGS into a
    fresh user cache; ``validate_table`` accepts the rows, which are
    written under chiprun_out/ beside the bundled rows. Then a graph
    capture that runs the flash backward at a signature no table holds,
    under ``DS_TPU_AUTOTUNE=1``: the capture completes and no sweep ran
    (no row, no memo)."""
    from deepspeed_tpu_torch.ops import autotuner
    os.makedirs(os.path.join(REPO_ROOT, "build"), exist_ok=True)
    cache = tempfile.mkdtemp(prefix="autotune_",
                             dir=os.path.join(REPO_ROOT, "build"))
    saved = {k: os.environ.get(k) for k in ("DS_TPU_AUTOTUNE",
                                            "XDG_CACHE_HOME")}
    os.environ["XDG_CACHE_HOME"] = cache
    autotuner._MEMO.clear()
    autotuner._USER = None
    rows = {}
    try:
        os.environ["DS_TPU_AUTOTUNE"] = "force"
        for name, B, H, T, causal in AUTOTUNE_SIGS:
            q, k, v, do, mask = _flash_inputs(B, T, torch.bfloat16, False,
                                              seed=7, H=H)
            o, lse = at.flash_fwd(q, k, v, None, causal)
            delta = (do.float() * o.float()).sum(-1, keepdim=True)
            sig = at.flash_signature(B, H, T, T, 64, q.dtype, causal)
            chosen = at._flash_bwd_mode(q, k, v, None, lse, delta, do, causal,
                                        0.125)
            rows[name] = (sig, chosen)
            del q, k, v, do, o, lse, delta
        with open(autotuner._user_cache_path()) as f:
            table = json.load(f)
        autotuner.validate_table(table, source="the sweep's rows")
        if len(table) != len(AUTOTUNE_SIGS):
            fail("autotune: {} rows for {} signatures".format(
                len(table), len(AUTOTUNE_SIGS)))
        os.environ["DS_TPU_AUTOTUNE"] = "1"
        B, H, T, causal = AUTOTUNE_CAPTURE_SIG
        q, k, v, do, _ = _flash_inputs(B, T, torch.bfloat16, False, seed=8,
                                       H=H)
        o, lse = at.flash_fwd(q, k, v, None, causal)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        key = autotuner.table_key("flash_attention", at.flash_signature(
            B, H, T, T, 64, q.dtype, causal))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            at.flash_bwd(q, k, v, None, lse, delta, do, causal)
        graph.replay()
        torch.cuda.synchronize()
        with open(autotuner._user_cache_path()) as f:
            after = json.load(f)
        if key in after or key in autotuner._MEMO:
            fail("autotune: a capture-time call swept ({})".format(key))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        autotuner._MEMO.clear()
        autotuner._USER = None
        shutil.rmtree(cache, ignore_errors=True)
    bundled = autotuner._load(autotuner._BUNDLED_PATH)
    out = {}
    for name, (sig, chosen) in rows.items():
        key = autotuner.table_key("flash_attention", sig)
        out[name] = dict(table[key], key=key,
                         bundled=bundled.get(key, {}).get("choice"))
        if chosen != table[key]["choice"]:
            fail("autotune: {} chose {} but wrote {}".format(
                name, chosen, table[key]["choice"]))
    os.makedirs(os.path.join(REPO_ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO_ROOT, "chiprun_out",
                           "autotune_rows.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    print("autotune " + json.dumps({"rows": out, "capture_swept": False}))
    return out


def phase_tooling(card):
    """The module-injection and tooling slice at full width (module
    docstring, phase 14a); prints each part's seconds."""
    seconds, out = {}, {}
    for part, fn in (("lut_op", _lut_op_check),
                     ("inject", lambda: _inject_bert(card)),
                     ("swap", lambda: _sparse_swap(card)),
                     ("checkpoint_import", lambda: _checkpoint_import(card)),
                     ("profiler", lambda: _profiler_check(card)),
                     ("autotune", _autotune_sweep)):
        t0 = time.perf_counter()
        out[part] = fn()
        seconds[part] = time.perf_counter() - t0
    print("tooling_seconds " + json.dumps(seconds))
    return out


def main():
    seconds = collections.OrderedDict()

    def timed(phase, *args, **kwargs):
        """Run a phase and add its wall-clock seconds to ``seconds``."""
        t0 = time.perf_counter()
        out = phase(*args, **kwargs)
        seconds[phase.__name__] = seconds.get(phase.__name__, 0.0) + \
            time.perf_counter() - t0
        print("phase_done {} {:.1f}".format(phase.__name__,
                                            seconds[phase.__name__]),
              flush=True)
        return out

    card = timed(phase_env)
    timed(phase_build)
    rows = timed(phase_kernels)
    variant_rows = timed(phase_decode_variants)
    tp_rows = timed(phase_tp_kernels)
    timed(phase_stress)
    flash_rows, lse_rows = timed(phase_flash)
    row_rows = timed(phase_rows)
    softmax_rows, softmax_launches = timed(phase_softmax)
    model = GPT2LMHeadModel(GPT2Config.gpt2_medium(dtype=torch.bfloat16),
                            device="cuda", seed=0)
    serve = {path[0]: timed(phase_serve, card, model, *path)[0]
             for path in SERVE_PATHS}
    spec = {path[0]: timed(phase_serve, card, model, *path, tiled=True)
            for path in SPEC_PATHS}
    on, off = spec["serve_spec"][1], spec["serve_spec_off"][1]
    if on["program_keys"] != off["program_keys"]:
        fail("serve_spec met the keys {} and serve_spec_off {}: speculation "
             "must not add a program".format(on["program_keys"],
                                             off["program_keys"]))
    timed(phase_graph_vs_eager, model)
    timed(phase_telemetry, card, model)
    timed(phase_sustained, card, model)
    # The resilience and hierarchy phases at GPT-2 medium's width and
    # SHORT_LAYERS of its layers: their step counts set their time, and the
    # smoke must stay inside its limit; their checks are per layer.
    short = GPT2LMHeadModel(dataclasses.replace(
        model.config, n_layer=SHORT_LAYERS), device="cuda", seed=0)
    timed(phase_resilience, card, short)
    timed(phase_chaos, card, model)
    hier = timed(phase_hierarchy, card, short)
    del short
    timed(phase_sustained_hier, card, model)
    fleet = timed(phase_fleet, card, model)
    disagg = timed(phase_disagg, card, model)
    timed(phase_frontdoor, card, model)
    timed(phase_frontdoor_resilience, card, model)
    timed(phase_adapters, card, model)
    timed(phase_xray, card, model)
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
    timed(phase_greedy)
    train_launches = timed(phase_train, card)
    timed(phase_train_breakdown, card)
    timed(phase_train_consistency)
    bert_launches = timed(phase_bert, card)
    timed(phase_bert_consistency)
    sparse_rows = timed(phase_sparse)
    split_rows = timed(phase_split_default)
    sparse_launches = timed(phase_bert_sparse, card)
    timed(phase_bert_sparse_consistency)
    timed(phase_tooling, card)
    offload_launches = timed(phase_offload, card)
    timed(phase_offload_consistency)
    dp_launches = timed(phase_data_parallel, card)
    mp_launches = timed(phase_model_parallel, card)
    tp_serve_launches = mp_launches.pop("serve")
    sp_launches = timed(phase_sequence_parallel, card)
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
    for row, kind in zip(kernels, ("decode", "q8", "paged", "paged_q8")):
        # The hierarchy phase's runs of each decode kernel (its decode and
        # prefill lanes), beside the main path's count.
        row["hierarchy_launches"] = {
            label: hier[label]["launches"][kind] for label in (
                "dense", "paged_int8_spec", "dense_int8_spec")}
        # The fleet phases' runs, per replica, and the kernel at the
        # fleet's shapes.
        row["fleet_launches"] = {
            "kill": {r: n[kind] for r, n in
                     fleet["kill"]["launches"].items()},
            "paged_int8": {r: n[kind] for r, n in
                           fleet["paged_int8"]["launches"].items()},
            "disagg": {r: n[kind] for r, n in
                       disagg["disagg"]["launches"].items()},
            "mixed": {r: n[kind] for r, n in
                      disagg["mixed"]["launches"].items()}}
        if kind in tp_rows:
            # Tensor-parallel serving (phase_model_parallel): each model
            # rank's launches on its 8 heads, and the kernel at that shape.
            row["model_parallel_serve"] = {
                "launches_per_rank": [n[kind] for n in tp_serve_launches],
                "cases": [{key: r.get(key) for key in (
                    "case", "B", "H", "S", "T", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "max_abs_err",
                    "max_err_over_limit")} for r in tp_rows[kind]]}
        if kind in variant_rows["fleet_shapes"]:
            row["fleet_shapes"] = [
                {key: r.get(key) for key in (
                    "case", "B", "S", "T", "ms", "plain_ms", "bound_ms",
                    "bound_by", "max_abs_err", "max_err_over_limit")}
                for r in variant_rows["fleet_shapes"][kind]]
    kernels += _flash_kernel_rows(flash_rows, train_launches, bert_launches,
                                  split_rows, offload_launches, lse_rows,
                                  dp_launches, mp_launches, sp_launches)
    kernels += _row_kernel_rows(row_rows, bert_launches)
    kernels.append(_softmax_kernel_row(softmax_rows, softmax_launches))
    kernels += _sparse_kernel_rows(sparse_rows, sparse_launches, split_rows)
    print("phase_seconds " + json.dumps(dict(seconds, total=sum(
        seconds.values()))))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    _ranks = {"--model-parallel-rank=": mp_rank,
              "--sequence-parallel-rank=": sp_rank}
    _rank = [(fn, a.split("=", 1)[1]) for a in sys.argv[1:]
             for flag, fn in _ranks.items() if a.startswith(flag)]
    if _rank:
        _rank[0][0](_rank[0][1])
    else:
        main()
