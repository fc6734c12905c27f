// Block-sparse flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of deepspeed_tpu/ops/sparse_attention/kernels.py:
//   K7a `_fwd_kernel` (launched from `_make_fn`'s forward)
//       -> fwd_wgmma_kernel (bf16, block 64), fwd_async_kernel (bf16,
//          blocks 16 and 32), fwd_kernel (fp32, fp16)
//   K7b fused `_bwd_fused_kernel`
//       -> dkdv_async_kernel (bf16) / dkdv_kernel with kDq = true (dq by
//          atomics into an fp32 buffer)
//   K7b split `_bwd_dkv_kernel` and `_bwd_dq_kernel`
//       -> dkdv_*kernel with kDq = false, then dq_async_kernel / dq_kernel
// The plain PyTorch versions they are held against are
// `sparse_fwd_reference` and `sparse_bwd_reference` in
// deepspeed_tpu_torch/ops/sparse_attention/kernels.py.
//
// What they compute, per (b, h), q/k/v [T, 64], T a multiple of the layout's
// block (16, 32 or 64). A lookup table (LUT) lists, for each query block, the
// key blocks it attends to (the forward LUT, [H, nb, deg]), and for each key
// block the query blocks that attend to it (the transposed LUT); -1 pads a
// row. For a (query, key) pair of a listed block pair:
//   s = scale * q.k; with a key-padding mask kpm[b, key] and a score bias
//   bias[b, h, query, key] (each optional, each added or, in 'mul' mode,
//   multiplied); causal keeps key <= query, else -1e30 (the JAX package's
//   NEG_INF), as is every pair of an unlisted block;
//   forward: online softmax from m = -1e30 with m_safe = max(m, -5e29) (so
//     that a row with no visible key traps nothing), l clamped at 1e-30,
//     o = sum p v / l (0 for a row with no visible key),
//     lse = max(m, -5e29) + log l (fp32);
//   backward: p = exp(s - lse), ds = p * (do.v - delta) * scale, times kpm
//     and bias in 'mul' mode (the mask scales the score, so it scales its
//     gradient), delta = rowsum(do * o) (given); dq = ds k, dk = ds^T q,
//     dv = p^T do.
// The forward scales the product q.k (the TPU kernel scales q first; for
// bf16 inputs and scale = 1/8 the two are the same numbers). Scores,
// softmax statistics, p, ds and every accumulator are fp32.
//
// Bound on an H100 SXM. At the sparse BERT-large path (B 2, H 16, T 4096,
// block 64, the Fixed layout: 19 of 64 key blocks per query block) a
// block pair costs 4 * 64 * 64 * 64 flops forward and 10 * 64^3 backward,
// 1216 pairs per (b, h): 40.8 GFLOP forward, 0.041 ms at 989 TFLOP/s,
// against 67 MB of q, k, v and o, 0.020 ms at 3.35 TB/s. Operations bound
// it, as they do the dense flash kernels (csrc/flash_attention.cu).
//
// What the design does about it:
//   - the [T, T] scores never exist: one block x block tile of scores at a
//     time lives in registers (bf16) or shared memory (fp32, fp16);
//   - the layout is a loop over the block's LUT row; a -1 entry is skipped,
//     or in the bf16 kernels never reached, as a row's -1 padding is at its
//     end (in the TPU kernel it aliases block 0 and adds exact zeros), so
//     only listed blocks are loaded and computed;
//   - bf16 runs its products on the tensor cores with fp32 accumulation, P
//     and dS entering the second product as hi + lo bf16. K7a at block 64
//     (the sparse BERT path) is warp-specialised on wgmma: a producer
//     warpgroup keeps a TMA ring of swizzled K/V tiles in flight, and two
//     consumer warpgroups serve two query blocks whose LUT rows are equal
//     (the forward schedule pairs them), so each K/V tile read feeds 128
//     rows, and take turns at the tensor cores, so one consumer's softmax
//     runs under the other's products (fwd_wgmma_kernel). The other bf16
//     kernels run mma.sync m16n8k16, a warp per 16 rows of the block, on
//     tiles staged by cp.async with every operand taken by ldmatrix (the
//     section below);
//     K7b's dk/dv kernel issues its key blocks by LUT count, largest first;
//     fp32 and fp16 run register-blocked FMAs on a 16 x 8 thread grid;
//   - the TPU's fused backward scatters dk/dv into full-length fp32 VMEM
//     over a sequential grid. Blocks here run in parallel, so the fused
//     backward turns the sweep around: one CTA per key block walks the
//     transposed LUT with dk/dv in registers and adds dq into an fp32
//     buffer by atomics (one product of atomics per block pair; walking the
//     forward LUT instead would need atomics for both dk and dv). The split
//     backward adds a dq kernel over the forward LUT and uses no atomics.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"

namespace {

constexpr int kD = 64;  // head width
constexpr float kNegInf = -1e30f;
constexpr float kHalfNegInf = 0.5f * kNegInf;

// The optional score masks of one (b, h).
struct Masks {
  const float* kpm;   // [T] of batch row b, or null
  const float* bias;  // [T, T] of (b, h), or null
  int T;
  int causal, kpm_mul, bias_mul;
};

__device__ __forceinline__ Masks make_masks(const float* kpm,
                                            const float* bias, int b,
                                            size_t bh, int T, int causal,
                                            int kpm_mul, int bias_mul) {
  Masks mk;
  mk.kpm = kpm != nullptr ? kpm + (size_t)b * T : nullptr;
  mk.bias = bias != nullptr ? bias + bh * T * T : nullptr;
  mk.T = T;
  mk.causal = causal;
  mk.kpm_mul = kpm_mul;
  mk.bias_mul = bias_mul;
  return mk;
}

// The score of (row, key) after the masks, in the TPU kernel's order: kpm,
// bias, then the causal cut (the block is listed: the caller skips -1).
__device__ __forceinline__ float masked(float s, const Masks& mk, int row,
                                        int key) {
  if (mk.kpm != nullptr) {
    const float m = mk.kpm[key];
    s = mk.kpm_mul ? s * m : s + m;
  }
  if (mk.bias != nullptr) {
    const float bv = mk.bias[(size_t)row * mk.T + key];
    s = mk.bias_mul ? s * bv : s + bv;
  }
  if (mk.causal && key > row) s = kNegInf;
  return s;
}

// ds = p * (dp - delta) * scale, times the masks in 'mul' mode.
__device__ __forceinline__ float score_grad(float p, float dp, float delta,
                                            float scale, const Masks& mk,
                                            int row, int key) {
  float ds = p * (dp - delta) * scale;
  if (mk.kpm != nullptr && mk.kpm_mul) ds *= mk.kpm[key];
  if (mk.bias != nullptr && mk.bias_mul)
    ds *= mk.bias[(size_t)row * mk.T + key];
  return ds;
}

// The same two for the tensor-core kernels, which take the key's padding
// mask entry kpm_v from registers or shared memory (masked and score_grad
// serve the FMA kernels). The score of a listed pair from s = q.k: times
// scale, then kpm_v, the bias (its entry returned in bv for the 'mul'
// gradient) and, where `cut`, the causal cut.
__device__ __forceinline__ float pair_score(float s, float scale, float kpm_v,
                                            const Masks& mk, int row, int key,
                                            bool cut, float& bv) {
  float x = s * scale;
  if (mk.kpm != nullptr) x = mk.kpm_mul ? x * kpm_v : x + kpm_v;
  if (mk.bias != nullptr) {
    bv = mk.bias[(size_t)row * mk.T + key];
    x = mk.bias_mul ? x * bv : x + bv;
  }
  if (cut && key > row) x = kNegInf;
  return x;
}

// ds = p * (dp - delta) * scale, times kpm_v and the bias entry bv in 'mul'
// mode (the mask scales the score, so it scales its gradient).
__device__ __forceinline__ float pair_grad(float p, float dp, float delta,
                                           float scale, float kpm_v, float bv,
                                           const Masks& mk) {
  float ds = p * (dp - delta) * scale;
  if (mk.kpm != nullptr && mk.kpm_mul) ds *= kpm_v;
  if (mk.bias != nullptr && mk.bias_mul) ds *= bv;
  return ds;
}

// The CTA's LUT row into shared memory.
__device__ __forceinline__ void stage_lut(int* dst, const int* src, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
}

// ------------------------------------------------ bf16 on the tensor cores
// mma.sync m16n8k16 and the Hopper operand path (attention_common.cuh):
// tiles are copied by cp.async into shared memory in their natural [row][d]
// layout, rows of 64 bf16 padded to 72 (every ldmatrix row then starts 16
// bytes further round the 32 banks), and every operand comes out of them by
// ldmatrix (.trans where a tile is read across its rows). K7a at block 64
// runs on wgmma instead (fwd_wgmma_kernel below).

constexpr int kLdh = kD + 8;
constexpr int kNT = kD / 8;   // 8-column tiles over 64
constexpr int kKS = kD / 16;  // 16-deep steps over 64
constexpr int kStages = 2;    // the cp.async ring

// Rows g and g + 8 (from row_a) of 64 accumulator columns times mul_a /
// mul_b, as bf16 pairs.
__device__ __forceinline__ void store_rows(bf16* base,
                                           const float (&acc)[kNT][4],
                                           int row_a, float mul_a,
                                           float mul_b, int t) {
#pragma unroll
  for (int nd = 0; nd < kNT; ++nd) {
    const int c = 8 * nd + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(base + (size_t)row_a * kD + c) =
        __floats2bfloat162_rn(acc[nd][0] * mul_a, acc[nd][1] * mul_a);
    *reinterpret_cast<__nv_bfloat162*>(base + (size_t)(row_a + 8) * kD + c) =
        __floats2bfloat162_rn(acc[nd][2] * mul_b, acc[nd][3] * mul_b);
  }
}

// The number of listed blocks in a LUT row of deg entries (build_luts pads
// each row with -1 at its end), counted by the whole CTA; every thread
// gets it.
__device__ __forceinline__ int row_count(const int* __restrict__ lrow,
                                         int deg) {
  int count = 0;
  for (int e0 = 0; e0 < deg; e0 += blockDim.x) {
    const int e = e0 + threadIdx.x;
    count += __syncthreads_count(e < deg && __ldg(lrow + e) >= 0);
  }
  return count;
}

// BLK rows from row0 of a contiguous [*, 64] bf16 matrix into shared memory
// (row stride kLdh) by cp.async, 16 bytes a thread.
template <int BLK>
__device__ __forceinline__ void async_rows(bf16* dst, const bf16* src,
                                           int row0) {
  for (int e = threadIdx.x; e < BLK * (kD / 8); e += 2 * BLK) {
    const int r = e / (kD / 8), c = (e % (kD / 8)) * 8;
    cp_async16(dst + r * kLdh + c, src + (size_t)(row0 + r) * kD + c, true);
  }
}

// Entries [row0, row0 + BLK) of an fp32 vector into shared memory by the
// threads [tid0, tid0 + BLK).
template <int BLK>
__device__ __forceinline__ void async_vec(float* dst, const float* src,
                                          int row0, int tid0) {
  const int i = threadIdx.x - tid0;
  if (i >= 0 && i < BLK) cp_async4(dst + i, src + row0 + i, true);
}

// The online softmax's step for one tile of scores s (rows g and g + 8 of
// a warp's 16, n-tiles over the tile's keys, already masked): the row
// maxima over the 4 lanes of a row, m updated, alpha = the factor that
// rescales the running sums, and s turned into p, whose partial row sums
// are returned in rs. The exponentials are ex2 of the difference taken in
// natural units, then scaled by log2(e): a row padded at -1e9 everywhere
// (fp32 ulp 64) keeps the plain version's probabilities. m starts at
// -1e30 and the shift is max(m, -5e29), so a row with no visible key yet
// gets p = 0 and alpha = 0.
template <int NK>
__device__ __forceinline__ void softmax_step(float (&s)[NK][4], float (&m)[2],
                                             float (&alpha)[2],
                                             float (&rs)[2]) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
  float m_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    m_safe[r] = fmaxf(m_new, kHalfNegInf);
    alpha[r] = ex2((m[r] - m_safe[r]) * kLog2e);
    m[r] = m_new;
    rs[r] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2((s[n][e] - m_safe[e >> 1]) * kLog2e);
      s[n][e] = p;
      rs[e >> 1] += p;
    }
}

// The end of K7a for rows g and g + 8 (row_a, row_a + 8) of a warp: o = acc
// / l (0 for a row with no visible key: l is clamped at 1e-30) and lse =
// max(m, -5e29) + log l, from the lane-partial sums l.
__device__ __forceinline__ void fwd_epilogue(bf16* ob, float* lb,
                                             const float (&acc)[kNT][4],
                                             const float (&m)[2],
                                             float (&l)[2], int row_a,
                                             int t) {
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float lv = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / lv;
    if (t == 0) lb[row_a + 8 * r] = fmaxf(m[r], kHalfNegInf) + logf(lv);
  }
  store_rows(ob, acc, row_a, inv[0], inv[1], t);
}

// K7a for bf16 at blocks 16 and 32: one CTA per (query block, h, b), a warp
// per 16 of its rows, whose Q fragments stay in registers. It walks the LUT
// row to its count; per listed key block (K, V and the key-padding mask
// slice in the cp.async ring, the next block's copy issued before this
// block's products): S = Q K^T, the masks (pair_score, the mask entries
// from shared memory), the online softmax, and O += P V with P as hi + lo
// bf16 and V's fragments by ldmatrix.trans from its natural tile.
template <int BLK>
constexpr size_t fwd_async_smem() {
  return (1 + kStages * 2) * BLK * kLdh * sizeof(bf16) +
         kStages * BLK * sizeof(float);
}

template <int BLK>
__global__ void __launch_bounds__(2 * BLK)
    fwd_async_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ lut,
                     int deg, const float* __restrict__ kpm,
                     const float* __restrict__ bias, bf16* __restrict__ o,
                     float* __restrict__ lse, int H, int T, float scale,
                     int causal, int kpm_mul, int bias_mul) {
  constexpr int kNK = BLK / 8;  // n-tiles over the key block
  constexpr int kTileB = BLK * kLdh;
  extern __shared__ __align__(16) unsigned char smem_fwd[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_fwd);  // [BLK][kLdh] Q
  bf16* kv_s = q_s + kTileB;                      // stages: K, V
  float* m_s = reinterpret_cast<float*>(kv_s + kStages * 2 * kTileB);

  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const int* lrow = lut + ((size_t)h * gridDim.x + blockIdx.x) * deg;
  const bf16* kb = k + bh * T * kD;
  const bf16* vb = v + bh * T * kD;
  const Masks mk = make_masks(kpm, bias, b, bh, T, causal, kpm_mul, bias_mul);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;
  const int q0 = blockIdx.x * BLK;
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const int count = row_count(lrow, deg);

  auto issue = [&](int j) {
    const int st = j % kStages;
    const int k0 = __ldg(lrow + j) * BLK;
    bf16* ks = kv_s + st * 2 * kTileB;
    async_rows<BLK>(ks, kb, k0);
    async_rows<BLK>(ks + kTileB, vb, k0);
    if (mk.kpm != nullptr) async_vec<BLK>(m_s + st * BLK, mk.kpm, k0, 0);
  };
  async_rows<BLK>(q_s, q + bh * T * kD, q0);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < count) issue(i);
    cp_async_commit();
  }

  uint32_t qf[kKS][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kNT][4];
  zero(acc);
  for (int j = 0; j < count; ++j) {
    cp_async_wait<kStages - 2>();  // block j (and Q) have landed
    // ... for every thread, and every warp is done with block j - 1, whose
    // stage the next copy refills.
    __syncthreads();
    if (j + kStages - 1 < count) issue(j + kStages - 1);
    cp_async_commit();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk)
        lhs_frag<kLdh>(qf[kk], q_s, r0, kk, lane);
    }
    const int k0 = __ldg(lrow + j) * BLK;
    const int st = j % kStages;
    const bf16* ks = kv_s + st * 2 * kTileB;
    const float* ms = m_s + st * BLK;
    // Causal: a warp whose rows all precede the block sees none of it (its
    // scores would all be cut, and add exact zeros).
    if (causal && k0 > q0 + r0 + 15) continue;
    float s[kNK][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) mma_nt<kLdh>(s, qf[kk], ks, kk, lane);
    const bool cut = causal && k0 + BLK - 1 > q0 + r0;
#pragma unroll
    for (int n = 0; n < kNK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);  // key within the block
        const float kpm_v = mk.kpm != nullptr ? ms[c] : 0.f;
        float bv = 0.f;
        s[n][e] = pair_score(s[n][e], scale, kpm_v, mk, row[e >> 1], k0 + c,
                             cut, bv);
      }
    float alpha[2], rs[2];
    softmax_step(s, m, alpha, rs);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
#pragma unroll
    for (int jj = 0; jj < BLK / 16; ++jj) {
      uint32_t hi[4], lo[4];
      frag_from_acc_t(s[2 * jj], s[2 * jj + 1], hi, lo);
      mma_nn2<kLdh>(acc, hi, lo, ks + kTileB, jj, lane);
    }
  }
  cp_async_wait<0>();  // a row with no listed block leaves Q in flight
  fwd_epilogue(o + bh * T * kD, lse + bh * T, acc, m, l, row[0], t);
}

// ------------------------------------- K7a for bf16 at block 64 on wgmma
// fwd_wgmma_kernel: one CTA per item of the layout's forward schedule
// (kernels.py `build_fwd_schedule`: h, query block a, query block b or -1,
// count; the two blocks' LUT rows are equal) and batch row, 384 threads:
//   - warpgroup 0 is the producer: it gives up its registers (setmaxnreg
//     24) and one thread keeps a ring of kWgStages K/V tiles in flight by
//     TMA, 128-byte swizzled (the tensor maps are built in the C entry
//     point), with each key block's 64 key-padding entries copied beside
//     them (cp.async.bulk); completion goes through mbarriers (full: the
//     bytes landed; empty: every consumer warp is done with the stage);
//   - warpgroups 1 and 2 are the consumers (setmaxnreg 240), 64 query rows
//     each (blocks a and b; an unpaired item runs one). They share every
//     K/V tile, so a pair reads the layout's tiles once for 128 rows;
//   - S = Q K^T is wgmma.m64n64k16 with Q and K both K-major swizzled
//     tiles in shared memory; O += P V takes P from registers (hi + lo
//     bf16, the accumulator layout of S is the left-operand layout) and V
//     as a transposed (MN-major) swizzled B: no tile is staged transposed;
//   - per tile j, S_j's product is issued, then P_{j-1} V_{j-1}; the
//     warpgroup waits for S_j alone (wait_group 1), runs the masks and the
//     online softmax step, waits for P_{j-1} V_{j-1}, rescales O, releases
//     tile j - 1's stage and splits P_j. (The compiler schedules that
//     second wait ahead of the softmax's exponentials; forcing it after
//     them, by a branch on their sum, timed slower.)
//   - the two consumers take turns issuing their products (named barriers
//     1 and 2), so one warpgroup's softmax runs while the other's products
//     hold the tensor cores.
// The softmax (FP32, ALU and ex2 work at two consumer warps per SM
// sub-partition) bounds it, not the products: a clock64 phase profile and
// timing-only cuts put most of each tile's time in the masks and the
// softmax (PERF.md).
constexpr int kWgThreads = 128;                // a warpgroup
constexpr int kWgStages = 8;                   // the TMA ring
constexpr int kSwTile = 64 * kD;               // a 64 x 64 bf16 tile
constexpr uint32_t kSwTileBytes = kSwTile * 2;  // 8 KB, 128-byte rows
constexpr int kFwdItemCols = 4;  // a schedule item: h, a, b or -1, count

// Shared memory: 1 KB of slack to align the swizzled tiles at 1024 bytes,
// two Q tiles, the K and V stages, the mask stages and the barriers (full
// and empty per stage, one for Q). At 8 stages a CTA takes 147 KB, so one
// CTA runs on an SM: the consumers' setmaxnreg then always finds the
// registers the producer gave up.
constexpr size_t fwd_wgmma_smem() {
  return 1024 + (2 + 2 * kWgStages) * kSwTileBytes +
         kWgStages * 64 * sizeof(float) +
         (2 * kWgStages + 1) * sizeof(uint64_t);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive, and expect `bytes` more from asynchronous copies in this phase.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// The 64 x 64 tile of rows [row, row + 64) of (b, h) = plane bh from a
// [B * H, T, 64] tensor map into dst (1024-byte aligned), completing on bar.
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map,
                                         int row, int bh, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(bh),
      "r"(smem_u32(bar))
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The wgmma descriptor of a 128-byte-swizzled bf16 tile whose 128-byte
// rows start at smem address addr (a 1024-byte-aligned tile plus a step's
// offset): 8-row groups 1024 bytes apart (the stride offset). The leading
// offset is not read at these widths: a K-major operand's 16-deep step and
// a 64-wide MN-major one each lie within one swizzled row. A K-major
// operand steps 16 deep by adding 32 bytes (2 in the address field); the
// MN-major V steps 16 keys by adding 16 rows (2048 bytes, 128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The accumulators are written asynchronously: keep the compiler from
// moving their reads or writes across a wgmma wait.
__device__ __forceinline__ void fence_acc(float (&d)[kNT][4]) {
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}

#define DS_WGMMA_D                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define DS_WGMMA_OUT(d)                                                      \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),                \
      "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),            \
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),            \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),            \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),            \
      "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),            \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),            \
      "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])

// d (= or +=, by `accumulate`) A B for a 64 x 16 A and a 16 x 64 B, both
// K-major tiles in shared memory. Thread (warp w, g, t) of the warpgroup
// holds rows 16 w + g and 16 w + g + 8 of d in mma.sync's layout: d[n][e]
// is column 8 n + 2 t + (e & 1) of row g + 8 (e >> 1).
__device__ __forceinline__ void wgmma_ss(float (&d)[kNT][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DS_WGMMA_D
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : DS_WGMMA_OUT(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B for A from registers (mma.sync's left-operand layout, rows 16 w
// .. 16 w + 15 in warp w) and an MN-major (transposed) B in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[kNT][4],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DS_WGMMA_D
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : DS_WGMMA_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef DS_WGMMA_D
#undef DS_WGMMA_OUT

// O += (P hi + P lo) V over the tile's 64 keys, V MN-major at v_tile.
__device__ __forceinline__ void wgmma_pv(float (&acc)[kNT][4],
                                         const uint32_t (&p_hi)[kKS][4],
                                         const uint32_t (&p_lo)[kKS][4],
                                         const bf16* v_tile) {
  const uint64_t vd = sw128_desc(smem_u32(v_tile));
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
    wgmma_rs(acc, p_hi[kk], vd + 128 * kk);
    wgmma_rs(acc, p_lo[kk], vd + 128 * kk);
  }
  wgmma_commit();
}

// Named barriers 1 and 2 (0 is __syncthreads): a consumer waits for its
// turn on its own barrier and hands the turn over on the other's, each
// barrier counting both consumers' 256 threads.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__global__ void __launch_bounds__(3 * kWgThreads, 1)
    fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const int* __restrict__ lut, int deg,
                     const int* __restrict__ sched,
                     const float* __restrict__ kpm,
                     const float* __restrict__ bias, bf16* __restrict__ o,
                     float* __restrict__ lse, int H, int T, float scale,
                     int causal, int kpm_mul, int bias_mul) {
  extern __shared__ unsigned char smem_wg[];
  const uint32_t raw = smem_u32(smem_wg);
  bf16* q_s = reinterpret_cast<bf16*>(smem_wg +
                                      (((raw + 1023u) & ~1023u) - raw));
  bf16* k_s = q_s + 2 * kSwTile;         // stages: K
  bf16* v_s = k_s + kWgStages * kSwTile;  // stages: V
  float* kpm_s = reinterpret_cast<float*>(v_s + kWgStages * kSwTile);
  uint64_t* full = reinterpret_cast<uint64_t*>(kpm_s + kWgStages * 64);
  uint64_t* empty = full + kWgStages;
  uint64_t* q_bar = empty + kWgStages;

  const int* item = sched + (size_t)blockIdx.x * kFwdItemCols;
  const int h = item[0], qa = item[1], qb = item[2], count = item[3];
  const int b = blockIdx.y;
  const int n_cons = qb >= 0 ? 2 : 1;
  const int bh = b * H + h;
  const int* lrow = lut + ((size_t)h * (T / 64) + qa) * deg;
  const Masks mk = make_masks(kpm, bias, b, bh, T, causal, kpm_mul, bias_mul);
  const int wg = threadIdx.x / kWgThreads;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * n_cons);  // every consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0 && count > 0) {
      mbar_arrive_tx(q_bar, n_cons * kSwTileBytes);
      tma_tile(q_s, &q_map, qa * 64, bh, q_bar);
      if (qb >= 0) tma_tile(q_s + kSwTile, &q_map, qb * 64, bh, q_bar);
      const uint32_t kpm_bytes = mk.kpm != nullptr ? 64 * sizeof(float) : 0;
      for (int j = 0; j < count; ++j) {
        const int st = j % kWgStages;
        // Tile j - kWgStages, the stage's last, is released.
        if (j >= kWgStages) mbar_wait(empty + st, (j / kWgStages - 1) & 1);
        const int k0 = __ldg(lrow + j) * 64;
        mbar_arrive_tx(full + st, 2 * kSwTileBytes + kpm_bytes);
        tma_tile(k_s + st * kSwTile, &k_map, k0, bh, full + st);
        tma_tile(v_s + st * kSwTile, &v_map, k0, bh, full + st);
        if (kpm_bytes)
          bulk_copy(kpm_s + st * 64, mk.kpm + k0, kpm_bytes, full + st);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;  // the consumer: query block a or b
  if (c >= n_cons) return;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (c == 0 ? qa : qb) * 64, r0 = 16 * warp;
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const uint64_t q_desc = sw128_desc(smem_u32(q_s + c * kSwTile));

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kNT][4], s[kNT][4];
  uint32_t p_hi[kKS][4], p_lo[kKS][4];  // P of the tile before
  zero(acc);
  // S of tile j (key block k0), waited for: the masks and the softmax
  // step; alpha and the partial row sums rs for O and l, which the caller
  // rescales.
  auto scores = [&](int j, int k0, float (&alpha)[2], float (&rs)[2]) {
    const float* ms = kpm_s + (j % kWgStages) * 64;
    const bool cut = causal && k0 + 63 > q0 + r0;
    if (mk.bias == nullptr && !mk.kpm_mul && !cut) {
      // The sparse BERT path's case, one FMA a score: s * scale + kpm.
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const float2 kv =
            mk.kpm != nullptr
                ? *reinterpret_cast<const float2*>(ms + 8 * n + 2 * t)
                : make_float2(0.f, 0.f);
        s[n][0] = fmaf(s[n][0], scale, kv.x);
        s[n][1] = fmaf(s[n][1], scale, kv.y);
        s[n][2] = fmaf(s[n][2], scale, kv.x);
        s[n][3] = fmaf(s[n][3], scale, kv.y);
      }
    } else {
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kc = 8 * n + 2 * t + (e & 1);  // key within the block
          const float kpm_v = mk.kpm != nullptr ? ms[kc] : 0.f;
          float bv = 0.f;
          s[n][e] = pair_score(s[n][e], scale, kpm_v, mk, row[e >> 1],
                               k0 + kc, cut, bv);
        }
    }
    softmax_step(s, m, alpha, rs);
  };
  // S_j = Q K_j^T into s, issued after tile j's bytes landed.
  auto issue_s = [&](int j) {
    const int st = j % kWgStages;
    mbar_wait(full + st, (j / kWgStages) & 1);
    const uint64_t k_desc = sw128_desc(smem_u32(k_s + st * kSwTile));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk)
      wgmma_ss(s, q_desc + 2 * kk, k_desc + 2 * kk, kk);
    wgmma_commit();
  };
  // l and O rescaled by alpha and tile j's P split hi/lo (O is settled).
  auto fold = [&](const float (&alpha)[2], const float (&rs)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
    // Once the rows' maxima settle, alpha is 1 for the whole warp.
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    }
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk)
      frag_from_acc_t(s[2 * kk], s[2 * kk + 1], p_hi[kk], p_lo[kk]);
  };
  // Turns: consumer 0 issues first; each hands the turn over after its
  // issue, consumer 1 not after its last (consumer 0 waits for no more).
  const bool turns = n_cons == 2;
  auto take_turn = [&]() {
    if (turns) bar_sync(1 + c);
  };
  auto pass_turn = [&](int j) {
    if (turns && !(c == 1 && j == count - 1)) bar_arrive(2 - c);
  };

  if (count > 0) {
    if (turns && c == 1) bar_arrive(1);
    mbar_wait(q_bar, 0);
    float alpha[2], rs[2];
    int k0 = __ldg(lrow) * 64;  // each tile's key block, read before its S
    take_turn();
    issue_s(0);
    pass_turn(0);
    wgmma_wait<0>();
    fence_acc(s);
    scores(0, k0, alpha, rs);
    fold(alpha, rs);
    // Tile j's S and tile j - 1's P V are issued together. No wgmma is
    // issued under a branch, so no accumulator is copied while in flight.
    for (int j = 1; j < count; ++j) {
      k0 = __ldg(lrow + j) * 64;
      take_turn();
      issue_s(j);
      wgmma_pv(acc, p_hi, p_lo, v_s + ((j - 1) % kWgStages) * kSwTile);
      pass_turn(j);
      wgmma_wait<1>();  // S_j is done; P_{j-1} V_{j-1} may still run
      fence_acc(s);
      scores(j, k0, alpha, rs);
      wgmma_wait<0>();  // P_{j-1} V_{j-1} is done: O is settled
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty + (j - 1) % kWgStages);
      fold(alpha, rs);
    }
    wgmma_fence();
    wgmma_pv(acc, p_hi, p_lo, v_s + ((count - 1) % kWgStages) * kSwTile);
    wgmma_wait<0>();
    fence_acc(acc);
  }
  fwd_epilogue(o + (size_t)bh * T * kD, lse + (size_t)bh * T, acc, m, l,
               row[0], t);
}

// ----------------------------- K7b for bf16 on the tensor cores, for Hopper
// The split and fused backward on the dense kernels' operand path
// (attention_common.cuh):
//   - a CTA walks its LUT row to its count (build_luts pads each row at its
//     end), and the next listed block's tiles (Q and dO with lse and delta
//     for the dk/dv kernel; K and V with the key-padding mask slice for the
//     dq kernel) are copied by cp.async into a two-stage ring while this
//     block's products run;
//   - every operand comes out of the tiles' natural [row][d] layout by
//     ldmatrix (.trans for Q, dO and K as right operands over the block's
//     rows, and for dS^T as the left operand of the fused dQ), so nothing
//     is staged transposed;
//   - the dk/dv kernel's CTA owns its keys, so it reads their key-padding
//     mask entries into registers once;
//   - p = ex2((x - lse) * log2(e)), the difference taken in natural units
//     first (a row padded at -1e9 everywhere keeps the plain version's
//     probabilities); P and dS enter their products as hi + lo bf16, hi by
//     truncation;
//   - the fused backward writes dS^T as hi/lo bf16 pairs with 32-bit stores
//     and adds dq as float4 atomics after a lane-pair exchange;
//   - the dk/dv kernel's grid walks the layout's backward schedule (kernels.
//     py, `build_schedule`): one (h, key block, count) item per CTA, the
//     largest counts first (reading the count with the item timed faster
//     than a CTA counting its row, as the dq kernel must; PERF.md). The Fixed layout's transposed LUT
//     holds rows of 4 and of 64 query blocks; issued in key-block order, the
//     long rows would start last and stretch the kernel's tail. Cutting the
//     long rows into chunks whose dk/dv partials a last chunk sums timed
//     slower than ordering alone (PERF.md): at 255 registers a thread two
//     CTAs fit an SM, and ordered rows already fill those slots evenly.
// Tiles are [BLK][kLdh] bf16, a warp per 16 of the block's rows (2 * BLK
// threads); the causal cut is tested only by a warp whose rows cross the
// diagonal.

constexpr int kSchedCols = 3;  // a schedule item: h, key block, count

// K7b's dk/dv kernel: one CTA per schedule item (h, key block kb, and the
// count of query blocks kb's transposed LUT row lists) and batch row; a
// warp per 16 of the block's keys, whose K and V rows stay in registers as
// left operands. Per listed query block: S^T = K Q^T and dP^T = V dO^T,
// P^T and dS^T in fp32, then dV += P^T dO and dK += dS^T Q into register
// accumulators. With kDq (the fused backward) dS^T goes to shared memory
// as hi and lo bf16 ([key][query]), and each warp adds 16 query rows of
// dS K into dq_acc.
template <int BLK, bool kDq>
constexpr size_t dkdv_async_smem() {
  return ((kDq ? 3 : 2) * BLK * kLdh + kStages * 2 * BLK * kLdh) *
             sizeof(bf16) +
         kStages * 2 * BLK * sizeof(float);
}

template <int BLK, bool kDq>
__global__ void __launch_bounds__(2 * BLK)
    dkdv_async_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const int* __restrict__ tlut, int deg,
                      const int* __restrict__ sched,
                      const float* __restrict__ kpm,
                      const float* __restrict__ bias,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                      int T, float scale, int causal, int kpm_mul,
                      int bias_mul) {
  constexpr int kNK = BLK / 8;  // n-tiles over the query block
  constexpr int kTileB = BLK * kLdh;
  extern __shared__ __align__(16) unsigned char smem_bwd[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_bwd);  // [BLK][kLdh] K
  bf16* dsh_s = k_s + kTileB;                      // V at the start, then
                                                   // dS^T hi
  bf16* dsl_s = dsh_s + kTileB;                    // kDq: dS^T lo
  bf16* st_s = kDq ? dsl_s + kTileB : dsl_s;       // stages: Q, dO
  float* vec_s = reinterpret_cast<float*>(st_s + kStages * 2 * kTileB);

  const int* item = sched + (size_t)blockIdx.x * kSchedCols;
  const int h = item[0], kb = item[1], count = item[2];
  const int b = blockIdx.y;
  const size_t bh = (size_t)b * H + h;
  const int* lrow = tlut + ((size_t)h * (T / BLK) + kb) * deg;
  const bf16* qb = q + bh * T * kD;
  const bf16* dob = dout + bh * T * kD;
  const float* lb = lse + bh * T;
  const float* db = delta + bh * T;
  const Masks mk = make_masks(kpm, bias, b, bh, T, causal, kpm_mul, bias_mul);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;
  const int k0 = kb * BLK;
  const int kw = k0 + r0;  // the warp's first key
  const int key[2] = {kw + g, kw + g + 8};
  float kpm_r[2] = {0.f, 0.f};
  if (mk.kpm != nullptr) {
    kpm_r[0] = mk.kpm[key[0]];
    kpm_r[1] = mk.kpm[key[1]];
  }

  auto issue = [&](int j) {
    const int st = j % kStages;
    const int q0 = __ldg(lrow + j) * BLK;
    bf16* qs = st_s + st * 2 * kTileB;
    async_rows<BLK>(qs, qb, q0);
    async_rows<BLK>(qs + kTileB, dob, q0);
    float* vs = vec_s + st * 2 * BLK;
    async_vec<BLK>(vs, lb, q0, 0);
    async_vec<BLK>(vs + BLK, db, q0, BLK);
  };
  if (count > 0) {
    async_rows<BLK>(k_s, k + bh * T * kD, k0);
    async_rows<BLK>(dsh_s, v + bh * T * kD, k0);
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < count) issue(i);
    cp_async_commit();
  }

  uint32_t kf[kKS][4], vf[kKS][4];
  float dk_acc[kNT][4], dv_acc[kNT][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int j = 0; j < count; ++j) {
    cp_async_wait<kStages - 2>();  // block j (and K, V) have landed
    // ... for every thread, and every warp is done with block j - 1: its
    // stage (refilled next) and dS^T (rewritten below).
    __syncthreads();
    if (j + kStages - 1 < count) issue(j + kStages - 1);
    cp_async_commit();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        lhs_frag<kLdh>(kf[kk], k_s, r0, kk, lane);
        lhs_frag<kLdh>(vf[kk], dsh_s, r0, kk, lane);
      }
      if (kDq) __syncthreads();  // V is read: dsh_s holds dS^T from here on
    }
    const int q0 = __ldg(lrow + j) * BLK;
    const int st = j % kStages;
    const bf16* qs = st_s + st * 2 * kTileB;
    const bf16* dos = qs + kTileB;
    const float* lse_s = vec_s + st * 2 * BLK;
    const float* delta_s = lse_s + BLK;
    float pt[kNK][4], dst[kNK][4];  // [key][query] tiles
    zero(pt);
    zero(dst);
    // Causal: a warp whose keys all follow the block's last query sees none
    // of it; only a warp whose keys cross the diagonal tests its pairs.
    if (!causal || kw <= q0 + BLK - 1) {
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        mma_nt<kLdh>(pt, kf[kk], qs, kk, lane);
        mma_nt<kLdh>(dst, vf[kk], dos, kk, lane);
      }
      const bool cut = causal && kw + 15 > q0;
#pragma unroll
      for (int n = 0; n < kNK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1);  // query within the block
          const int r = e >> 1;
          float bv = 0.f;
          const float x = pair_score(pt[n][e], scale, kpm_r[r], mk, q0 + c,
                                     key[r], cut, bv);
          const float p = ex2((x - lse_s[c]) * kLog2e);
          pt[n][e] = p;
          dst[n][e] = pair_grad(p, dst[n][e], delta_s[c], scale, kpm_r[r], bv,
                                mk);
        }
#pragma unroll
      for (int jq = 0; jq < BLK / 16; ++jq) {
        uint32_t hi[4], lo[4];
        frag_from_acc_t(pt[2 * jq], pt[2 * jq + 1], hi, lo);
        mma_nn2<kLdh>(dv_acc, hi, lo, dos, jq, lane);
        frag_from_acc_t(dst[2 * jq], dst[2 * jq + 1], hi, lo);
        mma_nn2<kLdh>(dk_acc, hi, lo, qs, jq, lane);
      }
    }
    if (kDq) {
      // dS^T as bf16 pairs: lane (g, t) holds keys g and g + 8, queries 2t
      // and 2t + 1 of each n-tile (zeros for a warp that sees no pair).
#pragma unroll
      for (int n = 0; n < kNK; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t hi, lo;
          split2t(dst[n][2 * r], dst[n][2 * r + 1], hi, lo);
          const int off = (r0 + g + 8 * r) * kLdh + 8 * n + 2 * t;
          *reinterpret_cast<uint32_t*>(dsh_s + off) = hi;
          *reinterpret_cast<uint32_t*>(dsl_s + off) = lo;
        }
      __syncthreads();  // every warp's dS^T rows are written
      // dq rows [q0 + r0, q0 + r0 + 16): dS K over the block's keys, dS read
      // transposed out of dS^T.
      float dq[kNT][4];
      zero(dq);
#pragma unroll
      for (int kk = 0; kk < BLK / 16; ++kk) {
        uint32_t ahi[4], alo[4];
        lhs_frag_t<kLdh>(ahi, dsh_s, r0, kk, lane);
        lhs_frag_t<kLdh>(alo, dsl_s, r0, kk, lane);
        mma_nn2<kLdh>(dq, ahi, alo, k_s, kk, lane);
      }
      atomic_add_rows(dq_acc + bh * T * kD, dq, q0 + r0 + g, kD, 1.f, true,
                      true, t);
    }
  }

  store_rows(dk + bh * T * kD, dk_acc, key[0], 1.f, 1.f, t);
  store_rows(dv + bh * T * kD, dv_acc, key[0], 1.f, 1.f, t);
}

// The split backward's dq kernel: one CTA per (query block, h, b), a warp
// per 16 of its rows, whose Q and dO rows stay in registers as left
// operands. It walks the forward LUT row to its count; per listed key block
// (K, V and the key-padding mask slice in the cp.async ring): S = Q K^T and
// dP = dO V^T, dS in fp32, then dQ += dS K with K's fragments by
// ldmatrix.trans from the same K tile; no atomics.
template <int BLK>
constexpr size_t dq_async_smem() {
  return (2 + kStages * 2) * BLK * kLdh * sizeof(bf16) +
         kStages * BLK * sizeof(float);
}

template <int BLK>
__global__ void __launch_bounds__(2 * BLK)
    dq_async_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ lut,
                    int deg, const float* __restrict__ kpm,
                    const float* __restrict__ bias,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int H, int T, float scale, int causal, int kpm_mul,
                    int bias_mul) {
  constexpr int kNK = BLK / 8;  // n-tiles over the key block
  constexpr int kTileB = BLK * kLdh;
  extern __shared__ __align__(16) unsigned char smem_dq[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_dq);  // [BLK][kLdh] Q
  bf16* do_s = q_s + kTileB;                     // dO
  bf16* kv_s = do_s + kTileB;                    // stages: K, V
  float* m_s = reinterpret_cast<float*>(kv_s + kStages * 2 * kTileB);

  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const int* lrow = lut + ((size_t)h * gridDim.x + blockIdx.x) * deg;
  const bf16* kb = k + bh * T * kD;
  const bf16* vb = v + bh * T * kD;
  const Masks mk = make_masks(kpm, bias, b, bh, T, causal, kpm_mul, bias_mul);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;
  const int q0 = blockIdx.x * BLK;
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const int count = row_count(lrow, deg);

  auto issue = [&](int j) {
    const int st = j % kStages;
    const int k0 = __ldg(lrow + j) * BLK;
    bf16* ks = kv_s + st * 2 * kTileB;
    async_rows<BLK>(ks, kb, k0);
    async_rows<BLK>(ks + kTileB, vb, k0);
    if (mk.kpm != nullptr) async_vec<BLK>(m_s + st * BLK, mk.kpm, k0, 0);
  };
  async_rows<BLK>(q_s, q + bh * T * kD, q0);
  async_rows<BLK>(do_s, dout + bh * T * kD, q0);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < count) issue(i);
    cp_async_commit();
  }
  const float lse_r[2] = {lse[bh * T + row[0]], lse[bh * T + row[1]]};
  const float delta_r[2] = {delta[bh * T + row[0]], delta[bh * T + row[1]]};

  uint32_t qf[kKS][4], dof[kKS][4];
  float acc[kNT][4];
  zero(acc);
  for (int j = 0; j < count; ++j) {
    cp_async_wait<kStages - 2>();  // block j (and Q, dO) have landed
    // ... for every thread, and every warp is done with block j - 1, whose
    // stage the next copy refills.
    __syncthreads();
    if (j + kStages - 1 < count) issue(j + kStages - 1);
    cp_async_commit();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        lhs_frag<kLdh>(qf[kk], q_s, r0, kk, lane);
        lhs_frag<kLdh>(dof[kk], do_s, r0, kk, lane);
      }
    }
    const int k0 = __ldg(lrow + j) * BLK;
    const int st = j % kStages;
    const bf16* ks = kv_s + st * 2 * kTileB;
    const float* ms = m_s + st * BLK;
    // Causal: a warp whose rows all precede the block sees none of it.
    if (causal && k0 > q0 + r0 + 15) continue;
    float s[kNK][4], dp[kNK][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      mma_nt<kLdh>(s, qf[kk], ks, kk, lane);
      mma_nt<kLdh>(dp, dof[kk], ks + kTileB, kk, lane);
    }
    const bool cut = causal && k0 + BLK - 1 > q0 + r0;
#pragma unroll
    for (int n = 0; n < kNK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);  // key within the block
        const int r = e >> 1;
        const float kpm_v = mk.kpm != nullptr ? ms[c] : 0.f;
        float bv = 0.f;
        const float x = pair_score(s[n][e], scale, kpm_v, mk, row[r], k0 + c,
                                   cut, bv);
        const float p = ex2((x - lse_r[r]) * kLog2e);
        s[n][e] = pair_grad(p, dp[n][e], delta_r[r], scale, kpm_v, bv, mk);
      }
#pragma unroll
    for (int jk = 0; jk < BLK / 16; ++jk) {
      uint32_t hi[4], lo[4];
      frag_from_acc_t(s[2 * jk], s[2 * jk + 1], hi, lo);
      mma_nn2<kLdh>(acc, hi, lo, ks, jk, lane);
    }
  }
  cp_async_wait<0>();  // a row with no listed block leaves Q, dO in flight
  store_rows(dq + bh * T * kD, acc, row[0], 1.f, 1.f, t);
}

// --------------------------------------------- fp32 and fp16 on the FMAs
// A 16 x 8 grid of threads: thread (ty, tx) owns rows ty * R + i (R =
// BLK / 16) and columns tx + 8 m of a block x block score tile, and columns
// tx + 8 c of a [block, 64] accumulator. Shared-memory rows are padded to
// 65 floats (no bank conflicts).

constexpr int kThreadsF = 128;
constexpr int kLd = kD + 1;

// Rows [row0, row0 + ROWS) of a contiguous [*, 64] matrix into shared
// memory as fp32 times mul.
template <int ROWS, typename T>
__device__ __forceinline__ void load_f(float* dst, const T* src, int row0,
                                       float mul) {
  for (int e = threadIdx.x; e < ROWS * kD; e += kThreadsF) {
    const int r = e / kD, c = e % kD;
    dst[r * kLd + c] = to_float(src[(size_t)(row0 + r) * kD + c]) * mul;
  }
}

template <int ROWS>
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0) {
  if (threadIdx.x < ROWS) dst[threadIdx.x] = src[row0 + threadIdx.x];
}

// out[i][m] = sum_d A[ty R + i][d] * B[tx + 8m][d]
template <int R, int C>
__device__ __forceinline__ void dot_tile(float (&out)[R][C], const float* A,
                                         const float* B, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int m = 0; m < C; ++m) out[i][m] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kD; ++d) {
    float a[R], bv[C];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = A[(ty * R + i) * kLd + d];
#pragma unroll
    for (int m = 0; m < C; ++m) bv[m] = B[(tx + 8 * m) * kLd + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int m = 0; m < C; ++m) out[i][m] = fmaf(a[i], bv[m], out[i][m]);
  }
}

// acc[i][c] += sum_k P[ty R + i][k] * B[k][tx + 8c] over k < DEPTH; with
// kTransP the first operand is read transposed, P[k][ty R + i].
template <int R, int DEPTH, bool kTransP>
__device__ __forceinline__ void acc_tile(float (&acc)[R][8], const float* P,
                                         const float* B, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < DEPTH; ++k) {
    float a[R], bv[8];
#pragma unroll
    for (int i = 0; i < R; ++i)
      a[i] = kTransP ? P[k * kLd + ty * R + i] : P[(ty * R + i) * kLd + k];
#pragma unroll
    for (int c = 0; c < 8; ++c) bv[c] = B[k * kLd + tx + 8 * c];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a[i], bv[c], acc[i][c]);
  }
}

template <int R>
__device__ __forceinline__ void zero_rows(float (&acc)[R][8]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
}

template <typename T, int R>
__device__ __forceinline__ void store_f(T* base, const float (&acc)[R][8],
                                        int row0, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      base[(size_t)(row0 + ty * R + i) * kD + tx + 8 * c] =
          from_float<T>(acc[i][c]);
}

// K7a on the FMAs; q is scaled as it is staged.
template <typename T, int BLK>
__global__ void __launch_bounds__(kThreadsF)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ lut, int deg,
               const float* __restrict__ kpm, const float* __restrict__ bias,
               T* __restrict__ o, float* __restrict__ lse, int H, int Tn,
               float scale, int causal, int kpm_mul, int bias_mul) {
  constexpr int R = BLK / 16, C = BLK / 8;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BLK * kLd;
  float* v_s = k_s + BLK * kLd;
  float* p_s = v_s + BLK * kLd;
  int* lut_s = reinterpret_cast<int*>(p_s + BLK * kLd);

  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const T* kb = k + bh * Tn * kD;
  const T* vb = v + bh * Tn * kD;
  const Masks mk =
      make_masks(kpm, bias, b, bh, Tn, causal, kpm_mul, bias_mul);
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const int q0 = blockIdx.x * BLK;

  stage_lut(lut_s, lut + ((size_t)h * gridDim.x + blockIdx.x) * deg, deg);
  load_f<BLK>(q_s, q + bh * Tn * kD, q0, scale);
  float m[R], l[R], acc[R][8];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  zero_rows(acc);

  for (int j = 0; j < deg; ++j) {
    __syncthreads();  // lut_s staged; the previous tile's k_s, v_s, p_s read
    const int c = lut_s[j];
    if (c < 0) continue;
    const int k0 = c * BLK;
    load_f<BLK>(k_s, kb, k0, 1.f);
    load_f<BLK>(v_s, vb, k0, 1.f);
    __syncthreads();
    float s[R][C];
    dot_tile(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty * R + i;
      float tmax = kNegInf;
#pragma unroll
      for (int mm = 0; mm < C; ++mm) {
        s[i][mm] = masked(s[i][mm], mk, row, k0 + tx + 8 * mm);
        tmax = fmaxf(tmax, s[i][mm]);
      }
      const float m_new = fmaxf(m[i], row_max(tmax));
      const float m_safe = fmaxf(m_new, kHalfNegInf);
      const float alpha = expf(m[i] - m_safe);
      float psum = 0.f;
#pragma unroll
      for (int mm = 0; mm < C; ++mm) {
        const float p = expf(s[i][mm] - m_safe);
        psum += p;
        p_s[(ty * R + i) * kLd + tx + 8 * mm] = p;
      }
      l[i] = l[i] * alpha + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) acc[i][cc] *= alpha;
    }
    __syncthreads();
    acc_tile<R, BLK, false>(acc, p_s, v_s, ty, tx);
  }

  T* ob = o + bh * Tn * kD;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
    const float lv = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lv;
#pragma unroll
    for (int cc = 0; cc < 8; ++cc)
      ob[(size_t)row * kD + tx + 8 * cc] = from_float<T>(acc[i][cc] * inv);
    if (tx == 0) lse[bh * Tn + row] = fmaxf(m[i], kHalfNegInf) + logf(lv);
  }
}

// K7b on the FMAs: one CTA per key block over the transposed LUT; with kDq
// it adds dq into dq_acc by atomics.
template <typename T, int BLK, bool kDq>
__global__ void __launch_bounds__(kThreadsF)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int* __restrict__ tlut,
                int deg, const float* __restrict__ kpm,
                const float* __restrict__ bias, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq_acc,
                T* __restrict__ dk, T* __restrict__ dv, int H, int Tn,
                float scale, int causal, int kpm_mul, int bias_mul) {
  constexpr int R = BLK / 16, C = BLK / 8;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + BLK * kLd;
  float* q_s = v_s + BLK * kLd;
  float* do_s = q_s + BLK * kLd;
  float* pt_s = do_s + BLK * kLd;   // p^T: [key][query]
  float* dst_s = pt_s + BLK * kLd;  // ds^T: [key][query]
  float* lse_s = dst_s + BLK * kLd;
  float* delta_s = lse_s + BLK;
  int* lut_s = reinterpret_cast<int*>(delta_s + BLK);

  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const T* qb = q + bh * Tn * kD;
  const T* dob = dout + bh * Tn * kD;
  const Masks mk =
      make_masks(kpm, bias, b, bh, Tn, causal, kpm_mul, bias_mul);
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const int k0 = blockIdx.x * BLK;

  stage_lut(lut_s, tlut + ((size_t)h * gridDim.x + blockIdx.x) * deg, deg);
  load_f<BLK>(k_s, k + bh * Tn * kD, k0, 1.f);
  load_f<BLK>(v_s, v + bh * Tn * kD, k0, 1.f);
  float dk_acc[R][8], dv_acc[R][8];
  zero_rows(dk_acc);
  zero_rows(dv_acc);

  for (int j = 0; j < deg; ++j) {
    __syncthreads();  // lut_s staged; the previous tile's buffers read
    const int r = lut_s[j];
    if (r < 0) continue;
    const int q0 = r * BLK;
    load_f<BLK>(q_s, qb, q0, 1.f);
    load_f<BLK>(do_s, dob, q0, 1.f);
    load_vec<BLK>(lse_s, lse + bh * Tn, q0);
    load_vec<BLK>(delta_s, delta + bh * Tn, q0);
    __syncthreads();
    float st[R][C], dpt[R][C];
    dot_tile(st, k_s, q_s, ty, tx);   // s^T[key][query]
    dot_tile(dpt, v_s, do_s, ty, tx);  // (do v^T)^T[key][query]
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int key = k0 + ty * R + i;
#pragma unroll
      for (int mm = 0; mm < C; ++mm) {
        const int qc = tx + 8 * mm;
        const float x = masked(st[i][mm] * scale, mk, q0 + qc, key);
        const float p = expf(x - lse_s[qc]);
        pt_s[(ty * R + i) * kLd + qc] = p;
        dst_s[(ty * R + i) * kLd + qc] =
            score_grad(p, dpt[i][mm], delta_s[qc], scale, mk, q0 + qc, key);
      }
    }
    __syncthreads();
    acc_tile<R, BLK, false>(dv_acc, pt_s, do_s, ty, tx);
    acc_tile<R, BLK, false>(dk_acc, dst_s, q_s, ty, tx);
    if (kDq) {
      float dq[R][8];
      zero_rows(dq);
      acc_tile<R, BLK, true>(dq, dst_s, k_s, ty, tx);  // dq[query][c]
      float* dqb = dq_acc + bh * Tn * kD;
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int cc = 0; cc < 8; ++cc)
          atomicAdd(&dqb[(size_t)(q0 + ty * R + i) * kD + tx + 8 * cc],
                    dq[i][cc]);
    }
  }
  store_f(dk + bh * Tn * kD, dk_acc, k0, ty, tx);
  store_f(dv + bh * Tn * kD, dv_acc, k0, ty, tx);
}

// The split backward's dq on the FMAs: one CTA per query block over the
// forward LUT, no atomics.
template <typename T, int BLK>
__global__ void __launch_bounds__(kThreadsF)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lut, int deg,
              const float* __restrict__ kpm, const float* __restrict__ bias,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, int H,
              int Tn, float scale, int causal, int kpm_mul, int bias_mul) {
  constexpr int R = BLK / 16, C = BLK / 8;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BLK * kLd;
  float* k_s = do_s + BLK * kLd;
  float* v_s = k_s + BLK * kLd;
  float* ds_s = v_s + BLK * kLd;  // ds: [query][key]
  float* lse_s = ds_s + BLK * kLd;
  float* delta_s = lse_s + BLK;
  int* lut_s = reinterpret_cast<int*>(delta_s + BLK);

  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const T* kb = k + bh * Tn * kD;
  const T* vb = v + bh * Tn * kD;
  const Masks mk =
      make_masks(kpm, bias, b, bh, Tn, causal, kpm_mul, bias_mul);
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const int q0 = blockIdx.x * BLK;

  stage_lut(lut_s, lut + ((size_t)h * gridDim.x + blockIdx.x) * deg, deg);
  load_f<BLK>(q_s, q + bh * Tn * kD, q0, 1.f);
  load_f<BLK>(do_s, dout + bh * Tn * kD, q0, 1.f);
  load_vec<BLK>(lse_s, lse + bh * Tn, q0);
  load_vec<BLK>(delta_s, delta + bh * Tn, q0);
  float acc[R][8];
  zero_rows(acc);

  for (int j = 0; j < deg; ++j) {
    __syncthreads();  // lut_s staged; the previous tile's buffers read
    const int c = lut_s[j];
    if (c < 0) continue;
    const int k0 = c * BLK;
    load_f<BLK>(k_s, kb, k0, 1.f);
    load_f<BLK>(v_s, vb, k0, 1.f);
    __syncthreads();
    float s[R][C], dp[R][C];
    dot_tile(s, q_s, k_s, ty, tx);
    dot_tile(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int rr = ty * R + i;
#pragma unroll
      for (int mm = 0; mm < C; ++mm) {
        const int key = k0 + tx + 8 * mm;
        const float x = masked(s[i][mm] * scale, mk, q0 + rr, key);
        const float p = expf(x - lse_s[rr]);
        ds_s[rr * kLd + tx + 8 * mm] =
            score_grad(p, dp[i][mm], delta_s[rr], scale, mk, q0 + rr, key);
      }
    }
    __syncthreads();
    acc_tile<R, BLK, false>(acc, ds_s, k_s, ty, tx);
  }
  store_f(dq + bh * Tn * kD, acc, q0, ty, tx);
}

// ----------------------------------------------------------------- launch

// The FMA kernels: `tiles` [BLK, 65] fp32 tiles and `vecs` [BLK] rows.
template <int BLK>
constexpr size_t fma_smem(int tiles, int vecs) {
  return (tiles * BLK * kLd + vecs * BLK) * sizeof(float);
}

// Set the kernel's dynamic shared-memory limit and launch it; returns the
// CUDA error (0 on success).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int threads, size_t smem, dim3 grid,
           cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

struct Args {
  const void *q, *k, *v, *dout;
  const int *lut, *sched;
  int deg, n_items;
  const float *kpm, *bias, *lse, *delta;
  void *o, *dq, *dk, *dv;
  float *lse_out, *dq_acc;
  int B, H, T;
  float scale;
  int causal, kpm_mul, bias_mul;
  cudaStream_t st;
};

// cuTensorMapEncodeTiled, from the driver through the runtime (so the
// library links against nothing beyond the runtime); null when the driver
// has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A contiguous [BH, T, 64] bf16 tensor as a TMA map of 64 x 64 tiles,
// 128-byte swizzled (the layout fwd_wgmma_kernel's descriptors read).
bool tile_map(CUtensorMap* map, const void* base, int BH, int T) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)kD, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {kD * sizeof(bf16),
                                 (cuuint64_t)T * kD * sizeof(bf16)};
  const cuuint32_t box[3] = {(cuuint32_t)kD, 64, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int BLK>
int run_fwd(const Args& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const dim3 grid(a.T / BLK, a.H, a.B);
  if constexpr (std::is_same<T, bf16>::value && BLK == 64) {
    CUtensorMap q_map, k_map, v_map;
    if (a.sched == nullptr || a.n_items < 1 ||
        (size_t)a.B * a.H > 0x7fffffff ||
        !tile_map(&q_map, q, a.B * a.H, a.T) ||
        !tile_map(&k_map, k, a.B * a.H, a.T) ||
        !tile_map(&v_map, v, a.B * a.H, a.T))
      return (int)cudaErrorInvalidValue;
    return launch(fwd_wgmma_kernel, 3 * kWgThreads, fwd_wgmma_smem(),
                  dim3(a.n_items, a.B), a.st, q_map, k_map, v_map, a.lut,
                  a.deg, a.sched, a.kpm, a.bias, static_cast<T*>(a.o),
                  a.lse_out, a.H, a.T, a.scale, a.causal, a.kpm_mul,
                  a.bias_mul);
  } else if constexpr (std::is_same<T, bf16>::value) {
    return launch(fwd_async_kernel<BLK>, 2 * BLK, fwd_async_smem<BLK>(), grid,
                  a.st, q, k, v, a.lut, a.deg, a.kpm, a.bias,
                  static_cast<T*>(a.o), a.lse_out, a.H, a.T, a.scale,
                  a.causal, a.kpm_mul, a.bias_mul);
  } else {
    return launch(fwd_kernel<T, BLK>, kThreadsF,
                  fma_smem<BLK>(4, 0) + a.deg * sizeof(int), grid, a.st, q, k,
                  v, a.lut, a.deg, a.kpm, a.bias, static_cast<T*>(a.o),
                  a.lse_out, a.H, a.T, a.scale, a.causal, a.kpm_mul,
                  a.bias_mul);
  }
}

template <typename T, int BLK>
int run_dkdv(const Args& a, int fused) {
  if constexpr (std::is_same<T, bf16>::value) {
    const dim3 grid(a.n_items, a.B);
    auto go = [&](auto kernel, size_t smem) {
      return launch(kernel, 2 * BLK, smem, grid, a.st,
                    static_cast<const bf16*>(a.q),
                    static_cast<const bf16*>(a.k),
                    static_cast<const bf16*>(a.v), a.lut, a.deg, a.sched,
                    a.kpm, a.bias, static_cast<const bf16*>(a.dout), a.lse,
                    a.delta, a.dq_acc, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H,
                    a.T, a.scale, a.causal, a.kpm_mul, a.bias_mul);
    };
    return fused ? go(dkdv_async_kernel<BLK, true>,
                      dkdv_async_smem<BLK, true>())
                 : go(dkdv_async_kernel<BLK, false>,
                      dkdv_async_smem<BLK, false>());
  } else {
    const dim3 grid(a.T / BLK, a.H, a.B);
    const size_t smem = fma_smem<BLK>(6, 2) + a.deg * sizeof(int);
    auto go = [&](auto kernel) {
      return launch(kernel, kThreadsF, smem, grid, a.st,
                    static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                    static_cast<const T*>(a.v), a.lut, a.deg, a.kpm, a.bias,
                    static_cast<const T*>(a.dout), a.lse, a.delta, a.dq_acc,
                    static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.T,
                    a.scale, a.causal, a.kpm_mul, a.bias_mul);
    };
    return fused ? go(dkdv_kernel<T, BLK, true>)
                 : go(dkdv_kernel<T, BLK, false>);
  }
}

template <typename T, int BLK>
int run_dq(const Args& a) {
  const dim3 grid(a.T / BLK, a.H, a.B);
  const size_t lut = a.deg * sizeof(int);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  if constexpr (std::is_same<T, bf16>::value) {
    return launch(dq_async_kernel<BLK>, 2 * BLK, dq_async_smem<BLK>(), grid,
                  a.st, q, k, v, a.lut, a.deg, a.kpm, a.bias, dout, a.lse,
                  a.delta, static_cast<T*>(a.dq), a.H, a.T, a.scale,
                  a.causal, a.kpm_mul, a.bias_mul);
  } else {
    return launch(dq_kernel<T, BLK>, kThreadsF, fma_smem<BLK>(5, 2) + lut,
                  grid, a.st, q, k, v, a.lut, a.deg, a.kpm, a.bias, dout,
                  a.lse, a.delta, static_cast<T*>(a.dq), a.H, a.T, a.scale,
                  a.causal, a.kpm_mul, a.bias_mul);
  }
}

// Dispatch on (dtype, block): 0 = float32, 1 = bfloat16, 2 = float16;
// blocks 16, 32, 64.
template <template <typename, int> class Op>
int dispatch(int dtype, int block, const Args& a, int extra) {
#define DS_SPARSE_BLOCKS(T)                          \
  switch (block) {                                   \
    case 16:                                         \
      return Op<T, 16>::run(a, extra);               \
    case 32:                                         \
      return Op<T, 32>::run(a, extra);               \
    case 64:                                         \
      return Op<T, 64>::run(a, extra);               \
    default:                                         \
      return (int)cudaErrorInvalidValue;             \
  }
  switch (dtype) {
    case 0:
      DS_SPARSE_BLOCKS(float)
    case 1:
      DS_SPARSE_BLOCKS(bf16)
    case 2:
      DS_SPARSE_BLOCKS(__half)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DS_SPARSE_BLOCKS
}

template <typename T, int BLK>
struct FwdOp {
  static int run(const Args& a, int) { return run_fwd<T, BLK>(a); }
};
template <typename T, int BLK>
struct DkdvOp {
  static int run(const Args& a, int fused) {
    return run_dkdv<T, BLK>(a, fused);
  }
};
template <typename T, int BLK>
struct DqOp {
  static int run(const Args& a, int) { return run_dq<T, BLK>(a); }
};

// The arguments every entry point takes.
Args common_args(const void* q, const void* k, const void* v, const int* lut,
                 int deg, const float* kpm, const float* bias, int B, int H,
                 int T, float scale, int causal, int kpm_mul, int bias_mul,
                 void* stream) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.lut = lut;
  a.deg = deg;
  a.kpm = kpm;
  a.bias = bias;
  a.B = B;
  a.H = H;
  a.T = T;
  a.scale = scale;
  a.causal = causal;
  a.kpm_mul = kpm_mul;
  a.bias_mul = bias_mul;
  a.st = reinterpret_cast<cudaStream_t>(stream);
  return a;
}

bool shape_ok(int B, int H, int T, int D, int block, int deg) {
  return D == kD && B >= 1 && H >= 1 && B <= 65535 && H <= 65535 &&
         (block == 16 || block == 32 || block == 64) && T >= block &&
         T % block == 0 && deg >= 1 && deg <= T / block;
}

}  // namespace

// Plain C entry points, bound with ctypes. Every tensor contiguous: q, k, v,
// o, dout, dq, dk, dv [B, H, T, 64] of `dtype`; lse, delta [B, H, T] fp32;
// lut [H, T / block, deg] int32 (-1 padded); kpm [B, T] and bias
// [B, H, T, T] fp32 or null; kpm_mul / bias_mul 1 for 'mul' mode. Each
// launches on `stream` and returns cudaGetLastError() (0 on success); what
// the kernels do not take returns cudaErrorInvalidValue.

// K7a: o and lse, over the forward LUT. bf16 at block 64 walks the forward
// schedule sched [n_items, 4] int32 (h, query block a, query block b or -1,
// count; kernels.py `build_fwd_schedule`); the other types and blocks take
// one CTA per query block and ignore it.
extern "C" int ds_sparse_fwd(const void* q, const void* k, const void* v,
                             const int* lut, int deg, const int* sched,
                             int n_items, const float* kpm,
                             const float* bias, void* o, float* lse, int B,
                             int H, int T, int D, int block, int dtype,
                             float scale, int causal, int kpm_mul,
                             int bias_mul, void* stream) {
  if (!shape_ok(B, H, T, D, block, deg)) return (int)cudaErrorInvalidValue;
  Args a = common_args(q, k, v, lut, deg, kpm, bias, B, H, T, scale, causal,
                       kpm_mul, bias_mul, stream);
  a.sched = sched;
  a.n_items = n_items;
  a.o = o;
  a.lse_out = lse;
  return dispatch<FwdOp>(dtype, block, a, 0);
}

// K7b fused (fused = 1): dk, dv over the transposed LUT, and dq added into
// dq_acc (fp32, zeroed by the caller). The split backward's first kernel
// (fused = 0): dk and dv only; dq_acc unused. bf16 walks the backward
// schedule sched [n_items, 3] int32 (h, key block, count; kernels.py
// `build_schedule`); fp32 and fp16 walk the LUT's rows in order
// and ignore it.
extern "C" int ds_sparse_bwd_dkdv(const void* q, const void* k,
                                  const void* v, const int* tlut, int deg,
                                  const int* sched, int n_items,
                                  const float* kpm, const float* bias,
                                  const void* dout, const float* lse,
                                  const float* delta, float* dq_acc,
                                  void* dk, void* dv, int B, int H, int T,
                                  int D, int block, int dtype, float scale,
                                  int causal, int kpm_mul, int bias_mul,
                                  int fused, void* stream) {
  if (!shape_ok(B, H, T, D, block, deg) || (fused && dq_acc == nullptr) ||
      (dtype == 1 && (sched == nullptr || n_items < 1)))
    return (int)cudaErrorInvalidValue;
  Args a = common_args(q, k, v, tlut, deg, kpm, bias, B, H, T, scale,
                       causal, kpm_mul, bias_mul, stream);
  a.sched = sched;
  a.n_items = n_items;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq_acc = dq_acc;
  a.dk = dk;
  a.dv = dv;
  return dispatch<DkdvOp>(dtype, block, a, fused);
}

// The split backward's second kernel: dq in the input type, over the
// forward LUT.
extern "C" int ds_sparse_bwd_dq(const void* q, const void* k, const void* v,
                                const int* lut, int deg, const float* kpm,
                                const float* bias, const void* dout,
                                const float* lse, const float* delta,
                                void* dq, int B, int H, int T, int D,
                                int block, int dtype, float scale,
                                int causal, int kpm_mul, int bias_mul,
                                void* stream) {
  if (!shape_ok(B, H, T, D, block, deg)) return (int)cudaErrorInvalidValue;
  Args a = common_args(q, k, v, lut, deg, kpm, bias, B, H, T, scale, causal,
                       kpm_mul, bias_mul, stream);
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  return dispatch<DqOp>(dtype, block, a, 0);
}
