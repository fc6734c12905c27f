// Flash attention for training, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of deepspeed_tpu/ops/transformer/kernels/
// attention.py:
//   K1  `_fwd_kernel` (launched by `_flash_fwd_pallas`)
//       -> fwd_async_kernel (bf16), fwd_kernel (fp32, fp16)
//   K2a `_bwd_fused_kernel` (by `_flash_bwd_fused_pallas`)
//       -> dkdv_async_kernel / dkdv_kernel with kDq = true (dq by atomics
//          into an fp32 buffer)
//   K2b `_bwd_dkv_kernel` and `_bwd_dq_kernel` (by `_flash_bwd_pallas`)
//       -> dkdv_*kernel with kDq = false, then dq_async_kernel / dq_kernel
// The plain PyTorch versions they are held against are `mha_reference`
// (with return_lse) and `flash_bwd_reference` in
// deepspeed_tpu_torch/ops/transformer/kernels/attention.py.
//
// What they compute, per (b, h), q/k/v [T, 64]:
//   s = scale * q k^T + mask[b] (additive, [T_kv], optional); causal keeps
//   key j for query i iff j <= i (else -1e30, the JAX package's NEG_INF);
//   forward:  o = softmax(s) v, lse = rowmax + log(rowsum) (fp32);
//   backward: p = exp(min(s - lse, 0)), dv = p^T do,
//             ds = p * (do v^T - delta), delta = rowsum(do * o) (given),
//             dq = scale * ds k, dk = scale * ds^T q.
// Scores, softmax statistics, p, ds and every accumulator are fp32; only the
// loads and the stores use the input type (fp32, bf16 or fp16). Keeping ds
// in fp32 matters under fp16 loss scaling, where do carries the scale.
//
// Bound on an H100 SXM. At T = 1024, D = 64 each (b, h) reads its q, k, v
// once (and do for the backward) but does 4 * D flops per visible (query,
// key) pair in the forward and 10 * D in the backward: about 250 and 360
// flops per byte (bf16, causal), near the line where the tensor cores
// (989 TFLOP/s) rather than memory (3.35 TB/s) set the least time.
//
// What the design does about it:
//   - the [T, T] score matrix never reaches device memory: one 64 x 64 tile
//     of scores at a time lives on chip;
//   - the causal mask is a loop bound (tiles past the diagonal are never
//     loaded or computed), the TPU kernel's kv_index clamp and @pl.when skip;
//   - bf16, the training path's type, runs its products on the tensor cores
//     (mma.sync, fp32 accumulation; see the bf16 sections below: operands
//     by cp.async and ldmatrix, 64-row blocks). fp32 and fp16
//     run them as register-blocked fp32 FMAs on the CUDA cores (67 TFLOP/s):
//     a thread of a 16 x 8 grid owns 4 rows x 8 strided columns, 2.7 FMAs
//     per shared-memory load, rows padded to 65 floats (no bank conflicts).
//     fp16 stays there because a loss-scaled dS, split into fp16 terms for
//     the tensor cores, could overflow;
//   - the backward keeps K_j and V_j, and the dk/dv accumulators, on chip
//     for a whole sweep over the query tiles. The TPU kernel's full-length
//     dk/dv accumulators (512 KiB at T = 1024) do not fit a block's 227 KB,
//     so K2a turns the sweep around (one block per key tile) and adds dq
//     into an fp32 buffer with atomics; K2b computes dq in a second kernel
//     that sweeps the key tiles instead, with no atomics.
// The ragged last tile (T not a multiple of 64) is guarded here, so no
// shape falls back to a dense path on the card.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"

namespace {

constexpr int kD = 64;          // head width
constexpr int kTile = 64;       // query rows / keys per tile
constexpr int kLd = kD + 1;     // padded shared-memory row stride (floats)
constexpr int kThreads = 128;   // a 16 x 8 grid of threads
constexpr int kRows = 4;        // rows per thread: ty * 4 + i
constexpr int kCols = 8;        // columns per thread: tx + 8 * m
constexpr int kTileFloats = kTile * kLd;
constexpr float kNegInf = -1e30f;

// Rows [row0, row0 + 64) of a contiguous [n, 64] matrix into shared memory
// as fp32 times `mul`; rows at or past n read as zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int n, float mul) {
  for (int e = threadIdx.x; e < kTile * kD; e += kThreads) {
    const int r = e / kD, c = e % kD;
    const int row = row0 + r;
    dst[r * kLd + c] =
        row < n ? to_float(src[(size_t)row * kD + c]) * mul : 0.f;
  }
}

// Entries [row0, row0 + 64) of a [n] fp32 vector into shared memory.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int n) {
  if (threadIdx.x < kTile) {
    const int row = row0 + threadIdx.x;
    dst[threadIdx.x] = row < n ? src[row] : 0.f;
  }
}

// out[i][m] = sum_d A[ty*4 + i][d] * B[tx + 8m][d]
__device__ __forceinline__ void dot_tile(float (&out)[kRows][kCols],
                                         const float* A, const float* B,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int m = 0; m < kCols; ++m) out[i][m] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kD; ++d) {
    float a[kRows], b[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) a[i] = A[(ty * kRows + i) * kLd + d];
#pragma unroll
    for (int m = 0; m < kCols; ++m) b[m] = B[(tx + 8 * m) * kLd + d];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int m = 0; m < kCols; ++m) out[i][m] = fmaf(a[i], b[m], out[i][m]);
  }
}

// acc[i][c] += sum_k P[ty*4 + i][k] * B[k][tx + 8c]; with kTransP the
// first operand is read transposed, P[k][ty*4 + i].
template <bool kTransP>
__device__ __forceinline__ void acc_tile(float (&acc)[kRows][kCols],
                                         const float* P, const float* B,
                                         int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float a[kRows], b[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      a[i] = kTransP ? P[k * kLd + ty * kRows + i]
                     : P[(ty * kRows + i) * kLd + k];
#pragma unroll
    for (int c = 0; c < kCols; ++c) b[c] = B[k * kLd + tx + 8 * c];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
  }
}

// Masked score: the additive mask, then the causal cut (kNegInf, finite, as
// the reference's `where`).
__device__ __forceinline__ float masked(float s, const float* mask, int key,
                                        int row, int causal) {
  if (mask != nullptr) s += mask[key];
  if (causal && key > row) s = kNegInf;
  return s;
}

// Key tiles a query tile starting at q0 sees.
__device__ __forceinline__ int key_tiles(int q0, int Tq, int Tk, int causal) {
  int n = (Tk + kTile - 1) / kTile;
  if (causal) {
    const int last_row = min(q0 + kTile - 1, Tq - 1);
    n = min(n, last_row / kTile + 1);
  }
  return n;
}

// ---------------------------------------------------------------- K1
// One block per (64-row query tile, h, b); online softmax over key tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ mask,
               T* __restrict__ o, float* __restrict__ lse, int H, int Tq,
               int Tk, float scale, int causal) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTileFloats;
  float* v_s = k_s + kTileFloats;
  float* p_s = v_s + kTileFloats;

  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const T* qb = q + bh * Tq * kD;
  const T* kb = k + bh * Tk * kD;
  const T* vb = v + bh * Tk * kD;
  const float* mb = mask != nullptr ? mask + (size_t)b * Tk : nullptr;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const int q0 = blockIdx.x * kTile;
  const int n_kt = key_tiles(q0, Tq, Tk, causal);

  load_tile(q_s, qb, q0, Tq, scale);
  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's k_s, v_s, p_s are read
    load_tile(k_s, kb, k0, Tk, 1.f);
    load_tile(v_s, vb, k0, Tk, 1.f);
    __syncthreads();
    float s[kRows][kCols];
    dot_tile(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty * kRows + i;
      float tmax = -INFINITY;
#pragma unroll
      for (int mm = 0; mm < kCols; ++mm) {
        const int key = k0 + tx + 8 * mm;
        // Keys past T_kv are not keys: -inf, an exact 0 below. Key 0 is in
        // range and finite for every row, so the running max is finite
        // from the first tile on.
        s[i][mm] = key < Tk ? masked(s[i][mm], mb, key, row, causal)
                            : -INFINITY;
        tmax = fmaxf(tmax, s[i][mm]);
      }
      const float m_new = fmaxf(m[i], row_max(tmax));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int mm = 0; mm < kCols; ++mm) {
        const float p = expf(s[i][mm] - m_new);
        psum += p;
        p_s[(ty * kRows + i) * kLd + tx + 8 * mm] = p;
      }
      l[i] = l[i] * alpha + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    acc_tile<false>(acc, p_s, v_s, ty, tx);
  }

  T* ob = o + bh * Tq * kD;
  float* lb = lse + bh * Tq;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row < Tq) {
      const float lv = fmaxf(l[i], 1e-30f);
      const float inv = 1.f / lv;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        ob[(size_t)row * kD + tx + 8 * c] = from_float<T>(acc[i][c] * inv);
      if (tx == 0) lb[row] = m[i] + logf(lv);
    }
  }
}

// ---------------------------------------------------------------- K2
// One block per (64-key tile, h, b): K_j, V_j and the dk/dv accumulators
// stay on chip over the sweep of the query tiles that see them. With kDq
// (K2a) the block also adds its share of dq into dq_acc (fp32, zeroed by
// the caller) with atomics; without (K2b) dq_kernel computes dq.
template <typename T, bool kDq>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ mask,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq_acc,
                T* __restrict__ dk, T* __restrict__ dv, int H, int Tq, int Tk,
                float scale, int causal) {
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTileFloats;
  float* q_s = v_s + kTileFloats;
  float* do_s = q_s + kTileFloats;
  float* pt_s = do_s + kTileFloats;  // p^T: [key][query]
  float* dst_s = pt_s + kTileFloats;  // ds^T: [key][query]
  float* lse_s = dst_s + kTileFloats;
  float* delta_s = lse_s + kTile;

  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const T* qb = q + bh * Tq * kD;
  const T* dob = dout + bh * Tq * kD;
  const float* mb = mask != nullptr ? mask + (size_t)b * Tk : nullptr;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const int k0 = blockIdx.x * kTile;
  const int n_qt = (Tq + kTile - 1) / kTile;
  // Causal: the first query that sees key k0 is row k0.
  const int first_qt = causal ? k0 / kTile : 0;

  load_tile(k_s, k + bh * Tk * kD, k0, Tk, 1.f);
  load_tile(v_s, v + bh * Tk * kD, k0, Tk, 1.f);
  float dk_acc[kRows][kCols], dv_acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int qt = first_qt; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile's q_s, do_s, pt_s, dst_s are read
    load_tile(q_s, qb, q0, Tq, scale);
    load_tile(do_s, dob, q0, Tq, 1.f);
    load_rows(lse_s, lse + bh * Tq, q0, Tq);
    load_rows(delta_s, delta + bh * Tq, q0, Tq);
    __syncthreads();
    float st[kRows][kCols], dpt[kRows][kCols];
    dot_tile(st, k_s, q_s, ty, tx);   // s^T[key][query]
    dot_tile(dpt, v_s, do_s, ty, tx);  // (do v^T)^T[key][query]
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int key = k0 + ty * kRows + i;
#pragma unroll
      for (int mm = 0; mm < kCols; ++mm) {
        const int r = tx + 8 * mm;
        const int row = q0 + r;
        float p = 0.f;
        if (key < Tk && row < Tq) {
          const float s = masked(st[i][mm], mb, key, row, causal);
          p = expf(fminf(s - lse_s[r], 0.f));
        }
        pt_s[(ty * kRows + i) * kLd + r] = p;
        dst_s[(ty * kRows + i) * kLd + r] = p * (dpt[i][mm] - delta_s[r]);
      }
    }
    __syncthreads();
    acc_tile<false>(dv_acc, pt_s, do_s, ty, tx);
    acc_tile<false>(dk_acc, dst_s, q_s, ty, tx);
    if (kDq) {
      float dq[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) dq[i][c] = 0.f;
      acc_tile<true>(dq, dst_s, k_s, ty, tx);  // dq[query][c]
      float* dqb = dq_acc + bh * Tq * kD;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = q0 + ty * kRows + i;
        if (row < Tq) {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            atomicAdd(&dqb[(size_t)row * kD + tx + 8 * c], dq[i][c] * scale);
        }
      }
    }
  }

  T* dkb = dk + bh * Tk * kD;
  T* dvb = dv + bh * Tk * kD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int key = k0 + ty * kRows + i;
    if (key < Tk) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        dkb[(size_t)key * kD + tx + 8 * c] = from_float<T>(dk_acc[i][c]);
        dvb[(size_t)key * kD + tx + 8 * c] = from_float<T>(dv_acc[i][c]);
      }
    }
  }
}

// K2b's second kernel: one block per (64-row query tile, h, b), sweeping the
// key tiles the tile sees; dq accumulates in registers, no atomics.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ mask,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, int H,
              int Tq, int Tk, float scale, int causal) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTileFloats;
  float* k_s = do_s + kTileFloats;
  float* v_s = k_s + kTileFloats;
  float* ds_s = v_s + kTileFloats;  // ds: [query][key]
  float* lse_s = ds_s + kTileFloats;
  float* delta_s = lse_s + kTile;

  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const T* kb = k + bh * Tk * kD;
  const T* vb = v + bh * Tk * kD;
  const float* mb = mask != nullptr ? mask + (size_t)b * Tk : nullptr;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const int q0 = blockIdx.x * kTile;
  const int n_kt = key_tiles(q0, Tq, Tk, causal);

  load_tile(q_s, q + bh * Tq * kD, q0, Tq, scale);
  load_tile(do_s, dout + bh * Tq * kD, q0, Tq, 1.f);
  load_rows(lse_s, lse + bh * Tq, q0, Tq);
  load_rows(delta_s, delta + bh * Tq, q0, Tq);
  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's k_s, v_s, ds_s are read
    load_tile(k_s, kb, k0, Tk, 1.f);
    load_tile(v_s, vb, k0, Tk, 1.f);
    __syncthreads();
    float s[kRows][kCols], dp[kRows][kCols];
    dot_tile(s, q_s, k_s, ty, tx);
    dot_tile(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int row = q0 + r;
#pragma unroll
      for (int mm = 0; mm < kCols; ++mm) {
        const int key = k0 + tx + 8 * mm;
        float p = 0.f;
        if (key < Tk && row < Tq) {
          const float sm = masked(s[i][mm], mb, key, row, causal);
          p = expf(fminf(sm - lse_s[r], 0.f));
        }
        ds_s[r * kLd + tx + 8 * mm] = p * (dp[i][mm] - delta_s[r]);
      }
    }
    __syncthreads();
    acc_tile<false>(acc, ds_s, k_s, ty, tx);
  }

  T* dqb = dq + bh * Tq * kD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row < Tq) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        dqb[(size_t)row * kD + tx + 8 * c] = from_float<T>(acc[i][c] * scale);
    }
  }
}

// ------------------------------------------------ bf16 on the tensor cores
// The kernels for bf16 inputs run their products on the tensor cores:
// mma.sync m16n8k16, bf16 operands, fp32 accumulation. A warp owns 16 rows
// (queries in K1 and K2b's dq kernel, keys in K2's dk/dv kernel), and every
// score, probability and accumulator stays in registers: the accumulator
// layout of one product (thread (g, t) = (lane / 4, lane % 4) holds rows g
// and g + 8, columns 2t and 2t + 1 of each 8-column tile) is the
// left-operand layout of the next, so P and dS go
// from the softmax arithmetic into the second product without touching
// shared memory. A left operand computed here (P, dS) enters the product
// as two bf16 terms, hi = bf16(x) and lo = bf16(x - hi): 16 significant
// bits, so those products keep fp32-level accuracy (2**-17 relative) at
// twice the tensor-core work. q, k, v and dO are bf16 already: their
// products are exact up to the fp32 accumulation. Shared-memory rows are
// padded to 72 bf16, so the 32 lanes' 4-byte operand loads (and ldmatrix's
// 16-byte rows) hit 32 banks.

constexpr int kLdh = kD + 8;  // bf16 row stride in shared memory
constexpr int kTileH = kTile * kLdh;
constexpr int kNT = kTile / 8;  // 8-column accumulator tiles per 64 columns
constexpr int kKS = kD / 16;    // 16-deep steps over 64

// Store rows g and g + 8 (global rows row_a, row_b, each written when below
// n) of 64 accumulator columns times mul, as bf16 pairs.
__device__ __forceinline__ void store_rows(bf16* base, const float (&acc)[kNT][4],
                                           int row_a, int n, float mul_a,
                                           float mul_b, int t) {
#pragma unroll
  for (int nd = 0; nd < kNT; ++nd) {
    const int c = 8 * nd + 2 * t;
    if (row_a < n)
      *reinterpret_cast<__nv_bfloat162*>(base + (size_t)row_a * kD + c) =
          __floats2bfloat162_rn(acc[nd][0] * mul_a, acc[nd][1] * mul_a);
    if (row_a + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(base + (size_t)(row_a + 8) * kD +
                                         c) =
          __floats2bfloat162_rn(acc[nd][2] * mul_b, acc[nd][3] * mul_b);
  }
}

// ------------------------------------ bf16 on the tensor cores, for Hopper
// K1, K2's dk/dv kernel (K2a fused, K2b's first kernel) and K2b's dq
// kernel (the operand path is in attention_common.cuh):
//   - tiles are copied into shared memory with cp.async (16 bytes a thread,
//     no registers on the way) into a two-stage ring, the next tile's copy
//     issued before this tile's products, so the copy runs under them;
//   - every operand comes out of shared memory through ldmatrix, from the
//     tiles' natural [row][d] layout: ldmatrix.trans hands out the
//     transposed fragments (V, dO and Q as right operands over the key or
//     query axis, K as the right operand of dQ = dS K, dS^T as the left
//     operand of K2a's dQ), so nothing is staged transposed;
//   - K2a adds dq once per 64-key block and query tile as float4 atomics
//     (red.global.add.v4.f32 on sm_90): a lane pair trades one row's half,
//     so each lane adds four neighbouring columns (a quarter of the
//     operations of one scalar atomic per element);
//   - the ragged and causal cuts are tested only on the tiles that cross
//     them, the additive mask read from shared memory (K1) or registers
//     (K2); the exponentials are ex2.approx of (x - m) * log2(e), the
//     difference taken in natural units first: a row masked at -1e9
//     everywhere (fp32 ulp 64) then gives exactly the plain version's
//     probabilities (folding log2(e) into the scale rounds the two sides
//     apart by up to 128, and timed no faster);
//   - P and dS enter their products as hi + lo bf16 (one bf16 rounding of
//     P, 2**-9 relative, would be some 30 times FLASH_ACC's limit), hi by
//     truncation (one byte permute per pair) and lo = RN(x - hi): 2**-16
//     relative, one conversion per pair instead of two.
// Blocks of 64 rows (K1) and 64 keys (K2) of 4 warps timed faster on the
// card than blocks of 128 (8 warps, or 4 warps of 32 rows); a three-stage
// ring, and wgmma for S = Q K^T and S^T = K Q^T (A in registers, B from a
// no-swizzle tile), timed no faster (PERF.md).

constexpr int kWarps = 4;              // a warp per 16 rows (K1) or keys (K2)
constexpr int kAsyncThreads = 32 * kWarps;
constexpr int kStages = 2;             // the cp.async ring

// Rows [row0, row0 + kTile) of a contiguous [n, 64] bf16 matrix into shared
// memory (row stride kLdh) by cp.async; rows at or past n are zeros.
__device__ __forceinline__ void async_tile(bf16* dst, const bf16* src,
                                           int row0, int n) {
  for (int e = threadIdx.x; e < kTile * (kD / 8); e += kAsyncThreads) {
    const int r = e / (kD / 8), c = (e % (kD / 8)) * 8;
    const bool in = row0 + r < n;
    cp_async16(dst + r * kLdh + c,
               in ? src + (size_t)(row0 + r) * kD + c : src, in);
  }
}

// Entries [row0, row0 + 64) of an fp32 [n] vector into shared memory by
// threads [tid0, tid0 + 64); entries at or past n are zeros.
__device__ __forceinline__ void async_vec(float* dst, const float* src,
                                          int row0, int n, int tid0) {
  const int i = threadIdx.x - tid0;
  if (i >= 0 && i < kTile) {
    const bool in = row0 + i < n;
    cp_async4(dst + i, in ? src + row0 + i : src, in);
  }
}

// K1 for bf16 on Hopper: one block per (64-row query tile, h, b), the
// longest causal rows first; a warp per 16 rows; K/V tiles of 64 keys in
// the cp.async ring; S = Q K^T, the online softmax and O += P V in
// registers.
constexpr size_t kFwdAsyncSmem =
    (kTile * kLdh + kStages * 2 * kTileH) * sizeof(bf16) +
    kStages * kTile * sizeof(float);

__global__ void __launch_bounds__(kAsyncThreads, 3)
    fwd_async_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ mask, bf16* __restrict__ o,
                     float* __restrict__ lse, int H, int Tq, int Tk,
                     float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_fwd[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_fwd);      // [64][kLdh]
  bf16* kv_s = q_s + kTileH;                          // stages: K, V
  float* m_s = reinterpret_cast<float*>(kv_s + kStages * 2 * kTileH);

  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const bf16* kb = k + bh * Tk * kD;
  const bf16* vb = v + bh * Tk * kD;
  const float* mb = mask != nullptr ? mask + (size_t)b * Tk : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  int n_kt = (Tk + kTile - 1) / kTile;
  if (causal) n_kt = min(n_kt, min(q0 + kTile - 1, Tq - 1) / kTile + 1);

  auto issue = [&](int kt) {
    bf16* ks = kv_s + (kt % kStages) * 2 * kTileH;
    async_tile(ks, kb, kt * kTile, Tk);
    async_tile(ks + kTileH, vb, kt * kTile, Tk);
    if (mb != nullptr)
      async_vec(m_s + (kt % kStages) * kTile, mb, kt * kTile, Tk, 0);
  };
  async_tile(q_s, q + bh * Tq * kD, q0, Tq);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_kt) issue(i);
    cp_async_commit();
  }

  uint32_t qf[kKS][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[kNT][4];
  zero(acc);
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt (and Q) have landed
    // ... for every thread, and every warp is done with tile kt - 1, whose
    // stage the next copy refills.
    __syncthreads();
    if (kt + kStages - 1 < n_kt) issue(kt + kStages - 1);
    cp_async_commit();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) lhs_frag<kLdh>(qf[kk], q_s, r0, kk, lane);
    }
    const int k0 = kt * kTile;
    const bf16* ks = kv_s + (kt % kStages) * 2 * kTileH;
    const float* ms = m_s + (kt % kStages) * kTile;
    // A warp whose rows all precede the tile sees none of it.
    if (!causal || k0 <= q0 + r0 + 15) {
      float s[kNT][4];
      zero(s);
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) mma_nt<kLdh>(s, qf[kk], ks, kk, lane);
      // Only a tile that crosses T_kv or the warp's causal frontier tests
      // its keys.
      const bool edge =
          k0 + kTile > Tk || (causal && k0 + kTile - 1 > q0 + r0);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1);
          float x = s[n][e] * scale;
          if (mb != nullptr) x += ms[c];
          if (edge) {
            // Keys past T_kv are not keys: -inf, an exact 0 below. Key 0 is
            // in range for every row, so the running max is finite from
            // tile 0.
            if (k0 + c >= Tk)
              x = -INFINITY;
            else if (causal && k0 + c > row[e >> 1])
              x = kNegInf;
          }
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = ex2((m[r] - m_new) * kLog2e);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[n][e] *= alpha[e >> 1];
          const float p = ex2((s[n][e] - m[e >> 1]) * kLog2e);
          s[n][e] = p;
          l[e >> 1] += p;
        }
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) {
        uint32_t hi[4], lo[4];
        frag_from_acc_t(s[2 * j], s[2 * j + 1], hi, lo);
        mma_nn2<kLdh>(acc, hi, lo, ks + kTileH, j, lane);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float lv = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / lv;
    if (t == 0 && row[r] < Tq) lse[bh * Tq + row[r]] = m[r] + logf(lv);
  }
  store_rows(o + bh * Tq * kD, acc, row[0], Tq, inv[0], inv[1], t);
}

// K2 for bf16 on Hopper: one block per 64-key tile, a warp per 16 keys,
// whose K and V rows stay in registers as left operands. Per 64-row query
// tile (Q, dO, lse and delta in the cp.async ring): S^T = K Q^T and dP^T =
// V dO^T, P^T and dS^T in fp32, then dV += P^T dO and dK += dS^T Q into
// register accumulators held across the sweep. With kDq (K2a) dS^T goes to
// shared memory as hi and lo bf16 ([key][query]), and after a barrier each
// warp computes 16 query rows of dS K over the block's 64 keys and adds
// them into dq_acc as float4 atomics.
template <bool kDq>
constexpr size_t dkdv_async_smem() {
  return ((kDq ? 3 : 2) * kTileH + kStages * 2 * kTileH) * sizeof(bf16) +
         kStages * 2 * kTile * sizeof(float);
}

template <bool kDq>
__global__ void __launch_bounds__(kAsyncThreads, 1)
    dkdv_async_kernel(const bf16* __restrict__ q,
                      const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ mask,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dq_acc, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int H, int Tq, int Tk,
                      float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_bwd[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_bwd);  // [64][kLdh] K
  bf16* dsh_s = k_s + kTileH;  // V at the start, then dS^T hi
  bf16* dsl_s = dsh_s + kTileH;                    // kDq: dS^T lo
  bf16* st_s = kDq ? dsl_s + kTileH : dsl_s;       // stages: Q, dO
  float* vec_s = reinterpret_cast<float*>(st_s + kStages * 2 * kTileH);

  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const bf16* qb = q + bh * Tq * kD;
  const bf16* dob = dout + bh * Tq * kD;
  const float* lb = lse + bh * Tq;
  const float* db = delta + bh * Tq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;
  const int k0 = blockIdx.x * kTile;
  const int kw = k0 + r0;  // the warp's first key
  const int key[2] = {kw + g, kw + g + 8};
  float mval[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    mval[r] = mask != nullptr && key[r] < Tk ? mask[(size_t)b * Tk + key[r]]
                                             : 0.f;
  const int n_qt = (Tq + kTile - 1) / kTile;
  const int first_qt = causal ? k0 / kTile : 0;  // first query to see k0

  auto issue = [&](int qt) {
    const int st = (qt - first_qt) % kStages;
    bf16* qs = st_s + st * 2 * kTileH;
    async_tile(qs, qb, qt * kTile, Tq);
    async_tile(qs + kTileH, dob, qt * kTile, Tq);
    float* vs = vec_s + st * 2 * kTile;
    async_vec(vs, lb, qt * kTile, Tq, 0);
    async_vec(vs + kTile, db, qt * kTile, Tq, kTile);
  };
  async_tile(k_s, k + bh * Tk * kD, k0, Tk);
  async_tile(dsh_s, v + bh * Tk * kD, k0, Tk);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (first_qt + i < n_qt) issue(first_qt + i);
    cp_async_commit();
  }

  uint32_t kf[kKS][4], vf[kKS][4];
  float dk_acc[kNT][4], dv_acc[kNT][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int qt = first_qt; qt < n_qt; ++qt) {
    cp_async_wait<kStages - 2>();  // tile qt (and K, V) have landed
    // ... for every thread, and every warp is done with tile qt - 1: its
    // stage (refilled next) and dS^T (rewritten below).
    __syncthreads();
    if (qt + kStages - 1 < n_qt) issue(qt + kStages - 1);
    cp_async_commit();
    if (qt == first_qt) {
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        lhs_frag<kLdh>(kf[kk], k_s, r0, kk, lane);
        lhs_frag<kLdh>(vf[kk], dsh_s, r0, kk, lane);
      }
      __syncthreads();  // V is read: dsh_s holds dS^T from here on
    }
    const int q0 = qt * kTile;
    const int st = (qt - first_qt) % kStages;
    const bf16* qs = st_s + st * 2 * kTileH;
    const bf16* dos = qs + kTileH;
    const float* lse_s = vec_s + st * 2 * kTile;
    const float* delta_s = lse_s + kTile;
    float pt[kNT][4], dst[kNT][4];  // [key][query] tiles
    zero(pt);
    zero(dst);
    // A warp whose keys all follow the tile's last query sees none of it.
    if (!causal || kw <= q0 + kTile - 1) {
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        mma_nt<kLdh>(pt, kf[kk], qs, kk, lane);
        mma_nt<kLdh>(dst, vf[kk], dos, kk, lane);
      }
      // Only a tile that crosses T_q, T_kv or the causal frontier tests
      // its pairs.
      const bool edge = q0 + kTile > Tq || kw + 16 > Tk ||
                        (causal && kw + 15 > q0);
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1);  // query within the tile
          const int kr = key[e >> 1];
          const float x = pt[n][e] * scale + mval[e >> 1];
          float p = ex2(fminf(x - lse_s[c], 0.f) * kLog2e);
          if (edge && (kr >= Tk || q0 + c >= Tq || (causal && kr > q0 + c)))
            p = 0.f;
          pt[n][e] = p;
          dst[n][e] = p * (dst[n][e] - delta_s[c]);
        }
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) {
        uint32_t hi[4], lo[4];
        frag_from_acc_t(pt[2 * j], pt[2 * j + 1], hi, lo);
        mma_nn2<kLdh>(dv_acc, hi, lo, dos, j, lane);
        frag_from_acc_t(dst[2 * j], dst[2 * j + 1], hi, lo);
        mma_nn2<kLdh>(dk_acc, hi, lo, qs, j, lane);
      }
    }
    if (kDq) {
      // dS^T as bf16 pairs: lane (g, t) holds keys g and g + 8, queries 2t
      // and 2t + 1 of each n-tile (zeros for a warp that sees no pair).
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t hi, lo;
          split2t(dst[n][2 * r], dst[n][2 * r + 1], hi, lo);
          const int off = (r0 + g + 8 * r) * kLdh + 8 * n + 2 * t;
          *reinterpret_cast<uint32_t*>(dsh_s + off) = hi;
          *reinterpret_cast<uint32_t*>(dsl_s + off) = lo;
        }
      __syncthreads();  // every warp's dS^T rows are written
      // dq rows [q0 + r0, q0 + r0 + 16): dS K over the block's 64 keys, dS
      // read transposed out of dS^T.
      float dq[kNT][4];
      zero(dq);
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t ahi[4], alo[4];
        lhs_frag_t<kLdh>(ahi, dsh_s, r0, kk, lane);
        lhs_frag_t<kLdh>(alo, dsl_s, r0, kk, lane);
        mma_nn2<kLdh>(dq, ahi, alo, k_s, kk, lane);
      }
      const int row = q0 + r0 + g;
      atomic_add_rows(dq_acc + bh * Tq * kD, dq, row, kD, scale, row < Tq,
                      row + 8 < Tq, t);
    }
  }
  store_rows(dk + bh * Tk * kD, dk_acc, key[0], Tk, scale, scale, t);
  store_rows(dv + bh * Tk * kD, dv_acc, key[0], Tk, 1.f, 1.f, t);
}

// K2b's second kernel for bf16 on Hopper: one block per 64-row query tile,
// the longest causal rows first, a warp per 16 rows whose Q and dO rows stay
// in registers as left operands. Per 64-key tile (K, V and the mask slice
// in the cp.async ring): S = Q K^T and dP = dO V^T, dS = P (dP - delta) in
// fp32, then dQ += dS K with K's fragments by ldmatrix.trans from the same
// K tile, all in registers; no atomics. Three blocks share an SM (168
// registers a thread, a few bytes spilled): timed faster than two at 219
// registers, and than passes of 32 keys (PERF.md).
constexpr size_t kDqAsyncSmem =
    (2 * kTileH + kStages * 2 * kTileH) * sizeof(bf16) +
    kStages * kTile * sizeof(float);

__global__ void __launch_bounds__(kAsyncThreads, 3)
    dq_async_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const float* __restrict__ mask,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int H, int Tq, int Tk, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_dq[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_dq);  // [64][kLdh] Q
  bf16* do_s = q_s + kTileH;                     // dO
  bf16* kv_s = do_s + kTileH;                    // stages: K, V
  float* m_s = reinterpret_cast<float*>(kv_s + kStages * 2 * kTileH);

  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const bf16* kb = k + bh * Tk * kD;
  const bf16* vb = v + bh * Tk * kD;
  const float* mb = mask != nullptr ? mask + (size_t)b * Tk : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  int n_kt = (Tk + kTile - 1) / kTile;
  if (causal) n_kt = min(n_kt, min(q0 + kTile - 1, Tq - 1) / kTile + 1);

  auto issue = [&](int kt) {
    bf16* ks = kv_s + (kt % kStages) * 2 * kTileH;
    async_tile(ks, kb, kt * kTile, Tk);
    async_tile(ks + kTileH, vb, kt * kTile, Tk);
    if (mb != nullptr)
      async_vec(m_s + (kt % kStages) * kTile, mb, kt * kTile, Tk, 0);
  };
  async_tile(q_s, q + bh * Tq * kD, q0, Tq);
  async_tile(do_s, dout + bh * Tq * kD, q0, Tq);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_kt) issue(i);
    cp_async_commit();
  }
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = row[r] < Tq ? lse[bh * Tq + row[r]] : 0.f;
    delta_r[r] = row[r] < Tq ? delta[bh * Tq + row[r]] : 0.f;
  }

  uint32_t qf[kKS][4], dof[kKS][4];
  float acc[kNT][4];
  zero(acc);
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt (and Q, dO) have landed
    // ... for every thread, and every warp is done with tile kt - 1, whose
    // stage the next copy refills.
    __syncthreads();
    if (kt + kStages - 1 < n_kt) issue(kt + kStages - 1);
    cp_async_commit();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        lhs_frag<kLdh>(qf[kk], q_s, r0, kk, lane);
        lhs_frag<kLdh>(dof[kk], do_s, r0, kk, lane);
      }
    }
    const int k0 = kt * kTile;
    const bf16* ks = kv_s + (kt % kStages) * 2 * kTileH;
    const float* ms = m_s + (kt % kStages) * kTile;
    // A warp whose rows all precede the tile sees none of it.
    if (causal && k0 > q0 + r0 + 15) continue;
    // Only a tile that crosses T_q, T_kv or the warp's causal frontier
    // tests its pairs.
    const bool edge = q0 + r0 + 16 > Tq || k0 + kTile > Tk ||
                      (causal && k0 + kTile - 1 > q0 + r0);
    float s[kNT][4], dp[kNT][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      mma_nt<kLdh>(s, qf[kk], ks, kk, lane);
      mma_nt<kLdh>(dp, dof[kk], ks + kTileH, kk, lane);
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);  // key within the tile
        const int r = e >> 1;
        float x = s[n][e] * scale;
        if (mb != nullptr) x += ms[c];
        float p = ex2(fminf(x - lse_r[r], 0.f) * kLog2e);
        if (edge &&
            (k0 + c >= Tk || row[r] >= Tq || (causal && k0 + c > row[r])))
          p = 0.f;
        s[n][e] = p * (dp[n][e] - delta_r[r]);
      }
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
      uint32_t hi[4], lo[4];
      frag_from_acc_t(s[2 * j], s[2 * j + 1], hi, lo);
      mma_nn2<kLdh>(acc, hi, lo, ks, j, lane);
    }
  }
  store_rows(dq + bh * Tq * kD, acc, row[0], Tq, scale, scale, t);
}

constexpr size_t kFwdSmem = 4 * kTileFloats * sizeof(float);
constexpr size_t kDkdvSmem = (6 * kTileFloats + 2 * kTile) * sizeof(float);
constexpr size_t kDqSmem = (5 * kTileFloats + 2 * kTile) * sizeof(float);
template <typename T>
constexpr bool kOnTensorCores = std::is_same<T, bf16>::value;

bool shape_ok(int B, int H, int Tq, int Tk, int D) {
  return D == kD && B >= 1 && H >= 1 && Tq >= 1 && Tk >= 1 && B <= 65535 &&
         H <= 65535;
}

// Set the kernel's dynamic shared-memory limit and launch it; returns the
// CUDA error (0 on success).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, dim3 grid, int threads,
           cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const void* mask,
               void* o, void* lse, int B, int H, int Tq, int Tk, float scale,
               int causal, cudaStream_t st) {
  const dim3 grid((Tq + kTile - 1) / kTile, H, B);
  if constexpr (kOnTensorCores<T>) {
    return launch(fwd_async_kernel, kFwdAsyncSmem, grid, kAsyncThreads, st,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v),
                  static_cast<const float*>(mask), static_cast<bf16*>(o),
                  static_cast<float*>(lse), H, Tq, Tk, scale, causal);
  } else {
    return launch(fwd_kernel<T>, kFwdSmem, grid, kThreads, st,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const float*>(mask),
                  static_cast<T*>(o), static_cast<float*>(lse), H, Tq, Tk,
                  scale, causal);
  }
}

template <typename T>
int launch_dkdv(const void* q, const void* k, const void* v, const void* mask,
                const void* dout, const void* lse, const void* delta,
                void* dq_acc, void* dk, void* dv, int B, int H, int Tq,
                int Tk, float scale, int causal, int fused, cudaStream_t st) {
  using E = std::conditional_t<kOnTensorCores<T>, bf16, T>;
  const dim3 grid((Tk + kTile - 1) / kTile, H, B);
  auto args = [&](auto kernel, size_t smem, int threads) {
    return launch(kernel, smem, grid, threads, st, static_cast<const E*>(q),
                  static_cast<const E*>(k), static_cast<const E*>(v),
                  static_cast<const float*>(mask),
                  static_cast<const E*>(dout),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta),
                  static_cast<float*>(dq_acc), static_cast<E*>(dk),
                  static_cast<E*>(dv), H, Tq, Tk, scale, causal);
  };
  if constexpr (kOnTensorCores<T>) {
    return fused ? args(dkdv_async_kernel<true>, dkdv_async_smem<true>(),
                        kAsyncThreads)
                 : args(dkdv_async_kernel<false>, dkdv_async_smem<false>(),
                        kAsyncThreads);
  } else {
    return fused ? args(dkdv_kernel<T, true>, kDkdvSmem, kThreads)
                 : args(dkdv_kernel<T, false>, kDkdvSmem, kThreads);
  }
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* mask,
              const void* dout, const void* lse, const void* delta, void* dq,
              int B, int H, int Tq, int Tk, float scale, int causal,
              cudaStream_t st) {
  using E = std::conditional_t<kOnTensorCores<T>, bf16, T>;
  const dim3 grid((Tq + kTile - 1) / kTile, H, B);
  auto args = [&](auto kernel, size_t smem, int threads) {
    return launch(kernel, smem, grid, threads, st, static_cast<const E*>(q),
                  static_cast<const E*>(k), static_cast<const E*>(v),
                  static_cast<const float*>(mask),
                  static_cast<const E*>(dout),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<E*>(dq), H,
                  Tq, Tk, scale, causal);
  };
  if constexpr (kOnTensorCores<T>) {
    return args(dq_async_kernel, kDqAsyncSmem, kAsyncThreads);
  } else {
    return args(dq_kernel<T>, kDqSmem, kThreads);
  }
}

}  // namespace

// Plain C entry points, bound with ctypes. dtype: 0 = float32, 1 = bfloat16,
// 2 = float16. Every tensor contiguous: q, o, dout, dq [B, H, Tq, 64];
// k, v, dk, dv [B, H, Tk, 64]; lse, delta [B, H, Tq] fp32; mask [B, Tk]
// fp32 or null. Each launches on `stream` and returns cudaGetLastError()
// (0 on success); shapes the kernels do not take return
// cudaErrorInvalidValue.

// K1: o and lse.
extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v,
                            const void* mask, void* o, void* lse, int B, int H,
                            int Tq, int Tk, int D, int dtype, float scale,
                            int causal, void* stream) {
  if (!shape_ok(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_fwd<float>(q, k, v, mask, o, lse, B, H, Tq, Tk, scale,
                               causal, st);
    case 1:
      return launch_fwd<__nv_bfloat16>(q, k, v, mask, o, lse, B, H, Tq, Tk,
                                       scale, causal, st);
    case 2:
      return launch_fwd<__half>(q, k, v, mask, o, lse, B, H, Tq, Tk, scale,
                                causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K2a (fused = 1): dk, dv, and dq added into dq_acc (fp32, zeroed by the
// caller). K2b's first kernel (fused = 0): dk and dv only; dq_acc unused.
extern "C" int ds_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                 const void* mask, const void* dout,
                                 const void* lse, const void* delta,
                                 void* dq_acc, void* dk, void* dv, int B,
                                 int H, int Tq, int Tk, int D, int dtype,
                                 float scale, int causal, int fused,
                                 void* stream) {
  if (!shape_ok(B, H, Tq, Tk, D) || (fused && dq_acc == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dkdv<float>(q, k, v, mask, dout, lse, delta, dq_acc, dk,
                                dv, B, H, Tq, Tk, scale, causal, fused, st);
    case 1:
      return launch_dkdv<__nv_bfloat16>(q, k, v, mask, dout, lse, delta,
                                        dq_acc, dk, dv, B, H, Tq, Tk, scale,
                                        causal, fused, st);
    case 2:
      return launch_dkdv<__half>(q, k, v, mask, dout, lse, delta, dq_acc, dk,
                                 dv, B, H, Tq, Tk, scale, causal, fused, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K2b's second kernel: dq in the input type.
extern "C" int ds_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* mask, const void* dout,
                               const void* lse, const void* delta, void* dq,
                               int B, int H, int Tq, int Tk, int D, int dtype,
                               float scale, int causal, void* stream) {
  if (!shape_ok(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dq<float>(q, k, v, mask, dout, lse, delta, dq, B, H, Tq,
                              Tk, scale, causal, st);
    case 1:
      return launch_dq<__nv_bfloat16>(q, k, v, mask, dout, lse, delta, dq, B,
                                      H, Tq, Tk, scale, causal, st);
    case 2:
      return launch_dq<__half>(q, k, v, mask, dout, lse, delta, dq, B, H, Tq,
                               Tk, scale, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
