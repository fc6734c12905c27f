// Flash-decode attention over a per-row-frontier KV cache, for Hopper
// (sm_90a): one kernel body, four kernels.
//
// What they replace (deepspeed_tpu/ops/transformer/kernels/
// decode_attention.py, each launched through `pl.pallas_call`) and the plain
// PyTorch version each is held against (deepspeed_tpu_torch/ops/transformer/
// kernels/decode_attention.py):
//   K3  dense plane, fp keys:     `_decode_kernel` (`_flash_decode_pallas`),
//                                 `decode_attention_reference`;
//   K4  dense plane, int8 keys:   `_decode_kernel_q8`
//                                 (`_flash_decode_q8_pallas`),
//                                 `decode_attention_q8_reference`;
//   K5  page arena, fp keys:      `_decode_kernel_paged`
//                                 (`_flash_decode_paged_pallas`),
//                                 `decode_attention_paged_reference`;
//   K6  page arena, int8 keys:    `_decode_kernel_paged_q8`
//                                 (`_flash_decode_paged_q8_pallas`),
//                                 `decode_attention_paged_q8_reference`.
//
// What they compute, per (b, h):
//   q [S, D] rows at global positions pos[b] .. pos[b]+S-1 (their k/v are
//   already written into the cache); key t is visible to query row i iff
//   t <= pos[b] + i. out[i] = softmax_t(scale * q[i].k[t]) @ v, with the
//   softmax in fp32. Keys past a row's frontier hold stale garbage from
//   earlier requests and never reach the result.
//
// The body is a template over two things:
//   - how key t of row b is addressed. Dense: row (b*H + h)*T + t of a
//     [B, H, T, D] plane. Paged: page tbl[b, t / page_len] of a
//     [P, H, page_len, D] arena, offset t % page_len; the CTA's row of the
//     block table is read once into shared memory. The logical plane is
//     n_lp * page_len keys long, and page 0 is the trash page that freed
//     rows and unmapped logical pages point at;
//   - what a stored key is. fp: T elements. int8: D codes plus one fp32
//     scale per key for k and one for v (scales [.., T] dense, [P, H,
//     page_len] paged, indexed by the same row as the codes). As the TPU
//     kernel does, k is dequantized to fp32 (codes x scale) for the scores,
//     and v to fp32 and then rounded to the output type.
// Only the addresses and the staging differ, so K5 on an arena performs the
// same arithmetic in the same order as K3 on the gathered plane, and K6 the
// same as K4: their results are equal bit for bit.
//
// Bound on an H100 SXM: memory, for all four. Each (b, h) must read its K
// and V rows up to the frontier once: 2 * D * sizeof(T) bytes per key for
// K3/K5 (256 in bf16), 2 * D + 8 for K4/K6 (136: int8 codes and two fp32
// scales), against 4 * S * D flops per key; at S <= 64 that is far below
// the 295 flops per byte the card needs before compute could be the limit.
// So the least time is those bytes over 3.35 TB/s.
//
// What the design does about it:
//   - frontier-aware: the tile loop stops at the last tile holding a key
//     visible to any row, (pos[b]+S-1)/kBlockK, so tiles past the frontier
//     are never loaded (the TPU kernels' kv_index clamp and @pl.when skip);
//     a paged row's unmapped logical pages (table entry 0) are loaded only
//     inside the masked part of the frontier tile;
//   - each tile of K and V is read from device memory once per (b, h) and
//     staged in shared memory (as fp32, dequantized while staged) for every
//     query row; the next tile's loads are issued into registers (16-byte
//     vectors: 8 bf16, 4 fp32 or 16 int8 codes, plus the key's two scales)
//     before the current tile is computed, so the load latency overlaps the
//     arithmetic;
//   - scores never leave the chip: online softmax with fp32 running max,
//     sum and accumulator in registers;
//   - the frontier mask is applied only on a tile that straddles it;
//   - the scale is applied once, to q, as it is staged.
// Layout: one CTA of 4 warps per (b, h); a warp owns query rows
// warp, warp+4, ...; within a tile, lane j scores key j, and for the value
// product lane j owns output columns j and j+32. The int8 kernels read
// 0.53x the bytes of the bf16 ones but share this latency-bound loop, so
// they take about the same time; split-K over the length, cp.async/TMA and
// wgmma are left for later work: at batch 1 (the prefill lane) only H CTAs
// run, far fewer than the 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kHeadDim = 64;
constexpr int kBlockK = 32;  // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 64;  // query rows S per (b, h)
constexpr int kRowsPerWarp = kMaxRows / kWarps;
// Block-table entries a CTA stages in shared memory; the kernel's static
// shared memory (q, k, v, p tiles: 33,408 bytes) plus this stays inside the
// 227 KB a block may use.
constexpr int kMaxTableEntries = 49152;
// Above this many entries the table no longer fits the 48 KB of shared
// memory a launch gets without opting in.
constexpr int kTableOptIn = 2048;

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_float(int8_t x) {
  return (float)x;
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// x rounded to T and widened back: the int8 kernels' v in the output type.
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// T: the type of q and out (and of the cached keys when not int8).
template <typename T, bool kQ8, bool kPaged>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q,
                            const void* __restrict__ k_,
                            const void* __restrict__ v_,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ tbl, int n_lp,
                            int page_len, const int* __restrict__ pos,
                            T* __restrict__ out, int H, int S, int T_len,
                            float scale) {
  using Elem = typename std::conditional<kQ8, int8_t, T>::type;
  constexpr int VN = 16 / sizeof(Elem);  // elements in one 16-byte load
  constexpr int kVecsPerRow = kHeadDim / VN;
  constexpr int kVecsPerThread = kBlockK * kVecsPerRow / kThreads;
  const Elem* k = static_cast<const Elem*>(k_);
  const Elem* v = static_cast<const Elem*>(v_);

  __shared__ float q_s[kMaxRows][kHeadDim];
  // +1 column: lane j reads row j, so an odd row stride keeps the 32 lanes
  // on 32 different banks.
  __shared__ float k_s[kBlockK][kHeadDim + 1];
  __shared__ float v_s[kBlockK][kHeadDim];
  __shared__ float p_s[kWarps][kBlockK];
  extern __shared__ int tbl_s[];  // paged: this CTA's row of the table

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t bh = (size_t)b * H + h;
  const T* qb = q + bh * S * kHeadDim;
  T* ob = out + bh * S * kHeadDim;

  const int pos_b = pos[b];
  const int n_tiles = (T_len + kBlockK - 1) / kBlockK;
  int last = (pos_b + S - 1) / kBlockK;
  if (last > n_tiles - 1) last = n_tiles - 1;

  if (kPaged) {
    // Only the entries of the tiles the loop will load.
    int last_key = (last + 1) * kBlockK - 1;
    if (last_key > T_len - 1) last_key = T_len - 1;
    const int n_used = last_key / page_len + 1;
    for (int e = threadIdx.x; e < n_used; e += kThreads) {
      tbl_s[e] = tbl[(size_t)b * n_lp + e];
    }
    __syncthreads();  // the first tile's loads read the table
  }
  // The cache row (of codes, and of scales) holding key t.
  auto key_row = [&](int t) -> size_t {
    if (kPaged) {
      return ((size_t)tbl_s[t / page_len] * H + h) * page_len + t % page_len;
    }
    return bh * T_len + t;
  };

  for (int e = threadIdx.x; e < S * kHeadDim; e += kThreads) {
    q_s[e / kHeadDim][e % kHeadDim] = to_float(qb[e]) * scale;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc0[kRowsPerWarp],
      acc1[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    acc0[r] = 0.f;
    acc1[r] = 0.f;
  }

  uint4 k_reg[kVecsPerThread], v_reg[kVecsPerThread];
  float ks_reg[kVecsPerThread], vs_reg[kVecsPerThread];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  auto load_tile = [&](int tile) {
#pragma unroll
    for (int i = 0; i < kVecsPerThread; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int key = tile * kBlockK + idx / kVecsPerRow;
      const int col = (idx % kVecsPerRow) * VN;
      if (key < T_len) {
        const size_t row = key_row(key);
        const size_t off = row * kHeadDim + col;
        k_reg[i] = *reinterpret_cast<const uint4*>(k + off);
        v_reg[i] = *reinterpret_cast<const uint4*>(v + off);
        if (kQ8) {
          ks_reg[i] = k_scale[row];
          vs_reg[i] = v_scale[row];
        }
      } else {
        k_reg[i] = zero;
        v_reg[i] = zero;
        if (kQ8) {
          ks_reg[i] = 0.f;
          vs_reg[i] = 0.f;
        }
      }
    }
  };

  if (last >= 0) load_tile(0);
  for (int tile = 0; tile <= last; ++tile) {
    __syncthreads();  // every warp is done reading the previous tile
#pragma unroll
    for (int i = 0; i < kVecsPerThread; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int row = idx / kVecsPerRow;
      const int col = (idx % kVecsPerRow) * VN;
      const Elem* ke = reinterpret_cast<const Elem*>(&k_reg[i]);
      const Elem* ve = reinterpret_cast<const Elem*>(&v_reg[i]);
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        if (kQ8) {
          k_s[row][col + j] = to_float(ke[j]) * ks_reg[i];
          v_s[row][col + j] = round_to(to_float(ve[j]) * vs_reg[i], q);
        } else {
          k_s[row][col + j] = to_float(ke[j]);
          v_s[row][col + j] = to_float(ve[j]);
        }
      }
    }
    __syncthreads();
    if (tile < last) load_tile(tile + 1);

    const int key = tile * kBlockK + lane;
    // A tile whose last key is visible to the FIRST row is visible to all
    // rows: only the tile straddling the frontier pays for the mask.
    const bool interior =
        (tile + 1) * kBlockK - 1 <= pos_b && (tile + 1) * kBlockK <= T_len;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = warp + r * kWarps;
      if (i < S) {  // uniform across the warp
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) s += q_s[i][d] * k_s[lane][d];
        if (!interior && (key > pos_b + i || key >= T_len)) s = -INFINITY;
        float tmax = s;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
        // Finite from tile 0 on: key 0 is visible to every row.
        const float m_new = fmaxf(m[r], tmax);
        const float alpha = expf(m[r] - m_new);
        const float p = expf(s - m_new);
        float psum = p;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, o);
        l[r] = l[r] * alpha + psum;
        m[r] = m_new;
        p_s[warp][lane] = p;
        __syncwarp();
        float a0 = acc0[r] * alpha;
        float a1 = acc1[r] * alpha;
#pragma unroll
        for (int j = 0; j < kBlockK; ++j) {
          const float pj = p_s[warp][j];
          a0 += pj * v_s[j][lane];
          a1 += pj * v_s[j][lane + 32];
        }
        acc0[r] = a0;
        acc1[r] = a1;
        __syncwarp();  // p_s is rewritten by the next row
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = warp + r * kWarps;
    if (i < S) {
      const float inv = 1.f / l[r];
      store_out(ob + (size_t)i * kHeadDim + lane, acc0[r] * inv);
      store_out(ob + (size_t)i * kHeadDim + lane + 32, acc1[r] * inv);
    }
  }
}

template <typename T, bool kQ8, bool kPaged>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* tbl, int n_lp, int page_len,
           const void* pos, void* out, int B, int H, int S, int T_len,
           float scale, void* stream) {
  auto kernel = decode_attention_kernel<T, kQ8, kPaged>;
  const size_t smem = kPaged ? (size_t)n_lp * sizeof(int) : 0;
  if (kPaged && n_lp > kTableOptIn) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(H, B);
  kernel<<<grid, kThreads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), k, v, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tbl), n_lp,
      page_len, static_cast<const int*>(pos), static_cast<T*>(out), H, S,
      T_len, scale);
  return (int)cudaGetLastError();
}

template <bool kQ8, bool kPaged>
int dispatch(int dtype, const void* q, const void* k, const void* v,
             const void* k_scale, const void* v_scale, const void* tbl,
             int n_lp, int page_len, const void* pos, void* out, int B, int H,
             int S, int T_len, int D, float scale, void* stream) {
  if (D != kHeadDim || S < 1 || S > kMaxRows || T_len < 1 || B < 1 ||
      H < 1 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    return launch<float, kQ8, kPaged>(q, k, v, k_scale, v_scale, tbl, n_lp,
                                      page_len, pos, out, B, H, S, T_len,
                                      scale, stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, kQ8, kPaged>(q, k, v, k_scale, v_scale, tbl,
                                              n_lp, page_len, pos, out, B, H,
                                              S, T_len, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

bool table_ok(int n_lp, int page_len) {
  return n_lp >= 1 && n_lp <= kMaxTableEntries && page_len >= 1 &&
         (long long)n_lp * page_len <= 0x7fffffffLL;
}

}  // namespace

// Plain C entry points, bound with ctypes. dtype (of q and out, and of k/v
// for K3/K5): 0 = float32, 1 = bfloat16. All tensors contiguous: q, out
// [B, H, S, D]; pos [B] int32. Each launches on `stream` and returns
// cudaGetLastError() (0 on success); shapes the kernels do not take return
// cudaErrorInvalidValue.

// K3: k, v [B, H, T, D] of dtype.
extern "C" int ds_decode_attention(const void* q, const void* k,
                                   const void* v, const void* pos, void* out,
                                   int B, int H, int S, int T, int D,
                                   int dtype, float scale, void* stream) {
  return dispatch<false, false>(dtype, q, k, v, nullptr, nullptr, nullptr, 0,
                                0, pos, out, B, H, S, T, D, scale, stream);
}

// K4: k, v [B, H, T, D] int8 codes; k_scale, v_scale [B, H, T] fp32.
extern "C" int ds_decode_attention_q8(const void* q, const void* k,
                                      const void* v, const void* k_scale,
                                      const void* v_scale, const void* pos,
                                      void* out, int B, int H, int S, int T,
                                      int D, int dtype, float scale,
                                      void* stream) {
  return dispatch<true, false>(dtype, q, k, v, k_scale, v_scale, nullptr, 0,
                               0, pos, out, B, H, S, T, D, scale, stream);
}

// K5: k, v [P, H, page_len, D] of dtype; tbl [B, n_lp] int32.
extern "C" int ds_decode_attention_paged(const void* q, const void* k,
                                         const void* v, const void* tbl,
                                         const void* pos, void* out, int B,
                                         int H, int S, int n_lp, int page_len,
                                         int D, int dtype, float scale,
                                         void* stream) {
  if (!table_ok(n_lp, page_len)) return (int)cudaErrorInvalidValue;
  return dispatch<false, true>(dtype, q, k, v, nullptr, nullptr, tbl, n_lp,
                               page_len, pos, out, B, H, S, n_lp * page_len,
                               D, scale, stream);
}

// K6: k, v [P, H, page_len, D] int8 codes; k_scale, v_scale [P, H,
// page_len] fp32; tbl [B, n_lp] int32.
extern "C" int ds_decode_attention_paged_q8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* tbl, const void* pos, void* out, int B,
    int H, int S, int n_lp, int page_len, int D, int dtype, float scale,
    void* stream) {
  if (!table_ok(n_lp, page_len)) return (int)cudaErrorInvalidValue;
  return dispatch<true, true>(dtype, q, k, v, k_scale, v_scale, tbl, n_lp,
                              page_len, pos, out, B, H, S, n_lp * page_len, D,
                              scale, stream);
}
