// Row kernels of the fused transformer layer, for Hopper (sm_90a):
// LayerNorm (K8), scale + mask + softmax over attention scores (K9),
// dropout forward (K10a) and backward (K10b), bias + GELU (K11).
//
// Replace the TPU kernels (deepspeed_tpu/ops/transformer/kernels/):
//   K8   layer_norm.py `_ln_fwd_kernel` (launched by `_ln_fwd`);
//   K9   softmax.py `_softmax_kernel` (launched by `_softmax_fwd`);
//   K10a dropout.py `_dropout_kernel` (launched by `_dropout_fwd`);
//   K10b dropout.py `_mask_kernel` (launched by `_regen_mask_tpu`), here
//        fused with the product it feeds: dx = g * keep * scale;
//   K11  gelu.py `_bias_gelu_kernel` (launched by `_bias_gelu_fwd`).
// Their plain PyTorch versions, which these are held against on the card,
// are `ln_fwd_reference`, `attn_softmax_reference`, `dropout_reference` /
// `dropout_bwd_reference` and `bias_gelu_reference` in
// deepspeed_tpu_torch/ops/transformer/kernels/.
//
// Bound on an H100 SXM: memory. Each kernel reads its inputs once and
// writes its outputs once, doing a few tens of operations per element
// (Philox's ten rounds per four elements for the dropout), far below the
// card's ~20 fp32 operations per byte. So the least time is the bytes over
// 3.35 TB/s, and the design only has to stream:
//   - 16-byte vector loads and stores everywhere (8 bf16/fp16 or 4 fp32);
//     the fp32 vectors (gamma, beta, bias) load as float4;
//   - all arithmetic in fp32, one rounding to the output type at the end;
//   - K8: one warp per row, the row held in registers between the two
//     passes (mean, then the mean of squared deviations: the variance is
//     two-pass as in the TPU kernel), so x is read once; mu and rstd are
//     written for the backward;
//   - K9: each score read once, each probability written once (at
//     BERT-large's [16, 16, 512, 512] bf16 scores, 268 MB: 0.080 ms). A row
//     of up to 2048 16-bit or 1024 fp32 keys, a whole number of 16-byte
//     vectors, is one warp's, held in registers between the max, the sum
//     and the store; a longer or ragged row (any T_k up to kSoftmaxMaxKeys)
//     is one CTA's, staged once in shared memory as fp32 scores. The
//     arithmetic is the plain version's: fp32 s * scale, + mask, the causal
//     `where` to -1e30, exp(s - max), products and sums rounded apart
//     (__fmul_rn / __fadd_rn: no FMA contraction); the division by the sum
//     is a product with its reciprocal (within an fp32 ulp of it: one
//     instruction, not a dozen, per element);
//   - K10a/K10b: the mask is a counter-based function of (seed, flat
//     element index): Philox-4x32-10 with key (seed low, seed high) and
//     counter (index / 4 as a 64-bit pair, 0, 0), whose four outputs are the
//     bits of elements 4i .. 4i+3. An element is kept when its bits >=
//     threshold = rate * 2^32. The backward regenerates the mask inside the
//     gradient pass and nothing is stored. The mask depends on neither the
//     block size nor the tiling. The products and sums use __fmul_rn /
//     __fadd_rn (never contracted into an FMA), so the output equals the
//     plain version's fp32 arithmetic bit for bit.
// Simple kernels, right first: no persistent blocks, no TMA.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);  // elements in 16 bytes
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// One 16-byte vector of T, widened to fp32.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < Vec<T>::n; ++j) out[j] = to_f(e[j]);
}

// N fp32 values (N a multiple of 4, p 16-byte aligned) as float4 loads.
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float4 v = reinterpret_cast<const float4*>(p)[j];
    out[4 * j] = v.x;
    out[4 * j + 1] = v.y;
    out[4 * j + 2] = v.z;
    out[4 * j + 3] = v.w;
  }
}

// Round to T and store as one 16-byte vector.
template <typename T>
__device__ __forceinline__ void store16(T* p, const float* in) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < Vec<T>::n; ++j) e[j] = from_f<T>(in[j]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------------ K8

constexpr int kLnWarps = 4;  // rows per block: one warp each

// o = LN(x [+ bias] [+ res]) * gamma + beta, with mu and rstd per row.
// kVecs: 16-byte vectors per lane, enough for the row (cols <= 32 * kVecs
// * VN); lane l holds vectors l, l + 32, ... of its row.
template <typename T, int kVecs>
__global__ void __launch_bounds__(kLnWarps * 32)
    layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                      const float* __restrict__ bias,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ out,
                      float* __restrict__ mu_out, float* __restrict__ rstd_out,
                      int rows, int cols, float eps) {
  constexpr int VN = Vec<T>::n;
  const int row = blockIdx.x * kLnWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // uniform across the warp
  const int nvec = cols / VN;
  const size_t base = (size_t)row * cols;
  const float n = (float)cols;

  float z[kVecs][VN];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int v = lane + i * 32;
    if (v < nvec) {
      const int c = v * VN;
      load16(x + base + c, z[i]);
      if (bias != nullptr) {  // same order as the TPU kernel: x + bias + res
        float b[VN];
        load_f32<VN>(bias + c, b);
#pragma unroll
        for (int j = 0; j < VN; ++j) z[i][j] += b[j];
      }
      if (res != nullptr) {
        float r[VN];
        load16(res + base + c, r);
#pragma unroll
        for (int j = 0; j < VN; ++j) z[i][j] += r[j];
      }
#pragma unroll
      for (int j = 0; j < VN; ++j) sum += z[i][j];
    }
  }
  const float mu = warp_sum(sum) / n;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (lane + i * 32 < nvec) {
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        const float d = z[i][j] - mu;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / n + eps);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int v = lane + i * 32;
    if (v < nvec) {
      const int c = v * VN;
      float g[VN], b[VN];
      load_f32<VN>(gamma + c, g);
      load_f32<VN>(beta + c, b);
#pragma unroll
      for (int j = 0; j < VN; ++j) z[i][j] = (z[i][j] - mu) * rstd * g[j] + b[j];
      store16(out + base + c, z[i]);
    }
  }
  if (lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

template <typename T>
int launch_layer_norm(const void* x, const void* res, const void* bias,
                      const void* gamma, const void* beta, void* out, void* mu,
                      void* rstd, int rows, int cols, float eps,
                      cudaStream_t st) {
  const int per_lane = (cols / Vec<T>::n + 31) / 32;
  const dim3 grid((rows + kLnWarps - 1) / kLnWarps);
  const dim3 block(kLnWarps * 32);
#define DS_LN(K)                                                             \
  layer_norm_kernel<T, K><<<grid, block, 0, st>>>(                           \
      static_cast<const T*>(x), static_cast<const T*>(res),                  \
      static_cast<const float*>(bias), static_cast<const float*>(gamma),     \
      static_cast<const float*>(beta), static_cast<T*>(out),                 \
      static_cast<float*>(mu), static_cast<float*>(rstd), rows, cols, eps)
  if (per_lane <= 1) {
    DS_LN(1);
  } else if (per_lane <= 2) {
    DS_LN(2);
  } else if (per_lane <= 4) {
    DS_LN(4);
  } else if (per_lane <= 8) {
    DS_LN(8);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef DS_LN
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K9

constexpr int kSmWarps = 4;            // rows per block on the warp path
constexpr int kSmRowThreads = 256;     // threads per row on the CTA path
constexpr int kSmWarpVecs = 8;         // vectors per lane on the warp path
constexpr int kSoftmaxMaxKeys = 32768; // the CTA path's fp32 row: 128 KB
constexpr float kSmNegInf = -1e30f;    // the JAX package's NEG_INF

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The masked, scaled score of key `key` (already widened to fp32): x *
// scale, plus the row's additive mask value m, then the causal cut, as the
// TPU kernel orders them.
__device__ __forceinline__ float sm_score(float x, bool masked, float m,
                                          int key, int query, float scale,
                                          int causal) {
  x = __fmul_rn(x, scale);
  if (masked) x = __fadd_rn(x, m);
  if (causal && key > query) x = kSmNegInf;
  return x;
}

// One warp per row of Tk = nvec 16-byte vectors (nvec <= 32 * kVecs); lane
// l holds vectors l, l + 32, ... of its row.
template <typename T, int kVecs>
__global__ void __launch_bounds__(kSmWarps * 32)
    softmax_warp_kernel(const T* __restrict__ s, const float* __restrict__ mask,
                        T* __restrict__ out, long long rows, int HTq, int Tq,
                        int Tk, float scale, int causal) {
  constexpr int VN = Vec<T>::n;
  const long long row = (long long)blockIdx.x * kSmWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // uniform across the warp
  const int nvec = Tk / VN;
  const int query = (int)(row % Tq);
  const float* mrow =
      mask != nullptr ? mask + (size_t)(row / HTq) * Tk : nullptr;
  const size_t base = (size_t)row * Tk;
  float x[kVecs][VN];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int v = lane + i * 32;
    if (v < nvec) {
      load16(s + base + v * VN, x[i]);
      float mv[VN];  // the mask's VN values: float4 loads (Tk % VN == 0)
      if (mrow != nullptr) load_f32<VN>(mrow + v * VN, mv);
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        x[i][j] = sm_score(x[i][j], mrow != nullptr, mv[j], v * VN + j,
                           query, scale, causal);
        mx = fmaxf(mx, x[i][j]);
      }
    }
  }
  mx = warp_max(mx);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (lane + i * 32 < nvec) {
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        x[i][j] = expf(x[i][j] - mx);
        sum += x[i][j];
      }
    }
  }
  const float inv = __frcp_rn(warp_sum(sum));
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int v = lane + i * 32;
    if (v < nvec) {
#pragma unroll
      for (int j = 0; j < VN; ++j) x[i][j] = __fmul_rn(x[i][j], inv);
      store16(out + base + v * VN, x[i]);
    }
  }
}

// The block's reduction of one value per thread (max or sum); every thread
// gets the result. red holds kSmRowThreads / 32 floats.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red is free (an earlier reduction has been read)
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kSmRowThreads / 32 ? red[lane] : (kMax ? -INFINITY : 0.f);
  return kMax ? warp_max(v) : warp_sum(v);
}

// One CTA per row of any Tk <= kSoftmaxMaxKeys: the row's scores staged in
// shared memory as fp32 (read from device memory once), then the max, the
// exponentials in place, the sum, the store. kVec: 16-byte loads and
// stores (Tk a whole number of vectors), else one element per access.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kSmRowThreads)
    softmax_row_kernel(const T* __restrict__ s, const float* __restrict__ mask,
                       T* __restrict__ out, int HTq, int Tq, int Tk,
                       float scale, int causal) {
  extern __shared__ float row_s[];  // [Tk]
  __shared__ float red[kSmRowThreads / 32];
  constexpr int VN = kVec ? Vec<T>::n : 1;
  const long long row = blockIdx.x;
  const int query = (int)(row % Tq);
  const float* mrow =
      mask != nullptr ? mask + (size_t)(row / HTq) * Tk : nullptr;
  const size_t base = (size_t)row * Tk;
  float mx = -INFINITY;
  for (int c = threadIdx.x * VN; c < Tk; c += kSmRowThreads * VN) {
    float x[VN];
    if (kVec) {
      load16(s + base + c, x);
    } else {
      x[0] = to_f(s[base + c]);
    }
#pragma unroll
    for (int j = 0; j < VN; ++j) {
      const float mv = mrow != nullptr ? mrow[c + j] : 0.f;
      x[j] = sm_score(x[j], mrow != nullptr, mv, c + j, query, scale, causal);
      mx = fmaxf(mx, x[j]);
      row_s[c + j] = x[j];
    }
  }
  mx = block_reduce<true>(mx, red);
  float sum = 0.f;
  for (int c = threadIdx.x * VN; c < Tk; c += kSmRowThreads * VN) {
#pragma unroll
    for (int j = 0; j < VN; ++j) {
      const float e = expf(row_s[c + j] - mx);
      row_s[c + j] = e;
      sum += e;
    }
  }
  const float inv = __frcp_rn(block_reduce<false>(sum, red));
  for (int c = threadIdx.x * VN; c < Tk; c += kSmRowThreads * VN) {
    float x[VN];
#pragma unroll
    for (int j = 0; j < VN; ++j) x[j] = __fmul_rn(row_s[c + j], inv);
    if (kVec) {
      store16(out + base + c, x);
    } else {
      out[base + c] = from_f<T>(x[0]);
    }
  }
}

template <typename T>
int softmax_impl(const void* s, const void* mask, void* out, int B, int H,
                 int Tq, int Tk, float scale, int causal, cudaStream_t st) {
  constexpr int VN = Vec<T>::n;
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || Tk > kSoftmaxMaxKeys)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H * Tq;
  const bool vec = Tk % VN == 0;
  const int per_lane = (Tk / VN + 31) / 32;
  const T* sp = static_cast<const T*>(s);
  const float* mp = static_cast<const float*>(mask);
  T* op = static_cast<T*>(out);
  if (vec && per_lane <= kSmWarpVecs) {
    const long long blocks = (rows + kSmWarps - 1) / kSmWarps;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
#define DS_SM(K)                                                          \
  softmax_warp_kernel<T, K><<<(unsigned)blocks, kSmWarps * 32, 0, st>>>( \
      sp, mp, op, rows, H * Tq, Tq, Tk, scale, causal)
    if (per_lane <= 1) {
      DS_SM(1);
    } else if (per_lane <= 2) {
      DS_SM(2);
    } else if (per_lane <= 4) {
      DS_SM(4);
    } else {
      DS_SM(8);
    }
#undef DS_SM
    return (int)cudaGetLastError();
  }
  if (rows > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)Tk * sizeof(float);
  auto kernel =
      vec ? softmax_row_kernel<T, true> : softmax_row_kernel<T, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)rows, kSmRowThreads, smem, st>>>(sp, mp, op, H * Tq, Tq,
                                                      Tk, scale, causal);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- K11

constexpr int kEltThreads = 256;

__device__ __forceinline__ float gelu_tanh(float z) {
  const float u = 0.7978845608028654f * (z + 0.044715f * (z * z * z));
  return 0.5f * z * (1.f + tanhf(u));
}

// out = gelu_tanh(x + bias[col]): one 16-byte vector per thread (a vector
// never straddles two rows: cols is a multiple of VN).
template <typename T>
__global__ void __launch_bounds__(kEltThreads)
    bias_gelu_kernel(const T* __restrict__ x, const float* __restrict__ bias,
                     T* __restrict__ out, size_t n_vec, int cols) {
  constexpr int VN = Vec<T>::n;
  const size_t i = (size_t)blockIdx.x * kEltThreads + threadIdx.x;
  if (i >= n_vec) return;
  const size_t e = i * VN;
  float v[VN], b[VN];
  load16(x + e, v);
  load_f32<VN>(bias + (int)(e % (size_t)cols), b);
#pragma unroll
  for (int j = 0; j < VN; ++j) v[j] = gelu_tanh(v[j] + b[j]);
  store16(out + e, v);
}

// ------------------------------------------------------------ K10a/b

// Philox-4x32-10 (Salmon et al., SC 2011) of counter (c0, c1, 0, 0) under
// key (k0, k1).
__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t c1, uint32_t k0,
                                        uint32_t k1) {
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// v[j] = (v[j] * keep) * scale for the VN elements from flat index e (a
// multiple of VN, so of 4), keep = bits >= threshold.
template <int VN>
__device__ __forceinline__ void apply_mask(float* v, size_t e,
                                           uint32_t threshold, float scale,
                                           uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int q = 0; q < VN / 4; ++q) {
    const unsigned long long group = (unsigned long long)(e >> 2) + q;
    const uint4 bits = philox((uint32_t)group, (uint32_t)(group >> 32), k0, k1);
    const uint32_t b[4] = {bits.x, bits.y, bits.z, bits.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float keep = b[t] >= threshold ? 1.f : 0.f;
      v[4 * q + t] = __fmul_rn(__fmul_rn(v[4 * q + t], keep), scale);
    }
  }
}

// K10a: out = ((x [+ bias]) * keep) * scale [+ res].
template <typename T>
__global__ void __launch_bounds__(kEltThreads)
    dropout_fwd_kernel(const T* __restrict__ x, const float* __restrict__ bias,
                       const T* __restrict__ res, T* __restrict__ out,
                       size_t n_vec, int cols, uint32_t threshold, float scale,
                       uint32_t k0, uint32_t k1) {
  constexpr int VN = Vec<T>::n;
  const size_t i = (size_t)blockIdx.x * kEltThreads + threadIdx.x;
  if (i >= n_vec) return;
  const size_t e = i * VN;
  float v[VN];
  load16(x + e, v);
  if (bias != nullptr) {
    float b[VN];
    load_f32<VN>(bias + (int)(e % (size_t)cols), b);
#pragma unroll
    for (int j = 0; j < VN; ++j) v[j] = __fadd_rn(v[j], b[j]);
  }
  apply_mask<VN>(v, e, threshold, scale, k0, k1);
  if (res != nullptr) {
    float r[VN];
    load16(res + e, r);
#pragma unroll
    for (int j = 0; j < VN; ++j) v[j] = __fadd_rn(v[j], r[j]);
  }
  store16(out + e, v);
}

// K10b: dx = (g * keep) * scale, the forward's mask regenerated.
template <typename T>
__global__ void __launch_bounds__(kEltThreads)
    dropout_bwd_kernel(const T* __restrict__ g, T* __restrict__ dx,
                       size_t n_vec, uint32_t threshold, float scale,
                       uint32_t k0, uint32_t k1) {
  constexpr int VN = Vec<T>::n;
  const size_t i = (size_t)blockIdx.x * kEltThreads + threadIdx.x;
  if (i >= n_vec) return;
  const size_t e = i * VN;
  float v[VN];
  load16(g + e, v);
  apply_mask<VN>(v, e, threshold, scale, k0, k1);
  store16(dx + e, v);
}

// Elementwise launches: n elements, every row of `cols` a whole number of
// 16-byte vectors.
template <typename T>
bool elt_shape_ok(long long n, int cols) {
  return n > 0 && cols > 0 && cols % Vec<T>::n == 0 && n % cols == 0 &&
         (n / Vec<T>::n + kEltThreads - 1) / kEltThreads < 2147483647LL;
}

template <typename T>
dim3 elt_grid(long long n) {
  return dim3((unsigned)((n / Vec<T>::n + kEltThreads - 1) / kEltThreads));
}

template <typename T>
int layer_norm_impl(const void* x, const void* res, const void* bias,
                    const void* gamma, const void* beta, void* out, void* mu,
                    void* rstd, int rows, int cols, float eps,
                    cudaStream_t st) {
  if (rows < 1 || cols < 1 || cols % Vec<T>::n != 0) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_layer_norm<T>(x, res, bias, gamma, beta, out, mu, rstd, rows,
                              cols, eps, st);
}

template <typename T>
int bias_gelu_impl(const void* x, const void* bias, void* out, long long n,
                   int cols, cudaStream_t st) {
  if (!elt_shape_ok<T>(n, cols)) return (int)cudaErrorInvalidValue;
  bias_gelu_kernel<T><<<elt_grid<T>(n), kEltThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(bias),
      static_cast<T*>(out), (size_t)(n / Vec<T>::n), cols);
  return (int)cudaGetLastError();
}

template <typename T>
int dropout_fwd_impl(const void* x, const void* bias, const void* res,
                     void* out, long long n, int cols, uint32_t threshold,
                     float scale, uint32_t k0, uint32_t k1, cudaStream_t st) {
  if (!elt_shape_ok<T>(n, cols)) return (int)cudaErrorInvalidValue;
  dropout_fwd_kernel<T><<<elt_grid<T>(n), kEltThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(bias),
      static_cast<const T*>(res), static_cast<T*>(out),
      (size_t)(n / Vec<T>::n), cols, threshold, scale, k0, k1);
  return (int)cudaGetLastError();
}

template <typename T>
int dropout_bwd_impl(const void* g, void* dx, long long n, uint32_t threshold,
                     float scale, uint32_t k0, uint32_t k1, cudaStream_t st) {
  if (!elt_shape_ok<T>(n, Vec<T>::n)) return (int)cudaErrorInvalidValue;
  dropout_bwd_kernel<T><<<elt_grid<T>(n), kEltThreads, 0, st>>>(
      static_cast<const T*>(g), static_cast<T*>(dx), (size_t)(n / Vec<T>::n),
      threshold, scale, k0, k1);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes. dtype: 0 = float32, 1 = bfloat16,
// 2 = float16. Tensors contiguous and 16-byte aligned; x-typed tensors are
// of `dtype`; gamma, beta, bias and the statistics are float32; optional
// pointers may be null. Each launches on `stream` and returns
// cudaGetLastError() (0 on success); a shape or dtype the kernel does not
// take returns cudaErrorInvalidValue without launching.

// K8: x, res, out [rows, cols]; bias, gamma, beta [cols]; mu, rstd [rows].
// cols a multiple of 16 bytes, at most 1024 (fp32) or 2048 (16-bit types).
extern "C" int ds_layer_norm_fwd(const void* x, const void* res,
                                 const void* bias, const void* gamma,
                                 const void* beta, void* out, void* mu,
                                 void* rstd, int rows, int cols, int dtype,
                                 float eps, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return layer_norm_impl<float>(x, res, bias, gamma, beta, out, mu, rstd,
                                    rows, cols, eps, st);
    case 1:
      return layer_norm_impl<__nv_bfloat16>(x, res, bias, gamma, beta, out, mu,
                                            rstd, rows, cols, eps, st);
    case 2:
      return layer_norm_impl<__half>(x, res, bias, gamma, beta, out, mu, rstd,
                                     rows, cols, eps, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K9: s, out [B, H, Tq, Tk] of `dtype`; mask [B, Tk] fp32 or null;
// causal (0/1) cuts key > query to -1e30. Any Tk from 1 to 32768.
extern "C" int ds_attn_softmax_fwd(const void* s, const void* mask, void* out,
                                   int B, int H, int Tq, int Tk, int dtype,
                                   float scale, int causal, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return softmax_impl<float>(s, mask, out, B, H, Tq, Tk, scale, causal,
                                 st);
    case 1:
      return softmax_impl<__nv_bfloat16>(s, mask, out, B, H, Tq, Tk, scale,
                                         causal, st);
    case 2:
      return softmax_impl<__half>(s, mask, out, B, H, Tq, Tk, scale, causal,
                                  st);
  }
  return (int)cudaErrorInvalidValue;
}

// K11: x, out with n elements in rows of `cols`; bias [cols].
extern "C" int ds_bias_gelu_fwd(const void* x, const void* bias, void* out,
                                long long n, int cols, int dtype,
                                void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return bias_gelu_impl<float>(x, bias, out, n, cols, st);
    case 1:
      return bias_gelu_impl<__nv_bfloat16>(x, bias, out, n, cols, st);
    case 2:
      return bias_gelu_impl<__half>(x, bias, out, n, cols, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K10a: x, res, out with n elements in rows of `cols`; bias [cols]; the
// seed as (k0 low word, k1 high word); keep when bits >= threshold.
extern "C" int ds_dropout_fwd(const void* x, const void* bias, const void* res,
                              void* out, long long n, int cols, int dtype,
                              unsigned threshold, float scale, unsigned k0,
                              unsigned k1, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dropout_fwd_impl<float>(x, bias, res, out, n, cols, threshold,
                                     scale, k0, k1, st);
    case 1:
      return dropout_fwd_impl<__nv_bfloat16>(x, bias, res, out, n, cols,
                                             threshold, scale, k0, k1, st);
    case 2:
      return dropout_fwd_impl<__half>(x, bias, res, out, n, cols, threshold,
                                      scale, k0, k1, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K10b: g, dx with n elements (a multiple of 16 bytes).
extern "C" int ds_dropout_bwd(const void* g, void* dx, long long n, int dtype,
                              unsigned threshold, float scale, unsigned k0,
                              unsigned k1, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dropout_bwd_impl<float>(g, dx, n, threshold, scale, k0, k1, st);
    case 1:
      return dropout_bwd_impl<__nv_bfloat16>(g, dx, n, threshold, scale, k0,
                                             k1, st);
    case 2:
      return dropout_bwd_impl<__half>(g, dx, n, threshold, scale, k0, k1, st);
  }
  return (int)cudaErrorInvalidValue;
}
