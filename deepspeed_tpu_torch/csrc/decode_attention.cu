// Flash-decode attention over a per-row-frontier KV cache, for Hopper
// (sm_90a): one kernel body, four kernels, and the kernel that combines
// their partial results.
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
// The combine kernel's plain version is `combine_partials_reference`.
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
//     [P, H, page_len, D] arena, offset t % page_len. The logical plane is
//     n_lp * page_len keys long, and page 0 is the trash page that freed
//     rows and unmapped logical pages point at;
//   - what a stored key is. fp: T elements. int8: D codes plus one fp32
//     scale per key for k and one for v (scales [.., T] dense, [P, H,
//     page_len] paged, indexed by the same row as the codes). As the TPU
//     kernel does, k is dequantized to fp32 (codes x scale) for the scores,
//     and v to fp32 and then rounded to the output type.
// Only the addresses differ, and the work is cut along logical positions,
// so K5 on an arena performs the same arithmetic in the same order as K3 on
// the gathered plane, and K6 the same as K4: their results are equal bit
// for bit.
//
// Bound on an H100 SXM: memory, for all four. Each (b, h) must read its K
// and V rows up to the frontier once: 2 * D * sizeof(T) bytes per key for
// K3/K5 (256 in bf16), 2 * D + 8 for K4/K6 (136: int8 codes and two fp32
// scales), against 4 * S * D flops per key; at S <= 64 that is far below
// the 295 flops per byte the card needs before compute could be the limit.
// So the least time is those bytes over 3.35 TB/s, and the design is about
// keeping enough of those bytes in flight:
//   - split over the key length (flash-decoding) and over query rows: a
//     grid of (n_split * n_groups, H, B) CTAs, n_split = ceil(T /
//     kSplitKeys) from the plane length alone (no host read of pos), and
//     n_groups = ceil(S / kGroupRows) groups of up to 4 query rows. The CTA
//     of split s and row group g covers the logical keys [s * kSplitKeys,
//     (s + 1) * kSplitKeys) up to the frontier of the group's last row and
//     exits at once when its split starts past it. It writes its partial
//     result (running max m, sum l and the unnormalised fp32 accumulator,
//     per query row) to a workspace the wrapper allocates per call; a
//     second launch, one CTA per (b, h), merges each row's splits in split
//     order 0, 1, ... (never in arrival order), so the result is
//     deterministic. The combine is launched as the split kernel's
//     programmatic dependent (griddepcontrol), so its CTAs are resident and
//     have read pos when the partials are complete, and it loads the first
//     splits' partials in one round trip. Split length 128 was faster than
//     256 at the serving decode shape and in the prefill lane (PERF.md §6);
//   - the CTA's keys arrive at once: every 32-key tile of the split up to
//     the frontier is issued as its own cp.async group into shared memory,
//     in its stored type (bf16, fp32 or int8 codes, plus the two scales of
//     each key once per tile), and consumed as it lands; keys past the
//     frontier are zero-filled, never read. Elements are widened (and int8
//     dequantized) in registers while scoring; an int8 code becomes fp32
//     by a byte permute and an add (exact, and at full rate where the
//     conversion instruction runs at a quarter), and a pair of int8 values
//     is rounded to bf16 by one packed conversion. Rows are padded by 16
//     bytes so that the 32 lanes reading 32 key rows hit distinct banks;
//   - every warp works: the 4 warps of a CTA take the split's tiles in
//     turn (tile j to warp j % 4), each loads its own tiles and keeps its
//     own online-softmax state for each of the group's rows, and the CTA
//     merges the four states in shared memory, in warp order, before it
//     writes its partial. So the decode lane (S = 1) keeps all 4 warps
//     busy, and a prefill lane (S = 32) runs 8 row groups side by side
//     (each re-reads the split's keys, mostly from L2) rather than one CTA
//     working through 32 rows;
//   - paged addressing is resolved once per key: the CTA first turns the
//     block-table entries its split touches into one row offset per key
//     (t / page_len and t % page_len once per key, not per 16-byte load);
//   - within a tile, lane j scores key j from the key row it holds in
//     registers, for each of its query rows; the probabilities reach the
//     value product by shuffles, and lane j owns output columns 2j and
//     2j + 1. The scale is applied once, to q, as it is staged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kTileKeys = 32;  // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 64;  // query rows S per (b, h)
constexpr int kGroupRows = kWarps;  // query rows per CTA
// Keys per split (the CTA's share of a row), shared by all four kernels;
// the wrapper reads it through ds_decode_split_keys.
constexpr int kSplitKeys = 128;
constexpr int kSplitTiles = kSplitKeys / kTileKeys;
static_assert(kSplitTiles % kWarps == 0 && kSplitTiles / kWarps <= 8,
              "a split is whole rounds of tiles, a warp's at most 8 "
              "cp.async groups");
// A partial result per (split, b, h, row): acc[0..D), m, l.
constexpr int kPartial = kHeadDim + 2;
// Splits whose partials the combine loads in one round trip.
constexpr int kPrefetch = 16;

// Code j (0-3) of four int8 codes packed in w, as fp32, exactly: the code's
// byte with its sign flipped (code + 128) becomes the low byte of the
// mantissa of 2^23, and 2^23 + 128 is taken off. A byte permute and an add
// at full rate, where the int8-to-float conversion runs at a quarter.
template <int j>
__device__ __forceinline__ float code_to_float(uint32_t w) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u,
                                     0x7540 + j)) - 8388736.f;
}

// Up to n cp.async groups of this thread left in flight (n >= 0).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// Shared-memory layout of one CTA, for stored element type Elem.
template <typename Elem, bool kQ8>
struct Smem {
  static constexpr int kVec = 16 / sizeof(Elem);  // elements per 16 bytes
  static constexpr int kVecsPerRow = kHeadDim / kVec;
  // +16 bytes: lane j reads 16-byte pieces of key row j, and the padded
  // pitch puts the 8 lanes of each quarter-warp on distinct banks.
  static constexpr int kPitch = kHeadDim * sizeof(Elem) + 16;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kSplitKeys * kPitch;
  static constexpr int kKScale = kV + kSplitKeys * kPitch;
  static constexpr int kVScale = kKScale + (kQ8 ? 4 * kSplitKeys : 0);
  static constexpr int kRows = kVScale + (kQ8 ? 4 * kSplitKeys : 0);
  static constexpr int kMerge = kRows + 4 * kSplitKeys;
  static constexpr int kQ = kMerge + 4 * kWarps * kGroupRows * kPartial;
  static constexpr int kBytes = kQ + 4 * kGroupRows * kHeadDim;
};

// Output columns 2 lane and 2 lane + 1 of a stored value row, in fp32; int8
// codes dequantized (x vscale) and rounded to the output type T.
template <typename T, typename Elem>
__device__ __forceinline__ float2 value_pair(const unsigned char* row,
                                             int lane, float vscale) {
  if constexpr (std::is_same<Elem, int8_t>::value) {
    const uint32_t w = *reinterpret_cast<const uint16_t*>(row + 2 * lane);
    const float x0 = code_to_float<0>(w) * vscale;
    const float x1 = code_to_float<1>(w) * vscale;
    if constexpr (std::is_same<T, float>::value) {
      return make_float2(x0, x1);
    } else {  // both rounded to bf16 by one packed conversion
      return __bfloat1622float2(__floats2bfloat162_rn(x0, x1));
    }
  } else if constexpr (std::is_same<Elem, float>::value) {
    return *reinterpret_cast<const float2*>(row + 8 * lane);
  } else {
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(row + 4 * lane));
  }
}

// One (split, row group, h, b): the partial results of the split's keys for
// the group's query rows (up to kWarps). The warps share the keys (tile j to
// warp j % kWarps), each holding every row of the group, and merge their
// states in warp order. T: the type of q and out (and of the cached keys
// when not int8).
template <typename T, bool kQ8, bool kPaged>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const T* __restrict__ q, const void* __restrict__ k_,
                        const void* __restrict__ v_,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ tbl, int n_lp, int page_len,
                        const int* __restrict__ pos, float* __restrict__ work,
                        int B, int H, int S, int T_len, float scale) {
  using Elem = typename std::conditional<kQ8, int8_t, T>::type;
  using L = Smem<Elem, kQ8>;
  constexpr int kVec = L::kVec;
  constexpr int kVecsPerRow = L::kVecsPerRow;
  constexpr int kPitch = L::kPitch;
  const Elem* k = static_cast<const Elem*>(k_);
  const Elem* v = static_cast<const Elem*>(v_);

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* k_s = smem + L::kK;
  unsigned char* v_s = smem + L::kV;
  float* ks_s = reinterpret_cast<float*>(smem + L::kKScale);
  float* vs_s = reinterpret_cast<float*>(smem + L::kVScale);
  uint32_t* rows_s = reinterpret_cast<uint32_t*>(smem + L::kRows);
  float* merge_s = reinterpret_cast<float*>(smem + L::kMerge);
  float* q_s = reinterpret_cast<float*>(smem + L::kQ);

  // The combine's CTAs may be scheduled once every CTA here has started;
  // they wait for this grid's partials (griddepcontrol.wait).
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int n_groups = (S + kGroupRows - 1) / kGroupRows;
  const int split = blockIdx.x / n_groups;
  const int row0 = (blockIdx.x % n_groups) * kGroupRows;
  const int n_rows = min(kGroupRows, S - row0);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t bh = (size_t)b * H + h;

  const int pos_b = pos[b];
  // The group's last key: that of its last row.
  const int last_key = min(pos_b + row0 + n_rows - 1, T_len - 1);
  const int start = split * kSplitKeys;
  // Past the frontier: nothing to load, and the combine reads no partial
  // of this split for these rows. Split 0 always runs.
  if (split > 0 && start > last_key) return;
  const int n_keys = min(kSplitKeys, last_key + 1 - start);
  const int n_tiles = n_keys > 0 ? (n_keys + kTileKeys - 1) / kTileKeys : 0;

  // The cache row (of codes, and of scales) of each key the split loads.
  for (int t = threadIdx.x; t < n_keys; t += kThreads) {
    const int key = start + t;
    rows_s[t] = kPaged ? (uint32_t)(((size_t)tbl[(size_t)b * n_lp +
                                                 key / page_len] * H + h) *
                                        page_len + key % page_len)
                       : (uint32_t)(bh * T_len + key);
  }
  const T* qb = q + (bh * S + row0) * kHeadDim;
  for (int e = threadIdx.x; e < n_rows * kHeadDim; e += kThreads) {
    q_s[e] = to_float(qb[e]) * scale;
  }
  __syncthreads();

  // Each warp's tiles j = warp, warp + kWarps, ..., one cp.async group
  // each; keys past the frontier are zero-filled.
  int mine = 0;
  for (int j = warp; j < n_tiles; j += kWarps, ++mine) {
    for (int e = lane; e < kTileKeys * kVecsPerRow; e += 32) {
      const int t = j * kTileKeys + e / kVecsPerRow;
      const int c = e % kVecsPerRow;
      const bool live = t < n_keys;
      const size_t off =
          live ? (size_t)rows_s[t] * kHeadDim + c * kVec : 0;
      cp_async16(k_s + t * kPitch + 16 * c, k + off, live);
      cp_async16(v_s + t * kPitch + 16 * c, v + off, live);
    }
    if (kQ8) {
      const int t = j * kTileKeys + lane;
      const bool live = t < n_keys;
      const size_t row = live ? rows_s[t] : 0;
      cp_async4(ks_s + t, k_scale + row, live);
      cp_async4(vs_s + t, v_scale + row, live);
    }
    cp_async_commit();
  }

  float m[kGroupRows], l[kGroupRows], acc0[kGroupRows], acc1[kGroupRows];
#pragma unroll
  for (int r = 0; r < kGroupRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    acc0[r] = 0.f;
    acc1[r] = 0.f;
  }

  // Online softmax over this warp's tiles as they land, for each row.
  for (int j = warp, n = 0; j < n_tiles; j += kWarps, ++n) {
    cp_async_wait_upto(mine - 1 - n);
    __syncwarp();  // the warp's copies of tile j are visible to every lane
    const int t = j * kTileKeys + lane;
    const int key = start + t;
    uint4 kr[kVecsPerRow];
#pragma unroll
    for (int c = 0; c < kVecsPerRow; ++c) {
      kr[c] = reinterpret_cast<const uint4*>(k_s + t * kPitch)[c];
    }
    const float kscale = kQ8 ? ks_s[t] : 1.f;
#pragma unroll
    for (int r = 0; r < kGroupRows; ++r) {
      const int lim = min(pos_b + row0 + r, T_len - 1);  // the row's last key
      // Uniform across the warp; the tile's first key visible keeps the
      // running max finite.
      if (r >= n_rows || start + j * kTileKeys > lim) continue;
      const float4* qv = reinterpret_cast<const float4*>(q_s + r * kHeadDim);
      float sp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < kVecsPerRow; ++c) {
        const Elem* e = reinterpret_cast<const Elem*>(&kr[c]);
        const uint32_t* w = reinterpret_cast<const uint32_t*>(&kr[c]);
#pragma unroll
        for (int x = 0; x < kVec; x += 4) {
          const float4 qq = qv[(c * kVec + x) / 4];
          float kf[4];
          if constexpr (kQ8) {
            kf[0] = code_to_float<0>(w[x / 4]) * kscale;
            kf[1] = code_to_float<1>(w[x / 4]) * kscale;
            kf[2] = code_to_float<2>(w[x / 4]) * kscale;
            kf[3] = code_to_float<3>(w[x / 4]) * kscale;
          } else {
#pragma unroll
            for (int y = 0; y < 4; ++y) kf[y] = to_float(e[x + y]);
          }
          sp[0] += qq.x * kf[0];
          sp[1] += qq.y * kf[1];
          sp[2] += qq.z * kf[2];
          sp[3] += qq.w * kf[3];
        }
      }
      float s = (sp[0] + sp[1]) + (sp[2] + sp[3]);
      if (key > lim) s = -INFINITY;
      float tmax = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m[r], tmax);
      const float alpha = expf(m[r] - m_new);
      const float p = expf(s - m_new);
      float psum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
      float a0 = acc0[r] * alpha, a1 = acc1[r] * alpha;
      float b0 = 0.f, b1 = 0.f;
#pragma unroll
      for (int jj = 0; jj < kTileKeys; jj += 2) {
        const int t0 = j * kTileKeys + jj;
        const float p0 = __shfl_sync(0xffffffffu, p, jj);
        const float p1 = __shfl_sync(0xffffffffu, p, jj + 1);
        const float2 v0 = value_pair<T, Elem>(v_s + t0 * kPitch, lane,
                                              kQ8 ? vs_s[t0] : 1.f);
        const float2 v1 = value_pair<T, Elem>(v_s + (t0 + 1) * kPitch, lane,
                                              kQ8 ? vs_s[t0 + 1] : 1.f);
        a0 += p0 * v0.x;
        a1 += p0 * v0.y;
        b0 += p1 * v1.x;
        b1 += p1 * v1.y;
      }
      acc0[r] = a0 + b0;
      acc1[r] = a1 + b1;
    }
  }

  // One row's state (or partial) at dst: acc at columns 2 lane, 2 lane + 1,
  // then m and l.
  auto store_state = [&](float* dst, float m_, float l_, float a0, float a1) {
    *reinterpret_cast<float2*>(dst + 2 * lane) = make_float2(a0, a1);
    if (lane == 0) {
      *reinterpret_cast<float2*>(dst + kHeadDim) = make_float2(m_, l_);
    }
  };
#pragma unroll
  for (int r = 0; r < kGroupRows; ++r) {
    if (r < n_rows) {
      store_state(merge_s + (warp * kGroupRows + r) * kPartial, m[r], l[r],
                  acc0[r], acc1[r]);
    }
  }
  __syncthreads();
  if (warp < n_rows) {  // warp r merges row r, in warp order
    const int r = warp;
    float m_tot = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      m_tot = fmaxf(m_tot,
                    merge_s[(w * kGroupRows + r) * kPartial + kHeadDim]);
    }
    float l_tot = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* st = merge_s + (w * kGroupRows + r) * kPartial;
      const float mw = st[kHeadDim];
      const float wt = mw == -INFINITY ? 0.f : expf(mw - m_tot);
      l_tot += wt * st[kHeadDim + 1];
      a0 += wt * st[2 * lane];
      a1 += wt * st[2 * lane + 1];
    }
    store_state(
        work + ((((size_t)split * B + b) * H + h) * S + row0 + r) * kPartial,
        m_tot, l_tot, a0, a1);
  }
}

// One (h, b): out = the splits' partials merged in split order, over the
// splits that hold a key of the row (those starting at or before its last
// key; split 0 always; the split kernel ran them all). A warp per query row: lane s reads split s's m and
// l (all splits at once), lane j owns output columns 2j and 2j + 1; the
// first kPrefetch splits' columns are loaded together with them.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const float* __restrict__ work,
                          const int* __restrict__ pos, T* __restrict__ out,
                          int B, int H, int S, int T_len) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t bh = (size_t)b * H + h;
  const int pos_b = pos[b];
  // Launched as the split kernel's programmatic dependent, its CTAs may
  // start early (pos is the split kernel's input, complete before it ran):
  // wait here for the partials (a no-op otherwise).
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t stride = (size_t)B * H * S * kPartial;  // one split
  for (int i = warp; i < S; i += kWarps) {
    const float* p = work + (bh * S + i) * kPartial;
    const int n_valid = max(min(pos_b + i, T_len - 1), 0) / kSplitKeys + 1;
    // Issued together: (m, l) of the first 32 splits, one per lane, and
    // this lane's accumulator columns of the first kPrefetch splits.
    const float2 ml0 = lane < n_valid ? reinterpret_cast<const float2*>(
                                            p + lane * stride + kHeadDim)[0]
                                      : make_float2(-INFINITY, 0.f);
    float2 pre[kPrefetch];
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      if (j < n_valid) {
        pre[j] = *reinterpret_cast<const float2*>(p + j * stride + 2 * lane);
      }
    }
    float m = ml0.x;
    for (int s = 32 + lane; s < n_valid; s += 32) {
      m = fmaxf(m, p[s * stride + kHeadDim]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f, a0 = 0.f, a1 = 0.f;
    for (int s0 = 0; s0 < n_valid; s0 += 32) {
      const float2 ml =
          s0 == 0 ? ml0
                  : s0 + lane < n_valid
                        ? reinterpret_cast<const float2*>(
                              p + (s0 + lane) * stride + kHeadDim)[0]
                        : make_float2(-INFINITY, 0.f);
      const float w = ml.x == -INFINITY ? 0.f : expf(ml.x - m);
      const int n = min(32, n_valid - s0);
      int j = 0;
      if (s0 == 0) {
#pragma unroll
        for (; j < kPrefetch; ++j) {
          if (j < n) {
            const float wj = __shfl_sync(0xffffffffu, w, j);
            l += wj * __shfl_sync(0xffffffffu, ml.y, j);
            a0 += wj * pre[j].x;
            a1 += wj * pre[j].y;
          }
        }
      }
      for (; j < n; ++j) {
        const float wj = __shfl_sync(0xffffffffu, w, j);
        const float2 aj =
            *reinterpret_cast<const float2*>(p + (s0 + j) * stride + 2 * lane);
        l += wj * __shfl_sync(0xffffffffu, ml.y, j);
        a0 += wj * aj.x;
        a1 += wj * aj.y;
      }
    }
    T* o = out + (bh * S + i) * kHeadDim + 2 * lane;
    o[0] = from_float<T>(a0 / l);
    o[1] = from_float<T>(a1 / l);
  }
}

// after_split: launched right behind the split kernel on the same stream,
// as its programmatic dependent (Hopper), so the launch overlaps its tail.
// Alone it is launched plainly: it reads pos before it waits, and there pos
// may come from the kernel just before it.
template <typename T>
int launch_combine(const void* work, const void* pos, void* out, int B,
                   int H, int S, int T_len, cudaStream_t stream,
                   bool after_split) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = after_split ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, decode_combine_kernel<T>,
                                 static_cast<const float*>(work),
                                 static_cast<const int*>(pos),
                                 static_cast<T*>(out), B, H, S, T_len);
}

template <typename T, bool kQ8, bool kPaged>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* tbl, int n_lp, int page_len,
           const void* pos, void* work, void* out, int B, int H, int S,
           int T_len, float scale, void* stream_) {
  using Elem = typename std::conditional<kQ8, int8_t, T>::type;
  auto kernel = decode_split_kernel<T, kQ8, kPaged>;
  constexpr int smem = Smem<Elem, kQ8>::kBytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const auto stream = reinterpret_cast<cudaStream_t>(stream_);
  const int n_split = (T_len + kSplitKeys - 1) / kSplitKeys;
  const dim3 grid(n_split * ((S + kGroupRows - 1) / kGroupRows), H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), k, v, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tbl), n_lp,
      page_len, static_cast<const int*>(pos), static_cast<float*>(work), B,
      H, S, T_len, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_combine<T>(work, pos, out, B, H, S, T_len, stream, true);
}

bool shape_ok(int B, int H, int S, int T_len, int D) {
  return D == kHeadDim && S >= 1 && S <= kMaxRows && T_len >= 1 && B >= 1 &&
         H >= 1 && B <= 65535 && H <= 65535;
}

template <bool kQ8, bool kPaged>
int dispatch(int dtype, const void* q, const void* k, const void* v,
             const void* k_scale, const void* v_scale, const void* tbl,
             int n_lp, int page_len, const void* pos, void* work, void* out,
             int B, int H, int S, int T_len, int D, float scale,
             void* stream) {
  if (!shape_ok(B, H, S, T_len, D)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return launch<float, kQ8, kPaged>(q, k, v, k_scale, v_scale, tbl, n_lp,
                                      page_len, pos, work, out, B, H, S,
                                      T_len, scale, stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, kQ8, kPaged>(
        q, k, v, k_scale, v_scale, tbl, n_lp, page_len, pos, work, out, B,
        H, S, T_len, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

bool table_ok(int n_lp, int page_len) {
  return n_lp >= 1 && page_len >= 1 &&
         (long long)n_lp * page_len <= 0x7fffffffLL;
}

}  // namespace

// Plain C entry points, bound with ctypes. dtype (of q and out, and of k/v
// for K3/K5): 0 = float32, 1 = bfloat16. All tensors contiguous: q, out
// [B, H, S, D]; pos [B] int32; work fp32 [n_split, B, H, S, D + 2] with
// n_split = ceil(T / ds_decode_split_keys()) for a plane of T keys (T =
// n_lp * page_len paged), written by the split kernel and read by the
// combine. Each launches both kernels on `stream` and returns
// cudaGetLastError() (0 on success); shapes the kernels do not take return
// cudaErrorInvalidValue.

// Keys per split.
extern "C" int ds_decode_split_keys() { return kSplitKeys; }

// K3: k, v [B, H, T, D] of dtype.
extern "C" int ds_decode_attention(const void* q, const void* k,
                                   const void* v, const void* pos, void* work,
                                   void* out, int B, int H, int S, int T,
                                   int D, int dtype, float scale,
                                   void* stream) {
  return dispatch<false, false>(dtype, q, k, v, nullptr, nullptr, nullptr, 0,
                                0, pos, work, out, B, H, S, T, D, scale,
                                stream);
}

// K4: k, v [B, H, T, D] int8 codes; k_scale, v_scale [B, H, T] fp32.
extern "C" int ds_decode_attention_q8(const void* q, const void* k,
                                      const void* v, const void* k_scale,
                                      const void* v_scale, const void* pos,
                                      void* work, void* out, int B, int H,
                                      int S, int T, int D, int dtype,
                                      float scale, void* stream) {
  return dispatch<true, false>(dtype, q, k, v, k_scale, v_scale, nullptr, 0,
                               0, pos, work, out, B, H, S, T, D, scale,
                               stream);
}

// K5: k, v [P, H, page_len, D] of dtype; tbl [B, n_lp] int32.
extern "C" int ds_decode_attention_paged(const void* q, const void* k,
                                         const void* v, const void* tbl,
                                         const void* pos, void* work,
                                         void* out, int B, int H, int S,
                                         int n_lp, int page_len, int D,
                                         int dtype, float scale,
                                         void* stream) {
  if (!table_ok(n_lp, page_len)) return (int)cudaErrorInvalidValue;
  return dispatch<false, true>(dtype, q, k, v, nullptr, nullptr, tbl, n_lp,
                               page_len, pos, work, out, B, H, S,
                               n_lp * page_len, D, scale, stream);
}

// K6: k, v [P, H, page_len, D] int8 codes; k_scale, v_scale [P, H,
// page_len] fp32; tbl [B, n_lp] int32.
extern "C" int ds_decode_attention_paged_q8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* tbl, const void* pos, void* work,
    void* out, int B, int H, int S, int n_lp, int page_len, int D, int dtype,
    float scale, void* stream) {
  if (!table_ok(n_lp, page_len)) return (int)cudaErrorInvalidValue;
  return dispatch<true, true>(dtype, q, k, v, k_scale, v_scale, tbl, n_lp,
                              page_len, pos, work, out, B, H, S,
                              n_lp * page_len, D, scale, stream);
}

// The combine kernel alone, over partials laid out as above (the split
// kernel's, or any others): out [B, H, S, D] of dtype.
extern "C" int ds_decode_combine(const void* work, const void* pos,
                                 void* out, int B, int H, int S, int T,
                                 int D, int dtype, void* stream) {
  if (!shape_ok(B, H, S, T, D)) return (int)cudaErrorInvalidValue;
  const auto st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_combine<float>(work, pos, out, B, H, S, T, st, false);
  }
  if (dtype == 1) {
    return launch_combine<__nv_bfloat16>(work, pos, out, B, H, S, T, st,
                                         false);
  }
  return (int)cudaErrorInvalidValue;
}
