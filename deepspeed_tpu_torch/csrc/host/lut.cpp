// Block-sparse layout -> lookup tables, for the block-sparse attention
// kernels K7a/K7b of deepspeed_tpu_torch (csrc/sparse_attention.cu).
//
// A SparsityConfig layout is [h, nb, nb] 0/1 per (query block, key block).
// The kernels walk per-row tables instead of the layout: fwd_lut[h][i]
// lists the key blocks of query block i, bwd_lut[h][j] the query blocks of
// key block j (the layout's transpose), each row padded with -1 to the
// largest row degree. ops/sparse_attention/kernels.py lowers every layout
// through these two functions (its numpy `build_luts_reference` is the
// same function, kept for the tests). One OpenMP pass per direction; at
// h=16, nb=512 a pass reads some four million cells.
//
// A plain C ABI, loaded with ctypes (op_builder/builder.py, the host
// route), which releases the GIL for the call.

#include <cstdint>

extern "C" {

// The largest row degree of an [h, rows, cols] 0/1 layout (transpose=1
// counts columns, the rows of the transpose). At least 1, so a caller can
// always allocate a non-empty table.
long ds_lut_max_degree(long h,
                       long rows,
                       long cols,
                       const int32_t* __restrict__ layout,
                       int transpose) {
    long outer = transpose ? cols : rows;
    long inner = transpose ? rows : cols;
    long max_deg = 1;
#pragma omp parallel for reduction(max : max_deg) collapse(2) schedule(static)
    for (long hi = 0; hi < h; ++hi) {
        for (long r = 0; r < outer; ++r) {
            const int32_t* base = layout + hi * rows * cols;
            long deg = 0;
            for (long c = 0; c < inner; ++c) {
                int32_t bit = transpose ? base[c * cols + r] : base[r * cols + c];
                deg += (bit != 0);
            }
            if (deg > max_deg) max_deg = deg;
        }
    }
    return max_deg;
}

// Fill out[h, outer, deg] (int32, row-major) with each (head, row)'s
// active inner indices in increasing order, padded with -1. `deg` must be
// at least ds_lut_max_degree of the same (layout, transpose).
void ds_build_lut(long h,
                  long rows,
                  long cols,
                  const int32_t* __restrict__ layout,
                  int transpose,
                  long deg,
                  int32_t* __restrict__ out) {
    long outer = transpose ? cols : rows;
    long inner = transpose ? rows : cols;
#pragma omp parallel for collapse(2) schedule(static)
    for (long hi = 0; hi < h; ++hi) {
        for (long r = 0; r < outer; ++r) {
            const int32_t* base = layout + hi * rows * cols;
            int32_t* row_out = out + (hi * outer + r) * deg;
            long k = 0;
            for (long c = 0; c < inner; ++c) {
                int32_t bit = transpose ? base[c * cols + r] : base[r * cols + c];
                if (bit != 0 && k < deg) row_out[k++] = (int32_t)c;
            }
            for (; k < deg; ++k) row_out[k] = -1;
        }
    }
}

}  // extern "C"
