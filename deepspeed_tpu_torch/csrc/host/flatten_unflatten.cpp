// Flatten/unflatten of fp32 spans for the host side of ZeRO-Offload: the
// engine packs per-tensor arrays into the flat master / moment buffers with
// one OpenMP pass (and scatters them back for checkpoints) instead of a
// Python loop of copies. A plain C ABI loaded with ctypes
// (op_builder/builder.py, the host route).

#include <cstring>

extern "C" {

// Concatenate `count` spans into dst. sizes[i] = element count of srcs[i].
void ds_flatten(const float* const* srcs,
                const long* sizes,
                int count,
                float* __restrict__ dst) {
#pragma omp parallel for schedule(dynamic)
    for (int i = 0; i < count; ++i) {
        long off = 0;
        for (int j = 0; j < i; ++j) off += sizes[j];
        std::memcpy(dst + off, srcs[i], (size_t)sizes[i] * sizeof(float));
    }
}

// Scatter a flat buffer back into `count` spans.
void ds_unflatten(float* const* dsts,
                  const long* sizes,
                  int count,
                  const float* __restrict__ src) {
#pragma omp parallel for schedule(dynamic)
    for (int i = 0; i < count; ++i) {
        long off = 0;
        for (int j = 0; j < i; ++j) off += sizes[j];
        std::memcpy(dsts[i], src + off, (size_t)sizes[i] * sizeof(float));
    }
}

}  // extern "C"
