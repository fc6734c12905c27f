// Host Adam/AdamW for the ZeRO-Offload tier of deepspeed_tpu_torch.
//
// The fp32 master weights and both Adam moments live in host memory as one
// flat buffer each; the engine hands this op ~16 MB chunks of them while
// the next chunk's gradients are still coming down from the card. The loop
// is plain C++ under `#pragma omp parallel for` / -O3 -march=native: the
// compiler emits the AVX FMA sequences. A plain C ABI, loaded with ctypes
// (op_builder/builder.py, the host route), which releases the GIL for the
// call.
//
// The `_copy` variant writes the updated parameters, rounded to bf16, into
// a second (pinned) buffer in the same pass: the engine copies that buffer
// to the card's bf16 parameters.
//
// The arithmetic is kept identical, line for line, to the JAX package's
// host Adam, so the two packages update a master bit for bit alike.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// One Adam step over a contiguous fp32 span. All buffers length n; p/m/v
// updated in place.
void ds_adam_step(long step,
                  float lr,
                  float beta1,
                  float beta2,
                  float eps,
                  float weight_decay,
                  int adamw_mode,
                  int bias_correction,
                  long n,
                  float* __restrict__ p,
                  const float* __restrict__ g,
                  float* __restrict__ m,
                  float* __restrict__ v) {
    float bc1 = 1.0f, bc2_sqrt = 1.0f;
    if (bias_correction) {
        bc1 = 1.0f - std::pow(beta1, (float)step);
        bc2_sqrt = std::sqrt(1.0f - std::pow(beta2, (float)step));
    }
    // Fold the bias corrections into a single step size and denom scale the
    // way DeepSpeed's CPU Adam does.
    const float step_size = lr / bc1;
    const float omb1 = 1.0f - beta1;
    const float omb2 = 1.0f - beta2;

#pragma omp parallel for schedule(static)
    for (long i = 0; i < n; ++i) {
        float grad = g[i];
        if (!adamw_mode && weight_decay > 0.0f) grad += weight_decay * p[i];
        float mi = beta1 * m[i] + omb1 * grad;
        float vi = beta2 * v[i] + omb2 * grad * grad;
        float denom = std::sqrt(vi) / bc2_sqrt + eps;
        // Decoupled (AdamW) decay scales by lr, not the bias-corrected step
        // size; folding it into `update` would multiply it by 1/bc1.
        float pi = p[i];
        if (adamw_mode && weight_decay > 0.0f) pi -= lr * weight_decay * pi;
        p[i] = pi - step_size * (mi / denom);
        m[i] = mi;
        v[i] = vi;
    }
}

// Round-to-nearest-even fp32 -> bf16 (upper 16 bits).
static inline uint16_t float_to_bf16(float f) {
    uint32_t bits;
    std::memcpy(&bits, &f, sizeof(bits));
    // NaN first: the rounding add below can carry a low-mantissa NaN payload
    // out of the mantissa, yielding +/-Inf instead of NaN.
    if ((bits & 0x7fffffffu) > 0x7f800000u) {
        return (uint16_t)((bits >> 16) | 0x0040u);  // quiet NaN, keep sign
    }
    uint32_t lsb = (bits >> 16) & 1u;
    bits += 0x7fffu + lsb;
    return (uint16_t)(bits >> 16);
}

// Adam step + fused bf16 downcast of the updated params into out_bf16.
void ds_adam_step_copy_bf16(long step,
                            float lr,
                            float beta1,
                            float beta2,
                            float eps,
                            float weight_decay,
                            int adamw_mode,
                            int bias_correction,
                            long n,
                            float* __restrict__ p,
                            const float* __restrict__ g,
                            float* __restrict__ m,
                            float* __restrict__ v,
                            uint16_t* __restrict__ out_bf16) {
    float bc1 = 1.0f, bc2_sqrt = 1.0f;
    if (bias_correction) {
        bc1 = 1.0f - std::pow(beta1, (float)step);
        bc2_sqrt = std::sqrt(1.0f - std::pow(beta2, (float)step));
    }
    const float step_size = lr / bc1;
    const float omb1 = 1.0f - beta1;
    const float omb2 = 1.0f - beta2;

#pragma omp parallel for schedule(static)
    for (long i = 0; i < n; ++i) {
        float grad = g[i];
        if (!adamw_mode && weight_decay > 0.0f) grad += weight_decay * p[i];
        float mi = beta1 * m[i] + omb1 * grad;
        float vi = beta2 * v[i] + omb2 * grad * grad;
        float denom = std::sqrt(vi) / bc2_sqrt + eps;
        float pi = p[i];
        if (adamw_mode && weight_decay > 0.0f) pi -= lr * weight_decay * pi;
        pi -= step_size * (mi / denom);
        p[i] = pi;
        m[i] = mi;
        v[i] = vi;
        out_bf16[i] = float_to_bf16(pi);
    }
}

// Squared L2 norm of a span (for host-side grad clipping in the offload
// path: the engine computes its norms on the card before the copy).
double ds_l2_norm_sq(long n, const float* __restrict__ x) {
    double acc = 0.0;
#pragma omp parallel for reduction(+ : acc) schedule(static)
    for (long i = 0; i < n; ++i) acc += (double)x[i] * (double)x[i];
    return acc;
}

// Scale a span in place (loss-scale unscaling / clip application).
void ds_scale(long n, float alpha, float* __restrict__ x) {
#pragma omp parallel for schedule(static)
    for (long i = 0; i < n; ++i) x[i] *= alpha;
}

}  // extern "C"
