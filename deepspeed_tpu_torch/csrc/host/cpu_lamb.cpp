// Host LAMB for the ZeRO-Offload tier of deepspeed_tpu_torch.
//
// Per tensor (all buffers length n, fp32, updated in place):
//   1. the m/v moment update and the Adam-style `update` vector, summing
//      ||p||^2 and ||update||^2 in the same OpenMP pass (update written to
//      scratch so phase 2 needs no recompute);
//   2. trust_ratio = clamp(||p|| / ||update||, min_coeff, max_coeff)
//      (1 when either norm is zero), then p -= lr * ratio * update.
// The engine calls it once per parameter tensor of each transfer chunk:
// the trust ratio is a per-tensor statistic. Over ranks that each hold a
// shard of a tensor the two phases are separate calls (ds_lamb_norms, then
// ds_lamb_apply with the ratio of the summed squares); ds_lamb_step is the
// two in one call.
//
// A plain C ABI loaded with ctypes (op_builder/builder.py, the host
// route). The arithmetic is kept identical, line for line, to the JAX
// package's host LAMB, so the two packages update a master alike.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

inline uint16_t float_to_bf16(float f) {
    uint32_t bits;
    std::memcpy(&bits, &f, sizeof(bits));
    if ((bits & 0x7fffffffu) > 0x7f800000u) {
        return (uint16_t)((bits >> 16) | 0x0040u);  // quiet NaN, keep sign
    }
    uint32_t lsb = (bits >> 16) & 1u;
    bits += 0x7fffu + lsb;
    return (uint16_t)(bits >> 16);
}

}  // namespace

extern "C" {

// Pass 1 of a LAMB step over a contiguous fp32 span: the m/v moment update
// and the Adam-style update vector (into `scratch`, n floats), and the
// span's sums of squares: out_sq[0] = ||p||^2, out_sq[1] = ||update||^2
// (doubles). Over partitioned ranks the caller adds every rank's sums of a
// tensor before pass 2.
void ds_lamb_norms(long step,
                   float beta1,
                   float beta2,
                   float eps,
                   float weight_decay,
                   int bias_correction,
                   long n,
                   const float* __restrict__ p,
                   const float* __restrict__ g,
                   float* __restrict__ m,
                   float* __restrict__ v,
                   float* __restrict__ scratch,
                   double* __restrict__ out_sq) {
    float bc1 = 1.0f, bc2 = 1.0f;
    if (bias_correction) {
        bc1 = 1.0f - std::pow(beta1, (float)step);
        bc2 = 1.0f - std::pow(beta2, (float)step);
    }
    const float omb1 = 1.0f - beta1;
    const float omb2 = 1.0f - beta2;
    const float inv_bc1 = 1.0f / bc1;
    const float inv_sqrt_bc2 = 1.0f / std::sqrt(bc2);

    double w_sq = 0.0, u_sq = 0.0;
#pragma omp parallel for reduction(+ : w_sq, u_sq) schedule(static)
    for (long i = 0; i < n; ++i) {
        float grad = g[i];
        float mi = beta1 * m[i] + omb1 * grad;
        float vi = beta2 * v[i] + omb2 * grad * grad;
        m[i] = mi;
        v[i] = vi;
        // update = (m/bc1) / (sqrt(v/bc2) + eps) + wd * p
        float upd = (mi * inv_bc1) / (std::sqrt(vi) * inv_sqrt_bc2 + eps);
        if (weight_decay > 0.0f) upd += weight_decay * p[i];
        scratch[i] = upd;
        w_sq += (double)p[i] * (double)p[i];
        u_sq += (double)upd * (double)upd;
    }
    out_sq[0] = w_sq;
    out_sq[1] = u_sq;
}

// The trust ratio of a tensor from its sums of squares: clamp(||p|| /
// ||update||, min_coeff, max_coeff), 1 when either is zero.
float ds_lamb_ratio(double w_sq, double u_sq, float max_coeff,
                    float min_coeff) {
    float ratio = 1.0f;
    if (w_sq > 0.0 && u_sq > 0.0) {
        ratio = (float)(std::sqrt(w_sq) / std::sqrt(u_sq));
        if (ratio > max_coeff) ratio = max_coeff;
        if (ratio < min_coeff) ratio = min_coeff;
    }
    return ratio;
}

// Pass 2: p -= lr * ratio * update, the update from pass 1's `scratch`.
// If out_bf16 is non-null the updated params are also round-to-nearest-even
// downcast into it in the same pass (the cpu_adam copy fusion).
void ds_lamb_apply(float lr,
                   float ratio,
                   long n,
                   float* __restrict__ p,
                   const float* __restrict__ scratch,
                   uint16_t* __restrict__ out_bf16) {
    const float step_size = lr * ratio;
    if (out_bf16 != nullptr) {
#pragma omp parallel for schedule(static)
        for (long i = 0; i < n; ++i) {
            float pi = p[i] - step_size * scratch[i];
            p[i] = pi;
            out_bf16[i] = float_to_bf16(pi);
        }
    } else {
#pragma omp parallel for schedule(static)
        for (long i = 0; i < n; ++i) p[i] -= step_size * scratch[i];
    }
}

// One LAMB step over a contiguous fp32 span, its own trust-ratio domain:
// pass 1, the ratio, pass 2. Returns the applied trust ratio (DeepSpeed
// exposes its lamb_coeffs for introspection the same way). `scratch` must
// hold n floats.
float ds_lamb_step(long step,
                   float lr,
                   float beta1,
                   float beta2,
                   float eps,
                   float weight_decay,
                   int bias_correction,
                   float max_coeff,
                   float min_coeff,
                   long n,
                   float* __restrict__ p,
                   const float* __restrict__ g,
                   float* __restrict__ m,
                   float* __restrict__ v,
                   float* __restrict__ scratch,
                   uint16_t* __restrict__ out_bf16) {
    double sq[2];
    ds_lamb_norms(step, beta1, beta2, eps, weight_decay, bias_correction, n,
                  p, g, m, v, scratch, sq);
    float ratio = ds_lamb_ratio(sq[0], sq[1], max_coeff, min_coeff);
    ds_lamb_apply(lr, ratio, n, p, scratch, out_bf16);
    return ratio;
}

}  // extern "C"
