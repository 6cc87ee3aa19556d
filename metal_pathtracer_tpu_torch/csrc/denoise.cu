// One à-trous iteration of the denoisers: ops/kernels/denoise.py
// atrous_step.
//
// Replaces no TPU kernel: the JAX package's tap filters
// (ops/denoise.py atrous_denoise:25, svgf_denoise:79, learned_denoise:157)
// are XLA, each iteration 25 jnp.rolls of four planes and a few dozen
// elementwise operations a tap, which PyTorch eager would run as ~1,000
// launches an iteration, each streaming whole-frame temporaries (the
// learned filter's (H,W,6) @ (6,16) alone makes a 16-channel plane a
// tap). Here one launch does one iteration at step 1 << it, a thread per
// pixel:
// - the variance prologue (the (1,2,1)/4 blur of the luminance variance,
//   then SVGF's denom or the learned filter's gstd, and the centre
//   luminance) is fused: nine reads of the variance around the pixel, no
//   extra plane and no extra launch;
// - the 25 taps wrap around the image as jnp.roll does (a true modulo:
//   with 5 iterations the step reaches 16, more than a small image), read
//   through L1, and accumulate in (ky, kx) row-major order;
// - MODE FIXED is atrous_denoise's tap weight, SVGF svgf_denoise's,
//   LEARNED the 6-16-1 MLP per tap with its 129 weights staged in shared
//   memory and softplus written as jax.nn.softplus (logaddexp(z, 0): no
//   threshold);
// - out: the normalised colour, and in SVGF and LEARNED the variance
//   propagated with squared weights.
//
// What bounds it on an H100: operations, ~290 float operations a tap for
// LEARNED (the MLP and the features), 43 and 50 for FIXED and SVGF, whose
// bytes (each input read once and each output written once: colour,
// albedo and normal in, colour out, 48 B a pixel; 56 B with the variance)
// come within 15 % of that. The taps' re-reads hit L1 and L2; the kernel
// is simple and right first.
//
// Arithmetic: the JAX package's eager ops round one by one, so every
// product and sum here is its own operation (the build passes
// --fmad=false) but the eight fused ones of the MLP's second layer, where
// XLA's dot places them, in the plain version's order (ops/denoise.py
// atrous_step_reference); divisions are IEEE, by the host's float32
// constants (kernels/denoise.py StepParams).
#include <cuda_runtime.h>

namespace {

constexpr int kFixed = 0, kSvgf = 1, kLearned = 2;
// w1 (6, 16) row by row, b1 (16), w2 (16), b2
constexpr int kMlpFloats = 6 * 16 + 16 + 16 + 1;
constexpr int kB1 = 96, kW2 = 112, kB2 = 128;

// kernels/denoise.py StepParams.scalars()
struct StepScalars {
  float c_color, c_normal, c_albedo, sigma_lum, normal_pow, it_feature,
      pad0, pad1;
};

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

__device__ __forceinline__ float luminance(float r, float g, float b) {
  return (0.2126f * r + 0.7152f * g) + 0.0722f * b;
}

__device__ __forceinline__ float dot3(float a0, float a1, float a2,
                                      float b0, float b1, float b2) {
  return (a0 * b0 + a1 * b1) + a2 * b2;
}

// ops/denoise.py _gauss3 at (y, x): the (1,2,1)/4 blur down the rows
// (roll by -1, 0, 1: rows y+1, y, y-1), then along the columns
__device__ float gauss3(const float* __restrict__ v, int h, int w, int y,
                        int x) {
  const int yp = wrap(y + 1, h) * w, y0 = y * w, ym = wrap(y - 1, h) * w;
  float r[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int xx = wrap(x + 1 - j, w);
    r[j] = (0.25f * __ldg(v + yp + xx) + 0.5f * __ldg(v + y0 + xx))
        + 0.25f * __ldg(v + ym + xx);
  }
  return (0.25f * r[0] + 0.5f * r[1]) + 0.25f * r[2];
}

// the learned tap weight's logit, summed as XLA:CPU's eager dots sum it
// (ops/denoise.py _mlp_logit): relu(((p0 + p1) + (p2 + p3)) + (p4 + p5)
// + b1) with p_c = f_c w1[c], then eight lanes fma(h[l + 8], w2[l + 8],
// h[l] w2[l]) summed in a tree, then b2
__device__ float mlp_logit(const float* __restrict__ m, const float f[6]) {
  float h[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float a = ((f[0] * m[k] + f[1] * m[16 + k])
                     + (f[2] * m[32 + k] + f[3] * m[48 + k]))
        + (f[4] * m[64 + k] + f[5] * m[80 + k]);
    h[k] = fmaxf(a + m[kB1 + k], 0.f);
  }
  float lane[8];
#pragma unroll
  for (int l = 0; l < 8; ++l)
    lane[l] = __fmaf_rn(h[l + 8], m[kW2 + l + 8], h[l] * m[kW2 + l]);
  const float z = ((lane[0] + lane[1]) + (lane[2] + lane[3]))
      + ((lane[4] + lane[5]) + (lane[6] + lane[7]));
  return z + m[kB2];
}

template <int MODE>
__global__ void __launch_bounds__(256) atrous_step_kernel(
    int h, int w, int step, StepScalars s, const float* __restrict__ mlp,
    const float* __restrict__ color, const float* __restrict__ var,
    const float* __restrict__ albedo, const float* __restrict__ normal,
    float* __restrict__ out_color, float* __restrict__ out_var) {
  __shared__ float m[MODE == kLearned ? kMlpFloats : 1];
  if (MODE == kLearned) {
    for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < kMlpFloats;
         i += blockDim.x * blockDim.y)
      m[i] = mlp[i];
    __syncthreads();
  }
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int p = y * w + x;
  const float c0 = color[3 * p], c1 = color[3 * p + 1],
              c2 = color[3 * p + 2];
  const float a0 = albedo[3 * p], a1 = albedo[3 * p + 1],
              a2 = albedo[3 * p + 2];
  const float n0 = normal[3 * p], n1 = normal[3 * p + 1],
              n2 = normal[3 * p + 2];
  const float nn = dot3(n0, n1, n2, n0, n1, n2);
  float lum_p = 0.f, denom = 0.f, gstd = 0.f;
  if (MODE != kFixed) {
    lum_p = luminance(c0, c1, c2);
    const float g = gauss3(var, h, w, y, x);
    if (MODE == kSvgf)
      denom = s.sigma_lum * sqrtf(fmaxf(g, 0.f)) + 1e-4f;
    else
      gstd = sqrtf(fmaxf(g, 1e-12f));
  }
  const float kw[5] = {0.0625f, 0.25f, 0.375f, 0.25f, 0.0625f};
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, vacc = 0.f, wsum = 0.f;
  for (int i = 0; i < 5; ++i) {
    const int row = wrap(y - (i - 2) * step, h) * w;
    for (int j = 0; j < 5; ++j) {
      const int q = row + wrap(x - (j - 2) * step, w);
      const float wk = kw[i] * kw[j];
      const float s0 = __ldg(color + 3 * q), s1 = __ldg(color + 3 * q + 1),
                  s2 = __ldg(color + 3 * q + 2);
      const float da0 = __ldg(albedo + 3 * q) - a0,
                  da1 = __ldg(albedo + 3 * q + 1) - a1,
                  da2 = __ldg(albedo + 3 * q + 2) - a2;
      const float m0 = __ldg(normal + 3 * q), m1 = __ldg(normal + 3 * q + 1),
                  m2 = __ldg(normal + 3 * q + 2);
      const float daa = dot3(da0, da1, da2, da0, da1, da2);
      const float ndot = dot3(m0, m1, m2, n0, n1, n2);
      float wt;
      if (MODE == kFixed) {
        const float dc0 = s0 - c0, dc1 = s1 - c1, dc2 = s2 - c2;
        const float dn = fmaxf(1.f - ndot, 0.f);
        const float wc = expf(-dot3(dc0, dc1, dc2, dc0, dc1, dc2)
                              / s.c_color);
        const float wn = expf(-dn / s.c_normal);
        const float wa = expf(-daa / s.c_albedo);
        wt = wk * ((wc * wn) * wa);
      } else {
        const bool both_bg = nn < 0.5f && dot3(m0, m1, m2, m0, m1, m2) < 0.5f;
        const float dl = fabsf(luminance(s0, s1, s2) - lum_p);
        if (MODE == kSvgf) {
          const float wl = expf(-dl / denom);
          const float wn = both_bg ? 1.f
                                   : powf(fmaxf(ndot, 0.f), s.normal_pow);
          const float wa = expf(-daa / s.c_albedo);
          wt = ((wk * wl) * wn) * wa;
        } else {
          float f[6];
          f[0] = dl / (gstd + 1e-4f);
          f[1] = both_bg ? 0.f : fmaxf(1.f - ndot, 0.f);
          f[2] = daa;
          f[3] = gstd;
          f[4] = s.it_feature;
          f[5] = (float)(abs(i - 2) + abs(j - 2)) * 0.25f;
          const float z = mlp_logit(m, f);
          const float sp = fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
          wt = wk * expf(-sp);
        }
        vacc = vacc + __ldg(var + q) * (wt * wt);
      }
      acc0 = acc0 + s0 * wt;
      acc1 = acc1 + s1 * wt;
      acc2 = acc2 + s2 * wt;
      wsum = wsum + wt;
    }
  }
  const float mm = fmaxf(wsum, 1e-6f);
  out_color[3 * p] = acc0 / mm;
  out_color[3 * p + 1] = acc1 / mm;
  out_color[3 * p + 2] = acc2 / mm;
  if (MODE != kFixed) out_var[p] = vacc / (mm * mm);
}

}  // namespace

// mode (0 FIXED, 1 SVGF, 2 LEARNED), image height and width, tap step,
// StepScalars (host float[8]), the packed MLP (device, LEARNED only),
// colour (h, w, 3), luminance variance (h, w; not FIXED), albedo and
// normal (h, w, 3), out colour, out variance (not FIXED), stream
extern "C" int mpt_atrous_step(int mode, int h, int w, int step,
                               const float* s, const void* mlp,
                               const void* color, const void* var,
                               const void* albedo, const void* normal,
                               void* out_color, void* out_var,
                               void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const StepScalars sc = {s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]};
  const dim3 block(32, 8), grid((w + 31) / 32, (h + 7) / 8);
  cudaStream_t st = (cudaStream_t)stream;
  const float *c = (const float*)color, *v = (const float*)var,
              *a = (const float*)albedo, *n = (const float*)normal,
              *m = (const float*)mlp;
  float *oc = (float*)out_color, *ov = (float*)out_var;
  switch (mode) {
    case kFixed:
      atrous_step_kernel<kFixed><<<grid, block, 0, st>>>(h, w, step, sc, m,
                                                         c, v, a, n, oc, ov);
      break;
    case kSvgf:
      atrous_step_kernel<kSvgf><<<grid, block, 0, st>>>(h, w, step, sc, m,
                                                        c, v, a, n, oc, ov);
      break;
    case kLearned:
      atrous_step_kernel<kLearned><<<grid, block, 0, st>>>(
          h, w, step, sc, m, c, v, a, n, oc, ov);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
