// One à-trous iteration of the denoisers, and the pack launch that gives
// a filter its 16-byte rows: ops/kernels/denoise.py atrous_step_packed,
// pack, atrous_filter.
//
// Replaces no TPU kernel: the JAX package's tap filters
// (ops/denoise.py atrous_denoise:25, svgf_denoise:79, learned_denoise:157)
// are XLA, each iteration 25 jnp.rolls of four planes and a few dozen
// elementwise operations a tap, which PyTorch eager would run as ~1,000
// launches an iteration, each streaming whole-frame temporaries (the
// learned filter's (H,W,6) @ (6,16) alone makes a 16-channel plane a
// tap). Here a filter is one pack launch, then one launch an iteration at
// step s = 1 << it.
//
// Layout (atrous_pack_kernel, once a filter, a bit copy): colour and the
// luminance variance as one float4 a pixel (0 in .w for the fixed
// filter), carried from iteration to iteration in that form; albedo and
// normal as two float4 a pixel, (a0, a1, a2, 0) and (n0, n1, n2, n.n),
// n.n summed as the taps sum it (hoisted: the variance-guided modes test
// it at every tap).
//
// Scheduling (atrous_step_kernel): the block of 32 x 8 threads takes one
// residue class (coset) of the step: thread (tx, ty) the pixel
// (ry + s (u0 + ty), rx + s (v0 + tx)). Every tap of every thread is then
// a point of one 12 x 36 lattice tile, (u0 - 2 .. u0 + 9) x (v0 - 2 ..
// v0 + 33), staged once in shared memory (432 points x 48 B, 20,736 B)
// and read up to 25 times; at step 1 the tile is a plain halo tile. The
// toroidal wrap (jnp.roll's true modulo: h mod s need not be 0, and the
// step may exceed a small image) is taken once a tile point, at its load,
// from its unwrapped lattice position, never in the tap loop. The cosets
// are the fastest-varying block index, so the s^2 blocks of one image
// region run together and their strided reads share L2 sectors. The
// variance blur's 3x3 prologue reads the unit-step neighbours: from the
// tile at step 1, else nine 4-byte reads of the carried float4s, wrapped
// by a compare (they are one pixel away).
//
// Arithmetic: the JAX package's eager ops round one by one, so every
// product and sum is its own operation (the build passes --fmad=false)
// but the eight fused ones of the MLP's second layer, where XLA's dot
// places them, in the plain version's order (ops/denoise.py
// atrous_step_reference); divisions are IEEE, by the host's float32
// constants (kernels/denoise.py StepParams); taps in (ky, kx) row-major
// order. The learned filter's constant terms are hoisted with the same
// roundings: the host computes p4 + p5 = it_feature w1[4] + (r / 4) w1[5]
// once a launch for each radius r (kernels/denoise.py mlp_constants, in
// float32), the kernel p3 = gstd w1[3] once a pixel, and the tap sums
// ((p0 + p1) + (p2 + p3)) + (p4 + p5) + b1 as before. The weights and the
// table are a __grid_constant__ parameter: constant-bank operands, no
// shared-memory load of a weight.
//
// What bounds it on an H100: instruction throughput. Every multiply and
// add is its own instruction (no FMA contraction): 222 float operations
// a tap for LEARNED once hoisted (293 before), 43 and 45 for FIXED and
// SVGF, plus the IEEE divisions and the expf / log1pf / powf sequences;
// the bytes (each input read once, each output written once: 48 or 56 B
// a pixel) are a fifth to a tenth of that time. The taps come from
// shared memory (three 16-byte loads a tap), so the loads no longer set
// the time.
#include <cuda_runtime.h>

namespace {

constexpr int kFixed = 0, kSvgf = 1, kLearned = 2;
// the block and its lattice tile (a 2-point halo on each side)
constexpr int kBX = 32, kBY = 8, kTX = kBX + 4, kTY = kBY + 4;
constexpr int kTile = kTX * kTY;
constexpr int kThreads = kBX * kBY;

// kernels/denoise.py StepParams.scalars()
struct StepScalars {
  float c_color, c_normal, c_albedo, sigma_lum, normal_pow, it_feature,
      pad0, pad1;
};

// kernels/denoise.py mlp_constants(): the learned filter's launch
// constants, w1's first four rows, b1, w2, b2 and the (p4 + p5) table by
// radius index (abs(ky) + abs(kx))
struct MlpConst {
  float w1[4][16];
  float b1[16];
  float w2[16];
  float b2, pad[3];
  float tab[5][16];
};
constexpr int kMlpConstFloats = sizeof(MlpConst) / sizeof(float);

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

// the B3-spline weight of a tap at distance d (0, 1, 2) from the centre
__device__ __forceinline__ float spline(int d) {
  return d == 0 ? 0.375f : d == 1 ? 0.25f : 0.0625f;
}

__global__ void __launch_bounds__(256) atrous_pack_kernel(
    int n, const float* __restrict__ color, const float* __restrict__ var,
    const float* __restrict__ albedo, const float* __restrict__ normal,
    float4* __restrict__ cv, float4* __restrict__ guide) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const float n0 = normal[3 * p], n1 = normal[3 * p + 1],
              n2 = normal[3 * p + 2];
  cv[p] = make_float4(color[3 * p], color[3 * p + 1], color[3 * p + 2],
                      var == nullptr ? 0.f : var[p]);
  guide[2 * p] = make_float4(albedo[3 * p], albedo[3 * p + 1],
                             albedo[3 * p + 2], 0.f);
  guide[2 * p + 1] = make_float4(n0, n1, n2, dot3(n0, n1, n2, n0, n1, n2));
}

// the learned tap weight's logit with the constant terms hoisted, summed
// as XLA:CPU's eager dots sum it (ops/denoise.py _mlp_logit_hoisted):
// relu(((p0 + p1) + (p2 + p3)) + (p4 + p5) + b1) with p_c = f_c w1[c],
// p3 and (p4 + p5) given, then eight lanes fma(h[l + 8], w2[l + 8],
// h[l] w2[l]) summed in a tree, then b2
__device__ __forceinline__ float mlp_logit(const MlpConst& m, float f0,
                                           float f1, float f2,
                                           const float p3[16], int r) {
  float h[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float a = ((f0 * m.w1[0][k] + f1 * m.w1[1][k])
                     + (f2 * m.w1[2][k] + p3[k])) + m.tab[r][k];
    h[k] = fmaxf(a + m.b1[k], 0.f);
  }
  float lane[8];
#pragma unroll
  for (int l = 0; l < 8; ++l)
    lane[l] = __fmaf_rn(h[l + 8], m.w2[l + 8], h[l] * m.w2[l]);
  const float z = ((lane[0] + lane[1]) + (lane[2] + lane[3]))
      + ((lane[4] + lane[5]) + (lane[6] + lane[7]));
  return z + m.b2;
}

// the luminance variance at (y, x) of the carried float4s (.w)
__device__ __forceinline__ float var_at(const float4* __restrict__ cv,
                                        int w, int y, int x) {
  return __ldg(&cv[y * w + x].w);
}

template <int MODE, bool PACKED_OUT>
__global__ void __launch_bounds__(kThreads) atrous_step_kernel(
    int h, int w, int step, int cy, int cx, int tiles_x, StepScalars s,
    const __grid_constant__ MlpConst mc, const float4* __restrict__ cv,
    const float4* __restrict__ guide, float4* __restrict__ out_cv,
    float* __restrict__ out_color, float* __restrict__ out_var) {
  __shared__ float4 t_cv[kTile], t_alb[kTile], t_nrm[kTile];
  const int cosets = cy * cx;
  const int coset = blockIdx.x % cosets, tile = blockIdx.x / cosets;
  const int ry = coset / cx, rx = coset - ry * cx;
  const int u0 = (tile / tiles_x) * kBY, v0 = (tile % tiles_x) * kBX;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  // stage the tile: each point from its wrapped address
  for (int k = tid; k < kTile; k += kThreads) {
    const int a = k / kTX, b = k - a * kTX;
    const int q = wrap(ry + step * (u0 - 2 + a), h) * w
        + wrap(rx + step * (v0 - 2 + b), w);
    t_cv[k] = __ldg(cv + q);
    t_alb[k] = __ldg(guide + 2 * q);
    t_nrm[k] = __ldg(guide + 2 * q + 1);
  }
  __syncthreads();
  const int y = ry + step * (u0 + threadIdx.y);
  const int x = rx + step * (v0 + threadIdx.x);
  if (y >= h || x >= w) return;
  const int p = y * w + x;
  const int centre = (threadIdx.y + 2) * kTX + threadIdx.x + 2;
  const float4 cc = t_cv[centre], ca = t_alb[centre], cn = t_nrm[centre];
  const float nn = cn.w;
  float lum_p = 0.f, denom = 0.f, gdiv = 0.f;
  float p3[16];
  if constexpr (MODE != kFixed) {
    lum_p = luminance(cc.x, cc.y, cc.z);
    // ops/denoise.py _gauss3 at (y, x): the (1,2,1)/4 blur down the rows
    // (roll by -1, 0, 1: rows y+1, y, y-1), then along the columns
    float r[3];
    if (step == 1) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int col = threadIdx.x + 3 - j;
        r[j] = (0.25f * t_cv[(threadIdx.y + 3) * kTX + col].w
                + 0.5f * t_cv[(threadIdx.y + 2) * kTX + col].w)
            + 0.25f * t_cv[(threadIdx.y + 1) * kTX + col].w;
      }
    } else {
      const int yp = y + 1 == h ? 0 : y + 1, ym = y == 0 ? h - 1 : y - 1;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int xx = j == 0 ? (x + 1 == w ? 0 : x + 1)
            : j == 1 ? x : (x == 0 ? w - 1 : x - 1);
        r[j] = (0.25f * var_at(cv, w, yp, xx) + 0.5f * var_at(cv, w, y, xx))
            + 0.25f * var_at(cv, w, ym, xx);
      }
    }
    const float g = (0.25f * r[0] + 0.5f * r[1]) + 0.25f * r[2];
    if constexpr (MODE == kSvgf) {
      denom = s.sigma_lum * sqrtf(fmaxf(g, 0.f)) + 1e-4f;
    } else {
      const float gstd = sqrtf(fmaxf(g, 1e-12f));
      gdiv = gstd + 1e-4f;
#pragma unroll
      for (int k = 0; k < 16; ++k) p3[k] = gstd * mc.w1[3][k];
    }
  }
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, vacc = 0.f, wsum = 0.f;
  // tap (i, j) reads the roll source (y - (i - 2) s, x - (j - 2) s): tile
  // point (ty + 4 - i, tx + 4 - j)
#pragma unroll 1
  for (int i = 0; i < 5; ++i) {
    const int di = i < 2 ? 2 - i : i - 2;
    const float wy = spline(di);
    const int row = (threadIdx.y + 4 - i) * kTX + threadIdx.x + 4;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const int dj = j < 2 ? 2 - j : j - 2;
      const float wk = wy * spline(dj);
      const float4 sc = t_cv[row - j], sa = t_alb[row - j],
                   sn = t_nrm[row - j];
      const float da0 = sa.x - ca.x, da1 = sa.y - ca.y, da2 = sa.z - ca.z;
      const float daa = dot3(da0, da1, da2, da0, da1, da2);
      const float ndot = dot3(sn.x, sn.y, sn.z, cn.x, cn.y, cn.z);
      float wt;
      if constexpr (MODE == kFixed) {
        const float dc0 = sc.x - cc.x, dc1 = sc.y - cc.y, dc2 = sc.z - cc.z;
        const float dn = fmaxf(1.f - ndot, 0.f);
        const float wc = expf(-dot3(dc0, dc1, dc2, dc0, dc1, dc2)
                              / s.c_color);
        const float wn = expf(-dn / s.c_normal);
        const float wa = expf(-daa / s.c_albedo);
        wt = wk * ((wc * wn) * wa);
      } else {
        const bool both_bg = nn < 0.5f && sn.w < 0.5f;
        const float dl = fabsf(luminance(sc.x, sc.y, sc.z) - lum_p);
        if constexpr (MODE == kSvgf) {
          const float wl = expf(-dl / denom);
          const float wn = both_bg ? 1.f
                                   : powf(fmaxf(ndot, 0.f), s.normal_pow);
          const float wa = expf(-daa / s.c_albedo);
          wt = ((wk * wl) * wn) * wa;
        } else {
          const float f0 = dl / gdiv;
          const float f1 = both_bg ? 0.f : fmaxf(1.f - ndot, 0.f);
          const float z = mlp_logit(mc, f0, f1, daa, p3, di + dj);
          const float sp = fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
          wt = wk * expf(-sp);
        }
        vacc = vacc + sc.w * (wt * wt);
      }
      acc0 = acc0 + sc.x * wt;
      acc1 = acc1 + sc.y * wt;
      acc2 = acc2 + sc.z * wt;
      wsum = wsum + wt;
    }
  }
  const float mm = fmaxf(wsum, 1e-6f);
  const float o0 = acc0 / mm, o1 = acc1 / mm, o2 = acc2 / mm;
  const float ov = MODE == kFixed ? 0.f : vacc / (mm * mm);
  if constexpr (PACKED_OUT) {
    out_cv[p] = make_float4(o0, o1, o2, ov);
  } else {
    out_color[3 * p] = o0;
    out_color[3 * p + 1] = o1;
    out_color[3 * p + 2] = o2;
    if (MODE != kFixed) out_var[p] = ov;
  }
}

template <int MODE>
int launch_step(int h, int w, int step, const StepScalars& sc,
                const MlpConst& mc, const float4* cv, const float4* guide,
                float4* out_cv, float* out_color, float* out_var,
                cudaStream_t st) {
  // cosets of the step that hold a pixel, and the lattice tiles of the
  // largest coset (ceil(h / s) x ceil(w / s) points)
  const int cy = step < h ? step : h, cx = step < w ? step : w;
  const int tiles_y = ((h + step - 1) / step + kBY - 1) / kBY;
  const int tiles_x = ((w + step - 1) / step + kBX - 1) / kBX;
  const long long blocks = (long long)cy * cx * tiles_y * tiles_x;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 block(kBX, kBY), grid((unsigned)blocks);
  if (out_cv != nullptr)
    atrous_step_kernel<MODE, true><<<grid, block, 0, st>>>(
        h, w, step, cy, cx, tiles_x, sc, mc, cv, guide, out_cv, out_color,
        out_var);
  else
    atrous_step_kernel<MODE, false><<<grid, block, 0, st>>>(
        h, w, step, cy, cx, tiles_x, sc, mc, cv, guide, out_cv, out_color,
        out_var);
  return (int)cudaGetLastError();
}

}  // namespace

// n pixels, colour (n, 3), luminance variance (n; NULL: 0), albedo and
// normal (n, 3), out: the carried float4 (n, 4) and the guide rows
// (n, 8), stream
extern "C" int mpt_atrous_pack(int n, const void* color, const void* var,
                               const void* albedo, const void* normal,
                               void* cv, void* guide, void* stream) {
  if (n <= 0) return 0;
  atrous_pack_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      n, (const float*)color, (const float*)var, (const float*)albedo,
      (const float*)normal, (float4*)cv, (float4*)guide);
  return (int)cudaGetLastError();
}

// mode (0 FIXED, 1 SVGF, 2 LEARNED), image height and width, tap step,
// StepScalars (host float[8]), MlpConst (host float[kMlpConstFloats],
// LEARNED only, else NULL), the carried float4s (h, w, 4) and guide rows
// (h, w, 8), then either out_cv (h, w, 4) or (out_cv NULL) out colour
// (h, w, 3) and out variance (h, w; not FIXED), stream
extern "C" int mpt_atrous_step(int mode, int h, int w, int step,
                               const float* s, const float* mlp,
                               const void* cv, const void* guide,
                               void* out_cv, void* out_color, void* out_var,
                               void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if (step <= 0) return (int)cudaErrorInvalidValue;
  const StepScalars sc = {s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]};
  MlpConst mc = {};
  if (mode == kLearned) {
    if (mlp == nullptr) return (int)cudaErrorInvalidValue;
    float* dst = (float*)&mc;
    for (int i = 0; i < kMlpConstFloats; ++i) dst[i] = mlp[i];
  }
  cudaStream_t st = (cudaStream_t)stream;
  const float4 *c = (const float4*)cv, *g = (const float4*)guide;
  float4* oc = (float4*)out_cv;
  float *ocol = (float*)out_color, *ov = (float*)out_var;
  switch (mode) {
    case kFixed:
      return launch_step<kFixed>(h, w, step, sc, mc, c, g, oc, ocol, ov, st);
    case kSvgf:
      return launch_step<kSvgf>(h, w, step, sc, mc, c, g, oc, ocol, ov, st);
    case kLearned:
      return launch_step<kLearned>(h, w, step, sc, mc, c, g, oc, ocol, ov,
                                   st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// floats of MlpConst, for the wrapper's check
extern "C" int mpt_atrous_mlp_floats() { return kMlpConstFloats; }
