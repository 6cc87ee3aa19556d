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

// ---- the learned iteration's backward -------------------------------------
//
// Three launches an iteration (kernels/denoise.py atrous_step_grad, the
// backward of its autograd Function), in place of JAX's autodiff of
// ops/denoise.py learned_denoise:157-206; their plain versions are
// ops/denoise.py grad_taps_reference, grad_gather_reference and
// grad_sum_reference. With c the colour and v the luminance variance in,
// A_p = sum_k w_pk c_q, V_p = sum_k w_pk^2 v_q, S_p = sum_k w_pk, m_p =
// max(S_p, 1e-6), o = A / m, o_v = V / m^2 and the cotangents g = dL/do,
// u = dL/do_v:
//
// atrous_grad_taps_kernel, a thread a pixel p: recomputes its 25 taps as
// the forward does (the same operations, so the same bits), then takes
// each tap back: dL/dw_pk = (g / m).c_q + 2 w_pk (u / m^2) v_q + dL/dS_p,
// dL/dz = -dL/dw w_k exp(-softplus(z)) sigmoid(z), through the 6-16-1 MLP
// (a hidden unit passes where its pre-activation >= 0), feature 0 to the
// luminance difference (sign +1 at 0, JAX's) and to gstd_p, gstd to the
// blurred variance. It writes w_pk and the adjoint of lum_q as (25, n)
// planes, its own terms (g / m, u / m^2; the adjoints of lum_p and of the
// blurred variance), and its block's sums of the 129 parameter gradients
// (a tree in shared memory, one row a block: no atomics, so two launches
// give the same bits).
// atrous_grad_gather_kernel, a thread a pixel q: gathers from the pixels
// p = q + (ky, kx) s that tapped it, in tap order: dL/dc_q = sum_k w_pk
// g_p / m_p + lum weights x (its own and the taps' luminance adjoints),
// dL/dv_q = sum_k w_pk^2 u_p / m_p^2 + the _gauss3 adjoint (the same
// symmetric blur, wrapping) of the blurred variance's adjoint.
// atrous_grad_sum_kernel: a block a parameter sums the blocks' rows in a
// fixed order.
//
// What bounds them: instruction throughput, like the forward. A tap is
// taken twice (the forward's sums first, then the tap back), so its
// forward is computed twice, and the tap back adds ~300 float operations
// (the MLP's layers back, the six per-tap parameter sums); the 96
// parameter accumulators a thread live in registers. The planes cost 200
// B a pixel of writes and reads (~415 MB an iteration at 1080p). Simple
// and right first: a thread a pixel, taps read from global memory
// through L1, no coset tiles.
constexpr int kGradThreads = 128;
constexpr int kMlpFloats = 6 * 16 + 16 + 16 + 1;

// the hidden pre-activations, hidden units and logit of one learned tap,
// in mlp_logit's operations and order
__device__ __forceinline__ float mlp_tap(const MlpConst& m, float f0,
                                         float f1, float f2, float gstd,
                                         int r, float pre[16],
                                         float hid[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float a = ((f0 * m.w1[0][k] + f1 * m.w1[1][k])
                     + (f2 * m.w1[2][k] + gstd * m.w1[3][k])) + m.tab[r][k];
    pre[k] = a + m.b1[k];
    hid[k] = fmaxf(pre[k], 0.f);
  }
  float lane[8];
#pragma unroll
  for (int l = 0; l < 8; ++l)
    lane[l] = __fmaf_rn(hid[l + 8], m.w2[l + 8], hid[l] * m.w2[l]);
  const float z = ((lane[0] + lane[1]) + (lane[2] + lane[3]))
      + ((lane[4] + lane[5]) + (lane[6] + lane[7]));
  return z + m.b2;
}

// one learned tap's recomputed terms
struct Tap {
  float4 sc;
  float dl, f0, f1, f2, z, e, wt;
};

__device__ __forceinline__ Tap learned_tap(
    const MlpConst& mc, const float4* __restrict__ cv,
    const float4* __restrict__ guide, int q, float lum_p, float gdiv,
    float gstd, float4 ca, float4 cn, int di, int dj, float pre[16],
    float hid[16]) {
  Tap t;
  t.sc = __ldg(cv + q);
  const float4 sa = __ldg(guide + 2 * q), sn = __ldg(guide + 2 * q + 1);
  const float da0 = sa.x - ca.x, da1 = sa.y - ca.y, da2 = sa.z - ca.z;
  t.f2 = dot3(da0, da1, da2, da0, da1, da2);
  const float ndot = dot3(sn.x, sn.y, sn.z, cn.x, cn.y, cn.z);
  const bool both_bg = cn.w < 0.5f && sn.w < 0.5f;
  t.dl = luminance(t.sc.x, t.sc.y, t.sc.z) - lum_p;
  t.f0 = fabsf(t.dl) / gdiv;
  t.f1 = both_bg ? 0.f : fmaxf(1.f - ndot, 0.f);
  t.z = mlp_tap(mc, t.f0, t.f1, t.f2, gstd, di + dj, pre, hid);
  const float sp = fmaxf(t.z, 0.f) + log1pf(expf(-fabsf(t.z)));
  t.e = expf(-sp);
  t.wt = (spline(di) * spline(dj)) * t.e;
  return t;
}

__global__ void __launch_bounds__(kGradThreads) atrous_grad_taps_kernel(
    int h, int w, int step, StepScalars s, const __grid_constant__ MlpConst mc,
    const float4* __restrict__ cv, const float4* __restrict__ guide,
    const float* __restrict__ g_out, const float* __restrict__ u_out,
    float* __restrict__ w_plane, float* __restrict__ l_plane,
    float4* __restrict__ pix, float2* __restrict__ pix2,
    float* __restrict__ partial) {
  __shared__ float red[16][kGradThreads];
  const int n = h * w;
  const int tid = threadIdx.x;
  const int p = blockIdx.x * kGradThreads + tid;
  float acc_f0[16], acc_f1[16], acc_f2[16], acc_r[16], acc_b1[16],
      acc_w2[16];
#pragma unroll
  for (int k = 0; k < 16; ++k)
    acc_f0[k] = acc_f1[k] = acc_f2[k] = acc_r[k] = acc_b1[k] = acc_w2[k] =
        0.f;
  float acc_b2 = 0.f, gstd = 0.f;
  if (p < n) {
    const int y = p / w, x = p - (p / w) * w;
    const float4 cc = __ldg(cv + p), ca = __ldg(guide + 2 * p),
                 cn = __ldg(guide + 2 * p + 1);
    const float lum_p = luminance(cc.x, cc.y, cc.z);
    const int yp = y + 1 == h ? 0 : y + 1, ym = y == 0 ? h - 1 : y - 1;
    float r3[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int xx = j == 0 ? (x + 1 == w ? 0 : x + 1)
          : j == 1 ? x : (x == 0 ? w - 1 : x - 1);
      r3[j] = (0.25f * var_at(cv, w, yp, xx) + 0.5f * var_at(cv, w, y, xx))
          + 0.25f * var_at(cv, w, ym, xx);
    }
    const float g = (0.25f * r3[0] + 0.5f * r3[1]) + 0.25f * r3[2];
    gstd = sqrtf(fmaxf(g, 1e-12f));
    const float gdiv = gstd + 1e-4f;
    float pre[16], hid[16];
    // the forward's sums, taps in (ky, kx) row-major order; tap (i, j)
    // reads the roll source (y - (i - 2) s, x - (j - 2) s)
    float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, vacc = 0.f, wsum = 0.f;
#pragma unroll 1
    for (int i = 0; i < 5; ++i) {
      const int di = i < 2 ? 2 - i : i - 2;
      const int row = wrap(y - (i - 2) * step, h) * w;
#pragma unroll 1
      for (int j = 0; j < 5; ++j) {
        const int dj = j < 2 ? 2 - j : j - 2;
        const Tap t = learned_tap(mc, cv, guide,
                                  row + wrap(x - (j - 2) * step, w), lum_p,
                                  gdiv, gstd, ca, cn, di, dj, pre, hid);
        vacc = vacc + t.sc.w * (t.wt * t.wt);
        acc0 = acc0 + t.sc.x * t.wt;
        acc1 = acc1 + t.sc.y * t.wt;
        acc2 = acc2 + t.sc.z * t.wt;
        wsum = wsum + t.wt;
      }
    }
    const float mm = fmaxf(wsum, 1e-6f);
    const float o0 = acc0 / mm, o1 = acc1 / mm, o2 = acc2 / mm;
    const float ov = vacc / (mm * mm);
    const float ab0 = g_out[3 * p] / mm, ab1 = g_out[3 * p + 1] / mm,
                ab2 = g_out[3 * p + 2] / mm;
    const float vbar = u_out == nullptr ? 0.f : u_out[p] / (mm * mm);
    const float sbar = wsum >= 1e-6f
        ? -dot3(ab0, ab1, ab2, o0, o1, o2) - ((vbar + vbar) * ov) * mm
        : 0.f;
    float lp = 0.f, gstd_bar = 0.f;
    // each tap back
#pragma unroll 1
    for (int i = 0; i < 5; ++i) {
      const int di = i < 2 ? 2 - i : i - 2;
      const int row = wrap(y - (i - 2) * step, h) * w;
#pragma unroll 1
      for (int j = 0; j < 5; ++j) {
        const int dj = j < 2 ? 2 - j : j - 2;
        const float wk = spline(di) * spline(dj);
        const float radius = (float)(di + dj) * 0.25f;
        const Tap t = learned_tap(mc, cv, guide,
                                  row + wrap(x - (j - 2) * step, w), lum_p,
                                  gdiv, gstd, ca, cn, di, dj, pre, hid);
        const float w_bar = (dot3(ab0, ab1, ab2, t.sc.x, t.sc.y, t.sc.z)
                             + (t.wt + t.wt) * (vbar * t.sc.w)) + sbar;
        const float sig = 1.f / (1.f + expf(-t.z));
        const float z_bar = -((w_bar * wk) * t.e) * sig;
        float f0_bar = 0.f, f3_bar = 0.f;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const float a_h = pre[k] >= 0.f ? z_bar * mc.w2[k] : 0.f;
          acc_w2[k] = acc_w2[k] + z_bar * hid[k];
          acc_b1[k] = acc_b1[k] + a_h;
          acc_f0[k] = acc_f0[k] + a_h * t.f0;
          acc_f1[k] = acc_f1[k] + a_h * t.f1;
          acc_f2[k] = acc_f2[k] + a_h * t.f2;
          acc_r[k] = acc_r[k] + a_h * radius;
          f0_bar = f0_bar + a_h * mc.w1[0][k];
          f3_bar = f3_bar + a_h * mc.w1[3][k];
        }
        acc_b2 = acc_b2 + z_bar;
        const float dl_bar = (t.dl >= 0.f ? f0_bar : -f0_bar) / gdiv;
        lp = lp - dl_bar;
        gstd_bar = gstd_bar
            + (f3_bar - f0_bar * (fabsf(t.dl) / (gdiv * gdiv)));
        const int k = i * 5 + j;
        w_plane[(size_t)k * n + p] = t.wt;
        l_plane[(size_t)k * n + p] = dl_bar;
      }
    }
    pix[p] = make_float4(ab0, ab1, ab2, vbar);
    pix2[p] = make_float2(lp, g >= 1e-12f ? gstd_bar / (gstd + gstd) : 0.f);
  }
  // the block's sums of the parameter gradients, pack_mlp's order: w1
  // rows 0-5 (row 3 gstd x the b1 sum, row 4 it x it), b1, w2, then b2
  float* out = partial + (size_t)blockIdx.x * kMlpFloats;
#pragma unroll
  for (int grp = 0; grp < 9; ++grp) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      float v;
      switch (grp) {
        case 0: v = acc_f0[k]; break;
        case 1: v = acc_f1[k]; break;
        case 2: v = acc_f2[k]; break;
        case 3: v = gstd * acc_b1[k]; break;
        case 4: v = s.it_feature * acc_b1[k]; break;
        case 5: v = acc_r[k]; break;
        case 6: v = acc_b1[k]; break;
        case 7: v = acc_w2[k]; break;
        default: v = k == 0 ? acc_b2 : 0.f;
      }
      red[k][tid] = v;
    }
    __syncthreads();
#pragma unroll
    for (int half = kGradThreads / 2; half > 0; half >>= 1) {
      if (tid < half) {
#pragma unroll
        for (int k = 0; k < 16; ++k) red[k][tid] = red[k][tid] + red[k][tid + half];
      }
      __syncthreads();
    }
    if (grp < 8 && tid < 16) out[grp * 16 + tid] = red[tid][0];
    if (grp == 8 && tid == 0) out[128] = red[0][0];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(256) atrous_grad_gather_kernel(
    int h, int w, int step, const float* __restrict__ w_plane,
    const float* __restrict__ l_plane, const float4* __restrict__ pix,
    const float2* __restrict__ pix2, float* __restrict__ d_color,
    float* __restrict__ d_var) {
  const int n = h * w;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  const int y = q / w, x = q - (q / w) * w;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, dv = 0.f, lum = pix2[q].x;
  // tap (i, j) of the pixel p = (y + (i - 2) s, x + (j - 2) s) read q
#pragma unroll 1
  for (int i = 0; i < 5; ++i) {
    const int row = wrap(y + (i - 2) * step, h) * w;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const int pp = row + wrap(x + (j - 2) * step, w);
      const size_t at = (size_t)(i * 5 + j) * n + pp;
      const float wt = __ldg(w_plane + at);
      const float4 pb = __ldg(pix + pp);
      c0 = c0 + pb.x * wt;
      c1 = c1 + pb.y * wt;
      c2 = c2 + pb.z * wt;
      dv = dv + pb.w * (wt * wt);
      lum = lum + __ldg(l_plane + at);
    }
  }
  // the _gauss3 adjoint: the same (1,2,1)/4 blur of the blurred
  // variance's adjoint, down the rows, then along the columns
  const int yp = y + 1 == h ? 0 : y + 1, ym = y == 0 ? h - 1 : y - 1;
  float r3[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int xx = j == 0 ? (x + 1 == w ? 0 : x + 1)
        : j == 1 ? x : (x == 0 ? w - 1 : x - 1);
    r3[j] = (0.25f * __ldg(&pix2[yp * w + xx].y)
             + 0.5f * __ldg(&pix2[y * w + xx].y))
        + 0.25f * __ldg(&pix2[ym * w + xx].y);
  }
  const float gb = (0.25f * r3[0] + 0.5f * r3[1]) + 0.25f * r3[2];
  d_color[3 * q] = c0 + lum * 0.2126f;
  d_color[3 * q + 1] = c1 + lum * 0.7152f;
  d_color[3 * q + 2] = c2 + lum * 0.0722f;
  d_var[q] = dv + gb;
}

// block b sums column b of the (blocks, 129) rows, in a fixed order
__global__ void __launch_bounds__(256) atrous_grad_sum_kernel(
    int blocks, const float* __restrict__ partial, float* __restrict__ out) {
  __shared__ float red[256];
  const int t = threadIdx.x;
  float acc = 0.f;
  for (int b = t; b < blocks; b += 256)
    acc = acc + __ldg(partial + (size_t)b * kMlpFloats + blockIdx.x);
  red[t] = acc;
  __syncthreads();
#pragma unroll
  for (int half = 128; half > 0; half >>= 1) {
    if (t < half) red[t] = red[t] + red[t + half];
    __syncthreads();
  }
  if (t == 0) out[blockIdx.x] = red[0];
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

// the learned iteration's first backward kernel: height, width, tap step,
// StepScalars (host float[8]), MlpConst (host float[kMlpConstFloats]),
// the iteration's carried float4s and guide rows, the cotangents of its
// colour (h, w, 3) and variance (h, w; NULL: 0), out: the tap weights and
// luminance adjoints (25, h, w) each, the pixel terms (h, w, 4) and
// (h, w, 2), the blocks' parameter rows (ceil(h w / 128), 129), stream
extern "C" int mpt_atrous_grad_taps(int h, int w, int step, const float* s,
                                    const float* mlp, const void* cv,
                                    const void* guide, const void* g_out,
                                    const void* u_out, void* w_plane,
                                    void* l_plane, void* pix, void* pix2,
                                    void* partial, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if (step <= 0 || mlp == nullptr) return (int)cudaErrorInvalidValue;
  const StepScalars sc = {s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]};
  MlpConst mc = {};
  float* dst = (float*)&mc;
  for (int i = 0; i < kMlpConstFloats; ++i) dst[i] = mlp[i];
  const int blocks = (h * w + kGradThreads - 1) / kGradThreads;
  atrous_grad_taps_kernel<<<blocks, kGradThreads, 0, (cudaStream_t)stream>>>(
      h, w, step, sc, mc, (const float4*)cv, (const float4*)guide,
      (const float*)g_out, (const float*)u_out, (float*)w_plane,
      (float*)l_plane, (float4*)pix, (float2*)pix2, (float*)partial);
  return (int)cudaGetLastError();
}

// the second: height, width, tap step, the first's planes and pixel
// terms, out: the colour (h, w, 3) and variance (h, w) cotangents, stream
extern "C" int mpt_atrous_grad_gather(int h, int w, int step,
                                      const void* w_plane,
                                      const void* l_plane, const void* pix,
                                      const void* pix2, void* d_color,
                                      void* d_var, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if (step <= 0) return (int)cudaErrorInvalidValue;
  const int n = h * w;
  atrous_grad_gather_kernel<<<(n + 255) / 256, 256, 0,
                              (cudaStream_t)stream>>>(
      h, w, step, (const float*)w_plane, (const float*)l_plane,
      (const float4*)pix, (const float2*)pix2, (float*)d_color,
      (float*)d_var);
  return (int)cudaGetLastError();
}

// the third: the rows' count, the rows (blocks, 129), out (129), stream
extern "C" int mpt_atrous_grad_sum(int blocks, const void* partial,
                                   void* out, void* stream) {
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  atrous_grad_sum_kernel<<<kMlpFloats, 256, 0, (cudaStream_t)stream>>>(
      blocks, (const float*)partial, (float*)out);
  return (int)cudaGetLastError();
}

// threads a block of the first, for the wrapper's row count
extern "C" int mpt_atrous_grad_threads() { return kGradThreads; }
