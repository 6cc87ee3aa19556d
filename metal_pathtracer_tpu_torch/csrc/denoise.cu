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

// WSUM (LEARNED, unpacked out only): also write each pixel's weight sum
// (out_wsum), which the backward reads in place of retaking the taps
template <int MODE, bool PACKED_OUT, bool WSUM = false>
__global__ void __launch_bounds__(kThreads) atrous_step_kernel(
    int h, int w, int step, int cy, int cx, int tiles_x, StepScalars s,
    const __grid_constant__ MlpConst mc, const float4* __restrict__ cv,
    const float4* __restrict__ guide, float4* __restrict__ out_cv,
    float* __restrict__ out_color, float* __restrict__ out_var,
    float* __restrict__ out_wsum) {
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
    if constexpr (WSUM) out_wsum[p] = wsum;
  }
}

template <int MODE>
int launch_step(int h, int w, int step, const StepScalars& sc,
                const MlpConst& mc, const float4* cv, const float4* guide,
                float4* out_cv, float* out_color, float* out_var,
                float* out_wsum, cudaStream_t st) {
  // cosets of the step that hold a pixel, and the lattice tiles of the
  // largest coset (ceil(h / s) x ceil(w / s) points)
  const int cy = step < h ? step : h, cx = step < w ? step : w;
  const int tiles_y = ((h + step - 1) / step + kBY - 1) / kBY;
  const int tiles_x = ((w + step - 1) / step + kBX - 1) / kBX;
  const long long blocks = (long long)cy * cx * tiles_y * tiles_x;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 block(kBX, kBY), grid((unsigned)blocks);
  if (out_wsum != nullptr) {
    if (MODE != kLearned || out_cv != nullptr)
      return (int)cudaErrorInvalidValue;
    atrous_step_kernel<kLearned, false, true><<<grid, block, 0, st>>>(
        h, w, step, cy, cx, tiles_x, sc, mc, cv, guide, out_cv, out_color,
        out_var, out_wsum);
  } else if (out_cv != nullptr) {
    atrous_step_kernel<MODE, true><<<grid, block, 0, st>>>(
        h, w, step, cy, cx, tiles_x, sc, mc, cv, guide, out_cv, out_color,
        out_var, nullptr);
  } else {
    atrous_step_kernel<MODE, false><<<grid, block, 0, st>>>(
        h, w, step, cy, cx, tiles_x, sc, mc, cv, guide, out_cv, out_color,
        out_var, nullptr);
  }
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
// atrous_grad_taps_kernel takes each of a pixel's 25 taps once. The
// forward's o, o_v and S (LearnedIteration saves them; S is the step
// kernel's WSUM output, the bits a retake of the taps would give) give
// g / m, u / m^2 and dL/dS = -(g / m).o - 2 (u / m^2) o_v m before the
// first tap. Each tap is then recomputed as the forward computes it, up
// to its logit z (the same operations, so the same bits), and taken
// back: w_pk = w_k exp(-softplus(z)), dL/dw_pk = (g / m).c_q + 2 w_pk
// (u / m^2) v_q + dL/dS, dL/dz = -dL/dw w_k exp(-softplus(z))
// sigmoid(z), through the 6-16-1 MLP (a hidden unit passes where its
// pre-activation >= 0), feature 0 to the luminance difference (sign +1
// at 0, JAX's) and to gstd_p, gstd to the blurred variance. It writes
// w_pk and the adjoint of lum_q as (25, n) planes, each pixel's own
// terms (g / m, u / m^2; the adjoints of lum_p and of the blurred
// variance), and a row of the 129 parameter sums a block.
// atrous_grad_gather_kernel, a thread a pixel q: gathers from the pixels
// p = q + (ky, kx) s that tapped it, in tap order: dL/dc_q = sum_k w_pk
// g_p / m_p + lum weights x (its own and the taps' luminance adjoints),
// dL/dv_q = sum_k w_pk^2 u_p / m_p^2 + the _gauss3 adjoint (the same
// symmetric blur, wrapping) of the blurred variance's adjoint.
// atrous_grad_sum_kernel: a block a parameter sums the blocks' rows in a
// fixed order.
//
// What bounds the taps kernel on an H100: instruction issue. A tap is
// ~500 float operations (the forward once, 222 hoisted; the tap back,
// 283: the MLP's layers back and six parameter sums a hidden unit), each
// its own instruction but the sums' explicit fused multiply-adds; the
// bytes (~310 a pixel: rows, saved sums, cotangents, planes) are a fifth
// of that time. A thread that owns all 16 hidden units keeps 96 sums in
// registers, and the card then runs too few warps to keep issuing (the
// first port's kernel: 182 registers, 8 warps an SM, each tap's forward
// taken twice). So:
// - a block is two warps over one group: 8 x 2 lattice points of one
//   coset of the step (the forward's lattice), its 12 x 6 tile of taps
//   staged once in shared memory, a tap's three rows side by side, with
//   the wrap taken at the load (a halo tile at step 1);
// - warp h owns hidden units 4h..4h+3 and 8+4h..11+4h: their
//   pre-activations and six sums (48 in registers and 8 per-pixel b1
//   sums), the weights as warp-uniform constant-bank operands. Its half
//   of the MLP's second layer is a subtree of the forward's ((l0 + l1) +
//   (l2 + l3)) + ((l4 + l5) + (l6 + l7)), so z = (warp 0's + warp 1's) +
//   b2 keeps the forward's bits. The halves meet in shared memory once a
//   tap (a barrier of the two warps), which also carries the previous
//   tap's partial adjoints of features 0 and 3; 127 registers, 8 blocks
//   (16 warps) an SM;
// - lanes 0-15 take the group's 16 pixels, lanes 16-31 the same pixels'
//   mirrored taps (24 - t beside t: the same radius and B3 weight, so the
//   launch constants stay warp-uniform): 13 steps for 25 taps;
// - both warps repeat a tap's scalar work (its features, then z to
//   dL/dz), so that chain is kept short: exp(-softplus(z)) = sigmoid(-z)
//   and sigmoid(z) come from one exp(-|z|) and one reciprocal (within a
//   few ulps of the forward's expf / log1pf / expf), and the adjoints' two
//   divisions by gstd + 1e-4 are products by its reciprocal, once a
//   pixel;
// - blocks are persistent, one wave (the occupancy API's blocks an SM x
//   the SMs), striding over the groups, so the parameter sums leave the
//   registers once a block: each sum over its warp's 32 lanes in lane
//   order, one row a block. No atomics: two launches give the same bits.
// Slower on the card (PERF.md): the split with the forward's own
// softplus chain and divisions; one warp a group owning all 16 units,
// its pre-activations in shared memory (it spills at 128 registers); 9
// blocks an SM with the pre-activations parked in shared memory.
constexpr int kGradThreads = 64;
// a group of 8 x 2 lattice points and its tile (a 2-point halo)
constexpr int kGX = 8, kGY = 2, kGTX = kGX + 4, kGTY = kGY + 4;
constexpr int kGTile = kGTX * kGTY;
constexpr int kMlpFloats = 6 * 16 + 16 + 16 + 1;
// a thread's sums in shared memory, 8 a slot of its warp's units: w1 rows
// 0-2, row 3 (gstd x b1), row 5 (radius), b1, w2; then b2 (warp 0)
constexpr int kF0 = 0, kF1 = 8, kF2 = 16, kG = 24, kR = 32, kB1 = 40,
              kW2 = 48, kB2 = 56, kSlots = 57;
constexpr int kRedStride = kGradThreads + 1;   // no bank conflicts

// the two warps of a block meet
__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kGradThreads) : "memory");
}

// the hidden unit of slot u (0-7) of warp H
template <int H>
__device__ __forceinline__ int unit(int u) {
  return u < 4 ? 4 * H + u : 4 + 4 * H + u;
}

// the groups of a launch: cosets of the step that hold a pixel (cy x cx)
// x the 8 x 2 lattice tiles of the largest coset; groups < 0 if too many
struct GradGrid {
  int cy, cx, tiles_x, groups;
};

GradGrid grad_grid(int h, int w, int step) {
  GradGrid g;
  g.cy = step < h ? step : h;
  g.cx = step < w ? step : w;
  const long long tiles_y = ((h + step - 1) / step + kGY - 1) / kGY;
  g.tiles_x = ((w + step - 1) / step + kGX - 1) / kGX;
  const long long groups = (long long)g.cy * g.cx * tiles_y * g.tiles_x;
  g.groups = groups > 0x7fffffffLL ? -1 : (int)groups;
  return g;
}

// one warp's share of a block: all its groups, then its sums
template <int H>
__device__ __forceinline__ void grad_taps_warp(
    int h, int w, int step, GradGrid gg, float it_feature,
    const MlpConst& mc, const float4* __restrict__ cv,
    const float4* __restrict__ guide, const float* __restrict__ out,
    const float* __restrict__ out_var, const float* __restrict__ wsum,
    const float* __restrict__ g_out, const float* __restrict__ u_out,
    float* __restrict__ w_plane, float* __restrict__ l_plane,
    float4* __restrict__ pix, float2* __restrict__ pix2,
    float* __restrict__ partial, float4 (*tile)[3], float4 (*xbuf)[2][32],
    float (*red)[kRedStride]) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int mirror = lane >> 4, ty = (lane >> 3) & 1, tx = lane & 7;
  const int n = h * w, cosets = gg.cy * gg.cx;
  // the lane's tile slot at step st, tap (i, j): centre + 2 (kGTX + 1) -
  // (i kGTX + j) for lanes 0-15, the mirror's centre - 2 (kGTX + 1) +
  // (i kGTX + j)
  const int centre = (ty + 2) * kGTX + tx + 2;
  const int sgn = mirror ? 1 : -1, slot0 = centre - sgn * 2 * (kGTX + 1);
  float acc_f0[8], acc_f1[8], acc_f2[8], acc_r[8], acc_w2[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    acc_f0[u] = acc_f1[u] = acc_f2[u] = acc_r[u] = acc_w2[u] = 0.f;
    red[kG + u][tid] = red[kB1 + u][tid] = 0.f;
  }
  float acc_b2 = 0.f;
  for (int grp = blockIdx.x; grp < gg.groups; grp += gridDim.x) {
    const int coset = grp % cosets, lt = grp / cosets;
    const int ry = coset / gg.cx, rx = coset - ry * gg.cx;
    const int u0 = (lt / gg.tiles_x) * kGY, v0 = (lt % gg.tiles_x) * kGX;
    // stage the tile (the last group's last read came before its last
    // barrier)
    for (int k = tid; k < kGTile; k += kGradThreads) {
      const int a = k / kGTX, b = k - a * kGTX;
      const int q = wrap(ry + step * (u0 - 2 + a), h) * w
          + wrap(rx + step * (v0 - 2 + b), w);
      tile[k][0] = __ldg(cv + q);
      tile[k][1] = __ldg(guide + 2 * q);
      tile[k][2] = __ldg(guide + 2 * q + 1);
    }
    pair_sync();
    const int y0 = ry + step * (u0 + ty), x0 = rx + step * (v0 + tx);
    const bool valid = y0 < h && x0 < w;
    // a lane without a pixel reads pixel 0's terms and adds nothing
    const int y = valid ? y0 : 0, x = valid ? x0 : 0, p = y * w + x;
    const float4 cc = tile[centre][0], ca = tile[centre][1],
                 cn = tile[centre][2];
    const float lum_p = luminance(cc.x, cc.y, cc.z);
    // ops/denoise.py _gauss3 at (y, x), as the forward forms it
    float r3[3];
    if (step == 1) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int col = tx + 3 - j;
        r3[j] = (0.25f * tile[(ty + 3) * kGTX + col][0].w
                 + 0.5f * tile[(ty + 2) * kGTX + col][0].w)
            + 0.25f * tile[(ty + 1) * kGTX + col][0].w;
      }
    } else {
      const int yp = y + 1 == h ? 0 : y + 1, ym = y == 0 ? h - 1 : y - 1;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int xx = j == 0 ? (x + 1 == w ? 0 : x + 1)
            : j == 1 ? x : (x == 0 ? w - 1 : x - 1);
        r3[j] = (0.25f * var_at(cv, w, yp, xx) + 0.5f * var_at(cv, w, y, xx))
            + 0.25f * var_at(cv, w, ym, xx);
      }
    }
    const float g = (0.25f * r3[0] + 0.5f * r3[1]) + 0.25f * r3[2];
    const float gstd = sqrtf(fmaxf(g, 1e-12f)), gdiv = gstd + 1e-4f;
    const float rg = __frcp_rn(gdiv);
    float p3[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) p3[u] = gstd * mc.w1[3][unit<H>(u)];
    // the forward's sums: dL/dA = g / m, dL/dV = u / m^2, dL/dS
    const float ws = __ldg(wsum + p), mm = fmaxf(ws, 1e-6f);
    const float ab0 = __ldg(g_out + 3 * p) / mm,
                ab1 = __ldg(g_out + 3 * p + 1) / mm,
                ab2 = __ldg(g_out + 3 * p + 2) / mm;
    const float vbar = u_out == nullptr ? 0.f : __ldg(u_out + p) / (mm * mm);
    const float sbar = ws >= 1e-6f
        ? -dot3(ab0, ab1, ab2, __ldg(out + 3 * p), __ldg(out + 3 * p + 1),
                __ldg(out + 3 * p + 2))
            - ((vbar + vbar) * __ldg(out_var + p)) * mm
        : 0.f;
    float pb1[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) pb1[u] = 0.f;
    float lp = 0.f, gstd_bar = 0.f;
    // the last tap's partial adjoints of features 0 and 3 (this warp's
    // units), its luminance difference and plane (-1: nothing to finish)
    float f0b = 0.f, f3b = 0.f, dl_last = 0.f;
    int plane_last = -1;
    // warp 0 finishes the last tap's luminance and gstd adjoints once
    // the other warp's partials have arrived
    auto finish = [&](float f0o, float f3o) {
      if (H != 0 || plane_last < 0) return;
      const float f0t = f0b + f0o, f3t = f3b + f3o;
      const float dl_bar = (dl_last >= 0.f ? f0t : -f0t) * rg;
      lp = lp - dl_bar;
      gstd_bar = gstd_bar + (f3t - f0t * ((fabsf(dl_last) * rg) * rg));
      l_plane[(size_t)plane_last * n + p] = dl_bar;
    };
    // lanes 0-15 take tap (i, j) = divmod(st, 5), lanes 16-31 tap
    // (4 - i, 4 - j); the mirror's centre (st 12) is lanes 0-15's
#pragma unroll 1
    for (int st = 0, i = 0, j = 0; st < 13; ++st) {
      const int di = i < 2 ? 2 - i : i - 2, dj = j < 2 ? 2 - j : j - 2;
      const int r = di + dj;
      const float wk = spline(di) * spline(dj);
      const bool live = valid && !(mirror && st == 12);
      const int t = mirror ? 24 - st : st;
      // tap (i, j) reads the roll source (y - (i - 2) s, x - (j - 2) s)
      const float4* tp = tile[slot0 + sgn * (i * kGTX + j)];
      const float4 sc = tp[0], sa = tp[1], sn = tp[2];
      if (++j == 5) {
        j = 0;
        ++i;
      }
      const float da0 = sa.x - ca.x, da1 = sa.y - ca.y, da2 = sa.z - ca.z;
      const float f2 = dot3(da0, da1, da2, da0, da1, da2);
      const float ndot = dot3(sn.x, sn.y, sn.z, cn.x, cn.y, cn.z);
      const bool both_bg = cn.w < 0.5f && sn.w < 0.5f;
      const float dl = luminance(sc.x, sc.y, sc.z) - lum_p;
      const float f0 = fabsf(dl) / gdiv;
      const float f1 = both_bg ? 0.f : fmaxf(1.f - ndot, 0.f);
      // this warp's hidden units, and its subtree of the second layer
      float pre[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = unit<H>(u);
        const float a = ((f0 * mc.w1[0][k] + f1 * mc.w1[1][k])
                         + (f2 * mc.w1[2][k] + p3[u])) + mc.tab[r][k];
        pre[u] = a + mc.b1[k];
      }
      float ln[4];
#pragma unroll
      for (int l = 0; l < 4; ++l)
        ln[l] = __fmaf_rn(fmaxf(pre[4 + l], 0.f), mc.w2[unit<H>(4 + l)],
                          fmaxf(pre[l], 0.f) * mc.w2[unit<H>(l)]);
      const float zh = (ln[0] + ln[1]) + (ln[2] + ln[3]);
      xbuf[st & 1][H][lane] = make_float4(zh, f0b, f3b, 0.f);
      pair_sync();
      const float4 other = xbuf[st & 1][1 - H][lane];
      const float z = (H == 0 ? zh + other.x : other.x + zh) + mc.b2;
      finish(other.y, other.z);
      // exp(-softplus(z)) = sigmoid(-z) and sigmoid(z) from one
      // exp(-|z|) and one reciprocal: within a few ulps of the forward's
      // exp(-softplus(z)), at a third of its chain
      const float ex = expf(-fabsf(z)), rc = __fdividef(1.f, 1.f + ex);
      const float e = (z >= 0.f ? ex : 1.f) * rc,
                  sig = (z >= 0.f ? 1.f : ex) * rc;
      const float wt = wk * e;
      if (H == 1 && live) w_plane[(size_t)t * n + p] = wt;
      const float w_bar = (dot3(ab0, ab1, ab2, sc.x, sc.y, sc.z)
                           + (wt + wt) * (vbar * sc.w)) + sbar;
      const float z_bar = live ? -((w_bar * wk) * e) * sig : 0.f;
      const float radius = (float)r * 0.25f;
      f0b = f3b = 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = unit<H>(u);
        // branch-free: a closed unit adds zeros
        const float a_h = pre[u] >= 0.f ? z_bar * mc.w2[k] : 0.f;
        acc_w2[u] = __fmaf_rn(z_bar, fmaxf(pre[u], 0.f), acc_w2[u]);
        pb1[u] = pb1[u] + a_h;
        acc_f0[u] = __fmaf_rn(a_h, f0, acc_f0[u]);
        acc_f1[u] = __fmaf_rn(a_h, f1, acc_f1[u]);
        acc_f2[u] = __fmaf_rn(a_h, f2, acc_f2[u]);
        acc_r[u] = __fmaf_rn(a_h, radius, acc_r[u]);
        f0b = __fmaf_rn(a_h, mc.w1[0][k], f0b);
        f3b = __fmaf_rn(a_h, mc.w1[3][k], f3b);
      }
      if (H == 0) acc_b2 = acc_b2 + z_bar;
      dl_last = dl;
      plane_last = live ? t : -1;
    }
    // the last tap's partials (step 13's buffer: read last at step 11)
    xbuf[1][H][lane] = make_float4(0.f, f0b, f3b, 0.f);
    pair_sync();
    if (H == 0) {
      const float4 other = xbuf[1][1][lane];
      finish(other.y, other.z);
      // the pixel's sums over both halves of its taps, lanes 0-15's first
      const float lp_m = __shfl_xor_sync(0xffffffffu, lp, 16),
                  gb_m = __shfl_xor_sync(0xffffffffu, gstd_bar, 16);
      if (!mirror && valid) {
        pix[p] = make_float4(ab0, ab1, ab2, vbar);
        pix2[p] = make_float2(
            lp + lp_m, g >= 1e-12f ? (gstd_bar + gb_m) / (gstd + gstd) : 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      red[kB1 + u][tid] = red[kB1 + u][tid] + pb1[u];
      red[kG + u][tid] = __fmaf_rn(gstd, pb1[u], red[kG + u][tid]);
    }
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    red[kF0 + u][tid] = acc_f0[u];
    red[kF1 + u][tid] = acc_f1[u];
    red[kF2 + u][tid] = acc_f2[u];
    red[kR + u][tid] = acc_r[u];
    red[kW2 + u][tid] = acc_w2[u];
  }
  red[kB2][tid] = acc_b2;
  pair_sync();
  // the block's row, pack_mlp's order (w1 rows 0-5, b1, w2, b2): each
  // value the sum over its owner warp's lanes in lane order; row 4 is
  // it_feature x the b1 sum
  for (int o = tid; o < kMlpFloats; o += kGradThreads) {
    const int row = o >> 4, k = o & 15;
    const int owner = o == kMlpFloats - 1 ? 0 : (k & 7) >> 2;
    const int u = (k & 3) + 4 * (k >> 3);
    const int slot = o == kMlpFloats - 1 ? kB2
        : (row == 0 ? kF0 : row == 1 ? kF1 : row == 2 ? kF2 : row == 3 ? kG
           : row == 5 ? kR : row == 7 ? kW2 : kB1) + u;
    float sum = 0.f;
    for (int l = 0; l < 32; ++l) sum = sum + red[slot][32 * owner + l];
    partial[(size_t)blockIdx.x * kMlpFloats + o] =
        row == 4 ? it_feature * sum : sum;
  }
}

__global__ void __launch_bounds__(kGradThreads, 8) atrous_grad_taps_kernel(
    int h, int w, int step, GradGrid gg, StepScalars s,
    const __grid_constant__ MlpConst mc, const float4* __restrict__ cv,
    const float4* __restrict__ guide, const float* __restrict__ out,
    const float* __restrict__ out_var, const float* __restrict__ wsum,
    const float* __restrict__ g_out, const float* __restrict__ u_out,
    float* __restrict__ w_plane, float* __restrict__ l_plane,
    float4* __restrict__ pix, float2* __restrict__ pix2,
    float* __restrict__ partial) {
  // each tile point's (colour and variance, albedo, normal)
  __shared__ float4 tile[kGTile][3];
  __shared__ float4 xbuf[2][2][32];
  __shared__ float red[kSlots][kRedStride];
  if (threadIdx.x < 32)
    grad_taps_warp<0>(h, w, step, gg, s.it_feature, mc, cv, guide, out,
                      out_var, wsum, g_out, u_out, w_plane, l_plane, pix,
                      pix2, partial, tile, xbuf, red);
  else
    grad_taps_warp<1>(h, w, step, gg, s.it_feature, mc, cv, guide, out,
                      out_var, wsum, g_out, u_out, w_plane, l_plane, pix,
                      pix2, partial, tile, xbuf, red);
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
// (h, w, 3) and out variance (h, w; not FIXED), out weight sums (h, w;
// NULL but for a learned iteration whose backward will run), stream
extern "C" int mpt_atrous_step(int mode, int h, int w, int step,
                               const float* s, const float* mlp,
                               const void* cv, const void* guide,
                               void* out_cv, void* out_color, void* out_var,
                               void* out_wsum, void* stream) {
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
  float *ocol = (float*)out_color, *ov = (float*)out_var,
        *ows = (float*)out_wsum;
  switch (mode) {
    case kFixed:
      return launch_step<kFixed>(h, w, step, sc, mc, c, g, oc, ocol, ov, ows,
                                 st);
    case kSvgf:
      return launch_step<kSvgf>(h, w, step, sc, mc, c, g, oc, ocol, ov, ows,
                                st);
    case kLearned:
      return launch_step<kLearned>(h, w, step, sc, mc, c, g, oc, ocol, ov,
                                   ows, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// floats of MlpConst, for the wrapper's check
extern "C" int mpt_atrous_mlp_floats() { return kMlpConstFloats; }

// blocks of the first backward kernel resident on one SM of the current
// device (the occupancy API), cached by device
static int grad_blocks_per_sm() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  if (cached[dev] == 0) {
    int per = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per, atrous_grad_taps_kernel, kGradThreads, 0) != cudaSuccess)
      return -1;
    cached[dev] = per;
  }
  return cached[dev];
}

// blocks of the first backward kernel an SM (-1 on an error)
extern "C" int mpt_atrous_grad_blocks_per_sm() { return grad_blocks_per_sm(); }

// blocks (and so parameter rows) of the first backward kernel at height,
// width and tap step: its groups, at most one wave (blocks an SM x SMs);
// -1 on an error
extern "C" int mpt_atrous_grad_blocks(int h, int w, int step) {
  if (h <= 0 || w <= 0 || step <= 0) return -1;
  const GradGrid gg = grad_grid(h, w, step);
  int dev = 0, sms = 0;
  const int per = grad_blocks_per_sm();
  if (gg.groups < 0 || per <= 0 || cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
          != cudaSuccess)
    return -1;
  const long long wave = (long long)per * sms;
  return gg.groups < wave ? gg.groups : (int)wave;
}

// the learned iteration's first backward kernel: height, width, tap step,
// StepScalars (host float[8]), MlpConst (host float[kMlpConstFloats]),
// the iteration's carried float4s and guide rows, its forward's colour
// (h, w, 3), variance and weight sums (h, w), the cotangents of its colour
// (h, w, 3) and variance (h, w; NULL: 0), out: the tap weights and
// luminance adjoints (25, h, w) each, the pixel terms (h, w, 4) and
// (h, w, 2), the blocks' parameter rows (blocks, 129), the block count
// (mpt_atrous_grad_blocks), stream
extern "C" int mpt_atrous_grad_taps(
    int h, int w, int step, const float* s, const float* mlp, const void* cv,
    const void* guide, const void* out, const void* out_var,
    const void* wsum, const void* g_out, const void* u_out, void* w_plane,
    void* l_plane, void* pix, void* pix2, void* partial, int blocks,
    void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if (step <= 0 || mlp == nullptr || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const GradGrid gg = grad_grid(h, w, step);
  if (gg.groups < 0) return (int)cudaErrorInvalidConfiguration;
  const StepScalars sc = {s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]};
  MlpConst mc = {};
  float* dst = (float*)&mc;
  for (int i = 0; i < kMlpConstFloats; ++i) dst[i] = mlp[i];
  atrous_grad_taps_kernel<<<blocks, kGradThreads, 0, (cudaStream_t)stream>>>(
      h, w, step, gg, sc, mc, (const float4*)cv, (const float4*)guide,
      (const float*)out, (const float*)out_var, (const float*)wsum,
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
