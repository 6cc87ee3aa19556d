// K2: one depth of shading per lane (stage "full", lambert, no NEE).
//
// Replaces the TPU fused shade megakernel ops/pallas/shade.py
// (_shade_kernel:1845, launched by _shade_call:2536) for the lambert type
// set. Per lane it does what the reference integrator body
// (ops/integrator.py trace_paths:261-719) does for that configuration,
// in the same order as its plain version ops/kernels/shade.py
// shade_full_reference:
//   hit rebuild from the shade_packed row, gathered here by tri id
//   (traversal._hit_record_from_best); miss -> gradient or solid
//   background, working colour space, firefly clamp; material fetch;
//   first-hit AOVs; lambert cosine sampling; throughput update and clamp;
//   ray cone; Russian roulette at depth >= 5; next origin
//   (intersect.offset_ray_origin); commit.
// It updates the carry arrays and the RNG state (uint32 values held in
// int64) IN PLACE; lanes that enter dead keep every value, lanes that miss
// end their path.
//
// What bounds it on an H100: bytes. A live lane reads ~100 B of carry,
// gathers one 96 B shade_packed row at a random triangle and writes the
// carry back; the arithmetic (one cos/sin pair, a few sqrt/div) is small
// beside that. The design touches each carry value once per depth, keeps
// every intermediate in registers, and returns at once for dead lanes so
// late depths cost little. It is written in CUDA rather than Triton for
// uint32 PCG arithmetic, the per-lane branches, and explicit control of
// FMA contraction (__fmaf_rn only where the plain version fuses).
#include "common.cuh"

#define PI_F 3.14159265358979323846f
#define RAY_ORIGIN_EPSILON 1.0e-4f
#define INFINITY_T 1.0e20f

namespace {

struct ShadeParams {
  int background_mode;  // 0 gradient, 1 solid
  int working_space;    // 0 linear sRGB, 1 ACEScg
  int russian_roulette;
  V3 background;
  float clamp_enabled, clamp_factor, clamp_floor, max_contribution,
      throughput_clamp;
};

__device__ V3 to_acescg(V3 c) {
  return v3(fmaf_rn(0.047380f, c.z, fmaf_rn(0.339523f, c.y, 0.613097f * c.x)),
            fmaf_rn(0.013452f, c.z, fmaf_rn(0.916354f, c.y, 0.070194f * c.x)),
            fmaf_rn(0.869816f, c.z, fmaf_rn(0.109569f, c.y, 0.020615f * c.x)));
}

// bsdf.clamp_firefly_contribution
__device__ V3 clamp_firefly(V3 tp, V3 contribution, const ShadeParams& p) {
  V3 combined = tp * contribution;
  bool finite = finite3(combined);
  V3 positive = cmin3(combined, 0.0f);
  float lum = luminance3(positive);
  float tp_lum = luminance3(cmin3(tp, 0.0f));
  float max_lum = cmin(tp_lum * p.clamp_factor, p.clamp_floor);
  if (p.max_contribution > 0.0f) max_lum = cmin(max_lum, p.max_contribution);
  float scale = (lum > max_lum && lum > 0.0f) ? max_lum / cmin(lum, 1e-6f)
                                                : 1.0f;
  V3 out = p.clamp_enabled < 0.5f ? positive : cmin3(combined * scale, 0.0f);
  return finite ? out : v3(0.0f, 0.0f, 0.0f);
}

// bsdf.clamp_path_throughput
__device__ V3 clamp_throughput(V3 tp, const ShadeParams& p) {
  bool finite = finite3(tp);
  float lum = luminance3(cmin3(tp, 0.0f));
  float scale = (lum > p.throughput_clamp && lum > 0.0f)
                    ? p.throughput_clamp / cmin(lum, 1e-6f)
                    : 1.0f;
  V3 out = tp;
  if (p.clamp_enabled >= 0.5f && p.throughput_clamp > 0.0f)
    out = v3(scale * tp.x, scale * tp.y, scale * tp.z);
  return finite ? out : v3(0.0f, 0.0f, 0.0f);
}

__global__ void shade_full_kernel(
    int n, int depth, const float* __restrict__ hit_t,
    const int* __restrict__ hit_tri, const float* __restrict__ hit_u,
    const float* __restrict__ hit_v, const float* __restrict__ shade_packed,
    const float* __restrict__ mat_base, int m_count, ShadeParams p,
    long long* state_io, float* ray_o_io, float* ray_d_io,
    float* throughput_io, float* radiance_io, bool* alive_io,
    bool* prev_valid_io, int* prev_mesh_io, int* prev_prim_io,
    bool* first_hit_io, float* aov_albedo_io, float* aov_normal_io,
    float* cone_w_io, float* cone_s_io) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !alive_io[i]) return;
  int tri = hit_tri[i];
  V3 ray_d = load3(ray_d_io, i);
  V3 tp0 = load3(throughput_io, i);

  if (tri < 0) {
    // ---- miss: background, then the path ends --------------------------
    V3 bg;
    if (p.background_mode == 1) {
      bg = p.background;
    } else {  // integrator.sky_color
      float t = 0.5f * (normalize3(ray_d).y + 1.0f);
      bg = v3(fmaf_rn(0.5f - 1.0f, t, 1.0f), fmaf_rn(0.7f - 1.0f, t, 1.0f),
              fmaf_rn(1.0f - 1.0f, t, 1.0f));
    }
    if (p.working_space == 1) bg = to_acescg(bg);
    store3(radiance_io, i, load3(radiance_io, i) + clamp_firefly(tp0, bg, p));
    prev_valid_io[i] = false;
    prev_mesh_io[i] = -1;
    prev_prim_io[i] = -1;
    alive_io[i] = false;
    return;
  }

  // ---- hit rebuild (traversal._hit_record_from_best) -------------------
  float t = hit_t[i], u = hit_u[i], v = hit_v[i];
  V3 ray_o = load3(ray_o_io, i);
  const float* row = shade_packed + 24LL * tri;
  V3 v0 = v3(row[0], row[1], row[2]);
  V3 v1 = v3(row[3], row[4], row[5]);
  V3 v2 = v3(row[6], row[7], row[8]);
  V3 n0 = v3(row[9], row[10], row[11]);
  V3 n1 = v3(row[12], row[13], row[14]);
  V3 n2 = v3(row[15], row[16], row[17]);
  int material = (int)row[18];
  int mesh = (int)row[19];
  V3 point = fma3(t, ray_d, ray_o);
  V3 geo_n = safe_normalize3(cross3(v1 - v0, v2 - v0));
  bool front = dot3(ray_d, geo_n) < 0.0f;
  V3 n_faced = sel(front, geo_n, -geo_n);
  // interpolate_shading_normal
  float w0 = cmin((1.0f - u) - v, 0.0f), w1 = cmin(u, 0.0f),
        w2 = cmin(v, 0.0f);
  float w_sum = (w0 + w1) + w2;
  bool has_w = w_sum > 1e-8f;
  w0 = has_w ? w0 / w_sum : 1.0f;
  w1 = has_w ? w1 / w_sum : 0.0f;
  w2 = has_w ? w2 / w_sum : 0.0f;
  V3 sn = v3(fmaf_rn(w2, n2.x, fmaf_rn(w0, n0.x, w1 * n1.x)),
             fmaf_rn(w2, n2.y, fmaf_rn(w0, n0.y, w1 * n1.y)),
             fmaf_rn(w2, n2.z, fmaf_rn(w0, n0.z, w1 * n1.z)));
  bool sn_ok = finite3(sn) && dot3(sn, sn) > 0.0f;
  sn = dot3(sn, n_faced) < 0.0f ? -sn : sn;
  sn = safe_normalize3(sn);
  V3 shading_n = sel(sn_ok, sn, n_faced);
  bool bad_sn = !finite3(shading_n) || dot3(shading_n, shading_n) <= 0.0f;
  if (bad_sn) shading_n = n_faced;

  // ---- material fetch, first-hit AOVs --------------------------------
  int mid = min(max(material, 0), m_count - 1);
  V3 base = v3(clampf(mat_base[3 * mid], 0.0f, 1.0f),
               clampf(mat_base[3 * mid + 1], 0.0f, 1.0f),
               clampf(mat_base[3 * mid + 2], 0.0f, 1.0f));
  if (first_hit_io[i]) {
    store3(aov_albedo_io, i, base);
    store3(aov_normal_io, i, shading_n);
    first_hit_io[i] = false;
  }

  // ---- ray cone at the hit -------------------------------------------
  float cone_w = cone_w_io[i], cone_s = cone_s_io[i];
  float ray_len = sqrtf(cmin(dot3(ray_d, ray_d), 1e-12f));
  float hit_world = cmin(t, 0.0f) * ray_len;
  float cone_at_hit = cmin(fmaf_rn(cone_s, hit_world, cone_w), 1e-7f);

  // ---- lambert sample (bsdf._sample_lambert) --------------------------
  uint32_t s = (uint32_t)state_io[i];
  float r1 = rand_uniform(&s);
  float r2 = rand_uniform(&s);
  float phi = 6.283185307179586f * r2;
  float r = sqrtf(cmin(r1, 0.0f));
  V3 local = v3(cosf(phi) * r, sinf(phi) * r, sqrtf(cmin(1.0f - r1, 0.0f)));
  bool nz = fabsf(shading_n.z) < 0.999f;
  V3 up = nz ? v3(0.0f, 0.0f, 1.0f) : v3(1.0f, 0.0f, 0.0f);
  V3 tangent = normalize3(cross3(up, shading_n));
  V3 bitangent = cross3(shading_n, tangent);
  V3 world = fma3(local.z, shading_n,
                  fma3(local.x, tangent, bitangent * local.y));
  V3 wi = safe_normalize3(world);
  float cos_i = dot3(shading_n, wi);
  float cos_t = cmin(dot3(shading_n, normalize3(wi)), 0.0f);
  float pdf = cos_t > 0.0f ? cos_t / PI_F : 0.0f;
  V3 f = base / PI_F;
  float ratio = cos_i / cmin(pdf, 1e-20f);
  V3 weight = cmin3(f * ratio, 0.0f);
  bool ok = cos_i > 0.0f && pdf > 0.0f && finite3(weight);
  V3 dir = ok ? wi : v3(0.0f, 0.0f, 0.0f);
  if (!ok) {
    weight = v3(0.0f, 0.0f, 0.0f);
    pdf = 0.0f;
  }
  bool active = pdf > 0.0f;

  // ---- next origin (intersect.offset_ray_origin) ----------------------
  V3 off_n = shading_n;
  if (!finite3(off_n) || dot3(off_n, off_n) <= 0.0f) off_n = n_faced;
  float sign = dot3(dir, off_n) >= 0.0f ? 1.0f : -1.0f;
  float dist = cmin(fabsf(t) * 1e-4f, RAY_ORIGIN_EPSILON);
  V3 next_o = fma3v(dir, RAY_ORIGIN_EPSILON * 0.5f,
                    fma3v(off_n, sign * dist, point));

  // ---- throughput -----------------------------------------------------
  V3 tp = clamp_throughput(tp0 * weight, p);
  float max_tp = maxn(maxn(tp.x, tp.y), tp.z);
  active = active && finite3(tp) && max_tp > 0.0f;
  if (active) {
    cone_w = cone_at_hit;
    cone_s = cmax(cone_s + 0.55f, 1.5f);  // lambert: diffuse lobe
  }

  // ---- Russian roulette -----------------------------------------------
  if (p.russian_roulette && depth >= 5 && active) {
    float xi = rand_uniform(&s);
    float cont_p = clampf(max_tp, 0.05f, 0.95f);
    bool survive = xi <= cont_p;
    if (survive)
      tp = v3(tp.x / cont_p, tp.y / cont_p, tp.z / cont_p);
    active = survive;
  }

  // ---- commit -------------------------------------------------------------
  state_io[i] = (long long)s;
  store3(ray_o_io, i, next_o);
  store3(ray_d_io, i, dir);
  store3(throughput_io, i, tp);
  prev_valid_io[i] = true;
  prev_mesh_io[i] = mesh;
  prev_prim_io[i] = tri;
  cone_w_io[i] = cone_w;
  cone_s_io[i] = cone_s;
  alive_io[i] = active;
}

}  // namespace

extern "C" int mpt_shade_full(
    int n, int depth, const void* t, const void* tri, const void* u,
    const void* v, const void* shade_packed, const void* mat_base,
    int m_count, int background_mode, int working_space,
    int russian_roulette, float bg_r, float bg_g, float bg_b,
    float clamp_enabled, float clamp_factor, float clamp_floor,
    float max_contribution, float throughput_clamp, void* state, void* ray_o,
    void* ray_d, void* throughput, void* radiance, void* alive,
    void* prev_valid, void* prev_mesh, void* prev_prim, void* first_hit,
    void* aov_albedo, void* aov_normal, void* cone_w, void* cone_s,
    void* stream) {
  if (n <= 0) return 0;
  ShadeParams p;
  p.background_mode = background_mode;
  p.working_space = working_space;
  p.russian_roulette = russian_roulette;
  p.background = v3(bg_r, bg_g, bg_b);
  p.clamp_enabled = clamp_enabled;
  p.clamp_factor = clamp_factor;
  p.clamp_floor = clamp_floor;
  p.max_contribution = max_contribution;
  p.throughput_clamp = throughput_clamp;
  const int block = 128;
  shade_full_kernel<<<(n + block - 1) / block, block, 0,
                      (cudaStream_t)stream>>>(
      n, depth, (const float*)t, (const int*)tri, (const float*)u,
      (const float*)v, (const float*)shade_packed, (const float*)mat_base,
      m_count, p, (long long*)state, (float*)ray_o, (float*)ray_d,
      (float*)throughput, (float*)radiance, (bool*)alive, (bool*)prev_valid,
      (int*)prev_mesh, (int*)prev_prim, (bool*)first_hit,
      (float*)aov_albedo, (float*)aov_normal, (float*)cone_w, (float*)cone_s);
  return (int)cudaGetLastError();
}
