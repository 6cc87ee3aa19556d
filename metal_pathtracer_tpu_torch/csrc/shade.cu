// K2: one depth of shading per lane, in three stages.
//
// Replaces the TPU fused shade megakernel ops/pallas/shade.py
// (_shade_kernel:1845, launched by _shade_call:2536):
//   shade_full  stage "full" for the lambert type set (no NEE);
//   shade_s1    stage "s1" for lambert, dielectric and PBR under an
//               environment map: misses add the environment with MIS and
//               end their path; hits get Beer-Lambert absorption from the
//               top of the medium stack, the dielectric geometric normal,
//               first-hit AOVs, the PBR emissive add and the three NEE
//               draws (taken only on NEE lanes), and export 18 transient
//               columns per lane (ops/kernels/shade.py TRANS);
//   shade_s2    stage "s2": the NEE add with MIS from the alias sample and
//               shadow flag (ESMP, 9 columns), BSDF sampling from the
//               post-s1 state, the spec-NEE chain exports (CHAIN, 7
//               columns), medium push/pop (8 clamped slots), next origin,
//               throughput clamp, environment LOD, ray cone, Russian
//               roulette at depth >= 5, commit.
// In a textured scene s1 and s2 read the texture stage's 15 planes per
// lane (csrc/texture.cu; a NULL pointer otherwise): lanes whose tpbr flag
// is set take the textured material values, diffuse occlusion and (s1)
// mapped normal, and alpha pass-through lanes record no AOV, add no
// emission, draw no NEE or BSDF sample and go on along their ray as a
// delta bounce of weight 1 (shade.py:2027-2059, 2123-2139, 2188,
// 2306-2331).
// Each kernel does what its plain version in ops/kernels/shade.py does, in
// the same order and with the same arithmetic; they update the PathCarry
// arrays and the RNG state (uint32 values held in int64) IN PLACE, and
// lanes that enter dead keep every value.
//
// What bounds them on an H100: bytes. A live lane reads its carry (~100 B
// for full, ~150 B with the environment fields), gathers one 96 B
// shade_packed row at a random triangle, reads or writes 72 B of
// transients (s1/s2), reads 60 B of texture planes in a textured scene,
// and writes the carry back; the arithmetic (a few
// sqrt/div/exp, one or two sin/cos pairs) is small beside that. The design
// touches each carry value once per stage, keeps every intermediate in
// registers, and returns at once for dead lanes so late depths cost
// little. It is written in CUDA rather than Triton for the uint32 PCG
// arithmetic, the per-lane material branches, and explicit control of FMA
// contraction (__fmaf_rn only where the plain version fuses; the build
// passes --fmad=false).
#include "bsdf.cuh"

#define RAY_ORIGIN_EPSILON 1.0e-4f
#define INFINITY_T 1.0e20f
#define MIS_MIN 1.0e-4f
#define MIS_MAX 0.9999f
#define MAX_MEDIUM_STACK 8
#define N_TRANS 18
#define N_ESMP 9
#define N_CHAIN 7
#define N_TEX 15

namespace {

struct ShadeParams {
  int background_mode;  // 0 gradient, 1 solid
  int working_space;    // 0 linear sRGB, 1 ACEScg
  int russian_roulette;
  V3 background;
  ClampP c;
};

// The s1/s2 launch constants, unpacked from NeeParams.scalars()
struct NeeParams {
  int depth;
  ClampP c;
  int russian_roulette;
  int specular_mis;
  float env_max_mip;  // 0: no mip chain, the LOD carry stays off
  int working_space;  // 0 linear sRGB, 1 ACEScg
};

// The texture planes' overrides of one lane (kernels/shade.py _textured):
// where tpbr, the textured material values; the PBR emission (the
// material's own, in the working space when the scene is textured), the
// diffuse occlusion, the pass-through flag and the mapped normal
struct TexLane {
  V3 emission, normal;
  float occlusion;
  bool tpbr, passthrough;
};
__device__ TexLane apply_tex(const float* tex, long long i, Mat* m,
                             int working_space) {
  TexLane o;
  o.emission = m->emission;
  o.occlusion = 1.0f;
  o.tpbr = o.passthrough = false;
  if (tex == nullptr) return o;
  const float* tx = tex + (long long)N_TEX * i;
  o.tpbr = tx[14] > 0.5f;
  if (!o.tpbr) {
    if (working_space == 1) o.emission = to_acescg(m->emission);
    return o;
  }
  m->base = v3(tx[0], tx[1], tx[2]);
  m->roughness = tx[3];
  m->metallic = tx[4];
  m->transmission = tx[13];
  o.emission = v3(tx[5], tx[6], tx[7]);
  o.occlusion = tx[8];
  o.passthrough = tx[9] > 0.5f;
  o.normal = v3(tx[10], tx[11], tx[12]);
  return o;
}

// The PathCarry arrays, in ops/kernels/shade.py _CARRY_DTYPES order
struct Carry {
  long long* state;
  float* ray_o;
  float* ray_d;
  float* throughput;
  float* radiance;
  bool* alive;
  bool* prev_valid;
  int* prev_mesh;
  int* prev_prim;
  bool* first_hit;
  float* aov_albedo;
  float* aov_normal;
  float* cone_w;
  float* cone_s;
  float* last_pdf;
  bool* last_delta;
  float* medium_stack;  // (N, 8, 3)
  int* medium_depth;
  int* specular_depth;
  float* env_lod;
  bool* env_lod_active;
};

// intersect.offset_ray_origin: off the (valid) shading normal, then along
// the new direction
__device__ __forceinline__ V3 offset_origin(V3 point, V3 sn, V3 n_faced,
                                            float t, V3 dir) {
  V3 off_n = sn;
  if (!finite3(off_n) || dot3(off_n, off_n) <= 0.0f) off_n = n_faced;
  float sign = dot3(dir, off_n) >= 0.0f ? 1.0f : -1.0f;
  float dist = cmin(fabsf(t) * 1e-4f, RAY_ORIGIN_EPSILON);
  return fma3v(dir, RAY_ORIGIN_EPSILON * 0.5f,
               fma3v(off_n, sign * dist, point));
}

// bsdf.bsdf_cone_spread_increment
__device__ __forceinline__ float cone_increment(const Sample& smp) {
  float r = clampf(smp.lobe_roughness, 0.0f, 1.0f);
  float inc = smp.lobe_type == 0   ? 0.55f
              : smp.lobe_type == 1 ? 0.03f + 0.42f * r
                                   : 0.10f + 0.5f * r;
  return smp.is_delta ? 0.0f : inc;
}

// the MIS weight of the integrator: a / max(a + b, 1e-30) clamped
__device__ __forceinline__ float mis_weight(float a, float denom) {
  return clampf(a / cmin(denom, 1e-30f), MIS_MIN, MIS_MAX);
}

__global__ void shade_full_kernel(
    int n, int depth, const float* __restrict__ hit_t,
    const int* __restrict__ hit_tri, const float* __restrict__ hit_u,
    const float* __restrict__ hit_v, const float* __restrict__ shade_packed,
    const float* __restrict__ mat_base, int m_count, ShadeParams p,
    Carry c) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !c.alive[i]) return;
  int tri = hit_tri[i];
  V3 ray_d = load3(c.ray_d, i);
  V3 tp0 = load3(c.throughput, i);

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
    store3(c.radiance, i, load3(c.radiance, i) + clamp_firefly(tp0, bg, p.c));
    c.prev_valid[i] = false;
    c.prev_mesh[i] = -1;
    c.prev_prim[i] = -1;
    c.alive[i] = false;
    return;
  }

  float t = hit_t[i];
  Hit h = rebuild_hit(shade_packed, tri, load3(c.ray_o, i), ray_d, t,
                      hit_u[i], hit_v[i]);
  V3 shading_n = h.shading_n;

  // ---- material fetch, first-hit AOVs --------------------------------
  int mid = min(max(h.material, 0), m_count - 1);
  V3 base = v3(clampf(mat_base[3 * mid], 0.0f, 1.0f),
               clampf(mat_base[3 * mid + 1], 0.0f, 1.0f),
               clampf(mat_base[3 * mid + 2], 0.0f, 1.0f));
  if (c.first_hit[i]) {
    store3(c.aov_albedo, i, base);
    store3(c.aov_normal, i, shading_n);
    c.first_hit[i] = false;
  }

  // ---- ray cone at the hit -------------------------------------------
  float cone_w = c.cone_w[i], cone_s = c.cone_s[i];
  float ray_len = sqrtf(cmin(dot3(ray_d, ray_d), 1e-12f));
  float hit_world = cmin(t, 0.0f) * ray_len;
  float cone_at_hit = cmin(fmaf_rn(cone_s, hit_world, cone_w), 1e-7f);

  // ---- lambert sample (bsdf._sample_lambert) --------------------------
  uint32_t s = (uint32_t)c.state[i];
  Mat m;
  m.base = base;
  Sample smp = sample_lambert(m, shading_n, &s);
  bool active = smp.pdf > 0.0f;
  V3 next_o = offset_origin(h.point, shading_n, h.n_faced, t, smp.dir);

  // ---- throughput -----------------------------------------------------
  V3 tp = clamp_throughput(tp0 * smp.weight, p.c);
  float max_tp = max3(tp);
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
    if (survive) tp = v3(tp.x / cont_p, tp.y / cont_p, tp.z / cont_p);
    active = survive;
  }

  // ---- commit -------------------------------------------------------------
  c.state[i] = (long long)s;
  store3(c.ray_o, i, next_o);
  store3(c.ray_d, i, smp.dir);
  store3(c.throughput, i, tp);
  c.prev_valid[i] = true;
  c.prev_mesh[i] = h.mesh;
  c.prev_prim[i] = tri;
  c.cone_w[i] = cone_w;
  c.cone_s[i] = cone_s;
  c.alive[i] = active;
}

__global__ void shade_s1_kernel(
    int n, NeeParams p, const float* __restrict__ hit_t,
    const int* __restrict__ hit_tri, const float* __restrict__ hit_u,
    const float* __restrict__ hit_v, const float* __restrict__ shade_packed,
    const float* __restrict__ mat_table, int m_count,
    const float* __restrict__ envbg, const float* __restrict__ envpdf,
    const float* __restrict__ tex, Carry c, float* __restrict__ trans) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float* tr = trans + (long long)N_TRANS * i;
  for (int k = 0; k < N_TRANS; ++k) tr[k] = 0.0f;
  if (!c.alive[i]) return;
  int tri = hit_tri[i];
  V3 tp0 = load3(c.throughput, i);
  V3 radiance = load3(c.radiance, i);

  if (tri < 0) {
    // ---- miss: the environment, MIS against the alias pdf; path ends ----
    float last_pdf = c.last_pdf[i];
    float denom = last_pdf + envpdf[i];
    bool use_mis = (!c.last_delta[i] || p.specular_mis) && denom > 0.0f;
    float mis = use_mis ? mis_weight(last_pdf, denom) : 1.0f;
    store3(c.radiance, i,
           radiance + clamp_firefly(tp0, load3(envbg, i) * mis, p.c));
    c.prev_valid[i] = false;
    c.prev_mesh[i] = -1;
    c.prev_prim[i] = -1;
    c.alive[i] = false;
    return;
  }

  float t = hit_t[i];
  Hit h = rebuild_hit(shade_packed, tri, load3(c.ray_o, i),
                      load3(c.ray_d, i), t, hit_u[i], hit_v[i]);
  Mat m = fetch_material(mat_table, min(max(h.material, 0), m_count - 1));
  TexLane tl = apply_tex(tex, i, &m, p.working_space);
  V3 sn = tl.tpbr ? tl.normal : h.shading_n;

  // ---- Beer-Lambert absorption by the innermost medium ----------------
  V3 tp = tp0;
  int md = c.medium_depth[i];
  if (md > 0) {
    int top = min(max(md - 1, 0), MAX_MEDIUM_STACK - 1);
    V3 sigma = load3(c.medium_stack, (long long)MAX_MEDIUM_STACK * i + top);
    float seg = cmin(t, 0.0f);
    V3 att = v3(expf(-sigma.x * seg), expf(-sigma.y * seg),
                expf(-sigma.z * seg));
    if (sigma.x > 0.0f || sigma.y > 0.0f || sigma.z > 0.0f) tp = tp0 * att;
  }

  V3 shading_n = m.type == MAT_DIELECTRIC ? h.n_faced : sn;
  bool two_sided = m.type == MAT_PBR && m.double_sided > 0.5f;
  bool delta = material_is_delta(m);
  V3 em = tl.emission;

  // ---- first-hit AOVs, PBR emission (pass-through lanes: neither) -------
  if (c.first_hit[i] && !tl.passthrough) {
    store3(c.aov_albedo, i, clamp3(m.base, 0.0f, 1.0f));
    store3(c.aov_normal, i, shading_n);
    c.first_hit[i] = false;
  }
  if (!tl.passthrough && m.type == MAT_PBR &&
      (em.x != 0.0f || em.y != 0.0f || em.z != 0.0f) &&
      (h.front || two_sided))
    radiance = radiance + clamp_firefly(tp, em, p.c);

  // ---- the NEE draws, committed on NEE lanes only ----------------------
  uint32_t s0 = (uint32_t)c.state[i];
  uint32_t s_env = s0;
  float u1 = rand_uniform(&s_env);
  float u2 = rand_uniform(&s_env);
  float u3 = rand_uniform(&s_env);
  c.state[i] = (long long)(delta || tl.passthrough ? s0 : s_env);
  store3(c.radiance, i, radiance);
  store3(c.throughput, i, tp);

  tr[0] = u1;
  tr[1] = u2;
  tr[2] = u3;
  tr[3] = env_lighting_roughness(m);
  tr[4] = shading_n.x;
  tr[5] = shading_n.y;
  tr[6] = shading_n.z;
  tr[7] = h.n_faced.x;
  tr[8] = h.n_faced.y;
  tr[9] = h.n_faced.z;
  tr[10] = h.point.x;
  tr[11] = h.point.y;
  tr[12] = h.point.z;
  tr[13] = 1.0f;
  tr[14] = delta ? 1.0f : 0.0f;
}

__global__ void shade_s2_kernel(
    int n, NeeParams p, const float* __restrict__ hit_t,
    const int* __restrict__ hit_tri, const float* __restrict__ hit_u,
    const float* __restrict__ hit_v, const float* __restrict__ shade_packed,
    const float* __restrict__ mat_table, int m_count,
    const float* __restrict__ trans, const float* __restrict__ esmp,
    const float* __restrict__ tex, Carry c, float* __restrict__ chain) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float* ch = chain + (long long)N_CHAIN * i;
  for (int k = 0; k < N_CHAIN; ++k) ch[k] = 0.0f;
  if (!c.alive[i]) return;  // after s1: the live hits only
  const float* tr = trans + (long long)N_TRANS * i;
  const float* es = esmp + (long long)N_ESMP * i;
  int tri = hit_tri[i];
  float t = hit_t[i];
  V3 ray_d = load3(c.ray_d, i);
  Hit h = rebuild_hit(shade_packed, tri, load3(c.ray_o, i), ray_d, t,
                      hit_u[i], hit_v[i]);
  Mat m = fetch_material(mat_table, min(max(h.material, 0), m_count - 1));
  TexLane tl = apply_tex(tex, i, &m, p.working_space);
  V3 sn = v3(tr[4], tr[5], tr[6]);
  V3 n_faced = v3(tr[7], tr[8], tr[9]);
  V3 point = v3(tr[10], tr[11], tr[12]);
  V3 incident = normalize3(ray_d);
  V3 wo = -incident;
  V3 tp = load3(c.throughput, i);
  V3 radiance = load3(c.radiance, i);

  // ---- NEE add: alias sample + shadow flag, MIS against the BSDF ------
  V3 e_dir = v3(es[0], es[1], es[2]);
  float e_pdf = es[6];
  float n_dot_l = cmin(dot3(sn, e_dir), 0.0f);
  bool do_shadow = tr[14] < 0.5f && !tl.passthrough && es[7] > 0.5f &&
                   e_pdf > 0.0f && n_dot_l > 0.0f;
  if (do_shadow && !(es[8] > 0.5f)) {
    Eval ev = evaluate_bsdf(m, sn, wo, e_dir, p.c, tl.occlusion);
    float w = ev.pdf > 0.0f ? mis_weight(e_pdf, e_pdf + ev.pdf) : 1.0f;
    V3 contribution = v3(es[3], es[4], es[5]) * ev.value * n_dot_l *
                      (w / cmin(e_pdf, 1e-30f));
    if (!ev.is_delta && max3(ev.value) > 0.0f && finite3(contribution))
      radiance = radiance + clamp_firefly(tp, contribution, p.c);
  }

  // ---- BSDF sample from the post-s1 state ------------------------------
  uint32_t s = (uint32_t)c.state[i];
  Sample smp;
  if (tl.passthrough) {
    // alpha pass-through: a delta bounce along the same ray, weight 1,
    // no draw
    smp = invalid_sample();
    smp.dir = ray_d;
    smp.weight = v3(1.0f, 1.0f, 1.0f);
    smp.pdf = smp.dpdf = 1.0f;
    smp.is_delta = true;
  } else {
    smp = sample_bsdf(m, sn, wo, incident, h.front, &s, p.c, tl.occlusion);
  }
  bool active = smp.pdf > 0.0f;
  ch[0] = smp.weight.x;
  ch[1] = smp.weight.y;
  ch[2] = smp.weight.z;
  ch[3] = smp.dpdf;
  ch[4] = (float)smp.medium_event;
  ch[5] = active && !tl.passthrough ? 1.0f : 0.0f;
  ch[6] = h.front ? 1.0f : 0.0f;

  // ---- medium stack push/pop (8 slots, clamped) ------------------------
  int md = c.medium_depth[i];
  if (active && smp.medium_event == 1) {
    int slot = min(max(md, 0), MAX_MEDIUM_STACK - 1);
    store3(c.medium_stack, (long long)MAX_MEDIUM_STACK * i + slot,
           cmin3(m.sigma_a, 0.0f));
    md = min(md + 1, MAX_MEDIUM_STACK);
  } else if (active && smp.medium_event == -1) {
    md = max(md - 1, 0);
  }

  // ---- next origin, throughput, environment LOD, ray cone --------------
  V3 next_o = offset_origin(point, sn, n_faced, t, smp.dir);
  tp = clamp_throughput(tp * smp.weight, p.c);
  float max_tp = max3(tp);
  active = active && finite3(tp) && max_tp > 0.0f;
  bool lod_lane = p.env_max_mip > 0.0f && active && smp.lobe_type == 1 &&
                  !smp.is_delta;
  float alpha_l = clampf(smp.lobe_roughness, 0.0f, 1.0f);
  float env_lod = lod_lane ? clampf(alpha_l * alpha_l * p.env_max_mip, 0.0f,
                                    p.env_max_mip)
                           : 0.0f;
  float cone_w = c.cone_w[i], cone_s = c.cone_s[i];
  float ray_len = sqrtf(cmin(dot3(ray_d, ray_d), 1e-12f));
  float cone_at_hit =
      cmin(fmaf_rn(cone_s, cmin(t, 0.0f) * ray_len, cone_w), 1e-7f);
  if (active) {
    cone_w = cone_at_hit;
    cone_s = cmax(cone_s + cone_increment(smp), 1.5f);
  }

  // ---- Russian roulette -----------------------------------------------
  if (p.russian_roulette && p.depth >= 5 && active) {
    float xi = rand_uniform(&s);
    float cont_p = clampf(max_tp, 0.05f, 0.95f);
    bool survive = xi <= cont_p;
    if (survive) tp = v3(tp.x / cont_p, tp.y / cont_p, tp.z / cont_p);
    active = survive;
  }

  // ---- commit -------------------------------------------------------------
  c.state[i] = (long long)s;
  store3(c.ray_o, i, next_o);
  store3(c.ray_d, i, smp.dir);
  store3(c.throughput, i, tp);
  store3(c.radiance, i, radiance);
  c.alive[i] = active;
  c.last_pdf[i] = smp.dpdf > 0.0f ? smp.dpdf : smp.pdf;
  c.last_delta[i] = smp.is_delta;
  c.prev_valid[i] = true;
  c.prev_mesh[i] = h.mesh;
  c.prev_prim[i] = tri;
  c.medium_depth[i] = md;
  c.specular_depth[i] = smp.is_delta ? c.specular_depth[i] + 1 : 0;
  c.env_lod[i] = env_lod;
  c.env_lod_active[i] = lod_lane;
  c.cone_w[i] = cone_w;
  c.cone_s[i] = cone_s;
}

Carry carry_of(void* const* ptrs) {
  Carry c;
  c.state = (long long*)ptrs[0];
  c.ray_o = (float*)ptrs[1];
  c.ray_d = (float*)ptrs[2];
  c.throughput = (float*)ptrs[3];
  c.radiance = (float*)ptrs[4];
  c.alive = (bool*)ptrs[5];
  c.prev_valid = (bool*)ptrs[6];
  c.prev_mesh = (int*)ptrs[7];
  c.prev_prim = (int*)ptrs[8];
  c.first_hit = (bool*)ptrs[9];
  c.aov_albedo = (float*)ptrs[10];
  c.aov_normal = (float*)ptrs[11];
  c.cone_w = (float*)ptrs[12];
  c.cone_s = (float*)ptrs[13];
  c.last_pdf = (float*)ptrs[14];
  c.last_delta = (bool*)ptrs[15];
  c.medium_stack = (float*)ptrs[16];
  c.medium_depth = (int*)ptrs[17];
  c.specular_depth = (int*)ptrs[18];
  c.env_lod = (float*)ptrs[19];
  c.env_lod_active = (bool*)ptrs[20];
  return c;
}

ClampP clamp_of(float enabled, float factor, float floor,
                float max_contribution, float throughput, float tail_base,
                float tail_rough, float min_spec_pdf) {
  ClampP c;
  c.enabled = enabled;
  c.factor = factor;
  c.floor = floor;
  c.max_contribution = max_contribution;
  c.throughput = throughput;
  c.tail_base = tail_base;
  c.tail_rough = tail_rough;
  c.min_spec_pdf = min_spec_pdf;
  return c;
}

// NeeParams.scalars(): depth, clamp factor, floor, throughput, tail base,
// tail roughness scale, min specular pdf, max contribution, enabled,
// russian roulette, specular MIS, env max mip, working colour space
NeeParams nee_params_of(const float* s) {
  NeeParams p;
  p.depth = (int)s[0];
  p.c = clamp_of(s[8], s[1], s[2], s[7], s[3], s[4], s[5], s[6]);
  p.russian_roulette = s[9] > 0.5f;
  p.specular_mis = s[10] > 0.5f;
  p.env_max_mip = s[11];
  p.working_space = (int)s[12];
  return p;
}

const int kBlock = 128;

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
  p.c = clamp_of(clamp_enabled, clamp_factor, clamp_floor, max_contribution,
                 throughput_clamp, 0.0f, 0.0f, 0.0f);
  void* ptrs[21] = {state,      ray_o,     ray_d,      throughput, radiance,
                    alive,      prev_valid, prev_mesh, prev_prim,  first_hit,
                    aov_albedo, aov_normal, cone_w,    cone_s};
  shade_full_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                      (cudaStream_t)stream>>>(
      n, depth, (const float*)t, (const int*)tri, (const float*)u,
      (const float*)v, (const float*)shade_packed, (const float*)mat_base,
      m_count, p, carry_of(ptrs));
  return (int)cudaGetLastError();
}

extern "C" int mpt_shade_s1(int n, const float* scalars, const void* t,
                            const void* tri, const void* u, const void* v,
                            const void* shade_packed, const void* mat_table,
                            int m_count, const void* envbg,
                            const void* envpdf, const void* tex,
                            void* const* carry, void* trans, void* stream) {
  if (n <= 0) return 0;
  shade_s1_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                    (cudaStream_t)stream>>>(
      n, nee_params_of(scalars), (const float*)t, (const int*)tri,
      (const float*)u, (const float*)v, (const float*)shade_packed,
      (const float*)mat_table, m_count, (const float*)envbg,
      (const float*)envpdf, (const float*)tex, carry_of(carry),
      (float*)trans);
  return (int)cudaGetLastError();
}

extern "C" int mpt_shade_s2(int n, const float* scalars, const void* t,
                            const void* tri, const void* u, const void* v,
                            const void* shade_packed, const void* mat_table,
                            int m_count, const void* trans, const void* esmp,
                            const void* tex, void* const* carry, void* chain,
                            void* stream) {
  if (n <= 0) return 0;
  shade_s2_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                    (cudaStream_t)stream>>>(
      n, nee_params_of(scalars), (const float*)t, (const int*)tri,
      (const float*)u, (const float*)v, (const float*)shade_packed,
      (const float*)mat_table, m_count, (const float*)trans,
      (const float*)esmp, (const float*)tex, carry_of(carry),
      (float*)chain);
  return (int)cudaGetLastError();
}
