// K2: one depth of shading per lane, in three stages.
//
// Replaces the TPU fused shade megakernel ops/pallas/shade.py
// (_shade_kernel:1845, launched by _shade_call:2536):
//   shade_full  stage "full" for scenes without a light integral: misses
//               add the gradient or solid background and end; hits get
//               Beer-Lambert absorption, the dielectric geometric normal,
//               first-hit AOVs, PBR emission, diffuse lights emit and end,
//               the others sample their BSDF, push or pop the medium
//               stack, clamp, Russian roulette, commit (a thread per
//               lane; on a sparse wavefront a sweep whose warps pack their
//               live lanes; between the first and the sparse depths of a
//               scene of several material types, a listing pass that
//               ends the misses and buckets the hits by material type,
//               then persistent warps over the buckets);
//   shade_s1    stage "s1" under a light integral (an environment map, rect
//               lights, or both): misses add the environment with MIS (or
//               the gradient/solid background) and end; hits get the same
//               absorption, normal, AOVs and emission, diffuse lights emit
//               with MIS against the rect-light pdf of the hit and end, and
//               the NEE draws (3 per light integral, rect first) are taken
//               on NEE lanes; 18 transient planes are exported
//               (ops/kernels/shade.py TRANS, plane-major: (18, n));
//   shade_s2    stage "s2" (the base instantiation over a list of the
//               lanes alive after s1, s2_list_kernel): the NEE adds with MIS from one bank of
//               light sample + shadow flag per light integral (ESMP, 9
//               columns each, rect first), BSDF sampling from the post-s1
//               state, the spec-NEE chain exports (CHAIN, plane-major: (7,
//               n)) and, with MNEE's secondary chain on, the RNG state at
//               the chain's fork point (an int64 per lane, written after
//               the sample commits and before the roulette draw,
//               shade.py:2319-2333), medium push/pop (8 clamped slots),
//               next origin, throughput clamp, environment LOD, ray cone,
//               Russian roulette at depth >= 5, commit.
// A hit is rebuilt from the winner of the merged trace (intersect.py
// trace_merged): a triangle from its shade_packed row, a sphere or a
// rectangle from its own arrays (the design choice of this port: the
// kernel takes each lane's family and index and branches, instead of the
// TPU path's 24 gathered floats per lane): the sphere normal (p - c) / r
// and the stored rectangle normal, each faced toward the ray, are also the
// shading normal; spheres are two-sided, rectangles as stored; only
// triangles set the self-hit exclusion ids (shade.py:1966-1988,
// 2012-2018, 2132-2143, 2449).
// In a textured scene every stage reads the texture stage's 15 planes
// (csrc/texture.cu, plane-major: (15, n); a NULL pointer otherwise): lanes
// whose tpbr flag
// is set take the textured material values, diffuse occlusion and (full,
// s1) mapped normal, and alpha pass-through lanes record no AOV, add no
// emission, draw no NEE or BSDF sample, skip Russian roulette and go on
// along their ray as a delta bounce of weight 1 (shade.py:2027-2059,
// 2123-2139, 2188, 2306-2331, 2414).
// Random-walk subsurface lanes (the walk traces the scene, so it runs
// before the stage, ops/kernels/shade.py random_walks) come in as 18
// override columns and a state per lane (RW, NULL without a walk): where
// the walk exited, its sample and state replace the lane's own
// (shade.py:2284-2300). s1 scales the emission of the front faces of
// emission_env lights by the emod plane (shade.py:2149-2154). full and s2
// leave a BSSRDF exit point off its normal (shade.py:2359-2371).
// The pixel probe (renderer/debugprobe.py) passes a 6-column plane per
// lane (PROBE, NULL otherwise): full and s1 write the throughput after
// absorption of each hit, full and s2 the sample's pdf, delta flag and
// medium event (zero on a diffuse light, which draws none), the columns
// of the reference's per-bounce record (integrator.py:676-688) that the
// carry does not keep.
//
// Each stage is compiled twice (template flag EXT, chosen on the host from
// the scene's material types): without and with the plastic, carpaint and
// subsurface branches, so that scenes without them run code that holds
// none of them (the JAX kernel is specialised on its static type set).
//
// Each kernel does what its plain version in ops/kernels/shade.py does, in
// the same order and with the same arithmetic; they update the PathCarry
// arrays and the RNG state (uint32 values held in int64) IN PLACE, and
// lanes that enter dead keep every value.
//
// What bounds them on an H100: bytes. A live lane reads its carry (~150
// B), gathers 80 B of a 96 B shade_packed row at a random triangle as five
// 16-byte loads (or 16-28 B of a sphere or rectangle), reads or writes 72
// B of transients (s1/s2), reads 36 B of light sample per bank, reads 60 B
// of texture planes in a textured scene, and writes the carry back; the
// arithmetic (a few sqrt/div/exp, one or two sin/cos pairs) is small
// beside that, but for s2, whose BSDF evaluation per light bank and BSDF
// sample make a live lane's work long and divergent. The design touches
// each carry value once per stage, keeps every intermediate in registers,
// and returns at once for dead lanes so late depths cost little; s1 still
// writes every lane's transients (zero where the lane is not a live hit),
// each plane once and coalesced, which is all a dead lane costs. The
// base s2 runs its warps over listed live lanes only, so its time follows
// the live hits and not the wavefront; full runs warps of one material
// type at the depths where a warp of lanes would mix them. It is written in CUDA rather than Triton for
// the uint32 PCG arithmetic, the per-lane material and primitive branches,
// and explicit control of FMA contraction (__fmaf_rn only where the plain
// version fuses; the build passes --fmad=false).
#include "bsdf.cuh"

#define INFINITY_T 1.0e20f
#define MIS_MIN 1.0e-4f
#define MIS_MAX 0.9999f
#define MAX_MEDIUM_STACK 8
#define N_TRANS 18
#define N_ESMP 9
#define N_CHAIN 7
#define N_RW 18
#define N_PROBE 6
#define PRIM_SPHERE 1
#define PRIM_RECT 2
#define PRIM_TRIANGLE 3
#define LIST_BLOCK 1024

namespace {

const int kBlock = 128;

// The launch constants, unpacked from ShadeParams.scalars()
struct ShadeParams {
  int depth;
  ClampP c;
  int russian_roulette;
  int specular_mis;
  float env_max_mip;    // 0: no mip chain, the LOD carry stays off
  int working_space;    // 0 linear sRGB, 1 ACEScg
  int background_mode;  // 0 gradient, 1 solid (without an environment map)
  V3 background;        // the solid background, linear sRGB
  int n_banks;          // s2: light integrals (1 or 2 ESMP banks)
  int sss_mode;         // 0 off (lambert fallback), 1 separable, 2 walk
  bool spec_only;       // debugSpecularOnly
};

// The merged trace's winner per lane and the geometry it indexes
struct Geo {
  const float* t;
  const int* idx;             // index within its family, -1: miss
  const float* u;
  const float* v;
  const int* kind;            // PRIMITIVE_* per lane; NULL: all triangles
  const float* shade_packed;  // (T, 24); NULL without triangles
  const float* sph_center;    // (S, 3)
  const float* sph_radius;
  const int* sph_material;
  const float* rect_normal;   // (R, 3)
  const int* rect_material;
  const float* rect_two_sided;
};

// intersect.analytic_record for one lane: the point o + t d (x and y
// fused, as XLA:CPU computes the JAX package's), the faced normal as
// geometric and shading normal, the material, two-sidedness
__device__ inline Hit rebuild_analytic(const Geo& g, int kind, int idx,
                                       V3 ray_o, V3 ray_d, float t) {
  Hit h;
  h.point = v3(fmaf_rn(t, ray_d.x, ray_o.x), fmaf_rn(t, ray_d.y, ray_o.y),
               ray_o.z + t * ray_d.z);
  V3 raw;
  if (kind == PRIM_SPHERE) {
    V3 c = load3(g.sph_center, idx);
    float r = g.sph_radius[idx];
    raw = v3((h.point.x - c.x) / r, (h.point.y - c.y) / r,
             (h.point.z - c.z) / r);
    h.material = g.sph_material[idx];
    h.two_sided = true;
  } else {
    raw = load3(g.rect_normal, idx);
    h.material = g.rect_material[idx];
    h.two_sided = g.rect_two_sided[idx] > 0.5f;
  }
  h.front = dot3(ray_d, raw) < 0.0f;
  h.n_faced = sel(h.front, raw, -raw);
  h.shading_rec = h.shading_n = h.n_faced;
  h.is_tri = false;
  h.mesh = 0;
  return h;
}

__device__ __forceinline__ Hit rebuild(const Geo& g, long long i, V3 ray_o,
                                       V3 ray_d) {
  int kind = g.kind == nullptr ? PRIM_TRIANGLE : g.kind[i];
  if (kind == PRIM_TRIANGLE)
    return rebuild_hit(g.shade_packed, g.idx[i], ray_o, ray_d, g.t[i], g.u[i],
                       g.v[i]);
  return rebuild_analytic(g, kind, g.idx[i], ray_o, ray_d, g.t[i]);
}

// The texture planes' overrides of one lane (kernels/shade.py _textured;
// the planes plane-major, (15, n)):
// where tpbr, the textured material values; the PBR emission (the
// material's own, in the working space when the scene is textured), the
// diffuse occlusion, the pass-through flag and the mapped normal
struct TexLane {
  V3 emission, normal;
  float occlusion;
  bool tpbr, passthrough;
};
__device__ TexLane apply_tex(const float* tex, int n, long long i, Mat* m,
                             int working_space) {
  TexLane o;
  o.emission = m->emission;
  o.occlusion = 1.0f;
  o.tpbr = o.passthrough = false;
  if (tex == nullptr) return o;
  auto tx = [&](int k) { return plane_at(tex, n, i, k); };
  o.tpbr = tx(14) > 0.5f;
  if (!o.tpbr) {
    if (working_space == 1) o.emission = to_acescg(m->emission);
    return o;
  }
  m->base = v3(tx(0), tx(1), tx(2));
  m->roughness = tx(3);
  m->metallic = tx(4);
  m->transmission = tx(13);
  o.emission = v3(tx(5), tx(6), tx(7));
  o.occlusion = tx(8);
  o.passthrough = tx(9) > 0.5f;
  o.normal = v3(tx(10), tx(11), tx(12));
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

// the gradient or solid background in the working space (shade.py
// _background; integrator.sky_color)
__device__ inline V3 background(V3 ray_d, const ShadeParams& p) {
  V3 bg;
  if (p.background_mode == 1) {
    bg = p.background;
  } else {
    float t = 0.5f * (normalize3(ray_d).y + 1.0f);
    bg = v3(fmaf_rn(0.5f - 1.0f, t, 1.0f), fmaf_rn(0.7f - 1.0f, t, 1.0f),
            fmaf_rn(1.0f - 1.0f, t, 1.0f));
  }
  return p.working_space == 1 ? to_acescg(bg) : bg;
}

// Beer-Lambert absorption by the innermost medium over the segment t
__device__ inline V3 absorb(const Carry& c, long long i, float t, V3 tp0) {
  int md = c.medium_depth[i];
  if (md <= 0) return tp0;
  int top = min(max(md - 1, 0), MAX_MEDIUM_STACK - 1);
  V3 sigma = load3(c.medium_stack, (long long)MAX_MEDIUM_STACK * i + top);
  float seg = cmin(t, 0.0f);
  V3 att = v3(expf(-sigma.x * seg), expf(-sigma.y * seg),
              expf(-sigma.z * seg));
  return (sigma.x > 0.0f || sigma.y > 0.0f || sigma.z > 0.0f) ? tp0 * att
                                                                : tp0;
}

// The part of a hit lane that stages full and s1 share (shade.py
// :2101-2177): hit rebuild, absorption, material (+ texture overrides),
// the dielectric geometric normal, first-hit AOVs, PBR emission, and a
// diffuse light's emission with MIS against `rectpdf` (the rect-light pdf
// of this hit; NULL: weight 1), after which the lane's path ends
struct Front {
  Hit h;
  Mat m;
  TexLane tl;
  V3 sn, tp, radiance;
  bool ended;
};
__device__ inline Front shade_front(const Geo& g, int n, long long i,
                                    const ShadeParams& p,
                                    const float* mat_table, int m_count,
                                    const float* tex, const float* rectpdf,
                                    const float* emod, const Carry& c) {
  Front f;
  f.h = rebuild(g, i, load3(c.ray_o, i), load3(c.ray_d, i));
  f.m = fetch_material(mat_table, min(max(f.h.material, 0), m_count - 1));
  f.tl = apply_tex(tex, n, i, &f.m, p.working_space);
  f.tp = absorb(c, i, g.t[i], load3(c.throughput, i));
  f.sn = f.m.type == MAT_DIELECTRIC ? f.h.n_faced
                                    : (f.tl.tpbr ? f.tl.normal : f.h.shading_n);
  bool two_sided =
      f.h.two_sided || (f.m.type == MAT_PBR && f.m.double_sided > 0.5f);
  bool facing = f.h.front || two_sided;
  V3 radiance = load3(c.radiance, i);
  if (c.first_hit[i] && !f.tl.passthrough) {
    store3(c.aov_albedo, i, clamp3(f.m.base, 0.0f, 1.0f));
    store3(c.aov_normal, i, f.sn);
    c.first_hit[i] = false;
  }
  V3 em = f.tl.emission;
  if (!f.tl.passthrough && f.m.type == MAT_PBR &&
      (em.x != 0.0f || em.y != 0.0f || em.z != 0.0f) && facing &&
      !p.spec_only)
    radiance = radiance + clamp_firefly(f.tp, em, p.c);
  f.ended = f.m.type == MAT_LIGHT;
  V3 le = f.m.emission;
  if (emod != nullptr && f.m.emission_env > 0.0f && f.h.front)
    le = le * load3(emod, i);
  if (f.ended && (le.x != 0.0f || le.y != 0.0f || le.z != 0.0f) && facing &&
      !p.spec_only) {
    float l_mis = 1.0f;
    if (rectpdf != nullptr) {
      float last_pdf = c.last_pdf[i];
      float denom = last_pdf + rectpdf[i];
      if ((!c.last_delta[i] || p.specular_mis) && denom > 0.0f)
        l_mis = mis_weight(last_pdf, denom);
    }
    radiance = radiance + clamp_firefly(f.tp, le * l_mis, p.c);
  }
  f.radiance = radiance;
  return f;
}

// a miss: the path ends (no self-hit exclusion for the next trace)
__device__ __forceinline__ void end_miss(const Carry& c, long long i,
                                         V3 radiance) {
  store3(c.radiance, i, radiance);
  c.prev_valid[i] = false;
  c.prev_mesh[i] = -1;
  c.prev_prim[i] = -1;
  c.alive[i] = false;
}

// medium stack push/pop (8 slots, clamped); returns the new depth
__device__ inline int medium_update(const Carry& c, long long i,
                                    const Sample& smp, const Mat& m,
                                    bool active) {
  int md = c.medium_depth[i];
  if (active && smp.medium_event == 1) {
    int slot = min(max(md, 0), MAX_MEDIUM_STACK - 1);
    store3(c.medium_stack, (long long)MAX_MEDIUM_STACK * i + slot,
           cmin3(m.sigma_a, 0.0f));
    md = min(md + 1, MAX_MEDIUM_STACK);
  } else if (active && smp.medium_event == -1) {
    md = max(md - 1, 0);
  }
  return md;
}

// the ray cone at the hit, and its update on lanes that go on
__device__ inline void cone_update(const Carry& c, long long i, V3 ray_d,
                                   float t, const Sample& smp, bool active) {
  float cone_w = c.cone_w[i], cone_s = c.cone_s[i];
  float ray_len = sqrtf(cmin(dot3(ray_d, ray_d), 1e-12f));
  float cone_at_hit =
      cmin(fmaf_rn(cone_s, cmin(t, 0.0f) * ray_len, cone_w), 1e-7f);
  if (active) {
    c.cone_w[i] = cone_at_hit;
    c.cone_s[i] = cmax(cone_s + cone_increment(smp), 1.5f);
  }
}

// Russian roulette at depth >= 5 on lanes that go on, alpha pass-through
// lanes excepted
__device__ inline bool roulette(const ShadeParams& p, uint32_t* s, V3* tp,
                                bool active, bool passthrough) {
  if (!(p.russian_roulette && p.depth >= 5 && active && !passthrough))
    return active;
  float xi = rand_uniform(s);
  float cont_p = clampf(max3(*tp), 0.05f, 0.95f);
  bool survive = xi <= cont_p;
  if (survive) *tp = v3(tp->x / cont_p, tp->y / cont_p, tp->z / cont_p);
  return survive;
}

// the alpha pass-through sample: a delta bounce along the same ray,
// weight 1, no draw
__device__ inline Sample passthrough_sample(V3 ray_d) {
  Sample smp = invalid_sample();
  smp.dir = ray_d;
  smp.weight = v3(1.0f, 1.0f, 1.0f);
  smp.pdf = smp.dpdf = 1.0f;
  smp.is_delta = true;
  return smp;
}

// the lane's random-walk override, if the walk exited: its sample and state
__device__ inline bool walk_override(const float* rw,
                                     const long long* rw_state, long long i,
                                     Sample* smp, uint32_t* s) {
  if (rw == nullptr) return false;
  const float* r = rw + (long long)N_RW * i;
  if (!(r[0] > 0.5f && r[7] > 0.0f)) return false;
  *smp = invalid_sample();
  smp->dir = v3(r[1], r[2], r[3]);
  smp->weight = v3(r[4], r[5], r[6]);
  smp->pdf = r[7];
  smp->dpdf = r[8];
  smp->lobe_type = (int)r[9];
  smp->lobe_roughness = r[10];
  smp->has_exit = r[11] > 0.5f;
  smp->exit_point = v3(r[12], r[13], r[14]);
  smp->exit_n = v3(r[15], r[16], r[17]);
  *s = (uint32_t)rw_state[i];
  return true;
}

// the probe plane of a lane (NULL: no probe): the throughput after
// absorption (probe_throughput), and the sample's pdf, delta flag and
// medium event (probe_sample); probe_lane writes both at once
__device__ __forceinline__ void probe_throughput(float* probe, long long i,
                                                 V3 tp) {
  if (probe != nullptr) store3(probe, 2 * i, tp);
}
__device__ __forceinline__ void probe_sample(float* probe, long long i,
                                             float pdf, bool is_delta,
                                             int medium_event) {
  if (probe == nullptr) return;
  float* q = probe + (long long)N_PROBE * i;
  q[3] = pdf;
  q[4] = is_delta ? 1.0f : 0.0f;
  q[5] = (float)medium_event;
}
__device__ __forceinline__ void probe_lane(float* probe, long long i, V3 tp,
                                           float pdf, bool is_delta,
                                           int medium_event) {
  probe_throughput(probe, i, tp);
  probe_sample(probe, i, pdf, is_delta, medium_event);
}

// the BSDF sample of a hit lane: pass-through, the walk's, or its own
template <bool EXT>
__device__ inline Sample lane_sample(const Mat& m, V3 point, V3 sn, V3 wo,
                                     V3 incident, bool front, uint32_t* s,
                                     const ShadeParams& p, float occ,
                                     bool passthrough, V3 ray_d,
                                     const float* rw,
                                     const long long* rw_state,
                                     long long i) {
  if (passthrough) return passthrough_sample(ray_d);
  Sample smp;
  if (EXT && walk_override(rw, rw_state, i, &smp, s)) return smp;
  return sample_bsdf<EXT>(m, point, sn, wo, incident, front, s, p.c, occ,
                          p.sss_mode, p.spec_only);
}

// the next ray's origin: off the hit, or off a BSSRDF exit point
template <bool EXT>
__device__ __forceinline__ V3 next_origin(V3 point, V3 sn, V3 n_faced,
                                          float t, const Sample& smp) {
  if (EXT && smp.has_exit) return exit_point_origin(smp, n_faced);
  return offset_origin(point, sn, n_faced, t, smp.dir);
}

// a live miss of stage full: the background, then the path ends
__device__ __forceinline__ void full_miss(const Carry& c, long long i,
                                          const ShadeParams& p) {
  end_miss(c, i, load3(c.radiance, i) +
                     clamp_firefly(load3(c.throughput, i),
                                   background(load3(c.ray_d, i), p), p.c));
}

// Stage full of one live lane i
template <bool EXT>
__device__ __forceinline__ void full_lane(long long i, int n,
                                          const ShadeParams& p, const Geo& g,
                                          const float* mat_table, int m_count,
                                          const float* tex, const float* rw,
                                          const long long* rw_state,
                                          const Carry& c, float* probe) {
  if (g.idx[i] < 0) {
    full_miss(c, i, p);
    return;
  }
  V3 ray_d = load3(c.ray_d, i);
  Front f = shade_front(g, n, i, p, mat_table, m_count, tex, nullptr,
                        nullptr, c);
  store3(c.radiance, i, f.radiance);
  if (f.ended) {
    probe_lane(probe, i, f.tp, 0.0f, false, 0);
    c.alive[i] = false;
    return;
  }
  float t = g.t[i];

  // ---- BSDF sample, medium stack, next origin --------------------------
  uint32_t s = (uint32_t)c.state[i];
  V3 incident = normalize3(ray_d);
  Sample smp = lane_sample<EXT>(f.m, f.h.point, f.sn, -incident, incident,
                                f.h.front, &s, p, f.tl.occlusion,
                                f.tl.passthrough, ray_d, rw, rw_state, i);
  probe_lane(probe, i, f.tp, smp.pdf, smp.is_delta, smp.medium_event);
  bool active = smp.pdf > 0.0f;
  c.medium_depth[i] = medium_update(c, i, smp, f.m, active);
  V3 next_o = next_origin<EXT>(f.h.point, f.sn, f.h.n_faced, t, smp);

  // ---- throughput, ray cone, Russian roulette --------------------------
  V3 tp = clamp_throughput(f.tp * smp.weight, p.c);
  active = active && finite3(tp) && max3(tp) > 0.0f;
  cone_update(c, i, ray_d, t, smp, active);
  active = roulette(p, &s, &tp, active, f.tl.passthrough);

  // ---- commit -------------------------------------------------------------
  c.state[i] = (long long)s;
  store3(c.ray_o, i, next_o);
  store3(c.ray_d, i, smp.dir);
  store3(c.throughput, i, tp);
  c.prev_valid[i] = true;
  c.prev_mesh[i] = f.h.is_tri ? f.h.mesh : -1;
  c.prev_prim[i] = f.h.is_tri ? g.idx[i] : -1;
  c.alive[i] = active;
}

// Stage full, a thread per wavefront lane: the kernel of the first depth
// and of scenes of one material type (kernels/shade.py full_schedule).
// Registers are allocated in steps of 8 per thread. The probe plane's
// writes and the debugSpecularOnly flag take the base instantiation from
// 77 to 80 registers (the same step: six 128-thread blocks per SM) and
// the extended one from 128 to 131, which the allocator rounds to 136,
// three blocks per SM instead of four; so each is held to its old
// occupancy (the extended one compiles to 120, no spills).
template <bool EXT>
__global__ void __launch_bounds__(128, EXT ? 4 : 6)
    shade_full_kernel(int n, ShadeParams p, Geo g,
                                  const float* __restrict__ mat_table,
                                  int m_count, const float* __restrict__ tex,
                                  const float* __restrict__ rw,
                                  const long long* __restrict__ rw_state,
                                  Carry c, float* __restrict__ probe) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n || !c.alive[i]) return;
  full_lane<EXT>(i, n, p, g, mat_table, m_count, tex, rw, rw_state, c,
                 probe);
}

// Stage full on a sparse wavefront (under 1/64 of the lanes alive), base
// instantiation only: there the thread-per-lane grid's sweep of the dead
// lanes set the time. Each warp takes FULL_SPARSE_SPANS spans of 32
// consecutive lanes, its threads read their alive flags together (one
// coalesced load a span), and the warp packs its live lanes 32 to a round
// (a ring of 64 lane indices in shared memory) and runs full_lane on
// each: a sixteenth of the warps sweep the wavefront, and a warp's few
// live lanes run side by side. Measured on an H100 (PERF.md): 1.34x on the
// lambert series' 2,073,600-lane sparse depths, even on rtow's 810,000;
// 0.83-0.94x on dense wavefronts, which keep shade_full_kernel, and 0.84x
// for the extended lanes, long and divergent, packed (as in s2). No
// minimum of blocks an SM: a sparse wavefront's warps fit in one wave,
// and the kernel spills under six.
#define FULL_SPARSE_SPANS 16
__global__ void __launch_bounds__(128) shade_full_sparse_kernel(
    int n, ShadeParams p, Geo g, const float* __restrict__ mat_table,
    int m_count, const float* __restrict__ tex, const float* __restrict__ rw,
    const long long* __restrict__ rw_state, Carry c,
    float* __restrict__ probe) {
  __shared__ int rings[kBlock / 32][64];
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* ring = rings[warp];
  long long base =
      ((long long)blockIdx.x * (kBlock / 32) + warp) * 32LL *
          FULL_SPARSE_SPANS + lane;
  unsigned live = 0;  // bit j: lane base + 32 j is alive
#pragma unroll
  for (int j = 0; j < FULL_SPARSE_SPANS; ++j) {
    long long i = base + 32LL * j;
    if (i < n && c.alive[i]) live |= 1u << j;
  }
  int head = 0, pending = 0;  // the ring's packed lanes not yet run
  for (int j = 0; j <= FULL_SPARSE_SPANS; ++j) {
    if (j < FULL_SPARSE_SPANS) {
      bool mine = (live >> j) & 1u;
      unsigned b = __ballot_sync(0xffffffffu, mine);
      if (mine)
        ring[(head + pending + __popc(b & ((1u << lane) - 1u))) & 63] =
            (int)(base + 32LL * j);
      pending += __popc(b);
      __syncwarp();
    }
    int k = j < FULL_SPARSE_SPANS ? (pending >= 32 ? 32 : 0) : pending;
    if (k == 0) continue;
    int i = lane < k ? ring[(head + lane) & 63] : -1;
    __syncwarp();
    head = (head + k) & 63;
    pending -= k;
    if (i >= 0)
      full_lane<false>(i, n, p, g, mat_table, m_count, tex, rw, rw_state, c,
                       probe);
  }
}

// Stage full over buckets of one lane kind each, for the depths between
// the first and the sparse ones in scenes of several material types
// (kernels/shade.py full_schedule). There a warp of the thread-per-lane
// kernel holds a few live lanes that mix misses with lambert, metal,
// dielectric, PBR (and, extended, plastic, carpaint, subsurface) hits,
// whose sample_bsdf branches run one after another. full_list_kernel
// ends the live misses' paths itself (their background; a bucket of
// their own measured slower) and appends each live hit to the bucket of
// its key, 1 + the MAT_* type of its material (read from the material
// types staged in shared memory; bucket 0, the misses', stays empty):
// one ballot per key, a block-local scan and one atomic per block and key
// (common.cuh list_append_keyed), so each block's lanes stay in ascending
// order within a bucket; a block without a live lane returns after one
// barrier. shade_full_buckets_kernel then runs persistent warps over the
// buckets in kFullOrder (the long types first), 32 lanes of one bucket at
// a time, so a warp's lanes take one branch: each warp's first batch by
// its index, the next ones from a device counter. Each listed lane
// indexes every input by its own lane index and runs full_lane, the same
// arithmetic in the same order as the thread-per-lane kernel, so the bits
// cannot change. The host never reads a count. Scratch: FULL_HEADER int32
// (a count per key, the fetch position), then one region of n lanes per
// key.
#define N_FULL_KEYS 9
#define FULL_HEADER 16
#define FULL_TYPES_SHARED 2048

// the material id of the hit of lane i (its family's record)
__device__ __forceinline__ int hit_material(const Geo& g, long long i,
                                            int idx) {
  int kind = g.kind == nullptr ? PRIM_TRIANGLE : g.kind[i];
  if (kind == PRIM_TRIANGLE)
    return (int)tri_row_tail(g.shade_packed, idx).z;
  return kind == PRIM_SPHERE ? g.sph_material[idx] : g.rect_material[idx];
}

__global__ void __launch_bounds__(LIST_BLOCK) full_list_kernel(
    int n, ShadeParams p, Geo g, const int* __restrict__ mat_type,
    int m_count, Carry c, int* __restrict__ counters,
    int* __restrict__ lists) {
  __shared__ int types[FULL_TYPES_SHARED];
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool live = i < n && c.alive[i];
  if (!__syncthreads_or(live)) return;
  int staged = min(m_count, FULL_TYPES_SHARED);
  for (int m = threadIdx.x; m < staged; m += blockDim.x)
    types[m] = mat_type[m];
  __syncthreads();
  int key = -1;
  if (live) {
    int idx = g.idx[i];
    if (idx < 0) {
      full_miss(c, i, p);
    } else {
      int mid = min(max(hit_material(g, i, idx), 0), m_count - 1);
      int type = mid < staged ? types[mid] : mat_type[mid];
      // a type outside MAT_* shares bucket 1: a bucket only schedules a
      // lane, whose shading reads its own material
      key = type >= 0 && type < N_FULL_KEYS - 1 ? 1 + type : 1;
    }
  }
  if (__syncthreads_or(key >= 0))
    list_append_keyed<LIST_BLOCK, N_FULL_KEYS>(key, i, counters, lists, n);
}

// the order in which the warps take the buckets: the long types first
__constant__ int kFullOrder[N_FULL_KEYS] = {
    1 + MAT_SSS,        1 + MAT_CARPAINT, 1 + MAT_PLASTIC,
    1 + MAT_PBR,        1 + MAT_DIELECTRIC, 1 + MAT_METAL,
    1 + MAT_LAMBERT,    1 + MAT_LIGHT,    0};

template <bool EXT>
__global__ void __launch_bounds__(kBlock, EXT ? 4 : 6)
    shade_full_buckets_kernel(const int* __restrict__ lists,
                              int* __restrict__ counters, int n,
                              ShadeParams p, Geo g,
                              const float* __restrict__ mat_table,
                              int m_count, const float* __restrict__ tex,
                              const float* __restrict__ rw,
                              const long long* __restrict__ rw_state,
                              Carry c, float* __restrict__ probe) {
  // each bucket's lanes and its span of batch positions (whole batches
  // of 32), in kFullOrder
  __shared__ int count[N_FULL_KEYS], span[N_FULL_KEYS];
  if (threadIdx.x < N_FULL_KEYS) {
    int k = counters[kFullOrder[threadIdx.x]];
    count[threadIdx.x] = k;
    span[threadIdx.x] = (k + 31) & ~31;
  }
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int b = 0; b < N_FULL_KEYS; ++b) total += span[b];
  const int warps = gridDim.x * (blockDim.x >> 5);
  int k = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * 32;
  while (k < total) {
    int b = 0, j = k;
    while (j >= span[b]) j -= span[b++];
    j += threadIdx.x & 31;
    if (j < count[b])
      full_lane<EXT>(lists[(long long)kFullOrder[b] * n + j], n, p, g,
                     mat_table, m_count, tex, rw, rw_state, c, probe);
    k = warps * 32 + next_batch(counters + N_FULL_KEYS);
  }
}

// Stage s1 of one lane: updates the carry and fills tr, the lane's 18
// transients, which stay zero unless the lane is a live hit after s1
template <bool EXT>
__device__ __forceinline__ void s1_lane(
    int n, long long i, const ShadeParams& p, const Geo& g,
    const float* mat_table, int m_count, const float* envbg,
    const float* envpdf, const float* rectpdf, const float* emod,
    const float* tex, const Carry& c, float* probe, float* tr) {
  if (!c.alive[i]) return;
  V3 tp0 = load3(c.throughput, i);

  if (g.idx[i] < 0) {
    // ---- miss: the environment with MIS against the alias pdf, or the
    // gradient/solid background; the path ends ------------------------------
    V3 bg;
    float mis = 1.0f;
    if (envbg != nullptr) {
      bg = load3(envbg, i);
      float last_pdf = c.last_pdf[i];
      float denom = last_pdf + envpdf[i];
      if ((!c.last_delta[i] || p.specular_mis) && denom > 0.0f)
        mis = mis_weight(last_pdf, denom);
    } else {
      bg = background(load3(c.ray_d, i), p);
    }
    end_miss(c, i, load3(c.radiance, i) + clamp_firefly(tp0, bg * mis, p.c));
    return;
  }

  Front f =
      shade_front(g, n, i, p, mat_table, m_count, tex, rectpdf, emod, c);
  store3(c.radiance, i, f.radiance);
  if (f.ended) {
    probe_lane(probe, i, f.tp, 0.0f, false, 0);
    c.alive[i] = false;
    return;
  }
  store3(c.throughput, i, f.tp);
  probe_throughput(probe, i, f.tp);

  // ---- the NEE draws (3 per light integral, rect first), committed on
  // NEE lanes only -------------------------------------------------------
  bool delta = material_is_delta(f.m);
  uint32_t s0 = (uint32_t)c.state[i];
  uint32_t s_nee = s0;
  tr[0] = rand_uniform(&s_nee);
  tr[1] = rand_uniform(&s_nee);
  tr[2] = rand_uniform(&s_nee);
  if (envbg != nullptr && rectpdf != nullptr) {
    tr[15] = rand_uniform(&s_nee);
    tr[16] = rand_uniform(&s_nee);
    tr[17] = rand_uniform(&s_nee);
  }
  c.state[i] = (long long)(delta || f.tl.passthrough ? s0 : s_nee);

  tr[3] = env_lighting_roughness<EXT>(f.m);
  tr[4] = f.sn.x;
  tr[5] = f.sn.y;
  tr[6] = f.sn.z;
  tr[7] = f.h.n_faced.x;
  tr[8] = f.h.n_faced.y;
  tr[9] = f.h.n_faced.z;
  tr[10] = f.h.point.x;
  tr[11] = f.h.point.y;
  tr[12] = f.h.point.z;
  tr[13] = 1.0f;
  tr[14] = delta ? 1.0f : 0.0f;
}

// The transients are plane-major, (18, n): each lane keeps its 18 values
// in registers and stores each plane once at the end, so a warp's store
// covers 32 consecutive floats of one plane (a lane-major (n, 18) record
// put each of a warp's stores in 32 different sectors, and every value
// was stored twice: a zero first, then the value). Holding the 18 values
// took the base instantiation from 48 to 56 registers; its launch bound
// keeps it at 48 (ten 128-thread blocks per SM), no spills; the extended
// one's 56 registers fit nine blocks, as its 55 did before.
template <bool EXT>
__global__ void __launch_bounds__(128, EXT ? 9 : 10) shade_s1_kernel(
    int n, ShadeParams p, Geo g, const float* __restrict__ mat_table,
    int m_count, const float* __restrict__ envbg,
    const float* __restrict__ envpdf, const float* __restrict__ rectpdf,
    const float* __restrict__ emod, const float* __restrict__ tex, Carry c,
    float* __restrict__ trans, float* __restrict__ probe) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float tr[N_TRANS];
#pragma unroll
  for (int k = 0; k < N_TRANS; ++k) tr[k] = 0.0f;
  s1_lane<EXT>(n, i, p, g, mat_table, m_count, envbg, envpdf, rectpdf, emod,
               tex, c, probe, tr);
#pragma unroll
  for (int k = 0; k < N_TRANS; ++k) trans[(long long)k * n + i] = tr[k];
}

// Stage s2's base instantiation runs over the lanes alive after s1 (the
// live hits) and nothing else. s2_list_kernel lists them, one atomic per block over a scan of
// warp ballots (common.cuh list_append), so listed lanes keep their order
// within a block, and writes the CHAIN zeros of every other lane, one
// coalesced store a plane. The s2 kernel then runs as persistent blocks
// whose warps take the next 32 listed lanes from a device counter until
// the list is spent (K1's scheme, csrc/traverse.cu), so a warp holds live
// hits only: before, one thread ran per wavefront lane, and at the
// headline's depth 1 a warp held about five live hits of 32 and paid for
// its slowest. CHAIN is plane-major, (7, n), like TRANS: a listed lane
// stores each of its 7 values once, and no lane's value is stored twice.
// The host never reads the count. Each listed lane indexes every input
// (carry, hit, TRANS, TEX, ESMP, RW, PROBE) by its own lane index.
// The extended instantiation (227 registers, two blocks an SM) keeps one
// thread per wavefront lane (shade_s2_lanes_kernel), each lane storing
// its CHAIN planes once: over the list it read 0.76x at materials-env-rw's
// first depth and 0.94x a sample, for its long, divergent lanes packed
// 32 to a warp cannot overlap as the scattered ones of a sparse wavefront
// do (PERF.md, PR 9).
template <bool EXT>
__device__ __forceinline__ void s2_lane(
    long long i, int n, const ShadeParams& p, const Geo& g,
    const float* mat_table, int m_count, const float* trans,
    const float* esmp, const float* tex, const float* rw,
    const long long* rw_state, const Carry& c, float* chain, long long* fork,
    float* probe) {
  auto tr = [&](int k) { return plane_at(trans, n, i, k); };
  float t = g.t[i];
  V3 ray_d = load3(c.ray_d, i);
  Hit h = rebuild(g, i, load3(c.ray_o, i), ray_d);
  Mat m = fetch_material(mat_table, min(max(h.material, 0), m_count - 1));
  TexLane tl = apply_tex(tex, n, i, &m, p.working_space);
  V3 sn = v3(tr(4), tr(5), tr(6));
  V3 n_faced = v3(tr(7), tr(8), tr(9));
  V3 point = v3(tr(10), tr(11), tr(12));
  V3 incident = normalize3(ray_d);
  V3 wo = -incident;
  V3 tp = load3(c.throughput, i);
  V3 radiance = load3(c.radiance, i);

  // ---- NEE adds: one bank (light sample + shadow flag) per light
  // integral, rect first; MIS against the BSDF --------------------------
  for (int b = 0; b < p.n_banks; ++b) {
    const float* es = esmp + (long long)N_ESMP * p.n_banks * i + N_ESMP * b;
    V3 e_dir = v3(es[0], es[1], es[2]);
    float e_pdf = es[6];
    float n_dot_l = cmin(dot3(sn, e_dir), 0.0f);
    bool do_shadow = tr(14) < 0.5f && !tl.passthrough && es[7] > 0.5f &&
                     e_pdf > 0.0f && n_dot_l > 0.0f;
    if (do_shadow && !(es[8] > 0.5f)) {
      Eval ev = evaluate_bsdf<EXT>(m, point, sn, wo, e_dir, p.c, tl.occlusion,
                                   p.spec_only);
      float w = ev.pdf > 0.0f ? mis_weight(e_pdf, e_pdf + ev.pdf) : 1.0f;
      V3 contribution = v3(es[3], es[4], es[5]) * ev.value * n_dot_l *
                        (w / cmin(e_pdf, 1e-30f));
      if (!ev.is_delta && !ev.is_bssrdf && max3(ev.value) > 0.0f &&
          finite3(contribution))
        radiance = radiance + clamp_firefly(tp, contribution, p.c);
    }
  }

  // ---- BSDF sample from the post-s1 state ------------------------------
  uint32_t s = (uint32_t)c.state[i];
  Sample smp = lane_sample<EXT>(m, point, sn, wo, incident, h.front, &s, p,
                                tl.occlusion, tl.passthrough, ray_d, rw,
                                rw_state, i);
  probe_sample(probe, i, smp.pdf, smp.is_delta, smp.medium_event);
  bool active = smp.pdf > 0.0f;
  float ch[N_CHAIN] = {smp.weight.x,
                       smp.weight.y,
                       smp.weight.z,
                       smp.dpdf,
                       (float)smp.medium_event,
                       active && !tl.passthrough ? 1.0f : 0.0f,
                       h.front ? 1.0f : 0.0f};
#pragma unroll
  for (int k = 0; k < N_CHAIN; ++k) chain[(long long)k * n + i] = ch[k];
  // the fork state: the BSDF sample's commit (lane_sample leaves `s` as
  // it was on pass-through lanes), before the roulette draw
  if (fork != nullptr) fork[i] = (long long)s;

  int md = medium_update(c, i, smp, m, active);

  // ---- next origin, throughput, environment LOD, ray cone --------------
  V3 next_o = next_origin<EXT>(point, sn, n_faced, t, smp);
  tp = clamp_throughput(tp * smp.weight, p.c);
  active = active && finite3(tp) && max3(tp) > 0.0f;
  bool lod_lane = p.env_max_mip > 0.0f && active && smp.lobe_type == 1 &&
                  !smp.is_delta;
  float alpha_l = clampf(smp.lobe_roughness, 0.0f, 1.0f);
  float env_lod = lod_lane ? clampf(alpha_l * alpha_l * p.env_max_mip, 0.0f,
                                    p.env_max_mip)
                           : 0.0f;
  cone_update(c, i, ray_d, t, smp, active);
  active = roulette(p, &s, &tp, active, tl.passthrough);

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
  c.prev_mesh[i] = h.is_tri ? h.mesh : -1;
  c.prev_prim[i] = h.is_tri ? g.idx[i] : -1;
  c.medium_depth[i] = md;
  c.specular_depth[i] = smp.is_delta ? c.specular_depth[i] + 1 : 0;
  c.env_lod[i] = env_lod;
  c.env_lod_active[i] = lod_lane;
}

// the listing pass: lanes alive after s1 at list[0..counters[0]), the
// CHAIN planes of every other lane zero and its fork state (if asked for)
// its entry state
__global__ void __launch_bounds__(LIST_BLOCK) s2_list_kernel(
    int n, const bool* __restrict__ alive, int* __restrict__ counters,
    int* __restrict__ list, float* __restrict__ chain,
    const long long* __restrict__ state, long long* __restrict__ fork) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool live = i < n && alive[i];
  list_append<LIST_BLOCK>(live, i, counters, list);
  if (!live && i < n) {
#pragma unroll
    for (int k = 0; k < N_CHAIN; ++k) chain[(long long)k * n + i] = 0.0f;
    if (fork != nullptr) fork[i] = state[i];
  }
}

__global__ void __launch_bounds__(kBlock) shade_s2_kernel(
    const int* __restrict__ list, int* __restrict__ counters, int n,
    ShadeParams p, Geo g, const float* __restrict__ mat_table, int m_count,
    const float* __restrict__ trans, const float* __restrict__ esmp,
    const float* __restrict__ tex, const float* __restrict__ rw,
    const long long* __restrict__ rw_state, Carry c,
    float* __restrict__ chain, long long* __restrict__ fork,
    float* __restrict__ probe) {
  const int n_live = counters[0];
  for (;;) {
    int k = next_batch(counters + 1);
    if (k >= n_live) break;
    k += threadIdx.x & 31;
    if (k < n_live)
      s2_lane<false>(list[k], n, p, g, mat_table, m_count, trans, esmp,
                     tex, rw, rw_state, c, chain, fork, probe);
  }
}

// the extended instantiation: one thread per wavefront lane, CHAIN zero
// and the fork state (if asked for) the entry state on lanes not alive
// after s1
__global__ void __launch_bounds__(kBlock) shade_s2_lanes_kernel(
    int n, ShadeParams p, Geo g, const float* __restrict__ mat_table,
    int m_count, const float* __restrict__ trans,
    const float* __restrict__ esmp, const float* __restrict__ tex,
    const float* __restrict__ rw, const long long* __restrict__ rw_state,
    Carry c, float* __restrict__ chain, long long* __restrict__ fork,
    float* __restrict__ probe) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!c.alive[i]) {
#pragma unroll
    for (int k = 0; k < N_CHAIN; ++k) chain[(long long)k * n + i] = 0.0f;
    if (fork != nullptr) fork[i] = c.state[i];
    return;
  }
  s2_lane<true>(i, n, p, g, mat_table, m_count, trans, esmp, tex, rw,
                rw_state, c, chain, fork, probe);
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

// ShadeParams.scalars(): depth, clamp factor, floor, throughput, tail base,
// tail roughness scale, min specular pdf, max contribution, enabled,
// russian roulette, specular MIS, env max mip, working colour space,
// background mode, solid background (3), ESMP banks, SSS mode,
// debugSpecularOnly
ShadeParams shade_params_of(const float* s) {
  ShadeParams p;
  p.depth = (int)s[0];
  p.c = clamp_of(s[8], s[1], s[2], s[7], s[3], s[4], s[5], s[6]);
  p.russian_roulette = s[9] > 0.5f;
  p.specular_mis = s[10] > 0.5f;
  p.env_max_mip = s[11];
  p.working_space = (int)s[12];
  p.background_mode = (int)s[13];
  p.background = v3(s[14], s[15], s[16]);
  p.n_banks = (int)s[17];
  p.sss_mode = (int)s[18];
  p.spec_only = s[19] > 0.5f;
  return p;
}

// kernels/shade.py _geo_pointers: t, index, u, v, family (NULL: all
// triangles), shade_packed, sphere centre, radius, material, rectangle
// normal, material, two-sidedness
Geo geo_of(void* const* q) {
  Geo g;
  g.t = (const float*)q[0];
  g.idx = (const int*)q[1];
  g.u = (const float*)q[2];
  g.v = (const float*)q[3];
  g.kind = (const int*)q[4];
  g.shade_packed = (const float*)q[5];
  g.sph_center = (const float*)q[6];
  g.sph_radius = (const float*)q[7];
  g.sph_material = (const int*)q[8];
  g.rect_normal = (const float*)q[9];
  g.rect_material = (const int*)q[10];
  g.rect_two_sided = (const float*)q[11];
  return g;
}

int grid(int n) { return (n + kBlock - 1) / kBlock; }

int s2_grid_cache;
int full_grid_cache[2];

}  // namespace

// K2 full's listing pass alone: the live hits' buckets into `scratch`
// (FULL_HEADER + N_FULL_KEYS * n int32), the live misses' paths ended;
// mat_type: the (m_count,) int32 material types
extern "C" int mpt_full_list(int n, const float* scalars, void* const* geo,
                             const void* mat_type, int m_count,
                             void* const* carry, void* scratch,
                             void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int* sc = (int*)scratch;
  cudaError_t err = cudaMemsetAsync(sc, 0, FULL_HEADER * sizeof(int), st);
  if (err != cudaSuccess) {
    cudaGetLastError();  // reported here, not by the next launch
    return (int)err;
  }
  full_list_kernel<<<(n + LIST_BLOCK - 1) / LIST_BLOCK, LIST_BLOCK, 0, st>>>(
      n, shade_params_of(scalars), geo_of(geo), (const int*)mat_type,
      m_count, carry_of(carry), sc, sc + FULL_HEADER);
  return (int)cudaGetLastError();
}

// ext selects the instantiation with plastic, carpaint and subsurface;
// `scratch`: NULL, a thread per lane (sparse: shade_full_sparse_kernel,
// base only); else the buckets that mpt_full_list filled, run by
// persistent warps
extern "C" int mpt_shade_full(int n, int ext, int sparse,
                              const float* scalars, void* const* geo,
                              const void* mat_table, int m_count,
                              const void* tex, const void* rw,
                              const void* rw_state, void* const* carry,
                              void* probe, void* scratch, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  ShadeParams p = shade_params_of(scalars);
  Geo g = geo_of(geo);
  Carry c = carry_of(carry);
  if (scratch == nullptr && sparse) {
    if (ext) return (int)cudaErrorInvalidValue;
    int span = kBlock * FULL_SPARSE_SPANS;
    shade_full_sparse_kernel<<<(n + span - 1) / span, kBlock, 0, st>>>(
        n, p, g, (const float*)mat_table, m_count, (const float*)tex,
        (const float*)rw, (const long long*)rw_state, c, (float*)probe);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr) {
    auto kernel = ext ? shade_full_kernel<true> : shade_full_kernel<false>;
    kernel<<<grid(n), kBlock, 0, st>>>(
        n, p, g, (const float*)mat_table, m_count, (const float*)tex,
        (const float*)rw, (const long long*)rw_state, c, (float*)probe);
    return (int)cudaGetLastError();
  }
  auto kernel = ext ? shade_full_buckets_kernel<true>
                    : shade_full_buckets_kernel<false>;
  int blocks = persistent_grid(kernel, kBlock, &full_grid_cache[ext], n);
  int* sc = (int*)scratch;
  kernel<<<blocks, kBlock, 0, st>>>(
      sc + FULL_HEADER, sc, n, p, g, (const float*)mat_table, m_count,
      (const float*)tex, (const float*)rw, (const long long*)rw_state, c,
      (float*)probe);
  return (int)cudaGetLastError();
}

extern "C" int mpt_shade_s1(int n, int ext, const float* scalars,
                            void* const* geo, const void* mat_table,
                            int m_count, const void* envbg,
                            const void* envpdf, const void* rectpdf,
                            const void* emod, const void* tex,
                            void* const* carry, void* trans, void* probe,
                            void* stream) {
  if (n <= 0) return 0;
  auto kernel = ext ? shade_s1_kernel<true> : shade_s1_kernel<false>;
  kernel<<<grid(n), kBlock, 0, (cudaStream_t)stream>>>(
      n, shade_params_of(scalars), geo_of(geo), (const float*)mat_table,
      m_count, (const float*)envbg, (const float*)envpdf,
      (const float*)rectpdf, (const float*)emod, (const float*)tex,
      carry_of(carry), (float*)trans, (float*)probe);
  return (int)cudaGetLastError();
}

// `fork`: the (n,) int64 fork-state output of MNEE's secondary chain,
// NULL when it is off (then s2 reads and writes what it does without it);
// `scratch`: n + 2 int32, the list of lanes alive after s1 and its two
// counters (listed count, fetch position), for the base instantiation;
// null for the extended one, which takes no list
extern "C" int mpt_shade_s2(int n, int ext, const float* scalars,
                            void* const* geo, const void* mat_table,
                            int m_count, const void* trans, const void* esmp,
                            const void* tex, const void* rw,
                            const void* rw_state, void* const* carry,
                            void* chain, void* fork, void* probe,
                            void* scratch, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  Carry c = carry_of(carry);
  if (ext) {
    shade_s2_lanes_kernel<<<grid(n), kBlock, 0, st>>>(
        n, shade_params_of(scalars), geo_of(geo), (const float*)mat_table,
        m_count, (const float*)trans, (const float*)esmp, (const float*)tex,
        (const float*)rw, (const long long*)rw_state, c, (float*)chain,
        (long long*)fork, (float*)probe);
    return (int)cudaGetLastError();
  }
  int* sc = (int*)scratch;
  cudaError_t err = cudaMemsetAsync(sc, 0, 2 * sizeof(int), st);
  if (err != cudaSuccess) {
    cudaGetLastError();  // reported here, not by the next launch
    return (int)err;
  }
  s2_list_kernel<<<(n + LIST_BLOCK - 1) / LIST_BLOCK, LIST_BLOCK, 0, st>>>(
      n, c.alive, sc, sc + 2, (float*)chain, c.state, (long long*)fork);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int blocks =
      persistent_grid(shade_s2_kernel, kBlock, &s2_grid_cache, n);
  shade_s2_kernel<<<blocks, kBlock, 0, st>>>(
      sc + 2, sc, n, shade_params_of(scalars), geo_of(geo),
      (const float*)mat_table, m_count, (const float*)trans,
      (const float*)esmp, (const float*)tex, (const float*)rw,
      (const long long*)rw_state, c, (float*)chain, (long long*)fork,
      (float*)probe);
  return (int)cudaGetLastError();
}
