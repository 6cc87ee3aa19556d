// BSDFs of the shade kernels: clamps, Fresnel/GGX helpers, and sampling
// and evaluation for lambert, metal, dielectric and PBR (a diffuse light
// ends its path before any sample: sample_bsdf returns the invalid one).
//
// Each function mirrors its plain PyTorch twin in ops/bsdf.py or
// ops/pbr.py operation for operation (same association, FMAs only inside
// dot3/cross3/luminance3/to_world, IEEE division, NaN-propagating
// min/max), so a kernel and its plain version agree to the bit wherever
// the libm functions (sinf, cosf, expf, exp2f) agree. The plain versions
// compute every lobe and select; these compute only the chosen lobe, with
// the same arithmetic and the same RNG draws.
#pragma once

#include "common.cuh"

#define PI_F 3.14159265358979323846f
#define TWO_PI_F 6.283185307179586f
#define SCHLICK_AVG_F 0.047619047619047616f  // 1/21
#define MAT_LAMBERT 0
#define MAT_METAL 1
#define MAT_DIELECTRIC 2
#define MAT_LIGHT 3
#define MAT_PBR 7
#define MAT_COLS 24

// bsdf.ClampParams
struct ClampP {
  float factor, floor, throughput, tail_base, tail_rough, min_spec_pdf,
      max_contribution, enabled;
};

// One row of the shade kernels' material table (kernels/shade.py MAT_COLS)
struct Mat {
  int type;
  V3 base;
  float roughness, eta, thin;
  V3 emission, sigma_a;
  float metallic, transmission, thickness, double_sided;
  V3 cond_eta, cond_k;
  float has_cond;
};

__device__ __forceinline__ Mat fetch_material(const float* table, int mid) {
  const float* r = table + (long long)MAT_COLS * mid;
  Mat m;
  m.type = (int)r[0];
  m.base = v3(r[1], r[2], r[3]);
  m.roughness = r[4];
  m.eta = r[5];
  m.thin = r[6];
  m.emission = v3(r[7], r[8], r[9]);
  m.sigma_a = v3(r[10], r[11], r[12]);
  m.metallic = r[13];
  m.transmission = r[14];
  m.thickness = r[15];
  m.double_sided = r[16];
  m.cond_eta = v3(r[17], r[18], r[19]);
  m.cond_k = v3(r[20], r[21], r[22]);
  m.has_cond = r[23];
  return m;
}

__device__ __forceinline__ V3 clamp3(V3 a, float lo, float hi) {
  return v3(clampf(a.x, lo, hi), clampf(a.y, lo, hi), clampf(a.z, lo, hi));
}
__device__ __forceinline__ float max3(V3 a) { return maxn(maxn(a.x, a.y), a.z); }
__device__ __forceinline__ V3 zero3() { return v3(0.0f, 0.0f, 0.0f); }

// bsdf.clamp_firefly_contribution
__device__ inline V3 clamp_firefly(V3 tp, V3 contribution, const ClampP& p) {
  V3 combined = tp * contribution;
  bool finite = finite3(combined);
  V3 positive = cmin3(combined, 0.0f);
  float lum = luminance3(positive);
  float tp_lum = luminance3(cmin3(tp, 0.0f));
  float max_lum = cmin(tp_lum * p.factor, p.floor);
  if (p.max_contribution > 0.0f) max_lum = cmin(max_lum, p.max_contribution);
  float scale = (lum > max_lum && lum > 0.0f) ? max_lum / cmin(lum, 1e-6f)
                                                : 1.0f;
  V3 out = p.enabled < 0.5f ? positive : cmin3(combined * scale, 0.0f);
  return finite ? out : zero3();
}

// bsdf.clamp_path_throughput
__device__ inline V3 clamp_throughput(V3 tp, const ClampP& p) {
  bool finite = finite3(tp);
  float lum = luminance3(cmin3(tp, 0.0f));
  float scale = (lum > p.throughput && lum > 0.0f)
                    ? p.throughput / cmin(lum, 1e-6f)
                    : 1.0f;
  V3 out = tp;
  if (p.enabled >= 0.5f && p.throughput > 0.0f)
    out = v3(scale * tp.x, scale * tp.y, scale * tp.z);
  return finite ? out : zero3();
}

// bsdf.clamp_specular_pdf
__device__ inline float clamp_specular_pdf(float pdf, const ClampP& p) {
  pdf = cmin(isfinite(pdf) ? pdf : 0.0f, 0.0f);
  float raised = p.min_spec_pdf > 0.0f ? cmin(pdf, p.min_spec_pdf) : pdf;
  return pdf > 0.0f ? raised : 0.0f;
}

// bsdf.clamp_specular_tail
__device__ inline V3 clamp_specular_tail(V3 value, float roughness, V3 f0,
                                  const ClampP& p) {
  bool finite = finite3(value);
  V3 positive = cmin3(value, 0.0f);
  if (p.enabled >= 0.5f && (p.tail_base > 0.0f || p.tail_rough > 0.0f)) {
    float strength = cmin(max3(f0), 1e-3f);
    float limit = (p.tail_base + p.tail_rough * roughness) * strength;
    limit = cmin(limit, p.floor);
    float lum = luminance3(positive);
    float scale = (lum > limit && lum > 0.0f) ? limit / cmin(lum, 1e-6f)
                                                : 1.0f;
    positive = positive * scale;
  }
  return finite ? positive : zero3();
}

// ---- Fresnel / GGX (bsdf.py:129-285) ----------------------------------
__device__ __forceinline__ float schlick_weight(float c) {
  float m = clampf(1.0f - c, 0.0f, 1.0f);
  return m * m * m * m * m;
}
__device__ __forceinline__ V3 schlick_fresnel(V3 f0, float c) {
  float w = schlick_weight(c);
  return v3(f0.x + (1.0f - f0.x) * w, f0.y + (1.0f - f0.y) * w,
            f0.z + (1.0f - f0.z) * w);
}

// returns Fr; *cos_t_out gets cosThetaT (0 on total internal reflection)
__device__ inline float fresnel_dielectric_exact(float cos_i, float eta_i,
                                          float eta_t, float* cos_t_out) {
  float abs_cos = fabsf(clampf(cos_i, -1.0f, 1.0f));
  float sin2_i = cmin(1.0f - abs_cos * abs_cos, 0.0f);
  float eta = eta_i / eta_t;
  float sin2_t = eta * eta * sin2_i;
  bool tir = sin2_t >= 1.0f;
  float cos_t = sqrtf(cmin(1.0f - sin2_t, 0.0f));
  float ei_ci = eta_i * abs_cos;
  float et_ct = eta_t * cos_t;
  float rs = (ei_ci - et_ct) / (ei_ci + et_ct);
  float rp = (eta_t * abs_cos - eta_i * cos_t) /
             (eta_t * abs_cos + eta_i * cos_t);
  float fr = 0.5f * (rs * rs + rp * rp);
  *cos_t_out = tir ? 0.0f : cos_t;
  return tir ? 1.0f : fr;
}

// bsdf.fresnel_conductor, one channel
__device__ inline float fresnel_conductor1(float ci, float eta, float k) {
  ci = clampf(ci, -1.0f, 1.0f);
  float cos2 = ci * ci;
  float sin2 = cmin(1.0f - cos2, 0.0f);
  float eta2 = eta * eta, k2 = k * k;
  float t0 = eta2 - k2 - sin2;
  float a2b2 = sqrtf(cmin(t0 * t0 + 4.0f * eta2 * k2, 0.0f));
  float a = sqrtf(cmin(0.5f * (a2b2 + t0), 0.0f));
  float term1 = a2b2 + cos2;
  float term2 = 2.0f * ci * a;
  float rs = (term1 - term2) / (term1 + term2);
  float term3 = cos2 * a2b2 + sin2 * sin2;
  float term4 = term2 * sin2;
  float rp = (term3 - term4) / (term3 + term4);
  return clampf(0.5f * (rs * rs + rp * rp), 0.0f, 1.0f);
}

__device__ inline float ggx_lambda(float alpha, float cos_theta) {
  float abs_cos = fabsf(cos_theta);
  float sin_theta = sqrtf(cmin(1.0f - abs_cos * abs_cos, 0.0f));
  float tan_theta = sin_theta / cmin(abs_cos, 1e-20f);
  float a = alpha * tan_theta;
  float lam = (sqrtf(1.0f + a * a) - 1.0f) * 0.5f;
  return (abs_cos <= 0.0f || sin_theta == 0.0f) ? 0.0f : lam;
}
__device__ __forceinline__ float ggx_g1(float alpha, float c) {
  return 1.0f / (1.0f + ggx_lambda(alpha, c));
}
__device__ inline float ggx_d(float alpha, float cos_h) {
  float abs_ch = fabsf(cos_h);
  float a2 = alpha * alpha;
  float denom = fmaf_rn(abs_ch * abs_ch, a2 - 1.0f, 1.0f);
  return a2 / (PI_F * denom * denom);
}
__device__ inline float ggx_pdf(float alpha, V3 n, V3 wo, V3 wi) {
  V3 wh = safe_normalize3(wo + wi);
  float cos_h = dot3(n, wh);
  float dot_wo_wh = dot3(wo, wh);
  float cos_o = dot3(n, wo);
  float pdf = ggx_d(alpha, cos_h) * ggx_g1(alpha, cos_o) * cos_h /
              (4.0f * cmin(dot_wo_wh, 1e-6f));
  return (cos_o <= 0.0f || cos_h <= 0.0f || dot_wo_wh <= 0.0f) ? 0.0f : pdf;
}

__device__ __forceinline__ V3 reflect3(V3 v, V3 n) {
  float s = 2.0f * dot3(v, n);
  return v3(v.x - s * n.x, v.y - s * n.y, v.z - s * n.z);
}
__device__ inline V3 refract3(V3 v, V3 n, float eta) {
  float cos_i = -dot3(v, n);
  float sin2_t = eta * eta * cmin(1.0f - cos_i * cos_i, 0.0f);
  float k = 1.0f - sin2_t;
  float c = eta * cos_i - sqrtf(cmin(k, 0.0f));
  V3 refr = v3(eta * v.x + c * n.x, eta * v.y + c * n.y, eta * v.z + c * n.z);
  return k >= 0.0f ? refr : zero3();
}

// vecmath.build_onb / to_world
__device__ __forceinline__ void build_onb(V3 n, V3* t, V3* b) {
  bool nz = fabsf(n.z) < 0.999f;
  V3 up = nz ? v3(0.0f, 0.0f, 1.0f) : v3(1.0f, 0.0f, 0.0f);
  *t = normalize3(cross3(up, n));
  *b = cross3(n, *t);
}
__device__ __forceinline__ V3 to_world(V3 l, V3 n) {
  V3 t, b;
  build_onb(n, &t, &b);
  return fma3(l.z, n, fma3(l.x, t, b * l.y));
}

// rng.sample_cosine_hemisphere (tangent space)
__device__ inline V3 sample_cosine_hemisphere(uint32_t* s) {
  float r1 = rand_uniform(s);
  float r2 = rand_uniform(s);
  float phi = TWO_PI_F * r2;
  float r = sqrtf(cmin(r1, 0.0f));
  return v3(cosf(phi) * r, sinf(phi) * r, sqrtf(cmin(1.0f - r1, 0.0f)));
}

// bsdf.sample_ggx_vndf: exactly 2 draws
__device__ inline V3 sample_ggx_vndf(V3 n, V3 wo, float roughness, uint32_t* s) {
  V3 t, b;
  build_onb(n, &t, &b);
  V3 w = safe_normalize3(wo);
  float lx = dot3(w, t), ly = dot3(w, b);
  float lz = cmin(dot3(w, n), 1e-6f);
  float alpha = cmin(roughness * roughness, 1e-4f);
  V3 vh = safe_normalize3(v3(alpha * lx, alpha * ly, lz));
  float lensq = vh.x * vh.x + vh.y * vh.y;
  float inv = 1.0f / sqrtf(cmin(lensq, 1e-38f));
  V3 t1 = lensq > 0.0f ? v3(-vh.y * inv, vh.x * inv, 0.0f)
                       : v3(1.0f, 0.0f, 0.0f);
  V3 t2 = cross3(vh, t1);
  float u1 = rand_uniform(s);
  float u2 = rand_uniform(s);
  float r = sqrtf(u1);
  float phi = TWO_PI_F * u2;
  float p1 = r * cosf(phi);
  float p2 = r * sinf(phi);
  float sh = 0.5f * (1.0f + vh.z);
  float p2_adj = (1.0f - sh) * sqrtf(cmin(1.0f - p1 * p1, 0.0f)) + sh * p2;
  float p3 = sqrtf(cmin(1.0f - p1 * p1 - p2_adj * p2_adj, 0.0f));
  V3 nh = v3(p1 * t1.x + p2_adj * t2.x + p3 * vh.x,
             p1 * t1.y + p2_adj * t2.y + p3 * vh.y,
             p1 * t1.z + p2_adj * t2.z + p3 * vh.z);
  V3 ne = safe_normalize3(v3(alpha * nh.x, alpha * nh.y, cmin(nh.z, 0.0f)));
  return safe_normalize3(to_world(ne, n));
}

// bsdf.specular_energy_compensation (dfg_approx inlined)
__device__ inline V3 specular_energy_compensation(V3 f0, float rough, float nov) {
  float nc = clampf(nov, 0.0f, 1.0f);
  float r0 = rough * -1.0f + 1.0f;
  float r1 = rough * -0.0275f + 0.0425f;
  float r2 = rough * -0.572f + 1.04f;
  float r3 = rough * 0.022f + -0.04f;
  float a004 = minn(r0 * r0, exp2f(-9.28f * nc)) * r0 + r1;
  float dx = -1.04f * a004 + r2;
  float dy = 1.04f * a004 + r3;
  float f[3] = {f0.x, f0.y, f0.z}, out[3];
  for (int c = 0; c < 3; ++c) {
    float fss = clampf(f[c] * dx + dy, 0.0f, 0.99f);
    float favg = f[c] + (1.0f - f[c]) * SCHLICK_AVG_F;
    float omf = clampf(1.0f - fss, 0.0f, 1.0f);
    float denom = cmin(1.0f - favg * omf, 1e-3f);
    float fms = (favg * omf) / denom;
    out[c] = clampf((fss + fms) / cmin(fss, 1e-4f), 1.0f, 2.0f);
  }
  return v3(out[0], out[1], out[2]);
}

__device__ __forceinline__ float lambert_pdf(V3 n, V3 d) {
  float cos_t = cmin(dot3(n, normalize3(d)), 0.0f);
  return cos_t > 0.0f ? cos_t / PI_F : 0.0f;
}

// bsdf.material_is_delta, environment_lighting_roughness
__device__ __forceinline__ bool material_is_delta(const Mat& m) {
  float rough = clampf(m.roughness, 0.0f, 1.0f);
  return m.type == MAT_DIELECTRIC ||
         ((m.type == MAT_METAL || m.type == MAT_PBR) && rough <= 1e-3f);
}
__device__ __forceinline__ float env_lighting_roughness(const Mat& m) {
  return m.type == MAT_METAL || m.type == MAT_PBR
             ? clampf(m.roughness, 0.0f, 1.0f)
             : 1.0f;
}

// bsdf.material_has_conductor_ior, conductor_f0, metal_fresnel
__device__ __forceinline__ bool has_conductor_ior(const Mat& m) {
  return m.has_cond > 0.0f || m.cond_eta.x > 0.0f || m.cond_eta.y > 0.0f ||
         m.cond_eta.z > 0.0f || m.cond_k.x > 0.0f || m.cond_k.y > 0.0f ||
         m.cond_k.z > 0.0f;
}
__device__ inline V3 metal_fresnel(const Mat& m, V3 f0, float c) {
  if (!has_conductor_ior(m)) return schlick_fresnel(f0, c);
  return v3(fresnel_conductor1(c, m.cond_eta.x, m.cond_k.x),
            fresnel_conductor1(c, m.cond_eta.y, m.cond_k.y),
            fresnel_conductor1(c, m.cond_eta.z, m.cond_k.z));
}
__device__ inline V3 conductor_f0(const Mat& m) {
  if (!has_conductor_ior(m)) return clamp3(m.base, 0.0f, 1.0f);
  return metal_fresnel(m, zero3(), 1.0f);
}

struct Sample {
  V3 dir, weight;
  float pdf, dpdf;
  bool is_delta;
  int medium_event, lobe_type;
  float lobe_roughness;
};
__device__ __forceinline__ Sample invalid_sample() {
  Sample o;
  o.dir = o.weight = zero3();
  o.pdf = o.dpdf = 0.0f;
  o.is_delta = false;
  o.medium_event = o.lobe_type = 0;
  o.lobe_roughness = 0.0f;
  return o;
}

// ---- lambert (bsdf._sample_lambert): 2 draws --------------------------
// `occ` is the diffuse occlusion of the texture stage (1 untextured)
__device__ inline Sample sample_lambert(const Mat& m, V3 n, uint32_t* s,
                                 float occ = 1.0f) {
  V3 wi = safe_normalize3(to_world(sample_cosine_hemisphere(s), n));
  float cos_i = dot3(n, wi);
  float pdf = lambert_pdf(n, wi);
  V3 f = (clamp3(m.base, 0.0f, 1.0f) * clampf(occ, 0.0f, 1.0f)) / PI_F;
  V3 weight = cmin3(f * (cos_i / cmin(pdf, 1e-20f)), 0.0f);
  Sample o = invalid_sample();
  if (cos_i > 0.0f && pdf > 0.0f && finite3(weight)) {
    o.dir = wi;
    o.weight = weight;
    o.pdf = o.dpdf = pdf;
    o.lobe_roughness = 1.0f;
  }
  return o;
}

// ---- metal (bsdf._sample_metal): a mirror at roughness <= 1e-3 (no
// draw), else a GGX lobe (2 draws) ------------------------------------------
__device__ inline Sample sample_metal(const Mat& m, V3 n, V3 wo, V3 incident,
                                      uint32_t* s, const ClampP& p) {
  float roughness = clampf(m.roughness, 0.0f, 1.0f);
  V3 f0 = conductor_f0(m);
  float cos_o = dot3(n, wo);
  Sample o = invalid_sample();
  if (roughness <= 1e-3f) {
    V3 wi_d = reflect3(incident, n);
    if (dot3(n, wi_d) > 0.0f) {
      o.dir = wi_d;
      o.weight = metal_fresnel(m, f0, cmin(cos_o, 0.0f));
      o.pdf = o.dpdf = 1.0f;
      o.is_delta = true;
      o.lobe_type = 1;
      o.lobe_roughness = roughness;
    }
    return o;
  }
  V3 wh = sample_ggx_vndf(n, wo, roughness, s);
  float alpha = roughness * roughness;
  V3 wi = safe_normalize3(reflect3(-wo, wh));
  float cos_i = dot3(n, wi);
  float dot_wo_wh = dot3(wo, wh);
  float d = ggx_d(alpha, dot3(n, wh));
  float g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i);
  V3 f = metal_fresnel(m, f0, dot3(wi, wh)) *
         ((d * g) / cmin(4.0f * cos_o * cos_i, 1e-6f));
  f = f * specular_energy_compensation(f0, roughness, cos_o);
  f = clamp_specular_tail(f, roughness, f0, p);
  float pdf_raw = ggx_pdf(alpha, n, wo, wi);
  float pdf = clamp_specular_pdf(pdf_raw, p);
  V3 weight = cmin3(f * (cos_i / cmin(pdf, 1e-20f)), 0.0f);
  if (dot3(wh, n) > 0.0f && finite3(wi) && cos_i > 0.0f && cos_o > 0.0f &&
      dot_wo_wh > 0.0f && pdf_raw > 0.0f && finite3(weight)) {
    o.dir = wi;
    o.weight = weight;
    o.pdf = o.dpdf = pdf;
    o.lobe_type = 1;
    o.lobe_roughness = roughness;
  }
  return o;
}

// ---- dielectric (bsdf._sample_dielectric): 1 draw ----------------------
__device__ inline Sample sample_dielectric(const Mat& m, V3 n, V3 incident,
                                    bool front, uint32_t* s) {
  bool is_thin = m.thin > 0.5f;
  float ref_idx = cmin(m.eta, 1.0f);
  bool inside = !is_thin && !front;
  float eta_i = inside ? ref_idx : 1.0f;
  float eta_t = inside ? 1.0f : ref_idx;
  float relative_eta = eta_i / eta_t;
  float cos_o = clampf(dot3(-incident, n), -1.0f, 1.0f);
  float cos_t;
  float fr = fresnel_dielectric_exact(cos_o, eta_i, eta_t, &cos_t);
  float xi = rand_uniform(s);
  V3 refr = refract3(incident, n, relative_eta);
  float refr_len2 = dot3(refr, refr);
  bool reflecting = xi < fr || refr_len2 <= 0.0f;
  Sample o = invalid_sample();
  if (reflecting) {
    o.dir = reflect3(incident, n);
    o.weight = v3(fr, fr, fr);
  } else {
    o.dir = refr / sqrtf(cmin(refr_len2, 1e-38f));
    float eta_scale = (eta_t * eta_t) / (eta_i * eta_i);
    float dir_scale = eta_scale * (fabsf(cos_t) / cmin(fabsf(cos_o), 1e-6f));
    float w = cmin(1.0f - fr, 0.0f) * dir_scale;
    o.weight = v3(w, w, w);
    if (!is_thin) o.medium_event = front ? 1 : -1;
  }
  o.dir = safe_normalize3(o.dir);
  o.pdf = o.dpdf = 1.0f;
  o.is_delta = true;
  o.lobe_type = 1;
  return o;
}

// ---- PBR (ops/pbr.py) --------------------------------------------------
struct PbrLobes {
  float roughness;
  V3 f0, diffuse_color;
  float transmission, reflect_scale, p_spec, p_diff, p_trans;
  bool weights_ok;
};
__device__ inline PbrLobes pbr_lobes(const Mat& m, float occ) {
  PbrLobes L;
  V3 base = clamp3(m.base, 0.0f, 1.0f);
  float metallic = clampf(m.metallic, 0.0f, 1.0f);
  L.roughness = clampf(m.roughness, 0.0f, 1.0f);
  float e = cmin(m.eta, 1.0f);
  float ratio = (e - 1.0f) / cmin(e + 1.0f, 1e-6f);
  float f0d = clampf(ratio * ratio, 0.0f, 0.99f);
  L.f0 = v3(f0d + (base.x - f0d) * metallic, f0d + (base.y - f0d) * metallic,
            f0d + (base.z - f0d) * metallic);
  L.diffuse_color = (base * (1.0f - metallic)) * clampf(occ, 0.0f, 1.0f);
  L.transmission = clampf(m.transmission, 0.0f, 1.0f) * (1.0f - metallic);
  L.reflect_scale = 1.0f - L.transmission;
  float swb = clampf(max3(L.f0), 0.05f, 0.95f);
  float w_spec = swb * L.reflect_scale;
  float w_diff = (1.0f - swb) * L.reflect_scale;
  float w_trans = L.transmission;
  float sum = w_spec + w_diff + w_trans;
  float safe = cmin(sum, 1e-20f);
  L.p_spec = w_spec / safe;
  L.p_diff = w_diff / safe;
  L.p_trans = w_trans / safe;
  L.weights_ok = sum > 0.0f;
  return L;
}

// pbr.transmission_tint
__device__ inline V3 transmission_tint(const Mat& m, float cos_theta) {
  float thickness = cmin(m.thickness, 0.0f);
  V3 sigma = cmin3(m.sigma_a, 0.0f);
  float distance = thickness / cmin(fabsf(cos_theta), 1e-3f);
  V3 tint = v3(clampf(expf(-sigma.x * distance), 0.0f, 1.0f),
               clampf(expf(-sigma.y * distance), 0.0f, 1.0f),
               clampf(expf(-sigma.z * distance), 0.0f, 1.0f));
  bool skip = thickness <= 0.0f ||
              (sigma.x <= 0.0f && sigma.y <= 0.0f && sigma.z <= 0.0f);
  return skip ? v3(1.0f, 1.0f, 1.0f) : tint;
}

__device__ inline float ggx_vndf_pdf(float alpha, V3 n, V3 wo, V3 wh) {
  float cos_o = dot3(n, wo);
  float cos_h = dot3(n, wh);
  float pdf = ggx_d(alpha, cos_h) * ggx_g1(alpha, cos_o) * cos_h /
              cmin(dot3(wo, wh), 1e-6f);
  return (cos_o <= 0.0f || cos_h <= 0.0f) ? 0.0f : pdf;
}

struct Eval {
  V3 value;
  float pdf;
  bool is_delta;
};

// pbr.evaluate_pbr
__device__ inline Eval evaluate_pbr(const Mat& m, V3 n, V3 wo, V3 wi,
                             const ClampP& p, float occ) {
  float cos_o = dot3(n, wo), cos_i = dot3(n, wi);
  float abs_o = fabsf(cos_o), abs_i = fabsf(cos_i);
  bool geom_ok = abs_o > 0.0f && abs_i > 0.0f;
  PbrLobes L = pbr_lobes(m, occ);
  Eval e;
  e.is_delta = L.roughness <= 1e-3f;
  e.value = zero3();
  e.pdf = 0.0f;
  if (!(geom_ok && L.weights_ok && !e.is_delta)) return e;
  float alpha = cmin(L.roughness * L.roughness, 1e-4f);
  V3 rs3 = v3(L.reflect_scale, L.reflect_scale, L.reflect_scale);
  if (cos_o * cos_i > 0.0f) {
    // reflection side
    if (!(cos_o > 0.0f && cos_i > 0.0f)) return e;
    V3 wh = safe_normalize3(wo + wi);
    bool half_ok = dot3(wh, n) > 0.0f && dot3(wo, wh) > 0.0f &&
                   dot3(wi, wh) > 0.0f;
    float d = ggx_d(alpha, dot3(n, wh));
    float g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i);
    V3 spec = schlick_fresnel(L.f0, dot3(wi, wh)) *
              (d * g / cmin(4.0f * cos_o * cos_i, 1e-6f));
    spec = spec * specular_energy_compensation(L.f0, L.roughness, abs_o);
    spec = clamp_specular_tail(spec, L.roughness, L.f0, p);
    spec = spec * rs3;
    float pdf_spec = ggx_pdf(alpha, n, wo, wi);
    V3 diffuse = (L.diffuse_color / PI_F) * rs3;
    float pdf_refl = L.p_spec * pdf_spec + L.p_diff * lambert_pdf(n, wi);
    if (half_ok && pdf_refl > 0.0f) {
      e.value = cmin3(spec + diffuse, 0.0f);
      e.pdf = clamp_specular_pdf(pdf_refl, p);
    }
    return e;
  }
  // transmission side
  float eta_t0 = cmin(m.eta, 1.0f);
  bool inside = cos_o < 0.0f;
  float eta_i = inside ? eta_t0 : 1.0f;
  float eta_t = inside ? 1.0f : eta_t0;
  float eta = eta_i / eta_t;
  V3 wht = safe_normalize3(wo + wi * eta);
  if (dot3(wht, n) <= 0.0f) wht = -wht;
  float cos_o_wh = dot3(wo, wht), cos_i_wh = dot3(wi, wht);
  float dt = ggx_d(alpha, cmin(dot3(n, wht), 0.0f));
  float gt = ggx_g1(alpha, abs_o) * ggx_g1(alpha, abs_i);
  float unused;
  float fr = fresnel_dielectric_exact(cos_o_wh, eta_i, eta_t, &unused);
  float denom = cos_o_wh + eta * cos_i_wh;
  float denom_sq = denom * denom;
  float factor = (eta * eta) * fabsf(cos_i_wh) * fabsf(cos_o_wh);
  factor = factor / cmin(abs_o * abs_i * denom_sq, 1e-6f);
  float ft = (1.0f - fr) * dt * gt * factor;
  V3 f = v3(ft, ft, ft) * transmission_tint(m, abs_i);
  f = f * v3(L.transmission, L.transmission, L.transmission);
  float pdf_wh = ggx_vndf_pdf(alpha, n, wo, wht);
  float dwh_dwi = fabsf((eta * eta * cos_i_wh) / cmin(denom_sq, 1e-8f));
  float pdf_trans = L.p_trans * pdf_wh * dwh_dwi;
  bool ok = L.transmission > 0.0f && finite3(wht) && dot3(wht, wht) > 0.0f &&
            cos_o_wh * cos_i_wh <= 0.0f && fabsf(denom_sq) > 1e-8f &&
            pdf_trans > 0.0f;
  if (ok) {
    e.value = cmin3(f, 0.0f);
    e.pdf = clamp_specular_pdf(pdf_trans, p);
  }
  return e;
}

// bsdf._evaluate_metal; cos_o, cos_i clamped at 0
__device__ inline Eval evaluate_metal(const Mat& m, V3 n, V3 wo, V3 wi,
                                      float cos_o, float cos_i,
                                      const ClampP& p) {
  float rough = clampf(m.roughness, 0.0f, 1.0f);
  Eval e;
  e.value = zero3();
  e.pdf = 0.0f;
  e.is_delta = rough <= 1e-3f;
  if (e.is_delta) return e;
  float alpha = rough * rough;
  V3 wh = safe_normalize3(wo + wi);
  bool half_ok = dot3(wh, n) > 0.0f && dot3(wo, wh) > 0.0f &&
                 dot3(wi, wh) > 0.0f;
  float d = ggx_d(alpha, dot3(n, wh));
  float g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i);
  V3 f0 = conductor_f0(m);
  V3 spec = metal_fresnel(m, f0, dot3(wi, wh)) *
            ((d * g) / cmin(4.0f * cos_o * cos_i, 1e-6f));
  spec = spec * specular_energy_compensation(f0, rough, cos_o);
  spec = clamp_specular_tail(spec, rough, f0, p);
  float p_raw = ggx_pdf(alpha, n, wo, wi);
  if (half_ok && p_raw > 0.0f) {
    e.value = cmin3(spec, 0.0f);
    e.pdf = clamp_specular_pdf(p_raw, p);
  }
  return e;
}

// bsdf.evaluate_bsdf over lambert, metal, dielectric, PBR
__device__ inline Eval evaluate_bsdf(const Mat& m, V3 n, V3 wo, V3 wi,
                              const ClampP& p, float occ) {
  float cos_o = cmin(dot3(n, wo), 0.0f);
  float cos_i = cmin(dot3(n, wi), 0.0f);
  bool geom_ok = cos_i > 0.0f && cos_o > 0.0f;
  Eval e;
  e.value = zero3();
  e.pdf = 0.0f;
  e.is_delta = false;
  if (m.type == MAT_LAMBERT && geom_ok) {
    e.value = (clamp3(m.base, 0.0f, 1.0f) * clampf(occ, 0.0f, 1.0f)) / PI_F;
    e.pdf = lambert_pdf(n, wi);
  } else if (m.type == MAT_METAL && geom_ok) {
    e = evaluate_metal(m, n, wo, wi, cos_o, cos_i, p);
  } else if (m.type == MAT_DIELECTRIC) {
    e.is_delta = true;
  } else if (m.type == MAT_PBR && geom_ok) {
    e = evaluate_pbr(m, n, wo, wi, p, occ);
  }
  if (e.pdf <= 0.0f || !finite3(e.value)) e.value = zero3();
  return e;
}

// pbr.sample_pbr: 1 selector draw, then 0 (smooth) or 2 more
__device__ inline Sample sample_pbr(const Mat& m, V3 n, V3 wo, V3 incident,
                             uint32_t* s, const ClampP& p, float occ) {
  PbrLobes L = pbr_lobes(m, occ);
  bool smooth = L.roughness <= 1e-3f;
  float alpha = cmin(L.roughness * L.roughness, 1e-4f);
  float choose = rand_uniform(s);
  bool lobe_spec = choose < L.p_spec;
  bool lobe_diff = !lobe_spec && choose < L.p_spec + L.p_diff;
  float cos_o = dot3(n, wo);
  float abs_o = fabsf(cos_o);
  float cos_o_pos = cmin(cos_o, 0.0f);
  V3 rs3 = v3(L.reflect_scale, L.reflect_scale, L.reflect_scale);
  V3 wi, f;
  float pdf_lobe;
  bool branch_ok;
  if (lobe_spec) {
    if (smooth) {
      wi = reflect3(incident, n);
      f = schlick_fresnel(L.f0, cos_o_pos) * rs3;
      pdf_lobe = 1.0f;
      branch_ok = dot3(n, wi) > 0.0f;
    } else {
      V3 wh = sample_ggx_vndf(n, wo, L.roughness, s);
      wi = reflect3(-wo, wh);
      float cos_i = dot3(n, wi);
      float d = ggx_d(alpha, dot3(n, wh));
      float g = ggx_g1(alpha, cos_o_pos) * ggx_g1(alpha, cos_i);
      f = schlick_fresnel(L.f0, dot3(wi, wh)) *
          (d * g / cmin(4.0f * cos_o_pos * cos_i, 1e-6f));
      f = f * specular_energy_compensation(L.f0, L.roughness, cos_o_pos);
      f = clamp_specular_tail(f, L.roughness, L.f0, p);
      f = f * rs3;
      pdf_lobe = ggx_pdf(alpha, n, wo, wi);
      branch_ok = cos_i > 0.0f;
    }
  } else if (lobe_diff) {
    wi = safe_normalize3(to_world(sample_cosine_hemisphere(s), n));
    f = (L.diffuse_color / PI_F) * rs3;
    pdf_lobe = lambert_pdf(n, wi);
    branch_ok = dot3(n, wi) > 0.0f;
  } else {
    float eta_t0 = cmin(m.eta, 1.0f);
    bool inside = cos_o < 0.0f;
    float eta_i = inside ? eta_t0 : 1.0f;
    float eta_t = inside ? 1.0f : eta_t0;
    float eta = eta_i / eta_t;
    V3 tr3 = v3(L.transmission, L.transmission, L.transmission);
    if (smooth) {
      V3 w0 = refract3(-wo, n, eta);
      float len2 = dot3(w0, w0);
      wi = w0 * (1.0f / sqrtf(cmin(len2, 1e-38f)));
      float cos_t0;
      float fr0 = fresnel_dielectric_exact(cos_o, eta_i, eta_t, &cos_t0);
      float eta_scale = (eta_t * eta_t) / (eta_i * eta_i);
      float dir_scale = eta_scale * (fabsf(cos_t0) / cmin(abs_o, 1e-6f));
      float ft0 = cmin(1.0f - fr0, 0.0f) * dir_scale;
      f = tr3 * (v3(ft0, ft0, ft0) * transmission_tint(m, fabsf(dot3(n, wi))));
      pdf_lobe = 1.0f;
      branch_ok = len2 > 0.0f;
    } else {
      V3 wh = sample_ggx_vndf(n, wo, L.roughness, s);
      V3 wr = refract3(-wo, wh, eta);
      float len2 = dot3(wr, wr);
      wi = wr * (1.0f / sqrtf(cmin(len2, 1e-38f)));
      float cos_i = dot3(n, wi);
      float abs_i = fabsf(cos_i);
      float cos_o_wh = dot3(wo, wh), cos_i_wh = dot3(wi, wh);
      float dt = ggx_d(alpha, cmin(dot3(n, wh), 0.0f));
      float gt = ggx_g1(alpha, abs_o) * ggx_g1(alpha, abs_i);
      float unused;
      float frt = fresnel_dielectric_exact(cos_o_wh, eta_i, eta_t, &unused);
      float denom = cos_o_wh + eta * cos_i_wh;
      float denom_sq = denom * denom;
      float factor = (eta * eta) * fabsf(cos_i_wh) * fabsf(cos_o_wh);
      factor = factor / cmin(abs_o * abs_i * denom_sq, 1e-6f);
      float ftr = (1.0f - frt) * dt * gt * factor;
      f = tr3 * (v3(ftr, ftr, ftr) * transmission_tint(m, abs_i));
      float pdf_wh = ggx_vndf_pdf(alpha, n, wo, wh);
      float dwh_dwi = fabsf((eta * eta * cos_i_wh) / cmin(denom_sq, 1e-8f));
      pdf_lobe = pdf_wh * dwh_dwi;
      branch_ok = len2 > 0.0f && cos_i * cos_o < 0.0f &&
                  cos_o_wh * cos_i_wh <= 0.0f && fabsf(denom_sq) > 1e-8f;
    }
  }
  bool lobe_trans = !lobe_spec && !lobe_diff;
  float pdf = L.p_spec * (lobe_spec ? pdf_lobe : 0.0f) +
              L.p_diff * (lobe_diff ? pdf_lobe : 0.0f) +
              L.p_trans * (lobe_trans ? pdf_lobe : 0.0f);
  float abs_i = fabsf(dot3(n, wi));
  V3 weight = cmin3(f * (abs_i / cmin(pdf, 1e-20f)), 0.0f);
  Sample o = invalid_sample();
  if (L.weights_ok && branch_ok && abs_i > 0.0f && pdf > 0.0f &&
      finite3(weight)) {
    o.dir = wi;
    o.weight = weight;
    o.pdf = o.dpdf = pdf;
    o.is_delta = !lobe_diff && smooth;
    o.lobe_type = lobe_spec ? 1 : (lobe_diff ? 0 : 2);
    o.lobe_roughness = lobe_diff ? 1.0f : L.roughness;
  }
  return o;
}

// bsdf.sample_bsdf over lambert, metal, dielectric, PBR
__device__ inline Sample sample_bsdf(const Mat& m, V3 n, V3 wo, V3 incident,
                              bool front, uint32_t* s, const ClampP& p,
                              float occ) {
  if (m.type == MAT_LAMBERT) return sample_lambert(m, n, s, occ);
  if (m.type == MAT_METAL) return sample_metal(m, n, wo, incident, s, p);
  if (m.type == MAT_DIELECTRIC) return sample_dielectric(m, n, incident, front, s);
  if (m.type == MAT_PBR) return sample_pbr(m, n, wo, incident, s, p, occ);
  return invalid_sample();
}
