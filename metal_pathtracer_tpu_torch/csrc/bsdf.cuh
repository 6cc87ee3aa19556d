// BSDFs of the shade kernels: clamps, Fresnel/GGX helpers, and sampling
// and evaluation for lambert, metal, dielectric and PBR, and (the EXT
// instantiations of sample_bsdf/evaluate_bsdf only) plastic, carpaint and
// subsurface (a diffuse light ends its path before any sample:
// sample_bsdf returns the invalid one).
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
#define MAT_PLASTIC 4
#define MAT_SSS 5
#define MAT_CARPAINT 6
#define MAT_PBR 7
#define MAT_COLS 61
#define RAY_ORIGIN_EPSILON 1.0e-4f

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
  float has_cond, emission_env;
  // plastic / carpaint coat layer
  float coat_ior, coat_roughness, coat_thickness, coat_weight, coat_favg;
  V3 coat_tint, coat_abs;
  // carpaint base and flake lobes
  float cp_metallic, cp_roughness, cp_flake_scale, cp_flake_weight,
      cp_flake_roughness, cp_flake_anis, cp_flake_strength, cp_has_cond;
  V3 cp_eta, cp_k;
  // subsurface
  float sss_g, sss_mfp, sss_method, sss_coat, sss_override;
  V3 sss_sigma_a, sss_sigma_s;
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
  m.emission_env = r[24];
  m.coat_ior = r[25];
  m.coat_roughness = r[26];
  m.coat_thickness = r[27];
  m.coat_weight = r[28];
  m.coat_favg = r[29];
  m.coat_tint = v3(r[30], r[31], r[32]);
  m.coat_abs = v3(r[33], r[34], r[35]);
  m.cp_metallic = r[36];
  m.cp_roughness = r[37];
  m.cp_flake_scale = r[38];
  m.cp_flake_weight = r[39];
  m.cp_flake_roughness = r[40];
  m.cp_flake_anis = r[41];
  m.cp_flake_strength = r[42];
  m.cp_has_cond = r[43];
  m.cp_eta = v3(r[44], r[45], r[46]);
  m.cp_k = v3(r[47], r[48], r[49]);
  m.sss_g = r[50];
  m.sss_mfp = r[51];
  m.sss_method = r[52];
  m.sss_coat = r[53];
  m.sss_override = r[54];
  m.sss_sigma_a = v3(r[55], r[56], r[57]);
  m.sss_sigma_s = v3(r[58], r[59], r[60]);
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
__device__ __forceinline__ float plastic_coat_roughness(const Mat& m) {
  return cmin(clampf(m.coat_roughness, 0.0f, 1.0f), 1e-3f);
}
template <bool EXT>
__device__ __forceinline__ float env_lighting_roughness(const Mat& m) {
  if (EXT && m.type == MAT_PLASTIC)
    return clampf(plastic_coat_roughness(m), 0.0f, 1.0f);
  if (EXT && m.type == MAT_CARPAINT) return clampf(m.cp_roughness, 0.0f, 1.0f);
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
  bool has_exit;           // the next ray leaves from the BSSRDF exit
  V3 exit_point, exit_n;   // point, off its normal
};
__device__ __forceinline__ Sample invalid_sample() {
  Sample o;
  o.dir = o.weight = zero3();
  o.pdf = o.dpdf = 0.0f;
  o.is_delta = false;
  o.medium_event = o.lobe_type = 0;
  o.lobe_roughness = 0.0f;
  o.has_exit = false;
  o.exit_point = o.exit_n = zero3();
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
// spec_only (debugSpecularOnly, pbr.py:81-89): no diffuse colour, the
// specular lobe takes the whole reflection weight
__device__ inline PbrLobes pbr_lobes(const Mat& m, float occ, bool spec_only) {
  PbrLobes L;
  V3 base = clamp3(m.base, 0.0f, 1.0f);
  float metallic = clampf(m.metallic, 0.0f, 1.0f);
  L.roughness = clampf(m.roughness, 0.0f, 1.0f);
  float e = cmin(m.eta, 1.0f);
  float ratio = (e - 1.0f) / cmin(e + 1.0f, 1e-6f);
  float f0d = clampf(ratio * ratio, 0.0f, 0.99f);
  L.f0 = v3(f0d + (base.x - f0d) * metallic, f0d + (base.y - f0d) * metallic,
            f0d + (base.z - f0d) * metallic);
  L.diffuse_color = spec_only ? zero3()
                              : (base * (1.0f - metallic)) *
                                    clampf(occ, 0.0f, 1.0f);
  L.transmission = clampf(m.transmission, 0.0f, 1.0f) * (1.0f - metallic);
  L.reflect_scale = 1.0f - L.transmission;
  float swb = spec_only ? 1.0f : clampf(max3(L.f0), 0.05f, 0.95f);
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
  bool is_delta, is_bssrdf;
};

// pbr.evaluate_pbr
__device__ inline Eval evaluate_pbr(const Mat& m, V3 n, V3 wo, V3 wi,
                             const ClampP& p, float occ, bool spec_only) {
  float cos_o = dot3(n, wo), cos_i = dot3(n, wi);
  float abs_o = fabsf(cos_o), abs_i = fabsf(cos_i);
  bool geom_ok = abs_o > 0.0f && abs_i > 0.0f;
  PbrLobes L = pbr_lobes(m, occ, spec_only);
  Eval e;
  e.is_delta = L.roughness <= 1e-3f;
  e.is_bssrdf = false;
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
  e.is_bssrdf = false;
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

// pbr.sample_pbr: 1 selector draw, then 0 (smooth) or 2 more
__device__ inline Sample sample_pbr(const Mat& m, V3 n, V3 wo, V3 incident,
                             uint32_t* s, const ClampP& p, float occ,
                             bool spec_only) {
  PbrLobes L = pbr_lobes(m, occ, spec_only);
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

// ---- plastic (bsdf._sample_plastic, _evaluate_plastic) -----------------
__device__ __forceinline__ float plastic_coat_f0(const Mat& m) {
  float eta = cmin(m.eta, 1.0f);
  float ratio = (eta - 1.0f) / cmin(eta + 1.0f, 1e-6f);
  return clampf(ratio * ratio, 0.0f, 0.999f);
}
__device__ inline V3 plastic_specular_tint(const Mat& m) {
  V3 tint = clamp3(m.coat_tint, 0.0f, 1.0f);
  float th = cmin(m.coat_thickness, 0.0f);
  V3 ab = cmin3(m.coat_abs, 0.0f);
  V3 att = clamp3(tint * v3(expf(-ab.x * th), expf(-ab.y * th),
                            expf(-ab.z * th)),
                  0.0f, 1.0f);
  bool skip = th <= 0.0f || (ab.x <= 1e-6f && ab.y <= 1e-6f && ab.z <= 1e-6f);
  return skip ? tint : att;
}
__device__ inline V3 plastic_diffuse_transmission(const Mat& m, float cos_i,
                                                  float cos_o) {
  float th = cmin(m.coat_thickness, 0.0f);
  V3 tint = clamp3(m.coat_tint, 0.0f, 1.0f);
  V3 ab = cmin3(m.coat_abs, 0.0f);
  float di = th / cmin(cos_i, 1e-3f), d_o = th / cmin(cos_o, 1e-3f);
  V3 att_i = v3(expf(-ab.x * di), expf(-ab.y * di), expf(-ab.z * di));
  V3 att_o = v3(expf(-ab.x * d_o), expf(-ab.y * d_o), expf(-ab.z * d_o));
  V3 full = clamp3(tint * att_i * att_o, 0.0f, 1.0f);
  return th <= 0.0f ? tint : full;
}
__device__ __forceinline__ V3 one_minus(V3 a) {
  return v3(1.0f - a.x, 1.0f - a.y, 1.0f - a.z);
}
__device__ __forceinline__ V3 splat(float a) { return v3(a, a, a); }
__device__ __forceinline__ V3 max0(V3 a) { return cmin3(a, 0.0f); }
// (d * g) / max(4 cos_o cos_i, 1e-6): the GGX specular factor
__device__ __forceinline__ float ggx_factor(float d, float g, float cos_o,
                                           float cos_i) {
  return (d * g) / cmin(4.0f * cos_o * cos_i, 1e-6f);
}

// the plastic diffuse lobe at wi, before its pdf: (base / pi) occ,
// through the coat (both Fresnel transmissions, the coat average)
__device__ inline V3 plastic_diffuse(const Mat& m, V3 f0c, float cos_i,
                                     float cos_o, float occ) {
  V3 d = (clamp3(m.base, 0.0f, 1.0f) / PI_F) * clampf(occ, 0.0f, 1.0f);
  d = d * plastic_diffuse_transmission(m, cos_i, cos_o) *
      one_minus(schlick_fresnel(f0c, cos_i)) *
      one_minus(schlick_fresnel(f0c, cos_o));
  return max0(d * cmin(1.0f - clampf(m.coat_favg, 0.0f, 1.0f), 0.0f));
}

// 1 selector draw, then 2 for either lobe; spec_only: always the coat,
// a black diffuse lobe
__device__ inline Sample sample_plastic(const Mat& m, V3 n, V3 wo,
                                        uint32_t* s, const ClampP& p,
                                        float occ, bool spec_only) {
  float cos_o = dot3(n, wo);
  float cr = plastic_coat_roughness(m);
  float alpha = cr * cr;
  V3 f0c = splat(plastic_coat_f0(m));
  float p_coat = spec_only ? 1.0f : clampf(m.coat_weight, 0.0f, 1.0f);
  float p_diffuse = 1.0f - p_coat;
  float selector = rand_uniform(s);
  Sample o = invalid_sample();
  if (selector < p_coat && p_coat > 0.0f) {
    V3 wh = sample_ggx_vndf(n, wo, cr, s);
    V3 wi = safe_normalize3(reflect3(-wo, wh));
    float cos_i = dot3(n, wi);
    float dot_wi_wh = dot3(wi, wh);
    float d = ggx_d(alpha, dot3(n, wh));
    float g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i);
    V3 spec = schlick_fresnel(f0c, dot_wi_wh) * ggx_factor(d, g, cos_o, cos_i);
    spec = clamp_specular_tail(spec, cr, f0c, p) * plastic_specular_tint(m);
    float raw = ggx_pdf(alpha, n, wo, wi);
    float spec_pdf = raw > 0.0f ? clamp_specular_pdf(raw, p) : 0.0f;
    float pdf = p_coat * spec_pdf + p_diffuse * lambert_pdf(n, wi);
    V3 weight = spec * (cos_i / cmin(pdf, 1e-20f));
    if (dot3(wh, n) > 0.0f && cos_i > 0.0f && dot_wi_wh > 0.0f &&
        pdf > 0.0f && finite3(weight) && cos_o > 0.0f) {
      o.dir = wi;
      o.weight = max0(weight);
      o.pdf = o.dpdf = pdf;
      o.lobe_type = 1;
      o.lobe_roughness = cr;
    }
    return o;
  }
  V3 wi = safe_normalize3(to_world(sample_cosine_hemisphere(s), n));
  float cos_i = dot3(n, wi);
  V3 diffuse =
      spec_only ? zero3() : plastic_diffuse(m, f0c, cos_i, cos_o, occ);
  float raw = ggx_pdf(alpha, n, wo, wi);
  float spec_pdf = raw > 0.0f ? clamp_specular_pdf(raw, p) : 0.0f;
  float pdf = p_coat * spec_pdf + p_diffuse * lambert_pdf(n, wi);
  V3 weight = diffuse * (cos_i / cmin(pdf, 1e-20f));
  if (cos_i > 0.0f && pdf > 0.0f && finite3(weight) && cos_o > 0.0f) {
    o.dir = wi;
    o.weight = max0(weight);
    o.pdf = o.dpdf = pdf;
    o.lobe_roughness = 1.0f;
  }
  return o;
}

// cos_o, cos_i clamped at 0, both > 0; spec_only: the coat alone
__device__ inline Eval evaluate_plastic(const Mat& m, V3 n, V3 wo, V3 wi,
                                        float cos_o, float cos_i,
                                        const ClampP& p, float occ,
                                        bool spec_only) {
  float cr = plastic_coat_roughness(m);
  float alpha = cr * cr;
  V3 f0c = splat(plastic_coat_f0(m));
  V3 wh = safe_normalize3(wo + wi);
  bool half_ok = dot3(wh, n) > 0.0f && dot3(wo, wh) > 0.0f &&
                 dot3(wi, wh) > 0.0f;
  float d = ggx_d(alpha, dot3(n, wh));
  float g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i);
  V3 spec = schlick_fresnel(f0c, dot3(wi, wh)) * ggx_factor(d, g, cos_o, cos_i);
  spec = clamp_specular_tail(spec, cr, f0c, p) * plastic_specular_tint(m);
  spec = half_ok ? max0(spec) : zero3();
  float raw = ggx_pdf(alpha, n, wo, wi);
  float spec_pdf = half_ok && raw > 0.0f ? clamp_specular_pdf(raw, p) : 0.0f;
  float p_coat = spec_only ? 1.0f : clampf(m.coat_weight, 0.0f, 1.0f);
  Eval e;
  e.value = spec_only ? spec + zero3()
                      : spec + plastic_diffuse(m, f0c, cos_i, cos_o, occ);
  e.pdf = p_coat * spec_pdf + (1.0f - p_coat) * lambert_pdf(n, wi);
  e.is_delta = e.is_bssrdf = false;
  return e;
}

// ---- carpaint (ops/carpaint.py) ------------------------------------------
// jnp.mod(x, 1): the truncated remainder moved into [0, 1)
__device__ __forceinline__ float mod1(float x) {
  float r = fmodf(x, 1.0f);
  return (r != 0.0f && r < 0.0f) ? r + 1.0f : r;
}
// carpaint._hash3 with the jitted reference's two FMAs
__device__ inline V3 carpaint_hash3(V3 q) {
  float px = mod1(fmaf_rn(q.x, 0.3183099f, 0.1f));
  float py = mod1(fmaf_rn(q.y, 0.3183099f, 0.3f));
  float pz = mod1(fmaf_rn(q.z, 0.3183099f, 0.7f));
  float s = fmaf_rn(pz, px + 77.77f, fmaf_rn(px, py + 33.33f,
                                            py * (pz + 55.55f)));
  px = px + s;
  py = py + s;
  pz = pz + s;
  return v3(mod1((px + py) * 13.5453123f), mod1((px + pz) * 13.5453123f),
            mod1((py + pz) * 13.5453123f));
}
__device__ inline V3 flake_normal(const Mat& m, V3 pos, V3 n) {
  float sc = m.cp_flake_scale;
  V3 rnd = carpaint_hash3(v3(pos.x * sc, pos.y * sc, pos.z * sc));
  float ax = cmin(1.0f - m.cp_flake_anis, 1e-3f);
  float ay = cmin(1.0f + m.cp_flake_anis, 1e-3f);
  float phi = TWO_PI_F * rnd.x;
  float r = sqrtf(cmin(rnd.y, 1e-4f));
  float x = r * cosf(phi) * ax;
  float y = r * sinf(phi) * ay;
  float m2 = clampf(x * x + y * y, 0.0f, 0.99f);
  float z = sqrtf(cmin(1.0f - m2, 0.0f));
  V3 t, b;
  build_onb(n, &t, &b);
  V3 perturbed = normalize3(t * x + b * y + n * z);
  return normalize3(n + (perturbed - n) * m.cp_flake_strength);
}
__device__ inline V3 carpaint_base_f0(const Mat& m) {
  if (!(m.cp_has_cond > 0.0f)) return clamp3(m.base, 0.0f, 1.0f);
  return v3(fresnel_conductor1(1.0f, m.cp_eta.x, m.cp_k.x),
            fresnel_conductor1(1.0f, m.cp_eta.y, m.cp_k.y),
            fresnel_conductor1(1.0f, m.cp_eta.z, m.cp_k.z));
}
struct Lobe {
  V3 f;
  float pdf;
};
__device__ inline Lobe carpaint_coat(const Mat& m, V3 n, V3 wo, V3 wi,
                                     const ClampP& p) {
  float cos_o = cmin(dot3(n, wo), 0.0f), cos_i = cmin(dot3(n, wi), 0.0f);
  float rough = plastic_coat_roughness(m);
  float alpha = cmin(rough * rough, 1e-4f);
  V3 wh = safe_normalize3(wo + wi);
  bool geo = cos_i > 0.0f && cos_o > 0.0f && dot3(wh, n) > 0.0f &&
             dot3(wo, wh) > 0.0f && dot3(wi, wh) > 0.0f;
  float d = ggx_d(alpha, dot3(n, wh));
  float g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i);
  V3 f0c = splat(plastic_coat_f0(m));
  V3 spec = schlick_fresnel(f0c, dot3(wi, wh)) * ggx_factor(d, g, cos_o, cos_i);
  spec = clamp_specular_tail(spec * plastic_specular_tint(m), rough, f0c, p);
  float raw = ggx_pdf(alpha, n, wo, wi);
  bool ok = geo && raw > 0.0f;
  Lobe l;
  l.f = ok ? spec : zero3();
  l.pdf = ok ? clamp_specular_pdf(raw, p) : 0.0f;
  return l;
}
__device__ inline Lobe carpaint_flake(const Mat& m, V3 fn, V3 wo, V3 wi,
                                      const ClampP& p) {
  float cos_o = cmin(dot3(fn, wo), 0.0f), cos_i = cmin(dot3(fn, wi), 0.0f);
  float rough = cmin(clampf(m.cp_flake_roughness, 0.0f, 1.0f), 1e-3f);
  float alpha = rough * rough;
  V3 wh = safe_normalize3(wo + wi);
  bool geo = cos_i > 0.0f && cos_o > 0.0f && dot3(wh, fn) > 0.0f &&
             dot3(wo, wh) > 0.0f && dot3(wi, wh) > 0.0f;
  float d = ggx_d(alpha, dot3(fn, wh));
  float g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i);
  V3 f0 = carpaint_base_f0(m);
  V3 spec = schlick_fresnel(f0, dot3(wi, wh)) * ggx_factor(d, g, cos_o, cos_i);
  spec = clamp_specular_tail(spec * plastic_specular_tint(m), rough, f0, p);
  spec = spec * cmin(1.0f - clampf(m.coat_favg, 0.0f, 1.0f), 0.0f);
  float raw = ggx_pdf(alpha, fn, wo, wi);
  bool ok = geo && raw > 0.0f;
  Lobe l;
  l.f = ok ? spec : zero3();
  l.pdf = ok ? clamp_specular_pdf(raw, p) : 0.0f;
  return l;
}
__device__ inline Lobe carpaint_base(const Mat& m, V3 n, V3 wo, V3 wi,
                                     const ClampP& p) {
  float cos_o = cmin(dot3(n, wo), 0.0f), cos_i = cmin(dot3(n, wi), 0.0f);
  bool geo = cos_i > 0.0f && cos_o > 0.0f;
  float metallic = clampf(m.cp_metallic, 0.0f, 1.0f);
  float dw = cmin(1.0f - metallic, 0.0f), sw = cmin(metallic, 0.0f);
  float coat_t = cmin(1.0f - clampf(m.coat_favg, 0.0f, 1.0f), 0.0f);
  V3 base = clamp3(m.base, 0.0f, 1.0f);
  V3 diffuse = max0((base / PI_F) * plastic_diffuse_transmission(m, cos_i,
                                                                 cos_o) *
                    coat_t);
  bool use_diff = dw > 1e-4f;
  V3 combined = zero3() + (use_diff ? diffuse * dw : zero3());
  float pdf_diffuse = use_diff ? lambert_pdf(n, wi) : 0.0f;
  float rough = cmin(clampf(m.cp_roughness, 0.0f, 1.0f), 1e-3f);
  float alpha = rough * rough;
  V3 wh = safe_normalize3(wo + wi);
  bool half_ok = dot3(wh, n) > 0.0f && dot3(wo, wh) > 0.0f &&
                 dot3(wi, wh) > 0.0f;
  float d = ggx_d(alpha, dot3(n, wh));
  float g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i);
  float c = dot3(wi, wh);
  V3 f = m.cp_has_cond > 0.0f
             ? v3(fresnel_conductor1(c, m.cp_eta.x, m.cp_k.x),
                  fresnel_conductor1(c, m.cp_eta.y, m.cp_k.y),
                  fresnel_conductor1(c, m.cp_eta.z, m.cp_k.z))
             : schlick_fresnel(base, c);
  V3 spec = f * ggx_factor(d, g, cos_o, cos_i);
  spec = max0(clamp_specular_tail(spec * plastic_specular_tint(m) * coat_t,
                                  rough, carpaint_base_f0(m), p));
  bool use_spec = sw > 1e-4f && half_ok;
  combined = combined + (use_spec ? spec * sw : zero3());
  float raw = ggx_pdf(alpha, n, wo, wi);
  float pdf_spec = use_spec && raw > 0.0f ? clamp_specular_pdf(raw, p) : 0.0f;
  bool ok = geo && (dw > 1e-4f || sw > 1e-4f);
  Lobe l;
  l.f = ok ? max0(combined) : zero3();
  l.pdf = ok ? dw * pdf_diffuse + sw * pdf_spec : 0.0f;
  return l;
}
// carpaint._lobe_probs: (p_coat, p_flake, p_base)
__device__ inline void carpaint_probs(const Mat& m, float* pc, float* pf,
                                      float* pb) {
  float c = clampf(m.coat_weight, 0.0f, 0.95f);
  float f = clampf(m.cp_flake_weight, 0.0f, 0.95f);
  float b = cmin(1.0f - (c + f), 0.0f);
  float norm = c + f + b;
  if (norm <= 1e-6f) {
    c = f = 0.0f;
    b = norm = 1.0f;
  }
  *pc = c / norm;
  *pf = f / norm;
  *pb = b / norm;
}
__device__ inline Eval evaluate_carpaint(const Mat& m, V3 pos, V3 n, V3 wo,
                                         V3 wi, const ClampP& p) {
  float pc, pf, pb;
  carpaint_probs(m, &pc, &pf, &pb);
  Lobe coat = carpaint_coat(m, n, wo, wi, p);
  Lobe flake = carpaint_flake(m, flake_normal(m, pos, n), wo, wi, p);
  Lobe base = carpaint_base(m, n, wo, wi, p);
  Eval e;
  e.value = base.f * pb + flake.f * pf + coat.f * pc;
  e.pdf = pb * base.pdf + pf * flake.pdf + pc * coat.pdf;
  e.is_delta = e.is_bssrdf = false;
  return e;
}
// 1 selector draw; coat and flake 2 more, the base 1 + 2
__device__ inline Sample sample_carpaint(const Mat& m, V3 pos, V3 n, V3 wo,
                                         uint32_t* s, const ClampP& p) {
  float pc, pf, pb;
  carpaint_probs(m, &pc, &pf, &pb);
  float r = rand_uniform(s);
  int lobe = (pc > 0.0f && r < pc) ? 2 : ((pf > 0.0f && r < pc + pf) ? 1 : 0);
  if (lobe == 0 && pb <= 1e-6f)
    lobe = (pf > pc && pf > 0.0f) ? 1 : (pc > 0.0f ? 2 : 0);
  float cr = plastic_coat_roughness(m);
  V3 fn = flake_normal(m, pos, n);
  float fr = cmin(clampf(m.cp_flake_roughness, 0.0f, 1.0f), 1e-3f);
  float br = cmin(clampf(m.cp_roughness, 0.0f, 1.0f), 1e-3f);
  V3 wi;
  bool branch_ok = true, sample_spec = false;
  if (lobe == 2) {
    V3 wh = sample_ggx_vndf(n, wo, cr, s);
    wi = safe_normalize3(reflect3(-wo, wh));
    branch_ok = dot3(wh, n) > 0.0f;
  } else if (lobe == 1) {
    V3 wh = sample_ggx_vndf(fn, wo, fr, s);
    wi = safe_normalize3(reflect3(-wo, wh));
    branch_ok = dot3(wh, fn) > 0.0f;
  } else {
    float metallic = clampf(m.cp_metallic, 0.0f, 1.0f);
    float dw = cmin(1.0f - metallic, 0.0f), sw = cmin(metallic, 0.0f);
    float choose = rand_uniform(s);
    sample_spec = sw > 0.0f && (dw + sw) > 0.0f &&
                  choose < sw / cmin(dw + sw, 1e-6f);
    if (sample_spec) {
      V3 wh = sample_ggx_vndf(n, wo, br, s);
      wi = safe_normalize3(reflect3(-wo, wh));
      branch_ok = dot3(wh, n) > 0.0f;
    } else {
      wi = safe_normalize3(to_world(sample_cosine_hemisphere(s), n));
    }
  }
  bool dir_ok = branch_ok && finite3(wi) && dot3(n, wi) > 0.0f;
  Lobe coat = carpaint_coat(m, n, wo, wi, p);
  Lobe flake = carpaint_flake(m, fn, wo, wi, p);
  Lobe base = carpaint_base(m, n, wo, wi, p);
  float combined = pb * base.pdf + pf * flake.pdf + pc * coat.pdf;
  Lobe sel = lobe == 2 ? coat : (lobe == 1 ? flake : base);
  float cos_i = cmin(dot3(n, wi), 0.0f);
  V3 weight = sel.f * (cos_i / cmin(combined, 1e-20f));
  Sample o = invalid_sample();
  if (dir_ok && combined > 0.0f && sel.pdf > 0.0f &&
      (sel.f.x > 0.0f || sel.f.y > 0.0f || sel.f.z > 0.0f) && cos_i > 0.0f &&
      finite3(weight)) {
    o.dir = wi;
    o.weight = max0(weight);
    o.pdf = combined;
    o.dpdf = cmin(sel.pdf, 0.0f);
    o.lobe_type = (lobe == 0 && !sample_spec) ? 0 : 1;
    o.lobe_roughness = lobe == 2 ? cr : (lobe == 1 ? fr : (sample_spec ? br
                                                                        : 1.0f));
  }
  return o;
}

// ---- subsurface (ops/sss.py) ---------------------------------------------
// sss._lambert_fallback: 2 draws
__device__ inline Sample sss_fallback(const Mat& m, V3 n, uint32_t* s) {
  V3 wi = safe_normalize3(to_world(sample_cosine_hemisphere(s), n));
  float cos_i = dot3(n, wi);
  float pdf = lambert_pdf(n, wi);
  V3 weight = max0((clamp3(m.base, 0.0f, 1.0f) / PI_F) *
                   (cos_i / cmin(pdf, 1e-20f)));
  Sample o = invalid_sample();
  if (cos_i > 0.0f && pdf > 0.0f && finite3(weight)) {
    o.dir = wi;
    o.weight = weight;
    o.pdf = o.dpdf = pdf;
    o.lobe_roughness = 1.0f;
  }
  return o;
}
// sss._sigma_tr for one channel: (sigma_t', d, sigma_tr)
__device__ inline void sss_sigma_tr(float sa, float ss, float* stp, float* d,
                                    float* str) {
  *stp = cmin(sa + ss, 1e-6f);
  *d = 1.0f / cmin(3.0f * *stp, 1e-6f);
  *str = sqrtf(cmin(sa / *d, 1e-6f));
}
// sss.normalized_diffusion_profile for one channel
__device__ inline float sss_profile(float radius, float sa, float ss) {
  float stp, d, str;
  sss_sigma_tr(sa, ss, &stp, &d, &str);
  float ap = clampf(ss / stp, 0.0f, 1.0f);
  float r = cmin(radius, 1e-4f);
  float zr = 1.0f / stp;
  float dr = sqrtf(r * r + zr * zr);
  float vr = zr + 4.0f * d;
  float dv = sqrtf(r * r + vr * vr);
  float term_dr = (zr * (1.0f + str * dr)) / cmin(dr * dr * dr, 1e-6f);
  float term_dv = (vr * (1.0f + str * dv)) / cmin(dv * dv * dv, 1e-6f);
  float profile = (ap / 12.566370614359172f) *
                  (term_dr * expf(-str * dr) + term_dv * expf(-str * dv));
  return cmin(profile, 0.0f);
}
// sss.sample_subsurface: the separable BSSRDF (sss_mode 1, separable lanes:
// 4 draws) or the lambert fallback (2 draws)
__device__ inline Sample sample_subsurface(const Mat& m, V3 pos, V3 n, V3 wo,
                                           uint32_t* s, int sss_mode) {
  if (sss_mode != 1) return sss_fallback(m, n, s);
  float mfp = cmin(m.sss_mfp, 1e-4f);
  float anis = clampf(m.sss_g, -0.99f, 0.99f);
  float sigma_t = 1.0f / cmin(mfp, 1e-4f);
  float keep = cmin(1.0f - anis, 0.01f);
  bool over = m.sss_override > 0.5f;
  float base[3] = {m.base.x, m.base.y, m.base.z};
  float ova[3] = {m.sss_sigma_a.x, m.sss_sigma_a.y, m.sss_sigma_a.z};
  float ovs[3] = {m.sss_sigma_s.x, m.sss_sigma_s.y, m.sss_sigma_s.z};
  float sa[3], ss[3], tr[3];
  for (int c = 0; c < 3; ++c) {
    float b = clampf(clampf(base[c], 0.0f, 1.0f), 0.0f, 0.999f);
    float sig_s = cmin(b * sigma_t, 0.0f) * keep;
    sa[c] = over ? cmin(ova[c], 1e-6f) : cmin(sigma_t - sig_s, 1e-6f);
    ss[c] = (over ? cmin(ovs[c], 0.0f) : cmin(b * sigma_t, 0.0f)) * keep;
    float stp, d;
    sss_sigma_tr(sa[c], ss[c], &stp, &d, &tr[c]);
  }
  float sigma_tr = cmin(luminance3(v3(tr[0], tr[1], tr[2])), 1e-4f);
  if (!(m.sss_method < 0.5f && mfp > 1e-4f && sigma_tr > 0.0f))
    return sss_fallback(m, n, s);
  float u_r = clampf(rand_uniform(s), 1e-6f, 0.999999f);
  float s_tr = cmin(sigma_tr, 1e-4f);
  float radius = minn(-logf(1.0f - u_r) / s_tr, mfp * 10.0f);
  float pdf_radius = s_tr * expf(-s_tr * radius);
  float phi = TWO_PI_F * rand_uniform(s);
  V3 t, b;
  build_onb(n, &t, &b);
  V3 exit_point = fma3v(b, radius * sinf(phi),
                        fma3v(t, radius * cosf(phi), pos));
  V3 wi = safe_normalize3(to_world(sample_cosine_hemisphere(s), n));
  float cos_exit = dot3(n, wi);
  float pdf_dir = lambert_pdf(n, wi);
  float pdf_area = pdf_radius / (TWO_PI_F * cmin(radius, 1e-4f));
  V3 profile = v3(sss_profile(radius, sa[0], ss[0]),
                  sss_profile(radius, sa[1], ss[1]),
                  sss_profile(radius, sa[2], ss[2]));
  float coat_average = 1.0f - clampf(m.coat_favg, 0.0f, 1.0f);
  float ci = cmin(m.coat_ior, 1.0f);
  float ratio = (ci - 1.0f) / (ci + 1.0f);
  float f0 = ratio * ratio;
  float trans_in =
      1.0f - (f0 + (1.0f - f0) * schlick_weight(cmin(dot3(n, wo), 0.0f)));
  float trans_out = 1.0f - (f0 + (1.0f - f0) * schlick_weight(cos_exit));
  bool has_coat = m.sss_coat > 0.5f;
  if (has_coat) profile = profile * clamp3(m.coat_tint, 0.0f, 1.0f);
  float coat_trans = has_coat ? clampf(trans_in * trans_out, 0.0f, 1.0f)
                              : 1.0f;
  V3 weight = profile * (cos_exit * coat_average * coat_trans);
  float denom = cmin(pdf_area * pdf_dir, 1e-6f);
  weight = max0(weight / denom);
  Sample o = invalid_sample();
  if (pdf_radius > 0.0f && isfinite(pdf_radius) && cos_exit > 0.0f &&
      pdf_dir > 0.0f && pdf_area > 0.0f && finite3(weight)) {
    o.dir = wi;
    o.weight = weight;
    o.pdf = denom;
    o.dpdf = pdf_dir;
    o.has_exit = true;
    o.exit_point = exit_point;
    o.exit_n = n;
  }
  return o;
}
// sss.exit_point_origin: off the exit normal (the faced normal where that
// is not finite and non-zero) by eps, then 32 eps along the normal and 32
// eps along the direction
__device__ inline V3 exit_point_origin(const Sample& smp, V3 n_faced) {
  V3 en = smp.exit_n;
  if (!finite3(en) || dot3(en, en) <= 0.0f) en = n_faced;
  en = safe_normalize3(en);
  float sign = dot3(smp.dir, en) >= 0.0f ? 1.0f : -1.0f;
  V3 o = fma3v(en, sign * RAY_ORIGIN_EPSILON, smp.exit_point);
  o = fma3v(en, RAY_ORIGIN_EPSILON * 32.0f, o);
  return fma3v(safe_normalize3(smp.dir), RAY_ORIGIN_EPSILON * 32.0f, o);
}

// ---- the type dispatch -------------------------------------------------
// bsdf.evaluate_bsdf; EXT: with plastic, carpaint and subsurface
// spec_only (debugSpecularOnly, bsdf.py:838): lambert lanes evaluate to
// zero, plastic and PBR without their diffuse lobes
template <bool EXT>
__device__ inline Eval evaluate_bsdf(const Mat& m, V3 pos, V3 n, V3 wo, V3 wi,
                                     const ClampP& p, float occ,
                                     bool spec_only) {
  float cos_o = cmin(dot3(n, wo), 0.0f);
  float cos_i = cmin(dot3(n, wi), 0.0f);
  bool geom_ok = cos_i > 0.0f && cos_o > 0.0f;
  Eval e;
  e.value = zero3();
  e.pdf = 0.0f;
  e.is_delta = e.is_bssrdf = false;
  if (m.type == MAT_LAMBERT && geom_ok && !spec_only) {
    e.value = (clamp3(m.base, 0.0f, 1.0f) * clampf(occ, 0.0f, 1.0f)) / PI_F;
    e.pdf = lambert_pdf(n, wi);
  } else if (m.type == MAT_METAL && geom_ok) {
    e = evaluate_metal(m, n, wo, wi, cos_o, cos_i, p);
  } else if (m.type == MAT_DIELECTRIC) {
    e.is_delta = true;
  } else if (m.type == MAT_PBR && geom_ok) {
    e = evaluate_pbr(m, n, wo, wi, p, occ, spec_only);
  } else if (EXT && m.type == MAT_PLASTIC && geom_ok) {
    e = evaluate_plastic(m, n, wo, wi, cos_o, cos_i, p, occ, spec_only);
  } else if (EXT && m.type == MAT_CARPAINT && geom_ok) {
    e = evaluate_carpaint(m, pos, n, wo, wi, p);
  } else if (EXT && m.type == MAT_SSS) {
    e.is_bssrdf = true;
  }
  if (e.pdf <= 0.0f || !finite3(e.value)) e.value = zero3();
  return e;
}

// bsdf.sample_bsdf; EXT: with plastic, carpaint and subsurface.
// spec_only (debugSpecularOnly, bsdf.py:786): lambert and subsurface lanes
// draw nothing and keep the invalid sample, plastic and PBR drop their
// diffuse lobes
template <bool EXT>
__device__ inline Sample sample_bsdf(const Mat& m, V3 pos, V3 n, V3 wo,
                                     V3 incident, bool front, uint32_t* s,
                                     const ClampP& p, float occ,
                                     int sss_mode, bool spec_only) {
  if (spec_only && (m.type == MAT_LAMBERT || (EXT && m.type == MAT_SSS)))
    return invalid_sample();
  if (m.type == MAT_LAMBERT) return sample_lambert(m, n, s, occ);
  if (m.type == MAT_METAL) return sample_metal(m, n, wo, incident, s, p);
  if (m.type == MAT_DIELECTRIC) return sample_dielectric(m, n, incident, front, s);
  if (m.type == MAT_PBR)
    return sample_pbr(m, n, wo, incident, s, p, occ, spec_only);
  if (EXT && m.type == MAT_PLASTIC)
    return sample_plastic(m, n, wo, s, p, occ, spec_only);
  if (EXT && m.type == MAT_SSS)
    return sample_subsurface(m, pos, n, wo, s, sss_mode);
  if (EXT && m.type == MAT_CARPAINT) return sample_carpaint(m, pos, n, wo, s, p);
  return invalid_sample();
}
