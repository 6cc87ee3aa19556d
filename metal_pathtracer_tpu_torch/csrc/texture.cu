// The texture pre-stage: each lane's textured PBR material overrides for
// one depth, between K1 and K2 s1.
//
// Replaces the JAX package's XLA texture stage ops/pallas/shade.py
// _texture_stage:3600 over ops/pbr_textures.py apply_pbr_textures (not a
// TPU kernel there), together with the identity planes (_texture_identity
// :3511) and the cumsum compaction with its lax.switch (_texture_dispatch
// :3524) that a TPU needs because it cannot branch per lane. Here one
// thread takes one lane: a lane that is not alive, missed, or hit a
// non-PBR material writes the identity (all-zero planes, tpbr 0) and
// keeps its state; an eligible lane samples the six texture slots
// (trilinear in the flat mip atlas, repeat/clamp/mirror addressing, UV set
// 0 or 1, KHR transform, Igehy LOD at depth 0 and ray-cone LOD beyond),
// applies ORM, transmission, alpha MASK/BLEND (one RNG draw on BLEND
// lanes, committed to the state in place), occlusion, emissive and the
// normal map with Toksvig widening, and writes the 15 planes of
// ops/kernels/texture.py TEX, plane-major: (15, n).
//
// What bounds it on an H100: bytes. An eligible lane reads its ray and
// cone (~40 B), 80 B of its triangle's 96 B shade_packed row (five 16-byte
// loads), up to 2x3 UV pairs (8-byte loads) and three tangents (16-byte
// loads) of its triangle, a 256 B material row and 8 texels (16 B each,
// one load) per bound slot, and writes 60 B of planes; a live hit on a
// non-PBR material reads 16 B of its row (the material id) and a dead lane
// only its flag, and every such lane writes 60 B of zeros, each plane
// once and coalesced, which is what a late depth costs. The launch
// constants come from the caller, built once per frame on the host, so a
// launch reads nothing back. The arithmetic (a few sqrt, div
// and log2 per slot) is small beside that. Slots no material binds take
// their defaults without a read, as in the plain version. Every operation
// mirrors ops/pbr_textures.py and ops/textures.py in order, with
// __fmaf_rn where they call vecmath.fma (the build passes --fmad=false);
// the libm log2f and the plain version's torch.log2 may differ in the
// last place, which can move a LOD, so planes are compared with a
// tolerance and the state and flags exactly.
//
// A lane that hit a placement of an instanced mesh (family KIND_INSTANCE +
// k, Inst below) takes its hit record from common.cuh rebuild_instanced
// (world-space normals, the placement's material) and, as the JAX
// package's XLA stage does (ops/pbr_textures.py:177-211: the instanced
// record says PRIMITIVE_TRIANGLE), the UVs, tangents and Igehy triangle
// of the SOUP triangle at clip(object triangle, 0, soup count - 1).
#include "bsdf.cuh"

#define N_TEX 15
#define TEX_MAT_COLS 64

namespace {

// texture.py TexParams.scalars(): depth, width, height, camera horizontal
// and vertical, working space, slot bit mask, UV set 1, the debug flags,
// the normal strength scale and the atlas's top LOD
struct TexParams {
  int depth, width, height;
  V3 hor, ver;
  int working_space, slots, uv1, disable_ao, ao_indirect_only, disable_nm,
      disable_orm, flip_green;
  float normal_strength, max_lod;
};

struct Atlas {
  const float* texels;  // (TOTAL, 4)
  const int *level_offset, *level_w, *level_h;  // (T, L)
  const int* n_levels;
  const float* size0;
  const int* wrap;  // (T, 2)
  int n_textures, max_levels;
};

// the triangle attributes, by value: shade_packed, uv0-uv2, uvb0-uvb2
// ((T, 2), 8-byte aligned), t0-t2 ((T, 4), 16-byte aligned) (TrianglesSoA)
struct TriAttrs {
  const float* p[10];
};

struct F4 {
  float x, y, z, w;
};
__device__ __forceinline__ F4 f4(float x, float y, float z, float w) {
  F4 r = {x, y, z, w};
  return r;
}

struct V2 {
  float x, y;
};
// a UV pair as one 8-byte load
__device__ __forceinline__ V2 load2(const float* p, int i) {
  float2 a = __ldg(reinterpret_cast<const float2*>(p) + i);
  V2 r = {a.x, a.y};
  return r;
}

// torch.remainder on int32 (a floor-mod, the sign of the divisor)
__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// textures._address
__device__ int address(int coord, int size, int mode) {
  int wrapped = floor_mod(coord, size);
  int clamped = min(max(coord, 0), size - 1);
  int period = 2 * size;
  int m = floor_mod(coord, period);
  int mirrored = m < size ? m : period - 1 - m;
  return mode == 0 ? wrapped : (mode == 1 ? clamped : mirrored);
}

// textures._lerp: the second product fused
__device__ __forceinline__ float lerpf(float a, float b, float f) {
  return fmaf_rn(b, f, a * (1.0f - f));
}
__device__ __forceinline__ F4 lerp4(F4 a, F4 b, float f) {
  return f4(lerpf(a.x, b.x, f), lerpf(a.y, b.y, f), lerpf(a.z, b.z, f),
            lerpf(a.w, b.w, f));
}

// an RGBA texel as one 16-byte load
__device__ __forceinline__ F4 texel(const Atlas& A, long long idx) {
  float4 t = __ldg(reinterpret_cast<const float4*>(A.texels) + idx);
  return f4(t.x, t.y, t.z, t.w);
}

// textures._bilinear_level
__device__ F4 bilinear_level(const Atlas& A, int tid, int level, float u,
                             float v, int ws, int wt) {
  int k = tid * A.max_levels + level;
  long long off = A.level_offset[k];
  int w = A.level_w[k], h = A.level_h[k];
  float x = fmaf_rn(u, (float)w, -0.5f);
  float y = fmaf_rn(v, (float)h, -0.5f);
  float x0 = floorf(x), y0 = floorf(y);
  float fx = x - x0, fy = y - y0;
  int x0i = (int)x0, y0i = (int)y0;
  long long xa = address(x0i, w, ws), xb = address(x0i + 1, w, ws);
  long long ya = address(y0i, h, wt), yb = address(y0i + 1, h, wt);
  F4 c00 = texel(A, off + ya * w + xa), c10 = texel(A, off + ya * w + xb);
  F4 c01 = texel(A, off + yb * w + xa), c11 = texel(A, off + yb * w + xb);
  return lerp4(lerp4(c00, c10, fx), lerp4(c01, c11, fx), fy);
}

// textures.sample_texture with a LOD, for a bound texture (tex_id >= 0)
__device__ F4 sample_texture(const Atlas& A, int tex_id, float u, float v,
                             float lod) {
  int tid = min(max(tex_id, 0), A.n_textures - 1);
  int ws = A.wrap[2 * tid], wt = A.wrap[2 * tid + 1];
  int top = A.n_levels[tid] - 1;
  lod = minn(cmin(lod, 0.0f), (float)top);
  int lo = (int)floorf(lod);
  int hi = min(lo + 1, top);
  float frac = lod - (float)lo;
  return lerp4(bilinear_level(A, tid, lo, u, v, ws, wt),
               bilinear_level(A, tid, hi, u, v, ws, wt), frac);
}

// pbr_textures._interp: saturated barycentric weights over three corners
__device__ __forceinline__ float interp1(float w0, float w1, float w2,
                                         float a0, float a1, float a2) {
  return fmaf_rn(w2, a2, fmaf_rn(w0, a0, w1 * a1));
}

// pbr_textures._uv_per_world
__device__ float uv_per_world(V3 v0, V3 v1, V3 v2, V2 a0, V2 a1, V2 a2) {
  V3 e1 = v1 - v0, e2 = v2 - v0;
  float d1x = a1.x - a0.x, d1y = a1.y - a0.y;
  float d2x = a2.x - a0.x, d2y = a2.y - a0.y;
  float det = fmaf_rn(d1x, d2y, -(d1y * d2x));
  float inv_det = 1.0f / (fabsf(det) > 1e-9f ? det : 1.0f);
  V3 dpdu = v3(fmaf_rn(e1.x, d2y, -(e2.x * d1y)),
               fmaf_rn(e1.y, d2y, -(e2.y * d1y)),
               fmaf_rn(e1.z, d2y, -(e2.z * d1y))) * inv_det;
  V3 dpdv = v3(fmaf_rn(e2.x, d1x, -(e1.x * d2x)),
               fmaf_rn(e2.y, d1x, -(e1.y * d2x)),
               fmaf_rn(e2.z, d1x, -(e1.z * d2x))) * inv_det;
  float len_u = sqrtf(cmin(dot3(dpdu, dpdu), 1e-30f));
  float len_v = sqrtf(cmin(dot3(dpdv, dpdv), 1e-30f));
  float primary = maxn(1.0f / len_u, 1.0f / len_v);
  V3 n = cross3(e1, e2);
  float world_area = sqrtf(cmin(dot3(n, n), 1e-30f));
  float fallback = sqrtf(fabsf(det) / cmin(world_area, 1e-12f));
  bool ok = fabsf(det) > 1e-9f && len_u > 1e-8f && len_v > 1e-8f;
  float out = ok ? primary : fallback;
  return (isfinite(out) && out > 0.0f) ? out : 0.0f;
}

// pbr_textures._igehy_uv_gradient
__device__ float uv_grad(V3 dp, V3 e1, V3 e2, float e11, float e12,
                         float e22, float inv, V2 duv1, V2 duv2) {
  float p1 = dot3(dp, e1), p2 = dot3(dp, e2);
  float a = fmaf_rn(p1, e22, -(p2 * e12)) * inv;
  float b = fmaf_rn(p2, e11, -(p1 * e12)) * inv;
  float gx = fmaf_rn(a, duv1.x, b * duv2.x);
  float gy = fmaf_rn(a, duv1.y, b * duv2.y);
  return sqrtf(cmin(fmaf_rn(gy, gy, gx * gx), 0.0f));
}
__device__ float igehy_gradient(V3 v0, V3 v1, V3 v2, V2 a0, V2 a1, V2 a2,
                                V3 n, V3 d, float t, V3 ddx, V3 ddy) {
  V3 e1 = v1 - v0, e2 = v2 - v0;
  V2 duv1 = {a1.x - a0.x, a1.y - a0.y}, duv2 = {a2.x - a0.x, a2.y - a0.y};
  float dn = dot3(d, n);
  float safe_dn = fabsf(dn) > 1e-12f ? dn : (dn >= 0.0f ? 1e-12f : -1e-12f);
  float kx = dot3(ddx, n) / safe_dn, ky = dot3(ddy, n) / safe_dn;
  V3 dpx = v3(fmaf_rn(-kx, d.x, ddx.x), fmaf_rn(-kx, d.y, ddx.y),
              fmaf_rn(-kx, d.z, ddx.z)) * t;
  V3 dpy = v3(fmaf_rn(-ky, d.x, ddy.x), fmaf_rn(-ky, d.y, ddy.y),
              fmaf_rn(-ky, d.z, ddy.z)) * t;
  float e11 = dot3(e1, e1), e12 = dot3(e1, e2), e22 = dot3(e2, e2);
  float det = fmaf_rn(e11, e22, -(e12 * e12));
  float inv = 1.0f / (fabsf(det) > 1e-20f ? det : 1.0f);
  float grad = maxn(uv_grad(dpx, e1, e2, e11, e12, e22, inv, duv1, duv2),
                    uv_grad(dpy, e1, e2, e11, e12, e22, inv, duv1, duv2));
  bool ok = fabsf(det) > 1e-20f && fabsf(dn) > 1e-12f && isfinite(grad);
  return ok ? grad : 0.0f;
}

__device__ __forceinline__ V3 working(V3 c, int working_space) {
  return working_space == 1 ? to_acescg(c) : c;
}

// One lane's footprint inputs, shared by the six slots
struct Footprint {
  V2 uv[2];           // UV set 0, 1 (set 1 = set 0 without UV set 1)
  float upw[2], ig[2];  // UV density and Igehy gradient per set
  float footprint;
};

// pbr_textures.apply_pbr_textures slot_sample: (rgba, valid)
__device__ F4 slot_sample(const TexParams& p, const Atlas& A,
                          const float* mat, const Footprint& fp, int slot,
                          F4 fill, bool* valid) {
  *valid = false;
  int tid = (int)mat[16 + slot];
  if (!((p.slots >> slot) & 1) || tid < 0) return fill;
  *valid = true;
  int set1 = (int)mat[22 + slot] == 1 ? 1 : 0;
  const float* tf = mat + 28 + 6 * slot;
  V2 uv = fp.uv[set1];
  float u = fmaf_rn(tf[0], uv.x, tf[1] * uv.y) + tf[2];
  float v = fmaf_rn(tf[3], uv.x, tf[4] * uv.y) + tf[5];
  float r0 = sqrtf(fmaf_rn(tf[0], tf[0], tf[1] * tf[1]));
  float r1 = sqrtf(fmaf_rn(tf[3], tf[3], tf[4] * tf[4]));
  float tscale = cmin(maxn(r0, r1), 1e-6f);
  float tex_size = A.size0[min(tid, A.n_textures - 1)];
  float texel_cone = fp.footprint * (fp.upw[set1] * tscale) * tex_size;
  float g = fp.ig[set1] * tscale;
  float texel = (p.depth == 0 && g > 0.0f) ? g * tex_size : texel_cone;
  float lod = clampf(log2f(cmin(texel, 1e-7f)), 0.0f, p.max_lod);
  return sample_texture(A, tid, u, v, lod);
}

// The instanced meshes of the scene: each lane's family (NULL: no
// instanced meshes), the instance table and the groups' object-space
// shade_packed rows, and the soup's triangle count
struct Inst {
  const int* kind;
  const float* table;
  const float* shade;
  int n_soup;
};

// The texture stage of one lane: fills out, its 15 planes, which stay
// the identity (zero, tpbr 0) unless the lane is alive and hit a PBR
// material; commits the BLEND draw to the state
__device__ __forceinline__ void texture_lane(
    int i, const TexParams& p, const float* hit_t, const int* hit_tri,
    const float* hit_u, const float* hit_v, const float* mat_table,
    int m_count, long long* state, const float* ray_o, const float* ray_d,
    const bool* alive, const float* cone_w, const float* cone_s,
    const TriAttrs& tris, const Atlas& A, const Inst& I, float* out) {
  const float* const* attrs = tris.p;
  if (!alive[i]) return;
  int tri = hit_tri[i];
  if (tri < 0) return;
  int k = I.kind == nullptr ? -1 : I.kind[i] - KIND_INSTANCE;
  // the material first: a non-PBR hit reads no more of its row
  const float* shade_packed = attrs[0];
  int mid;
  float4 tail;
  if (k >= 0) {
    mid = __float_as_int(__ldg(I.table + 32LL * k + 21));
    tri = min(tri, I.n_soup - 1);   // the soup triangle's attributes
    tail = tri_row_tail(shade_packed, tri);
  } else {
    tail = tri_row_tail(shade_packed, tri);
    mid = (int)tail.z;
  }
  mid = min(max(mid, 0), m_count - 1);
  const float* mat = mat_table + (long long)TEX_MAT_COLS * mid;
  if ((int)mat[0] != MAT_PBR) return;
  TriRow row = load_tri_row(shade_packed, tri, tail);
  float t = hit_t[i], bu = hit_u[i], bv = hit_v[i];
  V3 d = load3(ray_d, i);
  Hit h = k >= 0 ? rebuild_instanced(I.table, I.shade, k, hit_tri[i],
                                     load3(ray_o, i), d, t, bu, bv)
                 : rebuild_hit_row(row, load3(ray_o, i), d, t, bu, bv);

  // ---- corners, barycentric weights, footprint ----------------------
  V3 v0 = row_v0(row), v1 = row_v1(row), v2 = row_v2(row);
  float w0 = cmin((1.0f - bu) - bv, 0.0f), w1 = cmin(bu, 0.0f),
        w2 = cmin(bv, 0.0f);
  float w_sum = (w0 + w1) + w2;
  bool has_w = w_sum > 1e-8f;
  w0 = has_w ? w0 / w_sum : 1.0f;
  w1 = has_w ? w1 / w_sum : 0.0f;
  w2 = has_w ? w2 / w_sum : 0.0f;
  V3 sn = h.shading_rec;
  V3 wo = -normalize3(d);
  float cos_view = fabsf(dot3(normalize3(sn), normalize3(wo)));
  float hit_world = cmin(t, 0.0f) * sqrtf(cmin(dot3(d, d), 1e-12f));
  float cone = cmin(fmaf_rn(cone_s[i], hit_world, cone_w[i]), 1e-7f);
  Footprint fp;
  fp.footprint = cone / cmin(cos_view, 1e-3f);
  V3 ddx = v3(p.hor.x / (float)p.width, p.hor.y / (float)p.width,
              p.hor.z / (float)p.width);
  V3 nv = -p.ver;
  V3 ddy = v3(nv.x / (float)p.height, nv.y / (float)p.height,
              nv.z / (float)p.height);
  for (int set = 0; set < 2; ++set) {
    if (set == 1 && !p.uv1) {
      fp.uv[1] = fp.uv[0];
      fp.upw[1] = fp.upw[0];
      fp.ig[1] = fp.ig[0];
      break;
    }
    V2 a0 = load2(attrs[1 + 3 * set], tri);
    V2 a1 = load2(attrs[2 + 3 * set], tri);
    V2 a2 = load2(attrs[3 + 3 * set], tri);
    fp.uv[set].x = interp1(w0, w1, w2, a0.x, a1.x, a2.x);
    fp.uv[set].y = interp1(w0, w1, w2, a0.y, a1.y, a2.y);
    fp.upw[set] = uv_per_world(v0, v1, v2, a0, a1, a2);
    fp.ig[set] = p.depth == 0 ? igehy_gradient(v0, v1, v2, a0, a1, a2,
                                                h.n_faced, d, t, ddx, ddy)
                              : 0.0f;
  }

  // ---- base colour -------------------------------------------------------
  F4 white = f4(1.0f, 1.0f, 1.0f, 1.0f);
  bool valid;
  V3 base_factor = working(clamp3(v3(mat[1], mat[2], mat[3]), 0.0f, 1.0f),
                           p.working_space);
  F4 base = slot_sample(p, A, mat, fp, 0, white, &valid);
  V3 base_color =
      base_factor * working(v3(base.x, base.y, base.z), p.working_space);

  // ---- ORM ---------------------------------------------------------------
  float metallic = clampf(mat[5], 0.0f, 1.0f);
  float roughness = clampf(mat[4], 0.0f, 1.0f);
  bool disable_orm = ((int)mat[15] & 1) == 1;
  F4 orm = slot_sample(p, A, mat, fp, 1, white, &valid);
  if (valid && !disable_orm && !p.disable_orm) {
    metallic = clampf(orm.z * metallic, 0.0f, 1.0f);
    roughness = clampf(orm.y * roughness, 0.0f, 1.0f);
  }

  // ---- transmission --------------------------------------------------
  float transmission = clampf(mat[6], 0.0f, 1.0f);
  F4 tr = slot_sample(p, A, mat, fp, 5, white, &valid);
  if (valid) transmission = clampf(transmission * tr.x, 0.0f, 1.0f);
  transmission = transmission * (1.0f - metallic);

  // ---- alpha modes: one draw, kept on BLEND lanes -------------------
  float alpha = clampf(mat[7], 0.0f, 1.0f) * clampf(base.w, 0.0f, 1.0f);
  float alpha_mode = mat[8];
  uint32_t s0 = (uint32_t)state[i], s_b = s0;
  float xi = rand_uniform(&s_b);
  if (alpha_mode > 1.5f) state[i] = (long long)s_b;
  bool passthrough = alpha_mode > 1.5f
                         ? xi > alpha
                         : (alpha_mode > 0.5f &&
                            alpha < clampf(mat[9], 0.0f, 1.0f));

  // ---- occlusion -------------------------------------------------------
  F4 occ = slot_sample(p, A, mat, fp, 3, white, &valid);
  float occlusion = (valid && !disable_orm)
                        ? fmaf_rn(occ.x - 1.0f, clampf(mat[10], 0.0f, 1.0f),
                                  1.0f)
                        : 1.0f;
  float diffuse_occ = p.disable_ao ? 1.0f : occlusion;
  if (p.ao_indirect_only && p.depth == 0) diffuse_occ = 1.0f;

  // ---- emissive --------------------------------------------------------
  V3 base_em = working(v3(mat[12], mat[13], mat[14]), p.working_space);
  F4 em = slot_sample(p, A, mat, fp, 4, white, &valid);
  V3 emissive =
      base_em * (valid ? working(v3(em.x, em.y, em.z), p.working_space)
                       : v3(1.0f, 1.0f, 1.0f));

  // ---- normal map --------------------------------------------------------
  float normal_scale = mat[11] * p.normal_strength;
  F4 nm = slot_sample(p, A, mat, fp, 2, f4(0.5f, 0.5f, 1.0f, 1.0f), &valid);
  bool use_nm = valid && normal_scale > 1e-4f && !p.disable_nm;
  V3 n_ts = v3(fmaf_rn(nm.x, 2.0f, -1.0f), fmaf_rn(nm.y, 2.0f, -1.0f),
               fmaf_rn(nm.z, 2.0f, -1.0f));
  if (p.flip_green) n_ts.y = -n_ts.y;
  n_ts.x = n_ts.x * normal_scale;
  n_ts.y = n_ts.y * normal_scale;
  float normal_length = sqrtf(cmin(dot3(n_ts, n_ts), 1e-12f));
  float xy2 = fmaf_rn(n_ts.x, n_ts.x, n_ts.y * n_ts.y);
  n_ts = safe_normalize3(v3(n_ts.x, n_ts.y, sqrtf(cmin(1.0f - xy2, 0.0f))));
  V3 new_normal = sn;
  if (use_nm) {
    // each corner's tangent as one 16-byte load
    float4 c0 = __ldg(reinterpret_cast<const float4*>(attrs[7]) + tri);
    float4 c1 = __ldg(reinterpret_cast<const float4*>(attrs[8]) + tri);
    float4 c2 = __ldg(reinterpret_cast<const float4*>(attrs[9]) + tri);
    float tg[4] = {interp1(w0, w1, w2, c0.x, c1.x, c2.x),
                   interp1(w0, w1, w2, c0.y, c1.y, c2.y),
                   interp1(w0, w1, w2, c0.z, c1.z, c2.z),
                   interp1(w0, w1, w2, c0.w, c1.w, c2.w)};
    V3 t_raw = v3(tg[0], tg[1], tg[2]);
    bool trust = fabsf(tg[3]) > 0.5f && finite3(t_raw) &&
                 dot3(t_raw, t_raw) > 1e-6f;
    float st = dot3(sn, t_raw);
    V3 t_gs = v3(fmaf_rn(-sn.x, st, t_raw.x), fmaf_rn(-sn.y, st, t_raw.y),
                 fmaf_rn(-sn.z, st, t_raw.z));
    bool t_ok = trust && dot3(t_gs, t_gs) > 1e-6f;
    t_gs = safe_normalize3(t_gs);
    float sign = tg[3] < 0.0f ? -1.0f : 1.0f;
    V3 b_gs = safe_normalize3(cross3(sn, t_gs)) * sign;
    V3 t_onb, b_onb;
    build_onb(sn, &t_onb, &b_onb);
    V3 tb = t_ok ? t_gs : t_onb, bb = t_ok ? b_gs : b_onb;
    float nx = n_ts.x, ny = n_ts.y, nz = n_ts.z;
    V3 mapped = normalize3(v3(interp1(nx, ny, nz, tb.x, bb.x, sn.x),
                              interp1(nx, ny, nz, tb.y, bb.y, sn.y),
                              interp1(nx, ny, nz, tb.z, bb.z, sn.z)));
    new_normal = dot3(mapped, h.n_faced) < 0.0f ? -mapped : mapped;
    float tok =
        cmin((1.0f - normal_length) / cmin(normal_length, 1e-6f), 0.0f);
    roughness = clampf(sqrtf(fmaf_rn(roughness, roughness, tok)), 0.0f, 1.0f);
  }

  // ---- the planes (kernels/texture.py TEX order) ----------------------
  out[0] = base_color.x;
  out[1] = base_color.y;
  out[2] = base_color.z;
  out[3] = roughness;
  out[4] = metallic;
  out[5] = emissive.x;
  out[6] = emissive.y;
  out[7] = emissive.z;
  out[8] = diffuse_occ;
  out[9] = passthrough ? 1.0f : 0.0f;
  out[10] = new_normal.x;
  out[11] = new_normal.y;
  out[12] = new_normal.z;
  out[13] = transmission;
  out[14] = 1.0f;
}

// The planes are plane-major, (15, n): each lane keeps its 15 values in
// registers and stores each plane once at the end, so a warp's store
// covers 32 consecutive floats of one plane (a lane-major (n, 15) record
// put each of a warp's stores in 32 different sectors, and an eligible
// lane stored every value twice: a zero first, then the value).
__global__ void texture_stage_kernel(
    int n, TexParams p, const float* __restrict__ hit_t,
    const int* __restrict__ hit_tri, const float* __restrict__ hit_u,
    const float* __restrict__ hit_v, const float* __restrict__ mat_table,
    int m_count, long long* __restrict__ state,
    const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    const bool* __restrict__ alive, const float* __restrict__ cone_w,
    const float* __restrict__ cone_s, TriAttrs tris, Atlas A, Inst I,
    float* __restrict__ planes) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float out[N_TEX];
#pragma unroll
  for (int k = 0; k < N_TEX; ++k) out[k] = 0.0f;
  texture_lane(i, p, hit_t, hit_tri, hit_u, hit_v, mat_table, m_count, state,
               ray_o, ray_d, alive, cone_w, cone_s, tris, A, I, out);
#pragma unroll
  for (int k = 0; k < N_TEX; ++k) planes[(long long)k * n + i] = out[k];
}

const int kBlock = 128;

}  // namespace

extern "C" int mpt_texture_stage(int n, const float* s, const void* t,
                                 const void* tri, const void* u,
                                 const void* v, const void* mat_table,
                                 int m_count, void* const* carry,
                                 void* const* attrs, void* const* atlas,
                                 int n_textures, int max_levels,
                                 void* const* inst, int n_soup,
                                 void* planes, void* stream) {
  if (n <= 0) return 0;
  TexParams p;
  p.depth = (int)s[0];
  p.width = (int)s[1];
  p.height = (int)s[2];
  p.hor = v3(s[3], s[4], s[5]);
  p.ver = v3(s[6], s[7], s[8]);
  p.working_space = (int)s[9];
  p.slots = (int)s[10];
  p.uv1 = s[11] > 0.5f;
  p.disable_ao = s[12] > 0.5f;
  p.ao_indirect_only = s[13] > 0.5f;
  p.disable_nm = s[14] > 0.5f;
  p.disable_orm = s[15] > 0.5f;
  p.flip_green = s[16] > 0.5f;
  p.normal_strength = s[17];
  p.max_lod = s[18];
  Atlas A;
  A.texels = (const float*)atlas[0];
  A.level_offset = (const int*)atlas[1];
  A.level_w = (const int*)atlas[2];
  A.level_h = (const int*)atlas[3];
  A.n_levels = (const int*)atlas[4];
  A.size0 = (const float*)atlas[5];
  A.wrap = (const int*)atlas[6];
  A.n_textures = n_textures;
  A.max_levels = max_levels;
  TriAttrs tris;
  for (int k = 0; k < 10; ++k) tris.p[k] = (const float*)attrs[k];
  Inst I;
  I.kind = (const int*)inst[0];
  I.table = (const float*)inst[1];
  I.shade = (const float*)inst[2];
  I.n_soup = n_soup;
  texture_stage_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                         (cudaStream_t)stream>>>(
      n, p, (const float*)t, (const int*)tri, (const float*)u,
      (const float*)v, (const float*)mat_table, m_count,
      (long long*)carry[0], (const float*)carry[1], (const float*)carry[2],
      (const bool*)carry[3], (const float*)carry[4], (const float*)carry[5],
      tris, A, I, (float*)planes);
  return (int)cudaGetLastError();
}
