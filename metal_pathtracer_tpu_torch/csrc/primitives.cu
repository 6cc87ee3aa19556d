// K3: nearest analytic sphere and rectangle per ray.
//
// Replaces the TPU analytic-primitive kernels of ops/pallas/primitives.py:
//   sphere_nearest_kernel          K3a, _sphere_kernel:37 (every sphere);
//   sphere_nearest_chunked_kernel  K3b, _sphere_kernel_chunked:183 (Morton
//                                  groups of 16 behind one AABB each);
//   rect_nearest_kernel            K3c, _rect_kernel:314.
// Each writes, per ray, the t and index of the first primitive of smallest
// t in [t_min, t_max] (index -1 and t = 1e20 on a miss), computed exactly
// as its plain version in ops/kernels/primitives.py: the same operations
// in the same order, FMAs (__fmaf_rn) only where the plain version places
// them (the build passes --fmad=false), IEEE division and sqrtf. So a
// kernel and its plain version agree to the bit.
//
// Design. One thread per ray, as the TPU kernel is one vector lane per ray;
// the primitive set (at most 512 spheres or 128 rectangles, the scene caps
// of MetalShaderTypes.h) is copied once per block into shared memory, 8 KB
// for 512 spheres, and every thread walks it in the same order, so each
// read is a shared-memory broadcast. K3b tests a group's 16 spheres only
// when the ray's initial window [t_min, t_max] meets the group's box: the
// per-ray form of the TPU kernel's per-packet slab cull. The boxes are
// widened on the host (primitives.py sphere_groups) so that rounding in
// the quadratic or the slab test cannot drop a hit: K3b then equals K3a
// except where two spheres give the same float t. A lane whose window is
// empty (t_max < t_min: a dead lane) writes a miss without a test.
//
// What bounds them on an H100: operations, for a scene of many spheres.
// A ray reads 28 B (origin, direction, t_max) and writes 8 B, while K3a
// spends ~25 flops and one sqrt and two divisions per sphere; at 485
// spheres that is ~12,000 flops per ray against 36 B. K3b cuts the sphere
// tests to the groups whose box the ray's window reaches.
#include "common.cuh"

#define INFINITY_T 1.0e20f
#define MAX_SPHERES 512
#define MAX_GROUPS 32
#define GROUP 16
#define MAX_RECTS 128
#define RECT_FLOATS 16

namespace {

// primitives.sphere_roots for one sphere: the candidate t (near root if
// inside the window, else far) and whether it is valid
__device__ __forceinline__ bool sphere_root(V3 o, V3 d, float a, float4 s,
                                            float t_min, float t_max,
                                            float* t_out) {
  V3 oc = v3(o.x - s.x, o.y - s.y, o.z - s.z);
  float half_b = dot3(oc, d);
  float c = dot3(oc, oc) - s.w * s.w;
  float disc = fmaf_rn(half_b, half_b, -(a * c));
  float sqrt_d = sqrtf(cmin(disc, 0.0f));
  float t_near = (-half_b - sqrt_d) / a;
  float t_far = (-half_b + sqrt_d) / a;
  bool near_ok = t_near >= t_min && t_near <= t_max;
  bool far_ok = t_far >= t_min && t_far <= t_max;
  *t_out = near_ok ? t_near : t_far;
  return disc >= 0.0f && (near_ok || far_ok);
}

__global__ void sphere_nearest_kernel(int n, const float* __restrict__ ray_o,
                                      const float* __restrict__ ray_d,
                                      float t_min,
                                      const float* __restrict__ t_max,
                                      const float* __restrict__ center,
                                      const float* __restrict__ radius,
                                      int count, float* __restrict__ out_t,
                                      int* __restrict__ out_i) {
  __shared__ float4 sph[MAX_SPHERES];
  for (int k = threadIdx.x; k < count; k += blockDim.x)
    sph[k] = make_float4(center[3 * k], center[3 * k + 1], center[3 * k + 2],
                         radius[k]);
  __syncthreads();
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float tmax = t_max[i];
  if (!(tmax >= t_min)) {  // an empty window (a dead lane): no hit
    out_t[i] = INFINITY_T;
    out_i[i] = -1;
    return;
  }
  V3 o = load3(ray_o, i), d = load3(ray_d, i);
  float a = dot3(d, d);
  float best_t = INFINITY_T;
  int best_i = -1;
  for (int s = 0; s < count; ++s) {
    float t;
    if (sphere_root(o, d, a, sph[s], t_min, tmax, &t) &&
        (best_i < 0 || t < best_t)) {
      best_t = t;
      best_i = s;
    }
  }
  out_t[i] = best_i < 0 ? INFINITY_T : best_t;
  out_i[i] = best_i;
}

__global__ void sphere_nearest_chunked_kernel(
    int n, const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    float t_min, const float* __restrict__ t_max,
    const float* __restrict__ center, const float* __restrict__ radius,
    const int* __restrict__ index, const float* __restrict__ box_min,
    const float* __restrict__ box_max, int n_groups,
    float* __restrict__ out_t, int* __restrict__ out_i) {
  __shared__ float4 sph[MAX_SPHERES];
  __shared__ int sid[MAX_SPHERES];
  __shared__ float box[MAX_GROUPS * 6];
  for (int k = threadIdx.x; k < n_groups * GROUP; k += blockDim.x) {
    sph[k] = make_float4(center[3 * k], center[3 * k + 1], center[3 * k + 2],
                         radius[k]);
    sid[k] = index[k];
  }
  for (int k = threadIdx.x; k < n_groups * 3; k += blockDim.x) {
    box[2 * k] = box_min[k];
    box[2 * k + 1] = box_max[k];
  }
  __syncthreads();
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float tmax = t_max[i];
  if (!(tmax >= t_min)) {  // an empty window (a dead lane): no hit
    out_t[i] = INFINITY_T;
    out_i[i] = -1;
    return;
  }
  V3 o = load3(ray_o, i), d = load3(ray_d, i);
  float a = dot3(d, d);
  // primitives.slab_inverse
  float dd[3] = {d.x, d.y, d.z}, oo[3] = {o.x, o.y, o.z}, inv[3];
  for (int c = 0; c < 3; ++c) {
    float x = fabsf(dd[c]) < 1e-20f ? (dd[c] >= 0.0f ? 1e-20f : -1e-20f)
                                    : dd[c];
    inv[c] = 1.0f / x;
  }
  float best_t = INFINITY_T;
  int best_i = -1;
  for (int g = 0; g < n_groups; ++g) {
    // primitives.group_passes
    float lo[3], hi[3];
    for (int c = 0; c < 3; ++c) {
      float t0 = (box[6 * g + 2 * c] - oo[c]) * inv[c];
      float t1 = (box[6 * g + 2 * c + 1] - oo[c]) * inv[c];
      lo[c] = minn(t0, t1);
      hi[c] = maxn(t0, t1);
    }
    float tnear = maxn(maxn(lo[0], lo[1]), cmin(lo[2], t_min));
    float tfar = minn(minn(hi[0], hi[1]), minn(hi[2], tmax));
    if (!(tfar >= tnear)) continue;
    for (int j = 0; j < GROUP; ++j) {
      int s = g * GROUP + j;
      float t;
      if (sphere_root(o, d, a, sph[s], t_min, tmax, &t) &&
          (best_i < 0 || t < best_t)) {
        best_t = t;
        best_i = sid[s];
      }
    }
  }
  out_t[i] = best_i < 0 ? INFINITY_T : best_t;
  out_i[i] = best_i;
}

__global__ void rect_nearest_kernel(
    int n, const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    float t_min, const float* __restrict__ t_max,
    const float* __restrict__ corner, const float* __restrict__ edge_u,
    const float* __restrict__ edge_v, const float* __restrict__ inv_len2_u,
    const float* __restrict__ inv_len2_v, const float* __restrict__ normal,
    const float* __restrict__ plane, int count, float* __restrict__ out_t,
    int* __restrict__ out_i) {
  // per rectangle: corner, edge_u, edge_v, 1/|u|^2, 1/|v|^2, normal, plane
  __shared__ float rect[MAX_RECTS * RECT_FLOATS];
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    float* r = rect + RECT_FLOATS * k;
    for (int c = 0; c < 3; ++c) {
      r[c] = corner[3 * k + c];
      r[3 + c] = edge_u[3 * k + c];
      r[6 + c] = edge_v[3 * k + c];
      r[11 + c] = normal[3 * k + c];
    }
    r[9] = inv_len2_u[k];
    r[10] = inv_len2_v[k];
    r[14] = plane[k];
  }
  __syncthreads();
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float tmax = t_max[i];
  if (!(tmax >= t_min)) {  // an empty window (a dead lane): no hit
    out_t[i] = INFINITY_T;
    out_i[i] = -1;
    return;
  }
  V3 o = load3(ray_o, i), d = load3(ray_d, i);
  float best_t = INFINITY_T;
  int best_i = -1;
  for (int s = 0; s < count; ++s) {
    const float* r = rect + RECT_FLOATS * s;
    V3 nrm = v3(r[11], r[12], r[13]);
    float denom = dot3(d, nrm);
    float t = (r[14] - dot3(o, nrm)) / denom;
    V3 rel = v3(fmaf_rn(t, d.x, o.x) - r[0], fmaf_rn(t, d.y, o.y) - r[1],
                fmaf_rn(t, d.z, o.z) - r[2]);
    float u = dot3(rel, v3(r[3], r[4], r[5])) * r[9];
    float v = dot3(rel, v3(r[6], r[7], r[8])) * r[10];
    bool valid = fabsf(denom) >= 1e-6f && t >= t_min && t <= tmax &&
                 u >= 0.0f && u <= 1.0f && v >= 0.0f && v <= 1.0f;
    if (valid && (best_i < 0 || t < best_t)) {
      best_t = t;
      best_i = s;
    }
  }
  out_t[i] = best_i < 0 ? INFINITY_T : best_t;
  out_i[i] = best_i;
}

const int kBlock = 128;

}  // namespace

extern "C" int mpt_sphere_nearest(int n, const void* o, const void* d,
                                  float t_min, const void* t_max,
                                  const void* center, const void* radius,
                                  int count, void* out_t, void* out_i,
                                  void* stream) {
  if (n <= 0) return 0;
  if (count > MAX_SPHERES) return (int)cudaErrorInvalidValue;
  sphere_nearest_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                          (cudaStream_t)stream>>>(
      n, (const float*)o, (const float*)d, t_min, (const float*)t_max,
      (const float*)center, (const float*)radius, count, (float*)out_t,
      (int*)out_i);
  return (int)cudaGetLastError();
}

extern "C" int mpt_sphere_nearest_chunked(
    int n, const void* o, const void* d, float t_min, const void* t_max,
    const void* center, const void* radius, const void* index,
    const void* box_min, const void* box_max, int n_groups, void* out_t,
    void* out_i, void* stream) {
  if (n <= 0) return 0;
  if (n_groups > MAX_GROUPS) return (int)cudaErrorInvalidValue;
  sphere_nearest_chunked_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                                  (cudaStream_t)stream>>>(
      n, (const float*)o, (const float*)d, t_min, (const float*)t_max,
      (const float*)center, (const float*)radius, (const int*)index,
      (const float*)box_min, (const float*)box_max, n_groups, (float*)out_t,
      (int*)out_i);
  return (int)cudaGetLastError();
}

extern "C" int mpt_rect_nearest(int n, const void* o, const void* d,
                                float t_min, const void* t_max,
                                const void* corner, const void* edge_u,
                                const void* edge_v, const void* inv_len2_u,
                                const void* inv_len2_v, const void* normal,
                                const void* plane, int count, void* out_t,
                                void* out_i, void* stream) {
  if (n <= 0) return 0;
  if (count > MAX_RECTS) return (int)cudaErrorInvalidValue;
  rect_nearest_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                        (cudaStream_t)stream>>>(
      n, (const float*)o, (const float*)d, t_min, (const float*)t_max,
      (const float*)corner, (const float*)edge_u, (const float*)edge_v,
      (const float*)inv_len2_u, (const float*)inv_len2_v,
      (const float*)normal, (const float*)plane, count, (float*)out_t,
      (int*)out_i);
  return (int)cudaGetLastError();
}
