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
// of MetalShaderTypes.h) is copied into shared memory, 8 KB for 512
// spheres, and every thread of K3a and K3c walks it in the same order, so
// each read is a shared-memory broadcast. A lane whose window is empty
// (t_max < t_min: a dead lane) writes a miss without a test. K3a and K3c
// stage one packed record a primitive (SpheresSoA.records, 16 B;
// RectsSoA.records, 64 B), one 16-byte load a staging thread, and each
// thread reads its window before the staging barrier, so the two trips to
// memory overlap; K3a on a narrow wavefront (the random walk's) reads the
// whole ray then too.
//
// K3b visits the groups near first and shrinks its window as it goes. It
// slab-tests every group box once against the ray's initial window
// [t_min, t_max] (the per-ray form of the TPU kernel's per-packet cull),
// keeping the entry distance tnear of each box that passed in shared
// memory; then it repeatedly takes the pending group of least tnear
// (lowest group on a tie), tests its 16 spheres, and drops every group
// whose tnear now exceeds the window [t_min, w], w the best t so far
// (t_max before the first hit). For a box that passed the first test,
// "tnear <= w" is exactly the slab test against [t_min, w]. The boxes are
// widened on the host (primitives.py sphere_groups) so that a sphere whose
// computed root lies in [t_min, w] lies inside its group's box along the
// ray: the slab test against [t_min, w] passes for every w >= that root,
// so the cull drops no sphere that could win or tie. A candidate is taken
// when (t, slot) is lexicographically below the best (slot = g * 16 + j,
// the group-major position), which is the plain version's rule (groups in
// Morton order, strictly nearer across groups, the first of smallest t in
// a group), whatever the visit order: K3b returns its plain version's bits,
// and K3a's answer except where two spheres give the same float t. The
// square root and the two divisions of a sphere test run only where its
// discriminant is >= 0 (sphere_root discards them otherwise). A listing
// pass (chunked_list_kernel) lists the live lanes, in order, and writes
// the dead lanes' misses; K3b then runs as persistent blocks that stage
// the spheres, slot ids and boxes into shared memory once per block and
// take listed rays in a grid-stride loop, so warps hold live rays only,
// and a block past the list's end stages nothing (late depths of a few
// hundred rays cost a launch, not 1,000 blocks' staging).
//
// What bounds them on an H100: operations, for a scene of many spheres.
// A ray reads 28 B (origin, direction, t_max) and writes 8 B, while K3a
// spends ~25 flops and one sqrt and two divisions per sphere; at 485
// spheres that is ~12,000 flops per ray against 36 B. K3b cuts the sphere
// tests to the groups that can still hold the nearest hit. Its warps run
// as many group rounds as their busiest lane; on a wavefront of a few
// rays (rtow's late depths) one ray's chain of group visits sets the time.
// K3a on a few spheres and K3c on a few rectangles move 36 B a lane: a
// wavefront of 262,144 lanes is 9.4 MB, 0.0028 ms at the bound, and runs
// as one wave whose time is a chain (launch, window and record loads,
// barrier, ray loads, tests, stores); the launch alone, with every lane
// dead, takes 0.003-0.0045 ms. Per-thread uniform record loads in place of
// the staging (54 registers: two waves), two rays a thread, 256-thread
// blocks and a bound to 32 registers (spills) each measured slower.
#include "common.cuh"

#define INFINITY_T 1.0e20f
#define MAX_SPHERES 512
#define MAX_GROUPS 32
#define GROUP 16
#define MAX_RECTS 128
#define K3_BLOCK 128
#define K3B_BLOCK 128
#define LIST_BLOCK 1024

namespace {

// primitives.sphere_roots for one sphere: the candidate t (near root if
// inside the window, else far) and whether it is valid. CULL (K3b) skips
// the square root and the divisions where the discriminant is not >= 0:
// the sphere is then invalid whatever they give, so the bits are the same.
template <bool CULL = false>
__device__ __forceinline__ bool sphere_root(V3 o, V3 d, float a, float4 s,
                                            float t_min, float t_max,
                                            float* t_out) {
  V3 oc = v3(o.x - s.x, o.y - s.y, o.z - s.z);
  float half_b = dot3(oc, d);
  float c = dot3(oc, oc) - s.w * s.w;
  float disc = fmaf_rn(half_b, half_b, -(a * c));
  if (CULL && !(disc >= 0.0f)) return false;
  float sqrt_d = sqrtf(cmin(disc, 0.0f));
  float t_near = (-half_b - sqrt_d) / a;
  float t_far = (-half_b + sqrt_d) / a;
  bool near_ok = t_near >= t_min && t_near <= t_max;
  bool far_ok = t_far >= t_min && t_far <= t_max;
  *t_out = near_ok ? t_near : t_far;
  return disc >= 0.0f && (near_ok || far_ok);
}

// K3a: a thread per lane. The lane's window is read before the block stages
// the sphere records (one 16-byte load a thread, SpheresSoA.records), so the
// two loads are in flight together. NARROW (a wavefront of at most one block
// an SM, the random walk's): the ray is read then too, dead lanes' included,
// since such a launch waits on each trip to memory in turn; a wide one is
// bound by bytes and reads the ray only where the lane is live.
template <bool NARROW>
__global__ void __launch_bounds__(K3_BLOCK) sphere_nearest_kernel(
    int n, const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    float t_min, const float* __restrict__ t_max,
    const float4* __restrict__ rec, int count, float* __restrict__ out_t,
    int* __restrict__ out_i) {
  __shared__ float4 sph[MAX_SPHERES];
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  float tmax = i < n ? t_max[i] : 0.0f;
  V3 o = v3(0.0f, 0.0f, 0.0f), d = o;
  if (NARROW && i < n) {
    o = load3(ray_o, i);
    d = load3(ray_d, i);
  }
  for (int k = threadIdx.x; k < count; k += blockDim.x) sph[k] = rec[k];
  __syncthreads();
  if (i >= n) return;
  if (!(tmax >= t_min)) {  // an empty window (a dead lane): no hit
    out_t[i] = INFINITY_T;
    out_i[i] = -1;
    return;
  }
  if (!NARROW) {
    o = load3(ray_o, i);
    d = load3(ray_d, i);
  }
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

// K3b's live-lane list: lanes with t_max >= t_min (NaN and empty windows
// are dead) at list[0..counters[0]) in warp order, one atomic per block
// (common.cuh list_append); a dead lane gets its miss here
__global__ void __launch_bounds__(LIST_BLOCK) chunked_list_kernel(
    int n, const float* __restrict__ t_max, float t_min,
    int* __restrict__ counters, int* __restrict__ list,
    float* __restrict__ out_t, int* __restrict__ out_i) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool live = i < n && t_max[i] >= t_min;
  list_append<LIST_BLOCK>(live, i, counters, list);
  if (!live && i < n) {
    out_t[i] = INFINITY_T;
    out_i[i] = -1;
  }
}

__global__ void __launch_bounds__(K3B_BLOCK) sphere_nearest_chunked_kernel(
    const int* __restrict__ list, const int* __restrict__ counters,
    const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    float t_min, const float* __restrict__ t_max,
    const float* __restrict__ center, const float* __restrict__ radius,
    const int* __restrict__ index, const float* __restrict__ box_min,
    const float* __restrict__ box_max, int n_groups,
    float* __restrict__ out_t, int* __restrict__ out_i) {
  __shared__ float4 sph[MAX_SPHERES];
  __shared__ int sid[MAX_SPHERES];
  __shared__ float box[MAX_GROUPS * 6];
  // each thread's box entry distances, one row per group (conflict-free)
  __shared__ float entry[MAX_GROUPS][K3B_BLOCK];
  const int n_live = counters[0];
  if (blockIdx.x * K3B_BLOCK >= n_live) return;  // stages nothing
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
  float* my_entry = &entry[0][threadIdx.x];
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < n_live;
       k += gridDim.x * blockDim.x) {
    int i = list[k];
    float tmax = t_max[i];
    V3 o = load3(ray_o, i), d = load3(ray_d, i);
    float a = dot3(d, d);
    // primitives.slab_inverse
    float dd[3] = {d.x, d.y, d.z}, oo[3] = {o.x, o.y, o.z}, inv[3];
    for (int c = 0; c < 3; ++c) {
      float x = fabsf(dd[c]) < 1e-20f ? (dd[c] >= 0.0f ? 1e-20f : -1e-20f)
                                      : dd[c];
      inv[c] = 1.0f / x;
    }
    // primitives.group_entry against the initial window, every group once
    unsigned pending = 0u;
    for (int g = 0; g < n_groups; ++g) {
      float lo[3], hi[3];
      for (int c = 0; c < 3; ++c) {
        float t0 = (box[6 * g + 2 * c] - oo[c]) * inv[c];
        float t1 = (box[6 * g + 2 * c + 1] - oo[c]) * inv[c];
        lo[c] = minn(t0, t1);
        hi[c] = maxn(t0, t1);
      }
      float tnear = maxn(maxn(lo[0], lo[1]), cmin(lo[2], t_min));
      float tfar = minn(minn(hi[0], hi[1]), minn(hi[2], tmax));
      if (tfar >= tnear) {
        pending |= 1u << g;
        my_entry[g * K3B_BLOCK] = tnear;
      }
    }
    float best_t = INFINITY_T, w = tmax;
    int best_s = -1;
    while (pending != 0u) {
      // the pending group of least entry, dropping those past the window
      int gsel = -1;
      float esel = 0.0f;
      for (unsigned m = pending; m != 0u; m &= m - 1u) {
        int g = __ffs(m) - 1;
        float e = my_entry[g * K3B_BLOCK];
        if (e > w) {
          pending &= ~(1u << g);
        } else if (gsel < 0 || e < esel) {
          gsel = g;
          esel = e;
        }
      }
      if (gsel < 0) break;
      pending &= ~(1u << gsel);
      for (int j = 0; j < GROUP; ++j) {
        int s = gsel * GROUP + j;
        float t;
        if (sphere_root<true>(o, d, a, sph[s], t_min, tmax, &t) &&
            (best_s < 0 || t < best_t || (t == best_t && s < best_s))) {
          best_t = t;
          best_s = s;
        }
      }
      if (best_s >= 0) w = best_t;
    }
    out_t[i] = best_s < 0 ? INFINITY_T : best_t;
    out_i[i] = best_s < 0 ? -1 : sid[best_s];
  }
}

// one rectangle of a K3c record (RectsSoA.records: corner, edge_u, edge_v,
// 1/|u|^2, 1/|v|^2, normal, plane, a pad) against a ray, each value read
// where it is used: rect_nearest_reference's operations in its order
__device__ __forceinline__ bool rect_root(V3 o, V3 d, float t_min,
                                          float t_max, const float* r,
                                          float* t_out) {
  V3 nrm = v3(r[11], r[12], r[13]);
  float denom = dot3(d, nrm);
  float t = (r[14] - dot3(o, nrm)) / denom;
  V3 rel = v3(fmaf_rn(t, d.x, o.x) - r[0], fmaf_rn(t, d.y, o.y) - r[1],
              fmaf_rn(t, d.z, o.z) - r[2]);
  float u = dot3(rel, v3(r[3], r[4], r[5])) * r[9];
  float v = dot3(rel, v3(r[6], r[7], r[8])) * r[10];
  *t_out = t;
  return fabsf(denom) >= 1e-6f && t >= t_min && t <= t_max && u >= 0.0f &&
         u <= 1.0f && v >= 0.0f && v <= 1.0f;
}

// K3c: K3a's wide scheme over the rectangle records (four 16-byte loads
// each, one a staging thread)
__global__ void __launch_bounds__(K3_BLOCK) rect_nearest_kernel(
    int n, const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    float t_min, const float* __restrict__ t_max,
    const float4* __restrict__ rec, int count, float* __restrict__ out_t,
    int* __restrict__ out_i) {
  __shared__ float4 rect[MAX_RECTS * 4];
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  float tmax = i < n ? t_max[i] : 0.0f;
  for (int k = threadIdx.x; k < 4 * count; k += blockDim.x) rect[k] = rec[k];
  __syncthreads();
  if (i >= n) return;
  if (!(tmax >= t_min)) {  // an empty window (a dead lane): no hit
    out_t[i] = INFINITY_T;
    out_i[i] = -1;
    return;
  }
  V3 o = load3(ray_o, i), d = load3(ray_d, i);
  const float* rf = reinterpret_cast<const float*>(rect);
  float best_t = INFINITY_T;
  int best_i = -1;
  for (int s = 0; s < count; ++s) {
    float t;
    if (rect_root(o, d, t_min, tmax, rf + 16 * s, &t) &&
        (best_i < 0 || t < best_t)) {
      best_t = t;
      best_i = s;
    }
  }
  out_t[i] = best_i < 0 ? INFINITY_T : best_t;
  out_i[i] = best_i;
}

int k3b_grid_cache;
int k3a_sm_cache;

// the card's SM count, found once
int sm_count(int* cache) {
  if (*cache == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(cache, cudaDevAttrMultiProcessorCount, dev);
  }
  return *cache;
}

}  // namespace

// `records`: SpheresSoA.records(), (count, 4) float32, 16-byte aligned
extern "C" int mpt_sphere_nearest(int n, const void* o, const void* d,
                                  float t_min, const void* t_max,
                                  const void* records, int count, void* out_t,
                                  void* out_i, void* stream) {
  if (n <= 0) return 0;
  if (count > MAX_SPHERES) return (int)cudaErrorInvalidValue;
  int blocks = (n + K3_BLOCK - 1) / K3_BLOCK;
  auto kernel = blocks <= sm_count(&k3a_sm_cache)
                    ? sphere_nearest_kernel<true>
                    : sphere_nearest_kernel<false>;
  kernel<<<blocks, K3_BLOCK, 0, (cudaStream_t)stream>>>(
      n, (const float*)o, (const float*)d, t_min, (const float*)t_max,
      (const float4*)records, count, (float*)out_t, (int*)out_i);
  return (int)cudaGetLastError();
}

// `scratch`: n + 2 int32 (the live-lane list's count and unused fetch
// position, then the list)
extern "C" int mpt_sphere_nearest_chunked(
    int n, const void* o, const void* d, float t_min, const void* t_max,
    const void* center, const void* radius, const void* index,
    const void* box_min, const void* box_max, int n_groups, void* out_t,
    void* out_i, void* scratch, void* stream) {
  if (n <= 0) return 0;
  if (n_groups > MAX_GROUPS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int* sc = (int*)scratch;
  cudaError_t err = cudaMemsetAsync(sc, 0, 2 * sizeof(int), st);
  if (err != cudaSuccess) {
    cudaGetLastError();  // reported here, not by the next launch
    return (int)err;
  }
  chunked_list_kernel<<<(n + LIST_BLOCK - 1) / LIST_BLOCK, LIST_BLOCK, 0,
                        st>>>(n, (const float*)t_max, t_min, sc, sc + 2,
                              (float*)out_t, (int*)out_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int blocks = persistent_grid(sphere_nearest_chunked_kernel, K3B_BLOCK,
                               &k3b_grid_cache, n);
  sphere_nearest_chunked_kernel<<<blocks, K3B_BLOCK, 0, st>>>(
      sc + 2, sc, (const float*)o, (const float*)d, t_min,
      (const float*)t_max, (const float*)center, (const float*)radius,
      (const int*)index, (const float*)box_min, (const float*)box_max,
      n_groups, (float*)out_t, (int*)out_i);
  return (int)cudaGetLastError();
}

// `records`: RectsSoA.records(), (count, 16) float32, 16-byte aligned
extern "C" int mpt_rect_nearest(int n, const void* o, const void* d,
                                float t_min, const void* t_max,
                                const void* records, int count, void* out_t,
                                void* out_i, void* stream) {
  if (n <= 0) return 0;
  if (count > MAX_RECTS) return (int)cudaErrorInvalidValue;
  rect_nearest_kernel<<<(n + K3_BLOCK - 1) / K3_BLOCK, K3_BLOCK, 0,
                        (cudaStream_t)stream>>>(
      n, (const float*)o, (const float*)d, t_min, (const float*)t_max,
      (const float4*)records, count, (float*)out_t, (int*)out_i);
  return (int)cudaGetLastError();
}
