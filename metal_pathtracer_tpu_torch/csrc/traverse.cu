// K1: closest-hit and any-hit triangle traces, one thread per ray.
//
// Replaces the TPU packet-traversal kernel ops/pallas/traverse.py
// (_kernel:60 / _packet_body:106, launched by _call:596 from
// packet_trace:659), in closest-hit mode and in its any_hit=True mode
// (traverse.py:280-296: shadow rays). trace_any_kernel makes the same
// exit-link walk with the window fixed at tmax and returns at the first
// triangle that passes the test, so its occlusion flag equals the
// closest-hit walk's hit flag bit for bit: both visit the same nodes until
// the first valid triangle, with the same arithmetic. The TPU kernel walks 1024-ray packets through a
// chunked tree with a shared scalar stack and SMEM-resident nodes,
// because its vector unit only pays off when a whole packet moves
// together. A GPU thread can walk its own ray, so this kernel walks the
// exit-link BVH (scene/meshbuild.py _flatten_with_exit_links) stacklessly
// -- node = hit ? (leaf ? exit : node + 1) : exit -- exactly as the
// reference loop ops/traversal.py trace_triangles:66-171 does, and so
// returns the same bits as its plain version (ops/kernels/traverse.py):
// strict '<' across leaves in depth-first order, the first minimal slot
// within a leaf, the inverse-direction clamp, the 1e-8 determinant test
// and the (mesh, prim) self-hit exclusion.
//
// What bounds it on an H100: latency of dependent global loads. Each step
// reads one node (24 B of bounds plus three ints) whose address depends
// on the previous step, and each leaf gathers up to four triangles
// (36 B each) from a 16-to-70 MB soup; neighbouring threads diverge after
// a few bounces. The design keeps every ray in registers and reads nodes
// and triangles through the read-only cache (__ldg); the exit-link order
// needs no per-thread stack. Near-first child order, a wide BVH and
// sorting rays by direction are left for later work: each changes which
// of two equal-t triangles wins, which needs its own parity argument.
//
// Counting mode (template flag STATS) replaces the TPU kernel's
// return_stats mode (traverse.py packet_trace_unsorted(...,
// return_stats=True):726, totals :792-809). Per ray it counts the slab
// tests (nodes visited), the leaf visits whose box passed (the analogue of
// the packet walk's leaf chunks tested), the interior nodes both of whose
// children's boxes passed (counted at the right child: its left sibling
// passed unless the walk came to it straight from that sibling's failed
// test) and the triangle tests; the counts are summed per block in shared
// memory and added with one atomic per block and counter into an int64
// vector of 4. Counting reads one more int per visited node (its left
// sibling, BvhSoA.left_sibling) and writes 32 bytes per launch; it
// changes no t, tri, u, v or occlusion bit. STATS=false is the kernel
// without any of it.
#include "common.cuh"

#define MAX_LEAF 4
#define INFINITY_T 1.0e20f

namespace {

// Moller-Trumbore (reference: intersect_triangle_parametric) against
// triangle `tid`; the window test is the caller's.
struct TriHit {
  float t, u, v;
  bool ok;  // determinant and barycentric tests passed
};
__device__ __forceinline__ TriHit intersect_tri(
    V3 o, V3 d, int tid, const float* __restrict__ tv0,
    const float* __restrict__ tv1, const float* __restrict__ tv2) {
  V3 v0 = v3(__ldg(tv0 + 3 * tid), __ldg(tv0 + 3 * tid + 1),
             __ldg(tv0 + 3 * tid + 2));
  V3 v1 = v3(__ldg(tv1 + 3 * tid), __ldg(tv1 + 3 * tid + 1),
             __ldg(tv1 + 3 * tid + 2));
  V3 v2 = v3(__ldg(tv2 + 3 * tid), __ldg(tv2 + 3 * tid + 1),
             __ldg(tv2 + 3 * tid + 2));
  V3 edge1 = v1 - v0;
  V3 edge2 = v2 - v0;
  V3 pvec = cross3(d, edge2);
  float det = dot3(edge1, pvec);
  float inv_det = 1.0f / (fabsf(det) < 1e-8f ? 1.0f : det);
  V3 tvec = o - v0;
  TriHit h;
  h.u = dot3(tvec, pvec) * inv_det;
  V3 qvec = cross3(tvec, edge1);
  h.v = dot3(d, qvec) * inv_det;
  h.t = dot3(edge2, qvec) * inv_det;
  h.ok = fabsf(det) >= 1e-8f && h.u >= 0.0f && h.u <= 1.0f && h.v >= 0.0f &&
         h.u + h.v <= 1.0f;
  return h;
}

// The slab test of node `node` against [t_min, min(tfar, t_best)].
__device__ __forceinline__ bool box_hit(const float* __restrict__ bmin,
                                        const float* __restrict__ bmax,
                                        int node, const float* oo,
                                        const float* inv, float t_min,
                                        float t_best) {
  float tnear = 0.0f, tfar = 0.0f;
  for (int a = 0; a < 3; ++a) {
    float t0 = (__ldg(bmin + 3 * node + a) - oo[a]) * inv[a];
    float t1 = (__ldg(bmax + 3 * node + a) - oo[a]) * inv[a];
    float lo = cmin(minn(t0, t1), t_min);
    float hi = maxn(t0, t1);
    tnear = a == 0 ? lo : maxn(tnear, lo);
    tfar = a == 0 ? hi : minn(tfar, hi);
  }
  return minn(tfar, t_best) >= tnear;
}

__device__ __forceinline__ void inverse_dir(V3 d, float* inv) {
  float dd[3] = {d.x, d.y, d.z};
  for (int a = 0; a < 3; ++a) {
    float c = dd[a];
    float safe = fabsf(c) < 1e-20f ? (c >= 0.0f ? 1e-20f : -1e-20f) : c;
    inv[a] = 1.0f / safe;
  }
}

// the four counters of one ray (counting mode)
struct Counts {
  unsigned int nodes, leaves, both, tris;
};

// one slab test of the counting walk: `node` was reached from `prev`
// (whose test gave `prev_hit`); a right child (left sibling >= 0) whose
// box passed counts "both children passed" unless its sibling failed just
// before it
__device__ __forceinline__ void count_node(Counts* c, const int* left_sib,
                                           int node, int prev, bool prev_hit,
                                           bool hit_box, int pcount) {
  c->nodes += 1;
  if (hit_box && pcount > 0) c->leaves += 1;
  int ls = __ldg(left_sib + node);
  if (ls >= 0 && hit_box && !(prev == ls && !prev_hit)) c->both += 1;
}

// the block's sums of the four counters, one atomic per block and counter
// (every thread of the block calls it)
__device__ __forceinline__ void add_counts(const Counts& c,
                                          unsigned long long* out) {
  __shared__ unsigned long long sums[4];
  if (threadIdx.x < 4) sums[threadIdx.x] = 0ull;
  __syncthreads();
  unsigned long long v[4] = {c.nodes, c.leaves, c.both, c.tris};
  for (int k = 0; k < 4; ++k) {
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
    if ((threadIdx.x & 31) == 0) atomicAdd(&sums[k], v[k]);
  }
  __syncthreads();
  if (threadIdx.x < 4) atomicAdd(out + threadIdx.x, sums[threadIdx.x]);
}

template <bool STATS>
__device__ __forceinline__ void closest_lane(
    int i, const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    float t_min, const float* __restrict__ tmax,
    const int* __restrict__ excl_mesh, const int* __restrict__ excl_prim,
    int n_nodes, const float* __restrict__ bmin, const float* __restrict__ bmax,
    const int* __restrict__ prim_offset, const int* __restrict__ prim_count,
    const int* __restrict__ exit_index, const int* __restrict__ prim_indices,
    int n_slots, const float* __restrict__ tv0, const float* __restrict__ tv1,
    const float* __restrict__ tv2, const int* __restrict__ mesh_index,
    float* __restrict__ out_t, int* __restrict__ out_tri,
    float* __restrict__ out_u, float* __restrict__ out_v,
    const int* __restrict__ left_sib, Counts* cnt) {
  float best_t = tmax[i];
  int best_tri = -1;
  float best_u = 0.0f, best_v = 0.0f;
  // an empty window (dead lanes carry tmax = 0) misses the root box
  if (best_t >= t_min) {
    V3 o = load3(ray_o, i);
    V3 d = load3(ray_d, i);
    int ex_mesh = excl_mesh[i];
    int ex_prim = excl_prim[i];
    float inv[3];
    inverse_dir(d, inv);
    float oo[3] = {o.x, o.y, o.z};
    int node = 0;
    int prev = -1;
    bool prev_hit = false;
    while (node < n_nodes) {
      bool hit_box = box_hit(bmin, bmax, node, oo, inv, t_min, best_t);
      int pcount = __ldg(prim_count + node);
      if constexpr (STATS) {
        count_node(cnt, left_sib, node, prev, prev_hit, hit_box, pcount);
        prev = node;
        prev_hit = hit_box;
      }
      if (hit_box && pcount > 0) {
        int poff = __ldg(prim_offset + node);
        float tm[MAX_LEAF], uu[MAX_LEAF], vv[MAX_LEAF];
        int ids[MAX_LEAF];
        bool any_valid = false;
        for (int k = 0; k < MAX_LEAF; ++k) {
          tm[k] = INFINITY_T;
          uu[k] = vv[k] = 0.0f;
          ids[k] = -1;
          if (k >= pcount) continue;
          if constexpr (STATS) cnt->tris += 1;
          int slot = min(max(poff + k, 0), n_slots - 1);
          int tid = __ldg(prim_indices + slot);
          ids[k] = tid;
          TriHit h = intersect_tri(o, d, tid, tv0, tv1, tv2);
          bool excl = __ldg(mesh_index + tid) == ex_mesh && tid == ex_prim;
          if (h.ok && h.t >= t_min && h.t <= best_t && !excl) {
            tm[k] = h.t;
            uu[k] = h.u;
            vv[k] = h.v;
            any_valid = true;
          }
        }
        int kb = 0;  // first minimum, as argmin
        for (int k = 1; k < MAX_LEAF; ++k)
          if (tm[k] < tm[kb]) kb = k;
        if (any_valid && tm[kb] < best_t) {
          best_t = tm[kb];
          best_tri = ids[kb];
          best_u = uu[kb];
          best_v = vv[kb];
        }
      }
      node = (hit_box && pcount == 0) ? node + 1 : __ldg(exit_index + node);
    }
  }
  out_t[i] = best_t;
  out_tri[i] = best_tri;
  out_u[i] = best_u;
  out_v[i] = best_v;
}

template <bool STATS>
__global__ void trace_closest_kernel(
    int n, const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    float t_min, const float* __restrict__ tmax,
    const int* __restrict__ excl_mesh, const int* __restrict__ excl_prim,
    int n_nodes, const float* __restrict__ bmin, const float* __restrict__ bmax,
    const int* __restrict__ prim_offset, const int* __restrict__ prim_count,
    const int* __restrict__ exit_index, const int* __restrict__ prim_indices,
    int n_slots, const float* __restrict__ tv0, const float* __restrict__ tv1,
    const float* __restrict__ tv2, const int* __restrict__ mesh_index,
    float* __restrict__ out_t, int* __restrict__ out_tri,
    float* __restrict__ out_u, float* __restrict__ out_v,
    const int* __restrict__ left_sib, unsigned long long* __restrict__ stats) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  Counts cnt = {0u, 0u, 0u, 0u};
  if (i < n)
    closest_lane<STATS>(i, ray_o, ray_d, t_min, tmax, excl_mesh, excl_prim,
                        n_nodes, bmin, bmax, prim_offset, prim_count,
                        exit_index, prim_indices, n_slots, tv0, tv1, tv2,
                        mesh_index, out_t, out_tri, out_u, out_v, left_sib,
                        &cnt);
  if constexpr (STATS) add_counts(cnt, stats);
}

template <bool STATS>
__device__ __forceinline__ void any_lane(
    int i, const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    float t_min, const float* __restrict__ tmax, int n_nodes,
    const float* __restrict__ bmin, const float* __restrict__ bmax,
    const int* __restrict__ prim_offset, const int* __restrict__ prim_count,
    const int* __restrict__ exit_index, const int* __restrict__ prim_indices,
    int n_slots, const float* __restrict__ tv0, const float* __restrict__ tv1,
    const float* __restrict__ tv2, bool* __restrict__ out_occluded,
    const int* __restrict__ left_sib, Counts* cnt) {
  float t_max = tmax[i];
  bool occluded = false;
  if (t_max >= t_min) {
    V3 o = load3(ray_o, i);
    V3 d = load3(ray_d, i);
    float inv[3];
    inverse_dir(d, inv);
    float oo[3] = {o.x, o.y, o.z};
    int node = 0;
    int prev = -1;
    bool prev_hit = false;
    while (node < n_nodes && !occluded) {
      bool hit_box = box_hit(bmin, bmax, node, oo, inv, t_min, t_max);
      int pcount = __ldg(prim_count + node);
      if constexpr (STATS) {
        count_node(cnt, left_sib, node, prev, prev_hit, hit_box, pcount);
        prev = node;
        prev_hit = hit_box;
      }
      if (hit_box && pcount > 0) {
        int poff = __ldg(prim_offset + node);
        for (int k = 0; k < pcount && k < MAX_LEAF; ++k) {
          if constexpr (STATS) cnt->tris += 1;
          int tid = __ldg(prim_indices + min(max(poff + k, 0), n_slots - 1));
          TriHit h = intersect_tri(o, d, tid, tv0, tv1, tv2);
          // strict '<': the closest-hit walk records a hit only below its
          // running best, which is t_max until the first one
          if (h.ok && h.t >= t_min && h.t < t_max) {
            occluded = true;
            break;
          }
        }
      }
      node = (hit_box && pcount == 0) ? node + 1 : __ldg(exit_index + node);
    }
  }
  out_occluded[i] = occluded;
}

template <bool STATS>
__global__ void trace_any_kernel(
    int n, const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    float t_min, const float* __restrict__ tmax, int n_nodes,
    const float* __restrict__ bmin, const float* __restrict__ bmax,
    const int* __restrict__ prim_offset, const int* __restrict__ prim_count,
    const int* __restrict__ exit_index, const int* __restrict__ prim_indices,
    int n_slots, const float* __restrict__ tv0, const float* __restrict__ tv1,
    const float* __restrict__ tv2, bool* __restrict__ out_occluded,
    const int* __restrict__ left_sib, unsigned long long* __restrict__ stats) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  Counts cnt = {0u, 0u, 0u, 0u};
  if (i < n)
    any_lane<STATS>(i, ray_o, ray_d, t_min, tmax, n_nodes, bmin, bmax,
                    prim_offset, prim_count, exit_index, prim_indices,
                    n_slots, tv0, tv1, tv2, out_occluded, left_sib, &cnt);
  if constexpr (STATS) add_counts(cnt, stats);
}

}  // namespace

// `stats` NULL launches the counter-free kernel; otherwise the counting one
// adds its four totals (nodes, leaves passed, both children passed,
// triangle tests) to the int64 vector `stats`, reading `left_sib`
extern "C" int mpt_trace_any(
    int n, const void* ray_o, const void* ray_d, float t_min,
    const void* tmax, int n_nodes, const void* bmin, const void* bmax,
    const void* prim_offset, const void* prim_count, const void* exit_index,
    const void* prim_indices, int n_slots, const void* v0, const void* v1,
    const void* v2, void* out_occluded, const void* left_sib, void* stats,
    void* stream) {
  if (n <= 0) return 0;
  const int block = 128;
  auto kernel = stats == nullptr ? trace_any_kernel<false>
                                 : trace_any_kernel<true>;
  kernel<<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
      n, (const float*)ray_o, (const float*)ray_d, t_min, (const float*)tmax,
      n_nodes, (const float*)bmin, (const float*)bmax,
      (const int*)prim_offset, (const int*)prim_count,
      (const int*)exit_index, (const int*)prim_indices, n_slots,
      (const float*)v0, (const float*)v1, (const float*)v2,
      (bool*)out_occluded, (const int*)left_sib,
      (unsigned long long*)stats);
  return (int)cudaGetLastError();
}

extern "C" int mpt_trace_closest(
    int n, const void* ray_o, const void* ray_d, float t_min,
    const void* tmax, const void* excl_mesh, const void* excl_prim,
    int n_nodes, const void* bmin, const void* bmax, const void* prim_offset,
    const void* prim_count, const void* exit_index, const void* prim_indices,
    int n_slots, const void* v0, const void* v1, const void* v2,
    const void* mesh_index, void* out_t, void* out_tri, void* out_u,
    void* out_v, const void* left_sib, void* stats, void* stream) {
  if (n <= 0) return 0;
  const int block = 128;
  auto kernel = stats == nullptr ? trace_closest_kernel<false>
                                 : trace_closest_kernel<true>;
  kernel<<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
      n, (const float*)ray_o, (const float*)ray_d, t_min, (const float*)tmax,
      (const int*)excl_mesh, (const int*)excl_prim, n_nodes,
      (const float*)bmin, (const float*)bmax, (const int*)prim_offset,
      (const int*)prim_count, (const int*)exit_index,
      (const int*)prim_indices, n_slots, (const float*)v0, (const float*)v1,
      (const float*)v2, (const int*)mesh_index, (float*)out_t,
      (int*)out_tri, (float*)out_u, (float*)out_v, (const int*)left_sib,
      (unsigned long long*)stats);
  return (int)cudaGetLastError();
}
