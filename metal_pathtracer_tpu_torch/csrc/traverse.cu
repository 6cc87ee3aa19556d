// K1: closest-hit and any-hit triangle traces of a ray wavefront.
//
// Replaces the TPU packet-traversal kernel ops/pallas/traverse.py
// (_kernel:60 / _packet_body:106, launched by _call:596 from
// packet_trace:659), in closest-hit mode and in its any_hit=True mode
// (traverse.py:280-296: shadow rays). The TPU kernel walks 1024-ray packets
// through a chunked tree with a shared scalar stack and SMEM-resident
// nodes, because its vector unit only pays off when a whole packet moves
// together. A GPU thread walks its own ray: this kernel walks the
// exit-link BVH (scene/meshbuild.py _flatten_with_exit_links) stacklessly
// -- node = hit ? (leaf ? exit : node + 1) : exit -- exactly as the
// reference loop ops/traversal.py trace_triangles:66-171 does, and so
// returns the same bits as its plain version (ops/kernels/traverse.py):
// the same depth-first order, the same slab tests each decided against
// the same running best t, strict '<' across leaves, the first minimal
// slot within a leaf, the inverse-direction clamp, the 1e-8 determinant
// test and the (mesh, prim) self-hit exclusion. trace_any_kernel makes the
// same walk with the window fixed at tmax and returns at the first
// triangle that passes the test, so its occlusion flag equals the
// closest-hit walk's hit flag bit for bit.
//
// What bounds it on an H100. The byte bound (each touched node and
// triangle read once, every ray in and out once) is 2-3 % of the time: on
// the textured headline's first depth a primary ray makes ~57 slab tests
// and ~8 triangle tests, each one read whose address depends on the step
// before. So the walk pays per memory transaction, not per byte: the
// earlier layout read a node as six scalar bounds at a 12-byte stride plus
// its count and exit link (four 32-byte sectors a step) and a triangle
// through prim_indices, mesh_index and nine scalar vertex loads (five to
// eight sectors), ~271 sectors a primary ray. This layout
// (BvhSoA.packed_nodes, BvhSoA.slot_records) makes one slab test one
// sector, two 16-byte loads: {bmin.xyz, exit}, {bmax.xyz, offset << 3 |
// count}; and a triangle test one 48-byte record in leaf order, {v0, tid},
// {e1, mesh}, {e2, 0}, two sectors, consecutive for the slots of a leaf:
// ~74 sectors a primary ray. e1 = v1 - v0 and e2 = v2 - v0 are rounded
// once at build time, the same bits the walk computed from the vertices.
//
// Scheduling. live_lanes_kernel lists the lanes whose window is not empty
// (tmax >= t_min), one atomic per block over a block-local scan of warp
// ballots (common.cuh list_append, which K2 s2's listing pass shares),
// and writes the dead lanes' outputs itself. The walk kernels
// then run as persistent blocks (as many as fit on the SMs): each warp
// takes the next 32 listed lanes from a device counter until the list is
// spent, so warps hold live rays only, a warp that finishes early takes
// more, and the host never waits for the count. The list keeps lane order
// within a warp batch, so neighbouring pixels still walk together; every
// lane's output lands at its own index, unchanged. __launch_bounds__
// (128, 8) keeps the counter-free walks at <= 64 registers, 32 warps an
// SM; the counting walks keep a bound of their own (6 blocks).
//
// Not applicable: wgmma and TMA need dense tiles; here every address
// depends on the previous step and no two lanes share a tile. Left for
// later, each with its own parity argument: near-first child order and
// child-pair (or 4-/8-wide) nodes change the set of slab tests and which of
// two equal-t triangles in different leaves wins; ray reordering between
// depths changes nothing per lane but needs the sort.
//
// Counting mode (template flag STATS) replaces the TPU kernel's
// return_stats mode (traverse.py packet_trace_unsorted(...,
// return_stats=True):726, totals :792-809). Per ray it counts the slab
// tests (nodes visited), the leaf visits whose box passed (the analogue of
// the packet walk's leaf chunks tested), the interior nodes both of whose
// children's boxes passed (counted at the right child: its left sibling
// passed unless the walk came to it straight from that sibling's failed
// test) and the triangle tests; each thread sums its rays' counts, the
// block sums its threads' in shared memory and adds them with one atomic
// per block and counter into an int64 vector of 4. Counting reads one
// more int per visited node (its left sibling, BvhSoA.left_sibling) and
// writes 32 bytes per launch; it changes no t, tri, u, v or occlusion bit.
// STATS=false is the kernel without any of it.
//
// Instanced meshes (trace_instanced_closest_kernel,
// trace_instanced_any_kernel) replace the same TPU kernel where the JAX
// package launches it once per placement of a shared object-space mesh
// (ops/traversal.py trace_instanced:241 -> _trace_group:286, and
// trace_instanced_occluded:364), a Python loop of I launches a trace. Here
// one launch covers every placement of every group: the groups' nodes and
// slot records lie one after the other (schema.InstanceTable), each
// placement's row holds its world -> local rows and its group's offsets,
// and each lane runs the same walks (walk_closest, walk_any) once per
// placement, in the JAX order, its ray mapped into object space in
// registers. The bound is again the dependent reads: a lane walks every
// placement's tree, so its slab tests add up over the placements (a TLAS
// over the placements, which skips those the ray misses, is speed work
// with a parity argument of its own: ROADMAP). The table is 128 bytes a
// placement, read through the read-only cache by every lane.
#include "common.cuh"

#define MAX_LEAF 4
#define INFINITY_T 1.0e20f
#define BLOCK 128
#define LIST_BLOCK 1024

namespace {

// Moller-Trumbore (reference: intersect_triangle_parametric) against the
// record of slot `slot`; the window test is the caller's.
struct TriHit {
  float t, u, v;
  int tid, mesh;
  bool ok;  // determinant and barycentric tests passed
};
__device__ __forceinline__ TriHit intersect_slot(
    V3 o, V3 d, const float4* __restrict__ recs, int slot) {
  const float4* r = recs + 3 * slot;
  float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2);
  V3 v0 = v3(a.x, a.y, a.z);
  V3 edge1 = v3(b.x, b.y, b.z);
  V3 edge2 = v3(c.x, c.y, c.z);
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
  h.tid = __float_as_int(a.w);
  h.mesh = __float_as_int(b.w);
  return h;
}

// The slab test of a node ({bmin, exit}, {bmax, meta}) against
// [t_min, min(tfar, t_best)].
__device__ __forceinline__ bool box_hit(float4 lo, float4 hi, const float* oo,
                                        const float* inv, float t_min,
                                        float t_best) {
  const float bmin[3] = {lo.x, lo.y, lo.z};
  const float bmax[3] = {hi.x, hi.y, hi.z};
  float tnear = 0.0f, tfar = 0.0f;
  for (int a = 0; a < 3; ++a) {
    float t0 = (bmin[a] - oo[a]) * inv[a];
    float t1 = (bmax[a] - oo[a]) * inv[a];
    float lo_a = cmin(minn(t0, t1), t_min);
    float hi_a = maxn(t0, t1);
    tnear = a == 0 ? lo_a : maxn(tnear, lo_a);
    tfar = a == 0 ? hi_a : minn(tfar, hi_a);
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

// the four counters of one thread's rays (counting mode)
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

// The live-lane list: lanes with tmax >= t_min (NaN and empty windows are
// dead), appended in warp order at list[0..counters[0]) with one atomic
// per block; a dead lane gets its output here: (tmax, -1, 0, 0) for the
// closest-hit walk (out_t non-null; and placement -1 where out_inst is
// non-null), false for the any-hit walk.
__global__ void __launch_bounds__(LIST_BLOCK) live_lanes_kernel(
    int n, const float* __restrict__ tmax, float t_min,
    int* __restrict__ counters, int* __restrict__ list,
    float* __restrict__ out_t, int* __restrict__ out_tri,
    float* __restrict__ out_u, float* __restrict__ out_v,
    int* __restrict__ out_inst, bool* __restrict__ out_occluded) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  float tm = i < n ? tmax[i] : 0.0f;
  bool live = i < n && tm >= t_min;
  list_append<LIST_BLOCK>(live, i, counters, list);
  if (!live && i < n) {
    if (out_t != nullptr) {
      out_t[i] = tm;
      out_tri[i] = -1;
      out_u[i] = 0.0f;
      out_v[i] = 0.0f;
      if (out_inst != nullptr) out_inst[i] = -1;
    } else {
      out_occluded[i] = false;
    }
  }
}

// The closest-hit walk of one ray (o, d) through one tree from its root,
// against the running best (t, tri, u, v), which it updates in place;
// returns whether it found a nearer hit. The (mesh, prim) pair is the one
// triangle the ray must skip.
template <bool STATS>
__device__ __forceinline__ bool walk_closest(
    V3 o, V3 d, float t_min, int ex_mesh, int ex_prim, int n_nodes,
    const float4* __restrict__ nodes, int n_slots,
    const float4* __restrict__ recs, float* best_t_io, int* best_tri_io,
    float* best_u_io, float* best_v_io, const int* __restrict__ left_sib,
    Counts* cnt) {
  float best_t = *best_t_io;
  bool found = false;
  float inv[3];
  inverse_dir(d, inv);
  float oo[3] = {o.x, o.y, o.z};
  int node = 0;
  int prev = -1;
  bool prev_hit = false;
  while (node < n_nodes) {
    float4 lo = __ldg(nodes + 2 * node), hi = __ldg(nodes + 2 * node + 1);
    bool hit_box = box_hit(lo, hi, oo, inv, t_min, best_t);
    int meta = __float_as_int(hi.w);
    int pcount = meta & 7;
    if constexpr (STATS) {
      count_node(cnt, left_sib, node, prev, prev_hit, hit_box, pcount);
      prev = node;
      prev_hit = hit_box;
    }
    if (hit_box && pcount > 0) {
      int poff = meta >> 3;
      // argmin over the leaf's MAX_LEAF candidates (INFINITY_T where a
      // slot is past the count or fails the test), first minimum kept
      float kt = INFINITY_T, ku = 0.0f, kv = 0.0f;
      int kid = -1;
      bool any_valid = false;
      for (int k = 0; k < MAX_LEAF; ++k) {
        float t = INFINITY_T, u = 0.0f, v = 0.0f;
        int id = -1;
        if (k < pcount) {
          if constexpr (STATS) cnt->tris += 1;
          TriHit h = intersect_slot(o, d, recs,
                                    min(max(poff + k, 0), n_slots - 1));
          id = h.tid;
          bool excl = h.mesh == ex_mesh && h.tid == ex_prim;
          if (h.ok && h.t >= t_min && h.t <= best_t && !excl) {
            t = h.t;
            u = h.u;
            v = h.v;
            any_valid = true;
          }
        }
        if (k == 0 || t < kt) {
          kt = t;
          ku = u;
          kv = v;
          kid = id;
        }
      }
      if (any_valid && kt < best_t) {
        best_t = kt;
        *best_tri_io = kid;
        *best_u_io = ku;
        *best_v_io = kv;
        found = true;
      }
    }
    node = (hit_box && pcount == 0) ? node + 1 : __float_as_int(lo.w);
  }
  *best_t_io = best_t;
  return found;
}

// the closest-hit walk of live lane i
template <bool STATS>
__device__ __forceinline__ void closest_lane(
    int i, const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    float t_min, const float* __restrict__ tmax,
    const int* __restrict__ excl_mesh, const int* __restrict__ excl_prim,
    int n_nodes, const float4* __restrict__ nodes, int n_slots,
    const float4* __restrict__ recs, float* __restrict__ out_t,
    int* __restrict__ out_tri, float* __restrict__ out_u,
    float* __restrict__ out_v, const int* __restrict__ left_sib,
    Counts* cnt) {
  float best_t = tmax[i];
  int best_tri = -1;
  float best_u = 0.0f, best_v = 0.0f;
  walk_closest<STATS>(load3(ray_o, i), load3(ray_d, i), t_min, excl_mesh[i],
                      excl_prim[i], n_nodes, nodes, n_slots, recs, &best_t,
                      &best_tri, &best_u, &best_v, left_sib, cnt);
  out_t[i] = best_t;
  out_tri[i] = best_tri;
  out_u[i] = best_u;
  out_v[i] = best_v;
}

template <bool STATS>
__global__ void __launch_bounds__(BLOCK, STATS ? 6 : 8) trace_closest_kernel(
    const int* __restrict__ list, int* __restrict__ counters,
    const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    float t_min, const float* __restrict__ tmax,
    const int* __restrict__ excl_mesh, const int* __restrict__ excl_prim,
    int n_nodes, const float4* __restrict__ nodes, int n_slots,
    const float4* __restrict__ recs, float* __restrict__ out_t,
    int* __restrict__ out_tri, float* __restrict__ out_u,
    float* __restrict__ out_v, const int* __restrict__ left_sib,
    unsigned long long* __restrict__ stats) {
  Counts cnt = {0u, 0u, 0u, 0u};
  const int n_live = counters[0];
  for (;;) {
    int k = next_batch(counters + 1);
    if (k >= n_live) break;
    k += threadIdx.x & 31;
    if (k < n_live)
      closest_lane<STATS>(list[k], ray_o, ray_d, t_min, tmax, excl_mesh,
                          excl_prim, n_nodes, nodes, n_slots, recs, out_t,
                          out_tri, out_u, out_v, left_sib, &cnt);
  }
  if constexpr (STATS) add_counts(cnt, stats);
}

// The any-hit walk of one ray through one tree: whether a triangle lies
// at t in [t_min, t_max), stopping at the first one found.
template <bool STATS>
__device__ __forceinline__ bool walk_any(
    V3 o, V3 d, float t_min, float t_max, int n_nodes,
    const float4* __restrict__ nodes, int n_slots,
    const float4* __restrict__ recs, const int* __restrict__ left_sib,
    Counts* cnt) {
  bool occluded = false;
  float inv[3];
  inverse_dir(d, inv);
  float oo[3] = {o.x, o.y, o.z};
  int node = 0;
  int prev = -1;
  bool prev_hit = false;
  while (node < n_nodes && !occluded) {
    float4 lo = __ldg(nodes + 2 * node), hi = __ldg(nodes + 2 * node + 1);
    bool hit_box = box_hit(lo, hi, oo, inv, t_min, t_max);
    int meta = __float_as_int(hi.w);
    int pcount = meta & 7;
    if constexpr (STATS) {
      count_node(cnt, left_sib, node, prev, prev_hit, hit_box, pcount);
      prev = node;
      prev_hit = hit_box;
    }
    if (hit_box && pcount > 0) {
      int poff = meta >> 3;
      for (int k = 0; k < pcount && k < MAX_LEAF; ++k) {
        if constexpr (STATS) cnt->tris += 1;
        TriHit h = intersect_slot(o, d, recs,
                                  min(max(poff + k, 0), n_slots - 1));
        // strict '<': the closest-hit walk records a hit only below its
        // running best, which is t_max until the first one
        if (h.ok && h.t >= t_min && h.t < t_max) {
          occluded = true;
          break;
        }
      }
    }
    node = (hit_box && pcount == 0) ? node + 1 : __float_as_int(lo.w);
  }
  return occluded;
}

// the any-hit walk of live lane i
template <bool STATS>
__device__ __forceinline__ void any_lane(
    int i, const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    float t_min, const float* __restrict__ tmax, int n_nodes,
    const float4* __restrict__ nodes, int n_slots,
    const float4* __restrict__ recs, bool* __restrict__ out_occluded,
    const int* __restrict__ left_sib, Counts* cnt) {
  out_occluded[i] =
      walk_any<STATS>(load3(ray_o, i), load3(ray_d, i), t_min, tmax[i],
                      n_nodes, nodes, n_slots, recs, left_sib, cnt);
}

template <bool STATS>
__global__ void __launch_bounds__(BLOCK, STATS ? 6 : 8) trace_any_kernel(
    const int* __restrict__ list, int* __restrict__ counters,
    const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    float t_min, const float* __restrict__ tmax, int n_nodes,
    const float4* __restrict__ nodes, int n_slots,
    const float4* __restrict__ recs, bool* __restrict__ out_occluded,
    const int* __restrict__ left_sib, unsigned long long* __restrict__ stats) {
  Counts cnt = {0u, 0u, 0u, 0u};
  const int n_live = counters[0];
  for (;;) {
    int k = next_batch(counters + 1);
    if (k >= n_live) break;
    k += threadIdx.x & 31;
    if (k < n_live)
      any_lane<STATS>(list[k], ray_o, ray_d, t_min, tmax, n_nodes, nodes,
                      n_slots, recs, out_occluded, left_sib, &cnt);
  }
  if constexpr (STATS) add_counts(cnt, stats);
}

// ---- Instanced meshes --------------------------------------------------
// One row of the instance table (schema.InstanceTable, 32 floats, read as
// float4s): rows 0-2 the world -> local affine rows, then the normal
// matrix (floats 12-20) and, as int bits, the material (21), the group's
// node offset and count (22, 23), slot offset and count (24, 25), object
// triangle offset (26) and the global instance id (27).
struct Placement {
  float4 r0, r1, r2;
  int node_off, n_nodes, slot_off, n_slots, inst_id;
};
__device__ __forceinline__ Placement load_placement(
    const float4* __restrict__ table, int k) {
  const float4* row = table + 8 * k;
  Placement p;
  p.r0 = __ldg(row);
  p.r1 = __ldg(row + 1);
  p.r2 = __ldg(row + 2);
  float4 a = __ldg(row + 5), b = __ldg(row + 6);
  p.node_off = __float_as_int(a.z);
  p.n_nodes = __float_as_int(a.w);
  p.slot_off = __float_as_int(b.x);
  p.n_slots = __float_as_int(b.y);
  p.inst_id = __float_as_int(b.w);
  return p;
}
// kernels/traverse.py object_ray: a 3-term dot per component (XLA:CPU's
// jitted (N,3) x (3,3) product), the translation added unfused
__device__ __forceinline__ void object_ray(const Placement& p, V3 o, V3 d,
                                           V3* o_l, V3* d_l) {
  V3 a = v3(p.r0.x, p.r0.y, p.r0.z), b = v3(p.r1.x, p.r1.y, p.r1.z),
     c = v3(p.r2.x, p.r2.y, p.r2.z);
  *o_l = v3(dot3(o, a) + p.r0.w, dot3(o, b) + p.r1.w, dot3(o, c) + p.r2.w);
  *d_l = v3(dot3(d, a), dot3(d, b), dot3(d, c));
}

// The instanced closest-hit walk of live lane i: placement after placement
// in the table's order (the JAX package's), the ray mapped into the
// placement's object space in registers, the group's tree walked against
// the running best with the exclusion only where the previous hit was this
// placement (object triangle ids repeat across placements; a group's slot
// records carry mesh 0), a hit kept only when strictly nearer.
__global__ void __launch_bounds__(BLOCK, 8) trace_instanced_closest_kernel(
    const int* __restrict__ list, int* __restrict__ counters,
    const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    float t_min, const float* __restrict__ tmax,
    const int* __restrict__ excl_mesh, const int* __restrict__ excl_prim,
    int n_inst, const float4* __restrict__ table,
    const float4* __restrict__ nodes, const float4* __restrict__ recs,
    float* __restrict__ out_t, int* __restrict__ out_tri,
    float* __restrict__ out_u, float* __restrict__ out_v,
    int* __restrict__ out_inst) {
  const int n_live = counters[0];
  for (;;) {
    int k = next_batch(counters + 1);
    if (k >= n_live) break;
    k += threadIdx.x & 31;
    if (k >= n_live) continue;
    int i = list[k];
    float best_t = tmax[i];
    int best_tri = -1, best_inst = -1;
    float best_u = 0.0f, best_v = 0.0f;
    V3 o = load3(ray_o, i), d = load3(ray_d, i);
    int ex_mesh = excl_mesh[i], ex_prim = excl_prim[i];
    for (int q = 0; q < n_inst; ++q) {
      Placement p = load_placement(table, q);
      V3 o_l, d_l;
      object_ray(p, o, d, &o_l, &d_l);
      int ex_p = ex_mesh == p.inst_id ? ex_prim : -1;
      if (walk_closest<false>(o_l, d_l, t_min, 0, ex_p, p.n_nodes,
                              nodes + 2LL * p.node_off, p.n_slots,
                              recs + 3LL * p.slot_off, &best_t, &best_tri,
                              &best_u, &best_v, nullptr, nullptr))
        best_inst = q;
    }
    out_t[i] = best_t;
    out_tri[i] = best_tri;
    out_u[i] = best_u;
    out_v[i] = best_v;
    out_inst[i] = best_inst;
  }
}

// The instanced any-hit walk: placement after placement until one
// occludes, each walked with the lane's own window.
__global__ void __launch_bounds__(BLOCK, 8) trace_instanced_any_kernel(
    const int* __restrict__ list, int* __restrict__ counters,
    const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    float t_min, const float* __restrict__ tmax, int n_inst,
    const float4* __restrict__ table, const float4* __restrict__ nodes,
    const float4* __restrict__ recs, bool* __restrict__ out_occluded) {
  const int n_live = counters[0];
  for (;;) {
    int k = next_batch(counters + 1);
    if (k >= n_live) break;
    k += threadIdx.x & 31;
    if (k >= n_live) continue;
    int i = list[k];
    float t_max = tmax[i];
    V3 o = load3(ray_o, i), d = load3(ray_d, i);
    bool occluded = false;
    for (int q = 0; q < n_inst && !occluded; ++q) {
      Placement p = load_placement(table, q);
      V3 o_l, d_l;
      object_ray(p, o, d, &o_l, &d_l);
      occluded = walk_any<false>(o_l, d_l, t_min, t_max, p.n_nodes,
                                 nodes + 2LL * p.node_off, p.n_slots,
                                 recs + 3LL * p.slot_off, nullptr, nullptr);
    }
    out_occluded[i] = occluded;
  }
}

// zero the two counters (live count, fetch position) at scratch[0..1] and
// list the live lanes at scratch[2..n+2)
int list_live(int n, const void* tmax, float t_min, int* scratch,
              void* out_t, void* out_tri, void* out_u, void* out_v,
              void* out_inst, void* out_occluded, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(scratch, 0, 2 * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  live_lanes_kernel<<<(n + LIST_BLOCK - 1) / LIST_BLOCK, LIST_BLOCK, 0,
                      stream>>>(n, (const float*)tmax, t_min, scratch,
                                scratch + 2, (float*)out_t, (int*)out_tri,
                                (float*)out_u, (float*)out_v,
                                (int*)out_inst, (bool*)out_occluded);
  return (int)cudaGetLastError();
}

int grid_cache[6];

}  // namespace

// `scratch`: n + 2 int32 (the live-lane list and its two counters).
// `stats` NULL launches the counter-free kernel; otherwise the counting one
// adds its four totals (nodes, leaves passed, both children passed,
// triangle tests) to the int64 vector `stats`, reading `left_sib`
extern "C" int mpt_trace_any(
    int n, const void* ray_o, const void* ray_d, float t_min,
    const void* tmax, int n_nodes, const void* nodes, int n_slots,
    const void* recs, void* out_occluded, const void* left_sib, void* stats,
    void* scratch, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int* sc = (int*)scratch;
  int err = list_live(n, tmax, t_min, sc, nullptr, nullptr, nullptr, nullptr,
                      nullptr, out_occluded, s);
  if (err != 0) return err;
  bool counting = stats != nullptr;
  auto kernel = counting ? trace_any_kernel<true> : trace_any_kernel<false>;
  int grid =
      persistent_grid(kernel, BLOCK, &grid_cache[counting ? 1 : 0], n);
  kernel<<<grid, BLOCK, 0, s>>>(
      sc + 2, sc, (const float*)ray_o, (const float*)ray_d, t_min,
      (const float*)tmax, n_nodes, (const float4*)nodes, n_slots,
      (const float4*)recs, (bool*)out_occluded, (const int*)left_sib,
      (unsigned long long*)stats);
  return (int)cudaGetLastError();
}

extern "C" int mpt_trace_closest(
    int n, const void* ray_o, const void* ray_d, float t_min,
    const void* tmax, const void* excl_mesh, const void* excl_prim,
    int n_nodes, const void* nodes, int n_slots, const void* recs,
    void* out_t, void* out_tri, void* out_u, void* out_v,
    const void* left_sib, void* stats, void* scratch, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int* sc = (int*)scratch;
  int err = list_live(n, tmax, t_min, sc, out_t, out_tri, out_u, out_v,
                      nullptr, nullptr, s);
  if (err != 0) return err;
  bool counting = stats != nullptr;
  auto kernel =
      counting ? trace_closest_kernel<true> : trace_closest_kernel<false>;
  int grid =
      persistent_grid(kernel, BLOCK, &grid_cache[counting ? 3 : 2], n);
  kernel<<<grid, BLOCK, 0, s>>>(
      sc + 2, sc, (const float*)ray_o, (const float*)ray_d, t_min,
      (const float*)tmax, (const int*)excl_mesh, (const int*)excl_prim,
      n_nodes, (const float4*)nodes, n_slots, (const float4*)recs,
      (float*)out_t, (int*)out_tri, (float*)out_u, (float*)out_v,
      (const int*)left_sib, (unsigned long long*)stats);
  return (int)cudaGetLastError();
}

// One launch over every placement of every instanced group: `table` the
// n_inst rows of schema.InstanceTable, `nodes` / `recs` the groups'
// packed nodes and slot records one after the other; out_inst the flat
// placement index of each lane's hit (-1: none). `scratch` as above.
extern "C" int mpt_trace_instanced_closest(
    int n, const void* ray_o, const void* ray_d, float t_min,
    const void* tmax, const void* excl_mesh, const void* excl_prim,
    int n_inst, const void* table, const void* nodes, const void* recs,
    void* out_t, void* out_tri, void* out_u, void* out_v, void* out_inst,
    void* scratch, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int* sc = (int*)scratch;
  int err = list_live(n, tmax, t_min, sc, out_t, out_tri, out_u, out_v,
                      out_inst, nullptr, s);
  if (err != 0) return err;
  int grid = persistent_grid(trace_instanced_closest_kernel, BLOCK,
                             &grid_cache[4], n);
  trace_instanced_closest_kernel<<<grid, BLOCK, 0, s>>>(
      sc + 2, sc, (const float*)ray_o, (const float*)ray_d, t_min,
      (const float*)tmax, (const int*)excl_mesh, (const int*)excl_prim,
      n_inst, (const float4*)table, (const float4*)nodes,
      (const float4*)recs, (float*)out_t, (int*)out_tri, (float*)out_u,
      (float*)out_v, (int*)out_inst);
  return (int)cudaGetLastError();
}

extern "C" int mpt_trace_instanced_any(
    int n, const void* ray_o, const void* ray_d, float t_min,
    const void* tmax, int n_inst, const void* table, const void* nodes,
    const void* recs, void* out_occluded, void* scratch, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int* sc = (int*)scratch;
  int err = list_live(n, tmax, t_min, sc, nullptr, nullptr, nullptr, nullptr,
                      nullptr, out_occluded, s);
  if (err != 0) return err;
  int grid = persistent_grid(trace_instanced_any_kernel, BLOCK,
                             &grid_cache[5], n);
  trace_instanced_any_kernel<<<grid, BLOCK, 0, s>>>(
      sc + 2, sc, (const float*)ray_o, (const float*)ray_d, t_min,
      (const float*)tmax, n_inst, (const float4*)table,
      (const float4*)nodes, (const float4*)recs, (bool*)out_occluded);
  return (int)cudaGetLastError();
}
