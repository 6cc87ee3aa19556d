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
// Instanced meshes (trace_instanced_kernel<ANY, STAGED>: closest-hit and
// any-hit) replace the same TPU kernel where the JAX package launches it
// once per placement of a shared object-space mesh (ops/traversal.py
// trace_instanced:241 -> _trace_group:286, and
// trace_instanced_occluded:364), a Python loop of I launches a trace. Here
// one launch covers every placement of every group: the groups' nodes and
// slot records lie one after the other (schema.InstanceTable), each
// placement's row holds its world -> local rows and its group's offsets.
// A lane walks a two-level tree: schema.InstanceTlas, a median-split tree
// over the placements' world boxes in K1's own 32-byte node format (an
// interior node's offset is its right child, a leaf's its first placement
// box; the reference's SWRT path walks such a TLAS, SceneAccel.mm
// :188-247), near child first with a stack of TLAS_STACK entries (the
// build refuses a deeper tree); at a leaf, each placement's own box is
// tested before its row is read, and a placement that passes has its ray
// mapped into object space in registers and its group's tree walked by
// walk_closest / walk_any, K1's walks, unchanged. A box (node or
// placement) whose entry lies beyond the lane's window is skipped. The
// sequential walk it replaces paid a row, a mapping and a root test for
// every placement, in table order; this one pays them only for the
// placements whose box the ray enters before its window closes.
//
// Why the bits are the sequential walk's (trace_instanced_closest_
// reference, the plain version):
// - The window. A placement walked with window W returns the nearest hit
//   of its tree with t < W, the first in the tree's depth-first order
//   among equal t: the tree fixes that order, and a tighter window prunes
//   only nodes whose entry lies beyond it, so any two windows above the
//   placement's nearest t give the same (t, tri, u, v). The lane's
//   result is then the lexicographic minimum of (t, flat placement index)
//   over the placements, whatever the order they are visited in, if
//   every placement whose index is below the running best's is walked
//   with the window one ulp above the best (nextafterf): a tie then goes
//   to the lower index, as the table-order loop gives it (strict '<'
//   across placements). Others get the best itself. The exclusion stays
//   per placement: only where ex_mesh is the placement's instance id.
// - The padding. A placement whose box test fails is not walked, so the
//   test must never fail where walk_closest / walk_any would find a hit
//   inside its window: that walk's first step, the root's slab test in
//   object space, then passed at some t* in [t_min, W], so the object ray
//   at t* lies in the root box up to the slab test's rounding. The world
//   box holds the root box's 8 corners mapped local -> world in float64.
//   The world point o + t* d differs from the image of the object point
//   by the rounding of the mapping (o_l, d_l each a 3-term dot, w2l the
//   float inverse of l2w) and of the slab test: a few ulps of cond(L) x
//   (|o| + t*|d| + |translation|), where cond(L) is the condition number
//   of the placement's linear part; and t*|d| <= |o| + |the point|, the
//   point lying in a box. So each box is padded at build by kappa x (the
//   largest coordinate of any box + the largest translation), and each
//   lane grows every box it tests by 2 kappa max|o_i| (InstanceTlas.pad),
//   kappa = 2^-14 x max(1, the largest cond(L)): some 2^10 times the
//   rounding's bound, so that bound, the float32 rounding of the padded
//   box (outward) and of the slab test's own entry t are all inside the
//   margin. Any-hit's window is t_max for every placement, so its flag is
//   the OR of the same walks in any order.
//
// What the card offers. Persistent blocks on the live-lane list, as K1's.
// Where the TLAS nodes, the placement boxes and the 5 float4s of a row
// the walk reads (80 of its 128 bytes) fit TLAS_SMEM (12 KB: 32 B a node
// and 112 B a placement, ~100 placements), each block stages them once in
// dynamic shared memory and reads them there; 8 blocks an SM then hold at
// most 96 KB of the SM's 228, so the register bound (8 blocks) still sets
// the occupancy and L1 keeps the rest for the trees. Above it the walk
// reads them through L1. No wgmma or TMA: as in K1, every address depends
// on the step before and no two lanes share a tile.
#include "common.cuh"

#define MAX_LEAF 4
#define INFINITY_T 1.0e20f
#define BLOCK 128
#define LIST_BLOCK 1024
#define TLAS_STACK 16         // schema.TLAS_STACK
#define TLAS_SMEM (12 * 1024)  // the staged copy's budget a block

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
// triangle offset (26) and the global instance id (27). The walk reads 5
// of its 8 float4s: 0-2, 5 and 6.
struct Placement {
  float4 r0, r1, r2;
  int node_off, n_nodes, slot_off, n_slots, inst_id;
};
// the 5 float4s of placement k: from the table (stride 8) or, staged in
// shared memory, packed at stride 5
template <bool STAGED>
__device__ __forceinline__ Placement load_placement(
    const float4* __restrict__ rows, int k) {
  Placement p;
  float4 a, b;
  if constexpr (STAGED) {
    const float4* row = rows + 5 * k;
    p.r0 = row[0];
    p.r1 = row[1];
    p.r2 = row[2];
    a = row[3];
    b = row[4];
  } else {
    const float4* row = rows + 8 * k;
    p.r0 = __ldg(row);
    p.r1 = __ldg(row + 1);
    p.r2 = __ldg(row + 2);
    a = __ldg(row + 5);
    b = __ldg(row + 6);
  }
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

// The slab test of a TLAS node or placement box ({bmin, _}, {bmax, _}),
// grown by the lane's pad, against [t_min, window]: the entry t, or
// INFINITY where the box is missed (kernels/traverse.py _padded_entry).
__device__ __forceinline__ float padded_entry(float4 lo, float4 hi,
                                              const float* oo,
                                              const float* inv, float pad,
                                              float t_min, float window) {
  const float bmin[3] = {lo.x - pad, lo.y - pad, lo.z - pad};
  const float bmax[3] = {hi.x + pad, hi.y + pad, hi.z + pad};
  float tnear = 0.0f, tfar = 0.0f;
  for (int a = 0; a < 3; ++a) {
    float t0 = (bmin[a] - oo[a]) * inv[a];
    float t1 = (bmax[a] - oo[a]) * inv[a];
    float lo_a = cmin(minn(t0, t1), t_min);
    float hi_a = maxn(t0, t1);
    tnear = a == 0 ? lo_a : maxn(tnear, lo_a);
    tfar = a == 0 ? hi_a : minn(tfar, hi_a);
  }
  return minn(tfar, window) >= tnear ? tnear : __int_as_float(0x7f800000);
}

// Where the walk reads the TLAS nodes, the placement boxes and the rows:
// global memory through the read-only cache, or the block's shared copy
// (tlas_smem: nodes, then boxes, then the rows at stride 5). The
// addresses are rebuilt from the kernel's parameters at each read, so no
// register holds them across a placement's walk.
}  // namespace
extern __shared__ float4 tlas_smem[];
namespace {
template <bool STAGED>
__device__ __forceinline__ float4 tlas_node(const float4* __restrict__ g,
                                            int k) {
  if constexpr (STAGED) return tlas_smem[k];
  else return __ldg(g + k);
}
template <bool STAGED>
__device__ __forceinline__ float4 tlas_box(const float4* __restrict__ g,
                                           int n_tnodes, int k) {
  if constexpr (STAGED) return tlas_smem[2 * n_tnodes + k];
  else return __ldg(g + k);
}
template <bool STAGED>
__device__ __forceinline__ const float4* tlas_rows(
    const float4* __restrict__ table, int n_tnodes, int n_inst) {
  if constexpr (STAGED) return tlas_smem + 2 * n_tnodes + 2 * n_inst;
  else return table;
}

// The two-level walk of one live lane (ANY: any-hit): the TLAS near
// first, a placement's own box tested before its row is read, each
// placement that passes mapped into object space and walked by K1's
// walk_closest / walk_any unchanged. The window of a node (and of a popped
// node's kept entry) is the widest any placement can get: one ulp above
// the best once the lane has a hit; a placement's window is the best, or
// one ulp above it where its flat index is below the best's (the tie
// rule). Any-hit's window is t_max throughout, and a lane ends at its
// first occluder.
template <bool ANY, bool STAGED>
__device__ __forceinline__ void tlas_lane(
    int i, const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    float t_min, const float* __restrict__ tmax,
    const int* __restrict__ excl_mesh, const int* __restrict__ excl_prim,
    int n_inst, const float4* __restrict__ table, int n_tnodes,
    const float4* __restrict__ tnodes, const float4* __restrict__ boxes,
    float pad_scale, const float4* __restrict__ nodes,
    const float4* __restrict__ recs, float* __restrict__ out_t,
    int* __restrict__ out_tri, float* __restrict__ out_u,
    float* __restrict__ out_v, int* __restrict__ out_inst,
    bool* __restrict__ out_occluded) {
  const float t_max = tmax[i];
  float best_t = t_max;
  int best_inst = -1;
  bool occluded = false;
  V3 o = load3(ray_o, i), d = load3(ray_d, i);
  if constexpr (!ANY) {
    // the best hit's (tri, u, v) live in the outputs, written only where
    // a walk finds a nearer hit: three registers fewer across the walk
    out_tri[i] = -1;
    out_u[i] = 0.0f;
    out_v[i] = 0.0f;
  }
  float inv[3];
  inverse_dir(d, inv);
  const float oo[3] = {o.x, o.y, o.z};
  const float pad =
      pad_scale * fmaxf(fmaxf(fabsf(o.x), fabsf(o.y)), fabsf(o.z));
  const float inf = __int_as_float(0x7f800000);
  int stack[TLAS_STACK];
  float stack_t[TLAS_STACK];
  int sp = 0;
  auto widest = [&]() {
    return ANY ? t_max : (best_inst >= 0 ? nextafterf(best_t, inf) : best_t);
  };
  int node = padded_entry(tlas_node<STAGED>(tnodes, 0),
                          tlas_node<STAGED>(tnodes, 1), oo, inv, pad, t_min,
                          widest()) < inf ? 0 : -1;
  for (;;) {
    if (node < 0) {
      // the stack: the next kept node whose entry the window reaches
      if (sp == 0) break;
      --sp;
      if (stack_t[sp] <= widest()) node = stack[sp];
      continue;
    }
    int meta = __float_as_int(tlas_node<STAGED>(tnodes, 2 * node + 1).w);
    int count = meta & 7, off = meta >> 3;
    if (count == 0) {
      // both children, the nearer next, the farther kept
      int left = node + 1, right = off;
      float w = widest();
      float t_l = padded_entry(tlas_node<STAGED>(tnodes, 2 * left),
                               tlas_node<STAGED>(tnodes, 2 * left + 1), oo,
                               inv, pad, t_min, w);
      float t_r = padded_entry(tlas_node<STAGED>(tnodes, 2 * right),
                               tlas_node<STAGED>(tnodes, 2 * right + 1), oo,
                               inv, pad, t_min, w);
      bool ok_l = t_l < inf, ok_r = t_r < inf;
      bool right_first = ok_r && (!ok_l || t_r < t_l);
      if (ok_l && ok_r) {
        stack[sp] = right_first ? left : right;
        stack_t[sp] = right_first ? t_l : t_r;
        ++sp;
      }
      node = ok_l || ok_r ? (right_first ? right : left) : -1;
      continue;
    }
    // a leaf: each placement's own box, then its walk
    for (int k = off; k < off + count; ++k) {
      float4 lo = tlas_box<STAGED>(boxes, n_tnodes, 2 * k);
      int q = __float_as_int(lo.w);
      float w = ANY ? t_max
                    : (best_inst >= 0 && q < best_inst
                           ? nextafterf(best_t, inf)
                           : best_t);
      if (!(padded_entry(lo, tlas_box<STAGED>(boxes, n_tnodes, 2 * k + 1),
                         oo, inv, pad, t_min, w) < inf))
        continue;
      Placement p = load_placement<STAGED>(
          tlas_rows<STAGED>(table, n_tnodes, n_inst), q);
      V3 o_l, d_l;
      object_ray(p, o, d, &o_l, &d_l);
      if constexpr (ANY) {
        occluded = walk_any<false>(o_l, d_l, t_min, t_max, p.n_nodes,
                                   nodes + 2LL * p.node_off, p.n_slots,
                                   recs + 3LL * p.slot_off, nullptr, nullptr);
        if (occluded) break;
      } else {
        int ex_p = __ldg(excl_mesh + i) == p.inst_id ? __ldg(excl_prim + i)
                                                      : -1;
        float wt = w;
        if (walk_closest<false>(o_l, d_l, t_min, 0, ex_p, p.n_nodes,
                                nodes + 2LL * p.node_off, p.n_slots,
                                recs + 3LL * p.slot_off, &wt, out_tri + i,
                                out_u + i, out_v + i, nullptr, nullptr)) {
          best_t = wt;
          best_inst = q;
        }
      }
    }
    if (ANY && occluded) break;
    node = -1;
  }
  if constexpr (ANY) {
    out_occluded[i] = occluded;
  } else {
    out_t[i] = best_t;
    out_inst[i] = best_inst;
  }
}

// One kernel for both instanced walks (ANY: any-hit), persistent warps on
// the live-lane list as K1's. STAGED: the block first copies the TLAS
// nodes, the placement boxes and the 5 float4s of every row the walk reads
// into dynamic shared memory (n_tnodes * 32 + n_inst * 112 bytes, at most
// TLAS_SMEM), and reads them there.
template <bool ANY, bool STAGED>
__global__ void __launch_bounds__(BLOCK, 8) trace_instanced_kernel(
    const int* __restrict__ list, int* __restrict__ counters,
    const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    float t_min, const float* __restrict__ tmax,
    const int* __restrict__ excl_mesh, const int* __restrict__ excl_prim,
    int n_inst, const float4* __restrict__ table,
    const float4* __restrict__ nodes, const float4* __restrict__ recs,
    int n_tnodes, const float4* __restrict__ tnodes,
    const float4* __restrict__ boxes, float pad_scale,
    float* __restrict__ out_t, int* __restrict__ out_tri,
    float* __restrict__ out_u, float* __restrict__ out_v,
    int* __restrict__ out_inst, bool* __restrict__ out_occluded) {
  if constexpr (STAGED) {
    float4* s_nodes = tlas_smem;
    float4* s_boxes = s_nodes + 2 * n_tnodes;
    float4* s_rows = s_boxes + 2 * n_inst;
    for (int k = threadIdx.x; k < 2 * n_tnodes; k += blockDim.x)
      s_nodes[k] = __ldg(tnodes + k);
    for (int k = threadIdx.x; k < 2 * n_inst; k += blockDim.x)
      s_boxes[k] = __ldg(boxes + k);
    for (int k = threadIdx.x; k < 5 * n_inst; k += blockDim.x) {
      int q = k / 5, e = k - 5 * q;
      s_rows[k] = __ldg(table + 8 * q + (e < 3 ? e : e + 2));
    }
    __syncthreads();
  }
  const int n_live = counters[0];
  for (;;) {
    int k = next_batch(counters + 1);
    if (k >= n_live) break;
    k += threadIdx.x & 31;
    if (k >= n_live) continue;
    tlas_lane<ANY, STAGED>(list[k], ray_o, ray_d, t_min, tmax, excl_mesh,
                           excl_prim, n_inst, table, n_tnodes, tnodes, boxes,
                           pad_scale, nodes, recs, out_t, out_tri, out_u,
                           out_v, out_inst, out_occluded);
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

int grid_cache[8];

// An instanced walk's launch: the staged instantiation, with the shared
// copy's bytes, where the TLAS nodes, boxes and rows fit TLAS_SMEM (up to
// which the register bound, not the copy, sets the blocks an SM), the
// other one (reading them through L1) above it.
template <bool ANY>
int instanced_launch(int n, const void* ray_o, const void* ray_d,
                     float t_min, const void* tmax, const void* excl_mesh,
                     const void* excl_prim, int n_inst, const void* table,
                     const void* nodes, const void* recs, int n_tnodes,
                     const void* tnodes, const void* boxes, float pad_scale,
                     void* out_t, void* out_tri, void* out_u, void* out_v,
                     void* out_inst, void* out_occluded, int* sc,
                     cudaStream_t s) {
  size_t smem = (size_t)n_tnodes * 32 + (size_t)n_inst * (32 + 80);
  bool staged = smem <= TLAS_SMEM;
  auto kernel = staged ? trace_instanced_kernel<ANY, true>
                       : trace_instanced_kernel<ANY, false>;
  if (!staged) smem = 0;
  int grid = persistent_grid(kernel, BLOCK,
                             &grid_cache[4 + 2 * ANY + staged], n,
                             staged ? TLAS_SMEM : 0);
  kernel<<<grid, BLOCK, smem, s>>>(
      sc + 2, sc, (const float*)ray_o, (const float*)ray_d, t_min,
      (const float*)tmax, (const int*)excl_mesh, (const int*)excl_prim,
      n_inst, (const float4*)table, (const float4*)nodes,
      (const float4*)recs, n_tnodes, (const float4*)tnodes,
      (const float4*)boxes, pad_scale, (float*)out_t, (int*)out_tri,
      (float*)out_u, (float*)out_v, (int*)out_inst, (bool*)out_occluded);
  return (int)cudaGetLastError();
}

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
// packed nodes and slot records one after the other, `tnodes` / `boxes`
// the n_tnodes nodes of schema.InstanceTlas and its placement boxes,
// `pad_scale` its pad; out_inst the flat placement index of each lane's
// hit (-1: none). `scratch` as above.
extern "C" int mpt_trace_instanced_closest(
    int n, const void* ray_o, const void* ray_d, float t_min,
    const void* tmax, const void* excl_mesh, const void* excl_prim,
    int n_inst, const void* table, const void* nodes, const void* recs,
    int n_tnodes, const void* tnodes, const void* boxes, float pad_scale,
    void* out_t, void* out_tri, void* out_u, void* out_v, void* out_inst,
    void* scratch, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int* sc = (int*)scratch;
  int err = list_live(n, tmax, t_min, sc, out_t, out_tri, out_u, out_v,
                      out_inst, nullptr, s);
  if (err != 0) return err;
  return instanced_launch<false>(
      n, ray_o, ray_d, t_min, tmax, excl_mesh, excl_prim, n_inst, table,
      nodes, recs, n_tnodes, tnodes, boxes, pad_scale, out_t, out_tri, out_u,
      out_v, out_inst, nullptr, sc, s);
}

extern "C" int mpt_trace_instanced_any(
    int n, const void* ray_o, const void* ray_d, float t_min,
    const void* tmax, int n_inst, const void* table, const void* nodes,
    const void* recs, int n_tnodes, const void* tnodes, const void* boxes,
    float pad_scale, void* out_occluded, void* scratch, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int* sc = (int*)scratch;
  int err = list_live(n, tmax, t_min, sc, nullptr, nullptr, nullptr, nullptr,
                      nullptr, out_occluded, s);
  if (err != 0) return err;
  return instanced_launch<true>(
      n, ray_o, ray_d, t_min, tmax, nullptr, nullptr, n_inst, table, nodes,
      recs, n_tnodes, tnodes, boxes, pad_scale, nullptr, nullptr, nullptr,
      nullptr, nullptr, out_occluded, sc, s);
}
