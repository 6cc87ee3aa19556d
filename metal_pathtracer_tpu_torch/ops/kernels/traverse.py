"""K1: closest-hit and any-hit triangle traces of a ray wavefront.

Replace the TPU packet-traversal kernel ``ops/pallas/traverse.py``
(``_kernel:60`` / ``_packet_body:106``, launched by ``_call:596`` via
``packet_trace:659``), in its closest-hit mode and its ``any_hit=True``
mode (``traverse.py:280-296``, the shadow rays). ``trace_closest`` and
``trace_any`` launch ``csrc/traverse.cu`` on CUDA tensors and run their
plain versions on CPU tensors:

- ``trace_closest_reference`` is the exit-link loop of
  ``ops/traversal.py trace_triangles:66-171``; kernel and plain version
  compute the same bits: the same tree order, strict ``<`` across leaves,
  first minimal slot within a leaf, and the reference's FMA placement;
- ``trace_any_reference`` is the closest-hit reference's hit flag, each
  lane's walk stopped at its first hit (which changes no flag). The
  any-hit kernel walks the same tree and stops at the first triangle
  inside the window, so its flag equals that one bit for bit (which hit
  it found may differ; only the flag is the contract).

``stats=True`` (``trace_closest_stats`` / ``trace_any_stats``) launches
the counting instantiation of the same kernels, which replaces the TPU
kernel's ``return_stats`` mode (``packet_trace_unsorted(...,
return_stats=True):726``, totals ``:792-809``): it returns the usual
outputs, bit for bit, plus an int64 vector of four totals over the
wavefront (``STATS_KEYS``). The plain versions count the same walk
(``walk=``). The names are the JAX package's; on the exit-link tree:

- ``nodes_visited``: slab tests (the packet walk counts its node visits
  per 1024-ray packet, this one per ray);
- ``leaf_chunks_tested``: leaf visits whose box passed (a packet tests a
  leaf's triangle chunk once for the packet; a ray tests its own leaf);
- ``both_children_visited``: interior nodes both of whose children's
  boxes passed, counted at the right child when the walk reaches it (the
  packet walk asks it of both children at the parent, before the left
  subtree can shorten the window);
- ``leaf_prim_tests``: triangle tests (a packet counts a chunk's
  triangles once for its 1024 rays).

Both the kernels and the plain versions read K1's own layout, built once
per tree and kept on it: ``BvhSoA.packed_nodes()`` (32 bytes a node) and
``BvhSoA.slot_records(tris)`` (48 bytes a triangle slot, in leaf order);
``csrc/traverse.cu`` says why.

The instanced variants ``trace_instanced_closest`` / ``trace_instanced_any``
replace the same TPU kernel where the JAX package launches it once per
placement of an instanced mesh (``ops/traversal.py trace_instanced:241``
-> ``_trace_group:286`` -> ``packet_trace``, and
``trace_instanced_occluded:364``). The plain versions are the JAX
package's loop in Python, one ``trace_closest_reference`` /
``trace_any_reference`` walk a placement, in table order: each lane maps
its ray into the placement's object space (``object_ray``, placed like
XLA:CPU's jitted ``p @ m[:, :3].T + m[:, 3]``), walks that group's tree
with the window ``[t_min, best t]`` and its exclusion (only where the
previous hit was this placement: object triangle ids repeat across
placements), and keeps a hit only when strictly nearer. One launch of
the kernel covers every placement of every group
(``schema.InstanceTable``) by a two-level walk: a TLAS over the
placements' padded world boxes (``schema.InstanceTlas``), near first,
each placement whose box the ray enters walked with the running best as
its window, one ulp above it where its flat index is below the best's;
``trace_instanced_*_tlas_reference`` is that walk order in plain
PyTorch, and gives the loop's bits (``csrc/traverse.cu`` says why).
"""

from __future__ import annotations

import torch

from metal_pathtracer_tpu_torch.constants import INFINITY_T
from metal_pathtracer_tpu_torch.ops.kernels import build
from metal_pathtracer_tpu_torch.ops.vecmath import cross, dot
from metal_pathtracer_tpu_torch.schema import instance_table

MAX_LEAF = 4

#: the counting kernels' totals, in order (the JAX package's key names)
STATS_KEYS = ("nodes_visited", "leaf_chunks_tested", "both_children_visited",
              "leaf_prim_tests")


def _intersect_tris(origin, direction, rec, t_min, t_max, exclude_mesh,
                    exclude_prim):
    """Möller–Trumbore over a (lanes, K) block of slot records (reference:
    pathtrace.metal intersect_triangle_parametric:544-592).
    Returns (t, u, v, valid, tri), each (lanes, K)."""
    v0, edge1, edge2 = rec[..., 0:3], rec[..., 4:7], rec[..., 8:11]
    ids = rec.view(torch.int32)
    tri_ids, mesh = ids[..., 3], ids[..., 7]
    d = direction[:, None, :].expand_as(edge1)
    pvec = cross(d, edge2)
    det = dot(edge1, pvec)
    inv_det = 1.0 / torch.where(det.abs() < 1e-8, 1.0, det)
    tvec = origin[:, None, :] - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, edge1)
    v = dot(d, qvec) * inv_det
    t = dot(edge2, qvec) * inv_det
    excl = ((mesh == exclude_mesh[:, None])
            & (tri_ids == exclude_prim[:, None]))
    valid = ((det.abs() >= 1e-8) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t >= t_min) & (t <= t_max[:, None])
             & ~excl)
    return t, u, v, valid, tri_ids


def trace_closest_reference(origin, direction, t_min, t_max, bvh, tris,
                            exclude_mesh, exclude_prim, walk=None,
                            first_hit=False):
    """Plain PyTorch K1: every lane walks the exit-link BVH in lockstep
    (node = hit ? (leaf ? exit : node + 1) : exit) until all lanes leave
    the tree, reading the kernel's packed nodes and slot records. Returns
    (t, tri, u, v); tri is -1 on a miss and t then is the lane's t_max.
    ``first_hit`` ends each lane's walk at its first hit, at the slot
    where the any-hit kernel returns: the hit flag is the same, (t, tri,
    u, v) are then that first hit's.

    ``walk``, a dict, receives what the walk touched (the kernel visits
    the same nodes): ``nodes`` and ``slots`` masks over the node and
    triangle-slot arrays, and the counts of K1's counting mode:
    ``node_visits`` (slab tests), ``leaf_visits`` (leaves whose box
    passed), ``both_children`` (right children whose box passed, their
    left sibling's too) and ``tri_tests``. Given ``walk["lane_group"]``,
    an (N,) tensor of ints below ``walk["n_groups"]``, it receives them
    per group: (G, ...) masks and (G,) count tensors, each group's as a
    walk of its lanes alone gives them."""
    n = origin.shape[0]
    dev = origin.device
    n_nodes = bvh.node_count
    n_slots = bvh.prim_indices.shape[0]
    nodes, recs = bvh.packed_nodes(), bvh.slot_records(tris)
    inv_dir = 1.0 / torch.where(direction.abs() < 1e-20,
                                torch.where(direction >= 0, 1e-20, -1e-20),
                                direction)
    node = torch.zeros(n, dtype=torch.long, device=dev)
    best_t = t_max.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, device=dev)
    best_v = torch.zeros(n, device=dev)
    lanes = torch.arange(n, device=dev)
    ar = torch.arange(MAX_LEAF, device=dev)
    # lanes whose window is empty (dead lanes: t_max = 0) miss every box
    live = lanes[t_max >= t_min]
    node = node[live]
    if walk is not None:
        # masks and counts by lane group, kept on the device until the
        # walk ends: no host sync a step for them
        n_groups = walk.get("n_groups", 1)
        grp = walk.get("lane_group")
        grp = (torch.zeros(n, dtype=torch.long, device=dev) if grp is None
               else grp.long())[live]
        touched = torch.zeros(n_groups * n_nodes, dtype=torch.bool,
                              device=dev)
        slot_hits = torch.zeros(n_groups * n_slots, dtype=torch.int32,
                                device=dev)
        counts = {k: torch.zeros(n_groups, dtype=torch.int64, device=dev)
                  for k in WALK_COUNTS}
        left_sib = bvh.left_sibling().long()
        # each lane's previous slab test: its node and whether it passed
        prev = torch.full_like(node, -1)
        prev_hit = torch.zeros_like(node, dtype=torch.bool)
    while live.numel():
        if walk is not None:
            touched[grp * n_nodes + node] = True
            counts["node_visits"].index_add_(0, grp, torch.ones_like(grp))
        o, inv = origin[live], inv_dir[live]
        row = nodes[node]
        meta = row[:, 7].view(torch.int32)
        t0 = (row[:, 0:3] - o) * inv
        t1 = (row[:, 4:7] - o) * inv
        lo = torch.clamp_min(torch.minimum(t0, t1), t_min)
        hi = torch.maximum(t0, t1)
        tnear = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
        tfar = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
        box_hit = torch.minimum(tfar, best_t[live]) >= tnear
        pcount = meta & 7
        leaf = box_hit & (pcount > 0)
        if walk is not None:
            ls = left_sib[node]
            counts["leaf_visits"].index_add_(0, grp, leaf.long())
            counts["both_children"].index_add_(0, grp, (
                (ls >= 0) & box_hit & ~((prev == ls) & ~prev_hit)).long())
            prev, prev_hit = node, box_hit
        if bool(leaf.any()):
            li = live[leaf]
            slot = torch.clamp((meta[leaf] >> 3)[:, None] + ar, 0,
                               n_slots - 1)
            t, u, v, valid, tri_ids = _intersect_tris(
                origin[li], direction[li], recs[slot], t_min, best_t[li],
                exclude_mesh[li], exclude_prim[li])
            in_leaf = ar < pcount[leaf, None]
            valid &= in_leaf
            if first_hit:
                # slots past the first one inside the window go untested
                accept = valid & (t < best_t[li][:, None])
                first = torch.where(accept.any(-1),
                                    accept.int().argmax(-1), MAX_LEAF)
                in_leaf &= ar <= first[:, None]
                valid &= ar <= first[:, None]
            if walk is not None:
                g = grp[leaf]
                slot_hits.index_add_(0, (g[:, None] * n_slots
                                         + slot).reshape(-1),
                                     in_leaf.reshape(-1).to(torch.int32))
                counts["tri_tests"].index_add_(0, g, in_leaf.sum(-1))
            t_masked = torch.where(valid, t, INFINITY_T)
            k = torch.argmin(t_masked, -1, keepdim=True)  # first minimum
            t_hit = t_masked.gather(-1, k)[:, 0]
            better = valid.any(-1) & (t_hit < best_t[li])
            upd = li[better]
            best_t[upd] = t_hit[better]
            best_tri[upd] = tri_ids.gather(-1, k)[better, 0]
            best_u[upd] = u.gather(-1, k)[better, 0]
            best_v[upd] = v.gather(-1, k)[better, 0]
        descend = box_hit & (pcount == 0)
        node = torch.where(descend, node + 1,
                           row[:, 3].view(torch.int32).long())
        more = node < n_nodes
        if first_hit:
            more &= best_tri[live] < 0
        live, node = live[more], node[more]
        if walk is not None:
            prev, prev_hit, grp = prev[more], prev_hit[more], grp[more]
    if walk is not None:
        walk.update(nodes=touched.view(n_groups, n_nodes),
                    slots=(slot_hits > 0).view(n_groups, n_slots), **counts)
        if "lane_group" not in walk:
            _one_group(walk)
    return best_t, best_tri, best_u, best_v


#: the counts a walk receives (``trace_closest_reference``'s ``walk``)
WALK_COUNTS = ("node_visits", "leaf_visits", "both_children", "tri_tests")


def _one_group(walk):
    """A walk's masks and counts of its one lane group as the ungrouped
    walk gives them: 1-D masks and ints."""
    for k, v in walk.items():
        if torch.is_tensor(v) and v.dim() >= 1 and k != "lane_group":
            walk[k] = v[0] if v.dim() == 2 else int(v[0])


def walk_totals(walk, device) -> torch.Tensor:
    """The plain walk's counts as the counting kernel's (4,) int64 totals
    (``STATS_KEYS`` order)."""
    return torch.tensor([walk["node_visits"], walk["leaf_visits"],
                         walk["both_children"], walk["tri_tests"]],
                        dtype=torch.int64, device=device)


def _as_i32(x, n, dev):
    if x is None:
        return torch.full((n,), -1, dtype=torch.int32, device=dev)
    return x.to(torch.int32).contiguous()


def trace_closest(origin, direction, t_min: float, t_max, bvh, tris,
                  exclude_mesh=None, exclude_prim=None, stats: bool = False):
    """Nearest triangle hit per ray: (t, tri, u, v), each (N,).

    origin/direction (N,3) f32, t_max (N,) f32 (0 marks a dead lane),
    exclude_mesh/exclude_prim (N,) ids of a triangle each lane must skip.
    ``stats``: also return the walk's (4,) int64 totals (``STATS_KEYS``)
    from K1's counting instantiation. CPU tensors take the plain version;
    CUDA tensors launch K1."""
    n = origin.shape[0]
    dev = origin.device
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (n,)).contiguous()
    exclude_mesh = _as_i32(exclude_mesh, n, dev)
    exclude_prim = _as_i32(exclude_prim, n, dev)
    if dev.type == "cpu":
        walk = {} if stats else None
        out = trace_closest_reference(origin, direction, float(t_min),
                                      t_max, bvh, tris, exclude_mesh,
                                      exclude_prim, walk=walk)
        return (*out, walk_totals(walk, dev)) if stats else out
    if dev.type != "cuda":
        raise ValueError(f"trace_closest: unsupported device {dev}")
    nodes, recs = _k1_layout("trace_closest", bvh, tris, dev, [
        origin, direction, t_max, exclude_mesh, exclude_prim])
    out_t = torch.empty(n, dtype=torch.float32, device=dev)
    out_tri = torch.empty(n, dtype=torch.int32, device=dev)
    out_u = torch.empty(n, dtype=torch.float32, device=dev)
    out_v = torch.empty(n, dtype=torch.float32, device=dev)
    left_sib, totals = _stats_buffers(bvh, dev, stats)
    scratch = build.list_scratch(n, dev)
    lib = build.load()
    p = lambda x: None if x is None else x.data_ptr()
    err = lib.mpt_trace_closest(
        n, p(origin), p(direction), float(t_min), p(t_max),
        p(exclude_mesh), p(exclude_prim), bvh.node_count, p(nodes),
        recs.shape[0], p(recs), p(out_t), p(out_tri), p(out_u), p(out_v),
        p(left_sib), p(totals), p(scratch),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "mpt_trace_closest")
    if stats:
        trace_closest_stats.launches += 1
        return out_t, out_tri, out_u, out_v, totals
    trace_closest.launches += 1
    return out_t, out_tri, out_u, out_v


def _k1_layout(name, bvh, tris, dev, lanes):
    """K1's packed nodes and slot records for a launch on ``dev``, after
    checking them and the lane tensors: contiguous, on ``dev``, the rays
    float32 and the layouts aligned for 16-byte loads (nodes on 32)."""
    nodes, recs = bvh.packed_nodes(), bvh.slot_records(tris)
    for a in (*lanes, nodes, recs):
        if a.device != dev or not a.is_contiguous():
            raise ValueError(f"{name}: every tensor, the packed nodes and "
                             f"slot records included, must be contiguous "
                             f"and on {dev}")
    if lanes[0].dtype != torch.float32 or lanes[1].dtype != torch.float32:
        raise ValueError(f"{name}: rays must be float32")
    if nodes.data_ptr() % 32 or recs.data_ptr() % 16:
        raise ValueError(f"{name}: the packed nodes must be 32-byte and the "
                         "slot records 16-byte aligned")
    return nodes, recs


def _stats_buffers(bvh, dev, stats: bool):
    """The counting kernel's inputs: the left-sibling array and a zeroed
    (4,) int64 totals vector; (None, None) for the counter-free kernel."""
    if not stats:
        return None, None
    left_sib = bvh.left_sibling()
    if left_sib.device != dev:
        raise ValueError(f"K1 stats: the BVH must be on {dev}")
    return left_sib, torch.zeros(len(STATS_KEYS), dtype=torch.int64,
                                 device=dev)


def trace_closest_stats(origin, direction, t_min: float, t_max, bvh, tris,
                        exclude_mesh=None, exclude_prim=None):
    """``trace_closest(..., stats=True)``: (t, tri, u, v, totals)."""
    return trace_closest(origin, direction, t_min, t_max, bvh, tris,
                         exclude_mesh, exclude_prim, stats=True)


#: K1 launches since the last reset (chip_smoke.py reads and resets it);
#: the counting kernel's are counted on ``trace_closest_stats``
trace_closest.launches = 0
trace_closest_stats.launches = 0


def trace_any_reference(origin, direction, t_min, t_max, bvh, tris,
                        walk=None):
    """Plain PyTorch any-hit: the closest-hit reference's hit flag, with
    no self-hit exclusion and each lane's walk stopped at its first hit.
    Returns (N,) bool; ``walk`` as in ``trace_closest_reference``."""
    none = torch.full((origin.shape[0],), -1, dtype=torch.int32,
                      device=origin.device)
    return trace_closest_reference(origin, direction, t_min, t_max, bvh,
                                   tris, none, none, walk=walk,
                                   first_hit=True)[1] >= 0


def trace_any(origin, direction, t_min: float, t_max, bvh, tris,
              stats: bool = False):
    """Occlusion flag per ray: a triangle at t in [t_min, t_max], (N,)
    bool. t_max (N,) f32, 0 marks a lane that traces nothing. ``stats``:
    also return the walk's (4,) int64 totals (``STATS_KEYS``) from the
    counting instantiation. CPU tensors take the plain version; CUDA
    tensors launch K1's any-hit kernel."""
    n = origin.shape[0]
    dev = origin.device
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (n,))
    if dev.type == "cpu":
        walk = {} if stats else None
        occ = trace_any_reference(origin, direction, float(t_min), t_max,
                                  bvh, tris, walk=walk)
        return (occ, walk_totals(walk, dev)) if stats else occ
    if dev.type != "cuda":
        raise ValueError(f"trace_any: unsupported device {dev}")
    t_max = t_max.contiguous()
    nodes, recs = _k1_layout("trace_any", bvh, tris, dev,
                             [origin, direction, t_max])
    out = torch.empty(n, dtype=torch.bool, device=dev)
    left_sib, totals = _stats_buffers(bvh, dev, stats)
    scratch = build.list_scratch(n, dev)
    lib = build.load()
    p = lambda x: None if x is None else x.data_ptr()
    err = lib.mpt_trace_any(
        n, p(origin), p(direction), float(t_min), p(t_max), bvh.node_count,
        p(nodes), recs.shape[0], p(recs), p(out), p(left_sib), p(totals),
        p(scratch), torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "mpt_trace_any")
    if stats:
        trace_any_stats.launches += 1
        return out, totals
    trace_any.launches += 1
    return out


def trace_any_stats(origin, direction, t_min: float, t_max, bvh, tris):
    """``trace_any(..., stats=True)``: (occluded, totals)."""
    return trace_any(origin, direction, t_min, t_max, bvh, tris, stats=True)


#: any-hit launches since the last reset; the counting kernel's are
#: counted on ``trace_any_stats``
trace_any.launches = 0
trace_any_stats.launches = 0


# ---------------------------------------------------------------------------
# Instanced meshes: every placement of every group in one launch
# ---------------------------------------------------------------------------

def object_ray(w2l, origin, direction):
    """A world ray in a placement's object space through its (3,4)
    world -> local rows (or one (N,3,4) matrix a lane): each component a
    3-term dot, contracted like XLA:CPU's jitted (N,3) x (3,3) product
    (``fma(p2, m2, fma(p1, m1, p0 m0))``, measured on 65,536 rays and
    matrices: ``tests/test_torch_instancing.py``), then the translation
    added unfused. The direction is not renormalised, so t is the same in both
    spaces."""
    rows = [w2l[..., k, :3] for k in range(3)]
    o = torch.stack([dot(origin, r) + w2l[..., k, 3]
                     for k, r in enumerate(rows)], -1)
    d = torch.stack([dot(direction, r) for r in rows], -1)
    return o, d


def placements(groups):
    """(flat index, group index, group, placement index, global instance
    id) of every placement, in the JAX package's trace order."""
    k = 0
    for gi, g in enumerate(groups):
        for i in range(g.count):
            yield k, gi, g, i, g.base_id + i
            k += 1


def _walk_into(walk, gi, one):
    """Adds one placement's walk (``trace_closest_reference``'s ``walk``)
    to ``walk``: the nodes and slots touched per group, summed counts."""
    if walk is None:
        return
    groups = walk.setdefault("groups", {})
    if gi not in groups:
        groups[gi] = dict(nodes=torch.zeros_like(one["nodes"]),
                          slots=torch.zeros_like(one["slots"]))
    groups[gi]["nodes"] |= one["nodes"]
    groups[gi]["slots"] |= one["slots"]
    for k in ("node_visits", "tri_tests"):
        walk[k] = walk.get(k, 0) + one[k]


def trace_instanced_closest_reference(origin, direction, t_min, t_max,
                                      groups, exclude_mesh, exclude_prim,
                                      walk=None):
    """Plain PyTorch instanced K1 (``traversal.trace_instanced:241``):
    one ``trace_closest_reference`` walk a placement, its window the
    running best t, a hit kept only when strictly nearer. Returns (t,
    tri, u, v, inst): tri the object triangle, inst the flat placement
    index (-1 and t = t_max on a miss). ``walk``, a dict, receives the
    nodes and slots each group's walks touched (``groups``: group index
    -> masks) and the summed slab and triangle tests."""
    n = origin.shape[0]
    dev = origin.device
    best_t = t_max.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_inst = best_tri.clone()
    best_u = torch.zeros(n, device=dev)
    best_v = torch.zeros(n, device=dev)
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    for k, gi, g, i, gid in placements(groups):
        o_l, d_l = object_ray(g.w2l[i], origin, direction)
        ex_p = torch.where(exclude_mesh == gid, exclude_prim, -1)
        one = None if walk is None else {}
        t, tri, u, v = trace_closest_reference(
            o_l, d_l, t_min, best_t, g.tri_bvh, g.triangles, zeros, ex_p,
            walk=one)
        _walk_into(walk, gi, one)
        hit = tri >= 0
        best_t = torch.where(hit, t, best_t)
        best_tri = torch.where(hit, tri, best_tri)
        best_u = torch.where(hit, u, best_u)
        best_v = torch.where(hit, v, best_v)
        best_inst = torch.where(hit, k, best_inst)
    return best_t, best_tri, best_u, best_v, best_inst


def trace_instanced_any_reference(origin, direction, t_min, t_max, groups,
                                  walk=None):
    """Plain PyTorch instanced any-hit (``traversal.
    trace_instanced_occluded:364``): one ``trace_any_reference`` walk a
    placement, lanes already occluded walking with t_max = 0. ``walk``
    as in ``trace_instanced_closest_reference``."""
    occ = torch.zeros(origin.shape[0], dtype=torch.bool,
                      device=origin.device)
    for _, gi, g, i, _ in placements(groups):
        o_l, d_l = object_ray(g.w2l[i], origin, direction)
        lane_tmax = torch.where(occ, 0.0, t_max)
        one = None if walk is None else {}
        occ = occ | trace_any_reference(o_l, d_l, t_min, lane_tmax,
                                        g.tri_bvh, g.triangles, walk=one)
        _walk_into(walk, gi, one)
    return occ


# ---------------------------------------------------------------------------
# The kernels' walk order: a TLAS over the placements, near first
# ---------------------------------------------------------------------------

def _padded_entry(rows, o, inv, pad, t_min, window):
    """K1's slab test (``box_hit``) of one box a lane, ``rows`` (L, 8) in
    K1's node layout, each box grown by the lane's ``pad``, against
    [t_min, window]: (passed, entry t)."""
    lo = rows[:, 0:3] - pad[:, None]
    hi = rows[:, 4:7] + pad[:, None]
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    lo_t = torch.clamp_min(torch.minimum(t0, t1), t_min)
    hi_t = torch.maximum(t0, t1)
    tnear = torch.maximum(torch.maximum(lo_t[:, 0], lo_t[:, 1]), lo_t[:, 2])
    tfar = torch.minimum(torch.minimum(hi_t[:, 0], hi_t[:, 1]), hi_t[:, 2])
    return torch.minimum(tfar, window) >= tnear, tnear


def _tlas_walk(origin, direction, t_min, t_max, groups, exclude_mesh,
               exclude_prim, any_hit, walk):
    """The instanced kernels' walk in plain PyTorch, lane by lane in
    lockstep: the TLAS near first with a short stack (the kernel's order
    of slab tests, placement tests and walks, step for step), and each
    placement that passes walked by ``trace_closest_reference`` /
    ``trace_any_reference`` with the kernel's window: the running best,
    one ulp above it (``nextafter``) for a placement whose flat index is
    below the best's, ``t_max`` under any-hit. Returns (t, tri, u, v,
    inst) or the (N,) occlusion flags."""
    from metal_pathtracer_tpu_torch.schema import instance_tlas

    n = origin.shape[0]
    dev = origin.device
    tlas = instance_tlas(groups)
    nodes, boxes = tlas.nodes, tlas.boxes
    box_row = boxes[:, 3].view(torch.int32).long()
    meta_of = nodes[:, 7].view(torch.int32).long()
    first_flat, group_of = [], []
    for gi, g in enumerate(groups):
        first_flat.append(len(group_of))
        group_of += [gi] * g.count
    group_of = torch.tensor(group_of, device=dev)
    best_t = t_max.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_inst = best_tri.clone()
    best_u = torch.zeros(n, device=dev)
    best_v = torch.zeros(n, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    lanes = torch.arange(n, device=dev)[t_max >= t_min]
    m = lanes.numel()
    if walk is not None:
        # masks and counts by lane group, as trace_closest_reference's
        n_groups = walk.get("n_groups", 1)
        grp = walk.get("lane_group")
        grp = (torch.zeros(n, dtype=torch.long, device=dev) if grp is None
               else grp.long())[lanes]
        mask = lambda size: torch.zeros((n_groups, size), dtype=torch.bool,
                                        device=dev)
        count = lambda: torch.zeros(n_groups, dtype=torch.int64, device=dev)
        walk.update(tlas_nodes=mask(tlas.node_count),
                    boxes=mask(boxes.shape[0]), rows=mask(boxes.shape[0]),
                    tlas_tests=count(), placement_walks=count())
    o, d = origin[lanes], direction[lanes]
    inv = 1.0 / torch.where(d.abs() < 1e-20,
                            torch.where(d >= 0, 1e-20, -1e-20), d)
    pad = torch.tensor(tlas.pad, dtype=torch.float32, device=dev) \
        * o.abs().amax(-1)
    cur = torch.zeros(m, dtype=torch.long, device=dev)
    lpos = torch.zeros(m, dtype=torch.long, device=dev)
    lend = torch.zeros(m, dtype=torch.long, device=dev)
    stack = torch.zeros((m, tlas.depth + 1), dtype=torch.long, device=dev)
    stack_t = torch.zeros((m, tlas.depth + 1), device=dev)
    sp = torch.zeros(m, dtype=torch.long, device=dev)
    pend = torch.full((m,), -1, dtype=torch.long, device=dev)
    done = torch.zeros(m, dtype=torch.bool, device=dev)
    inf = torch.tensor(float("inf"), device=dev)

    def widest(k):
        """The window of a node: the widest any placement may get."""
        if any_hit:
            return t_max[lanes[k]]
        bt, bi = best_t[lanes[k]], best_inst[lanes[k]]
        return torch.where(bi >= 0, torch.nextafter(bt, inf), bt)

    def test(k, rows, window, name, index):
        if walk is not None:
            walk[name][grp[k], index] = True
            walk["tlas_tests"].index_add_(0, grp[k], torch.ones_like(k))
        return _padded_entry(rows, o[k], inv[k], pad[k], t_min, window)

    # the root: the lane walks nothing when its box fails
    k = torch.arange(m, device=dev)
    ok, _ = test(k, nodes[cur], widest(k), "tlas_nodes", cur)
    done |= ~ok
    while True:
        # advance every lane that waits for nothing to its next placement
        while True:
            act = ~done & (pend < 0)
            if not bool(act.any()):
                break
            k = act.nonzero().squeeze(1)
            in_leaf = lpos[k] < lend[k]
            at_node = ~in_leaf & (cur[k] >= 0)
            pop = ~in_leaf & ~at_node
            # a placement of the current leaf: its own box, its own window
            a = k[in_leaf]
            if a.numel():
                pos = lpos[a]
                q = box_row[pos]
                if any_hit:
                    window = t_max[lanes[a]]
                else:
                    bt, bi = best_t[lanes[a]], best_inst[lanes[a]]
                    window = torch.where((bi >= 0) & (q < bi),
                                         torch.nextafter(bt, inf), bt)
                ok, _ = test(a, boxes[pos], window, "boxes", pos)
                pend[a] = torch.where(ok, q, -1)
                lpos[a] = pos + 1
            # a node: a leaf opens its placements, an interior node tests
            # both children, goes to the nearer and keeps the farther
            a = k[at_node]
            if a.numel():
                node = cur[a]
                meta = meta_of[node]
                leaf = (meta & 7) > 0
                b = a[leaf]
                lpos[b] = meta[leaf] >> 3
                lend[b] = lpos[b] + (meta[leaf] & 7)
                cur[b] = -1
                b = a[~leaf]
                if b.numel():
                    left = cur[b] + 1
                    right = meta[~leaf] >> 3
                    window = widest(b)
                    ok_l, t_l = test(b, nodes[left], window, "tlas_nodes",
                                     left)
                    ok_r, t_r = test(b, nodes[right], window, "tlas_nodes",
                                     right)
                    right_first = ok_r & (~ok_l | (t_r < t_l))
                    near = torch.where(right_first, right, left)
                    far = torch.where(right_first, left, right)
                    far_t = torch.where(right_first, t_l, t_r)
                    both = ok_l & ok_r
                    c = b[both]
                    stack[c, sp[c]] = far[both]
                    stack_t[c, sp[c]] = far_t[both]
                    sp[c] += 1
                    cur[b] = torch.where(ok_l | ok_r, near, -1)
            # the stack: the next kept node whose entry the window reaches
            a = k[pop]
            if a.numel():
                empty = sp[a] == 0
                done[a[empty]] = True
                b = a[~empty]
                sp[b] -= 1
                top = stack[b, sp[b]]
                cur[b] = torch.where(stack_t[b, sp[b]] <= widest(b), top, -1)
        k = (pend >= 0).nonzero().squeeze(1)
        if not k.numel():
            break
        # walk each pending placement, a call per group
        q = pend[k]
        for gi, g in enumerate(groups):
            a = k[group_of[q] == gi]
            if not a.numel():
                continue
            qa = pend[a]
            li = lanes[a]
            o_l, d_l = object_ray(g.w2l[qa - first_flat[gi]], o[a], d[a])
            one = None
            if walk is not None:
                one = dict(lane_group=grp[a], n_groups=n_groups)
                walk["rows"][grp[a], qa] = True
                walk["placement_walks"].index_add_(0, grp[a],
                                                   torch.ones_like(a))
            if any_hit:
                hit = trace_any_reference(o_l, d_l, t_min, t_max[li],
                                          g.tri_bvh, g.triangles, walk=one)
                occ[li] |= hit
                done[a] |= hit
            else:
                bt, bi = best_t[li], best_inst[li]
                window = torch.where((bi >= 0) & (qa < bi),
                                     torch.nextafter(bt, inf), bt)
                ex_p = torch.where(exclude_mesh[li] == g.base_id + qa
                                   - first_flat[gi], exclude_prim[li], -1)
                t, tri, u, v = trace_closest_reference(
                    o_l, d_l, t_min, window, g.tri_bvh, g.triangles,
                    torch.zeros_like(ex_p), ex_p, walk=one)
                hit = tri >= 0
                h = li[hit]
                best_t[h] = t[hit]
                best_tri[h] = tri[hit]
                best_u[h] = u[hit]
                best_v[h] = v[hit]
                best_inst[h] = qa[hit].to(torch.int32)
            _walk_into(walk, gi, one)
        pend[k] = -1
    if walk is not None and "lane_group" not in walk:
        _one_group(walk)
        for masks in walk.get("groups", {}).values():
            masks.update(nodes=masks["nodes"][0], slots=masks["slots"][0])
    if any_hit:
        return occ
    return best_t, best_tri, best_u, best_v, best_inst


def trace_instanced_closest_tlas_reference(origin, direction, t_min, t_max,
                                           groups, exclude_mesh,
                                           exclude_prim, walk=None):
    """The instanced closest-hit kernel's own walk order in plain PyTorch
    (``_tlas_walk``): the TLAS near first, each placement walked with the
    running best as its window, one ulp above it where the placement's
    flat index is below the best's, so the result is the lexicographic
    minimum of (t, placement) and equals
    ``trace_instanced_closest_reference`` bit for bit (``csrc/traverse.cu``
    says why). The tests hold the two equal; nothing on the card's path
    calls it. ``walk`` receives, besides the groups' masks and counts of
    ``trace_instanced_closest_reference``, the TLAS nodes and placement
    boxes tested (``tlas_nodes``, ``boxes``: masks; ``tlas_tests``: slab
    tests), the placements walked (``rows``: a mask over the table;
    ``placement_walks``: walks); by lane group, as
    ``trace_closest_reference`` gives them, where ``walk`` holds
    ``lane_group`` and ``n_groups``."""
    return _tlas_walk(origin, direction, t_min, t_max, groups, exclude_mesh,
                      exclude_prim, False, walk)


def trace_instanced_any_tlas_reference(origin, direction, t_min, t_max,
                                       groups, walk=None):
    """The instanced any-hit kernel's walk order in plain PyTorch: the same
    TLAS walk with the window fixed at ``t_max``, each lane ended by its
    first occluder; equal to ``trace_instanced_any_reference`` in any
    order. ``walk`` as in ``trace_instanced_closest_tlas_reference``."""
    return _tlas_walk(origin, direction, t_min, t_max, groups, None, None,
                      True, walk)


def _instance_layout(name, groups, dev, lanes):
    """The ``InstanceTable`` and its ``InstanceTlas`` for a launch on
    ``dev``, after checking them and the lane tensors as ``_k1_layout``
    does."""
    from metal_pathtracer_tpu_torch.schema import instance_tlas

    tab, tlas = instance_table(groups), instance_tlas(groups)
    for a in (*lanes, tab.table, tab.nodes, tab.recs, tlas.nodes,
              tlas.boxes):
        if a.device != dev or not a.is_contiguous():
            raise ValueError(f"{name}: every tensor, the instance table "
                             f"and its TLAS included, must be contiguous "
                             f"and on {dev}")
    if lanes[0].dtype != torch.float32 or lanes[1].dtype != torch.float32:
        raise ValueError(f"{name}: rays must be float32")
    if any(x.data_ptr() % 32 for x in (tab.nodes, tlas.nodes, tlas.boxes)) \
            or tab.recs.data_ptr() % 16 or tab.table.data_ptr() % 16:
        raise ValueError(f"{name}: the packed nodes and boxes must be "
                         "32-byte, the slot records and the table 16-byte "
                         "aligned")
    return tab, tlas


def trace_instanced_closest(origin, direction, t_min: float, t_max, groups,
                            exclude_mesh=None, exclude_prim=None):
    """Nearest hit over every placement of the instanced ``groups``: (t,
    tri, u, v, inst), each (N,); tri is the object triangle, inst the
    flat placement index (``schema.InstanceTable`` row), -1 on a miss.
    exclude_mesh/exclude_prim: each lane's previous hit (global instance
    id, object triangle) or a soup triangle's (mesh, triangle), which no
    placement excludes. CPU tensors take the plain version, the
    sequential walk; CUDA tensors launch ``trace_instanced_closest_kernel``
    once, which walks the ``schema.InstanceTlas`` and gives the same
    bits."""
    n = origin.shape[0]
    dev = origin.device
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (n,)).contiguous()
    exclude_mesh = _as_i32(exclude_mesh, n, dev)
    exclude_prim = _as_i32(exclude_prim, n, dev)
    if dev.type == "cpu":
        return trace_instanced_closest_reference(
            origin, direction, float(t_min), t_max, groups, exclude_mesh,
            exclude_prim)
    if dev.type != "cuda":
        raise ValueError(f"trace_instanced_closest: unsupported device {dev}")
    tab, tlas = _instance_layout("trace_instanced_closest", groups, dev, [
        origin, direction, t_max, exclude_mesh, exclude_prim])
    out_t = torch.empty(n, dtype=torch.float32, device=dev)
    out_tri = torch.empty(n, dtype=torch.int32, device=dev)
    out_u = torch.empty(n, dtype=torch.float32, device=dev)
    out_v = torch.empty(n, dtype=torch.float32, device=dev)
    out_inst = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = build.list_scratch(n, dev)
    lib = build.load()
    p = lambda x: x.data_ptr()
    err = lib.mpt_trace_instanced_closest(
        n, p(origin), p(direction), float(t_min), p(t_max), p(exclude_mesh),
        p(exclude_prim), tab.count, p(tab.table), p(tab.nodes), p(tab.recs),
        tlas.node_count, p(tlas.nodes), p(tlas.boxes), tlas.pad,
        p(out_t), p(out_tri), p(out_u), p(out_v), p(out_inst), p(scratch),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "mpt_trace_instanced_closest")
    trace_instanced_closest.launches += 1
    return out_t, out_tri, out_u, out_v, out_inst


def trace_instanced_any(origin, direction, t_min: float, t_max, groups):
    """Occlusion flag per ray over every placement of the instanced
    ``groups``: (N,) bool, a triangle at t in [t_min, t_max). CPU tensors
    take the plain version; CUDA tensors launch
    ``trace_instanced_any_kernel`` once, the TLAS walk."""
    n = origin.shape[0]
    dev = origin.device
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (n,)).contiguous()
    if dev.type == "cpu":
        return trace_instanced_any_reference(origin, direction, float(t_min),
                                             t_max, groups)
    if dev.type != "cuda":
        raise ValueError(f"trace_instanced_any: unsupported device {dev}")
    tab, tlas = _instance_layout("trace_instanced_any", groups, dev,
                                 [origin, direction, t_max])
    out = torch.empty(n, dtype=torch.bool, device=dev)
    scratch = build.list_scratch(n, dev)
    lib = build.load()
    p = lambda x: x.data_ptr()
    err = lib.mpt_trace_instanced_any(
        n, p(origin), p(direction), float(t_min), p(t_max), tab.count,
        p(tab.table), p(tab.nodes), p(tab.recs), tlas.node_count,
        p(tlas.nodes), p(tlas.boxes), tlas.pad, p(out), p(scratch),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "mpt_trace_instanced_any")
    trace_instanced_any.launches += 1
    return out


#: instanced K1 launches since the last reset (one per trace, whatever the
#: number of placements)
trace_instanced_closest.launches = 0
trace_instanced_any.launches = 0
