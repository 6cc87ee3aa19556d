"""K1's layout: the packed nodes (32 bytes) and the leaf-ordered slot
records (48 bytes) against the ``BvhSoA``/``TrianglesSoA`` arrays they are
built from, and the plain walks that read them against the JAX package's
``trace_triangles`` and against the walk over the SoA arrays that K1 made
before the layout (kept here as ``_soa_walk``).

Two meshes (a subdivision-3 and a shifted subdivision-2 displaced
icosphere, 1,600 triangles) so that the mesh index varies; 4,096 probes
with every other lane dead (t_max 0), a quarter of the live ones with a
short window, and an eighth excluding the triangle they hit first. Two
JAX calls, each reused."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from metal_pathtracer_tpu import constants as C
from metal_pathtracer_tpu.ops import traversal as jax_traversal
from metal_pathtracer_tpu.scene.resources import Material as JMaterial
from metal_pathtracer_tpu.scene.resources import SceneResources as JResources
from metal_pathtracer_tpu.utils.procgen import dragon_class_scene_mesh
from metal_pathtracer_tpu_torch.constants import INFINITY_T
from metal_pathtracer_tpu_torch.ops.kernels import traverse
from metal_pathtracer_tpu_torch.ops.vecmath import cross, dot
from metal_pathtracer_tpu_torch.scene.resources import (
    Material,
    Mesh,
    SceneResources,
)
from metal_pathtracer_tpu_torch.schema import BvhSoA

N = 4096


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.fixture(scope="module")
def case():
    a = dragon_class_scene_mesh(3, material=0)
    b = dragon_class_scene_mesh(2, material=0)
    b = dataclasses.replace(b, name="shifted", vertices=(
        b.vertices + np.float32([2.2, 0.3, -0.4])).astype(np.float32))
    jr, pr = JResources(), SceneResources()
    jr.add_material(JMaterial(base_color=(0.7, 0.7, 0.7)))
    pr.add_material(Material(base_color=(0.7, 0.7, 0.7)))
    for m in (a, b):
        jr.add_mesh(m)
        pr.add_mesh(Mesh(**{f.name: getattr(m, f.name)
                            for f in dataclasses.fields(Mesh)}))
    js, ps = jr.build_arrays(), pr.build_arrays(device="cpu")
    rng = np.random.default_rng(11)
    o = rng.uniform(-3.5, 3.5, (N, 3)).astype(np.float32)
    v0 = ps.triangles.v0.numpy()
    target = rng.uniform(v0.min(0), v0.max(0), (N, 3)).astype(np.float32)
    d = target - o
    d[N // 2:] = rng.normal(size=(N // 2, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tmax = np.full(N, INFINITY_T, np.float32)
    tmax[1::8] = rng.uniform(0.5, 4.0, N // 8).astype(np.float32)
    tmax[::2] = 0.0
    trace = jax.jit(lambda o, d, tm, em, ep: jax_traversal.trace_triangles(
        o, d, js, C.EPSILON_T, tm, exclude_mesh=em, exclude_prim=ep))
    none = np.full(N, -1, np.int32)
    # the any-hit flags' reference: the hit flag without exclusion
    plain = trace(o, d, tmax, none, none)
    hit0 = np.asarray(plain.hit)
    ex_prim = none.copy()
    ex_prim[1::8] = np.where(hit0[1::8],
                             np.asarray(plain.prim_index)[1::8], -1)
    ex_mesh = np.where(ex_prim >= 0, ps.triangles.mesh_index.numpy()[
        np.maximum(ex_prim, 0)], -1).astype(np.int32)
    ref = trace(o, d, tmax, ex_mesh, ex_prim)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    return dict(ps=ps, o=t(o), d=t(d), tmax=t(tmax), ex_mesh=t(ex_mesh),
                ex_prim=t(ex_prim), none=t(none), plain=plain, ref=ref)


def _soa_walk(origin, direction, t_min, t_max, bvh, tris, ex_mesh, ex_prim,
              first_hit=False):
    """The exit-link walk over the SoA arrays as K1 read them before the
    packed layout: bounds, counts, offsets and exit links per node,
    ``prim_indices`` per slot, three vertices and ``mesh_index`` per
    triangle. Returns ((t, tri, u, v), the four counting totals)."""
    n = origin.shape[0]
    n_nodes, n_slots = bvh.node_count, bvh.prim_indices.shape[0]
    inv_dir = 1.0 / torch.where(direction.abs() < 1e-20,
                                torch.where(direction >= 0, 1e-20, -1e-20),
                                direction)
    best_t = t_max.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32)
    best_u, best_v = torch.zeros(n), torch.zeros(n)
    ar = torch.arange(traverse.MAX_LEAF)
    live = torch.arange(n)[t_max >= t_min]
    node = torch.zeros_like(live)
    left_sib = bvh.left_sibling().long()
    prev = torch.full_like(node, -1)
    prev_hit = torch.zeros_like(node, dtype=torch.bool)
    counts = [0, 0, 0, 0]
    while live.numel():
        o, inv = origin[live], inv_dir[live]
        t0 = (bvh.bounds_min[node] - o) * inv
        t1 = (bvh.bounds_max[node] - o) * inv
        lo = torch.clamp_min(torch.minimum(t0, t1), t_min)
        hi = torch.maximum(t0, t1)
        tnear = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
        tfar = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
        box = torch.minimum(tfar, best_t[live]) >= tnear
        pcount = bvh.prim_count[node]
        leaf = box & (pcount > 0)
        ls = left_sib[node]
        counts[0] += int(node.numel())
        counts[1] += int(leaf.sum())
        counts[2] += int(((ls >= 0) & box & ~((prev == ls) & ~prev_hit)).sum())
        prev, prev_hit = node, box
        if bool(leaf.any()):
            li = live[leaf]
            slot = torch.clamp(bvh.prim_offset[node[leaf], None] + ar, 0,
                               n_slots - 1)
            ids = bvh.prim_indices[slot].long()
            v0 = tris.v0[ids]
            e1, e2 = tris.v1[ids] - v0, tris.v2[ids] - v0
            dd = direction[li][:, None, :].expand_as(e1)
            pvec = cross(dd, e2)
            det = dot(e1, pvec)
            inv_det = 1.0 / torch.where(det.abs() < 1e-8, 1.0, det)
            tvec = origin[li][:, None, :] - v0
            u = dot(tvec, pvec) * inv_det
            qvec = cross(tvec, e1)
            v = dot(dd, qvec) * inv_det
            t = dot(e2, qvec) * inv_det
            excl = ((tris.mesh_index[ids] == ex_mesh[li][:, None])
                    & (ids == ex_prim[li][:, None]))
            in_leaf = ar < pcount[leaf][:, None]
            valid = ((det.abs() >= 1e-8) & (u >= 0.0) & (u <= 1.0)
                     & (v >= 0.0) & (u + v <= 1.0) & (t >= t_min)
                     & (t <= best_t[li][:, None]) & ~excl & in_leaf)
            if first_hit:
                accept = valid & (t < best_t[li][:, None])
                first = torch.where(accept.any(-1), accept.int().argmax(-1),
                                    traverse.MAX_LEAF)
                in_leaf &= ar <= first[:, None]
                valid &= ar <= first[:, None]
            counts[3] += int(in_leaf.sum())
            tm = torch.where(valid, t, INFINITY_T)
            k = torch.argmin(tm, -1, keepdim=True)
            t_hit = tm.gather(-1, k)[:, 0]
            better = valid.any(-1) & (t_hit < best_t[li])
            upd = li[better]
            best_t[upd] = t_hit[better]
            best_tri[upd] = ids.gather(-1, k)[better, 0].int()
            best_u[upd] = u.gather(-1, k)[better, 0]
            best_v[upd] = v.gather(-1, k)[better, 0]
        node = torch.where(box & (pcount == 0), node + 1,
                           bvh.exit_index[node].long())
        more = node < n_nodes
        if first_hit:
            more &= best_tri[live] < 0
        live, node = live[more], node[more]
        prev, prev_hit = prev[more], prev_hit[more]
    return (best_t, best_tri, best_u, best_v), torch.tensor(counts)


def test_packed_nodes_unpack_to_the_soa_arrays(case):
    bvh = case["ps"].tri_bvh
    nodes = bvh.packed_nodes()
    assert nodes.shape == (bvh.node_count, 8) and nodes.dtype == torch.float32
    assert nodes.element_size() * nodes.shape[1] == 32
    assert bvh.packed_nodes() is nodes
    ints = nodes.view(torch.int32)
    for got, want in ((nodes[:, 0:3], bvh.bounds_min),
                      (nodes[:, 4:7], bvh.bounds_max)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(ints[:, 3], bvh.exit_index)
    assert torch.equal(ints[:, 7] >> 3, bvh.prim_offset)
    assert torch.equal(ints[:, 7] & 7, bvh.prim_count)
    assert set(bvh.prim_count.tolist()) == {0, 1, 2, 3, 4}
    last = int(torch.argmax(bvh.prim_offset))
    assert int(ints[last, 7] >> 3) == bvh.prim_indices.shape[0] - int(
        bvh.prim_count[last])


def test_packed_nodes_field_limits():
    """The largest offset and count that fit pack and unpack exactly; one
    past either raises."""
    def tree(offset, count):
        f = lambda *v: torch.tensor([v], dtype=torch.float32)
        i = lambda v: torch.tensor([v], dtype=torch.int32)
        return BvhSoA(bounds_min=f(-1.0, -2.0, -3.0),
                      bounds_max=f(1.0, 2.0, 3.0), prim_offset=i(offset),
                      prim_count=i(count), exit_index=i(1),
                      prim_indices=torch.zeros(4, dtype=torch.int32))

    meta = tree((1 << 28) - 1, 7).packed_nodes().view(torch.int32)[0, 7]
    assert int(meta >> 3) == (1 << 28) - 1 and int(meta & 7) == 7
    for offset, count in ((1 << 28, 1), (0, 8), (-1, 1)):
        with pytest.raises(ValueError):
            tree(offset, count).packed_nodes()


def test_slot_records_hold_each_slots_triangle(case):
    bvh, tris = case["ps"].tri_bvh, case["ps"].triangles
    recs = bvh.slot_records(tris)
    assert recs.shape == (bvh.prim_indices.shape[0], 12)
    assert recs.element_size() * recs.shape[1] == 48
    assert bvh.slot_records(tris) is recs
    tid = bvh.prim_indices.long()
    ints = recs.view(torch.int32)
    assert torch.equal(ints[:, 3], bvh.prim_indices)
    assert torch.equal(ints[:, 7], tris.mesh_index[tid])
    assert set(ints[:, 7].tolist()) == {0, 1}
    v0 = tris.v0[tid]
    for got, want in ((recs[:, 0:3], v0), (recs[:, 4:7], tris.v1[tid] - v0),
                      (recs[:, 8:11], tris.v2[tid] - v0)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not ints[:, 11].any()
    # another triangle set gets its own records
    other = dataclasses.replace(tris, v0=tris.v0 + 1.0)
    assert not torch.equal(bvh.slot_records(other), recs)


def test_plain_walk_matches_jax_and_the_soa_walk(case):
    """(t, tri, u, v) of the plain walk over the packed layout equal JAX
    trace_triangles' bit for bit, dead lanes, short windows and the
    exclusion included, and equal the SoA walk's with the same four
    counting totals."""
    ps, ref = case["ps"], case["ref"]
    args = (case["o"], case["d"], C.EPSILON_T, case["tmax"], ps.tri_bvh,
            ps.triangles, case["ex_mesh"], case["ex_prim"])
    walk = {}
    got = traverse.trace_closest_reference(*args, walk=walk)
    hit = np.asarray(ref.hit)
    live = case["tmax"].numpy() > 0
    assert 0.2 < hit[live].mean() < 0.8 and (case["ex_prim"] >= 0).sum() > 50
    np.testing.assert_array_equal(
        got[1].numpy(), np.where(hit, np.asarray(ref.prim_index), -1))
    np.testing.assert_array_equal(_bits(got[0].numpy()[hit]),
                                  _bits(np.asarray(ref.t)[hit]))
    np.testing.assert_array_equal(
        _bits(np.stack([got[2].numpy(), got[3].numpy()], -1)),
        _bits(np.asarray(ref.barycentric)))
    old, totals = _soa_walk(*args)
    for a, b in zip(got, old):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b)
    assert torch.equal(traverse.walk_totals(walk, "cpu"), totals)


def test_plain_any_hit_matches_jax_and_the_soa_walk(case):
    """The any-hit flags over the packed layout equal JAX's hit flag
    without exclusion and the SoA walk's first-hit flags, with the same
    four counting totals."""
    ps = case["ps"]
    args = (case["o"], case["d"], C.EPSILON_T, case["tmax"], ps.tri_bvh,
            ps.triangles)
    walk = {}
    occ = traverse.trace_any_reference(*args, walk=walk)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(case["plain"].hit))
    old, totals = _soa_walk(*args, case["none"], case["none"],
                            first_hit=True)
    assert torch.equal(occ, old[1] >= 0)
    assert torch.equal(traverse.walk_totals(walk, "cpu"), totals)
    assert occ.any() and not occ[case["tmax"] > 0].all()
