"""The instanced K1's two-level walk on the CPU: ``schema.InstanceTlas``
(a median-split tree over the placements' padded world boxes, in K1's
node layout) and the kernels' walk order in plain PyTorch
(``trace_instanced_closest_tlas_reference``,
``trace_instanced_any_tlas_reference``) against the sequential walks
that stay the kernels' plain versions.

- the tree: every placement in one leaf of <= 4, exit links and right
  children consistent, interior boxes holding their children's, depth
  within the kernel's stack;
- the padding (hypothesis over rotations, non-uniform scales and
  translations): every hit a placement's own walk finds lies, mapped to
  world space in float64, inside its padded box grown by the lane's pad,
  and the box's padded slab test passes at that hit's t;
- the walk order: (t, tri, u, v, placement) and occlusion bit for bit
  equal to the sequential walks on coincident placements (every hit a
  tie), touching placements, a toy 8x8 grid of two sources, with
  exclusion ids, grazing rays along the world boxes' faces, dead lanes
  and short windows; on the grid, both against jitted JAX
  ``trace_instanced`` / ``trace_instanced_occluded`` (the file's two JAX
  calls).

No integrator call; ~70 s.
"""

import math
import os
import sys

import jax
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from metal_pathtracer_tpu import constants as JC
from metal_pathtracer_tpu.ops import traversal as jax_traversal
from metal_pathtracer_tpu.scene.resources import Material as JMaterial
from metal_pathtracer_tpu.scene.resources import Mesh as JMesh
from metal_pathtracer_tpu.scene.resources import SceneResources as JResources
from metal_pathtracer_tpu_torch.ops.kernels import traverse as T
from metal_pathtracer_tpu_torch.schema import (
    TLAS_LEAF,
    TLAS_STACK,
    instance_tlas,
)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_instancing import _port_resources  # noqa: E402

T_MIN = JC.EPSILON_T
N_RAYS = 768


def _icosahedron(name, material=0, radius=0.5):
    """A 20-triangle icosahedron about the origin (JAX ``Mesh``)."""
    p = (1.0 + math.sqrt(5.0)) / 2.0
    v = np.array([[-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0],
                  [0, -1, p], [0, 1, p], [0, -1, -p], [0, 1, -p],
                  [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1]],
                 np.float64)
    v = (v / np.linalg.norm(v, axis=1, keepdims=True) * radius)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 np.int32)
    return _mesh(name, v, f, material)


def _cube(name, material=0):
    """A unit cube's 12 triangles, its faces on its bounding box."""
    v = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
                 np.float64) - 0.5
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                  [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                  [1, 5, 7], [1, 7, 3]], np.int32)
    return _mesh(name, v, f, material)


def _mesh(name, v, f, material):
    v = v.astype(np.float32)
    n = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
    uv = np.zeros((len(v), 2), np.float32)
    return JMesh(name=name, vertices=v, normals=n.astype(np.float32),
                 uv0=uv, uv1=uv.copy(),
                 tangents=np.zeros((len(v), 4), np.float32), indices=f,
                 material=material)


def _transform(axis, angle, scale, translate):
    """local -> world 4x4 (float64): translate . rotate . scale."""
    a = np.asarray(axis, np.float64)
    a = a / max(np.linalg.norm(a), 1e-12)
    c, s = math.cos(angle), math.sin(angle)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    r = np.eye(3) + s * k + (1 - c) * (k @ k)
    m = np.eye(4)
    m[:3, :3] = r @ np.diag(scale)
    m[:3, 3] = translate
    return m


def _scene(placements):
    """JAX resources with each (source, transform) placed, a lambert
    material, no soup; returns (JAX resources, port scene arrays)."""
    jr = JResources()
    jr.add_material(JMaterial(base_color=(0.7, 0.7, 0.7)))
    for src, m in placements:
        jr.add_mesh_instance(src, m, 0)
    return jr, _port_resources(jr).build_arrays(device="cpu")


def _grid_placements(seed=5):
    """The toy grid: an icosahedron 8x8 at scale 0.25 with seeded yaw and
    a cube 4x4 between the rows, non-uniformly scaled."""
    rng = np.random.default_rng(seed)
    ico, cube = _icosahedron("ico"), _cube("cube")
    out = [(ico, _transform((0, 1, 0), rng.uniform(0, 2 * math.pi),
                            (0.25, 0.25, 0.25), (x * 0.3, 0.0, z * 0.3)))
           for x in range(8) for z in range(8)]
    out += [(cube, _transform((0, 1, 0), rng.uniform(0, 2 * math.pi),
                              (0.1, 0.2, 0.05), (x * 0.6 + 0.15, 0.1,
                                                 z * 0.6 + 0.15)))
            for x in range(4) for z in range(4)]
    return out


def _coincident():
    """One source twice with the same transform (every hit a tie) beside
    a third placement of another source."""
    ico, other = _icosahedron("ico"), _icosahedron("other")
    return [(ico, np.eye(4)), (ico, np.eye(4)),
            (other, _transform((1, 0, 0), 0.3, (1, 1, 1), (2, 0, 0)))]


def _touching():
    """Cubes side by side, their boxes touching face to face."""
    cube = _cube("cube")
    return [(cube, _transform((0, 0, 1), 0.0, (1, 1, 1), (float(x), 0, 0)))
            for x in range(5)]


SCENES = {"coincident": _coincident, "touching": _touching,
          "grid": _grid_placements}


def _world_boxes(ps):
    """Each placement's unpadded world box in float64 (flat order)."""
    lo, hi = [], []
    for g in ps.instanced:
        b = g.tri_bvh
        c = np.array([[(b.bounds_max if k >> a & 1 else b.bounds_min)[0, a]
                       .item() for a in range(3)] for k in range(8)])
        for m in g.l2w.double().numpy():
            w = c @ m[:, :3].T + m[:, 3]
            lo.append(w.min(0))
            hi.append(w.max(0))
    return np.array(lo), np.array(hi)


def _rays(ps, seed, n=N_RAYS):
    """n rays: a third aimed at points of placed triangles, a third
    grazing a face of a placement's world box (origin on the face plane,
    no component across it), a third random; float32 torch."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)) + np.array([1.0, 0.5, 1.0])
    d = rng.normal(size=(n, 3))
    third = n // 3
    targets = []
    for _, _, g, i, _ in T.placements(ps.instanced):
        tri = g.triangles.shade_packed[:, :9].numpy().reshape(-1, 3, 3)
        l2w = g.l2w[i].double().numpy()
        p = (rng.dirichlet([1.0] * 3, third)[:, :, None]
             * tri[rng.integers(0, len(tri), third)]).sum(1)
        targets.append(p @ l2w[:, :3].T + l2w[:, 3])
    pick = rng.integers(0, len(targets), third)
    d[:third] = np.stack(targets, 1)[np.arange(third), pick] - o[:third]
    lo, hi = _world_boxes(ps)
    k = rng.integers(0, len(lo), third)
    axis = rng.integers(0, 3, third)
    face = np.where(rng.integers(0, 2, third) == 0, lo[k, axis], hi[k, axis])
    g = np.arange(third, 2 * third)
    centre = (lo[k] + hi[k]) * 0.5
    o[g] = centre + rng.uniform(-1.5, 1.5, (third, 3)) * (hi[k] - lo[k])
    o[g, axis] = face
    d[g] = centre + rng.uniform(-0.5, 0.5, (third, 3)) * (hi[k] - lo[k]) \
        - o[g]
    d[g, axis] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    o[g, axis] = face.astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    jr, ps = _scene(SCENES[request.param]())
    return dict(name=request.param, jr=jr, ps=ps)


def test_tree_structure(scene):
    """Every placement in exactly one leaf of at most ``TLAS_LEAF``; the
    exit links those of a depth-first walk; each interior node's box
    holds its children's, each leaf's its placements' boxes; the depth
    within ``TLAS_STACK``."""
    ps = scene["ps"]
    tlas = instance_tlas(ps.instanced)
    nodes = tlas.nodes.numpy()
    meta = nodes[:, 7].view(np.int32)
    exits = nodes[:, 3].view(np.int32)
    rows = tlas.boxes[:, 3].numpy().view(np.int32)
    k = sum(g.count for g in ps.instanced)
    assert sorted(rows.tolist()) == list(range(k))
    assert tlas.depth <= TLAS_STACK
    assert exits[0] == len(nodes)
    seen = []
    for i, m in enumerate(meta):
        lo, hi = nodes[i, 0:3], nodes[i, 4:7]
        if m & 7:
            assert (m & 7) <= TLAS_LEAF
            part = tlas.boxes.numpy()[(m >> 3):(m >> 3) + (m & 7)]
            seen += list(range(m >> 3, (m >> 3) + (m & 7)))
        else:
            left, right = i + 1, m >> 3
            assert exits[left] == right and exits[right] == exits[i]
            part = nodes[[left, right]]
        assert (lo <= part[:, 0:3]).all() and (hi >= part[:, 4:7]).all()
    assert sorted(seen) == list(range(k))


def test_boxes_are_padded(scene):
    """Each placement's stored box holds its unpadded float64 world box
    with room to spare on every side."""
    ps = scene["ps"]
    tlas = instance_tlas(ps.instanced)
    lo, hi = _world_boxes(ps)
    b = tlas.boxes.double().numpy()
    rows = tlas.boxes[:, 3].numpy().view(np.int32)
    assert (b[:, 0:3] < lo[rows]).all() and (b[:, 4:7] > hi[rows]).all()


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(axis=st.tuples(*[st.floats(-1, 1)] * 3).filter(
           lambda a: sum(x * x for x in a) > 1e-3),
       angle=st.floats(0, 2 * math.pi),
       scale=st.tuples(*[st.floats(0.05, 8.0)] * 3),
       translate=st.tuples(*[st.floats(-40, 40)] * 3),
       seed=st.integers(0, 2 ** 16))
def test_padded_boxes_hold_every_hit(axis, angle, scale, translate, seed):
    """Every hit a placement's own walk finds, mapped back to world space
    in float64 (o + t d), lies inside the placement's stored box grown by
    the lane's pad, and the box's padded slab test (the kernels') passes
    with the window at that hit's t."""
    m = _transform(axis, angle, scale, translate)
    _, ps = _scene([(_cube("cube"), m), (_cube("cube"), np.eye(4))])
    tlas = instance_tlas(ps.instanced)
    o, d = _rays(ps, seed, 192)
    g = ps.instanced[0]
    rows = tlas.boxes[:, 3].numpy().view(np.int32)
    pad = torch.tensor(tlas.pad, dtype=torch.float32) * o.abs().amax(-1)
    inv = 1.0 / torch.where(d.abs() < 1e-20,
                            torch.where(d >= 0, 1e-20, -1e-20), d)
    none = torch.full((o.shape[0],), -1, dtype=torch.int32)
    for q in range(g.count):
        o_l, d_l = T.object_ray(g.w2l[q], o, d)
        t, tri, _, _ = T.trace_closest_reference(
            o_l, d_l, T_MIN, torch.full((o.shape[0],), 1e20), g.tri_bvh,
            g.triangles, none, none)
        hit = tri >= 0
        if not bool(hit.any()):
            continue
        box = tlas.boxes[int(np.nonzero(rows == q)[0][0])]
        p = o.double()[hit] + t.double()[hit, None] * d.double()[hit]
        grown = pad.double()[hit, None]
        assert (p >= box[0:3].double() - grown).all()
        assert (p <= box[4:7].double() + grown).all()
        ok, _ = T._padded_entry(box.expand(int(hit.sum()), 8), o[hit],
                                inv[hit], pad[hit], T_MIN, t[hit])
        assert bool(ok.all())


def _windows(n, seed):
    rng = np.random.default_rng(seed)
    tm = rng.choice([1e20, 1e20, 1e20, 2.5, 0.0], n).astype(np.float32)
    return torch.from_numpy(tm)


def _equal(a, b, label):
    for name, x, y in zip(("t", "tri", "u", "v", "inst"), a, b):
        assert torch.equal(x, y), (label, name, int((x != y).sum()))


@pytest.mark.parametrize("seed", [0, 1])
def test_tlas_walk_equals_sequential(scene, seed):
    """The kernels' walk order against the sequential walks: (t, tri, u, v,
    placement) and occlusion bit for bit, with dead lanes and short
    windows; then a second trace from each hit point excluding that hit
    (global instance id, object triangle). On the coincident scene every
    hit ties and goes to the lower placement."""
    ps = scene["ps"]
    o, d = _rays(ps, 10 + seed)
    n = o.shape[0]
    tm = _windows(n, seed)
    none = torch.full((n,), -1, dtype=torch.int32)
    args = (o, d, T_MIN, tm, ps.instanced)
    want = T.trace_instanced_closest_reference(*args, none, none)
    got = T.trace_instanced_closest_tlas_reference(*args, none, none)
    _equal(got, want, scene["name"])
    hits = int((want[4] >= 0).sum())
    assert hits > n // 6
    if scene["name"] == "coincident":
        assert not bool((want[4] == 1).any())   # the tie goes to placement 0
    assert torch.equal(T.trace_instanced_any_tlas_reference(*args),
                       T.trace_instanced_any_reference(*args))
    # from the hit points, the hits excluded
    hit = want[4] >= 0
    base = ps.instanced[0].base_id
    em = torch.where(hit, want[4] + base, -1).to(torch.int32)
    ep = torch.where(hit, want[1], -1)
    o2 = torch.where(hit[:, None], o + want[0][:, None] * d, o)
    tm2 = torch.where(hit, torch.tensor(1e20), tm)
    args = (o2, d, T_MIN, tm2, ps.instanced, em, ep)
    _equal(T.trace_instanced_closest_tlas_reference(*args),
           T.trace_instanced_closest_reference(*args), scene["name"])


def test_tlas_walk_skips_placements():
    """On the toy grid the two-level walk tests far fewer placement boxes
    and walks far fewer placements than the sequential walk's one a
    placement for every live lane."""
    _, ps = _scene(_grid_placements())
    o, d = _rays(ps, 3)
    n = o.shape[0]
    tm = torch.full((n,), 1e20)
    none = torch.full((n,), -1, dtype=torch.int32)
    walk = {}
    T.trace_instanced_closest_tlas_reference(o, d, T_MIN, tm, ps.instanced,
                                             none, none, walk=walk)
    k = sum(g.count for g in ps.instanced)
    assert walk["placement_walks"] < n * k / 8
    assert int(walk["rows"].sum()) <= k


_JIT_INSTANCED = jax.jit(
    lambda o, d, tm, em, ep, sc: jax_traversal.trace_instanced(
        o, d, sc, JC.EPSILON_T, tm, em, ep))
_JIT_OCCLUDED = jax.jit(
    lambda o, d, tm, sc: jax_traversal.trace_instanced_occluded(
        o, d, sc, JC.EPSILON_T, tm))


def test_grid_matches_jax():
    """On the toy grid the two-level walk against jitted JAX
    ``trace_instanced`` and ``trace_instanced_occluded``: t, object
    triangle, u, v and global instance id of every hit, and occlusion,
    bit for bit."""
    jr, ps = _scene(_grid_placements())
    js = jr.build_arrays()
    o, d = _rays(ps, 21)
    n = o.shape[0]
    tm = _windows(n, 4)
    none = torch.full((n,), -1, dtype=torch.int32)
    t, tri, u, v, inst = T.trace_instanced_closest_tlas_reference(
        o, d, T_MIN, tm, ps.instanced, none, none)
    rec = _JIT_INSTANCED(o.numpy(), d.numpy(), tm.numpy(), none.numpy(),
                         none.numpy(), js)
    hit = np.asarray(rec.hit)
    np.testing.assert_array_equal((inst >= 0).numpy(), hit)
    base = ps.instanced[0].base_id
    for got, want in ((t, rec.t), (tri, rec.prim_index),
                      (inst + base, rec.mesh_index),
                      (u, np.asarray(rec.barycentric)[:, 0]),
                      (v, np.asarray(rec.barycentric)[:, 1])):
        np.testing.assert_array_equal(got.numpy()[hit],
                                      np.asarray(want)[hit])
    assert hit.sum() > n // 6
    occ = T.trace_instanced_any_tlas_reference(o, d, T_MIN, tm, ps.instanced)
    np.testing.assert_array_equal(
        occ.numpy(), np.asarray(_JIT_OCCLUDED(o.numpy(), d.numpy(),
                                              tm.numpy(), js)))


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_by_lane_group(any_hit):
    """The walk model's masks and counts by lane group (three wavefronts
    in one call, as ``chip_smoke.py instanced_k1`` holds a sample's
    launches) equal those of three separate calls, and so do the
    outputs: the TLAS nodes, boxes and rows tested, each group's BLAS
    nodes and slots, the slab, triangle and TLAS tests and the walks."""
    _, ps = _scene(_grid_placements())
    n = 256
    rays = [_rays(ps, 30 + k, n) for k in range(3)]
    tms = [torch.full((n,), 1e20), _windows(n, 9), torch.full((n,), 2.5)]
    none = torch.full((3 * n,), -1, dtype=torch.int32)
    args = (torch.cat([r[0] for r in rays]), torch.cat([r[1] for r in rays]),
            T_MIN, torch.cat(tms), ps.instanced)
    walk = {"lane_group": torch.arange(3).repeat_interleave(n),
            "n_groups": 3}
    if any_hit:
        got = T.trace_instanced_any_tlas_reference(*args, walk=walk)
    else:
        got = T.trace_instanced_closest_tlas_reference(*args, none, none,
                                                       walk=walk)
    for k in range(3):
        one = {}
        part = (rays[k][0], rays[k][1], T_MIN, tms[k], ps.instanced)
        if any_hit:
            want = T.trace_instanced_any_tlas_reference(*part, walk=one)
            assert torch.equal(got[k * n:(k + 1) * n], want)
        else:
            want = T.trace_instanced_closest_tlas_reference(
                *part, none[:n], none[:n], walk=one)
            _equal([x[k * n:(k + 1) * n] for x in got], want, k)
        for key in ("tlas_tests", "placement_walks", "node_visits",
                    "tri_tests"):
            assert int(walk[key][k]) == one[key], key
        for key in ("tlas_nodes", "boxes", "rows"):
            assert torch.equal(walk[key][k], one[key]), key
        assert sorted(walk["groups"]) == sorted(one["groups"])
        for gi, masks in one["groups"].items():
            for key in ("nodes", "slots"):
                assert torch.equal(walk["groups"][gi][key][k], masks[key])
