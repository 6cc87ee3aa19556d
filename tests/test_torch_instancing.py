"""Mesh instancing at the trace level: the port's instanced groups, its
object-space ray mapping, ``trace_instanced`` / ``trace_instanced_occluded``
(the instanced K1's plain versions), the merged fold and the instanced
hit record, each against the JAX package run under ``jax.jit`` (the
render is jitted, and XLA:CPU rounds jitted and eager code differently).

Scenes are ``tests/test_trace_merged.py:_random_scene``'s: a soup of 40
triangles (or none), spheres, rectangles and two placements of an
8-triangle object, plus a case where a placement repeats a soup mesh
exactly, so that soup and instance tie at equal t. Half the rays aim at
placed triangles. Traces (t, object triangle, u, v, instance id) and
occlusion are held bit for bit; the record's point, front flag, material
and ids too, and its normals within 2 ulps: XLA:CPU's ``1/sqrt`` is the
x86 estimate plus Newton steps (ROADMAP Queue 3), the port's IEEE. No
JAX integrator call; ~20 s.
"""

import math
import sys
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_pathtracer_tpu import constants as JC
from metal_pathtracer_tpu.ops import intersect as jax_intersect
from metal_pathtracer_tpu.ops import traversal as jax_traversal
from metal_pathtracer_tpu.scene import dsl as jax_dsl
from metal_pathtracer_tpu.scene.meshload import mesh_loader as jax_loader
from metal_pathtracer_tpu.scene.resources import Mesh as JMesh
from metal_pathtracer_tpu.scene.resources import SceneResources as JResources
from metal_pathtracer_tpu.settings import RenderSettings as JSettings
from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch import convert
from metal_pathtracer_tpu_torch.ops import intersect, traversal
from metal_pathtracer_tpu_torch.ops.kernels import traverse
from metal_pathtracer_tpu_torch.scene import dsl
from metal_pathtracer_tpu_torch.scene.resources import (
    Material,
    Mesh,
    Rect,
    SceneResources,
    Sphere,
)
from metal_pathtracer_tpu_torch.settings import RenderSettings

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_scene import _np  # noqa: E402
from test_trace_merged import _random_scene  # noqa: E402

N_RAYS = 512


def _port_resources(jr):
    """The JAX resources' meshes, spheres, rects, materials and placements
    in the port's containers (each source object shared as in ``jr``)."""
    pr = SceneResources()
    for m in jr.materials:
        pr.add_material(Material(mat_type=m.mat_type,
                                 base_color=m.base_color))
    mesh = lambda m: Mesh(m.name, m.vertices, m.normals, m.uv0, m.uv1,
                          m.tangents, m.indices, m.material)
    pr.meshes = [mesh(m) for m in jr.meshes]
    pr.spheres = [Sphere(s.center, s.radius, s.material) for s in jr.spheres]
    pr.rects = [Rect(r.corner, r.edge_u, r.edge_v, r.normal, r.material,
                     r.two_sided) for r in jr.rects]
    sources = {}
    for inst in jr.mesh_instances:
        src = sources.setdefault(id(inst.source), mesh(inst.source))
        pr.add_mesh_instance(src, inst.transform, inst.material)
    return pr


def _tie_scene():
    """Soup meshes placed again as instances with the identity transform
    (object rays equal world rays bit for bit, so t ties exactly), twice
    (the two placements tie too), beside a rotated, scaled placement."""
    rng = np.random.default_rng(7)
    jr = _random_scene(rng, n_tris=24, n_spheres=3, n_rects=2,
                       instanced=False)
    src = jr.meshes[0]
    jr.add_mesh_instance(src, np.eye(4), 0)
    jr.add_mesh_instance(src, np.eye(4), 0)
    c, s = math.cos(0.4), math.sin(0.4)
    m = np.eye(4)
    m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) * 0.6
    m[:3, 3] = [0.5, -1.0, 2.0]
    jr.add_mesh_instance(JMesh(**{**vars(src), "name": "other"}), m, 0)
    return jr


CASES = {"soup+prims": lambda: _random_scene(np.random.default_rng(0)),
         "no-soup": lambda: _random_scene(np.random.default_rng(2),
                                          n_tris=0),
         "soup-only-tris": lambda: _random_scene(np.random.default_rng(5),
                                                 n_spheres=0, n_rects=0),
         "ties": _tie_scene}


def _rays(jscene, seed, group=-1):
    """N_RAYS rays: half aimed at random points of the triangles of one
    group's placements, half at random; float32 numpy."""
    rng = np.random.default_rng(100 + seed)
    o = rng.uniform(-8, 8, (N_RAYS, 3))
    d = rng.normal(size=(N_RAYS, 3))
    g = jscene.instanced[group]
    tris = np.asarray(g.triangles.shade_packed)[:, :9].reshape(-1, 3, 3)
    l2w = np.asarray(g.l2w)
    h = N_RAYS // 2
    k = rng.integers(0, g.count, h)
    b = rng.dirichlet([1.0, 1.0, 1.0], h)
    p_l = (b[:, :, None] * tris[rng.integers(0, len(tris), h)]).sum(1)
    p_w = np.einsum("nij,nj->ni", l2w[k][:, :, :3], p_l) + l2w[k][:, :, 3]
    d[:h] = p_w - o[:h]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jr = CASES[request.param]()
    js = jr.build_arrays()
    pr = _port_resources(jr)
    ps = pr.build_arrays(device="cpu")
    o, d = _rays(js, sorted(CASES).index(request.param),
                 0 if request.param == "ties" else -1)
    return dict(name=request.param, jr=jr, js=js, pr=pr, ps=ps, o=o, d=d)


_JIT_INSTANCED = jax.jit(
    lambda o, d, tm, em, ep, sc: jax_traversal.trace_instanced(
        o, d, sc, JC.EPSILON_T, tm, em, ep))
_JIT_OCCLUDED = jax.jit(
    lambda o, d, tm, sc: jax_traversal.trace_instanced_occluded(
        o, d, sc, JC.EPSILON_T, tm))
_JIT_SCENE = jax.jit(
    lambda o, d, tm, em, ep, sc: jax_intersect.trace_scene(
        o, d, sc, JC.EPSILON_T, tm, em, ep))
_JIT_SCENE_OCC = jax.jit(
    lambda o, d, tm, sc: jax_intersect.trace_occluded(
        o, d, sc, JC.EPSILON_T, tm))


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ia, ib = a.view(np.int32).astype(np.int64), b.view(np.int32).astype(
        np.int64)
    ia = np.where(ia < 0, np.int64(-(2 ** 31)) - ia, ia)
    ib = np.where(ib < 0, np.int64(-(2 ** 31)) - ib, ib)
    return np.abs(ia - ib)


def _assert_records(got, want, point_ulps=0, origin=None):
    """A port ``HitRecord`` against a JAX one on the hit lanes: flags, ids,
    t and barycentrics bit for bit. On triangle lanes (soup and
    instanced) normals within 2 ulps (XLA:CPU's rsqrt) and points within
    ``point_ulps`` of their magnitude, or of the ray origin's where
    that is larger (how XLA:CPU contracts an (N,3)
    ``o + t d`` depends on the jitted program around it: all three
    components inside ``trace_scene`` and ``trace_instanced``, where the
    port's placement comes from; x and y only in ``_trace_group`` jitted
    alone). Sphere and rectangle lanes, whose records the port builds as
    before, hold their points within 2 ulps of the magnitude and their
    normals within 1e-5 (``test_torch_primitives``' sphere rounding)."""
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    for f in ("t", "prim_type", "prim_index", "mesh_index", "material",
              "front_face", "two_sided", "barycentric"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[hit],
                                      np.asarray(getattr(want, f))[hit],
                                      err_msg=f)
    tri = hit & (np.asarray(want.prim_type) == JC.PRIMITIVE_TRIANGLE)
    prim = hit & ~tri
    for f in ("normal", "shading_normal"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert _ulps(a[tri], b[tri]).max(initial=0) <= 2, f
        assert (np.abs(a - b)[prim] <= 1e-5).all(), f
    a, b = got.point.numpy(), np.asarray(want.point)
    mag = np.abs(b).max(-1, keepdims=True)
    if origin is not None:
        mag = np.maximum(mag, np.abs(origin).max(-1, keepdims=True))
    mag = np.spacing(mag)
    assert (np.abs(a - b)[tri] <= point_ulps * mag[tri]).all()
    assert (np.abs(a - b)[prim] <= 2 * mag[prim]).all()


def test_groups_match_jax(case):
    """The port's groups, built from its own resources and converted from
    the JAX package's, equal JAX ``build_arrays().instanced`` field for
    field, bit for bit."""
    js, ps = case["js"], case["ps"]
    conv = convert.scene_arrays(
        {"materials": _np(js.materials),
         "instanced": [_np(g) for g in js.instanced]}, "cpu")
    assert len(ps.instanced) == len(js.instanced) == len(conv.instanced)
    for g, cg, jg in zip(ps.instanced, conv.instanced, js.instanced):
        assert (g.base_id, g.count) == (jg.base_id, jg.count) == \
            (cg.base_id, cg.count)
        for port in (g, cg):
            for f in ("l2w", "w2l", "nrm_mat", "material"):
                np.testing.assert_array_equal(getattr(port, f).numpy(),
                                              np.asarray(getattr(jg, f)))
            for part in ("triangles", "tri_bvh"):
                pp, jp = getattr(port, part), getattr(jg, part)
                for f in vars(pp):
                    if f.startswith("_"):
                        continue
                    np.testing.assert_array_equal(
                        getattr(pp, f).numpy(), np.asarray(getattr(jp, f)),
                        err_msg=f"{part}.{f}")
    if case["name"] == "no-soup":
        assert ps.triangles is None and js.triangles is None
        assert ps.n_triangles == 0


def test_object_ray_placement_matches_jit():
    """The world -> object mapping (``traverse.object_ray``) against
    jitted ``_transform_point``/``_transform_dir`` on 65,536 random rays
    and matrices: every component bit for bit (a 3-term dot contracted
    as ``fma(p2, m2, fma(p1, m1, p0 m0))``, then the translation)."""
    rng = np.random.default_rng(11)
    n = 65536
    o = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    for k in range(4):
        m = rng.normal(size=(3, 4)).astype(np.float32) * (1.0 + 3 * k)
        jo = jax.jit(jax_traversal._transform_point)(jnp.asarray(m), o)
        jd = jax.jit(jax_traversal._transform_dir)(jnp.asarray(m), d)
        po, pd = traverse.object_ray(torch.from_numpy(m),
                                     torch.from_numpy(o),
                                     torch.from_numpy(d))
        np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))


def _traces(case, tmax, em, ep):
    o, d = case["o"], case["d"]
    jrec = _JIT_INSTANCED(o, d, tmax, em, ep, case["js"])
    t = lambda x: torch.from_numpy(np.asarray(x))
    prec = traversal.trace_instanced(t(o), t(d), case["ps"], JC.EPSILON_T,
                                     t(tmax), t(em), t(ep))
    return prec, jrec


def test_trace_instanced_matches_jit(case):
    """``trace_instanced`` (the instanced K1's plain version and the
    record) against jitted JAX: once without exclusions, then from each
    hit point along the same ray excluding the hit (global instance id,
    object triangle), with half the lanes dead (t_max 0): t, object
    triangle, u, v and instance id bit for bit."""
    n = N_RAYS
    tmax = np.full(n, JC.INFINITY_T, np.float32)
    none = np.full(n, -1, np.int32)
    prec, jrec = _traces(case, tmax, none, none)
    _assert_records(prec, jrec)
    assert np.asarray(jrec.hit).sum() > n // 4
    # the second trace: from the hit points, the hits excluded
    hit = np.asarray(jrec.hit)
    em = np.where(hit, np.asarray(jrec.mesh_index), -1).astype(np.int32)
    ep = np.where(hit, np.asarray(jrec.prim_index), -1).astype(np.int32)
    case2 = dict(case, o=np.where(hit[:, None], np.asarray(jrec.point),
                                  case["o"]).astype(np.float32))
    tmax2 = np.where(np.arange(n) % 2 == 0, JC.INFINITY_T, 0.0).astype(
        np.float32)
    prec2, jrec2 = _traces(case2, tmax2, em, ep)
    _assert_records(prec2, jrec2)
    # the excluded triangle of a placement is hit by no second trace of
    # the same lane, unless from another placement
    same = np.asarray(jrec2.hit) & (np.asarray(jrec2.mesh_index) == em) \
        & (np.asarray(jrec2.prim_index) == ep)
    assert not same.any()


def test_trace_instanced_occluded_matches_jit(case):
    """``trace_instanced_occluded`` (the instanced any-hit's plain
    version) against jitted JAX, and the merged ``trace_occluded``
    against JAX ``intersect.trace_occluded``: flags bit for bit, with
    windows cut short on some lanes and dead on others."""
    rng = np.random.default_rng(3)
    tmax = rng.choice([0.0, 2.0, 6.0, JC.INFINITY_T], N_RAYS).astype(
        np.float32)
    o, d = case["o"], case["d"]
    want = np.asarray(_JIT_OCCLUDED(o, d, tmax, case["js"]))
    t = lambda x: torch.from_numpy(np.asarray(x))
    got = traversal.trace_instanced_occluded(t(o), t(d), case["ps"],
                                             JC.EPSILON_T, t(tmax))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < N_RAYS
    want = np.asarray(_JIT_SCENE_OCC(o, d, tmax, case["js"]))
    got = intersect.trace_occluded(t(o), t(d), case["ps"], JC.EPSILON_T,
                                   t(tmax))
    np.testing.assert_array_equal(got.numpy(), want)


def test_fold_matches_trace_scene(case):
    """``trace_merged``/``trace_scene`` against JAX ``trace_scene``:
    spheres, rectangles, soup triangles, then instances, each later family
    taking a lane only when strictly nearer. On the tie scene soup and
    placement (and two placements) meet at equal t: the soup triangle
    wins, then the earlier placement."""
    n = N_RAYS
    o, d = case["o"], case["d"]
    tmax = np.full(n, JC.INFINITY_T, np.float32)
    none = np.full(n, -1, np.int32)
    want = _JIT_SCENE(o, d, tmax, none, none, case["js"])
    t = lambda x: torch.from_numpy(np.asarray(x))
    got = intersect.trace_scene(t(o), t(d), case["ps"], JC.EPSILON_T,
                                t(tmax), t(none), t(none))
    _assert_records(got, want)
    _, idx, _, _, kind = intersect.trace_merged(
        t(o), t(d), case["ps"], JC.EPSILON_T, t(tmax), t(none), t(none))
    inst = (kind >= intersect.KIND_INSTANCE).numpy()
    base = case["ps"].instanced[0].base_id
    np.testing.assert_array_equal(
        np.asarray(want.mesh_index)[inst],
        (kind - intersect.KIND_INSTANCE).numpy()[inst] + base)
    if case["name"] == "ties":
        # rays that hit the soup mesh: its identity placements tie at the
        # same t, and the soup keeps them
        inst_t = traversal.trace_instanced(t(o), t(d), case["ps"],
                                           JC.EPSILON_T, t(tmax))
        soup = (kind == C.PRIMITIVE_TRIANGLE).numpy()
        ties = soup & (inst_t.t.numpy() == got.t.numpy())
        assert ties.sum() > 20
        # of the two identity placements the first keeps the tie
        assert (inst_t.mesh_index.numpy()[ties] == base).all()
    else:
        assert inst.sum() > 0


def test_instanced_record_matches_trace_group():
    """The instanced record against JAX ``_trace_group``'s under
    ``jax.jit`` on one placement of the soup-and-primitives scene:
    point, front flag, material, ids and barycentrics bit for bit,
    normals within 2 ulps (XLA:CPU's rsqrt), the point within 1 ulp (see
    ``_assert_records``: jitted alone, ``_trace_group`` leaves z unfused;
    the traces the render runs fuse it, as the port does)."""
    jr = _random_scene(np.random.default_rng(0))
    js = jr.build_arrays()
    ps = _port_resources(jr).build_arrays(device="cpu")
    o, d = _rays(js, 9)
    g = js.instanced[0]
    i = 1
    gid = g.base_id + i

    def group(o_w, d_w, grp):
        o_l = jax_traversal._transform_point(grp.w2l[i], o_w)
        d_l = jax_traversal._transform_dir(grp.w2l[i], d_w)
        return jax_traversal._trace_group(
            grp, o_l, d_l, o_w, d_w, JC.EPSILON_T,
            jnp.full(o_w.shape[:1], JC.INFINITY_T, jnp.float32),
            jnp.full(o_w.shape[:1], -1, jnp.int32), gid)

    want = jax.jit(group)(o, d, g)
    hit = np.asarray(want.hit)
    assert hit.sum() > 50
    t, tri, bary = (torch.tensor(np.asarray(x)) for x in (
        want.t, want.prim_index, want.barycentric))
    inst = torch.where(torch.tensor(hit), i, -1).to(torch.int32)
    got = traversal.instanced_record(
        torch.from_numpy(o), torch.from_numpy(d), t, tri, bary[:, 0],
        bary[:, 1], inst,
        ps.instanced)
    _assert_records(got, want, point_ulps=1, origin=o)


def test_instanced_dsl_token(tmp_path):
    """``tests/test_instancing.py test_instanced_dsl_token`` through the
    port's loader: two ``instanced=1`` records of one OBJ share one
    object-space mesh and build one group of two placements, equal to the
    JAX package's."""
    path = tmp_path / "tri.obj"
    path.write_text("v -1 0 -1\nv 1 0 -1\nv 0 1 -1\nf 1 2 3\n")
    text = f"""\
camera target=0,0,-1 distance=3 yaw=0 pitch=0 vfov=45
material type=lambert albedo=0.8,0.2,0.2
mesh path={path} material=0 instanced=1 translate=-0.8,0,0
mesh path={path} material=0 instanced=1 translate=0.8,0,0 scale=0.5
"""
    res = SceneResources()
    dsl.parse_scene(text, RenderSettings(), res,
                    scene_directory=str(tmp_path))
    jres = JResources()
    jax_dsl.parse_scene(text, JSettings(), jres,
                        scene_directory=str(tmp_path),
                        mesh_loader=jax_loader)
    assert len(res.mesh_instances) == 2
    assert res.mesh_instances[0].source is res.mesh_instances[1].source
    scene = res.build_arrays(device="cpu")
    assert len(scene.instanced) == 1 and scene.instanced[0].count == 2
    jg = jres.build_arrays().instanced[0]
    for f in ("w2l", "nrm_mat", "l2w"):
        np.testing.assert_array_equal(getattr(scene.instanced[0], f).numpy(),
                                      np.asarray(getattr(jg, f)))
