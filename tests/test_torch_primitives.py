"""The port's analytic primitives against the JAX package.

- The sphere and rectangle SoA, the emissive-rectangle list and the
  materials bit for bit, for the Cornell box, the smoke scene, the rtow
  sphere field and a box scene, each text parsed by both DSLs.
- The plain K3a/K3c versions (``ops/kernels/primitives.py``) against
  ``intersect.hit_spheres``/``hit_rects`` (XLA, jitted as the render runs
  them) and the plain K3a/K3b against the Pallas twins under the
  interpreter (``MPT_PALLAS_INTERPRET=1``, ``MPT_SPHERE_BVH`` choosing the
  route, as ``tests/test_sphere_bvh.py`` does). Indices agree exactly; a
  sphere's t agrees within the rounding of its quadratic (XLA's ``sqrt``
  and the Pallas kernel's ``* (1/a)`` differ from IEEE by an ulp, which
  the cancellation in ``-half_b -+ sqrt(disc)`` scales; see ``_t_tol``).
- ``trace_scene`` and ``trace_occluded`` over every family, with the
  triangle-only self-hit exclusion, against the JAX package's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_pathtracer_tpu import constants as JC
from metal_pathtracer_tpu.ops import intersect as jax_intersect
from metal_pathtracer_tpu.scene import dsl as jax_dsl
from metal_pathtracer_tpu.scene.resources import Material as JMaterial
from metal_pathtracer_tpu.scene.resources import Rect as JRect
from metal_pathtracer_tpu.scene.resources import SceneResources as JResources
from metal_pathtracer_tpu.scene.resources import Sphere as JSphere
from metal_pathtracer_tpu.settings import RenderSettings as JSettings
from metal_pathtracer_tpu.utils.procgen import (
    dragon_class_scene_mesh as jax_dragon_mesh,
)
from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops import intersect
from metal_pathtracer_tpu_torch.ops.kernels import primitives as P
from metal_pathtracer_tpu_torch.scene import dsl
from metal_pathtracer_tpu_torch.scene.resources import SceneResources
from metal_pathtracer_tpu_torch.schema import SpheresSoA
from metal_pathtracer_tpu_torch.settings import RenderSettings
from metal_pathtracer_tpu_torch.utils import benchscene as B

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_EPS = float(np.finfo(np.float32).eps)
N_RAYS = 4096

BOX_SCENE = """\
camera target=0,0.5,0 distance=4 yaw=0.3 pitch=0.2 vfov=40
material type=lambert albedo=0.7,0.6,0.5
material type=light emit=4,4,4
box min=-1,0,-1 max=1,1,1 material=0
box min=-0.3,0,-0.3 max=0.3,0.6,0.3 material=0 translate=0.2,1,0 rotateY=30 includeBottom=0 twoSided=1
rect x=-0.5,0.5 y=2 z=-0.5,0.5 normal=-1 material=1 twoSided=1
rectangle x=-2,2 y=-2,2 z=-3 normal=1 material=1
"""

SCENES = {"cornell": B.cornell_scene_text,
          "smoke": B.SMOKE_PATH.read_text,
          "rtow": lambda: B.rtow_scene_text(0),
          "box": lambda: BOX_SCENE}


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _parse_both(text):
    js, jr = JSettings(), JResources()
    jax_dsl.parse_scene(text, js, jr)
    ps, pr = RenderSettings(), SceneResources()
    dsl.parse_scene(text, ps, pr)
    return (js, jr), (ps, pr)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_soa_equal(port_soa, jax_soa, label):
    for name in port_soa.__dataclass_fields__:
        got = getattr(port_soa, name).numpy()
        want = np.asarray(getattr(jax_soa, name))
        assert got.shape == want.shape, (label, name, got.shape, want.shape)
        np.testing.assert_array_equal(_bits(got), _bits(want),
                                      err_msg=f"{label}.{name}")


def test_scene_texts_are_the_repository_files():
    """The Cornell and smoke builders read the repository's own scene
    files, as the JAX package's DSL reads them."""
    for path, rel, build in (
            (B.CORNELL_PATH, "assets/scenes/cornell.scene",
             B.build_cornell_scene),
            (B.SMOKE_PATH, "tests/scenes/smoke.scene", B.build_smoke_scene)):
        assert os.path.samefile(path, os.path.join(REPO, rel))
        js, jr = JSettings(), JResources()
        jax_dsl.load_scene_file(os.path.join(REPO, rel), js, jr)
        ps, pr = build()
        for key, value in vars(ps).items():
            assert getattr(js, key) == value, (rel, key)
        assert len(pr.spheres) == len(jr.spheres) > 0
        assert [vars(m)["name"] for m in pr.materials] \
            == [vars(m)["name"] for m in jr.materials]
    assert B.cornell_scene_text() == B.CORNELL_PATH.read_text()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_soa_and_light_list_bitexact(name):
    """Spheres, rectangles, the emissive-rectangle list and the materials
    of the same text parsed by both DSLs, bit for bit; the settings the
    DSL sets agree too."""
    (js, jr), (ps, pr) = _parse_both(SCENES[name]())
    jarr, parr = jr.build_arrays(), pr.build_arrays(device="cpu")
    _assert_soa_equal(parr.spheres, jarr.spheres, f"{name}.spheres")
    _assert_soa_equal(parr.rects, jarr.rects, f"{name}.rects")
    _assert_soa_equal(parr.materials, jarr.materials, f"{name}.materials")
    np.testing.assert_array_equal(parr.light_rect_indices.numpy(),
                                  np.asarray(jarr.light_rect_indices))
    for key, value in vars(ps).items():
        assert getattr(js, key) == value, key
    counts = {"cornell": (2, 6, 1), "smoke": (2, 0, 0), "rtow": (487, 0, 0),
              "box": (0, 13, 2)}[name]
    assert (parr.n_spheres, parr.n_rects, parr.n_rect_lights) == counts
    # the chunked kernel's layout is built with the scene above 32 spheres
    assert (parr.sphere_groups is not None) == (name == "rtow")


def _rays(centers, n=N_RAYS, seed=5, spread=3.0, lift=None):
    """Rays from a box around the scene aimed near the primitive centres,
    some with an empty window (t_max 0) and some with t_max 1."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    if lift is not None:
        o[:, 1] = np.abs(o[:, 1]) + lift
    target = centers[rng.integers(0, len(centers), n)] \
        + rng.normal(scale=0.3, size=(n, 3))
    d = (target - o).astype(np.float32)
    d[::5] = rng.normal(size=(len(d[::5]), 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(n, C.INFINITY_T, np.float32)
    tmax[::37] = 0.0
    tmax[5::41] = 1.0
    return o, d.astype(np.float32), tmax


def _t_tol(o, d, center, radius):
    """First-order rounding bound of a sphere's t: each operand of
    (-half_b -+ sqrt(half_b^2 - a c)) / a off by a few ulps of its own
    magnitude, the square root's error growing as 1/sqrt(disc) where the
    discriminant cancels (grazing rays)."""
    o64, d64 = o.astype(np.float64), d.astype(np.float64)
    oc = o64 - center.astype(np.float64)
    a = (d64 * d64).sum(-1)
    half_b = (oc * d64).sum(-1)
    c = (oc * oc).sum(-1) - radius.astype(np.float64) ** 2
    disc = np.maximum(half_b * half_b - a * c, 0.0)
    sq = np.sqrt(disc)
    scale = np.abs(half_b) + sq + (half_b * half_b + np.abs(a * c)) \
        / np.maximum(sq, 1e-30)
    return 8.0 * F32_EPS * scale / a


def _sphere_check(t, idx, t_ref, idx_ref, o, d, centers, radii):
    np.testing.assert_array_equal(idx, idx_ref)
    hit = idx_ref >= 0
    assert (t[~hit] == C.INFINITY_T).all()
    k = idx_ref[hit]
    tol = _t_tol(o[hit], d[hit], centers[k], radii[k])
    err = np.abs(t[hit].astype(np.float64) - t_ref[hit])
    assert (err <= tol).all(), float((err / tol).max())


def _jax_scene(name):
    (_, jr), (_, pr) = _parse_both(SCENES[name]())
    return jr.build_arrays(), pr.build_arrays(device="cpu")


@pytest.mark.parametrize("name", ["cornell", "rtow"])
def test_sphere_nearest_plain_vs_xla(name):
    """K3a's plain version against the jitted ``hit_spheres``; on rtow
    (487 spheres) K3b's plain version returns K3a's answer bit for bit."""
    js, ps = _jax_scene(name)
    centers = ps.spheres.center.numpy()
    radii = ps.spheres.radius.numpy()
    o, d, tmax = _rays(centers if name == "cornell" else centers[1:],
                       spread=3.0 if name == "cornell" else 12.0,
                       lift=None if name == "cornell" else 0.3)
    rec = jax.jit(lambda o, d, tm: jax_intersect.hit_spheres(
        o, d, js.spheres, JC.EPSILON_T, tm))(o, d, tmax)
    ref_idx = np.where(np.asarray(rec.hit), np.asarray(rec.prim_index), -1)
    args = (torch.from_numpy(o), torch.from_numpy(d), C.EPSILON_T,
            torch.from_numpy(tmax))
    t, idx = P.sphere_nearest_reference(*args, ps.spheres)
    _sphere_check(t.numpy(), idx.numpy(), np.asarray(rec.t), ref_idx, o, d,
                  centers, radii)
    assert (ref_idx >= 0).mean() > 0.3
    if name == "rtow":
        groups = ps.sphere_groups
        stats = {}
        tc, ic = P.sphere_nearest_chunked_reference(*args, groups,
                                                    stats=stats)
        assert torch.equal(tc, t) and torch.equal(ic, idx)
        # the cull skips most of the 31 groups
        assert stats["group_tests"] < 0.5 * N_RAYS * groups.n_groups


@pytest.mark.parametrize("name", ["cornell", "box"])
def test_rect_nearest_plain_vs_xla(name):
    """K3c's plain version against the jitted ``hit_rects``: the same
    index, t within an ulp (measured equal)."""
    js, ps = _jax_scene(name)
    o, d, tmax = _rays(ps.rects.corner.numpy()
                       + 0.5 * (ps.rects.edge_u + ps.rects.edge_v).numpy())
    rec = jax.jit(lambda o, d, tm: jax_intersect.hit_rects(
        o, d, js.rects, JC.EPSILON_T, tm))(o, d, tmax)
    ref_idx = np.where(np.asarray(rec.hit), np.asarray(rec.prim_index), -1)
    t, idx = P.rect_nearest_reference(torch.from_numpy(o),
                                      torch.from_numpy(d), C.EPSILON_T,
                                      torch.from_numpy(tmax), ps.rects)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    ulps = np.abs(_bits(t.numpy()).astype(np.int64)
                  - _bits(np.asarray(rec.t)).astype(np.int64))
    assert ulps.max() <= 1
    assert (ref_idx >= 0).mean() > 0.3


@pytest.mark.parametrize("n_spheres,route", [(16, "0"), (100, "0"),
                                             (100, "1")])
def test_sphere_plain_vs_pallas_interpret(monkeypatch, n_spheres, route):
    """The plain K3a (brute route) and K3b (chunked route, above 32
    spheres) against ``pk.sphere_nearest`` under the interpreter:
    ``test_sphere_bvh.py``'s scene and rays."""
    from metal_pathtracer_tpu.ops.pallas import primitives as pk

    monkeypatch.setenv("MPT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MPT_SPHERE_BVH", route)
    rng = np.random.default_rng(7)
    centers = rng.uniform(-5, 5, (n_spheres, 3)).astype(np.float32)
    radii = rng.uniform(0.1, 0.5, n_spheres).astype(np.float32)
    n = 1500
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_ref, i_ref = pk.sphere_nearest(jnp.asarray(o), jnp.asarray(d), 1e-3,
                                     1e20, jnp.asarray(centers),
                                     jnp.asarray(radii))
    spheres = SpheresSoA(center=torch.from_numpy(centers),
                         radius=torch.from_numpy(radii),
                         material=torch.zeros(n_spheres, dtype=torch.int32))
    args = (torch.from_numpy(o), torch.from_numpy(d), 1e-3,
            torch.full((n,), 1e20))
    if route == "1":
        assert n_spheres > P.BRUTE_MAX_SPHERES
        t, i = P.sphere_nearest_chunked_reference(*args,
                                                  P.sphere_groups(spheres))
    else:
        t, i = P.sphere_nearest_reference(*args, spheres)
    _sphere_check(t.numpy(), i.numpy(), np.asarray(t_ref),
                  np.asarray(i_ref), o, d, centers, radii)
    assert (np.asarray(i_ref) >= 0).sum() > 10


def test_morton_groups():
    """The K3b layout: the JAX package's Morton order, whole groups padded
    by the last sphere, and boxes that hold every sphere of their group."""
    from metal_pathtracer_tpu.ops.pallas import primitives as pk

    _, ps = _jax_scene("rtow")
    centers = ps.spheres.center.numpy()
    np.testing.assert_array_equal(
        P.morton_order(centers),
        np.asarray(pk._morton_order(jnp.asarray(centers))))
    g = ps.sphere_groups
    assert g.n_groups == 31 and g.index.shape[0] == 31 * P.SPHERE_GROUP
    assert sorted(set(g.index.tolist())) == list(range(ps.n_spheres))
    c = g.center.numpy().reshape(31, P.SPHERE_GROUP, 3).astype(np.float64)
    r = g.radius.numpy().reshape(31, P.SPHERE_GROUP, 1).astype(np.float64)
    assert (g.box_min.numpy()[:, None] < c - r).all()
    assert (g.box_max.numpy()[:, None] > c + r).all()


def _mixed_scenes():
    """The mixed scene (``test_fused_shade.py:166-196``) in both packages."""
    ps, pr = B.build_mixed_scene()
    jr = JResources()
    for m in pr.materials:
        jr.add_material(JMaterial(mat_type=m.mat_type,
                                  base_color=m.base_color,
                                  emission=m.emission))
    jr.add_mesh(jax_dragon_mesh(2, material=0))
    for s in pr.spheres:
        jr.spheres.append(JSphere(center=s.center, radius=s.radius,
                                  material=s.material))
    for r in pr.rects:
        jr.rects.append(JRect(corner=r.corner, edge_u=r.edge_u,
                              edge_v=r.edge_v, normal=r.normal,
                              material=r.material, two_sided=r.two_sided))
    return jr.build_arrays(), pr.build_arrays(device="cpu")


@pytest.fixture(scope="module")
def traced():
    """Both packages' scenes and rays for cornell and the mixed scene."""
    out = {}
    for name in ("cornell", "mixed"):
        js, ps = _mixed_scenes() if name == "mixed" else _jax_scene(name)
        pts = [ps.spheres.center.numpy(), ps.rects.corner.numpy()]
        if ps.n_triangles:
            pts.append(ps.triangles.v0.numpy()[::7])
        o, d, tmax = _rays(np.concatenate(pts), seed=9)
        out[name] = (js, ps, o, d, tmax)
    return out


@pytest.mark.parametrize("name", ["cornell", "mixed"])
def test_trace_scene_vs_jax(traced, name):
    """The merged trace's record against the JAX package's
    ``trace_scene``: the winner's family, index, material and faces
    exactly, t/point/normal within the sphere rounding bound. On the
    mixed scene every fourth lane excludes the triangle it hit first, so
    the exclusion is held to triangles only."""
    js, ps, o, d, tmax = traced[name]
    ex_mesh = np.full(len(o), -1, np.int32)
    ex_prim = np.full(len(o), -1, np.int32)
    if ps.n_triangles:
        first = jax.jit(lambda o, d, tm: jax_intersect.trace_scene(
            o, d, js, JC.EPSILON_T, tm))(o, d, tmax)
        sel = (np.arange(len(o)) % 4 == 0) & np.asarray(first.hit) \
            & (np.asarray(first.prim_type) == JC.PRIMITIVE_TRIANGLE)
        ex_mesh[sel] = np.asarray(first.mesh_index)[sel]
        ex_prim[sel] = np.asarray(first.prim_index)[sel]
        assert sel.sum() > 50
    ref = jax.jit(lambda o, d, tm, em, ep: jax_intersect.trace_scene(
        o, d, js, JC.EPSILON_T, tm, em, ep))(o, d, tmax, ex_mesh, ex_prim)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = intersect.trace_scene(t(o), t(d), ps, C.EPSILON_T, t(tmax),
                                t(ex_mesh), t(ex_prim))
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    for f in ("prim_type", "prim_index", "material", "front_face",
              "two_sided", "mesh_index"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[hit],
                                      np.asarray(getattr(ref, f))[hit],
                                      err_msg=f)
    kinds = set(np.asarray(ref.prim_type)[hit].tolist())
    assert kinds >= {JC.PRIMITIVE_SPHERE, JC.PRIMITIVE_RECTANGLE}
    # t, point and normal: the sphere lanes within the quadratic's
    # rounding (XLA's sqrt), the rest within 2 ulps of their magnitude
    t_err = np.abs(got.t.numpy()[hit] - np.asarray(ref.t)[hit])
    is_s = np.asarray(ref.prim_type)[hit] == JC.PRIMITIVE_SPHERE
    k = np.asarray(ref.prim_index)[hit][is_s]
    tol = _t_tol(o[hit][is_s], d[hit][is_s], ps.spheres.center.numpy()[k],
                 ps.spheres.radius.numpy()[k])
    assert (t_err[is_s] <= tol).all()
    t_ref = np.abs(np.asarray(ref.t)[hit][~is_s])
    assert (t_err[~is_s] <= 2 * F32_EPS * t_ref).all()
    p_err = np.abs(got.point.numpy()[hit] - np.asarray(ref.point)[hit])
    assert p_err.max() <= 1e-5 * (1.0 + np.abs(o).max() + t_ref.max())
    n_err = np.abs(got.normal.numpy()[hit] - np.asarray(ref.normal)[hit])
    assert n_err.max() <= 1e-4, n_err.max()


@pytest.mark.parametrize("name", ["cornell", "mixed"])
def test_trace_occluded_vs_jax(traced, name):
    """Shadow flags over every family, equal to the JAX package's, with
    the window a shadow ray gets (t_max short of the light)."""
    js, ps, o, d, tmax = traced[name]
    tmax = np.where(tmax > 1.0, np.float32(1.7), tmax).astype(np.float32)
    ref = jax.jit(lambda o, d, tm: jax_intersect.trace_occluded(
        o, d, js, JC.EPSILON_T, tm))(o, d, tmax)
    got = intersect.trace_occluded(torch.from_numpy(o), torch.from_numpy(d),
                                   ps, C.EPSILON_T, torch.from_numpy(tmax))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0.1 < np.asarray(ref).mean() < 0.9
