"""K1's plain version and the hit rebuild vs ``ops/traversal.py`` of the
JAX package (its XLA path, as tier-1 runs it) on 4096 probes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_pathtracer_tpu import constants as C
from metal_pathtracer_tpu.ops import intersect as jax_intersect
from metal_pathtracer_tpu.ops import traversal as jax_traversal
from metal_pathtracer_tpu.scene.resources import Material as JMaterial
from metal_pathtracer_tpu.scene.resources import SceneResources as JResources
from metal_pathtracer_tpu.utils.procgen import dragon_class_scene_mesh
from metal_pathtracer_tpu_torch.ops import intersect, traversal
from metal_pathtracer_tpu_torch.ops.kernels import traverse
from metal_pathtracer_tpu_torch.scene.resources import (
    Material,
    Mesh,
    SceneResources,
)

N_PROBES = 4096
F32_EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def case():
    """Subdivision-3 mesh (1,280 triangles) plus bench.py:136-146's probes:
    half aimed at the mesh bounds, dead lanes (tmax 0) and lanes that
    exclude the triangle they hit first."""
    jm = dragon_class_scene_mesh(3, material=0)
    jr, pr = JResources(), SceneResources()
    jr.add_material(JMaterial(base_color=(0.7, 0.7, 0.7)))
    pr.add_material(Material(base_color=(0.7, 0.7, 0.7)))
    jr.add_mesh(jm)
    pr.add_mesh(Mesh(**{f.name: getattr(jm, f.name)
                        for f in dataclasses.fields(Mesh)}))
    js, ps = jr.build_arrays(), pr.build_arrays(device="cpu")
    rng = np.random.default_rng(7)
    o = rng.uniform(-3.0, 3.0, (N_PROBES, 3)).astype(np.float32)
    v0 = np.asarray(js.triangles.v0)
    target = rng.uniform(v0.min(0), v0.max(0),
                         (N_PROBES // 2, 3)).astype(np.float32)
    d = rng.normal(size=(N_PROBES, 3)).astype(np.float32)
    d[: N_PROBES // 2] = target - o[: N_PROBES // 2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(N_PROBES, C.INFINITY_T, np.float32)
    tmax[::61] = 0.0
    trace = jax.jit(lambda o, d, tm, em, ep: jax_traversal.trace_triangles(
        o, d, js, C.EPSILON_T, tm, exclude_mesh=em, exclude_prim=ep))
    none = np.full(N_PROBES, -1, np.int32)
    first = trace(o, d, tmax, none, none)
    hit0 = np.asarray(first.hit)
    ex_prim = none.copy()
    ex_prim[::8] = np.where(hit0[::8], np.asarray(first.prim_index)[::8], -1)
    ex_mesh = np.where(ex_prim >= 0, 0, -1).astype(np.int32)
    ref = trace(o, d, tmax, ex_mesh, ex_prim)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = traversal.trace_triangles(t(o), t(d), ps, C.EPSILON_T, t(tmax),
                                    t(ex_mesh), t(ex_prim))
    return dict(js=js, ps=ps, o=o, d=d, tmax=tmax, ex_mesh=ex_mesh,
                ex_prim=ex_prim, ref=ref, got=got, trace=trace)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def test_probe_set_exercises_exclusion_and_dead_lanes(case):
    hit = np.asarray(case["ref"].hit)
    assert 0.2 < hit.mean() < 0.8
    assert (case["ex_prim"] >= 0).sum() > 100
    assert not hit[case["tmax"] == 0.0].any()


@pytest.mark.parametrize("field", ["hit", "t", "prim_index", "barycentric",
                                   "front_face", "material", "mesh_index",
                                   "prim_type", "two_sided"])
def test_trace_bitexact(case, field):
    """hit, tri, t, u, v and the rebuilt record's discrete fields are
    bit-exact against trace_triangles, ties and exclusions included."""
    ref = np.asarray(getattr(case["ref"], field))
    got = getattr(case["got"], field).numpy()
    if field == "prim_index":  # the reference keeps tri 0 on misses
        hit = np.asarray(case["ref"].hit)
        ref, got = np.where(hit, ref, -1), np.where(hit, got, -1)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_trace_closest_outputs_bitexact(case):
    """K1's own outputs (t, tri, u, v) through the wrapper on CPU tensors."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    bt, tri, u, v = traverse.trace_closest(
        t(case["o"]), t(case["d"]), C.EPSILON_T, t(case["tmax"]),
        case["ps"].tri_bvh, case["ps"].triangles, t(case["ex_mesh"]),
        t(case["ex_prim"]))
    ref = case["ref"]
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(tri.numpy(),
                                  np.where(hit, np.asarray(ref.prim_index), -1))
    np.testing.assert_array_equal(_bits(bt.numpy()[hit]),
                                  _bits(np.asarray(ref.t)[hit]))
    np.testing.assert_array_equal(
        _bits(np.stack([u.numpy(), v.numpy()], -1)),
        _bits(np.asarray(ref.barycentric)))
    assert (bt.numpy()[~hit] == case["tmax"][~hit]).all()


@pytest.mark.parametrize("field,ulps", [("point", 2), ("normal", 4),
                                        ("shading_normal", 8)])
def test_hit_record_vectors(case, field, ulps):
    """Within a few ulps on hit lanes: XLA:CPU rewrites 1/sqrt into its own
    approximate rsqrt (measured: 86% correctly rounded, else 1 ulp) and
    fuses ``o + t*d`` on some (N,3) components only; the port normalizes
    with IEEE sqrt and division and fuses every component."""
    hit = np.asarray(case["ref"].hit)
    ref = np.asarray(getattr(case["ref"], field))[hit]
    got = getattr(case["got"], field).numpy()[hit]
    scale = np.maximum(np.abs(ref).max(-1, keepdims=True), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=ulps * F32_EPS * float(scale.max()))


def test_trace_scene_folds_misses(case):
    """trace_scene's miss lanes carry the miss record, as the reference's."""
    ps, js = case["ps"], case["js"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = intersect.trace_scene(t(case["o"]), t(case["d"]), ps, C.EPSILON_T,
                                t(case["tmax"]))
    ref = jax.jit(lambda o, d, tm: jax_intersect.trace_scene(
        o, d, js, C.EPSILON_T, tm))(case["o"], case["d"], case["tmax"])
    miss = ~np.asarray(ref.hit)
    for f in ("hit", "t", "point", "normal", "material", "prim_index",
              "mesh_index", "prim_type", "barycentric"):
        np.testing.assert_array_equal(
            _bits(getattr(got, f).numpy()[miss]),
            _bits(np.asarray(getattr(ref, f))[miss]), err_msg=f)


def test_offset_ray_origin(case):
    ref_rec = case["ref"]
    hit = np.asarray(ref_rec.hit)
    d = case["d"]
    ref = np.asarray(jax.jit(jax_intersect.offset_ray_origin)(
        ref_rec, jnp.asarray(d)))[hit]
    got = intersect.offset_ray_origin(case["got"], torch.from_numpy(d))
    got = got.numpy()[hit]
    np.testing.assert_allclose(got, ref, rtol=0, atol=8 * F32_EPS * 3.0)
