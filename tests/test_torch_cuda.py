"""The port's CUDA kernels against their plain PyTorch versions on the
card. Marked ``cuda``: each test skips without a CUDA device. On a GPU
machine (``--noconftest``: ``tests/conftest.py`` imports jax, which the
port's GPU host need not have):
``python -m pytest tests/test_torch_cuda.py -q --noconftest``."""

import numpy as np
import pytest
import torch

from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops.camera import build_camera
from metal_pathtracer_tpu_torch.ops import camera as camera_ops
from metal_pathtracer_tpu_torch.ops import integrator
from metal_pathtracer_tpu_torch.ops import rng as rng_ops
from metal_pathtracer_tpu_torch.ops.kernels import shade, texture, traverse
from metal_pathtracer_tpu_torch.renderer import frame
from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
from metal_pathtracer_tpu_torch.schema import (
    settings_to_static,
    settings_to_uniforms,
)
from metal_pathtracer_tpu_torch.utils.benchscene import (
    build_bench_scene,
    build_lambert_series,
    build_six_slot_scene,
    build_untextured_bench_scene,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def lambert(dev):
    settings, resources = build_lambert_series(4)
    return settings, resources, resources.build_arrays(device=dev)


def _rays(scene, dev, n=4096, seed=3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2] = -o[: n // 2] + rng.normal(scale=0.3, size=(n // 2, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(n, C.INFINITY_T, np.float32)
    tmax[::17] = 0.0
    return [torch.from_numpy(a).to(dev) for a in (o, d, tmax)]


def test_trace_closest_bitexact_on_card(dev, lambert):
    _, _, scene = lambert
    o, d, tmax = _rays(scene, dev)
    none = torch.full((o.shape[0],), -1, dtype=torch.int32, device=dev)
    before = traverse.trace_closest.launches
    got = traverse.trace_closest(o, d, C.EPSILON_T, tmax, scene.tri_bvh,
                                 scene.triangles, none, none)
    ref = traverse.trace_closest_reference(o, d, C.EPSILON_T, tmax,
                                           scene.tri_bvh, scene.triangles,
                                           none, none)
    assert traverse.trace_closest.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert (got[1] >= 0).any()


def test_render_kernels_vs_plain_on_card(dev, lambert):
    settings, resources, scene = lambert
    w, h = 48, 32
    static = settings_to_static(settings, w, h,
                                resources.material_types_present())
    uni = settings_to_uniforms(settings, build_camera(settings, w, h, dev),
                               0, 0)
    k = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                             static, 2)

    def plain_trace(o, d, t_min, t_max, bvh, tris, em, ep):
        return traverse.trace_closest_reference(o, d, float(t_min), t_max,
                                                bvh, tris, em.int(), ep.int())

    saved = shade.trace_closest, shade.shade_full
    shade.trace_closest, shade.shade_full = (plain_trace,
                                             shade.shade_full_reference)
    try:
        p = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                 static, 2)
    finally:
        shade.trace_closest, shade.shade_full = saved
    assert k.ray_count == p.ray_count
    diff = (k.present() - p.present()).abs()
    assert float(diff.square().mean().sqrt()) < 2e-4
    assert float((diff.amax(-1) < 1e-5).float().mean()) > 0.98
    assert k.frame_index == p.frame_index == 2


@pytest.fixture(scope="module")
def headline(dev):
    settings, res, env = build_untextured_bench_scene(3, dev)
    settings.maxDepth = 5
    return settings, res, res.build_arrays(environment=env, device=dev)


def test_trace_any_bitexact_on_card(dev, headline):
    _, _, scene = headline
    o, d, tmax = _rays(scene, dev)
    before = traverse.trace_any.launches
    got = traverse.trace_any(o, d, C.EPSILON_T, tmax, scene.tri_bvh,
                             scene.triangles)
    ref = traverse.trace_any_reference(o, d, C.EPSILON_T, tmax,
                                       scene.tri_bvh, scene.triangles)
    assert traverse.trace_any.launches == before + 1
    assert torch.equal(got, ref)
    assert got.any() and not got.all()


def test_nee_kernels_vs_plain_on_card(dev, headline):
    """K1 closest/any-hit and K2 s1/s2 against their plain versions over a
    whole env-NEE render: equal trace counts, the lambert image gate
    (RMSE < 2e-4, > 98 % of pixels within 1e-5)."""
    settings, res, scene = headline
    w, h = 48, 32
    static = settings_to_static(settings, w, h,
                                res.material_types_present())
    uni = settings_to_uniforms(settings, build_camera(settings, w, h, dev),
                               0, 0)
    before = (shade.shade_s1.launches, shade.shade_s2.launches)
    k = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                             static, 2)
    assert shade.shade_s1.launches > before[0]
    assert shade.shade_s2.launches > before[1]

    def plain_trace(o, d, t_min, t_max, bvh, tris, em, ep):
        return traverse.trace_closest_reference(o, d, float(t_min), t_max,
                                                bvh, tris, em.int(), ep.int())

    def plain_any(o, d, t_min, t_max, bvh, tris):
        return traverse.trace_any_reference(o, d, float(t_min), t_max, bvh,
                                            tris)

    saved = (shade.trace_closest, traverse.trace_any, shade.shade_s1,
             shade.shade_s2)
    shade.trace_closest, traverse.trace_any = plain_trace, plain_any
    shade.shade_s1, shade.shade_s2 = (shade.shade_s1_reference,
                                      shade.shade_s2_reference)
    try:
        p = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                 static, 2)
    finally:
        (shade.trace_closest, traverse.trace_any, shade.shade_s1,
         shade.shade_s2) = saved
    assert (k.ray_count, k.shadow_ray_count) == (p.ray_count,
                                                 p.shadow_ray_count)
    diff = (k.present() - p.present()).abs()
    assert float(diff.square().mean().sqrt()) < 2e-4
    assert float((diff.amax(-1) < 1e-5).float().mean()) > 0.98


def _primary_hits(scene, uni, static, dev):
    """The primary wavefront of sample 0, every ninth lane dead, and its
    K1 hits."""
    w, h = static.width, static.height
    flat = torch.arange(w * h, device=dev)
    xs, ys = flat % w, flat // w
    seed = rng_ops.make_seed(uni.fixed_rng_seed, 0, xs, ys, 0,
                             torch.zeros_like(xs))
    state, ro, rd = camera_ops.generate_primary_rays(uni.camera, xs, ys, w,
                                                     h, seed)
    carry = integrator.PathCarry.start(
        state, ro, rd, 1e-3, integrator._primary_cone_spread(uni, static))
    carry.alive[::9] = False
    hit = traverse.trace_closest(
        carry.ray_o, carry.ray_d, C.EPSILON_T,
        torch.where(carry.alive, C.INFINITY_T, 0.0), scene.tri_bvh,
        scene.triangles)
    return carry, hit


@pytest.mark.parametrize("which", ["headline", "six_slots"])
def test_texture_stage_vs_plain_on_card(dev, which):
    """The texture-stage kernel against its plain version at depths 0 and
    2: the state and the tpass/tpbr flags equal, the other planes within
    1e-5 (libm log2f against torch.log2 may move a LOD in the last
    place)."""
    if which == "headline":
        settings, res, env = build_bench_scene(3, dev)
    else:
        settings, res = build_six_slot_scene()
        env = None
    scene = res.build_arrays(environment=env, device=dev)
    w, h = 96, 64
    static = settings_to_static(settings, w, h, res.material_types_present(),
                                res.texture_slots_present(),
                                res.texture_uses_uv1())
    uni = settings_to_uniforms(settings, build_camera(settings, w, h, dev),
                               0, 0)
    carry, hit = _primary_hits(scene, uni, static, dev)
    idx = texture.TEX_IDX
    for depth in (0, 2):
        ck = integrator.PathCarry(**{k: v.clone()
                                     for k, v in vars(carry).items()})
        cp = integrator.PathCarry(**{k: v.clone()
                                     for k, v in vars(carry).items()})
        before = texture.texture_stage.launches
        got = texture.texture_stage(ck, *hit, scene, uni, static, depth)
        want = texture.texture_stage_reference(cp, *hit, scene, uni, static,
                                               depth)
        torch.cuda.synchronize()
        assert texture.texture_stage.launches == before + 1
        assert torch.equal(ck.state, cp.state)
        for name in ("tpass", "tpbr"):
            assert torch.equal(got[:, idx[name]], want[:, idx[name]]), name
        assert (want[:, idx["tpbr"]] > 0.5).sum() > 100
        assert float((got - want).abs().max()) <= 1e-5


def test_textured_render_kernels_vs_plain_on_card(dev):
    """The textured headline (subdivision 3, maxDepth 5) through every
    kernel, texture stage included, against the plain path: equal trace
    counts and the lambert image gate."""
    settings, res, env = build_bench_scene(3, dev)
    settings.maxDepth = 5
    scene = res.build_arrays(environment=env, device=dev)
    w, h = 48, 32
    static = settings_to_static(settings, w, h, res.material_types_present(),
                                res.texture_slots_present(),
                                res.texture_uses_uv1())
    uni = settings_to_uniforms(settings, build_camera(settings, w, h, dev),
                               0, 0)
    before = texture.texture_stage.launches
    k = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                             static, 2)
    assert texture.texture_stage.launches > before

    def plain_trace(o, d, t_min, t_max, bvh, tris, em, ep):
        return traverse.trace_closest_reference(o, d, float(t_min), t_max,
                                                bvh, tris, em.int(), ep.int())

    def plain_any(o, d, t_min, t_max, bvh, tris):
        return traverse.trace_any_reference(o, d, float(t_min), t_max, bvh,
                                            tris)

    saved = (shade.trace_closest, traverse.trace_any, shade.shade_s1,
             shade.shade_s2, shade.texture_stage)
    shade.trace_closest, traverse.trace_any = plain_trace, plain_any
    shade.shade_s1, shade.shade_s2 = (shade.shade_s1_reference,
                                      shade.shade_s2_reference)
    shade.texture_stage = texture.texture_stage_reference
    try:
        p = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                 static, 2)
    finally:
        (shade.trace_closest, traverse.trace_any, shade.shade_s1,
         shade.shade_s2, shade.texture_stage) = saved
    assert (k.ray_count, k.shadow_ray_count) == (p.ray_count,
                                                 p.shadow_ray_count)
    diff = (k.present() - p.present()).abs()
    assert float(diff.square().mean().sqrt()) < 2e-4
    assert float((diff.amax(-1) < 1e-5).float().mean()) > 0.98


@pytest.mark.parametrize("name", ["cornell", "rtow"])
def test_primitive_kernels_vs_plain_on_card(dev, name):
    """K3a, K3c and (rtow, 487 spheres) K3b against their plain versions
    on a primary wavefront, t and index bit for bit; K3b equals K3a except
    where two spheres meet a ray at the same t."""
    from metal_pathtracer_tpu_torch.ops.kernels import primitives as P
    from metal_pathtracer_tpu_torch.utils import benchscene

    settings, res = (benchscene.build_cornell_scene() if name == "cornell"
                     else benchscene.build_rtow_scene(0))
    scene = res.build_arrays(device=dev)
    w, h = 256, 144
    static = settings_to_static(settings, w, h, res.material_types_present())
    uni = settings_to_uniforms(settings, build_camera(settings, w, h, dev),
                               0, 0)
    flat = torch.arange(w * h, device=dev)
    seed = rng_ops.make_seed(uni.fixed_rng_seed, 0, flat % w, flat // w, 0,
                             torch.zeros_like(flat))
    _, o, d = camera_ops.generate_primary_rays(uni.camera, flat % w,
                                               flat // w, w, h, seed)
    tmax = torch.full((w * h,), C.INFINITY_T, device=dev)
    tmax[::13] = 0.0
    args = (o.contiguous(), d.contiguous(), C.EPSILON_T, tmax)
    brute = P.sphere_nearest_brute(*args, scene.spheres)
    for got, want in [
            (brute, P.sphere_nearest_reference(*args, scene.spheres))] + (
            [(P.rect_nearest(*args, scene.rects),
              P.rect_nearest_reference(*args, scene.rects))]
            if scene.n_rects else []):
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32))
        assert torch.equal(got[1], want[1])
        assert (got[1] >= 0).any()
    if scene.n_spheres > P.BRUTE_MAX_SPHERES:
        groups = scene.sphere_groups
        before = P.sphere_nearest_chunked.launches
        got = P.sphere_nearest_chunked(*args, groups)
        assert P.sphere_nearest_chunked.launches == before + 1
        want = P.sphere_nearest_chunked_reference(*args, groups)
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32))
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0].view(torch.int32),
                           brute[0].view(torch.int32))
        assert int((got[1] != brute[1]).sum()) <= 4


@pytest.mark.parametrize("name", ["cornell", "rtow"])
def test_primitive_render_kernels_vs_plain_on_card(dev, name):
    """The Cornell box (K3a, K3c, K2 s1/s2 with rect-light NEE) and rtow
    (K3b, K2 full) at 160x96, 2 spp, through the kernels against the plain
    path: the same image and the same trace counts."""
    from unittest import mock

    from metal_pathtracer_tpu_torch.ops.kernels import primitives as P
    from metal_pathtracer_tpu_torch.utils import benchscene

    settings, res = (benchscene.build_cornell_scene() if name == "cornell"
                     else benchscene.build_rtow_scene(0))
    scene = res.build_arrays(device=dev)
    w, h = 160, 96
    static = settings_to_static(settings, w, h, res.material_types_present())
    uni = settings_to_uniforms(settings, build_camera(settings, w, h, dev),
                               0, 0)
    k = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                             static, 2)

    def plain(reference):
        return lambda o, d, t_min, t_max, prims: reference(
            o, d, float(t_min), P._prepare(o, t_max), prims)

    with mock.patch.object(P, "sphere_nearest_brute",
                           plain(P.sphere_nearest_reference)), \
            mock.patch.object(P, "sphere_nearest_chunked",
                              plain(P.sphere_nearest_chunked_reference)), \
            mock.patch.object(P, "rect_nearest",
                              plain(P.rect_nearest_reference)), \
            mock.patch.object(shade, "shade_full",
                              shade.shade_full_reference), \
            mock.patch.object(shade, "shade_s1", shade.shade_s1_reference), \
            mock.patch.object(shade, "shade_s2", shade.shade_s2_reference):
        p = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                 static, 2)
    assert (k.ray_count, k.shadow_ray_count) == (p.ray_count,
                                                 p.shadow_ray_count)
    assert torch.equal(k.present(), p.present())
