"""The port's CUDA kernels against their plain PyTorch versions on the
card. Marked ``cuda``: each test skips without a CUDA device. On a GPU
machine (``--noconftest``: ``tests/conftest.py`` imports jax, which the
port's GPU host need not have):
``python -m pytest tests/test_torch_cuda.py -q --noconftest``."""

import contextlib
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops.camera import build_camera
from metal_pathtracer_tpu_torch.ops import camera as camera_ops
from metal_pathtracer_tpu_torch.ops import integrator
from metal_pathtracer_tpu_torch.ops import rng as rng_ops
from metal_pathtracer_tpu_torch.ops.kernels import (
    build,
    shade,
    texture,
    traverse,
)
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


#: K1's test wavefronts: probes (every 17th lane dead), the depth-1
#: wavefront after the camera rays, and probes with every other lane dead
#: and each live lane excluding the triangle it hits first
WAVES = ("probes", "depth1", "half_dead")


def _depth1_rays(settings, res, scene, dev, w=96, h=64):
    """The depth-1 wavefront of sample 0 (``_primary_hits`` through the
    plain K2 ``full``): (o, d, tmax, exclude_mesh, exclude_prim), dead
    lanes at tmax 0, each live lane excluding the triangle it leaves."""
    static = settings_to_static(settings, w, h,
                                res.material_types_present())
    uni = settings_to_uniforms(settings, build_camera(settings, w, h, dev),
                               0, 0)
    carry, hit = _primary_hits(scene, uni, static, dev)
    shade.shade_full_reference(carry, *hit, scene.triangles, scene.materials,
                               shade.ShadeParams.of(uni, static,
                                                    scene.environment), 0)
    assert 0 < int(carry.alive.sum()) < w * h
    return (carry.ray_o.contiguous(), carry.ray_d.contiguous(),
            torch.where(carry.alive, C.INFINITY_T, 0.0),
            torch.where(carry.prev_valid, carry.prev_mesh, -1).int(),
            torch.where(carry.prev_valid, carry.prev_prim, -1).int())


def _wave(which, settings, res, scene, dev):
    """K1's inputs (o, d, tmax, exclude_mesh, exclude_prim) for one of
    ``WAVES``."""
    if which == "depth1":
        return _depth1_rays(settings, res, scene, dev)
    o, d, tmax = _rays(scene, dev)
    none = torch.full((o.shape[0],), -1, dtype=torch.int32, device=dev)
    if which == "probes":
        return o, d, tmax, none, none
    tmax[::2] = 0.0
    _, tri, _, _ = traverse.trace_closest_reference(
        o, d, C.EPSILON_T, tmax, scene.tri_bvh, scene.triangles, none, none)
    mesh = torch.where(tri >= 0, scene.triangles.mesh_index[
        tri.clamp_min(0).long()], -1).int()
    assert (tri >= 0).sum() > 100
    return o, d, tmax, mesh, tri


def _bits_equal(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("which", WAVES)
def test_trace_closest_bitexact_on_card(dev, lambert, which):
    settings, res, scene = lambert
    o, d, tmax, em, ep = _wave(which, settings, res, scene, dev)
    before = traverse.trace_closest.launches
    got = traverse.trace_closest(o, d, C.EPSILON_T, tmax, scene.tri_bvh,
                                 scene.triangles, em, ep)
    ref = traverse.trace_closest_reference(o, d, C.EPSILON_T, tmax,
                                           scene.tri_bvh, scene.triangles,
                                           em, ep)
    assert traverse.trace_closest.launches == before + 1
    for a, b in zip(got, ref):
        assert _bits_equal(a, b)
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


@pytest.mark.parametrize("which", WAVES)
def test_trace_any_bitexact_on_card(dev, headline, which):
    settings, res, scene = headline
    o, d, tmax, _, _ = _wave(which, settings, res, scene, dev)
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
    params = texture.TexParams.of(uni, static, scene.textures)
    for depth in (0, 2):
        ck = integrator.PathCarry(**{k: v.clone()
                                     for k, v in vars(carry).items()})
        cp = integrator.PathCarry(**{k: v.clone()
                                     for k, v in vars(carry).items()})
        before = texture.texture_stage.launches
        got = texture.texture_stage(ck, *hit, scene, uni, static, depth,
                                    params)
        want = texture.texture_stage_reference(cp, *hit, scene, uni, static,
                                               depth)
        torch.cuda.synchronize()
        assert texture.texture_stage.launches == before + 1
        assert torch.equal(ck.state, cp.state)
        for name in ("tpass", "tpbr"):
            assert torch.equal(got[:, idx[name]], want[:, idx[name]]), name
        assert (want[:, idx["tpbr"]] > 0.5).sum() > 100
        assert float((got - want).abs().max()) <= 1e-5


def _kept(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, integrator.PathCarry):
        return integrator.PathCarry(**{k: v.clone()
                                       for k, v in vars(x).items()})
    return x


@pytest.fixture(scope="module")
def stage_inputs(dev):
    """The textured headline (subdivision 3, 96x64): the texture stage's
    and s1's inputs at depths 0 and 1 of one sample of the frame loop,
    cloned as the wrappers took them, every third lane of each carry
    dead."""
    settings, res, env = build_bench_scene(3, dev)
    scene = res.build_arrays(environment=env, device=dev)
    w, h = 96, 64
    static = settings_to_static(settings, w, h, res.material_types_present(),
                                res.texture_slots_present(),
                                res.texture_uses_uv1())
    uni = settings_to_uniforms(settings, build_camera(settings, w, h, dev),
                               0, 0)
    kept = {}
    real = {"tex": shade.texture_stage, "s1": shade.shade_s1}

    def spy(which):
        def run(*args, **kw):
            depth = sum(k[0] == which for k in kept)
            copy = tuple(_kept(x) for x in args)
            copy[0].alive[::3] = False
            kept[which, depth] = (copy, {k: _kept(x) for k, x in kw.items()})
            return real[which](*args, **kw)
        run.launches = 0
        return run

    saved = (shade.texture_stage, shade.shade_s1)
    shade.texture_stage, shade.shade_s1 = spy("tex"), spy("s1")
    try:
        frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                             static, 1)
    finally:
        shade.texture_stage, shade.shade_s1 = saved
    return kept


@pytest.mark.parametrize("depth", [0, 1])
def test_planes_vs_plain_on_card(dev, stage_inputs, depth):
    """The texture stage and K2 s1 against their plain versions at depths 0
    and 1 of the textured headline, every third lane dead: both return
    (N, k) views of plane-major (k, N) storage; the state, flags and carry
    equal, the texture planes within 1e-5, the transients within 1e-4."""
    idx = texture.TEX_IDX
    args, _ = stage_inputs["tex", depth]
    n = args[1].shape[0]
    ck, cp = _kept(args[0]), _kept(args[0])
    got = texture.texture_stage(ck, *args[1:])
    want = texture.texture_stage_reference(cp, *args[1:])
    torch.cuda.synchronize()
    for planes in (got, want):
        assert planes.shape == (n, len(texture.TEX))
        assert planes.stride() == (1, n)
    assert torch.equal(ck.state, cp.state)
    for name in ("tpass", "tpbr"):
        assert torch.equal(got[:, idx[name]], want[:, idx[name]]), name
    assert (want[:, idx["tpbr"]] > 0.5).any()
    assert (got[::3] == 0).all()
    assert float((got - want).abs().max()) <= 1e-5

    args, kw = stage_inputs["s1", depth]
    ck, cp = _kept(args[0]), _kept(args[0])
    got = shade.shade_s1(ck, *args[1:], **kw)
    want = shade.shade_s1_reference(cp, *args[1:], **kw)
    torch.cuda.synchronize()
    for planes in (got, want):
        assert planes.shape == (n, len(shade.TRANS))
        assert planes.stride() == (1, n)
    for name in ("state", "alive", "prev_prim", "is_first_hit"):
        assert torch.equal(getattr(ck, name), getattr(cp, name)), name
    for name in ("throughput", "radiance", "aov_albedo", "aov_normal"):
        assert float((getattr(ck, name) - getattr(cp, name)).abs().max()) \
            <= 1e-4, name
    assert (got[::3] == 0).all() and (got[:, 13] > 0.5).any()
    assert float((got - want).abs().max()) <= 1e-4


def test_texture_stage_raises_on_misaligned_texels(dev, stage_inputs):
    """The texture wrapper reads a texel as one 16-byte load and refuses a
    texel buffer that does not start on a 16-byte boundary."""
    args, _ = stage_inputs["tex", 0]
    scene = args[5]
    texels = scene.textures.texels
    shifted = torch.empty(texels.numel() + 1, device=dev)[1:].view_as(texels)
    shifted.copy_(texels)
    bad = dataclasses.replace(scene, textures=dataclasses.replace(
        scene.textures, texels=shifted))
    with pytest.raises(ValueError, match="aligned"):
        texture.texture_stage(_kept(args[0]), *args[1:5], bad, *args[6:])


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


@pytest.mark.parametrize("blocks", ["one", "an SM each", "one more"])
def test_k3a_narrow_and_wide_on_card(dev, blocks):
    """K3a's two instantiations against the plain version bit for bit, at
    the widths around the launcher's choice (at most one 128-thread block
    an SM reads the whole ray before the staging barrier), on rays from
    inside ``materials.scene``'s spheres' box, every fifth lane dead."""
    from metal_pathtracer_tpu_torch.ops.kernels import primitives as P
    from metal_pathtracer_tpu_torch.utils import benchscene

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = {"one": 100, "an SM each": 128 * sms,
         "one more": 128 * sms + 1}[blocks]
    _, res = benchscene.build_materials_scene()
    spheres = res.build_spheres_soa(dev)
    rng = np.random.default_rng(n)
    o = torch.from_numpy(rng.uniform(-2.0, 2.0, (n, 3)).astype(
        np.float32)).to(dev)
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    tmax = torch.full((n,), C.INFINITY_T, device=dev)
    tmax[::5] = 0.0
    got = P.sphere_nearest_brute(o, d, C.EPSILON_T, tmax, spheres)
    want = P.sphere_nearest_reference(o, d, C.EPSILON_T, tmax, spheres)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    assert (got[1] >= 0).any() and (got[1][::5] == -1).all()


def test_k3_records_must_be_aligned_on_card(dev):
    """K3a and K3c read their records with 16-byte loads: a record that
    does not start on a 16-byte boundary raises."""
    from metal_pathtracer_tpu_torch.ops.kernels import primitives as P
    from metal_pathtracer_tpu_torch.utils import benchscene

    _, res = benchscene.build_cornell_scene()
    scene = res.build_arrays(device=dev)
    o = torch.zeros((64, 3), device=dev)
    d = torch.ones((64, 3), device=dev)
    for soa, fn in ((scene.spheres, P.sphere_nearest_brute),
                    (scene.rects, P.rect_nearest)):
        rec = soa.records()
        bad = torch.empty(rec.numel() + 1, device=dev)[1:].view(rec.shape)
        bad.copy_(rec)
        soa.__dict__["_records"] = bad
        with pytest.raises(ValueError, match="16-byte"):
            fn(o, d, C.EPSILON_T, C.INFINITY_T, soa)
        soa.__dict__["_records"] = rec


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
    diff = (k.present() - p.present()).abs()
    assert float(diff.square().mean().sqrt()) < 2e-4
    assert float((diff.amax(-1) < 1e-5).float().mean()) > 0.98


def _zoo_stage_inputs(dev, which, w=192, h=64):
    """A zoo configuration's first-depth wavefront on the card: (scene,
    static, uniforms, environment, carry, hit)."""
    from metal_pathtracer_tpu_torch.utils import benchscene

    env = None
    if which == "materials":
        settings, res = benchscene.build_materials_scene()
    elif which == "materials-env-rw":
        settings, res, env = benchscene.build_materials_env_rw_scene(dev)
    else:
        settings, res, env = benchscene.build_cornell_emitenv_scene(dev)
    scene = res.build_arrays(environment=env, device=dev)
    static = settings_to_static(settings, w, h, res.material_types_present())
    uni = settings_to_uniforms(settings, build_camera(settings, w, h, dev),
                               0, 0)
    flat = torch.arange(w * h, device=dev)
    seed = rng_ops.make_seed(uni.fixed_rng_seed, 0, flat % w, flat // w, 0,
                             torch.zeros_like(flat))
    state, o, d = camera_ops.generate_primary_rays(uni.camera, flat % w,
                                                   flat // w, w, h, seed)
    carry = integrator.PathCarry.start(
        state, o, d, 0.0, integrator._primary_cone_spread(uni, static))
    return scene, static, uni, env, carry, shade._trace(scene, carry)


def _clone(c):
    return integrator.PathCarry(**{k: v.clone() for k, v in vars(c).items()})


def _assert_carry_equal(a, b):
    for k in vars(a):
        x, y = getattr(a, k), getattr(b, k)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), k


def test_zoo_full_vs_plain_on_card(dev):
    """K2 full's extended instantiation (plastic, carpaint, separable SSS)
    on materials.scene's first two depths: carry bit for bit."""
    scene, static, uni, _, carry, hit = _zoo_stage_inputs(dev, "materials")
    params = shade.ShadeParams.of(uni, static)
    assert params.extended
    for depth in (0, 1):
        t, idx, u, v, kind = hit
        ck, cp = _clone(carry), _clone(carry)
        before = shade.shade_full.launches
        shade.shade_full(ck, t, idx, u, v, scene.triangles, scene.materials,
                         params, depth, kind=kind, scene=scene)
        assert shade.shade_full.launches == before + 1
        shade.shade_full_reference(cp, t, idx, u, v, scene.triangles,
                                   scene.materials, params, depth, kind=kind,
                                   scene=scene)
        _assert_carry_equal(ck, cp)
        carry = ck
        hit = shade._trace(scene, carry)


def test_zoo_s1_s2_random_walk_vs_plain_on_card(dev):
    """K2 s1 and s2 (extended) on materials-env-rw's first depth with its
    environment bank and the random walk's override planes fed to both:
    carry, transients and chain bit for bit."""
    from metal_pathtracer_tpu_torch.ops import env as env_ops

    scene, static, uni, env, carry, hit = _zoo_stage_inputs(
        dev, "materials-env-rw")
    t, idx, u, v, kind = hit
    params = shade.ShadeParams.of(uni, static, env)
    envbg = env_ops.environment_background(env, carry.ray_d, uni, static,
                                           carry.env_lod,
                                           carry.env_lod_active)
    envpdf = env_ops.environment_pdf(env, carry.ray_d,
                                     uni.environment_rotation)
    args = (t, idx, u, v, scene.triangles, scene.materials)
    ck, cp = _clone(carry), _clone(carry)
    trans = shade.shade_s1(ck, *args, envbg, envpdf, params, 0, kind=kind,
                           scene=scene)
    trans_p = shade.shade_s1_reference(cp, *args, envbg, envpdf, params, 0,
                                       kind=kind, scene=scene)
    _assert_carry_equal(ck, cp)
    assert torch.equal(trans.view(torch.int32), trans_p.view(torch.int32))
    rw, rw_state = shade.random_walks(scene, uni, static, ck, t, idx, u, v,
                                      kind)
    assert (rw[:, 0] > 0.5).any()
    esmp, _ = shade.light_banks(scene, uni, static, trans, t)
    c2k, c2p = _clone(ck), _clone(ck)
    chain = shade.shade_s2(c2k, *args, trans, esmp, params, 0, kind=kind,
                           scene=scene, rw=rw, rw_state=rw_state)
    chain_p = shade.shade_s2_reference(c2p, *args, trans, esmp, params, 0,
                                       kind=kind, scene=scene, rw=rw,
                                       rw_state=rw_state)
    _assert_carry_equal(c2k, c2p)
    assert torch.equal(chain.view(torch.int32), chain_p.view(torch.int32))


def test_zoo_s1_emod_vs_plain_on_card(dev):
    """K2 s1 with the emod plane on cornell-emitenv's first depth (rect
    and environment NEE, an ``emission_env`` lamp): carry and transients
    bit for bit."""
    from metal_pathtracer_tpu_torch.ops import env as env_ops
    from metal_pathtracer_tpu_torch.ops.intersect import analytic_point

    scene, static, uni, env, carry, hit = _zoo_stage_inputs(
        dev, "cornell-emitenv", 128, 128)
    t, idx, u, v, kind = hit
    params = shade.ShadeParams.of(uni, static, env)
    assert not params.extended
    envbg = env_ops.environment_background(env, carry.ray_d, uni, static,
                                           carry.env_lod,
                                           carry.env_lod_active)
    envpdf = env_ops.environment_pdf(env, carry.ray_d,
                                     uni.environment_rotation)
    rectpdf = integrator.rect_light_pdf_for_hit(
        scene, analytic_point(carry.ray_o, t, carry.ray_d), kind, idx,
        carry.ray_o)
    emod = shade.env_modulation(scene, uni, static, carry, t, idx, u, v,
                                kind)
    args = (t, idx, u, v, scene.triangles, scene.materials, envbg, envpdf,
            params, 0)
    ck, cp = _clone(carry), _clone(carry)
    trans = shade.shade_s1(ck, *args, kind=kind, scene=scene,
                           rectpdf=rectpdf, emod=emod)
    trans_p = shade.shade_s1_reference(cp, *args, kind=kind, scene=scene,
                                       rectpdf=rectpdf, emod=emod)
    _assert_carry_equal(ck, cp)
    assert torch.equal(trans.view(torch.int32), trans_p.view(torch.int32))


@pytest.mark.parametrize("which", WAVES)
def test_trace_stats_vs_counter_free_and_plain_on_card(dev, lambert, which):
    """K1's counting instantiation on a 5,120-triangle soup (each of
    ``WAVES``): t, tri, u, v and the occlusion flags bit-equal to the
    counter-free kernels, the four totals equal to the plain walk's."""
    settings, res, scene = lambert
    o, d, tmax, em, ep = _wave(which, settings, res, scene, dev)
    args = (o, d, C.EPSILON_T, tmax, scene.tri_bvh, scene.triangles)
    before = (traverse.trace_closest_stats.launches,
              traverse.trace_any_stats.launches)
    *got, totals = traverse.trace_closest_stats(*args, em, ep)
    occ, totals_any = traverse.trace_any_stats(*args)
    assert (traverse.trace_closest_stats.launches,
            traverse.trace_any_stats.launches) == (before[0] + 1,
                                                   before[1] + 1)
    for a, b in zip(got, traverse.trace_closest(*args, em, ep)):
        assert _bits_equal(a, b)
    assert torch.equal(occ, traverse.trace_any(*args))
    walk, walk_any = {}, {}
    traverse.trace_closest_reference(*args, em, ep, walk=walk)
    traverse.trace_any_reference(*args, walk=walk_any)
    assert torch.equal(totals, traverse.walk_totals(walk, dev))
    assert torch.equal(totals_any, traverse.walk_totals(walk_any, dev))
    assert (totals > 0).all()


@pytest.mark.parametrize("which", ["materials", "headline"])
def test_specular_only_kernels_vs_plain_on_card(dev, which):
    """``debugSpecularOnly`` through K2 (materials.scene: stage full,
    extended; the textured headline at subdivision 3: texture stage and
    s1/s2) against the plain path at 48x32, 2 spp: the same image and
    trace counts."""
    from metal_pathtracer_tpu_torch.utils import benchscene as B

    if which == "materials":
        settings, res = B.build_materials_scene()
        env = None
    else:
        settings, res, env = build_bench_scene(3, dev)
        settings.maxDepth = 5
    settings.debugSpecularOnly = True
    scene = res.build_arrays(environment=env, device=dev)
    w, h = 48, 32
    static = settings_to_static(settings, w, h, res.material_types_present(),
                                res.texture_slots_present(),
                                res.texture_uses_uv1())
    uni = settings_to_uniforms(settings, build_camera(settings, w, h, dev),
                               0, 0)
    k = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                             static, 2)
    saved = (shade.trace_closest, traverse.trace_any, shade.shade_full,
             shade.shade_s1, shade.shade_s2, shade.texture_stage)

    def plain_trace(o, d, t_min, t_max, bvh, tris, em, ep):
        return traverse.trace_closest_reference(o, d, float(t_min), t_max,
                                                bvh, tris, em.int(), ep.int())

    shade.trace_closest = plain_trace
    traverse.trace_any = lambda o, d, t_min, t_max, bvh, tris: \
        traverse.trace_any_reference(o, d, float(t_min), t_max, bvh, tris)
    shade.shade_full = shade.shade_full_reference
    shade.shade_s1, shade.shade_s2 = (shade.shade_s1_reference,
                                      shade.shade_s2_reference)
    shade.texture_stage = texture.texture_stage_reference
    try:
        p = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                 static, 2)
    finally:
        (shade.trace_closest, traverse.trace_any, shade.shade_full,
         shade.shade_s1, shade.shade_s2, shade.texture_stage) = saved
    assert (k.ray_count, k.shadow_ray_count) == (p.ray_count,
                                                 p.shadow_ray_count)
    diff = (k.present() - p.present()).abs()
    assert float(diff.square().mean().sqrt()) < 2e-4
    assert float((diff.amax(-1) < 1e-5).float().mean()) > 0.98


def test_cli_checkpoint_resume_on_card(dev, tmp_path):
    """The CLI on the card: the smoke scene at 64x64, 2 spp checkpointed
    then resumed to 4, equal byte for byte to the straight 4 spp EXR."""
    from metal_pathtracer_tpu_torch import cli

    base = ["--scene", "tests/scenes/smoke.scene", "--width", "64",
            "--height", "64"]
    straight, resumed = str(tmp_path / "a.exr"), str(tmp_path / "b.exr")
    ckpt = str(tmp_path / "state.npz")
    assert cli.main([*base, "--sppTotal", "4", "--output", straight]) == 0
    assert cli.main([*base, "--sppTotal", "2", "--checkpoint", ckpt,
                     "--output", str(tmp_path / "half.exr")]) == 0
    assert cli.main([*base, "--sppTotal", "4", "--checkpoint", ckpt,
                     "--output", resumed]) == 0
    assert open(straight, "rb").read() == open(resumed, "rb").read()


@pytest.fixture(scope="module")
def s2_inputs(dev):
    """s2's inputs at depths 1 and 5 of one sample of the frame loop,
    cloned as the wrapper took them: the textured headline (subdivision
    3, 96x64; the base instantiation) and materials-env-rw (192x64, the
    random walk's planes; the extended one). {which: {depth: (args,
    kwargs)}}."""
    from metal_pathtracer_tpu_torch.utils import benchscene

    out = {}
    for which in ("headline", "zoo"):
        if which == "headline":
            settings, res, env = build_bench_scene(3, dev)
            w, h = 96, 64
        else:
            settings, res, env = benchscene.build_materials_env_rw_scene(dev)
            w, h = 192, 64
        scene = res.build_arrays(environment=env, device=dev)
        static = settings_to_static(settings, w, h,
                                    res.material_types_present(),
                                    res.texture_slots_present(),
                                    res.texture_uses_uv1())
        uni = settings_to_uniforms(settings,
                                   build_camera(settings, w, h, dev), 0, 0)
        kept, real = {}, shade.shade_s2

        def spy(*args, **kw):
            depth = spy.calls
            spy.calls += 1
            if depth in (1, 5):
                kept[depth] = (tuple(_kept(x) for x in args),
                               {k: _kept(x) for k, x in kw.items()})
            return real(*args, **kw)

        spy.calls = spy.launches = 0
        with mock.patch.object(shade, "shade_s2", spy):
            frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                 static, 1)
        out[which] = kept
    return out


def _s2_pair(args, kw):
    """s2 by the wrapper and by the plain version on clones of the kept
    carry: (chain, carry, plain chain, plain carry)."""
    ck, cp = _kept(args[0]), _kept(args[0])
    before = shade.shade_s2.launches
    got = shade.shade_s2(ck, *args[1:], **kw)
    assert shade.shade_s2.launches == before + 1
    want = shade.shade_s2_reference(cp, *args[1:], **kw)
    torch.cuda.synchronize()
    return got, ck, want, cp


@pytest.mark.parametrize("depth", [1, 5])
@pytest.mark.parametrize("which", ["headline", "zoo"])
def test_s2_sparse_vs_plain_on_card(dev, s2_inputs, which, depth):
    """K2 s2 against the plain version on the sparse depth-1 and depth-5
    wavefronts (base, over its live-lane list; extended, a thread per
    lane): CHAIN
    plane-major from both and zero off the lanes alive after s1, dead
    lanes' carry untouched, the carry and chain within ``chip_smoke.py``'s
    tolerance (state, alive, prim, delta flag and medium depth on all but
    1e-4 of the lanes; floats within 1e-4 of max(1, |plain|))."""
    args, kw = s2_inputs[which][depth]
    if which == "zoo":
        assert kw["rw"] is not None
    n = args[1].shape[0]
    alive = args[0].alive
    assert 0 < int(alive.sum()) < n // 2
    got, ck, want, cp = _s2_pair(args, kw)
    for chain in (got, want):
        build.check_planes("CHAIN", chain, n, len(shade.CHAIN))
    assert (got[~alive] == 0).all() and (got[alive] != 0).any()
    for k, x in vars(ck).items():
        assert torch.equal(x[~alive], getattr(args[0], k)[~alive]), k
    differ = sum(int((getattr(ck, k) != getattr(cp, k)).reshape(n, -1)
                     .any(-1).sum())
                 for k in ("state", "alive", "prev_prim", "last_delta",
                           "medium_depth"))
    assert differ <= 1e-4 * n
    for k in ("ray_o", "ray_d", "throughput", "radiance", "last_pdf",
              "medium_stack", "cone_width"):
        a, b = getattr(ck, k), getattr(cp, k)
        assert float(((a - b).abs() / b.abs().clamp_min(1.0)).max()) <= 1e-4
    assert float(((got - want).abs() / want.abs().clamp_min(1.0)).max()) \
        <= 1e-4


def test_chain_layout_refused_lane_major_on_card(dev, s2_inputs):
    """s2's CHAIN is an (N, 7) view of plane-major (7, N) storage;
    ``check_planes`` refuses a lane-major copy of it."""
    args, kw = s2_inputs["headline"][1]
    n = args[1].shape[0]
    got = _s2_pair(args, kw)[0]
    build.check_planes("CHAIN", got, n, len(shade.CHAIN))
    with pytest.raises(ValueError, match="plane-major"):
        build.check_planes("CHAIN", got.contiguous(), n, len(shade.CHAIN))


@pytest.fixture(scope="module")
def mnee_s2_inputs(dev):
    """s2's inputs at depths 0, 1 and 5 of one sample with MNEE on (its
    secondary chain asks s2 for the fork state): the textured headline
    (subdivision 3, 96x64; the base instantiation) and materials-env-rw
    (192x64, the glass sphere under the sky; the extended one).
    {which: {depth: (args, kwargs)}}."""
    from metal_pathtracer_tpu_torch.utils import benchscene

    out = {}
    for which in ("headline", "zoo"):
        if which == "headline":
            settings, res, env = build_bench_scene(3, dev)
            w, h = 96, 64
        else:
            settings, res, env = benchscene.build_materials_env_rw_scene(dev)
            w, h = 192, 64
        settings.enableMnee = True
        scene = res.build_arrays(environment=env, device=dev)
        static = settings_to_static(settings, w, h,
                                    res.material_types_present(),
                                    res.texture_slots_present(),
                                    res.texture_uses_uv1())
        uni = settings_to_uniforms(settings,
                                   build_camera(settings, w, h, dev), 0, 0)
        kept, real = {}, shade.shade_s2

        def spy(*args, **kw):
            depth = spy.calls
            spy.calls += 1
            if depth in (0, 1, 5):
                kept[depth] = (tuple(_kept(x) for x in args),
                               {k: _kept(x) for k, x in kw.items()})
            return real(*args, **kw)

        spy.calls = spy.launches = 0
        with mock.patch.object(shade, "shade_s2", spy):
            frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                 static, 1)
        out[which] = kept
    return out


@pytest.mark.parametrize("depth", [0, 1, 5])
@pytest.mark.parametrize("which", ["headline", "zoo"])
def test_s2_fork_state_vs_plain_on_card(dev, mnee_s2_inputs, which, depth):
    """K2 s2's fork-state export (MNEE's secondary chain) against the
    plain version, in both instantiations: the (N,) int64 fork state bit
    for bit; lanes not alive on entry export their entry state; on each
    lane it equals the committed state or is one PCG step behind it (the
    roulette's draw, from depth 5 only); the chain and carry as without
    the export (``test_s2_sparse_vs_plain_on_card``'s tolerance)."""
    args, kw = mnee_s2_inputs[which][depth]
    assert kw["fork"] is True
    assert args[9].extended == (which == "zoo")
    n = args[1].shape[0]
    alive = args[0].alive
    (chain, fork), ck, (chain_p, fork_p), cp = _s2_pair(args, kw)
    assert fork.dtype == torch.int64 and fork.shape == (n,)
    assert torch.equal(fork, fork_p)
    assert torch.equal(fork[~alive], args[0].state[~alive])
    same = fork == ck.state
    step = rng_ops.rand_uniform(fork)[0] == ck.state
    assert bool((same | step).all())
    if depth < 5:
        assert bool(same.all())
    differ = sum(int((getattr(ck, k) != getattr(cp, k)).reshape(n, -1)
                     .any(-1).sum())
                 for k in ("state", "alive", "prev_prim", "last_delta",
                           "medium_depth"))
    assert differ <= 1e-4 * n
    assert float(((chain - chain_p).abs()
                  / chain_p.abs().clamp_min(1.0)).max()) <= 1e-4
    # the same launch without the export: the same chain and carry
    c_off = _kept(args[0])
    off = shade.shade_s2(c_off, *args[1:], **{**kw, "fork": False})
    torch.cuda.synchronize()
    assert torch.equal(off, chain)
    for k, x in vars(c_off).items():
        assert torch.equal(x, getattr(ck, k)), k


def test_mnee_render_kernels_vs_plain_on_card(dev):
    """The textured headline (subdivision 3, maxDepth 8) with MNEE on
    through every kernel against the plain path: equal trace counts (the
    chains' included) and the image gate."""
    settings, res, env = build_bench_scene(3, dev)
    settings.enableMnee = True
    scene = res.build_arrays(environment=env, device=dev)
    w, h = 48, 32
    static = settings_to_static(settings, w, h, res.material_types_present(),
                                res.texture_slots_present(),
                                res.texture_uses_uv1())
    assert static.enable_mnee_secondary
    uni = settings_to_uniforms(settings, build_camera(settings, w, h, dev),
                               0, 0)
    before = shade.shade_s2.launches
    k = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                             static, 2)
    assert shade.shade_s2.launches > before

    def plain_trace(o, d, t_min, t_max, bvh, tris, em=None, ep=None):
        n = o.shape[0]
        return traverse.trace_closest_reference(
            o, d, float(t_min), t_max, bvh, tris,
            traverse._as_i32(em, n, o.device),
            traverse._as_i32(ep, n, o.device))

    def plain_any(o, d, t_min, t_max, bvh, tris):
        return traverse.trace_any_reference(o, d, float(t_min), t_max, bvh,
                                            tris)

    with mock.patch.object(shade, "trace_closest", plain_trace), \
            mock.patch.object(traverse, "trace_closest", plain_trace), \
            mock.patch.object(traverse, "trace_any", plain_any), \
            mock.patch.object(shade, "shade_s1", shade.shade_s1_reference), \
            mock.patch.object(shade, "shade_s2", shade.shade_s2_reference), \
            mock.patch.object(shade, "texture_stage",
                              texture.texture_stage_reference):
        p = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                 static, 2)
    assert (k.ray_count, k.shadow_ray_count) == (p.ray_count,
                                                 p.shadow_ray_count)
    diff = (k.present() - p.present()).abs()
    assert float(diff.square().mean().sqrt()) < 2e-4
    assert float((diff.amax(-1) < 1e-5).float().mean()) > 0.98


@pytest.mark.parametrize("wave", ["depth 0", "depth 1", "exact tie"])
def test_k3b_bitexact_on_card(dev, wave):
    """K3b (near first, shrinking window) against its plain version bit
    for bit: rtow's 256x144 wavefronts at depths 0 and 1 and the scene
    with two identical spheres in different groups; the tie goes to the
    lower slot."""
    from metal_pathtracer_tpu_torch.ops.kernels import primitives as P
    from test_torch_k3b import rtow_waves, tie_scene

    if wave == "exact tie":
        spheres, groups, args = tie_scene()
        groups = type(groups)(**{k: v.to(dev)
                                 for k, v in vars(groups).items()})
        args = tuple(x.to(dev) if isinstance(x, torch.Tensor) else x
                     for x in args)
    else:
        groups, waves = rtow_waves(dev, 256, 144)
        args = (*waves[wave][:2], C.EPSILON_T, waves[wave][2])
    before = P.sphere_nearest_chunked.launches
    got = P.sphere_nearest_chunked(*args, groups)
    assert P.sphere_nearest_chunked.launches == before + 1
    want = P.sphere_nearest_chunked_reference(*args, groups)
    model = P.sphere_nearest_visits(*args, groups)
    for ref in (want, model):
        assert torch.equal(got[0].view(torch.int32), ref[0].view(torch.int32))
        assert torch.equal(got[1], ref[1])
    assert (got[1] >= 0).sum() > 100
    if wave == "exact tie":
        assert (got[1] == 40).sum() > 100 and not (got[1] == 3).any()


@pytest.fixture(scope="module")
def full_inputs(dev):
    """Stage full's inputs at every depth of one sample of the frame loop,
    cloned as the wrapper took them: rtow (256x144, the base
    instantiation) and materials.scene (192x64, the extended one).
    {which: [(args, kwargs)]}."""
    from metal_pathtracer_tpu_torch.utils import benchscene

    out = {}
    for which in ("rtow", "materials"):
        if which == "rtow":
            settings, res = benchscene.build_rtow_scene(0)
            w, h = 256, 144
        else:
            settings, res = benchscene.build_materials_scene()
            w, h = 192, 64
        scene = res.build_arrays(device=dev)
        static = settings_to_static(settings, w, h,
                                    res.material_types_present())
        uni = settings_to_uniforms(settings,
                                   build_camera(settings, w, h, dev), 0, 0)
        kept, real = [], shade.shade_full

        def spy(*args, **kw):
            kept.append((tuple(_kept(x) for x in args),
                         {k: _kept(x) for k, x in kw.items()}))
            return real(*args, **kw)

        spy.launches = 0
        with mock.patch.object(shade, "shade_full", spy):
            frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                 static, 1)
        out[which] = kept
    return out


def _sparse_depth(kept):
    """The first depth from 5 with under a tenth of the lanes alive."""
    n = kept[0][0][1].shape[0]
    return next(d for d, (a, _) in enumerate(kept)
                if d >= 5 and 0 < int(a[0].alive.sum()) < n // 10)


@pytest.mark.parametrize("which,depth", [("rtow", 0), ("rtow", 1),
                                         ("rtow", "sparse"),
                                         ("materials", 0),
                                         ("materials", 1)])
def test_full_buckets_vs_plain_on_card(dev, full_inputs, which, depth):
    """K2 full against its plain version bit for bit in the carry: through
    the wrapper as the frame loop calls it, and by each kernel (a thread
    per lane; the listing pass and the bucket kernel; on rtow the sparse
    sweep), at rtow's depths
    0, 1 and a sparse one from depth 5, and materials' depths 0 and 1
    (the extended instantiation). The listing pass's buckets hold the
    plain listing's hits, each in its bucket, and no miss (it ends them);
    each wrapper counts one launch."""
    kept = full_inputs[which]
    if depth == "sparse":
        depth = _sparse_depth(kept)
    args, kw = kept[depth]
    assert "n_alive" in kw
    bare = {k: x for k, x in kw.items() if k != "n_alive"}
    want = _clone(args[0])
    shade.shade_full_reference(want, *args[1:], **bare)
    runs = [(shade.shade_full, kw), (shade.shade_full_lanes, bare),
            (shade.shade_full_buckets, bare)]
    if which == "rtow":     # the base instantiation only
        runs.append((shade.shade_full_sparse, bare))
    for fn, opts in runs:
        got = _clone(args[0])
        before = fn.launches
        fn(got, *args[1:], **opts)
        assert fn.launches == before + 1
        torch.cuda.synchronize()
        _assert_carry_equal(got, want)
    fam = dict(kind=kw["kind"], scene=kw["scene"])
    before = shade.full_buckets.launches
    scratch = shade.full_buckets(_clone(args[0]), *args[1:8], **fam)
    assert shade.full_buckets.launches == before + 1
    got = shade.bucket_lanes(scratch, args[1].shape[0])
    ref = shade.full_buckets_reference(args[0], *args[1:8], **fam)
    assert len(got[0]) == 0 and len(ref[0]) > 0
    for a, b in zip(got[1:], ref[1:]):
        assert torch.equal(a, b)
    assert sum(len(b) > 0 for b in ref[1:]) >= 3


def test_s2_listing_pass_raises_on_cuda_error(dev, s2_inputs, monkeypatch):
    """A CUDA error in s2's listing pass (its list at a null address)
    raises from the wrapper, with no launch counted and no fallback; the
    next launch runs clean. At the end of the file: it provokes an
    error."""
    args, kw = s2_inputs["headline"][1]

    class Null:
        def data_ptr(self):
            return 0

    monkeypatch.setattr(build, "list_scratch", lambda n, dev: Null())
    before = shade.shade_s2.launches
    with pytest.raises(RuntimeError, match="mpt_shade_s2: CUDA error"):
        shade.shade_s2(_kept(args[0]), *args[1:], **kw)
    assert shade.shade_s2.launches == before
    monkeypatch.undo()
    got, _, want, _ = _s2_pair(args, kw)
    assert float(((got - want).abs() / want.abs().clamp_min(1.0)).max()) \
        <= 1e-4


def test_full_listing_pass_raises_on_cuda_error(dev, full_inputs,
                                                monkeypatch):
    """A CUDA error in stage full's listing pass (its scratch at a null
    address) raises from the wrapper, with no launch counted and no
    fallback; the next launch runs clean. At the end of the file: it
    provokes an error."""
    args, kw = full_inputs["rtow"][1]

    class Null:
        def data_ptr(self):
            return 0

    monkeypatch.setattr(build, "list_scratch", lambda *a, **k: Null())
    before = (shade.shade_full.launches, shade.full_buckets.launches,
              shade.shade_full_buckets.launches)
    with pytest.raises(RuntimeError, match="mpt_full_list: CUDA error"):
        shade.shade_full(_clone(args[0]), *args[1:], **kw)
    assert (shade.shade_full.launches, shade.full_buckets.launches,
            shade.shade_full_buckets.launches) == before
    monkeypatch.undo()
    got, want = _clone(args[0]), _clone(args[0])
    shade.shade_full(got, *args[1:], **kw)
    shade.shade_full_reference(want, *args[1:],
                               **{k: x for k, x in kw.items()
                                  if k != "n_alive"})
    torch.cuda.synchronize()
    _assert_carry_equal(got, want)


# ---- instanced meshes ----------------------------------------------------------

#: a fourth placement of the displaced icosphere with the GLB's
#: checker-textured PBR material: its lanes are textured with the soup's
#: UVs (ROADMAP Queue 3)
_PBR_PLACEMENT = ("mesh path=dragon.ply material=checker instanced=1 "
                  "translate=1.0,-0.75,0.4 rotate=0,30,0 scale=0.4\n")


@pytest.fixture(scope="module")
def instanced(dev, tmp_path_factory):
    """The instanced-headline cell's files at subdivision 3: (settings,
    resources, scene) of ``instanced_headline.scene`` with a textured PBR
    placement more, and of ``instanced_lambert.scene``."""
    from metal_pathtracer_tpu_torch.ops import env as env_ops
    from metal_pathtracer_tpu_torch.scene import dsl
    from metal_pathtracer_tpu_torch.scene.resources import SceneResources
    from metal_pathtracer_tpu_torch.settings import RenderSettings
    from metal_pathtracer_tpu_torch.utils import meshfiles

    d = tmp_path_factory.mktemp("instanced")
    meshfiles.write_headline_files(str(d), 3, dev)
    (d / "pbr.scene").write_text(meshfiles.instanced_scene_text()
                                 + _PBR_PLACEMENT)
    out = {}
    for name in ("pbr", "instanced_lambert"):
        settings, res = RenderSettings(), SceneResources()
        dsl.load_scene_file(str(d / f"{name}.scene"), settings, res)
        env = env_ops.load_environment(settings.environmentMapPath, dev) \
            if settings.environmentMapPath else None
        out[name] = (settings, res, res.build_arrays(environment=env,
                                                     device=dev))
    return out


@pytest.mark.parametrize("excluded", [False, True])
def test_instanced_k1_vs_plain_on_card(dev, instanced, excluded):
    """Instanced K1, closest and any-hit, one launch over every placement,
    against the plain per-placement walks: (t, object triangle, u, v,
    placement) and the flags bit for bit; with ``excluded``, every live
    lane skips the hit of a first trace (its global instance id and
    object triangle)."""
    _, _, scene = instanced["pbr"]
    o, d, tmax = _rays(scene, dev)
    n = o.shape[0]
    none = torch.full((n,), -1, dtype=torch.int32, device=dev)
    em = ep = none
    if excluded:
        _, tri, _, _, inst = traverse.trace_instanced_closest(
            o, d, C.EPSILON_T, tmax, scene.instanced)
        base = scene.instanced[0].base_id
        em = torch.where(inst >= 0, inst + base, -1).to(torch.int32)
        ep = torch.where(inst >= 0, tri, -1)
    args = (o, d, C.EPSILON_T, tmax, scene.instanced, em, ep)
    before = traverse.trace_instanced_closest.launches
    got = traverse.trace_instanced_closest(*args)
    want = traverse.trace_instanced_closest_reference(*args)
    torch.cuda.synchronize()
    assert traverse.trace_instanced_closest.launches == before + 1
    for a, b in zip(got, want):
        assert _bits_equal(a, b)
    assert int((want[4] >= 0).sum()) > n // 8
    assert len(torch.unique(want[4][want[4] >= 0])) == scene.n_instances
    tm = torch.where(torch.arange(n, device=dev) % 3 == 0, 2.0, tmax)
    before = traverse.trace_instanced_any.launches
    occ = traverse.trace_instanced_any(o, d, C.EPSILON_T, tm,
                                       scene.instanced)
    assert traverse.trace_instanced_any.launches == before + 1
    assert torch.equal(occ, traverse.trace_instanced_any_reference(
        o, d, C.EPSILON_T, tm, scene.instanced))
    assert 0 < int(occ.sum()) < n


def test_instanced_texture_stage_vs_plain_on_card(dev, instanced):
    """The texture-stage kernel on a primary wavefront of the instanced
    scene (the merged trace's families passed): state and flags equal to
    the plain version's, planes within 1e-5, and the PBR placement's lanes
    textured."""
    from metal_pathtracer_tpu_torch.ops import intersect

    settings, res, scene = instanced["pbr"]
    w, h = 96, 64
    static = settings_to_static(settings, w, h, res.material_types_present(),
                                res.texture_slots_present(),
                                res.texture_uses_uv1())
    uni = settings_to_uniforms(settings, build_camera(settings, w, h, dev),
                               0, 0)
    carry, _ = _primary_hits(scene, uni, static, dev)
    t, idx, u, v, kind = intersect.trace_merged(
        carry.ray_o, carry.ray_d, scene, C.EPSILON_T,
        torch.where(carry.alive, C.INFINITY_T, 0.0))
    tri = shade.triangle_lanes(idx, kind)
    params = texture.TexParams.of(uni, static, scene.textures)
    ck, cp = _kept(carry), _kept(carry)
    got = texture.texture_stage(ck, t, tri, u, v, scene, uni, static, 0,
                                params, kind)
    want = texture.texture_stage_reference(cp, t, tri, u, v, scene, uni,
                                           static, 0, kind=kind)
    torch.cuda.synchronize()
    idx_of = texture.TEX_IDX
    assert torch.equal(ck.state, cp.state)
    for name in ("tpass", "tpbr"):
        assert torch.equal(got[:, idx_of[name]], want[:, idx_of[name]]), name
    tpbr = want[:, idx_of["tpbr"]] > 0.5
    assert int((tpbr & (kind >= intersect.KIND_INSTANCE)).sum()) > 20
    assert float((got - want).abs().max()) <= 1e-5


def _plain_instanced_render(scene, uni, static, dev, spp):
    """A render with every kernel of the instanced scenes' paths replaced
    by its plain version."""
    def plain_trace(o, d, t_min, t_max, bvh, tris, em=None, ep=None):
        n = o.shape[0]
        return traverse.trace_closest_reference(
            o, d, float(t_min), t_max, bvh, tris,
            traverse._as_i32(em, n, dev), traverse._as_i32(ep, n, dev))

    def plain_inst(o, d, t_min, t_max, groups, em=None, ep=None):
        n = o.shape[0]
        return traverse.trace_instanced_closest_reference(
            o, d, float(t_min), t_max, groups, traverse._as_i32(em, n, dev),
            traverse._as_i32(ep, n, dev))

    patches = {
        (traverse, "trace_closest"): plain_trace,
        (traverse, "trace_any"): lambda o, d, t_min, t_max, bvh, tris:
            traverse.trace_any_reference(o, d, float(t_min), t_max, bvh,
                                         tris),
        (traverse, "trace_instanced_closest"): plain_inst,
        (traverse, "trace_instanced_any"): lambda o, d, t_min, t_max, g:
            traverse.trace_instanced_any_reference(o, d, float(t_min),
                                                   t_max, g),
        (shade, "shade_full"): shade.shade_full_reference,
        (shade, "shade_s1"): shade.shade_s1_reference,
        (shade, "shade_s2"): shade.shade_s2_reference,
        (shade, "texture_stage"): texture.texture_stage_reference}
    with contextlib.ExitStack() as stack:
        for (mod, name), fn in patches.items():
            stack.enter_context(mock.patch.object(mod, name, fn))
        return frame.render_samples(scene, uni, RenderState.create(
            static.width, static.height, dev), static, spp)


@pytest.mark.parametrize("name", ["pbr", "instanced_lambert"])
def test_instanced_render_kernels_vs_plain_on_card(dev, instanced, name):
    """The instanced scenes (subdivision 3, maxDepth 5) through the
    kernels, instanced K1 and the texture stage included, against the
    plain path: equal trace counts and the lambert image gate (the
    texture planes may differ by 1e-5). The PBR scene runs K2 s1/s2
    under the environment, the lambert variant K2 ``full``."""
    settings, res, scene = instanced[name]
    settings.maxDepth = 5
    w, h = 48, 32
    static = settings_to_static(settings, w, h, res.material_types_present(),
                                res.texture_slots_present(),
                                res.texture_uses_uv1())
    uni = settings_to_uniforms(settings, build_camera(settings, w, h, dev),
                               0, 0)
    before = (traverse.trace_instanced_closest.launches,
              shade.shade_full.launches, shade.shade_s2.launches)
    k = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                             static, 2)
    assert traverse.trace_instanced_closest.launches > before[0]
    stage = 1 if name == "instanced_lambert" else 2
    assert (shade.shade_full.launches, shade.shade_s2.launches)[stage - 1] \
        > before[stage]
    p = _plain_instanced_render(scene, uni, static, dev, 2)
    assert (k.ray_count, k.shadow_ray_count) == (p.ray_count,
                                                 p.shadow_ray_count)
    diff = (k.present() - p.present()).abs()
    assert float(diff.square().mean().sqrt()) < 2e-4
    assert float((diff.amax(-1) < 1e-5).float().mean()) > 0.98


#: the instanced cells the two-level walk is held on: the tie scene (the
#: glass OBJ twice, one transform), the grid (64 + 16 placements, staged
#: in shared memory) and a wide grid of 160 glass placements (past the
#: staging budget: read through L1)
_WIDE = "".join(
    f"mesh path=glass.obj material=glass instanced=1 translate="
    f"{0.3 * (k % 16) - 2.0},{0.25 * (k // 16) - 1.0},-1.0 scale=0.2\n"
    for k in range(160))


@pytest.fixture(scope="module")
def tlas_cells(dev, tmp_path_factory):
    from metal_pathtracer_tpu_torch.scene import dsl
    from metal_pathtracer_tpu_torch.scene.resources import SceneResources
    from metal_pathtracer_tpu_torch.settings import RenderSettings
    from metal_pathtracer_tpu_torch.utils import meshfiles

    d = tmp_path_factory.mktemp("tlas")
    meshfiles.write_headline_files(str(d), 3, dev)
    (d / "instanced_wide.scene").write_text(
        meshfiles.instanced_scene_text(variant="tie").rsplit("mesh", 2)[0]
        + _WIDE)
    out = {}
    for name in ("tie", "grid", "wide"):
        settings, res = RenderSettings(), SceneResources()
        dsl.load_scene_file(str(d / f"instanced_{name}.scene"), settings,
                            res)
        out[name] = res.build_arrays(device=dev)
    return out


@pytest.mark.parametrize("cell", ["tie", "grid", "wide"])
def test_instanced_tlas_vs_plain_on_card(dev, tlas_cells, cell):
    """The two-level instanced walks against the sequential plain walks
    on 4096 probes, a third of them grazing the faces of the placements'
    world boxes, the second half excluding a first trace's hits (each
    wrapper launched once): (t, object triangle, u, v, placement) and the
    flags bit for bit. Every tie goes to the lower placement; the wide
    grid reads its TLAS through L1, the others stage it."""
    import os
    import sys

    from metal_pathtracer_tpu_torch.schema import instance_tlas

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import compare_instanced, instanced_probes

    scene = tlas_cells[cell]
    tlas = instance_tlas(scene.instanced)
    staged = tlas.node_count * 32 + scene.n_instances * 112 <= 12 * 1024
    assert staged == (cell != "wide")
    o, d, tmax, em, ep = instanced_probes(scene, dev)
    n = o.shape[0]
    args = (o, d, C.EPSILON_T, tmax, scene.instanced, em, ep)
    before = traverse.trace_instanced_closest.launches
    got = traverse.trace_instanced_closest(*args)
    torch.cuda.synchronize()
    assert traverse.trace_instanced_closest.launches == before + 1
    want = traverse.trace_instanced_closest_reference(*args)
    compare_instanced(got, want, cell)
    assert int((want[4] >= 0).sum()) > n // 8
    if cell == "tie":   # where no hit is excluded, placement 0 wins
        assert not bool((want[4][em < 0] == 1).any())
    tm = torch.where(torch.arange(n, device=dev) % 3 == 0, 2.0, tmax)
    before = traverse.trace_instanced_any.launches
    occ = traverse.trace_instanced_any(o, d, C.EPSILON_T, tm,
                                       scene.instanced)
    assert traverse.trace_instanced_any.launches == before + 1
    assert torch.equal(occ, traverse.trace_instanced_any_reference(
        o, d, C.EPSILON_T, tm, scene.instanced))
    assert 0 < int(occ.sum()) < n


@pytest.mark.parametrize("background", ["solid=0.7,0.8,1.0", "env=./sky.exr"])
def test_empty_scene_on_card(dev, tmp_path, background):
    """A scene without any primitive renders on the card, equal to its
    plain render on the CPU, with no trace kernel launched."""
    from metal_pathtracer_tpu_torch.ops import env as env_ops
    from metal_pathtracer_tpu_torch.ops.kernels import primitives
    from metal_pathtracer_tpu_torch.scene import dsl
    from metal_pathtracer_tpu_torch.scene.resources import SceneResources
    from metal_pathtracer_tpu_torch.settings import RenderSettings
    from metal_pathtracer_tpu_torch.utils import benchscene, image_io

    image_io.write_exr_rgb(str(tmp_path / "sky.exr"),
                           benchscene.hdr_sky(128, 64))
    (tmp_path / "empty.scene").write_text(
        "camera target=0,0,0 distance=4 yaw=0.3 pitch=0.15 vfov=45\n"
        f"renderer maxDepth=4 seed=7\nbackground {background}\n"
        "material type=lambert albedo=0.5,0.5,0.5\n")
    settings, res = RenderSettings(), SceneResources()
    dsl.load_scene_file(str(tmp_path / "empty.scene"), settings, res)
    traces = (traverse.trace_closest, traverse.trace_any,
              traverse.trace_instanced_closest, traverse.trace_instanced_any,
              primitives.sphere_nearest_brute,
              primitives.sphere_nearest_chunked, primitives.rect_nearest)
    before = [f.launches for f in traces]
    imgs = []
    for device in (dev, torch.device("cpu")):
        env = env_ops.load_environment(settings.environmentMapPath, device) \
            if settings.environmentMapPath else None
        scene = res.build_arrays(environment=env, device=device)
        static = settings_to_static(settings, 64, 48,
                                    res.material_types_present())
        uni = settings_to_uniforms(
            settings, build_camera(settings, 64, 48, device), 0, 0)
        st = frame.render_samples(scene, uni,
                                  RenderState.create(64, 48, device),
                                  static, 2)
        imgs.append(st.present().cpu().numpy())
    assert [f.launches for f in traces] == before
    assert np.isfinite(imgs[0]).all() and imgs[0].max() > 0.0
    d = np.abs(imgs[0] - imgs[1])
    assert float(np.sqrt((d * d).mean())) < 2e-4
    assert float((d.max(-1) < 1e-5).mean()) > 0.98


def test_png_sky_render_on_card(dev, tmp_path):
    """Two spheres under the committed 8-bit PNG sky, loaded by the port's
    own decoder (no imageio on the card's host), render on the card as
    their plain render on the CPU, the primitives' and shading kernels
    launched."""
    import os
    import shutil

    from metal_pathtracer_tpu_torch.ops import env as env_ops
    from metal_pathtracer_tpu_torch.ops.kernels import primitives
    from metal_pathtracer_tpu_torch.ops.kernels import shade as shade_k
    from metal_pathtracer_tpu_torch.scene import dsl
    from metal_pathtracer_tpu_torch.scene.resources import SceneResources
    from metal_pathtracer_tpu_torch.settings import RenderSettings

    shutil.copy(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "images", "sky_rgb8_48x24.png"),
                tmp_path / "sky.png")
    (tmp_path / "sky.scene").write_text(
        "camera target=0,0,0 distance=4 yaw=0.3 pitch=0.15 vfov=45\n"
        "renderer maxDepth=4 seed=11\nbackground env=./sky.png\n"
        "material type=lambert albedo=0.7,0.6,0.5\n"
        "material type=lambert albedo=0.3,0.5,0.6\n"
        "sphere center=-0.6,0,0 radius=0.7 material=0\n"
        "sphere center=0.9,-0.2,0.3 radius=0.5 material=1\n")
    settings, res = RenderSettings(), SceneResources()
    dsl.load_scene_file(str(tmp_path / "sky.scene"), settings, res)
    kernels = (primitives.sphere_nearest_brute, shade_k.shade_s1,
               shade_k.shade_s2)
    before = [f.launches for f in kernels]
    imgs = []
    for device in (dev, torch.device("cpu")):
        env = env_ops.load_environment(settings.environmentMapPath, device)
        scene = res.build_arrays(environment=env, device=device)
        static = settings_to_static(settings, 64, 48,
                                    res.material_types_present())
        uni = settings_to_uniforms(
            settings, build_camera(settings, 64, 48, device), 0, 0)
        st = frame.render_samples(scene, uni,
                                  RenderState.create(64, 48, device),
                                  static, 2)
        imgs.append(st.present().cpu().numpy())
        if device == dev:
            assert all(f.launches > b for f, b in zip(kernels, before))
    assert np.isfinite(imgs[0]).all() and imgs[0].max() > 0.0
    d = np.abs(imgs[0] - imgs[1])
    assert float(np.sqrt((d * d).mean())) < 2e-4
    assert float((d.max(-1) < 1e-5).mean()) > 0.98


# ---- the à-trous kernel and the U-Net (the interactive path) ---------------

def _denoise_inputs(dev, h, w, seed=21):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.tensor(rng.random(s, dtype=np.float32), device=dev)
    color = f(h, w, 3) * 3.0
    albedo = f(h, w, 3)
    normal = torch.nn.functional.normalize(
        torch.tensor(rng.normal(size=(h, w, 3)).astype(np.float32),
                     device=dev), dim=-1)
    normal[: h // 5] = 0.0           # a band of background pixels
    var = f(h, w) * 0.05
    return color, var, albedo, normal


@pytest.mark.parametrize("mode", ["fixed", "svgf", "learned"])
@pytest.mark.parametrize("size", [(24, 24), (37, 53), (72, 136), (1, 97),
                                  (97, 1)])
def test_atrous_step_vs_plain_on_card(dev, mode, size):
    """One launch of ``csrc/denoise.cu`` per iteration against
    ``ops/denoise.atrous_step_reference`` on the card, at every step of
    a 5-iteration pyramid (steps 1-16: at 24x24 the taps wrap around more
    than once; at 72x136 72 mod 16 = 8, so taps past the edge land on
    another coset's row), at an odd size and on one row or one column:
    within 1e-6 relative."""
    from metal_pathtracer_tpu_torch import convert
    from metal_pathtracer_tpu_torch.ops import denoise as D
    from metal_pathtracer_tpu_torch.ops.kernels import denoise as K

    h, w = size
    color, var, albedo, normal = _denoise_inputs(dev, h, w)
    with np.load(D.DATA_DIR + "/denoiser_weights.npz") as z:
        mlp = K.pack_mlp(convert.denoiser_params(
            {k: z[k] for k in z.files}, dev))
    for it in range(5):
        p = {"fixed": K.StepParams.fixed(1 << it, 0.245 / 9 ** it, 0.125,
                                         0.08),
             "svgf": K.StepParams.svgf(1 << it, 1.5, 64.0, 0.125),
             "learned": K.StepParams.learned(1 << it, it / 4)}[mode]
        before = K.atrous_step.launches
        got, got_var = K.atrous_step(color, var, albedo, normal, p, mlp)
        assert K.atrous_step.launches == before + 1
        ref, ref_var = D.atrous_step_reference(color, var, albedo, normal,
                                               p, mlp)
        torch.cuda.synchronize()
        rel = ((got - ref).abs() / (1 + ref.abs())).max().item()
        assert rel <= 1e-6, (mode, it, rel)
        if mode == "fixed":
            assert got_var is None and ref_var is None
        else:
            rel = ((got_var - ref_var).abs() / (1 + ref_var.abs())).max()
            assert rel.item() <= 1e-6, (mode, it, rel.item())
            var = got_var
        color = got


@pytest.mark.parametrize("mode", ["fixed", "svgf", "learned"])
@pytest.mark.parametrize("size", [(37, 53), (72, 136)])
def test_atrous_filter_equals_the_iterations_on_card(dev, mode, size):
    """The pack launch is a bit copy of ``pack_reference``; the whole
    filter (one pack, then ``atrous_step_packed`` an iteration) gives the
    per-iteration path's bits (``atrous_step``, pack and step each
    iteration), with 1 + 5 and 2 x 5 launches counted; each packed
    iteration holds against ``atrous_step_reference`` within 1e-6."""
    from metal_pathtracer_tpu_torch import convert
    from metal_pathtracer_tpu_torch.ops import denoise as D
    from metal_pathtracer_tpu_torch.ops.kernels import denoise as K

    h, w = size
    color, var, albedo, normal = _denoise_inputs(dev, h, w, seed=23)
    with np.load(D.DATA_DIR + "/denoiser_weights.npz") as z:
        mlp = K.pack_mlp(convert.denoiser_params(
            {k: z[k] for k in z.files}, dev))
    steps = [{"fixed": K.StepParams.fixed(1 << it, 0.245 / 9 ** it, 0.125,
                                          0.08),
              "svgf": K.StepParams.svgf(1 << it, 1.5, 64.0, 0.125),
              "learned": K.StepParams.learned(1 << it, it / 4)}[mode]
             for it in range(5)]
    v = None if mode == "fixed" else var
    cv, guide = K.pack(color, v, albedo, normal)
    ref_cv, ref_guide = D.pack_reference(color, v, albedo, normal)
    assert torch.equal(cv, ref_cv) and torch.equal(guide, ref_guide)
    before = (K.atrous_step.launches, K.pack.launches)
    got, got_var = K.atrous_filter(color, v, albedo, normal, steps, mlp)
    assert (K.atrous_step.launches, K.pack.launches) == (
        before[0] + 5, before[1] + 1)
    c, cvar = color, v
    for p in steps:
        c, cvar = K.atrous_step(c, cvar, albedo, normal, p, mlp)
    assert (K.atrous_step.launches, K.pack.launches) == (
        before[0] + 10, before[1] + 6)
    torch.cuda.synchronize()
    assert torch.equal(got, c)
    if mode == "fixed":
        assert got_var is None and cvar is None
    else:
        assert torch.equal(got_var, cvar)
    x = cv
    for k, p in enumerate(steps):
        last = k == len(steps) - 1
        nxt = K.atrous_step_packed(x, guide, p, mlp, last=last)
        col, vv, alb, nrm = D.unpack(x, guide)
        ref, ref_var = D.atrous_step_reference(
            col, None if mode == "fixed" else vv, alb, nrm, p, mlp)
        out, out_var = nxt if last else D.unpack(nxt, guide)[:2]
        torch.cuda.synchronize()
        rel = ((out - ref).abs() / (1 + ref.abs())).max().item()
        assert rel <= 1e-6, (mode, k, rel)
        if mode != "fixed":
            rel = ((out_var - ref_var).abs() / (1 + ref_var.abs())).max()
            assert rel.item() <= 1e-6, (mode, k, rel.item())
        x = nxt
    assert build.load().mpt_atrous_mlp_floats() == K.MLP_CONST_FLOATS


def test_atrous_step_refuses_bad_inputs_on_card(dev):
    from metal_pathtracer_tpu_torch.ops.kernels import denoise as K

    color, var, albedo, normal = _denoise_inputs(dev, 8, 8)
    with pytest.raises(ValueError, match="variance"):
        K.atrous_step(color, None, albedo, normal,
                      K.StepParams.svgf(1, 1.5, 64.0, 0.125))
    with pytest.raises(ValueError, match="color"):
        K.atrous_step(color.transpose(0, 1), var, albedo, normal,
                      K.StepParams.fixed(1, 1.0, 1.0, 1.0))
    cv, guide = K.pack(color, var, albedo, normal)
    with pytest.raises(ValueError, match="guide"):
        K.atrous_step_packed(cv, guide[..., :4].contiguous(),
                             K.StepParams.fixed(1, 1.0, 1.0, 1.0))
    with pytest.raises(ValueError, match="mlp"):
        K.atrous_step_packed(cv, guide, K.StepParams.learned(1, 0.0))


def test_unet_tf32_off_vs_cpu(dev):
    """The vendored U-Net on the card (cuDNN, TF32 off inside ``forward``)
    against the same net on the CPU, over a learned prepass: within 1e-4
    relative; the global TF32 switch is left as it was."""
    from metal_pathtracer_tpu_torch import convert
    from metal_pathtracer_tpu_torch.ops import denoise as D
    from metal_pathtracer_tpu_torch.ops import denoise_unet as U

    with np.load(D.DATA_DIR + "/denoiser_unet.npz") as z:
        raw = {k: z[k] for k in z.files}
    color, var, albedo, normal = _denoise_inputs(dev, 45, 67)
    var3 = var[..., None].expand(-1, -1, 3).contiguous()
    base = color * 0.8
    flag = torch.backends.cudnn.allow_tf32
    out = {}
    for d in (dev, torch.device("cpu")):
        net = U.DenoiseUNet.from_params(convert.denoiser_params(raw, d))
        out[d.type] = U.denoise(*(x.to(d) for x in (color, albedo, normal,
                                                     var3)), net,
                                base.to(d)).cpu()
    assert torch.backends.cudnn.allow_tf32 == flag
    ref = out["cpu"]
    rel = ((out["cuda"] - ref).abs() / (1 + ref.abs())).max().item()
    assert rel <= 1e-4, rel


def test_denoised_display_launches_the_kernel(dev):
    """``display_image`` with ``denoiseEnabled`` on a card state launches
    the à-trous kernel once an iteration (4, or 5 for RTLightmap) and
    matches the display through the plain filters within one LDR step."""
    from metal_pathtracer_tpu_torch.ops.kernels import denoise as K
    from metal_pathtracer_tpu_torch.renderer import display

    color, var, albedo, normal = _denoise_inputs(dev, 40, 56)
    n = torch.full((40, 56), 4, dtype=torch.int64, device=dev)
    st = RenderState(radiance_sum=color * 4, sample_count=n, albedo=albedo,
                     normal=normal, radiance_sq_sum=color * color * 4 + 0.3)
    from metal_pathtracer_tpu_torch.settings import RenderSettings
    for ftype, iters in ((0, 4), (1, 5)):
        s = RenderSettings()
        s.denoiseEnabled, s.denoiseFilterType = True, ftype
        before = K.atrous_step.launches
        got = display.display_to_u8(st, s)
        assert K.atrous_step.launches == before + iters
        from metal_pathtracer_tpu_torch.ops import denoise as D
        with mock.patch.object(K, "atrous_filter",
                               D.atrous_filter_reference):
            ref = display.display_to_u8(st, s)
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


# ---- the denoisers' training path ------------------------------------------

def _grad_scene(dev, h, w, seed=19):
    """A learned filter's inputs and reference with a background band (no
    variance, zero AOVs) and an unlit band (luminance ties)."""
    rng = np.random.default_rng(seed)
    c = rng.gamma(1.2, 0.6, (h, w, 3)).astype(np.float32)
    var = rng.uniform(0.0, 0.05, (h, w, 3)).astype(np.float32)
    a = rng.uniform(0.05, 0.95, (h, w, 3)).astype(np.float32)
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    ref = rng.gamma(1.2, 0.6, (h, w, 3)).astype(np.float32)
    band = h // 8
    c[:band] = (0.65, 0.75, 0.95)
    var[:band], a[:band], n[:band] = 0.0, 0.0, 0.0
    c[2 * band:4 * band] = 0.0
    return {k: torch.from_numpy(v).to(dev) for k, v in
            dict(noisy=c, albedo=a, normal=n, variance=var, ref=ref).items()}


def _vendored_mlp(dev):
    from metal_pathtracer_tpu_torch import convert
    from metal_pathtracer_tpu_torch.ops import denoise as D

    with np.load(D.DATA_DIR + "/denoiser_weights.npz") as z:
        params = convert.denoiser_params({k: z[k] for k in z.files}, dev)
    return {k: v.requires_grad_() for k, v in params.items()}


def _learned_grads(params, d, iters, plain=False):
    from metal_pathtracer_tpu_torch.ops import denoise as D
    from metal_pathtracer_tpu_torch.ops.kernels import denoise as K
    from metal_pathtracer_tpu_torch.tools import train_denoiser as td

    d = dict(d, noisy=d["noisy"].clone().requires_grad_(),
             variance=d["variance"].clone().requires_grad_())
    patch = mock.patch.object(K, "atrous_filter", D.atrous_filter_reference) \
        if plain else contextlib.nullcontext()
    with patch:
        loss = td.scene_error(params, d, (iters,))
        return torch.autograd.grad(
            loss, [params[k] for k in ("w1", "b1", "w2", "b2")]
            + [d["noisy"], d["variance"]])


def _rel_norm(got, want):
    got = torch.cat([x.reshape(-1) for x in got]).double().cpu()
    want = torch.cat([x.reshape(-1) for x in want]).double().cpu()
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("iters", [4, 5])
def test_learned_backward_vs_plain_autograd_on_card(dev, iters):
    """The learned filter's gradients through ``LearnedIteration`` (the
    backward kernels) against autograd through the plain version on the
    card, at 4 and 5 iterations on a 96x80 state with ties: MLP, colour
    and variance within 1e-4 relative norm; the forward with grad
    bit-equal to the forward without; one backward launch of each kernel
    an iteration (the gather none where no input needs a gradient)."""
    from metal_pathtracer_tpu_torch.ops import denoise as D
    from metal_pathtracer_tpu_torch.ops.kernels import denoise as K

    d = _grad_scene(dev, 80, 96)
    params = _vendored_mlp(dev)
    before = (K.grad_taps.launches, K.grad_gather.launches,
              K.grad_sum.launches)
    got = _learned_grads(params, d, iters)
    assert (K.grad_taps.launches - before[0], K.grad_gather.launches
            - before[1], K.grad_sum.launches - before[2]) == (iters,) * 3
    want = _learned_grads(params, d, iters, plain=True)
    for sl in (slice(0, 4), slice(4, 5), slice(5, 6)):
        assert _rel_norm(got[sl], want[sl]) <= 1e-4
    args = (d["noisy"], d["albedo"], d["normal"], d["variance"])
    with torch.no_grad():
        free = D.learned_denoise(*args, params, iters)
    assert torch.equal(D.learned_denoise(*args, params, iters).detach(),
                       free)
    only_mlp = (K.grad_gather.launches, K.grad_taps.launches)
    torch.autograd.grad(D.learned_denoise(*args, params, iters).sum(),
                        params["w1"])
    assert K.grad_gather.launches - only_mlp[0] == iters - 1
    assert K.grad_taps.launches - only_mlp[1] == iters


def test_backward_kernels_vs_twins_on_card(dev):
    """Each backward kernel against its plain twin on the same inputs at
    every step of a 5-iteration filter on a 53x71 state (1e-4 relative
    norm an output), and two launches of each bit-equal."""
    from metal_pathtracer_tpu_torch.ops import denoise as D
    from metal_pathtracer_tpu_torch.ops.kernels import build
    from metal_pathtracer_tpu_torch.ops.kernels import denoise as K

    assert build.load().mpt_atrous_grad_threads() == K.GRAD_THREADS
    d = _grad_scene(dev, 53, 71)
    kept = []
    real = K.atrous_step_grad

    def keep(*a, **k):
        kept.append(a)
        return real(*a, **k)

    with mock.patch.object(K, "atrous_step_grad", keep):
        _learned_grads(_vendored_mlp(dev), d, 5)
    assert len(kept) == 5
    for cv, guide, p, mlp, g_out, u_out in kept:
        mlp = mlp.detach()
        g_out, u_out = K._cotangents(g_out, u_out, 53, 71, dev)
        got = K.grad_taps(cv, guide, p, mlp, g_out, u_out)
        again = K.grad_taps(cv, guide, p, mlp, g_out, u_out)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        want = D.grad_taps_reference(cv, guide, p, mlp, g_out, u_out)
        for x, y in zip(got[:4], want[:4]):
            assert _rel_norm([x], [y]) <= 1e-4
        sums = K.grad_sum(got[4])
        assert torch.equal(sums, K.grad_sum(got[4]))
        assert _rel_norm([sums], [D.grad_sum_reference(want[4])]) <= 1e-4
        assert _rel_norm([sums], [D.grad_sum_reference(got[4])]) <= 1e-6
        gather = K.grad_gather(p, *got[:4])
        assert all(torch.equal(x, y) for x, y in
                   zip(gather, K.grad_gather(p, *got[:4])))
        for x, y in zip(gather, D.grad_gather_reference(p, *got[:4])):
            assert _rel_norm([x], [y]) <= 1e-4


def test_only_the_learned_filter_trains_on_card(dev):
    from metal_pathtracer_tpu_torch.ops import denoise as D

    d = _grad_scene(dev, 16, 16)
    noisy = d["noisy"].clone().requires_grad_()
    with pytest.raises(ValueError, match="backward kernel"):
        D.svgf_denoise(noisy, d["albedo"], d["normal"], d["variance"])
    with torch.no_grad():
        D.svgf_denoise(noisy, d["albedo"], d["normal"], d["variance"])


def test_trainers_steps_on_card(dev, tmp_path):
    """Two steps of each trainer on one scene rendered on the card at
    32x32 (16x16 crops for the U-Net), each step's gradients against the
    plain version's on the same data copied to the CPU: 1e-4 relative
    norm."""
    from metal_pathtracer_tpu_torch import convert
    from metal_pathtracer_tpu_torch.ops import denoise_unet as U
    from metal_pathtracer_tpu_torch.tools import train_denoiser as td
    from metal_pathtracer_tpu_torch.tools import train_denoiser_unet as tu

    stacked = td.load_renders([td.SCENES[0]], 32, 32, 2, 4, dev,
                              str(tmp_path), log=lambda m: None)
    data = [{k: torch.from_numpy(v[0]).to(dev) for k, v in stacked.items()}]
    cpu = [{k: v.cpu() for k, v in data[0].items()}]
    params = {k: v.to(dev).requires_grad_() for k, v in td.init_params(
        torch.Generator().manual_seed(0)).items()}
    keys = ("w1", "b1", "w2", "b2")

    def tap_check(step, grads):
        same = {k: v.detach().cpu().requires_grad_()
                for k, v in params.items()}
        want = torch.autograd.grad(td.loss_fn(same, cpu),
                                   [same[k] for k in keys])
        assert _rel_norm([grads[k] for k in keys], want) <= 1e-4

    _, _, losses, _ = td.train(params, lambda p: td.loss_fn(p, data), 2,
                               log=lambda m: None, check=tap_check)
    assert np.isfinite(losses).all()

    base = tu.prepass(stacked, dev)
    feats = tu.features(base, stacked, dev)
    net = U.DenoiseUNet.from_params(convert.denoiser_params(U.init_params(
        torch.Generator().manual_seed(0)), dev))
    net.requires_grad_(True)

    def unet_check(step, batch, grads):
        on_cpu = U.DenoiseUNet.from_params(
            {k: v.detach().cpu() for k, v in net.params().items()})
        on_cpu.requires_grad_(True)
        _, want = tu.gradients(on_cpu, *(x.cpu() for x in batch))
        assert _rel_norm(list(grads.values()), list(want.values())) <= 1e-4

    losses, _ = tu.train(net, feats, base, stacked["noisy"], stacked["ref"],
                         2, crop=16, batch=2, device=dev,
                         log=lambda m: None, check=unet_check)
    assert np.isfinite(losses).all()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sharded_render_nccl_world_one_on_card(dev):
    """``parallel/mesh.py`` over an NCCL group of world size 1: the
    textured headline (subdivision 3, maxDepth 5) at 160x96, 1 spp,
    gathered bit-equal to ``render_samples`` through the kernels, and
    against the plain path: equal trace counts, the lambert image gate."""
    import torch.distributed as dist

    from metal_pathtracer_tpu_torch.parallel import mesh as mesh_ops

    settings, res, env = build_bench_scene(3, dev)
    settings.maxDepth = 5
    scene = res.build_arrays(environment=env, device=dev)
    w, h = 160, 96
    static = settings_to_static(settings, w, h, res.material_types_present(),
                                res.texture_slots_present(),
                                res.texture_uses_uv1())
    uni = settings_to_uniforms(settings, build_camera(settings, w, h, dev),
                               0, 0)
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0, device_id=dev)
    try:
        mesh = mesh_ops.make_mesh(device=dev)
        assert mesh.collective_device == dev
        slab = mesh_ops.shard_state(RenderState.create(w, h, dev), mesh)
        out = mesh_ops.render_samples_sharded(scene, uni, slab, static, 1,
                                              mesh)
        full = mesh_ops.gather_state(out, mesh)
    finally:
        dist.destroy_process_group()
    single = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                  static, 1)
    for f in mesh_ops.IMAGE_FIELDS:
        assert torch.equal(getattr(full, f), getattr(single, f).cpu()), f
    assert (out.ray_count, out.shadow_ray_count) == (single.ray_count,
                                                     single.shadow_ray_count)

    def plain_trace(o, d, t_min, t_max, bvh, tris, em, ep):
        return traverse.trace_closest_reference(o, d, float(t_min), t_max,
                                                bvh, tris, em.int(), ep.int())

    def plain_any(o, d, t_min, t_max, bvh, tris):
        return traverse.trace_any_reference(o, d, float(t_min), t_max, bvh,
                                            tris)

    with mock.patch.object(shade, "trace_closest", plain_trace), \
            mock.patch.object(traverse, "trace_any", plain_any), \
            mock.patch.object(shade, "shade_s1", shade.shade_s1_reference), \
            mock.patch.object(shade, "shade_s2", shade.shade_s2_reference), \
            mock.patch.object(shade, "texture_stage",
                              texture.texture_stage_reference):
        p = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                 static, 1)
    assert (out.ray_count, out.shadow_ray_count) == (p.ray_count,
                                                     p.shadow_ray_count)
    diff = (single.present() - p.present()).abs()
    assert float(diff.square().mean().sqrt()) < 2e-4
    assert float((diff.amax(-1) < 1e-5).float().mean()) > 0.98


def test_two_gloo_ranks_share_the_card(dev, tmp_path):
    """Two ``parallel.dryrun`` ranks over gloo, both on cuda:0, render the
    bench-class scene at 160x96: each checks itself against its own
    single render, and rank 0's gathered frame equals this process's."""
    import os
    import subprocess
    import sys

    from metal_pathtracer_tpu_torch.parallel import dryrun
    from metal_pathtracer_tpu_torch.parallel import mesh as mesh_ops

    build.load()   # the ranks only load the built library
    out = str(tmp_path / "frame.npz")
    init = f"tcp://127.0.0.1:{_free_port()}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "metal_pathtracer_tpu_torch.parallel.dryrun",
         "--backend", "gloo", "--init-method", init, "--world-size", "2",
         "--rank", str(rank), "--device", "cuda:0", "--scene", "bench",
         "--width", "160", "--height", "96", "--spp", "1", "--out", out],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(2)]
    try:
        texts = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, text) in enumerate(zip(procs, texts)):
        assert p.returncode == 0, text
        assert f"DIST_DRYRUN_OK rank={rank} world=2" in text, text
    got = np.load(out)
    scene, uni, static = dryrun.build_scene("bench", 160, 96, dev)
    single = frame.render_samples(scene, uni,
                                  RenderState.create(160, 96, dev), static, 1)
    for f in mesh_ops.IMAGE_FIELDS:
        np.testing.assert_array_equal(got[f], getattr(single, f).cpu()
                                      .numpy(), err_msg=f)
    assert (int(got["ray_count"]), int(got["shadow_ray_count"])) == \
        (single.ray_count, single.shadow_ray_count)
