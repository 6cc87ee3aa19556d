"""Scene build and state conversion: the port's jax-free builder vs
``SceneResources.build_arrays()`` of the JAX package, bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from metal_pathtracer_tpu import constants as C
from metal_pathtracer_tpu.ops.camera import build_camera as jax_camera
from metal_pathtracer_tpu.renderer.accumulation import RenderState as JState
from metal_pathtracer_tpu.scene.resources import Material as JMaterial
from metal_pathtracer_tpu.scene.resources import SceneResources as JResources
from metal_pathtracer_tpu.schema import settings_to_static as jax_static
from metal_pathtracer_tpu.schema import settings_to_uniforms as jax_uniforms
from metal_pathtracer_tpu.settings import BackgroundMode, RenderSettings
from metal_pathtracer_tpu.utils import procgen as jax_procgen
from metal_pathtracer_tpu.utils.benchscene import build_bench_scene as jax_bench
from metal_pathtracer_tpu.utils.procgen import dragon_class_scene_mesh
from metal_pathtracer_tpu_torch import convert
from metal_pathtracer_tpu_torch.ops import bsdf, integrator
from metal_pathtracer_tpu_torch.ops import env as env_ops
from metal_pathtracer_tpu_torch.ops.textures import build_texture_arrays
from metal_pathtracer_tpu_torch.scene.resources import (
    Material,
    Mesh,
    SceneResources,
)
from metal_pathtracer_tpu_torch.schema import (
    settings_to_static,
    settings_to_uniforms,
)
from metal_pathtracer_tpu_torch.utils import procgen
from metal_pathtracer_tpu_torch.utils.benchscene import (
    build_bench_scene,
    build_untextured_bench_scene,
)

MATERIALS = [
    dict(base_color=(0.7, 0.7, 0.7)),
    dict(base_color=(1.4, -0.2, 0.5), roughness=0.3, name="clamped"),
    dict(mat_type=C.MATERIAL_METAL, base_color=(0.9, 0.8, 0.6),
         roughness=0.2, conductor_eta=(0.2, 0.9, 1.1)),
    dict(mat_type=C.MATERIAL_PLASTIC, coat_roughness=0.3, coat_thickness=0.4,
         coat_absorption=(0.2, 0.1, 0.05), ior=1.6),
    dict(mat_type=C.MATERIAL_CARPAINT, carpaint_flake_sample_weight=0.4,
         carpaint_flake_reflectance=0.5, carpaint_has_base_conductor=True,
         carpaint_base_eta=(1.3, 0.9, 0.6), carpaint_base_k=(7.4, 6.4, 5.3)),
    dict(mat_type=C.MATERIAL_PBR, pbr_metallic=0.8, pbr_alpha=0.4,
         pbr_double_sided=True, emission=(0.5, 0.4, 0.3)),
]


def _port_mesh(jm):
    return Mesh(**{f.name: getattr(jm, f.name)
                   for f in dataclasses.fields(Mesh)})


def _np(obj):
    """A JAX pytree dataclass as a dict of numpy arrays (nested)."""
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj):
        return {f.name: _np(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)) or np.isscalar(obj):
        return obj
    return np.asarray(obj)


@pytest.fixture(scope="module")
def scenes():
    meshes = [dragon_class_scene_mesh(3, material=0),
              dragon_class_scene_mesh(1, material=1)]
    meshes[1].vertices = meshes[1].vertices * 0.5 + 2.0
    jr, pr = JResources(), SceneResources()
    for kw in MATERIALS:
        jr.add_material(JMaterial(**kw))
        pr.add_material(Material(**kw))
    for m in meshes:
        jr.add_mesh(m)
        pr.add_mesh(_port_mesh(m))
    return jr, jr.build_arrays(), pr, pr.build_arrays(device="cpu")


def _assert_fields_equal(port_obj, jax_obj, fields):
    for f in fields:
        got = getattr(port_obj, f).numpy()
        ref = np.asarray(getattr(jax_obj, f))
        assert got.dtype == ref.dtype, f
        np.testing.assert_array_equal(got, ref, err_msg=f)


def test_triangles_bitexact(scenes):
    _, js, _, ps = scenes
    names = [f.name for f in dataclasses.fields(ps.triangles)]
    _assert_fields_equal(ps.triangles, js.triangles, names)
    np.testing.assert_array_equal(ps.triangles.shade_packed.numpy()[:, :22],
                                  np.asarray(js.triangles.shade_packed)[:, :22])


def test_materials_bitexact(scenes):
    _, js, _, ps = scenes
    _assert_fields_equal(ps.materials, js.materials,
                         [f.name for f in dataclasses.fields(ps.materials)])


def test_bvh_bitexact(scenes):
    _, js, _, ps = scenes
    _assert_fields_equal(ps.tri_bvh, js.tri_bvh,
                         [f.name for f in dataclasses.fields(ps.tri_bvh)])


def test_material_types_present(scenes):
    jr, _, pr, _ = scenes
    assert pr.material_types_present() == jr.material_types_present()


def test_convert_scene_roundtrip(scenes):
    _, js, _, ps = scenes
    d = {"materials": _np(js.materials), "triangles": _np(js.triangles),
         "tri_bvh": _np(js.tri_bvh), "spheres": _np(js.spheres),
         "rects": _np(js.rects)}
    conv = convert.scene_arrays(d, "cpu")
    back = convert.to_numpy(conv)
    for part in ("materials", "triangles", "tri_bvh"):
        for k, v in back[part].items():
            np.testing.assert_array_equal(v, d[part][k], err_msg=f"{part}.{k}")
    _assert_fields_equal(conv.tri_bvh, ps.tri_bvh,
                         [f.name for f in dataclasses.fields(ps.tri_bvh)])


def test_convert_uniforms_static_state():
    s = RenderSettings()
    s.backgroundMode = BackgroundMode.SOLID
    s.backgroundColor = (0.9, 0.6, 0.3)
    s.fireflyClampFactor = 12.3
    s.maxDepth = 6
    cam = jax_camera(s, 40, 24)
    ju = jax_uniforms(s, cam, 3, 5)
    pu = convert.uniforms(_np(ju), "cpu")
    assert (pu.frame_index, pu.sample_count, pu.fixed_rng_seed) == (3, 5, 0)
    assert pu.background_color == tuple(
        float(c) for c in np.asarray(ju.background_color))
    assert pu.firefly_clamp_factor == float(np.asarray(
        ju.firefly_clamp_factor))
    for f in ("origin", "lower_left", "horizontal", "vertical", "u", "v"):
        np.testing.assert_array_equal(getattr(pu.camera, f).numpy(),
                                      np.asarray(getattr(cam, f)))
    st = jax_static(s, 40, 24, [0])
    assert convert.static_config(dataclasses.asdict(st)) == \
        settings_to_static(s, 40, 24, [0])
    js = JState.create(4, 3)
    js = js.replace(sample_count=js.sample_count + 7,
                    radiance_sum=js.radiance_sum + 0.25)
    d = _np(js)
    ps = convert.render_state(d, "cpu")
    back = convert.to_numpy(ps)
    for k in ("radiance_sum", "albedo", "normal", "radiance_sq_sum"):
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
    np.testing.assert_array_equal(back["sample_count"], d["sample_count"])
    assert ps.frame_index == 0 and ps.ray_count == 0


def test_unported_features_raise():
    r = SceneResources()
    r.add_material(Material())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        r.add_mesh_instance(None, np.eye(4))
    # a texture that needs a resample (ported): 48x20 snaps to 32x16 and
    # the atlas equals the JAX package's, Pillow's bilinear resize included
    from metal_pathtracer_tpu.ops.textures import (
        build_texture_arrays as jax_atlas,
    )

    img = np.random.default_rng(4).integers(0, 256, (20, 48, 4),
                                            dtype=np.uint8)
    got = build_texture_arrays([img], [True], device="cpu")
    want = jax_atlas([img], [True])
    assert (int(got.level_w[0, 0]), int(got.level_h[0, 0])) == (32, 16)
    np.testing.assert_array_equal(got.texels.numpy(),
                                  np.asarray(want.texels))
    # plastic (ported) samples instead of raising
    r.materials[0].mat_type = C.MATERIAL_PLASTIC
    m = bsdf.gather_material(r.build_materials_soa("cpu"), torch.zeros(2))
    up = torch.tensor([[0.0, 0.0, 1.0]] * 2)
    state, smp = bsdf.sample_bsdf(
        m, up, up, -up, torch.ones(2, dtype=torch.bool),
        torch.zeros(2, dtype=torch.long),
        bsdf.make_clamp_params(settings_to_uniforms(RenderSettings(), None,
                                                    0, 0)),
        torch.ones(2), (C.MATERIAL_PLASTIC,), position=torch.zeros(2, 3))
    assert (state != 0).all() and (smp.pdf > 0.0).all()
    s = RenderSettings()
    s.backgroundMode = BackgroundMode.ENVIRONMENT
    env = env_ops.environment_from_texels(np.ones((4, 8, 3), np.float32),
                                          "cpu")
    r.add_mesh(_port_mesh(dragon_class_scene_mesh(0)))
    scene = r.build_arrays(environment=env, device="cpu")
    integrator.check_supported(
        scene, settings_to_static(s, 8, 8, [C.MATERIAL_PLASTIC]))
    # MNEE (ported) passes, its secondary chain on by default
    s.enableMnee = True
    static = settings_to_static(s, 8, 8, [0])
    assert static.enable_mnee and static.enable_mnee_secondary
    integrator.check_supported(scene, static)
    s.enableMnee = False
    # debugSpecularOnly (ported: a K2 flag) passes
    s.debugSpecularOnly = True
    integrator.check_supported(scene, settings_to_static(s, 8, 8, [0]))
    s.debugSpecularOnly = False
    integrator.check_supported(scene, settings_to_static(
        s, 8, 8, [0, C.MATERIAL_METAL, C.MATERIAL_DIELECTRIC,
                  C.MATERIAL_DIFFUSE_LIGHT, C.MATERIAL_PBR]))


def _assert_arrays_equal(got, ref, label):
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.dtype == b.dtype, (label, i)
        np.testing.assert_array_equal(a, b, err_msg=f"{label}[{i}]")


@pytest.mark.parametrize("n", range(6))
def test_procgen_bitexact(n):
    """The port's vectorised subdivision: the JAX package's edge-loop
    icosphere and displaced icosphere, vertices, normals and faces bit for
    bit (the same numbering, so the same triangle order)."""
    _assert_arrays_equal(procgen.icosphere(n), jax_procgen.icosphere(n),
                         "icosphere")
    _assert_arrays_equal(procgen.dragon_class_mesh(n),
                         jax_procgen.dragon_class_mesh(n), "dragon")


def test_untextured_bench_scene_bitexact():
    """``build_untextured_bench_scene`` against the JAX bench scene cleared
    as ``tests/test_fused_shade.py _bench_like_scene(False)`` clears it, at
    subdivision 2: settings, triangles, materials, BVH and environment."""
    js_settings, jres, jenv = jax_bench(subdivisions=2)
    jres.texture_images.clear()
    jres.texture_srgb.clear()
    jres.texture_wrap.clear()
    for m in jres.materials:
        m.texture_indices = (-1, -1, -1, -1, -1, -1)
    settings, res, env = build_untextured_bench_scene(2, device="cpu")
    assert vars(settings) == vars(js_settings)
    assert res.material_types_present() == jres.material_types_present()
    js = jres.build_arrays(environment=jenv)
    ps = res.build_arrays(environment=env, device="cpu")
    for part in ("triangles", "materials", "tri_bvh"):
        _assert_fields_equal(getattr(ps, part), getattr(js, part),
                             [f.name for f in dataclasses.fields(
                                 getattr(ps, part))])
    for f in dataclasses.fields(ps.environment):
        got, ref = getattr(ps.environment, f.name), getattr(js.environment,
                                                            f.name)
        if f.name == "mips":
            _assert_arrays_equal([m.numpy() for m in got],
                                 [np.asarray(m) for m in ref], "mips")
        elif isinstance(got, torch.Tensor):
            _assert_fields_equal(ps.environment, js.environment, [f.name])
        else:
            assert tuple(got) == tuple(ref) if f.name == "mip_meta" \
                else got == ref, f.name


def test_textured_bench_scene_bitexact():
    """``build_bench_scene`` with its 512x512 sRGB checker against the JAX
    bench scene at subdivision 2: settings, triangles, materials, BVH, the
    texture atlas and the static texture facts, bit for bit."""
    js_settings, jres, jenv = jax_bench(subdivisions=2)
    settings, res, env = build_bench_scene(2, device="cpu")
    assert vars(settings) == vars(js_settings)
    assert res.texture_slots_present() == jres.texture_slots_present() == [0]
    assert res.texture_uses_uv1() is jres.texture_uses_uv1() is False
    js = jres.build_arrays(environment=jenv)
    ps = res.build_arrays(environment=env, device="cpu")
    for part in ("triangles", "materials", "tri_bvh", "textures"):
        _assert_fields_equal(getattr(ps, part), getattr(js, part),
                             [f.name for f in dataclasses.fields(
                                 getattr(ps, part))
                              if f.name not in ("n_textures", "max_levels")])
    assert (ps.textures.n_textures, ps.textures.max_levels) == \
        (js.textures.n_textures, js.textures.max_levels) == (1, 10)
    assert convert.static_config(dataclasses.asdict(jax_static(
        js_settings, 8, 8, jres.material_types_present(),
        jres.texture_slots_present(), jres.texture_uses_uv1()))) == \
        settings_to_static(settings, 8, 8, res.material_types_present(),
                           res.texture_slots_present(),
                           res.texture_uses_uv1())
