"""The port's texture atlas, texture sampling and texture stage against the
JAX package's on the CPU, with inputs made from numpy seeds.

- The atlas (sRGB decode, mip chain, tables) bit for bit.
- ``sample_texture`` on 4,096 lanes: texture ids from -1 (white) to T-1,
  u and v in [-3, 3] (every wrap mode on negative coordinates), LOD in
  [-1, max + 1].
- The texture stage (``texture_stage_reference`` over the port's
  ``apply_pbr_textures``) against the JAX package's ``_texture_stage``
  (``ops/pallas/shade.py:3600``, jitted as the render runs it) on a
  wavefront traced on the port's ``build_six_slot_scene`` (built by both
  packages from the same fields), which binds all six slots: a normal map on a
  mesh with tangents of handedness +1 and -1 and on one with zero tangents
  (the ONB fallback), ORM, occlusion, emissive and transmission, UV set 1
  and a KHR transform, a MASK and a BLEND material; at depth 0 (Igehy
  gradients) and depth 2 (ray cone), in linear sRGB and ACEScg.

The RNG state, ``tpass`` and ``tpbr`` must be equal. The other planes are
held to 2e-6 absolute: XLA:CPU contracts the bilinear lerps and the
barycentric sums into FMAs at places the port's fused multiply-adds
reproduce only most of the time, and its log2 and sqrt are not the libm
ones, so a sampled colour or a normal may differ in its last bits (at
most a few ulp of values below 2 in magnitude, measured).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_pathtracer_tpu.ops import textures as jax_tex
from metal_pathtracer_tpu.ops.pallas import shade as jax_shade
from metal_pathtracer_tpu.scene.resources import Material as JMaterial
from metal_pathtracer_tpu.scene.resources import Mesh as JMesh
from metal_pathtracer_tpu.scene.resources import SceneResources as JResources
from metal_pathtracer_tpu.schema import settings_to_static as jax_static
from metal_pathtracer_tpu.schema import settings_to_uniforms as jax_uniforms
from metal_pathtracer_tpu.ops.camera import build_camera as jax_camera
from metal_pathtracer_tpu.utils.benchscene import checker_texture
from metal_pathtracer_tpu_torch import constants as PC
from metal_pathtracer_tpu_torch import convert
from metal_pathtracer_tpu_torch.ops import camera as camera_ops
from metal_pathtracer_tpu_torch.ops import integrator
from metal_pathtracer_tpu_torch.ops import rng as rng_ops
from metal_pathtracer_tpu_torch.ops import textures as tex_ops
from metal_pathtracer_tpu_torch.ops.kernels import texture, traverse
from metal_pathtracer_tpu_torch.utils.benchscene import build_six_slot_scene
from test_torch_scene import _np

PLANE_ATOL = 2e-6
W, H = 48, 32


def test_atlas_bitexact():
    """The 512x512 sRGB checker of the headline, and two linear RGBA
    textures (64x16 and 16x64) under wrap modes (0,1) and (2,0)."""
    rng = np.random.default_rng(4)
    wide = rng.integers(0, 256, (16, 64, 4), dtype=np.uint8)
    tall = rng.integers(0, 256, (64, 16, 4), dtype=np.uint8)
    for images, srgb, wraps in (([checker_texture()], [True], None),
                                ([wide, tall], [False, False],
                                 [(0, 1), (2, 0)])):
        ref = jax_tex.build_texture_arrays(images, srgb, wraps)
        got = tex_ops.build_texture_arrays(images, srgb, wraps, device="cpu")
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(ref, f.name)
            if isinstance(a, torch.Tensor):
                b = np.asarray(b)
                assert a.numpy().dtype == b.dtype, f.name
                np.testing.assert_array_equal(a.numpy(), b, err_msg=f.name)
            else:
                assert a == b, f.name


def test_sample_texture_matches_jax():
    _, res = build_six_slot_scene(0)
    images, srgb, wraps = res.texture_images, res.texture_srgb, \
        res.texture_wrap
    ref = jax_tex.build_texture_arrays(images, srgb, wraps)
    atlas = convert.textures(_np(ref), "cpu")
    rng = np.random.default_rng(8)
    n = 4096
    tid = rng.integers(-1, len(images), n).astype(np.int32)
    u, v = (rng.uniform(-3.0, 3.0, n).astype(np.float32) for _ in range(2))
    lod = rng.uniform(-1.0, ref.max_lod + 1.0, n).astype(np.float32)
    want = np.asarray(jax.jit(jax_tex.sample_texture)(
        ref, jnp.asarray(tid), jnp.asarray(u), jnp.asarray(v),
        jnp.asarray(lod)))
    got = tex_ops.sample_texture(atlas, torch.from_numpy(tid),
                                 torch.from_numpy(u), torch.from_numpy(v),
                                 torch.from_numpy(lod)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PLANE_ATOL)
    assert (got[tid < 0] == 1.0).all()
    assert (u < 0).any() and (lod > ref.max_lod).any() and (lod < 0).any()


def _jax_resources(port_res):
    """The JAX package's twin of a port ``SceneResources``: the same
    material and mesh fields, the same images."""
    jres = JResources()
    for m in port_res.materials:
        jres.add_material(JMaterial(**dataclasses.asdict(m)))
    for m in port_res.meshes:
        jres.add_mesh(JMesh(**vars(m)))
    jres.texture_images.extend(port_res.texture_images)
    jres.texture_srgb.extend(port_res.texture_srgb)
    jres.texture_wrap.extend(port_res.texture_wrap)
    return jres


@pytest.fixture(scope="module")
def six_slots():
    settings, port_res = build_six_slot_scene()
    jres = _jax_resources(port_res)
    js = jres.build_arrays()
    ju = jax_uniforms(settings, jax_camera(settings, W, H), 0, 0)
    scene = convert.scene_arrays(_np(js), "cpu")
    uni = convert.uniforms(_np(ju), "cpu")
    assert port_res.texture_slots_present() == \
        jres.texture_slots_present() == list(range(6))
    assert port_res.texture_uses_uv1() and jres.texture_uses_uv1()
    return dict(settings=settings, jres=jres, js=js, ju=ju, scene=scene,
                uni=uni, port_res=port_res)


def test_six_slot_scene_builds_like_jax(six_slots):
    """The port builds the same atlas, materials and triangles from its
    own classes."""
    ps = six_slots["port_res"].build_arrays(device="cpu")
    want = six_slots["scene"]
    for part in ("textures", "materials", "triangles"):
        for f in dataclasses.fields(getattr(ps, part)):
            a, b = getattr(getattr(ps, part), f.name), \
                getattr(getattr(want, part), f.name)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), (part, f.name)
            else:
                assert a == b, (part, f.name)


def _wavefront(scene, uni, static, seed=5):
    """Primary rays of the frame, every ninth lane dead, traced by the
    port's K1 (dead lanes trace with t_max 0 and miss)."""
    n = W * H
    flat = torch.arange(n)
    xs, ys = flat % W, flat // W
    s = rng_ops.make_seed(seed, 0, xs, ys, 0, torch.zeros_like(xs))
    state, ro, rd = camera_ops.generate_primary_rays(uni.camera, xs, ys, W,
                                                     H, s)
    carry = integrator.PathCarry.start(
        state, ro, rd, 0.0, integrator._primary_cone_spread(uni, static))
    carry.alive[::9] = False
    carry.cone_width.copy_(torch.linspace(0.0, 2e-3, n))
    hit = traverse.trace_closest(
        carry.ray_o, carry.ray_d, PC.EPSILON_T,
        torch.where(carry.alive, PC.INFINITY_T, 0.0), scene.tri_bvh,
        scene.triangles)
    return carry, hit


@pytest.mark.parametrize("depth,space", [(0, 0), (2, 0), (2, 1)])
def test_texture_stage_matches_jax(six_slots, depth, space):
    settings = dataclasses.replace(six_slots["settings"],
                                   workingColorSpace=space)
    jres = six_slots["jres"]
    jst = jax_static(settings, W, H, jres.material_types_present(),
                     jres.texture_slots_present(), jres.texture_uses_uv1())
    static = convert.static_config(dataclasses.asdict(jst))
    scene, uni = six_slots["scene"], six_slots["uni"]
    carry, (t, tri, u, v) = _wavefront(scene, uni, static)
    state0 = carry.state.clone()
    planes = texture.texture_stage(carry, t, tri, u, v, scene, uni, static,
                                   depth)

    J = lambda x: jnp.asarray(x.numpy())
    stage = jax.jit(lambda sc, un, *a: jax_shade._texture_stage(
        sc, un, jst, *a[:8], depth, lambda x: x, a[8]))
    want, want_state = stage(
        six_slots["js"], six_slots["ju"], J(carry.cone_width),
        J(carry.cone_spread), J(carry.ray_o), J(carry.ray_d), J(t), J(tri),
        J(u), J(v), J(state0).astype(jnp.uint32))
    want = np.asarray(want).T
    got = planes.numpy()
    idx = texture.TEX_IDX
    tpbr = want[:, idx["tpbr"]] > 0.5
    # every material kind of the scene is on screen, and lanes discard
    mat = scene.triangles.material[tri.clamp_min(0).long()].numpy()
    for m in range(5):
        assert ((tri.numpy() >= 0) & (mat == m)).sum() > 20, m
    assert 0 < want[:, idx["tpass"]].sum() < tpbr.sum()
    for name in ("tpass", "tpbr"):
        np.testing.assert_array_equal(got[:, idx[name]],
                                      want[:, idx[name]], err_msg=name)
    sel = (carry.alive & (tri >= 0)).numpy()
    np.testing.assert_array_equal(
        carry.state.numpy(),
        np.where(sel, np.asarray(want_state).astype(np.int64),
                 state0.numpy()))
    assert (carry.state != state0).any()
    # identity planes off the textured lanes; the JAX stage's values there
    # are read by no kernel
    assert (got[~tpbr] == 0.0).all()
    np.testing.assert_allclose(got[tpbr], want[tpbr], rtol=0,
                               atol=PLANE_ATOL)
