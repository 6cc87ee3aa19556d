"""The plane-major layout of the texture stage's ``TEX`` planes, K2 s1's
``TRANS`` transients and K2 s2's ``CHAIN`` exports, on the CPU.

- The plain texture stage, s1 and s2 return what the kernels return: (N, k)
  views of contiguous (k, N) storage, zero off their lanes; the layout
  check the CUDA wrappers use (``build.check_planes``) accepts exactly
  that and rejects a lane-major tensor; the alignment check refuses a
  tensor that does not start on the vector loads' boundary.
- The glue that reads the planes (``nee_shadow_rays``, ``light_banks``,
  the spec-NEE ``delta_chain_estimators`` on s2's ``CHAIN``) gives the
  same bits from the plane-major planes as from lane-major copies, and
  hands the traces contiguous rays.
- The texture stage's launch constants (``TexParams``) are built once per
  depth loop, not per launch, and equal the per-launch vector the stage
  used to build (its ``_scalars``).

The textured headline (``build_bench_scene``, subdivision 2) with its HDR
sky at 40x24, one sample; the six-slot scene under the gradient sky for
the loop without a light integral. No JAX reference call: the parity of
the stages with the JAX package is held by ``test_torch_textures``,
``test_torch_tex_render`` and ``test_torch_nee_render*``.
"""

from unittest import mock

import pytest
import torch

from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops import env as env_ops
from metal_pathtracer_tpu_torch.ops import integrator
from metal_pathtracer_tpu_torch.ops.camera import build_camera
from metal_pathtracer_tpu_torch.ops.kernels import build, shade, texture
from metal_pathtracer_tpu_torch.renderer import frame
from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
from metal_pathtracer_tpu_torch.schema import (
    settings_to_static,
    settings_to_uniforms,
)
from metal_pathtracer_tpu_torch.utils.benchscene import (
    build_bench_scene,
    build_six_slot_scene,
)

W, H, SUBDIV = 40, 24, 2


def _setup(settings, res, env=None):
    scene = res.build_arrays(environment=env, device="cpu")
    static = settings_to_static(settings, W, H, res.material_types_present(),
                                res.texture_slots_present(),
                                res.texture_uses_uv1())
    uni = settings_to_uniforms(settings, build_camera(settings, W, H,
                                                      device="cpu"), 0, 0)
    return scene, static, uni


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, integrator.PathCarry):
        return integrator.PathCarry(**{k: v.clone()
                                       for k, v in vars(x).items()})
    return x


def _render(scene, static, uni):
    """One sample of the frame loop; returns the texture stage's, s1's
    and s2's calls in order, each (name, inputs as they came, output) with the
    inputs cloned, and the ``TexParams.of`` calls."""
    calls, built = [], []
    real = {"tex": shade.texture_stage, "s1": shade.shade_s1,
            "s2": shade.shade_s2}
    real_of = texture.TexParams.of

    def spy(name):
        def run(*args, **kw):
            kept = [_clone(x) for x in args], {k: _clone(x)
                                              for k, x in kw.items()}
            out = real[name](*args, **kw)
            calls.append((name, kept, out))
            return out
        return run

    def of(uniforms, static_, textures):
        built.append(real_of(uniforms, static_, textures))
        return built[-1]

    with mock.patch.object(shade, "texture_stage", spy("tex")), \
            mock.patch.object(shade, "shade_s1", spy("s1")), \
            mock.patch.object(shade, "shade_s2", spy("s2")), \
            mock.patch.object(texture.TexParams, "of", of):
        frame.render_samples(scene, uni, RenderState.create(W, H, "cpu"),
                             static, 1)
    return calls, built


@pytest.fixture(scope="module")
def headline():
    torch.set_num_threads(1)
    settings, res, env = build_bench_scene(SUBDIV, device="cpu")
    scene, static, uni = _setup(settings, res, env)
    calls, built = _render(scene, static, uni)
    return scene, static, uni, calls, built


def _first(calls, name, depth=0):
    return [c for c in calls if c[0] == name][depth]


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("name,cols", [("tex", len(texture.TEX)),
                                       ("s1", len(shade.TRANS)),
                                       ("s2", len(shade.CHAIN))])
@pytest.mark.parametrize("depth", [0, 1])
def test_plain_stages_return_plane_major(headline, name, cols, depth):
    _, _, _, calls, _ = headline
    (args, _), out = _first(calls, name, depth)[1:]
    n = W * H
    assert out.shape == (n, cols) and out.dtype == torch.float32
    assert out.t().is_contiguous() and out.stride() == (1, n)
    build.check_planes(name, out, n, cols)
    # zero off the lanes the stage fills: dead and missed lanes (s2: the
    # lanes not alive after s1, which are all hits)
    lanes = args[0].alive & (args[2] >= 0)
    assert (out[~lanes] == 0).all() and (out[lanes] != 0).any()
    if name == "s2":
        assert torch.equal(lanes, args[0].alive)
        assert (~lanes).any()


def test_check_planes_accepts_plane_major_only():
    n, cols = 37, 15
    build.check_planes("x", build.planes(n, cols, "cpu"), n, cols)
    build.check_planes("x", torch.zeros(cols, n).t(), n, cols)
    bad = {"lane-major": torch.zeros(n, cols),
           "a lane-major copy": torch.zeros(cols, n).t().contiguous(),
           "float64": torch.zeros(cols, n, dtype=torch.float64).t(),
           "too few columns": torch.zeros(cols - 1, n).t(),
           "a strided view": torch.zeros(cols, 2 * n).t()[::2]}
    for what, x in bad.items():
        with pytest.raises(ValueError, match="plane-major"):
            build.check_planes(what, x, n, cols)


def test_check_aligned_refuses_an_offset_tensor():
    base = torch.zeros(65)
    build.check_aligned("x", [base, base[4:]], 16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        build.check_aligned("x", [base[1:]], 16)
    build.check_aligned("x", [base[2:]], 8)


def test_nee_shadow_rays_layout_independent(headline):
    scene, static, uni, calls, _ = headline
    (args, _), trans = _first(calls, "s1")[1:]
    tex = args[11]
    t = args[1]
    e_dir, _, e_pdf, e_valid = env_ops.sample_environment_from_uniforms(
        scene.environment, trans[:, 0], trans[:, 1], trans[:, 2], uni,
        static)
    got = shade.nee_shadow_rays(trans, t, e_dir, e_pdf, e_valid, tex)
    want = shade.nee_shadow_rays(trans.contiguous(), t, e_dir, e_pdf,
                                 e_valid, tex.contiguous())
    assert got[0].is_contiguous()
    assert int(got[2].sum()) > 0
    for a, b in zip(got, want):
        assert _same_bits(a, b)


def test_light_banks_layout_independent(headline):
    scene, static, uni, calls, _ = headline
    for depth in (0, 1):
        (args, _), trans = _first(calls, "s1", depth)[1:]
        tex, t = args[11], args[1]
        esmp, shadow = shade.light_banks(scene, uni, static, trans, t, tex)
        esmp_l, shadow_l = shade.light_banks(scene, uni, static,
                                             trans.contiguous(), t,
                                             tex.contiguous())
        assert _same_bits(esmp, esmp_l)
        assert int(shadow) == int(shadow_l) > 0


def test_chain_estimators_layout_independent(headline):
    """``delta_chain_estimators`` gives the same bits from s2's plane-major
    CHAIN as from a lane-major copy (the depth loop's call)."""
    scene, static, uni, calls, _ = headline
    idx = shade.CHAIN_IDX
    for depth in (0, 1):
        (args, kw), chain = _first(calls, "s2", depth)[1:]
        carry = _clone(args[0])
        shade.shade_s2(carry, *args[1:], **kw)
        params = shade.ShadeParams.of(uni, static, scene.environment)
        got, want = (shade.specnee.delta_chain_estimators(
            scene, uni, static, params.clamp, args[0].throughput,
            carry.ray_d, carry.last_delta, ch[:, 0:3], ch[:, idx["dpdf"]],
            ch[:, idx["medev"]], carry.ray_o, ch[:, idx["active"]] > 0.5)
            for ch in (chain, chain.contiguous()))
        assert not chain.is_contiguous()
        assert (got[0] != 0).any()
        for a, b in zip(got, want):
            assert _same_bits(a, b)


def _old_scalars(uni, static, textures, depth):
    """The launch vector the texture wrapper built on every call before
    ``TexParams`` (its ``_scalars``)."""
    cam = uni.camera
    return [float(depth), float(static.width), float(static.height),
            *cam.horizontal.tolist(), *cam.vertical.tolist(),
            float(static.working_color_space),
            float(sum(1 << s for s in static.texture_slots)),
            float(static.texture_uv1), float(static.debug_disable_ao),
            float(static.debug_ao_indirect_only),
            float(static.debug_disable_normal_map),
            float(static.debug_disable_orm),
            float(static.debug_flip_normal_green),
            float(uni.debug_normal_strength_scale), textures.max_lod]


def _check_built_once(scene, static, uni, calls, built):
    stages = [c for c in calls if c[0] == "tex"]
    assert len(built) == 1 and len(stages) > 1
    for _, (args, _), _ in stages:
        depth, params = args[8], args[9]
        assert params is built[0]
        assert params.scalars(depth) == _old_scalars(uni, static,
                                                     scene.textures, depth)


def test_tex_params_built_once_per_nee_loop(headline):
    scene, static, uni, calls, built = headline
    _check_built_once(scene, static, uni, calls, built)


def test_tex_params_built_once_per_fused_loop():
    """The loop without a light integral: the six-slot scene under the
    gradient sky (every slot bound, UV set 1 in use)."""
    settings, res = build_six_slot_scene()
    settings.maxDepth = 3
    scene, static, uni = _setup(settings, res)
    assert not (integrator.env_nee(scene, static)
                or integrator.rect_nee(scene))
    calls, built = _render(scene, static, uni)
    _check_built_once(scene, static, uni, calls, built)
    assert C.MATERIAL_PBR in static.material_types
