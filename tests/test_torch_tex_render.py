"""The port's textured environment-NEE path end to end vs the JAX package:
the textured headline scene (``tests/test_fused_shade.py``
``_bench_like_scene(True)``: the HDR sun/sky with alias NEE, the
absorbing glass sphere, the PBR sphere with its 512x512 sRGB checker, the
lambert dragon and ground) at subdivisions 3, 40x24, 2 spp, maxDepth 5,
each package building the scene with its own code, under the gate of
``test_torch_nee_render.py`` (ray and shadow counts within max(4, 1e-4 *
count), RMSE < 5e-3, more than 95 % of pixels within 1e-4). One JAX
render in the file.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from metal_pathtracer_tpu.ops.camera import build_camera as jax_camera
from metal_pathtracer_tpu.renderer import frame as jax_frame
from metal_pathtracer_tpu.renderer.accumulation import RenderState as JState
from metal_pathtracer_tpu.schema import settings_to_static as jax_static
from metal_pathtracer_tpu.schema import settings_to_uniforms as jax_uniforms
from metal_pathtracer_tpu.utils.benchscene import build_bench_scene as jax_bench
from metal_pathtracer_tpu_torch.ops.camera import build_camera
from metal_pathtracer_tpu_torch.ops.kernels import shade, texture
from metal_pathtracer_tpu_torch.renderer import frame
from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
from metal_pathtracer_tpu_torch.schema import (
    settings_to_static,
    settings_to_uniforms,
)
from metal_pathtracer_tpu_torch.utils.benchscene import (
    build_bench_scene,
    build_untextured_bench_scene,
)
from test_torch_nee_render import assert_matches_jax
from test_torch_render import _run

W, H, SPP, SUBDIV, DEPTH = 40, 24, 2, 3, 5


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jax_render():
    settings, res, environment = jax_bench(subdivisions=SUBDIV)
    settings.maxDepth = DEPTH
    scene = res.build_arrays(environment=environment)
    static = jax_static(settings, W, H, res.material_types_present(),
                        res.texture_slots_present(), res.texture_uses_uv1())
    uni = jax_uniforms(settings, jax_camera(settings, W, H), 0, 0)
    st = jax_frame.render_samples(scene, uni, JState.create(W, H), static,
                                  SPP)
    return (np.asarray(st.present()), float(np.asarray(st.ray_count)),
            float(np.asarray(st.shadow_ray_count)))


def _port_render(make_scene):
    settings, res, env = make_scene(SUBDIV, device="cpu")
    settings.maxDepth = DEPTH
    scene = res.build_arrays(environment=env, device="cpu")
    static = settings_to_static(settings, W, H, res.material_types_present(),
                                res.texture_slots_present(),
                                res.texture_uses_uv1())
    uni = settings_to_uniforms(settings, build_camera(settings, W, H,
                                                      device="cpu"), 0, 0)
    return frame.render_samples(scene, uni, RenderState.create(W, H, "cpu"),
                                static, SPP)


@pytest.fixture(scope="module")
def renders():
    torch.set_num_threads(1)
    textured_lanes = []
    real_stage = shade.texture_stage

    def spy(carry, *args):
        planes = real_stage(carry, *args)
        textured_lanes.append(int((planes[:, texture.TEX_IDX["tpbr"]]
                                   > 0.5).sum()))
        return planes

    before = texture.texture_stage.launches
    with mock.patch.object(shade, "texture_stage", spy):
        port = _port_render(build_bench_scene)
    return dict(port=port, jax=_jax_render(),
                untextured=_port_render(build_untextured_bench_scene),
                textured_lanes=textured_lanes, before=before)


def test_tex_render_matches_jax(renders):
    assert_matches_jax(renders)


def test_tex_render_ran_the_texture_stage(renders):
    """The stage ran at every depth of every sample, shaded textured lanes,
    launched no kernel on the CPU, and the checker sphere's pixels (where
    the first-hit albedo differs from the untextured scene's) differ from
    the untextured render."""
    p, u = renders["port"], renders["untextured"]
    lanes = renders["textured_lanes"]
    assert len(lanes) >= SPP and sum(lanes) > 0
    assert texture.texture_stage.launches == renders["before"]
    img = p.present().numpy()
    assert np.isfinite(img).all() and img.max() > 0.0
    assert (p.sample_count.numpy() == SPP).all()
    checker = np.abs(p.albedo.numpy() - u.albedo.numpy()).max(-1) > 1e-3
    assert 10 <= checker.sum() < W * H // 2
    diff = np.abs(img - u.present().numpy()).max(-1)
    assert float(diff[checker].mean()) > 1e-2
    assert float((diff[checker] > 1e-4).mean()) > 0.9


def test_textured_render_without_jax():
    """The textured headline renders 16x16 through ``frame.render_samples``
    on the CPU, texture stage included, without loading jax, flax or any
    module of the JAX package."""
    proc = _run("""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from metal_pathtracer_tpu_torch.ops.camera import build_camera
        from metal_pathtracer_tpu_torch.renderer import frame
        from metal_pathtracer_tpu_torch.renderer.accumulation import (
            RenderState)
        from metal_pathtracer_tpu_torch.schema import (
            settings_to_static, settings_to_uniforms)
        from metal_pathtracer_tpu_torch.utils.benchscene import (
            build_bench_scene)
        settings, res, env = build_bench_scene(1, device="cpu")
        settings.maxDepth = 3
        scene = res.build_arrays(environment=env, device="cpu")
        assert scene.textures is not None
        static = settings_to_static(settings, 16, 16,
                                    res.material_types_present(),
                                    res.texture_slots_present(),
                                    res.texture_uses_uv1())
        uni = settings_to_uniforms(
            settings, build_camera(settings, 16, 16, "cpu"), 0, 0)
        st = frame.render_samples(scene, uni,
                                  RenderState.create(16, 16, "cpu"), static,
                                  1)
        img = st.present().numpy()
        assert np.isfinite(img).all() and img.max() > 0
        assert st.ray_count >= 256 and st.shadow_ray_count > 0
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                      "metal_pathtracer_tpu")]
        assert not bad, bad
        print("OK")
    """)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")
