"""The port's ``render_samples`` vs the JAX package's on the lambert scene
of ``tests/test_fused_shade.py:76-87`` at maxDepth 8, plus the port's
import hygiene (no JAX, no nvcc needed on the CPU)."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from metal_pathtracer_tpu.ops.camera import build_camera as jax_camera
from metal_pathtracer_tpu.renderer import frame as jax_frame
from metal_pathtracer_tpu.renderer.accumulation import RenderState as JState
from metal_pathtracer_tpu.scene.resources import Material as JMaterial
from metal_pathtracer_tpu.scene.resources import SceneResources as JResources
from metal_pathtracer_tpu.schema import settings_to_static as jax_static
from metal_pathtracer_tpu.schema import settings_to_uniforms as jax_uniforms
from metal_pathtracer_tpu.settings import RenderSettings
from metal_pathtracer_tpu.utils.procgen import dragon_class_scene_mesh
from metal_pathtracer_tpu_torch import convert
from metal_pathtracer_tpu_torch.ops.camera import build_camera
from metal_pathtracer_tpu_torch.renderer import frame
from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
from metal_pathtracer_tpu_torch.scene.resources import (
    Material,
    Mesh,
    SceneResources,
)
from metal_pathtracer_tpu_torch.schema import (
    settings_to_static,
    settings_to_uniforms,
)

W, H, SPP = 40, 24, 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _settings():
    s = RenderSettings()
    s.cameraTarget = (0.0, 0.0, 0.0)
    s.cameraDistance = 3.2
    s.cameraYaw = 0.4
    s.cameraPitch = 0.25
    s.maxDepth = 8
    s.fixedRngSeed = 1234
    return s


@pytest.fixture(scope="module")
def renders():
    """One JAX reference render (2 spp) and the port's, from one scene."""
    s = _settings()
    jm = dragon_class_scene_mesh(2, material=0)
    jr, pr = JResources(), SceneResources()
    jr.add_material(JMaterial(base_color=(0.7, 0.7, 0.7)))
    pr.add_material(Material(base_color=(0.7, 0.7, 0.7)))
    jr.add_mesh(jm)
    pr.add_mesh(Mesh(**{f.name: getattr(jm, f.name)
                        for f in dataclasses.fields(Mesh)}))
    js, ps = jr.build_arrays(), pr.build_arrays(device="cpu")
    j_static = jax_static(s, W, H, jr.material_types_present())
    j_uni = jax_uniforms(s, jax_camera(s, W, H), 0, 0)
    j_one = jax_frame.render_samples(js, j_uni, JState.create(W, H), j_static,
                                     1)
    j_two = jax_frame.render_samples(js, j_uni, j_one, j_static, 1)
    p_static = settings_to_static(s, W, H, pr.material_types_present())
    p_uni = settings_to_uniforms(s, build_camera(s, W, H, "cpu"), 0, 0)
    p_two = frame.render_samples(ps, p_uni, RenderState.create(W, H, "cpu"),
                                 p_static, SPP)
    return dict(ps=ps, p_uni=p_uni, p_static=p_static, j_one=j_one,
                j_two=j_two, p_two=p_two)


def _gate(img, ref, rays, rays_ref):
    """tests/test_fused_shade.py:60-73's gate."""
    assert abs(rays - rays_ref) <= max(4.0, 1e-4 * rays_ref)
    d = np.abs(img - ref)
    rmse = float(np.sqrt((d * d).mean()))
    assert rmse < 2e-4, rmse
    assert float((d.max(-1) < 1e-5).mean()) > 0.98


def test_render_samples_image_gate(renders):
    j, p = renders["j_two"], renders["p_two"]
    _gate(p.present().numpy(), np.asarray(j.present()), p.ray_count,
          float(np.asarray(j.ray_count)))


def test_render_samples_counters_and_aovs(renders):
    j, p = renders["j_two"], renders["p_two"]
    np.testing.assert_array_equal(p.sample_count.numpy(),
                                  np.asarray(j.sample_count))
    assert p.frame_index == int(np.asarray(j.frame_index)) == SPP
    assert p.ray_count >= W * H * SPP
    np.testing.assert_array_equal(p.albedo.numpy(), np.asarray(j.albedo))
    np.testing.assert_allclose(p.normal.numpy(), np.asarray(j.normal),
                               rtol=0, atol=1e-5)


def test_render_resumes_from_jax_state(renders):
    """Continue the JAX package's 1-spp state for one more sample in the
    port: per-pixel seeds (prev count, frame index) and the accumulation
    order must land on the JAX package's own 2-spp result."""
    j_one, j_two = renders["j_one"], renders["j_two"]
    d = {f.name: np.asarray(getattr(j_one, f.name))
         for f in dataclasses.fields(j_one)
         if getattr(j_one, f.name) is not None}
    state = convert.render_state(d, "cpu")
    out = frame.render_samples(renders["ps"], renders["p_uni"], state,
                               renders["p_static"], 1)
    rays_one = float(np.asarray(j_one.ray_count))
    _gate(out.present().numpy(), np.asarray(j_two.present()),
          out.ray_count - rays_one, float(np.asarray(j_two.ray_count))
          - rays_one)
    assert out.frame_index == 2


def _run(code, env=None):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=240, env=env)


def test_port_renders_without_jax():
    """The port imports and renders 16x16 on the CPU, the lambert series,
    the environment-NEE headline, the Cornell box (spheres, rectangles,
    rect-light NEE) and ``materials.scene`` (plastic, carpaint, separable
    SSS) with its random-walk variant under an environment, renders the
    smoke scene through the CLI (the plain path, then the native oracle's
    wrapper) and profiles a wavefront with
    ``traversal_profile``, without loading jax, flax or any module of the
    JAX package."""
    proc = _run("""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from metal_pathtracer_tpu_torch.renderer.headless import CudaBackend
        from metal_pathtracer_tpu_torch.ops.camera import build_camera
        from metal_pathtracer_tpu_torch.renderer import frame
        from metal_pathtracer_tpu_torch.renderer.accumulation import (
            RenderState)
        from metal_pathtracer_tpu_torch.schema import (
            settings_to_static, settings_to_uniforms)
        from metal_pathtracer_tpu_torch.utils.benchscene import (
            build_cornell_scene, build_lambert_series,
            build_materials_env_rw_scene, build_materials_scene,
            build_untextured_bench_scene)
        settings, resources = build_lambert_series(2)
        settings.maxDepth = 3
        out = CudaBackend().render(resources, settings, 16, 16, 1,
                                   device="cpu")
        assert out.linear_rgb.shape == (16, 16, 3)
        assert np.isfinite(out.linear_rgb).all()
        assert out.linear_rgb.max() > 0 and out.ray_count >= 256
        settings, res, env = build_untextured_bench_scene(1, device="cpu")
        settings.maxDepth = 3
        scene = res.build_arrays(environment=env, device="cpu")
        static = settings_to_static(settings, 16, 16,
                                    res.material_types_present())
        uni = settings_to_uniforms(
            settings, build_camera(settings, 16, 16, "cpu"), 0, 0)
        st = frame.render_samples(scene, uni,
                                  RenderState.create(16, 16, "cpu"), static,
                                  1)
        img = st.present().numpy()
        assert np.isfinite(img).all() and img.max() > 0
        assert st.ray_count >= 256 and st.shadow_ray_count > 0
        settings, res = build_cornell_scene()
        settings.maxDepth = 3
        out = CudaBackend().render(res, settings, 16, 16, 1, device="cpu")
        assert np.isfinite(out.linear_rgb).all()
        assert out.linear_rgb.max() > 0 and out.shadow_ray_count > 0
        settings, res = build_materials_scene()
        settings.maxDepth = 3
        out = CudaBackend().render(res, settings, 16, 16, 1, device="cpu")
        assert np.isfinite(out.linear_rgb).all() and out.linear_rgb.max() > 0
        settings, res, env = build_materials_env_rw_scene("cpu")
        settings.maxDepth = 2
        settings.sssMaxSteps = 4
        out = CudaBackend().render(res, settings, 16, 16, 1, device="cpu",
                                   environment=env)
        assert np.isfinite(out.linear_rgb).all()
        assert out.shadow_ray_count > 0
        import os, tempfile
        from metal_pathtracer_tpu_torch import cli
        from metal_pathtracer_tpu_torch.utils.stats import traversal_profile
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "smoke.ppm")
            # the port's plain path, then the native oracle's wrapper
            for backend in ("cpu-torch", "cpu"):
                assert cli.main(["--scene", "tests/scenes/smoke.scene",
                                 "--width", "16", "--height", "16",
                                 "--sppTotal", "1", "--format", "ppm",
                                 "--backend", backend, "--output",
                                 out]) == 0
                assert os.path.getsize(out) == 13 + 16 * 16 * 3
        scene = build_lambert_series(1)[1].build_arrays(device="cpu")
        o = torch.zeros((64, 3))
        o[:, 2] = 4.0
        d = torch.nn.functional.normalize(torch.randn(64, 3) * 0.3 - o, dim=1)
        prof = traversal_profile(o, d, scene.tri_bvh, scene.triangles)
        assert prof["rays"] == 64 and prof["nodes_per_ray"] >= 1
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                      "metal_pathtracer_tpu")]
        assert not bad, bad
        print("OK")
    """)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


def test_kernel_modules_import_without_nvcc():
    """The kernel wrappers import (and their CPU paths run) with no CUDA
    toolkit; only building the library asks for nvcc, and says so."""
    env = dict(os.environ)
    env["PATH"] = os.pathsep.join(
        p for p in env.get("PATH", "").split(os.pathsep)
        if not os.path.exists(os.path.join(p, "nvcc")))
    env["CUDA_HOME"] = os.path.join(REPO, "no-cuda-here")
    proc = _run("""
        from metal_pathtracer_tpu_torch.ops.kernels import build, shade
        from metal_pathtracer_tpu_torch.ops.kernels import texture, traverse
        from metal_pathtracer_tpu_torch.ops.kernels import primitives
        assert primitives.sphere_nearest_brute.launches == 0
        assert primitives.sphere_nearest_chunked.launches == 0
        assert primitives.rect_nearest.launches == 0
        assert traverse.trace_closest.launches == 0
        assert texture.texture_stage.launches == 0
        assert traverse.trace_any.launches == 0
        assert shade.shade_full.launches == 0
        assert shade.shade_s1.launches == shade.shade_s2.launches == 0
        assert build.library_path().endswith(".so")
        try:
            build.nvcc_path()
        except RuntimeError as e:
            assert "nvcc not found" in str(e)
            print("OK")
    """, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")
