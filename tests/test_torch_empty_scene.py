"""Scenes without any primitive, on the CPU: a camera, a material and a
background, nothing to hit. Two ``.scene`` files the test writes: a
solid background, and an environment map (a 16x8 PFM sky with a sun
block, also written by the test). Each package parses each file with its
own DSL; the port renders through its plain path at 32x24, 2 spp,
maxDepth 2, against the JAX package's XLA render under the ladder's
tight gate (RMSE < 2e-4, more than 98 % of pixels within 1e-5, ray
counts within max(4, 1e-4 rays)). The environment scene takes the
environment light integral's depth loop (``trace_paths_nee``), where no
ray hits anything, so no shadow ray is traced. The port's CLI
(``--backend cpu-torch``) and its ``Renderer`` facade render both files
too, the CLI's solid image the reference's bytes. Every trace of an
empty family returns misses (``trace_merged``, ``trace_scene``,
``trace_occluded``, ``traversal_profile``). Two JAX renders; ~25 s.
"""

import numpy as np
import pytest
import torch

from metal_pathtracer_tpu.ops import env as jax_env
from metal_pathtracer_tpu.scene import dsl as jax_dsl
from metal_pathtracer_tpu.scene.resources import SceneResources as JResources
from metal_pathtracer_tpu.settings import RenderSettings as JSettings
from metal_pathtracer_tpu_torch import cli
from metal_pathtracer_tpu_torch.ops import env as env_ops
from metal_pathtracer_tpu_torch.ops import intersect
from metal_pathtracer_tpu_torch.renderer.renderer import Renderer
from metal_pathtracer_tpu_torch.scene import dsl
from metal_pathtracer_tpu_torch.scene.resources import SceneResources
from metal_pathtracer_tpu_torch.settings import RenderSettings
from metal_pathtracer_tpu_torch.utils import image_io, stats
from test_torch_prims_render import assert_counters, assert_gate, render_pair

W, H, DEPTH = 32, 24, 2

HEAD = ("camera target=0,0,0 distance=4 yaw=0.3 pitch=0.15 vfov=45\n"
        "renderer maxDepth=2 seed=7\n"
        "material type=lambert albedo=0.5,0.5,0.5 name=m\n")
SCENES = {"solid": "background solid=0.7,0.8,1.0\n",
          "sky": "background env=./sky.pfm\n"}


def _sky():
    """16x8 linear sky: a vertical gradient and a bright sun block."""
    y = np.linspace(0.2, 1.0, 8, dtype=np.float32)[:, None, None]
    img = np.broadcast_to(y * np.array([0.4, 0.6, 1.0], np.float32),
                          (8, 16, 3)).copy()
    img[1:3, 4:6] = 40.0
    return img


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("empty")
    image_io.write_pfm(str(d / "sky.pfm"), _sky())
    out = {}
    for name, line in SCENES.items():
        (d / f"{name}.scene").write_text(HEAD + line)
        out[name] = str(d / f"{name}.scene")
    return out


@pytest.fixture(scope="module", params=sorted(SCENES))
def renders(request, files):
    path = files[request.param]
    ps, pr, js, jr = RenderSettings(), SceneResources(), JSettings(), \
        JResources()
    dsl.load_scene_file(path, ps, pr)
    jax_dsl.load_scene_file(path, js, jr)
    envs = (None, None)
    if ps.environmentMapPath:
        envs = (env_ops.load_environment(ps.environmentMapPath, "cpu"),
                jax_env.load_environment(js.environmentMapPath))
    r = render_pair((ps, pr), (js, jr), W, H, DEPTH, envs=envs)
    r.update(name=request.param, resources=pr,
             scene=pr.build_arrays(environment=envs[0], device="cpu"))
    return r


def test_empty_scene_matches_jax(renders):
    assert_gate(renders, 2e-4, 0.98)


def test_empty_scene_counters(renders):
    """Every pixel sampled, the image finite and lit, no shadow trace, no
    kernel launched on the CPU, and nothing in the scene."""
    sc = renders["scene"]
    assert sc.n_triangles + sc.n_spheres + sc.n_rects + sc.n_instances == 0
    assert_counters(renders, shadow=False)


def test_empty_traces_miss(renders):
    """Every trace of an empty scene misses: the merged trace, the hit
    record, occlusion and the traversal profile, which walks nothing."""
    sc = renders["scene"]
    rng = np.random.default_rng(1)
    o = torch.from_numpy(rng.uniform(-2, 2, (64, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32)), dim=-1)
    t, idx, u, v, kind = intersect.trace_merged(o, d, sc, 1e-3, 1e20)
    assert (idx == -1).all() and (kind == 0).all()
    assert not intersect.trace_scene(o, d, sc, 1e-3, 1e20).hit.any()
    assert not intersect.trace_occluded(o, d, sc, 1e-3, 1e20).any()
    for any_hit in (False, True):
        prof = stats.traversal_profile(o, d, sc.tri_bvh, sc.triangles,
                                       any_hit=any_hit)
        assert prof["nodes_per_ray"] == 0.0 and prof["hit_pct"] == 0.0


def test_empty_scene_cli(files, tmp_path):
    """The port's CLI renders both files: the solid background's PPM is
    the sky colour everywhere ((217, 230, 255) after gamma, the bytes of
    the JAX CLI's file), the sky's EXR finite and lit."""
    out = tmp_path / "solid.ppm"
    assert cli.main(["--scene", files["solid"], "--width", "8", "--height",
                     "8", "--sppTotal", "1", "--format", "ppm", "--backend",
                     "cpu-torch", "--output", str(out)]) == 0
    data = out.read_bytes()
    assert data.startswith(b"P6\n8 8\n255\n")
    pix = np.frombuffer(data[len(b"P6\n8 8\n255\n"):], np.uint8)
    assert (pix.reshape(-1, 3) == [217, 230, 255]).all()
    out = tmp_path / "sky.exr"
    assert cli.main(["--scene", files["sky"], "--width", "8", "--height",
                     "8", "--sppTotal", "1", "--backend", "cpu-torch",
                     "--output", str(out)]) == 0
    rgb = image_io.read_exr(str(out))
    rgb = np.stack([rgb["R"], rgb["G"], rgb["B"]], -1)
    assert np.isfinite(rgb).all() and rgb.max() > 0.0


def test_empty_scene_facade(files):
    """The ``Renderer`` facade loads and draws both files."""
    r = Renderer(width=16, height=12, device="cpu")
    for name in ("solid", "sky"):
        r.load_scene_from_path(files[name])
        r.draw_frame()
        img = r.capture_average_image()
        assert np.isfinite(img).all() and img.max() > 0.0, name
