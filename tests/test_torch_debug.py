"""The port's debug tooling against the JAX package's:

- ``renderer/debugprobe.probe_pixel`` on ``tests/test_debugprobe.py``'s
  scene (a glass and a lambert sphere under a solid sky, 64x64) for the
  centre pixel (32, 32), the sky corner (1, 0) and (32, 40): the same
  rows as the JAX probe, integer fields equal and float fields within
  1e-5 relative (measured: 2e-7), and the JAX test's own assertions on
  the port's rows. The miss rows hold the reference's artefact of its
  vectorised integrator (sphere 0's record and the sample drawn there),
  which the port's probe replays;
- ``debugSpecularOnly`` through K2's flag: a lambert, a plastic and a
  PBR icosphere on a lambert ground under the toy HDR sky of
  ``test_torch_cornell_render.py`` (environment NEE, stages s1/s2), every
  GGX lobe at roughness >= 0.5 (well-conditioned, ROADMAP Queue 3), 40x24,
  2 spp, maxDepth 4, against the JAX package's XLA render (its Pallas
  path refuses the flag) under the image gate: RMSE < 2e-4, more than
  98 % of pixels within 1e-5, trace counts within max(4, 1e-4 rays).

Two JAX reference calls, each in a module fixture: the three probes and
the render.
"""

import numpy as np
import pytest
import torch

from metal_pathtracer_tpu import constants as JC
from metal_pathtracer_tpu.ops.camera import build_camera as jax_camera
from metal_pathtracer_tpu.renderer.debugprobe import probe_pixel as jax_probe
from metal_pathtracer_tpu.scene import dsl as jax_dsl
from metal_pathtracer_tpu.scene.resources import SceneResources as JResources
from metal_pathtracer_tpu.schema import settings_to_static as jax_static
from metal_pathtracer_tpu.schema import settings_to_uniforms as jax_uniforms
from metal_pathtracer_tpu.settings import RenderSettings as JSettings
from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops.camera import build_camera
from metal_pathtracer_tpu_torch.renderer import frame
from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
from metal_pathtracer_tpu_torch.renderer.debugprobe import (
    PROBE_FIELDS,
    probe_pixel,
)
from metal_pathtracer_tpu_torch.scene import dsl
from metal_pathtracer_tpu_torch.scene.resources import SceneResources
from metal_pathtracer_tpu_torch.schema import (
    settings_to_static,
    settings_to_uniforms,
)
from metal_pathtracer_tpu_torch.settings import BackgroundMode, RenderSettings
from metal_pathtracer_tpu_torch.utils import benchscene as B
from test_debugprobe import SCENE
from test_torch_cornell_render import _toy_env
from test_torch_prims_render import assert_gate, render_pair
from test_torch_zoo_render import GROUND, ROUGH_PLASTIC, pair_of

PIXELS = [(32, 32), (1, 0), (32, 40)]
INT_FIELDS = ("hit", "prim_type", "prim_index", "mesh_index", "material",
              "medium_depth", "medium_event", "is_delta")
FLOAT_RTOL = 1e-5
W, H = 40, 24
LAMBERT = dict(base_color=(0.7, 0.6, 0.5))
ROUGH_PBR = dict(mat_type=C.MATERIAL_PBR, base_color=(0.8, 0.6, 0.2),
                 roughness=0.6, pbr_metallic=0.4, ior=1.5)


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _port_setup(w=64, h=64):
    settings, res = RenderSettings(), SceneResources()
    dsl.parse_scene(SCENE, settings, res)
    static = settings_to_static(settings, w, h, res.material_types_present())
    uni = settings_to_uniforms(settings, build_camera(settings, w, h, "cpu"),
                               0, 0)
    return res.build_arrays(device="cpu"), uni, static


@pytest.fixture(scope="module")
def probes():
    js, jr = JSettings(), JResources()
    jax_dsl.parse_scene(SCENE, js, jr)
    jscene = jr.build_arrays()
    jstatic = jax_static(js, 64, 64, jr.material_types_present())
    juni = jax_uniforms(js, jax_camera(js, 64, 64), 0, 0)
    scene, uni, static = _port_setup()
    return {xy: (jax_probe(jscene, juni, jstatic, *xy),
                 probe_pixel(scene, uni, static, *xy)) for xy in PIXELS}


@pytest.mark.parametrize("xy", PIXELS)
def test_probe_rows_match_jax(probes, xy):
    ref, got = probes[xy]
    assert len(got) == len(ref)
    for depth, (a, b) in enumerate(zip(ref, got)):
        assert set(b) == set(PROBE_FIELDS) | {"depth"} and b["depth"] == depth
        for k in INT_FIELDS:
            assert b[k] == a[k], (depth, k, b[k], a[k])
        for k in set(PROBE_FIELDS) - set(INT_FIELDS):
            np.testing.assert_allclose(b[k], a[k], rtol=FLOAT_RTOL,
                                       err_msg=f"depth {depth} {k}")


def test_probe_center_pixel_hits_glass_sphere(probes):
    rows = probes[(32, 32)][1]
    assert len(rows) >= 2, "glass path should bounce at least twice"
    first = rows[0]
    assert first["hit"] == 1.0
    assert first["prim_type"] == JC.PRIMITIVE_SPHERE
    assert first["prim_index"] == 0          # the glass sphere
    assert first["material"] == 1
    assert first["is_delta"] == 1.0          # dielectric = delta
    # t along the unnormalised ray (t = 1 at the focus plane)
    assert 0.5 < first["t"] < 1.0
    for row in rows:
        tp = (row["throughput_r"], row["throughput_g"], row["throughput_b"])
        assert all(np.isfinite(tp))
    events = [row["medium_event"] for row in rows]
    assert any(e == 1 for e in events) or all(e == 0 for e in events)


def test_probe_sky_pixel_terminates_immediately(probes):
    rows = probes[(1, 0)][1]
    assert rows[0]["hit"] == 0.0
    assert len(rows) == 1


def test_probe_is_deterministic(probes):
    scene, uni, static = _port_setup()
    a = probes[(32, 40)][1]
    b = probe_pixel(scene, uni, static, 32, 40)
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for k in ra:
            assert ra[k] == rb[k], k


def _specular_scene():
    settings, res = B.build_icosphere_scene(
        [LAMBERT, ROUGH_PLASTIC, ROUGH_PBR, GROUND],
        [((-1.1, 0.45, 0.0), 0.45, 0), ((0.0, 0.5, 0.2), 0.5, 1),
         ((1.1, 0.45, 0.0), 0.45, 2)], 11)
    settings.backgroundMode = BackgroundMode.ENVIRONMENT
    settings.debugSpecularOnly = True
    return pair_of(settings, res)


@pytest.fixture(scope="module")
def specular():
    port, jax = _specular_scene()
    return render_pair(port, jax, W, H, 4, envs=_toy_env())


def test_specular_only_render_matches_jax(specular):
    """(measured: RMSE 1.1e-6, 99.4 % of pixels within 1e-5, equal trace
    counts)"""
    assert specular["port"].shadow_ray_count > 0
    assert_gate(specular, 2e-4, 0.98)


def test_specular_only_drops_the_diffuse_lobes(specular):
    """Against the port's render of the same scene without the flag:
    lambert lanes draw no sample and add no NEE, so every path ends black
    at its first lambert hit (the ground, the lambert sphere): more black
    pixels (76 % measured) and fewer traces."""
    (ps, pr), _ = _specular_scene()
    ps.debugSpecularOnly = False
    ps.maxDepth = 4
    env = _toy_env()[0]
    full = frame.render_samples(
        pr.build_arrays(environment=env, device="cpu"),
        settings_to_uniforms(ps, build_camera(ps, W, H, "cpu"), 0, 0),
        RenderState.create(W, H, "cpu"),
        settings_to_static(ps, W, H, pr.material_types_present()), 2)
    spec = specular["port"]
    black = lambda st: float((st.present().numpy().max(-1) == 0.0).mean())
    assert black(spec) > 0.5 > black(full)
    assert spec.ray_count < full.ray_count
    assert np.isfinite(spec.present().numpy()).all()
