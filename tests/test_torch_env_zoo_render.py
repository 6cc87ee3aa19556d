"""The material zoo under an environment light integral, the port's K2
``s1``/``s2`` against the JAX package's render at 40x24, 2 spp, under the
32x16 toy HDR sky with a sun block of the reference's tests
(``test_fused_shade.py:583-590``). One JAX render per case, and for
``walk_env`` a witness:

- ``walk_env``: the random-walk scene of ``test_torch_sss_render.py`` (a
  random-walk sphere, a separable-method one taking the fallback, a
  plastic and a carpaint sphere with every lobe at roughness >= 0.5), d4,
  environment NEE: the walk forks from the post-s1 state (after the NEE
  draws), the plastic, carpaint and subsurface evaluations enter the MIS
  weights (subsurface lanes add no NEE) and s1 exports their ``lrough``.
  The reference's gates for its random walk and for plastic + carpaint
  under an environment (``test_fused_shade.py:855-875, 916-926``: RMSE
  < 1e-4, more than 90 % of pixels within 1e-4) do not hold for the JAX
  render against itself: the witness, the JAX render with the carpaint
  sphere's radius one float32 ulp larger, differs from it by RMSE 2.8e-4
  (97.3 % of pixels within 1e-5, the differences on and around the
  carpaint sphere; measured). So the gate is the witness's, as
  ``test_torch_materials_render.py`` does: trace counts within
  max(4, 1e-4 * rays); the witness really disagrees (fewer than 99.5 % of
  pixels within 1e-5, RMSE > 1e-5); the port agrees with the JAX render
  on as many pixels as the witness does, less 3 points (97.6 % against
  97.3 %, measured), with RMSE < 4e-4 (1.4e-4) and more than 90 % of
  pixels within 1e-4 (98.8 %); the subsurface spheres' first-hit pixels
  (by the albedo AOV) under the reference's walk gate and tighter, RMSE
  < 1e-5 and every one within 1e-4 (6.4e-7, largest 7.2e-6); the plastic
  and the carpaint spheres' first-hit pixels within 1e-3 of the JAX
  render in mean (2.4e-5 and 1.6e-4 relative; the witness 5.5e-6 and
  3.9e-4);
- ``emit_env``: the Cornell box without its ceiling and spheres with
  ``emitEnv=1`` on the lamp's material and a rough plastic icosphere
  inside, d4: rect and environment NEE together (plastic's evaluation in
  both banks' MIS weights), and s1 scales the lamp's emission by the
  environment seen along its reversed normal (the ``emod`` plane). The
  reference's gate for env-modulated lights (``test_fused_shade.py:
  680-694``, RMSE < 5e-3; it puts ``emitEnv`` on the rectangle record,
  where the DSL ignores it: here it is on the material, so the modulation
  runs) and the tighter one for plastic under an environment (RMSE < 1e-4,
  more than 90 % of pixels within 1e-4) (measured RMSE 9e-7, every pixel
  within 1e-5), and the plastic sphere's first-hit pixels within 1e-3 in
  mean.
"""

import numpy as np
import pytest
import torch

from metal_pathtracer_tpu_torch.ops.kernels import shade
from metal_pathtracer_tpu_torch.scene import dsl
from metal_pathtracer_tpu_torch.scene.resources import SceneResources
from metal_pathtracer_tpu_torch.settings import BackgroundMode, RenderSettings
from metal_pathtracer_tpu_torch.utils import benchscene as B
from test_torch_cornell_render import _toy_env
from test_torch_prims_render import (
    assert_counters,
    assert_counts,
    image_diff,
    jax_render,
    render_pair,
)
from test_torch_sss_render import SSS, walk_scene
from test_torch_zoo_render import (
    GROUND,
    ROUGH_CARPAINT,
    ROUGH_PLASTIC,
    W,
    H,
    pair_of,
)

DEPTH = 4
#: the first-hit albedos of the zoo spheres (the albedo AOV)
SUBSURFACE, PLASTIC, CARPAINT = (SSS["base_color"],
                                 ROUGH_PLASTIC["base_color"],
                                 ROUGH_CARPAINT["base_color"])
#: the largest relative difference of a material's mean over its pixels
MEAN_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def emit_env_scene():
    """``cornell_emitenv_text`` without the ceiling and the spheres, a
    rough plastic icosphere on its floor."""
    text = "\n".join(line for line in B.cornell_emitenv_text().splitlines()
                     if not line.startswith("sphere")
                     and "y=2 z=-1,1" not in line)
    settings, res = RenderSettings(), SceneResources()
    dsl.parse_scene(text, settings, res)
    assert res.materials[3].emission_env
    _, spheres = B.build_icosphere_scene(
        [ROUGH_PLASTIC, GROUND], [((-0.45, 0.4, -0.35), 0.4, 0)], 7)
    base = len(res.materials)
    res.materials.append(spheres.materials[0])
    mesh = spheres.meshes[0]
    mesh.material += base
    res.add_mesh(mesh)
    return settings, res


def _env(settings):
    settings.backgroundMode = BackgroundMode.ENVIRONMENT
    return settings


def _witness(envs):
    """The JAX render of ``walk_env`` with the carpaint sphere's radius
    one float32 ulp larger."""
    radius = float(np.nextafter(np.float32(0.7), np.float32(1.0)))
    settings, res = walk_scene(radius)
    _, (js, jr) = pair_of(_env(settings), res)
    js.maxDepth = DEPTH
    return jax_render(js, jr, W, H, envs[1])


CASES = {"walk_env": walk_scene, "emit_env": emit_env_scene}


@pytest.fixture(scope="module", params=sorted(CASES))
def renders(request):
    settings, res = CASES[request.param]()
    seen = {"emod": 0, "walk": 0}
    real_emod, real_walk = shade.env_modulation, shade.random_walks

    def emod(*args):
        seen["emod"] += 1
        return real_emod(*args)

    def walks(*args):
        out = real_walk(*args)
        seen["walk"] += int(out[0] is not None
                            and bool((out[0][:, 0] > 0).any()))
        return out

    envs = _toy_env()
    shade.env_modulation, shade.random_walks = emod, walks
    try:
        r = render_pair(*pair_of(_env(settings), res), W, H, DEPTH,
                        envs=envs)
    finally:
        shade.env_modulation, shade.random_walks = real_emod, real_walk
    if request.param == "walk_env":
        r["witness"] = _witness(envs)
    return request.param, r, seen


def _pixels(r, rgb, least):
    """The first-hit pixels of the material of albedo ``rgb``."""
    sel = np.isclose(r["port"].albedo.numpy(),
                     np.asarray(rgb, np.float32)).all(-1)
    assert sel.sum() >= least, (rgb, int(sel.sum()))
    return sel


def _assert_mean(r, rgb, least):
    img, ref = r["port"].present().numpy(), r["jax"][0]
    sel = _pixels(r, rgb, least)
    m, m_ref = float(img[sel].mean()), float(ref[sel].mean())
    assert abs(m - m_ref) < MEAN_RTOL * m_ref, (rgb, m, m_ref)


def test_env_zoo_render_matches_jax(renders):
    name, r, _ = renders
    assert_counts(r)
    d, rmse, within = image_diff(r)
    assert float((d.max(-1) < 1e-4).mean()) > 0.9
    if name == "emit_env":
        assert rmse < 1e-4, (rmse, float(d.max()))
        _assert_mean(r, PLASTIC, 30)
        return
    dw = np.abs(r["witness"][0] - r["jax"][0])
    w_rmse = float(np.sqrt((dw * dw).mean()))
    w_within = float((dw.max(-1) < 1e-5).mean())
    assert w_within < 0.995 and w_rmse > 1e-5, (w_within, w_rmse)
    assert within > w_within - 0.03, (within, w_within)
    assert rmse < 4e-4, (rmse, float(d.max()))
    sss = _pixels(r, SUBSURFACE, 100)
    assert float(np.sqrt((d[sss] ** 2).mean())) < 1e-5
    assert float(d[sss].max()) < 1e-4
    _assert_mean(r, PLASTIC, 100)
    _assert_mean(r, CARPAINT, 30)


def test_env_zoo_render_counters(renders):
    name, r, seen = renders
    assert_counters(r, shadow=True)
    assert (seen["emod"] > 0) == (name == "emit_env")
    assert (seen["walk"] > 0) == (name == "walk_env")
    assert np.isfinite(r["port"].albedo.numpy()).all()
