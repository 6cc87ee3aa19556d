"""``assets/scenes/materials.scene`` as written (the reference's material
zoo row: lambert, brushed metal at roughness 0.15, glass, plastic with
its coat at roughness 0.08, carpaint with 2e6 flakes and separable SSS
spheres on a ground sphere, gradient sky, ``sss=separable``) through the
port's K3a and K2 ``full``, against the JAX package's render at 48x16,
2 spp, maxDepth 8, each package parsing the file with its own DSL.

Per-pixel parity cannot be asked of this scene: the spheres' hit points
already differ from XLA's within the quadratic's rounding, the near-smooth
plastic coat and the brushed metal sample GGX where one ulp moves D by
1e-3 (``test_torch_zoo_render.py``), and the carpaint flake hash turns an
ulp of hit position into another flake. The reference does not hold it
with itself: the witness is the JAX render with the plastic sphere's
radius one float32 ulp larger, which differs from the JAX render by RMSE
4.0e-5 with 99.2 % of pixels within 1e-5 (measured). The gate is what the
renders share, as ``test_torch_cornell_render.py`` ``as_written`` does:
trace counts within max(4, 1e-4 * rays) (equal, measured); the witness
really disagrees (fewer than 99.5 % of pixels within 1e-5, RMSE > 1e-5);
the port agrees with the JAX render on as many pixels as the witness
does, less 3 points (97.0 % against 99.2 %, measured) and with RMSE < 4e-4
(9.3e-5); each of the plastic, carpaint and subsurface spheres' first-hit
pixels (by the albedo AOV) within 5 % in mean, and the image means within
1 % (measured 1e-6 relative).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_pathtracer_tpu.scene import dsl as jax_dsl
from metal_pathtracer_tpu.scene.resources import SceneResources as JResources
from metal_pathtracer_tpu.settings import RenderSettings as JSettings
from metal_pathtracer_tpu_torch.utils import benchscene as B
from test_torch_prims_render import (
    assert_counters,
    assert_counts,
    image_diff,
    jax_render,
    render_text_pair,
)

W, H, DEPTH = 48, 16, 8
#: the plastic sphere (the witness's nudge) and the zoo spheres' albedos
PLASTIC_SPHERE = 4
ALBEDOS = {"plastic": (0.1, 0.3, 0.8), "carpaint": (0.6, 0.05, 0.05),
           "subsurface": (0.9, 0.5, 0.35)}


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _nudge_plastic(arrays):
    """The JAX scene arrays with the plastic sphere's radius one float32
    ulp larger (same shapes: the compiled render is reused)."""
    sp = arrays.spheres
    radius = np.array(sp.radius)
    radius[PLASTIC_SPHERE] = np.nextafter(radius[PLASTIC_SPHERE],
                                          np.float32(np.inf))
    return dataclasses.replace(arrays, spheres=dataclasses.replace(
        sp, radius=jnp.asarray(radius)))


@pytest.fixture(scope="module")
def renders():
    text = B.MATERIALS_PATH.read_text()
    r = render_text_pair(text, W, H, DEPTH)
    js, jr = JSettings(), JResources()
    jax_dsl.parse_scene(text, js, jr)
    js.maxDepth = DEPTH
    r["witness"] = jax_render(js, jr, W, H, edit=_nudge_plastic)
    return r


def test_materials_render_matches_jax(renders):
    r = renders
    assert_counts(r)
    _, rmse, within = image_diff(r)
    img, ref, wit = r["port"].present().numpy(), r["jax"][0], \
        r["witness"][0]
    dw = np.abs(wit - ref)
    w_rmse = float(np.sqrt((dw * dw).mean()))
    w_within = float((dw.max(-1) < 1e-5).mean())
    assert w_within < 0.995 and w_rmse > 1e-5, (w_within, w_rmse)
    assert within > w_within - 0.03, (within, w_within)
    assert rmse < 4e-4, rmse
    albedo = r["port"].albedo.numpy()
    for name, rgb in ALBEDOS.items():
        sel = np.isclose(albedo, np.asarray(rgb, np.float32)).all(-1)
        assert sel.sum() >= 6, (name, int(sel.sum()))
        m, m_ref = float(img[sel].mean()), float(ref[sel].mean())
        assert abs(m - m_ref) < 0.05 * m_ref, (name, m, m_ref)
    mean, mean_ref = float(img.mean()), float(ref.mean())
    assert abs(mean - mean_ref) < 0.01 * mean_ref, (mean, mean_ref)


def test_materials_render_counters(renders):
    assert_counters(renders, shadow=False)
