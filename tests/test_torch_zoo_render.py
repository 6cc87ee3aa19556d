"""Plastic and carpaint at the reference's own roughness, and the texture
planes in stage ``full``, end to end: the port's K2 ``full`` against the
JAX package's render at 40x24, 2 spp, the JAX scene a field-for-field
twin of the port's. One JAX render per case:

- ``reference_rows``: the plastic (coat roughness 0.15, absorbing tinted
  coat) and carpaint (coat 0.2, flakes 0.2 at scale 8, base 0.25) rows of
  the reference's fused-vs-XLA tests (``test_fused_shade.py:796-852``) on
  triangle icospheres, d3. Per-pixel parity does not hold at these
  roughnesses: GGX below roughness 0.3 turns the one-ulp differences of
  XLA's approximate rsqrt, sin and cos (against IEEE in the port) into
  1e-4..1e-3 relative differences of D (``test_torch_zoo_bsdf.py``), as
  for the rough metal of ``test_torch_cornell_render.py``; the same
  materials with every lobe at roughness >= 0.5 hold the reference's
  tight gate through 4 bounces (``test_torch_sss_render.py`` ``walk``:
  RMSE 3.1e-5, 98.1 % of pixels within 1e-5). So the
  gate is the curved one of ``test_torch_cornell_render.py``
  (``rough_mirror``): RMSE < 1e-3, more than 80 % of pixels within 1e-5
  (measured RMSE 1.8e-4, 87.1 %); the reference's 95 % does not hold;
- ``six_slot``: ``build_six_slot_scene`` under the gradient sky, d4: no
  light integral, so the texture stage feeds stage ``full`` (base colour,
  ORM, normal map, occlusion, emission, transmission, alpha MASK/BLEND
  pass-through); the tight gate: RMSE < 2e-4, more than 98 % within 1e-5
  (measured RMSE 2.3e-7, every pixel).

Both: trace counts within max(4, 1e-4 * rays). ``pair_of`` builds the
JAX twins for the other zoo render files.
"""

import numpy as np
import pytest
import torch

from metal_pathtracer_tpu.scene.resources import Rect as JRect
from metal_pathtracer_tpu.scene.resources import Sphere as JSphere
from metal_pathtracer_tpu.settings import RenderSettings as JSettings
from metal_pathtracer_tpu_torch.ops.kernels import texture
from metal_pathtracer_tpu_torch.utils import benchscene as B
from test_torch_prims_render import assert_counters, assert_gate, render_pair
from test_torch_textures import _jax_resources

W, H = 40, 24

PLASTIC = B.ICOSPHERE_ROWS["plastic"]
CARPAINT = B.ICOSPHERE_ROWS["carpaint"]
#: the same with every GGX lobe at roughness >= 0.5 (well-conditioned)
ROUGH_PLASTIC = dict(PLASTIC, coat_roughness=0.5)
ROUGH_CARPAINT = dict(CARPAINT, coat_roughness=0.5,
                      carpaint_base_roughness=0.6,
                      carpaint_flake_roughness=0.5)
GROUND = B.ICOSPHERE_ROWS["ground"]


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def pair_of(settings, resources):
    """((port settings, resources), (JAX settings, resources)): the JAX
    twins field for field (materials, meshes, images, spheres,
    rectangles)."""
    js = JSettings()
    for key, value in vars(settings).items():
        setattr(js, key, value)
    jr = _jax_resources(resources)
    jr.spheres.extend(JSphere(**vars(x)) for x in resources.spheres)
    jr.rects.extend(JRect(**vars(x)) for x in resources.rects)
    return (settings, resources), (js, jr)


def _reference_rows():
    return pair_of(*B.build_icosphere_scene(
        [PLASTIC, CARPAINT, GROUND],
        [((-1.0, 0.6, 0.0), 0.8, 0), ((1.0, 0.6, 0.0), 0.8, 1)], 13))


def _six_slot():
    settings, res = B.build_six_slot_scene()
    assert settings.backgroundMode == 0
    return pair_of(settings, res)


CASES = {"reference_rows": (_reference_rows, 3, (1e-3, 0.8)),
         "six_slot": (_six_slot, 4, (2e-4, 0.98))}


@pytest.fixture(scope="module", params=sorted(CASES))
def renders(request):
    make, depth, gate = CASES[request.param]
    before = texture.texture_stage.launches
    calls = []
    real = texture.texture_stage_reference

    def spy(*args):
        calls.append(1)
        return real(*args)

    texture.texture_stage_reference = spy
    try:
        r = render_pair(*make(), W, H, depth)
    finally:
        texture.texture_stage_reference = real
    assert texture.texture_stage.launches == before
    return request.param, gate, r, len(calls)


def test_zoo_render_matches_jax(renders):
    _, gate, r, _ = renders
    assert_gate(r, *gate)


def test_zoo_render_counters(renders):
    name, _, r, texture_calls = renders
    assert_counters(r, shadow=False)
    # stage full read the texture planes of the textured scene only
    assert (texture_calls > 0) == (name == "six_slot")
    assert np.isfinite(r["port"].albedo.numpy()).all()
