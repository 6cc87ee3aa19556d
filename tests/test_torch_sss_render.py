"""Subsurface scattering end to end on triangle icospheres, the port's K2
``full`` (and the random-walk pre-stage) against the JAX package's render
at 40x24, 2 spp, the JAX scene a field-for-field twin of the port's. One
JAX render per case, each under the gate of the reference's fused-vs-XLA
tests for it: trace counts within max(4, 1e-4 * rays), RMSE < 1e-4 and
more than 93 % of pixels within 1e-5:

- ``separable``: a subsurface sphere under ``sss=separable``, d4 (the
  reference's ``test_fused_shade.py:890-899``): four draws per lane, the
  exit point and the BSSRDF next origin (measured: every pixel within
  1e-5, RMSE 4e-8);
- ``walk``: under ``sss=randomwalk`` (``test_fused_shade.py:902-913``),
  d4, a random-walk sphere beside a sphere of a separable-method material
  (which takes the lambert fallback in that mode) and a plastic and a
  carpaint sphere with every lobe at roughness >= 0.5: the walk's 32
  steps of scene traces from the full stage's input state, its override
  planes, the fallback, and plastic and carpaint tightly (at the
  reference's lower roughnesses see ``test_torch_zoo_render.py``)
  (measured RMSE 3.1e-5, 98.1 % within 1e-5).
"""

import numpy as np
import pytest
import torch

from metal_pathtracer_tpu_torch.ops.kernels import shade
from metal_pathtracer_tpu_torch.settings import SssMode
from metal_pathtracer_tpu_torch.utils import benchscene as B
from test_torch_prims_render import assert_counters, assert_gate, render_pair
from test_torch_zoo_render import (
    GROUND,
    ROUGH_CARPAINT,
    ROUGH_PLASTIC,
    W,
    H,
    pair_of,
)

SSS = B.ICOSPHERE_ROWS["sss"]
WALK = dict(SSS, sss_method=1, coat_roughness=0.5)


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def separable_scene():
    settings, res = B.build_icosphere_scene(
        [SSS, GROUND], [((0.0, 0.6, 0.0), 0.8, 0)], 23)
    settings.sssMode = SssMode.SEPARABLE
    return settings, res


def walk_scene(carpaint_radius=0.7):
    """A random-walk sphere, a separable-method one (the fallback under
    ``sss=randomwalk``), a rough plastic and a rough carpaint sphere (of
    radius ``carpaint_radius``)."""
    settings, res = B.build_icosphere_scene(
        [WALK, SSS, ROUGH_PLASTIC, ROUGH_CARPAINT, GROUND],
        [((-1.5, 0.6, 0.0), 0.7, 0), ((0.0, 0.6, 0.0), 0.7, 1),
         ((1.5, 0.6, 0.0), 0.7, 2), ((0.0, 0.6, -1.8), carpaint_radius, 3)],
        23)
    settings.sssMode = SssMode.RANDOM_WALK
    return settings, res


CASES = {"separable": separable_scene, "walk": walk_scene}


@pytest.fixture(scope="module", params=sorted(CASES))
def renders(request):
    walks = []
    real = shade.random_walks

    def spy(*args):
        out = real(*args)
        walks.append(out[0] is not None and bool((out[0][:, 0] > 0).any()))
        return out

    shade.random_walks = spy
    try:
        r = render_pair(*pair_of(*CASES[request.param]()), W, H, 4)
    finally:
        shade.random_walks = real
    return request.param, r, walks


def test_sss_render_matches_jax(renders):
    _, r, _ = renders
    assert_gate(r, 1e-4, 0.93)


def test_sss_render_counters(renders):
    name, r, walks = renders
    assert_counters(r, shadow=False)
    # the walk pre-stage ran on walk lanes in the random-walk scene only
    assert any(walks) == (name == "walk")
    assert np.isfinite(r["port"].albedo.numpy()).all()
