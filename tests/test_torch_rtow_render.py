"""The final scene of *Ray Tracing in One Weekend* (``benchscene.
rtow_scene_text``: 487 spheres of lambert, metal and glass, a thin-lens
camera, the gradient sky) through the port's no-light path, K3b (more
than 32 spheres: Morton-ordered groups of 16 behind one box each) and K2
``full`` with lambert, metal, dielectric and the medium stack, against
the JAX package's render at 48x27, 2 spp, maxDepth 8, each package
parsing the scene text with its own DSL.

Gate: the curved one (``test_fused_shade.py:69-73,163``): ray counts
within max(4, 1e-4 * rays), RMSE < 1e-3, more than 80 % of pixels within
1e-5; every bounce rebuilds a sphere normal from a hit point that drifts
by an ulp (XLA's approximate ``sqrt``), and the ground sphere of radius
1000 scales a 1-ulp ``sqrt`` difference into ~256 ulps of t.
"""

import pytest
import torch

from metal_pathtracer_tpu_torch.ops.kernels import primitives
from metal_pathtracer_tpu_torch.utils.benchscene import rtow_scene_text
from test_torch_prims_render import (
    assert_counters,
    assert_gate,
    render_text_pair,
)


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def renders():
    return render_text_pair(rtow_scene_text(0), 48, 27, 8)


def test_rtow_render_matches_jax(renders):
    assert_gate(renders, 1e-3, 0.8)


def test_rtow_render_counters(renders):
    assert_counters(renders, shadow=False)
    assert renders["port"].ray_count > 48 * 27 * 2


def test_rtow_takes_the_chunked_route():
    """487 spheres exceed two groups, so ``sphere_nearest`` takes K3b (the
    JAX package's route, ``primitives.py:130-133``)."""
    from metal_pathtracer_tpu_torch.utils.benchscene import build_rtow_scene

    _, res = build_rtow_scene(0)
    scene = res.build_arrays(device="cpu")
    calls = []
    saved = primitives.sphere_nearest_chunked_reference

    def spy(*args, **kwargs):
        calls.append(1)
        return saved(*args, **kwargs)

    primitives.sphere_nearest_chunked_reference = spy
    try:
        o = torch.zeros((4, 3))
        o[:, 1] = 3.0
        d = torch.tensor([[0.0, -1.0, 0.0]]).repeat(4, 1)
        t, idx = primitives.sphere_nearest(o, d, 1e-4, 1e20, scene.spheres,
                                           scene.sphere_groups)
    finally:
        primitives.sphere_nearest_chunked_reference = saved
    assert calls and (idx >= 0).all()
