"""Analytic-primitive scenes end to end, the port against the JAX package's
``frame.render_samples`` (its XLA path, as tier-1 runs it), each package
building the scene with its own code:

- the smoke scene (``tests/scenes/smoke.scene``, two lambert spheres under
  a solid sky) at 48x48, 2 spp, seed 1337: the scene and shape of the
  reference's golden pin (``tests/test_golden_pinned.py:20-28``), ROADMAP
  step 11's gate; stage ``full``, K3a only;
- the mixed scene (``test_fused_shade.py:166-196``: triangles, a lambert
  and an emissive sphere, a one-sided rectangle) at 40x24, 2 spp, d5:
  the merged trace's tie order, two-sided emission and the triangle-only
  self-exclusion; K1, K3a, K3c and stage ``full``.

Gates, the JAX package's own for its fused path against XLA
(``test_fused_shade.py:60-73``): ray counts within max(4, 1e-4 * rays),
RMSE < 2e-4, and more than 98 % of pixels within 1e-5 for the smoke scene
(measured exact to 1e-5 at every pixel), more than 80 % for the mixed
scene, whose curved surfaces rebuild the normal from a hit point that
drifts by an ulp each bounce (XLA's approximate ``sqrt``,
``test_fused_shade.py:69-73,196``).

``render_text_pair`` and ``assert_gate`` serve the Cornell box and rtow
files too.
"""

import numpy as np
import pytest
import torch

from metal_pathtracer_tpu.ops.camera import build_camera as jax_camera
from metal_pathtracer_tpu.renderer import frame as jax_frame
from metal_pathtracer_tpu.renderer.accumulation import RenderState as JState
from metal_pathtracer_tpu.scene import dsl as jax_dsl
from metal_pathtracer_tpu.scene.resources import Material as JMaterial
from metal_pathtracer_tpu.scene.resources import Rect as JRect
from metal_pathtracer_tpu.scene.resources import SceneResources as JResources
from metal_pathtracer_tpu.scene.resources import Sphere as JSphere
from metal_pathtracer_tpu.schema import settings_to_static as jax_static
from metal_pathtracer_tpu.schema import settings_to_uniforms as jax_uniforms
from metal_pathtracer_tpu.settings import RenderSettings as JSettings
from metal_pathtracer_tpu.utils.procgen import (
    dragon_class_scene_mesh as jax_dragon_mesh,
)
from metal_pathtracer_tpu_torch.ops.camera import build_camera
from metal_pathtracer_tpu_torch.ops.kernels import primitives, shade
from metal_pathtracer_tpu_torch.renderer import frame
from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
from metal_pathtracer_tpu_torch.scene import dsl
from metal_pathtracer_tpu_torch.scene.resources import SceneResources
from metal_pathtracer_tpu_torch.schema import (
    settings_to_static,
    settings_to_uniforms,
)
from metal_pathtracer_tpu_torch.settings import RenderSettings
from metal_pathtracer_tpu_torch.utils import benchscene as B

SPP = 2


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _launches():
    return (shade.shade_full.launches, shade.shade_s1.launches,
            shade.shade_s2.launches,
            primitives.sphere_nearest_brute.launches,
            primitives.sphere_nearest_chunked.launches,
            primitives.rect_nearest.launches)


def render_pair(port_scene, jax_scene, w, h, depth, tweak=None,
                envs=(None, None)):
    """The port's and the JAX package's render of (settings, resources)
    pairs at w x h, ``SPP`` samples, maxDepth ``depth``; ``tweak`` edits
    both settings; ``envs``: the (port, JAX) environment maps."""
    torch.set_num_threads(1)
    js, jr = jax_scene
    ps, pr = port_scene
    for s in (js, ps):
        s.maxDepth = depth
        if tweak is not None:
            tweak(s)
    ref = jax_render(js, jr, w, h, envs[1])
    before = _launches()
    port = frame.render_samples(
        pr.build_arrays(environment=envs[0], device="cpu"),
        settings_to_uniforms(ps, build_camera(ps, w, h, device="cpu"), 0, 0),
        RenderState.create(w, h, "cpu"),
        settings_to_static(ps, w, h, pr.material_types_present()), SPP)
    return dict(port=port, jax=ref, before=before, size=(w, h))


def jax_render(js, jr, w, h, env=None, edit=None):
    """The JAX package's render of (settings, resources) at w x h, ``SPP``
    samples: (image, closest traces, shadow traces). ``edit`` maps its
    ``SceneArrays`` to the arrays rendered (same shapes: no recompile)."""
    jsc = jr.build_arrays(environment=env)
    if edit is not None:
        jsc = edit(jsc)
    st = jax_frame.render_samples(
        jsc, jax_uniforms(js, jax_camera(js, w, h), 0, 0),
        JState.create(w, h), jax_static(js, w, h,
                                        jr.material_types_present()), SPP)
    return (np.asarray(st.present()), float(np.asarray(st.ray_count)),
            float(np.asarray(st.shadow_ray_count)))


def render_text_pair(text, w, h, depth, tweak=None, envs=(None, None)):
    """``render_pair`` of a ``.scene`` text parsed by each package's DSL."""
    js, jr = JSettings(), JResources()
    jax_dsl.parse_scene(text, js, jr)
    ps, pr = RenderSettings(), SceneResources()
    dsl.parse_scene(text, ps, pr)
    return render_pair((ps, pr), (js, jr), w, h, depth, tweak, envs)


def image_diff(renders):
    d = np.abs(renders["port"].present().numpy() - renders["jax"][0])
    return d, float(np.sqrt((d * d).mean())), float((d.max(-1) < 1e-5).mean())


def assert_counts(renders):
    p = renders["port"]
    _, rays_ref, shadow_ref = renders["jax"]
    assert abs(p.ray_count - rays_ref) <= max(4.0, 1e-4 * rays_ref)
    assert abs(p.shadow_ray_count - shadow_ref) <= max(4.0, 1e-4 * shadow_ref)


def assert_gate(renders, max_rmse, min_within):
    assert_counts(renders)
    d, rmse, within = image_diff(renders)
    assert rmse < max_rmse, (rmse, float(d.max()))
    assert within > min_within, within


def assert_counters(renders, shadow):
    """Every pixel got its samples, the image is finite and lit, the
    shadow traces are there when a light integral runs, and on the CPU no
    kernel was launched."""
    p = renders["port"]
    w, h = renders["size"]
    assert (p.sample_count.numpy() == SPP).all() and p.frame_index == SPP
    img = p.present().numpy()
    assert np.isfinite(img).all() and img.max() > 0.0
    assert p.ray_count >= w * h * SPP
    assert (p.shadow_ray_count > 0) == shadow
    assert _launches() == renders["before"]


def _mixed_pair():
    ps, pr = B.build_mixed_scene()
    js, jr = JSettings(), JResources()
    for key, value in vars(ps).items():
        setattr(js, key, value)
    for m in pr.materials:
        jr.add_material(JMaterial(mat_type=m.mat_type,
                                  base_color=m.base_color,
                                  emission=m.emission))
    jr.add_mesh(jax_dragon_mesh(2, material=0))
    for s in pr.spheres:
        jr.spheres.append(JSphere(center=s.center, radius=s.radius,
                                  material=s.material))
    for r in pr.rects:
        jr.rects.append(JRect(corner=r.corner, edge_u=r.edge_u,
                              edge_v=r.edge_v, normal=r.normal,
                              material=r.material, two_sided=r.two_sided))
    return (ps, pr), (js, jr)


def _seed_1337(settings):
    settings.fixedRngSeed = 1337


@pytest.fixture(scope="module", params=["smoke", "mixed"])
def renders(request):
    if request.param == "smoke":
        return request.param, render_text_pair(B.SMOKE_PATH.read_text(), 48,
                                               48, 4, _seed_1337)
    return request.param, render_pair(*_mixed_pair(), 40, 24, 5)


def test_prims_render_matches_jax(renders):
    name, r = renders
    assert_gate(r, 2e-4, 0.98 if name == "smoke" else 0.8)


def test_prims_render_counters(renders):
    _, r = renders
    assert_counters(r, shadow=False)
