"""The port's environment-NEE path end to end vs the JAX package: the
untextured headline scene (``tests/test_fused_shade.py``
``_bench_like_scene(False)``: HDR sun/sky with alias NEE, dielectric with
an absorbing interior, untextured PBR, lambert) at subdivisions 3, 40x24,
2 spp, maxDepth 5 (the reference's own test), each package building the
scene with its own code. ``test_torch_nee_render_d8.py`` holds the same
comparison at the bench's maxDepth 8, where Russian roulette runs from
depth 5 on: one JAX render per file, so that the two run side by side
under ``--dist loadfile``.

Gate: the one the JAX package holds its own fused env-NEE path to
(``test_fused_shade.py:530-535``): ray counts within max(4, 1e-4 * rays),
here for the scene traces and the shadow traces separately; RMSE < 5e-3;
more than 95 % of pixels within 1e-4. ulp differences of XLA:CPU's
sin/cos/atan2/asin against PyTorch's move a rare Fresnel or Russian
roulette decision, and the 1500x sun turns those paths into large pixel
differences, so parity is statistical, not bitwise.
"""

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
from metal_pathtracer_tpu_torch.ops.kernels import shade
from metal_pathtracer_tpu_torch.renderer import frame
from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
from metal_pathtracer_tpu_torch.schema import (
    settings_to_static,
    settings_to_uniforms,
)
from metal_pathtracer_tpu_torch.utils.benchscene import (
    build_untextured_bench_scene,
)

W, H, SPP, SUBDIV = 40, 24, 2, 3


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jax_render(depth):
    settings, res, environment = jax_bench(subdivisions=SUBDIV)
    settings.maxDepth = depth
    res.texture_images.clear()
    res.texture_srgb.clear()
    res.texture_wrap.clear()
    for m in res.materials:
        m.texture_indices = (-1, -1, -1, -1, -1, -1)
    scene = res.build_arrays(environment=environment)
    static = jax_static(settings, W, H, res.material_types_present())
    uni = jax_uniforms(settings, jax_camera(settings, W, H), 0, 0)
    st = jax_frame.render_samples(scene, uni, JState.create(W, H), static,
                                  SPP)
    return (np.asarray(st.present()), float(np.asarray(st.ray_count)),
            float(np.asarray(st.shadow_ray_count)))


def render_pair(depth):
    """The port's and the JAX package's render at maxDepth ``depth``."""
    torch.set_num_threads(1)
    settings, res, env = build_untextured_bench_scene(SUBDIV, device="cpu")
    settings.maxDepth = depth
    scene = res.build_arrays(environment=env, device="cpu")
    static = settings_to_static(settings, W, H,
                                res.material_types_present())
    uni = settings_to_uniforms(settings, build_camera(settings, W, H,
                                                      device="cpu"), 0, 0)
    before = (shade.shade_s1.launches, shade.shade_s2.launches)
    port = frame.render_samples(scene, uni, RenderState.create(W, H, "cpu"),
                                static, SPP)
    return dict(port=port, jax=_jax_render(depth), before=before)


# one depth per file; the parameter keeps the depth in the test id
@pytest.fixture(scope="module", params=[5])
def renders(request):
    return render_pair(request.param)


def assert_matches_jax(renders):
    p = renders["port"]
    img_ref, rays_ref, shadow_ref = renders["jax"]
    assert abs(p.ray_count - rays_ref) <= max(4.0, 1e-4 * rays_ref)
    assert abs(p.shadow_ray_count - shadow_ref) <= max(4.0,
                                                        1e-4 * shadow_ref)
    d = np.abs(p.present().numpy() - img_ref)
    rmse = float(np.sqrt((d * d).mean()))
    assert rmse < 5e-3, (rmse, float(d.max()))
    assert float((d.max(-1) < 1e-4).mean()) > 0.95


def assert_counters(renders):
    """Every pixel got its samples, the image is finite, NEE traced shadow
    rays, and on the CPU no kernel was launched."""
    p = renders["port"]
    assert (p.sample_count.numpy() == SPP).all()
    assert p.frame_index == SPP
    img = p.present().numpy()
    assert np.isfinite(img).all() and img.max() > 0.0
    assert p.ray_count >= W * H * SPP and p.shadow_ray_count > 0
    assert (shade.shade_s1.launches, shade.shade_s2.launches) \
        == renders["before"]


def test_nee_render_matches_jax(renders):
    assert_matches_jax(renders)


def test_nee_render_counters(renders):
    assert_counters(renders)


def test_s2_commits_every_live_hit():
    """Stage s2 commits every lane that entered it alive, including lanes
    whose sample fails or that Russian roulette ends (depth 5), and leaves
    dead lanes untouched; s1 ends misses and keeps dead lanes."""
    from metal_pathtracer_tpu_torch import constants as C
    from metal_pathtracer_tpu_torch.ops import env as env_ops
    from metal_pathtracer_tpu_torch.ops import integrator
    from metal_pathtracer_tpu_torch.ops.kernels import traverse

    settings, res, env = build_untextured_bench_scene(1, device="cpu")
    scene = res.build_arrays(environment=env, device="cpu")
    w, h = 24, 16
    static = settings_to_static(settings, w, h, res.material_types_present())
    uni = settings_to_uniforms(settings, build_camera(settings, w, h,
                                                      device="cpu"), 0, 0)
    rng = np.random.default_rng(5)
    n = w * h
    o = torch.tensor(rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32))
    o[:, 2] += 4.0
    d = torch.tensor(rng.normal(size=(n, 3)).astype(np.float32))
    d[:, 2] = -2.0
    state = torch.tensor(rng.integers(0, 2 ** 32, n), dtype=torch.int64)
    carry = integrator.PathCarry.start(state, o, d, 0.0, 0.01)
    carry.alive[::5] = False
    before = {k: v.clone() for k, v in vars(carry).items()}
    params = shade.ShadeParams.of(uni, static, env)
    t, tri, u, v = traverse.trace_closest(
        carry.ray_o, carry.ray_d, C.EPSILON_T,
        torch.where(carry.alive, C.INFINITY_T, 0.0), scene.tri_bvh,
        scene.triangles)
    envbg = env_ops.environment_background(env, carry.ray_d, uni, static,
                                           carry.env_lod,
                                           carry.env_lod_active)
    envpdf = env_ops.environment_pdf(env, carry.ray_d, 0.0)
    trans = shade.shade_s1(carry, t, tri, u, v, scene.triangles,
                           scene.materials, envbg, envpdf, params, 5)
    live_hit = before["alive"] & (tri >= 0)
    assert torch.equal(carry.alive, live_hit)
    assert (trans[~live_hit] == 0).all()
    esmp = torch.zeros((n, 9))
    shade.shade_s2(carry, t, tri, u, v, scene.triangles, scene.materials,
                   trans, esmp, params, 5)
    assert torch.equal(carry.prev_prim[live_hit], tri[live_hit])
    assert carry.prev_valid[live_hit].all()
    assert not carry.prev_valid[before["alive"] & (tri < 0)].any()
    dead = ~before["alive"]
    for k, val in vars(carry).items():
        assert torch.equal(val[dead], before[k][dead]), k
    # some live hits ended here (failed sample or roulette), some go on
    assert (live_hit & ~carry.alive).any() and carry.alive.any()
