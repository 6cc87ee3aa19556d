"""The port's depth loop (K1 + K2 plain versions) vs the JAX package's
``integrator.trace_paths`` (XLA path) on the same primary-ray lanes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_pathtracer_tpu import constants as C
from metal_pathtracer_tpu.ops import camera as jax_camera
from metal_pathtracer_tpu.ops import integrator as jax_integrator
from metal_pathtracer_tpu.ops import rng as jax_rng
from metal_pathtracer_tpu.scene.resources import Material as JMaterial
from metal_pathtracer_tpu.scene.resources import SceneResources as JResources
from metal_pathtracer_tpu.schema import settings_to_static as jax_static
from metal_pathtracer_tpu.schema import settings_to_uniforms as jax_uniforms
from metal_pathtracer_tpu.settings import BackgroundMode, RenderSettings
from metal_pathtracer_tpu.utils.procgen import dragon_class_scene_mesh
from metal_pathtracer_tpu_torch import convert
from metal_pathtracer_tpu_torch.ops import integrator
from metal_pathtracer_tpu_torch.ops.kernels import shade
from metal_pathtracer_tpu_torch.scene.resources import (
    Material,
    Mesh,
    SceneResources,
)

W, H = 32, 24

# The image gate the reference holds its own fused kernel to
# (tests/test_fused_shade.py:60-73): ulp drift from XLA:CPU's approximate
# sqrt/rsqrt/cos/sin compounds over bounces and may flip a rare Russian
# roulette decision, so parity is statistical past depth 1.
MAX_RMSE = 2e-4
MIN_WITHIN_1E5 = 0.98


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def scenes():
    jm = dragon_class_scene_mesh(2, material=0)
    jr, pr = JResources(), SceneResources()
    jr.add_material(JMaterial(base_color=(0.7, 0.6, 0.5)))
    pr.add_material(Material(base_color=(0.7, 0.6, 0.5)))
    jr.add_mesh(jm)
    pr.add_mesh(Mesh(**{f.name: getattr(jm, f.name)
                        for f in dataclasses.fields(Mesh)}))
    return jr, jr.build_arrays(), pr.build_arrays(device="cpu")


def _settings(depth, background, space, rr=True):
    s = RenderSettings()
    s.cameraTarget = (0.0, 0.0, 0.0)
    s.cameraDistance = 3.2
    s.cameraYaw = 0.4
    s.cameraPitch = 0.25
    s.maxDepth = depth
    s.fixedRngSeed = 1234
    s.enableRussianRoulette = rr
    s.backgroundMode = background
    s.backgroundColor = (0.9, 0.6, 0.3)
    s.workingColorSpace = space
    return s


def _np(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _np(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return np.asarray(obj)


CASES = [
    (1, BackgroundMode.GRADIENT, 0, True),
    (8, BackgroundMode.GRADIENT, 0, True),
    (8, BackgroundMode.SOLID, 0, True),
    (8, BackgroundMode.GRADIENT, 1, True),
    (8, BackgroundMode.SOLID, 1, True),
    (8, BackgroundMode.GRADIENT, 0, False),
]


@pytest.mark.parametrize("depth,background,space,rr", CASES)
def test_trace_paths_matches_jax(scenes, depth, background, space, rr):
    jr, js, ps = scenes
    s = _settings(depth, background, space, rr)
    static = jax_static(s, W, H, jr.material_types_present())
    uni = jax_uniforms(s, jax_camera.build_camera(s, W, H), 2, 2)
    n = W * H
    x = jnp.arange(n, dtype=jnp.uint32) % W
    y = jnp.arange(n, dtype=jnp.uint32) // W

    @jax.jit
    def reference(uni):
        seed = jax_rng.make_seed(uni.fixed_rng_seed, uni.frame_index, x, y,
                                 uni.sample_count, jnp.zeros(n, jnp.uint32))
        st, o, d = jax_camera.generate_primary_rays(uni.camera, x, y, W, H,
                                                    seed)
        out = jax_integrator.trace_paths(js, uni, static, st, o, d)
        return (st, o, d) + tuple(out)

    st0, o, d, st, rad, alb, nrm, stats = reference(uni)
    p_uni = convert.uniforms(_np(uni), "cpu")
    p_static = convert.static_config(dataclasses.asdict(static))
    t = lambda a, dt=None: torch.tensor(np.asarray(a), dtype=dt)
    p_st, p_rad, p_alb, p_nrm, p_stats = integrator.trace_paths(
        ps, p_uni, p_static, t(st0, torch.int64), t(o), t(d))

    rays = float(stats["rays"])
    assert abs(p_stats["rays"] - rays) <= max(4.0, 1e-4 * rays)
    diff = np.abs(p_rad.numpy() - np.asarray(rad))
    rmse = float(np.sqrt((diff * diff).mean()))
    assert rmse < MAX_RMSE, rmse
    assert float((diff.max(-1) < 1e-5).mean()) > MIN_WITHIN_1E5
    # first-hit AOVs: the albedo is a table value, the normal carries the
    # normalization ulps of the hit rebuild
    np.testing.assert_array_equal(p_alb.numpy(), np.asarray(alb))
    np.testing.assert_allclose(p_nrm.numpy(), np.asarray(nrm), rtol=0,
                               atol=1e-5)
    same_state = (p_st.numpy().astype(np.uint32) == np.asarray(st)).mean()
    assert same_state > MIN_WITHIN_1E5
    if depth == 1:   # one bounce: the RNG streams agree exactly
        assert same_state == 1.0


def test_shade_full_keeps_dead_lanes(scenes):
    """Dead lanes enter and leave K2 with every carry value unchanged, and
    only live lanes that hit advance their RNG state (in place)."""
    _, _, ps = scenes
    s = _settings(8, BackgroundMode.GRADIENT, 0)
    from metal_pathtracer_tpu_torch.ops.camera import build_camera
    from metal_pathtracer_tpu_torch.schema import (
        settings_to_static,
        settings_to_uniforms,
    )
    uni = settings_to_uniforms(s, build_camera(s, W, H, "cpu"), 0, 0)
    static = settings_to_static(s, W, H, [C.MATERIAL_LAMBERTIAN])
    n = W * H
    rng = np.random.default_rng(5)
    o = torch.tensor(rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32))
    o[:, 2] += 3.0
    d = torch.tensor(rng.normal(size=(n, 3)).astype(np.float32))
    d[:, 2] = -3.0
    state = torch.tensor(rng.integers(0, 2 ** 32, n), dtype=torch.int64)
    carry = integrator.PathCarry.start(state, o, d, 0.0, 0.01)
    carry.alive[::3] = False
    before = {k: v.clone() for k, v in vars(carry).items()}
    hit = shade.trace_closest(carry.ray_o, carry.ray_d, C.EPSILON_T,
                              torch.where(carry.alive, C.INFINITY_T, 0.0),
                              ps.tri_bvh, ps.triangles)
    shade.shade_full(carry, *hit, ps.triangles, ps.materials,
                     shade.ShadeParams.of(uni, static), 0)
    dead = ~before["alive"]
    for k, v in vars(carry).items():
        assert torch.equal(v[dead], before[k][dead]), k
    live_hit = before["alive"] & (hit[1] >= 0)
    assert live_hit.any() and (before["alive"] & (hit[1] < 0)).any()
    assert (carry.state[live_hit] != before["state"][live_hit]).all()
    live_miss = before["alive"] & (hit[1] < 0)
    assert torch.equal(carry.state[live_miss], before["state"][live_miss])
    assert not carry.alive[live_miss].any()
    assert (carry.radiance[live_miss] > 0).all()


def test_material_tables_packed_once(scenes):
    """K2's and the texture stage's material tables are packed on first
    use and kept on the materials object, value for value what the
    packers give; a new materials object gets its own."""
    from metal_pathtracer_tpu_torch.ops.kernels import texture

    _, _, ps = scenes
    m = ps.materials
    for pack in (shade.pack_material_table,
                 texture.pack_texture_material_table):
        table = m.table(pack)
        assert m.table(pack) is table
        assert torch.equal(table, pack(m))
    assert m.table(shade.pack_material_table).shape == (
        m.count, len(shade.MAT_COLS))
    other = dataclasses.replace(m, roughness=m.roughness + 0.25)
    assert not torch.equal(other.table(shade.pack_material_table),
                           m.table(shade.pack_material_table))
