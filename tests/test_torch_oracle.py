"""The port's oracle backend against the JAX package's.

- ``renderer/oracle.pack_materials`` bit for bit equal to the JAX
  wrapper's on ``assets/scenes/materials.scene`` (lambert, metal, glass,
  plastic, carpaint, subsurface), the Cornell box (its diffuse light) and
  the six-slot scene (PBR with every texture slot bound): all eight
  material types and the texture slot ids.
- ``render_oracle`` of the port bit for bit equal to the JAX wrapper's on
  the smoke scene, the Cornell box and a scene under an environment built
  from texels (as ``tests/test_oracle_parity.py`` builds its own): both
  wrappers feed the same library, so a difference is a packing fault.
- The port's plain path against the oracle at the reference's own gate,
  ``test_oracle_parity.py test_cornell_box_rmse`` (40x40, 64 spp: RMSE
  < 0.02, means within 0.005).
- The CLI's backend names: ``metal`` is the card (no CUDA device here),
  ``cpu``, ``oracle``, ``embree`` and ``--enableEmbree 1`` the oracle,
  each writing the JAX package's CLI bytes on the smoke scene (8x8, 1
  spp), and ``cpu-torch`` the port's plain path.

No JAX integrator call: the JAX side is its oracle wrapper and its CLI on
the oracle backend.
"""

import dataclasses

import numpy as np
import pytest
import torch

from metal_pathtracer_tpu import cli as jax_cli
from metal_pathtracer_tpu.renderer import oracle as jax_oracle
from metal_pathtracer_tpu.scene import dsl as jax_dsl
from metal_pathtracer_tpu.scene.resources import Material as JMaterial
from metal_pathtracer_tpu.scene.resources import Mesh as JMesh
from metal_pathtracer_tpu.scene.resources import SceneResources as JResources
from metal_pathtracer_tpu.schema import EnvironmentSoA as JEnvironment
from metal_pathtracer_tpu.settings import RenderSettings as JSettings
from metal_pathtracer_tpu_torch import cli
from metal_pathtracer_tpu_torch.ops import env as env_ops
from metal_pathtracer_tpu_torch.renderer import oracle
from metal_pathtracer_tpu_torch.renderer.headless import (
    CudaBackend,
    OracleBackend,
    make_backend,
)
from metal_pathtracer_tpu_torch.scene import dsl
from metal_pathtracer_tpu_torch.scene.resources import SceneResources
from metal_pathtracer_tpu_torch.settings import BackgroundMode, RenderSettings
from metal_pathtracer_tpu_torch.utils import benchscene as B
from metal_pathtracer_tpu_torch.utils import image_io

SMOKE = "tests/scenes/smoke.scene"

# test_oracle_parity.py's Cornell box (test_cornell_box_rmse)
CORNELL = """\
camera target=0,1,0 distance=3.9 yaw=1.5708 pitch=0 vfov=40
renderer maxDepth=5 seed=7
material type=lambert albedo=0.73,0.73,0.73
material type=lambert albedo=0.65,0.05,0.05
material type=lambert albedo=0.12,0.45,0.15
material type=light emit=15,15,15
rectangle x=-1,1 y=0 z=-1,1 normal=1 material=0
rectangle x=-1,1 y=2 z=-1,1 normal=-1 material=0
rectangle x=-1 y=0,2 z=-1,1 normal=1 material=2
rectangle x=1 y=0,2 z=-1,1 normal=-1 material=1
rectangle x=-1,1 y=0,2 z=-1 normal=1 material=0
rectangle x=-0.4,0.4 y=1.99 z=-0.4,0.4 normal=-1 material=3
"""

# test_oracle_parity.py's environment scene (test_env_scene_rmse)
ENV_SCENE = """\
camera target=0,0,-1 distance=3 yaw=0 pitch=0 vfov=45
renderer maxDepth=4 seed=9
material type=lambert albedo=0.7,0.7,0.7
sphere center=0,0,-1 radius=0.5 material=0
sphere center=0,-100.5,-1 radius=100 material=0
"""


@pytest.fixture(scope="module", autouse=True)
def _library():
    """The library is built from ``native/`` on first use; the tests need
    it (a missing oracle raises, it never falls back)."""
    assert oracle.oracle_available(), "native/build.sh failed"


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def both(text=None, path=None):
    """(port settings, port resources, JAX settings, JAX resources) of one
    scene text or file, parsed by each package's DSL."""
    ps, pr, js, jr = RenderSettings(), SceneResources(), JSettings(), \
        JResources()
    if path is not None:
        dsl.load_scene_file(str(path), ps, pr)
        jax_dsl.load_scene_file(str(path), js, jr)
    else:
        dsl.parse_scene(text, ps, pr)
        jax_dsl.parse_scene(text, js, jr)
    return ps, pr, js, jr


def jax_twin(port_res):
    """The JAX package's ``SceneResources`` with a port scene's materials,
    meshes and images (the six-slot scene is built in code)."""
    jres = JResources()
    for m in port_res.materials:
        jres.add_material(JMaterial(**dataclasses.asdict(m)))
    for m in port_res.meshes:
        jres.add_mesh(JMesh(**vars(m)))
    jres.texture_images.extend(port_res.texture_images)
    jres.texture_srgb.extend(port_res.texture_srgb)
    jres.texture_wrap.extend(port_res.texture_wrap)
    return jres


def test_pack_materials_bit_equal():
    types, slots = set(), set()
    _, mr, _, mj = both(path=B.MATERIALS_PATH)
    _, cr, _, cj = both(path=B.CORNELL_PATH)
    _, sr = B.build_six_slot_scene(0)
    for port_res, jres in ((mr, mj), (cr, cj), (sr, jax_twin(sr))):
        got, want = oracle.pack_materials(port_res), \
            jax_oracle.pack_materials(jres)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape and got.shape[1] == 72
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        types |= {int(t) for t in got[:, 4]}
        slots |= {int(s) for s in got[:, 61:67].ravel() if s >= 0}
    assert types == oracle.ORACLE_TYPES == set(jax_oracle.ORACLE_TYPES)
    assert slots == set(range(6))


def _environment():
    """test_oracle_parity.py's 32x16 sky with a warm hot spot, for each
    package."""
    texels = np.full((16, 32, 3), 0.2, np.float32)
    texels[3:6, 6:10] = (8.0, 6.0, 3.0)
    port = env_ops.environment_from_texels(texels, "cpu")
    from metal_pathtracer_tpu.ops import env as jax_env

    ma, mt, ca, ct, pdf = jax_env.build_distribution(texels)
    jax = JEnvironment(
        texels=texels, mips=(), marginal_threshold=mt,
        marginal_alias=ma.astype(np.int32), conditional_threshold=ct,
        conditional_alias=ca.astype(np.int32), pdf=pdf, width=32, height=16)
    return port, jax


@pytest.mark.parametrize("scene", ["smoke", "cornell", "environment"])
def test_render_oracle_bit_equal(scene):
    port_env = jax_env = None
    if scene == "smoke":
        ps, pr, js, jr = both(path=SMOKE)
        w, h, spp = 48, 48, 8
    elif scene == "cornell":
        ps, pr, js, jr = both(CORNELL)
        w, h, spp = 40, 40, 8
    else:
        ps, pr, js, jr = both(ENV_SCENE)
        ps.backgroundMode = js.backgroundMode = BackgroundMode.ENVIRONMENT
        port_env, jax_env = _environment()
        w, h, spp = 32, 32, 8
    got = oracle.render_oracle(pr, ps, w, h, spp, environment=port_env)
    want = jax_oracle.render_oracle(jr, js, w, h, spp, environment=jax_env)
    assert got.shape == (h, w, 3) and got.dtype == np.float32
    assert np.isfinite(got).all() and got.max() > 0.0
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_plain_path_meets_the_cornell_gate():
    """The port's plain path against the oracle at test_cornell_box_rmse's
    gate: RMSE < 0.02 and means within 0.005 (40x40, 64 spp)."""
    settings, res, _, _ = both(CORNELL)
    img = make_backend("cpu-torch").render(res, settings, 40, 40,
                                           64).linear_rgb
    ref = make_backend("oracle").render(res, settings, 40, 40,
                                        64).linear_rgb
    err = oracle.rmse(img, ref)
    assert err < 0.02, f"RMSE {err}"
    assert abs(img.mean() - ref.mean()) < 0.005


def test_texture_pool_needs_equal_squares():
    """The library takes one pool of equal square textures; the six-slot
    scene's mixed sizes need the resampler the port does not have."""
    settings, res = B.build_six_slot_scene(0)
    with pytest.raises(NotImplementedError, match="resampler"):
        oracle.render_oracle(res, settings, 8, 8, 1)


def _cli_bytes(main, tmp_path, tag, *extra):
    out = str(tmp_path / f"{tag}.ppm")
    assert main(["--scene", SMOKE, "--width", "8", "--height", "8",
                 "--sppTotal", "1", "--seed", "1337", "--format", "ppm",
                 "--output", out, *extra]) == 0
    return open(out, "rb").read()


@pytest.mark.parametrize("args", [("--backend", "cpu"),
                                  ("--backend", "oracle"),
                                  ("--backend", "embree"),
                                  ("--enableEmbree", "1")])
def test_cli_oracle_names_match_jax(tmp_path, args):
    got = _cli_bytes(cli.main, tmp_path, "port", *args)
    want = _cli_bytes(jax_cli.main, tmp_path, "jax", *args)
    assert got.startswith(b"P6\n8 8\n255\n") and got == want


def test_cli_metal_is_the_card(tmp_path, capsys):
    if torch.cuda.is_available():
        assert make_backend("metal").device == "cuda"
        return
    assert cli.main(["--scene", SMOKE, "--width", "8", "--height", "8",
                     "--sppTotal", "1", "--backend", "metal", "--output",
                     str(tmp_path / "x.ppm")]) == 1
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "unknown backend" not in err


def test_cli_cpu_torch_is_the_plain_path(tmp_path):
    got = _cli_bytes(cli.main, tmp_path, "port", "--backend", "cpu-torch")
    backend = make_backend("cpu-torch")
    assert isinstance(backend, CudaBackend) and backend.device == "cpu"
    assert isinstance(make_backend("cpu"), OracleBackend)
    settings, res, _, _ = both(path=SMOKE)
    settings.fixedRngSeed = 1337
    img = backend.render(res, settings, 8, 8, 1).linear_rgb
    path = str(tmp_path / "direct.ppm")
    image_io.write_image(path, img, "ppm", image_io.TonemapSettings(
        tonemapMode=settings.tonemapMode, acesVariant=settings.acesVariant,
        exposure=settings.exposure,
        reinhardWhitePoint=settings.reinhardWhitePoint))
    assert got == open(path, "rb").read()
