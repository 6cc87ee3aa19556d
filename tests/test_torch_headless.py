"""The port's headless surface against the JAX package's:

- ``CudaBackend`` checkpoints on the CPU: ``tests/test_checkpoint.py``'s
  four cases (a resume bit-identical to the straight render, a finished
  checkpoint a no-op, size and scene mismatches refused);
- the ``.npz`` format: a port-written checkpoint read by the JAX
  package's ``RenderState.load`` with the same arrays, and a JAX-written
  one loaded by the port;
- ``utils/image_io``: every writer's bytes equal to the JAX writer's on
  the same numpy image, the readers' round trips, and an ``.exr``
  environment map read by ``ops/env.load_hdr_image``;
- ``ops/tonemap``: every mode and ``bloom`` within 1e-6 of the JAX
  package's (numpy path, as its writers run it);
- the CLI on ``tests/scenes/smoke.scene`` at 48x48, 2 spp, PPM on the
  CPU backend: the reference header, the sky corner ~ (217, 230, 255),
  and the same bytes from two runs with one seed;
- ``scene/manager.build_procedural_scene`` sphere for sphere equal to
  the JAX package's.

No JAX render: the JAX side is its writers, its checkpoint format and its
procedural scene.
"""

import numpy as np
import pytest
import torch

from metal_pathtracer_tpu.ops import tonemap as jax_tonemap
from metal_pathtracer_tpu.renderer.accumulation import RenderState as JState
from metal_pathtracer_tpu.scene.manager import (
    build_procedural_scene as jax_procedural,
)
from metal_pathtracer_tpu.scene.resources import SceneResources as JResources
from metal_pathtracer_tpu.settings import RenderSettings as JSettings
from metal_pathtracer_tpu.utils import image_io as jax_io
from metal_pathtracer_tpu_torch import cli
from metal_pathtracer_tpu_torch.ops import env as env_ops
from metal_pathtracer_tpu_torch.ops import tonemap
from metal_pathtracer_tpu_torch.renderer.accumulation import (
    CheckpointError,
    RenderState,
)
from metal_pathtracer_tpu_torch.renderer.headless import make_backend
from metal_pathtracer_tpu_torch.scene import dsl
from metal_pathtracer_tpu_torch.scene.manager import (
    SceneManager,
    build_procedural_scene,
)
from metal_pathtracer_tpu_torch.scene.resources import SceneResources
from metal_pathtracer_tpu_torch.settings import RenderSettings
from metal_pathtracer_tpu_torch.utils import image_io

SCENE = """\
camera target=0,0,-1 distance=3.5 yaw=0 pitch=0 vfov=45
renderer maxDepth=4 seed=1337
background solid=0.7,0.8,1.0
material type=lambert albedo=0.8,0.3,0.3
material type=lambert albedo=0.8,0.8,0.0
sphere center=0,0,-1 radius=0.5 material=0
sphere center=0,-100.5,-1 radius=100 material=1
"""


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _scene():
    settings, res = RenderSettings(), SceneResources()
    dsl.parse_scene(SCENE, settings, res)
    return settings, res


@pytest.fixture
def backend():
    return make_backend("cpu-torch")


# ---- checkpoints (tests/test_checkpoint.py on the port) -------------------

def test_resume_bit_identical(tmp_path, backend):
    settings, res = _scene()
    straight = backend.render(res, settings, 16, 16, 16)
    ckpt = str(tmp_path / "state.ckpt")
    part1 = backend.render(res, settings, 16, 16, 8, checkpoint_path=ckpt)
    assert part1.samples == 8
    resumed = backend.render(res, settings, 16, 16, 16, checkpoint_path=ckpt)
    assert resumed.samples == 16
    np.testing.assert_array_equal(resumed.linear_rgb, straight.linear_rgb)
    np.testing.assert_array_equal(resumed.sample_count, straight.sample_count)


def test_resume_noop_when_done(tmp_path, backend):
    settings, res = _scene()
    ckpt = str(tmp_path / "state.ckpt")
    first = backend.render(res, settings, 16, 16, 8, checkpoint_path=ckpt)
    again = backend.render(res, settings, 16, 16, 8, checkpoint_path=ckpt)
    assert again.samples == 8
    np.testing.assert_array_equal(again.linear_rgb, first.linear_rgb)


def test_resume_rejects_resolution_mismatch(tmp_path, backend):
    settings, res = _scene()
    ckpt = str(tmp_path / "state.ckpt")
    backend.render(res, settings, 16, 16, 2, checkpoint_path=ckpt)
    with pytest.raises(CheckpointError, match="32x32"):
        backend.render(res, settings, 32, 32, 4, checkpoint_path=ckpt)


def test_resume_rejects_scene_mismatch(tmp_path, backend):
    settings, res = _scene()
    ckpt = str(tmp_path / "state.ckpt")
    backend.render(res, settings, 16, 16, 2, checkpoint_path=ckpt)
    other_settings, other_res = _scene()
    other_settings.maxDepth = 7  # radiometrically different render
    with pytest.raises(CheckpointError, match="digest"):
        backend.render(other_res, other_settings, 16, 16, 4,
                       checkpoint_path=ckpt)


def test_make_backend_never_falls_back():
    assert make_backend("cpu-torch").device == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_backend("cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        make_backend("tpu")


# ---- the .npz format, both ways --------------------------------------------

def _filled_state(rng, w=5, h=3):
    f = lambda *s: torch.from_numpy(rng.uniform(0, 2, s).astype(np.float32))
    return RenderState(radiance_sum=f(h, w, 3), radiance_sq_sum=f(h, w, 3),
                       sample_count=torch.from_numpy(
                           rng.integers(0, 9, (h, w))).to(torch.int64),
                       albedo=f(h, w, 3), normal=f(h, w, 3), frame_index=6,
                       ray_count=12345, shadow_ray_count=678)


def test_port_checkpoint_reads_in_jax(tmp_path):
    st = _filled_state(np.random.default_rng(3))
    path = str(tmp_path / "port.npz")
    st.save(path, digest="abc")
    js = JState.load(path, expect_digest="abc", expect_size=(5, 3))
    for k in ("radiance_sum", "radiance_sq_sum", "albedo", "normal"):
        np.testing.assert_array_equal(np.asarray(getattr(js, k)),
                                      getattr(st, k).numpy(), err_msg=k)
    assert np.asarray(js.sample_count).dtype == np.uint32
    np.testing.assert_array_equal(np.asarray(js.sample_count),
                                  st.sample_count.numpy())
    assert int(js.frame_index) == 6
    assert float(js.ray_count) == 12345.0
    assert float(js.shadow_ray_count) == 678.0
    np.testing.assert_array_equal(np.asarray(js.variance_of_mean()),
                                  st.variance_of_mean().numpy())
    data = np.load(path)
    assert set(data.files) == {
        "digest", "radiance_sum", "sample_count", "albedo", "normal",
        "frame_index", "denoised", "ray_count", "shadow_ray_count",
        "radiance_sq_sum"}


def test_jax_checkpoint_loads_in_port(tmp_path):
    rng = np.random.default_rng(4)
    js = JState.create(5, 3)
    js = js.replace(
        radiance_sum=js.radiance_sum + rng.uniform(0, 2, (3, 5, 3)).astype(
            np.float32),
        sample_count=js.sample_count + 3, frame_index=js.frame_index + 3,
        ray_count=js.ray_count + 99.0)
    path = str(tmp_path / "jax.npz")
    js.save(path, digest="xyz")
    st = RenderState.load(path, expect_digest="xyz", expect_size=(5, 3),
                          device="cpu")
    np.testing.assert_array_equal(st.radiance_sum.numpy(),
                                  np.asarray(js.radiance_sum))
    assert st.sample_count.dtype == torch.int64
    assert (st.sample_count == 3).all() and st.frame_index == 3
    assert st.ray_count == 99
    with pytest.raises(CheckpointError, match="digest"):
        RenderState.load(path, expect_digest="other", device="cpu")
    with pytest.raises(CheckpointError, match="could not load"):
        RenderState.load(str(tmp_path / "missing.npz"), device="cpu")


# ---- image writers and readers ---------------------------------------------

@pytest.fixture
def hdr():
    rng = np.random.default_rng(7)
    return rng.uniform(0.0, 4.0, size=(13, 17, 3)).astype(np.float32)


@pytest.mark.parametrize("tm", [(1, 0, 0.0), (2, 0, 0.5), (2, 1, 0.0),
                                (3, 0, -0.5), (4, 0, 0.0)])
def test_ldr_writers_bytes_equal_jax(tmp_path, hdr, tm):
    mode, variant, exposure = tm
    settings = dict(tonemapMode=mode, acesVariant=variant, exposure=exposure,
                    reinhardWhitePoint=1.5)
    for fmt in ("ppm", "png"):
        a, b = str(tmp_path / f"p.{fmt}"), str(tmp_path / f"j.{fmt}")
        image_io.write_image(a, hdr, fmt, image_io.TonemapSettings(**settings))
        jax_io.write_image(b, hdr, fmt, jax_io.TonemapSettings(**settings))
        assert open(a, "rb").read() == open(b, "rb").read(), fmt
    back = image_io.read_ppm(str(tmp_path / "p.ppm"))
    np.testing.assert_array_equal(back, image_io.tonemap_to_u8(
        hdr, image_io.TonemapSettings(**settings)))


def test_hdr_writers_bytes_equal_jax(tmp_path, hdr):
    samples = np.full(hdr.shape[:2], 7, np.uint32)
    writes = [
        ("pfm", lambda io, p: io.write_pfm(p, hdr)),
        ("exr", lambda io, p: io.write_exr_rgb(p, hdr)),
        ("layers.exr", lambda io, p: io.write_exr_multilayer(
            p, hdr, albedo=hdr * 0.5, normal=hdr * 0.25, samples=samples)),
    ]
    for name, write in writes:
        a, b = str(tmp_path / f"p.{name}"), str(tmp_path / f"j.{name}")
        write(image_io, a)
        write(jax_io, b)
        assert open(a, "rb").read() == open(b, "rb").read(), name
    np.testing.assert_array_equal(image_io.read_pfm(str(tmp_path / "p.pfm")),
                                  hdr)
    ch = image_io.read_exr(str(tmp_path / "p.layers.exr"))
    assert set(ch) == {"R", "G", "B", "albedo.R", "albedo.G", "albedo.B",
                       "normal.R", "normal.G", "normal.B", "SAMPLES"}
    np.testing.assert_array_equal(np.stack([ch["R"], ch["G"], ch["B"]], -1),
                                  hdr)
    np.testing.assert_array_equal(ch["SAMPLES"], 7.0)
    np.testing.assert_array_equal(ch["albedo.G"], hdr[..., 1] * 0.5)


def test_exr_environment_map(tmp_path, hdr):
    """An uncompressed EXR environment map reads through ``read_exr``
    (the port read .hdr and .pfm only before), the same texels."""
    path = str(tmp_path / "sky.exr")
    image_io.write_exr_rgb(path, hdr)
    np.testing.assert_array_equal(env_ops.load_hdr_image(path), hdr)
    env = env_ops.load_environment(path, "cpu")
    assert env.width == hdr.shape[1] and env.height == hdr.shape[0]


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("variant", [0, 1])
def test_tonemap_matches_jax(hdr, mode, variant):
    got = tonemap.apply_tonemap(torch.from_numpy(hdr), mode, variant, 0.3,
                                1.5).numpy()
    ref = jax_tonemap.apply_tonemap(hdr, mode, variant, 0.3, 1.5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_bloom_matches_jax(hdr):
    got = tonemap.bloom(torch.from_numpy(hdr), 1.0, 0.6, 2.0).numpy()
    ref = jax_tonemap.bloom(hdr, 1.0, 0.6, 2.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


# ---- the CLI ---------------------------------------------------------------

def test_cli_smoke_scene_ppm(tmp_path, capsys):
    outs = []
    for k in range(2):
        out = str(tmp_path / f"smoke{k}.ppm")
        assert cli.main(["--scene", "tests/scenes/smoke.scene", "--width",
                         "48", "--height", "48", "--sppTotal", "2",
                         "--maxDepth", "4", "--seed", "1337", "--format",
                         "ppm", "--backend", "cpu-torch", "--output",
                         out]) == 0
        outs.append(open(out, "rb").read())
    printed = capsys.readouterr().out
    assert "Rendered 2 spp at 48x48" in printed and "[Output]" in printed
    assert outs[0] == outs[1]
    assert outs[0].startswith(b"P6\n48 48\n255\n")
    img = np.frombuffer(outs[0][13:], np.uint8).reshape(48, 48, 3)
    assert np.abs(img[0, 0].astype(int) - (217, 230, 255)).max() <= 1


def test_cli_error_paths(tmp_path, capsys):
    assert cli.main(["--scene", "no_such_scene", "--backend",
                     "cpu-torch"]) == 1
    assert "scene not found" in capsys.readouterr().err
    assert cli.main(["--scene", "tests/scenes/smoke.scene", "--width", "8",
                     "--height", "8", "--sppTotal", "1", "--enableMnee",
                     "1", "--backend", "cpu-torch", "--output",
                     str(tmp_path / "x.exr")]) == 1
    err = capsys.readouterr().err
    assert err.startswith("error: MNEE") and "Traceback" not in err
    assert SceneManager().find_scene("cornell").endswith("cornell.scene")


# ---- the procedural default scene -------------------------------------------

def test_procedural_scene_matches_jax():
    ps, pr = RenderSettings(), SceneResources()
    js, jr = JSettings(), JResources()
    build_procedural_scene(ps, pr)
    jax_procedural(js, jr)
    # 353 spheres: above 32, so the CLI's default scene runs K3b
    assert len(pr.spheres) == len(jr.spheres) == 353
    for a, b in zip(pr.spheres, jr.spheres):
        assert (a.center, a.radius, a.material) == \
            (tuple(b.center), b.radius, b.material)
    assert len(pr.materials) == len(jr.materials)
    for a, b in zip(pr.materials, jr.materials):
        assert (a.mat_type, a.base_color, a.roughness, a.ior) == \
            (b.mat_type, tuple(b.base_color), b.roughness, b.ior)
    assert ps.backgroundMode == js.backgroundMode
