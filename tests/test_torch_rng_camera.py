"""PCG streams and camera rays: the PyTorch port vs ``ops/rng.py`` and
``ops/camera.py`` of the JAX package, on the same numpy-made inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_pathtracer_tpu.ops import camera as jcam
from metal_pathtracer_tpu.ops import rng as jrng
from metal_pathtracer_tpu.settings import RenderSettings
from metal_pathtracer_tpu_torch.ops import camera as pcam
from metal_pathtracer_tpu_torch.ops import rng as prng

# XLA:CPU evaluates sqrt, cos and sin with its own approximations, which
# differ from the correctly rounded sqrt and PyTorch's cosf/sinf by up to
# one ulp (measured: ~5% of cos/sin arguments on [0, 2pi), ~0.5% of sqrt
# arguments on [0, 1]); a sample component such as cos(phi) * r is then
# off by at most ~2 ulp of 1.
TRIG_ATOL = 2.0 ** -22
RAY_ULPS = 2


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _states(n=4096, seed=0):
    return np.random.default_rng(seed).integers(0, 2 ** 32, n,
                                                dtype=np.uint64).astype(
                                                    np.uint32)


def _u32(t):
    return t.numpy().astype(np.uint32)


def test_make_seed_bitexact():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 4096, 2048).astype(np.uint32)
    y = rng.integers(0, 4096, 2048).astype(np.uint32)
    prev = rng.integers(0, 2 ** 32, 2048, dtype=np.uint64).astype(np.uint32)
    for fixed, frame, count in ((0, 0, 0), (1234, 7, 7),
                                (2 ** 32 - 1, 2 ** 31 + 5, 2 ** 32 - 3)):
        ref = np.asarray(jrng.make_seed(fixed, frame, jnp.asarray(x),
                                        jnp.asarray(y), count,
                                        jnp.asarray(prev)))
        got = prng.make_seed(fixed, frame, torch.from_numpy(x.astype(np.int64)),
                             torch.from_numpy(y.astype(np.int64)), count,
                             torch.from_numpy(prev.astype(np.int64)))
        np.testing.assert_array_equal(_u32(got), ref)


def test_pcg_rand_uniform_stream_bitexact():
    s = _states()
    js, ps = jnp.asarray(s), torch.from_numpy(s.astype(np.int64))
    np.testing.assert_array_equal(_u32(prng.pcg_hash(ps)),
                                  np.asarray(jrng.pcg_hash(js)))
    for _ in range(8):
        js, jv = jrng.rand_uniform(js)
        ps, pv = prng.rand_uniform(ps)
        np.testing.assert_array_equal(_u32(ps), np.asarray(js))
        np.testing.assert_array_equal(pv.numpy().view(np.int32),
                                      np.asarray(jv).view(np.int32))


def test_random_in_unit_disk_bitexact():
    s = _states(seed=2)
    js, jv = jrng.random_in_unit_disk(jnp.asarray(s))
    ps, pv = prng.random_in_unit_disk(torch.from_numpy(s.astype(np.int64)))
    np.testing.assert_array_equal(_u32(ps), np.asarray(js))
    np.testing.assert_array_equal(pv.numpy().view(np.int32),
                                  np.asarray(jv).view(np.int32))


def test_sample_cosine_hemisphere():
    """The state stream is bit-exact; the direction carries the sqrt/cos/sin
    ulp (TRIG_ATOL)."""
    s = _states(seed=3)
    js, jv = jrng.sample_cosine_hemisphere(jnp.asarray(s))
    ps, pv = prng.sample_cosine_hemisphere(torch.from_numpy(s.astype(np.int64)))
    jv, pv = np.asarray(jv), pv.numpy()
    np.testing.assert_array_equal(_u32(ps), np.asarray(js))
    np.testing.assert_allclose(pv, jv, rtol=0, atol=TRIG_ATOL)


def _camera_settings(defocus):
    s = RenderSettings()
    s.cameraTarget = (0.0, 0.1, 0.0)
    s.cameraDistance = 3.2
    s.cameraYaw = 0.4
    s.cameraPitch = 0.25
    s.cameraVerticalFov = 40.0
    s.cameraDefocusAngle = defocus
    return s


def test_build_camera_bitexact():
    for defocus in (0.0, 2.5):
        s = _camera_settings(defocus)
        ref = jcam.build_camera(s, 40, 24, to_device=False)
        got = pcam.build_camera(s, 40, 24, "cpu")
        for f in ("origin", "lower_left", "horizontal", "vertical", "u", "v",
                  "lens_radius"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(ref, f)), f)


@pytest.mark.parametrize("defocus", [0.0, 2.5])
def test_generate_primary_rays(defocus):
    """States match bit for bit; origins and directions within RAY_ULPS of
    the camera's extent. The reference runs jitted, as in a render, and
    XLA:CPU's vectorizer then fuses ``ll + u*h + v*w`` (and the lens
    offset) into FMAs on some (N,3) components and not on others, which
    the port does not copy: it fuses all three."""
    w, h = 40, 24
    s = _camera_settings(defocus)
    jc = jcam.build_camera(s, w, h)
    pc = pcam.build_camera(s, w, h, "cpu")
    n = w * h
    x = (np.arange(n) % w).astype(np.uint32)
    y = (np.arange(n) // w).astype(np.uint32)
    seed = np.asarray(jrng.make_seed(1234, 3, jnp.asarray(x), jnp.asarray(y), 3,
                                     jnp.zeros(n, jnp.uint32)))
    js, jo, jd = jax.jit(jcam.generate_primary_rays, static_argnums=(3, 4))(
        jc, jnp.asarray(x), jnp.asarray(y), w, h, jnp.asarray(seed))
    ps, po, pd = pcam.generate_primary_rays(
        pc, torch.from_numpy(x.astype(np.int64)),
        torch.from_numpy(y.astype(np.int64)), w, h,
        torch.from_numpy(seed.astype(np.int64)))
    np.testing.assert_array_equal(_u32(ps), np.asarray(js))
    jo, jd, po, pd = np.asarray(jo), np.asarray(jd), po.numpy(), pd.numpy()
    scale = np.float32(max(np.abs(np.asarray(getattr(jc, f))).max() for f in
                           ("origin", "lower_left", "horizontal", "vertical")))
    atol = RAY_ULPS * np.spacing(scale)
    np.testing.assert_allclose(po, jo, rtol=0, atol=atol)
    np.testing.assert_allclose(pd, jd, rtol=0, atol=atol)
