"""The port's environment module vs the JAX package's ``ops/env.py``.

Host build (mips, alias tables, pdf, packed rows): bit for bit. Lookups
on 4,096 numpy directions and uniforms: every table index (the pdf texel,
the alias-sampled texel) exact; directions, equirect coordinates and
filtered backgrounds within the ulps that XLA:CPU's own approximations of
sin/cos/atan2/asin explain (ROADMAP Queue 3):

- sampled unit directions: within ``UV_ULPS`` = 4 ulps of 1.0 (2^-21),
  measured up to 3;
- (u, v): within 4 ulps of 1.0 divided by the direction's distance from
  the poles, rho = sqrt(1 - y^2) (floored at 1/16): asin and atan2 are
  ill-conditioned there; measured up to 4.5 ulps, 0.6 ulps times rho;
- a bilinear/trilinear background: a (u, v) error dx moves the filter
  weights by dx * width, so the bound is the (u, v) bound times
  (width + height) times the largest texel the lane's filter can read
  (the 3x3 bilinear footprints around its own, on both mip levels: an
  error of a few ulps may move the footprint by one texel), plus 4 ulps
  of the value; measured up to 0.11 of it, while a 0.1 % error in one
  filter weight exceeds it 9-36 times.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_pathtracer_tpu.ops import env as jenv
from metal_pathtracer_tpu.ops.camera import build_camera as jax_camera
from metal_pathtracer_tpu.schema import settings_to_static as jax_static
from metal_pathtracer_tpu.schema import settings_to_uniforms as jax_uniforms
from metal_pathtracer_tpu.settings import RenderSettings
from metal_pathtracer_tpu.utils.benchscene import hdr_sky as jax_hdr_sky
from metal_pathtracer_tpu_torch import convert
from metal_pathtracer_tpu_torch.ops import env as penv
from metal_pathtracer_tpu_torch.schema import (
    settings_to_static,
    settings_to_uniforms,
)
from metal_pathtracer_tpu_torch.utils.benchscene import hdr_sky

N = 4096
UV_ULPS = 4
ULP1 = 2.0 ** -23


def _toy_sky():
    rng = np.random.default_rng(3)
    sky = rng.uniform(0.05, 2.0, (16, 32, 3)).astype(np.float32)
    sky[2, 5] = 400.0     # a hot texel the alias tables must favour
    sky[9, :4] = 0.0      # zero-radiance texels the sampler must skip
    return sky


SKIES = {"toy_32x16": _toy_sky, "hdr_sky_64x32": lambda: hdr_sky(64, 32)}


@pytest.fixture(scope="module", params=sorted(SKIES))
def envs(request):
    texels = SKIES[request.param]()
    settings = RenderSettings()
    settings.environmentRotation = 0.3
    settings.environmentIntensity = 1.7
    ju = jax_uniforms(settings, jax_camera(settings, 8, 8), 0, 0)
    pu = settings_to_uniforms(settings, None, 0, 0)
    return dict(texels=texels, je=jenv.environment_from_texels(texels),
                pe=penv.environment_from_texels(texels, "cpu"), ju=ju, pu=pu,
                js=jax_static(settings, 8, 8, [0]),
                ps=settings_to_static(settings, 8, 8, [0]))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d *= rng.uniform(0.5, 2.0, (N, 1)).astype(np.float32)
    return dict(d=d, u=rng.random((N, 3)).astype(np.float32),
                lod=rng.uniform(0.0, 5.0, N).astype(np.float32),
                act=rng.random(N) < 0.5)


def test_hdr_sky_bitexact():
    np.testing.assert_array_equal(hdr_sky(64, 32), jax_hdr_sky(64, 32))


def test_environment_build_bitexact(envs):
    je, pe = envs["je"], envs["pe"]
    for f in dataclasses.fields(pe):
        got, ref = getattr(pe, f.name), getattr(je, f.name)
        if f.name == "mips":
            assert len(got) == len(ref)
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        elif isinstance(got, torch.Tensor):
            ref = np.asarray(ref)
            assert got.numpy().dtype == ref.dtype, f.name
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=f.name)
        else:
            assert tuple(got) == tuple(ref) if f.name == "mip_meta" \
                else got == ref, f.name


def test_convert_environment(envs):
    je = envs["je"]
    d = {f.name: (tuple(np.asarray(m) for m in je.mips) if f.name == "mips"
                  else getattr(je, f.name))
         for f in dataclasses.fields(je)}
    pe = convert.environment(d, "cpu")
    np.testing.assert_array_equal(pe.flat_quads.numpy(),
                                  envs["pe"].flat_quads.numpy())
    assert pe.mip_meta == envs["pe"].mip_meta


def _close_ulps(got, ref, scale, ulps=UV_ULPS):
    got, ref = np.asarray(got), np.asarray(ref)
    tol = ulps * ULP1 * scale + ulps * ULP1 * np.abs(ref)
    assert np.all(np.abs(got - ref) <= tol), float(np.abs(got - ref).max())


def _uv_scale(d):
    """1 / rho: the conditioning of the equirect map at each direction."""
    unit = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rho = np.sqrt(np.maximum(1.0 - unit[:, 1] ** 2, 0.0))
    return 1.0 / np.maximum(rho, 1.0 / 16.0)


def _footprint_max(env, d, lod, rotation):
    """Per lane, the largest texel in the 3x3 bilinear footprints around
    the one the trilinear filter reads, on its lower and upper mip level."""
    u, v = (x.numpy() for x in penv.direction_to_uv(torch.tensor(d),
                                                    rotation))
    lod = np.clip(lod, 0.0, len(env.mips))
    lo = np.floor(lod).astype(np.int64)
    meta = np.asarray(env.mip_meta)
    quads = env.flat_quads.numpy()
    best = np.zeros(len(d), np.float32)
    for level in (lo, np.minimum(lo + 1, len(env.mips))):
        off, h, w = meta[level].T
        x0 = np.floor(u * w - 0.5).astype(np.int64)
        y0 = np.floor(v * h - 0.5).astype(np.int64)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                row = off + (y0 + dy) % h * w + (x0 + dx) % w
                best = np.maximum(best, quads[row].max(-1))
    return best


def test_direction_to_uv(envs, inputs):
    d = inputs["d"]
    ju, jv = jenv._direction_to_uv(jnp.asarray(d),
                                   envs["ju"].environment_rotation)
    pu, pv = penv.direction_to_uv(torch.tensor(d),
                                  envs["pu"].environment_rotation)
    _close_ulps(pu.numpy(), ju, _uv_scale(d))
    _close_ulps(pv.numpy(), jv, _uv_scale(d))


def test_environment_pdf_exact(envs, inputs):
    d = inputs["d"]
    ref = jenv.environment_pdf(envs["je"], jnp.asarray(d),
                               envs["ju"].environment_rotation)
    got = penv.environment_pdf(envs["pe"], torch.tensor(d),
                               envs["pu"].environment_rotation)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_environment_background(envs, inputs):
    d, lod, act = inputs["d"], inputs["lod"], inputs["act"]
    ref = jenv.environment_background(
        envs["je"], jnp.asarray(d), envs["ju"], envs["js"], jnp.asarray(lod),
        jnp.asarray(act))
    got = penv.environment_background(
        envs["pe"], torch.tensor(d), envs["pu"], envs["ps"],
        torch.tensor(lod), torch.tensor(act))
    t = envs["texels"]
    texel = _footprint_max(envs["pe"], d, np.where(act, lod, 0.0),
                           envs["pu"].environment_rotation)
    scale = (t.shape[0] + t.shape[1]) * texel * 1.7 * _uv_scale(d)
    _close_ulps(got.numpy(), ref, scale[:, None])


def test_sample_environment_from_uniforms(envs, inputs):
    u = inputs["u"]
    ref = jenv.sample_environment_from_uniforms(
        envs["je"], *[jnp.asarray(u[:, i]) for i in range(3)], envs["ju"],
        envs["js"], None)
    got = penv.sample_environment_from_uniforms(
        envs["pe"], *[torch.tensor(u[:, i]) for i in range(3)], envs["pu"],
        envs["ps"])
    r_dir, r_rad, r_pdf, r_valid = (np.asarray(x) for x in ref)
    g_dir, g_rad, g_pdf, g_valid = (x.numpy() for x in got)
    # the sampled texel is exact: its pdf and radiance are gathered rows
    np.testing.assert_array_equal(g_pdf, r_pdf)
    np.testing.assert_array_equal(g_rad, r_rad)
    np.testing.assert_array_equal(g_valid, r_valid)
    _close_ulps(g_dir, r_dir, 1.0)
    assert r_valid.any()
