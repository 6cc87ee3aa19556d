"""The port's denoisers against the JAX package's, on the CPU.

Inputs are made with numpy from a seed at 36x44 (not a multiple of 8, so
the U-Net pads and crops; with 5 iterations the last tap step, 16, wraps
around more than once), with a band of background pixels whose normal
and albedo are zero. The same arrays go through:

- ``atrous_denoise``, ``svgf_denoise`` and ``learned_denoise`` at 4 and 5
  iterations (the port's plain ``atrous_step_reference`` per iteration),
  held to ``|port - jax| <= 1e-5 (1 + |jax|)``; measured maxima of
  ``|port - jax| / (1 + |jax|)``: fixed 1.5e-7, SVGF 2.3e-7 and 2.9e-7,
  learned 2.6e-7 and 2.3e-7 (XLA's ``exp`` and ``log1p`` are its own
  approximations, an ulp off torch's on some inputs; on other random
  inputs the learned filter reached 6.2e-6, the softplus's ``log1p``
  carried through the propagated variance into the next iteration's
  features);
- the U-Net's ``denoise`` with the vendored weights over the learned
  prepass, held to ``1e-4 (1 + |jax|)`` (measured 2.4e-7: the library
  convolutions sum in their own orders);
- ``denoise_state`` in each case that reaches a different tier (both
  weight files, ``MPT_UNET_DENOISE=0``, both switched off, a state
  without a second moment): the same filters called in the same order in
  both packages, and the same image within the tier's tolerance (measured at most 3.2e-7).

The JAX filters run eagerly (~1-7 s each here); each is computed once in
a module fixture and reused.
"""

import hashlib
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_pathtracer_tpu.ops import denoise as JD
from metal_pathtracer_tpu.ops import denoise_unet as JU
from metal_pathtracer_tpu.renderer.accumulation import RenderState as JState
from metal_pathtracer_tpu_torch import convert
from metal_pathtracer_tpu_torch.ops import denoise as D
from metal_pathtracer_tpu_torch.ops import denoise_unet as U
from metal_pathtracer_tpu_torch.ops.kernels import denoise as K
from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
from metal_pathtracer_tpu_torch.settings import RenderSettings

H, W = 36, 44
BAND = 5            # rows of background pixels: zero normal and albedo
TAP_TOL = 1e-5
UNET_TOL = 1e-4
JAX_DATA = "metal_pathtracer_tpu/data/"


def _rel(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(port - ref) / (1.0 + np.abs(ref))).max())


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(14)
    n = rng.integers(1, 9, (H, W)).astype(np.uint32)
    mean = rng.gamma(1.2, 0.6, (H, W, 3)).astype(np.float32)
    spread = rng.uniform(0.0, 0.8, (H, W, 3)).astype(np.float32)
    radiance_sum = (mean * n[..., None]).astype(np.float32)
    sq_sum = ((mean * mean + spread * spread) * n[..., None]).astype(
        np.float32)
    albedo = rng.uniform(0.05, 0.95, (H, W, 3)).astype(np.float32)
    normal = rng.normal(size=(H, W, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    normal[:BAND] = 0.0
    albedo[:BAND] = 0.0
    js = JState.create(W, H).replace(
        radiance_sum=jnp.asarray(radiance_sum), sample_count=jnp.asarray(n),
        albedo=jnp.asarray(albedo), normal=jnp.asarray(normal),
        radiance_sq_sum=jnp.asarray(sq_sum), frame_index=jnp.uint32(8))
    color = np.array(js.present())
    var = np.array(js.variance_of_mean())
    return dict(js=js, color=color, albedo=albedo, normal=normal, var=var,
                radiance_sum=radiance_sum, sq_sum=sq_sum, n=n)


def _port_state(d, sq=True):
    t = torch.from_numpy
    return RenderState(
        radiance_sum=t(d["radiance_sum"]),
        sample_count=t(d["n"].astype(np.int64)),
        albedo=t(d["albedo"]), normal=t(d["normal"]),
        radiance_sq_sum=t(d["sq_sum"]) if sq else None, frame_index=8)


def _tap_params():
    with np.load(JAX_DATA + "denoiser_weights.npz") as z:
        return {k: z[k] for k in z.files}


FILTERS = [(name, it) for name in ("fixed", "svgf", "learned")
           for it in (4, 5)]


@pytest.fixture(scope="module")
def jax_out(data):
    jp = {k: jnp.asarray(v) for k, v in _tap_params().items()}
    c, a, n, v = data["color"], data["albedo"], data["normal"], data["var"]
    out = {}
    for name, it in FILTERS:
        if name == "fixed":
            r = JD.atrous_denoise(c, a, n, iterations=it)
        elif name == "svgf":
            r = JD.svgf_denoise(c, a, n, v, iterations=it)
        else:
            r = JD.learned_denoise(c, a, n, v, jp, iterations=it)
        out[name, it] = np.asarray(r)
    return out


def _port_filter(data, name, it):
    t = lambda k: torch.from_numpy(data[k])
    if name == "fixed":
        return D.atrous_denoise(t("color"), t("albedo"), t("normal"),
                                iterations=it)
    if name == "svgf":
        return D.svgf_denoise(t("color"), t("albedo"), t("normal"), t("var"),
                              iterations=it)
    return D.learned_denoise(t("color"), t("albedo"), t("normal"),
                             t("var"),
                             convert.denoiser_params(_tap_params(), "cpu"),
                             iterations=it)


@pytest.mark.parametrize("name,it", FILTERS)
def test_tap_filter_matches_jax(data, jax_out, name, it):
    before = K.atrous_step.launches
    got = _port_filter(data, name, it)
    assert K.atrous_step.launches == before   # CPU tensors: the plain path
    assert got.shape == (H, W, 3) and got.dtype == torch.float32
    ref = jax_out[name, it]
    assert np.isfinite(got.numpy()).all()
    err = _rel(got.numpy(), ref)
    assert err <= TAP_TOL, f"{name} x{it}: {err}"
    # the filter smooths: it is not the identity
    assert np.abs(ref - data["color"]).max() > 1e-2


def test_unet_matches_jax(data, jax_out):
    with np.load(JAX_DATA + "denoiser_unet.npz") as z:
        raw = {k: z[k] for k in z.files}
    base = jax_out["learned", 4]
    ref = np.asarray(JU.denoise(
        data["color"], data["albedo"], data["normal"], data["var"],
        {k: jnp.asarray(v) for k, v in raw.items()}, base))
    net = U.DenoiseUNet.from_params(convert.denoiser_params(raw, "cpu"))
    t = torch.from_numpy
    got = U.denoise(t(data["color"]), t(data["albedo"]), t(data["normal"]),
                    t(data["var"]), net, t(base))
    assert got.shape == (H, W, 3)
    assert _rel(got.numpy(), ref) <= UNET_TOL
    assert np.abs(ref - base).max() > 1e-3   # the net changes the prepass


def _spy(module, names, calls):
    """Patches that record each call of ``module``'s ``names`` in ``calls``
    and pass it on."""
    return [mock.patch.object(
        module, n, side_effect=lambda *a, _n=n, _fn=getattr(module, n), **k: (
            calls.append(_n), _fn(*a, **k))[1]) for n in names]


TIERS = {
    "both": ({}, True, ["learned_denoise", "denoise"]),
    "no_unet": ({"MPT_UNET_DENOISE": "0"}, True, ["learned_denoise"]),
    "none": ({"MPT_UNET_DENOISE": "0", "MPT_LEARNED_DENOISE": "0"}, True,
             ["svgf_denoise"]),
    "pre_sq_sum": ({}, False, ["atrous_denoise"]),
}


@pytest.mark.parametrize("case", sorted(TIERS))
@pytest.mark.parametrize("filter_type", [0, 1])
def test_denoise_state_tiers_match_jax(data, case, filter_type,
                                       monkeypatch):
    env, sq, expect = TIERS[case]
    for k in ("MPT_UNET_DENOISE", "MPT_LEARNED_DENOISE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    # both packages cache the vendored weights: start each case afresh
    monkeypatch.setattr(JD, "_UNET_PARAMS", None)
    monkeypatch.setattr(JD, "_LEARNED_PARAMS", None)
    monkeypatch.setattr(D, "_UNET_PARAMS", {})
    monkeypatch.setattr(D, "_LEARNED_PARAMS", {})
    settings = RenderSettings()
    settings.denoiseFilterType = filter_type
    js = data["js"] if sq else data["js"].replace(radiance_sq_sum=None)
    filters = ["atrous_denoise", "svgf_denoise", "learned_denoise"]
    jcalls, pcalls = [], []
    patches = _spy(JD, filters, jcalls) + _spy(D, filters, pcalls) \
        + _spy(JU, ["denoise"], jcalls) + _spy(U, ["denoise"], pcalls)
    for p in patches:
        p.start()
    try:
        ref = np.asarray(JD.denoise_state(js, settings))
        got = D.denoise_state(_port_state(data, sq), settings)
    finally:
        for p in patches:
            p.stop()
    assert jcalls == expect, jcalls
    assert pcalls == jcalls
    tol = UNET_TOL if "denoise" in expect else TAP_TOL
    assert _rel(got.numpy(), ref) <= tol


def test_pre_sq_sum_state_variance_is_zero(data):
    st = _port_state(data, sq=False)
    assert st.radiance_sq_sum is None
    assert (st.variance_of_mean() == 0).all()
    np.testing.assert_array_equal(
        _port_state(data).variance_of_mean().numpy(),
        np.asarray(data["js"].variance_of_mean()))


def test_init_params_shapes_and_range():
    """``test_unet_shapes_and_range`` on the port: the pad/crop path at a
    shape that is not a multiple of 8, finite and non-negative output with
    untrained weights, the JAX package's shapes and He scale."""
    raw = U.init_params(torch.Generator().manual_seed(3))
    assert sorted(raw) == sorted(k for name, _, _ in U.LAYERS
                                 for k in (name + "_w", name + "_b"))
    for name, cin, cout in U.LAYERS:
        w = raw[name + "_w"]
        assert tuple(w.shape) == (3, 3, cin, cout)
        assert (raw[name + "_b"] == 0).all()
        scale = np.sqrt(2.0 / (9 * cin)) * (0.05 if name == "out" else 1.0)
        assert 0.7 * scale < float(w.std()) < 1.3 * scale, name
    net = U.DenoiseUNet.from_params(convert.denoiser_params(raw, "cpu"))
    rng = np.random.default_rng(5)
    color = torch.from_numpy(rng.random((37, 53, 3)).astype(np.float32) * 4)
    alb = torch.from_numpy(rng.random((37, 53, 3)).astype(np.float32))
    nrm = torch.from_numpy(rng.standard_normal((37, 53, 3)).astype(
        np.float32))
    var = torch.from_numpy(rng.random((37, 53, 3)).astype(np.float32) * 0.01)
    out = U.denoise(color, alb, nrm, var, net, color * 0.9)
    assert out.shape == color.shape
    assert torch.isfinite(out).all() and (out >= 0).all()


def test_denoiser_params_round_trip():
    """The U-Net's HWIO weights become OIHW and back bit for bit; the tap
    MLP and the biases stay as they are; the net holds them."""
    with np.load(JAX_DATA + "denoiser_unet.npz") as z:
        raw = {k: z[k] for k in z.files}
    with np.load(JAX_DATA + "denoiser_weights.npz") as z:
        raw.update({k: z[k] for k in z.files})
    got = convert.denoiser_params(raw, "cpu")
    assert sorted(got) == sorted(raw)
    for k, v in raw.items():
        t = got[k]
        assert t.dtype == torch.float32 and t.is_contiguous()
        back = t.permute(2, 3, 1, 0) if k.endswith("_w") and v.ndim == 4 \
            else t
        np.testing.assert_array_equal(back.numpy(), v, err_msg=k)
    assert tuple(got["enc1_w"].shape) == (16, 13, 3, 3)
    assert tuple(got["w1"].shape) == (6, 16)
    net = U.DenoiseUNet.from_params(got)
    for name, _, _ in U.LAYERS:
        assert torch.equal(net.convs[name].weight, got[name + "_w"])
        assert torch.equal(net.convs[name].bias, got[name + "_b"])
    mlp = K.pack_mlp(got)
    assert mlp.shape == (K.MLP_FLOATS,)
    np.testing.assert_array_equal(mlp[:96].reshape(6, 16).numpy(), raw["w1"])


@pytest.mark.parametrize("name", ["denoiser_unet.npz",
                                  "denoiser_weights.npz"])
def test_vendored_weights_are_the_jax_packages(name):
    digest = lambda p: hashlib.sha256(open(p, "rb").read()).hexdigest()
    assert digest(D.DATA_DIR + "/" + name) == digest(JAX_DATA + name)


def test_step_params_round_once_to_float32():
    """The host constants are the Python doubles rounded once to float32
    (``2.0 * sc ** 2`` in float64, then float32), not float32 products."""
    sc = 0.35 / 3.0 ** 3
    p = K.StepParams.fixed(8, 2.0 * sc ** 2, 2.0 * 0.25 ** 2, 2.0 * 0.2 ** 2)
    assert p.c_color == float(np.float32(2.0 * sc ** 2))
    assert p.c_albedo == float(np.float32(0.08000000000000002))
    assert p.scalars()[:3] == [p.c_color, p.c_normal, p.c_albedo]
    q = K.StepParams.learned(4, 2 / 3)
    assert q.it_feature == float(np.float32(2 / 3)) and q.mode == K.LEARNED
