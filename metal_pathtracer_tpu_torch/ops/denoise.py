"""Edge-aware à-trous denoising (``ops/denoise.py`` twin).

The three tap filters of the JAX package, each a pyramid of iterations
over 5x5 B3-spline taps at step ``1 << it`` that wrap around the image
(``jnp.roll``): ``atrous_denoise`` (fixed sigmas, decaying colour sigma),
``svgf_denoise`` (luminance weight scaled by the smoothed standard
deviation of the variance, normal weight ``max(n.n', 0)^64``, variance
propagated with squared weights) and ``learned_denoise`` (SVGF's pyramid
with each tap's weight from a 6-16-1 MLP, ``w_k exp(-softplus(z))``).
``denoise_state`` picks the best filter the state and the vendored
weights allow, with the JAX package's tiers: the conv U-Net
(``ops/denoise_unet.py``) over the learned prepass, the learned filter,
SVGF, and the fixed filter for a state without a second moment.

Each filter goes through ``ops/kernels/denoise.atrous_filter``: on CUDA
tensors one ``pack`` launch (the state in 16-byte rows) and one launch
of ``csrc/denoise.cu`` an iteration, on CPU tensors the plain versions
below (``pack_reference``, then ``atrous_step_reference`` an iteration
on the rows unpacked). Both compute the JAX
package's eager arithmetic in its order: no fused multiply-adds (the
eager ops round one by one) but in the MLP's second layer, where XLA's
dot places them, sums left to right but in the MLP (``_mlp_logit``),
taps in (ky, kx) row-major order, the Python constants rounded once to float32 and
divisions as one IEEE division each (``vecmath.fdiv``).

Gradients (the trainers, ``tools/train_denoiser*.py``): the learned
filter differentiates as JAX differentiates it. Its plain version runs
under autograd with two conventions of JAX's at ties: ``_AbsJax`` (the
derivative of |x| is +1 at 0; feature 0 is 0 wherever two tapped pixels
share a luminance) and ``_SoftplusJax`` (sigmoid(z), 0.5 at 0); the
MLP's fused second layer goes through ``_Fma`` (``vecmath.fma``'s bit
arithmetic has no derivative). ``clamp_min`` keeps torch's convention
(it passes at equality, where JAX's ``maximum`` splits 0.5 / 0.5): the
hidden units, ``max(gvar, 1e-12)`` and ``max(weight sum, 1e-6)``. On
CUDA tensors ``kernels/denoise.atrous_filter`` records a
``LearnedIteration`` an iteration instead, whose backward is three
kernels; ``grad_taps_reference``, ``grad_gather_reference`` and
``grad_sum_reference`` below are their plain versions.

The vendored weights are the JAX package's files, copied into
``metal_pathtracer_tpu_torch/data`` (the tests hold the copies equal);
``MPT_UNET_DENOISE=0`` and ``MPT_LEARNED_DENOISE=0`` switch each tier off,
as in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from metal_pathtracer_tpu_torch.ops.kernels import denoise as K
from metal_pathtracer_tpu_torch.ops.kernels.denoise import (
    FIXED,
    LEARNED,
    SVGF,
    StepParams,
)
from metal_pathtracer_tpu_torch.ops.vecmath import fdiv, fma

# 5-tap B3-spline kernel for the à-trous pyramid
_KERNEL = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
_TAPS = (-2, -1, 0, 1, 2)

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


def _dot(a, b):
    """``jnp.sum(a * b, -1)`` over 3 components, as the eager JAX rounds
    it: three products, summed left to right."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def _luminance(rgb):
    return (0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1]) \
        + 0.0722 * rgb[..., 2]


def _gauss3(img):
    """Separable 3x3 (1,2,1)/4 blur of (H,W) or (H,W,C), wrapping."""
    w = (0.25, 0.5, 0.25)
    out = 0.0
    for k, wk in zip((-1, 0, 1), w):
        out = out + wk * torch.roll(img, k, 0)
    res = 0.0
    for k, wk in zip((-1, 0, 1), w):
        res = res + wk * torch.roll(out, k, 1)
    return res


class _AbsJax(torch.autograd.Function):
    """``torch.abs`` whose derivative is JAX's: +1 for x >= 0 (torch's is 0
    at 0). Feature 0 of the learned filter is ``|lum(s_col) - lum_p|``,
    exactly 0 wherever two tapped pixels have the same luminance (every
    flat background region), where the two conventions part."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, grad, -grad)


class _SoftplusJax(torch.autograd.Function):
    """``_softplus_value``'s bits with ``sigmoid(z)`` as the derivative,
    ``jax.nn.softplus``'s (0.5 at z = 0, where the composed torch ops
    give 1)."""

    @staticmethod
    def forward(ctx, z):
        ctx.save_for_backward(z)
        return _softplus_value(z)

    @staticmethod
    def backward(ctx, grad):
        (z,) = ctx.saved_tensors
        return grad * torch.sigmoid(z)


class _Fma(torch.autograd.Function):
    """``vecmath.fma`` (one rounding; its bit arithmetic has no derivative)
    with the derivatives of a * b + c, each summed to its operand's
    shape."""

    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        ctx.shapes = (a.shape, b.shape, c.shape)
        return fma(a, b, c)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        sa, sb, sc = ctx.shapes
        return ((grad * b).sum_to_size(sa), (grad * a).sum_to_size(sb),
                grad.sum_to_size(sc))


def _abs(x):
    return _AbsJax.apply(x)


def _tap_features(lum_p, gstd, normal, albedo, s_col, s_nrm, s_alb,
                  it_feature, radius):
    """Per-tap (H,W,6) feature planes for the learned weight net."""
    both_bg = (_dot(normal, normal) < 0.5) & (_dot(s_nrm, s_nrm) < 0.5)
    ndiff = torch.where(both_bg, 0.0,
                        torch.clamp_min(1.0 - _dot(s_nrm, normal), 0.0))
    da = s_alb - albedo
    return torch.stack([
        fdiv(_abs(_luminance(s_col) - lum_p), gstd + 1e-4),
        ndiff,
        _dot(da, da),
        gstd,
        torch.full_like(lum_p, it_feature),
        torch.full_like(lum_p, radius),
    ], -1)


def _mlp_logit(mlp, f):
    """The tap MLP on (H,W,6) features, from the packed weights
    (``kernels/denoise.pack_mlp``), summed as XLA:CPU's eager dots sum
    them (bit-equal on 5,000 random feature rows): the six products of
    the first layer in pairs, ((p0 + p1) + (p2 + p3)) + (p4 + p5), then
    the bias; the second layer in eight lanes, lane l = fma(h[l + 8],
    w2[l + 8], h[l] w2[l]), the lanes in a tree, then the bias."""
    w1 = mlp[:96].reshape(6, 16)
    p = [f[..., k:k + 1] * w1[k] for k in range(6)]
    return _mlp_out(mlp, torch.clamp_min(
        ((p[0] + p[1]) + (p[2] + p[3])) + (p[4] + p[5]) + mlp[96:112], 0.0))


def _mlp_out(mlp, h):
    """The MLP's second layer on the hidden units h (..., 16): eight lanes
    fma(h[l + 8], w2[l + 8], h[l] w2[l]) summed in a tree, then b2."""
    w2, b2 = mlp[112:128], mlp[128]
    lanes = [_Fma.apply(h[..., l + 8], w2[l + 8], h[..., l] * w2[l])
             for l in range(8)]
    z = ((lanes[0] + lanes[1]) + (lanes[2] + lanes[3])) \
        + ((lanes[4] + lanes[5]) + (lanes[6] + lanes[7]))
    return z + b2


def _mlp_table(mlp, it_feature):
    """The learned filter's per-launch constant terms, (5, 16): row r is
    (p4 + p5) = it_feature w1[4] + (r / 4) w1[5] for the tap radius
    (abs(ky) + abs(kx)) / 4, each product rounded to float32, then the sum,
    as ``_mlp_logit`` forms them (``kernels/denoise.mlp_constants`` is the
    host twin the kernel reads)."""
    w1 = mlp[:96].reshape(6, 16)
    it = torch.tensor(it_feature, dtype=torch.float32, device=mlp.device)
    radius = torch.arange(5, dtype=torch.float32, device=mlp.device) * 0.25
    return (it * w1[4])[None, :] + radius[:, None] * w1[5][None, :]


def _mlp_logit_hoisted(mlp, f, p3, table_row):
    """``_mlp_logit`` with the constant terms hoisted, as
    ``csrc/denoise.cu`` sums it: the per-tap features f[..., :3], p3 =
    gstd w1[3] once a pixel (..., 16), and the (p4 + p5) row of the tap's
    radius from ``_mlp_table`` (..., 16); the same roundings in the same
    order, so the same bits."""
    return _mlp_out(mlp, torch.clamp_min(_mlp_pre(mlp, f, p3, table_row),
                                         0.0))


def _mlp_pre(mlp, f, p3, table_row):
    """The hidden units' pre-activations (..., 16) of the hoisted sum."""
    w1 = mlp[:96].reshape(6, 16)
    p = [f[..., k:k + 1] * w1[k] for k in range(3)]
    return ((p[0] + p[1]) + (p[2] + p3)) + table_row + mlp[96:112]


def _softplus_value(z):
    """``jax.nn.softplus``: ``logaddexp(z, 0)`` = max(z, 0) +
    log1p(exp(-|z|)), with no threshold."""
    return torch.clamp_min(z, 0.0) + torch.log1p(torch.exp(-torch.abs(z)))


def _softplus(z):
    """``_softplus_value`` differentiated as JAX differentiates it."""
    return _SoftplusJax.apply(z)


def atrous_step_reference(color, var, albedo, normal, p: StepParams,
                          mlp=None, wsum: bool = False):
    """Plain PyTorch version of one iteration (``kernels/denoise.
    atrous_step``'s arguments and results): the loop bodies of
    ``denoise.py:53-64``, ``:96-129`` and ``:175-201``. With ``wsum``,
    each pixel's weight sum (H, W) follows the colour and variance."""
    step = p.step
    dev = color.device
    c_color, c_normal, c_albedo = (
        torch.tensor(x, dtype=torch.float32, device=dev)
        for x in (p.c_color, p.c_normal, p.c_albedo))
    if p.mode == SVGF:
        gvar = torch.clamp_min(_gauss3(var), 0.0)
        denom = p.sigma_lum * torch.sqrt(gvar) + 1e-4
    elif p.mode == LEARNED:
        gstd = torch.sqrt(torch.clamp_min(_gauss3(var), 1e-12))
    if p.mode != FIXED:
        lum_p = _luminance(color)
        var_accum = torch.zeros_like(var)
    nn = _dot(normal, normal)
    accum = torch.zeros_like(color)
    weight_sum = torch.zeros_like(color[..., 0])
    for ky, wy in zip(_TAPS, _KERNEL):
        for kx, wx in zip(_TAPS, _KERNEL):
            w_k = wy * wx
            shift = (ky * step, kx * step)
            s_col = torch.roll(color, shift, (0, 1))
            s_alb = torch.roll(albedo, shift, (0, 1))
            s_nrm = torch.roll(normal, shift, (0, 1))
            da = s_alb - albedo
            if p.mode == FIXED:
                dc = s_col - color
                dn = torch.clamp_min(1.0 - _dot(s_nrm, normal), 0.0)
                wc = torch.exp(fdiv(-_dot(dc, dc), c_color))
                wn = torch.exp(fdiv(-dn, c_normal))
                wa = torch.exp(fdiv(-_dot(da, da), c_albedo))
                w = w_k * (wc * wn * wa)
            elif p.mode == SVGF:
                w_l = torch.exp(fdiv(-torch.abs(_luminance(s_col) - lum_p),
                                     denom))
                both_bg = (nn < 0.5) & (_dot(s_nrm, s_nrm) < 0.5)
                w_n = torch.where(both_bg, 1.0, torch.pow(torch.clamp_min(
                    _dot(s_nrm, normal), 0.0), p.normal_pow))
                w_a = torch.exp(fdiv(-_dot(da, da), c_albedo))
                w = w_k * w_l * w_n * w_a
            else:
                f = _tap_features(lum_p, gstd, normal, albedo, s_col, s_nrm,
                                  s_alb, p.it_feature,
                                  (abs(ky) + abs(kx)) / 4.0)
                w = w_k * torch.exp(-_softplus(_mlp_logit(mlp, f)))
            accum = accum + s_col * w[..., None]
            if p.mode != FIXED:
                s_var = torch.roll(var, shift, (0, 1))
                var_accum = var_accum + s_var * (w * w)
            weight_sum = weight_sum + w
    m = torch.clamp_min(weight_sum, 1e-6)
    out = fdiv(accum, m[..., None])
    out_var = None if p.mode == FIXED else fdiv(var_accum, m * m)
    return (out, out_var, weight_sum) if wsum else (out, out_var)


def pack_reference(color, var, albedo, normal):
    """Plain version of ``kernels/denoise.pack``: (cv (H, W, 4): colour
    and the luminance variance, 0 without one; guide (H, W, 8): albedo,
    0, normal, n.n summed as ``_dot``)."""
    zero = torch.zeros_like(color[..., :1])
    v = zero if var is None else var[..., None]
    return (torch.cat([color, v], -1).contiguous(),
            torch.cat([albedo, zero, normal, _dot(normal, normal)[..., None]],
                      -1).contiguous())


def unpack(cv, guide):
    """(colour, luminance variance, albedo, normal) of a filter's rows,
    each contiguous."""
    return (cv[..., :3].contiguous(), cv[..., 3].contiguous(),
            guide[..., :3].contiguous(), guide[..., 4:7].contiguous())


def atrous_step_packed_reference(cv, guide, p: StepParams, mlp=None,
                                 last: bool = False, wsum: bool = False):
    """Plain version of ``kernels/denoise.atrous_step_packed``:
    ``atrous_step_reference`` on the rows unpacked, the result packed
    again unless ``last``; with ``wsum`` the weight sums too."""
    color, var, albedo, normal = unpack(cv, guide)
    got = atrous_step_reference(
        color, None if p.mode == FIXED else var, albedo, normal, p, mlp,
        wsum)
    if last:
        return got
    return pack_reference(got[0], got[1], albedo, normal)[0]


def atrous_filter_reference(color, var, albedo, normal, steps, mlp=None):
    """Plain version of ``kernels/denoise.atrous_filter``:
    ``atrous_step_reference`` an iteration on the unpacked tensors."""
    for p in steps:
        color, var = atrous_step_reference(color, var, albedo, normal, p,
                                           mlp)
    return color, var


def _learned_taps(color, var, albedo, normal, p: StepParams, mlp):
    """The learned iteration's per-tap terms, tap by tap in (ky, kx)
    row-major order, as ``atrous_step_reference`` forms them (the same
    bits): per tap (shift, B3 weight, radius, s_col, s_var, the luminance
    difference, features 0-2, the hidden pre-activations, the hidden
    units, the logit, exp(-softplus), the weight); and the pixel's
    (luminance, blurred variance, gstd)."""
    g = _gauss3(var)
    gstd = torch.sqrt(torch.clamp_min(g, 1e-12))
    gdiv = gstd + 1e-4
    lum_p = _luminance(color)
    nn = _dot(normal, normal)
    w1 = mlp[:96].reshape(6, 16)
    p3 = gstd[..., None] * w1[3]
    table = _mlp_table(mlp, p.it_feature)
    taps = []
    for ky, wy in zip(_TAPS, _KERNEL):
        for kx, wx in zip(_TAPS, _KERNEL):
            shift = (ky * p.step, kx * p.step)
            s_col = torch.roll(color, shift, (0, 1))
            s_nrm = torch.roll(normal, shift, (0, 1))
            da = torch.roll(albedo, shift, (0, 1)) - albedo
            dl = _luminance(s_col) - lum_p
            f0 = fdiv(torch.abs(dl), gdiv)
            both_bg = (nn < 0.5) & (_dot(s_nrm, s_nrm) < 0.5)
            f1 = torch.where(both_bg, 0.0, torch.clamp_min(
                1.0 - _dot(s_nrm, normal), 0.0))
            f2 = _dot(da, da)
            radius = abs(ky) + abs(kx)
            pre = _mlp_pre(mlp, torch.stack([f0, f1, f2], -1), p3,
                           table[radius])
            hid = torch.clamp_min(pre, 0.0)
            z = _mlp_out(mlp, hid)
            e = torch.exp(-_softplus_value(z))
            taps.append(dict(shift=shift, w_k=wy * wx, radius=radius / 4.0,
                             s_col=s_col, s_var=torch.roll(var, shift, (0, 1)),
                             dl=dl, f=(f0, f1, f2), pre=pre, hid=hid, z=z,
                             e=e, w=(wy * wx) * e))
    return taps, lum_p, g, gstd


def grad_taps_reference(cv, guide, p: StepParams, mlp, g_out, u_out,
                        saved=None):
    """Plain version of ``kernels/denoise.grad_taps``, the first backward
    kernel of a learned iteration: from the iteration's rows (``pack``),
    the packed MLP, its forward's (colour, variance, weight sums) in
    ``saved`` (None: the taps' sums retaken here, the same bits) and the
    cotangents of its outputs (g_out (H, W, 3), u_out (H, W) or None),
    each pixel's 25 tap weights and the adjoints of their luminances
    (w_plane, l_plane: (25, H, W)), its own terms (pix (H, W, 4): dL/dA =
    g / m and dL/dV = u / m^2; pix2 (H, W, 2): the adjoint of its own
    luminance and of its blurred variance) and its share of the 129
    parameter gradients (rows (H W, 129), ``pack_mlp``'s order; the kernel
    writes one row a block). Derivatives as JAX takes them but at the ties
    the plain version keeps (``_AbsJax``, ``_SoftplusJax``; ``clamp_min``
    passes at equality)."""
    color, var, albedo, normal = unpack(cv, guide)
    taps, lum_p, g, gstd = _learned_taps(color, var, albedo, normal, p, mlp)
    gdiv = gstd + 1e-4
    w1, w2 = mlp[:96].reshape(6, 16), mlp[112:128]
    if saved is None:
        acc = torch.zeros_like(color)
        vacc = torch.zeros_like(var)
        wsum = torch.zeros_like(var)
        for t in taps:
            acc = acc + t["s_col"] * t["w"][..., None]
            vacc = vacc + t["s_var"] * (t["w"] * t["w"])
            wsum = wsum + t["w"]
        m = torch.clamp_min(wsum, 1e-6)
        o = fdiv(acc, m[..., None])
        ov = fdiv(vacc, m * m)
    else:
        o, ov, wsum = saved
        m = torch.clamp_min(wsum, 1e-6)
    if u_out is None:
        u_out = torch.zeros_like(var)
    a_bar = fdiv(g_out, m[..., None])
    v_bar = fdiv(u_out, m * m)
    s_bar = torch.where(wsum >= 1e-6,
                        -_dot(a_bar, o) - ((v_bar + v_bar) * ov) * m, 0.0)
    rows = torch.zeros(var.shape + (6, 16), dtype=torch.float32,
                       device=var.device)
    b1_rows = torch.zeros(var.shape + (16,), dtype=torch.float32,
                          device=var.device)
    w2_rows = torch.zeros_like(b1_rows)
    b2_rows = torch.zeros_like(var)
    lp = torch.zeros_like(var)
    gstd_bar = torch.zeros_like(var)
    w_plane, l_plane = [], []
    for t in taps:
        w = t["w"]
        w_bar = (_dot(a_bar, t["s_col"]) + (w + w) * (v_bar * t["s_var"])) \
            + s_bar
        sig = fdiv(1.0, 1.0 + torch.exp(-t["z"]))
        z_bar = -((w_bar * t["w_k"]) * t["e"]) * sig
        a_h = torch.where(t["pre"] >= 0, z_bar[..., None] * w2, 0.0)
        w2_rows = w2_rows + z_bar[..., None] * t["hid"]
        b2_rows = b2_rows + z_bar
        b1_rows = b1_rows + a_h
        f0, f1, f2 = t["f"]
        for c, f in enumerate((f0, f1, f2)):
            rows[..., c, :] = rows[..., c, :] + a_h * f[..., None]
        rows[..., 5, :] = rows[..., 5, :] + a_h * t["radius"]
        f0_bar = torch.zeros_like(var)
        f3_bar = torch.zeros_like(var)
        for j in range(16):
            f0_bar = f0_bar + a_h[..., j] * w1[0, j]
            f3_bar = f3_bar + a_h[..., j] * w1[3, j]
        dl_bar = fdiv(torch.where(t["dl"] >= 0, f0_bar, -f0_bar), gdiv)
        lp = lp - dl_bar
        gstd_bar = gstd_bar + (f3_bar - f0_bar * fdiv(torch.abs(t["dl"]),
                                                      gdiv * gdiv))
        w_plane.append(w)
        l_plane.append(dl_bar)
    rows[..., 3, :] = gstd[..., None] * b1_rows
    rows[..., 4, :] = p.it_feature * b1_rows
    gv_bar = torch.where(g >= 1e-12, fdiv(gstd_bar, gstd + gstd), 0.0)
    n = var.numel()
    return (torch.stack(w_plane), torch.stack(l_plane),
            torch.cat([a_bar, v_bar[..., None]], -1),
            torch.stack([lp, gv_bar], -1),
            torch.cat([rows.reshape(n, 96), b1_rows.reshape(n, 16),
                       w2_rows.reshape(n, 16), b2_rows.reshape(n, 1)], 1))


def grad_gather_reference(p: StepParams, w_plane, l_plane, pix, pix2):
    """Plain version of ``kernels/denoise.grad_gather``, the second
    backward kernel: each pixel q gathers what the pixels that tapped it
    (p = q + (ky, kx) step, wrapping) owe it, in tap order: the colour
    adjoint sum_k w_pk dL/dA_p + lum weights x (its own luminance adjoint
    + the taps' l_pk), and the variance adjoint sum_k w_pk^2 dL/dV_p plus
    the ``_gauss3`` adjoint (the same symmetric blur) of the blurred
    variance's. Returns (dL/dcolour (H, W, 3), dL/dvariance (H, W))."""
    dc = torch.zeros_like(pix[..., :3])
    dv = torch.zeros_like(pix[..., 0])
    lum = pix2[..., 0]
    k = 0
    for ky in _TAPS:
        for kx in _TAPS:
            back = (-ky * p.step, -kx * p.step)
            w = torch.roll(w_plane[k], back, (0, 1))
            src = torch.roll(pix, back, (0, 1))
            dc = dc + src[..., :3] * w[..., None]
            dv = dv + src[..., 3] * (w * w)
            lum = lum + torch.roll(l_plane[k], back, (0, 1))
            k += 1
    lw = torch.tensor((0.2126, 0.7152, 0.0722), dtype=torch.float32,
                      device=pix.device)
    return dc + lum[..., None] * lw, dv + _gauss3(pix2[..., 1])


def grad_sum_reference(rows):
    """Plain version of ``kernels/denoise.grad_sum``: the 129 parameter
    gradients, the rows summed."""
    return rows.sum(0)


def atrous_step_grad_reference(cv, guide, p: StepParams, mlp, g_out,
                               u_out, saved=None):
    """The three backward kernels' plain versions in a row: (dL/dcolour,
    dL/dvariance, dL/dmlp) of one learned iteration."""
    w_plane, l_plane, pix, pix2, rows = grad_taps_reference(
        cv, guide, p, mlp, g_out, u_out, saved)
    dc, dv = grad_gather_reference(p, w_plane, l_plane, pix, pix2)
    return dc, dv, grad_sum_reference(rows)


def _prepare(*xs):
    return [x.to(torch.float32).contiguous() for x in xs]


def atrous_denoise(color, albedo, normal, iterations: int = 4,
                   sigma_color: float = 0.35, sigma_normal: float = 0.25,
                   sigma_albedo: float = 0.2, sigma_color_decay: float = 3.0):
    """Edge-aware à-trous filtering of (H,W,3) radiance guided by the
    first-hit albedo and normal AOVs; ``sigma_color`` decays by
    ``sigma_color_decay`` per iteration (``denoise.py:25-64``)."""
    out, albedo, normal = _prepare(color, albedo, normal)
    steps = []
    for it in range(iterations):
        sc = sigma_color / (sigma_color_decay ** it)
        steps.append(StepParams.fixed(1 << it, 2.0 * sc ** 2,
                                      2.0 * sigma_normal ** 2,
                                      2.0 * sigma_albedo ** 2))
    return K.atrous_filter(out, None, albedo, normal, steps)[0]


def svgf_denoise(color, albedo, normal, variance, iterations: int = 4,
                 sigma_lum: float = 1.5, sigma_normal_pow: float = 64.0,
                 sigma_albedo: float = 0.25):
    """Variance-guided à-trous filtering, the spatial core of SVGF
    (``denoise.py:79-130``); ``variance`` is the per-pixel, per-channel
    variance of the mean (``RenderState.variance_of_mean``)."""
    out, albedo, normal, variance = _prepare(color, albedo, normal, variance)
    var = _luminance(variance).contiguous()
    steps = [StepParams.svgf(1 << it, sigma_lum, sigma_normal_pow,
                             2.0 * sigma_albedo ** 2)
             for it in range(iterations)]
    return K.atrous_filter(out, var, albedo, normal, steps)[0]


def learned_denoise(color, albedo, normal, variance, params,
                    iterations: int = 4):
    """À-trous filtering with learned tap weights (``denoise.py
    :157-202``); ``params``: the MLP's ``w1``, ``b1``, ``w2``, ``b2`` as
    tensors (``convert.denoiser_params``)."""
    out, albedo, normal, variance = _prepare(color, albedo, normal, variance)
    var = _luminance(variance).contiguous()
    mlp = K.pack_mlp(params).to(out.device)
    steps = [StepParams.learned(1 << it, it / max(iterations - 1, 1))
             for it in range(iterations)]
    return K.atrous_filter(out, var, albedo, normal, steps, mlp)[0]


#: the vendored weights by device: a model, a dict of tensors, or False
#: where the file is absent
_UNET_PARAMS = {}
_LEARNED_PARAMS = {}


def _vendored(name, switch, cache, device, make):
    if os.environ.get(switch, "1") != "1":
        return None
    key = str(torch.device(device))
    if key not in cache:
        path = os.path.join(DATA_DIR, name)
        if not os.path.exists(path):
            cache[key] = False
        else:
            from metal_pathtracer_tpu_torch import convert

            with np.load(path) as z:
                cache[key] = make(convert.denoiser_params(
                    {k: z[k] for k in z.files}, device))
    return cache[key] or None


def _unet_params(device):
    """The vendored conv U-Net (``data/denoiser_unet.npz``) as a
    ``DenoiseUNet`` on ``device``; None if absent or disabled via
    ``MPT_UNET_DENOISE=0``."""
    from metal_pathtracer_tpu_torch.ops.denoise_unet import DenoiseUNet

    return _vendored("denoiser_unet.npz", "MPT_UNET_DENOISE", _UNET_PARAMS,
                     device, DenoiseUNet.from_params)


def _learned_params(device):
    """The vendored tap MLP (``data/denoiser_weights.npz``) on ``device``;
    None if absent or disabled via ``MPT_LEARNED_DENOISE=0``."""
    return _vendored("denoiser_weights.npz", "MPT_LEARNED_DENOISE",
                     _LEARNED_PARAMS, device, lambda params: params)


def denoise_state(state, settings):
    """Denoise the averaged image with the state's AOVs: (H,W,3).

    Filter choice, best first (``denoise.py:251-290``): the conv U-Net
    over the learned prepass (SVGF without the tap weights); the learned
    filter at 4 or 5 iterations; SVGF; the fixed-sigma filter for a state
    without a second moment (a pre-sq_sum checkpoint)."""
    avg = state.present()
    iterations = 5 if settings.denoiseFilterType == 1 else 4
    normal = state.normal
    dev = avg.device
    if state.radiance_sq_sum is not None:
        net = _unet_params(dev)
        tparams = _learned_params(dev)
        var = state.variance_of_mean()
        if net is not None:
            from metal_pathtracer_tpu_torch.ops import denoise_unet

            if tparams is not None:
                base = learned_denoise(avg, state.albedo, normal, var,
                                       tparams, iterations=iterations)
            else:
                base = svgf_denoise(avg, state.albedo, normal, var,
                                    iterations=iterations)
            return denoise_unet.denoise(avg, state.albedo, normal, var, net,
                                        base)
        if tparams is not None and iterations in (4, 5):
            return learned_denoise(avg, state.albedo, normal, var, tparams,
                                   iterations=iterations)
        return svgf_denoise(avg, state.albedo, normal, var,
                            iterations=iterations)
    return atrous_denoise(avg, state.albedo, normal, iterations=iterations)
