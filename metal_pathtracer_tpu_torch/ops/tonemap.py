"""Tonemapping and bloom (``ops/tonemap.py`` twin, in torch).

The reference's display shader and its CPU writer replicas share this
math (reference: shaders/display.metal:1-149,
src/renderer/ImageWriter.mm:83-162). The JAX package runs it as XLA or
numpy, no Pallas kernel, so the port's version is plain torch on whatever
device the image lies on. Sums are written out term by term, in the order
the JAX package's numpy path takes them, and divisions by a number go
through ``vecmath.fdiv`` (one IEEE division, as numpy's).
"""

from __future__ import annotations

import math

import torch

from metal_pathtracer_tpu_torch.constants import LUMINANCE_WEIGHTS
from metal_pathtracer_tpu_torch.ops.vecmath import fdiv

# Stephen Hill's ACES fit, row layout as the reference's applyMatrix
# (r = M v, with its transposed-vs-textbook coefficient order)
_ACES_IN = ((0.59719, 0.07600, 0.02840),
            (0.35458, 0.90834, 0.13383),
            (0.04823, 0.01566, 0.83777))
_ACES_OUT = ((1.60475, -0.10208, -0.00327),
             (-0.53108, 1.10813, -0.07276),
             (-0.07367, -0.00605, 1.07602))


def _f32(x: float) -> float:
    """A Python float rounded to float32, as the JAX package's arrays of
    constants hold it."""
    return float(torch.tensor(x, dtype=torch.float32))


def _luminance(rgb):
    w = [_f32(c) for c in LUMINANCE_WEIGHTS]
    return (rgb[..., 0] * w[0] + rgb[..., 1] * w[1]) + rgb[..., 2] * w[2]


def _apply(mat, c):
    rows = [(c[..., 0] * _f32(m[0]) + c[..., 1] * _f32(m[1]))
            + c[..., 2] * _f32(m[2]) for m in mat]
    return torch.stack(rows, -1)


def aces_fitted(color):
    """Stephen Hill's ACES fit (reference: ImageWriter.mm ACESFitted:83-101)."""
    c = _apply(_ACES_IN, color)
    a = c * (c + 0.0245786) - 0.000090537
    b = c * (0.983729 * c + 0.4329510) + 0.238081
    return torch.clamp(_apply(_ACES_OUT, a / b), 0.0, 1.0)


def aces_simple(color):
    """Narkowicz approximation (reference: ImageWriter.mm ACESSimple)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    num = color * (a * color + b)
    den = color * (c * color + d) + e
    return torch.clamp(num / den, 0.0, 1.0)


def reinhard(color, white_point):
    """(reference: ImageWriter.mm tonemapReinhard). In float64 from the
    luminance on, as the JAX package's numpy path computes it (its white
    point is a float64 scalar)."""
    w = torch.tensor(max(float(white_point), 1e-4), dtype=torch.float64,
                     device=color.device)
    denom = 1.0 + torch.div(_luminance(color).double(), w)
    return torch.clamp(torch.div(color.double(), denom[..., None]), 0.0, 1.0)


def hable(color):
    """Uncharted 2 filmic (reference: ImageWriter.mm tonemapHable)."""
    A, B, Cc, D, E, F, W = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30, 11.2

    def curve(x):
        return ((x * (A * x + B)) + Cc * x + D) \
            / ((x * (A * x + B)) + E * x + F) - D / F

    white = ((W * (A * W + B)) + Cc * W + D) \
        / ((W * (A * W + B)) + E * W + F) - D / F
    return torch.clamp(fdiv(curve(color), white), 0.0, 1.0)


def apply_tonemap(linear_rgb, tonemap_mode: int, aces_variant: int,
                  exposure: float, reinhard_white: float):
    """Exposure -> curve -> gamma 2.2 (reference: ImageWriter.mm
    applyTonemap:140-162)."""
    color = linear_rgb * _f32(math.pow(2.0, _f32(exposure)))
    if tonemap_mode == 2:
        color = aces_fitted(color) if aces_variant == 0 else aces_simple(color)
    elif tonemap_mode == 3:
        color = reinhard(color, reinhard_white)
    elif tonemap_mode == 4:
        color = hable(color)
    else:
        color = torch.clamp(color, 0.0, 1.0)
    color = torch.pow(torch.clamp_min(color, 0.0), 1.0 / 2.2)
    return torch.clamp(color, 0.0, 1.0)


def bloom(hdr, threshold: float, intensity: float, radius: float):
    """9-tap threshold bloom, pre-tonemap on the HDR average: one ring of
    8 taps at ``radius`` pixels plus the centre (reference:
    shaders/display.metal:56-105)."""
    lum = _luminance(hdr)
    mask = torch.clamp_min(lum - threshold, 0.0) / torch.clamp_min(lum, 1e-4)
    bright = hdr * mask[..., None]
    r = max(int(round(radius)), 1)
    acc = bright
    for dy, dx in [(-r, 0), (r, 0), (0, -r), (0, r), (-r, -r), (-r, r),
                   (r, -r), (r, r)]:
        acc = acc + torch.roll(bright, (dy, dx), dims=(0, 1))
    return hdr + intensity * fdiv(acc, 9.0)
