"""One à-trous iteration of the denoisers, as one CUDA launch.

The JAX package's three tap filters (``ops/denoise.py`` ``atrous_denoise
:25``, ``svgf_denoise:79``, ``learned_denoise:157``) are XLA, not Pallas:
each iteration is 25 ``jnp.roll``s of four planes and a few dozen
elementwise operations a tap, so not a TPU kernel there, like the
texture pre-stage. Here an iteration is ``csrc/denoise.cu``
``atrous_step_kernel<MODE>``, a thread per pixel: the variance prologue
(``_gauss3`` of the luminance variance, ``denom`` or ``gstd``, the centre
luminance) is fused in (nine reads of the variance around the pixel),
the 25 taps at step ``1 << it`` are read toroidally (``jnp.roll``'s
wrap-around, a true modulo) through L1, the learned filter's 6-16-1 MLP
runs per tap from shared memory, and the normalised colour and, in the
variance-guided modes, the variance come out. The bound is operations:
~290 a tap for ``LEARNED`` (the MLP), 43 and 50 for ``FIXED`` and
``SVGF``, whose bytes (each input read once and each output written once:
48 or 56 B a pixel) come within 15 % of it.

``atrous_step`` launches the kernel on CUDA tensors and runs
``ops/denoise.atrous_step_reference`` on CPU tensors. The host-side
constants (``StepParams``) are the JAX package's Python doubles rounded
once to float32, as they are when they meet an array there; the kernel
divides by them as the plain version does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from metal_pathtracer_tpu_torch.ops.kernels import build

#: filter modes, ``MODE`` of ``atrous_step_kernel``
FIXED, SVGF, LEARNED = 0, 1, 2
#: the learned filter's MLP packed as the kernel reads it: w1 (6, 16) row
#: by row, b1 (16), w2 (16), b2 (1)
MLP_FLOATS = 6 * 16 + 16 + 16 + 1


def _f32(x: float) -> float:
    """A Python double rounded once to float32."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class StepParams:
    """One iteration's launch constants: the mode, the tap step and the
    eight float32 scalars of ``csrc/denoise.cu StepScalars`` (the colour,
    normal and albedo divisors of the fixed filter, SVGF's luminance
    sigma and normal exponent, the learned filter's iteration feature)."""

    mode: int
    step: int
    c_color: float = 0.0
    c_normal: float = 0.0
    c_albedo: float = 0.0
    sigma_lum: float = 0.0
    normal_pow: float = 0.0
    it_feature: float = 0.0

    @classmethod
    def fixed(cls, step, c_color, c_normal, c_albedo) -> "StepParams":
        return cls(FIXED, step, c_color=_f32(c_color),
                   c_normal=_f32(c_normal), c_albedo=_f32(c_albedo))

    @classmethod
    def svgf(cls, step, sigma_lum, normal_pow, c_albedo) -> "StepParams":
        return cls(SVGF, step, c_albedo=_f32(c_albedo),
                   sigma_lum=_f32(sigma_lum), normal_pow=_f32(normal_pow))

    @classmethod
    def learned(cls, step, it_feature) -> "StepParams":
        return cls(LEARNED, step, it_feature=_f32(it_feature))

    def scalars(self):
        return [self.c_color, self.c_normal, self.c_albedo, self.sigma_lum,
                self.normal_pow, self.it_feature, 0.0, 0.0]


def pack_mlp(params: dict) -> torch.Tensor:
    """The tap MLP's weights as one contiguous (129,) float32 tensor on
    their device (``MLP_FLOATS``'s order)."""
    return torch.cat([params["w1"].reshape(-1), params["b1"].reshape(-1),
                      params["w2"].reshape(-1), params["b2"].reshape(-1)]
                     ).to(torch.float32).contiguous()


def _check(color, var, albedo, normal, p, mlp):
    h, w = color.shape[:2]
    need = [("color", color, (h, w, 3)), ("albedo", albedo, (h, w, 3)),
            ("normal", normal, (h, w, 3))]
    if p.mode != FIXED:
        need.append(("variance", var, (h, w)))
    if p.mode == LEARNED:
        need.append(("mlp", mlp, (MLP_FLOATS,)))
    for name, x, shape in need:
        if x is None or tuple(x.shape) != shape \
                or x.dtype != torch.float32 or not x.is_contiguous() \
                or x.device != color.device:
            raise ValueError(
                f"atrous_step: {name} must be a contiguous float32 {shape} "
                f"tensor on {color.device}, got "
                f"{None if x is None else (tuple(x.shape), x.dtype)}")


def atrous_step(color, var, albedo, normal, p: StepParams, mlp=None):
    """One iteration at step ``p.step``: (colour (H, W, 3), variance (H,
    W) or None in ``FIXED`` mode). ``var`` is the luminance variance
    (``SVGF``, ``LEARNED``), ``mlp`` the packed MLP (``LEARNED``). CPU
    tensors run the plain version; CUDA tensors launch
    ``csrc/denoise.cu``."""
    dev = color.device
    if dev.type == "cpu":
        from metal_pathtracer_tpu_torch.ops.denoise import (
            atrous_step_reference,
        )
        return atrous_step_reference(color, var, albedo, normal, p, mlp)
    if dev.type != "cuda":
        raise ValueError(f"atrous_step: unsupported device {dev}")
    _check(color, var, albedo, normal, p, mlp)
    h, w = color.shape[:2]
    out = torch.empty_like(color)
    out_var = None if p.mode == FIXED else torch.empty_like(var)
    ptr = lambda x: None if x is None else x.data_ptr()
    lib = build.load()
    err = lib.mpt_atrous_step(
        p.mode, h, w, p.step, build.floats(p.scalars()),
        ptr(mlp if p.mode == LEARNED else None), ptr(color),
        ptr(None if p.mode == FIXED else var), ptr(albedo), ptr(normal),
        ptr(out), ptr(out_var), torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "mpt_atrous_step")
    atrous_step.launches += 1
    return out, out_var


#: à-trous iterations launched since the last reset
atrous_step.launches = 0
