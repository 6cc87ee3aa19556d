"""BSDF sampling and clamps (``ops/bsdf.py`` twin, lambert subset).

Metal, dielectric, plastic, subsurface, carpaint and PBR are ROADMAP
Queue 1 steps 6 and 13; ``sample_bsdf`` raises for them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from metal_pathtracer_tpu import constants as C
from metal_pathtracer_tpu_torch.ops import rng as rng_ops
from metal_pathtracer_tpu_torch.ops.vecmath import (
    dot,
    fdiv,
    luminance,
    normalize,
    safe_normalize,
    to_world,
    where3,
)

PI = 3.14159265358979323846


class ClampParams(NamedTuple):
    """Firefly and throughput clamp settings (host floats)."""

    clamp_factor: float
    clamp_floor: float
    throughput_clamp: float
    max_contribution: float
    enabled: float


def make_clamp_params(uniforms) -> ClampParams:
    return ClampParams(
        clamp_factor=uniforms.firefly_clamp_factor,
        clamp_floor=uniforms.firefly_clamp_floor,
        throughput_clamp=uniforms.throughput_clamp,
        max_contribution=uniforms.firefly_clamp_max_contribution,
        enabled=uniforms.firefly_clamp_enabled,
    )


def clamp_firefly_contribution(throughput, contribution, p: ClampParams):
    """(reference: pathtrace.metal clamp_firefly_contribution)"""
    combined = throughput * contribution
    finite = torch.isfinite(combined).all(-1)
    positive = torch.clamp_min(combined, 0.0)
    lum = luminance(positive)
    tp_lum = luminance(torch.clamp_min(throughput, 0.0))
    max_lum = torch.clamp_min(tp_lum * p.clamp_factor, p.clamp_floor)
    if p.max_contribution > 0.0:
        max_lum = torch.clamp_min(max_lum, p.max_contribution)
    scale = torch.where((lum > max_lum) & (lum > 0.0),
                        max_lum / torch.clamp_min(lum, 1e-6), 1.0)
    out = positive if p.enabled < 0.5 else \
        torch.clamp_min(combined * scale[..., None], 0.0)
    return where3(finite, out, torch.zeros_like(out))


def clamp_path_throughput(throughput, p: ClampParams):
    """(reference: pathtrace.metal clamp_path_throughput)"""
    finite = torch.isfinite(throughput).all(-1)
    lum = luminance(torch.clamp_min(throughput, 0.0))
    scale = torch.where((lum > p.throughput_clamp) & (lum > 0.0),
                        fdiv(p.throughput_clamp, torch.clamp_min(lum, 1e-6)),
                        1.0)
    out = throughput
    if p.enabled >= 0.5 and p.throughput_clamp > 0.0:
        out = scale[..., None] * throughput
    return where3(finite, out, torch.zeros_like(out))


@dataclasses.dataclass(frozen=True)
class MatLanes:
    """Material rows gathered onto lanes: the fields lambert reads."""

    base_color: torch.Tensor  # (N,3)
    mat_type: torch.Tensor    # (N,) i32


def gather_material(materials, index) -> MatLanes:
    idx = torch.clamp(index, 0, materials.count - 1).long()
    return MatLanes(base_color=materials.base_color[idx],
                    mat_type=materials.mat_type[idx])


def material_base_color(m: MatLanes):
    return torch.clamp(m.base_color, 0.0, 1.0)


def lambert_pdf(normal, direction):
    cos_t = torch.clamp_min(dot(normal, normalize(direction)), 0.0)
    return torch.where(cos_t > 0.0, fdiv(cos_t, PI), 0.0)


@dataclasses.dataclass(frozen=True)
class BsdfSample:
    """The sampled lobe; lambert sets direction, weight, the pdfs and the
    lobe roughness (its lobe type is 0 = diffuse, never delta)."""

    direction: torch.Tensor        # (N,3)
    weight: torch.Tensor           # (N,3) — f * cos / pdf
    pdf: torch.Tensor              # (N,)
    directional_pdf: torch.Tensor  # (N,)
    lobe_type: torch.Tensor        # (N,) i32: 0 diffuse, 1 glossy
    lobe_roughness: torch.Tensor   # (N,)
    is_delta: torch.Tensor         # (N,) bool


def _sample_lambert(m: MatLanes, normal, state, diffuse_occlusion):
    """(reference: pathtrace.metal:5163-5196)"""
    state, local = rng_ops.sample_cosine_hemisphere(state)
    wi = safe_normalize(to_world(local, normal))
    cos_i = dot(normal, wi)
    pdf = lambert_pdf(normal, wi)
    albedo = material_base_color(m) * torch.clamp(diffuse_occlusion, 0.0,
                                                  1.0)[..., None]
    f = fdiv(albedo, PI)
    weight = torch.clamp_min(
        f * (cos_i / torch.clamp_min(pdf, 1e-20))[..., None], 0.0)
    ok = (cos_i > 0.0) & (pdf > 0.0) & torch.isfinite(weight).all(-1)
    zero = torch.zeros_like(pdf)
    return state, BsdfSample(
        direction=where3(ok, wi, torch.zeros_like(wi)),
        weight=where3(ok, weight, torch.zeros_like(weight)),
        pdf=torch.where(ok, pdf, zero),
        directional_pdf=torch.where(ok, pdf, zero),
        lobe_type=torch.zeros(pdf.shape, dtype=torch.int32,
                              device=pdf.device),
        lobe_roughness=torch.where(ok, 1.0, zero),
        is_delta=torch.zeros(pdf.shape, dtype=torch.bool, device=pdf.device))


def sample_bsdf(m: MatLanes, normal, state, diffuse_occlusion,
                material_types):
    """Type-dispatched sampling; this slice has the lambert branch only.
    Returns (new_state, BsdfSample)."""
    if set(int(t) for t in material_types) - {C.MATERIAL_LAMBERTIAN}:
        raise NotImplementedError(
            "only lambert materials are ported (ROADMAP Queue 1, step 6)")
    return _sample_lambert(m, normal, state, diffuse_occlusion)


def bsdf_cone_spread_increment(lobe_type, roughness, is_delta):
    """(reference: pathtrace.metal bsdf_cone_spread_increment)"""
    r = torch.clamp(roughness, 0.0, 1.0)
    inc = torch.where(lobe_type == 0, 0.55,
                      torch.where(lobe_type == 1, 0.03 + (0.45 - 0.03) * r,
                                  0.10 + (0.60 - 0.10) * r))
    return torch.where(is_delta, 0.0, inc)
