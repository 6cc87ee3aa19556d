"""Specular-NEE delta-chain estimator (``ops/specnee.py`` twin, environment
half).

After a delta bounce (a dielectric, or smooth PBR), the reference traces
one more shadow ray along the sampled direction and adds the environment
seen through it with MIS against the delta lobe's pdf (reference:
shaders/pathtrace.metal:6770-7235). Rect-light chains wait for the
analytic primitives (ROADMAP Queue 1 step 11) and MNEE for step 8.
"""

from __future__ import annotations

import torch

from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops import bsdf as bsdf_ops
from metal_pathtracer_tpu_torch.ops import env as env_ops
from metal_pathtracer_tpu_torch.ops.intersect import trace_occluded
from metal_pathtracer_tpu_torch.ops.vecmath import dot, fdiv, safe_normalize

PDF_FLOOR = 1.0e-4       # kSpecularNeePdfFloor (pathtrace.metal:38)
INV_PDF_CLAMP = 1.0e4    # kSpecularNeeInvPdfClamp (pathtrace.metal:39)


def _mis(light_pdf, bsdf_pdf):
    light_pdf = torch.clamp_min(light_pdf, PDF_FLOOR)
    inv = torch.clamp_max(fdiv(1.0, light_pdf), INV_PDF_CLAMP)
    bsdf_pdf = torch.clamp_min(bsdf_pdf, PDF_FLOOR)
    denom = light_pdf + bsdf_pdf
    w = torch.where(denom > 0.0, light_pdf / denom, 0.0)
    w = torch.clamp(w, C.MIS_WEIGHT_CLAMP_MIN, C.MIS_WEIGHT_CLAMP_MAX)
    return w * inv


def delta_chain_estimators(scene, uniforms, static, clamp_p, throughput,
                           direction, is_delta, weight, directional_pdf,
                           medium_event, next_origin, active):
    """The spec-NEE environment contribution of this bounce
    (``specnee.py:63-151`` with MNEE off and no rect lights).

    ``direction``/``is_delta``/``weight``/``directional_pdf``/
    ``medium_event`` describe the BSDF sample just taken, ``next_origin``
    the offset origin of the next ray, ``throughput`` the path throughput
    before that sample's weight, ``active`` the lanes that sampled. The
    RNG state is not read: the reference forks a copy only for the MNEE
    secondary chain. Returns (radiance (N,3), shadow traces issued as a
    0-dim tensor)."""
    if static.enable_mnee:
        raise NotImplementedError("MNEE chains: ROADMAP Queue 1, step 8")
    if not static.enable_specular_nee or scene.environment is None:
        return (torch.zeros_like(next_origin),
                torch.zeros((), dtype=torch.int64, device=active.device))
    env = scene.environment
    dir_valid = (dot(direction, direction) > 0.0) \
        & torch.isfinite(direction).all(-1)
    lanes = active & is_delta & (medium_event <= 0) & dir_valid
    nee_dir = safe_normalize(direction)
    occluded = trace_occluded(next_origin, nee_dir, scene, C.EPSILON_T,
                              torch.where(lanes, C.INFINITY_T, 0.0))
    factor = _mis(env_ops.environment_pdf(env, nee_dir,
                                          uniforms.environment_rotation),
                  directional_pdf)
    env_color = env_ops.environment_color(
        env, nee_dir, uniforms.environment_rotation,
        uniforms.environment_intensity, static)
    contribution = weight * env_color * factor[..., None]
    ok = lanes & ~occluded & torch.isfinite(contribution).all(-1)
    clamped = bsdf_ops.clamp_firefly_contribution(throughput, contribution,
                                                  clamp_p)
    return (torch.where(ok[..., None], clamped, 0.0),
            lanes.sum(dtype=torch.int64))
