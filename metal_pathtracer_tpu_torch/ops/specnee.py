"""Specular-NEE delta-chain estimators (``ops/specnee.py`` twin, MNEE
off).

After a delta bounce (a dielectric, a mirror, or smooth PBR), the
reference traces one more ray along the sampled direction and adds the
light seen through it with MIS against the delta lobe's pdf (reference:
shaders/pathtrace.metal:6770-7235): the environment through a shadow ray,
and an emissive rectangle through a closest-hit trace of the scene. MNEE
(and its secondary chain) is ROADMAP Queue 1's MNEE item.
"""

from __future__ import annotations

import torch

from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops import bsdf as bsdf_ops
from metal_pathtracer_tpu_torch.ops import env as env_ops
from metal_pathtracer_tpu_torch.ops.integrator import (
    env_nee,
    rect_light_pdf_for_hit,
    rect_nee,
)
from metal_pathtracer_tpu_torch.ops.intersect import (
    trace_occluded,
    trace_scene,
)
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


def rect_hit_light(scene, uniforms, static, rec, origin):
    """mnee_rect_light_hit (``specnee.py _rect_hit_light:35-60``;
    reference: shaders/mnee.metal:1-62): the emission and NEE pdf of a
    hit on an emissive rectangle seen from ``origin``; under an
    environment light integral the front face of an ``emission_env``
    light emits times the environment seen along its reversed shading
    normal. Returns (emission (N,3), pdf (N,), valid (N,))."""
    mats = scene.materials
    idx = torch.clamp(rec.prim_index, 0, max(scene.n_rects - 1, 0)).long()
    mat = torch.clamp(scene.rects.material[idx], 0, mats.count - 1).long()
    emission = mats.emission[mat]
    is_light = (mats.mat_type[mat] == C.MATERIAL_DIFFUSE_LIGHT) \
        & (emission != 0.0).any(-1)
    if env_nee(scene, static):
        env_mod = env_ops.environment_color(
            scene.environment, -rec.shading_normal,
            uniforms.environment_rotation, uniforms.environment_intensity,
            static)
        emission = torch.where(
            ((mats.emission_env[mat] > 0.0) & rec.front_face)[:, None],
            emission * env_mod, emission)
    pdf = rect_light_pdf_for_hit(scene, rec.point, rec.prim_type,
                                 rec.prim_index, origin)
    valid = ((rec.prim_type == C.PRIMITIVE_RECTANGLE) & is_light
             & (rec.front_face | rec.two_sided) & (emission != 0.0).any(-1)
             & (pdf > 0.0) & torch.isfinite(pdf))
    return emission, pdf, valid


def delta_chain_estimators(scene, uniforms, static, clamp_p, throughput,
                           direction, is_delta, weight, directional_pdf,
                           medium_event, next_origin, active):
    """The spec-NEE contributions of this bounce (``specnee.py:63-151``
    with MNEE off): the environment estimator when an environment map
    lights the scene, then the rect-light estimator when rectangles emit.

    ``direction``/``is_delta``/``weight``/``directional_pdf``/
    ``medium_event`` describe the BSDF sample just taken, ``next_origin``
    the offset origin of the next ray, ``throughput`` the path throughput
    before that sample's weight, ``active`` the lanes that sampled. The
    RNG state is not read: the reference forks a copy only for the MNEE
    secondary chain. Returns (radiance (N,3), scene traces, shadow
    traces), the counts as 0-dim tensors."""
    if static.enable_mnee:
        raise NotImplementedError("MNEE chains: ROADMAP Queue 1, MNEE")
    radiance = torch.zeros_like(next_origin)
    n_scene = torch.zeros((), dtype=torch.int64, device=active.device)
    n_shadow = torch.zeros((), dtype=torch.int64, device=active.device)
    use_env, use_rect = env_nee(scene, static), rect_nee(scene)
    if not static.enable_specular_nee or not (use_env or use_rect):
        return radiance, n_scene, n_shadow
    dir_valid = (dot(direction, direction) > 0.0) \
        & torch.isfinite(direction).all(-1)
    lanes = active & is_delta & (medium_event <= 0) & dir_valid
    nee_dir = safe_normalize(direction)
    lane_tmax = torch.where(lanes, C.INFINITY_T, 0.0)

    def add(contribution, ok):
        clamped = bsdf_ops.clamp_firefly_contribution(throughput,
                                                      contribution, clamp_p)
        return torch.where((ok & torch.isfinite(contribution).all(-1))[:, None],
                           clamped, 0.0)

    if use_env:
        env = scene.environment
        occluded = trace_occluded(next_origin, nee_dir, scene, C.EPSILON_T,
                                  lane_tmax)
        factor = _mis(env_ops.environment_pdf(env, nee_dir,
                                              uniforms.environment_rotation),
                      directional_pdf)
        env_color = env_ops.environment_color(
            env, nee_dir, uniforms.environment_rotation,
            uniforms.environment_intensity, static)
        radiance = radiance + add(weight * env_color * factor[:, None],
                                  lanes & ~occluded)
        n_shadow = n_shadow + lanes.sum(dtype=torch.int64)
    if use_rect:
        hit = trace_scene(next_origin, nee_dir, scene, C.EPSILON_T, lane_tmax)
        emission, pdf, valid = rect_hit_light(scene, uniforms, static, hit,
                                              next_origin)
        factor = _mis(pdf, directional_pdf)
        radiance = radiance + add(weight * emission * factor[:, None],
                                  lanes & hit.hit & valid)
        n_scene = n_scene + lanes.sum(dtype=torch.int64)
    return radiance, n_scene, n_shadow
