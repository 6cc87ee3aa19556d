"""Specular-NEE and MNEE delta-chain estimators (``ops/specnee.py``
twin).

After a delta bounce (a dielectric, a mirror, or smooth PBR), the
reference traces one more ray along the sampled direction and adds the
light seen through it with MIS against the delta lobe's pdf (reference:
shaders/pathtrace.metal:6770-7235): the environment through a shadow ray,
and an emissive rectangle through a closest-hit trace of the scene. With
MNEE on, the delta dielectric lanes at the first delta bounce of a run
(``mneeEligible``) take these primary estimators in place of spec-NEE,
and, with its secondary chain on, trace the scene along that direction,
sample the delta surface they reach from a copy of the RNG state at the
fork point and run both estimators again from there. Despite the name
this is specular-chain NEE, not a manifold walk (SURVEY.md section 2.2);
the port replicates the implemented behaviour.
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
    offset_ray_origin,
    trace_occluded,
    trace_scene,
)
from metal_pathtracer_tpu_torch.ops.vecmath import (
    dot,
    fdiv,
    normalize,
    safe_normalize,
    where3,
)

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
                           medium_event, next_origin, active, front_face,
                           shading_normal, specular_depth, state,
                           is_dielectric):
    """The spec-NEE and MNEE contributions of this bounce
    (``specnee.py:63-209``): the primary estimators on the spec-NEE and
    MNEE lanes, the environment's when an environment map lights the
    scene, then the rect lights' when rectangles emit; then, with MNEE's
    secondary chain on, the chain trace and both estimators again from
    the delta surface it reaches.

    ``direction``/``is_delta``/``weight``/``directional_pdf``/
    ``medium_event`` describe the BSDF sample just taken, ``next_origin``
    the offset origin of the next ray, ``throughput`` the path throughput
    before that sample's weight, ``active`` the lanes that sampled,
    ``front_face`` the side the sample was taken on, ``shading_normal``
    the normal it was taken about, ``specular_depth`` the run of delta
    bounces including this one, ``is_dielectric`` the lanes whose hit
    material is a dielectric (these four are read with MNEE on only).
    ``state`` is the RNG state at the fork point, read only: the
    secondary chain samples from a copy of it (pathtrace.metal:7113); it
    may be None when the secondary chain is off. Returns (radiance (N,3),
    scene traces, shadow traces), the counts as 0-dim tensors: every lane
    a chain traces counts, before any hit test."""
    radiance = torch.zeros_like(next_origin)
    n_scene = torch.zeros((), dtype=torch.int64, device=active.device)
    n_shadow = torch.zeros((), dtype=torch.int64, device=active.device)
    use_env, use_rect = env_nee(scene, static), rect_nee(scene)
    if not (static.enable_specular_nee or static.enable_mnee) \
            or not (use_env or use_rect):
        return radiance, n_scene, n_shadow
    dir_valid = (dot(direction, direction) > 0.0) \
        & torch.isfinite(direction).all(-1)
    mnee = torch.zeros_like(active)
    if static.enable_mnee:
        # didTransmission (reference: pathtrace.metal:6727-6738), then
        # mneeEligible (:6777-6782)
        side = torch.where(front_face, 1.0, -1.0)
        did_transmission = is_dielectric & is_delta \
            & (dot(shading_normal, direction) * side < 0.0)
        mnee = is_delta & ((medium_event <= 0) | did_transmission) \
            & is_dielectric & (specular_depth == 1) & dir_valid
    spec = torch.zeros_like(active)
    if static.enable_specular_nee:
        spec = is_delta & (medium_event <= 0) & dir_valid & ~mnee
    nee_dir = safe_normalize(direction)

    def add(contribution, ok, tp):
        clamped = bsdf_ops.clamp_firefly_contribution(tp, contribution,
                                                      clamp_p)
        return torch.where((ok & torch.isfinite(contribution).all(-1))[:, None],
                           clamped, 0.0)

    def env_estimator(lanes, origin, ray_dir, w, bsdf_pdf, tp):
        env = scene.environment
        occluded = trace_occluded(origin, ray_dir, scene, C.EPSILON_T,
                                  torch.where(lanes, C.INFINITY_T, 0.0))
        factor = _mis(env_ops.environment_pdf(env, ray_dir,
                                              uniforms.environment_rotation),
                      bsdf_pdf)
        env_color = env_ops.environment_color(
            env, ray_dir, uniforms.environment_rotation,
            uniforms.environment_intensity, static)
        return add(w * env_color * factor[:, None], lanes & ~occluded, tp)

    def rect_estimator(lanes, origin, ray_dir, w, bsdf_pdf, tp):
        hit = trace_scene(origin, ray_dir, scene, C.EPSILON_T,
                          torch.where(lanes, C.INFINITY_T, 0.0))
        emission, pdf, valid = rect_hit_light(scene, uniforms, static, hit,
                                              origin)
        factor = _mis(pdf, bsdf_pdf)
        return add(w * emission * factor[:, None], lanes & hit.hit & valid,
                   tp)

    def estimators(lanes, origin, ray_dir, w, bsdf_pdf, rows=None):
        """Both estimators on ``lanes``, over the whole wavefront or (with
        ``rows``, the wavefront's lane of each entry) a subset of it; each
        contribution is added as the reference adds it, environment
        first."""
        nonlocal radiance, n_scene, n_shadow
        tp = throughput if rows is None else throughput[rows]
        count = lanes.sum(dtype=torch.int64)
        for on, estimator in ((use_env, env_estimator),
                              (use_rect, rect_estimator)):
            if not on:
                continue
            got = estimator(lanes, origin, ray_dir, w, bsdf_pdf, tp)
            if rows is None:
                radiance = radiance + got
            else:
                radiance = radiance.index_put((rows,), radiance[rows] + got)
        if use_env:
            n_shadow = n_shadow + count
        if use_rect:
            n_scene = n_scene + count

    estimators(active & (spec | mnee), next_origin, nee_dir, weight,
               directional_pdf)
    if static.enable_mnee and static.enable_mnee_secondary:
        chain = active & mnee
        n_scene = n_scene + chain.sum(dtype=torch.int64)
        # the secondary chain runs on its own lanes only (a few percent of
        # the wavefront; one host sync for their count): every step is
        # per lane, so the subset gives each lane what the whole
        # wavefront would
        rows = torch.nonzero(chain).squeeze(1)
        if rows.numel():
            estimators(*_secondary_chain(
                scene, uniforms, static, clamp_p, next_origin[rows],
                nee_dir[rows], weight[rows], directional_pdf[rows],
                state[rows], use_rect), rows=rows)
    return radiance, n_scene, n_shadow


def _secondary_chain(scene, uniforms, static, clamp_p, origin, nee_dir,
                     weight, directional_pdf, state, use_rect):
    """MNEE's secondary chain up to its estimators (``specnee.py:153-
    200``; reference: pathtrace.metal:7060-7232), on the chain's lanes
    only: trace the scene from the delta surface along ``nee_dir``; where
    the ray reaches a delta surface that is not an emissive rectangle,
    sample its BSDF from a copy of ``state`` about the geometric normal
    ((0, 1, 0) where that is not finite and non-zero). Returns the
    estimators' arguments: the lanes whose sample is a delta lobe
    without a medium event, its offset origin and direction, the product
    of both weights and of both pdfs (floored at ``PDF_FLOOR``)."""
    rec = trace_scene(origin, nee_dir, scene, C.EPSILON_T, C.INFINITY_T)
    if use_rect:
        hit_is_light = rect_hit_light(scene, uniforms, static, rec,
                                      origin)[2]
    else:
        hit_is_light = torch.zeros_like(rec.hit)
    mats = scene.materials
    m2 = bsdf_ops.gather_material(
        mats, torch.clamp(rec.material, 0, mats.count - 1))
    ok = rec.hit & ~hit_is_light & bsdf_ops.material_is_delta(m2)
    normal = rec.normal
    bad = ~torch.isfinite(normal).all(-1) | (dot(normal, normal) <= 0.0)
    up = torch.tensor([0.0, 1.0, 0.0], device=normal.device)
    normal = normalize(where3(bad, up.expand_as(normal), normal))
    incident = normalize(nee_dir)
    # only the material types of the lanes that go on are sampled (one
    # host sync): every type's sampler runs over all lanes, and the other
    # lanes' samples are never read
    types = [t for t in torch.unique(m2.mat_type[ok]).tolist()
             if t in static.material_types]
    _, smp = bsdf_ops.sample_bsdf(
        m2, normal, -incident, incident, rec.front_face, state, clamp_p,
        torch.ones_like(rec.t), types, position=rec.point,
        sss_mode=static.sss_mode, specular_only=static.debug_specular_only)
    ok = ok & (smp.pdf > 0.0) & smp.is_delta & (smp.medium_event <= 0)
    chain_dir = safe_normalize(smp.direction)
    ok = ok & torch.isfinite(chain_dir).all(-1) \
        & (dot(chain_dir, chain_dir) > 0.0)
    pdf = torch.clamp_min(directional_pdf * smp.directional_pdf, PDF_FLOOR)
    return (ok, offset_ray_origin(rec, chain_dir), chain_dir,
            weight * smp.weight, pdf)
