"""Triangle tracing and hit rebuild (``ops/traversal.py`` twin).

The nearest-hit search itself is kernel K1 (``ops/kernels/traverse.py``):
its exit-link loop is the plain version, ``csrc/traverse.cu`` the CUDA
kernel. This module turns (t, tri, u, v) into a full ``HitRecord``, and
(t, tri, u, v, placement) of an instanced mesh into its world-space
record (``instanced_record``, ``_trace_group:286``'s arithmetic, which
``csrc/common.cuh rebuild_instanced`` repeats in K2 and the texture
stage).
"""

from __future__ import annotations

import torch

from metal_pathtracer_tpu_torch.constants import INFINITY_T, PRIMITIVE_TRIANGLE
from metal_pathtracer_tpu_torch.ops.intersect import HitRecord
from metal_pathtracer_tpu_torch.ops.kernels import traverse
from metal_pathtracer_tpu_torch.ops.kernels.traverse import trace_closest
from metal_pathtracer_tpu_torch.ops.vecmath import (
    cross,
    dot,
    fdiv,
    fma,
    safe_normalize,
    where3,
)
from metal_pathtracer_tpu_torch.schema import (
    INST_ID,
    INST_MAT,
    INST_NRM,
    INST_TRI_OFF,
    instance_table,
)


def trace_triangles(origin, direction, scene, t_min, t_max,
                    exclude_mesh=None, exclude_prim=None) -> HitRecord:
    """Nearest-hit trace of the wavefront against the triangle BVH."""
    best_t, best_tri, best_u, best_v = trace_closest(
        origin, direction, t_min, t_max, scene.tri_bvh, scene.triangles,
        exclude_mesh, exclude_prim)
    return _hit_record_from_best(origin, direction, scene.triangles,
                                 best_t, best_tri, best_u, best_v)


def interpolate_shading_normal(n_faced, n0, n1, n2, u, v):
    """Saturated-barycentric shading normal flipped toward the geometric
    normal (reference: pathtrace.metal interpolate_shading_normal:597-700,
    integrator flip :5895-5906). Returns (normal, ok)."""
    w0 = torch.clamp_min((1.0 - u) - v, 0.0)
    w1 = torch.clamp_min(u, 0.0)
    w2 = torch.clamp_min(v, 0.0)
    w_sum = (w0 + w1) + w2
    has_w = w_sum > 1e-8
    one = torch.ones_like(w0)
    w0 = torch.where(has_w, w0 / w_sum, one)
    w1 = torch.where(has_w, w1 / w_sum, 0.0 * one)
    w2 = torch.where(has_w, w2 / w_sum, 0.0 * one)
    sn = fma(w2[..., None], n2, fma(w0[..., None], n0, w1[..., None] * n1))
    sn_ok = torch.isfinite(sn).all(-1) & (dot(sn, sn) > 0.0)
    sn = torch.where((dot(sn, n_faced) < 0.0)[..., None], -sn, sn)
    return safe_normalize(sn), sn_ok


def _hit_record_from_best(origin, direction, tris, best_t, best_tri,
                          best_u, best_v) -> HitRecord:
    """Rebuild the hit record from (t, tri, u, v) and one gathered
    ``shade_packed`` row per lane."""
    hit = best_tri >= 0
    tri = torch.clamp_min(best_tri, 0).long()
    point = fma(best_t[..., None], direction, origin)
    row = tris.shade_packed[tri]
    v0, v1, v2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    geo_n = safe_normalize(cross(v1 - v0, v2 - v0))
    front = dot(direction, geo_n) < 0.0
    n_faced = where3(front, geo_n, -geo_n)
    sn, sn_ok = interpolate_shading_normal(
        n_faced, row[..., 9:12], row[..., 12:15], row[..., 15:18],
        best_u, best_v)
    shape = best_t.shape
    return HitRecord(
        hit=hit,
        t=torch.where(hit, best_t, INFINITY_T),
        point=point,
        normal=n_faced,
        shading_normal=where3(sn_ok, sn, n_faced),
        front_face=front,
        two_sided=torch.zeros(shape, dtype=torch.bool, device=hit.device),
        material=row[..., 18].to(torch.int32),
        prim_type=torch.where(hit, PRIMITIVE_TRIANGLE, 0).to(torch.int32),
        prim_index=tri.to(torch.int32),
        mesh_index=row[..., 19].to(torch.int32),
        barycentric=torch.stack([best_u, best_v], -1),
    )


def _mat3(m, x):
    """``x @ m.T`` for per-lane (N,3,3) ``m``: each component a 3-term
    dot, contracted like XLA:CPU's jitted (N,3) x (3,3) product."""
    return torch.stack([dot(x, m[:, k]) for k in range(3)], -1)


def instanced_record(origin, direction, t, tri, u, v, inst,
                     groups) -> HitRecord:
    """The world-space hit record of instanced hits from (t, tri, u, v,
    inst) (``_trace_group:318-350``): the object-space ``shade_packed``
    row of the placement's group, the geometric normal
    ``cross(v1 - v0, v2 - v0) @ nrm.T`` normalised and faced, clamped
    barycentric weights over their sum, the shading normal mapped by the
    same matrix, flipped to the faced normal and finite-checked, the
    placement's material, ``mesh_index`` its global instance id. Lanes
    with inst < 0 keep the miss record."""
    tab = instance_table(groups)
    hit = inst >= 0
    row_k = tab.table[torch.clamp_min(inst, 0).long()]
    ints = row_k.view(torch.int32)
    tri_c = torch.where(hit, torch.clamp_min(tri, 0), 0)
    row = tab.shade_packed[(ints[:, INST_TRI_OFF] + tri_c).long()]
    nrm = row_k[:, INST_NRM:INST_NRM + 9].reshape(-1, 3, 3)
    v0, v1, v2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    geo_w = safe_normalize(_mat3(nrm, cross(v1 - v0, v2 - v0)))
    front = dot(direction, geo_w) < 0.0
    n_faced = where3(front, geo_w, -geo_w)
    w0 = torch.clamp_min((1.0 - u) - v, 0.0)
    w1 = torch.clamp_min(u, 0.0)
    w2 = torch.clamp_min(v, 0.0)
    w_sum = torch.clamp_min((w0 + w1) + w2, 1e-8)
    sn_l = fdiv(fma(w2[:, None], row[:, 15:18],
                    fma(w0[:, None], row[:, 9:12], w1[:, None] * row[:, 12:15])),
                w_sum[:, None])
    sn_w = _mat3(nrm, sn_l)
    sn_ok = torch.isfinite(sn_w).all(-1) & (dot(sn_w, sn_w) > 0.0)
    sn_w = torch.where((dot(sn_w, n_faced) < 0.0)[:, None], -sn_w, sn_w)
    shading = where3(sn_ok, safe_normalize(sn_w), n_faced)
    rec = HitRecord(
        hit=hit, t=t, point=fma(t[:, None], direction, origin),
        normal=n_faced, shading_normal=shading, front_face=front,
        two_sided=torch.zeros_like(hit), material=ints[:, INST_MAT],
        prim_type=torch.full_like(tri, PRIMITIVE_TRIANGLE),
        prim_index=tri_c.to(torch.int32), mesh_index=ints[:, INST_ID],
        barycentric=torch.stack([u, v], -1))
    miss = HitRecord.miss(t.shape, t.device)
    return HitRecord(**{
        f: torch.where(hit.reshape(hit.shape + (1,) * (x.dim() - 1)), x,
                       getattr(miss, f))
        for f, x in vars(rec).items()})


def trace_instanced(origin, direction, scene, t_min, t_max,
                    exclude_mesh=None, exclude_prim=None) -> HitRecord:
    """Nearest hit over the scene's instanced groups (``traversal.
    trace_instanced:241``): one ``traverse.trace_instanced_closest`` (one
    launch on CUDA over every placement), its winner rebuilt in world
    space; a lane that hits nothing keeps the miss record (t =
    INFINITY_T)."""
    t, tri, u, v, inst = traverse.trace_instanced_closest(
        origin, direction, t_min, t_max, scene.instanced, exclude_mesh,
        exclude_prim)
    return instanced_record(origin, direction,
                            torch.where(inst >= 0, t, INFINITY_T), tri, u, v,
                            inst, scene.instanced)


def trace_instanced_occluded(origin, direction, scene, t_min, t_max):
    """Any-hit over the instanced groups (``traversal.
    trace_instanced_occluded:364``): (N,) bool."""
    return traverse.trace_instanced_any(origin, direction, t_min, t_max,
                                        scene.instanced)
