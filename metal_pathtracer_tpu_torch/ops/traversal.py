"""Triangle tracing and hit rebuild (``ops/traversal.py`` twin).

The nearest-hit search itself is kernel K1 (``ops/kernels/traverse.py``):
its exit-link loop is the plain version, ``csrc/traverse.cu`` the CUDA
kernel. This module turns (t, tri, u, v) into a full ``HitRecord``.
"""

from __future__ import annotations

import torch

from metal_pathtracer_tpu_torch.constants import INFINITY_T, PRIMITIVE_TRIANGLE
from metal_pathtracer_tpu_torch.ops.intersect import HitRecord
from metal_pathtracer_tpu_torch.ops.kernels.traverse import trace_closest
from metal_pathtracer_tpu_torch.ops.vecmath import (
    cross,
    dot,
    fma,
    safe_normalize,
    where3,
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
