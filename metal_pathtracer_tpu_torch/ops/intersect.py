"""Hit records and scene tracing (``ops/intersect.py`` twin, triangle half).

Spheres and rectangles (the analytic primitives and their TPU kernels)
are ROADMAP Queue 1 step 11; the port traces the triangle soup only:
nearest hits through K1 closest-hit, shadow rays through K1 any-hit.
"""

from __future__ import annotations

import dataclasses

import torch

from metal_pathtracer_tpu_torch.constants import (
    INFINITY_T,
    PRIMITIVE_NONE,
    RAY_ORIGIN_EPSILON,
)
from metal_pathtracer_tpu_torch.ops.vecmath import dot, fma, where3


@dataclasses.dataclass(frozen=True)
class HitRecord:
    """SoA hit record over the wavefront (reference: pathtrace.metal:242-256)."""

    hit: torch.Tensor             # (N,)  bool
    t: torch.Tensor               # (N,)  f32
    point: torch.Tensor           # (N,3) f32
    normal: torch.Tensor          # (N,3) f32 — geometric, faced toward the ray
    shading_normal: torch.Tensor  # (N,3) f32
    front_face: torch.Tensor      # (N,)  bool
    two_sided: torch.Tensor       # (N,)  bool
    material: torch.Tensor        # (N,)  i32
    prim_type: torch.Tensor       # (N,)  i32
    prim_index: torch.Tensor      # (N,)  i32
    mesh_index: torch.Tensor      # (N,)  i32
    barycentric: torch.Tensor     # (N,2) f32

    @classmethod
    def miss(cls, shape, device):
        z3 = torch.zeros(shape + (3,), dtype=torch.float32, device=device)
        zi = torch.zeros(shape, dtype=torch.int32, device=device)
        zb = torch.zeros(shape, dtype=torch.bool, device=device)
        return cls(hit=zb, t=torch.full(shape, INFINITY_T, device=device),
                   point=z3, normal=z3, shading_normal=z3, front_face=zb,
                   two_sided=zb, material=zi,
                   prim_type=torch.full_like(zi, PRIMITIVE_NONE),
                   prim_index=zi, mesh_index=zi,
                   barycentric=torch.zeros(shape + (2,), device=device))

    def replace(self, **changes) -> "HitRecord":
        return dataclasses.replace(self, **changes)


def _closer(a: HitRecord, b: HitRecord) -> HitRecord:
    """Per lane, the nearer of two hit sets (ties keep ``a``)."""
    take_b = b.hit & (~a.hit | (b.t < a.t))
    out = {}
    for f in dataclasses.fields(HitRecord):
        x, y = getattr(a, f.name), getattr(b, f.name)
        mask = take_b.reshape(take_b.shape + (1,) * (x.dim() - take_b.dim()))
        out[f.name] = torch.where(mask, y, x)
    out["hit"] = a.hit | b.hit
    return HitRecord(**out)


def trace_scene(origin, direction, scene, t_min, t_max,
                exclude_mesh=None, exclude_prim=None) -> HitRecord:
    """Nearest hit over the scene's triangles, folded into a miss record
    the way the reference folds every primitive family."""
    from metal_pathtracer_tpu_torch.ops import traversal

    rec = HitRecord.miss(origin.shape[:-1], origin.device)
    if scene.triangles is not None and scene.triangles.count > 0:
        rec = _closer(rec, traversal.trace_triangles(
            origin, direction, scene, t_min, t_max,
            exclude_mesh=exclude_mesh, exclude_prim=exclude_prim))
    return rec


def trace_occluded(origin, direction, scene, t_min, t_max):
    """Any-hit (shadow) trace over the scene's triangles: (N,) bool
    (``intersect.trace_occluded:303``; K1 any-hit)."""
    from metal_pathtracer_tpu_torch.ops.kernels import traverse

    if scene.triangles is None or scene.triangles.count == 0:
        return torch.zeros(origin.shape[:-1], dtype=torch.bool,
                           device=origin.device)
    return traverse.trace_any(origin, direction, t_min, t_max,
                              scene.tri_bvh, scene.triangles)


def offset_origin(point, shading_normal, normal, t, direction):
    """Self-intersection-avoiding origin from plain planes (reference:
    pathtrace.metal offset_ray_origin:1196-1207): off the shading normal
    (the geometric ``normal`` where that is not finite and non-zero) by
    max(|t| 1e-4, eps), on the side of ``direction``, then eps/2 along it."""
    bad = ~torch.isfinite(shading_normal).all(-1) \
        | (dot(shading_normal, shading_normal) <= 0.0)
    n = where3(bad, normal, shading_normal)
    sign = torch.where(dot(direction, n) >= 0.0, 1.0, -1.0)
    distance = torch.clamp_min(t.abs() * 1e-4, RAY_ORIGIN_EPSILON)
    origin = fma(n, (sign * distance)[..., None], point)
    return fma(direction, RAY_ORIGIN_EPSILON * 0.5, origin)


def offset_ray_origin(rec: HitRecord, direction):
    """``offset_origin`` of a hit record (``intersect.offset_ray_origin``)."""
    return offset_origin(rec.point, rec.shading_normal, rec.normal, rec.t,
                         direction)
