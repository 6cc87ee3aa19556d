"""Hit records and scene tracing (``ops/intersect.py`` twin).

Nearest hits go through K1 closest-hit (triangles), K1 instanced
(placements of instanced meshes), K3a or K3b (spheres) and K3c
(rectangles), shadow rays through K1 any-hit, K1 instanced any-hit and
the same K3 kernels with the shadow window. ``trace_merged`` folds the
families in the reference's order and returns each lane's winner as (t,
index, u, v, family); ``trace_scene`` turns that into a full
``HitRecord`` (``hit_record``).

The family of an instanced hit is a port-internal code, not a
``PRIMITIVE_*`` id: ``KIND_INSTANCE + k`` for flat placement k (row k of
``schema.InstanceTable``), with the object triangle as its index, so the
five (N,) planes carry the placement too and no sixth is needed. Its
``HitRecord`` says ``PRIMITIVE_TRIANGLE``, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses

import torch

from metal_pathtracer_tpu_torch.constants import (
    INFINITY_T,
    PRIMITIVE_NONE,
    PRIMITIVE_RECTANGLE,
    PRIMITIVE_SPHERE,
    PRIMITIVE_TRIANGLE,
    RAY_ORIGIN_EPSILON,
)
from metal_pathtracer_tpu_torch.ops.vecmath import dot, fdiv, fma, where3


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


def analytic_point(origin, t, direction):
    """o + t d of a sphere or rectangle hit. XLA:CPU contracts the x and y
    components of the JAX package's (N,3) ``origin + t * direction`` into
    FMAs and not the z component (measured on ``hit_spheres`` and
    ``hit_rects``); the sphere normal is rebuilt from this point, so the
    port keeps that placement here and in K2."""
    return torch.stack([fma(t, direction[..., 0], origin[..., 0]),
                        fma(t, direction[..., 1], origin[..., 1]),
                        origin[..., 2] + t * direction[..., 2]], -1)


def sphere_outward(point, center, radius):
    """(p - c) / r, one IEEE division per component (``hit_spheres``)."""
    return fdiv(point - center, radius[..., None])


def analytic_record(origin, direction, t, idx, kind, scene) -> HitRecord:
    """The hit record of sphere (``kind`` 1) and rectangle (2) lanes from
    (t, index), as ``hit_spheres``/``hit_rects`` build it: the normal
    faced toward the ray is also the shading normal, spheres are
    two-sided and rectangles as stored. Other lanes keep the miss
    record."""
    shape = t.shape
    dev = t.device
    is_s = kind == PRIMITIVE_SPHERE
    is_r = kind == PRIMITIVE_RECTANGLE
    point = analytic_point(origin, t, direction)
    raw = torch.zeros(shape + (3,), device=dev)
    zi = torch.zeros(shape, dtype=torch.int32, device=dev)
    material, two_sided = zi, torch.zeros(shape, dtype=torch.bool, device=dev)
    if scene.n_spheres:
        i = torch.clamp(idx, 0, scene.spheres.count - 1).long()
        raw = where3(is_s, sphere_outward(point, scene.spheres.center[i],
                                          scene.spheres.radius[i]), raw)
        material = torch.where(is_s, scene.spheres.material[i], material)
        two_sided = two_sided | is_s
    if scene.n_rects:
        i = torch.clamp(idx, 0, scene.rects.count - 1).long()
        raw = where3(is_r, scene.rects.normal[i], raw)
        material = torch.where(is_r, scene.rects.material[i], material)
        two_sided = two_sided | (is_r & (scene.rects.two_sided[i] > 0.5))
    front = dot(direction, raw) < 0.0
    normal = where3(front, raw, -raw)
    return _closer(HitRecord.miss(shape, dev), HitRecord(
        hit=is_s | is_r, t=t, point=point, normal=normal,
        shading_normal=normal, front_face=front, two_sided=two_sided,
        material=material, prim_type=kind.to(torch.int32),
        prim_index=idx.to(torch.int32), mesh_index=zi,
        barycentric=torch.zeros(shape + (2,), device=dev)))


#: the family code of flat placement 0 of the instanced groups
KIND_INSTANCE = 4


def trace_merged(origin, direction, scene, t_min, t_max, exclude_mesh=None,
                 exclude_prim=None):
    """Nearest hit over every primitive family: (t, index, u, v, family).

    ``family`` is the winner's ``PRIMITIVE_*`` id (0 on a miss), or
    ``KIND_INSTANCE + k`` for placement k of an instanced mesh, and
    ``index`` its index within the family (the object triangle of an
    instanced hit; -1 on a miss); u, v are the triangle's barycentrics (0
    otherwise). The fold is ``trace_scene``'s (``intersect.py:277-300``;
    ``shade.py _trace_merged:2641-2755``): spheres, then rectangles, then
    triangles, then instances, each later family taking a lane only when
    strictly nearer, so an exact-t tie goes to the sphere, then the
    rectangle, then the soup triangle. The self-hit exclusion applies to
    triangles and instances only: a soup triangle's (mesh, triangle) and
    an instance's (global instance id, object triangle) never name each
    other, since instance ids start after the soup's mesh ids.
    """
    from metal_pathtracer_tpu_torch.ops.kernels import primitives, traverse

    n = origin.shape[0]
    dev = origin.device
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (n,)).contiguous()
    zero = torch.zeros(n, device=dev)
    if scene.n_triangles:
        t, idx, u, v = traverse.trace_closest(
            origin, direction, t_min, t_max, scene.tri_bvh, scene.triangles,
            exclude_mesh, exclude_prim)
    else:
        t = torch.full((n,), INFINITY_T, device=dev)
        idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
        u, v = zero, zero
    kind = torch.where(idx >= 0, PRIMITIVE_TRIANGLE,
                       PRIMITIVE_NONE).to(torch.int32)
    best_t = torch.where(idx >= 0, t, INFINITY_T)
    if scene.instanced:
        it, itri, iu, iv, inst = traverse.trace_instanced_closest(
            origin, direction, t_min, t_max, scene.instanced, exclude_mesh,
            exclude_prim)
        take = (inst >= 0) & ((kind == PRIMITIVE_NONE) | (it < best_t))
        best_t = torch.where(take, it, best_t)
        idx = torch.where(take, itri, idx)
        kind = torch.where(take, KIND_INSTANCE + inst, kind).to(torch.int32)
        u = torch.where(take, iu, u)
        v = torch.where(take, iv, v)
    nearest = []
    if scene.n_rects:
        nearest.append((PRIMITIVE_RECTANGLE, primitives.rect_nearest(
            origin, direction, t_min, t_max, scene.rects)))
    if scene.n_spheres:
        nearest.append((PRIMITIVE_SPHERE, primitives.sphere_nearest(
            origin, direction, t_min, t_max, scene.spheres,
            scene.sphere_groups)))
    for family, (pt, pi) in nearest:
        take = (pi >= 0) & ((kind == PRIMITIVE_NONE) | (pt <= best_t))
        best_t = torch.where(take, pt, best_t)
        idx = torch.where(take, pi, idx)
        kind = torch.where(take, family, kind).to(torch.int32)
        u = torch.where(take, 0.0, u)
        v = torch.where(take, 0.0, v)
    return best_t, idx, u, v, kind


def hit_record(origin, direction, t, idx, u, v, kind, scene) -> HitRecord:
    """The hit record of each lane's winner of ``trace_merged``: a
    sphere's or rectangle's from its arrays, a triangle's from its
    ``shade_packed`` row, an instance's in world space
    (``traversal.instanced_record``)."""
    from metal_pathtracer_tpu_torch.ops import traversal

    rec = analytic_record(origin, direction, t, idx, kind, scene)
    if scene.n_triangles:
        tri = torch.where(kind == PRIMITIVE_TRIANGLE, idx, -1)
        rec = _closer(rec, traversal._hit_record_from_best(
            origin, direction, scene.triangles, t, tri, u, v))
    if scene.instanced:
        inst = torch.where(kind >= KIND_INSTANCE, kind - KIND_INSTANCE, -1)
        rec = _closer(rec, traversal.instanced_record(
            origin, direction, t, idx, u, v, inst, scene.instanced))
    return rec


def trace_scene(origin, direction, scene, t_min, t_max,
                exclude_mesh=None, exclude_prim=None) -> HitRecord:
    """Nearest-hit record over every primitive family (``trace_merged``)."""
    t, idx, u, v, kind = trace_merged(origin, direction, scene, t_min, t_max,
                                      exclude_mesh, exclude_prim)
    return hit_record(origin, direction, t, idx, u, v, kind, scene)


def trace_occluded(origin, direction, scene, t_min, t_max):
    """Any-hit (shadow) trace over every family: (N,) bool
    (``intersect.trace_occluded:303``). Triangles take K1 any-hit and
    instances K1 instanced any-hit; spheres and rectangles the nearest
    kernels with the same window, any index >= 0 (``shade.py
    _occluded_merged:2758``)."""
    from metal_pathtracer_tpu_torch.ops.kernels import primitives, traverse

    n = origin.shape[0]
    dev = origin.device
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (n,)).contiguous()
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    if scene.n_triangles:
        occ = occ | traverse.trace_any(origin, direction, t_min, t_max,
                                       scene.tri_bvh, scene.triangles)
    if scene.instanced:
        occ = occ | traverse.trace_instanced_any(origin, direction, t_min,
                                                 t_max, scene.instanced)
    if scene.n_spheres:
        occ = occ | (primitives.sphere_nearest(
            origin, direction, t_min, t_max, scene.spheres,
            scene.sphere_groups)[1] >= 0)
    if scene.n_rects:
        occ = occ | (primitives.rect_nearest(
            origin, direction, t_min, t_max, scene.rects)[1] >= 0)
    return occ


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
