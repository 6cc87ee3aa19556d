"""K3: nearest analytic sphere and rectangle per ray.

Replace the TPU analytic-primitive kernels of
``ops/pallas/primitives.py``:

- K3a ``_sphere_kernel:37`` (launched by ``_sphere_call:83`` via
  ``sphere_nearest:104``): every sphere against every ray, at most 32
  spheres;
- K3b ``_sphere_kernel_chunked:183`` (``_sphere_call_chunked:271``): more
  than 32 spheres, Morton-ordered into groups of 16 with one AABB per
  group; a group whose box the ray's window misses is skipped;
- K3c ``_rect_kernel:314`` (``_rect_call:349`` via ``rect_nearest:368``):
  every oriented rectangle against every ray.

``sphere_nearest`` and ``rect_nearest`` launch ``csrc/primitives.cu`` on
CUDA tensors (K3a and K3c over one packed record a primitive,
``SpheresSoA.records()`` and ``RectsSoA.records()``, made once per scene)
and run the plain versions below on CPU tensors. Each
returns (t, index): index -1 and t = INFINITY_T on a miss. The function
is the one ``ops/intersect.py hit_spheres``/``hit_rects`` of the JAX
package reduce to: per primitive, the near root of the half-b quadratic
if it lies in [t_min, t_max] else the far one (the rectangle: its plane
hit with |denom| >= 1e-6 and u, v in [0, 1]), then the first primitive
of smallest t. The plain versions:

- ``sphere_nearest_reference`` / ``rect_nearest_reference`` (K3a, K3c):
  the (lanes, primitives) broadcast of the JAX package's XLA functions,
  with the FMAs XLA:CPU places there (``vecmath.dot`` for every 3-term
  sum; the discriminant as ``fma(half_b, half_b, -(a * c))``);
- ``sphere_nearest_chunked_reference`` (K3b): the same roots over the
  Morton-ordered groups in sequence, each group tested only on the lanes
  whose window reaches its box. The box is widened beyond rounding (see
  ``sphere_groups``), so the cull drops no hit and K3b returns K3a's
  answer; only when two spheres meet a ray at the same float t can the
  first one tested (Morton order here, index order in K3a) differ;
- ``sphere_nearest_visits``: the K3b kernel's own schedule (groups near
  first, a window that shrinks to the best t, the lexicographic (t, slot)
  rule), which returns the same bits in any visit order; it gives the
  kernel's group visits and sphere tests, and the tests run it.

Shadow rays use the same functions with their own t_max and test
``index >= 0``.
"""

from __future__ import annotations

import numpy as np
import torch

from metal_pathtracer_tpu_torch.constants import INFINITY_T
from metal_pathtracer_tpu_torch.ops.kernels import build
from metal_pathtracer_tpu_torch.schema import SphereGroups
from metal_pathtracer_tpu_torch.ops.vecmath import dot, fdiv, fma

#: spheres per K3b group, and the most spheres K3a takes (the JAX
#: package's route: more than two groups' worth goes chunked)
SPHERE_GROUP = 16
BRUTE_MAX_SPHERES = 2 * SPHERE_GROUP
#: lanes x primitives per block of the plain broadcast (bounds its memory)
_PLAIN_BLOCK = 1 << 22


def _lane_blocks(n: int, width: int):
    step = max(_PLAIN_BLOCK // max(width, 1), 1)
    return [slice(lo, min(lo + step, n)) for lo in range(0, n, step)]


def _nearest(t, valid):
    """First primitive of smallest valid t per lane: (t, index)."""
    t_masked = torch.where(valid, t, INFINITY_T)
    best = torch.argmin(t_masked, -1, keepdim=True)
    hit = valid.any(-1)
    t_best = t_masked.gather(-1, best)[:, 0]
    return (torch.where(hit, t_best, INFINITY_T),
            torch.where(hit, best[:, 0].to(torch.int32), -1))


def sphere_roots(origin, direction, center, radius, t_min, t_max):
    """(lanes, spheres) candidate t and validity (``hit_spheres``'
    quadratic: near root, else far root, inside [t_min, t_max]). The
    spheres are shared, ``center`` (S, 3), or per lane, (lanes, S, 3)."""
    oc = origin[:, None, :] - (center if center.dim() == 3 else center[None])
    a = dot(direction, direction)[:, None]
    half_b = dot(oc, direction[:, None, :])
    c = dot(oc, oc) - radius * radius
    disc = fma(half_b, half_b, -(a * c))
    sqrt_d = torch.sqrt(torch.clamp_min(disc, 0.0))
    t_near = fdiv(-half_b - sqrt_d, a)
    t_far = fdiv(-half_b + sqrt_d, a)
    tmax = t_max[:, None]
    near_ok = (t_near >= t_min) & (t_near <= tmax)
    far_ok = (t_far >= t_min) & (t_far <= tmax)
    return (torch.where(near_ok, t_near, t_far),
            (disc >= 0.0) & (near_ok | far_ok))


def sphere_nearest_reference(origin, direction, t_min, t_max, spheres):
    """Plain K3a: the (lanes, spheres) broadcast and its first minimum."""
    n = origin.shape[0]
    out_t = torch.full((n,), INFINITY_T, device=origin.device)
    out_i = torch.full((n,), -1, dtype=torch.int32, device=origin.device)
    for sl in _lane_blocks(n, spheres.count):
        t, valid = sphere_roots(origin[sl], direction[sl], spheres.center,
                                spheres.radius, t_min, t_max[sl])
        out_t[sl], out_i[sl] = _nearest(t, valid)
    return out_t, out_i


def rect_nearest_reference(origin, direction, t_min, t_max, rects):
    """Plain K3c: the (lanes, rectangles) broadcast of ``hit_rects``."""
    n = origin.shape[0]
    out_t = torch.full((n,), INFINITY_T, device=origin.device)
    out_i = torch.full((n,), -1, dtype=torch.int32, device=origin.device)
    for sl in _lane_blocks(n, rects.count):
        o, d = origin[sl][:, None, :], direction[sl][:, None, :]
        denom = dot(d, rects.normal)
        t = fdiv(rects.plane - dot(o, rects.normal), denom)
        rel = fma(t[..., None], d, o) - rects.corner
        u = dot(rel, rects.edge_u) * rects.inv_len2_u
        v = dot(rel, rects.edge_v) * rects.inv_len2_v
        valid = ((denom.abs() >= 1e-6) & (t >= t_min)
                 & (t <= t_max[sl][:, None]) & (u >= 0.0) & (u <= 1.0)
                 & (v >= 0.0) & (v <= 1.0))
        out_t[sl], out_i[sl] = _nearest(t, valid)
    return out_t, out_i


def morton_order(centers: np.ndarray) -> np.ndarray:
    """Morton order of the centres on a 10-bit grid (the JAX package's
    ``_morton_order:300``, in numpy)."""
    c = np.asarray(centers, np.float32)
    lo, hi = c.min(0), c.max(0)
    q = (c - lo) / np.maximum(hi - lo, np.float32(1e-9)) * np.float32(1023.0)
    q = np.clip(q, 0.0, 1023.0).astype(np.uint32)
    key = np.zeros(len(c), np.uint32)
    for b in range(10):
        for axis in range(3):
            key |= ((q[:, axis] >> b) & 1) << (3 * b + axis)
    return np.argsort(key, kind="stable")


def _outward_f32(x: np.ndarray, direction: float) -> np.ndarray:
    """float64 -> float32, rounded away from the box's inside."""
    y = x.astype(np.float32)
    off = (y > x) if direction < 0 else (y < x)
    return np.where(off, np.nextafter(y, np.float32(direction * np.inf)), y)


def sphere_groups(spheres) -> SphereGroups:
    """Build the K3b layout on the host (``primitives.py:136-162``), once
    per scene (``SceneArrays.sphere_groups``), the spheres in their Morton
    order. Each box is the group's spheres' box widened by 1e-3 x (1 + its
    largest coordinate magnitude), then rounded outward to float32: a
    quadratic that grazes a sphere can report a hit a little outside it
    (about eps |o - c|^2 / r), and the slab test rounds too, so an exact
    box could drop a hit that K3a keeps."""
    center = spheres.center.detach().cpu().numpy()
    radius = spheres.radius.detach().cpu().numpy()
    s = len(radius)
    order = morton_order(center)
    n_groups = (s + SPHERE_GROUP - 1) // SPHERE_GROUP
    rep = order[np.minimum(np.arange(n_groups * SPHERE_GROUP), s - 1)]
    c64 = center[rep].astype(np.float64).reshape(n_groups, SPHERE_GROUP, 3)
    r64 = radius[rep].astype(np.float64).reshape(n_groups, SPHERE_GROUP, 1)
    lo = (c64 - r64).min(1)
    hi = (c64 + r64).max(1)
    pad = 1e-3 * (1.0 + np.maximum(np.abs(lo), np.abs(hi)).max(1,
                                                                 keepdims=True))
    dev = spheres.center.device
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return SphereGroups(
        center=t(center[rep]), radius=t(radius[rep]),
        index=t(rep.astype(np.int32)),
        box_min=t(_outward_f32(lo - pad, -1.0)),
        box_max=t(_outward_f32(hi + pad, 1.0)))


def groups_of(spheres):
    """The K3b layout of a scene's spheres, None at 32 spheres or fewer
    (K3a's route)."""
    if spheres.count <= BRUTE_MAX_SPHERES:
        return None
    return sphere_groups(spheres)


def slab_inverse(direction):
    """1/d with |d| < 1e-20 replaced by +-1e-20 (``traverse.py``'s)."""
    return fdiv(1.0, torch.where(direction.abs() < 1e-20,
                                 torch.where(direction >= 0, 1e-20, -1e-20),
                                 direction))


def group_entry(origin, inv_dir, t_min, t_max, box_min, box_max):
    """Per lane, the slab interval (tnear, tfar) of ``[t_min, t_max]``
    against one box."""
    t0 = (box_min - origin) * inv_dir
    t1 = (box_max - origin) * inv_dir
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tnear = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]),
                          torch.clamp_min(lo[:, 2], t_min))
    tfar = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]),
                         torch.minimum(hi[:, 2], t_max))
    return tnear, tfar


def group_passes(origin, inv_dir, t_min, t_max, box_min, box_max):
    """Per lane, whether [t_min, t_max] meets the box (the TPU kernel's
    slab margin ``tfar - tnear >= 0``, per ray instead of per packet)."""
    tnear, tfar = group_entry(origin, inv_dir, t_min, t_max, box_min,
                              box_max)
    return tfar >= tnear


def sphere_nearest_chunked_reference(origin, direction, t_min, t_max,
                                     groups: SphereGroups, stats=None):
    """Plain K3b: the groups in Morton order, one after another; a lane
    tests a group's 16 spheres only where its window meets the group box
    and takes a sphere only if it is strictly nearer than its best so far.
    ``stats``, a dict, receives ``group_tests`` (lane x group boxes that
    passed) for the bound."""
    n = origin.shape[0]
    best_t = torch.full((n,), INFINITY_T, device=origin.device)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=origin.device)
    inv = slab_inverse(direction)
    passed = 0
    for g in range(groups.n_groups):
        sl = slice(g * SPHERE_GROUP, (g + 1) * SPHERE_GROUP)
        ok = group_passes(origin, inv, t_min, t_max, groups.box_min[g],
                          groups.box_max[g])
        passed += int(ok.sum())
        t, valid = sphere_roots(origin, direction, groups.center[sl],
                                groups.radius[sl], t_min, t_max)
        tg, k = _nearest(t, valid & ok[:, None])
        take = (k >= 0) & ((best_i < 0) | (tg < best_t))
        best_t = torch.where(take, tg, best_t)
        best_i = torch.where(take, groups.index[sl][k.clamp_min(0).long()],
                             best_i)
    if stats is not None:
        stats["group_tests"] = passed
    return best_t, best_i


def sphere_nearest_visits(origin, direction, t_min, t_max,
                          groups: SphereGroups, stats=None):
    """The K3b kernel's schedule in plain PyTorch (``csrc/primitives.cu
    sphere_nearest_chunked_kernel``), for its counts and for the tests:
    every box slab-tested once against [t_min, t_max]; then, until none is
    pending, the pending group of least entry tnear (the lowest group on a
    tie) is tested, 16 spheres, and groups whose tnear exceeds the window
    [t_min, w] are dropped, w the best t so far (t_max before a hit). A
    candidate is taken when (t, slot) is lexicographically below the best.
    Returns (t, index) like ``sphere_nearest_chunked_reference``;
    ``stats``, a dict, receives ``group_visits`` (lane x group visits) and
    ``sphere_tests`` (16 a visit)."""
    n, n_groups = origin.shape[0], groups.n_groups
    dev = origin.device
    inv = slab_inverse(direction)
    entry = torch.empty((n, n_groups), device=dev)
    pending = torch.empty((n, n_groups), dtype=torch.bool, device=dev)
    for g in range(n_groups):
        tnear, tfar = group_entry(origin, inv, t_min, t_max,
                                  groups.box_min[g], groups.box_max[g])
        entry[:, g], pending[:, g] = tnear, tfar >= tnear
    pending &= (t_max >= t_min)[:, None]
    center = groups.center.view(n_groups, SPHERE_GROUP, 3)
    radius = groups.radius.view(n_groups, SPHERE_GROUP)
    lanes = torch.arange(n, device=dev)
    best_t = torch.full((n,), INFINITY_T, device=dev)
    best_s = torch.full((n,), -1, dtype=torch.int64, device=dev)
    visits = 0
    while True:
        w = torch.where(best_s >= 0, best_t, t_max)
        pending &= entry <= w[:, None]
        go = pending.any(1)
        if not bool(go.any()):
            break
        visits += int(go.sum())
        g = torch.argmin(torch.where(pending, entry, float("inf")), 1)
        pending[lanes, g] = False
        t, valid = sphere_roots(origin, direction, center[g], radius[g],
                                t_min, t_max)
        valid &= go[:, None]
        tg, j = _nearest(t, valid)
        slot = g * SPHERE_GROUP + j.long()
        take = (j >= 0) & ((best_s < 0) | (tg < best_t)
                           | ((tg == best_t) & (slot < best_s)))
        best_t = torch.where(take, tg, best_t)
        best_s = torch.where(take, slot, best_s)
    if stats is not None:
        stats["group_visits"] = visits
        stats["sphere_tests"] = visits * SPHERE_GROUP
    return (torch.where(best_s >= 0, best_t, INFINITY_T),
            torch.where(best_s >= 0,
                        groups.index[best_s.clamp_min(0)], -1).to(torch.int32))


def _check(name, tensors, dev):
    for x in tensors:
        if x.device != dev or not x.is_contiguous() \
                or x.dtype not in (torch.float32, torch.int32):
            raise ValueError(f"{name}: every tensor must be a contiguous "
                             f"float32/int32 tensor on {dev}")


def _launch(name, origin, direction, t_min, t_max, prim_args, count,
            listed=False):
    """Check, then launch ``mpt_<name>``; ``listed``: the kernel also takes
    its live-lane list's scratch (K3b). K3a and K3c read their one record
    argument with 16-byte loads."""
    n = origin.shape[0]
    dev = origin.device
    _check(name, [origin, direction, t_max, *prim_args], dev)
    if not listed:
        build.check_aligned(name, prim_args, 16)
    out_t = torch.empty(n, dtype=torch.float32, device=dev)
    out_i = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = build.list_scratch(n, dev) if listed else None
    p = lambda x: x.data_ptr()
    err = getattr(build.load(), f"mpt_{name}")(
        n, p(origin), p(direction), float(t_min), p(t_max),
        *[p(x) for x in prim_args], count, p(out_t), p(out_i),
        *([p(scratch)] if listed else []),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, f"mpt_{name}")
    return out_t, out_i


def _prepare(origin, t_max):
    n = origin.shape[0]
    return torch.broadcast_to(torch.as_tensor(
        t_max, dtype=torch.float32, device=origin.device), (n,)).contiguous()


def sphere_nearest(origin, direction, t_min: float, t_max, spheres,
                   groups=None):
    """Nearest sphere per ray, (t, index), by the JAX package's route:
    K3b over ``groups`` (the scene's ``sphere_groups``) above 32 spheres,
    K3a otherwise."""
    if spheres.count > BRUTE_MAX_SPHERES:
        if groups is None:
            raise ValueError("sphere_nearest: more than 32 spheres need "
                             "their K3b layout (SceneArrays.sphere_groups)")
        return sphere_nearest_chunked(origin, direction, t_min, t_max,
                                      groups)
    return sphere_nearest_brute(origin, direction, t_min, t_max, spheres)


def sphere_nearest_brute(origin, direction, t_min: float, t_max, spheres):
    """K3a: every sphere against every ray (any sphere count up to the
    scene cap of 512). CPU tensors take the plain version; CUDA tensors
    launch the kernel over ``spheres.records()``."""
    t_max = _prepare(origin, t_max)
    dev = origin.device
    if dev.type == "cpu":
        return sphere_nearest_reference(origin, direction, t_min, t_max,
                                        spheres)
    if dev.type != "cuda":
        raise ValueError(f"sphere_nearest_brute: unsupported device {dev}")
    out = _launch("sphere_nearest", origin, direction, t_min, t_max,
                  [spheres.records()], spheres.count)
    sphere_nearest_brute.launches += 1
    return out


def sphere_nearest_chunked(origin, direction, t_min: float, t_max,
                           groups: SphereGroups):
    """K3b over the Morton groups ``groups`` (``sphere_groups``). CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    t_max = _prepare(origin, t_max)
    dev = origin.device
    if dev.type == "cpu":
        return sphere_nearest_chunked_reference(origin, direction, t_min,
                                                t_max, groups)
    if dev.type != "cuda":
        raise ValueError(f"sphere_nearest_chunked: unsupported device {dev}")
    out = _launch("sphere_nearest_chunked", origin, direction, t_min, t_max,
                  [groups.center, groups.radius, groups.index,
                   groups.box_min, groups.box_max], groups.n_groups,
                  listed=True)
    sphere_nearest_chunked.launches += 1
    return out


#: K3a and K3b launches since the last reset
sphere_nearest_brute.launches = 0
sphere_nearest_chunked.launches = 0


def rect_nearest(origin, direction, t_min: float, t_max, rects):
    """Nearest rectangle per ray: (t, index). CPU tensors take the plain
    version; CUDA tensors launch K3c over ``rects.records()``."""
    t_max = _prepare(origin, t_max)
    dev = origin.device
    if dev.type == "cpu":
        return rect_nearest_reference(origin, direction, t_min, t_max, rects)
    if dev.type != "cuda":
        raise ValueError(f"rect_nearest: unsupported device {dev}")
    out = _launch("rect_nearest", origin, direction, t_min, t_max,
                  [rects.records()], rects.count)
    rect_nearest.launches += 1
    return out


#: K3c launches since the last reset
rect_nearest.launches = 0
