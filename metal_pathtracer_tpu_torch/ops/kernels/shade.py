"""K2: one depth of shading per lane, and the depth loop around K1 + K2.

Replaces the TPU fused shade megakernel ``ops/pallas/shade.py``
(``_shade_kernel:1845``, launched by ``_shade_call:2536``) in its stage
``"full"`` for the lambert type set, and ``trace_paths_fused:2915``'s
no-NEE branch (``shade.py:3152-3163``) as the depth loop.

``shade_full`` launches ``csrc/shade.cu`` on CUDA tensors and runs
``shade_full_reference`` on CPU tensors. Both do the same per-lane steps,
in the reference integrator's order (``ops/integrator.py`` body):
hit rebuild from the ``shade_packed`` row, miss -> background + firefly
clamp, material fetch, first-hit AOVs, lambert sampling, throughput clamp,
ray cone, Russian roulette at depth >= 5, next origin, commit. Both update
the ``PathCarry`` tensors in place; lanes that enter dead keep every value.
"""

from __future__ import annotations

import dataclasses

import torch

from metal_pathtracer_tpu import constants as C
from metal_pathtracer_tpu_torch.ops import bsdf as bsdf_ops
from metal_pathtracer_tpu_torch.ops import rng as rng_ops
from metal_pathtracer_tpu_torch.ops.integrator import (
    PathCarry,
    sky_color,
    to_working_space,
)
from metal_pathtracer_tpu_torch.ops.intersect import offset_ray_origin
from metal_pathtracer_tpu_torch.ops.kernels import build
from metal_pathtracer_tpu_torch.ops.kernels.traverse import trace_closest
from metal_pathtracer_tpu_torch.ops.traversal import _hit_record_from_best
from metal_pathtracer_tpu_torch.ops.vecmath import (
    dot,
    fma,
    where3,
)


@dataclasses.dataclass(frozen=True)
class ShadeParams:
    """The launch constants of one shade call."""

    background_mode: int          # 0 gradient / 1 solid
    working_color_space: int      # 0 linear sRGB / 1 ACEScg
    use_russian_roulette: bool
    background_color: tuple       # solid background, linear sRGB
    clamp: bsdf_ops.ClampParams

    @classmethod
    def of(cls, uniforms, static) -> "ShadeParams":
        return cls(background_mode=static.background_mode,
                   working_color_space=static.working_color_space,
                   use_russian_roulette=static.use_russian_roulette,
                   background_color=tuple(uniforms.background_color),
                   clamp=bsdf_ops.make_clamp_params(uniforms))


def _background(ray_d, params: ShadeParams):
    if params.background_mode == 1:
        bg = torch.tensor(params.background_color, device=ray_d.device)
        bg = bg.expand_as(ray_d)
    else:
        bg = sky_color(ray_d)
    return to_working_space(bg, params)


def shade_full_reference(carry: PathCarry, t, tri, u, v, triangles,
                         materials, params: ShadeParams, depth: int):
    """Plain PyTorch K2 (see the module docstring)."""
    alive0 = carry.alive
    hit = tri >= 0
    active = alive0 & hit
    miss = alive0 & ~hit

    # ---- miss: background ------------------------------------------------
    bg = _background(carry.ray_d, params)
    bg_contrib = bsdf_ops.clamp_firefly_contribution(carry.throughput, bg,
                                                     params.clamp)
    radiance = torch.where(miss[:, None], carry.radiance + bg_contrib,
                           carry.radiance)

    # ---- hit rebuild, material, AOVs ---------------------------------------
    rec = _hit_record_from_best(carry.ray_o, carry.ray_d, triangles, t, tri,
                                u, v)
    sn = rec.shading_normal
    bad_sn = ~torch.isfinite(sn).all(-1) | (dot(sn, sn) <= 0.0)
    shading_normal = where3(bad_sn, rec.normal, sn)
    rec = rec.replace(shading_normal=shading_normal)
    m = bsdf_ops.gather_material(materials, rec.material)
    record_aov = active & carry.is_first_hit
    aov_albedo = where3(record_aov, bsdf_ops.material_base_color(m),
                        carry.aov_albedo)
    aov_normal = where3(record_aov, shading_normal, carry.aov_normal)

    # ---- ray cone at the hit -----------------------------------------------
    ray_len = torch.sqrt(torch.clamp_min(dot(carry.ray_d, carry.ray_d),
                                         1e-12))
    hit_world = torch.clamp_min(rec.t, 0.0) * ray_len
    cone_at_hit = torch.clamp_min(
        fma(carry.cone_spread, hit_world, carry.cone_width), 1e-7)

    # ---- BSDF sample -------------------------------------------------------
    nstate, smp = bsdf_ops.sample_bsdf(
        m, shading_normal, carry.state, torch.ones_like(t),
        (C.MATERIAL_LAMBERTIAN,))
    state = torch.where(active, nstate, carry.state)
    active = active & (smp.pdf > 0.0)
    next_origin = offset_ray_origin(rec, smp.direction)

    throughput = bsdf_ops.clamp_path_throughput(
        carry.throughput * smp.weight, params.clamp)
    max_tp = torch.maximum(torch.maximum(throughput[:, 0], throughput[:, 1]),
                           throughput[:, 2])
    active = active & torch.isfinite(throughput).all(-1) & (max_tp > 0.0)

    cone_width = torch.where(active, cone_at_hit, carry.cone_width)
    cone_spread = torch.where(active, torch.clamp_max(
        carry.cone_spread + bsdf_ops.bsdf_cone_spread_increment(
            smp.lobe_type, smp.lobe_roughness, smp.is_delta), 1.5),
        carry.cone_spread)

    # ---- Russian roulette ----------------------------------------------------
    if params.use_russian_roulette and depth >= 5:
        rr_state, xi = rng_ops.rand_uniform(state)
        cont_p = torch.clamp(max_tp, 0.05, 0.95)
        survive = xi <= cont_p
        throughput = torch.where((active & survive)[:, None],
                                 throughput / cont_p[:, None], throughput)
        state = torch.where(active, rr_state, state)
        active = active & survive

    # ---- commit: misses end their path, dead lanes keep everything --------
    h = alive0 & hit
    carry.state.copy_(torch.where(h, state, carry.state))
    carry.ray_o.copy_(where3(h, next_origin, carry.ray_o))
    carry.ray_d.copy_(where3(h, smp.direction, carry.ray_d))
    carry.throughput.copy_(where3(h, throughput, carry.throughput))
    carry.radiance.copy_(radiance)
    carry.prev_valid.copy_(torch.where(alive0, hit, carry.prev_valid))
    carry.prev_mesh.copy_(torch.where(
        alive0, torch.where(hit, rec.mesh_index, -1), carry.prev_mesh))
    carry.prev_prim.copy_(torch.where(
        alive0, torch.where(hit, rec.prim_index, -1), carry.prev_prim))
    carry.is_first_hit.copy_(carry.is_first_hit & ~h)
    carry.aov_albedo.copy_(aov_albedo)
    carry.aov_normal.copy_(aov_normal)
    carry.cone_width.copy_(cone_width)
    carry.cone_spread.copy_(cone_spread)
    carry.alive.copy_(alive0 & active)


_CARRY_DTYPES = {
    "state": torch.int64, "ray_o": torch.float32, "ray_d": torch.float32,
    "throughput": torch.float32, "radiance": torch.float32,
    "alive": torch.bool, "prev_valid": torch.bool, "prev_mesh": torch.int32,
    "prev_prim": torch.int32, "is_first_hit": torch.bool,
    "aov_albedo": torch.float32, "aov_normal": torch.float32,
    "cone_width": torch.float32, "cone_spread": torch.float32,
}


def shade_full(carry: PathCarry, t, tri, u, v, triangles, materials,
               params: ShadeParams, depth: int) -> None:
    """One depth of shading, in place on ``carry``. CPU tensors take the
    plain version; CUDA tensors launch K2."""
    dev = t.device
    if dev.type == "cpu":
        shade_full_reference(carry, t, tri, u, v, triangles, materials,
                             params, depth)
        return
    if dev.type != "cuda":
        raise ValueError(f"shade_full: unsupported device {dev}")
    n = t.shape[0]
    for name, dtype in _CARRY_DTYPES.items():
        x = getattr(carry, name)
        if x.device != dev or x.dtype != dtype or not x.is_contiguous() \
                or x.shape[0] != n:
            raise ValueError(f"shade_full: carry.{name} must be a contiguous "
                             f"{dtype} tensor of {n} lanes on {dev}")
    # lambert reads the base colour: one (M,3) row per material
    mat_table = materials.base_color
    inputs = [t, tri, u, v, triangles.shade_packed, mat_table]
    if any(x.device != dev or not x.is_contiguous() for x in inputs) \
            or tri.dtype != torch.int32:
        raise ValueError("shade_full: hit, triangle and material tensors "
                         f"must be contiguous, on {dev}, with int32 tri ids")
    c = params.clamp
    bg = params.background_color
    lib = build.load()
    p = lambda x: x.data_ptr()
    err = lib.mpt_shade_full(
        n, depth, p(t), p(tri), p(u), p(v),
        p(triangles.shade_packed), p(mat_table), mat_table.shape[0],
        params.background_mode, params.working_color_space,
        int(params.use_russian_roulette), bg[0], bg[1], bg[2],
        c.enabled, c.clamp_factor, c.clamp_floor, c.max_contribution,
        c.throughput_clamp,
        *[p(getattr(carry, name)) for name in _CARRY_DTYPES],
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "mpt_shade_full")
    shade_full.launches += 1


#: K2 launches since the last reset (chip_smoke.py reads and resets it)
shade_full.launches = 0


def trace_paths_fused(scene, uniforms, static, carry: PathCarry) -> int:
    """Depth loop: K1 then K2 until ``max_depth`` or no lane is alive
    (``shade.py:2991-2995``). Syncs once per depth on the alive count,
    which is also that depth's trace count. Returns the traces issued."""
    params = ShadeParams.of(uniforms, static)
    rays = 0
    for depth in range(static.max_depth):
        n_alive = int(carry.alive.sum())
        if n_alive == 0:
            break
        rays += n_alive
        ex_mesh = torch.where(carry.prev_valid, carry.prev_mesh, -1)
        ex_prim = torch.where(carry.prev_valid, carry.prev_prim, -1)
        lane_tmax = torch.where(carry.alive, C.INFINITY_T, 0.0)
        t, tri, u, v = trace_closest(carry.ray_o, carry.ray_d, C.EPSILON_T,
                                     lane_tmax, scene.tri_bvh,
                                     scene.triangles, ex_mesh, ex_prim)
        shade_full(carry, t, tri, u, v, scene.triangles, scene.materials,
                   params, depth)
    return rays
