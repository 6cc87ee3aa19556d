"""K2: one depth of shading per lane, and the depth loops around K1 + K2.

Replaces the TPU fused shade megakernel ``ops/pallas/shade.py``
(``_shade_kernel:1845``, launched by ``_shade_call:2536``) in three
stages, each launching ``csrc/shade.cu`` on CUDA tensors and running its
plain version on CPU tensors; all update the ``PathCarry`` tensors in
place, and lanes that enter dead keep every value:

- ``shade_full`` (lambert, no NEE): hit rebuild from the ``shade_packed``
  row, miss -> background + firefly clamp, material fetch, first-hit AOVs,
  lambert sampling, throughput clamp, ray cone, Russian roulette at depth
  >= 5, next origin, commit (the integrator body's order);
- ``shade_s1`` (environment NEE, lambert/dielectric/PBR): misses add the
  environment with MIS and end; hits get Beer-Lambert absorption from the
  top of the medium stack, the dielectric geometric normal, first-hit
  AOVs, the PBR emissive add and the three NEE draws, and export 18
  transient columns (``TRANS``);
- ``shade_s2``: the NEE add with MIS from the alias sample and the shadow
  trace (``ESMP``), BSDF sampling from the post-s1 state, the spec-NEE
  chain exports (``CHAIN``), medium push/pop, next origin, throughput
  clamp, environment LOD, ray cone, Russian roulette and the commit.

In a textured scene s1 and s2 also read the texture stage's 15 ``TEX``
planes (``ops/kernels/texture.py``; ``shade.py:2027-2059``): lanes whose
``tpbr`` flag is set take the textured base colour, roughness, metallic,
transmission, emission and occlusion (s1 also the mapped normal), and
alpha pass-through lanes record no AOV, add no emission, draw no NEE or
BSDF sample and continue along their ray as a delta bounce of weight 1
(``shade.py:2123-2139, 2188, 2306-2331``).

The depth loops are ``trace_paths_fused:2915``'s no-NEE branch
(``shade.py:3152-3163``) and its NEE branch (``shade.py:3165-3351``).
"""

from __future__ import annotations

import dataclasses

import torch

from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops import bsdf as bsdf_ops
from metal_pathtracer_tpu_torch.ops import env as env_ops
from metal_pathtracer_tpu_torch.ops import rng as rng_ops
from metal_pathtracer_tpu_torch.ops import specnee
from metal_pathtracer_tpu_torch.ops.integrator import (
    PathCarry,
    sky_color,
    to_working_space,
)
from metal_pathtracer_tpu_torch.ops.intersect import (
    offset_origin,
    offset_ray_origin,
    trace_occluded,
)
from metal_pathtracer_tpu_torch.ops.kernels import build
from metal_pathtracer_tpu_torch.ops.kernels.texture import (
    TEX_IDX,
    has_textures,
    texture_stage,
)
from metal_pathtracer_tpu_torch.ops.kernels.traverse import trace_closest
from metal_pathtracer_tpu_torch.ops.traversal import _hit_record_from_best
from metal_pathtracer_tpu_torch.ops.vecmath import (
    dot,
    fdiv,
    fma,
    normalize,
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
    incident = normalize(carry.ray_d)
    nstate, smp = bsdf_ops.sample_bsdf(
        m, shading_normal, -incident, incident, rec.front_face, carry.state,
        params.clamp, torch.ones_like(t), (C.MATERIAL_LAMBERTIAN,))
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


#: every PathCarry field and its dtype, in the order the kernels take them;
#: ``shade_full`` takes the first fourteen
_CARRY_DTYPES = {
    "state": torch.int64, "ray_o": torch.float32, "ray_d": torch.float32,
    "throughput": torch.float32, "radiance": torch.float32,
    "alive": torch.bool, "prev_valid": torch.bool, "prev_mesh": torch.int32,
    "prev_prim": torch.int32, "is_first_hit": torch.bool,
    "aov_albedo": torch.float32, "aov_normal": torch.float32,
    "cone_width": torch.float32, "cone_spread": torch.float32,
    "last_pdf": torch.float32, "last_delta": torch.bool,
    "medium_stack": torch.float32, "medium_depth": torch.int32,
    "specular_depth": torch.int32, "env_lod": torch.float32,
    "env_lod_active": torch.bool,
}
_FULL_FIELDS = list(_CARRY_DTYPES)[:14]


def _carry_pointers(carry: PathCarry, names, n: int, dev, who: str):
    """Device pointers of the named carry tensors, after checking each is
    a contiguous tensor of the kernel's dtype with ``n`` lanes on ``dev``."""
    ptrs = []
    for name in names:
        x = getattr(carry, name)
        dtype = _CARRY_DTYPES[name]
        if x.device != dev or x.dtype != dtype or not x.is_contiguous() \
                or x.shape[0] != n:
            raise ValueError(f"{who}: carry.{name} must be a contiguous "
                             f"{dtype} tensor of {n} lanes on {dev}")
        ptrs.append(x.data_ptr())
    return ptrs


def _check_inputs(tensors, dev, who: str, tri):
    if any(x.device != dev or not x.is_contiguous() for x in tensors) \
            or tri.dtype != torch.int32:
        raise ValueError(f"{who}: hit, triangle and material tensors must be "
                         f"contiguous, on {dev}, with int32 tri ids")


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
    ptrs = _carry_pointers(carry, _FULL_FIELDS, n, dev, "shade_full")
    # lambert reads the base colour: one (M,3) row per material
    mat_table = materials.base_color
    _check_inputs([t, tri, u, v, triangles.shade_packed, mat_table], dev,
                  "shade_full", tri)
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
        c.throughput_clamp, *ptrs,
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


# ---------------------------------------------------------------------------
# Environment NEE: stages s1 and s2
# ---------------------------------------------------------------------------

#: transient columns s1 -> s2 (``shade.py:1795``); u4-u6 carry the second
#: light integral's draws when rect and environment NEE run together, which
#: this port does not have yet, so they stay 0
TRANS = ["u1", "u2", "u3", "lrough", "snx", "sny", "snz",
         "nfx", "nfy", "nfz", "px", "py", "pz", "active", "delta",
         "u4", "u5", "u6"]
TRANS_IDX = {n: i for i, n in enumerate(TRANS)}

#: NEE sample and occlusion columns, alias stage + shadow trace -> s2
ESMP = ["edx", "edy", "edz", "err", "erg", "erb", "epdf", "evalid", "occl"]

#: spec-NEE chain exports, s2 -> the chain estimator
CHAIN = ["wr", "wg", "wb", "dpdf", "medev", "active", "front"]
CHAIN_IDX = {n: i for i, n in enumerate(CHAIN)}

#: material table columns the s1/s2 kernels read (``pack_material_table:292``
#: cut to lambert, dielectric and PBR)
MAT_COLS = ["mat_type", "base_r", "base_g", "base_b", "roughness", "eta",
            "thin", "em_r", "em_g", "em_b", "sa_r", "sa_g", "sa_b",
            "pbr_metallic", "pbr_transmission", "pbr_thickness",
            "pbr_double_sided"]


def pack_material_table(materials) -> torch.Tensor:
    """(M, 17) f32 table in ``MAT_COLS`` order."""
    cols = [materials.mat_type.to(torch.float32),
            *materials.base_color.unbind(-1), materials.roughness,
            materials.eta, materials.thin, *materials.emission.unbind(-1),
            *materials.dielectric_sigma_a.unbind(-1), materials.pbr_metallic,
            materials.pbr_transmission, materials.pbr_thickness,
            materials.pbr_double_sided]
    return torch.stack(cols, 1).contiguous()


@dataclasses.dataclass(frozen=True)
class NeeParams:
    """The launch constants of the s1/s2 stages."""

    use_russian_roulette: bool
    specular_mis: bool      # MIS on misses after delta bounces too
    env_max_mip: float      # mip levels below mip0; 0 turns the LOD off
    material_types: tuple
    clamp: bsdf_ops.ClampParams
    working_color_space: int      # 0 linear sRGB / 1 ACEScg

    @classmethod
    def of(cls, uniforms, static, env) -> "NeeParams":
        return cls(use_russian_roulette=static.use_russian_roulette,
                   specular_mis=static.enable_specular_nee
                   or static.enable_mnee,
                   env_max_mip=env_ops.max_mip(env),
                   material_types=tuple(static.material_types),
                   clamp=bsdf_ops.make_clamp_params(uniforms),
                   working_color_space=static.working_color_space)

    def scalars(self, depth: int):
        """The float vector the kernels unpack (``NeeScalars`` in
        ``csrc/shade.cu``)."""
        c = self.clamp
        return [float(depth), c.clamp_factor, c.clamp_floor,
                c.throughput_clamp, c.specular_tail_base,
                c.specular_tail_roughness_scale, c.min_specular_pdf,
                c.max_contribution, c.enabled,
                float(self.use_russian_roulette), float(self.specular_mis),
                self.env_max_mip, float(self.working_color_space)]


def _mis_weight(pdf_a, pdf_b):
    """The power-free balance heuristic of the integrator:
    a / max(a + b, 1e-30) clamped to [MIS_MIN, MIS_MAX], and the sum."""
    denom = pdf_a + pdf_b
    return torch.clamp(fdiv(pdf_a, torch.clamp_min(denom, 1e-30)),
                       C.MIS_WEIGHT_CLAMP_MIN, C.MIS_WEIGHT_CLAMP_MAX), denom


def _textured(m, tex, params: NeeParams):
    """The texture planes' overrides (``shade.py:2027-2052``): (material
    lanes, PBR emission, diffuse occlusion, pass-through, tpbr). Without
    planes: the material's own values and emission, no occlusion, no
    pass-through."""
    ones = torch.ones_like(m.roughness)
    if tex is None:
        return m, m.emission, ones, torch.zeros_like(ones, dtype=torch.bool), \
            None
    tv = tex[:, TEX_IDX["tpbr"]] > 0.5
    col = lambda name: tex[:, TEX_IDX[name]]
    m_tex = dataclasses.replace(
        m, base_color=where3(tv, tex[:, 0:3], m.base_color),
        roughness=torch.where(tv, col("trough"), m.roughness),
        pbr_metallic=torch.where(tv, col("tmetal"), m.pbr_metallic),
        pbr_transmission=torch.where(tv, col("ttrans"), m.pbr_transmission))
    emissive = where3(tv, tex[:, 5:8], to_working_space(m.emission, params))
    occlusion = torch.where(tv, col("tocc"), ones)
    return m_tex, emissive, occlusion, tv & (col("tpass") > 0.5), tv


def shade_s1_reference(carry: PathCarry, t, tri, u, v, triangles, materials,
                       envbg, envpdf, params: NeeParams, depth: int,
                       tex=None):
    """Plain PyTorch K2 stage s1 (``_shade_kernel`` stage "s1",
    integrator body :280-460), reading the texture planes ``tex`` when
    given. Updates ``carry`` in place and returns the (N,18)
    transients."""
    del depth
    n = t.shape[0]
    alive0 = carry.alive
    hit = tri >= 0
    active = alive0 & hit
    miss = alive0 & ~hit

    # ---- miss: environment with MIS against the alias pdf ----------------
    w, denom = _mis_weight(carry.last_pdf, envpdf)
    use_mis = (~carry.last_delta | params.specular_mis) & (denom > 0.0)
    mis = torch.where(use_mis, w, 1.0)
    bg_contrib = bsdf_ops.clamp_firefly_contribution(
        carry.throughput, envbg * mis[:, None], params.clamp)
    radiance = where3(miss, carry.radiance + bg_contrib, carry.radiance)

    # ---- hit rebuild, absorption, material -------------------------------
    rec = _hit_record_from_best(carry.ray_o, carry.ray_d, triangles, t, tri,
                                u, v)
    sn = rec.shading_normal
    bad_sn = ~torch.isfinite(sn).all(-1) | (dot(sn, sn) <= 0.0)
    shading_normal = where3(bad_sn, rec.normal, sn)
    m, pbr_emissive, _, passthrough, tv = _textured(
        bsdf_ops.gather_material(materials, rec.material), tex, params)
    if tv is not None:
        shading_normal = where3(tv, tex[:, 10:13], shading_normal)

    top = torch.clamp(carry.medium_depth - 1, 0, C.MAX_MEDIUM_STACK - 1)
    sigma = carry.medium_stack[torch.arange(n, device=t.device), top.long()]
    att = torch.exp(-sigma * torch.clamp_min(t, 0.0)[:, None])
    absorb = active & (carry.medium_depth > 0) & (sigma > 0.0).any(-1)
    throughput = where3(absorb, carry.throughput * att, carry.throughput)

    shading_normal = where3(m.mat_type == C.MATERIAL_DIELECTRIC, rec.normal,
                            shading_normal)
    two_sided = (m.mat_type == C.MATERIAL_PBR) & (m.pbr_double_sided > 0.5)
    surface_is_delta = bsdf_ops.material_is_delta(m)

    # ---- first-hit AOVs, PBR emission ------------------------------------
    shaded = active & ~passthrough
    record_aov = shaded & carry.is_first_hit
    aov_albedo = where3(record_aov, bsdf_ops.material_base_color(m),
                        carry.aov_albedo)
    aov_normal = where3(record_aov, shading_normal, carry.aov_normal)
    pbr_emit = (shaded & (m.mat_type == C.MATERIAL_PBR)
                & (pbr_emissive != 0.0).any(-1)
                & (rec.front_face | two_sided))
    radiance = radiance + where3(
        pbr_emit, bsdf_ops.clamp_firefly_contribution(
            throughput, pbr_emissive, params.clamp),
        torch.zeros_like(radiance))

    # ---- the NEE draws: taken on NEE lanes only --------------------------
    nee_lanes = shaded & ~surface_is_delta
    s_env, u1 = rng_ops.rand_uniform(carry.state)
    s_env, u2 = rng_ops.rand_uniform(s_env)
    s_env, u3 = rng_ops.rand_uniform(s_env)

    carry.state.copy_(torch.where(nee_lanes, s_env, carry.state))
    carry.radiance.copy_(radiance)
    carry.throughput.copy_(where3(active, throughput, carry.throughput))
    carry.aov_albedo.copy_(aov_albedo)
    carry.aov_normal.copy_(aov_normal)
    carry.is_first_hit.copy_(carry.is_first_hit & ~shaded)
    # misses end their path here; s2 then sees only live hits
    carry.prev_valid.copy_(carry.prev_valid & ~miss)
    carry.prev_mesh.copy_(torch.where(miss, -1, carry.prev_mesh))
    carry.prev_prim.copy_(torch.where(miss, -1, carry.prev_prim))
    carry.alive.copy_(active)

    zero = torch.zeros_like(u1)
    trans = torch.stack(
        [u1, u2, u3, bsdf_ops.environment_lighting_roughness(m),
         *shading_normal.unbind(-1), *rec.normal.unbind(-1),
         *rec.point.unbind(-1), active.to(torch.float32),
         surface_is_delta.to(torch.float32), zero, zero, zero], -1)
    return where3(active, trans, torch.zeros_like(trans))


def shade_s2_reference(carry: PathCarry, t, tri, u, v, triangles, materials,
                       trans, esmp, params: NeeParams, depth: int, tex=None):
    """Plain PyTorch K2 stage s2 (``_shade_kernel`` stage "s2",
    integrator body :497-716), reading the texture planes ``tex`` when
    given. Updates ``carry`` in place and returns the (N,7) chain
    exports."""
    n = t.shape[0]
    alive0 = carry.alive.clone()    # after s1: the live hits
    active = alive0
    sn = trans[:, 4:7]
    n_faced = trans[:, 7:10]
    point = trans[:, 10:13]
    rec = _hit_record_from_best(carry.ray_o, carry.ray_d, triangles, t, tri,
                                u, v)
    m, _, occlusion, passthrough, _ = _textured(
        bsdf_ops.gather_material(materials, rec.material), tex, params)
    incident = normalize(carry.ray_d)
    wo = -incident
    throughput = carry.throughput

    # ---- NEE add: alias sample + shadow trace, MIS against the BSDF -------
    nee_lanes = active & (trans[:, TRANS_IDX["delta"]] < 0.5) & ~passthrough
    e_dir, e_rad, e_pdf = esmp[:, 0:3], esmp[:, 3:6], esmp[:, 6]
    e_valid, occluded = esmp[:, 7] > 0.5, esmp[:, 8] > 0.5
    n_dot_l = torch.clamp_min(dot(sn, e_dir), 0.0)
    do_shadow = nee_lanes & e_valid & (e_pdf > 0.0) & (n_dot_l > 0.0)
    ev = bsdf_ops.evaluate_bsdf(m, sn, wo, e_dir, params.clamp, occlusion,
                                params.material_types)
    max_comp = torch.maximum(torch.maximum(ev.value[:, 0], ev.value[:, 1]),
                             ev.value[:, 2])
    w, _ = _mis_weight(e_pdf, ev.pdf)
    w = torch.where(ev.pdf > 0.0, w, 1.0)
    contribution = e_rad * ev.value * n_dot_l[:, None] \
        * fdiv(w, torch.clamp_min(e_pdf, 1e-30))[:, None]
    add = (do_shadow & ~occluded & ~ev.is_delta & (max_comp > 0.0)
           & torch.isfinite(contribution).all(-1))
    radiance = carry.radiance + where3(
        add, bsdf_ops.clamp_firefly_contribution(throughput, contribution,
                                                 params.clamp),
        torch.zeros_like(contribution))

    # ---- BSDF sample from the post-s1 state ------------------------------
    nstate, smp = bsdf_ops.sample_bsdf(
        m, sn, wo, incident, rec.front_face, carry.state, params.clamp,
        occlusion, params.material_types)
    state = torch.where(active & ~passthrough, nstate, carry.state)
    # alpha pass-through: a delta bounce along the same ray, weight 1
    ones = torch.ones_like(t)
    through = bsdf_ops.BsdfSample.invalid(t.shape, t.device).replace(
        direction=carry.ray_d, weight=torch.ones_like(carry.ray_d), pdf=ones,
        directional_pdf=ones, is_delta=torch.ones_like(passthrough))
    smp = bsdf_ops.select_sample(passthrough, through, smp)
    active = active & (smp.pdf > 0.0)
    chain = torch.stack([*smp.weight.unbind(-1), smp.directional_pdf,
                         smp.medium_event.to(torch.float32),
                         (active & ~passthrough).to(torch.float32),
                         rec.front_face.to(torch.float32)], -1)

    # ---- medium stack push/pop (8 slots, clamped) ------------------------
    push = active & (smp.medium_event == 1)
    pop = active & (smp.medium_event == -1)
    slot = torch.clamp(carry.medium_depth, 0, C.MAX_MEDIUM_STACK - 1).long()
    lanes = torch.arange(n, device=t.device)
    stack = carry.medium_stack.clone()
    stack[lanes, slot] = where3(push, torch.clamp_min(m.dielectric_sigma_a,
                                                      0.0),
                                stack[lanes, slot])
    medium_depth = torch.where(
        push, torch.clamp_max(carry.medium_depth + 1, C.MAX_MEDIUM_STACK),
        carry.medium_depth)
    medium_depth = torch.where(pop, torch.clamp_min(medium_depth - 1, 0),
                               medium_depth)

    next_origin = offset_origin(point, sn, n_faced, t, smp.direction)

    # ---- throughput, environment LOD, ray cone ---------------------------
    throughput = bsdf_ops.clamp_path_throughput(throughput * smp.weight,
                                                params.clamp)
    max_tp = torch.maximum(torch.maximum(throughput[:, 0], throughput[:, 1]),
                           throughput[:, 2])
    active = active & torch.isfinite(throughput).all(-1) & (max_tp > 0.0)
    lod_lane = active & (smp.lobe_type == 1) & ~smp.is_delta
    if params.env_max_mip > 0.0:
        mm = params.env_max_mip
        alpha = torch.clamp(smp.lobe_roughness, 0.0, 1.0)
        env_lod = torch.where(lod_lane,
                              torch.clamp(alpha * alpha * mm, 0.0, mm), 0.0)
    else:
        env_lod = torch.zeros_like(t)
        lod_lane = torch.zeros_like(lod_lane)
    ray_len = torch.sqrt(torch.clamp_min(dot(carry.ray_d, carry.ray_d),
                                         1e-12))
    cone_at_hit = torch.clamp_min(
        fma(carry.cone_spread, torch.clamp_min(t, 0.0) * ray_len,
            carry.cone_width), 1e-7)
    cone_width = torch.where(active, cone_at_hit, carry.cone_width)
    cone_spread = torch.where(active, torch.clamp_max(
        carry.cone_spread + bsdf_ops.bsdf_cone_spread_increment(
            smp.lobe_type, smp.lobe_roughness, smp.is_delta), 1.5),
        carry.cone_spread)
    last_pdf = torch.where(smp.directional_pdf > 0.0, smp.directional_pdf,
                           smp.pdf)

    # ---- Russian roulette ------------------------------------------------
    if params.use_russian_roulette and depth >= 5:
        rr_state, xi = rng_ops.rand_uniform(state)
        cont_p = torch.clamp(max_tp, 0.05, 0.95)
        survive = xi <= cont_p
        throughput = where3(active & survive, throughput / cont_p[:, None],
                            throughput)
        state = torch.where(active, rr_state, state)
        active = active & survive

    # ---- commit: the live hits only --------------------------------------
    h = alive0
    carry.state.copy_(torch.where(h, state, carry.state))
    carry.ray_o.copy_(where3(h, next_origin, carry.ray_o))
    carry.ray_d.copy_(where3(h, smp.direction, carry.ray_d))
    carry.throughput.copy_(where3(h, throughput, carry.throughput))
    carry.radiance.copy_(where3(h, radiance, carry.radiance))
    carry.alive.copy_(h & active)
    carry.last_pdf.copy_(torch.where(h, last_pdf, carry.last_pdf))
    carry.last_delta.copy_(torch.where(h, smp.is_delta, carry.last_delta))
    carry.prev_valid.copy_(carry.prev_valid | h)
    carry.prev_mesh.copy_(torch.where(h, rec.mesh_index, carry.prev_mesh))
    carry.prev_prim.copy_(torch.where(h, rec.prim_index, carry.prev_prim))
    carry.medium_stack.copy_(stack)
    carry.medium_depth.copy_(torch.where(h, medium_depth, carry.medium_depth))
    carry.specular_depth.copy_(torch.where(
        h, torch.where(smp.is_delta, carry.specular_depth + 1, 0),
        carry.specular_depth))
    carry.env_lod.copy_(torch.where(h, env_lod, carry.env_lod))
    carry.env_lod_active.copy_(torch.where(h, lod_lane,
                                           carry.env_lod_active))
    carry.cone_width.copy_(cone_width)
    carry.cone_spread.copy_(cone_spread)
    return where3(h, chain, torch.zeros_like(chain))


def _nee_launch(name, carry, t, tri, u, v, triangles, materials, extra,
                tex, out_cols, params: NeeParams, depth: int):
    """Check, then launch ``mpt_<name>`` (``tex`` None: no texture
    planes); returns its (N, out_cols) output."""
    dev = t.device
    n = t.shape[0]
    ptrs = _carry_pointers(carry, list(_CARRY_DTYPES), n, dev, name)
    mat_table = pack_material_table(materials)
    planes = [] if tex is None else [tex]
    _check_inputs([t, tri, u, v, triangles.shade_packed, mat_table, *extra,
                   *planes], dev, name, tri)
    if tex is not None and tex.shape != (n, len(TEX_IDX)):
        raise ValueError(f"{name}: tex must be ({n}, {len(TEX_IDX)})")
    out = torch.empty((n, out_cols), dtype=torch.float32, device=dev)
    lib = build.load()
    p = lambda x: x.data_ptr()
    err = getattr(lib, f"mpt_{name}")(
        n, build.floats(params.scalars(depth)), p(t), p(tri), p(u), p(v),
        p(triangles.shade_packed), p(mat_table), mat_table.shape[0],
        *[p(x) for x in extra], None if tex is None else p(tex),
        build.pointers(ptrs), p(out),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, f"mpt_{name}")
    return out


def shade_s1(carry: PathCarry, t, tri, u, v, triangles, materials, envbg,
             envpdf, params: NeeParams, depth: int, tex=None):
    """Stage s1, in place on ``carry``; returns the (N,18) transients
    (zero on lanes that were not live hits). ``tex``: the texture planes
    of a textured scene. CPU tensors take the plain version; CUDA tensors
    launch K2 s1."""
    dev = t.device
    if dev.type == "cpu":
        return shade_s1_reference(carry, t, tri, u, v, triangles, materials,
                                  envbg, envpdf, params, depth, tex)
    if dev.type != "cuda":
        raise ValueError(f"shade_s1: unsupported device {dev}")
    out = _nee_launch("shade_s1", carry, t, tri, u, v, triangles, materials,
                      [envbg.contiguous(), envpdf.contiguous()], tex,
                      len(TRANS), params, depth)
    shade_s1.launches += 1
    return out


def shade_s2(carry: PathCarry, t, tri, u, v, triangles, materials, trans,
             esmp, params: NeeParams, depth: int, tex=None):
    """Stage s2, in place on ``carry``; returns the (N,7) chain exports
    (zero on lanes that were not live hits). ``tex``: the texture planes
    of a textured scene. CPU tensors take the plain version; CUDA tensors
    launch K2 s2."""
    dev = t.device
    if dev.type == "cpu":
        return shade_s2_reference(carry, t, tri, u, v, triangles, materials,
                                  trans, esmp, params, depth, tex)
    if dev.type != "cuda":
        raise ValueError(f"shade_s2: unsupported device {dev}")
    out = _nee_launch("shade_s2", carry, t, tri, u, v, triangles, materials,
                      [trans.contiguous(), esmp.contiguous()], tex,
                      len(CHAIN), params, depth)
    shade_s2.launches += 1
    return out


#: K2 s1/s2 launches since the last reset
shade_s1.launches = 0
shade_s2.launches = 0


def nee_shadow_rays(trans, t, e_dir, e_pdf, e_valid, tex=None):
    """The NEE shadow rays of a wavefront from the s1 exports, the alias
    sample and the texture planes' pass-through flags
    (``shade.py:3251-3269``): (origin, t_max, traced lanes), t_max 0 on
    lanes that trace nothing."""
    sn = trans[:, 4:7]
    nee_lanes = (trans[:, TRANS_IDX["active"]] > 0.5) \
        & (trans[:, TRANS_IDX["delta"]] < 0.5)
    if tex is not None:
        nee_lanes = nee_lanes & (tex[:, TEX_IDX["tpass"]] < 0.5)
    do_sh = nee_lanes & e_valid & (e_pdf > 0.0) \
        & (torch.clamp_min(dot(sn, e_dir), 0.0) > 0.0)
    origin = offset_origin(trans[:, 10:13], sn, trans[:, 7:10], t, e_dir)
    return origin, torch.where(do_sh, C.INFINITY_T, 0.0), do_sh


def trace_paths_nee(scene, uniforms, static, carry: PathCarry):
    """The environment-NEE depth loop (``trace_paths_fused``'s NEE branch,
    ``shade.py:3165-3351``): K1 closest-hit, in a textured scene the
    texture stage (``shade.py:3023-3063``), the environment background and
    pdf of the wavefront, K2 s1, the alias sample, a K1 any-hit shadow
    trace, K2 s2 and the spec-NEE chain. One host sync per depth (the
    alive count); the shadow count stays on the device. Returns
    (traces issued, shadow traces as a 0-dim tensor)."""
    env = scene.environment
    params = NeeParams.of(uniforms, static, env)
    textured = has_textures(scene, static)
    rot = uniforms.environment_rotation
    rays = 0
    shadow = torch.zeros((), dtype=torch.int64, device=carry.ray_o.device)
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
        # the alpha-BLEND draw lands before s1's NEE draws
        tex = texture_stage(carry, t, tri, u, v, scene, uniforms, static,
                            depth) if textured else None
        # miss lanes read these; every lane computes them (value-identical
        # to the reference's skip when no lane missed)
        envbg = env_ops.environment_background(
            env, carry.ray_d, uniforms, static, carry.env_lod,
            carry.env_lod_active)
        envpdf = env_ops.environment_pdf(env, carry.ray_d, rot)
        trans = shade_s1(carry, t, tri, u, v, scene.triangles,
                         scene.materials, envbg, envpdf, params, depth, tex)

        # ---- alias sample from s1's draws, shadow trace ------------------
        e_dir, e_rad, e_pdf, e_valid = \
            env_ops.sample_environment_from_uniforms(
                env, trans[:, 0], trans[:, 1], trans[:, 2], uniforms, static)
        sh_o, sh_max, do_sh = nee_shadow_rays(trans, t, e_dir, e_pdf,
                                              e_valid, tex)
        occ = trace_occluded(sh_o, e_dir, scene, C.EPSILON_T, sh_max)
        shadow = shadow + do_sh.sum()
        esmp = torch.cat([e_dir, e_rad, e_pdf[:, None],
                          e_valid[:, None].to(torch.float32),
                          occ[:, None].to(torch.float32)], 1)

        throughput_s1 = carry.throughput.clone()
        chain = shade_s2(carry, t, tri, u, v, scene.triangles,
                         scene.materials, trans, esmp, params, depth, tex)

        # ---- spec-NEE: the environment through the delta bounce ----------
        add, n_chain = specnee.delta_chain_estimators(
            scene, uniforms, static, params.clamp, throughput_s1,
            carry.ray_d, carry.last_delta, chain[:, 0:3],
            chain[:, CHAIN_IDX["dpdf"]], chain[:, CHAIN_IDX["medev"]],
            carry.ray_o, chain[:, CHAIN_IDX["active"]] > 0.5)
        carry.radiance.add_(add)
        shadow = shadow + n_chain
    return rays, shadow
