"""K2: one depth of shading per lane, and the depth loops around the
traces and K2.

Replaces the TPU fused shade megakernel ``ops/pallas/shade.py``
(``_shade_kernel:1845``, launched by ``_shade_call:2536``) in three
stages, each launching ``csrc/shade.cu`` on CUDA tensors and running its
plain version on CPU tensors; all update the ``PathCarry`` tensors in
place, and lanes that enter dead keep every value:

- ``shade_full`` (no light integral): misses add the gradient or solid
  background and end; hits get Beer-Lambert absorption from the top of the
  medium stack, the dielectric geometric normal, first-hit AOVs, the PBR
  emissive add; a diffuse light emits and ends its path; the others sample
  their BSDF (every material type), push or pop the medium stack, and get
  the next origin (off a BSSRDF exit point where the sample has one),
  throughput clamp, ray cone, Russian roulette at depth >= 5 and the
  commit (the integrator body's order). On CUDA, as ``full_schedule``
  says: a thread per lane (the first depth; scenes of one material
  type), a sweep whose warps take 16 spans of 32 lanes and run their
  live lanes packed (sparse wavefronts), or a listing pass that ends the
  misses and buckets the hits by material type (``full_buckets``), then
  persistent warps over the buckets (the depths between);
- ``shade_s1`` (rect lights and/or an environment map): misses add the
  environment with MIS (or the gradient/solid background) and end; hits
  get the same absorption, normal, AOVs and emission, a diffuse light
  emits (an ``emission_env`` light's front face times the ``emod``
  plane) with MIS against the rect-light pdf of the hit and ends, and the
  NEE draws are taken, 3 per light integral, rect first; 18 transient
  columns are exported (``TRANS``, an (N, 18) view of plane-major
  (18, N) storage: the kernel stores each plane coalesced, and each
  column is contiguous);
- ``shade_s2``: the NEE adds with MIS, one bank (light sample + shadow
  flag, ``ESMP``) per light integral, rect first, none on subsurface
  lanes; BSDF sampling from the post-s1 state, the spec-NEE chain exports
  (``CHAIN``, plane-major like ``TRANS``), medium push/pop, next origin,
  throughput clamp, environment LOD, ray cone, Russian roulette and the
  commit. On CUDA the base instantiation first lists the lanes alive
  after s1 (and zeroes the others' chain planes) and runs over the list;
  the extended one runs a thread per lane.

Stages ``full`` and ``s2`` take the random walk's override planes
(``RW``, from ``random_walks``, which runs ``sss.sample_sss_random_walk``
over the scene's trace kernels on the walk lanes only): where the walk
left a sample, it and the walk's RNG state replace the lane's own. Each
stage launches one of two instantiations of its kernel, chosen from the
scene's material types (``ShadeParams.extended``): without, or with, the
plastic, carpaint and subsurface branches.

The hit comes from the merged trace (``intersect.trace_merged``): each
lane's winning family and index, and K2 rebuilds it. A triangle from its
``shade_packed`` row; a sphere or rectangle from its own arrays, with the
raw normal ((p - c) / r, or the stored rectangle normal) faced toward the
ray as both geometric and shading normal, spheres two-sided and rectangles
as stored; only triangles set the self-hit exclusion ids
(``shade.py:1966-1988, 2012-2018, 2132-2143, 2449``). A placement of an
instanced mesh (family ``intersect.KIND_INSTANCE + k``) is rebuilt in
world space from its group's object-space row and its instance-table
row (``traversal.instanced_record``), where the TPU kernel takes XLA's
precomputed normal (``shade.py:1969-2015``); its exclusion ids are its
global instance id and object triangle (``integrator.py:701``).
Triangle-only scenes pass no family (``kind`` None).

In a textured scene every stage reads the texture stage's 15 ``TEX``
planes (``ops/kernels/texture.py``, plane-major like ``TRANS``;
``shade.py:2027-2059``): lanes whose
``tpbr`` flag is set take the textured base colour, roughness, metallic,
transmission, emission and occlusion (full and s1 also the mapped
normal), and alpha pass-through lanes record no AOV, add no emission,
draw no NEE or BSDF sample, skip Russian roulette and continue along
their ray as a delta bounce of weight 1 (``shade.py:2123-2139, 2188,
2306-2331, 2414``).

``debugSpecularOnly`` (``ShadeParams.specular_only``, a runtime argument
of every stage) drops the diffuse lobes (lambert and subsurface lanes
draw no sample; plastic and PBR sample and evaluate their specular lobes
only), the PBR emission and diffuse lights' emission, as the reference's
XLA integrator does (``integrator.py:421, 454``; the Pallas path refuses
the flag, ``shade.py:2507``).

For the pixel probe every stage takes an optional (N,6) ``PROBE`` plane:
``full`` and ``s1`` write each hit's throughput after absorption, ``full``
and ``s2`` the sample's pdf, delta flag and medium event (zero on a
diffuse light). The depth loops record, per depth, what a probe row
needs (``ProbeDepth``) when given a list.

The depth loops are ``trace_paths_fused:2915``'s no-light branch
(``shade.py:3152-3163``) and its NEE branch (``shade.py:3165-3351``);
the random walk forks from the stage's input state before ``full`` and
from the post-s1 state under NEE (``shade.py:3157, 3245``).
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import torch

from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops import bsdf as bsdf_ops
from metal_pathtracer_tpu_torch.ops import env as env_ops
from metal_pathtracer_tpu_torch.ops import integrator
from metal_pathtracer_tpu_torch.ops import rng as rng_ops
from metal_pathtracer_tpu_torch.ops import specnee
from metal_pathtracer_tpu_torch.ops import sss as sss_ops
from metal_pathtracer_tpu_torch.ops.integrator import (
    PathCarry,
    sky_color,
    to_working_space,
)
from metal_pathtracer_tpu_torch.ops.intersect import (
    KIND_INSTANCE,
    analytic_point,
    hit_record,
    offset_origin,
    trace_merged,
    trace_occluded,
)
from metal_pathtracer_tpu_torch.ops.kernels import build
from metal_pathtracer_tpu_torch.ops.kernels.texture import (
    TEX,
    TEX_IDX,
    TexParams,
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
from metal_pathtracer_tpu_torch.schema import INST_MAT, instance_table
from metal_pathtracer_tpu_torch.utils.spans import count, host_read, span


@dataclasses.dataclass(frozen=True)
class ShadeParams:
    """The launch constants of a shade call (every stage)."""

    background_mode: int          # 0 gradient / 1 solid (no environment)
    working_color_space: int      # 0 linear sRGB / 1 ACEScg
    use_russian_roulette: bool
    background_color: tuple       # solid background, linear sRGB
    clamp: bsdf_ops.ClampParams
    material_types: tuple
    specular_mis: bool = False    # MIS on hits after delta bounces too
    env_max_mip: float = 0.0      # mip levels below mip0; 0: LOD off
    sss_mode: int = 0             # 0 off / 1 separable / 2 random walk
    specular_only: bool = False   # debugSpecularOnly

    @classmethod
    def of(cls, uniforms, static, env=None) -> "ShadeParams":
        """The constants of ``static``; ``env`` the environment map of an
        environment light integral."""
        return cls(background_mode=static.background_mode,
                   working_color_space=static.working_color_space,
                   use_russian_roulette=static.use_russian_roulette,
                   background_color=tuple(uniforms.background_color),
                   clamp=bsdf_ops.make_clamp_params(uniforms),
                   material_types=tuple(static.material_types),
                   specular_mis=static.enable_specular_nee
                   or static.enable_mnee,
                   env_max_mip=0.0 if env is None else env_ops.max_mip(env),
                   sss_mode=static.sss_mode,
                   specular_only=static.debug_specular_only)

    @property
    def extended(self) -> bool:
        """The K2 instantiation with the plastic, carpaint and subsurface
        branches (``csrc/shade.cu``: the other one holds none of them)."""
        return bool(set(self.material_types) & set(EXTENDED_TYPES))

    def scalars(self, depth: int, n_banks: int = 0):
        """The float vector the kernels unpack (``shade_params_of`` in
        ``csrc/shade.cu``)."""
        c = self.clamp
        return [float(depth), c.clamp_factor, c.clamp_floor,
                c.throughput_clamp, c.specular_tail_base,
                c.specular_tail_roughness_scale, c.min_specular_pdf,
                c.max_contribution, c.enabled,
                float(self.use_russian_roulette), float(self.specular_mis),
                self.env_max_mip, float(self.working_color_space),
                float(self.background_mode), *self.background_color,
                float(n_banks), float(self.sss_mode),
                float(self.specular_only)]


#: the material types only K2's extended instantiation holds
EXTENDED_TYPES = (C.MATERIAL_PLASTIC, C.MATERIAL_SUBSURFACE,
                  C.MATERIAL_CARPAINT)


def _background(ray_d, params: ShadeParams):
    if params.background_mode == 1:
        bg = torch.tensor(params.background_color, device=ray_d.device)
        bg = bg.expand_as(ray_d)
    else:
        bg = sky_color(ray_d)
    return to_working_space(bg, params)


def _mis_weight(pdf_a, pdf_b):
    """The power-free balance heuristic of the integrator:
    a / max(a + b, 1e-30) clamped to [MIS_MIN, MIS_MAX], and the sum."""
    denom = pdf_a + pdf_b
    return torch.clamp(fdiv(pdf_a, torch.clamp_min(denom, 1e-30)),
                       C.MIS_WEIGHT_CLAMP_MIN, C.MIS_WEIGHT_CLAMP_MAX), denom


def rebuild_hit(ray_o, ray_d, triangles, t, idx, u, v, kind=None, scene=None):
    """The hit record of each lane's winner: the triangle's from its
    ``shade_packed`` row, a sphere's or rectangle's from its arrays, an
    instance's in world space (``kind`` None: every hit is a triangle)."""
    if kind is None:
        return _hit_record_from_best(ray_o, ray_d, triangles, t, idx, u, v)
    return hit_record(ray_o, ray_d, t, idx, u, v, kind, scene)


def triangle_lanes(idx, kind):
    """Each lane's triangle, soup or instanced (the texture stage's
    input), -1 on other lanes."""
    if kind is None:
        return idx
    return torch.where((kind == C.PRIMITIVE_TRIANGLE) | (kind >= KIND_INSTANCE),
                       idx, -1)


def _textured(m, tex, params: ShadeParams):
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


@dataclasses.dataclass
class _Front:
    """What ``_shade_front`` leaves for the rest of a stage."""

    rec: object            # HitRecord
    m: object              # MatLanes, textured
    sn: torch.Tensor       # shading normal (textured, dielectric: faced)
    throughput: torch.Tensor  # after absorption
    radiance: torch.Tensor
    occlusion: torch.Tensor
    passthrough: torch.Tensor
    light: torch.Tensor    # live hits on a diffuse light: their path ends


def _shade_front(carry: PathCarry, t, tri, u, v, triangles, materials,
                 params: ShadeParams, hit_lanes, radiance, kind, scene,
                 tex=None, rectpdf=None, emod=None) -> _Front:
    """The part of a hit lane that stages full and s1 share
    (``shade.py:2101-2177``; integrator body :323-459): hit rebuild,
    absorption, material (+ texture overrides), the dielectric geometric
    normal, first-hit AOVs (committed here), PBR emission, and a diffuse
    light's emission, front faces of an ``emission_env`` light times the
    ``emod`` plane (``shade.py:2149-2154``), with MIS against ``rectpdf``
    (None: weight 1)."""
    rec = rebuild_hit(carry.ray_o, carry.ray_d, triangles, t, tri, u, v,
                      kind, scene)
    sn = rec.shading_normal
    bad_sn = ~torch.isfinite(sn).all(-1) | (dot(sn, sn) <= 0.0)
    shading_normal = where3(bad_sn, rec.normal, sn)
    m, emissive, occlusion, passthrough, tv = _textured(
        bsdf_ops.gather_material(materials, rec.material), tex, params)
    if tv is not None:
        shading_normal = where3(tv, tex[:, 10:13], shading_normal)

    n = t.shape[0]
    top = torch.clamp(carry.medium_depth - 1, 0, C.MAX_MEDIUM_STACK - 1)
    sigma = carry.medium_stack[torch.arange(n, device=t.device), top.long()]
    att = torch.exp(-sigma * torch.clamp_min(t, 0.0)[:, None])
    absorb = hit_lanes & (carry.medium_depth > 0) & (sigma > 0.0).any(-1)
    throughput = where3(absorb, carry.throughput * att, carry.throughput)

    shading_normal = where3(m.mat_type == C.MATERIAL_DIELECTRIC, rec.normal,
                            shading_normal)
    two_sided = rec.two_sided | ((m.mat_type == C.MATERIAL_PBR)
                                 & (m.pbr_double_sided > 0.5))
    facing = rec.front_face | two_sided

    shaded = hit_lanes & ~passthrough
    record_aov = shaded & carry.is_first_hit
    carry.aov_albedo.copy_(where3(record_aov, bsdf_ops.material_base_color(m),
                                  carry.aov_albedo))
    carry.aov_normal.copy_(where3(record_aov, shading_normal,
                                  carry.aov_normal))
    carry.is_first_hit.copy_(carry.is_first_hit & ~shaded)
    zero = torch.zeros_like(radiance)
    pbr_emit = (shaded & (m.mat_type == C.MATERIAL_PBR)
                & (emissive != 0.0).any(-1) & facing
                & (not params.specular_only))
    radiance = radiance + where3(pbr_emit, bsdf_ops.clamp_firefly_contribution(
        throughput, emissive, params.clamp), zero)

    light = hit_lanes & (m.mat_type == C.MATERIAL_DIFFUSE_LIGHT)
    l_mis = torch.ones_like(t)
    if rectpdf is not None:
        w, denom = _mis_weight(carry.last_pdf, rectpdf)
        use_mis = (~carry.last_delta | params.specular_mis) & (denom > 0.0)
        l_mis = torch.where(use_mis, w, 1.0)
    emission = m.emission
    if emod is not None:
        emission = where3((m.emission_env > 0.0) & rec.front_face,
                          emission * emod, emission)
    emit = light & (emission != 0.0).any(-1) & facing \
        & (not params.specular_only)
    radiance = radiance + where3(emit, bsdf_ops.clamp_firefly_contribution(
        throughput, emission * l_mis[:, None], params.clamp), zero)
    return _Front(rec=rec, m=m, sn=shading_normal, throughput=throughput,
                  radiance=radiance, occlusion=occlusion,
                  passthrough=passthrough, light=light)


def _medium_update(carry: PathCarry, smp, m, active):
    """Medium stack push/pop (8 slots, clamped): (stack, depth)."""
    n = active.shape[0]
    push = active & (smp.medium_event == 1)
    pop = active & (smp.medium_event == -1)
    slot = torch.clamp(carry.medium_depth, 0, C.MAX_MEDIUM_STACK - 1).long()
    lanes = torch.arange(n, device=active.device)
    stack = carry.medium_stack.clone()
    stack[lanes, slot] = where3(push, torch.clamp_min(m.dielectric_sigma_a,
                                                      0.0),
                                stack[lanes, slot])
    depth = torch.where(
        push, torch.clamp_max(carry.medium_depth + 1, C.MAX_MEDIUM_STACK),
        carry.medium_depth)
    return stack, torch.where(pop, torch.clamp_min(depth - 1, 0), depth)


def _cone_update(carry: PathCarry, t, smp, active):
    """The ray cone at the hit, kept on lanes that go on: (width,
    spread)."""
    ray_len = torch.sqrt(torch.clamp_min(dot(carry.ray_d, carry.ray_d),
                                         1e-12))
    cone_at_hit = torch.clamp_min(
        fma(carry.cone_spread, torch.clamp_min(t, 0.0) * ray_len,
            carry.cone_width), 1e-7)
    return (torch.where(active, cone_at_hit, carry.cone_width),
            torch.where(active, torch.clamp_max(
                carry.cone_spread + bsdf_ops.bsdf_cone_spread_increment(
                    smp.lobe_type, smp.lobe_roughness, smp.is_delta), 1.5),
                carry.cone_spread))


def _roulette(params: ShadeParams, depth: int, state, throughput, max_tp,
              active, passthrough):
    """Russian roulette at depth >= 5 on lanes that go on, alpha
    pass-through lanes excepted: (state, throughput, active)."""
    if not (params.use_russian_roulette and depth >= 5):
        return state, throughput, active
    do_rr = active & ~passthrough
    rr_state, xi = rng_ops.rand_uniform(state)
    cont_p = torch.clamp(max_tp, 0.05, 0.95)
    survive = xi <= cont_p
    throughput = where3(do_rr & survive, throughput / cont_p[:, None],
                        throughput)
    return (torch.where(do_rr, rr_state, state), throughput,
            active & (survive | ~do_rr))


def _passthrough_sample(smp, passthrough, ray_d):
    """Alpha pass-through lanes: a delta bounce along the same ray, weight
    1 (``shade.py:2306-2313``)."""
    ones = torch.ones_like(ray_d[:, 0])
    through = bsdf_ops.BsdfSample.invalid(ones.shape, ones.device).replace(
        direction=ray_d, weight=torch.ones_like(ray_d), pdf=ones,
        directional_pdf=ones, is_delta=torch.ones_like(passthrough))
    return bsdf_ops.select_sample(passthrough, through, smp)


#: random-walk override columns, the walk pre-stage -> stages full and s2
#: (``shade.py:1804``)
RW = ["mask", "dx", "dy", "dz", "wr", "wg", "wb", "pdf", "dpdf", "lobe",
      "lrough", "hasexit", "ex", "ey", "ez", "enx", "eny", "enz"]


def _rw_override(smp, nstate, rw, rw_state):
    """Random-walk lanes (mask set, pdf > 0) replace both the sample and
    the RNG state (``shade.py:2284-2300``)."""
    if rw is None:
        return smp, nstate
    used = (rw[:, 0] > 0.5) & (rw[:, 7] > 0.0)
    walk = bsdf_ops.BsdfSample.invalid(used.shape, used.device).replace(
        direction=rw[:, 1:4], weight=rw[:, 4:7], pdf=rw[:, 7],
        directional_pdf=rw[:, 8], lobe_type=rw[:, 9].to(torch.int32),
        lobe_roughness=rw[:, 10], has_exit_point=rw[:, 11] > 0.5,
        exit_point=rw[:, 12:15], exit_normal=rw[:, 15:18])
    return (bsdf_ops.select_sample(used, walk, smp),
            torch.where(used, rw_state, nstate))


def _next_origin(point, sn, n_faced, t, smp, params: ShadeParams):
    """The next ray's origin: off the hit (``offset_origin``), or off the
    BSSRDF exit point on lanes that have one (``shade.py:2359-2371``)."""
    origin = offset_origin(point, sn, n_faced, t, smp.direction)
    if C.MATERIAL_SUBSURFACE not in params.material_types:
        return origin
    return where3(smp.has_exit_point,
                  sss_ops.exit_point_origin(smp, n_faced), origin)


def _max3(x):
    return torch.maximum(torch.maximum(x[:, 0], x[:, 1]), x[:, 2])


#: the probe plane's columns: the throughput after absorption, then the
#: BSDF sample's pdf, delta flag and medium event
PROBE = ["tpr", "tpg", "tpb", "pdf", "delta", "medev"]


def _probe_sample(probe, lanes, smp):
    """Write the sample's probe columns on ``lanes`` (no-op without a
    plane)."""
    if probe is not None:
        probe[lanes, 3:6] = torch.stack(
            [smp.pdf, smp.is_delta.to(torch.float32),
             smp.medium_event.to(torch.float32)], -1)[lanes]


def shade_full_reference(carry: PathCarry, t, tri, u, v, triangles,
                         materials, params: ShadeParams, depth: int,
                         kind=None, scene=None, tex=None, rw=None,
                         rw_state=None, probe=None, lanes=None, n_alive=None):
    """Plain PyTorch K2 stage full (see the module docstring). ``lanes``:
    shade only these lane indices (a bucket of ``full_buckets``); every
    other lane keeps every value. ``n_alive`` is the kernels' regime
    hint, unused here."""
    del n_alive
    alive0 = carry.alive.clone()
    if lanes is not None:
        chosen = torch.zeros_like(alive0)
        chosen[lanes] = True
        alive0 = alive0 & chosen
    hit = tri >= 0
    miss = alive0 & ~hit
    bg = bsdf_ops.clamp_firefly_contribution(
        carry.throughput, _background(carry.ray_d, params), params.clamp)
    radiance = where3(miss, carry.radiance + bg, carry.radiance)
    f = _shade_front(carry, t, tri, u, v, triangles, materials, params,
                     alive0 & hit, radiance, kind, scene, tex)
    active = alive0 & hit & ~f.light
    go = active.clone()                 # the hit lanes that sample

    incident = normalize(carry.ray_d)
    nstate, smp = bsdf_ops.sample_bsdf(
        f.m, f.sn, -incident, incident, f.rec.front_face, carry.state,
        params.clamp, f.occlusion, params.material_types,
        position=f.rec.point, sss_mode=params.sss_mode,
        specular_only=params.specular_only)
    smp, nstate = _rw_override(smp, nstate, rw, rw_state)
    state = torch.where(active & ~f.passthrough, nstate, carry.state)
    smp = _passthrough_sample(smp, f.passthrough, carry.ray_d)
    if probe is not None:
        hit_lanes = alive0 & hit
        probe[hit_lanes, 0:3] = f.throughput[hit_lanes]
        probe[hit_lanes & f.light, 3:6] = 0.0
        _probe_sample(probe, go, smp)
    active = active & (smp.pdf > 0.0)
    stack, medium_depth = _medium_update(carry, smp, f.m, active)
    next_origin = _next_origin(f.rec.point, f.sn, f.rec.normal, t, smp,
                               params)
    throughput = bsdf_ops.clamp_path_throughput(f.throughput * smp.weight,
                                                params.clamp)
    max_tp = _max3(throughput)
    active = active & torch.isfinite(throughput).all(-1) & (max_tp > 0.0)
    cone_width, cone_spread = _cone_update(carry, t, smp, active)
    state, throughput, active = _roulette(params, depth, state, throughput,
                                          max_tp, active, f.passthrough)

    # ---- commit: misses and lights end their path, dead lanes keep all --
    is_tri = f.rec.prim_type == C.PRIMITIVE_TRIANGLE
    carry.state.copy_(torch.where(go, state, carry.state))
    carry.ray_o.copy_(where3(go, next_origin, carry.ray_o))
    carry.ray_d.copy_(where3(go, smp.direction, carry.ray_d))
    carry.throughput.copy_(where3(go, throughput, carry.throughput))
    carry.radiance.copy_(where3(alive0, f.radiance, carry.radiance))
    carry.prev_valid.copy_(torch.where(go, True, torch.where(
        miss, False, carry.prev_valid)))
    carry.prev_mesh.copy_(torch.where(go, torch.where(
        is_tri, f.rec.mesh_index, -1), torch.where(miss, -1,
                                                   carry.prev_mesh)))
    carry.prev_prim.copy_(torch.where(go, torch.where(
        is_tri, f.rec.prim_index, -1), torch.where(miss, -1,
                                                   carry.prev_prim)))
    carry.medium_stack.copy_(stack)
    carry.medium_depth.copy_(torch.where(go, medium_depth,
                                         carry.medium_depth))
    carry.cone_width.copy_(cone_width)
    carry.cone_spread.copy_(cone_spread)
    carry.alive.copy_(torch.where(alive0, active, carry.alive))


#: every PathCarry field and its dtype, in the order the kernels take them
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


def _carry_pointers(carry: PathCarry, n: int, dev, who: str):
    """Device pointers of the carry tensors, after checking each is a
    contiguous tensor of the kernel's dtype with ``n`` lanes on ``dev``."""
    ptrs = []
    for name, dtype in _CARRY_DTYPES.items():
        x = getattr(carry, name)
        if x.device != dev or x.dtype != dtype or not x.is_contiguous() \
                or x.shape[0] != n:
            raise ValueError(f"{who}: carry.{name} must be a contiguous "
                             f"{dtype} tensor of {n} lanes on {dev}")
        ptrs.append(x.data_ptr())
    return ptrs


def _geo_pointers(t, tri, u, v, triangles, kind, scene, dev, who: str):
    """The geometry pointer array of ``csrc/shade.cu geo_of``: hit t,
    index, u, v, family, ``shade_packed``, sphere centre, radius and
    material, rectangle normal, material and two-sidedness, the instance
    table and the instanced groups' ``shade_packed`` rows (NULL where the
    scene has none)."""
    spheres = None if scene is None or not scene.n_spheres else scene.spheres
    rects = None if scene is None or not scene.n_rects else scene.rects
    inst = instance_table(scene.instanced) \
        if scene is not None and scene.instanced else None
    if inst is not None and kind is None:
        raise ValueError(f"{who}: an instanced scene's hits need a family")
    tensors = [t, tri, u, v]
    if kind is not None:
        tensors.append(kind)
    elif triangles is None:
        raise ValueError(f"{who}: a triangle-only hit needs triangles")
    if triangles is not None:
        tensors.append(triangles.shade_packed)
    for prims, names in ((spheres, ("center", "radius", "material")),
                         (rects, ("normal", "material", "two_sided"))):
        if prims is not None:
            tensors += [getattr(prims, nm) for nm in names]
    if inst is not None:
        tensors += [inst.table, inst.shade_packed]
    if any(x.device != dev or not x.is_contiguous() for x in tensors) \
            or tri.dtype != torch.int32 \
            or (kind is not None and kind.dtype != torch.int32):
        raise ValueError(f"{who}: hit and geometry tensors must be "
                         f"contiguous, on {dev}, with int32 indices")
    if triangles is not None:   # its rows are read as 16-byte loads
        build.check_aligned(who, [triangles.shade_packed], 16)
    if inst is not None:
        build.check_aligned(who, [inst.table, inst.shade_packed], 16)
    p = lambda x: None if x is None else x.data_ptr()
    return build.pointers(
        [p(t), p(tri), p(u), p(v), p(kind),
         p(None if triangles is None else triangles.shade_packed),
         *[p(None if spheres is None else getattr(spheres, nm))
           for nm in ("center", "radius", "material")],
         *[p(None if rects is None else getattr(rects, nm))
           for nm in ("normal", "material", "two_sided")],
         p(None if inst is None else inst.table),
         p(None if inst is None else inst.shade_packed)])


#: material table columns the shade kernels read (``pack_material_table:292``
#: columns ``:240-281``, in the order of ``csrc/bsdf.cuh fetch_material``)
MAT_COLS = ["mat_type", "base_r", "base_g", "base_b", "roughness", "eta",
            "thin", "em_r", "em_g", "em_b", "sa_r", "sa_g", "sa_b",
            "pbr_metallic", "pbr_transmission", "pbr_thickness",
            "pbr_double_sided", "ce_r", "ce_g", "ce_b", "ck_r", "ck_g",
            "ck_b", "has_conductor", "emission_env",
            # plastic / carpaint coat layer
            "coat_ior", "coat_roughness", "coat_thickness",
            "coat_sample_weight", "coat_fresnel_avg",
            "coat_tint_r", "coat_tint_g", "coat_tint_b",
            "coat_abs_r", "coat_abs_g", "coat_abs_b",
            # carpaint base and flake lobes
            "carpaint_base_metallic", "carpaint_base_roughness",
            "carpaint_flake_scale", "carpaint_flake_sample_weight",
            "carpaint_flake_roughness", "carpaint_flake_anisotropy",
            "carpaint_flake_normal_strength", "carpaint_has_base_conductor",
            "cpe_r", "cpe_g", "cpe_b", "cpk_r", "cpk_g", "cpk_b",
            # subsurface
            "sss_g", "sss_mfp", "sss_method", "sss_coat",
            "sss_sigma_override", "ssa_r", "ssa_g", "ssa_b",
            "ssss_r", "ssss_g", "ssss_b"]


def pack_material_table(materials) -> torch.Tensor:
    """(M, 61) f32 table in ``MAT_COLS`` order (``_launch`` packs it once
    per materials object, ``MaterialsSoA.table``)."""
    v = lambda x: x.unbind(-1)
    m = materials
    cols = [m.mat_type.to(torch.float32), *v(m.base_color), m.roughness,
            m.eta, m.thin, *v(m.emission), *v(m.dielectric_sigma_a),
            m.pbr_metallic, m.pbr_transmission, m.pbr_thickness,
            m.pbr_double_sided, *v(m.conductor_eta), *v(m.conductor_k),
            m.has_conductor, m.emission_env, m.coat_ior, m.coat_roughness,
            m.coat_thickness, m.coat_sample_weight, m.coat_fresnel_avg,
            *v(m.coat_tint), *v(m.coat_absorption), m.carpaint_base_metallic,
            m.carpaint_base_roughness, m.carpaint_flake_scale,
            m.carpaint_flake_sample_weight, m.carpaint_flake_roughness,
            m.carpaint_flake_anisotropy, m.carpaint_flake_normal_strength,
            m.carpaint_has_base_conductor, *v(m.carpaint_base_eta),
            *v(m.carpaint_base_k), m.sss_g, m.sss_mfp, m.sss_method,
            m.sss_coat, m.sss_sigma_override, *v(m.sss_sigma_a),
            *v(m.sss_sigma_s)]
    return torch.stack([c.to(torch.float32) for c in cols], 1).contiguous()


def _launch(name, carry, t, tri, u, v, triangles, materials, kind, scene,
            inputs, out_cols, params: ShadeParams, depth: int, n_banks=0,
            probe=None, plane_inputs=(), plane_out=False, listed=False,
            scratch=None, lead=(), extra_out=()):
    """Check, then launch ``mpt_<name>`` (the instantiation that
    ``params.material_types`` needs) with the stage ``inputs`` (device
    tensors or None; those at the positions ``plane_inputs`` names are
    plane-major ``TRANS`` or ``TEX`` planes, the others contiguous) after
    the material table (packed on the first launch for these materials)
    and the probe plane (or None), and, if ``listed``, the stage's
    live-lane list ``scratch`` (a null pointer for None); ``lead``: ints
    the entry takes after the instantiation flag; ``extra_out``: tensors
    or None (a null pointer) the entry takes after the output (s2's fork
    state); returns its (N, out_cols) output, plane-major if ``plane_out``
    (None without one)."""
    dev = t.device
    n = t.shape[0]
    ptrs = _carry_pointers(carry, n, dev, name)
    geo = _geo_pointers(t, tri, u, v, triangles, kind, scene, dev, name)
    mat_table = materials.table(pack_material_table)
    for k, x in enumerate(inputs):
        if x is None:
            continue
        if k in plane_inputs:
            build.check_planes(name, x, n, x.shape[1])
        elif not x.is_contiguous():
            raise ValueError(f"{name}: stage inputs must be contiguous")
        if x.device != dev or x.shape[0] != n:
            raise ValueError(f"{name}: stage inputs must be of {n} lanes "
                             f"and on {dev}")
    if probe is not None and (probe.shape != (n, len(PROBE))
                              or probe.dtype != torch.float32
                              or probe.device != dev
                              or not probe.is_contiguous()):
        raise ValueError(f"{name}: probe must be a contiguous ({n}, "
                         f"{len(PROBE)}) float32 plane on {dev}")
    out = None if out_cols is None else build.planes(n, out_cols, dev) \
        if plane_out else torch.empty((n, out_cols), dtype=torch.float32,
                                      device=dev)
    lib = build.load()
    p = lambda x: None if x is None else x.data_ptr()
    err = getattr(lib, f"mpt_{name}")(
        n, int(params.extended), *lead,
        build.floats(params.scalars(depth, n_banks)),
        geo, p(mat_table), mat_table.shape[0],
        *[p(x) for x in inputs], build.pointers(ptrs),
        *([] if out is None else [p(out)]),
        *[p(x) for x in extra_out], p(probe),
        *([p(scratch)] if listed else []),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, f"mpt_{name}")
    return out


def _check_rw(name, rw, rw_state, n):
    if rw is not None and (rw.shape != (n, len(RW)) or rw_state is None
                           or rw_state.dtype != torch.int64):
        raise ValueError(f"{name}: rw must be ({n}, {len(RW)}) with int64 "
                         "states")


#: K2 full's buckets (``csrc/shade.cu N_FULL_KEYS``): the misses, then the
#: hits by their material's type, key 1 + ``constants.MATERIAL_*``
FULL_KEYS = ["miss", "lambert", "metal", "dielectric", "light", "plastic",
             "subsurface", "carpaint", "pbr"]
#: int32 counters ahead of the bucket lists (``csrc/shade.cu FULL_HEADER``)
FULL_HEADER = 16


def full_buckets_reference(carry: PathCarry, t, tri, u, v, triangles,
                           materials, params: ShadeParams = None, kind=None,
                           scene=None):
    """Plain listing of stage full's buckets: for each key of
    ``FULL_KEYS``, the live lanes of that key in ascending order (a miss,
    or 1 + the type of the hit's material; a type outside them takes key
    1). ``params`` is the kernel's (it ends the misses there); unused."""
    del params
    rec = rebuild_hit(carry.ray_o, carry.ray_d, triangles, t, tri, u, v,
                      kind, scene)
    mat = torch.clamp(rec.material, 0, materials.count - 1).long()
    mtype = materials.mat_type[mat].long()
    typed = (mtype >= 0) & (mtype < len(FULL_KEYS) - 1)
    key = torch.where(tri >= 0, torch.where(typed, 1 + mtype, 1), 0)
    key = torch.where(carry.alive, key, -1)
    return [torch.nonzero(key == k).squeeze(1) for k in range(len(FULL_KEYS))]


def full_buckets(carry: PathCarry, t, tri, u, v, triangles, materials,
                 params: ShadeParams, kind=None, scene=None):
    """Stage full's listing pass. CPU tensors: ``full_buckets_reference``.
    CUDA tensors: ``csrc/shade.cu full_list_kernel`` lists every live hit
    into its key's bucket and ends the misses' paths in place (their
    bucket stays empty); returns the scratch (``FULL_HEADER`` counters,
    then a region of N lanes per key) that ``shade_full`` runs over
    (``bucket_lanes`` reads it back)."""
    dev = t.device
    if dev.type == "cpu":
        return full_buckets_reference(carry, t, tri, u, v, triangles,
                                      materials, params, kind, scene)
    if dev.type != "cuda":
        raise ValueError(f"full_buckets: unsupported device {dev}")
    n = t.shape[0]
    ptrs = _carry_pointers(carry, n, dev, "full_buckets")
    geo = _geo_pointers(t, tri, u, v, triangles, kind, scene, dev,
                        "full_buckets")
    types = materials.mat_type
    if types.device != dev or types.dtype != torch.int32 \
            or not types.is_contiguous():
        raise ValueError(f"full_buckets: materials.mat_type must be a "
                         f"contiguous int32 tensor on {dev}")
    scratch = build.list_scratch(n, dev, len(FULL_KEYS), FULL_HEADER)
    err = build.load().mpt_full_list(
        n, build.floats(params.scalars(0)), geo, types.data_ptr(),
        types.shape[0], build.pointers(ptrs), scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "mpt_full_list")
    full_buckets.launches += 1
    return scratch


def bucket_lanes(scratch, n: int):
    """The buckets of a ``full_buckets`` scratch as ``full_buckets_reference``
    gives them: per key its lanes in ascending order (reads the counts
    back: for checks, not the depth loop)."""
    counts = scratch[:len(FULL_KEYS)].tolist()
    lists = scratch[FULL_HEADER:].view(len(FULL_KEYS), n)
    return [torch.sort(lists[k, :c]).values.long()
            for k, c in enumerate(counts)]


def _check_full(t, tex, rw, rw_state):
    if t.device.type != "cuda":
        raise ValueError(f"shade_full: unsupported device {t.device}")
    _check_tex("shade_full", tex, t.shape[0])
    _check_rw("shade_full", rw, rw_state, t.shape[0])


def _sweep(carry: PathCarry, t, tri, u, v, triangles, materials,
           params: ShadeParams, depth: int, kind, scene, tex, rw, rw_state,
           probe, sparse: bool) -> None:
    _check_full(t, tex, rw, rw_state)
    _launch("shade_full", carry, t, tri, u, v, triangles, materials, kind,
            scene, [tex, rw, rw_state], None, params, depth, probe=probe,
            plane_inputs=(0,), listed=True, lead=(int(sparse),))


def shade_full_lanes(carry: PathCarry, t, tri, u, v, triangles, materials,
                     params: ShadeParams, depth: int, kind=None, scene=None,
                     tex=None, rw=None, rw_state=None, probe=None) -> None:
    """Stage full on CUDA tensors, a thread per wavefront lane
    (``shade_full_kernel``): the first depth's kernel, and that of scenes
    of one material type."""
    _sweep(carry, t, tri, u, v, triangles, materials, params, depth, kind,
           scene, tex, rw, rw_state, probe, False)
    shade_full_lanes.launches += 1


def shade_full_sparse(carry: PathCarry, t, tri, u, v, triangles, materials,
                      params: ShadeParams, depth: int, kind=None, scene=None,
                      tex=None, rw=None, rw_state=None, probe=None) -> None:
    """Stage full on CUDA tensors for a sparse wavefront, base
    instantiation only (``shade_full_sparse_kernel``): each warp sweeps 16
    spans of 32 lanes and runs its live lanes packed 32 to a round."""
    if params.extended:
        raise ValueError("shade_full_sparse: the base instantiation only")
    _sweep(carry, t, tri, u, v, triangles, materials, params, depth, kind,
           scene, tex, rw, rw_state, probe, True)
    shade_full_sparse.launches += 1


def shade_full_buckets(carry: PathCarry, t, tri, u, v, triangles, materials,
                       params: ShadeParams, depth: int, kind=None,
                       scene=None, tex=None, rw=None, rw_state=None,
                       probe=None, buckets=None) -> None:
    """Stage full on CUDA tensors over buckets of one lane kind each: the
    listing pass (``full_buckets``; ``buckets``: its scratch, already made
    on this carry), then persistent warps taking 32 lanes of one bucket at
    a time (``shade_full_buckets_kernel``)."""
    _check_full(t, tex, rw, rw_state)
    scratch = full_buckets(carry, t, tri, u, v, triangles, materials, params,
                           kind, scene) if buckets is None else buckets
    n = t.shape[0]
    if scratch.dtype != torch.int32 or scratch.device != t.device \
            or scratch.numel() != FULL_HEADER + len(FULL_KEYS) * n:
        raise ValueError("shade_full: buckets must be full_buckets' int32 "
                         f"scratch of {n} lanes on {t.device}")
    _launch("shade_full", carry, t, tri, u, v, triangles, materials, kind,
            scene, [tex, rw, rw_state], None, params, depth, probe=probe,
            plane_inputs=(0,), listed=True, scratch=scratch, lead=(0,))
    shade_full_buckets.launches += 1


#: below this share of live lanes a wavefront is sparse: no listing pass
#: pays for itself there, and the base instantiation runs
#: ``shade_full_sparse`` (measured on an H100: ``PERF.md``)
FULL_SPARSE_ALIVE = 1 / 64


def full_schedule(params: ShadeParams, depth: int, n_alive=None,
                  n: int = 0):
    """Which wrapper runs stage full on CUDA, from what the caller knows
    (no host sync). On a sparse wavefront (``n_alive``, the caller's live
    lanes, under ``FULL_SPARSE_ALIVE`` of the ``n``) ``shade_full_sparse``
    for the base instantiation and ``shade_full_lanes`` for the extended
    one (its long lanes run slower packed); ``shade_full_lanes`` at the
    first depth (where nearly every lane lives and shades alike) and in
    scenes of one material type (no divergence to remove);
    ``shade_full_buckets`` at the other depths (``n_alive`` None: not
    known to be sparse)."""
    if n_alive is not None and n_alive < FULL_SPARSE_ALIVE * n:
        return shade_full_lanes if params.extended else shade_full_sparse
    if depth == 0 or len(set(params.material_types)) < 2:
        return shade_full_lanes
    return shade_full_buckets


def shade_full(carry: PathCarry, t, tri, u, v, triangles, materials,
               params: ShadeParams, depth: int, kind=None,
               scene=None, tex=None, rw=None, rw_state=None,
               probe=None, n_alive=None) -> None:
    """Stage full, in place on ``carry``. ``tri`` is each lane's index in
    its family (-1: a miss), ``kind`` the family (None: triangles only)
    and ``scene`` the spheres and rectangles it indexes; ``tex`` the
    texture planes of a textured scene, ``rw``/``rw_state`` the
    random-walk override, ``probe`` the (N,6) probe plane, ``n_alive``
    the live lanes if the caller knows them (no host sync here). CPU
    tensors take the plain version; CUDA tensors launch K2: a thread per
    lane, a sweep for sparse wavefronts, or the listing pass and
    persistent warps over buckets of one lane kind each
    (``full_schedule`` decides)."""
    if t.device.type == "cpu":
        shade_full_reference(carry, t, tri, u, v, triangles, materials,
                             params, depth, kind, scene, tex, rw, rw_state,
                             probe)
        return
    run = full_schedule(params, depth, n_alive, t.shape[0])
    run(carry, t, tri, u, v, triangles, materials, params, depth, kind=kind,
        scene=scene, tex=tex, rw=rw, rw_state=rw_state, probe=probe)
    shade_full.launches += 1


#: K2 full launches since the last reset (chip_smoke.py reads and resets
#: them): every stage-full call, and each kernel's: a thread per lane, the
#: sparse sweep, the buckets and the listing pass
shade_full.launches = 0
shade_full_lanes.launches = 0
shade_full_sparse.launches = 0
shade_full_buckets.launches = 0
full_buckets.launches = 0


def _trace(scene, carry: PathCarry):
    """The closest-hit trace of the wavefront's live lanes with the
    triangle self-hit exclusion: (t, index, u, v, family or None). A
    scene of soup triangles alone takes K1 alone (family None); any other
    family, instanced meshes included, takes the merged trace, as does a
    scene without any primitive (every lane misses; nothing launches)."""
    ex_mesh = torch.where(carry.prev_valid, carry.prev_mesh, -1)
    ex_prim = torch.where(carry.prev_valid, carry.prev_prim, -1)
    lane_tmax = torch.where(carry.alive, C.INFINITY_T, 0.0)
    if scene.n_spheres or scene.n_rects or scene.instanced \
            or not scene.n_triangles:
        return trace_merged(carry.ray_o, carry.ray_d, scene, C.EPSILON_T,
                            lane_tmax, ex_mesh, ex_prim)
    t, tri, u, v = trace_closest(carry.ray_o, carry.ray_d, C.EPSILON_T,
                                 lane_tmax, scene.tri_bvh, scene.triangles,
                                 ex_mesh, ex_prim)
    return t, tri, u, v, None


def random_walks(scene, uniforms, static, carry: PathCarry, t, idx, u, v,
                 kind):
    """The random-walk pre-stage of one depth (``shade.py:3064-3150``):
    ``sss.sample_sss_random_walk`` on the live front-face hits of a
    random-walk subsurface material only, from the carry's RNG state (the
    stage's fork point), gathered into a dense batch. Returns the (N,18)
    ``RW`` planes (zero off the walk's lanes) and the (N,) states (the
    carry's off them); (None, None) when the scene walks nowhere."""
    if not (static.sss_mode == 2
            and C.MATERIAL_SUBSURFACE in static.material_types):
        return None, None
    mats = scene.materials
    rec = rebuild_hit(carry.ray_o, carry.ray_d, scene.triangles, t, idx, u,
                      v, kind, scene)
    walk_mat = (mats.mat_type == C.MATERIAL_SUBSURFACE) \
        & (mats.sss_method >= 0.5)
    mat = torch.clamp(rec.material, 0, mats.count - 1).long()
    lanes = torch.nonzero(carry.alive & (idx >= 0) & walk_mat[mat]
                          & rec.front_face).squeeze(1)
    rw = torch.zeros((t.shape[0], len(RW)), device=t.device)
    rw_state = carry.state.clone()
    if lanes.numel() == 0:
        return rw, rw_state
    incident = normalize(carry.ray_d[lanes])
    hit = SimpleNamespace(normal=rec.normal[lanes], point=rec.point[lanes],
                          front_face=torch.ones_like(lanes, dtype=torch.bool))
    state, smp = sss_ops.sample_sss_random_walk(
        scene, bsdf_ops.gather_material(mats, rec.material[lanes]), hit,
        -incident, incident, carry.state[lanes],
        bsdf_ops.make_clamp_params(uniforms), static.sss_max_steps)
    f = lambda x: x.to(torch.float32)[:, None]
    rw[lanes] = torch.cat([
        torch.ones_like(f(lanes)), smp.direction, smp.weight, f(smp.pdf),
        f(smp.directional_pdf), f(smp.lobe_type), f(smp.lobe_roughness),
        f(smp.has_exit_point), smp.exit_point, smp.exit_normal], 1)
    rw_state[lanes] = state
    return rw, rw_state


@dataclasses.dataclass
class ProbeDepth:
    """What one depth of a probed wavefront leaves for its probe rows
    (``renderer/debugprobe.py``): the lanes alive at entry and their
    entry state and ray, the trace's winner, the probe plane (``PROBE``;
    the entry throughput on misses) and the carry's radiance and medium
    depth after the depth."""

    alive: torch.Tensor
    state: torch.Tensor
    ray_o: torch.Tensor
    ray_d: torch.Tensor
    t: torch.Tensor
    idx: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    kind: object
    plane: torch.Tensor
    radiance: torch.Tensor = None
    medium_depth: torch.Tensor = None


def _probe_depth(carry: PathCarry, t, idx, u, v, kind) -> ProbeDepth:
    plane = torch.zeros((t.shape[0], len(PROBE)), device=t.device)
    plane[:, 0:3] = carry.throughput
    return ProbeDepth(alive=carry.alive.clone(), state=carry.state.clone(),
                      ray_o=carry.ray_o.clone(), ray_d=carry.ray_d.clone(),
                      t=t, idx=idx, u=u, v=v, kind=kind, plane=plane)


def _probe_end(probe, rec: ProbeDepth, carry: PathCarry) -> None:
    rec.radiance = carry.radiance.clone()
    rec.medium_depth = carry.medium_depth.clone()
    probe.append(rec)


def trace_paths_fused(scene, uniforms, static, carry: PathCarry,
                      probe=None) -> int:
    """Depth loop without a light integral: the merged trace, in a
    textured scene the texture stage, the random walk on its lanes, then
    K2 ``full`` until ``max_depth`` or no lane is alive
    (``shade.py:2991-2995, 3152-3163``). Syncs once per depth on the alive
    count, which is also that depth's trace count (and once per walk
    step, and once per call for the texture stage's ``TexParams``). ``probe``, a list, receives one ``ProbeDepth`` per depth.
    Returns the traces issued."""
    params = ShadeParams.of(uniforms, static)
    textured = has_textures(scene, static) and scene.n_triangles > 0
    tex_params = TexParams.of(uniforms, static, scene.textures) \
        if textured else None
    rays = 0
    for depth in range(static.max_depth):
        with span("mpt.depth"):
            count("depths")
            n_alive = host_read(carry.alive.sum())
            if n_alive == 0:
                break
            rays += n_alive
            count("lanes.trace", n_alive)
            with span("mpt.trace"):
                t, idx, u, v, kind = _trace(scene, carry)
            rec = None if probe is None else _probe_depth(carry, t, idx, u,
                                                          v, kind)
            tex = None
            if textured:
                with span("mpt.texture"):
                    tex = texture_stage(carry, t, triangle_lanes(idx, kind),
                                        u, v, scene, uniforms, static, depth,
                                        tex_params, kind)
            # the full stage samples from its input state: the walk's fork
            with span("mpt.walk"):
                rw, rw_state = random_walks(scene, uniforms, static, carry, t,
                                            idx, u, v, kind)
            count("lanes.shade", n_alive)
            with span("mpt.shade"):
                shade_full(carry, t, idx, u, v, scene.triangles,
                           scene.materials, params, depth, kind=kind,
                           scene=scene, tex=tex, rw=rw, rw_state=rw_state,
                           probe=None if rec is None else rec.plane,
                           n_alive=n_alive)
            if rec is not None:
                _probe_end(probe, rec, carry)
    return rays


# ---------------------------------------------------------------------------
# Light integrals (rect lights, environment): stages s1 and s2
# ---------------------------------------------------------------------------

#: transient columns s1 -> s2 (``shade.py:1795``); u4-u6 carry the
#: environment's draws when rect and environment NEE run together
TRANS = ["u1", "u2", "u3", "lrough", "snx", "sny", "snz",
         "nfx", "nfy", "nfz", "px", "py", "pz", "active", "delta",
         "u4", "u5", "u6"]
TRANS_IDX = {n: i for i, n in enumerate(TRANS)}

#: one bank of light sample and occlusion columns per light integral,
#: light sample + shadow trace -> s2 (rect bank first)
ESMP = ["edx", "edy", "edz", "err", "erg", "erb", "epdf", "evalid", "occl"]

#: spec-NEE chain exports, s2 -> the chain estimators: an (N, 7) view of
#: plane-major (7, N) storage, like ``TRANS`` (``csrc/shade.cu N_CHAIN``)
CHAIN = ["wr", "wg", "wb", "dpdf", "medev", "active", "front"]
CHAIN_IDX = {n: i for i, n in enumerate(CHAIN)}


def shade_s1_reference(carry: PathCarry, t, tri, u, v, triangles, materials,
                       envbg, envpdf, params: ShadeParams, depth: int,
                       tex=None, kind=None, scene=None, rectpdf=None,
                       emod=None, probe=None):
    """Plain PyTorch K2 stage s1 (``_shade_kernel`` stage "s1",
    integrator body :280-460). ``envbg``/``envpdf``: the environment
    background and alias pdf of an environment light integral (None: the
    gradient or solid background, no MIS); ``rectpdf``: the rect-light
    pdf of each hit, under a rect-light integral; ``tex``: the texture
    planes; ``emod``: the environment seen along each hit's reversed
    shading normal, for ``emission_env`` lights (``env_modulation``).
    Updates ``carry`` in place and returns the (N,18) transients as a
    view of plane-major (18, N) storage, the kernel's layout."""
    del depth
    alive0 = carry.alive.clone()
    hit = tri >= 0
    miss = alive0 & ~hit

    # ---- miss: the environment with MIS against the alias pdf, or the
    # gradient/solid background -------------------------------------------
    if envbg is None:
        bg, mis = _background(carry.ray_d, params), torch.ones_like(t)
    else:
        w, denom = _mis_weight(carry.last_pdf, envpdf)
        use_mis = (~carry.last_delta | params.specular_mis) & (denom > 0.0)
        bg, mis = envbg, torch.where(use_mis, w, 1.0)
    bg_contrib = bsdf_ops.clamp_firefly_contribution(
        carry.throughput, bg * mis[:, None], params.clamp)
    radiance = where3(miss, carry.radiance + bg_contrib, carry.radiance)

    f = _shade_front(carry, t, tri, u, v, triangles, materials, params,
                     alive0 & hit, radiance, kind, scene, tex, rectpdf, emod)
    active = alive0 & hit & ~f.light
    surface_is_delta = bsdf_ops.material_is_delta(f.m)
    if probe is not None:
        hit_lanes = alive0 & hit
        probe[hit_lanes, 0:3] = f.throughput[hit_lanes]
        probe[hit_lanes & f.light, 3:6] = 0.0

    # ---- the NEE draws (3 per light integral, rect first): NEE lanes only
    nee_lanes = active & ~f.passthrough & ~surface_is_delta
    s_nee, u1 = rng_ops.rand_uniform(carry.state)
    s_nee, u2 = rng_ops.rand_uniform(s_nee)
    s_nee, u3 = rng_ops.rand_uniform(s_nee)
    zero = torch.zeros_like(u1)
    u4 = u5 = u6 = zero
    if envbg is not None and rectpdf is not None:
        s_nee, u4 = rng_ops.rand_uniform(s_nee)
        s_nee, u5 = rng_ops.rand_uniform(s_nee)
        s_nee, u6 = rng_ops.rand_uniform(s_nee)

    carry.state.copy_(torch.where(nee_lanes, s_nee, carry.state))
    carry.radiance.copy_(where3(alive0, f.radiance, carry.radiance))
    carry.throughput.copy_(where3(active, f.throughput, carry.throughput))
    # misses end their path here; s2 then sees only live hits
    carry.prev_valid.copy_(carry.prev_valid & ~miss)
    carry.prev_mesh.copy_(torch.where(miss, -1, carry.prev_mesh))
    carry.prev_prim.copy_(torch.where(miss, -1, carry.prev_prim))
    carry.alive.copy_(active)

    trans = torch.stack(
        [u1, u2, u3, bsdf_ops.environment_lighting_roughness(f.m),
         *f.sn.unbind(-1), *f.rec.normal.unbind(-1),
         *f.rec.point.unbind(-1), active.to(torch.float32),
         surface_is_delta.to(torch.float32), u4, u5, u6])
    return torch.where(active, trans, 0.0).t()


def shade_s2_reference(carry: PathCarry, t, tri, u, v, triangles, materials,
                       trans, esmp, params: ShadeParams, depth: int,
                       tex=None, kind=None, scene=None, rw=None,
                       rw_state=None, probe=None, fork=False):
    """Plain PyTorch K2 stage s2 (``_shade_kernel`` stage "s2",
    integrator body :461-716). ``esmp`` holds one 9-column bank per light
    integral, rect first; ``rw``/``rw_state`` the random-walk override
    planes and states (``RW``). Updates ``carry`` in place and returns the
    (N,7) chain exports as a view of plane-major (7, N) storage, the
    kernel's layout, zero off the lanes alive on entry; with ``fork``,
    (chain, fork state): the (N,) int64 RNG state at the chain's fork
    point (``shade.py:2319-2333``, ``chain_state``), after the BSDF
    sample commits and before the roulette draw, the entry state on the
    lanes not alive on entry."""
    alive0 = carry.alive.clone()    # after s1: the live hits
    active = alive0
    sn = trans[:, 4:7]
    n_faced = trans[:, 7:10]
    point = trans[:, 10:13]
    rec = rebuild_hit(carry.ray_o, carry.ray_d, triangles, t, tri, u, v,
                      kind, scene)
    m, _, occlusion, passthrough, _ = _textured(
        bsdf_ops.gather_material(materials, rec.material), tex, params)
    incident = normalize(carry.ray_d)
    wo = -incident
    throughput = carry.throughput
    radiance = carry.radiance

    # ---- NEE adds: one bank per light integral, MIS against the BSDF ----
    nee_lanes = active & (trans[:, TRANS_IDX["delta"]] < 0.5) & ~passthrough
    for bank in esmp.split(len(ESMP), 1):
        e_dir, e_rad, e_pdf = bank[:, 0:3], bank[:, 3:6], bank[:, 6]
        e_valid, occluded = bank[:, 7] > 0.5, bank[:, 8] > 0.5
        n_dot_l = torch.clamp_min(dot(sn, e_dir), 0.0)
        do_shadow = nee_lanes & e_valid & (e_pdf > 0.0) & (n_dot_l > 0.0)
        ev = bsdf_ops.evaluate_bsdf(m, sn, wo, e_dir, params.clamp,
                                    occlusion, params.material_types,
                                    position=point,
                                    specular_only=params.specular_only)
        w, _ = _mis_weight(e_pdf, ev.pdf)
        w = torch.where(ev.pdf > 0.0, w, 1.0)
        contribution = e_rad * ev.value * n_dot_l[:, None] \
            * fdiv(w, torch.clamp_min(e_pdf, 1e-30))[:, None]
        add = (do_shadow & ~occluded & ~ev.is_delta & ~ev.is_bssrdf
               & (_max3(ev.value) > 0.0)
               & torch.isfinite(contribution).all(-1))
        radiance = radiance + where3(
            add, bsdf_ops.clamp_firefly_contribution(throughput, contribution,
                                                     params.clamp),
            torch.zeros_like(contribution))

    # ---- BSDF sample from the post-s1 state ------------------------------
    nstate, smp = bsdf_ops.sample_bsdf(
        m, sn, wo, incident, rec.front_face, carry.state, params.clamp,
        occlusion, params.material_types, position=point,
        sss_mode=params.sss_mode, specular_only=params.specular_only)
    smp, nstate = _rw_override(smp, nstate, rw, rw_state)
    state = torch.where(active & ~passthrough, nstate, carry.state)
    smp = _passthrough_sample(smp, passthrough, carry.ray_d)
    _probe_sample(probe, alive0, smp)
    active = active & (smp.pdf > 0.0)
    chain = torch.stack([*smp.weight.unbind(-1), smp.directional_pdf,
                         smp.medium_event.to(torch.float32),
                         (active & ~passthrough).to(torch.float32),
                         rec.front_face.to(torch.float32)])
    stack, medium_depth = _medium_update(carry, smp, m, active)
    next_origin = _next_origin(point, sn, n_faced, t, smp, params)

    # ---- throughput, environment LOD, ray cone ---------------------------
    throughput = bsdf_ops.clamp_path_throughput(throughput * smp.weight,
                                                params.clamp)
    max_tp = _max3(throughput)
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
    cone_width, cone_spread = _cone_update(carry, t, smp, active)
    last_pdf = torch.where(smp.directional_pdf > 0.0, smp.directional_pdf,
                           smp.pdf)
    fork_state = state
    state, throughput, active = _roulette(params, depth, state, throughput,
                                          max_tp, active, passthrough)

    # ---- commit: the live hits only --------------------------------------
    h = alive0
    is_tri = rec.prim_type == C.PRIMITIVE_TRIANGLE
    carry.state.copy_(torch.where(h, state, carry.state))
    carry.ray_o.copy_(where3(h, next_origin, carry.ray_o))
    carry.ray_d.copy_(where3(h, smp.direction, carry.ray_d))
    carry.throughput.copy_(where3(h, throughput, carry.throughput))
    carry.radiance.copy_(where3(h, radiance, carry.radiance))
    carry.alive.copy_(h & active)
    carry.last_pdf.copy_(torch.where(h, last_pdf, carry.last_pdf))
    carry.last_delta.copy_(torch.where(h, smp.is_delta, carry.last_delta))
    carry.prev_valid.copy_(carry.prev_valid | h)
    carry.prev_mesh.copy_(torch.where(
        h, torch.where(is_tri, rec.mesh_index, -1), carry.prev_mesh))
    carry.prev_prim.copy_(torch.where(
        h, torch.where(is_tri, rec.prim_index, -1), carry.prev_prim))
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
    chain = torch.where(h, chain, 0.0).t()
    return (chain, fork_state) if fork else chain


def _check_tex(name, tex, n):
    if tex is not None:
        build.check_planes(name, tex, n, len(TEX))


def shade_s1(carry: PathCarry, t, tri, u, v, triangles, materials, envbg,
             envpdf, params: ShadeParams, depth: int, tex=None, kind=None,
             scene=None, rectpdf=None, emod=None, probe=None):
    """Stage s1, in place on ``carry``; returns the (N,18) transients,
    plane-major (zero on lanes that are not live hits afterwards).
    ``envbg``/``envpdf`` for an environment light integral (None without
    one), ``rectpdf`` for a rect-light integral, ``tex`` the texture
    planes of a textured scene, ``emod`` the environment modulation of
    ``emission_env`` lights, ``kind``/``scene``/``probe`` as in
    ``shade_full``. CPU tensors take the plain version; CUDA tensors
    launch K2 s1."""
    dev = t.device
    if dev.type == "cpu":
        return shade_s1_reference(carry, t, tri, u, v, triangles, materials,
                                  envbg, envpdf, params, depth, tex, kind,
                                  scene, rectpdf, emod, probe)
    if dev.type != "cuda":
        raise ValueError(f"shade_s1: unsupported device {dev}")
    _check_tex("shade_s1", tex, t.shape[0])
    out = _launch("shade_s1", carry, t, tri, u, v, triangles, materials,
                  kind, scene, [envbg, envpdf, rectpdf, emod, tex],
                  len(TRANS), params, depth, probe=probe, plane_inputs=(4,),
                  plane_out=True)
    shade_s1.launches += 1
    return out


def shade_s2(carry: PathCarry, t, tri, u, v, triangles, materials, trans,
             esmp, params: ShadeParams, depth: int, tex=None, kind=None,
             scene=None, rw=None, rw_state=None, probe=None, fork=False):
    """Stage s2, in place on ``carry``; returns the (N,7) chain exports,
    plane-major (zero on lanes that were not live hits), and with
    ``fork`` (MNEE's secondary chain) also the (N,) int64 fork state
    (``shade_s2_reference``). ``trans``: s1's plane-major transients;
    ``esmp``: one 9-column bank per light integral, rect first;
    ``rw``/``rw_state`` the random-walk override, ``probe`` the probe
    plane. CPU tensors take the plain version; CUDA tensors launch K2 s2:
    the base instantiation after its listing pass (the lanes alive after
    s1; the chain zeros and, with ``fork``, the entry states of the
    others) over the listed lanes, the extended one a thread per lane."""
    dev = t.device
    if dev.type == "cpu":
        return shade_s2_reference(carry, t, tri, u, v, triangles, materials,
                                  trans, esmp, params, depth, tex, kind,
                                  scene, rw, rw_state, probe, fork)
    if dev.type != "cuda":
        raise ValueError(f"shade_s2: unsupported device {dev}")
    _check_tex("shade_s2", tex, t.shape[0])
    _check_rw("shade_s2", rw, rw_state, t.shape[0])
    if esmp.shape[1] not in (len(ESMP), 2 * len(ESMP)):
        raise ValueError("shade_s2: esmp holds one or two banks")
    build.check_planes("shade_s2", trans, t.shape[0], len(TRANS))
    fork_state = torch.empty(t.shape[0], dtype=torch.int64, device=dev) \
        if fork else None
    out = _launch("shade_s2", carry, t, tri, u, v, triangles, materials,
                  kind, scene, [trans, esmp.contiguous(), tex, rw, rw_state],
                  len(CHAIN), params, depth, esmp.shape[1] // len(ESMP),
                  probe=probe, plane_inputs=(0, 2), plane_out=True,
                  listed=True, scratch=None if params.extended
                  else build.list_scratch(t.shape[0], dev),
                  extra_out=(fork_state,))
    shade_s2.launches += 1
    return (out, fork_state) if fork else out


#: K2 s1/s2 launches since the last reset
shade_s1.launches = 0
shade_s2.launches = 0


def nee_shadow_rays(trans, t, e_dir, e_pdf, e_valid, tex=None,
                    t_max=C.INFINITY_T):
    """The NEE shadow rays of a wavefront from the s1 exports, a light
    sample and the texture planes' pass-through flags
    (``shade.py:3251-3269``): (origin, t_max, traced lanes), t_max 0 on
    lanes that trace nothing. ``t_max``: the window of a traced lane (a
    rect light's distance less epsilon)."""
    sn = trans[:, 4:7]
    nee_lanes = (trans[:, TRANS_IDX["active"]] > 0.5) \
        & (trans[:, TRANS_IDX["delta"]] < 0.5)
    if tex is not None:
        nee_lanes = nee_lanes & (tex[:, TEX_IDX["tpass"]] < 0.5)
    do_sh = nee_lanes & e_valid & (e_pdf > 0.0) \
        & (torch.clamp_min(dot(sn, e_dir), 0.0) > 0.0)
    origin = offset_origin(trans[:, 10:13], sn, trans[:, 7:10], t, e_dir)
    # the planes' (N,3) views give a plane-major origin: the traces take
    # contiguous rays
    return origin.contiguous(), torch.where(do_sh, t_max, 0.0), do_sh


def env_modulation(scene, uniforms, static, carry: PathCarry, t, idx, u, v,
                   kind):
    """The ``emod`` plane of one depth (``shade.py:3210-3234``;
    integrator body :435-442): the environment seen along each hit's
    reversed shading normal, by which s1 scales the emission of the front
    faces of ``emission_env`` lights."""
    rec = rebuild_hit(carry.ray_o, carry.ray_d, scene.triangles, t, idx, u,
                      v, kind, scene)
    sn = rec.shading_normal
    bad = ~torch.isfinite(sn).all(-1) | (dot(sn, sn) <= 0.0)
    return env_ops.environment_color(
        scene.environment, -where3(bad, rec.normal, sn),
        uniforms.environment_rotation, uniforms.environment_intensity,
        static)


def light_banks(scene, uniforms, static, trans, t, tex=None):
    """Per light integral (rect first, ``shade.py:3251-3290``) the light
    sample from s1's draws and its shadow trace: the ESMP columns s2
    reads (one bank of ``len(ESMP)`` per integral) and the shadow traces
    issued, a 0-dim tensor."""
    banks = []
    shadow = torch.zeros((), dtype=torch.int64, device=t.device)
    rects = integrator.rect_nee(scene)

    def bank(l_dir, l_rad, l_pdf, l_valid, t_max):
        nonlocal shadow
        l_dir = l_dir.contiguous()
        sh_o, sh_max, do_sh = nee_shadow_rays(trans, t, l_dir, l_pdf,
                                              l_valid, tex, t_max)
        occ = trace_occluded(sh_o, l_dir, scene, C.EPSILON_T, sh_max)
        shadow = shadow + do_sh.sum()
        banks.append(torch.cat([l_dir, l_rad, l_pdf[:, None],
                                l_valid[:, None].to(torch.float32),
                                occ[:, None].to(torch.float32)], 1))

    if rects:
        l_dir, l_dist, l_pdf, l_em, l_valid = \
            integrator.rect_light_sample_from_uniforms(
                scene, trans[:, 10:13], trans[:, 0], trans[:, 1],
                trans[:, 2], uniforms, static)
        bank(l_dir, l_em, l_pdf, l_valid,
             torch.clamp_min(l_dist - C.EPSILON_T, C.EPSILON_T))
    if integrator.env_nee(scene, static):
        k = TRANS_IDX["u4"] if rects else TRANS_IDX["u1"]
        e_dir, e_rad, e_pdf, e_valid = \
            env_ops.sample_environment_from_uniforms(
                scene.environment, trans[:, k], trans[:, k + 1],
                trans[:, k + 2], uniforms, static)
        bank(e_dir, e_rad, e_pdf, e_valid, C.INFINITY_T)
    return torch.cat(banks, 1), shadow


def hit_material(scene, idx, kind, materials):
    """The material type of each lane's hit from its (kind, index): a
    triangle's, a sphere's, a rectangle's or a placement's material
    (``kind`` None: every hit is a triangle); misses read material 0."""
    mat = torch.zeros_like(idx)
    if scene.instanced and kind is not None:
        rows = instance_table(scene.instanced).table.view(torch.int32)
        k = torch.clamp(kind - KIND_INSTANCE, 0, rows.shape[0] - 1).long()
        mat = torch.where(kind >= KIND_INSTANCE, rows[k, INST_MAT], mat)
    for family, count, prims in (
            (C.PRIMITIVE_TRIANGLE, scene.n_triangles, scene.triangles),
            (C.PRIMITIVE_SPHERE, scene.n_spheres, scene.spheres),
            (C.PRIMITIVE_RECTANGLE, scene.n_rects, scene.rects)):
        if not count or (kind is None and family != C.PRIMITIVE_TRIANGLE):
            continue
        lanes = idx >= 0 if kind is None else kind == family
        own = prims.material[torch.clamp(idx, 0, count - 1).long()]
        mat = torch.where(lanes, own, mat)
    return materials.mat_type[torch.clamp(mat, 0, materials.count - 1)
                              .long()]


def trace_paths_nee(scene, uniforms, static, carry: PathCarry, probe=None):
    """The depth loop under one or two light integrals (``trace_paths_fused``
    's NEE branch, ``shade.py:3165-3351``): the merged trace, in a textured
    scene the texture stage (``shade.py:3023-3063``), the environment
    background and pdf of the wavefront, the rect-light pdf of each hit,
    the environment modulation of ``emission_env`` lights, K2 s1, the
    random walk from the post-s1 state, the light banks (``light_banks``:
    per light integral its sample from s1's draws and a shadow trace), K2
    s2 and the spec-NEE estimators. One host sync per depth (the alive
    count, and one per walk step; one per call for the texture stage's
    ``TexParams``); the shadow count stays on the device.
    ``probe``, a list, receives one ``ProbeDepth`` per depth. Returns
    (traces issued,
    shadow traces as a 0-dim tensor); the spec-NEE rect estimator's scene
    traces count as traces."""
    env = scene.environment if integrator.env_nee(scene, static) else None
    rects = integrator.rect_nee(scene)
    params = ShadeParams.of(uniforms, static, env)
    mats = scene.materials
    modulated = env is not None \
        and C.MATERIAL_DIFFUSE_LIGHT in static.material_types \
        and host_read(((mats.mat_type == C.MATERIAL_DIFFUSE_LIGHT)
                       & (mats.emission_env > 0.0)).any(), bool)
    # only triangles carry texture coordinates
    textured = has_textures(scene, static) and scene.n_triangles > 0
    tex_params = TexParams.of(uniforms, static, scene.textures) \
        if textured else None
    rot = uniforms.environment_rotation
    # MNEE's secondary chain samples from s2's fork-state export
    fork = static.enable_mnee and static.enable_mnee_secondary
    rays = 0
    dev = carry.ray_o.device
    shadow = torch.zeros((), dtype=torch.int64, device=dev)
    chain_rays = torch.zeros((), dtype=torch.int64, device=dev)
    for depth in range(static.max_depth):
        with span("mpt.depth"):
            count("depths")
            n_alive = host_read(carry.alive.sum())
            if n_alive == 0:
                break
            rays += n_alive
            count("lanes.trace", n_alive)
            with span("mpt.trace"):
                t, idx, u, v, kind = _trace(scene, carry)
            rec = None if probe is None else _probe_depth(carry, t, idx, u,
                                                          v, kind)
            plane = None if rec is None else rec.plane
            # the alpha-BLEND draw lands before s1's NEE draws
            tex = None
            if textured:
                with span("mpt.texture"):
                    tex = texture_stage(carry, t, triangle_lanes(idx, kind),
                                        u, v, scene, uniforms, static, depth,
                                        tex_params, kind)
            envbg = envpdf = rectpdf = None
            with span("mpt.light"):
                if env is not None:
                    # miss lanes read these; every lane computes them
                    # (value-identical to the reference's skip when no
                    # lane missed)
                    envbg = env_ops.environment_background(
                        env, carry.ray_d, uniforms, static, carry.env_lod,
                        carry.env_lod_active)
                    envpdf = env_ops.environment_pdf(env, carry.ray_d, rot)
                if rects:
                    rectpdf = integrator.rect_light_pdf_for_hit(
                        scene, analytic_point(carry.ray_o, t, carry.ray_d),
                        kind, idx, carry.ray_o)
                emod = env_modulation(scene, uniforms, static, carry, t, idx,
                                      u, v, kind) if modulated else None
            count("lanes.shade", n_alive)
            with span("mpt.shade"):
                trans = shade_s1(carry, t, idx, u, v, scene.triangles,
                                 scene.materials, envbg, envpdf, params,
                                 depth, tex, kind=kind, scene=scene,
                                 rectpdf=rectpdf, emod=emod, probe=plane)
            # s2 samples from the post-s1 state: the walk's fork
            with span("mpt.walk"):
                rw, rw_state = random_walks(scene, uniforms, static, carry, t,
                                            idx, u, v, kind)
            with span("mpt.light"):
                esmp, n_shadow = light_banks(scene, uniforms, static, trans,
                                             t, tex)
            shadow = shadow + n_shadow

            throughput_s1 = carry.throughput.clone()
            with span("mpt.shade"):
                chain = shade_s2(carry, t, idx, u, v, scene.triangles,
                                 scene.materials, trans, esmp, params, depth,
                                 tex, kind=kind, scene=scene, rw=rw,
                                 rw_state=rw_state, probe=plane, fork=fork)
            chain, fork_state = chain if fork else (chain, None)

            # ---- spec-NEE and MNEE: the lights through the delta bounce -
            # (``_apply_delta_chains``, shade.py:2780-2822)
            with span("mpt.chain"):
                dielectric = hit_material(scene, idx, kind, mats) \
                    == C.MATERIAL_DIELECTRIC if static.enable_mnee else None
                add, n_scene, n_shadow = specnee.delta_chain_estimators(
                    scene, uniforms, static, params.clamp, throughput_s1,
                    carry.ray_d, carry.last_delta, chain[:, 0:3],
                    chain[:, CHAIN_IDX["dpdf"]], chain[:, CHAIN_IDX["medev"]],
                    carry.ray_o, chain[:, CHAIN_IDX["active"]] > 0.5,
                    chain[:, CHAIN_IDX["front"]] > 0.5, trans[:, 4:7],
                    carry.specular_depth, fork_state, dielectric)
                carry.radiance.add_(add)
            shadow = shadow + n_shadow
            chain_rays = chain_rays + n_scene
            if rec is not None:
                _probe_end(probe, rec, carry)
    return rays + host_read(chain_rays), shadow
