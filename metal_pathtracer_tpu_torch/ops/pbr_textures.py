"""PBR texture pipeline: per-hit sampling of the six material texture
slots with ray-cone LOD, normal mapping, occlusion and alpha modes (the
port of the JAX package's ``ops/pbr_textures.py``, reference:
shaders/pathtrace.metal:5919-6424):

- UV0/UV1/tangent interpolation from the triangle corners with saturated
  barycentrics (:597-933);
- texture LOD from Igehy ray-differential UV gradients on the first hit
  (:203-257), from the ray-cone footprint over the triangle's UV density
  beyond it (triangle_surface_partials:750-817);
- base colour, ORM, transmission, occlusion, emissive and the normal map
  with its tangent or ONB basis and Toksvig-style roughness widening
  (:6086-6395), KHR transforms, dual UV sets, working-space conversion;
- alpha MASK and BLEND (:6203-6228): BLEND lanes take one RNG draw;
  discarded lanes pass through as a delta bounce.

Slots that no material binds (``static.texture_slots``) take their
defaults without a gather, and UV set 1 and the tangents are read only
when some material needs them, as in the JAX package. The fused
multiply-adds that the reference's XLA:CPU build contracts are spelled
out with ``vecmath.fma``; ``csrc/texture.cu`` repeats this arithmetic per
lane.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops import rng as rng_ops
from metal_pathtracer_tpu_torch.ops import textures as tex_ops
from metal_pathtracer_tpu_torch.ops.integrator import to_working_space
from metal_pathtracer_tpu_torch.ops.vecmath import (
    build_onb,
    cross,
    dot,
    fdiv,
    fma,
    normalize,
    safe_normalize,
    where3,
)

SLOT_BASE, SLOT_MR, SLOT_NORMAL, SLOT_OCCLUSION, SLOT_EMISSIVE, \
    SLOT_TRANSMISSION = range(6)


class PbrTextureResult(NamedTuple):
    """The textured overrides of each lane (non-PBR lanes keep their
    material's values)."""

    base_color: torch.Tensor         # (N,3)
    roughness: torch.Tensor
    metallic: torch.Tensor
    transmission: torch.Tensor
    emissive: torch.Tensor           # (N,3) for the additive term
    shading_normal: torch.Tensor     # (N,3)
    diffuse_occlusion: torch.Tensor
    passthrough: torch.Tensor        # lanes discarded by alpha
    pbr_lane: torch.Tensor           # PBR triangle lanes
    state: torch.Tensor


def _bary_weights(u, v):
    """Saturated, renormalised barycentric weights (N,3)."""
    w = torch.clamp_min(torch.stack([(1.0 - u) - v, u, v], -1), 0.0)
    s = (w[..., 0:1] + w[..., 1:2]) + w[..., 2:3]
    fallback = torch.tensor([1.0, 0.0, 0.0], device=w.device)
    return torch.where(s > 1e-8, w / s, fallback)


def _interp(w, a0, a1, a2):
    return fma(w[..., 2:3], a2, fma(w[..., 0:1], a0, w[..., 1:2] * a1))


def _corners(tris, tri, uv_set: int):
    names = ("uv0", "uv1", "uv2") if uv_set == 0 else ("uvb0", "uvb1", "uvb2")
    return [getattr(tris, nm)[tri] for nm in names]


def _uv_per_world(v0, v1, v2, uv0, uv1, uv2):
    """UV units per world unit (reference: triangle_surface_partials
    :750-817), 0 where degenerate."""
    e1 = v1 - v0
    e2 = v2 - v0
    duv1 = uv1 - uv0
    duv2 = uv2 - uv0
    det = fma(duv1[..., 0], duv2[..., 1], -(duv1[..., 1] * duv2[..., 0]))
    inv_det = fdiv(1.0, torch.where(det.abs() > 1e-9, det, 1.0))
    dpdu = fma(e1, duv2[..., 1:2], -(e2 * duv1[..., 1:2])) * inv_det[..., None]
    dpdv = fma(e2, duv1[..., 0:1], -(e1 * duv2[..., 0:1])) * inv_det[..., None]
    len_u = torch.sqrt(torch.clamp_min(dot(dpdu, dpdu), 1e-30))
    len_v = torch.sqrt(torch.clamp_min(dot(dpdv, dpdv), 1e-30))
    primary = torch.maximum(fdiv(1.0, len_u), fdiv(1.0, len_v))
    n = cross(e1, e2)
    world_area = torch.sqrt(torch.clamp_min(dot(n, n), 1e-30))
    fallback = torch.sqrt(det.abs() / torch.clamp_min(world_area, 1e-12))
    ok = (det.abs() > 1e-9) & (len_u > 1e-8) & (len_v > 1e-8)
    out = torch.where(ok, primary, fallback)
    return torch.where(torch.isfinite(out) & (out > 0.0), out, 0.0)


def _transform_scale(tf):
    r0 = torch.sqrt(fma(tf[..., 0, 0], tf[..., 0, 0],
                        tf[..., 0, 1] * tf[..., 0, 1]))
    r1 = torch.sqrt(fma(tf[..., 1, 0], tf[..., 1, 0],
                        tf[..., 1, 1] * tf[..., 1, 1]))
    return torch.clamp_min(torch.maximum(r0, r1), 1e-6)


def _igehy_uv_gradient(v0, v1, v2, uv0, uv1, uv2, n, d, t, ddx, ddy):
    """First-hit UV gradient by ray differentials (reference:
    pathtrace.metal:203-257): the pinhole pixel differentials moved onto
    the hit triangle's plane, then the barycentric solve for duv/dx and
    duv/dy. max(|duv/dx|, |duv/dy|), 0 where degenerate."""
    e1 = v1 - v0
    e2 = v2 - v0
    duv1 = uv1 - uv0
    duv2 = uv2 - uv0
    dn = dot(d, n)
    safe_dn = torch.where(dn.abs() > 1e-12, dn,
                          torch.where(dn >= 0, 1e-12, -1e-12))

    def transfer(dd):
        k = fdiv(dot(dd, n), safe_dn)[..., None]
        return t[..., None] * fma(-k, d, dd)

    e11 = dot(e1, e1)
    e12 = dot(e1, e2)
    e22 = dot(e2, e2)
    det = fma(e11, e22, -(e12 * e12))
    inv = fdiv(1.0, torch.where(det.abs() > 1e-20, det, 1.0))

    def uv_grad(dp):
        p1 = dot(dp, e1)
        p2 = dot(dp, e2)
        a = fma(p1, e22, -(p2 * e12)) * inv
        b = fma(p2, e11, -(p1 * e12)) * inv
        g = fma(a[..., None], duv1, b[..., None] * duv2)
        return torch.sqrt(torch.clamp_min(
            fma(g[..., 1], g[..., 1], g[..., 0] * g[..., 0]), 0.0))

    grad = torch.maximum(uv_grad(transfer(ddx)), uv_grad(transfer(ddy)))
    ok = (det.abs() > 1e-20) & (dn.abs() > 1e-12) & torch.isfinite(grad)
    return torch.where(ok, grad, 0.0)


def apply_pbr_textures(scene, mat_index, rec, wo, cone_width, depth: int,
                       state, static, uniforms, ray_d) -> PbrTextureResult:
    """The six texture slots on the PBR triangle lanes of a wavefront.

    ``mat_index`` is each lane's material row, ``rec`` its hit record,
    ``cone_width`` the ray cone's width at the hit. At ``depth`` 0 the
    LOD comes from Igehy gradients of ``ray_d``, deeper from the cone.
    Non-PBR lanes keep their material's values; BLEND lanes advance
    ``state`` by one draw."""
    mats = scene.materials
    textures = scene.textures
    tris = scene.triangles
    shape = rec.t.shape
    dev = rec.t.device
    mi = torch.clamp(mat_index, 0, mats.count - 1).long()
    g = lambda name: getattr(mats, name)[mi]
    mat_type = g("mat_type")
    shading_normal = rec.shading_normal
    ones = torch.ones(shape, device=dev)
    pbr_lane = (mat_type == C.MATERIAL_PBR) & \
        (rec.prim_type == C.PRIMITIVE_TRIANGLE)

    tri = torch.clamp(rec.prim_index, 0, tris.count - 1).long()
    w = _bary_weights(rec.barycentric[..., 0], rec.barycentric[..., 1])
    v0, v1, v2 = tris.v0[tri], tris.v1[tri], tris.v2[tri]
    corners = [_corners(tris, tri, 0)]
    if static.texture_uv1:
        corners.append(_corners(tris, tri, 1))
    uvs = [_interp(w, *c) for c in corners]
    upw = [_uv_per_world(v0, v1, v2, *c) for c in corners]
    if SLOT_NORMAL in static.texture_slots:
        tangent = _interp(w, tris.t0[tri], tris.t1[tri], tris.t2[tri])
    else:
        tangent = torch.zeros(shape + (4,), device=dev)
    cos_view = dot(normalize(shading_normal), normalize(wo)).abs()
    footprint = fdiv(cone_width, torch.clamp_min(cos_view, 1e-3))
    if depth == 0:
        cam = uniforms.camera
        ddx = fdiv(cam.horizontal, float(static.width)).expand_as(ray_d)
        ddy = fdiv(-cam.vertical, float(static.height)).expand_as(ray_d)
        igehy = [_igehy_uv_gradient(v0, v1, v2, *c, rec.normal, ray_d,
                                    rec.t, ddx, ddy) for c in corners]
    else:
        igehy = [torch.zeros(shape, device=dev)] * len(corners)
    # UV set 1 falls back to set 0 when no material addresses it
    uv_b, upw_b, igehy_b = uvs[-1], upw[-1], igehy[-1]
    max_lod = textures.max_lod
    tex_idx, tex_uv, tex_tf = g("texture_indices"), g("texture_uv_set"), \
        g("texture_transform")

    def slot_sample(slot, default=(1.0, 1.0, 1.0, 1.0)):
        """(rgba, valid) of one slot: UV set, KHR transform, LOD."""
        fill = torch.tensor(default, device=dev).expand(shape + (4,))
        if slot not in static.texture_slots:
            return fill, torch.zeros(shape, dtype=torch.bool, device=dev)
        tid = tex_idx[..., slot]
        set1 = tex_uv[..., slot] == 1
        uv = where3(set1, uv_b, uvs[0])
        tf = tex_tf[..., slot, :, :]
        u, v = tex_ops.apply_uv_transform(tf, uv[..., 0], uv[..., 1])
        tscale = _transform_scale(tf)
        tex_size = tex_ops.texture_lod_scale(textures, tid)
        texel_cone = footprint * (torch.where(set1, upw_b, upw[0]) * tscale) \
            * tex_size
        g_lane = torch.where(set1, igehy_b, igehy[0]) * tscale
        texel = torch.where((depth == 0) & (g_lane > 0.0), g_lane * tex_size,
                            texel_cone)
        lod = torch.clamp(torch.log2(torch.clamp_min(texel, 1e-7)), 0.0,
                          max_lod)
        rgba = tex_ops.sample_texture(textures, tid, u, v, lod=lod)
        valid = tid >= 0
        return torch.where(valid[..., None], rgba, fill), valid

    # ---- base colour (reference :6086-6111) ----------------------------
    base_factor = to_working_space(torch.clamp(g("base_color"), 0.0, 1.0),
                                   static)
    base_rgba, _ = slot_sample(SLOT_BASE)
    base_color = base_factor * to_working_space(base_rgba[..., :3], static)

    # ---- ORM (reference :6113-6152) ------------------------------------
    metallic = torch.clamp(g("pbr_metallic"), 0.0, 1.0)
    roughness = torch.clamp(g("roughness"), 0.0, 1.0)
    disable_orm = (g("material_flags") & 1) == 1
    orm_rgba, orm_valid = slot_sample(SLOT_MR)
    use_orm = orm_valid & ~disable_orm
    if static.debug_disable_orm:
        use_orm = torch.zeros_like(use_orm)
    metallic = torch.where(
        use_orm, torch.clamp(orm_rgba[..., 2] * metallic, 0.0, 1.0), metallic)
    roughness = torch.where(
        use_orm, torch.clamp(orm_rgba[..., 1] * roughness, 0.0, 1.0),
        roughness)

    # ---- transmission (reference :6180-6202) ---------------------------
    transmission = torch.clamp(g("pbr_transmission"), 0.0, 1.0)
    tr_rgba, tr_valid = slot_sample(SLOT_TRANSMISSION)
    transmission = torch.where(
        tr_valid, torch.clamp(transmission * tr_rgba[..., 0], 0.0, 1.0),
        transmission)
    transmission = transmission * (1.0 - metallic)

    # ---- alpha modes (reference :6203-6228) ----------------------------
    alpha = torch.clamp(g("pbr_alpha"), 0.0, 1.0) \
        * torch.clamp(base_rgba[..., 3], 0.0, 1.0)
    alpha_mode = g("pbr_alpha_mode")
    state_b, xi = rng_ops.rand_uniform(state)
    state = torch.where(pbr_lane & (alpha_mode > 1.5), state_b, state)
    discard = torch.where(
        alpha_mode > 1.5, xi > alpha,
        (alpha_mode > 0.5)
        & (alpha < torch.clamp(g("pbr_alpha_cutoff"), 0.0, 1.0)))
    passthrough = pbr_lane & discard

    # ---- occlusion (reference :6229-6255) ------------------------------
    occ_rgba, occ_valid = slot_sample(SLOT_OCCLUSION)
    use_occ = occ_valid & ~disable_orm
    occlusion = torch.where(
        use_occ, fma(occ_rgba[..., 0] - 1.0,
                     torch.clamp(g("pbr_occlusion_strength"), 0.0, 1.0), 1.0),
        1.0)
    diffuse_occlusion = ones if static.debug_disable_ao else occlusion
    if static.debug_ao_indirect_only and depth == 0:
        diffuse_occlusion = ones

    # ---- emissive (reference :6260-6287) -------------------------------
    base_emissive = to_working_space(g("emission"), static)
    em_rgba, em_valid = slot_sample(SLOT_EMISSIVE)
    em_sample = to_working_space(em_rgba[..., :3], static)
    emissive = base_emissive * torch.where(em_valid[..., None], em_sample,
                                           1.0)

    # ---- normal map (reference :6289-6395) -----------------------------
    normal_scale = g("pbr_normal_scale") * uniforms.debug_normal_strength_scale
    nm_rgba, nm_valid = slot_sample(SLOT_NORMAL, default=(0.5, 0.5, 1.0, 1.0))
    use_nm = nm_valid & (normal_scale > 1e-4)
    if static.debug_disable_normal_map:
        use_nm = torch.zeros_like(use_nm)
    n_ts = fma(nm_rgba[..., :3], 2.0, -1.0)
    if static.debug_flip_normal_green:
        n_ts = n_ts * torch.tensor([1.0, -1.0, 1.0], device=dev)
    n_ts = torch.cat([n_ts[..., :2] * normal_scale[..., None],
                      n_ts[..., 2:3]], -1)
    normal_length = torch.sqrt(torch.clamp_min(dot(n_ts, n_ts), 1e-12))
    xy2 = fma(n_ts[..., 0], n_ts[..., 0], n_ts[..., 1] * n_ts[..., 1])
    n_z = torch.sqrt(torch.clamp_min(1.0 - xy2, 0.0))
    n_ts = safe_normalize(torch.cat([n_ts[..., :2], n_z[..., None]], -1))

    # tangent basis: the vertex tangent (Gram-Schmidt) or the ONB fallback
    t_raw = tangent[..., :3]
    trust = (tangent[..., 3].abs() > 0.5) & torch.isfinite(t_raw).all(-1) \
        & (dot(t_raw, t_raw) > 1e-6)
    t_gs = fma(-shading_normal, dot(shading_normal, t_raw)[..., None], t_raw)
    t_ok = trust & (dot(t_gs, t_gs) > 1e-6)
    t_gs = safe_normalize(t_gs)
    sign = torch.where(tangent[..., 3] < 0.0, -1.0, 1.0)
    b_gs = safe_normalize(cross(shading_normal, t_gs)) * sign[..., None]
    t_onb, b_onb = build_onb(shading_normal)
    t_basis = where3(t_ok, t_gs, t_onb)
    b_basis = where3(t_ok, b_gs, b_onb)
    mapped = normalize(_interp(n_ts, t_basis, b_basis, shading_normal))
    mapped = where3(dot(mapped, rec.normal) < 0.0, -mapped, mapped)
    mapped_lane = pbr_lane & use_nm
    new_normal = where3(mapped_lane, mapped, shading_normal)

    # Toksvig-style roughness widening from the normal's shortening
    tok = torch.clamp_min(fdiv(1.0 - normal_length,
                               torch.clamp_min(normal_length, 1e-6)), 0.0)
    roughness = torch.where(
        mapped_lane,
        torch.clamp(torch.sqrt(fma(roughness, roughness, tok)), 0.0, 1.0),
        roughness)

    # ---- write back (reference :6397-6401) -----------------------------
    return PbrTextureResult(
        base_color=where3(pbr_lane, base_color, g("base_color")),
        roughness=torch.where(pbr_lane, roughness, g("roughness")),
        metallic=torch.where(pbr_lane, metallic, g("pbr_metallic")),
        transmission=torch.where(pbr_lane, transmission,
                                 g("pbr_transmission")),
        emissive=where3(pbr_lane, emissive, base_emissive),
        shading_normal=new_normal,
        diffuse_occlusion=torch.where(pbr_lane, diffuse_occlusion, ones),
        passthrough=passthrough, pbr_lane=pbr_lane, state=state)
