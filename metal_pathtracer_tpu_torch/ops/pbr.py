"""glTF PBR metallic-roughness BSDF with rough transmission (``ops/pbr.py``
twin): metallic/dielectric specular with DFG energy compensation, lambert
diffuse, and GGX microfacet refraction with a Beer-Lambert volume tint
(reference: shaders/pathtrace.metal evaluate_pbr_metallic_roughness
:4632-4766, sample_pbr_metallic_roughness:4768-4945).

Every lobe is computed for every lane and each lane keeps its chosen
lobe, as in the JAX package; ``csrc/shade.cu`` computes only the chosen
lobe, with the same arithmetic.
"""

from __future__ import annotations

import torch

from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops import rng as rng_ops
from metal_pathtracer_tpu_torch.ops.bsdf import (
    PI,
    BsdfEval,
    BsdfSample,
    ClampParams,
    clamp_specular_pdf,
    clamp_specular_tail,
    fresnel_dielectric_exact,
    ggx_d,
    ggx_g1,
    ggx_pdf,
    lambert_pdf,
    reflect,
    refract,
    sample_ggx_vndf,
    schlick_fresnel,
    specular_energy_compensation,
)
from metal_pathtracer_tpu_torch.ops.vecmath import (
    dot,
    fdiv,
    safe_normalize,
    to_world,
    where3,
)


def dielectric_f0_from_ior(ior):
    eta = torch.clamp_min(ior, 1.0)
    ratio = (eta - 1.0) / torch.clamp_min(eta + 1.0, 1e-6)
    return torch.clamp(ratio * ratio, 0.0, 0.99)


def transmission_tint(m, cos_theta):
    """(reference: pathtrace.metal transmission_tint)"""
    thickness = torch.clamp_min(m.pbr_thickness, 0.0)
    sigma_a = torch.clamp_min(m.dielectric_sigma_a, 0.0)
    distance = thickness / torch.clamp_min(cos_theta.abs(), 1e-3)
    tint = torch.clamp(torch.exp(-sigma_a * distance[..., None]), 0.0, 1.0)
    skip = (thickness <= 0.0) | (sigma_a <= 0.0).all(-1)
    return where3(skip, torch.ones_like(tint), tint)


def ggx_vndf_pdf(alpha, normal, wo, wh):
    cos_o = dot(normal, wo)
    cos_h = dot(normal, wh)
    pdf = ggx_d(alpha, cos_h) * ggx_g1(alpha, cos_o) * cos_h \
        / torch.clamp_min(dot(wo, wh), 1e-6)
    return torch.where((cos_o <= 0.0) | (cos_h <= 0.0), 0.0, pdf)


def _lobe_params(m, diffuse_occlusion, specular_only: bool = False):
    """(base, metallic, roughness, f0, diffuse colour, transmission,
    reflect scale, p_spec, p_diff, p_trans, weights_ok). ``specular_only``
    (``debugSpecularOnly``, ``pbr.py:81-89``): no diffuse colour, the
    specular lobe takes the whole reflection weight."""
    base_color = torch.clamp(m.base_color, 0.0, 1.0)
    metallic = torch.clamp(m.pbr_metallic, 0.0, 1.0)
    roughness = torch.clamp(m.roughness, 0.0, 1.0)
    f0d = dielectric_f0_from_ior(m.eta)[..., None]
    f0 = f0d + (base_color - f0d) * metallic[..., None]
    diffuse_color = base_color * (1.0 - metallic)[..., None]
    diffuse_color = diffuse_color * torch.clamp(diffuse_occlusion, 0.0,
                                                1.0)[..., None]
    if specular_only:
        diffuse_color = torch.zeros_like(diffuse_color)
    transmission = torch.clamp(m.pbr_transmission, 0.0, 1.0) \
        * (1.0 - metallic)
    reflect_scale = 1.0 - transmission
    spec_weight_base = torch.ones_like(metallic) if specular_only \
        else torch.clamp(torch.maximum(torch.maximum(f0[..., 0], f0[..., 1]),
                                       f0[..., 2]), 0.05, 0.95)
    w_spec = spec_weight_base * reflect_scale
    w_diff = (1.0 - spec_weight_base) * reflect_scale
    w_trans = transmission
    weight_sum = w_spec + w_diff + w_trans
    safe = torch.clamp_min(weight_sum, 1e-20)
    return (base_color, metallic, roughness, f0, diffuse_color, transmission,
            reflect_scale, w_spec / safe, w_diff / safe, w_trans / safe,
            weight_sum > 0.0)


def evaluate_pbr(m, normal, wo, wi, clamp_p: ClampParams,
                 diffuse_occlusion, specular_only: bool = False) -> BsdfEval:
    """(reference: evaluate_pbr_metallic_roughness:4632-4766)"""
    cos_o = dot(normal, wo)
    cos_i = dot(normal, wi)
    abs_o = cos_o.abs()
    abs_i = cos_i.abs()
    geom_ok = (abs_o > 0.0) & (abs_i > 0.0)
    (_, _, roughness, f0, diffuse_color, transmission, reflect_scale,
     p_spec, p_diff, p_trans, weights_ok) = _lobe_params(m, diffuse_occlusion,
                                                         specular_only)
    is_delta = (m.mat_type == C.MATERIAL_PBR) & (roughness <= 1e-3)

    # reflection side (both cosines positive)
    refl_side = (cos_o * cos_i > 0.0) & (cos_o > 0.0) & (cos_i > 0.0)
    alpha = torch.clamp_min(roughness * roughness, 1e-4)
    wh = safe_normalize(wo + wi)
    half_ok = (dot(wh, normal) > 0.0) & (dot(wo, wh) > 0.0) \
        & (dot(wi, wh) > 0.0)
    d = ggx_d(alpha, dot(normal, wh))
    g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i)
    spec = schlick_fresnel(f0, dot(wi, wh)) * (
        d * g / torch.clamp_min(4.0 * cos_o * cos_i, 1e-6))[..., None]
    spec = spec * specular_energy_compensation(f0, roughness, abs_o)
    spec = clamp_specular_tail(spec, roughness, f0, clamp_p)
    spec = spec * reflect_scale[..., None]
    pdf_spec = ggx_pdf(alpha, normal, wo, wi)
    diffuse = fdiv(diffuse_color, PI) * reflect_scale[..., None]
    pdf_refl = p_spec * pdf_spec + p_diff * lambert_pdf(normal, wi)
    refl_ok = refl_side & half_ok & (pdf_refl > 0.0)
    value_refl = torch.clamp_min(spec + diffuse, 0.0)
    pdf_refl_c = clamp_specular_pdf(pdf_refl, clamp_p)

    # transmission side (opposite hemispheres)
    eta_t0 = torch.clamp_min(m.eta, 1.0)
    inside = cos_o < 0.0
    eta_i = torch.where(inside, eta_t0, 1.0)
    eta_t = torch.where(inside, 1.0, eta_t0)
    eta = eta_i / eta_t
    wht = safe_normalize(wo + wi * eta[..., None])
    wht = where3(dot(wht, normal) <= 0.0, -wht, wht)
    cos_o_wh = dot(wo, wht)
    cos_i_wh = dot(wi, wht)
    dt = ggx_d(alpha, torch.clamp_min(dot(normal, wht), 0.0))
    gt = ggx_g1(alpha, abs_o) * ggx_g1(alpha, abs_i)
    fr, _ = fresnel_dielectric_exact(cos_o_wh, eta_i, eta_t)
    denom = cos_o_wh + eta * cos_i_wh
    denom_sq = denom * denom
    factor = (eta * eta) * cos_i_wh.abs() * cos_o_wh.abs()
    factor = factor / torch.clamp_min(abs_o * abs_i * denom_sq, 1e-6)
    ft = ((1.0 - fr) * dt * gt * factor)[..., None]
    ft = ft * transmission_tint(m, abs_i)
    ft = ft * transmission[..., None]
    pdf_wh = ggx_vndf_pdf(alpha, normal, wo, wht)
    dwh_dwi = ((eta * eta * cos_i_wh)
               / torch.clamp_min(denom_sq, 1e-8)).abs()
    pdf_trans = p_trans * pdf_wh * dwh_dwi
    trans_ok = ((cos_o * cos_i <= 0.0) & (transmission > 0.0)
                & torch.isfinite(wht).all(-1) & (dot(wht, wht) > 0.0)
                & (cos_o_wh * cos_i_wh <= 0.0)
                & (denom_sq.abs() > 1e-8) & (pdf_trans > 0.0))
    value_trans = torch.clamp_min(ft, 0.0)
    pdf_trans_c = clamp_specular_pdf(pdf_trans, clamp_p)

    take = geom_ok & weights_ok & ~is_delta
    take_refl = take & refl_ok
    take_trans = take & (cos_o * cos_i <= 0.0) & trans_ok
    value = torch.zeros_like(wo)
    value = where3(take_refl, value_refl, value)
    value = where3(take_trans, value_trans, value)
    pdf = torch.where(take_refl, pdf_refl_c, 0.0)
    pdf = torch.where(take_trans, pdf_trans_c, pdf)
    return BsdfEval(value=value, pdf=pdf, is_delta=is_delta)


def sample_pbr(m, normal, wo, incident, state, clamp_p: ClampParams,
               diffuse_occlusion, specular_only: bool = False):
    """(reference: sample_pbr_metallic_roughness:4768-4945).

    RNG: 1 lobe selector; smooth specular/transmission draw nothing more,
    rough lobes and the diffuse lobe draw 2."""
    (_, _, roughness, f0, diffuse_color, transmission, reflect_scale,
     p_spec, p_diff, p_trans, weights_ok) = _lobe_params(m, diffuse_occlusion,
                                                         specular_only)
    smooth = roughness <= 1e-3
    alpha = torch.clamp_min(roughness * roughness, 1e-4)

    state, choose = rng_ops.rand_uniform(state)
    lobe_spec = choose < p_spec
    lobe_diff = ~lobe_spec & (choose < p_spec + p_diff)
    lobe_trans = ~(lobe_spec | lobe_diff)

    cos_o = dot(normal, wo)
    abs_o = cos_o.abs()
    cos_o_pos = torch.clamp_min(cos_o, 0.0)
    rs = reflect_scale[..., None]

    # specular: smooth mirror (0 draws) or rough VNDF (2 draws)
    wi_sm = reflect(incident, normal)
    f_sm = schlick_fresnel(f0, cos_o_pos) * rs
    ok_sm = dot(normal, wi_sm) > 0.0
    state_sr, wh = sample_ggx_vndf(normal, wo, roughness, state)
    wi_sr = reflect(-wo, wh)
    cos_i_sr = dot(normal, wi_sr)
    d = ggx_d(alpha, dot(normal, wh))
    g = ggx_g1(alpha, cos_o_pos) * ggx_g1(alpha, cos_i_sr)
    f_sr = schlick_fresnel(f0, dot(wi_sr, wh)) * (
        d * g / torch.clamp_min(4.0 * cos_o_pos * cos_i_sr, 1e-6))[..., None]
    f_sr = f_sr * specular_energy_compensation(f0, roughness, cos_o_pos)
    f_sr = clamp_specular_tail(f_sr, roughness, f0, clamp_p)
    f_sr = f_sr * rs
    pdf_spec_r = ggx_pdf(alpha, normal, wo, wi_sr)
    wi_s = where3(smooth, wi_sm, wi_sr)
    f_s = where3(smooth, f_sm, f_sr)
    pdf_spec = torch.where(smooth, 1.0, pdf_spec_r)
    ok_s = torch.where(smooth, ok_sm, cos_i_sr > 0.0)
    state_s = torch.where(smooth, state, state_sr)

    # diffuse: cosine hemisphere (2 draws)
    state_d, local = rng_ops.sample_cosine_hemisphere(state)
    wi_d = safe_normalize(to_world(local, normal))
    f_d = fdiv(diffuse_color, PI) * rs
    pdf_diffuse = lambert_pdf(normal, wi_d)
    ok_d = dot(normal, wi_d) > 0.0

    # transmission: smooth refraction (0 draws) or rough VNDF (2 draws)
    eta_t0 = torch.clamp_min(m.eta, 1.0)
    inside = cos_o < 0.0
    eta_i = torch.where(inside, eta_t0, 1.0)
    eta_t = torch.where(inside, 1.0, eta_t0)
    eta = eta_i / eta_t
    wi_t0 = refract(-wo, normal, eta)
    len2_t0 = dot(wi_t0, wi_t0)
    wi_t0n = wi_t0 * fdiv(1.0, torch.sqrt(
        torch.clamp_min(len2_t0, 1e-38)))[..., None]
    fr0, cos_t0 = fresnel_dielectric_exact(cos_o, eta_i, eta_t)
    eta_scale = (eta_t * eta_t) / (eta_i * eta_i)
    dir_scale = eta_scale * (cos_t0.abs() / torch.clamp_min(abs_o, 1e-6))
    ft0 = (torch.clamp_min(1.0 - fr0, 0.0) * dir_scale)[..., None]
    ft0 = ft0 * transmission_tint(m, dot(normal, wi_t0n).abs())
    f_t0 = transmission[..., None] * ft0
    state_tr, wh_t = sample_ggx_vndf(normal, wo, roughness, state)
    wi_tr = refract(-wo, wh_t, eta)
    len2_tr = dot(wi_tr, wi_tr)
    wi_trn = wi_tr * fdiv(1.0, torch.sqrt(
        torch.clamp_min(len2_tr, 1e-38)))[..., None]
    cos_i_tr = dot(normal, wi_trn)
    abs_i_tr = cos_i_tr.abs()
    cos_o_wh = dot(wo, wh_t)
    cos_i_wh = dot(wi_trn, wh_t)
    dt = ggx_d(alpha, torch.clamp_min(dot(normal, wh_t), 0.0))
    gt = ggx_g1(alpha, abs_o) * ggx_g1(alpha, abs_i_tr)
    frt, _ = fresnel_dielectric_exact(cos_o_wh, eta_i, eta_t)
    denom = cos_o_wh + eta * cos_i_wh
    denom_sq = denom * denom
    factor = (eta * eta) * cos_i_wh.abs() * cos_o_wh.abs()
    factor = factor / torch.clamp_min(abs_o * abs_i_tr * denom_sq, 1e-6)
    ftr = ((1.0 - frt) * dt * gt * factor)[..., None]
    ftr = ftr * transmission_tint(m, abs_i_tr)
    f_tr = transmission[..., None] * ftr
    pdf_wh = ggx_vndf_pdf(alpha, normal, wo, wh_t)
    dwh_dwi = ((eta * eta * cos_i_wh)
               / torch.clamp_min(denom_sq, 1e-8)).abs()
    pdf_trans_r = pdf_wh * dwh_dwi
    ok_tr = ((len2_tr > 0.0) & (cos_i_tr * cos_o < 0.0)
             & (cos_o_wh * cos_i_wh <= 0.0) & (denom_sq.abs() > 1e-8))
    wi_t = where3(smooth, wi_t0n, wi_trn)
    f_t = where3(smooth, f_t0, f_tr)
    pdf_trans = torch.where(smooth, 1.0, pdf_trans_r)
    ok_t = torch.where(smooth, len2_t0 > 0.0, ok_tr)
    state_t = torch.where(smooth, state, state_tr)

    # the chosen lobe, per lane
    wi = where3(lobe_spec, wi_s, where3(lobe_diff, wi_d, wi_t))
    f = where3(lobe_spec, f_s, where3(lobe_diff, f_d, f_t))
    branch_ok = torch.where(lobe_spec, ok_s, torch.where(lobe_diff, ok_d,
                                                         ok_t))
    new_state = torch.where(lobe_spec, state_s,
                            torch.where(lobe_diff, state_d, state_t))
    is_delta = ~lobe_diff & smooth
    pdf = (p_spec * torch.where(lobe_spec, pdf_spec, 0.0)
           + p_diff * torch.where(lobe_diff, pdf_diffuse, 0.0)
           + p_trans * torch.where(lobe_trans, pdf_trans, 0.0))
    abs_i = dot(normal, wi).abs()
    weight = torch.clamp_min(
        f * (abs_i / torch.clamp_min(pdf, 1e-20))[..., None], 0.0)
    ok = weights_ok & branch_ok & (abs_i > 0.0) & (pdf > 0.0) \
        & torch.isfinite(weight).all(-1)
    lobe_type = torch.where(lobe_spec, 1, torch.where(lobe_diff, 0, 2))
    out = BsdfSample.invalid(pdf.shape, pdf.device)
    return new_state, out.replace(
        direction=where3(ok, wi, out.direction),
        weight=where3(ok, weight, out.weight),
        pdf=torch.where(ok, pdf, 0.0),
        directional_pdf=torch.where(ok, pdf, 0.0),
        is_delta=ok & is_delta,
        lobe_type=torch.where(ok, lobe_type, 0).to(torch.int32),
        lobe_roughness=torch.where(ok, torch.where(lobe_diff, 1.0, roughness),
                                   0.0))
