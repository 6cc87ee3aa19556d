"""CarPaint BSDF (``ops/carpaint.py`` twin): a clearcoat GGX lobe, a
procedural-flake GGX lobe and a diffuse/conductor base (reference:
shaders/pathtrace.metal carpaint_*:3300-3536, sample case 6 :5508-5633,
evaluate case 6 :5079-5110).

The flake normal comes from a hash of the hit position scaled by the
flake scale. ``_hash3`` takes the remainder of values of a few thousand
in float32, so one ulp of input moves a flake by ~1e-3; it therefore
repeats the jitted reference's fused multiply-adds exactly (found by
trying the placements against the jitted ``_hash3``, bit for bit on 2e5
random points): the offset ``p * 0.3183099 + c`` and the middle term of
the sum are FMAs. ``csrc/bsdf.cuh`` does the same with ``__fmaf_rn``.
"""

from __future__ import annotations

import torch

from metal_pathtracer_tpu_torch.ops import rng as rng_ops
from metal_pathtracer_tpu_torch.ops.bsdf import (
    PI,
    BsdfSample,
    ClampParams,
    clamp_specular_pdf,
    clamp_specular_tail,
    fresnel_conductor,
    ggx_d,
    ggx_g1,
    ggx_pdf,
    lambert_pdf,
    material_base_color,
    plastic_coat_f0,
    plastic_coat_roughness,
    plastic_diffuse_transmission,
    plastic_specular_tint,
    reflect,
    sample_ggx_vndf,
    schlick_fresnel,
)
from metal_pathtracer_tpu_torch.ops.vecmath import (
    build_onb,
    dot,
    fdiv,
    fma,
    normalize,
    safe_normalize,
    to_world,
    where3,
)

_HASH_OFFSET = (0.1, 0.3, 0.7)


def mod1(x):
    """``jnp.mod(x, 1.0)``: the truncated remainder, moved into [0, 1)."""
    r = torch.fmod(x, 1.0)
    return torch.where((r != 0.0) & (r < 0.0), r + 1.0, r)


def _hash3(p):
    """(reference: pathtrace.metal carpaint_hash3)"""
    off = torch.tensor(_HASH_OFFSET, device=p.device)
    p = mod1(fma(p, 0.3183099, off))
    px, py, pz = p.unbind(-1)
    s = fma(pz, px + 77.77, fma(px, py + 33.33, py * (pz + 55.55)))
    p = p + s[..., None]
    px, py, pz = p.unbind(-1)
    return mod1(torch.stack([px + py, px + pz, py + pz], -1) * 13.5453123)


def flake_normal(m, position, normal):
    """(reference: pathtrace.metal carpaint_flake_normal:3371-3392)"""
    rand = _hash3(position * m.carpaint_flake_scale[..., None])
    anis = m.carpaint_flake_anisotropy
    ax = torch.clamp_min(1.0 - anis, 1e-3)
    ay = torch.clamp_min(1.0 + anis, 1e-3)
    phi = (2.0 * PI) * rand[..., 0]
    r = torch.sqrt(torch.clamp_min(rand[..., 1], 1e-4))
    x = r * torch.cos(phi) * ax
    y = r * torch.sin(phi) * ay
    m2 = torch.clamp(x * x + y * y, 0.0, 0.99)
    z = torch.sqrt(torch.clamp_min(1.0 - m2, 0.0))
    tangent, bitangent = build_onb(normal)
    perturbed = normalize(x[..., None] * tangent + y[..., None] * bitangent
                          + z[..., None] * normal)
    strength = m.carpaint_flake_normal_strength[..., None]
    return normalize(normal + (perturbed - normal) * strength)


def _base_f0(m):
    fc = fresnel_conductor(torch.ones_like(m.carpaint_has_base_conductor),
                           m.carpaint_base_eta, m.carpaint_base_k)
    return where3(m.carpaint_has_base_conductor > 0.0, fc,
                  material_base_color(m))


def _spec(f, d, g, cos_o, cos_i):
    return f * fdiv(d * g, torch.clamp_min(4.0 * cos_o * cos_i,
                                           1e-6))[..., None]


def _eval_coat(m, normal, wo, wi, clamp_p):
    """(reference: carpaint_eval_coat:3394-3427)"""
    cos_o = torch.clamp_min(dot(normal, wo), 0.0)
    cos_i = torch.clamp_min(dot(normal, wi), 0.0)
    roughness = plastic_coat_roughness(m)
    alpha = torch.clamp_min(roughness * roughness, 1e-4)
    wh = safe_normalize(wo + wi)
    geo = ((cos_i > 0.0) & (cos_o > 0.0) & (dot(wh, normal) > 0.0)
           & (dot(wo, wh) > 0.0) & (dot(wi, wh) > 0.0))
    d = ggx_d(alpha, dot(normal, wh))
    g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i)
    f0c = plastic_coat_f0(m)[..., None].expand(normal.shape)
    spec = _spec(schlick_fresnel(f0c, dot(wi, wh)), d, g, cos_o, cos_i)
    spec = clamp_specular_tail(spec * plastic_specular_tint(m), roughness,
                               f0c, clamp_p)
    pdf_raw = ggx_pdf(alpha, normal, wo, wi)
    ok = geo & (pdf_raw > 0.0)
    return (where3(ok, spec, torch.zeros_like(spec)),
            torch.where(ok, clamp_specular_pdf(pdf_raw, clamp_p), 0.0))


def _eval_flake(m, fn, wo, wi, clamp_p):
    """(reference: carpaint_eval_flake:3429-3470) about the flake normal
    ``fn``"""
    cos_o = torch.clamp_min(dot(fn, wo), 0.0)
    cos_i = torch.clamp_min(dot(fn, wi), 0.0)
    roughness = torch.clamp_min(
        torch.clamp(m.carpaint_flake_roughness, 0.0, 1.0), 1e-3)
    alpha = roughness * roughness
    wh = safe_normalize(wo + wi)
    geo = ((cos_i > 0.0) & (cos_o > 0.0) & (dot(wh, fn) > 0.0)
           & (dot(wo, wh) > 0.0) & (dot(wi, wh) > 0.0))
    d = ggx_d(alpha, dot(fn, wh))
    g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i)
    f0 = _base_f0(m)
    spec = _spec(schlick_fresnel(f0, dot(wi, wh)), d, g, cos_o, cos_i)
    spec = clamp_specular_tail(spec * plastic_specular_tint(m), roughness,
                               f0, clamp_p)
    spec = spec * torch.clamp_min(
        1.0 - torch.clamp(m.coat_fresnel_avg, 0.0, 1.0), 0.0)[..., None]
    pdf_raw = ggx_pdf(alpha, fn, wo, wi)
    ok = geo & (pdf_raw > 0.0)
    return (where3(ok, spec, torch.zeros_like(spec)),
            torch.where(ok, clamp_specular_pdf(pdf_raw, clamp_p), 0.0))


def _eval_base(m, normal, wo, wi, clamp_p):
    """(reference: carpaint_eval_base:3472-3536)"""
    cos_o = torch.clamp_min(dot(normal, wo), 0.0)
    cos_i = torch.clamp_min(dot(normal, wi), 0.0)
    geo = (cos_i > 0.0) & (cos_o > 0.0)
    metallic = torch.clamp(m.carpaint_base_metallic, 0.0, 1.0)
    diffuse_w = torch.clamp_min(1.0 - metallic, 0.0)
    spec_w = torch.clamp_min(metallic, 0.0)
    coat_t = torch.clamp_min(
        1.0 - torch.clamp(m.coat_fresnel_avg, 0.0, 1.0), 0.0)[..., None]
    base_color = material_base_color(m)
    zero = torch.zeros_like(normal)

    diffuse = fdiv(base_color, PI) \
        * plastic_diffuse_transmission(m, cos_i, cos_o) * coat_t
    diffuse = torch.clamp_min(diffuse, 0.0)
    use_diff = diffuse_w > 1e-4
    combined = zero + where3(use_diff, diffuse_w[..., None] * diffuse, zero)
    pdf_diffuse = torch.where(use_diff, lambert_pdf(normal, wi), 0.0)

    roughness = torch.clamp_min(
        torch.clamp(m.carpaint_base_roughness, 0.0, 1.0), 1e-3)
    alpha = roughness * roughness
    wh = safe_normalize(wo + wi)
    half_ok = ((dot(wh, normal) > 0.0) & (dot(wo, wh) > 0.0)
               & (dot(wi, wh) > 0.0))
    d = ggx_d(alpha, dot(normal, wh))
    g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i)
    f = where3(m.carpaint_has_base_conductor > 0.0,
               fresnel_conductor(dot(wi, wh), m.carpaint_base_eta,
                                 m.carpaint_base_k),
               schlick_fresnel(base_color, dot(wi, wh)))
    spec = _spec(f, d, g, cos_o, cos_i)
    spec = clamp_specular_tail(spec * plastic_specular_tint(m) * coat_t,
                               roughness, _base_f0(m), clamp_p)
    spec = torch.clamp_min(spec, 0.0)
    use_spec = (spec_w > 1e-4) & half_ok
    combined = combined + where3(use_spec, spec_w[..., None] * spec, zero)
    pdf_raw = ggx_pdf(alpha, normal, wo, wi)
    pdf_spec = torch.where(use_spec & (pdf_raw > 0.0),
                           clamp_specular_pdf(pdf_raw, clamp_p), 0.0)

    ok = geo & ((diffuse_w > 1e-4) | (spec_w > 1e-4))
    return (where3(ok, torch.clamp_min(combined, 0.0), zero),
            torch.where(ok, diffuse_w * pdf_diffuse + spec_w * pdf_spec, 0.0))


def _lobe_probs(m):
    """(p_coat, p_flake, p_base), normalised; the base alone when both
    weights vanish."""
    p_coat = torch.clamp(m.coat_sample_weight, 0.0, 0.95)
    p_flake = torch.clamp(m.carpaint_flake_sample_weight, 0.0, 0.95)
    p_base = torch.clamp_min(1.0 - (p_coat + p_flake), 0.0)
    norm = p_coat + p_flake + p_base
    degenerate = norm <= 1e-6
    p_coat = torch.where(degenerate, 0.0, p_coat)
    p_flake = torch.where(degenerate, 0.0, p_flake)
    p_base = torch.where(degenerate, 1.0, p_base)
    norm = torch.where(degenerate, 1.0, norm)
    return p_coat / norm, p_flake / norm, p_base / norm


def _eval_all(m, fn, normal, wo, wi, clamp_p):
    """The three lobes at ``wi``: (coat, flake, base) as (value, pdf)."""
    return (_eval_coat(m, normal, wo, wi, clamp_p),
            _eval_flake(m, fn, wo, wi, clamp_p),
            _eval_base(m, normal, wo, wi, clamp_p))


def evaluate_carpaint(m, position, normal, wo, wi, clamp_p: ClampParams):
    """(reference: evaluate_bsdf case 6): (value, pdf)"""
    p_coat, p_flake, p_base = _lobe_probs(m)
    (coat_f, coat_pdf), (flake_f, flake_pdf), (base_f, base_pdf) = \
        _eval_all(m, flake_normal(m, position, normal), normal, wo, wi,
                  clamp_p)
    value = (p_base[..., None] * base_f + p_flake[..., None] * flake_f
             + p_coat[..., None] * coat_f)
    return value, p_base * base_pdf + p_flake * flake_pdf + p_coat * coat_pdf


def sample_carpaint(m, position, normal, wo, state, clamp_p: ClampParams):
    """(reference: sample_bsdf case 6:5508-5633). RNG: 1 lobe selector,
    then the coat and flake lobes draw 2 (VNDF) and the base 1 (sub-lobe
    choice) + 2 (VNDF or cosine). Returns (new_state, BsdfSample).
    ``debugSpecularOnly`` leaves carpaint as it is (the reference's case 6
    has no carve-out, ``carpaint.py:291``)."""
    p_coat, p_flake, p_base = _lobe_probs(m)
    state, r = rng_ops.rand_uniform(state)
    lobe = torch.where((p_coat > 0.0) & (r < p_coat), 2,
                       torch.where((p_flake > 0.0) & (r < p_coat + p_flake),
                                   1, 0))
    fallback = torch.where((p_flake > p_coat) & (p_flake > 0.0), 1,
                           torch.where(p_coat > 0.0, 2, 0))
    lobe = torch.where((lobe == 0) & (p_base <= 1e-6), fallback, lobe)

    coat_roughness = plastic_coat_roughness(m)
    fn = flake_normal(m, position, normal)
    flake_roughness = torch.clamp_min(
        torch.clamp(m.carpaint_flake_roughness, 0.0, 1.0), 1e-3)

    state_c, wh_c = sample_ggx_vndf(normal, wo, coat_roughness, state)
    wi_c = safe_normalize(reflect(-wo, wh_c))
    coat_ok = dot(wh_c, normal) > 0.0

    state_f, wh_f = sample_ggx_vndf(fn, wo, flake_roughness, state)
    wi_f = safe_normalize(reflect(-wo, wh_f))
    flake_ok = dot(wh_f, fn) > 0.0

    metallic = torch.clamp(m.carpaint_base_metallic, 0.0, 1.0)
    diffuse_w = torch.clamp_min(1.0 - metallic, 0.0)
    spec_w = torch.clamp_min(metallic, 0.0)
    state_b, choose = rng_ops.rand_uniform(state)
    sample_spec = ((spec_w > 0.0) & ((diffuse_w + spec_w) > 0.0)
                   & (choose < spec_w / torch.clamp_min(diffuse_w + spec_w,
                                                        1e-6)))
    base_rough = torch.clamp_min(
        torch.clamp(m.carpaint_base_roughness, 0.0, 1.0), 1e-3)
    state_bs, wh_b = sample_ggx_vndf(normal, wo, base_rough, state_b)
    wi_bs = safe_normalize(reflect(-wo, wh_b))
    state_bd, local = rng_ops.sample_cosine_hemisphere(state_b)
    wi_bd = safe_normalize(to_world(local, normal))
    base_ok = ~sample_spec | (dot(wh_b, normal) > 0.0)

    is_c, is_f = lobe == 2, lobe == 1
    wi = where3(is_c, wi_c, where3(is_f, wi_f,
                                   where3(sample_spec, wi_bs, wi_bd)))
    branch_ok = torch.where(is_c, coat_ok, torch.where(is_f, flake_ok,
                                                       base_ok))
    new_state = torch.where(is_c, state_c, torch.where(
        is_f, state_f, torch.where(sample_spec, state_bs, state_bd)))
    dir_ok = branch_ok & torch.isfinite(wi).all(-1) & (dot(normal, wi) > 0.0)

    (coat_f, coat_pdf), (flake_f, flake_pdf), (base_f, base_pdf) = \
        _eval_all(m, fn, normal, wo, wi, clamp_p)
    combined_pdf = p_base * base_pdf + p_flake * flake_pdf + p_coat * coat_pdf
    sel_f = where3(is_c, coat_f, where3(is_f, flake_f, base_f))
    sel_pdf = torch.where(is_c, coat_pdf, torch.where(is_f, flake_pdf,
                                                      base_pdf))
    cos_i = torch.clamp_min(dot(normal, wi), 0.0)
    weight = sel_f * fdiv(cos_i, torch.clamp_min(combined_pdf,
                                                 1e-20))[..., None]
    ok = (dir_ok & (combined_pdf > 0.0) & (sel_pdf > 0.0)
          & (sel_f > 0.0).any(-1) & (cos_i > 0.0)
          & torch.isfinite(weight).all(-1))
    lobe_type = torch.where((lobe == 0) & ~sample_spec, 0, 1)
    lobe_roughness = torch.where(is_c, coat_roughness, torch.where(
        is_f, flake_roughness, torch.where(sample_spec, base_rough, 1.0)))
    out = BsdfSample.invalid(cos_i.shape, cos_i.device)
    return new_state, out.replace(
        direction=where3(ok, wi, out.direction),
        weight=where3(ok, torch.clamp_min(weight, 0.0), out.weight),
        pdf=torch.where(ok, combined_pdf, 0.0),
        directional_pdf=torch.where(ok, torch.clamp_min(sel_pdf, 0.0), 0.0),
        lobe_type=torch.where(ok, lobe_type, 0).to(torch.int32),
        lobe_roughness=torch.where(ok, lobe_roughness, 0.0))
