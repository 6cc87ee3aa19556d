"""Subsurface scattering (``ops/sss.py`` twin): the separable
normalized-diffusion BSSRDF, its lambert fallback, and the volumetric
random walk (reference: shaders/pathtrace.metal sss_* helpers:3912-4059,
separable sample in case 5 :5420-5508, random walk
sample_sss_random_walk_software:4060-4310).

The separable sample and the fallback are per-lane arithmetic that K2
repeats (``csrc/bsdf.cuh``). The random walk traces the scene at every
step, so it is not a kernel of its own, in the JAX package either (an XLA
pre-stage there, ``shade.py:3064-3150``): here it is torch code whose
traces go through ``intersect.trace_scene``, so K1 and K3 run on the card
at every step.

Sums of products that place a point or a direction are fused as XLA:CPU
fuses the JAX package's (``a*b + c*d`` -> ``fma(a, b, c*d)``, then
``+ e*f`` -> ``fma(e, f, .)``, the placement measured for
``vecmath.to_world`` and the carpaint hash); other arithmetic stays
unfused.
"""

from __future__ import annotations

import torch

from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops import rng as rng_ops
from metal_pathtracer_tpu_torch.ops.bsdf import (
    PI,
    BsdfSample,
    ClampParams,
    clamp_specular_pdf,
    clamp_specular_tail,
    fresnel_dielectric_exact,
    ggx_d,
    ggx_g1,
    ggx_pdf,
    lambert_pdf,
    material_base_color,
    plastic_coat_f0,
    plastic_coat_roughness,
    plastic_specular_tint,
    reflect,
    refract,
    sample_ggx_vndf,
    schlick_fresnel,
    schlick_weight,
    select_sample,
)
from metal_pathtracer_tpu_torch.ops.vecmath import (
    build_onb,
    dot,
    fdiv,
    fma,
    luminance,
    safe_normalize,
    to_world,
    where3,
)

SSS_THROUGHPUT_CUTOFF = 1e-3  # (reference: pathtrace.metal:31)
#: 1 - 1e-6 in float32, the top of a distance draw
_XI_MAX = 0.999999


def _sigma_t(mean_free_path):
    return fdiv(1.0, torch.clamp_min(mean_free_path, 1e-4))


def sss_sigma_a(m, base_color, mean_free_path, anisotropy):
    """(reference: pathtrace.metal sss_sigma_a:3916-3931)"""
    sigma_t = _sigma_t(mean_free_path)
    sigma_s = torch.clamp(base_color, 0.0, 0.999) * sigma_t[..., None]
    sigma_s = torch.clamp_min(sigma_s, 0.0) \
        * torch.clamp_min(1.0 - anisotropy, 0.01)[..., None]
    derived = torch.clamp_min(sigma_t[..., None] - sigma_s, 1e-6)
    return where3(m.sss_sigma_override > 0.5,
                  torch.clamp_min(m.sss_sigma_a, 1e-6), derived)


def sss_sigma_s_prime(m, base_color, mean_free_path, anisotropy):
    """(reference: pathtrace.metal sss_sigma_s_prime:3933-3949)"""
    sigma_t = _sigma_t(mean_free_path)
    derived = torch.clamp_min(
        torch.clamp(base_color, 0.0, 0.999) * sigma_t[..., None], 0.0)
    out = where3(m.sss_sigma_override > 0.5,
                 torch.clamp_min(m.sss_sigma_s, 0.0), derived)
    return out * torch.clamp_min(1.0 - anisotropy, 0.01)[..., None]


def _sigma_tr(sigma_a, sigma_s_prime):
    """(sigma_t', d, sigma_tr) of the diffusion profile, per channel"""
    sigma_t_prime = torch.clamp_min(sigma_a + sigma_s_prime, 1e-6)
    d = fdiv(1.0, torch.clamp_min(3.0 * sigma_t_prime, 1e-6))
    return sigma_t_prime, d, torch.sqrt(torch.clamp_min(sigma_a / d, 1e-6))


def normalized_diffusion_profile(radius, sigma_a, sigma_s_prime):
    """Two-exponential dipole-style profile (reference: pathtrace.metal
    normalized_diffusion_profile:3951-3973)."""
    sigma_t_prime, d, sigma_tr = _sigma_tr(sigma_a, sigma_s_prime)
    alpha_prime = torch.clamp(sigma_s_prime / sigma_t_prime, 0.0, 1.0)
    r = torch.clamp_min(radius, 1e-4)[..., None]
    zr = fdiv(1.0, sigma_t_prime)
    dr = torch.sqrt(r * r + zr * zr)
    vr = zr + 4.0 * d
    dv = torch.sqrt(r * r + vr * vr)
    term_dr = (zr * (1.0 + sigma_tr * dr)) \
        / torch.clamp_min(dr * dr * dr, 1e-6)
    term_dv = (vr * (1.0 + sigma_tr * dv)) \
        / torch.clamp_min(dv * dv * dv, 1e-6)
    profile = fdiv(alpha_prime, 4.0 * PI) * (
        term_dr * torch.exp(-sigma_tr * dr)
        + term_dv * torch.exp(-sigma_tr * dv))
    return torch.clamp_min(profile, 0.0)


def sss_sigma_tr_scalar(sigma_a, sigma_s_prime):
    """(reference: pathtrace.metal sss_sigma_tr_scalar:3975-3982)"""
    return torch.clamp_min(luminance(_sigma_tr(sigma_a, sigma_s_prime)[2]),
                           1e-4)


def sample_henyey_greenstein_world(reference_dir, g, state):
    """(reference: pathtrace.metal sample_henyey_greenstein_local, then
    about ``reference_dir``); 2 draws."""
    state, u1 = rng_ops.rand_uniform(state)
    state, u2 = rng_ops.rand_uniform(state)
    iso = g.abs() < 1e-3
    s = (1.0 - g * g) / (1.0 - g + 2.0 * g * u1)
    cos_aniso = torch.clamp((1.0 + g * g - s * s)
                            / (2.0 * torch.where(iso, 1.0, g)), -1.0, 1.0)
    cos_theta = torch.where(iso, 1.0 - 2.0 * u1, cos_aniso)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    phi = (2.0 * PI) * u2
    local = torch.stack([sin_theta * torch.cos(phi),
                         sin_theta * torch.sin(phi), cos_theta], -1)
    return state, safe_normalize(to_world(local, safe_normalize(
        reference_dir)))


def offset_surface_point(point, normal, direction):
    """(reference: pathtrace.metal offset_surface_point)"""
    ok = torch.isfinite(normal).all(-1) & (dot(normal, normal) > 0.0)
    up = torch.tensor([0.0, 1.0, 0.0], device=point.device).expand_as(point)
    n = where3(ok, safe_normalize(normal), up)
    sign = torch.where(dot(direction, n) >= 0.0, 1.0, -1.0)
    origin = fma(n, (sign * C.RAY_ORIGIN_EPSILON * 4.0)[..., None], point)
    return fma(direction, C.RAY_ORIGIN_EPSILON * 0.5, origin)


def _lambert_fallback(m, normal, state):
    """(reference: pathtrace.metal:5482-5508); 2 draws"""
    state, local = rng_ops.sample_cosine_hemisphere(state)
    wi = safe_normalize(to_world(local, normal))
    cos_i = dot(normal, wi)
    pdf = lambert_pdf(normal, wi)
    weight = torch.clamp_min(fdiv(material_base_color(m), PI) * fdiv(
        cos_i, torch.clamp_min(pdf, 1e-20))[..., None], 0.0)
    ok = (cos_i > 0.0) & (pdf > 0.0) & torch.isfinite(weight).all(-1)
    out = BsdfSample.invalid(pdf.shape, pdf.device)
    return state, out.replace(
        direction=where3(ok, wi, out.direction),
        weight=where3(ok, weight, out.weight),
        pdf=torch.where(ok, pdf, 0.0),
        directional_pdf=torch.where(ok, pdf, 0.0),
        lobe_roughness=torch.where(ok, 1.0, 0.0))


def sample_subsurface(m, position, normal, wo, state, sss_mode: int):
    """sample_bsdf case 5: the separable BSSRDF (``sss_mode`` 1, on lanes
    of a separable material with a usable mean free path; 4 draws) or the
    lambert fallback (2 draws). Returns (new_state, BsdfSample)."""
    if sss_mode != 1:
        return _lambert_fallback(m, normal, state)
    mean_free_path = torch.clamp_min(m.sss_mfp, 1e-4)
    anisotropy = torch.clamp(m.sss_g, -0.99, 0.99)
    base_color = material_base_color(m)
    sigma_a = sss_sigma_a(m, base_color, mean_free_path, anisotropy)
    sigma_sp = sss_sigma_s_prime(m, base_color, mean_free_path, anisotropy)
    sigma_tr = sss_sigma_tr_scalar(sigma_a, sigma_sp)
    lane_separable = (m.sss_method < 0.5) & (mean_free_path > 1e-4) \
        & (sigma_tr > 0.0)

    st, u_r = rng_ops.rand_uniform(state)
    u_r = torch.clamp(u_r, 1e-6, _XI_MAX)
    s_tr = torch.clamp_min(sigma_tr, 1e-4)
    radius = torch.minimum(-torch.log(1.0 - u_r) / s_tr,
                           mean_free_path * 10.0)
    pdf_radius = s_tr * torch.exp(-s_tr * radius)
    st, u_phi = rng_ops.rand_uniform(st)
    phi = (2.0 * PI) * u_phi
    tangent, bitangent = build_onb(normal)
    exit_point = fma(bitangent, (radius * torch.sin(phi))[..., None],
                     fma(tangent, (radius * torch.cos(phi))[..., None],
                         position))
    st, local = rng_ops.sample_cosine_hemisphere(st)
    wi = safe_normalize(to_world(local, normal))
    cos_exit = dot(normal, wi)
    pdf_dir = lambert_pdf(normal, wi)
    pdf_area = pdf_radius / ((2.0 * PI) * torch.clamp_min(radius, 1e-4))

    profile = normalized_diffusion_profile(radius, sigma_a, sigma_sp)
    coat_average = 1.0 - torch.clamp(m.coat_fresnel_avg, 0.0, 1.0)
    coat_ior = torch.clamp_min(m.coat_ior, 1.0)
    ratio = (coat_ior - 1.0) / (coat_ior + 1.0)
    f0 = ratio * ratio
    cos_in = torch.clamp_min(dot(normal, wo), 0.0)
    trans_in = 1.0 - (f0 + (1.0 - f0) * schlick_weight(cos_in))
    trans_out = 1.0 - (f0 + (1.0 - f0) * schlick_weight(cos_exit))
    has_coat = m.sss_coat > 0.5
    profile = where3(has_coat,
                     profile * torch.clamp(m.coat_tint, 0.0, 1.0), profile)
    coat_trans = torch.where(
        has_coat, torch.clamp(trans_in * trans_out, 0.0, 1.0), 1.0)
    weight = profile * (cos_exit * coat_average * coat_trans)[..., None]
    denom = torch.clamp_min(pdf_area * pdf_dir, 1e-6)
    weight = torch.clamp_min(weight / denom[..., None], 0.0)
    ok = (lane_separable & (pdf_radius > 0.0) & torch.isfinite(pdf_radius)
          & (cos_exit > 0.0) & (pdf_dir > 0.0) & (pdf_area > 0.0)
          & torch.isfinite(weight).all(-1))
    sep = BsdfSample.invalid(pdf_dir.shape, pdf_dir.device)
    sep = sep.replace(
        direction=where3(ok, wi, sep.direction),
        weight=where3(ok, weight, sep.weight),
        pdf=torch.where(ok, denom, 0.0),
        directional_pdf=torch.where(ok, pdf_dir, 0.0),
        is_bssrdf=ok, has_exit_point=ok,
        exit_point=where3(ok, exit_point, sep.exit_point),
        exit_normal=where3(ok, normal, sep.exit_normal))
    fb_state, fb = _lambert_fallback(m, normal, state)
    return (torch.where(lane_separable, st, fb_state),
            select_sample(lane_separable, sep, fb))


def exit_point_origin(smp: BsdfSample, n_faced):
    """The next ray's origin off a BSSRDF exit point (``integrator.py
    :588-601``; reference: pathtrace.metal:6741-6766): off the exit normal
    (the faced geometric normal where that is not finite and non-zero)
    by eps on the side of the direction, then 32 eps along the normal and
    32 eps along the direction."""
    en = smp.exit_normal
    bad = ~torch.isfinite(en).all(-1) | (dot(en, en) <= 0.0)
    en = safe_normalize(where3(bad, n_faced, en))
    sign = torch.where(dot(smp.direction, en) >= 0.0, 1.0, -1.0)
    o = fma(en, (sign * C.RAY_ORIGIN_EPSILON)[..., None], smp.exit_point)
    o = fma(en, C.RAY_ORIGIN_EPSILON * 32.0, o)
    return fma(safe_normalize(smp.direction), C.RAY_ORIGIN_EPSILON * 32.0,
               o)


def sample_sss_random_walk(scene, m, rec, wo, incident, state,
                           clamp_p: ClampParams, sss_max_steps: int):
    """Volumetric random walk through the object's interior (reference:
    sample_sss_random_walk_software:4060-4310). ``rec`` holds the hit's
    ``point``, faced geometric ``normal`` and ``front_face`` (the lanes
    that walk). One lobe draw; the coat lobe draws 2, the walk 1 per step
    and 2 more per scatter. Runs up to ``sss_max_steps`` masked steps, each
    tracing the walking lanes (``intersect.trace_scene``: K1 and K3 on the
    card); stops early once no lane walks, which changes no value.
    Returns (state, BsdfSample)."""
    from metal_pathtracer_tpu_torch.ops import intersect

    shape, dev = rec.normal.shape[:-1], rec.normal.device
    normal, front = rec.normal, rec.front_face
    p_coat = torch.clamp(m.coat_sample_weight, 0.0, 1.0)
    state, rand_lobe = rng_ops.rand_uniform(state)
    take_coat = (p_coat > 0.0) & (rand_lobe < p_coat)

    # ---- coat lobe (2 draws) ----------------------------------------------
    coat_roughness = plastic_coat_roughness(m)
    alpha = coat_roughness * coat_roughness
    f0c = plastic_coat_f0(m)[..., None].expand(normal.shape)
    state_c, wh = sample_ggx_vndf(normal, wo, coat_roughness, state)
    wi_c = safe_normalize(reflect(-wo, wh))
    cos_i = dot(normal, wi_c)
    cos_o = dot(normal, wo)
    d = ggx_d(alpha, dot(normal, wh))
    g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i)
    spec = schlick_fresnel(f0c, dot(wi_c, wh)) * fdiv(
        d * g, torch.clamp_min(4.0 * cos_o * cos_i, 1e-6))[..., None]
    spec = clamp_specular_tail(spec * plastic_specular_tint(m),
                               coat_roughness, f0c, clamp_p)
    spec_pdf_raw = ggx_pdf(alpha, normal, wo, wi_c)
    spec_pdf = clamp_specular_pdf(spec_pdf_raw, clamp_p)
    combined_pdf = torch.clamp_min(p_coat * spec_pdf, 1e-6)
    weight_c = torch.clamp_min(spec * fdiv(cos_i, combined_pdf)[..., None],
                               0.0)
    coat_ok = ((dot(wh, normal) > 0.0) & torch.isfinite(wi_c).all(-1)
               & (cos_i > 0.0) & (cos_o > 0.0) & (dot(wi_c, wh) > 0.0)
               & (spec_pdf_raw > 0.0) & torch.isfinite(weight_c).all(-1))
    coat = BsdfSample.invalid(shape, dev)
    coat = coat.replace(
        direction=where3(coat_ok, wi_c, coat.direction),
        weight=where3(coat_ok, weight_c, coat.weight),
        pdf=torch.where(coat_ok, combined_pdf, 0.0),
        directional_pdf=torch.where(coat_ok, spec_pdf, 0.0),
        lobe_type=coat_ok.to(torch.int32),
        lobe_roughness=torch.where(coat_ok, coat_roughness, 0.0))

    # ---- the walk ---------------------------------------------------------
    p_diffuse = torch.clamp_min(1.0 - p_coat, 1e-3)
    anisotropy = torch.clamp(m.sss_g, -0.99, 0.99)
    mean_free_path = torch.clamp_min(m.sss_mfp, 1e-4)
    base_color = material_base_color(m)
    sigma_a = sss_sigma_a(m, base_color, mean_free_path, anisotropy)
    sigma_sp = sss_sigma_s_prime(m, base_color, mean_free_path, anisotropy)
    sigma_t = torch.clamp_min(sigma_a + sigma_sp, 1e-6)
    sigma_t_scalar = torch.clamp_min(sigma_t.amax(-1), 1e-4)
    scatter_albedo = torch.clamp(
        sigma_sp / torch.clamp_min(sigma_t, 1e-6), 0.0, 1.0)
    tint = plastic_specular_tint(m)
    has_coat = (m.sss_coat > 0.5)[..., None]

    eta_inside = torch.clamp_min(m.eta, 1.0)
    ones = torch.ones_like(eta_inside)
    cos_theta_i = dot(-incident, normal)
    fr_entry, cos_theta_t = fresnel_dielectric_exact(cos_theta_i, ones,
                                                     eta_inside)
    enter_dir = refract(incident, normal, fdiv(ones, eta_inside))
    enter_ok = ((cos_theta_i > 0.0) & torch.isfinite(enter_dir).all(-1)
                & (dot(enter_dir, enter_dir) > 0.0))
    enter_dir = safe_normalize(enter_dir)
    eta_scale = eta_inside * eta_inside
    dir_scale = eta_scale * (cos_theta_t / torch.clamp_min(cos_theta_i, 1e-6))
    tp = fdiv(torch.ones_like(normal), p_diffuse[..., None]) \
        * (torch.clamp_min(1.0 - fr_entry, 0.0) * dir_scale)[..., None]
    tp = torch.where(has_coat, tp * tint, tp)

    pos = offset_surface_point(rec.point, -normal, enter_dir)
    dirn = enter_dir
    walking = front & ~take_coat & enter_ok
    exited = torch.zeros(shape, dtype=torch.bool, device=dev)
    e_pt = torch.zeros_like(normal)
    e_n = torch.zeros_like(normal)
    e_dir = torch.zeros_like(normal)
    e_tp = torch.zeros_like(normal)
    eta_scale_exit = fdiv(1.0, eta_inside * eta_inside)
    st = state
    for _ in range(max(int(sss_max_steps), 1)):
        if not bool(walking.any()):
            break
        st0 = st
        st, xi = rng_ops.rand_uniform(st)
        xi = torch.clamp(xi, 1e-6, _XI_MAX)
        distance = -torch.log(1.0 - xi) / sigma_t_scalar
        b = intersect.trace_scene(
            pos, dirn, scene, C.RAY_ORIGIN_EPSILON,
            torch.where(walking, C.INFINITY_T, 0.0))
        boundary = torch.clamp_min(b.t, 1e-4)
        scatter = walking & b.hit & (distance < boundary)
        reach = walking & b.hit & ~(distance < boundary)

        # volume scatter: Henyey-Greenstein redirection (2 more draws)
        tp_scatter = tp * torch.exp(-sigma_t * distance[..., None]) \
            * scatter_albedo
        cutoff_s = tp_scatter.amax(-1) < SSS_THROUGHPUT_CUTOFF
        st_hg, new_dir = sample_henyey_greenstein_world(-dirn, anisotropy, st)
        dir_ok = torch.isfinite(new_dir).all(-1) \
            & (dot(new_dir, new_dir) > 0.0)
        pos_scatter = fma(dirn, distance[..., None], pos)

        # boundary: refract out, or reflect internally
        tp_reach = tp * torch.exp(-sigma_t * boundary[..., None])
        cutoff_r = tp_reach.amax(-1) < SSS_THROUGHPUT_CUTOFF
        outward = where3(b.front_face, b.normal, -b.normal)
        outward_ok = torch.isfinite(outward).all(-1) \
            & (dot(outward, outward) > 0.0)
        outward = safe_normalize(outward)
        cos_exit_i = dot(-dirn, outward)
        fr_exit, cos_exit_t = fresnel_dielectric_exact(cos_exit_i,
                                                       eta_inside, ones)
        refracted = refract(dirn, outward, eta_inside)
        refract_fail = ~(torch.isfinite(refracted).all(-1)
                         & (dot(refracted, refracted) > 0.0))
        refracted = safe_normalize(refracted)
        dir_scale_exit = eta_scale_exit * (
            cos_exit_t / torch.clamp_min(cos_exit_i, 1e-6))
        tp_exit = tp_reach * (torch.clamp_min(1.0 - fr_exit, 0.0)
                              * dir_scale_exit)[..., None]
        tp_exit = torch.clamp_min(torch.where(has_coat, tp_exit * tint,
                                              tp_exit), 0.0)
        internal = cos_exit_i <= 0.0
        go = reach & ~cutoff_r & outward_ok
        tir = go & (internal | refract_fail)
        exit_now = go & ~internal & ~refract_fail \
            & torch.isfinite(tp_exit).all(-1)

        e_pt = where3(exit_now, b.point, e_pt)
        e_n = where3(exit_now, outward, e_n)
        e_dir = where3(exit_now, refracted, e_dir)
        e_tp = where3(exit_now, tp_exit, e_tp)
        exited = exited | exit_now

        cont = scatter & ~cutoff_s & dir_ok
        pos = where3(cont, pos_scatter, where3(tir, b.point, pos))
        dirn = where3(cont, new_dir, where3(
            tir, safe_normalize(reflect(dirn, outward)), dirn))
        tp = where3(cont, tp_scatter, where3(tir, tp_reach, tp))
        st = torch.where(walking, st, st0)
        st = torch.where(scatter & ~cutoff_s, st_hg, st)
        walking = walking & (cont | tir)

    walk = BsdfSample.invalid(shape, dev)
    walk = walk.replace(
        direction=where3(exited, e_dir, walk.direction),
        weight=where3(exited, e_tp, walk.weight),
        pdf=torch.where(exited, torch.clamp_min(p_diffuse, 1e-4), 0.0),
        directional_pdf=torch.where(exited, 1.0, 0.0),
        is_bssrdf=exited, has_exit_point=exited,
        exit_point=where3(exited, e_pt, walk.exit_point),
        exit_normal=where3(exited, e_n, walk.exit_normal))
    out = select_sample(take_coat, coat, walk)
    out = select_sample(~front, BsdfSample.invalid(shape, dev), out)
    return torch.where(take_coat, state_c, st), out
