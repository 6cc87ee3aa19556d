"""BSDF sampling, evaluation and clamps (``ops/bsdf.py`` twin) for every
material type: lambert, metal, dielectric, plastic, PBR, and through
``ops/carpaint.py`` and ``ops/sss.py`` carpaint and subsurface (diffuse
lights emit and end their path before any BSDF is sampled).

Every type present in the scene is evaluated over the whole wavefront and
each lane keeps its own type's result, so each lane's RNG stream advances
exactly as the reference's per-thread branch does.

The CUDA shade kernels (``csrc/shade.cu``) repeat this arithmetic
operation for operation: products and sums stay unfused except inside
``vecmath.dot``/``cross``/``luminance``/``to_world`` and where a function
says otherwise, and every division is one IEEE division
(``vecmath.fdiv``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops import rng as rng_ops
from metal_pathtracer_tpu_torch.ops.vecmath import (
    build_onb,
    cross,
    dot,
    fdiv,
    fma,
    luminance,
    normalize,
    safe_normalize,
    to_world,
    where3,
)

PI = 3.14159265358979323846


class ClampParams(NamedTuple):
    """Firefly, throughput and specular clamp settings (host floats)."""

    clamp_factor: float
    clamp_floor: float
    throughput_clamp: float
    specular_tail_base: float
    specular_tail_roughness_scale: float
    min_specular_pdf: float
    max_contribution: float
    enabled: float


def make_clamp_params(uniforms) -> ClampParams:
    return ClampParams(
        clamp_factor=uniforms.firefly_clamp_factor,
        clamp_floor=uniforms.firefly_clamp_floor,
        throughput_clamp=uniforms.throughput_clamp,
        specular_tail_base=uniforms.specular_tail_clamp_base,
        specular_tail_roughness_scale=(
            uniforms.specular_tail_clamp_roughness_scale),
        min_specular_pdf=uniforms.min_specular_pdf,
        max_contribution=uniforms.firefly_clamp_max_contribution,
        enabled=uniforms.firefly_clamp_enabled,
    )


def clamp_firefly_contribution(throughput, contribution, p: ClampParams):
    """(reference: pathtrace.metal clamp_firefly_contribution)"""
    combined = throughput * contribution
    finite = torch.isfinite(combined).all(-1)
    positive = torch.clamp_min(combined, 0.0)
    lum = luminance(positive)
    tp_lum = luminance(torch.clamp_min(throughput, 0.0))
    max_lum = torch.clamp_min(tp_lum * p.clamp_factor, p.clamp_floor)
    if p.max_contribution > 0.0:
        max_lum = torch.clamp_min(max_lum, p.max_contribution)
    scale = torch.where((lum > max_lum) & (lum > 0.0),
                        max_lum / torch.clamp_min(lum, 1e-6), 1.0)
    out = positive if p.enabled < 0.5 else \
        torch.clamp_min(combined * scale[..., None], 0.0)
    return where3(finite, out, torch.zeros_like(out))


def clamp_path_throughput(throughput, p: ClampParams):
    """(reference: pathtrace.metal clamp_path_throughput)"""
    finite = torch.isfinite(throughput).all(-1)
    lum = luminance(torch.clamp_min(throughput, 0.0))
    scale = torch.where((lum > p.throughput_clamp) & (lum > 0.0),
                        fdiv(p.throughput_clamp, torch.clamp_min(lum, 1e-6)),
                        1.0)
    out = throughput
    if p.enabled >= 0.5 and p.throughput_clamp > 0.0:
        out = scale[..., None] * throughput
    return where3(finite, out, torch.zeros_like(out))


def clamp_specular_pdf(pdf, p: ClampParams):
    """(reference: pathtrace.metal clamp_specular_pdf)"""
    pdf = torch.clamp_min(torch.where(torch.isfinite(pdf), pdf, 0.0), 0.0)
    raised = torch.clamp_min(pdf, p.min_specular_pdf) \
        if p.min_specular_pdf > 0.0 else pdf
    return torch.where(pdf > 0.0, raised, 0.0)


def clamp_specular_tail(value, roughness, f0, p: ClampParams):
    """(reference: pathtrace.metal clamp_specular_tail)"""
    finite = torch.isfinite(value).all(-1)
    positive = torch.clamp_min(value, 0.0)
    if p.enabled >= 0.5 and (p.specular_tail_base > 0.0
                             or p.specular_tail_roughness_scale > 0.0):
        strength = torch.clamp_min(
            torch.maximum(torch.maximum(f0[..., 0], f0[..., 1]), f0[..., 2]),
            1e-3)
        limit = (p.specular_tail_base
                 + p.specular_tail_roughness_scale * roughness) * strength
        limit = torch.clamp_min(limit, p.clamp_floor)
        lum = luminance(positive)
        scale = torch.where((lum > limit) & (lum > 0.0),
                            limit / torch.clamp_min(lum, 1e-6), 1.0)
        positive = positive * scale[..., None]
    return where3(finite, positive, torch.zeros_like(positive))


# ---------------------------------------------------------------------------
# Fresnel / GGX microfacet helpers (reference: pathtrace.metal:3645-3911)
# ---------------------------------------------------------------------------

def schlick_weight(cos_theta):
    m = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    return m * m * m * m * m


def schlick_fresnel(f0, cos_theta):
    return f0 + (1.0 - f0) * schlick_weight(cos_theta)[..., None]


def fresnel_dielectric_exact(cos_theta_i, eta_i, eta_t):
    """Exact unpolarized dielectric Fresnel, returning (Fr, cosThetaT)
    (reference: pathtrace.metal fresnel_dielectric_exact:3645-3674)."""
    abs_cos = torch.clamp(cos_theta_i, -1.0, 1.0).abs()
    sin2_i = torch.clamp_min(1.0 - abs_cos * abs_cos, 0.0)
    eta = eta_i / eta_t
    sin2_t = eta * eta * sin2_i
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    ei_ci = eta_i * abs_cos
    et_ct = eta_t * cos_t
    rs = (ei_ci - et_ct) / (ei_ci + et_ct)
    rp = (eta_t * abs_cos - eta_i * cos_t) / (eta_t * abs_cos + eta_i * cos_t)
    fr = 0.5 * (rs * rs + rp * rp)
    return torch.where(tir, 1.0, fr), torch.where(tir, 0.0, cos_t)


def fresnel_conductor(cos_theta_i, eta, k):
    """(reference: pathtrace.metal fresnel_conductor:3677-3698)"""
    cos_theta_i = torch.clamp(cos_theta_i, -1.0, 1.0)
    cos2 = (cos_theta_i * cos_theta_i)[..., None]
    sin2 = torch.clamp_min(1.0 - cos2, 0.0)
    eta2 = eta * eta
    k2 = k * k
    t0 = eta2 - k2 - sin2
    a2b2 = torch.sqrt(torch.clamp_min(t0 * t0 + 4.0 * eta2 * k2, 0.0))
    a = torch.sqrt(torch.clamp_min(0.5 * (a2b2 + t0), 0.0))
    term1 = a2b2 + cos2
    term2 = 2.0 * cos_theta_i[..., None] * a
    rs = (term1 - term2) / (term1 + term2)
    term3 = cos2 * a2b2 + sin2 * sin2
    term4 = term2 * sin2
    rp = (term3 - term4) / (term3 + term4)
    return torch.clamp(0.5 * (rs * rs + rp * rp), 0.0, 1.0)


def ggx_lambda(alpha, cos_theta):
    abs_cos = cos_theta.abs()
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - abs_cos * abs_cos, 0.0))
    tan_theta = sin_theta / torch.clamp_min(abs_cos, 1e-20)
    a = alpha * tan_theta
    lam = (torch.sqrt(1.0 + a * a) - 1.0) * 0.5
    return torch.where((abs_cos <= 0.0) | (sin_theta == 0.0), 0.0, lam)


def ggx_g1(alpha, cos_theta):
    return fdiv(1.0, 1.0 + ggx_lambda(alpha, cos_theta))


def ggx_d(alpha, cos_theta_h):
    abs_ch = cos_theta_h.abs()
    a2 = alpha * alpha
    denom = fma(abs_ch * abs_ch, a2 - 1.0, 1.0)
    return a2 / (PI * denom * denom)


def ggx_pdf(alpha, normal, wo, wi):
    wh = safe_normalize(wo + wi)
    cos_h = dot(normal, wh)
    dot_wo_wh = dot(wo, wh)
    cos_o = dot(normal, wo)
    pdf = ggx_d(alpha, cos_h) * ggx_g1(alpha, cos_o) * cos_h \
        / (4.0 * torch.clamp_min(dot_wo_wh, 1e-6))
    return torch.where((cos_o <= 0.0) | (cos_h <= 0.0) | (dot_wo_wh <= 0.0),
                       0.0, pdf)


def reflect(v, n):
    """Mirror v about n (Metal ``reflect``: v points toward the surface)."""
    return v - (2.0 * dot(v, n))[..., None] * n


def refract(v, n, eta_ratio):
    """Metal/GLSL ``refract``; the zero vector on total internal
    reflection. ``eta_ratio`` is (N,) etaI/etaT."""
    cos_i = -dot(v, n)
    sin2_t = eta_ratio * eta_ratio * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    k = 1.0 - sin2_t
    refr = eta_ratio[..., None] * v + (
        eta_ratio * cos_i - torch.sqrt(torch.clamp_min(k, 0.0)))[..., None] * n
    return where3(k >= 0.0, refr, torch.zeros_like(v))


def sample_ggx_vndf(normal, wo, roughness, state):
    """Heitz VNDF sampling (reference: pathtrace.metal
    sample_ggx_vndf:3770-3797); exactly 2 uniforms per lane."""
    tangent, bitangent = build_onb(normal)
    w = safe_normalize(wo)
    lx, ly = dot(w, tangent), dot(w, bitangent)
    lz = torch.clamp_min(dot(w, normal), 1e-6)
    alpha = torch.clamp_min(roughness * roughness, 1e-4)
    vh = safe_normalize(torch.stack([alpha * lx, alpha * ly, lz], -1))
    lensq = vh[..., 0] * vh[..., 0] + vh[..., 1] * vh[..., 1]
    inv = fdiv(1.0, torch.sqrt(torch.clamp_min(lensq, 1e-38)))
    t1 = torch.stack([-vh[..., 1] * inv, vh[..., 0] * inv,
                      torch.zeros_like(inv)], -1)
    x_axis = torch.zeros_like(t1)
    x_axis[..., 0] = 1.0
    t1 = where3(lensq > 0.0, t1, x_axis)
    t2 = cross(vh, t1)
    state, u1 = rng_ops.rand_uniform(state)
    state, u2 = rng_ops.rand_uniform(state)
    r = torch.sqrt(u1)
    phi = (2.0 * PI) * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2_adj = (1.0 - s) * torch.sqrt(torch.clamp_min(1.0 - p1 * p1, 0.0)) \
        + s * p2
    p3 = torch.sqrt(torch.clamp_min(1.0 - p1 * p1 - p2_adj * p2_adj, 0.0))
    nh = p1[..., None] * t1 + p2_adj[..., None] * t2 + p3[..., None] * vh
    ne = safe_normalize(torch.stack(
        [alpha * nh[..., 0], alpha * nh[..., 1],
         torch.clamp_min(nh[..., 2], 0.0)], -1))
    return state, safe_normalize(to_world(ne, normal))


def dfg_approx(roughness, nov):
    """Karis split-sum DFG approximation (reference: pathtrace.metal
    dfg_approx)."""
    r0 = roughness * -1.0 + 1.0
    r1 = roughness * -0.0275 + 0.0425
    r2 = roughness * -0.572 + 1.04
    r3 = roughness * 0.022 + -0.04
    a004 = torch.minimum(r0 * r0, torch.exp2(-9.28 * nov)) * r0 + r1
    return -1.04 * a004 + r2, 1.04 * a004 + r3


def specular_energy_compensation(f0, roughness, nov):
    """Multiple-scattering energy compensation (reference: pathtrace.metal
    specular_energy_compensation)."""
    dfg_x, dfg_y = dfg_approx(roughness, torch.clamp(nov, 0.0, 1.0))
    fss = torch.clamp(f0 * dfg_x[..., None] + dfg_y[..., None], 0.0, 0.99)
    favg = f0 + (1.0 - f0) * C.SCHLICK_AVERAGE_FACTOR
    one_minus_fss = torch.clamp(1.0 - fss, 0.0, 1.0)
    denom = torch.clamp_min(1.0 - favg * one_minus_fss, 1e-3)
    fms = (favg * one_minus_fss) / denom
    scale = (fss + fms) / torch.clamp_min(fss, 1e-4)
    return torch.clamp(scale, 1.0, 2.0)


# ---------------------------------------------------------------------------
# Material lanes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MatLanes:
    """Material rows gathered onto lanes: the fields the BSDFs, the
    emission and the medium stack read."""

    base_color: torch.Tensor          # (N,3)
    roughness: torch.Tensor
    mat_type: torch.Tensor            # (N,) i32
    eta: torch.Tensor
    thin: torch.Tensor
    emission: torch.Tensor            # (N,3)
    emission_env: torch.Tensor
    conductor_eta: torch.Tensor       # (N,3)
    conductor_k: torch.Tensor         # (N,3)
    has_conductor: torch.Tensor
    dielectric_sigma_a: torch.Tensor  # (N,3)
    pbr_metallic: torch.Tensor
    pbr_transmission: torch.Tensor
    pbr_thickness: torch.Tensor
    pbr_double_sided: torch.Tensor
    # plastic / carpaint coat layer
    coat_ior: torch.Tensor
    coat_roughness: torch.Tensor
    coat_thickness: torch.Tensor
    coat_sample_weight: torch.Tensor
    coat_fresnel_avg: torch.Tensor
    coat_tint: torch.Tensor           # (N,3)
    coat_absorption: torch.Tensor     # (N,3)
    # carpaint base and flake lobes
    carpaint_base_metallic: torch.Tensor
    carpaint_base_roughness: torch.Tensor
    carpaint_flake_scale: torch.Tensor
    carpaint_flake_sample_weight: torch.Tensor
    carpaint_flake_roughness: torch.Tensor
    carpaint_flake_anisotropy: torch.Tensor
    carpaint_flake_normal_strength: torch.Tensor
    carpaint_has_base_conductor: torch.Tensor
    carpaint_base_eta: torch.Tensor   # (N,3)
    carpaint_base_k: torch.Tensor     # (N,3)
    # subsurface
    sss_g: torch.Tensor
    sss_mfp: torch.Tensor
    sss_method: torch.Tensor          # 0 separable / 1 random walk
    sss_coat: torch.Tensor
    sss_sigma_override: torch.Tensor
    sss_sigma_a: torch.Tensor         # (N,3)
    sss_sigma_s: torch.Tensor         # (N,3)


def gather_material(materials, index) -> MatLanes:
    idx = torch.clamp(index, 0, materials.count - 1).long()
    return MatLanes(**{f.name: getattr(materials, f.name)[idx]
                       for f in dataclasses.fields(MatLanes)})


def material_base_color(m: MatLanes):
    return torch.clamp(m.base_color, 0.0, 1.0)


def material_is_delta(m: MatLanes):
    """(reference: pathtrace.metal material_is_delta)"""
    rough = torch.clamp(m.roughness, 0.0, 1.0)
    glossy = (m.mat_type == C.MATERIAL_METAL) | (m.mat_type == C.MATERIAL_PBR)
    return (m.mat_type == C.MATERIAL_DIELECTRIC) | (glossy & (rough <= 1e-3))


def material_has_conductor_ior(m: MatLanes):
    return ((m.has_conductor > 0.0) | (m.conductor_eta > 0.0).any(-1)
            | (m.conductor_k > 0.0).any(-1))


def conductor_f0(m: MatLanes):
    """Normal-incidence reflectance of a metal: the conductor Fresnel at
    cos 1 where the material carries an eta/k, else its base colour."""
    fc = fresnel_conductor(torch.ones_like(m.roughness), m.conductor_eta,
                           m.conductor_k)
    return where3(material_has_conductor_ior(m), fc, material_base_color(m))


def metal_fresnel(m: MatLanes, f0, cos_theta):
    """The conductor Fresnel where the material has an eta/k, else
    Schlick's from ``f0``."""
    return where3(material_has_conductor_ior(m),
                  fresnel_conductor(cos_theta, m.conductor_eta,
                                    m.conductor_k),
                  schlick_fresnel(f0, cos_theta))


def plastic_coat_ior(m: MatLanes):
    return torch.clamp_min(m.eta, 1.0)


def plastic_coat_roughness(m: MatLanes):
    return torch.clamp_min(torch.clamp(m.coat_roughness, 0.0, 1.0), 1e-3)


def plastic_coat_f0(m: MatLanes):
    eta = plastic_coat_ior(m)
    ratio = (eta - 1.0) / torch.clamp_min(eta + 1.0, 1e-6)
    return torch.clamp(ratio * ratio, 0.0, 0.999)


def plastic_specular_tint(m: MatLanes):
    """(reference: pathtrace.metal plastic_specular_tint)"""
    tint = torch.clamp(m.coat_tint, 0.0, 1.0)
    thickness = torch.clamp_min(m.coat_thickness, 0.0)
    absorption = torch.clamp_min(m.coat_absorption, 0.0)
    attenuated = torch.clamp(
        tint * torch.exp(-absorption * thickness[..., None]), 0.0, 1.0)
    skip = (thickness <= 0.0) | (absorption <= 1e-6).all(-1)
    return where3(skip, tint, attenuated)


def plastic_diffuse_transmission(m: MatLanes, cos_i, cos_o):
    """(reference: pathtrace.metal plastic_diffuse_transmission)"""
    thickness = torch.clamp_min(m.coat_thickness, 0.0)
    tint = torch.clamp(m.coat_tint, 0.0, 1.0)
    absorption = torch.clamp_min(m.coat_absorption, 0.0)
    safe_i = torch.clamp_min(cos_i, 1e-3)
    safe_o = torch.clamp_min(cos_o, 1e-3)
    att_i = torch.exp(-absorption * (thickness / safe_i)[..., None])
    att_o = torch.exp(-absorption * (thickness / safe_o)[..., None])
    full = torch.clamp(tint * att_i * att_o, 0.0, 1.0)
    return where3(thickness <= 0.0, tint, full)


def environment_lighting_roughness(m: MatLanes):
    """(reference: pathtrace.metal environment_lighting_roughness)"""
    rough = torch.clamp(m.roughness, 0.0, 1.0)
    glossy = (m.mat_type == C.MATERIAL_METAL) | (m.mat_type == C.MATERIAL_PBR)
    out = torch.where(glossy, rough, 1.0)
    out = torch.where(m.mat_type == C.MATERIAL_PLASTIC,
                      torch.clamp(plastic_coat_roughness(m), 0.0, 1.0), out)
    return torch.where(m.mat_type == C.MATERIAL_CARPAINT,
                       torch.clamp(m.carpaint_base_roughness, 0.0, 1.0), out)


def lambert_pdf(normal, direction):
    cos_t = torch.clamp_min(dot(normal, normalize(direction)), 0.0)
    return torch.where(cos_t > 0.0, fdiv(cos_t, PI), 0.0)


# ---------------------------------------------------------------------------
# Sample / eval results
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BsdfSample:
    direction: torch.Tensor        # (N,3)
    weight: torch.Tensor           # (N,3) — f * cos / pdf
    pdf: torch.Tensor              # (N,)
    directional_pdf: torch.Tensor  # (N,)
    is_delta: torch.Tensor         # (N,) bool
    medium_event: torch.Tensor     # (N,) i32: +1 enter a medium, -1 leave
    lobe_type: torch.Tensor        # (N,) i32: 0 diffuse, 1 glossy, 2 trans
    lobe_roughness: torch.Tensor   # (N,)
    is_bssrdf: torch.Tensor        # (N,) bool
    has_exit_point: torch.Tensor   # (N,) bool: the next ray leaves from
    exit_point: torch.Tensor       # (N,3)      the BSSRDF exit point,
    exit_normal: torch.Tensor      # (N,3)      off its normal

    @classmethod
    def invalid(cls, shape, device):
        z = torch.zeros(shape, device=device)
        z3 = torch.zeros(shape + (3,), device=device)
        zi = torch.zeros(shape, dtype=torch.int32, device=device)
        zb = torch.zeros(shape, dtype=torch.bool, device=device)
        return cls(direction=z3, weight=z3, pdf=z, directional_pdf=z,
                   is_delta=zb, medium_event=zi, lobe_type=zi,
                   lobe_roughness=z, is_bssrdf=zb, has_exit_point=zb,
                   exit_point=z3, exit_normal=z3)

    def replace(self, **changes) -> "BsdfSample":
        return dataclasses.replace(self, **changes)


class BsdfEval(NamedTuple):
    value: torch.Tensor   # (N,3)
    pdf: torch.Tensor     # (N,)
    is_delta: torch.Tensor
    is_bssrdf: torch.Tensor = None  # subsurface lanes (no NEE add)


def select_sample(mask, a: BsdfSample, b: BsdfSample) -> BsdfSample:
    """Lanes where ``mask`` take ``a``, else ``b``."""
    out = {}
    for f in dataclasses.fields(BsdfSample):
        x, y = getattr(a, f.name), getattr(b, f.name)
        m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
        out[f.name] = torch.where(m, x, y)
    return BsdfSample(**out)


# ---------------------------------------------------------------------------
# Per-type samplers (each consumes RNG like its reference branch)
# ---------------------------------------------------------------------------

def _sample_lambert(m: MatLanes, normal, state, diffuse_occlusion):
    """case 0 (reference: pathtrace.metal:5163-5196); 2 draws"""
    state, local = rng_ops.sample_cosine_hemisphere(state)
    wi = safe_normalize(to_world(local, normal))
    cos_i = dot(normal, wi)
    pdf = lambert_pdf(normal, wi)
    albedo = material_base_color(m) * torch.clamp(diffuse_occlusion, 0.0,
                                                  1.0)[..., None]
    f = fdiv(albedo, PI)
    weight = torch.clamp_min(
        f * (cos_i / torch.clamp_min(pdf, 1e-20))[..., None], 0.0)
    ok = (cos_i > 0.0) & (pdf > 0.0) & torch.isfinite(weight).all(-1)
    out = BsdfSample.invalid(pdf.shape, pdf.device)
    return state, out.replace(
        direction=where3(ok, wi, out.direction),
        weight=where3(ok, weight, out.weight),
        pdf=torch.where(ok, pdf, 0.0),
        directional_pdf=torch.where(ok, pdf, 0.0),
        lobe_roughness=torch.where(ok, 1.0, 0.0))


def _sample_metal(m: MatLanes, normal, wo, incident, state,
                  clamp_p: ClampParams):
    """case 1 (reference: pathtrace.metal:5197-5284): a mirror at
    roughness <= 1e-3 (no draw), else a GGX lobe (2 draws)."""
    roughness = torch.clamp(m.roughness, 0.0, 1.0)
    f0 = conductor_f0(m)
    smooth = roughness <= 1e-3
    # delta (mirror) branch
    wi_d = reflect(incident, normal)
    cos_i_d = dot(normal, wi_d)
    cos_o = dot(normal, wo)
    f_delta = metal_fresnel(m, f0, torch.clamp_min(cos_o, 0.0))
    # rough GGX branch
    state_r, wh = sample_ggx_vndf(normal, wo, roughness, state)
    alpha = roughness * roughness
    wi_r = safe_normalize(reflect(-wo, wh))
    cos_i = dot(normal, wi_r)
    dot_wo_wh = dot(wo, wh)
    d = ggx_d(alpha, dot(normal, wh))
    g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i)
    f_val = metal_fresnel(m, f0, dot(wi_r, wh)) * fdiv(
        d * g, torch.clamp_min(4.0 * cos_o * cos_i, 1e-6))[..., None]
    f_val = f_val * specular_energy_compensation(f0, roughness, cos_o)
    f_val = clamp_specular_tail(f_val, roughness, f0, clamp_p)
    pdf_raw = ggx_pdf(alpha, normal, wo, wi_r)
    pdf = clamp_specular_pdf(pdf_raw, clamp_p)
    weight = torch.clamp_min(
        f_val * fdiv(cos_i, torch.clamp_min(pdf, 1e-20))[..., None], 0.0)
    rough_ok = ((dot(wh, normal) > 0.0) & torch.isfinite(wi_r).all(-1)
                & (cos_i > 0.0) & (cos_o > 0.0) & (dot_wo_wh > 0.0)
                & (pdf_raw > 0.0) & torch.isfinite(weight).all(-1))
    rough_valid = ~smooth & rough_ok
    delta_valid = smooth & (cos_i_d > 0.0)
    out = BsdfSample.invalid(pdf.shape, pdf.device)
    ones = torch.ones_like(pdf)
    ok = rough_valid | delta_valid
    return torch.where(smooth, state, state_r), out.replace(
        direction=where3(rough_valid, wi_r,
                         where3(delta_valid, wi_d, out.direction)),
        weight=where3(rough_valid, weight,
                      where3(delta_valid, f_delta, out.weight)),
        pdf=torch.where(rough_valid, pdf, torch.where(delta_valid, ones,
                                                      out.pdf)),
        directional_pdf=torch.where(rough_valid, pdf,
                                    torch.where(delta_valid, ones,
                                                out.directional_pdf)),
        is_delta=delta_valid,
        lobe_type=torch.where(ok, 1, out.lobe_type).to(torch.int32),
        lobe_roughness=torch.where(ok, roughness, out.lobe_roughness))


def _evaluate_metal(m: MatLanes, normal, wo, wi, cos_o, cos_i,
                    clamp_p: ClampParams):
    """The metal branch of ``evaluate_bsdf`` (``bsdf.py:846-867``):
    (value, pdf, valid, smooth); ``cos_o``/``cos_i`` are clamped at 0."""
    rough = torch.clamp(m.roughness, 0.0, 1.0)
    smooth = rough <= 1e-3
    alpha = rough * rough
    wh = safe_normalize(wo + wi)
    half_ok = ((dot(wh, normal) > 0.0) & (dot(wo, wh) > 0.0)
               & (dot(wi, wh) > 0.0))
    d = ggx_d(alpha, dot(normal, wh))
    g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i)
    f0 = conductor_f0(m)
    spec = metal_fresnel(m, f0, dot(wi, wh)) * fdiv(
        d * g, torch.clamp_min(4.0 * cos_o * cos_i, 1e-6))[..., None]
    spec = spec * specular_energy_compensation(f0, rough, cos_o)
    spec = clamp_specular_tail(spec, rough, f0, clamp_p)
    p_raw = ggx_pdf(alpha, normal, wo, wi)
    valid = ~smooth & half_ok & (p_raw > 0.0)
    return (torch.clamp_min(spec, 0.0), clamp_specular_pdf(p_raw, clamp_p),
            valid, smooth)


def _sample_dielectric(m: MatLanes, normal, incident, front_face, state):
    """case 2 (reference: pathtrace.metal:5647-5695); 1 draw"""
    is_thin = (m.mat_type == C.MATERIAL_DIELECTRIC) & (m.thin > 0.5)
    ref_idx = torch.clamp_min(m.eta, 1.0)
    inside = ~is_thin & ~front_face
    eta_i = torch.where(inside, ref_idx, 1.0)
    eta_t = torch.where(inside, 1.0, ref_idx)
    relative_eta = eta_i / eta_t
    cos_o = torch.clamp(dot(-incident, normal), -1.0, 1.0)
    fr, cos_t = fresnel_dielectric_exact(cos_o, eta_i, eta_t)
    state, xi = rng_ops.rand_uniform(state)
    choose_reflect = xi < fr
    refl_dir = reflect(incident, normal)
    refr_dir = refract(incident, normal, relative_eta)
    refr_len2 = dot(refr_dir, refr_dir)
    refr_unit = refr_dir / torch.sqrt(
        torch.clamp_min(refr_len2, 1e-38))[..., None]
    eta_scale = (eta_t * eta_t) / (eta_i * eta_i)
    dir_scale = eta_scale * (cos_t.abs() / torch.clamp_min(cos_o.abs(), 1e-6))
    refr_weight = torch.clamp_min(1.0 - fr, 0.0) * dir_scale
    reflecting = choose_reflect | (refr_len2 <= 0.0)
    direction = where3(reflecting, refl_dir, refr_unit)
    weight = torch.where(reflecting, fr, refr_weight)[..., None].expand(
        direction.shape)
    medium_event = torch.where(~reflecting & ~is_thin,
                               torch.where(front_face, 1, -1), 0)
    one = torch.ones_like(fr)
    return state, BsdfSample.invalid(fr.shape, fr.device).replace(
        direction=safe_normalize(direction), weight=weight.contiguous(),
        pdf=one, directional_pdf=one.clone(),
        is_delta=torch.ones_like(front_face),
        medium_event=medium_event.to(torch.int32),
        lobe_type=torch.ones(fr.shape, dtype=torch.int32, device=fr.device),
        lobe_roughness=torch.zeros_like(fr))


def _sample_plastic(m: MatLanes, normal, wo, state, clamp_p: ClampParams,
                    diffuse_occlusion, specular_only: bool = False):
    """case 4 (reference: pathtrace.metal:5285-5419): 1 selector draw,
    then 2 for either lobe (GGX coat or cosine diffuse).
    ``specular_only``: the coat is always chosen, the diffuse lobe is
    black (``bsdf.py:666, 707``)."""
    cos_o = dot(normal, wo)
    coat_roughness = plastic_coat_roughness(m)
    alpha = coat_roughness * coat_roughness
    f0c = plastic_coat_f0(m)[..., None].expand(normal.shape)
    p_coat = torch.clamp(m.coat_sample_weight, 0.0, 1.0)
    if specular_only:
        p_coat = torch.ones_like(p_coat)
    p_diffuse = 1.0 - p_coat
    fresnel_avg = torch.clamp(m.coat_fresnel_avg, 0.0, 1.0)
    spec_tint = plastic_specular_tint(m)

    state, selector = rng_ops.rand_uniform(state)
    sample_coat = (selector < p_coat) & (p_coat > 0.0)

    # coat lobe (2 draws)
    state_c, wh = sample_ggx_vndf(normal, wo, coat_roughness, state)
    wi_c = safe_normalize(reflect(-wo, wh))
    cos_i_c = dot(normal, wi_c)
    dot_wi_wh = dot(wi_c, wh)
    d = ggx_d(alpha, dot(normal, wh))
    g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i_c)
    spec = schlick_fresnel(f0c, dot_wi_wh) * fdiv(
        d * g, torch.clamp_min(4.0 * cos_o * cos_i_c, 1e-6))[..., None]
    spec = clamp_specular_tail(spec, coat_roughness, f0c, clamp_p)
    spec = spec * spec_tint
    spec_pdf_raw = ggx_pdf(alpha, normal, wo, wi_c)
    spec_pdf = torch.where(spec_pdf_raw > 0.0,
                           clamp_specular_pdf(spec_pdf_raw, clamp_p), 0.0)
    pdf_c = p_coat * spec_pdf + p_diffuse * lambert_pdf(normal, wi_c)
    weight_c = spec * fdiv(cos_i_c, torch.clamp_min(pdf_c, 1e-20))[..., None]
    coat_ok = ((dot(wh, normal) > 0.0) & (cos_i_c > 0.0) & (dot_wi_wh > 0.0)
               & (pdf_c > 0.0) & torch.isfinite(weight_c).all(-1))

    # diffuse lobe (2 draws)
    state_d, local = rng_ops.sample_cosine_hemisphere(state)
    wi_d = safe_normalize(to_world(local, normal))
    cos_i_d = dot(normal, wi_d)
    diffuse = fdiv(material_base_color(m), PI) \
        * torch.clamp(diffuse_occlusion, 0.0, 1.0)[..., None]
    diffuse = diffuse * plastic_diffuse_transmission(m, cos_i_d, cos_o) \
        * (1.0 - schlick_fresnel(f0c, cos_i_d)) \
        * (1.0 - schlick_fresnel(f0c, cos_o))
    diffuse = torch.clamp_min(
        diffuse * torch.clamp_min(1.0 - fresnel_avg, 0.0)[..., None], 0.0)
    if specular_only:
        diffuse = torch.zeros_like(diffuse)
    spec_pdf_raw_d = ggx_pdf(alpha, normal, wo, wi_d)
    spec_pdf_d = torch.where(spec_pdf_raw_d > 0.0,
                             clamp_specular_pdf(spec_pdf_raw_d, clamp_p), 0.0)
    pdf_d = p_coat * spec_pdf_d + p_diffuse * lambert_pdf(normal, wi_d)
    weight_d = diffuse * fdiv(cos_i_d,
                              torch.clamp_min(pdf_d, 1e-20))[..., None]
    diff_ok = ((cos_i_d > 0.0) & (pdf_d > 0.0)
               & torch.isfinite(weight_d).all(-1))

    coat_valid = sample_coat & coat_ok & (cos_o > 0.0)
    diff_valid = ~sample_coat & diff_ok & (cos_o > 0.0)
    out = BsdfSample.invalid(cos_o.shape, cos_o.device)
    pdf = torch.where(coat_valid, pdf_c, torch.where(diff_valid, pdf_d, 0.0))
    return torch.where(sample_coat, state_c, state_d), out.replace(
        direction=where3(coat_valid, wi_c,
                         where3(diff_valid, wi_d, out.direction)),
        weight=where3(coat_valid, torch.clamp_min(weight_c, 0.0),
                      where3(diff_valid, torch.clamp_min(weight_d, 0.0),
                             out.weight)),
        pdf=pdf, directional_pdf=pdf,
        lobe_type=coat_valid.to(torch.int32),
        lobe_roughness=torch.where(coat_valid, coat_roughness,
                                   torch.where(diff_valid, 1.0, 0.0)))


def _evaluate_plastic(m: MatLanes, normal, wo, wi, cos_o, cos_i,
                      clamp_p: ClampParams, diffuse_occlusion,
                      specular_only: bool = False):
    """The plastic branch of ``evaluate_bsdf`` (``bsdf.py:872-917``):
    (value, pdf); ``cos_o``/``cos_i`` are clamped at 0. ``specular_only``:
    the coat alone (``bsdf.py:900, 905``)."""
    coat_roughness = plastic_coat_roughness(m)
    alpha = coat_roughness * coat_roughness
    f0c = plastic_coat_f0(m)[..., None].expand(normal.shape)
    wh = safe_normalize(wo + wi)
    half_ok = ((dot(wh, normal) > 0.0) & (dot(wo, wh) > 0.0)
               & (dot(wi, wh) > 0.0))
    d = ggx_d(alpha, dot(normal, wh))
    g = ggx_g1(alpha, cos_o) * ggx_g1(alpha, cos_i)
    spec = schlick_fresnel(f0c, dot(wi, wh)) * fdiv(
        d * g, torch.clamp_min(4.0 * cos_o * cos_i, 1e-6))[..., None]
    spec = clamp_specular_tail(spec, coat_roughness, f0c, clamp_p)
    spec = spec * plastic_specular_tint(m)
    spec = where3(half_ok, torch.clamp_min(spec, 0.0), torch.zeros_like(spec))
    spec_pdf_raw = ggx_pdf(alpha, normal, wo, wi)
    spec_pdf = torch.where(half_ok & (spec_pdf_raw > 0.0),
                           clamp_specular_pdf(spec_pdf_raw, clamp_p), 0.0)
    diffuse = fdiv(material_base_color(m), PI) \
        * torch.clamp(diffuse_occlusion, 0.0, 1.0)[..., None]
    diffuse = diffuse * plastic_diffuse_transmission(m, cos_i, cos_o) \
        * (1.0 - schlick_fresnel(f0c, cos_i)) \
        * (1.0 - schlick_fresnel(f0c, cos_o))
    diffuse = torch.clamp_min(diffuse * torch.clamp_min(
        1.0 - torch.clamp(m.coat_fresnel_avg, 0.0, 1.0), 0.0)[..., None], 0.0)
    p_coat = torch.clamp(m.coat_sample_weight, 0.0, 1.0)
    if specular_only:
        diffuse = torch.zeros_like(diffuse)
        p_coat = torch.ones_like(p_coat)
    return spec + diffuse, p_coat * spec_pdf \
        + (1.0 - p_coat) * lambert_pdf(normal, wi)


def sample_bsdf(m: MatLanes, normal, wo, incident, front_face, state,
                clamp_p: ClampParams, diffuse_occlusion, material_types,
                position=None, sss_mode: int = 0,
                specular_only: bool = False):
    """Type-dispatched sampling over the wavefront (reference:
    pathtrace.metal sample_bsdf:5136-5717). ``position`` is the hit point
    (carpaint's flakes and the separable BSSRDF's exit point read it);
    ``sss_mode`` 1 takes the separable BSSRDF on subsurface lanes, other
    modes the lambert fallback (random-walk lanes are overridden by the
    walk, ``ops/sss.py``). ``specular_only`` (``debugSpecularOnly``,
    ``bsdf.py:786``): lambert and subsurface lanes draw nothing and keep
    the invalid sample, plastic and PBR drop their diffuse lobes; metal,
    dielectric and carpaint are unchanged. Returns (new_state,
    BsdfSample)."""
    from metal_pathtracer_tpu_torch.ops import carpaint as carpaint_ops
    from metal_pathtracer_tpu_torch.ops import pbr as pbr_ops
    from metal_pathtracer_tpu_torch.ops import sss as sss_ops

    types = set(int(t) for t in material_types)
    out = BsdfSample.invalid(state.shape, state.device)
    new_state = state

    def merge(type_id, branch):
        nonlocal out, new_state
        s, o = branch
        mask = m.mat_type == type_id
        out = select_sample(mask, o, out)
        new_state = torch.where(mask, s, new_state)

    if C.MATERIAL_LAMBERTIAN in types and not specular_only:
        merge(C.MATERIAL_LAMBERTIAN,
              _sample_lambert(m, normal, state, diffuse_occlusion))
    if C.MATERIAL_METAL in types:
        merge(C.MATERIAL_METAL,
              _sample_metal(m, normal, wo, incident, state, clamp_p))
    if C.MATERIAL_DIELECTRIC in types:
        merge(C.MATERIAL_DIELECTRIC,
              _sample_dielectric(m, normal, incident, front_face, state))
    if C.MATERIAL_PLASTIC in types:
        merge(C.MATERIAL_PLASTIC,
              _sample_plastic(m, normal, wo, state, clamp_p,
                              diffuse_occlusion, specular_only))
    if C.MATERIAL_SUBSURFACE in types and not specular_only:
        merge(C.MATERIAL_SUBSURFACE,
              sss_ops.sample_subsurface(m, position, normal, wo, state,
                                        sss_mode))
    if C.MATERIAL_CARPAINT in types:
        merge(C.MATERIAL_CARPAINT,
              carpaint_ops.sample_carpaint(m, position, normal, wo, state,
                                           clamp_p))
    if C.MATERIAL_PBR in types:
        merge(C.MATERIAL_PBR,
              pbr_ops.sample_pbr(m, normal, wo, incident, state, clamp_p,
                                 diffuse_occlusion, specular_only))
    return new_state, out


def evaluate_bsdf(m: MatLanes, normal, wo, wi, clamp_p: ClampParams,
                  diffuse_occlusion, material_types,
                  position=None, specular_only: bool = False) -> BsdfEval:
    """Type-dispatched evaluation, no RNG (reference: pathtrace.metal
    evaluate_bsdf:4950-5136). Subsurface lanes evaluate to zero and are
    flagged ``is_bssrdf``. ``specular_only`` (``bsdf.py:838``): lambert
    lanes evaluate to zero, plastic and PBR without their diffuse
    lobes."""
    from metal_pathtracer_tpu_torch.ops import carpaint as carpaint_ops
    from metal_pathtracer_tpu_torch.ops import pbr as pbr_ops

    types = set(int(t) for t in material_types)
    cos_o = torch.clamp_min(dot(normal, wo), 0.0)
    cos_i = torch.clamp_min(dot(normal, wi), 0.0)
    geom_ok = (cos_i > 0.0) & (cos_o > 0.0)
    value = torch.zeros_like(normal)
    pdf = torch.zeros_like(cos_o)
    is_delta = torch.zeros_like(geom_ok)
    if C.MATERIAL_LAMBERTIAN in types and not specular_only:
        mask = (m.mat_type == C.MATERIAL_LAMBERTIAN) & geom_ok
        albedo = material_base_color(m) * torch.clamp(
            diffuse_occlusion, 0.0, 1.0)[..., None]
        value = where3(mask, fdiv(albedo, PI), value)
        pdf = torch.where(mask, lambert_pdf(normal, wi), pdf)
    if C.MATERIAL_METAL in types:
        mask = (m.mat_type == C.MATERIAL_METAL) & geom_ok
        v, p, valid, smooth = _evaluate_metal(m, normal, wo, wi, cos_o,
                                              cos_i, clamp_p)
        is_delta = is_delta | (mask & smooth)
        value = where3(mask & valid, v, value)
        pdf = torch.where(mask & valid, p, pdf)
    if C.MATERIAL_DIELECTRIC in types:
        is_delta = is_delta | (m.mat_type == C.MATERIAL_DIELECTRIC)
    if C.MATERIAL_PLASTIC in types:
        mask = (m.mat_type == C.MATERIAL_PLASTIC) & geom_ok
        v, p = _evaluate_plastic(m, normal, wo, wi, cos_o, cos_i, clamp_p,
                                 diffuse_occlusion, specular_only)
        value = where3(mask, v, value)
        pdf = torch.where(mask, p, pdf)
    is_bssrdf = m.mat_type == C.MATERIAL_SUBSURFACE
    if C.MATERIAL_CARPAINT in types:
        mask = (m.mat_type == C.MATERIAL_CARPAINT) & geom_ok
        v, p = carpaint_ops.evaluate_carpaint(m, position, normal, wo, wi,
                                              clamp_p)
        value = where3(mask, v, value)
        pdf = torch.where(mask, p, pdf)
    if C.MATERIAL_PBR in types:
        mask = (m.mat_type == C.MATERIAL_PBR) & geom_ok
        ev = pbr_ops.evaluate_pbr(m, normal, wo, wi, clamp_p,
                                  diffuse_occlusion, specular_only)
        value = where3(mask, ev.value, value)
        pdf = torch.where(mask, ev.pdf, pdf)
        is_delta = torch.where(mask, ev.is_delta, is_delta)
    bad = (pdf <= 0.0) | ~torch.isfinite(value).all(-1)
    value = where3(bad, torch.zeros_like(value), value)
    return BsdfEval(value=value, pdf=pdf, is_delta=is_delta,
                    is_bssrdf=is_bssrdf)


def bsdf_cone_spread_increment(lobe_type, roughness, is_delta):
    """(reference: pathtrace.metal bsdf_cone_spread_increment)"""
    r = torch.clamp(roughness, 0.0, 1.0)
    inc = torch.where(lobe_type == 0, 0.55,
                      torch.where(lobe_type == 1, 0.03 + (0.45 - 0.03) * r,
                                  0.10 + (0.60 - 0.10) * r))
    return torch.where(is_delta, 0.0, inc)
