"""Wavefront path integrator (``ops/integrator.py`` twin).

``trace_paths`` covers every material type (lambert, metal, dielectric,
plastic, carpaint, subsurface in its three modes, PBR, diffuse lights,
``emission_env`` lights under an environment map) over triangles,
spheres and rectangles, with the medium stack and the texture stage, in
two depth loops of ``ops/kernels/shade.py``:

- without a light integral (the gradient or solid background and no
  emissive rectangle): one merged trace (K1, K3), the texture stage in a
  textured scene, the random walk on its lanes, and one K2 ``full`` shade
  per depth; a diffuse light hit emits and ends its path;
- with one or two light integrals, rect lights (NEE sampled from
  ``light_rect_indices``, emissive-hit MIS) and/or an environment map
  (alias-table NEE, MIS): the merged trace, K2 ``s1``, the light samples
  and their shadow traces (K1 any-hit, K3), the random walk, K2 ``s2``
  and the spec-NEE and MNEE delta-chain estimators (environment and rect
  lights; MNEE's secondary chain from s2's fork-state export) per depth.

``debugSpecularOnly`` runs through K2 (a runtime flag of every stage).
Mesh instances raise where a scene adds one.
"""

from __future__ import annotations

import dataclasses

import torch

from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops import camera as camera_ops
from metal_pathtracer_tpu_torch.ops import env as env_ops
from metal_pathtracer_tpu_torch.ops import rng as rng_ops
from metal_pathtracer_tpu_torch.ops.vecmath import (
    cross,
    dot,
    fdiv,
    fma,
    length,
    linear_srgb_to_acescg,
    normalize,
    where3,
)
from metal_pathtracer_tpu_torch.schema import SceneArrays, StaticConfig, Uniforms

_WHITE = (1.0, 1.0, 1.0)
_BLUE = (0.5, 0.7, 1.0)


def sky_color(direction):
    """Gradient background (reference: pathtrace.metal sky_color:1320-1325)."""
    t = 0.5 * (normalize(direction)[..., 1:2] + 1.0)
    white = torch.tensor(_WHITE, device=direction.device)
    blue = torch.tensor(_BLUE, device=direction.device)
    return fma(blue - white, t, white)


def to_working_space(color, static: StaticConfig):
    """(reference: pathtrace.metal to_working_space:100-107)"""
    if static.working_color_space == 1:
        return linear_srgb_to_acescg(color)
    return color


@dataclasses.dataclass
class PathCarry:
    """Per-lane path state (the JAX package's ``PathCarry`` without its
    ray counters), updated in place by the shade stages. The gradient
    path's ``full`` stage reads and writes the first fourteen fields; the
    environment path's ``s1``/``s2`` stages all of them."""

    state: torch.Tensor          # (N,)  i64 holding the uint32 RNG state
    ray_o: torch.Tensor          # (N,3) f32
    ray_d: torch.Tensor          # (N,3) f32
    throughput: torch.Tensor     # (N,3) f32
    radiance: torch.Tensor       # (N,3) f32
    alive: torch.Tensor          # (N,)  bool
    prev_valid: torch.Tensor     # (N,)  bool
    prev_mesh: torch.Tensor      # (N,)  i32 — triangle self-hit exclusion
    prev_prim: torch.Tensor      # (N,)  i32
    is_first_hit: torch.Tensor   # (N,)  bool
    aov_albedo: torch.Tensor     # (N,3) f32
    aov_normal: torch.Tensor     # (N,3) f32
    cone_width: torch.Tensor     # (N,)  f32 — ray cone
    cone_spread: torch.Tensor    # (N,)  f32
    last_pdf: torch.Tensor       # (N,)  f32 — MIS: pdf of the last bounce
    last_delta: torch.Tensor     # (N,)  bool — last bounce was a delta lobe
    medium_stack: torch.Tensor   # (N,8,3) f32 — sigma_a of nested media
    medium_depth: torch.Tensor   # (N,)  i32
    specular_depth: torch.Tensor  # (N,) i32 — consecutive delta bounces
    env_lod: torch.Tensor        # (N,)  f32 — environment LOD for a miss
    env_lod_active: torch.Tensor  # (N,) bool

    @classmethod
    def start(cls, state, ray_o, ray_d, cone_width: float,
              cone_spread: float) -> "PathCarry":
        n, dev = ray_o.shape[0], ray_o.device
        z = torch.zeros(n, device=dev)
        z3 = torch.zeros((n, 3), device=dev)
        zb = torch.zeros(n, dtype=torch.bool, device=dev)
        zi = torch.zeros(n, dtype=torch.int32, device=dev)
        return cls(
            state=state.contiguous(), ray_o=ray_o.contiguous(),
            ray_d=ray_d.contiguous(), throughput=torch.ones((n, 3), device=dev),
            radiance=z3, alive=~zb, prev_valid=zb.clone(),
            prev_mesh=torch.full((n,), -1, dtype=torch.int32, device=dev),
            prev_prim=torch.full((n,), -1, dtype=torch.int32, device=dev),
            is_first_hit=~zb, aov_albedo=z3.clone(), aov_normal=z3.clone(),
            cone_width=torch.full((n,), cone_width, device=dev),
            cone_spread=torch.full((n,), cone_spread, device=dev),
            last_pdf=torch.ones(n, device=dev), last_delta=~zb,
            medium_stack=torch.zeros((n, C.MAX_MEDIUM_STACK, 3), device=dev),
            medium_depth=zi, specular_depth=zi.clone(), env_lod=z,
            env_lod_active=zb.clone())


def _primary_cone_spread(uniforms: Uniforms, static: StaticConfig) -> float:
    """(reference: pathtrace.metal make_primary_ray_cone)"""
    cam = uniforms.camera
    pixel_x = length(cam.horizontal) / max(float(static.width), 1.0)
    pixel_y = length(cam.vertical) / max(float(static.height), 1.0)
    footprint = torch.clamp_min(torch.maximum(pixel_x, pixel_y), 1e-6)
    center = fma(0.5, cam.vertical, fma(0.5, cam.horizontal, cam.lower_left))
    focus = length(center - cam.origin)
    return float(footprint / torch.clamp_min(focus, 1e-6))


def env_nee(scene: SceneArrays, static: StaticConfig) -> bool:
    """The environment light integral: an environment background with a
    map."""
    return static.background_mode == 2 and scene.environment is not None


def rect_nee(scene: SceneArrays) -> bool:
    """The rect-light integral: at least one emissive rectangle."""
    return scene.n_rect_lights > 0


def check_supported(scene: SceneArrays, static: StaticConfig) -> None:
    """Raise NotImplementedError for configurations not ported yet."""
    if scene.n_triangles + scene.n_spheres + scene.n_rects == 0:
        raise NotImplementedError("a scene without any primitive")


def rect_light_pdf_for_hit(scene: SceneArrays, point, prim_type, prim_index,
                           origin):
    """Solid-angle pdf of sampling the hit rectangle by NEE, for MIS on
    emissive hits (``integrator.py _rect_light_pdf_for_hit:95-122``;
    reference: pathtrace.metal rect_light_pdf_for_hit); 0 on lanes that
    did not hit an emissive rectangle."""
    rects, mats = scene.rects, scene.materials
    idx = torch.clamp(prim_index, 0, rects.count - 1).long()
    mat = torch.clamp(rects.material[idx], 0, mats.count - 1).long()
    is_light = (mats.mat_type[mat] == C.MATERIAL_DIFFUSE_LIGHT) \
        & (mats.emission[mat] != 0.0).any(-1)
    cr = cross(rects.edge_u[idx], rects.edge_v[idx])
    area = torch.sqrt(torch.clamp_min(dot(cr, cr), 0.0))
    to_light = point - origin
    dist_sq = dot(to_light, to_light)
    distance = torch.sqrt(torch.clamp_min(dist_sq, 1e-30))
    direction = fdiv(to_light, distance[:, None])
    cos_light = dot(-direction, rects.normal[idx])
    cos_light = torch.where(rects.two_sided[idx] > 0.5, cos_light.abs(),
                            cos_light)
    pdf = fdiv(fdiv(1.0, torch.clamp_min(area, 1e-20)) * dist_sq,
               torch.clamp_min(cos_light, 1e-6))
    pdf = fdiv(pdf, float(scene.n_rect_lights))
    valid = ((prim_type == C.PRIMITIVE_RECTANGLE) & is_light & (area > 0.0)
             & (dist_sq > 0.0) & (cos_light > 0.0))
    return torch.where(valid, pdf, 0.0)


def rect_light_sample_from_uniforms(scene: SceneArrays, point, sel_u, u, v,
                                    uniforms: Uniforms,
                                    static: StaticConfig):
    """Rect-light NEE sample from three drawn uniforms
    (``integrator.py _rect_light_sample_from_uniforms:125-172``; reference:
    pathtrace.metal sample_rect_light): a light by ``sel_u``, a point on
    it by (u, v). Under an environment light integral an ``emission_env``
    light's emission is scaled by the environment seen along its reversed
    normal (``:161-167``).
    Returns (direction, distance, pdf, emission, valid).
    The sample point is corner + u edge_u + v edge_v with the placement
    XLA:CPU gives the JAX package's (N,3) sum: the x and y components
    unfused, the z component as two FMAs."""
    n = scene.n_rect_lights
    rects, mats = scene.rects, scene.materials
    selected = torch.clamp_max((sel_u * float(n)).to(torch.int64), n - 1)
    idx = scene.light_rect_indices[selected].long()
    eu, ev, corner = rects.edge_u[idx], rects.edge_v[idx], rects.corner[idx]
    uu, vv = u[:, None], v[:, None]
    plain = (corner + uu * eu) + vv * ev
    fused = fma(vv, ev, fma(uu, eu, corner))
    sample_point = torch.cat([plain[:, :2], fused[:, 2:]], -1)
    to_light = sample_point - point
    dist_sq = dot(to_light, to_light)
    distance = torch.sqrt(torch.clamp_min(dist_sq, 1e-30))
    direction = fdiv(to_light, distance[:, None])
    cr = cross(eu, ev)
    area = torch.sqrt(torch.clamp_min(dot(cr, cr), 0.0))
    cos_light = dot(-direction, rects.normal[idx])
    two_sided = rects.two_sided[idx] > 0.5
    cos_ok = two_sided | (cos_light > 0.0)
    cos_light = torch.where(two_sided, cos_light.abs(), cos_light)
    pdf = fdiv(fdiv(1.0, torch.clamp_min(area, 1e-20)) * dist_sq,
               torch.clamp_min(cos_light, 1e-6))
    pdf = fdiv(pdf, float(n))
    mat = torch.clamp(rects.material[idx], 0, mats.count - 1).long()
    emission = mats.emission[mat]
    if env_nee(scene, static):
        env_mod = env_ops.environment_color(
            scene.environment, -rects.normal[idx],
            uniforms.environment_rotation, uniforms.environment_intensity,
            static)
        emission = where3(mats.emission_env[mat] > 0.0, emission * env_mod,
                          emission)
    valid = ((dist_sq > 0.0) & (area > 0.0) & cos_ok & (cos_light > 0.0)
             & (pdf > 0.0) & torch.isfinite(pdf) & (emission != 0.0).any(-1))
    return direction, distance, torch.where(valid, pdf, 0.0), emission, valid


def trace_paths(scene: SceneArrays, uniforms: Uniforms, static: StaticConfig,
                state, ray_o, ray_d, probe=None):
    """Trace a wavefront of primary rays to completion.

    Returns (state, radiance, aov_albedo, aov_normal, stats) with
    ``stats["rays"]`` the scene traces issued (an int) and
    ``stats["shadow_rays"]`` the shadow traces (a 0-dim tensor on the
    wavefront's device, so counting them costs no host sync). ``probe``,
    a list, receives one ``kernels.shade.ProbeDepth`` per depth (the
    pixel probe, ``renderer/debugprobe.py``)."""
    from metal_pathtracer_tpu_torch.ops.kernels import shade

    check_supported(scene, static)
    lens = max(2.0 * float(uniforms.camera.lens_radius), 0.0)
    carry = PathCarry.start(state, ray_o, ray_d, lens,
                            _primary_cone_spread(uniforms, static))
    if env_nee(scene, static) or rect_nee(scene):
        rays, shadow = shade.trace_paths_nee(scene, uniforms, static, carry,
                                             probe)
    else:
        rays = shade.trace_paths_fused(scene, uniforms, static, carry, probe)
        shadow = torch.zeros((), dtype=torch.int64, device=ray_o.device)
    return (carry.state, carry.radiance, carry.aov_albedo, carry.aov_normal,
            {"rays": rays, "shadow_rays": shadow})


def integrate_pixels(scene: SceneArrays, uniforms: Uniforms,
                     static: StaticConfig, x, y, prev_count):
    """One sample for a batch of pixels (the kernel entry, reference:
    pathtrace.metal:9698-9815). Returns (sample, albedo, normal, stats)."""
    seed = rng_ops.make_seed(uniforms.fixed_rng_seed, uniforms.frame_index,
                             x, y, uniforms.sample_count, prev_count)
    state, origin, direction = camera_ops.generate_primary_rays(
        uniforms.camera, x, y, static.width, static.height, seed)
    _, radiance, aov_albedo, aov_normal, stats = trace_paths(
        scene, uniforms, static, state, origin, direction)
    finite = torch.isfinite(radiance).all(-1, keepdim=True)
    sample = torch.where(finite, torch.clamp_min(radiance, 0.0), 0.0)
    return sample, aov_albedo, aov_normal, stats
