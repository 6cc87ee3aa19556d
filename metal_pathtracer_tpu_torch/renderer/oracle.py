"""ctypes wrapper of the native CPU oracle (``renderer/oracle.py`` twin).

``native/cpu_oracle.cpp`` is the independent parity backend, the role
the Embree renderer plays for the reference (SURVEY.md §3.5): a scalar
C++ path tracer that shares only the behavioural spec and the RNG recipe
with the integrator. This module packs the port's ``SceneResources``
into the library's flat arrays, exactly as the JAX package's wrapper
does, so both wrappers hand the library the same bytes and get the same
image back. The library is built by ``native/build.sh``, on first use if
it is missing (``utils/nativebuild.py``).
"""

from __future__ import annotations

import ctypes

import numpy as np

from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops.camera import build_camera
from metal_pathtracer_tpu_torch.scene.resources import (
    compute_coat_average,
    compute_coat_sample_weight,
)
from metal_pathtracer_tpu_torch.settings import RenderSettings
from metal_pathtracer_tpu_torch.utils.nativebuild import ensure_built

LIB_NAME = "libcpu_oracle.so"

# All 8 material types are implemented by the oracle.
ORACLE_TYPES = {C.MATERIAL_LAMBERTIAN, C.MATERIAL_METAL, C.MATERIAL_DIELECTRIC,
                C.MATERIAL_DIFFUSE_LIGHT, C.MATERIAL_PLASTIC, C.MATERIAL_PBR,
                C.MATERIAL_CARPAINT, C.MATERIAL_SUBSURFACE}

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)

#: ``render_oracle``'s C signature (``native/cpu_oracle.cpp``), in order: a
#: pointer passed in the wrong place is not caught, it renders garbage
_ARGTYPES = [
    ctypes.c_int, ctypes.c_int, ctypes.c_int,   # width, height, spp
    ctypes.c_int, ctypes.c_uint32, ctypes.c_int,  # max depth, seed, RR
    _FP, ctypes.c_int, _FP,                     # camera, bg mode, bg colour
    ctypes.c_int, _FP, _IP,                     # spheres, their materials
    ctypes.c_int, _FP, _IP, _IP,                # rects, materials, 2-sided
    ctypes.c_int, _FP, _IP, _FP, _FP,           # triangles, mat, uv, tangent
    ctypes.c_int, ctypes.c_int, _FP, _IP,       # textures: n, side, pool, wrap
    ctypes.c_int, _FP,                          # materials
    ctypes.c_int, ctypes.c_int, _FP,            # environment w, h, texels
    _FP, _IP, _FP, _IP, _FP,                    # its alias tables, pdf
    ctypes.c_float, ctypes.c_float,             # rotation, intensity
    _FP,                                        # firefly clamp
    ctypes.c_int, ctypes.c_int, ctypes.c_int,   # spec-NEE, MNEE, secondary
    ctypes.c_int, ctypes.c_int, ctypes.c_int,   # sss mode, steps, AO debug
    ctypes.c_int, _FP]                          # threads, output


def oracle_available() -> bool:
    return ensure_built(LIB_NAME) is not None


def _load():
    path = ensure_built(LIB_NAME)
    if path is None:
        raise RuntimeError(f"the native CPU oracle ({LIB_NAME}) is not "
                           "built and cannot be built: run native/build.sh")
    lib = ctypes.CDLL(path)
    lib.render_oracle.argtypes = _ARGTYPES
    lib.render_oracle.restype = ctypes.c_int
    return lib


def pack_materials(resources) -> np.ndarray:
    """(M, 72) float32: one oracle row per material (JAX
    ``oracle.pack_materials``)."""
    mats = resources.materials or []
    out = np.zeros((max(len(mats), 1), 72), np.float32)
    for i, m in enumerate(mats):
        coat_roughness = float(np.clip(m.coat_roughness, 0.0, 1.0))
        avg = compute_coat_average(max(m.coat_ior, 0.0))
        weight = compute_coat_sample_weight(m.mat_type, coat_roughness,
                                            max(m.coat_thickness, 0.0), avg)
        out[i] = [
            *np.clip(m.base_color, 0.0, 1.0),
            np.clip(m.roughness, 0.0, 1.0), m.mat_type, max(m.ior, 0.0),
            1.0 if m.thin else 0.0,
            *m.emission, 1.0 if m.emission_env else 0.0,
            *np.maximum(m.conductor_eta, 0.0), *np.maximum(m.conductor_k, 0.0),
            1.0 if m.has_conductor else 0.0,
            *np.maximum(m.dielectric_sigma_a, 0.0),
            coat_roughness, max(m.coat_thickness, 0.0), min(weight, 0.95), avg,
            *np.clip(m.coat_tint, 0.0, 1.0),
            *np.maximum(m.coat_absorption, 0.0),
            max(m.coat_ior, 0.0),
            float(np.clip(m.pbr_metallic, 0.0, 1.0)),
            float(np.clip(m.pbr_transmission, 0.0, 1.0)),
            max(m.pbr_thickness, 0.0),
            1.0 if m.pbr_double_sided else 0.0,
            # carpaint lanes, derived as in SceneResources.build_arrays
            float(np.clip(m.carpaint_base_metallic, 0.0, 1.0)),
            float(np.clip(m.carpaint_base_roughness, 0.0, 1.0)),
            max(m.carpaint_flake_scale, 1e-4),
            float(np.clip(
                np.clip(m.carpaint_flake_sample_weight, 0.0, 0.95)
                * max(np.clip(m.carpaint_flake_reflectance, 0.0, 1.0), 0.01),
                0.0, 0.95)),
            float(np.clip(m.carpaint_flake_roughness, 0.0, 1.0)),
            float(np.clip(m.carpaint_flake_anisotropy, -0.99, 0.99)),
            float(np.clip(m.carpaint_flake_normal_strength, 0.0, 1.0)),
            *(np.maximum(m.carpaint_base_eta, 0.0)
              if m.carpaint_has_base_conductor else np.zeros(3)),
            *(np.maximum(m.carpaint_base_k, 0.0)
              if m.carpaint_has_base_conductor else np.zeros(3)),
            1.0 if m.carpaint_has_base_conductor else 0.0,
            # subsurface lanes
            *np.maximum(m.sss_sigma_a, 0.0),
            *np.maximum(m.sss_sigma_s, 0.0),
            max(m.sss_mfp, 0.0),
            float(np.clip(m.sss_g, -0.99, 0.99)),
            float(m.sss_method),
            1.0 if m.sss_coat else 0.0,
            1.0 if m.sss_sigma_override else 0.0,
            # texture slot ids (ops/pbr_textures.py slot order: base, ORM,
            # normal, occlusion, emissive, transmission; -1 = none)
            *(list(m.texture_indices[:6])
              + [-1.0] * (6 - len(m.texture_indices))
              if m.texture_indices else [-1.0] * 6),
            float(np.clip(m.pbr_occlusion_strength, 0.0, 1.0)),
            float(max(m.pbr_normal_scale, 0.0)),
            float(m.material_flags),
            0.0, 0.0,  # pad to 72
        ]
    return out


def _camera(settings, width, height) -> np.ndarray:
    cam = build_camera(settings, width, height, device="cpu")
    return np.concatenate([
        cam.origin.numpy(), cam.lower_left.numpy(), cam.horizontal.numpy(),
        cam.vertical.numpy(), cam.u.numpy(), cam.v.numpy(),
        [float(cam.lens_radius)]]).astype(np.float32)


def _triangles(resources):
    """World-space triangles with their material, UVs and tangents per
    corner; one zero row when there are none."""
    tris, mat, uvs, tans = [], [], [], []
    for mesh in resources.meshes:
        idx, v = mesh.indices, mesh.vertices
        tris.append(np.concatenate([v[idx[:, 0]], v[idx[:, 1]],
                                    v[idx[:, 2]]], 1))
        mat.append(np.full(len(idx), mesh.material, np.int32))
        uv = mesh.uv0 if mesh.uv0 is not None and len(mesh.uv0) == len(v) \
            else np.zeros((len(v), 2), np.float32)
        uvs.append(np.concatenate([uv[idx[:, 0]], uv[idx[:, 1]],
                                   uv[idx[:, 2]]], 1))
        tan = mesh.tangents if mesh.tangents is not None \
            and len(mesh.tangents) == len(v) \
            else np.zeros((len(v), 4), np.float32)
        tans.append(np.concatenate([tan[idx[:, 0]], tan[idx[:, 1]],
                                    tan[idx[:, 2]]], 1))
    if not tris:
        return (0, np.zeros((1, 9), np.float32), np.zeros(1, np.int32),
                np.zeros((1, 6), np.float32), np.zeros((1, 12), np.float32))
    join = lambda parts, dt: np.ascontiguousarray(np.concatenate(parts), dt)
    out = join(tris, np.float32)
    return (len(out), out, join(mat, np.int32), join(uvs, np.float32),
            join(tans, np.float32))


def _texture_pool(resources):
    """(count, side, texels (T, side, side, 3), wrap (T, 2)): level 0 of
    the texture atlas the integrator samples, as the JAX wrapper builds
    it. The library takes one pool of equal square textures: a set of
    square power-of-two textures of one side keeps it (the oracle then
    sees the integrator's level-0 texels exactly); any other set is
    resampled to 512 x 512."""
    from metal_pathtracer_tpu_torch.ops.textures import build_texture_arrays

    images = resources.texture_images
    if not images:
        return 0, 0, np.zeros(1, np.float32), np.zeros(2, np.int32)
    shapes = {im.shape[:2] for im in images}
    side = 512
    if len(shapes) == 1 and len(set(shapes.pop())) == 1:
        native = images[0].shape[0]
        side = native if native & (native - 1) == 0 else 512
    wraps = resources.texture_wrap \
        if len(resources.texture_wrap) == len(images) else None
    ta = build_texture_arrays(images, resources.texture_srgb, wraps,
                              size=side, device="cpu")
    flat = ta.texels.numpy()
    base = np.stack([flat[o:o + side * side].reshape(side, side, 4)
                     for o in ta.level_offset[:, 0].tolist()])
    return (len(images), side, np.ascontiguousarray(base[..., :3]),
            np.ascontiguousarray(ta.wrap_mode.numpy(), np.int32))


def render_oracle(resources, settings: RenderSettings, width: int,
                  height: int, spp: int, environment=None,
                  n_threads: int = 0) -> np.ndarray:
    """Render with the native CPU oracle; returns linear (H, W, 3) float32.
    ``environment``: an ``EnvironmentSoA`` (any device) or None."""
    lib = _load()
    cam_flat = _camera(settings, width, height)

    n_sph = len(resources.spheres)
    spheres = np.zeros((max(n_sph, 1), 4), np.float32)
    sph_mat = np.zeros(max(n_sph, 1), np.int32)
    for i, s in enumerate(resources.spheres):
        spheres[i] = [*s.center, s.radius]
        sph_mat[i] = s.material

    n_rect = len(resources.rects)
    rects = np.zeros((max(n_rect, 1), 15), np.float32)
    rect_mat = np.zeros(max(n_rect, 1), np.int32)
    rect_two = np.zeros(max(n_rect, 1), np.int32)
    for i, r in enumerate(resources.rects):
        eu2 = float(np.dot(r.edge_u, r.edge_u))
        ev2 = float(np.dot(r.edge_v, r.edge_v))
        rects[i] = [*r.corner, *r.edge_u, *r.edge_v,
                    1.0 / max(eu2, 1e-20), 1.0 / max(ev2, 1e-20),
                    *r.normal, float(np.dot(r.normal, r.corner))]
        rect_mat[i] = r.material
        rect_two[i] = 1 if r.two_sided else 0

    n_tris, tris, tri_mat, tri_uv, tri_tan = _triangles(resources)
    n_textures, tex_size, tex_data, tex_wrap = _texture_pool(resources)
    mats = pack_materials(resources)

    env_w = env_h = 0
    env_texels = env_marg_t = env_cond_t = env_pdf = np.zeros(1, np.float32)
    env_marg_a = env_cond_a = np.zeros(1, np.int32)
    if environment is not None:
        env_w, env_h = environment.width, environment.height
        arr = lambda x, dt: np.ascontiguousarray(x.detach().cpu().numpy(), dt)
        env_texels = arr(environment.texels, np.float32)
        env_marg_t = arr(environment.marginal_threshold, np.float32)
        env_marg_a = arr(environment.marginal_alias, np.int32)
        env_cond_t = arr(environment.conditional_threshold, np.float32)
        env_cond_a = arr(environment.conditional_alias, np.int32)
        env_pdf = arr(environment.pdf, np.float32)

    firefly = np.asarray([
        max(settings.fireflyClampFactor, 0.0),
        max(settings.fireflyClampFloor, 0.0),
        max(settings.throughputClamp, 0.0),
        max(settings.fireflyClampMaxContribution, 0.0),
        1.0 if settings.fireflyClampEnabled else 0.0], np.float32)
    background = np.asarray(settings.backgroundColor, np.float32)

    out = np.zeros((height, width, 3), np.float32)
    f = lambda a: a.ctypes.data_as(_FP)
    i = lambda a: a.ctypes.data_as(_IP)
    ret = lib.render_oracle(
        width, height, spp, settings.maxDepth, settings.fixedRngSeed,
        1 if settings.enableRussianRoulette else 0,
        f(cam_flat), int(settings.backgroundMode), f(background),
        n_sph, f(spheres), i(sph_mat),
        n_rect, f(rects), i(rect_mat), i(rect_two),
        n_tris, f(tris), i(tri_mat), f(tri_uv), f(tri_tan),
        n_textures, tex_size, f(tex_data), i(tex_wrap),
        len(mats), f(mats),
        env_w, env_h, f(env_texels),
        f(env_marg_t), i(env_marg_a), f(env_cond_t), i(env_cond_a),
        f(env_pdf),
        settings.environmentRotation, settings.environmentIntensity,
        f(firefly),
        1 if settings.enableSpecularNee else 0,
        1 if settings.enableMnee else 0,
        1 if settings.enableMneeSecondary else 0,
        int(settings.sssMode), int(settings.sssMaxSteps),
        1 if settings.debugAoIndirectOnly else 0,
        n_threads, f(out))
    if ret != 0:
        raise RuntimeError(f"oracle render failed ({ret})")
    return out


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean(
        (a.astype(np.float64) - b.astype(np.float64)) ** 2)))
