"""The texture pre-stage: one depth's textured material overrides per lane.

The JAX package runs this stage in XLA between K1 and K2 s1
(``ops/pallas/shade.py`` ``_texture_stage:3600``, routed by
``_texture_dispatch:3524``, which compacts the eligible lanes with a
cumsum and a ``lax.switch`` because a TPU cannot branch per lane). It is
not a TPU kernel there; here it is ``csrc/texture.cu``, one thread per
lane, with no compaction and no host sync: a lane that is not eligible
(not alive, a miss, or a non-PBR material, ``shade.py:3046``) keeps its
state and writes the identity, all-zero planes with ``tpbr`` 0.

``texture_stage`` launches the kernel on CUDA tensors and runs
``texture_stage_reference``, ``apply_pbr_textures`` over the wavefront,
on CPU tensors. Both return the 15 ``TEX`` planes per lane as an (N, 15)
view of plane-major (15, N) storage (``shade.py:1822-1825`` order; the
kernel stores each plane coalesced, and ``tex[:, k]`` is contiguous) and
commit the alpha-BLEND draw to ``carry.state`` in place
(``shade.py:3060-3063``), before s1's NEE draws. The launch constants
(``TexParams``) are built on the host once per frame by the depth loops,
so a launch makes no device-to-host copy.

Lanes that hit a placement of an instanced mesh (``kind``, family
``intersect.KIND_INSTANCE + k``) take their hit record from the
instanced rebuild (world-space normals, the placement's material) and,
as the JAX package's XLA stage does (``ops/pbr_textures.py:177-211``:
the record says ``PRIMITIVE_TRIANGLE``), the UVs, tangents and Igehy
triangle of the SOUP triangle at ``clip(object triangle, 0, soup count
- 1)``. A scene without a soup runs no texture stage (``:181``).
"""

from __future__ import annotations

import dataclasses

import torch

from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops import pbr_textures
from metal_pathtracer_tpu_torch.ops.intersect import KIND_INSTANCE, _closer
from metal_pathtracer_tpu_torch.ops.kernels import build
from metal_pathtracer_tpu_torch.ops.traversal import (
    _hit_record_from_best,
    instanced_record,
)
from metal_pathtracer_tpu_torch.ops.vecmath import dot, fma, normalize
from metal_pathtracer_tpu_torch.schema import instance_table
from metal_pathtracer_tpu_torch.utils.spans import host_read

#: texture-stage override planes, s1/s2 read them per lane
TEX = ["tbr", "tbg", "tbb", "trough", "tmetal", "temr", "temg", "temb",
       "tocc", "tpass", "tnx", "tny", "tnz", "ttrans", "tpbr"]
TEX_IDX = {n: i for i, n in enumerate(TEX)}


def pack_texture_material_table(materials) -> torch.Tensor:
    """(M, 64) f32 table of the columns the kernel reads: type, base
    colour, roughness, metallic, transmission, alpha, alpha mode, alpha
    cutoff, occlusion strength, normal scale, emission, flags, then per
    slot the texture id, then per slot the UV set, then per slot the 2x3
    transform."""
    f = lambda x: x.to(torch.float32).reshape(x.shape[0], -1)
    cols = [materials.mat_type, materials.base_color, materials.roughness,
            materials.pbr_metallic, materials.pbr_transmission,
            materials.pbr_alpha, materials.pbr_alpha_mode,
            materials.pbr_alpha_cutoff, materials.pbr_occlusion_strength,
            materials.pbr_normal_scale, materials.emission,
            materials.material_flags, materials.texture_indices,
            materials.texture_uv_set, materials.texture_transform]
    return torch.cat([f(c) for c in cols], 1).contiguous()


def has_textures(scene, static) -> bool:
    """The textured path: an atlas and a PBR material (``shade.py:2955``)."""
    return scene.textures is not None and \
        C.MATERIAL_PBR in static.material_types


def _instanced_lanes(kind, scene):
    """Each lane's flat placement (-1: not an instanced hit), or None when
    the scene has no instanced meshes."""
    if kind is None or not scene.instanced:
        return None
    return torch.where(kind >= KIND_INSTANCE, kind - KIND_INSTANCE, -1)


def texture_stage_reference(carry, t, tri, u, v, scene, uniforms, static,
                            depth: int, params=None, kind=None):
    """Plain PyTorch texture stage (``shade.py _texture_stage:3600`` over
    the port's ``apply_pbr_textures``); see the module docstring. It takes
    ``texture_stage``'s arguments, so that it can stand in for it; the
    launch constants ``params`` it does not need."""
    del params
    d3 = carry.ray_d
    inst = _instanced_lanes(kind, scene)
    soup = tri if inst is None else torch.where(inst >= 0, -1, tri)
    rec = _hit_record_from_best(carry.ray_o, d3, scene.triangles, t, soup,
                                u, v)
    if inst is not None:
        rec = _closer(rec, instanced_record(carry.ray_o, d3, t, tri, u, v,
                                            inst, scene.instanced))
    hit_world = torch.clamp_min(t, 0.0) * torch.sqrt(
        torch.clamp_min(dot(d3, d3), 1e-12))
    cone = torch.clamp_min(fma(carry.cone_spread, hit_world,
                               carry.cone_width), 1e-7)
    r = pbr_textures.apply_pbr_textures(
        scene, rec.material, rec, -normalize(d3), cone, depth, carry.state,
        static, uniforms, d3)
    eligible = carry.alive & rec.hit & r.pbr_lane
    f = lambda x: x.to(torch.float32)
    planes = torch.cat([
        r.base_color.t(), r.roughness[None], r.metallic[None],
        r.emissive.t(), r.diffuse_occlusion[None], f(r.passthrough)[None],
        r.shading_normal.t(), r.transmission[None], f(r.pbr_lane)[None]])
    carry.state.copy_(torch.where(eligible, r.state, carry.state))
    return torch.where(eligible[None], planes, 0.0).t()


@dataclasses.dataclass(frozen=True)
class TexParams:
    """The texture stage's launch constants of one frame, but the depth:
    image size, camera horizontal and vertical (read back to the host
    once, here), working space, slot bit mask, UV set 1, the debug flags,
    the normal strength scale and the atlas's top LOD."""

    values: tuple

    @classmethod
    def of(cls, uniforms, static, textures) -> "TexParams":
        cam = uniforms.camera
        slots = sum(1 << s for s in static.texture_slots)
        return cls((float(static.width), float(static.height),
                    *host_read(cam.horizontal, torch.Tensor.tolist),
                    *host_read(cam.vertical, torch.Tensor.tolist),
                    float(static.working_color_space), float(slots),
                    float(static.texture_uv1),
                    float(static.debug_disable_ao),
                    float(static.debug_ao_indirect_only),
                    float(static.debug_disable_normal_map),
                    float(static.debug_disable_orm),
                    float(static.debug_flip_normal_green),
                    float(uniforms.debug_normal_strength_scale),
                    float(textures.max_lod)))

    def scalars(self, depth: int):
        """The float vector the kernel unpacks (``TexParams`` in
        ``csrc/texture.cu``)."""
        return [float(depth), *self.values]


def texture_stage(carry, t, tri, u, v, scene, uniforms, static, depth: int,
                  params: TexParams | None = None, kind=None) -> torch.Tensor:
    """The texture stage of one depth: (N,15) ``TEX`` planes, stored
    plane-major; commits the BLEND draw to ``carry.state``. ``tri``: each
    lane's soup or object triangle (-1 elsewhere), ``kind`` the merged
    trace's families (needed in a scene with instanced meshes). CPU
    tensors take the plain version; CUDA tensors launch
    ``csrc/texture.cu`` with ``params``, the frame's ``TexParams``
    (required there: the launch reads nothing back to the host)."""
    dev = t.device
    if dev.type == "cpu":
        return texture_stage_reference(carry, t, tri, u, v, scene, uniforms,
                                       static, depth, None, kind)
    if dev.type != "cuda":
        raise ValueError(f"texture_stage: unsupported device {dev}")
    if params is None:
        raise ValueError("texture_stage: a CUDA launch needs the frame's "
                         "TexParams (TexParams.of(uniforms, static, "
                         "scene.textures))")
    n = t.shape[0]
    tris, tex = scene.triangles, scene.textures
    mat_table = scene.materials.table(pack_texture_material_table)
    carry_in = [carry.state, carry.ray_o, carry.ray_d, carry.alive,
                carry.cone_width, carry.cone_spread]
    attrs = [tris.shade_packed, tris.uv0, tris.uv1, tris.uv2, tris.uvb0,
             tris.uvb1, tris.uvb2, tris.t0, tris.t1, tris.t2]
    atlas = [tex.texels, tex.level_offset, tex.level_w, tex.level_h,
             tex.n_levels, tex.size0, tex.wrap_mode]
    inputs = [t, tri, u, v, mat_table, *carry_in, *attrs, *atlas]
    inst = None
    if scene.instanced:
        if kind is None or kind.dtype != torch.int32:
            raise ValueError("texture_stage: an instanced scene needs the "
                             "int32 families of its hits")
        inst = instance_table(scene.instanced)
        inputs += [kind, inst.table, inst.shade_packed]
    if any(x.device != dev or not x.is_contiguous() for x in inputs) \
            or tri.dtype != torch.int32 or carry.state.dtype != torch.int64 \
            or any(x.dtype != torch.int32 for x in atlas[1:5] + atlas[6:]):
        raise ValueError(f"texture_stage: inputs must be contiguous, on "
                         f"{dev}, with int32 ids and tables and an int64 "
                         f"state")
    build.check_aligned("texture_stage", [attrs[0], *attrs[7:], tex.texels],
                        16)
    if inst is not None:
        build.check_aligned("texture_stage", [inst.table, inst.shade_packed],
                            16)
    build.check_aligned("texture_stage", attrs[1:7], 8)
    out = build.planes(n, len(TEX), dev)
    lib = build.load()
    p = lambda x: None if x is None else x.data_ptr()
    err = lib.mpt_texture_stage(
        n, build.floats(params.scalars(depth)),
        *[p(x) for x in (t, tri, u, v)], p(mat_table), mat_table.shape[0],
        build.pointers([p(x) for x in carry_in]),
        build.pointers([p(x) for x in attrs]),
        build.pointers([p(x) for x in atlas]), tex.n_textures,
        tex.max_levels, build.pointers(
            [p(None if inst is None else kind),
             p(None if inst is None else inst.table),
             p(None if inst is None else inst.shade_packed)]),
        tris.count, p(out), torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "mpt_texture_stage")
    texture_stage.launches += 1
    return out


#: texture-stage launches since the last reset
texture_stage.launches = 0
