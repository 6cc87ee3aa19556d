"""Device-side data layouts as torch dataclasses (``schema.py`` twin).

Each struct-of-arrays container of the JAX package becomes a frozen
dataclass of tensors, field for field. Instancing is not ported yet: its
container lands with the ROADMAP step that reads it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MaterialsSoA:
    """One row per material (reference: MetalShaderTypes.h:57-97),
    field for field the JAX package's; scalar fields are (M,) f32
    unless noted."""

    base_color: torch.Tensor          # (M,3) f32
    roughness: torch.Tensor           # (M,)  f32
    mat_type: torch.Tensor            # (M,)  i32 — MaterialType enum
    eta: torch.Tensor                 # (M,)  f32
    coat_ior: torch.Tensor
    thin: torch.Tensor
    emission: torch.Tensor            # (M,3)
    emission_env: torch.Tensor
    conductor_eta: torch.Tensor       # (M,3)
    conductor_k: torch.Tensor         # (M,3)
    has_conductor: torch.Tensor
    coat_roughness: torch.Tensor
    coat_thickness: torch.Tensor
    coat_sample_weight: torch.Tensor
    coat_fresnel_avg: torch.Tensor
    coat_tint: torch.Tensor           # (M,3)
    coat_absorption: torch.Tensor     # (M,3)
    dielectric_sigma_a: torch.Tensor  # (M,3)
    sss_sigma_a: torch.Tensor         # (M,3)
    sss_sigma_override: torch.Tensor
    sss_sigma_s: torch.Tensor         # (M,3)
    sss_g: torch.Tensor
    sss_mfp: torch.Tensor
    sss_method: torch.Tensor
    sss_coat: torch.Tensor
    carpaint_base_metallic: torch.Tensor
    carpaint_base_roughness: torch.Tensor
    carpaint_flake_scale: torch.Tensor
    carpaint_flake_reflectance: torch.Tensor
    carpaint_flake_sample_weight: torch.Tensor
    carpaint_flake_roughness: torch.Tensor
    carpaint_flake_anisotropy: torch.Tensor
    carpaint_flake_normal_strength: torch.Tensor
    carpaint_base_eta: torch.Tensor   # (M,3)
    carpaint_base_k: torch.Tensor     # (M,3)
    carpaint_has_base_conductor: torch.Tensor
    carpaint_base_tint: torch.Tensor  # (M,3)
    pbr_metallic: torch.Tensor
    pbr_roughness: torch.Tensor
    pbr_occlusion_strength: torch.Tensor
    pbr_normal_scale: torch.Tensor
    pbr_alpha: torch.Tensor
    pbr_alpha_cutoff: torch.Tensor
    pbr_transmission: torch.Tensor
    pbr_alpha_mode: torch.Tensor
    pbr_double_sided: torch.Tensor
    pbr_thickness: torch.Tensor
    texture_indices: torch.Tensor     # (M,6) i32
    texture_uv_set: torch.Tensor      # (M,6) i32
    texture_transform: torch.Tensor   # (M,6,2,3) f32
    material_flags: torch.Tensor      # (M,)  i32

    @property
    def count(self) -> int:
        return self.mat_type.shape[0]

    def table(self, pack) -> torch.Tensor:
        """``pack(self)``, made on first use and kept on this immutable
        object: a kernel's packed material rows are built once per scene,
        not once per launch."""
        tables = self.__dict__.setdefault("_tables", {})
        if pack not in tables:
            tables[pack] = pack(self)
        return tables[pack]


@dataclasses.dataclass(frozen=True)
class SpheresSoA:
    """(reference: MetalShaderTypes.h SphereData)"""

    center: torch.Tensor    # (S,3) f32
    radius: torch.Tensor    # (S,)  f32
    material: torch.Tensor  # (S,)  i32

    @property
    def count(self) -> int:
        return self.radius.shape[0]

    def records(self) -> torch.Tensor:
        """(S, 4) f32, K3a's layout: ``[centre xyz, radius]``, one 16-byte
        load a sphere, copies of the fields' bits. Made on first use, on
        these arrays' device, and kept on this immutable object."""
        cached = self.__dict__.get("_records")
        if cached is None:
            cached = torch.cat([self.center, self.radius[:, None]],
                               1).contiguous()
            self.__dict__["_records"] = cached
        return cached


@dataclasses.dataclass(frozen=True)
class RectsSoA:
    """Oriented rectangles (reference: MetalShaderTypes.h RectData)."""

    corner: torch.Tensor      # (R,3) f32
    edge_u: torch.Tensor      # (R,3) f32
    edge_v: torch.Tensor      # (R,3) f32
    inv_len2_u: torch.Tensor  # (R,)  f32
    inv_len2_v: torch.Tensor  # (R,)  f32
    normal: torch.Tensor      # (R,3) f32, normalised
    plane: torch.Tensor       # (R,)  f32, dot(normal, corner)
    material: torch.Tensor    # (R,)  i32
    two_sided: torch.Tensor   # (R,)  f32

    @property
    def count(self) -> int:
        return self.plane.shape[0]

    def records(self) -> torch.Tensor:
        """(R, 16) f32, K3c's layout: 64 bytes a rectangle, read as four
        16-byte loads, ``[corner xyz, edge_u xyz, edge_v xyz, 1/|u|^2,
        1/|v|^2, normal xyz, plane, 0]``, copies of the fields' bits. Made
        on first use, on these arrays' device, and kept on this immutable
        object."""
        cached = self.__dict__.get("_records")
        if cached is None:
            cached = torch.cat(
                [self.corner, self.edge_u, self.edge_v,
                 self.inv_len2_u[:, None], self.inv_len2_v[:, None],
                 self.normal, self.plane[:, None],
                 torch.zeros_like(self.plane)[:, None]], 1).contiguous()
            self.__dict__["_records"] = cached
        return cached


@dataclasses.dataclass(frozen=True)
class SphereGroups:
    """The layout of the chunked sphere kernel (K3b) for more than 32
    spheres: the spheres in Morton order, padded to whole groups of 16 by
    repeating the last one (a repeat gives the same t and index, so it
    changes no result), each slot's own sphere index, and one AABB per
    group, widened so that rounding cannot cull a hit
    (``ops/kernels/primitives.py sphere_groups``)."""

    center: torch.Tensor    # (G*16, 3) f32, Morton order
    radius: torch.Tensor    # (G*16,)   f32
    index: torch.Tensor     # (G*16,)   i32, the sphere's own index
    box_min: torch.Tensor   # (G, 3)    f32
    box_max: torch.Tensor   # (G, 3)    f32

    @property
    def n_groups(self) -> int:
        return self.box_min.shape[0]


@dataclasses.dataclass(frozen=True)
class BvhSoA:
    """Binary SAH BVH flattened depth-first with exit links
    (``scene/meshbuild.py``): an internal node is followed by its left
    subtree; ``exit_index`` is where traversal continues on a miss or
    after a leaf."""

    bounds_min: torch.Tensor    # (N,3) f32
    bounds_max: torch.Tensor    # (N,3) f32
    prim_offset: torch.Tensor   # (N,)  i32
    prim_count: torch.Tensor    # (N,)  i32 — 0 for internal nodes
    exit_index: torch.Tensor    # (N,)  i32
    prim_indices: torch.Tensor  # (P,)  i32

    @property
    def node_count(self) -> int:
        return self.prim_offset.shape[0]

    def left_sibling(self) -> torch.Tensor:
        """(N,) i32: for a right child, its left sibling (an interior node
        P has children P + 1 and ``exit_index[P + 1]``); -1 elsewhere. Made
        on first use and kept on this immutable object (K1's counting
        mode reads it)."""
        cached = self.__dict__.get("_left_sibling")
        if cached is None:
            interior = torch.nonzero(self.prim_count == 0).squeeze(1)
            left = interior + 1
            cached = torch.full_like(self.prim_count, -1)
            cached[self.exit_index[left].long()] = left.to(torch.int32)
            self.__dict__["_left_sibling"] = cached
        return cached

    def packed_nodes(self) -> torch.Tensor:
        """(N, 8) f32, K1's node layout: 32 bytes per node, read as two
        16-byte loads, ``[bounds_min xyz, exit_index]`` and ``[bounds_max
        xyz, meta]`` with ``meta = prim_offset << 3 | prim_count``; the two
        ints travel as their bits. Made on first use, on this tree's
        device, and kept on this immutable object."""
        cached = self.__dict__.get("_packed_nodes")
        if cached is None:
            off, cnt = self.prim_offset, self.prim_count
            if self.node_count and not (
                    int(cnt.min()) >= 0 and int(cnt.max()) < 8
                    and int(off.min()) >= 0 and int(off.max()) < 1 << 28):
                raise ValueError("packed_nodes: prim_count must fit 3 bits "
                                 "and prim_offset 28")
            meta = (off << 3) | cnt
            cached = torch.cat(
                [self.bounds_min.view(torch.int32), self.exit_index[:, None],
                 self.bounds_max.view(torch.int32), meta[:, None]],
                1).view(torch.float32)
            self.__dict__["_packed_nodes"] = cached
        return cached

    def slot_records(self, tris: "TrianglesSoA") -> torch.Tensor:
        """(P, 12) f32, K1's triangle layout: 48 bytes per slot of
        ``prim_indices`` (leaf order), ``[v0 xyz, tid, e1 xyz, mesh, e2
        xyz, 0]`` with ``e1 = v1 - v0``, ``e2 = v2 - v0`` in float32 (the
        bits the walk computed from the vertices) and the slot's triangle
        and mesh index as their bits. Made on first use for ``tris`` and
        kept on this immutable object."""
        cached = self.__dict__.get("_slot_records")
        if cached is None or cached[0] is not tris:
            tid = self.prim_indices.long()
            v0 = tris.v0[tid]
            rec = torch.zeros((tid.shape[0], 12), dtype=torch.int32,
                              device=tid.device)
            rec[:, 0:3] = v0.view(torch.int32)
            rec[:, 3] = self.prim_indices
            rec[:, 4:7] = (tris.v1[tid] - v0).view(torch.int32)
            rec[:, 7] = tris.mesh_index[tid]
            rec[:, 8:11] = (tris.v2[tid] - v0).view(torch.int32)
            cached = (tris, rec.view(torch.float32))
            self.__dict__["_slot_records"] = cached
        return cached[1]


@dataclasses.dataclass(frozen=True)
class TrianglesSoA:
    """World-space triangle soup plus per-corner shading attributes."""

    v0: torch.Tensor          # (T,3) f32
    v1: torch.Tensor
    v2: torch.Tensor
    material: torch.Tensor    # (T,) i32
    mesh_index: torch.Tensor  # (T,) i32
    n0: torch.Tensor          # (T,3) f32 shading normals
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor         # (T,2) f32 texture coords, UV set 0
    uv1: torch.Tensor
    uv2: torch.Tensor
    uvb0: torch.Tensor        # (T,2) f32 texture coords, UV set 1
    uvb1: torch.Tensor
    uvb2: torch.Tensor
    t0: torch.Tensor          # (T,4) f32 tangent + handedness
    t1: torch.Tensor
    t2: torch.Tensor
    # [v0 v1 v2 n0 n1 n2 material mesh_index pad pad]: the one row the
    # shade stage gathers per hit
    shade_packed: torch.Tensor  # (T,24) f32

    @property
    def count(self) -> int:
        return self.material.shape[0]


@dataclasses.dataclass(frozen=True)
class EnvironmentSoA:
    """Equirect environment map plus alias tables for importance sampling
    (reference: src/renderer/EnvImportanceSampler.mm:16-236), field for
    field the JAX package's; built by ``ops/env.py``.

    The packed rows are bit-identical copies of the tables, one row per
    lookup: ``flat_quads`` the four bilinear neighbours of every texel of
    every mip level, ``cond_packed`` [threshold, alias, pdf],
    ``marg_packed`` [threshold, alias], ``nee_packed`` [pdf, R, G, B] of
    the mip0 texel the pdf was built from."""

    texels: torch.Tensor                 # (H,W,3) f32 mip0 radiance
    mips: Tuple[torch.Tensor, ...]       # coarser levels, (Hi,Wi,3)
    marginal_threshold: torch.Tensor     # (H,)  f32
    marginal_alias: torch.Tensor         # (H,)  i32
    conditional_threshold: torch.Tensor  # (H,W) f32
    conditional_alias: torch.Tensor      # (H,W) i32
    pdf: torch.Tensor                    # (H,W) f32 solid-angle pdf
    width: int
    height: int
    flat_mips: torch.Tensor              # (sum Hi*Wi, 3) f32
    mip_meta: Tuple[Tuple[int, int, int], ...]  # (offset, h, w) per level
    flat_quads: torch.Tensor             # (sum Hi*Wi, 12) f32
    cond_packed: torch.Tensor            # (H,W,3) f32
    marg_packed: torch.Tensor            # (H,2) f32
    nee_packed: torch.Tensor             # (H,W,4) f32


@dataclasses.dataclass(frozen=True)
class TextureArrays:
    """Flat native-resolution mip atlas of every material texture
    (``ops/textures.py`` builds it), field for field the JAX package's:
    all textures x all levels in one (TOTAL,4) texel buffer plus
    per-(texture, level) offset and size tables."""

    texels: torch.Tensor        # (TOTAL,4) f32
    level_offset: torch.Tensor  # (T,L) i32 flat offset per level
    level_w: torch.Tensor       # (T,L) i32
    level_h: torch.Tensor       # (T,L) i32
    n_levels: torch.Tensor      # (T,)  i32
    size0: torch.Tensor         # (T,)  f32 max(native w, h): LOD scale
    wrap_mode: torch.Tensor     # (T,2) i32 0 repeat / 1 clamp / 2 mirror
    n_textures: int = 0
    max_levels: int = 0

    @property
    def max_lod(self) -> float:
        return float(self.max_levels - 1)


@dataclasses.dataclass(frozen=True)
class SceneArrays:
    """Everything the integrator reads on the device. ``spheres`` and
    ``rects`` may be None or hold no rows when the scene has none."""

    materials: MaterialsSoA
    triangles: Optional[TrianglesSoA] = None
    tri_bvh: Optional[BvhSoA] = None
    environment: Optional[EnvironmentSoA] = None
    textures: Optional[TextureArrays] = None
    spheres: Optional[SpheresSoA] = None
    rects: Optional[RectsSoA] = None
    # emissive rectangles for NEE (rect indices), (L,) i32
    light_rect_indices: Optional[torch.Tensor] = None
    # the chunked sphere kernel's layout, above 32 spheres
    sphere_groups: Optional[SphereGroups] = None

    @property
    def n_spheres(self) -> int:
        return 0 if self.spheres is None else self.spheres.count

    @property
    def n_rects(self) -> int:
        return 0 if self.rects is None else self.rects.count

    @property
    def n_triangles(self) -> int:
        return 0 if self.triangles is None else self.triangles.count

    @property
    def n_rect_lights(self) -> int:
        idx = self.light_rect_indices
        return 0 if idx is None else idx.shape[0]


@dataclasses.dataclass(frozen=True)
class CameraUniforms:
    """Orbit camera basis (reference: UniformBuilder.mm:34-83)."""

    origin: torch.Tensor      # (3,)
    lower_left: torch.Tensor  # (3,)
    horizontal: torch.Tensor  # (3,)
    vertical: torch.Tensor    # (3,)
    u: torch.Tensor           # (3,)
    v: torch.Tensor           # (3,)
    lens_radius: torch.Tensor  # ()


@dataclasses.dataclass(frozen=True)
class Uniforms:
    """Per-dispatch parameters (reference: PathtraceUniforms:117-213).
    Counters and clamp settings are host scalars: the kernels take them as
    launch arguments."""

    camera: CameraUniforms
    frame_index: int
    sample_count: int
    fixed_rng_seed: int
    background_color: Tuple[float, float, float]
    environment_rotation: float
    environment_intensity: float
    firefly_clamp_enabled: float
    firefly_clamp_factor: float
    firefly_clamp_floor: float
    throughput_clamp: float
    specular_tail_clamp_base: float
    specular_tail_clamp_roughness_scale: float
    min_specular_pdf: float
    firefly_clamp_max_contribution: float
    debug_env_mip_override: float = -1.0
    debug_normal_strength_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class StaticConfig:
    """Hashable render configuration: the flags that select code paths."""

    width: int
    height: int
    max_depth: int
    use_russian_roulette: bool
    background_mode: int            # 0 gradient / 1 solid / 2 environment
    working_color_space: int        # 0 linear sRGB / 1 ACEScg
    enable_specular_nee: bool = True
    enable_mnee: bool = False
    enable_mnee_secondary: bool = True
    debug_specular_only: bool = False
    debug_disable_ao: bool = False
    debug_ao_indirect_only: bool = True
    debug_disable_normal_map: bool = False
    debug_disable_orm: bool = False
    debug_flip_normal_green: bool = False
    # subsurface: 0 off (lambert fallback) / 1 separable / 2 random walk,
    # and the walk's step count
    sss_mode: int = 0
    sss_max_steps: int = 32
    material_types: Tuple[int, ...] = ()
    # texture slots (base/ORM/normal/occlusion/emissive/transmission) bound
    # by at least one material: absent slots take their defaults unsampled
    texture_slots: Tuple[int, ...] = (0, 1, 2, 3, 4, 5)
    # any material addressing UV set 1
    texture_uv1: bool = True


def settings_to_static(settings, width: int, height: int, material_types,
                       texture_slots=None, texture_uv1=None) -> StaticConfig:
    """(``schema.settings_to_static`` of the JAX package; the texture
    arguments default to every slot and UV set 1, as there)."""
    return StaticConfig(
        texture_slots=(tuple(sorted(set(int(s) for s in texture_slots)))
                       if texture_slots is not None else (0, 1, 2, 3, 4, 5)),
        texture_uv1=bool(texture_uv1) if texture_uv1 is not None else True,
        width=int(width),
        height=int(height),
        max_depth=int(settings.maxDepth),
        use_russian_roulette=bool(settings.enableRussianRoulette),
        background_mode=int(settings.backgroundMode),
        working_color_space=int(settings.workingColorSpace),
        enable_specular_nee=bool(settings.enableSpecularNee),
        enable_mnee=bool(settings.enableMnee),
        enable_mnee_secondary=bool(settings.enableMneeSecondary),
        debug_specular_only=bool(settings.debugSpecularOnly),
        debug_disable_ao=bool(settings.debugDisableAO),
        debug_ao_indirect_only=bool(settings.debugAoIndirectOnly),
        debug_disable_normal_map=bool(settings.debugDisableNormalMap),
        debug_disable_orm=bool(settings.debugDisableOrmTexture),
        debug_flip_normal_green=bool(settings.debugFlipNormalGreen),
        sss_mode=int(settings.sssMode),
        sss_max_steps=int(settings.sssMaxSteps),
        material_types=tuple(sorted(set(int(t) for t in material_types))),
    )


def _f32(x) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def settings_to_uniforms(settings, camera: CameraUniforms, frame_index: int,
                         sample_count: int) -> Uniforms:
    """Scalars rounded to float32 as the reference stores them."""
    return Uniforms(
        camera=camera,
        frame_index=int(frame_index) & 0xFFFFFFFF,
        sample_count=int(sample_count) & 0xFFFFFFFF,
        fixed_rng_seed=int(settings.fixedRngSeed) & 0xFFFFFFFF,
        background_color=tuple(_f32(c) for c in settings.backgroundColor),
        environment_rotation=_f32(settings.environmentRotation),
        environment_intensity=_f32(settings.environmentIntensity),
        firefly_clamp_enabled=1.0 if settings.fireflyClampEnabled else 0.0,
        firefly_clamp_factor=_f32(max(settings.fireflyClampFactor, 0.0)),
        firefly_clamp_floor=_f32(max(settings.fireflyClampFloor, 0.0)),
        throughput_clamp=_f32(max(settings.throughputClamp, 0.0)),
        specular_tail_clamp_base=_f32(
            max(settings.specularTailClampBase, 0.0)),
        specular_tail_clamp_roughness_scale=_f32(
            max(settings.specularTailClampRoughnessScale, 0.0)),
        min_specular_pdf=_f32(max(settings.minSpecularPdf, 0.0)),
        firefly_clamp_max_contribution=_f32(
            max(settings.fireflyClampMaxContribution, 0.0)),
        debug_env_mip_override=_f32(settings.debugEnvMipOverride),
        debug_normal_strength_scale=_f32(settings.debugNormalStrengthScale),
    )
