"""Host-side scene container and device-array builder (jax-free twin of
``scene/resources.py``).

Materials, analytic spheres and oriented rectangles, world-space triangle
meshes, placements of shared object-space meshes (true instancing: one
BLAS per source, ``InstanceGroup``), material textures and an
environment map.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops.kernels import primitives
from metal_pathtracer_tpu_torch.schema import (
    InstanceGroup,
    MaterialsSoA,
    RectsSoA,
    SceneArrays,
    SpheresSoA,
)


def _clamp01(v):
    return np.clip(np.asarray(v, np.float64), 0.0, 1.0)


def _positive(v):
    return np.maximum(np.asarray(v, np.float64), 0.0)


def compute_coat_average(coat_ior: float) -> float:
    """(reference: SceneResources.mm ComputeCoatAverage:825-834)"""
    eta = max(coat_ior, 1.0)
    ratio = (eta - 1.0) / max(eta + 1.0, 1e-6)
    f0 = ratio * ratio
    average = f0 + (1.0 - f0) * C.SCHLICK_AVERAGE_FACTOR
    return float(np.clip(average, 0.0, 0.999))


def compute_coat_sample_weight(mat_type: int, coat_roughness: float,
                               coat_thickness: float,
                               coat_average: float) -> float:
    """(reference: SceneResources.mm ComputeCoatSampleWeight:835-852)"""
    has_layer = (coat_thickness > 1e-4 or coat_roughness > 1e-4
                 or mat_type in (C.MATERIAL_PLASTIC, C.MATERIAL_CARPAINT))
    if not has_layer:
        return 0.0
    weight = coat_average * 2.5 + coat_roughness * 0.5
    if mat_type == C.MATERIAL_CARPAINT:
        weight = max(weight, 0.35)
    elif mat_type == C.MATERIAL_PLASTIC:
        weight = max(weight, 0.25)
    return float(np.clip(weight, 0.0, 0.95))


@dataclasses.dataclass
class Material:
    """One material row, pre-derivation (reference:
    SceneResources.mm:902-1038); same fields and defaults as the JAX
    package's ``Material``."""

    base_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    roughness: float = 0.0
    mat_type: int = C.MATERIAL_LAMBERTIAN
    ior: float = 1.5
    emission: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    emission_env: bool = False
    conductor_eta: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    conductor_k: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    has_conductor: bool = False
    coat_roughness: float = 0.0
    coat_thickness: float = 0.0
    coat_tint: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    coat_absorption: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    coat_ior: float = 1.5
    dielectric_sigma_a: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    sss_sigma_a: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    sss_sigma_s: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    sss_mfp: float = 0.0
    sss_g: float = 0.0
    sss_method: int = 0
    sss_coat: bool = False
    sss_sigma_override: bool = False
    carpaint_base_metallic: float = 0.0
    carpaint_base_roughness: float = 0.0
    carpaint_flake_sample_weight: float = 0.0
    carpaint_flake_roughness: float = 0.0
    carpaint_flake_anisotropy: float = 0.0
    carpaint_flake_normal_strength: float = 0.0
    carpaint_flake_scale: float = 1.0
    carpaint_flake_reflectance: float = 1.0
    carpaint_base_eta: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    carpaint_base_k: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    carpaint_has_base_conductor: bool = False
    carpaint_base_tint: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    thin: bool = False
    name: str = ""
    pbr_metallic: float = 0.0
    pbr_roughness: Optional[float] = None   # defaults to roughness
    pbr_occlusion_strength: float = 1.0
    pbr_normal_scale: float = 1.0
    pbr_alpha: float = 1.0
    pbr_alpha_cutoff: float = 0.5
    pbr_transmission: float = 0.0
    pbr_alpha_mode: int = 0
    pbr_double_sided: bool = False
    pbr_thickness: float = 0.0
    texture_indices: Tuple[int, ...] = (-1, -1, -1, -1, -1, -1)
    texture_uv_set: Tuple[int, ...] = (0, 0, 0, 0, 0, 0)
    texture_transform: Optional[np.ndarray] = None  # (6,2,3)
    material_flags: int = 0


@dataclasses.dataclass
class Sphere:
    center: Tuple[float, float, float]
    radius: float
    material: int


@dataclasses.dataclass
class Rect:
    corner: np.ndarray
    edge_u: np.ndarray
    edge_v: np.ndarray
    normal: np.ndarray
    material: int
    two_sided: bool


@dataclasses.dataclass
class Mesh:
    """A triangle mesh already composed into world space."""

    name: str
    vertices: np.ndarray      # (V,3) f32
    normals: np.ndarray       # (V,3) f32
    uv0: np.ndarray           # (V,2) f32
    uv1: np.ndarray           # (V,2) f32
    tangents: np.ndarray      # (V,4) f32
    indices: np.ndarray       # (F,3) i32
    material: int = 0


@dataclasses.dataclass
class MeshInstance:
    """A placement of a shared OBJECT-space mesh (reference: SceneAccel.mm
    SoftwareInstanceInfo :173-247): N placements of one source keep one
    triangle store and BVH."""

    source: Mesh              # object-space geometry (shared by reference)
    transform: np.ndarray     # (4,4) f64 local -> world
    material: int = 0


class SceneResources:
    """Mutable scene under construction; ``build_arrays()`` freezes it."""

    def __init__(self):
        self.materials: List[Material] = []
        self.spheres: List[Sphere] = []
        self.rects: List[Rect] = []
        self.meshes: List[Mesh] = []
        self.mesh_instances: List[MeshInstance] = []
        self.material_names: Dict[str, int] = {}
        # texture pixels ((H,W,4) uint8), sRGB flags and (wrap_s, wrap_t)
        # modes: 0 repeat / 1 clamp / 2 mirror
        self.texture_images: List[np.ndarray] = []
        self.texture_srgb: List[bool] = []
        self.texture_wrap: List = []
        # object-space meshes of `mesh ... instanced=1` records, by path
        self.instance_mesh_cache: Dict[str, Mesh] = {}

    def add_material(self, material: Material) -> int:
        """(reference: SceneResources.mm addMaterial:902-1038)"""
        if len(self.materials) >= C.MAX_MATERIALS:
            return C.MAX_MATERIALS - 1
        index = len(self.materials)
        self.materials.append(material)
        if material.name:
            self.material_names[material.name] = index
        return index

    def material_count(self) -> int:
        return len(self.materials)

    def add_mesh(self, mesh: Mesh) -> None:
        self.meshes.append(mesh)

    def add_sphere(self, center, radius, material_index) -> None:
        if len(self.spheres) >= C.MAX_SPHERES:
            return
        self.spheres.append(Sphere(tuple(center), float(radius),
                                   int(material_index)))

    def add_rectangle(self, bounds_min, bounds_max, normal_axis: int,
                      normal_positive: bool, two_sided: bool,
                      material_index: int) -> None:
        """Axis-aligned rectangle -> oriented corner/edge representation
        (reference: SceneResources.mm addRectangle:1743-1834)."""
        if len(self.rects) >= C.MAX_RECTANGLES:
            return
        material_index = int(material_index)
        if material_index >= len(self.materials):
            material_index = max(len(self.materials) - 1, 0)
        normal_axis = min(int(normal_axis), 2)
        mn = np.minimum(np.asarray(bounds_min, np.float64),
                        np.asarray(bounds_max, np.float64))
        mx = np.maximum(np.asarray(bounds_min, np.float64),
                        np.asarray(bounds_max, np.float64))
        if normal_axis == 0:  # X constant
            edge_u = np.array([0.0, mx[1] - mn[1], 0.0])
            if normal_positive:
                corner = np.array([mx[0], mn[1], mn[2]])
                edge_v = np.array([0.0, 0.0, mx[2] - mn[2]])
            else:
                corner = np.array([mn[0], mn[1], mx[2]])
                edge_v = np.array([0.0, 0.0, mn[2] - mx[2]])
        elif normal_axis == 1:  # Y constant
            edge_u = np.array([mx[0] - mn[0], 0.0, 0.0])
            if normal_positive:
                corner = np.array([mn[0], mx[1], mn[2]])
                edge_v = np.array([0.0, 0.0, mx[2] - mn[2]])
            else:
                corner = np.array([mn[0], mn[1], mx[2]])
                edge_v = np.array([0.0, 0.0, mn[2] - mx[2]])
        else:  # Z constant
            if normal_positive:
                corner = np.array([mn[0], mn[1], mx[2]])
                edge_u = np.array([mx[0] - mn[0], 0.0, 0.0])
                edge_v = np.array([0.0, mx[1] - mn[1], 0.0])
            else:
                corner = np.array([mx[0], mn[1], mn[2]])
                edge_u = np.array([mn[0] - mx[0], 0.0, 0.0])
                edge_v = np.array([0.0, mx[1] - mn[1], 0.0])
        desired = np.zeros(3)
        desired[normal_axis] = 1.0 if normal_positive else -1.0
        self.add_rectangle_oriented(corner, edge_u, edge_v, two_sided,
                                    material_index, desired)

    def add_rectangle_oriented(self, corner, edge_u, edge_v, two_sided,
                               material_index, desired_normal) -> None:
        """(reference: SceneResources.mm storeRectangleOriented): the
        stored normal is flipped toward ``desired_normal``; the edges keep
        their winding (light sampling uses that parameterisation)."""
        if len(self.rects) >= C.MAX_RECTANGLES:
            return
        corner = np.asarray(corner, np.float64)
        edge_u = np.asarray(edge_u, np.float64)
        edge_v = np.asarray(edge_v, np.float64)
        if np.dot(edge_u, edge_u) <= 0.0 or np.dot(edge_v, edge_v) <= 0.0:
            return
        normal = np.cross(edge_u, edge_v)
        norm = np.linalg.norm(normal)
        if norm <= 0.0:
            return
        normal = normal / norm
        desired = np.asarray(desired_normal, np.float64)
        if np.linalg.norm(desired) > 0.0 \
                and float(np.dot(normal, desired)) < 0.0:
            normal = -normal
        if not np.all(np.isfinite(normal)):
            return
        self.rects.append(Rect(
            corner=corner.astype(np.float32),
            edge_u=edge_u.astype(np.float32),
            edge_v=edge_v.astype(np.float32),
            normal=normal.astype(np.float32),
            material=int(material_index),
            two_sided=bool(two_sided)))

    def add_box(self, min_corner, max_corner, material_index,
                transform: Optional[np.ndarray] = None,
                include_bottom: bool = True, two_sided: bool = False) -> None:
        """Box as 5 or 6 oriented rectangles, faces in the reference's
        order and windings (reference: SceneResources.mm
        addBoxTransformed:1835+)."""
        if self.materials and material_index >= len(self.materials):
            material_index = len(self.materials) - 1
        mn = np.minimum(np.asarray(min_corner, np.float64),
                        np.asarray(max_corner, np.float64))
        mx = np.maximum(np.asarray(min_corner, np.float64),
                        np.asarray(max_corner, np.float64))
        dy = np.array([0, mx[1] - mn[1], 0])
        dx = np.array([mx[0] - mn[0], 0, 0])
        faces = [
            (np.array([mx[0], mn[1], mn[2]]), dy,
             np.array([0, 0, mx[2] - mn[2]]), np.array([1.0, 0, 0]), True),
            (np.array([mn[0], mn[1], mx[2]]), dy,
             np.array([0, 0, mn[2] - mx[2]]), np.array([-1.0, 0, 0]), True),
            (np.array([mn[0], mx[1], mn[2]]), dx,
             np.array([0, 0, mx[2] - mn[2]]), np.array([0, 1.0, 0]), True),
            (np.array([mn[0], mn[1], mx[2]]), dx,
             np.array([0, 0, mn[2] - mx[2]]), np.array([0, -1.0, 0]),
             include_bottom),
            (np.array([mn[0], mn[1], mx[2]]), dx, dy,
             np.array([0, 0, 1.0]), True),
            (np.array([mx[0], mn[1], mn[2]]), np.array([mn[0] - mx[0], 0, 0]),
             dy, np.array([0, 0, -1.0]), True),
        ]
        for corner, eu, ev, desired, include in faces:
            if not include:
                continue
            if transform is not None:
                tf = np.asarray(transform, np.float64)
                corner = (tf @ np.append(corner, 1.0))[:3]
                eu = tf[:3, :3] @ eu
                ev = tf[:3, :3] @ ev
                desired = tf[:3, :3] @ desired
            self.add_rectangle_oriented(corner, eu, ev, two_sided,
                                        material_index, desired)

    def add_mesh_instance(self, source: Mesh, transform,
                          material: int = 0) -> None:
        """Place ``source`` (object space) with a shared BLAS: N
        placements of the same source object keep one triangle store."""
        self.mesh_instances.append(MeshInstance(
            source=source,
            transform=np.asarray(transform, np.float64).reshape(4, 4),
            material=int(material)))

    def build_materials_soa(self, device="cuda") -> MaterialsSoA:
        mats = self.materials or [Material()]
        n = len(mats)

        def arr(fn, shape_tail=(), dtype=np.float32):
            out = np.zeros((n,) + shape_tail, dtype)
            for i, m in enumerate(mats):
                out[i] = fn(m)
            return torch.as_tensor(out, device=device)

        tt_default = np.zeros((6, 2, 3), np.float32)
        tt_default[:, 0, 0] = 1.0
        tt_default[:, 1, 1] = 1.0

        def derived(m: Material):
            coat_ior = max(m.coat_ior, 0.0)
            coat_roughness = float(np.clip(m.coat_roughness, 0.0, 1.0))
            coat_thickness = max(m.coat_thickness, 0.0)
            avg = compute_coat_average(coat_ior)
            weight = compute_coat_sample_weight(m.mat_type, coat_roughness,
                                                coat_thickness, avg)
            return coat_roughness, coat_thickness, min(weight, 0.95), avg

        def flake_weight(m):
            refl = max(np.clip(m.carpaint_flake_reflectance, 0.0, 1.0), 0.01)
            return np.clip(np.clip(m.carpaint_flake_sample_weight, 0.0, 0.95)
                           * refl, 0.0, 0.95)

        def base_conductor(v, m):
            return _positive(v) if m.carpaint_has_base_conductor \
                else np.zeros(3)

        return MaterialsSoA(
            base_color=arr(lambda m: _clamp01(m.base_color), (3,)),
            roughness=arr(lambda m: np.clip(m.roughness, 0.0, 1.0)),
            mat_type=arr(lambda m: m.mat_type, dtype=np.int32),
            eta=arr(lambda m: max(m.ior, 0.0)),
            coat_ior=arr(lambda m: max(m.coat_ior, 0.0)),
            thin=arr(lambda m: 1.0 if m.thin else 0.0),
            emission=arr(lambda m: np.asarray(m.emission, np.float64), (3,)),
            emission_env=arr(lambda m: 1.0 if m.emission_env else 0.0),
            conductor_eta=arr(lambda m: _positive(m.conductor_eta), (3,)),
            conductor_k=arr(lambda m: _positive(m.conductor_k), (3,)),
            has_conductor=arr(lambda m: 1.0 if m.has_conductor else 0.0),
            coat_roughness=arr(lambda m: derived(m)[0]),
            coat_thickness=arr(lambda m: derived(m)[1]),
            coat_sample_weight=arr(lambda m: derived(m)[2]),
            coat_fresnel_avg=arr(lambda m: derived(m)[3]),
            coat_tint=arr(lambda m: _clamp01(m.coat_tint), (3,)),
            coat_absorption=arr(lambda m: _positive(m.coat_absorption), (3,)),
            dielectric_sigma_a=arr(lambda m: _positive(m.dielectric_sigma_a),
                                   (3,)),
            sss_sigma_a=arr(lambda m: _positive(m.sss_sigma_a), (3,)),
            sss_sigma_override=arr(
                lambda m: 1.0 if m.sss_sigma_override else 0.0),
            sss_sigma_s=arr(lambda m: _positive(m.sss_sigma_s), (3,)),
            sss_g=arr(lambda m: np.clip(m.sss_g, -0.99, 0.99)),
            sss_mfp=arr(lambda m: max(m.sss_mfp, 0.0)),
            sss_method=arr(lambda m: float(m.sss_method)),
            sss_coat=arr(lambda m: 1.0 if m.sss_coat else 0.0),
            carpaint_base_metallic=arr(
                lambda m: np.clip(m.carpaint_base_metallic, 0.0, 1.0)),
            carpaint_base_roughness=arr(
                lambda m: np.clip(m.carpaint_base_roughness, 0.0, 1.0)),
            carpaint_flake_scale=arr(
                lambda m: max(m.carpaint_flake_scale, 1e-4)),
            carpaint_flake_reflectance=arr(
                lambda m: np.clip(m.carpaint_flake_reflectance, 0.0, 1.0)),
            carpaint_flake_sample_weight=arr(flake_weight),
            carpaint_flake_roughness=arr(
                lambda m: np.clip(m.carpaint_flake_roughness, 0.0, 1.0)),
            carpaint_flake_anisotropy=arr(
                lambda m: np.clip(m.carpaint_flake_anisotropy, -0.99, 0.99)),
            carpaint_flake_normal_strength=arr(
                lambda m: np.clip(m.carpaint_flake_normal_strength, 0.0, 1.0)),
            carpaint_base_eta=arr(
                lambda m: base_conductor(m.carpaint_base_eta, m), (3,)),
            carpaint_base_k=arr(
                lambda m: base_conductor(m.carpaint_base_k, m), (3,)),
            carpaint_has_base_conductor=arr(
                lambda m: 1.0 if m.carpaint_has_base_conductor else 0.0),
            carpaint_base_tint=arr(lambda m: _clamp01(m.carpaint_base_tint),
                                   (3,)),
            pbr_metallic=arr(lambda m: np.clip(m.pbr_metallic, 0.0, 1.0)),
            pbr_roughness=arr(lambda m: np.clip(
                m.pbr_roughness if m.pbr_roughness is not None
                else m.roughness, 0.0, 1.0)),
            pbr_occlusion_strength=arr(
                lambda m: np.clip(m.pbr_occlusion_strength, 0.0, 1.0)),
            pbr_normal_scale=arr(lambda m: m.pbr_normal_scale),
            pbr_alpha=arr(lambda m: np.clip(m.pbr_alpha, 0.0, 1.0)),
            pbr_alpha_cutoff=arr(lambda m: m.pbr_alpha_cutoff),
            pbr_transmission=arr(
                lambda m: np.clip(m.pbr_transmission, 0.0, 1.0)),
            pbr_alpha_mode=arr(lambda m: float(m.pbr_alpha_mode)),
            pbr_double_sided=arr(lambda m: 1.0 if m.pbr_double_sided else 0.0),
            pbr_thickness=arr(lambda m: max(m.pbr_thickness, 0.0)),
            texture_indices=arr(
                lambda m: np.asarray(m.texture_indices, np.int64), (6,),
                np.int32),
            texture_uv_set=arr(
                lambda m: np.asarray(m.texture_uv_set, np.int64), (6,),
                np.int32),
            texture_transform=arr(
                lambda m: (m.texture_transform
                           if m.texture_transform is not None
                           else tt_default), (6, 2, 3)),
            material_flags=arr(lambda m: m.material_flags, dtype=np.int32),
        )

    def build_arrays(self, environment=None, textures=None,
                     device="cuda") -> SceneArrays:
        """Materials, the merged triangle soup and its BVH, and the texture
        atlas, on ``device``; ``environment`` is an ``EnvironmentSoA``
        (``ops/env.py``) and ``textures`` a ``TextureArrays`` built
        beforehand, each on the same device."""
        for what, arrays in (("environment", environment),
                             ("textures", textures)):
            if arrays is not None and arrays.texels.device.type != \
                    torch.device(device).type:
                raise ValueError(f"the {what} lie on "
                                 f"{arrays.texels.device}, not {device}")
        if textures is None and self.texture_images:
            from metal_pathtracer_tpu_torch.ops.textures import (
                build_texture_arrays,
            )
            wraps = self.texture_wrap if len(self.texture_wrap) == \
                len(self.texture_images) else None
            textures = build_texture_arrays(self.texture_images,
                                            self.texture_srgb, wraps,
                                            device=device)
        triangles = tri_bvh = None
        if self.meshes:
            from metal_pathtracer_tpu_torch.scene import meshbuild
            triangles, tri_bvh = meshbuild.build_triangle_arrays(
                self.meshes, device=device)
        spheres = self.build_spheres_soa(device)
        return SceneArrays(materials=self.build_materials_soa(device),
                           triangles=triangles, tri_bvh=tri_bvh,
                           environment=environment, textures=textures,
                           spheres=spheres,
                           rects=self.build_rects_soa(device),
                           light_rect_indices=torch.as_tensor(
                               np.array(self.light_rect_indices(), np.int32),
                               device=device),
                           sphere_groups=primitives.groups_of(spheres),
                           instanced=self._build_instance_groups(device))

    def _build_instance_groups(self, device="cuda"):
        """One ``InstanceGroup`` per source object, in order of first
        appearance: its object-space soup and BVH, shared by its
        placements; global instance ids follow the soup's mesh ids.
        ``w2l`` and ``nrm_mat`` come from the float64 inverse of each
        placement's 4x4, stored as float32."""
        if not self.mesh_instances:
            return ()
        from metal_pathtracer_tpu_torch.scene import meshbuild

        by_source: Dict[int, list] = {}
        for inst in self.mesh_instances:
            by_source.setdefault(id(inst.source), []).append(inst)
        groups = []
        base_id = len(self.meshes)
        for insts in by_source.values():
            tris, bvh = meshbuild.build_triangle_arrays([insts[0].source],
                                                        device=device)
            l2w = np.zeros((len(insts), 3, 4), np.float32)
            w2l = np.zeros((len(insts), 3, 4), np.float32)
            nrm = np.zeros((len(insts), 3, 3), np.float32)
            for i, inst in enumerate(insts):
                m44 = np.asarray(inst.transform, np.float64)
                inv = np.linalg.inv(m44)
                l2w[i] = m44[:3, :4]
                w2l[i] = inv[:3, :4]
                nrm[i] = inv[:3, :3].T
            t = lambda a: torch.as_tensor(a, device=device)
            groups.append(InstanceGroup(
                triangles=tris, tri_bvh=bvh, l2w=t(l2w), w2l=t(w2l),
                nrm_mat=t(nrm),
                material=t(np.array([i.material for i in insts], np.int32)),
                base_id=base_id, count=len(insts)))
            base_id += len(insts)
        return tuple(groups)

    def build_spheres_soa(self, device="cuda") -> SpheresSoA:
        """The spheres as (S,...) arrays; zero rows without spheres."""
        t = lambda a, dt: torch.as_tensor(np.array(a, dt), device=device)
        return SpheresSoA(
            center=t([s.center for s in self.spheres], np.float32).reshape(
                -1, 3),
            radius=t([s.radius for s in self.spheres], np.float32),
            material=t([s.material for s in self.spheres], np.int32))

    def build_rects_soa(self, device="cuda") -> RectsSoA:
        """The rectangles with their derived rows (inverse squared edge
        lengths and plane offsets in float32, as the JAX package computes
        them); zero rows without rectangles."""
        cols = lambda f: np.array([f(r) for r in self.rects],
                                  np.float32).reshape(-1, 3)
        eu, ev = cols(lambda r: r.edge_u), cols(lambda r: r.edge_v)
        nrm, corner = cols(lambda r: r.normal), cols(lambda r: r.corner)
        t = lambda a: torch.as_tensor(a, device=device)
        return RectsSoA(
            corner=t(corner), edge_u=t(eu), edge_v=t(ev),
            inv_len2_u=t(1.0 / np.maximum((eu * eu).sum(-1), 1e-20)),
            inv_len2_v=t(1.0 / np.maximum((ev * ev).sum(-1), 1e-20)),
            normal=t(nrm), plane=t((nrm * corner).sum(-1)),
            material=t(np.array([r.material for r in self.rects], np.int32)),
            two_sided=t(np.array([1.0 if r.two_sided else 0.0
                                  for r in self.rects], np.float32)))

    def light_rect_indices(self) -> List[int]:
        """Emissive rectangles for NEE: diffuse-light material with a
        non-zero emission (reference: pathtrace.metal count_rect_lights)."""
        out = []
        for i, r in enumerate(self.rects):
            if not self.materials:
                break
            m = self.materials[min(r.material, len(self.materials) - 1)]
            if m.mat_type == C.MATERIAL_DIFFUSE_LIGHT \
                    and any(e != 0.0 for e in m.emission):
                out.append(i)
        return out

    def material_types_present(self):
        return sorted({m.mat_type for m in self.materials})

    def texture_slots_present(self):
        """Slots (0-5) bound by at least one material: absent slots take
        their defaults without a sample."""
        return sorted({s for m in self.materials
                       for s, t in enumerate(m.texture_indices) if t >= 0})

    def texture_uses_uv1(self):
        """Any bound texture slot addressing UV set 1 (glTF TEXCOORD_1)."""
        return any(t >= 0 and s < len(m.texture_uv_set)
                   and m.texture_uv_set[s] == 1
                   for m in self.materials
                   for s, t in enumerate(m.texture_indices))
