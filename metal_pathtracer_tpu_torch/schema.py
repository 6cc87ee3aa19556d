"""Device-side data layouts as torch dataclasses (``schema.py`` twin).

Each struct-of-arrays container of the JAX package becomes a frozen
dataclass of tensors, field for field. ``InstanceGroup`` holds one
shared object-space mesh and its placements; ``InstanceTable`` is the
flat layout the instanced trace kernels and K2 read.
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
class InstanceGroup:
    """One shared object-space BLAS and its placements (``schema.py
    InstanceGroup:398-416``; reference: SceneAccel.mm:173-247
    SoftwareInstanceInfo). Every placement traces the same triangles with
    its ray mapped into object space (the direction is not renormalised,
    so t is the same in both spaces), so N placements store the mesh
    once."""

    triangles: TrianglesSoA   # OBJECT-space soup of the source mesh
    tri_bvh: BvhSoA
    l2w: torch.Tensor         # (I,3,4) f32 local -> world affine rows
    w2l: torch.Tensor         # (I,3,4) f32 world -> local affine rows
    nrm_mat: torch.Tensor     # (I,3,3) f32 inverse-transpose linear part
    material: torch.Tensor    # (I,)    i32 per-placement material
    base_id: int = 0          # global instance id of placement 0
    count: int = 0


#: ``InstanceTable.table`` columns the host reads: the normal matrix (9
#: floats), then as int bits the material, the object-triangle offset and
#: the global instance id (``csrc/common.cuh rebuild_instanced``)
INST_NRM, INST_MAT, INST_TRI_OFF, INST_ID = 12, 21, 26, 27


@dataclasses.dataclass(frozen=True)
class InstanceTable:
    """Every placement of every group in one flat layout, in the JAX
    package's trace order (group by group, placement by placement): row
    k of ``table`` (32 floats, 128 bytes) is flat instance k, whose global
    id is the first group's ``base_id`` + k: its world -> local rows (12
    floats), normal
    matrix (9), then as int bits its material, its group's node offset
    and count, slot offset and count, object-triangle offset, and its
    global id (``csrc/traverse.cu load_placement``). ``nodes`` and
    ``recs`` are the groups' K1 layouts (``packed_nodes``,
    ``slot_records``) one after the other, ``shade_packed`` their
    object-space hit rows; a row's offsets index them, and a group's
    exit links and leaf offsets stay relative to its own start."""

    table: torch.Tensor         # (K, 32) f32
    nodes: torch.Tensor         # (sum N_g, 8) f32
    recs: torch.Tensor          # (sum P_g, 12) f32
    shade_packed: torch.Tensor  # (sum T_g, 24) f32

    @property
    def count(self) -> int:
        return self.table.shape[0]


def instance_table(groups) -> InstanceTable:
    """The ``InstanceTable`` of a tuple of ``InstanceGroup``s, on their
    device; made on first use and kept on the first group (rebuilt when
    asked for another tuple)."""
    cached = groups[0].__dict__.get("_table")
    if cached is not None and len(cached[0]) == len(groups) and all(
            a is b for a, b in zip(cached[0], groups)):
        return cached[1]
    rows, nodes, recs, shade = [], [], [], []
    node_off = slot_off = tri_off = 0
    for g in groups:
        nd, rc = g.tri_bvh.packed_nodes(), g.tri_bvh.slot_records(g.triangles)
        ints = torch.tensor(
            [[int(m), node_off, nd.shape[0], slot_off, rc.shape[0], tri_off,
              g.base_id + i, 0, 0, 0, 0]
             for i, m in enumerate(g.material.tolist())], dtype=torch.int32,
            device=g.w2l.device).reshape(-1, 11)
        rows.append(torch.cat([g.w2l.reshape(-1, 12), g.nrm_mat.reshape(-1, 9),
                               ints.view(torch.float32)], 1))
        nodes.append(nd)
        recs.append(rc)
        shade.append(g.triangles.shade_packed)
        node_off += nd.shape[0]
        slot_off += rc.shape[0]
        tri_off += g.triangles.count
    out = InstanceTable(table=torch.cat(rows).contiguous(),
                        nodes=torch.cat(nodes).contiguous(),
                        recs=torch.cat(recs).contiguous(),
                        shade_packed=torch.cat(shade).contiguous())
    groups[0].__dict__["_table"] = (tuple(groups), out)
    return out


#: placements a TLAS leaf holds at most, and the instanced walk's stack
#: depth (``csrc/traverse.cu TLAS_STACK``): a median split over K
#: placements is ceil(log2(ceil(K / 4))) interior levels deep, so 16
#: levels hold 262,144 placements
TLAS_LEAF, TLAS_STACK = 4, 16
#: the padding's scale: kappa = TLAS_KAPPA x the largest condition number
#: of a placement's linear part (``csrc/traverse.cu`` says why it holds)
TLAS_KAPPA = 2.0 ** -14


@dataclasses.dataclass(frozen=True)
class InstanceTlas:
    """A tree over the placements' world boxes (reference: SceneAccel.mm
    :188-247, a median split on the largest centroid axis, leaves of <= 4
    placements), in K1's node layout (``BvhSoA.packed_nodes``): a node is
    ``[bmin xyz, exit]``, ``[bmax xyz, offset << 3 | count]``, flattened
    depth first; an interior node's offset is its right child (its left is
    the next node), a leaf's its first row of ``boxes``. ``boxes`` holds
    every placement's own world box in leaf order, ``[bmin xyz, table
    row]``, ``[bmax xyz, 0]``: the 8 corners of its group's root box mapped
    local -> world in float64, padded outward by kappa x (the largest
    world coordinate of any box + the largest translation), rounded
    outward to float32. A lane pads every box by ``pad`` x max |o_i| more
    (``pad`` = 2 kappa). Interior boxes are their children's unions."""

    nodes: torch.Tensor   # (T, 8) f32
    boxes: torch.Tensor   # (K, 8) f32
    pad: float
    depth: int            # interior levels (the stack the walk needs)

    @property
    def node_count(self) -> int:
        return self.nodes.shape[0]


def _outward(x, down: bool):
    """float64 -> float32 rounded away from the box's inside."""
    import numpy as np

    f = x.astype(np.float32)
    away = f > x if down else f < x
    return np.where(away, np.nextafter(f, np.float32(-np.inf if down
                                                     else np.inf)), f)


def instance_tlas(groups) -> InstanceTlas:
    """The ``InstanceTlas`` of the groups' placements (flat index as in
    ``instance_table``), on their device; made on first use and kept on
    their ``InstanceTable``."""
    import numpy as np

    tab = instance_table(groups)
    cached = tab.__dict__.get("_tlas")
    if cached is not None:
        return cached
    lo, hi, l2w = [], [], []
    for g in groups:
        nd = g.tri_bvh.packed_nodes()[0].double().cpu().numpy()
        corners = np.array([[nd[4 * (k >> a & 1) + a] for a in range(3)]
                            for k in range(8)])
        for m in g.l2w.double().cpu().numpy():
            w = corners @ m[:, :3].T + m[:, 3]
            lo.append(w.min(0))
            hi.append(w.max(0))
            l2w.append(m)
    lo, hi, l2w = np.array(lo), np.array(hi), np.array(l2w)
    cond = max(1.0, max(float(s[0] / s[-1]) if s[-1] > 0 else np.inf
                        for s in np.linalg.svd(l2w[:, :, :3],
                                               compute_uv=False)))
    kappa = min(TLAS_KAPPA * cond, 1.0)
    reach = max(np.abs(lo).max(), np.abs(hi).max()) \
        + np.abs(l2w[:, :, 3]).max()
    lo = _outward(lo - kappa * reach, True)
    hi = _outward(hi + kappa * reach, False)
    centre = (lo.astype(np.float64) + hi) * 0.5
    nodes, order = [], []

    def build(idx, level):
        k = len(nodes)
        nodes.append(None)
        if len(idx) <= TLAS_LEAF:
            first = len(order)
            order.extend(idx.tolist())
            nodes[k] = (lo[idx].min(0), hi[idx].max(0), first << 3 | len(idx))
            return level
        c = centre[idx]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        idx = idx[np.argsort(c[:, axis], kind="stable")]
        half = len(idx) // 2
        depth = build(idx[:half], level + 1)
        right = len(nodes)
        depth = max(depth, build(idx[half:], level + 1))
        nodes[k] = (np.minimum(nodes[k + 1][0], nodes[right][0]),
                    np.maximum(nodes[k + 1][1], nodes[right][1]),
                    right << 3)
        return depth

    depth = build(np.arange(len(lo)), 0)
    if depth > TLAS_STACK:
        raise ValueError(f"instance_tlas: {len(lo)} placements need "
                         f"{depth} levels, the walk keeps {TLAS_STACK}")
    # exit links: where a depth-first walk goes after a node's subtree
    exits = [len(nodes)] * len(nodes)
    for k, (_, _, meta) in enumerate(nodes):
        if meta & 7 == 0:
            right = meta >> 3
            exits[k + 1] = right
            exits[right] = exits[k]
    dev = groups[0].w2l.device
    as_f = lambda ints: np.asarray(ints, np.int32).view(np.float32)
    packed = np.array([np.concatenate([b0, as_f([e]), b1, as_f([m])])
                       for (b0, b1, m), e in zip(nodes, exits)], np.float32)
    order = np.array(order)
    boxes = np.concatenate([lo[order], as_f(order)[:, None], hi[order],
                            np.zeros((len(order), 1), np.float32)], 1)
    out = InstanceTlas(nodes=torch.from_numpy(packed).to(dev).contiguous(),
                       boxes=torch.from_numpy(boxes.astype(np.float32))
                       .to(dev).contiguous(),
                       pad=float(np.float32(2.0 * kappa)), depth=depth)
    tab.__dict__["_tlas"] = out
    return out


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
    # instanced mesh groups (shared BLAS per source; ``InstanceGroup``)
    instanced: Tuple[InstanceGroup, ...] = ()

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
    def n_instances(self) -> int:
        """Placements over every instanced group."""
        return sum(g.count for g in self.instanced)

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
