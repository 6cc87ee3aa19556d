"""glTF 2.0 and GLB loader (``scene/gltf.py`` twin, without Pillow).

The reference's loader (reference: src/assets/GltfLoader.mm,
include/assets/GltfLoader.h:11-42): GLB chunks, buffers from the BIN
chunk, files or base64 data URIs, buffer views and accessors (strided,
sparse, normalized integers), node TRS composition, PBR
metallic-roughness materials with KHR_materials_transmission,
KHR_materials_volume, KHR_materials_ior, KHR_materials_emissive_strength
and KHR_texture_transform, per-slot UV sets, alpha modes, double-sided
materials, the emissive scale of the ``gltf*`` settings, and the first
camera node. Texture images are decoded by ``utils/image_io.decode_png``
into ``SceneResources.texture_images``; tangents a primitive lacks are
generated (``scene/tangent.py``) when it has UVs.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import Dict, Optional, Tuple
from urllib.parse import unquote

import numpy as np

from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.scene.resources import (
    Material,
    Mesh,
    SceneResources,
)
from metal_pathtracer_tpu_torch.utils.image_io import decode_png

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT2": 4, "MAT3": 9, "MAT4": 16}

#: texture slots of ``Material.texture_indices``
SLOT_BASE, SLOT_MR, SLOT_NORMAL, SLOT_OCCLUSION, SLOT_EMISSIVE, \
    SLOT_TRANSMISSION = range(6)
#: sampler wrap modes -> 0 repeat / 1 clamp / 2 mirror
_WRAP = {10497: 0, 33071: 1, 33648: 2}


class GltfError(ValueError):
    pass


def _load_glb(data: bytes):
    """(JSON document, BIN chunk or None) of a GLB file (reference:
    GltfLoader.mm :812-857)."""
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise GltfError("not a GLB file")
    if version != 2:
        raise GltfError(f"unsupported GLB version {version}")
    offset, doc, bin_chunk = 12, None, None
    while offset + 8 <= len(data):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        offset += 8
        chunk = data[offset:offset + chunk_len]
        offset += chunk_len
        if chunk_type == 0x4E4F534A:    # JSON
            doc = json.loads(chunk.decode("utf-8"))
        elif chunk_type == 0x004E4942:  # BIN
            bin_chunk = chunk
    if doc is None:
        raise GltfError("GLB missing JSON chunk")
    return doc, bin_chunk


class GltfFile:
    """A glTF document with lazy buffers and accessor decoding."""

    def __init__(self, path: str):
        self.base_dir = os.path.dirname(os.path.abspath(path))
        with open(path, "rb") as f:
            raw = f.read()
        if path.lower().endswith(".glb") or raw[:4] == b"glTF":
            self.doc, self.bin_chunk = _load_glb(raw)
        else:
            self.doc, self.bin_chunk = json.loads(raw.decode("utf-8")), None
        self._buffers: Dict[int, bytes] = {}

    def _uri(self, uri: str) -> bytes:
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])
        with open(os.path.join(self.base_dir, unquote(uri)), "rb") as f:
            return f.read()

    def buffer(self, index: int) -> bytes:
        """(reference: GltfLoader.mm buffers and data URIs :173-199)"""
        if index not in self._buffers:
            uri = self.doc["buffers"][index].get("uri")
            if uri is None:
                if self.bin_chunk is None:
                    raise GltfError("buffer refers to missing GLB BIN chunk")
                self._buffers[index] = self.bin_chunk
            else:
                self._buffers[index] = self._uri(uri)
        return self._buffers[index]

    def accessor(self, index: int) -> np.ndarray:
        """An accessor as a (count, components) array of its component
        type, or float32 when it is normalized (reference: GltfLoader.mm
        accessors :359-513)."""
        acc = self.doc["accessors"][index]
        count = acc["count"]
        n_comp = _TYPE_COUNTS[acc["type"]]
        dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]])
        if "bufferView" not in acc:
            out = np.zeros((count, n_comp), dtype)
        else:
            view = self.doc["bufferViews"][acc["bufferView"]]
            data = self.buffer(view["buffer"])
            start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = view.get("byteStride") or n_comp * dtype.itemsize
            out = np.ndarray((count, n_comp), dtype, buffer=data,
                             offset=start,
                             strides=(stride, dtype.itemsize)).copy()
        sparse = acc.get("sparse")
        if sparse:
            sc = sparse["count"]

            def block(spec, dt, n):
                view = self.doc["bufferViews"][spec["bufferView"]]
                return np.frombuffer(
                    self.buffer(view["buffer"]), dt, n,
                    view.get("byteOffset", 0) + spec.get("byteOffset", 0))

            indices = block(sparse["indices"], _COMPONENT_DTYPES[
                sparse["indices"]["componentType"]], sc)
            out[indices] = block(sparse["values"], dtype,
                                 sc * n_comp).reshape(sc, n_comp)
        if acc.get("normalized") and dtype != np.float32:
            info = np.iinfo(dtype)
            out = out.astype(np.float32) / float(info.max)
            if info.min < 0:
                out = np.maximum(out, -1.0)
        return out

    def image_bytes(self, index: int) -> bytes:
        img = self.doc["images"][index]
        if "uri" in img:
            return self._uri(img["uri"])
        view = self.doc["bufferViews"][img["bufferView"]]
        start = view.get("byteOffset", 0)
        return self.buffer(view["buffer"])[start:start + view["byteLength"]]


def _node_matrix(node: dict) -> np.ndarray:
    """A node's local 4x4 matrix, float64 (reference: GltfLoader.mm
    :219-269)."""
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    t = node.get("translation", [0, 0, 0])
    x, y, z, w = node.get("rotation", [0, 0, 0, 1])
    s = node.get("scale", [1, 1, 1])
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])
    m = np.eye(4)
    m[:3, :3] = rot @ np.diag(s)
    m[:3, 3] = t
    return m


def _tex_transform(ext: Optional[dict]) -> np.ndarray:
    """KHR_texture_transform as 2x3 affine rows, uv' = offset +
    R(-rotation) S uv (reference: GltfLoader.mm :323-350, 615-632)."""
    m = np.zeros((2, 3), np.float32)
    m[0, 0] = m[1, 1] = 1.0
    if not ext:
        return m
    offset = ext.get("offset", [0.0, 0.0])
    rotation = ext.get("rotation", 0.0)
    scale = ext.get("scale", [1.0, 1.0])
    cos_r, sin_r = np.cos(rotation), np.sin(rotation)
    m[0] = (cos_r * scale[0], sin_r * scale[1], offset[0])
    m[1] = (-sin_r * scale[0], cos_r * scale[1], offset[1])
    return m


def _material(spec: dict, key: int, settings, load_texture) -> Material:
    """A glTF material as a PBR ``Material`` (reference: GltfLoader.mm
    :650-791); ``load_texture(index, srgb)`` registers a texture."""
    pbr = spec.get("pbrMetallicRoughness", {})
    ext = spec.get("extensions", {})
    base_factor = pbr.get("baseColorFactor", [1, 1, 1, 1])
    roughness = pbr.get("roughnessFactor", 1.0)
    strength = ext.get("KHR_materials_emissive_strength", {}).get(
        "emissiveStrength", 1.0)
    emissive_scale = getattr(settings, "gltfEmissiveScale", 1.0)
    emissive = [e * strength * emissive_scale
                for e in spec.get("emissiveFactor", [0, 0, 0])]
    transmission_ext = ext.get("KHR_materials_transmission", {})
    transmission = transmission_ext.get("transmissionFactor", 0.0)
    volume = ext.get("KHR_materials_volume", {})
    thickness = volume.get("thicknessFactor", 0.0)
    sigma_a = (0.0, 0.0, 0.0)
    if volume and volume.get("attenuationDistance", 0.0) > 0.0:
        # sigma_a = -ln(colour) / distance (reference :599-614)
        dist = volume["attenuationDistance"]
        sigma_a = tuple(max(-np.log(max(c, 1e-4)) / dist, 0.0)
                        for c in volume.get("attenuationColor", [1, 1, 1]))
    thin = transmission > 0.0 and thickness <= 0.0 \
        and getattr(settings, "gltfThinWalledFallback", True)

    tex_idx, uv_set = [-1] * 6, [0] * 6
    transforms = np.zeros((6, 2, 3), np.float32)
    transforms[:, 0, 0] = transforms[:, 1, 1] = 1.0

    def wire(slot, info, srgb):
        if not info:
            return
        tex_idx[slot] = load_texture(info["index"], srgb)
        uv_set[slot] = info.get("texCoord", 0)
        transforms[slot] = _tex_transform(
            info.get("extensions", {}).get("KHR_texture_transform"))

    wire(SLOT_BASE, pbr.get("baseColorTexture"),
         not getattr(settings, "gltfCompatForceLinearBaseColor", False))
    wire(SLOT_MR, pbr.get("metallicRoughnessTexture"), False)
    wire(SLOT_NORMAL, spec.get("normalTexture"), False)
    wire(SLOT_OCCLUSION, spec.get("occlusionTexture"), False)
    wire(SLOT_EMISSIVE, spec.get("emissiveTexture"),
         not getattr(settings, "gltfCompatForceLinearEmissive", False))
    wire(SLOT_TRANSMISSION, transmission_ext.get("transmissionTexture"),
         False)
    return Material(
        base_color=tuple(base_factor[:3]), roughness=roughness,
        mat_type=C.MATERIAL_PBR,
        ior=ext.get("KHR_materials_ior", {}).get("ior", 1.5),
        emission=tuple(emissive), dielectric_sigma_a=sigma_a, thin=thin,
        name=spec.get("name", f"gltf_mat_{key}"),
        pbr_metallic=pbr.get("metallicFactor", 1.0),
        pbr_roughness=roughness,
        pbr_occlusion_strength=(spec.get("occlusionTexture") or {}).get(
            "strength", 1.0),
        pbr_normal_scale=(spec.get("normalTexture") or {}).get("scale", 1.0),
        pbr_alpha=base_factor[3] if len(base_factor) > 3 else 1.0,
        pbr_alpha_cutoff=spec.get("alphaCutoff", 0.5),
        pbr_transmission=transmission,
        pbr_alpha_mode={"OPAQUE": 0, "MASK": 1, "BLEND": 2}.get(
            spec.get("alphaMode", "OPAQUE"), 0),
        pbr_double_sided=spec.get("doubleSided", False),
        pbr_thickness=thickness, texture_indices=tuple(tex_idx),
        texture_uv_set=tuple(uv_set), texture_transform=transforms)


def _primitive_mesh(gltf: GltfFile, prim: dict, world: np.ndarray,
                    name: str, material: int) -> Mesh:
    """One triangle primitive in world space: normals through the inverse
    transpose, tangents through the matrix, both renormalised; flat
    normals summed per vertex when it has none, tangents generated when
    it has none but has UVs."""
    from metal_pathtracer_tpu_torch.scene.tangent import generate_tangents

    attrs = prim["attributes"]
    pos = gltf.accessor(attrs["POSITION"]).astype(np.float32)
    n = len(pos)

    def attr(key, width):
        return gltf.accessor(attrs[key]).astype(np.float32) \
            if key in attrs else np.zeros((n, width), np.float32)

    normals, uv0, uv1 = attr("NORMAL", 3), attr("TEXCOORD_0", 2), \
        attr("TEXCOORD_1", 2)
    tangents = attr("TANGENT", 4)
    idx = gltf.accessor(prim["indices"]).reshape(-1).astype(np.int64) \
        if "indices" in prim else np.arange(n, dtype=np.int64)
    faces = idx.reshape(-1, 3).astype(np.int32)

    wpos = (pos @ world[:3, :3].T + world[:3, 3]).astype(np.float32)
    wnrm = normals @ np.linalg.inv(world[:3, :3]).T.T
    ln = np.linalg.norm(wnrm, axis=-1, keepdims=True)
    wnrm = np.where(ln > 0, wnrm / np.maximum(ln, 1e-20),
                    wnrm).astype(np.float32)
    wtan = tangents.copy()
    wtan[:, :3] = tangents[:, :3] @ world[:3, :3].T
    tl = np.linalg.norm(wtan[:, :3], axis=-1, keepdims=True)
    wtan[:, :3] = np.where(tl > 0, wtan[:, :3] / np.maximum(tl, 1e-20),
                           wtan[:, :3])
    if np.linalg.norm(normals).sum() == 0:
        # flat normals (reference: ApplyFallbackNormals)
        fn = np.cross(wpos[faces[:, 1]] - wpos[faces[:, 0]],
                      wpos[faces[:, 2]] - wpos[faces[:, 0]])
        for c in range(3):
            np.add.at(wnrm, faces[:, c], fn)
        l2 = np.linalg.norm(wnrm, axis=-1, keepdims=True)
        wnrm = np.where(l2 > 0, wnrm / np.maximum(l2, 1e-20), wnrm)
    if np.abs(tangents).sum() == 0 and np.abs(uv0).sum() != 0:
        wtan = generate_tangents(wpos, wnrm.astype(np.float32), uv0, faces)
    return Mesh(name=name, vertices=wpos, normals=wnrm.astype(np.float32),
                uv0=uv0, uv1=uv1, tangents=wtan.astype(np.float32),
                indices=faces, material=material)


def _import_camera(settings, resources, world, cam) -> None:
    """A perspective camera node as the orbit camera: aimed at the centre
    of the meshes' bounds (reference: GltfCameraInfo, GltfLoader.h:11-23)."""
    if cam.get("type") != "perspective":
        return
    eye, forward = world[:3, 3], -world[:3, 2]
    if resources.meshes:
        lo = np.min([me.vertices.min(0) for me in resources.meshes], 0)
        hi = np.max([me.vertices.max(0) for me in resources.meshes], 0)
        target = (lo + hi) / 2
    else:
        target = eye + forward
    offset = eye - target
    dist = float(np.linalg.norm(offset))
    settings.cameraTarget = tuple(float(v) for v in target)
    settings.cameraDistance = max(dist, 0.1)
    settings.cameraYaw = float(np.arctan2(offset[2], offset[0]))
    settings.cameraPitch = float(np.arcsin(
        np.clip(offset[1] / max(dist, 1e-6), -1, 1)))
    settings.cameraVerticalFov = float(np.degrees(
        cam["perspective"].get("yfov", 0.8)))


def load_gltf_into(path: str, settings, resources: SceneResources,
                   root_transform: np.ndarray,
                   allow_camera_import: bool = False) -> None:
    """Load a glTF or GLB file's default scene into ``resources``, under
    ``root_transform``: each triangle primitive becomes a world-space
    mesh with a PBR material, each (image, colour space) one texture;
    with ``allow_camera_import``, the first camera node sets the camera."""
    gltf = GltfFile(path)
    doc = gltf.doc
    textures: Dict[Tuple[int, bool], int] = {}

    def load_texture(tex_index: int, srgb: bool) -> int:
        tex = doc["textures"][tex_index]
        sampler = doc["samplers"][tex.get("sampler", 0)] \
            if doc.get("samplers") else {}
        key = (tex["source"], srgb)
        if key not in textures:
            resources.texture_images.append(
                decode_png(gltf.image_bytes(tex["source"])))
            resources.texture_srgb.append(srgb)
            resources.texture_wrap.append(
                (_WRAP.get(sampler.get("wrapS", 10497), 0),
                 _WRAP.get(sampler.get("wrapT", 10497), 0)))
            textures[key] = len(resources.texture_images) - 1
        return textures[key]

    materials: Dict[int, int] = {}

    def material(mi: Optional[int]) -> int:
        key = -1 if mi is None else mi
        if key not in materials:
            spec = doc.get("materials", [])[mi] if mi is not None else {}
            materials[key] = resources.add_material(
                _material(spec, key, settings, load_texture))
        return materials[key]

    camera = {}

    def walk(node_index: int, parent: np.ndarray):
        node = doc["nodes"][node_index]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            name = node.get("name", f"node{node_index}")
            for prim in doc["meshes"][node["mesh"]].get("primitives", []):
                if prim.get("mode", 4) == 4:   # triangles only
                    mat = material(prim.get("material"))
                    resources.add_mesh(_primitive_mesh(gltf, prim, world,
                                                       name, mat))
        if "camera" in node and allow_camera_import and not camera:
            camera["matrix"] = world
            camera["camera"] = doc["cameras"][node["camera"]]
        for child in node.get("children", []):
            walk(child, world)

    scenes = doc.get("scenes", [{"nodes": list(range(len(doc.get("nodes",
                                                                   []))))}])
    for root in scenes[doc.get("scene", 0)].get("nodes", []):
        walk(root, root_transform.astype(np.float64))
    if camera and allow_camera_import:
        _import_camera(settings, resources, camera["matrix"],
                       camera["camera"])
