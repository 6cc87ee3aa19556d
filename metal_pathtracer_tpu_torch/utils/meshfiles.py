"""Writers of the mesh files the loaders read: OBJ, PLY and GLB from
in-memory ``Mesh`` objects, so that a test or a benchmark can build a
``.scene`` file with ``mesh`` records from generated geometry (the
repository ships no mesh file).

Each writer keeps the float32 values the loaders give back bit for bit:
OBJ writes each float32 as the shortest decimal of its exact double
(``repr``), which a Python ``float`` reads back exactly; PLY and GLB
store float32 as they are.
"""

from __future__ import annotations

import json
import struct
from typing import List, Optional, Sequence

import numpy as np


def _f(x) -> str:
    return repr(float(x))


def write_obj(path: str, mesh) -> None:
    """``mesh`` as an OBJ file: ``v``, ``vt`` and ``vn`` per vertex and
    one ``f v/vt/vn`` per triangle."""
    lines = ["# written by metal_pathtracer_tpu_torch.utils.meshfiles"]
    lines += [f"v {_f(a)} {_f(b)} {_f(c)}" for a, b, c in
              mesh.vertices.astype(np.float32).tolist()]
    lines += [f"vt {_f(a)} {_f(b)}" for a, b in
              mesh.uv0.astype(np.float32).tolist()]
    lines += [f"vn {_f(a)} {_f(b)} {_f(c)}" for a, b, c in
              mesh.normals.astype(np.float32).tolist()]
    lines += [f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}" for a, b, c in
              (mesh.indices.astype(np.int64) + 1).tolist()]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_ply(path: str, mesh, fmt: str = "binary_little_endian") -> None:
    """``mesh`` as a PLY file (``ascii``, ``binary_little_endian`` or
    ``binary_big_endian``): float x y z nx ny nz u v per vertex, a uchar
    count and int indices per triangle."""
    v = len(mesh.vertices)
    head = ["ply", f"format {fmt} 1.0", f"element vertex {v}"]
    head += [f"property float {p}" for p in
             ("x", "y", "z", "nx", "ny", "nz", "u", "v")]
    head += [f"element face {len(mesh.indices)}",
             "property list uchar int vertex_indices", "end_header"]
    cols = np.concatenate([mesh.vertices, mesh.normals, mesh.uv0],
                          1).astype(np.float32)
    idx = mesh.indices.astype(np.int32)
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode("ascii"))
        if fmt == "ascii":
            f.write("".join(" ".join(_f(x) for x in row) + "\n"
                            for row in cols.tolist()).encode("ascii"))
            f.write("".join(f"3 {a} {b} {c}\n"
                            for a, b, c in idx.tolist()).encode("ascii"))
            return
        e = "<" if fmt == "binary_little_endian" else ">"
        f.write(cols.astype(e + "f4").tobytes())
        faces = np.zeros(len(idx), np.dtype([("n", "u1"),
                                             ("i", e + "i4", (3,))]))
        faces["n"], faces["i"] = 3, idx
        f.write(faces.tobytes())


class _Bin:
    """The BIN chunk of a GLB under construction: buffer views and
    accessors appended to a glTF document."""

    def __init__(self, doc: dict):
        self.doc, self.data = doc, bytearray()
        doc.setdefault("bufferViews", [])
        doc.setdefault("accessors", [])

    def view(self, payload: bytes) -> int:
        self.data += b"\0" * (-len(self.data) % 4)
        self.doc["bufferViews"].append({"buffer": 0,
                                        "byteOffset": len(self.data),
                                        "byteLength": len(payload)})
        self.data += payload
        return len(self.doc["bufferViews"]) - 1

    def accessor(self, arr: np.ndarray, kind: str, component: int) -> int:
        acc = {"bufferView": self.view(np.ascontiguousarray(arr).tobytes()),
               "componentType": component, "count": int(arr.shape[0]),
               "type": kind}
        if component == 5126:
            acc["min"] = arr.min(0).tolist()
            acc["max"] = arr.max(0).tolist()
        self.doc["accessors"].append(acc)
        return len(self.doc["accessors"]) - 1


def gltf_document(meshes: Sequence, materials: Sequence[dict],
                  images: Sequence[bytes] = (),
                  nodes: Optional[List[dict]] = None):
    """(glTF document, its buffer's bytes) of ``meshes`` (one primitive
    each: POSITION, NORMAL, TEXCOORD_0, TEXCOORD_1 when any is non-zero,
    uint32 indices; the primitive's material is ``mesh.material``, an
    index into ``materials``, glTF material objects), ``images`` (PNG
    bytes, texture k samples image k with the default sampler) and
    ``nodes`` (default: one node per mesh at the identity; the nodes no
    other node lists as a child are the scene's roots). The buffer has
    no ``uri``: it is a GLB's BIN chunk unless the caller sets one."""
    doc = {"asset": {"version": "2.0"}, "meshes": [],
           "materials": list(materials)}
    b = _Bin(doc)
    for m in meshes:
        attrs = {"POSITION": b.accessor(m.vertices.astype(np.float32),
                                        "VEC3", 5126),
                 "NORMAL": b.accessor(m.normals.astype(np.float32), "VEC3",
                                      5126),
                 "TEXCOORD_0": b.accessor(m.uv0.astype(np.float32), "VEC2",
                                          5126)}
        if np.any(m.uv1):
            attrs["TEXCOORD_1"] = b.accessor(m.uv1.astype(np.float32),
                                             "VEC2", 5126)
        indices = b.accessor(m.indices.astype(np.uint32).reshape(-1, 1),
                             "SCALAR", 5125)
        doc["meshes"].append({"name": m.name, "primitives": [{
            "attributes": attrs, "indices": indices,
            "material": int(m.material)}]})
    if images:
        doc["images"] = [{"bufferView": b.view(png), "mimeType": "image/png"}
                         for png in images]
        doc["textures"] = [{"source": k} for k in range(len(images))]
    doc["nodes"] = nodes if nodes is not None else \
        [{"mesh": k, "name": m.name} for k, m in enumerate(meshes)]
    children = {c for node in doc["nodes"] for c in node.get("children", [])}
    doc["scenes"] = [{"nodes": [k for k in range(len(doc["nodes"]))
                                if k not in children]}]
    doc["scene"] = 0
    b.data += b"\0" * (-len(b.data) % 4)
    doc["buffers"] = [{"byteLength": len(b.data)}]
    return doc, bytes(b.data)


def glb_bytes(doc: dict, data: bytes) -> bytes:
    """A GLB file: the header, the JSON chunk and the BIN chunk."""
    text = json.dumps(doc).encode("utf-8")
    text += b" " * (-len(text) % 4)
    data = data + b"\0" * (-len(data) % 4)
    body = struct.pack("<II", len(text), 0x4E4F534A) + text \
        + struct.pack("<II", len(data), 0x004E4942) + data
    return struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body


def write_glb(path: str, meshes: Sequence, materials: Sequence[dict],
              images: Sequence[bytes] = (),
              nodes: Optional[List[dict]] = None) -> None:
    """``gltf_document`` of the arguments as a GLB file."""
    with open(path, "wb") as f:
        f.write(glb_bytes(*gltf_document(meshes, materials, images, nodes)))


def write_headline_files(directory: str, subdivisions: int = 8,
                         device="cuda"):
    """The headline scene (``benchscene.build_bench_scene``) as files in
    ``directory``: the displaced icosphere as binary PLY, the glass
    icosphere as OBJ, the checker sphere and the ground as a GLB (the
    checker an embedded PNG from ``image_io.encode_png_u8``; the ground a
    PBR material with a 200x120 metallic-roughness texture, which the
    atlas resamples), the HDR sky as an EXR, and ``mesh_files.scene``
    with the headline's camera and ``mesh`` records. Returns (the scene
    file's path, the in-memory meshes)."""
    import dataclasses
    import os

    from metal_pathtracer_tpu_torch.utils import benchscene, image_io

    _, res, _ = benchscene.build_bench_scene(subdivisions, device)
    dragon, glass, checker, ground = res.meshes
    write_ply(os.path.join(directory, "dragon.ply"), dragon)
    write_obj(os.path.join(directory, "glass.obj"), glass)
    rng = np.random.default_rng(3)
    mr = np.stack([np.zeros((120, 200)), rng.uniform(200, 255, (120, 200)),
                   rng.uniform(0, 40, (120, 200))], -1).astype(np.uint8)
    write_glb(
        os.path.join(directory, "props.glb"),
        [dataclasses.replace(checker, material=0),
         dataclasses.replace(ground, material=1)],
        [{"name": "checker", "pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0}, "metallicFactor": 0.15,
            "roughnessFactor": 0.35}},
         {"name": "ground-pbr", "pbrMetallicRoughness": {
             "baseColorFactor": [0.45, 0.45, 0.48, 1.0],
             "metallicRoughnessTexture": {"index": 1},
             "metallicFactor": 0.5, "roughnessFactor": 1.0}}],
        [image_io.encode_png_u8(benchscene.checker_texture()[..., :3]),
         image_io.encode_png_u8(mr)])
    image_io.write_exr_rgb(os.path.join(directory, "sky.exr"),
                           benchscene.hdr_sky())
    path = os.path.join(directory, "mesh_files.scene")
    with open(path, "w") as fh:
        fh.write("camera target=0,-0.1,0 distance=4.2 yaw=0.4 pitch=0.18 "
                 "vfov=40\n"
                 "renderer maxDepth=8 seed=1234\n"
                 "background env=./sky.exr\n"
                 "material type=lambert albedo=0.72,0.68,0.62 name=dragon\n"
                 "material type=glass ior=1.5 sigmaA=0.08,0.02,0.02 "
                 "name=glass\n"
                 "mesh path=dragon.ply material=dragon\n"
                 "mesh path=glass.obj material=glass\n"
                 "mesh path=props.glb\n")
    return path, res.meshes
