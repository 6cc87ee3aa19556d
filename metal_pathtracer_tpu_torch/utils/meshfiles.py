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
    index into ``materials``, glTF material objects), ``images`` (PNG or
    JPEG bytes, texture k samples image k with the default sampler) and
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
        doc["images"] = [{"bufferView": b.view(img), "mimeType":
                          "image/jpeg" if img[:3] == b"\xff\xd8\xff"
                          else "image/png"} for img in images]
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


#: ``mesh_files.scene`` but its GLB: the headline's camera, depth, seed
#: and sky, the displaced icosphere PLY and the glass icosphere OBJ
MESH_FILES_HEAD = (
    "camera target=0,-0.1,0 distance=4.2 yaw=0.4 pitch=0.18 vfov=40\n"
    "renderer maxDepth=8 seed=1234\n"
    "background env=./sky.exr\n"
    "material type=lambert albedo=0.72,0.68,0.62 name=dragon\n"
    "material type=glass ior=1.5 sigmaA=0.08,0.02,0.02 name=glass\n"
    "mesh path=dragon.ply material=dragon\n"
    "mesh path=glass.obj material=glass\n")


#: the instanced-headline cell's placements of the displaced icosphere
#: (translate, rotate in degrees, uniform scale: each resting on the
#: ground) and of the glass icosphere (translate only; the OBJ holds it
#: where the headline has it)
INSTANCED_DRAGONS = (((-2.31, -0.55, 0.03), (0, 40, 0), 0.6),
                     ((-0.95, -0.38, -0.87), (0, -25, 0), 0.8),
                     ((0.49, -0.6, -1.72), (10, 110, 0), 0.55))
INSTANCED_GLASS = ((0.0, 0.0, 0.0), (2.67, 0.0, -1.32))


#: the instanced-grid cell: the displaced icosphere 8x8 at scale 0.25
#: (0.55 apart, resting on the ground, each with a yaw drawn from this
#: seed) and the glass icosphere 4x4 at scale 0.25 in the gaps between
INSTANCED_GRID_SEED = 16
GRID_STEP, GRID_ORIGIN, GRID_SCALE = 0.55, (-1.925, -2.2), 0.25
#: the glass icosphere's centre in the OBJ (the headline's glass sphere)
GLASS_CENTRE = (-1.55, -0.45, 0.95)


def _grid_lines():
    rng = np.random.default_rng(INSTANCED_GRID_SEED)
    x0, z0 = GRID_ORIGIN
    lines = []
    for i in range(8):
        for j in range(8):
            lines.append(
                "mesh path=dragon.ply material=dragon instanced=1 "
                f"translate={x0 + GRID_STEP * i:.4f},-0.86,"
                f"{z0 + GRID_STEP * j:.4f} rotate=0,"
                f"{rng.uniform(0.0, 360.0):.3f},0 scale={GRID_SCALE}")
    cx, cy, cz = GLASS_CENTRE
    for a in range(4):
        for b in range(4):
            x = x0 + GRID_STEP * (2 * a + 0.5) - GRID_SCALE * cx
            z = z0 + GRID_STEP * (2 * b + 0.5) - GRID_SCALE * cz
            y = -1.08 + 0.62 * GRID_SCALE - GRID_SCALE * cy
            lines.append("mesh path=glass.obj material=glass instanced=1 "
                         f"translate={x:.4f},{y:.4f},{z:.4f} "
                         f"scale={GRID_SCALE}")
    return lines


def instanced_scene_text(lambert: bool = False,
                         variant: str = "headline") -> str:
    """The ``.scene`` of an instanced cell, beside the files
    ``write_headline_files`` writes, with the headline's camera and sky:
    ``headline``, the displaced icosphere PLY placed three times and the
    glass icosphere OBJ twice with ``instanced=1``, the GLB's checker
    sphere and ground as the soup; ``grid``, the same soup with the PLY
    placed 64 times (an 8x8 grid at scale 0.25, a seeded yaw each) and
    the OBJ 16 times, one triangle store a source; ``tie``, the OBJ
    placed twice with the same transform and nothing else, so that every
    hit ties. ``lambert``: every placement lambert and the gradient sky
    instead of the EXR (the depth loop without a light integral: K2
    ``full``)."""
    lines = ["camera target=0,-0.1,-0.3 distance=4.6 yaw=0.4 pitch=0.18 "
             "vfov=42", "renderer maxDepth=8 seed=1234"]
    if lambert:
        lines += ["material type=lambert albedo=0.72,0.68,0.62 name=dragon",
                  "material type=lambert albedo=0.5,0.6,0.75 name=glass"]
    else:
        lines += ["background env=./sky.exr",
                  "material type=lambert albedo=0.72,0.68,0.62 name=dragon",
                  "material type=glass ior=1.5 sigmaA=0.08,0.02,0.02 "
                  "name=glass"]
    if variant == "tie":
        return "\n".join(lines + ["mesh path=glass.obj material=glass "
                                   "instanced=1"] * 2) + "\n"
    lines.append("mesh path=props.glb")
    if variant == "grid":
        return "\n".join(lines + _grid_lines()) + "\n"
    for (t, r, sc) in INSTANCED_DRAGONS:
        lines.append("mesh path=dragon.ply material=dragon instanced=1 "
                     f"translate={t[0]},{t[1]},{t[2]} "
                     f"rotate={r[0]},{r[1]},{r[2]} scale={sc}")
    for t in INSTANCED_GLASS:
        lines.append("mesh path=glass.obj material=glass instanced=1 "
                     f"translate={t[0]},{t[1]},{t[2]}")
    return "\n".join(lines) + "\n"


def write_headline_files(directory: str, subdivisions: int = 8,
                         device="cuda"):
    """The headline scene (``benchscene.build_bench_scene``) as files in
    ``directory``: the displaced icosphere as binary PLY, the glass
    icosphere as OBJ, the checker sphere and the ground as a GLB (the
    checker an embedded PNG from ``image_io.encode_png_u8``; the ground a
    PBR material with a 200x120 metallic-roughness texture, which the
    atlas resamples), the HDR sky as an EXR, ``mesh_files.scene`` with
    the headline's camera and ``mesh`` records, and the instanced cells'
    ``instanced_headline.scene``, ``instanced_lambert.scene``,
    ``instanced_grid.scene`` and ``instanced_tie.scene``
    (``instanced_scene_text``). Returns (the scene file's path, the
    in-memory meshes)."""
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
        fh.write(MESH_FILES_HEAD + "mesh path=props.glb\n")
    for name, lambert, variant in (
            ("instanced_headline.scene", False, "headline"),
            ("instanced_lambert.scene", True, "headline"),
            ("instanced_grid.scene", False, "grid"),
            ("instanced_tie.scene", False, "tie")):
        with open(os.path.join(directory, name), "w") as fh:
            fh.write(instanced_scene_text(lambert, variant))
    return path, res.meshes


def write_ground_texture_files(directory: str, meshes, image: bytes,
                               stem: str, sky: str = "sky.exr") -> str:
    """The mesh-files scene with a textured ground: ``<stem>.glb`` holds
    the headline's checker sphere and its ground, whose base colour is
    ``image`` (PNG or JPEG bytes, embedded as they are), and
    ``<stem>.scene`` places it beside the PLY and OBJ that
    ``write_headline_files`` wrote into ``directory`` under ``sky`` (a
    file there: by default the EXR sky it wrote); ``meshes`` are the
    meshes it returned. Returns the scene file's path."""
    import dataclasses
    import os

    from metal_pathtracer_tpu_torch.utils import benchscene, image_io

    _, _, checker, ground = meshes
    write_glb(
        os.path.join(directory, f"{stem}.glb"),
        [dataclasses.replace(checker, material=0),
         dataclasses.replace(ground, material=1)],
        [{"name": "checker", "pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0}, "metallicFactor": 0.15,
            "roughnessFactor": 0.35}},
         {"name": "ground-textured", "pbrMetallicRoughness": {
             "baseColorTexture": {"index": 1}, "metallicFactor": 0.0,
             "roughnessFactor": 0.8}}],
        [image_io.encode_png_u8(benchscene.checker_texture()[..., :3]),
         image])
    path = os.path.join(directory, f"{stem}.scene")
    with open(path, "w") as fh:
        fh.write(MESH_FILES_HEAD.replace("./sky.exr", f"./{sky}")
                 + f"mesh path={stem}.glb\n")
    return path
