"""The ``mesh`` record of the ``.scene`` DSL (``scene/meshload.py``
twin): OBJ, PLY or glTF/GLB by extension, placed by a TRS transform
(reference: src/renderer/SceneManager.mm parseMesh:2362-2634).
"""

from __future__ import annotations

import math
import os

import numpy as np

from metal_pathtracer_tpu_torch.scene.dsl import (
    SceneParseError,
    parse_float,
    parse_float3,
    parse_uint,
)


def _rotation_matrix(rx: float, ry: float, rz: float) -> np.ndarray:
    """Euler XYZ rotation in degrees, Rz Ry Rx (reference:
    SceneManager.mm TRS compose)."""
    rx, ry, rz = (math.radians(v) for v in (rx, ry, rz))
    cx, sx = math.cos(rx), math.sin(rx)
    cy, sy = math.cos(ry), math.sin(ry)
    cz, sz = math.cos(rz), math.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mz @ my @ mx


def _material(tokens, resources) -> int:
    value = tokens.get("material")
    if value is None:
        return 0
    if value.isdigit():
        material = parse_uint(value)
        if material >= resources.material_count():
            raise SceneParseError("mesh references material index that has "
                                  "not been defined yet")
        return material
    if value in resources.material_names:
        return resources.material_names[value]
    raise SceneParseError(f"mesh references unknown material name: {value}")


def _transform(tokens) -> np.ndarray:
    """T R S (column vectors) from ``translate`` (or ``position``),
    ``rotate`` (degrees) and ``scale`` (one value or three)."""
    translate = (0.0, 0.0, 0.0)
    for key in ("translate", "position"):
        if key in tokens:
            translate = parse_float3(tokens[key])
            break
    rotate = parse_float3(tokens["rotate"]) if "rotate" in tokens \
        else (0.0, 0.0, 0.0)
    scale = (1.0, 1.0, 1.0)
    if "scale" in tokens:
        value = tokens["scale"]
        scale = parse_float3(value) if "," in value \
            else (parse_float(value),) * 3
    tf = np.eye(4)
    tf[:3, :3] = _rotation_matrix(*rotate) @ np.diag(scale)
    tf[:3, 3] = translate
    return tf


def mesh_loader(tokens, settings, resources, allow_camera_import: bool,
                scene_directory: str) -> None:
    """Load a ``mesh path=... [translate= rotate= scale= material= name=
    instanced=]`` record; a relative path is read from
    ``scene_directory``. ``instanced=1`` on an OBJ or PLY file places one
    shared object-space mesh through ``add_mesh_instance`` (every record
    of one path shares the mesh loaded first, so they form one instanced
    group); a glTF file's own materials and camera
    come with it (the camera when no ``camera`` record came first)."""
    path = tokens.get("path") or tokens.get("file")
    if not path:
        raise SceneParseError("mesh requires a path (or file) token")
    if not os.path.isabs(path):
        path = os.path.join(scene_directory or ".", path)
    path = os.path.normpath(path)
    if not os.path.exists(path):
        raise SceneParseError(f"mesh file not found: {path}")
    tf = _transform(tokens)
    material = _material(tokens, resources)
    ext = os.path.splitext(path)[1].lower()
    name = tokens.get("name", os.path.basename(path))
    if ext in (".gltf", ".glb"):
        from metal_pathtracer_tpu_torch.scene.gltf import load_gltf_into
        load_gltf_into(path, settings, resources, tf,
                       allow_camera_import=allow_camera_import)
        return
    if ext == ".obj":
        from metal_pathtracer_tpu_torch.scene.obj import load_obj as load
    elif ext == ".ply":
        from metal_pathtracer_tpu_torch.scene.ply import load_ply as load
    else:
        raise SceneParseError(f"unsupported mesh format: {ext}")
    if tokens.get("instanced", "0") == "1":
        cache = resources.instance_mesh_cache
        if path not in cache:
            cache[path] = load(path, name=name, material=material,
                               transform=np.eye(4))
        resources.add_mesh_instance(cache[path], tf, material)
        return
    resources.add_mesh(load(path, name=name, material=material,
                            transform=tf))
