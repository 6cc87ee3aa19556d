"""PLY loader, ascii and binary of either endianness (``scene/ply.py``
twin).

The reference reads PLY through tinyply (reference:
src/renderer/SceneManager.mm LoadPlyMesh:223-519): vertex x/y/z, with
nx/ny/nz and s/t or u/v when present, and the faces' vertex_indices
lists, fan-triangulated; flat normals averaged per vertex when the file
has none. Binary bodies are read with ``np.frombuffer`` over the
header's types: the vertex block as one record array, and a face block
whose lists all have one length (a triangle or a quad mesh) as another,
so a mesh of a million triangles loads in about a second; faces of
varying length are read one by one.
"""

from __future__ import annotations

import struct

import numpy as np

from metal_pathtracer_tpu_torch.scene.obj import transform_mesh
from metal_pathtracer_tpu_torch.scene.resources import Mesh

_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}
_INDEX_NAMES = ("vertex_indices", "vertex_index")


def _header(data: bytes, path: str):
    """(format, [(element, count, [(property, type, list count type or
    None)])], body)."""
    if not data.startswith(b"ply"):
        raise ValueError(f"not a PLY file: {path}")
    end = data.index(b"end_header\n") + len(b"end_header\n")
    fmt, elements = "ascii", []
    for line in data[:end].decode("ascii", errors="replace").splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], parts[3], parts[2]))
            else:
                elements[-1][2].append((parts[2], parts[1], None))
    return fmt, elements, data[end:]


def _read_ascii(body: bytes, elements):
    tokens = body.decode("ascii", errors="replace").split()
    pos, verts, faces = 0, {}, []
    for name, count, props in elements:
        if name == "vertex":
            cols = {p[0]: [] for p in props}
            for _ in range(count):
                for pname, _t, _l in props:
                    cols[pname].append(float(tokens[pos]))
                    pos += 1
            verts = {k: np.asarray(v, np.float32) for k, v in cols.items()}
            continue
        for _ in range(count):
            for pname, _t, ltype in props:
                if ltype is None:
                    pos += 1
                    continue
                n = int(tokens[pos])
                if name == "face" and pname in _INDEX_NAMES:
                    faces.append([int(tokens[pos + 1 + k])
                                  for k in range(n)])
                pos += 1 + n
    return verts, faces


def _uniform_lists(body, off, count, props, endian):
    """The record array of a binary element whose lists all have the
    length of its first record's, or None when they do not."""
    fields, cur = [], off
    for pname, ptype, ltype in props:
        if ltype is None:
            fields.append((pname, endian + _TYPES[ptype][0]))
            cur += _TYPES[ptype][1]
            continue
        lc, lsz = _TYPES[ltype]
        (n,) = struct.unpack_from(endian + lc, body, cur)
        fields.append((pname + "#n", endian + lc))
        fields.append((pname, endian + _TYPES[ptype][0], (n,)))
        cur += lsz + n * _TYPES[ptype][1]
    dtype = np.dtype(fields)
    if off + dtype.itemsize * count > len(body):
        return None
    arr = np.frombuffer(body, dtype, count, off)
    for pname, _t, ltype in props:
        if ltype is not None and not (arr[pname + "#n"]
                                      == arr[pname].shape[1]).all():
            return None
    return arr


def _read_binary(body: bytes, elements, endian: str):
    off, verts, faces = 0, {}, []
    for name, count, props in elements:
        if name == "vertex" and all(p[2] is None for p in props):
            dtype = np.dtype([(p[0], endian + _TYPES[p[1]][0])
                              for p in props])
            arr = np.frombuffer(body, dtype, count, off)
            off += dtype.itemsize * count
            verts = {p[0]: arr[p[0]].astype(np.float32) for p in props}
            continue
        arr = _uniform_lists(body, off, count, props, endian) if count \
            else None
        if arr is not None:
            off += arr.dtype.itemsize * count
            ids = [p[0] for p in props if p[2] is not None
                   and p[0] in _INDEX_NAMES]
            if name == "face" and ids:
                faces.append(arr[ids[-1]].astype(np.int64))
            continue
        for _ in range(count):
            face_ids = None
            for pname, ptype, ltype in props:
                if ltype is None:
                    off += _TYPES[ptype][1]
                    continue
                lc, lsz = _TYPES[ltype]
                (n,) = struct.unpack_from(endian + lc, body, off)
                off += lsz
                ic, isz = _TYPES[ptype]
                got = struct.unpack_from(endian + ic * n, body, off)
                off += isz * n
                if pname in _INDEX_NAMES:
                    face_ids = list(got)
            if name == "face" and face_ids is not None:
                faces.append(face_ids)
    return verts, faces


def _triangulate(faces) -> np.ndarray:
    """Triangle fans (v0, vk, vk+1) of each face, in face order; an entry
    of ``faces`` is one face's index list or an (F, n) block of faces of
    one length."""
    parts, loose = [], []
    for face in faces:
        if not isinstance(face, np.ndarray):
            loose.extend((face[0], face[k], face[k + 1])
                         for k in range(1, len(face) - 1))
            continue
        if loose:
            parts.append(np.asarray(loose, np.int64))
            loose = []
        n = face.shape[1]
        if n >= 3:
            parts.append(np.stack([np.repeat(face[:, :1], n - 2, 1),
                                   face[:, 1:-1], face[:, 2:]],
                                  -1).reshape(-1, 3))
    if loose:
        parts.append(np.asarray(loose, np.int64))
    if not parts:
        return np.zeros((0, 3), np.int32)
    return np.concatenate(parts).astype(np.int32)


def load_ply_raw(path: str):
    """(positions (V,3), normals (V,3), uvs (V,2), faces (F,3) int32) of a
    PLY file."""
    with open(path, "rb") as f:
        data = f.read()
    fmt, elements, body = _header(data, path)
    if fmt == "ascii":
        verts, faces = _read_ascii(body, elements)
    else:
        verts, faces = _read_binary(body, elements,
                                    "<" if "little" in fmt else ">")
    if "x" not in verts:
        raise ValueError(f"PLY file has no vertex positions: {path}")
    pos = np.stack([verts["x"], verts["y"], verts["z"]], -1)
    if "nx" in verts:
        nrm = np.stack([verts["nx"], verts["ny"], verts["nz"]], -1)
    else:
        nrm = np.zeros_like(pos)
    if "s" in verts:
        uv = np.stack([verts["s"], verts["t"]], -1)
    elif "u" in verts:
        uv = np.stack([verts["u"], verts["v"]], -1)
    else:
        uv = np.zeros((len(pos), 2), np.float32)
    idx = _triangulate(faces)
    if idx.size == 0:
        raise ValueError(f"PLY file contains no faces: {path}")
    if np.linalg.norm(nrm, axis=-1).max() <= 0.0:
        # flat face normals summed per vertex, then normalised
        nrm = np.zeros_like(pos)
        fn = np.cross(pos[idx[:, 1]] - pos[idx[:, 0]],
                      pos[idx[:, 2]] - pos[idx[:, 0]])
        ln = np.linalg.norm(fn, axis=-1, keepdims=True)
        fn = np.where(ln > 0, fn / np.maximum(ln, 1e-30), fn)
        for c in range(3):
            np.add.at(nrm, idx[:, c], fn)
        ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
        nrm = np.where(ln > 0, nrm / np.maximum(ln, 1e-30), nrm)
    return (pos.astype(np.float32), nrm.astype(np.float32),
            uv.astype(np.float32), idx)


def load_ply(path: str, name: str = "", material: int = 0,
             transform: np.ndarray = None) -> Mesh:
    """A PLY file as one mesh, through ``transform`` if given."""
    pos, nrm, uv, idx = load_ply_raw(path)
    if transform is not None:
        pos, nrm = transform_mesh(pos, nrm, transform)
    return Mesh(name=name or path, vertices=pos, normals=nrm, uv0=uv,
                uv1=np.zeros_like(uv),
                tangents=np.zeros((len(pos), 4), np.float32), indices=idx,
                material=material)
