"""Procedural benchmark geometry (numpy only): the displaced icosphere that
stands in for the Stanford Dragon, and the plain icosphere the bench
scene's props use.

Same vertices, faces and normals as the JAX package's
``utils/procgen.py``, bit for bit: the subdivision is vectorised, but new
vertices are numbered in the order the reference's edge loop first meets
their edges, and each midpoint is normalised with the same 1-D
``np.linalg.norm`` (a BLAS dot whose rounding a vectorised norm does not
reproduce).
"""

from __future__ import annotations

import numpy as np


def _subdivide(verts: np.ndarray, faces: np.ndarray):
    """One 4-to-1 split; midpoints numbered by first use, face by face,
    edges (a,b), (b,c), (c,a)."""
    n_verts = len(verts)
    a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
    ends = np.stack([np.stack([a, b, c], 1), np.stack([b, c, a], 1)], -1)
    ends = ends.reshape(-1, 2)                       # (3F, 2) in call order
    keys = ends.min(1) * n_verts + ends.max(1)
    uniq, first, inverse = np.unique(keys, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first, kind="stable")         # first-use order
    rank = np.empty(len(uniq), np.int64)
    rank[order] = np.arange(len(uniq))
    mid = (n_verts + rank[inverse]).reshape(-1, 3)   # (F, 3): ab, bc, ca
    src = ends[first[order]]
    m = verts[src[:, 0]] + verts[src[:, 1]]
    norms = np.sqrt(np.array([np.dot(r, r) for r in m]))
    verts = np.concatenate([verts, m / norms[:, None]], 0)
    ab, bc, ca = mid[:, 0], mid[:, 1], mid[:, 2]
    new_faces = np.stack([np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
                          np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)],
                         1).reshape(-1, 3)
    return verts, new_faces


def icosphere(subdivisions: int):
    """Subdivided icosahedron: 20 * 4^n triangles. Returns (verts (V,3)
    f64, faces (F,3) i64)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdivisions):
        verts, faces = _subdivide(verts, faces)
    return verts, faces


def _fbm(p: np.ndarray, octaves: int = 5, seed: int = 7) -> np.ndarray:
    """Cheap value-noise fBm over unit-sphere points."""
    rng = np.random.default_rng(seed)
    out = np.zeros(len(p))
    amp = 1.0
    freq = 1.5
    for _ in range(octaves):
        phase = rng.uniform(0, 2 * np.pi, 3)
        dirs = rng.normal(size=(3, 3))
        for k in range(3):
            out += amp * np.sin(freq * (p @ dirs[k]) + phase[k])
        amp *= 0.5
        freq *= 2.03
    return out / 4.0


def dragon_class_mesh(subdivisions: int = 6, seed: int = 7):
    """Displaced icosphere: 20*4^6 = 81,920 tris at n=6; 1.3M at n=8.

    Returns (vertices (V,3) f32, normals (V,3) f32, faces (F,3) i32).
    """
    verts, faces = icosphere(subdivisions)
    disp = 1.0 + 0.25 * _fbm(verts, seed=seed)
    pos = (verts * disp[:, None]).astype(np.float32)

    # area-weighted vertex normals
    normals = np.zeros_like(pos)
    e1 = pos[faces[:, 1]] - pos[faces[:, 0]]
    e2 = pos[faces[:, 2]] - pos[faces[:, 0]]
    fn = np.cross(e1, e2)
    for c in range(3):
        np.add.at(normals, faces[:, c], fn)
    ln = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = (normals / np.maximum(ln, 1e-20)).astype(np.float32)
    return pos, normals, faces.astype(np.int32)


def dragon_class_scene_mesh(subdivisions: int = 6, material: int = 0):
    """The displaced icosphere as a port ``Mesh`` (327,680 triangles at 7)."""
    from metal_pathtracer_tpu_torch.scene.resources import Mesh

    pos, normals, faces = dragon_class_mesh(subdivisions)
    uv = np.zeros((len(pos), 2), np.float32)
    return Mesh(name=f"dragon-class-{subdivisions}", vertices=pos,
                normals=normals, uv0=uv, uv1=uv.copy(),
                tangents=np.zeros((len(pos), 4), np.float32),
                indices=faces, material=material)
