"""Triangle soup assembly and BVH construction (``scene/meshbuild.py``
twin, without the TPU packet BVH).

The BVH comes from the same native binned-SAH builder the JAX package
uses (``native/bvh_builder.cpp``), flattened depth-first with exit links,
so both packages trace the identical tree. There is no numpy fallback: at
the lambert series' 327,680 triangles it would take minutes, and a
different tree would break trace parity.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from metal_pathtracer_tpu_torch.schema import BvhSoA, TrianglesSoA

MAX_LEAF = 4
SAH_BINS = 16


def build_triangle_arrays(meshes, device="cuda"):
    """Merge world-space meshes into SoA triangle arrays plus their BVH.
    Returns (TrianglesSoA, BvhSoA)."""
    cols = {k: [] for k in ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1",
                            "uv2", "uvb0", "uvb1", "uvb2", "t0", "t1", "t2")}
    mats, mesh_ids = [], []
    for mesh_index, mesh in enumerate(meshes):
        idx = mesh.indices.astype(np.int64)
        per_vertex = {"v": mesh.vertices, "n": mesh.normals, "uv": mesh.uv0,
                      "uvb": mesh.uv1, "t": mesh.tangents}
        for key, data in per_vertex.items():
            data = data.astype(np.float32)
            for c in range(3):
                cols[f"{key}{c}"].append(data[idx[:, c]])
        mats.append(np.full(len(idx), mesh.material, np.int32))
        mesh_ids.append(np.full(len(idx), mesh_index, np.int32))

    soup = {k: np.concatenate(v, 0) for k, v in cols.items()}
    mat_arr = np.concatenate(mats)
    mesh_arr = np.concatenate(mesh_ids)
    nodes = build_bvh(soup["v0"], soup["v1"], soup["v2"])

    shade = np.zeros((len(mat_arr), 24), np.float32)
    for c, k in enumerate(("v0", "v1", "v2", "n0", "n1", "n2")):
        shade[:, 3 * c:3 * c + 3] = soup[k]
    shade[:, 18] = mat_arr
    shade[:, 19] = mesh_arr

    t = lambda a: torch.as_tensor(a, device=device)
    tris = TrianglesSoA(material=t(mat_arr), mesh_index=t(mesh_arr),
                        shade_packed=t(shade),
                        **{k: t(v) for k, v in soup.items()})
    bvh = BvhSoA(**{k: t(v) for k, v in nodes.items()})
    return tris, bvh


def _native_lib():
    from metal_pathtracer_tpu_torch.utils.nativebuild import ensure_built

    path = ensure_built("libbvh_builder.so")
    if path is None:
        raise RuntimeError(
            "native/libbvh_builder.so is missing and native/build.sh could "
            "not build it (a C++17 compiler is required)")
    for attempt in range(30):
        try:
            return ctypes.CDLL(path)
        except OSError:
            # another process may be writing the library right now
            if attempt == 29:
                raise
            time.sleep(2.0)


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> dict:
    """Binned-SAH BVH over the soup, flattened depth-first with exit links
    (``meshbuild._flatten_with_exit_links`` layout); numpy arrays keyed
    like ``BvhSoA``'s fields."""
    lib = _native_lib()
    n = v0.shape[0]
    verts = np.ascontiguousarray(np.concatenate(
        [v0.astype(np.float32), v1.astype(np.float32),
         v2.astype(np.float32)], axis=1))  # (n, 9)
    max_nodes = max(2 * n, 1)
    out = {
        "bounds_min": np.zeros((max_nodes, 3), np.float32),
        "bounds_max": np.zeros((max_nodes, 3), np.float32),
        "prim_offset": np.zeros(max_nodes, np.int32),
        "prim_count": np.zeros(max_nodes, np.int32),
        "exit_index": np.zeros(max_nodes, np.int32),
        "prim_indices": np.zeros(n, np.int32),
    }
    fptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    iptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    lib.build_bvh_sah.restype = ctypes.c_int
    n_nodes = lib.build_bvh_sah(
        ctypes.c_int(n), fptr(verts),
        fptr(out["bounds_min"]), fptr(out["bounds_max"]),
        iptr(out["prim_offset"]), iptr(out["prim_count"]),
        iptr(out["exit_index"]), iptr(out["prim_indices"]),
        ctypes.c_int(MAX_LEAF), ctypes.c_int(SAH_BINS))
    if n_nodes <= 0:
        raise RuntimeError("native BVH build failed")
    return {k: (v if k == "prim_indices" else v[:n_nodes])
            for k, v in out.items()}
