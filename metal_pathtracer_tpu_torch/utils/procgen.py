"""Procedural benchmark geometry: the JAX package's displaced icosphere
(``utils/procgen.py dragon_class_mesh``, numpy only) as a port ``Mesh``."""

from __future__ import annotations

import numpy as np

from metal_pathtracer_tpu.utils.procgen import dragon_class_mesh
from metal_pathtracer_tpu_torch.scene.resources import Mesh


def dragon_class_scene_mesh(subdivisions: int = 6, material: int = 0) -> Mesh:
    """20 * 4^subdivisions triangles (327,680 at 7)."""
    pos, normals, faces = dragon_class_mesh(subdivisions)
    uv = np.zeros((len(pos), 2), np.float32)
    return Mesh(name=f"dragon-class-{subdivisions}", vertices=pos,
                normals=normals, uv0=uv, uv1=uv.copy(),
                tangents=np.zeros((len(pos), 4), np.float32),
                indices=faces, material=material)
