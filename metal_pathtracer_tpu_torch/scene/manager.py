"""Scene discovery, loading, and the built-in procedural scene
(``scene/manager.py`` twin).

The twin of the reference's SceneManager
(reference: src/renderer/SceneManager.mm:570-905): discovers `.scene` files
under an assets directory (cwd `assets/` by default), loads by name or
path, and provides the procedural RTOW demo scene
(reference: src/MetalRenderer.mm buildProceduralScene:1997-2126).
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional

import numpy as np

from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.scene import dsl
from metal_pathtracer_tpu_torch.scene.resources import Material, SceneResources
from metal_pathtracer_tpu_torch.settings import BackgroundMode, RenderSettings


class SceneManager:
    def __init__(self, scenes_directory: str = ""):
        if scenes_directory:
            self.scene_directory = os.path.abspath(scenes_directory)
        else:
            candidate = os.path.join(os.getcwd(), "assets")
            self.scene_directory = candidate if os.path.isdir(candidate) else ""
        self.scenes: Dict[str, str] = {}
        self.refresh()

    def refresh(self) -> None:
        """Discover `.scene` files (reference: SceneManager.mm discoverScenes)."""
        self.scenes = {}
        if not self.scene_directory or not os.path.isdir(self.scene_directory):
            return
        for root, _dirs, files in os.walk(self.scene_directory):
            for fn in sorted(files):
                if fn.endswith(".scene"):
                    name = os.path.splitext(fn)[0]
                    self.scenes.setdefault(name, os.path.join(root, fn))

    def scene_names(self) -> List[str]:
        return sorted(self.scenes)

    def find_scene(self, name: str) -> Optional[str]:
        return self.scenes.get(name)

    def new_resources(self) -> SceneResources:
        return SceneResources()

    def load_scene_from_path(self, path: str, settings: RenderSettings,
                             resources: SceneResources) -> None:
        """Parse a ``.scene`` file; its ``mesh`` records load their files
        from the scene's directory."""
        dsl.load_scene_file(path, settings, resources)

    def load_scene(self, name: str, settings: RenderSettings,
                   resources: SceneResources) -> None:
        path = self.find_scene(name)
        if path is None:
            raise FileNotFoundError(f"scene not found: {name}")
        self.load_scene_from_path(path, settings, resources)

    def load_default_scene(self, settings: RenderSettings,
                           resources: SceneResources) -> None:
        build_procedural_scene(settings, resources)


def build_procedural_scene(settings: RenderSettings,
                           resources: SceneResources) -> None:
    """The RTOW final-scene sphere field
    (reference: src/MetalRenderer.mm buildProceduralScene:1997-2126).

    Same construction: ground sphere, 22x22 grid of small spheres with
    depth-dependent occupancy, 80/15/5 lambert/metal/glass split, shared
    glass material, three reserved large spheres. The RNG is Python's
    Mersenne Twister seeded with 42 — same generator family as the
    reference's std::mt19937(42); layouts are statistically identical but
    not sphere-for-sphere bit-identical.
    """
    settings.backgroundMode = BackgroundMode.GRADIENT
    settings.backgroundColor = (0.0, 0.0, 0.0)
    settings.environmentMapPath = ""
    settings.environmentRotation = 0.0
    settings.environmentIntensity = 1.0

    rng = random.Random(42)
    rand = rng.random

    def rand_range(lo, hi):
        return lo + (hi - lo) * rand()

    placed = []  # (center, radius)
    reserved = [((0.0, 1.0, 0.0), 1.0), ((-4.0, 1.0, 0.0), 1.0),
                ((4.0, 1.0, 0.0), 1.0)]

    def intersects_existing(center, radius):
        eps = 1e-3
        for (pc, pr) in placed:
            if pr > 900.0:
                continue
            d = np.linalg.norm(np.subtract(center, pc))
            if d < radius + pr + eps:
                return True
        for (rc, rr) in reserved:
            d = np.linalg.norm(np.subtract(center, rc))
            if d < radius + rr + eps:
                return True
        return False

    def add_sphere(center, radius, material):
        resources.add_sphere(center, radius, material)
        placed.append((center, radius))

    ground = resources.add_material(Material(
        base_color=(0.5, 0.5, 0.5), roughness=0.0,
        mat_type=C.MATERIAL_LAMBERTIAN, ior=1.0))
    add_sphere((0.0, -1000.0, 0.0), 1000.0, ground)

    shared_glass = resources.add_material(Material(
        base_color=(1.0, 1.0, 1.0), roughness=0.0,
        mat_type=C.MATERIAL_DIELECTRIC, ior=1.5))

    for a in range(-11, 11):
        for b in range(-11, 11):
            if len(resources.spheres) >= C.MAX_SPHERES - 3 or \
                    resources.material_count() >= C.MAX_MATERIALS - 3:
                break
            center = (a + 0.9 * rand(), 0.2, b + 0.9 * rand())
            if intersects_existing(center, 0.2):
                continue
            normalized_z = min(max((center[2] + 11.0) / 22.0, 0.0), 1.0)
            occupancy = 0.9 - (0.9 - 0.6) * normalized_z
            if rand() > occupancy:
                continue
            choose = rand()
            if choose < 0.8:
                albedo = (rand() * rand(), rand() * rand(), rand() * rand())
                mat = resources.add_material(Material(
                    base_color=albedo, roughness=0.0,
                    mat_type=C.MATERIAL_LAMBERTIAN, ior=1.0))
            elif choose < 0.95:
                albedo = (rand_range(0.5, 1.0), rand_range(0.5, 1.0),
                          rand_range(0.5, 1.0))
                roughness = rand_range(0.0, 0.5)
                mat = resources.add_material(Material(
                    base_color=albedo, roughness=roughness,
                    mat_type=C.MATERIAL_METAL, ior=1.0))
            else:
                mat = shared_glass
            add_sphere(center, 0.2, mat)

    big_lambert = resources.add_material(Material(
        base_color=(0.4, 0.2, 0.1), roughness=0.0,
        mat_type=C.MATERIAL_LAMBERTIAN, ior=1.0))
    big_metal = resources.add_material(Material(
        base_color=(0.7, 0.6, 0.5), roughness=0.0,
        mat_type=C.MATERIAL_METAL, ior=1.0))

    add_sphere((0.0, 1.0, 0.0), 1.0, shared_glass)
    add_sphere((-4.0, 1.0, 0.0), 1.0, big_lambert)
    add_sphere((4.0, 1.0, 0.0), 1.0, big_metal)
