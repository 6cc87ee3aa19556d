"""The bench's lambert series scene (``bench.py:261-280``): one lambert
displaced icosphere under the gradient sky, maxDepth 8, seed 1234."""

from __future__ import annotations

from metal_pathtracer_tpu.settings import RenderSettings
from metal_pathtracer_tpu_torch.scene.resources import Material, SceneResources
from metal_pathtracer_tpu_torch.utils.procgen import dragon_class_scene_mesh


def build_lambert_series(subdivisions: int = 7):
    """Returns (settings, resources); 327,680 triangles at the bench's
    subdivision 7."""
    settings = RenderSettings()
    settings.cameraTarget = (0.0, 0.0, 0.0)
    settings.cameraDistance = 3.2
    settings.cameraYaw = 0.4
    settings.cameraPitch = 0.25
    settings.cameraVerticalFov = 40.0
    settings.maxDepth = 8
    settings.fixedRngSeed = 1234
    resources = SceneResources()
    resources.add_material(Material(base_color=(0.7, 0.7, 0.7)))
    resources.add_mesh(dragon_class_scene_mesh(subdivisions, material=0))
    return settings, resources
