"""Scene generation from a configuration file (plain Python and numpy).

A configuration (``portbench/configs/<name>.json``) names its generator,
a module of ``portbench/scenes/`` found by that name. The generators are
kept here, apart from the program, so that a change to the program cannot
change the benchmark's inputs. ``build_spec`` gives the scene as plain
data that the harness hands to the port through its public scene API
(``apply``) and to the reference alike.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np


@dataclasses.dataclass
class SceneSpec:
    """A scene as plain data: the settings the configuration fixes
    (camera, background, path and clamp settings, by the upstream
    ``RenderSettings`` names), the material rows (``mat_type`` by name,
    base colour, roughness, IOR) and the spheres (centre and radius, and
    each one's material)."""

    settings: dict
    materials: list
    spheres: np.ndarray          # (S, 4) float64
    sphere_material: np.ndarray  # (S,) int32

    @property
    def counts(self) -> dict:
        return {"spheres": len(self.spheres),
                "materials": len(self.materials)}


def build_spec(config: dict) -> SceneSpec:
    """The scene of a configuration file, generated."""
    module = importlib.import_module(f"portbench.scenes.{config['generator']}")
    return module.build(config)


def apply(spec: SceneSpec, traffic: dict, seed: int, api) -> tuple:
    """The scene through the port's public scene API (``api``: a namespace
    with ``RenderSettings``, ``BackgroundMode``, ``Material``,
    ``SceneResources`` and ``constants``): (settings, resources). The
    traffic fixes the frame and the depth, ``seed`` the render's RNG seed
    (``fixedRngSeed``, its low 32 bits: the seed is an unsigned 32-bit
    word in the reference's recipe too)."""
    settings = api.RenderSettings()
    for k, v in spec.settings.items():
        if k == "backgroundMode":
            v = getattr(api.BackgroundMode, v)
        elif isinstance(v, list):
            v = tuple(v)
        if not hasattr(settings, k):
            raise KeyError(f"the port's RenderSettings has no {k!r}")
        setattr(settings, k, v)
    settings.maxDepth = traffic["max_depth"]
    settings.fixedRngSeed = seed32(seed)
    settings.renderWidth, settings.renderHeight = (traffic["width"],
                                                   traffic["height"])
    res = api.SceneResources()
    for m in spec.materials:
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in m.items()}
        kw["mat_type"] = getattr(api.constants, "MATERIAL_" + kw["mat_type"])
        res.add_material(api.Material(**kw))
    for s, mat in zip(spec.spheres.tolist(), spec.sphere_material.tolist()):
        res.add_sphere(s[:3], s[3], mat)
    return settings, res


def seed32(seed: int) -> int:
    """The render seed: ``--seed``'s low 32 bits."""
    return int(seed) & 0xFFFFFFFF
