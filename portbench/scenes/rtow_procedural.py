"""Upstream's default scene: the final scene of *Ray Tracing in One
Weekend* as ``buildProceduralScene`` builds it (upstream
``src/MetalRenderer.mm:1997-2126``).

A lambert ground sphere (radius 1000, albedo 0.5), then for a, b in
[-11, 11) a sphere of radius 0.2 at (a + 0.9 xi, 0.2, b + 0.9 xi) unless
it touches one already placed or one of the three reserved large spheres,
kept with an occupancy that falls from 0.9 to 0.6 along z; 80 % lambert
(albedo xi * xi a channel), 15 % metal (albedo U(0.5, 1), roughness
U(0, 0.5)), 5 % the one shared glass (IOR 1.5); then the three spheres of
radius 1: glass, lambert (0.4, 0.2, 0.1), metal (0.7, 0.6, 0.5). Upstream
draws from ``std::mt19937(42)``; Python's Mersenne Twister seeded with 42
stands in, in the same draw order (the configuration lists it under
``assumed``). The counts stop at upstream's caps of 512 spheres and 512
materials less the three reserved.
"""

from __future__ import annotations

import math
import random

import numpy as np

from portbench.scenegen import SceneSpec

MAX_SPHERES = 512
MAX_MATERIALS = 512
RESERVED = (((0.0, 1.0, 0.0), 1.0), ((-4.0, 1.0, 0.0), 1.0),
            ((4.0, 1.0, 0.0), 1.0))


def build(config: dict) -> SceneSpec:
    rand = random.Random(int(config["scene_seed"])).random
    materials, spheres, sphere_material = [], [], []

    def material(kind, albedo, roughness=0.0, ior=1.0):
        materials.append(dict(mat_type=kind, base_color=list(albedo),
                              roughness=roughness, ior=ior))
        return len(materials) - 1

    def touches(center, radius):
        for c, r in [(s[:3], s[3]) for s in spheres if s[3] <= 900.0] \
                + list(RESERVED):
            if math.dist(center, c) < radius + r + 1e-3:
                return True
        return False

    def sphere(center, radius, mat):
        spheres.append((*center, radius))
        sphere_material.append(mat)

    sphere((0.0, -1000.0, 0.0), 1000.0,
           material("LAMBERTIAN", (0.5, 0.5, 0.5)))
    glass = material("DIELECTRIC", (1.0, 1.0, 1.0), ior=1.5)
    for a in range(-11, 11):
        for b in range(-11, 11):
            if len(spheres) >= MAX_SPHERES - 3 \
                    or len(materials) >= MAX_MATERIALS - 3:
                break
            center = (a + 0.9 * rand(), 0.2, b + 0.9 * rand())
            if touches(center, 0.2):
                continue
            z = min(max((center[2] + 11.0) / 22.0, 0.0), 1.0)
            if rand() > 0.9 - (0.9 - 0.6) * z:
                continue
            choose = rand()
            if choose < 0.8:
                mat = material("LAMBERTIAN", (rand() * rand(), rand() * rand(),
                                              rand() * rand()))
            elif choose < 0.95:
                albedo = tuple(0.5 + 0.5 * rand() for _ in range(3))
                mat = material("METAL", albedo, roughness=0.5 * rand())
            else:
                mat = glass
            sphere(center, 0.2, mat)
    big_lambert = material("LAMBERTIAN", (0.4, 0.2, 0.1))
    big_metal = material("METAL", (0.7, 0.6, 0.5))
    sphere((0.0, 1.0, 0.0), 1.0, glass)
    sphere((-4.0, 1.0, 0.0), 1.0, big_lambert)
    sphere((4.0, 1.0, 0.0), 1.0, big_metal)
    return SceneSpec(settings=dict(config["settings"]), materials=materials,
                     spheres=np.asarray(spheres, np.float64),
                     sphere_material=np.asarray(sphere_material, np.int32))
