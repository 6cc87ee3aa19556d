"""RTOW-style orbit camera (``ops/camera.py`` twin)."""

from __future__ import annotations

import math

import numpy as np
import torch

from metal_pathtracer_tpu_torch.ops import rng as rng_ops
from metal_pathtracer_tpu_torch.ops.vecmath import fdiv, fma
from metal_pathtracer_tpu_torch.schema import CameraUniforms


def build_camera(settings, width: int, height: int,
                 device="cuda") -> CameraUniforms:
    """Settings -> camera basis, computed in numpy exactly as the reference
    does (reference: UniformBuilder.mm:34-83), then moved to ``device``."""
    aspect = float(width) / float(height)
    vfov = min(max(settings.cameraVerticalFov, 1.0), 179.0)
    defocus_angle = max(settings.cameraDefocusAngle, 0.0)

    theta = math.radians(vfov)
    h = math.tan(theta * 0.5)
    viewport_height = 2.0 * h
    viewport_width = aspect * viewport_height

    distance = max(settings.cameraDistance, 0.1)
    yaw = settings.cameraYaw
    pitch = settings.cameraPitch
    offset = np.array([
        distance * math.cos(pitch) * math.cos(yaw),
        distance * math.sin(pitch),
        distance * math.cos(pitch) * math.sin(yaw),
    ], np.float32)

    look_at = np.asarray(settings.cameraTarget, np.float32)
    look_from = look_at + offset
    vup = np.array([0.0, 1.0, 0.0], np.float32)

    w = look_from - look_at
    w = w / np.linalg.norm(w)
    u = np.cross(vup, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)

    focus_dist = settings.cameraFocusDistance
    if focus_dist <= 0.0:
        focus_dist = distance

    horizontal = (focus_dist * viewport_width) * u
    vertical = (focus_dist * viewport_height) * v
    lower_left = look_from - 0.5 * horizontal - 0.5 * vertical - focus_dist * w
    lens_radius = focus_dist * math.tan(math.radians(defocus_angle * 0.5))

    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return CameraUniforms(
        origin=f(look_from), lower_left=f(lower_left),
        horizontal=f(horizontal), vertical=f(vertical),
        u=f(u), v=f(v), lens_radius=f(lens_radius))


def generate_primary_rays(camera: CameraUniforms, x, y, width, height,
                          state):
    """Jittered primary rays for integer pixel coords (reference:
    pathtrace.metal:9742-9752). The unit-disk draw runs for every ray, even
    at lens radius 0, so each lane's RNG stream matches the reference.

    Returns (state, origin, direction); direction is unnormalized.
    """
    state, jx = rng_ops.rand_uniform(state)
    u = fdiv(x.to(torch.float32) + jx, width)
    state, jy = rng_ops.rand_uniform(state)
    v = 1.0 - fdiv(y.to(torch.float32) + jy, height)

    pixel = fma(v[..., None], camera.vertical,
                fma(u[..., None], camera.horizontal, camera.lower_left))
    state, disk = rng_ops.random_in_unit_disk(state)
    disk = camera.lens_radius * disk
    offset = fma(disk[..., 0:1], camera.u, disk[..., 1:2] * camera.v)
    origin = camera.origin + offset
    return state, origin, pixel - origin
