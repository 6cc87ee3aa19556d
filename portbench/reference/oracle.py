"""The reference's Python side: builds ``oracle.cpp`` into a fixed
directory of the checkout (``portbench/_cache/oracle/``) on first use and
renders the benchmark's generated scene (``scenegen.SceneSpec``) at a list
of pixels with it.

Everything the library is given is worked out here from the
configuration and the generated arrays: the camera basis (upstream's
orbit camera, ``UniformBuilder.mm:34-83``), the material rows and the
settings. Nothing is taken from the program.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess

import numpy as np

from portbench import cells, scenegen

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "oracle.cpp")
BUILD_DIR = os.path.join(cells.PKG_DIR, "_cache", "oracle")
FLAGS = ["-O3", "-march=x86-64-v3", "-ffp-contract=off", "-fPIC", "-shared", "-std=c++17",
         "-pthread"]

#: upstream's enums (``MetalShaderTypes.h``)
MATERIAL_TYPES = {"LAMBERTIAN": 0, "METAL": 1, "DIELECTRIC": 2}
BACKGROUND_MODES = {"GRADIENT": 0, "SOLID": 1}

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)
_ARGTYPES = [
    ctypes.c_int, ctypes.c_int, ctypes.c_int, _IP,   # w, h, pixels
    ctypes.c_int, ctypes.c_int, ctypes.c_uint32,     # spp, depth, seed
    ctypes.c_int, ctypes.c_int,                      # RR, control
    _FP, ctypes.c_int, _FP,                          # camera, background
    ctypes.c_int, _FP, _IP,                          # spheres
    ctypes.c_int, _FP, _FP,                          # materials, sigma_a
    _FP,                                             # firefly clamps
    ctypes.c_int, _FP]                               # threads, out


def library_path() -> str:
    """The built library, built on first use: its name carries the
    source's and the flags' digest, so that a changed source builds
    anew and an unchanged one is found."""
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(FLAGS).encode())
    path = os.path.join(BUILD_DIR, f"liboracle_{digest.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        part = path + ".part"
        subprocess.run([os.environ.get("CXX", "g++"), *FLAGS, SOURCE,
                        "-o", part], check=True)
        os.replace(part, path)
    return path


_LIB = None


def library():
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(library_path())
        _LIB.render_pixels.argtypes = _ARGTYPES
        _LIB.render_pixels.restype = ctypes.c_int
    return _LIB


def camera(settings: dict, width: int, height: int) -> np.ndarray:
    """Upstream's orbit camera (``UniformBuilder.mm:34-83``): origin,
    lower-left corner, horizontal and vertical spans, the lens basis u, v
    and the lens radius, 19 float32."""
    aspect = width / height
    vfov = min(max(float(settings["cameraVerticalFov"]), 1.0), 179.0)
    half = math.tan(math.radians(vfov) / 2.0)
    view_h = 2.0 * half
    view_w = aspect * view_h
    dist = max(float(settings["cameraDistance"]), 0.1)
    yaw, pitch = float(settings["cameraYaw"]), float(settings["cameraPitch"])
    f32 = lambda a: np.asarray(a, np.float32)
    target = f32(settings["cameraTarget"])
    eye = target + f32([dist * math.cos(pitch) * math.cos(yaw),
                        dist * math.sin(pitch),
                        dist * math.cos(pitch) * math.sin(yaw)])
    w = eye - target
    w = w / np.linalg.norm(w)
    u = np.cross(f32([0.0, 1.0, 0.0]), w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    focus = float(settings["cameraFocusDistance"])
    if focus <= 0.0:
        focus = dist
    horizontal = (focus * view_w) * u
    vertical = (focus * view_h) * v
    lower_left = eye - 0.5 * horizontal - 0.5 * vertical - focus * w
    lens = focus * math.tan(math.radians(
        max(float(settings["cameraDefocusAngle"]), 0.0) / 2.0))
    return np.concatenate([eye, lower_left, horizontal, vertical, u, v,
                           [lens]]).astype(np.float32)


def material_rows(materials: list) -> tuple:
    """The library's material rows: (M, 8) float32 base colour,
    roughness, type, IOR, thin and a pad, and (M, 3) float32 absorption
    inside a dielectric."""
    rows = np.zeros((max(len(materials), 1), 8), np.float32)
    sigma = np.zeros((max(len(materials), 1), 3), np.float32)
    for i, m in enumerate(materials):
        rows[i, 0:3] = np.clip(m["base_color"], 0.0, 1.0)
        rows[i, 3] = min(max(float(m.get("roughness", 0.0)), 0.0), 1.0)
        rows[i, 4] = MATERIAL_TYPES[m["mat_type"]]
        rows[i, 5] = max(float(m.get("ior", 1.5)), 0.0)
        rows[i, 6] = 1.0 if m.get("thin") else 0.0
        sigma[i] = np.maximum(m.get("dielectric_sigma_a", (0.0, 0.0, 0.0)),
                              0.0)
    return rows, sigma


class Reference:
    """The reference for one scene, frame and render seed."""

    def __init__(self, spec: scenegen.SceneSpec, traffic: dict, seed: int,
                 threads: int = 0):
        self.spec = spec
        self.width, self.height = traffic["width"], traffic["height"]
        self.depth = traffic["max_depth"]
        self.seed = scenegen.seed32(seed)
        self.threads = threads

    def reseed(self, seed: int) -> None:
        self.seed = scenegen.seed32(seed)

    def radiance_sums(self, pixels: np.ndarray, spp: int,
                      control: bool = False) -> np.ndarray:
        """(P, 3) float32: each listed pixel's radiance summed over
        samples 0 .. ``spp`` - 1 in order; ``control`` rounds the path
        state to bfloat16 after every depth."""
        s = self.spec.settings
        lib = library()
        pix = np.ascontiguousarray(pixels, np.int32)
        cam = camera(s, self.width, self.height)
        bg = np.asarray(s.get("backgroundColor", (0, 0, 0)), np.float32)
        sph = np.ascontiguousarray(self.spec.spheres, np.float32)
        sph_mat = np.ascontiguousarray(self.spec.sphere_material, np.int32)
        mats, sigma = material_rows(self.spec.materials)
        firefly = np.asarray([
            max(s["fireflyClampFactor"], 0.0), max(s["fireflyClampFloor"], 0.0),
            max(s["throughputClamp"], 0.0),
            max(s["fireflyClampMaxContribution"], 0.0),
            1.0 if s["fireflyClampEnabled"] else 0.0], np.float32)
        out = np.zeros((len(pix), 3), np.float32)
        f = lambda a: a.ctypes.data_as(_FP)
        i = lambda a: a.ctypes.data_as(_IP)
        ret = lib.render_pixels(
            self.width, self.height, len(pix), i(pix), int(spp), self.depth,
            self.seed, 1 if s["enableRussianRoulette"] else 0,
            1 if control else 0,
            f(cam), BACKGROUND_MODES[s["backgroundMode"]], f(bg),
            len(sph), f(sph), i(sph_mat),
            len(self.spec.materials), f(mats), f(sigma),
            f(firefly), self.threads, f(out))
        if ret != 0:
            raise RuntimeError(f"the reference's render failed ({ret})")
        return out
