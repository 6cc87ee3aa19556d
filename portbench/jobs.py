"""The system under test: the port ``metal_pathtracer_tpu_torch``, driven
through its public entry points.

- ``OfflineJob``: the job of the headless CLI (``renderer/headless.py
  CudaBackend.render``): ``renderer/frame.py render_samples`` in batches
  of ``batch_spp`` samples, each synchronised, accumulating into one
  state.
- ``InteractiveJob``: the viewer's frame once its camera has settled:
  the facade's ``Renderer.draw_frame(samples_per_frame)``, then
  ``renderer/display.py display_to_u8``, the uint8 image on the host.
  PNG encoding, the viewer's host work, is left out.

A job builds its scene from the generated arrays in ``__init__`` and
warms up with one unit of its own work (``warm``); ``step`` runs one
unit and returns the pixel samples it added; ``outputs`` gives what the
check compares, on the host; ``free`` drops every tensor of the program.
"""

from __future__ import annotations

import dataclasses
import gc
import time
import types

import numpy as np
import torch

from portbench import scenegen


def port_api():
    """The port's modules the benchmark calls, imported on first use."""
    from metal_pathtracer_tpu_torch import constants
    from metal_pathtracer_tpu_torch.ops.camera import build_camera
    from metal_pathtracer_tpu_torch.ops.kernels import build
    from metal_pathtracer_tpu_torch.renderer import display, frame
    from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
    from metal_pathtracer_tpu_torch.renderer.renderer import Renderer
    from metal_pathtracer_tpu_torch.scene.resources import (
        Material,
        SceneResources,
    )
    from metal_pathtracer_tpu_torch.schema import (
        settings_to_static,
        settings_to_uniforms,
    )
    from metal_pathtracer_tpu_torch.settings import (
        BackgroundMode,
        RenderSettings,
    )

    return types.SimpleNamespace(
        constants=constants, build_camera=build_camera, build=build,
        display=display, frame=frame, RenderState=RenderState,
        Renderer=Renderer, Material=Material, SceneResources=SceneResources, settings_to_static=settings_to_static,
        settings_to_uniforms=settings_to_uniforms,
        BackgroundMode=BackgroundMode, RenderSettings=RenderSettings)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Outputs:
    """What the timed path produced, on the host: the sampled pixels'
    radiance sums and sample counts, the state's frame index, the samples
    a pixel the harness asked for (``requested``: what each pixel should
    hold) and, for a displayed job, the sampled pixels of the last image
    it displayed."""

    pixels: np.ndarray           # (P,) flat pixel indices
    radiance_sum: np.ndarray     # (P, 3) f32
    sample_count: np.ndarray     # (P,) i64
    frame_index: int
    requested: int
    image: np.ndarray | None = None  # (P, 3) uint8


def _sampled(state, pixels) -> tuple:
    flat = torch.as_tensor(pixels, device=state.radiance_sum.device)
    rad = state.radiance_sum.reshape(-1, 3)[flat].cpu().numpy()
    cnt = state.sample_count.reshape(-1)[flat].cpu().numpy()
    return rad, cnt


class OfflineJob:
    """Batches of ``batch_spp`` samples through ``frame.render_samples``."""

    def __init__(self, spec, traffic: dict, seed: int, device):
        self.P = P = port_api()
        dev = device
        if torch.device(dev).type == "cuda":
            P.build.load()
        self.width, self.height = traffic["width"], traffic["height"]
        settings, res = scenegen.apply(spec, traffic, seed, P)
        self.scene = res.build_arrays(environment=None, device=dev)
        self.static = P.settings_to_static(
            settings, self.width, self.height, res.material_types_present(),
            res.texture_slots_present(), res.texture_uses_uv1())
        self.uniforms = P.settings_to_uniforms(
            settings, P.build_camera(settings, self.width, self.height, dev),
            0, 0)
        self.state = P.RenderState.create(self.width, self.height, dev)
        self.requested = 0
        self.batch = traffic["batch_spp"]
        self.device = dev

    def reseed(self, seed: int) -> None:
        """An empty state under another render seed, the scene kept."""
        self.uniforms = dataclasses.replace(
            self.uniforms, fixed_rng_seed=scenegen.seed32(seed))
        self.state = self.P.RenderState.create(self.width, self.height,
                                               self.device)
        self.requested = 0

    def render(self, n: int) -> int:
        self.state = self.P.frame.render_samples(
            self.scene, self.uniforms, self.state, self.static, n)
        sync(self.device)
        self.requested += n
        return n * self.width * self.height

    def warm(self) -> None:
        self.step()

    def step(self) -> int:
        return self.render(self.batch)

    def rays(self) -> tuple:
        """The port's own counts: (closest, shadow) traces so far."""
        return int(self.state.ray_count), int(self.state.shadow_ray_count)

    def outputs(self, pixels: np.ndarray) -> Outputs:
        rad, cnt = _sampled(self.state, pixels)
        return Outputs(pixels, rad, cnt, int(self.state.frame_index),
                       self.requested)

    def free(self) -> None:
        self.scene = self.state = self.uniforms = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()


class InteractiveJob:
    """The facade's frame and its display, the camera still. ``split``:
    None, or two lists that collect each frame's ``draw_frame`` seconds
    (synchronised) and display seconds."""

    def __init__(self, spec, traffic: dict, seed: int, device):
        self.P = P = port_api()
        dev = device
        if torch.device(dev).type == "cuda":
            P.build.load()
        self.width, self.height = traffic["width"], traffic["height"]
        settings, res = scenegen.apply(spec, traffic, seed, P)
        settings.samplesPerFrame = traffic["samples_per_frame"]
        self.renderer = P.Renderer(self.width, self.height, device=dev)
        self.renderer.resources = res
        self.renderer.apply_settings(settings)
        if self.renderer.render_size != (self.width, self.height):
            raise ValueError(f"the facade renders "
                             f"{self.renderer.render_size}, not "
                             f"{(self.width, self.height)}")
        self.spf = traffic["samples_per_frame"]
        self.requested = 0
        self.image = None
        self.device = dev
        self.split = None

    def reseed(self, seed: int) -> None:
        """An empty state under another render seed, the scene kept."""
        settings = self.renderer.settings.copy()
        settings.fixedRngSeed = scenegen.seed32(seed)
        self.renderer.apply_settings(settings)
        self.renderer.reset_accumulation()
        self.requested = 0

    def warm(self) -> None:
        self.step()

    def step(self) -> int:
        r = self.renderer
        self.requested += self.spf
        if self.split is None:
            r.draw_frame(self.spf)
            self.image = self.P.display.display_to_u8(r.state, r.settings)
        else:
            t0 = time.perf_counter()
            r.draw_frame(self.spf)
            sync(self.device)
            t1 = time.perf_counter()
            self.image = self.P.display.display_to_u8(r.state, r.settings)
            self.split[0].append(t1 - t0)
            self.split[1].append(time.perf_counter() - t1)
        return self.spf * self.width * self.height

    def rays(self) -> tuple:
        """The port's own counts: (closest, shadow) traces so far."""
        st = self.renderer.state
        return int(st.ray_count), int(st.shadow_ray_count)

    def outputs(self, pixels: np.ndarray) -> Outputs:
        st = self.renderer.state
        rad, cnt = _sampled(st, pixels)
        return Outputs(pixels, rad, cnt, int(st.frame_index), self.requested,
                       self.image.reshape(-1, 3)[pixels])

    def free(self) -> None:
        self.renderer = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()


JOBS = {"offline": OfflineJob, "interactive": InteractiveJob}
