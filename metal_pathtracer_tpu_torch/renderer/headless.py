"""Headless rendering on a CUDA device (``renderer/headless.py`` twin of
``TpuBackend``, without checkpoints)."""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from metal_pathtracer_tpu_torch.ops.camera import build_camera
from metal_pathtracer_tpu_torch.renderer import frame
from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
from metal_pathtracer_tpu_torch.schema import (
    settings_to_static,
    settings_to_uniforms,
)
from metal_pathtracer_tpu_torch.settings import BackgroundMode, RenderSettings


@dataclasses.dataclass
class HeadlessRenderOutput:
    """(reference: IHeadlessRenderer.h HeadlessRenderOutput:30-40)"""

    linear_rgb: np.ndarray       # (H,W,3) f32
    width: int
    height: int
    samples: int
    total_seconds: float
    avg_ms_per_sample: float
    albedo: Optional[np.ndarray] = None
    normal: Optional[np.ndarray] = None
    sample_count: Optional[np.ndarray] = None
    ray_count: int = 0           # scene traces issued over the render
    shadow_ray_count: int = 0    # shadow traces issued over the render


# Samples per frame.render_samples call (the reference batches <=16 spp
# per command buffer, MetalHeadlessRenderer.mm:48).
DEFAULT_BATCH = 16


class CudaBackend:
    """Progressive batch renderer on a torch device. The device is the
    caller's choice; CPU tensors run every kernel's plain version."""

    name = "cuda"

    def render(self, resources, settings: RenderSettings, width: int,
               height: int, spp_total: int, device="cuda",
               batch: int = DEFAULT_BATCH,
               environment=None) -> HeadlessRenderOutput:
        """``environment``: an ``EnvironmentSoA`` on ``device`` for an
        environment background (default: the settings' map file, if
        any)."""
        if environment is None \
                and settings.backgroundMode == BackgroundMode.ENVIRONMENT \
                and settings.environmentMapPath:
            from metal_pathtracer_tpu_torch.ops import env as env_ops
            environment = env_ops.load_environment(
                settings.environmentMapPath, device)
        scene = resources.build_arrays(environment=environment, device=device)
        static = settings_to_static(settings, width, height,
                                    resources.material_types_present(),
                                    resources.texture_slots_present(),
                                    resources.texture_uses_uv1())
        uniforms = settings_to_uniforms(
            settings, build_camera(settings, width, height, device), 0, 0)
        state = RenderState.create(width, height, device)
        start = time.time()
        done = 0
        while done < spp_total:
            n = min(batch, spp_total - done)
            state = frame.render_samples(scene, uniforms, state, static, n)
            done += n
        img = state.present().cpu().numpy()  # waits for the device
        total = time.time() - start
        return HeadlessRenderOutput(
            linear_rgb=img, width=width, height=height, samples=done,
            total_seconds=total,
            avg_ms_per_sample=1000.0 * total / max(done, 1),
            albedo=state.albedo.cpu().numpy(),
            normal=(state.normal * 0.5 + 0.5).cpu().numpy(),
            sample_count=state.sample_count.cpu().numpy(),
            ray_count=state.ray_count,
            shadow_ray_count=state.shadow_ray_count)
