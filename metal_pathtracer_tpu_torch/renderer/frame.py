"""Frame stepping: N samples of progressive accumulation
(``renderer/frame.py`` twin).

Lanes are pixels in scan order. The TPU tiles them 8x128 to match its
traversal packets; one thread per ray on the GPU has no packet to fill, so
scan order stays until a measured reorder beats it. A chunk is the whole
frame up to 2^21 lanes (1080p is 2,073,600): per depth that is one K1 and
one K2 launch and one host sync for the whole image (the environment
path: K1, K2 s1, K1 any-hit, K2 s2 and the spec-NEE any-hit).

``ray_count`` counts the scene traces and ``shadow_ray_count`` the shadow
traces (NEE and spec-NEE), as the JAX package counts them; Mrays/s is
their sum over the time (``bench.py:29-33``).
"""

from __future__ import annotations

import dataclasses

import torch

from metal_pathtracer_tpu_torch.ops import integrator
from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
from metal_pathtracer_tpu_torch.schema import SceneArrays, StaticConfig, Uniforms
from metal_pathtracer_tpu_torch.utils.spans import host_read, span

DEFAULT_CHUNK = 1 << 21


def render_rows(scene: SceneArrays, uniforms: Uniforms, state: RenderState,
                static: StaticConfig, n_samples: int, row_offset: int = 0,
                chunk: int = DEFAULT_CHUNK) -> RenderState:
    """Advance a slab of rows by ``n_samples``. Pixel coordinates are
    global (slab row 0 is image row ``row_offset``), so seeds depend on the
    absolute pixel only. Each pixel accumulates its samples in sample
    order, as the reference does."""
    if n_samples <= 0:
        return state
    height, width = state.height, state.width
    total = height * width
    dev = state.radiance_sum.device
    flat = torch.arange(total, device=dev)
    xs = flat % width
    ys = flat // width + row_offset
    prev0 = state.sample_count.reshape(-1)
    lane_rad = state.radiance_sum.reshape(-1, 3).clone()
    # a pre-sq_sum checkpoint's second moment starts from zeros
    # (``frame.py:143-144``)
    lane_sq = torch.zeros_like(lane_rad) if state.radiance_sq_sum is None \
        else state.radiance_sq_sum.reshape(-1, 3).clone()
    lane_alb = torch.zeros_like(lane_rad)
    lane_nrm = torch.zeros_like(lane_rad)
    rays = state.ray_count
    shadow = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(n_samples):
        # frameIndex == sampleCount == dispatch index (reference:
        # Accumulation.h incrementFrame:54-57, UniformBuilder.mm:31-33)
        frame_idx = state.frame_index + i
        u = dataclasses.replace(uniforms, frame_index=frame_idx,
                                sample_count=frame_idx)
        for lo in range(0, total, chunk):
            sl = slice(lo, min(lo + chunk, total))
            with span("mpt.sample"):
                sample, albedo, normal, stats = integrator.integrate_pixels(
                    scene, u, static, xs[sl], ys[sl], prev0[sl] + i)
                with span("mpt.accumulate"):
                    lane_rad[sl] += sample
                    lane_sq[sl] += sample * sample
                    lane_alb[sl] = albedo
                    lane_nrm[sl] = normal
                    rays += stats["rays"]
                    shadow = shadow + stats["shadow_rays"]
    shape = (height, width, 3)
    return state.replace(
        radiance_sum=lane_rad.reshape(shape),
        radiance_sq_sum=lane_sq.reshape(shape),
        sample_count=state.sample_count + n_samples,
        albedo=lane_alb.reshape(shape),
        normal=lane_nrm.reshape(shape),
        frame_index=state.frame_index + n_samples,
        ray_count=rays,
        shadow_ray_count=state.shadow_ray_count + host_read(shadow))


def render_samples(scene: SceneArrays, uniforms: Uniforms, state: RenderState,
                   static: StaticConfig, n_samples: int,
                   chunk: int = DEFAULT_CHUNK) -> RenderState:
    """Advance the full frame by ``n_samples``."""
    return render_rows(scene, uniforms, state, static, n_samples, 0, chunk)
