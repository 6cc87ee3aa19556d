"""Headless rendering (``renderer/headless.py`` twin).

``CudaBackend`` renders progressive sample batches on a torch device: the
card by default, the CPU where the caller asks (every kernel then runs
its plain version). It keeps the JAX ``TpuBackend``'s surface: the scene
digest and the ``.npz`` checkpoint it resumes from, ``PerformanceStats``
and the ``[Headless]`` log lines (``headless.py:48-62, 69-160``).
``OracleBackend`` renders with the native C++ oracle (``renderer/oracle.py``),
the reference's Embree role. ``make_backend`` takes the JAX package's
names and never falls back from one backend to another.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Optional

import numpy as np
import torch

from metal_pathtracer_tpu_torch.ops.camera import build_camera
from metal_pathtracer_tpu_torch.renderer import frame
from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
from metal_pathtracer_tpu_torch.schema import (
    settings_to_static,
    settings_to_uniforms,
)
from metal_pathtracer_tpu_torch.settings import BackgroundMode, RenderSettings
from metal_pathtracer_tpu_torch.utils import stats as stats_mod


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

# Seconds between periodic checkpoint saves during a render
CHECKPOINT_INTERVAL = 30.0


def _leaves(obj):
    """The tensors and scalars of nested dataclasses, in field order."""
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name))
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _leaves(x)
    elif obj is not None:
        yield obj


def scene_digest(scene, static, uniforms) -> str:
    """sha256 over the static configuration, the uniforms and the scene
    arrays: what a checkpointed accumulation was rendered with."""
    h = hashlib.sha256()
    h.update(repr(static).encode())
    for leaf in (*_leaves(uniforms), *_leaves(scene)):
        if torch.is_tensor(leaf):
            leaf = leaf.detach().cpu().numpy()
        h.update(np.asarray(leaf).tobytes())
    return h.hexdigest()


class CudaBackend:
    """Progressive batch renderer on a torch device (``device``: the card
    by default; CPU tensors run every kernel's plain version)."""

    def __init__(self, device="cuda"):
        self.device = device
        self.name = torch.device(device).type   # "cuda" or "cpu"
        self.last_stats = None

    def render(self, resources, settings: RenderSettings, width: int,
               height: int, spp_total: int, device=None,
               batch: int = DEFAULT_BATCH, environment=None,
               verbose: bool = False, progress_interval: float = 0.5,
               checkpoint_path: str = "") -> HeadlessRenderOutput:
        """Render ``spp_total`` samples per pixel. ``device`` overrides the
        backend's; ``environment``, an ``EnvironmentSoA`` on that device,
        the settings' map file. With ``checkpoint_path`` the render
        resumes from that file when it exists (raising ``CheckpointError``
        if it belongs to another scene, settings or size), saves it every
        ``CHECKPOINT_INTERVAL`` seconds and at the end."""
        device = self.device if device is None else device
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
        log = stats_mod.get_logger("Headless")
        stats_mod.set_verbose(verbose)
        digest = scene_digest(scene, static, uniforms) \
            if checkpoint_path else ""
        if checkpoint_path and os.path.exists(checkpoint_path):
            state = RenderState.load(checkpoint_path, expect_digest=digest,
                                     expect_size=(width, height),
                                     device=device)
            log.debug(f"resumed {state.frame_index} spp from "
                      f"{checkpoint_path}")
        else:
            state = RenderState.create(width, height, device)

        perf = stats_mod.PerformanceStats()
        # counters restored from a checkpoint are history, not this run's
        perf.total_rays = float(state.ray_count)
        perf.total_shadow_rays = float(state.shadow_ray_count)
        sync = torch.cuda.synchronize if state.radiance_sum.is_cuda \
            else (lambda: None)
        start = last_report = last_save = time.time()
        done = state.frame_index
        while done < spp_total:
            n = min(batch, spp_total - done)
            with stats_mod.BatchTimer() as bt:
                state = frame.render_samples(scene, uniforms, state, static,
                                             n)
                sync()
            done += n
            if checkpoint_path and done < spp_total \
                    and time.time() - last_save >= CHECKPOINT_INTERVAL:
                state.save(checkpoint_path, digest=digest)
                last_save = time.time()
            perf.update(samples=n, seconds=bt.seconds, width=width,
                        height=height, ray_count=float(state.ray_count),
                        shadow_ray_count=float(state.shadow_ray_count))
            now = time.time()
            if now - last_report >= progress_interval or done >= spp_total:
                log.debug(f"{done}/{spp_total} spp — {perf.summary()}")
                last_report = now
        img = state.present().cpu().numpy()  # waits for the device
        total = time.time() - start
        self.last_stats = perf
        if checkpoint_path:
            state.save(checkpoint_path, digest=digest)
        return HeadlessRenderOutput(
            linear_rgb=img, width=width, height=height, samples=done,
            total_seconds=total,
            avg_ms_per_sample=1000.0 * total / max(done, 1),
            albedo=state.albedo.cpu().numpy(),
            normal=(state.normal * 0.5 + 0.5).cpu().numpy(),
            sample_count=state.sample_count.cpu().numpy(),
            ray_count=state.ray_count,
            shadow_ray_count=state.shadow_ray_count)


class OracleBackend:
    """The native C++ CPU oracle, the parity reference backend, in the
    reference's ``--backend=embree`` role (JAX ``headless.py:175-209``;
    reference: src/headless/EmbreeHeadlessRenderer.mm)."""

    name = "oracle"

    def render(self, resources, settings: RenderSettings, width: int,
               height: int, spp_total: int, verbose: bool = False,
               n_threads: int = 0, **_kwargs) -> HeadlessRenderOutput:
        from metal_pathtracer_tpu_torch.renderer import oracle

        if _kwargs.get("checkpoint_path"):
            print("[Oracle] warning: --checkpoint is not supported by the "
                  "CPU oracle backend; rendering from scratch")
        environment = None
        if settings.backgroundMode == BackgroundMode.ENVIRONMENT \
                and settings.environmentMapPath:
            from metal_pathtracer_tpu_torch.ops import env as env_ops
            environment = env_ops.load_environment(
                settings.environmentMapPath, "cpu")
        start = time.time()
        img = oracle.render_oracle(resources, settings, width, height,
                                   spp_total, environment=environment,
                                   n_threads=n_threads)
        total = time.time() - start
        if verbose:
            print(f"[Oracle] {spp_total} spp in {total:.1f}s")
        return HeadlessRenderOutput(
            linear_rgb=img, width=width, height=height, samples=spp_total,
            total_seconds=total,
            avg_ms_per_sample=1000.0 * total / max(spp_total, 1))


#: backend names (JAX ``make_backend``): the reference's ``metal`` is the
#: card; ``cpu``, ``oracle`` and ``embree`` the native oracle;
#: ``cpu-torch`` (JAX ``cpu-jax``) the port's own plain path on the CPU
CUDA_NAMES = ("cuda", "metal")
ORACLE_NAMES = ("cpu", "oracle", "embree")


def make_backend(name: str = "cuda"):
    """``cuda`` or ``metal`` (the card; raises without one), ``cpu``,
    ``oracle`` or ``embree`` (the native oracle; raises when it cannot be
    built) or ``cpu-torch`` (torch on the CPU: every kernel's plain
    version). No fallback from one to another."""
    if name in CUDA_NAMES:
        if not torch.cuda.is_available():
            raise RuntimeError(f"backend {name!r}: no CUDA device is "
                               "available (use --backend cpu-torch for the "
                               "plain versions on the CPU)")
        return CudaBackend("cuda")
    if name in ORACLE_NAMES:
        from metal_pathtracer_tpu_torch.renderer import oracle
        if not oracle.oracle_available():
            raise RuntimeError(f"backend {name!r}: the native CPU oracle "
                               "cannot be built (run native/build.sh)")
        return OracleBackend()
    if name == "cpu-torch":
        return CudaBackend("cpu")
    raise ValueError(f"unknown backend: {name} (choose "
                     f"{' | '.join(CUDA_NAMES + ORACLE_NAMES)} | cpu-torch)")
