"""Progressive accumulation state (``renderer/accumulation.py`` twin),
with the ``.npz`` checkpoint.

A checkpoint holds the JAX package's keys and dtypes (``accumulation.py
:69-155``: uint32 sample counts and dispatch counter, float32 moments and
counters, an empty ``denoised`` plane), so either package reads the
other's files. The trace counters are float32 there, exact up to 2^24.
A checkpoint written before the second moment existed has no
``radiance_sq_sum``: it loads as ``None`` (``accumulation.py:153-154``),
which ``variance_of_mean`` reads as zeros, the next frame starts from
zeros, and ``ops/denoise.denoise_state`` takes the fixed-sigma filter for.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch


class CheckpointError(RuntimeError):
    """A render-state checkpoint could not be read."""


@dataclasses.dataclass(frozen=True)
class RenderState:
    radiance_sum: torch.Tensor     # (H,W,3) f32 — running radiance sum
    sample_count: torch.Tensor     # (H,W)   i64 — per-pixel sample counts
    albedo: torch.Tensor           # (H,W,3) f32 — first-hit albedo AOV
    normal: torch.Tensor           # (H,W,3) f32 — first-hit normal AOV
    radiance_sq_sum: Optional[torch.Tensor]  # (H,W,3) f32 — sum of
    #                                  sample^2; None: a pre-sq_sum checkpoint
    frame_index: int = 0           # dispatch counter
    ray_count: int = 0             # scene traces issued
    shadow_ray_count: int = 0      # shadow traces issued (NEE + spec-NEE)

    @classmethod
    def create(cls, width: int, height: int, device="cuda") -> "RenderState":
        z3 = torch.zeros((height, width, 3), device=device)
        return cls(radiance_sum=z3, radiance_sq_sum=z3.clone(),
                   sample_count=torch.zeros((height, width), dtype=torch.int64,
                                            device=device),
                   albedo=z3.clone(), normal=z3.clone())

    @property
    def height(self) -> int:
        return self.radiance_sum.shape[0]

    @property
    def width(self) -> int:
        return self.radiance_sum.shape[1]

    def replace(self, **changes) -> "RenderState":
        return dataclasses.replace(self, **changes)

    def present(self) -> torch.Tensor:
        """Average image (reference: pathtracePresentKernel,
        pathtrace.metal:9947-9961): sum / count, count == 0 -> black."""
        count = torch.clamp_min(self.sample_count.to(torch.float32), 1.0)
        avg = self.radiance_sum / count[..., None]
        return torch.where((self.sample_count > 0)[..., None], avg, 0.0)

    def variance_of_mean(self) -> torch.Tensor:
        """Per-pixel, per-channel variance of the accumulated mean:
        max(E[x^2] - E[x]^2, 0) / n; zero where n < 2, and everywhere
        without a second moment (a pre-sq_sum checkpoint)."""
        if self.radiance_sq_sum is None:
            return torch.zeros_like(self.radiance_sum)
        n = torch.clamp_min(self.sample_count.to(torch.float32),
                            1.0)[..., None]
        mean = self.radiance_sum / n
        var = torch.clamp_min(self.radiance_sq_sum / n - mean * mean,
                              0.0) / n
        return torch.where((self.sample_count > 1)[..., None], var, 0.0)

    def save(self, path: str, digest: str = "") -> None:
        """Checkpoint to ``.npz``; resume with ``RenderState.load``.
        ``digest`` names the (scene, settings) the accumulation belongs to,
        and ``load`` refuses a different one."""
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        f32 = lambda x: x.detach().cpu().numpy().astype(np.float32)
        # a handle, so np.savez cannot append ".npz" to the name
        with open(path, "wb") as fh:
            np.savez(
                fh,
                digest=np.asarray(digest),
                radiance_sum=f32(self.radiance_sum),
                sample_count=self.sample_count.cpu().numpy().astype(np.uint32),
                albedo=f32(self.albedo),
                normal=f32(self.normal),
                frame_index=np.asarray(self.frame_index, np.uint32),
                denoised=np.zeros(tuple(self.radiance_sum.shape), np.float32),
                ray_count=np.asarray(self.ray_count, np.float32),
                shadow_ray_count=np.asarray(self.shadow_ray_count,
                                            np.float32),
                # zeros for a state without a second moment, as the JAX
                # package writes it: the file's keys stay the same
                radiance_sq_sum=np.zeros(tuple(self.radiance_sum.shape),
                                         np.float32)
                if self.radiance_sq_sum is None
                else f32(self.radiance_sq_sum))

    @classmethod
    def load(cls, path: str, expect_digest: str = None,
             expect_size: tuple = None, device="cuda") -> "RenderState":
        """Load a checkpoint onto ``device``. ``expect_size`` is (width,
        height) and ``expect_digest`` the digest the caller would save
        with; a mismatch of either raises ``CheckpointError`` rather than
        resume another accumulation."""
        try:
            data = np.load(path)
            radiance_sum = data["radiance_sum"]
        except (OSError, ValueError, KeyError) as exc:
            raise CheckpointError(
                f"could not load render-state checkpoint {path!r}: {exc}"
            ) from exc
        h, w = radiance_sum.shape[:2]
        if expect_size is not None and (w, h) != tuple(expect_size):
            raise CheckpointError(
                f"checkpoint {path!r} is {w}x{h} but this render is "
                f"{expect_size[0]}x{expect_size[1]}; delete the checkpoint "
                "or match the resolution")
        if expect_digest:
            stored = str(data["digest"]) if "digest" in data else ""
            if stored and stored != expect_digest:
                raise CheckpointError(
                    f"checkpoint {path!r} was rendered with a different "
                    "scene/settings (digest mismatch); delete it to start "
                    "fresh")
        t = lambda x, dtype=torch.float32: torch.as_tensor(
            np.asarray(x), dtype=dtype, device=device)
        scalar = lambda k: float(data[k]) if k in data else 0.0
        return cls(radiance_sum=t(radiance_sum),
                   sample_count=t(data["sample_count"], torch.int64),
                   albedo=t(data["albedo"]), normal=t(data["normal"]),
                   radiance_sq_sum=t(data["radiance_sq_sum"])
                   if "radiance_sq_sum" in data else None,
                   frame_index=int(data["frame_index"]),
                   ray_count=int(scalar("ray_count")),
                   shadow_ray_count=int(scalar("shadow_ray_count")))
