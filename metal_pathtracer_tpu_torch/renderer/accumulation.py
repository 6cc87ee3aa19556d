"""Progressive accumulation state (``renderer/accumulation.py`` twin,
without the ``.npz`` checkpoint, which is ROADMAP Queue 1 step 10)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RenderState:
    radiance_sum: torch.Tensor     # (H,W,3) f32 — running radiance sum
    sample_count: torch.Tensor     # (H,W)   i64 — per-pixel sample counts
    albedo: torch.Tensor           # (H,W,3) f32 — first-hit albedo AOV
    normal: torch.Tensor           # (H,W,3) f32 — first-hit normal AOV
    radiance_sq_sum: torch.Tensor  # (H,W,3) f32 — sum of sample^2
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
