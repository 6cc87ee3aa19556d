"""The reference's display: upstream's display shader
(``shaders/display.metal``) at the settings the benchmark's
configurations state (exposure 0, no bloom, the linear tonemap, no
denoiser): each pixel's mean radiance clamped to [0, 1], gamma 2.2,
rounded to uint8. It takes the reference's own radiance sums."""

from __future__ import annotations

import numpy as np

#: the display settings this reference follows
SETTINGS = {"exposure": 0.0, "bloomEnabled": False, "tonemapMode": 1,
            "denoiseEnabled": False}


def display_u8(sums: np.ndarray, samples: int, settings: dict) -> np.ndarray:
    """(P, 3) uint8 of the (P, 3) radiance sums over ``samples``."""
    for k, v in SETTINGS.items():
        if settings.get(k) != v:
            raise ValueError(f"the reference's display follows {k}={v!r}, "
                             f"not {settings.get(k)!r}")
    mean = sums.astype(np.float64) / max(samples, 1)
    ldr = np.clip(mean, 0.0, 1.0) ** (1.0 / 2.2)
    return np.clip(np.floor(ldr * 255.0 + 0.5), 0, 255).astype(np.uint8)
