"""Display path: exposure -> bloom -> tonemap -> gamma
(``renderer/display.py`` twin).

The reference's fullscreen display pass (reference:
shaders/display.metal:1-149): exposure scaling, the 9-tap threshold bloom
(:56-105), then the selected tonemap curve and gamma 2.2, on the device
the state lies on; with ``denoiseEnabled`` the HDR image is
``ops/denoise.denoise_state``'s first (the à-trous kernel, and the U-Net
over it, on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from metal_pathtracer_tpu_torch.ops import tonemap as tonemap_ops
from metal_pathtracer_tpu_torch.ops.denoise import denoise_state
from metal_pathtracer_tpu_torch.utils.spans import host_read, span


def display_image(state, settings, use_denoised: bool = None) -> torch.Tensor:
    """RenderState -> LDR (H,W,3) in [0,1] following the display shader."""
    if use_denoised is None:
        use_denoised = settings.denoiseEnabled
    hdr = denoise_state(state, settings) if use_denoised else state.present()
    # exp2(float32(exposure)) as a float32 scalar, computed on the host
    hdr = hdr * float(torch.exp2(torch.tensor(settings.exposure,
                                              dtype=torch.float32)))
    if settings.bloomEnabled:
        hdr = tonemap_ops.bloom(hdr, settings.bloomThreshold,
                                settings.bloomIntensity, settings.bloomRadius)
    # curve + gamma (exposure already applied -> pass exposure=0)
    return tonemap_ops.apply_tonemap(hdr, settings.tonemapMode,
                                     settings.acesVariant, 0.0,
                                     settings.reinhardWhitePoint)


def display_to_u8(state, settings) -> np.ndarray:
    """The display image as (H,W,3) uint8, rounded on the device."""
    with span("mpt.display"):
        ldr = display_image(state, settings).to(torch.float32)
        u8 = torch.clamp(torch.floor(ldr * 255.0 + 0.5), 0, 255)
        return host_read(u8.to(torch.uint8), torch.Tensor.cpu).numpy()
