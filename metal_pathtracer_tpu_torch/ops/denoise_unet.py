"""Small convolutional U-Net denoiser (``ops/denoise_unet.py`` twin).

A 3-level U-Net on (log1p of the tap-filter prepass, log1p of the noisy
colour, albedo, normal, sqrt of the luminance variance) that predicts a
residual in log space over the prepass: enc1(16) -> pool -> enc2(24) ->
pool -> enc3(32) -> pool -> bottleneck(48) -> up+skip dec3(32) -> up+skip
dec2(24) -> up+skip dec1(16) -> out(3); 3x3 convolutions with SAME
padding and leaky ReLU (0.1) except on ``out``, 2x2 max pools, nearest
upsampling, inputs padded at the edges to a multiple of 8 and cropped
back.

The JAX package computes it with ``lax.conv_general_dilated`` outside any
Pallas kernel, so it stays a library product here:
``torch.nn.functional.conv2d`` (cuDNN on the card). cuDNN runs float32
convolutions in TF32 by default; ``DenoiseUNet.forward`` runs under
``torch.backends.cudnn.flags(..., allow_tf32=False)``, scoped to the
call, so the card computes in float32 as the JAX package does. The
public functions keep the JAX package's NHWC layout; the convolutions
see the same memory as NCHW in channels-last order.

A net from ``from_params`` is frozen and runs under ``torch.no_grad``
(the display path). Its trainer (``tools/train_denoiser_unet.py``) sets
``requires_grad_(True)``; ``forward`` then records the graph under the
same cuDNN flags (``cudnn_float32``, which the trainer also holds around
the backward), and ``params`` gives the weights back by name.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

# (name, in_ch, out_ch) for every conv, in forward order. IN_CH features:
# log1p(base) 3 + log1p(noisy color) 3 + albedo 3 + normal 3 +
# sqrt(luma variance) 1
IN_CH = 13
_ENC = (("enc1", IN_CH, 16), ("enc2", 16, 24), ("enc3", 24, 32))
_BOTTLE = ("bottle", 32, 48)
_DEC = (("dec3", 48 + 32, 32), ("dec2", 32 + 24, 24), ("dec1", 24 + 16, 16))
_OUT = ("out", 16, 3)
LAYERS = _ENC + (_BOTTLE,) + _DEC + (_OUT,)


def init_params(generator: torch.Generator) -> dict:
    """He-normal weights in the JAX package's layout (``name_w`` (3, 3,
    cin, cout) HWIO, ``name_b`` zeros; ``denoise_unet.py:41-57``), the
    output conv at 0.05x He, drawn from ``generator`` (not JAX's PRNG
    bits). ``convert.denoiser_params`` takes them to the port's layout."""
    params = {}
    for name, cin, cout in LAYERS:
        w = torch.randn((3, 3, cin, cout), generator=generator,
                        dtype=torch.float32) * math.sqrt(2.0 / (9 * cin))
        if name == "out":
            w = w * 0.05
        params[name + "_w"] = w
        params[name + "_b"] = torch.zeros((cout,), dtype=torch.float32)
    return params


def cudnn_float32():
    """cuDNN in float32 (TF32 off) with deterministic algorithms: the
    forward's flags, and its trainer's around the backward, which runs
    outside ``forward``."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


def _leaky(y):
    return torch.where(y > 0.0, y, 0.1 * y)


def _pool(x):
    return F.max_pool2d(x, 2, 2)


def _up(x):
    return x.repeat_interleave(2, 2).repeat_interleave(2, 3)


class DenoiseUNet(nn.Module):
    """The eight convolutions; ``forward`` is the JAX package's
    ``apply:83``."""

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleDict({
            name: nn.Conv2d(cin, cout, 3, padding=1)
            for name, cin, cout in LAYERS})
        self.requires_grad_(False)

    @classmethod
    def from_params(cls, params: dict) -> "DenoiseUNet":
        """A net holding ``convert.denoiser_params``' tensors (OIHW
        weights), on their device."""
        net = cls()
        for name, _, _ in LAYERS:
            conv = net.convs[name]
            conv.weight = nn.Parameter(params[name + "_w"],
                                       requires_grad=False)
            conv.bias = nn.Parameter(params[name + "_b"], requires_grad=False)
        return net

    def params(self) -> dict:
        """The weights by the JAX package's names (``name_w`` OIHW,
        ``name_b``): the tensors themselves."""
        out = {}
        for name, _, _ in LAYERS:
            out[name + "_w"] = self.convs[name].weight
            out[name + "_b"] = self.convs[name].bias
        return out

    def _conv(self, name, x, relu=True):
        y = self.convs[name](x)
        return _leaky(y) if relu else y

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """feats: (N, H, W, IN_CH) with H, W divisible by 8. Returns the
        log-space residual (N, H, W, 3); under ``no_grad`` unless a weight
        requires grad in grad mode."""
        train = torch.is_grad_enabled() and any(
            p.requires_grad for p in self.parameters())
        with contextlib.nullcontext() if train else torch.no_grad(), \
                cudnn_float32():
            x = feats.permute(0, 3, 1, 2)
            e1 = self._conv("enc1", x)
            e2 = self._conv("enc2", _pool(e1))
            e3 = self._conv("enc3", _pool(e2))
            b = self._conv("bottle", _pool(e3))
            d3 = self._conv("dec3", torch.cat([_up(b), e3], 1))
            d2 = self._conv("dec2", torch.cat([_up(d3), e2], 1))
            d1 = self._conv("dec1", torch.cat([_up(d2), e1], 1))
            return self._conv("out", d1, relu=False).permute(0, 2, 3, 1)


def _features(base, color, albedo, normal, variance):
    lum_var = (0.2126 * variance[..., 0] + 0.7152 * variance[..., 1]) \
        + 0.0722 * variance[..., 2]
    return torch.cat([
        torch.log1p(torch.clamp_min(base, 0.0)),
        torch.log1p(torch.clamp_min(color, 0.0)),
        albedo,
        normal,
        torch.sqrt(torch.clamp_min(lum_var, 0.0))[..., None],
    ], -1)


def _pad_edge(x, ph: int, pw: int):
    """(H, W, C) padded by ``ph`` rows and ``pw`` columns at the end,
    repeating the edge (``jnp.pad(mode="edge")``)."""
    if not (ph or pw):
        return x
    return F.pad(x.permute(2, 0, 1), (0, pw, 0, ph),
                 mode="replicate").permute(1, 2, 0)


def denoise(color, albedo, normal, variance, net: DenoiseUNet, base):
    """Refine one (H, W, 3) linear-HDR image over ``base``, the tap-filter
    prepass: out = expm1(relu(log1p(base) + unet(feats)))
    (``denoise_unet.py:108-125``)."""
    h, w = color.shape[:2]
    ph, pw = (-h) % 8, (-w) % 8
    feats = _pad_edge(_features(base, color, albedo, normal, variance),
                      ph, pw)
    res = net(feats[None])[0]
    log_out = torch.log1p(torch.clamp_min(_pad_edge(base, ph, pw), 0.0)) \
        + res
    out = torch.expm1(torch.clamp_min(log_out, 0.0))
    return out[:h, :w]
