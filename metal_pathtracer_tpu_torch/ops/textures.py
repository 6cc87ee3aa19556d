"""Texture atlas and texture sampling (the port's own copy of the JAX
package's ``ops/textures.py``).

Every material texture keeps its native resolution, which must already be
a power of two per side no larger than the cap (default 2048). All
textures and all their mip levels are flattened into one (TOTAL, 4) texel
buffer plus small per-(texture, level) offset and size tables, so a
filtered sample is a handful of gathers into the flat buffer: trilinear is
2 levels x 4 taps (reference: src/renderer/SceneResources.mm:1309-1388
texture upload, shaders/pathtrace.metal:3015-3218 cone-LOD sampling).

The atlas is built with numpy alone, value for value the JAX package's:
sRGB decode of colour slots at upload, then a 2x2 box-filtered mip chain.
Sampling implements repeat/clamp/mirror addressing (a floor-mod, as
``jnp.mod`` on int32), bilinear and trilinear-by-LOD filtering,
KHR_texture_transform and the white fallback for unbound slots.

The sampling helpers spell out with ``vecmath.fma`` the fused
multiply-adds the reference's XLA:CPU build contracts (``u * w - 0.5``
before the floor, the bilinear and trilinear lerps, the transform rows);
``csrc/texture.cu`` places ``__fmaf_rn`` at the same points.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from metal_pathtracer_tpu_torch.ops.vecmath import fma
from metal_pathtracer_tpu_torch.schema import TextureArrays

DEFAULT_CAP = 2048


def _srgb_to_linear(x: np.ndarray) -> np.ndarray:
    a = x / 255.0
    return np.where(a <= 0.04045, a / 12.92, ((a + 0.055) / 1.055) ** 2.4)


def _pow2_snap(n: int, cap: int) -> int:
    p = 1
    while p * 2 <= min(n, cap):
        p *= 2
    if p < cap and (n - p) > (p * 2 - n):
        p *= 2
    return min(p, cap)


def build_texture_arrays(images: List[np.ndarray], srgb_flags: List[bool],
                         wrap_modes: Optional[List] = None,
                         cap: int = DEFAULT_CAP,
                         device="cuda") -> Optional[TextureArrays]:
    """The flat native-resolution mip atlas of ``images`` ((H,W,4) uint8
    RGBA each) on ``device``; None for no images. An image whose sides
    are not powers of two no larger than ``cap`` would need a resample,
    which the image loaders bring (ROADMAP Queue 1, step 10)."""
    if not images:
        return None
    flat_chunks, offsets, widths, heights, counts, sizes0 = \
        [], [], [], [], [], []
    total = 0
    for img, srgb in zip(images, srgb_flags):
        w = _pow2_snap(img.shape[1], cap)
        h = _pow2_snap(img.shape[0], cap)
        if (img.shape[1], img.shape[0]) != (w, h):
            raise NotImplementedError(
                f"a {img.shape[1]}x{img.shape[0]} texture needs a resample "
                f"to {w}x{h}: ROADMAP Queue 1, step 10 (image loaders)")
        arr = img.astype(np.float32)
        base = np.zeros((h, w, 4), np.float32)
        if srgb:
            base[..., :3] = _srgb_to_linear(arr[..., :3])
        else:
            base[..., :3] = arr[..., :3] / 255.0
        base[..., 3] = arr[..., 3] / 255.0

        levels = [base]
        cur = base
        while max(cur.shape[0], cur.shape[1]) > 1:
            h2 = max(cur.shape[0] // 2, 1)
            w2 = max(cur.shape[1] // 2, 1)
            trimmed = cur[:h2 * 2 if cur.shape[0] > 1 else 1,
                          :w2 * 2 if cur.shape[1] > 1 else 1]
            if cur.shape[0] > 1 and cur.shape[1] > 1:
                cur = trimmed.reshape(h2, 2, w2, 2, 4).mean((1, 3))
            elif cur.shape[0] > 1:
                cur = trimmed.reshape(h2, 2, 1, 1, 4).mean(1)[:, 0]
                cur = cur.reshape(h2, 1, 4)
            else:
                cur = trimmed.reshape(1, w2, 2, 4).mean(2)
            cur = cur.astype(np.float32)
            levels.append(cur)

        offs, ws, hs = [], [], []
        for lv in levels:
            offs.append(total)
            ws.append(lv.shape[1])
            hs.append(lv.shape[0])
            flat_chunks.append(lv.reshape(-1, 4))
            total += lv.shape[0] * lv.shape[1]
        offsets.append(offs)
        widths.append(ws)
        heights.append(hs)
        counts.append(len(levels))
        sizes0.append(float(max(w, h)))

    max_levels = max(counts)
    n_tex = len(images)
    off_t = np.zeros((n_tex, max_levels), np.int32)
    w_t = np.ones((n_tex, max_levels), np.int32)
    h_t = np.ones((n_tex, max_levels), np.int32)
    for i in range(n_tex):
        k = counts[i]
        off_t[i, :k] = offsets[i]
        w_t[i, :k] = widths[i]
        h_t[i, :k] = heights[i]
        # out-of-range levels repeat the last (1x1) level
        off_t[i, k:] = offsets[i][-1]
    wrap = np.zeros((n_tex, 2), np.int32) if wrap_modes is None \
        else np.asarray(wrap_modes, np.int32)
    t = lambda a: torch.as_tensor(a, device=device)
    return TextureArrays(
        texels=t(np.concatenate(flat_chunks, 0)), level_offset=t(off_t),
        level_w=t(w_t), level_h=t(h_t),
        n_levels=t(np.asarray(counts, np.int32)),
        size0=t(np.asarray(sizes0, np.float32)), wrap_mode=t(wrap),
        n_textures=n_tex, max_levels=max_levels)


def _address(coord, size, mode):
    """Texel addressing per lane: 0 repeat, 1 clamp, 2 mirror (floor-mod,
    so negative coordinates wrap as ``jnp.mod`` does)."""
    wrapped = torch.remainder(coord, size)
    clamped = torch.minimum(torch.clamp_min(coord, 0), size - 1)
    period = 2 * size
    m = torch.remainder(coord, period)
    mirrored = torch.where(m < size, m, period - 1 - m)
    return torch.where(mode == 0, wrapped,
                       torch.where(mode == 1, clamped, mirrored))


def _lerp(a, b, f):
    """``a * (1 - f) + b * f`` with the second product fused, the
    placement that agrees most often with the jitted reference."""
    return fma(b, f, a * (1.0 - f))


def _bilinear_level(textures: TextureArrays, tid, level, u, v, wrap_s,
                    wrap_t):
    """4-tap bilinear at a per-lane (texture, level) into the flat atlas."""
    tid_l, lvl_l = tid.long(), level.long()
    off = textures.level_offset[tid_l, lvl_l].long()
    w = textures.level_w[tid_l, lvl_l]
    h = textures.level_h[tid_l, lvl_l]
    x = fma(u, w.to(torch.float32), -0.5)
    y = fma(v, h.to(torch.float32), -0.5)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)
    xa = _address(x0i, w, wrap_s).long()
    xb = _address(x0i + 1, w, wrap_s).long()
    ya = _address(y0i, h, wrap_t).long()
    yb = _address(y0i + 1, h, wrap_t).long()
    wl = w.long()
    c00 = textures.texels[off + ya * wl + xa]
    c10 = textures.texels[off + ya * wl + xb]
    c01 = textures.texels[off + yb * wl + xa]
    c11 = textures.texels[off + yb * wl + xb]
    return _lerp(_lerp(c00, c10, fx), _lerp(c01, c11, fx), fy)


def sample_texture(textures: TextureArrays, tex_id, u, v, lod=None):
    """Trilinear RGBA sample at per-lane texture ids, uv and LOD (bilinear
    at level 0 without one); lanes with ``tex_id`` < 0 read white (the
    reference binds a 1x1 white fallback)."""
    valid = tex_id >= 0
    tid = torch.clamp(tex_id, 0, textures.n_textures - 1).long()
    wrap_s = textures.wrap_mode[tid, 0]
    wrap_t = textures.wrap_mode[tid, 1]
    top_level = textures.n_levels[tid] - 1
    if lod is None:
        color = _bilinear_level(textures, tid, torch.zeros_like(tid), u, v,
                                wrap_s, wrap_t)
    else:
        lod = torch.minimum(torch.clamp_min(lod, 0.0),
                            top_level.to(torch.float32))
        lo = torch.floor(lod).to(torch.int32)
        hi = torch.minimum(lo + 1, top_level)
        frac = (lod - lo.to(torch.float32))[..., None]
        c_lo = _bilinear_level(textures, tid, lo, u, v, wrap_s, wrap_t)
        c_hi = _bilinear_level(textures, tid, hi, u, v, wrap_s, wrap_t)
        color = _lerp(c_lo, c_hi, frac)
    return torch.where(valid[..., None], color, torch.ones_like(color))


def texture_lod_scale(textures: TextureArrays, tex_id):
    """Per-lane native size: texel footprint = world footprint x uv
    density x this."""
    return textures.size0[torch.clamp(tex_id, 0,
                                      textures.n_textures - 1).long()]


def apply_uv_transform(transform, u, v):
    """KHR_texture_transform 2x3 affine rows per lane."""
    nu = fma(transform[..., 0, 0], u, transform[..., 0, 1] * v) \
        + transform[..., 0, 2]
    nv = fma(transform[..., 1, 0], u, transform[..., 1, 1] * v) \
        + transform[..., 1, 2]
    return nu, nv
