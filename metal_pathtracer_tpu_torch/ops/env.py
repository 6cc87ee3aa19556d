"""Environment lighting: HDR load, mip chain, alias-table importance
sampling, equirect lookup (``ops/env.py`` twin).

The host build is the JAX package's numpy code, operation for operation,
so mips, alias tables, pdf and packed rows come out bit-identical
(reference: src/renderer/EnvImportanceSampler.mm:16-236). The device-side
lookups are torch ops over the wavefront: the JAX package runs them as
XLA around its shade kernel too (``ops/pallas/shade.py:3176-3199,
3294-3310``). Only the packed-row paths and the texel-exact NEE radiance
are ported: they are the JAX package's defaults, and its switches back to
the unpacked tables (``MPT_ENV_PACKED``, ``MPT_ENV_TEXEL``) exist for
timing experiments on the TPU.

Contraction: the bilinear and trilinear blends are written with
``vecmath.fma`` where XLA:CPU fuses them (``a*b + c*d`` ->
``fma(a, b, c*d)``); divisions go through ``vecmath.fdiv``. The lookups
agree with the JAX package's to within the ulps of XLA:CPU's own
``atan2``/``asin``/``sin``/``cos`` (``tests/test_torch_env.py`` states
the bounds).
"""

from __future__ import annotations

import functools
import os
from typing import List, Tuple

import numpy as np
import torch

from metal_pathtracer_tpu_torch.constants import LUMINANCE_WEIGHTS
from metal_pathtracer_tpu_torch.ops.vecmath import (
    fdiv,
    fma,
    linear_srgb_to_acescg,
    normalize,
)
from metal_pathtracer_tpu_torch.schema import EnvironmentSoA

PI = np.pi
_UCLAMP = 0.99999994


# ---------------------------------------------------------------------------
# HDR image loading
# ---------------------------------------------------------------------------

def _load_radiance_hdr(path: str) -> np.ndarray:
    """Radiance RGBE (.hdr) decoder -> (H,W,3) float32 linear."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"not a Radiance HDR file: {path}")
    pos = data.index(b"\n\n") + 2
    dim_end = data.index(b"\n", pos)
    dims = data[pos:dim_end].decode("ascii").split()
    if dims[0] != "-Y" or dims[2] != "+X":
        raise ValueError(f"unsupported HDR orientation: {' '.join(dims)}")
    height, width = int(dims[1]), int(dims[3])
    pos = dim_end + 1

    rgbe = np.zeros((height, width, 4), np.uint8)
    buf = memoryview(data)
    for y in range(height):
        if pos + 4 <= len(data) and buf[pos] == 2 and buf[pos + 1] == 2 \
                and ((buf[pos + 2] << 8) | buf[pos + 3]) == width:
            # new-style RLE scanline
            pos += 4
            for c in range(4):
                x = 0
                while x < width:
                    count = buf[pos]
                    pos += 1
                    if count > 128:
                        run = count - 128
                        rgbe[y, x:x + run, c] = buf[pos]
                        pos += 1
                        x += run
                    else:
                        rgbe[y, x:x + count, c] = np.frombuffer(
                            buf[pos:pos + count], np.uint8)
                        pos += count
                        x += count
        else:
            # flat scanline
            row = np.frombuffer(buf[pos:pos + width * 4], np.uint8)
            rgbe[y] = row.reshape(width, 4)
            pos += width * 4

    mantissa = rgbe[..., :3].astype(np.float32)
    exponent = rgbe[..., 3].astype(np.int32)
    scale = np.where(exponent > 0,
                     np.ldexp(1.0, exponent - 136).astype(np.float32), 0.0)
    return mantissa * scale[..., None]


def load_hdr_image(path: str) -> np.ndarray:
    """(H,W,3) float32 linear radiance, the JAX package's ``load_hdr_image``
    bit for bit: .hdr, .pfm or uncompressed .exr (``image_io.read_exr``
    first, as ``env.py:90-102`` does); PNG and JPEG skies whose imageio
    array is the RGB or RGBA channels of the port's own decoder
    (``image_io.imageio_channels``: 8- and 16-bit RGB and RGBA, palette,
    16-bit grey + alpha, three-component JPEG) through that decoder on
    every host, so the card and the CPU read the same bits, with the JAX
    rule applied as it is there: above 64 in any channel imageio returns,
    alpha included, the whole array becomes ``(img / 255) ** 2.2``
    (float32) before its first three channels are kept. Other formats
    (grey PNG, 8-bit grey + alpha, grey or CMYK JPEG, compressed EXR) go
    through imageio where it is installed and raise ``ValueError`` naming
    the kind where it is not."""
    from metal_pathtracer_tpu_torch.utils import image_io

    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        return _load_radiance_hdr(path)
    if ext == ".pfm":
        img = image_io.read_pfm(path)
        return img if img.shape[-1] == 3 else np.repeat(img, 3, -1)
    kind = "a compressed or non-float EXR"
    if ext == ".exr":
        try:
            ch = image_io.read_exr(path)
            return np.stack([ch["R"], ch["G"], ch["B"]], -1)
        except (ValueError, KeyError):
            pass  # compressed or not RGB float: imageio below
    else:
        with open(path, "rb") as fh:
            data = fh.read()
        channels, kind = image_io.imageio_channels(data)
        if channels is not None:
            img = image_io.decode_image(data)[..., :channels].astype(
                np.float32)
            if img.max() > 64.0:
                img = (img / 255.0) ** 2.2
            return img[..., :3]
    try:
        import imageio.v3 as iio
    except ImportError as exc:
        raise ValueError(f"environment map {path} is {kind}, which only "
                         "imageio reads here, and imageio is not "
                         "installed") from exc
    img = np.asarray(iio.imread(path), np.float32)
    if ext != ".exr" and img.max() > 64.0:
        img = (img / 255.0) ** 2.2
    return img[..., :3]


def build_mips(texels: np.ndarray) -> List[np.ndarray]:
    """Box-filter mip chain down to 1x1 (the reference blits a full chain,
    SceneResources.mm:1490-1609)."""
    mips = []
    cur = texels
    while min(cur.shape[0], cur.shape[1]) > 1:
        h, w = cur.shape[:2]
        h2, w2 = max(h // 2, 1), max(w // 2, 1)
        trimmed = cur[:h2 * 2, :w2 * 2]
        cur = trimmed.reshape(h2, 2, w2, 2, 3).mean((1, 3)).astype(np.float32)
        mips.append(cur)
    return mips


# ---------------------------------------------------------------------------
# Alias tables (Vose) — numerical twin of BuildAliasTable
# ---------------------------------------------------------------------------

def build_alias_table(probabilities: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(reference: EnvImportanceSampler.mm BuildAliasTable:16-66)"""
    n = len(probabilities)
    alias = np.zeros(n, np.uint32)
    threshold = np.zeros(n, np.float32)
    if n == 0:
        return alias, threshold
    scaled = (probabilities.astype(np.float64) * n).astype(np.float32)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large[-1]
        threshold[s] = min(max(scaled[s], 0.0), 1.0)
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        if scaled[l] < 1.0 - 1e-7:
            small.append(l)
            large.pop()
    for i in small + large:
        threshold[i] = 1.0
        alias[i] = i
    return alias, threshold


def build_distribution(texels: np.ndarray):
    """Luminance x solid-angle weights -> marginal/conditional alias tables
    + per-texel solid-angle pdf
    (reference: EnvImportanceSampler.mm BuildEnvImportanceDistribution:68-170)."""
    height, width = texels.shape[:2]
    d_theta = PI / height
    d_phi = (2.0 * PI) / width

    lum = texels @ np.asarray(LUMINANCE_WEIGHTS, np.float32)
    theta = (np.arange(height) + 0.5) * d_theta
    cell_solid = np.maximum(np.sin(theta), 0.0) * d_theta * d_phi  # (H,)
    weights = np.maximum(lum, 0.0) * cell_solid[:, None]
    row_weights = weights.sum(1)
    total = float(weights.sum())
    if total <= 0.0:
        raise ValueError("Environment map contains no positive radiance")

    marginal_prob = np.where(row_weights > 0.0, row_weights / total, 0.0)
    marginal_alias, marginal_threshold = build_alias_table(
        marginal_prob.astype(np.float32))

    cond_alias = np.zeros((height, width), np.uint32)
    cond_threshold = np.zeros((height, width), np.float32)
    for y in range(height):
        if row_weights[y] > 0.0:
            p = weights[y] / row_weights[y]
        else:
            p = np.full(width, 1.0 / width, np.float32)
        a, t = build_alias_table(p.astype(np.float32))
        cond_alias[y] = a
        cond_threshold[y] = t

    prob = weights / total
    pdf = np.where(cell_solid[:, None] > 0.0, prob / cell_solid[:, None], 0.0)
    return (marginal_alias, marginal_threshold, cond_alias, cond_threshold,
            pdf.astype(np.float32))


def load_environment(path: str, device="cuda") -> EnvironmentSoA:
    return environment_from_texels(load_hdr_image(path), device)


def environment_from_texels(texels: np.ndarray,
                            device="cuda") -> EnvironmentSoA:
    """The full EnvironmentSoA (mips, alias tables, pdf and the packed
    rows) from an in-memory (H,W,3) linear-radiance array, on ``device``."""
    texels = np.asarray(texels, np.float32)
    mips = build_mips(texels)
    (marg_alias, marg_thresh, cond_alias, cond_thresh, pdf) = \
        build_distribution(texels)
    # flat mip atlas: every level, mip0 first, row-major
    levels = [texels] + list(mips)
    meta = []
    off = 0
    for m in levels:
        meta.append((off, int(m.shape[0]), int(m.shape[1])))
        off += int(m.shape[0]) * int(m.shape[1])
    flat = np.concatenate([m.reshape(-1, 3) for m in levels], 0)

    # quad atlas: each texel's bilinear footprint [c00, c10, c01, c11] with
    # wrap addressing on both axes, one 12-wide row per texel
    def quads(m):
        right = np.roll(m, -1, axis=1)
        down = np.roll(m, -1, axis=0)
        down_right = np.roll(right, -1, axis=0)
        return np.concatenate([m, right, down, down_right],
                              -1).reshape(-1, 12)

    flat_quads = np.concatenate([quads(m) for m in levels], 0)
    cond_packed = np.stack([cond_thresh,
                            cond_alias.astype(np.float32), pdf], -1)
    marg_packed = np.stack([marg_thresh,
                            marg_alias.astype(np.float32)], -1)
    nee_packed = np.concatenate([pdf[..., None], texels], -1)
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return EnvironmentSoA(
        texels=f(texels),
        mips=tuple(f(m) for m in mips),
        marginal_threshold=f(marg_thresh),
        marginal_alias=f(marg_alias.astype(np.int32)),
        conditional_threshold=f(cond_thresh),
        conditional_alias=f(cond_alias.astype(np.int32)),
        pdf=f(pdf),
        width=int(texels.shape[1]),
        height=int(texels.shape[0]),
        flat_mips=f(flat),
        mip_meta=tuple(meta),
        flat_quads=f(flat_quads),
        cond_packed=f(cond_packed),
        marg_packed=f(marg_packed),
        nee_packed=f(nee_packed),
    )


# ---------------------------------------------------------------------------
# Device-side lookup (torch)
# ---------------------------------------------------------------------------

def _scalar_trig(angle: float):
    """float32 cos and sin of a host angle, as the reference computes them
    on a () f32 array."""
    a = torch.tensor(angle, dtype=torch.float32)
    return float(torch.cos(a)), float(torch.sin(a))


def _to_working_space(color, static):
    if static.working_color_space == 1:
        return linear_srgb_to_acescg(color)
    return color


def direction_to_uv(direction, rotation: float):
    """Equirect mapping with Y-axis rotation
    (reference: pathtrace.metal environment_color:1372-1386)."""
    unit = normalize(direction)
    cos_t, sin_t = _scalar_trig(rotation)
    ux, uy, uz = unit[..., 0], unit[..., 1], unit[..., 2]
    # rounded products, unfused: measured closer to XLA:CPU's result here
    rx = ux * cos_t - uz * sin_t
    rz = ux * sin_t + uz * cos_t
    u = fdiv(torch.atan2(rz, rx) + PI, 2.0 * PI)
    v = 0.5 - fdiv(torch.asin(torch.clamp(uy, -1.0, 1.0)), PI)
    return u, v


def _bilinear_quads(env: EnvironmentSoA, off, h, w, u, v):
    """Bilinear sample with repeat addressing (texel centres at +0.5) from
    ONE quad-atlas row per lane; ``off``/``h``/``w`` pick the mip level
    (Python ints or per-lane int64 tensors)."""
    x = fma(u, w, -0.5)
    y = fma(v, h, -0.5)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.long(), w)
    y0i = torch.remainder(y0.long(), h)
    q = env.flat_quads[off + y0i * w + x0i]
    c00, c10, c01, c11 = q[..., 0:3], q[..., 3:6], q[..., 6:9], q[..., 9:12]
    top = fma(c00, 1.0 - fx, c10 * fx)
    bot = fma(c01, 1.0 - fx, c11 * fx)
    return fma(top, 1.0 - fy, bot * fy)


@functools.lru_cache(maxsize=8)
def _mip_table(mip_meta, device) -> torch.Tensor:
    """(levels, 3) int64 (offset, h, w) on ``device``, made once per
    environment: a host-to-device copy per lookup would cost the depth
    loop a host sync each time."""
    return torch.tensor(mip_meta, dtype=torch.int64, device=device)


def max_mip(env: EnvironmentSoA) -> float:
    return float(len(env.mips))


def environment_lod_from_roughness(roughness, env: EnvironmentSoA):
    """(reference: pathtrace.metal:1334-1344) lod = roughness^2 * maxMip"""
    mm = max_mip(env)
    alpha = torch.clamp(roughness, 0.0, 1.0)
    return torch.clamp(alpha * alpha * mm, 0.0, mm)


def environment_color(env: EnvironmentSoA, direction, rotation: float,
                      intensity: float, static, lod=None):
    """Equirect lookup, trilinear across the mip chain when ``lod`` is given
    (reference: pathtrace.metal environment_color(_lod):1372-1407).
    Trilinear at lod 0 equals the mip0 bilinear bit for bit, so the port
    always takes the trilinear form when a lod is given (the JAX package
    skips it when no lane has lod > 0)."""
    u, v = direction_to_uv(direction, rotation)
    h, w = env.height, env.width
    if lod is None:
        color = _bilinear_quads(env, 0, h, w, u, v)
    else:
        n_levels = len(env.mips) + 1
        lod = torch.clamp(lod, 0.0, float(n_levels - 1))
        lo = torch.floor(lod).long()
        frac = (lod - lo.to(torch.float32))[..., None]
        meta = _mip_table(env.mip_meta, direction.device)
        hi = torch.clamp_max(lo + 1, n_levels - 1)
        m_lo, m_hi = meta[lo], meta[hi]
        c_lo = _bilinear_quads(env, m_lo[..., 0], m_lo[..., 1], m_lo[..., 2],
                               u, v)
        c_hi = _bilinear_quads(env, m_hi[..., 0], m_hi[..., 1], m_hi[..., 2],
                               u, v)
        color = fma(c_lo, 1.0 - frac, c_hi * frac)
    return _to_working_space(color * intensity, static)


def environment_background(env: EnvironmentSoA, direction, uniforms, static,
                           env_lod, env_lod_active):
    """Miss-path background with the roughness-carried LOD
    (reference: pathtrace.metal:5806-5830)."""
    rot, inten = uniforms.environment_rotation, uniforms.environment_intensity
    if len(env.mips) == 0:
        return environment_color(env, direction, rot, inten, static)
    lod = torch.where(env_lod_active, env_lod, 0.0)
    override = uniforms.debug_env_mip_override
    if override >= 0.0:
        lod = torch.full_like(lod, max(override, 0.0))
    return environment_color(env, direction, rot, inten, static, lod=lod)


def environment_pdf(env: EnvironmentSoA, direction, rotation: float):
    """Per-texel solid-angle pdf (reference: pathtrace.metal
    environment_pdf:1444-1479), from the packed conditional rows."""
    u, v = direction_to_uv(direction, rotation)
    u = torch.clamp(u, 0.0, _UCLAMP)
    v = torch.clamp(v, 0.0, _UCLAMP)
    w, h = env.width, env.height
    x = torch.clamp_max((u * w).long(), w - 1)
    y = torch.clamp_max((v * h).long(), h - 1)
    value = env.cond_packed[y, x][..., 2]
    return torch.where(torch.isfinite(value) & (value > 0.0), value, 0.0)


def sample_environment_from_uniforms(env: EnvironmentSoA, u_marginal,
                                     u_conditional, u_jitter, uniforms,
                                     static):
    """Alias-table sample from three pre-drawn uniforms (reference:
    pathtrace.metal sample_environment:1494-1573), with texel-exact NEE
    radiance: the pdf and the radiance come from the sampled texel's
    ``nee_packed`` row. Returns (direction, radiance, pdf, valid)."""
    w, h = env.width, env.height
    row_choice = u_marginal * h
    row_floor = torch.floor(row_choice)
    row = torch.clamp_max(row_floor.long(), h - 1)
    row_frac = row_choice - row_floor
    mrow = env.marg_packed[row]
    row = torch.where(row_frac >= mrow[..., 0],
                      torch.clamp_max(mrow[..., 1].long(), h - 1), row)

    col_choice = u_conditional * w
    col_floor = torch.floor(col_choice)
    col = torch.clamp_max(col_floor.long(), w - 1)
    col_frac = col_choice - col_floor
    crow = env.cond_packed[row, col]
    col = torch.where(col_frac >= crow[..., 0],
                      torch.clamp_max(crow[..., 1].long(), w - 1), col)

    fx = fdiv(col.to(torch.float32)
              + (u_conditional - torch.floor(u_conditional)), float(w))
    fy = fdiv(row.to(torch.float32) + torch.clamp(u_jitter, 0.0, _UCLAMP),
              float(h))
    theta = fy * PI
    # DEVIATION from the reference, kept from the JAX package: phi =
    # fx*2pi - pi (the reference builds phi = fx*2pi, half a map away from
    # the texel every lookup maps that direction to)
    phi = fma(fx, 2.0 * PI, -PI)
    sin_t = torch.sin(theta)
    cos_t = torch.cos(theta)
    mx = sin_t * torch.cos(phi)
    my = cos_t
    mz = sin_t * torch.sin(phi)
    cos_r, sin_r = _scalar_trig(uniforms.environment_rotation)
    world_dir = torch.stack([fma(mx, cos_r, mz * sin_r), my,
                             fma(-mx, sin_r, mz * cos_r)], -1)

    nrow = env.nee_packed[row, col]
    pdf = nrow[..., 0]
    radiance = _to_working_space(
        nrow[..., 1:4] * uniforms.environment_intensity, static)
    valid = (torch.isfinite(pdf) & (pdf > 0.0)
             & torch.isfinite(radiance).all(-1))
    radiance = torch.clamp_min(radiance, 0.0)
    return world_dir, radiance, torch.where(valid, pdf, 0.0), valid
