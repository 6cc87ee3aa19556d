"""The à-trous iterations of the denoisers, as CUDA launches.

The JAX package's three tap filters (``ops/denoise.py`` ``atrous_denoise
:25``, ``svgf_denoise:79``, ``learned_denoise:157``) are XLA, not Pallas:
each iteration is 25 ``jnp.roll``s of four planes and a few dozen
elementwise operations a tap, so not a TPU kernel there, like the
texture pre-stage. Here a filter (``atrous_filter``) is one ``pack``
launch, which lays the state out in 16-byte rows (colour and variance
as one float4 a pixel, albedo and normal as two), then one launch of
``csrc/denoise.cu`` ``atrous_step_kernel<MODE>`` an iteration
(``atrous_step_packed``): a block of 32 x 8 threads takes one coset of
the step, stages its 12 x 36 lattice tile of taps once in shared memory
(the toroidal wrap, ``jnp.roll``'s true modulo, taken once a tile point
at its load), fuses the variance prologue (``_gauss3`` of the luminance
variance, ``denom`` or ``gstd``), runs the 25 taps from the tile, and
writes the carried float4s, or at the last iteration the (H, W, 3)
colour and (H, W) variance. The learned filter's 6-16-1 MLP runs per tap
with its weights and the per-launch ``p4 + p5`` table
(``mlp_constants``) as constant-bank operands. The bound is instruction
throughput: 222 float operations a tap for ``LEARNED`` (293 before the
constant terms, the tap normal's n.n and the radius feature were
hoisted), 43 and 45 for ``FIXED`` and ``SVGF``, each its own instruction
(``--fmad=false``).

``atrous_step`` keeps the per-iteration contract on (H, W, 3) tensors
(one ``pack`` launch, then one step launch); the chip checks hold each
iteration of either entry against ``ops/denoise.atrous_step_reference``.
Every wrapper runs its plain version on CPU tensors and launches its
kernel or raises on CUDA tensors. The host-side constants
(``StepParams``) are the JAX package's Python doubles rounded once to
float32, as they are when they meet an array there; the kernel divides
by them as the plain version does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from metal_pathtracer_tpu_torch.ops.kernels import build

#: filter modes, ``MODE`` of ``atrous_step_kernel``
FIXED, SVGF, LEARNED = 0, 1, 2
#: the learned filter's MLP packed as ``pack_mlp`` lays it out: w1 (6, 16)
#: row by row, b1 (16), w2 (16), b2 (1)
MLP_FLOATS = 6 * 16 + 16 + 16 + 1
#: ``csrc/denoise.cu MlpConst``: w1's first four rows (64), b1, w2, b2 and
#: 3 pads, the (p4 + p5) table (5, 16)
MLP_CONST_FLOATS = 64 + 16 + 16 + 4 + 80
#: the kernel's block (BX x BY threads) and lattice tile (TX x TY points)
BX, BY = 32, 8
TX, TY = BX + 4, BY + 4
TILE = TX * TY


def _f32(x: float) -> float:
    """A Python double rounded once to float32."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class StepParams:
    """One iteration's launch constants: the mode, the tap step and the
    eight float32 scalars of ``csrc/denoise.cu StepScalars`` (the colour,
    normal and albedo divisors of the fixed filter, SVGF's luminance
    sigma and normal exponent, the learned filter's iteration feature)."""

    mode: int
    step: int
    c_color: float = 0.0
    c_normal: float = 0.0
    c_albedo: float = 0.0
    sigma_lum: float = 0.0
    normal_pow: float = 0.0
    it_feature: float = 0.0

    @classmethod
    def fixed(cls, step, c_color, c_normal, c_albedo) -> "StepParams":
        return cls(FIXED, step, c_color=_f32(c_color),
                   c_normal=_f32(c_normal), c_albedo=_f32(c_albedo))

    @classmethod
    def svgf(cls, step, sigma_lum, normal_pow, c_albedo) -> "StepParams":
        return cls(SVGF, step, c_albedo=_f32(c_albedo),
                   sigma_lum=_f32(sigma_lum), normal_pow=_f32(normal_pow))

    @classmethod
    def learned(cls, step, it_feature) -> "StepParams":
        return cls(LEARNED, step, it_feature=_f32(it_feature))

    def scalars(self):
        return [self.c_color, self.c_normal, self.c_albedo, self.sigma_lum,
                self.normal_pow, self.it_feature, 0.0, 0.0]


#: params["w1"] -> (b1, w2, b2, their versions, the packed tensor)
_PACKED = WeakIdKeyDictionary()
#: packed tensor -> (its version, its floats on the host)
_HOST = WeakIdKeyDictionary()


def pack_mlp(params: dict) -> torch.Tensor:
    """The tap MLP's weights as one contiguous (129,) float32 tensor on
    their device (``MLP_FLOATS``'s order); the same tensor again for the
    same, unchanged weight tensors, so its host copy (``mlp_host``) is
    made once."""
    ws = [params[k] for k in ("w1", "b1", "w2", "b2")]
    versions = tuple(x._version for x in ws)
    got = _PACKED.get(ws[0])
    if got is not None and all(a is b for a, b in zip(got[:3], ws[1:])) \
            and got[3] == versions:
        return got[4]
    packed = torch.cat([x.reshape(-1) for x in ws]).to(
        torch.float32).contiguous()
    _PACKED[ws[0]] = (*ws[1:], versions, packed)
    return packed


def mlp_host(mlp: torch.Tensor) -> np.ndarray:
    """The packed MLP's floats on the host: copied once a tensor (and
    again after an in-place change), so a filter's launches read no
    device memory back."""
    got = _HOST.get(mlp)
    if got is None or got[0] != mlp._version:
        got = (mlp._version,
               mlp.detach().to("cpu", torch.float32).numpy().copy())
        _HOST[mlp] = got
    return got[1]


def mlp_constants(mlp: np.ndarray, it_feature: float) -> np.ndarray:
    """``csrc/denoise.cu MlpConst`` of one learned launch, (180,) float32:
    w1's first four rows, b1, w2, b2, three zeros, then row r of the
    (p4 + p5) table, ``it_feature w1[4] + (r / 4) w1[5]`` in float32 (each
    product rounded, then the sum), for r = abs(ky) + abs(kx) = 0..4: the
    terms ``ops/denoise._mlp_logit`` adds as (p4 + p5), the same bits
    (``ops/denoise._mlp_table`` is the plain twin)."""
    mlp = np.asarray(mlp, np.float32)
    w1 = mlp[:96].reshape(6, 16)
    radius = (np.arange(5, dtype=np.float32) * np.float32(0.25))[:, None]
    table = np.float32(it_feature) * w1[4] + radius * w1[5]
    return np.concatenate([w1[:4].reshape(-1), mlp[96:129],
                           np.zeros(3, np.float32), table.reshape(-1)]
                          ).astype(np.float32)


def atrous_grid(h: int, w: int, step: int):
    """The step kernel's grid: (cosets down, cosets across, lattice tiles
    down, lattice tiles across); block b takes coset b mod (cy cx) (row
    major) and lattice tile b // (cy cx) (row major)."""
    cy, cx = min(step, h), min(step, w)
    tiles_y = (-(-h // step) + BY - 1) // BY
    tiles_x = (-(-w // step) + BX - 1) // BX
    return cy, cx, tiles_y, tiles_x


def atrous_tiles(h: int, w: int, step: int, blocks=None):
    """The step kernel's addressing, as ``csrc/denoise.cu`` computes it,
    for the blocks ``blocks`` (default: all): (the flat source pixel y w
    + x of each tile point, (B, TILE) int64, the wrap taken at the load;
    each thread's pixel, (B, BY BX) int64, -1 where the thread has none;
    each thread's 25 tap slots in the tile, (BY BX, 25) int64, taps in
    (ky, kx) row-major order). Tap (ky, kx) of the pixel (y, x) is the
    ``torch.roll`` source (y - ky step, x - kx step) mod (h, w)."""
    cy, cx, tiles_y, tiles_x = atrous_grid(h, w, step)
    if blocks is None:
        blocks = torch.arange(cy * cx * tiles_y * tiles_x)
    blocks = torch.as_tensor(blocks, dtype=torch.int64)
    coset, tile = blocks % (cy * cx), blocks // (cy * cx)
    ry, rx = coset // cx, coset % cx
    u0, v0 = (tile // tiles_x) * BY, (tile % tiles_x) * BX
    a = torch.arange(TY).repeat_interleave(TX)
    b = torch.arange(TX).repeat(TY)
    ys = (ry[:, None] + step * (u0[:, None] - 2 + a)) % h
    xs = (rx[:, None] + step * (v0[:, None] - 2 + b)) % w
    ty = torch.arange(BY).repeat_interleave(BX)
    tx = torch.arange(BX).repeat(BY)
    y = ry[:, None] + step * (u0[:, None] + ty)
    x = rx[:, None] + step * (v0[:, None] + tx)
    pixel = torch.where((y < h) & (x < w), y * w + x, -1)
    i = torch.arange(5).repeat_interleave(5)
    j = torch.arange(5).repeat(5)
    slots = (ty[:, None] + 4 - i) * TX + tx[:, None] + 4 - j
    return ys * w + xs, pixel, slots


def _check(color, var, albedo, normal, p, mlp):
    h, w = color.shape[:2]
    need = [("color", color, (h, w, 3)), ("albedo", albedo, (h, w, 3)),
            ("normal", normal, (h, w, 3))]
    if p.mode != FIXED:
        need.append(("variance", var, (h, w)))
    if p.mode == LEARNED:
        need.append(("mlp", mlp, (MLP_FLOATS,)))
    _check_need("atrous_step", need, color.device)


def _check_need(who, need, device):
    for name, x, shape in need:
        if x is None or tuple(x.shape) != shape \
                or x.dtype != torch.float32 or not x.is_contiguous() \
                or x.device != device:
            raise ValueError(
                f"{who}: {name} must be a contiguous float32 {shape} "
                f"tensor on {device}, got "
                f"{None if x is None else (tuple(x.shape), x.dtype)}")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def pack(color, var, albedo, normal):
    """A filter's rows (a bit copy): (cv (H, W, 4): colour and the
    luminance variance, 0 without one; guide (H, W, 8): albedo, 0, normal,
    n.n). CPU tensors run ``ops/denoise.pack_reference``; CUDA tensors
    launch ``atrous_pack_kernel``."""
    dev = color.device
    if dev.type == "cpu":
        from metal_pathtracer_tpu_torch.ops.denoise import pack_reference
        return pack_reference(color, var, albedo, normal)
    if dev.type != "cuda":
        raise ValueError(f"pack: unsupported device {dev}")
    h, w = color.shape[:2]
    need = [("color", color, (h, w, 3)), ("albedo", albedo, (h, w, 3)),
            ("normal", normal, (h, w, 3))]
    if var is not None:
        need.append(("variance", var, (h, w)))
    _check_need("pack", need, dev)
    cv = torch.empty((h, w, 4), dtype=torch.float32, device=dev)
    guide = torch.empty((h, w, 8), dtype=torch.float32, device=dev)
    err = build.load().mpt_atrous_pack(
        h * w, _ptr(color), _ptr(var), _ptr(albedo), _ptr(normal),
        _ptr(cv), _ptr(guide), _stream(dev))
    build.check(err, "mpt_atrous_pack")
    pack.launches += 1
    return cv, guide


#: pack launches since the last reset
pack.launches = 0


def _launch_step(cv, guide, p, mlp, out_cv, out_color, out_var):
    h, w = cv.shape[:2]
    consts = None
    if p.mode == LEARNED:
        consts = np.ascontiguousarray(
            mlp_constants(mlp_host(mlp), p.it_feature))
    err = build.load().mpt_atrous_step(
        p.mode, h, w, p.step, build.floats(p.scalars()),
        None if consts is None else consts.ctypes.data, _ptr(cv),
        _ptr(guide), _ptr(out_cv), _ptr(out_color), _ptr(out_var),
        _stream(cv.device))
    build.check(err, "mpt_atrous_step")
    atrous_step.launches += 1


def atrous_step_packed(cv, guide, p: StepParams, mlp=None,
                       last: bool = False):
    """One iteration at step ``p.step`` on a filter's rows (``pack``):
    the next (H, W, 4) float4s, or with ``last`` (colour (H, W, 3),
    variance (H, W) or None in ``FIXED`` mode). ``mlp`` is the packed MLP
    (``LEARNED``). CPU tensors run
    ``ops/denoise.atrous_step_packed_reference``; CUDA tensors launch
    ``csrc/denoise.cu``."""
    dev = cv.device
    if dev.type == "cpu":
        from metal_pathtracer_tpu_torch.ops.denoise import (
            atrous_step_packed_reference,
        )
        return atrous_step_packed_reference(cv, guide, p, mlp, last)
    if dev.type != "cuda":
        raise ValueError(f"atrous_step_packed: unsupported device {dev}")
    h, w = cv.shape[:2]
    need = [("cv", cv, (h, w, 4)), ("guide", guide, (h, w, 8))]
    if p.mode == LEARNED:
        need.append(("mlp", mlp, (MLP_FLOATS,)))
    _check_need("atrous_step_packed", need, dev)
    build.check_aligned("atrous_step_packed", (cv, guide), 16)
    if not last:
        out = torch.empty_like(cv)
        _launch_step(cv, guide, p, mlp, out, None, None)
        return out
    out = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    out_var = None if p.mode == FIXED else torch.empty(
        (h, w), dtype=torch.float32, device=dev)
    _launch_step(cv, guide, p, mlp, None, out, out_var)
    return out, out_var


def atrous_step(color, var, albedo, normal, p: StepParams, mlp=None):
    """One iteration at step ``p.step``: (colour (H, W, 3), variance (H,
    W) or None in ``FIXED`` mode). ``var`` is the luminance variance
    (``SVGF``, ``LEARNED``), ``mlp`` the packed MLP (``LEARNED``). CPU
    tensors run the plain version; CUDA tensors launch ``pack`` and one
    step of ``csrc/denoise.cu``."""
    dev = color.device
    if dev.type == "cpu":
        from metal_pathtracer_tpu_torch.ops.denoise import (
            atrous_step_reference,
        )
        return atrous_step_reference(color, var, albedo, normal, p, mlp)
    if dev.type != "cuda":
        raise ValueError(f"atrous_step: unsupported device {dev}")
    _check(color, var, albedo, normal, p, mlp)
    cv, guide = pack(color, None if p.mode == FIXED else var, albedo,
                     normal)
    return atrous_step_packed(cv, guide, p, mlp, last=True)


#: step launches since the last reset (``atrous_step`` and
#: ``atrous_step_packed`` launch the same kernel)
atrous_step.launches = 0


def atrous_filter(color, var, albedo, normal, steps, mlp=None):
    """A whole filter: the iterations ``steps`` (``StepParams``, one mode)
    over colour (H, W, 3) and, in the variance-guided modes, the luminance
    variance (H, W): one ``pack``, then ``atrous_step_packed`` an
    iteration. Returns (colour (H, W, 3), variance (H, W) or None)."""
    steps = list(steps)
    if not steps:
        return color, var
    cv, guide = pack(color, None if steps[0].mode == FIXED else var, albedo,
                     normal)
    for k, p in enumerate(steps):
        cv = atrous_step_packed(cv, guide, p, mlp, last=k == len(steps) - 1)
    return cv
