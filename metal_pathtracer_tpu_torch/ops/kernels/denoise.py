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

Training: in grad mode, with the colour, the variance or the packed MLP
requiring grad, ``atrous_filter`` runs a learned filter as one
``LearnedIteration`` (a ``torch.autograd.Function``) an iteration: its
forward is a pack, then the step with its weight-sum output (the same
colour and variance bits as the filter without grad), and it saves its
rows, its outputs and the weight sums; its backward,
``atrous_step_grad``, launches ``grad_taps`` (each tap once, from the
saved sums, its logit with the forward's bits: two warps over a group of
16 pixels of one coset, each with half of the MLP's hidden units and
their parameter sums, lanes 16-31 the mirrored taps; tap weights and
luminance adjoints as (25, H, W) planes, each pixel's own terms, a row
of the 129 parameter gradients a block of a one-wave persistent grid),
``grad_gather`` (each pixel sums what its tappers owe it: the colour and
variance cotangents) and ``grad_sum`` (the rows in a fixed order: no
atomics, so the same bits every launch). CPU tensors run autograd
through the plain version instead; the fixed and SVGF filters have no
backward kernel.

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
    made once. Weights that require grad, in grad mode, are packed afresh
    each call and not kept: the packed tensor carries their graph, which
    the first backward frees."""
    ws = [params[k] for k in ("w1", "b1", "w2", "b2")]
    if torch.is_grad_enabled() and any(x.requires_grad for x in ws):
        return torch.cat([x.reshape(-1) for x in ws]).to(torch.float32)
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


def _launch_step(cv, guide, p, mlp, out_cv, out_color, out_var,
                 out_wsum=None):
    h, w = cv.shape[:2]
    consts = None
    if p.mode == LEARNED:
        consts = np.ascontiguousarray(
            mlp_constants(mlp_host(mlp), p.it_feature))
    err = build.load().mpt_atrous_step(
        p.mode, h, w, p.step, build.floats(p.scalars()),
        None if consts is None else consts.ctypes.data, _ptr(cv),
        _ptr(guide), _ptr(out_cv), _ptr(out_color), _ptr(out_var),
        _ptr(out_wsum), _stream(cv.device))
    build.check(err, "mpt_atrous_step")
    atrous_step.launches += 1


def atrous_step_packed(cv, guide, p: StepParams, mlp=None,
                       last: bool = False, wsum: bool = False):
    """One iteration at step ``p.step`` on a filter's rows (``pack``):
    the next (H, W, 4) float4s, or with ``last`` (colour (H, W, 3),
    variance (H, W) or None in ``FIXED`` mode), and with ``wsum`` (a
    learned ``last`` iteration) each pixel's weight sum (H, W) after them,
    which its backward reads. ``mlp`` is the packed MLP (``LEARNED``). CPU
    tensors run ``ops/denoise.atrous_step_packed_reference``; CUDA tensors
    launch ``csrc/denoise.cu``."""
    dev = cv.device
    if wsum and (not last or p.mode != LEARNED):
        raise ValueError("atrous_step_packed: the weight sums are a learned "
                         "last iteration's output")
    if dev.type == "cpu":
        from metal_pathtracer_tpu_torch.ops.denoise import (
            atrous_step_packed_reference,
        )
        return atrous_step_packed_reference(cv, guide, p, mlp, last, wsum)
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
    if not wsum:
        _launch_step(cv, guide, p, mlp, None, out, out_var)
        return out, out_var
    sums = torch.empty((h, w), dtype=torch.float32, device=dev)
    _launch_step(cv, guide, p, mlp, None, out, out_var, sums)
    return out, out_var, sums


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


#: ``grad_taps``' kernel: a block is two warps (GRAD_THREADS) over one
#: group of GX x GY lattice points of a coset of the step, whose taps are
#: a GTX x GTY tile; lanes 16-31 take the mirrored taps (24 - t beside t)
#: in GRAD_STEPS steps
GRAD_THREADS = 64
GX, GY = 8, 2
GTX, GTY = GX + 4, GY + 4
GRAD_STEPS = 13


def grad_grid(h: int, w: int, step: int):
    """``grad_taps``' groups: (cosets down, cosets across, lattice tiles
    down, lattice tiles across); group g takes coset g mod (cy cx) and
    lattice tile g // (cy cx), both row major."""
    cy, cx = min(step, h), min(step, w)
    return (cy, cx, (-(-h // step) + GY - 1) // GY,
            (-(-w // step) + GX - 1) // GX)


def grad_tiles(h: int, w: int, step: int):
    """``grad_taps``' addressing, as ``csrc/denoise.cu`` computes it: (the
    flat source pixel of each group's tile points, (G, GTX GTY) int64, the
    wrap taken at the load; each lane's pixel, (G, 32) int64, -1 where the
    lane has none; each lane's tap (ky, kx row major) at each step, (32,
    GRAD_STEPS) int64, -1 where it has none (the mirror's centre); the
    tile slot it reads there, (32, GRAD_STEPS) int64)."""
    cy, cx, tiles_y, tiles_x = grad_grid(h, w, step)
    g = torch.arange(cy * cx * tiles_y * tiles_x)
    coset, tile = g % (cy * cx), g // (cy * cx)
    ry, rx = coset // cx, coset % cx
    u0, v0 = (tile // tiles_x) * GY, (tile % tiles_x) * GX
    a = torch.arange(GTY).repeat_interleave(GTX)
    b = torch.arange(GTX).repeat(GTY)
    ys = (ry[:, None] + step * (u0[:, None] - 2 + a)) % h
    xs = (rx[:, None] + step * (v0[:, None] - 2 + b)) % w
    lane = torch.arange(32)
    mirror, ty, tx = lane // 16, (lane // 8) % 2, lane % 8
    y = ry[:, None] + step * (u0[:, None] + ty)
    x = rx[:, None] + step * (v0[:, None] + tx)
    pixel = torch.where((y < h) & (x < w), y * w + x, -1)
    st = torch.arange(GRAD_STEPS)
    i, j = st // 5, st % 5
    m = mirror[:, None].bool()
    tap = torch.where(m, 24 - st, st)
    tap = torch.where(m & (st == GRAD_STEPS - 1), -1, tap)
    slots = torch.where(m, (ty[:, None] + i) * GTX + tx[:, None] + j,
                        (ty[:, None] + 4 - i) * GTX + tx[:, None] + 4 - j)
    return ys * w + xs, pixel, tap, slots


def grad_blocks(h: int, w: int, step: int) -> int:
    """The block count (and parameter rows) of ``grad_taps``' kernel at
    h x w and ``step`` on the current device: its groups, at most one
    wave (``mpt_atrous_grad_blocks``)."""
    blocks = build.load().mpt_atrous_grad_blocks(h, w, step)
    if blocks <= 0:
        raise RuntimeError(f"grad_blocks: no block count for {h}x{w} at "
                           f"step {step}")
    return blocks


def _cotangents(g_out, u_out, h, w, dev):
    g = torch.zeros((h, w, 3), dtype=torch.float32, device=dev) \
        if g_out is None else g_out.to(torch.float32).contiguous()
    u = None if u_out is None else u_out.to(torch.float32).contiguous()
    return g, u


def grad_taps(cv, guide, p: StepParams, mlp, g_out, u_out, saved):
    """The first backward kernel of a learned iteration (on its rows, the
    packed MLP, ``saved``: its forward's colour (H, W, 3), variance and
    weight sums (H, W) (``atrous_step_packed(..., wsum=True)``), and the
    cotangents of its colour and variance; ``u_out`` None for 0): (the tap
    weights and the adjoints of the tapped luminances, (25, H, W) each;
    dL/dA and dL/dV a pixel (H, W, 4); the adjoints of each pixel's own
    luminance and blurred variance (H, W, 2); parameter-gradient rows
    (R, 129), a row a block (``grad_blocks``) on CUDA, a row a pixel on
    the CPU). CPU tensors run ``ops/denoise.grad_taps_reference``; CUDA
    tensors launch ``csrc/denoise.cu atrous_grad_taps_kernel``."""
    dev = cv.device
    if dev.type == "cpu":
        from metal_pathtracer_tpu_torch.ops.denoise import (
            grad_taps_reference,
        )
        return grad_taps_reference(cv, guide, p, mlp, g_out, u_out, saved)
    if dev.type != "cuda":
        raise ValueError(f"grad_taps: unsupported device {dev}")
    if p.mode != LEARNED:
        raise ValueError("grad_taps: only the learned filter has a backward "
                         "kernel")
    h, w = cv.shape[:2]
    out, out_var, wsum = saved
    _check_need("grad_taps", [("cv", cv, (h, w, 4)),
                              ("guide", guide, (h, w, 8)),
                              ("mlp", mlp, (MLP_FLOATS,)),
                              ("out", out, (h, w, 3)),
                              ("out_var", out_var, (h, w)),
                              ("wsum", wsum, (h, w)),
                              ("g_out", g_out, (h, w, 3))]
                + ([] if u_out is None else [("u_out", u_out, (h, w))]),
                dev)
    build.check_aligned("grad_taps", (cv, guide), 16)
    blocks = grad_blocks(h, w, p.step)
    w_plane = torch.empty((25, h, w), dtype=torch.float32, device=dev)
    l_plane = torch.empty_like(w_plane)
    pix = torch.empty((h, w, 4), dtype=torch.float32, device=dev)
    pix2 = torch.empty((h, w, 2), dtype=torch.float32, device=dev)
    rows = torch.empty((blocks, MLP_FLOATS), dtype=torch.float32,
                       device=dev)
    consts = np.ascontiguousarray(mlp_constants(mlp_host(mlp),
                                                p.it_feature))
    err = build.load().mpt_atrous_grad_taps(
        h, w, p.step, build.floats(p.scalars()), consts.ctypes.data,
        _ptr(cv), _ptr(guide), _ptr(out), _ptr(out_var), _ptr(wsum),
        _ptr(g_out), _ptr(u_out), _ptr(w_plane), _ptr(l_plane), _ptr(pix),
        _ptr(pix2), _ptr(rows), blocks, _stream(dev))
    build.check(err, "mpt_atrous_grad_taps")
    grad_taps.launches += 1
    return w_plane, l_plane, pix, pix2, rows


def grad_gather(p: StepParams, w_plane, l_plane, pix, pix2):
    """The second backward kernel: (dL/dcolour (H, W, 3), dL/dvariance
    (H, W)) gathered from ``grad_taps``' planes and pixel terms. CPU
    tensors run ``ops/denoise.grad_gather_reference``; CUDA tensors launch
    ``atrous_grad_gather_kernel``."""
    dev = pix.device
    if dev.type == "cpu":
        from metal_pathtracer_tpu_torch.ops.denoise import (
            grad_gather_reference,
        )
        return grad_gather_reference(p, w_plane, l_plane, pix, pix2)
    if dev.type != "cuda":
        raise ValueError(f"grad_gather: unsupported device {dev}")
    h, w = pix.shape[:2]
    _check_need("grad_gather", [("w_plane", w_plane, (25, h, w)),
                                ("l_plane", l_plane, (25, h, w)),
                                ("pix", pix, (h, w, 4)),
                                ("pix2", pix2, (h, w, 2))], dev)
    build.check_aligned("grad_gather", (pix,), 16)
    d_color = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    d_var = torch.empty((h, w), dtype=torch.float32, device=dev)
    err = build.load().mpt_atrous_grad_gather(
        h, w, p.step, _ptr(w_plane), _ptr(l_plane), _ptr(pix), _ptr(pix2),
        _ptr(d_color), _ptr(d_var), _stream(dev))
    build.check(err, "mpt_atrous_grad_gather")
    grad_gather.launches += 1
    return d_color, d_var


def grad_sum(rows):
    """The third backward kernel: the 129 parameter gradients, ``rows``
    (R, 129) summed in a fixed order. CPU tensors run
    ``ops/denoise.grad_sum_reference``; CUDA tensors launch
    ``atrous_grad_sum_kernel``."""
    dev = rows.device
    if dev.type == "cpu":
        from metal_pathtracer_tpu_torch.ops.denoise import grad_sum_reference
        return grad_sum_reference(rows)
    if dev.type != "cuda":
        raise ValueError(f"grad_sum: unsupported device {dev}")
    _check_need("grad_sum", [("rows", rows, (rows.shape[0], MLP_FLOATS))],
                dev)
    out = torch.empty(MLP_FLOATS, dtype=torch.float32, device=dev)
    err = build.load().mpt_atrous_grad_sum(rows.shape[0], _ptr(rows),
                                           _ptr(out), _stream(dev))
    build.check(err, "mpt_atrous_grad_sum")
    grad_sum.launches += 1
    return out


#: launches since the last reset of each backward kernel
grad_taps.launches = grad_gather.launches = grad_sum.launches = 0


def atrous_step_grad(cv, guide, p: StepParams, mlp, g_out, u_out,
                     saved=None, inputs: bool = True, params: bool = True):
    """The backward of one learned iteration on its rows: (dL/dcolour
    (H, W, 3), dL/dvariance (H, W), dL/dmlp (129,)), the first two None
    unless ``inputs``, the last None unless ``params``: ``grad_taps``,
    then ``grad_gather`` and ``grad_sum`` as asked. ``saved`` is the
    forward's (colour, variance, weight sums); None runs the forward for
    them."""
    h, w = cv.shape[:2]
    g_out, u_out = _cotangents(g_out, u_out, h, w, cv.device)
    if saved is None:
        saved = atrous_step_packed(cv, guide, p, mlp, last=True, wsum=True)
    w_plane, l_plane, pix, pix2, rows = grad_taps(cv, guide, p, mlp, g_out,
                                                  u_out, saved)
    d_color = d_var = d_mlp = None
    if inputs:
        d_color, d_var = grad_gather(p, w_plane, l_plane, pix, pix2)
    if params:
        d_mlp = grad_sum(rows)
    return d_color, d_var, d_mlp


class LearnedIteration(torch.autograd.Function):
    """One learned iteration (``pack``, then one launch of
    ``atrous_step_kernel`` with its weight sums; colour and variance with
    the bits of the filter without grad), whose backward is
    ``atrous_step_grad``'s kernels on the saved rows, outputs and weight
    sums. Inputs: colour (H, W, 3), luminance variance (H, W), packed MLP
    (129), then albedo, normal and the ``StepParams``, which take no
    gradient."""

    @staticmethod
    def forward(ctx, color, var, mlp, albedo, normal, p):
        cv, guide = pack(color, var, albedo, normal)
        out, out_var, wsum = atrous_step_packed(cv, guide, p, mlp, last=True,
                                                wsum=True)
        ctx.save_for_backward(cv, guide, out, out_var, wsum)
        # the input itself, so that its host copy (mlp_host) is reused
        ctx.mlp, ctx.p = mlp, p
        ctx.set_materialize_grads(False)
        return out, out_var

    @staticmethod
    def backward(ctx, g_out, u_out):
        cv, guide, *saved = ctx.saved_tensors
        need_c, need_v, need_m = ctx.needs_input_grad[:3]
        d_color, d_var, d_mlp = atrous_step_grad(
            cv, guide, ctx.p, ctx.mlp, g_out, u_out, saved=tuple(saved),
            inputs=need_c or need_v, params=need_m)
        return (d_color if need_c else None, d_var if need_v else None,
                d_mlp, None, None, None)


def _needs_grad(color, var, mlp) -> bool:
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in (color, var, mlp))


def atrous_filter(color, var, albedo, normal, steps, mlp=None):
    """A whole filter: the iterations ``steps`` (``StepParams``, one mode)
    over colour (H, W, 3) and, in the variance-guided modes, the luminance
    variance (H, W): one ``pack``, then ``atrous_step_packed`` an
    iteration. Returns (colour (H, W, 3), variance (H, W) or None).

    In grad mode, with the colour, the variance or the MLP requiring grad,
    a learned filter records its graph: on the CPU through the plain
    version (``ops/denoise.atrous_filter_reference``), on CUDA as one
    ``LearnedIteration`` an iteration, whose backward launches the
    backward kernels. The fixed and SVGF filters have none: on CUDA they
    raise in that case."""
    steps = list(steps)
    if not steps:
        return color, var
    if _needs_grad(color, var, mlp):
        if color.device.type == "cpu":
            from metal_pathtracer_tpu_torch.ops.denoise import (
                atrous_filter_reference,
            )
            return atrous_filter_reference(color, var, albedo, normal, steps,
                                           mlp)
        if steps[0].mode != LEARNED:
            raise ValueError("atrous_filter: only the learned filter has a "
                             "backward kernel; run the others without grad")
        for p in steps:
            color, var = LearnedIteration.apply(color, var, mlp, albedo,
                                                normal, p)
        return color, var
    cv, guide = pack(color, None if steps[0].mode == FIXED else var, albedo,
                     normal)
    for k, p in enumerate(steps):
        cv = atrous_step_packed(cv, guide, p, mlp, last=k == len(steps) - 1)
    return cv
