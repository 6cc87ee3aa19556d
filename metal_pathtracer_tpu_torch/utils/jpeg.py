"""JPEG decoding for texture images, as Pillow decodes them:
``Image.open(...).convert("RGBA")`` over libjpeg-turbo's defaults, bit for
bit (the JAX package's ``gltf._decode_image``), without Pillow.

Every 8-bit JPEG that Pillow decodes: sequential (SOF0, SOF1, SOF9) and
progressive (SOF2, SOF10) DCT files, Huffman- or arithmetic-coded, and
lossless files (SOF3); one, three or four components; any integer
sampling ratio of factors 1-4; restart intervals. The entropy decoding
into coefficient blocks (lossless: into samples) is C
(``hostsrc/jpeg_entropy.c``, ``hostsrc/jpeg_arith.c``, built at first
use), as is the block smoothing of a progressive file's unrefined
coefficients (``hostsrc/jpeg_smooth.c``); the rest is numpy integer code
that ports libjpeg-turbo:

- the IDCT is ``JDCT_ISLOW`` (``jidctint.c``): CONST_BITS 13, PASS1_BITS
  2, and the post-IDCT range-limit table indexed under its 10-bit mask;
- a progressive file that leaves one of the first zigzag coefficients
  unrefined is block-smoothed first (``jdcoefct.c
  decompress_smooth_data``), as libjpeg does by default;
- chroma is upsampled by ``jdsample.c``'s fancy filters: h2v1 ``(3 near +
  far + 1 or 2) >> 2``, h1v2 the same down the columns, h2v2 the triangle
  filter ``(3 near + far + 8 or 7) >> 4`` over column sums ``3 near +
  far``, with edges replicated at the component's own width and height;
  plain replication (``int_upsample``) for every other ratio, for h2v1 and
  h2v2 components at most two samples wide, and for every ratio of a
  lossless file, which has no fancy upsampling;
- colour is ``jdcolor.c ycc_rgb_convert`` (16-bit fixed-point tables);
  YCCK is ``ycck_cmyk_convert`` (the same tables, inverted, K kept);
  Pillow reads CMYK as Adobe's inverted ``CMYK;I`` and converts it with
  its own ``cmyk2rgb``;
- a three-component DCT file is RGB, not YCbCr, when it has no JFIF
  marker and an Adobe marker with transform 0, or neither marker and
  component ids ``R``, ``G``, ``B``; a lossless one is RGB without a JFIF
  or Adobe marker whatever its ids; a four-component file is YCCK when
  its Adobe marker says any transform but 0, else CMYK
  (``jdapimin.c default_decompress_parms``, latched at the first scan).

EXIF orientation is not applied, as Pillow's ``open`` + ``convert`` does
not apply it. The JPEGs refused raise ``ImageFormatError``; Pillow refuses
each of them too: a precision other than 8, two components, a height
defined by DNL, hierarchical and lossless arithmetic-coded files (SOF5-7,
SOF11, SOF13-15), fractional sampling ratios, more than 10 blocks in an
interleaved scan's MCU, lossless files in YCbCr or YCCK, and a lossless
restart interval that is not a whole number of MCU rows.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from metal_pathtracer_tpu_torch.utils import nativebuild
from metal_pathtracer_tpu_torch.utils.image_io import ImageFormatError

#: zigzag index -> natural (row-major) index
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

#: (horizontal, vertical) upsampling ratios decoded: every integer ratio
#: of sampling factors 1-4, as libjpeg-turbo upsamples them
SAMPLING = {(h, v) for h in range(1, 5) for v in range(1, 5)}

#: blocks in an interleaved scan's MCU, at most (libjpeg's
#: D_MAX_BLOCKS_IN_MCU)
MAX_BLOCKS_IN_MCU = 10

#: zigzag coefficients whose estimates block smoothing computes
SMOOTHED_COEFS = 10

#: blocks an IDCT batch (bounds the int64 temporaries)
IDCT_BATCH = 16384


def _refused(what: str):
    raise ImageFormatError(f"JPEG with {what} is not decoded (Pillow "
                           "refuses it too)")


def _corrupt(what: str):
    raise ImageFormatError(f"corrupt JPEG: {what}")


# ---- the IDCT (jidctint.c jpeg_idct_islow) --------------------------------

def _islow_1d(x0, x1, x2, x3, x4, x5, x6, x7):
    """One 8-point pass of the slow-but-accurate integer IDCT; returns the
    eight outputs before their descale."""
    z1 = (x2 + x6) * 4433                      # FIX_0_541196100
    tmp2 = z1 + x6 * -15137                    # FIX_1_847759065
    tmp3 = z1 + x2 * 6270                      # FIX_0_765366865
    tmp0 = (x0 + x4) << 13
    tmp1 = (x0 - x4) << 13
    t10, t13 = tmp0 + tmp3, tmp0 - tmp3
    t11, t12 = tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = x7, x5, x3, x1
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * 9633                      # FIX_1_175875602
    o0 = o0 * 2446                             # FIX_0_298631336
    o1 = o1 * 16819                            # FIX_2_053119869
    o2 = o2 * 25172                            # FIX_3_072711026
    o3 = o3 * 12299                            # FIX_1_501321110
    z1 = z1 * -7373                            # FIX_0_899976223
    z2 = z2 * -20995                           # FIX_2_562915447
    z3 = z3 * -16069 + z5                      # FIX_1_961570560
    z4 = z4 * -3196 + z5                       # FIX_0_390180644
    o0 += z1 + z3
    o1 += z2 + z4
    o2 += z2 + z3
    o3 += z1 + z4
    return (t10 + o3, t11 + o2, t12 + o1, t13 + o0,
            t13 - o0, t12 - o1, t11 - o2, t10 - o3)


def _range_limit() -> np.ndarray:
    """The post-IDCT table (``jdmaster.c prepare_range_limit_table``) as
    indexed by ``x & 1023``: x + 128 clamped, x read as a signed 10-bit
    value."""
    idx = np.arange(1024)
    signed = np.where(idx >= 512, idx - 1024, idx)
    return np.clip(signed + 128, 0, 255).astype(np.uint8)


_IDCT_LIMIT = _range_limit()


def idct_islow(blocks: np.ndarray) -> np.ndarray:
    """(N, 8, 8) dequantised coefficients (int64, row = vertical
    frequency) -> (N, 8, 8) uint8 samples, libjpeg-turbo's ISLOW bits."""
    out = np.empty(blocks.shape, np.uint8)
    for lo in range(0, len(blocks), IDCT_BATCH):
        b = blocks[lo:lo + IDCT_BATCH]
        cols = _islow_1d(*(b[:, k, :] for k in range(8)))
        ws = np.stack([(c + (1 << 10)) >> 11 for c in cols], 1)
        rows = _islow_1d(*(ws[:, :, k] for k in range(8)))
        out[lo:lo + IDCT_BATCH] = _IDCT_LIMIT[np.stack(
            [((r + (1 << 17)) >> 18) & 1023 for r in rows], 2)]
    return out


# ---- upsampling (jdsample.c) and colour (jdcolor.c) -----------------------

def _neighbours(x: np.ndarray, axis: int):
    """(previous, next) along ``axis`` with the edges replicated."""
    first = np.take(x, [0], axis)
    last = np.take(x, [x.shape[axis] - 1], axis)
    prev = np.concatenate([first, np.delete(x, -1, axis)], axis)
    nxt = np.concatenate([np.delete(x, 0, axis), last], axis)
    return prev, nxt


def upsample(plane: np.ndarray, fh: int, fv: int,
             fancy: bool = True) -> np.ndarray:
    """A component plane (its own width and height, uint8) upsampled by
    (fh, fv) as libjpeg-turbo does: with fancy upsampling on, unless
    ``fancy`` is false (a lossless file)."""
    if (fh, fv) == (1, 1):
        return plane
    h, w = plane.shape
    if not fancy or (fh, fv) not in ((2, 1), (2, 2), (1, 2)) \
            or (fh == 2 and w <= 2):   # int_upsample / h2v?_upsample
        return np.repeat(np.repeat(plane, fv, 0), fh, 1)
    x = plane.astype(np.int32)
    if (fh, fv) == (1, 2):   # h1v2_fancy_upsample
        up, down = _neighbours(x, 0)
        out = np.empty((2 * h, w), np.int32)
        out[0::2] = (3 * x + up + 1) >> 2
        out[1::2] = (3 * x + down + 2) >> 2
        return out.astype(np.uint8)
    if fv == 2:   # column sums: 3 * nearer row + further row
        up, down = _neighbours(x, 0)
        sums = np.empty((2 * h, w), np.int32)
        sums[0::2] = 3 * x + up
        sums[1::2] = 3 * x + down
        x, bias = sums, (8, 7, 4)
    else:
        bias = (1, 2, 2)
    left, right = _neighbours(x, 1)
    out = np.empty((x.shape[0], 2 * w), np.int32)
    out[:, 0::2] = (3 * x + left + bias[0]) >> bias[2]
    out[:, 1::2] = (3 * x + right + bias[1]) >> bias[2]
    return out.astype(np.uint8)


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    return ((91881 * x + half) >> 16,          # Cr -> R, FIX(1.40200)
            (116130 * x + half) >> 16,         # Cb -> B, FIX(1.77200)
            -46802 * x,                        # Cr -> G, FIX(0.71414)
            -22554 * x + half)                 # Cb -> G, FIX(0.34414)


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def ycck_to_cmyk(y, cb, cr, k) -> np.ndarray:
    """``jdcolor.c ycck_cmyk_convert``: each of Y, Cb, Cr to R, G, B by
    ``ycc_rgb_convert``'s arithmetic, inverted; K passes through."""
    rgb = ycc_to_rgb(y, cb, cr)
    return np.concatenate([255 - rgb, k[..., None]], -1)


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """Pillow's ``convert`` of its ``CMYK`` mode (``Convert.c cmyk2rgb``):
    ``nk - c * nk / 255`` with ``nk = 255 - k``, its MULDIV255 rounding."""
    x = cmyk.astype(np.int32)
    nk = 255 - x[..., 3:]
    tmp = x[..., :3] * nk + 128
    return np.clip(nk - (((tmp >> 8) + tmp) >> 8), 0, 255).astype(np.uint8)


# ---- markers and scans -----------------------------------------------------

#: SOF marker -> (progressive, arithmetic-coded, lossless)
SOF_KINDS = {0xC0: (False, False, False), 0xC1: (False, False, False),
             0xC2: (True, False, False), 0xC3: (False, False, True),
             0xC9: (False, True, False), 0xCA: (True, True, False)}


class _Frame:
    def __init__(self, marker: int, seg: bytes):
        if marker in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF):
            _refused(f"hierarchical coding (SOF{marker - 0xC0})")
        if marker == 0xCB:
            _refused("lossless arithmetic coding (SOF11)")
        self.progressive, self.arithmetic, self.lossless = SOF_KINDS[marker]
        if len(seg) < 6:
            _corrupt("short SOF segment")
        self.precision, self.height, self.width, n = struct.unpack(
            ">BHHB", seg[:6])
        if n == 0 or len(seg) != 6 + 3 * n:
            _corrupt(f"SOF segment of {len(seg)} bytes for {n} components")
        if self.precision != 8:
            _refused(f"{self.precision}-bit precision")
        if n not in (1, 3, 4):
            _refused(f"{n} components")
        if self.width == 0:
            _refused("a width of 0")
        if self.height == 0:
            _refused("a height defined by DNL")
        self.ids, self.h, self.v, self.tq = [], [], [], []
        for k in range(n):
            cid, hv, tq = seg[6 + 3 * k:9 + 3 * k]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3 \
                    or cid in self.ids:
                _corrupt(f"component {cid}: sampling {h}x{v}, table {tq}")
            self.ids.append(cid)
            self.h.append(h)
            self.v.append(v)
            self.tq.append(tq)
        # libjpeg groups a lone component's block rows by its own declared
        # factor (the iMCU rows that block smoothing fetches by)
        self.v_declared = self.v[0]
        if n == 1:   # a one-component frame is never subsampled
            self.h, self.v = [1], [1]
        hmax, vmax = max(self.h), max(self.v)
        self.factors = []
        for h, v in zip(self.h, self.v):
            if hmax % h or vmax % v or (hmax // h, vmax // v) not in SAMPLING:
                _refused(f"fractional sampling ({'x'.join(map(str, self.h))}"
                         f" by {'x'.join(map(str, self.v))})")
            self.factors.append((hmax // h, vmax // v))
        self.mcus_x = -(-self.width // (8 * hmax))
        self.mcus_y = -(-self.height // (8 * vmax))
        # each component's own size and its blocks, as allocated (MCU
        # multiples) and as coded in a one-component scan
        self.size = [(-(-self.height * v // vmax), -(-self.width * h // hmax))
                     for h, v in zip(self.h, self.v)]
        if self.lossless:   # samples, one a "block"
            self.lossless_mcus = (-(-self.width // hmax),
                                  -(-self.height // vmax))
            mx, my = self.lossless_mcus
            self.samples = [np.zeros((my * v, mx * h), np.int32)
                            for h, v in zip(self.h, self.v)]
            self.point_transform = [0] * n
        else:
            self.coefs = [np.zeros((self.mcus_y * v, self.mcus_x * h, 64),
                                   np.int16)
                          for h, v in zip(self.h, self.v)]
        self.quant = [None] * n
        # successive-approximation bit of each coefficient, -1: none yet
        self.coef_bits = np.full((n, 64), -1, np.int32)


def _huffman_tables(seg: bytes, tables: np.ndarray, present: list) -> None:
    pos = 0
    while pos < len(seg):
        if pos + 17 > len(seg):
            _corrupt("short DHT segment")
        tc, th = seg[pos] >> 4, seg[pos] & 15
        counts = np.frombuffer(seg, np.uint8, 16, pos + 1)
        n = int(counts.sum())
        if tc > 1 or th > 3 or n > 256 or pos + 17 + n > len(seg):
            _corrupt("DHT segment")
        slot = tc * 4 + th
        tables[slot, :16] = counts
        tables[slot, 16:16 + n] = np.frombuffer(seg, np.uint8, n, pos + 17)
        present[0] |= 1 << slot
        pos += 17 + n


def _arith_conditioning(seg: bytes, cond: np.ndarray) -> None:
    """A DAC segment into ``cond`` (L[16], U[16], K[16])."""
    if len(seg) % 2:
        _corrupt("DAC segment")
    for pos in range(0, len(seg), 2):
        index, value = seg[pos], seg[pos + 1]
        if index >= 32:
            _corrupt(f"DAC table {index}")
        if index >= 16:
            cond[32 + index - 16] = value
        else:
            if value & 15 > value >> 4:
                _corrupt(f"DAC conditioning {value:#04x}")
            cond[index], cond[16 + index] = value & 15, value >> 4


def _quant_tables(seg: bytes, quant: dict) -> None:
    pos = 0
    while pos < len(seg):
        pq, tq = seg[pos] >> 4, seg[pos] & 15
        size = 64 * (2 if pq else 1)
        if pq > 1 or tq > 3 or pos + 1 + size > len(seg):
            _corrupt("DQT segment")
        zz = np.frombuffer(seg, ">u2" if pq else np.uint8, 64, pos + 1)
        table = np.empty(64, np.int64)
        table[NATURAL_ORDER] = zz
        quant[tq] = table
        pos += 1 + size


_SCAN_ERRORS = {-1: "a scan uses an undefined Huffman table",
                -2: "bad entropy-coded data",
                -3: "restart marker missing",
                -4: "scan parameters"}


def _scan(frame: _Frame, seg: bytes, data: bytes, pos: int, quant: dict,
          tables: np.ndarray, present: int, cond: np.ndarray,
          interval: int) -> int:
    """Decode the scan whose header is ``seg`` and whose data starts at
    ``pos``; returns the offset of the marker after it."""
    if not seg or len(seg) != 4 + 2 * seg[0] or not 1 <= seg[0] <= 4:
        _corrupt("SOS segment")
    n = seg[0]
    comps, slots = [], []
    for k in range(n):
        cid, t = seg[1 + 2 * k:3 + 2 * k]
        if cid not in frame.ids:
            _corrupt(f"scan component {cid} is not in the frame")
        comps.append(frame.ids.index(cid))
        slots.append((t >> 4, t & 15))
    ss, se, a = seg[1 + 2 * n:4 + 2 * n]
    ah, al = a >> 4, a & 15
    if n > 1 and sum(frame.h[c] * frame.v[c] for c in comps) \
            > MAX_BLOCKS_IN_MCU:
        _refused(f"more than {MAX_BLOCKS_IN_MCU} blocks in an MCU")
    if frame.lossless:
        return _lossless_scan(frame, comps, slots, ss, al, data, pos,
                              tables, present, interval)
    if frame.progressive:
        if se > 63 or ss > se or (ss == 0 and se != 0) \
                or (ss > 0 and n != 1) or al > 13:
            _corrupt(f"progressive scan {ss}-{se}, {ah}/{al}")
    elif (ss, se, ah, al) != (0, 63, 0, 0):
        _corrupt(f"sequential scan {ss}-{se}, {ah}/{al}")
    for c in comps:
        if frame.quant[c] is None:   # latched at the component's first scan
            if frame.tq[c] not in quant:
                _corrupt(f"quantisation table {frame.tq[c]} is not defined")
            frame.quant[c] = quant[frame.tq[c]]
        frame.coef_bits[c, ss:se + 1] = al
    if n == 1:
        c = comps[0]
        rows, cols = frame.size[c]
        grid = (-(-cols // 8), -(-rows // 8))
    else:
        grid = (frame.mcus_x, frame.mcus_y)
    params = [n, ss, se, ah, al, int(frame.progressive), interval, *grid]
    for c, (td, ta) in zip(comps, slots):
        params += [frame.h[c], frame.v[c], frame.coefs[c].shape[1], td, ta]
    params = np.asarray(params, np.int32)
    ptrs = (ctypes.c_void_p * n)(*[frame.coefs[c].ctypes.data
                                   for c in comps])
    lib = nativebuild.host_library()
    if frame.arithmetic:
        end = lib.mpt_jpeg_decode_scan_arith(
            data, len(data), pos, params.ctypes.data, cond.ctypes.data,
            ctypes.cast(ptrs, ctypes.c_void_p))
    else:
        end = lib.mpt_jpeg_decode_scan(
            data, len(data), pos, params.ctypes.data, tables.ctypes.data,
            present, ctypes.cast(ptrs, ctypes.c_void_p))
    if end < 0:
        _corrupt(_SCAN_ERRORS.get(end, f"scan error {end}"))
    return int(end)


def _lossless_scan(frame: _Frame, comps, slots, predictor: int, pt: int,
                   data: bytes, pos: int, tables: np.ndarray, present: int,
                   interval: int) -> int:
    """One lossless scan (Ss: the predictor, Al: the point transform)
    into the components' sample planes."""
    if not 1 <= predictor <= 7 or pt >= frame.precision:
        _corrupt(f"lossless scan: predictor {predictor}, transform {pt}")
    if len(comps) == 1:
        c = comps[0]
        rows, cols = frame.size[c]
        grid = (cols, rows)
    else:
        grid = frame.lossless_mcus
    if interval % grid[0]:
        _refused(f"a lossless restart interval of {interval} MCUs in rows "
                 f"of {grid[0]}")
    for c in comps:
        frame.point_transform[c] = pt
        frame.coef_bits[c, :] = 0
    params = [len(comps), predictor, pt, interval, *grid, frame.precision]
    for c, (td, _) in zip(comps, slots):
        params += [frame.h[c], frame.v[c], frame.samples[c].shape[1], td]
    params = np.asarray(params, np.int32)
    ptrs = (ctypes.c_void_p * len(comps))(*[frame.samples[c].ctypes.data
                                            for c in comps])
    end = nativebuild.host_library().mpt_jpeg_decode_lossless(
        data, len(data), pos, params.ctypes.data, tables.ctypes.data,
        present, ctypes.cast(ptrs, ctypes.c_void_p))
    if end < 0:
        _corrupt(_SCAN_ERRORS.get(end, f"scan error {end}"))
    return int(end)


def _smoothing(frame: _Frame) -> bool:
    """``jdcoefct.c smoothing_ok``: a progressive file whose components
    all have DC values and quantisation tables non-zero at the estimated
    coefficients, and that leaves one of zigzag 1-9 of some component
    unrefined (or never coded)."""
    if not frame.progressive or (frame.coef_bits[:, 0] < 0).any():
        return False
    first = NATURAL_ORDER[:SMOOTHED_COEFS]
    if any(q is None or (q[first] == 0).any() for q in frame.quant):
        return False
    return bool((frame.coef_bits[:, 1:SMOOTHED_COEFS] != 0).any())


def _dct_planes(frame: _Frame) -> list:
    """Each component's samples at its own size, block-smoothed first
    where libjpeg smooths."""
    smooth = _smoothing(frame)
    vmax = max(frame.v)
    planes = []
    for c, (rows, cols) in enumerate(frame.size):
        coef = frame.coefs[c]
        bh, bw = coef.shape[:2]
        if smooth and (frame.coef_bits[c, 1:SMOOTHED_COEFS] != 0).any():
            v_samp = frame.v[c] if len(frame.size) > 1 else frame.v_declared
            imcu_rows = -(-frame.height // (8 * (vmax if len(frame.size) > 1
                                                 else v_samp)))
            smoothed = coef.copy()
            nativebuild.host_library().mpt_jpeg_smooth(
                coef.ctypes.data, smoothed.ctypes.data, bw, bh,
                -(-cols // 8), -(-rows // 8), v_samp, imcu_rows,
                np.ascontiguousarray(frame.coef_bits[c, :SMOOTHED_COEFS])
                .ctypes.data,
                frame.quant[c].astype(np.int32).ctypes.data)
            coef = smoothed
        # a component no scan coded keeps zero coefficients (libjpeg's
        # coefficient arrays start zeroed)
        quant = frame.quant[c] if frame.quant[c] is not None \
            else np.zeros(64, np.int64)
        blocks = coef.reshape(-1, 8, 8).astype(np.int64) * quant.reshape(8, 8)
        pix = idct_islow(blocks).reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3)
        planes.append(pix.reshape(bh * 8, bw * 8)[:rows, :cols])
    return planes


def _colour_space(frame: _Frame, jfif: bool, adobe) -> str:
    """``jdapimin.c default_decompress_parms``: the colour space libjpeg
    assumes, from the markers seen before the first scan."""
    n = len(frame.ids)
    if n == 1:
        return "grey"
    if n == 4:
        return "cmyk" if adobe is None or adobe == 0 else "ycck"
    if jfif:
        return "ycc"
    if adobe is not None:
        return "rgb" if adobe == 0 else "ycc"
    if frame.lossless or tuple(frame.ids) == (82, 71, 66):   # "R", "G", "B"
        return "rgb"
    return "ycc"


def frame_components(data: bytes):
    """The component count of a JPEG's frame header (None without one)."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xFF or 0xD0 <= marker <= 0xD8 or marker in (0x00, 0x01):
            pos += 1 if marker == 0xFF else 2
            continue
        if marker in (0xD9, 0xDA):
            return None
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return data[pos + 9] if pos + 10 <= len(data) else None
        pos += 2 + struct.unpack_from(">H", data, pos + 2)[0]
    return None


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode a JPEG into (H, W, 4) uint8 RGBA, Pillow's
    ``convert("RGBA")`` of it bit for bit; anything else raises
    ``ImageFormatError``."""
    data = bytes(data)
    if data[:3] != b"\xff\xd8\xff":
        raise ImageFormatError("not a JPEG image")
    frame, quant, interval = None, {}, 0
    tables = np.zeros((8, 272), np.int32)
    present = [0]
    cond = np.array([0] * 16 + [1] * 16 + [5] * 16, np.int32)
    jfif, adobe, space = False, None, None
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:   # libjpeg skips extraneous bytes
            pos += 1
            continue
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD8 or marker in (0x00, 0x01):
            continue
        if pos + 2 > len(data):
            _corrupt("truncated marker segment")
        length = struct.unpack_from(">H", data, pos)[0]
        if length < 2 or pos + length > len(data):
            _corrupt(f"marker 0x{marker:02X} of length {length}")
        seg = data[pos + 2:pos + length]
        pos += length
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if frame is not None:
                _corrupt("a second SOF marker")
            frame = _Frame(marker, seg)
        elif marker == 0xC4:
            _huffman_tables(seg, tables, present)
        elif marker == 0xCC:
            _arith_conditioning(seg, cond)
        elif marker == 0xDB:
            _quant_tables(seg, quant)
        elif marker == 0xDD:
            if len(seg) != 2:
                _corrupt("DRI segment")
            interval = struct.unpack(">H", seg)[0]
        elif marker == 0xDC:
            _refused("a height defined by DNL")
        elif marker == 0xE0:
            jfif = jfif or (len(seg) >= 14 and seg[:5] == b"JFIF\0")
        elif marker == 0xEE:
            if len(seg) >= 12 and seg[:5] == b"Adobe":
                adobe = seg[11]
        elif marker == 0xDA:
            if frame is None:
                _corrupt("SOS before SOF")
            if space is None:
                space = _colour_space(frame, jfif, adobe)
                if frame.lossless and space in ("ycc", "ycck"):
                    _refused(f"lossless coding of {space.upper()} colour")
            pos = _scan(frame, seg, data, pos, quant, tables, present[0],
                        cond, interval)
    if frame is None:
        _corrupt("no SOF marker")
    if space is None:
        _corrupt("no SOS marker")

    if frame.lossless:
        planes = [((s[:rows, :cols] << pt) & 0xFF).astype(np.uint8)
                  for s, pt, (rows, cols) in zip(
                      frame.samples, frame.point_transform, frame.size)]
    else:
        planes = _dct_planes(frame)
    planes = [upsample(p, *f, fancy=not frame.lossless)[:frame.height,
                                                        :frame.width]
              for p, f in zip(planes, frame.factors)]
    out = np.empty((frame.height, frame.width, 4), np.uint8)
    out[..., 3] = 255
    if space == "grey":
        out[..., :3] = planes[0][..., None]
    elif space == "rgb":
        out[..., :3] = np.stack(planes, -1)
    elif space == "ycc":
        out[..., :3] = ycc_to_rgb(*planes)
    else:   # Pillow's CMYK;I: the decoded CMYK inverted, then cmyk2rgb
        cmyk = np.stack(planes, -1) if space == "cmyk" \
            else ycck_to_cmyk(*planes)
        out[..., :3] = cmyk_to_rgb(255 - cmyk)
    return out
