"""Writers of the texture-image fixtures that ``chip_smoke.py`` decodes on
the card's host (which has no Pillow) and ``tests/test_torch_image_formats
.py`` and ``tests/test_torch_jpeg_variants.py`` check, the sky fixtures of
``tests/test_torch_env_ldr.py``, and the encoders those tests share.

    python tests/images/make_fixtures.py   # needs Pillow, imageio, the
                                           # JAX package, cc and libjpeg's
                                           # headers (libjpeg-dev)

writes each fixture beside this file and ``pillow_rgba.json``: Pillow's
``Image.open(...).convert("RGBA")`` of each, as the SHA-256 of its bytes
and its shape; and ``imageio_env.json``: the SHA-256, shape and dtype of
the JAX package's ``load_hdr_image`` array of each sky fixture. Pillow
writes the JPEGs it can write; the PNGs of depths and layouts Pillow
cannot write, and the 4:1:1 JPEG (Pillow's encoder has no 4:1:1), are
written here: ``png_bytes`` (every colour type and depth, Adam7, each row
with its own filter) and ``jpeg_baseline`` (a baseline encoder: a float
DCT, one quantisation table per component, fixed-length Huffman codes,
any sampling factors); the lossless JPEGs by ``jpeg_lossless`` (T.81
Annex H, predictors 1-7, point transforms, restarts); the YCCK, plain
CMYK, 4:4:0, 3x1, arithmetic-coded and scripted progressive JPEGs by
``jpeg_writer.c`` over the system's libjpeg(-turbo), compiled here into a
temporary directory.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import struct
import subprocess
import tempfile
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DIGESTS = os.path.join(HERE, "pillow_rgba.json")
ENV_DIGESTS = os.path.join(HERE, "imageio_env.json")
#: the sky fixtures, each loaded by ``load_hdr_image``
SKIES = ("sky_rgb8_48x24.png", "sky_rgba8_48x24.png",
         "sky_palette_48x24.png", "sky_rgb16_48x24.png", "sky_48x24.jpg",
         "sky_dim_48x24.png")

#: PNG colour type -> samples per pixel
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def _pack(px: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, ch) samples -> (h, stride) bytes of unfiltered rows."""
    h = px.shape[0]
    flat = px.reshape(h, -1).astype(np.int64)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    flat = np.pad(flat, ((0, 0), (0, -flat.shape[1] % per)))
    shifts = np.arange(8 - depth, -1, -depth)
    return (flat.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter(rows: np.ndarray, bpp: int, filters) -> bytes:
    """Each row filtered with ``filters[y % len(filters)]`` (0-4)."""
    out = []
    prior = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        kind = filters[y % len(filters)]
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        pred = {0: 0, 1: a, 2: prior, 3: (a + prior) >> 1,
                4: _paeth(a, prior, c)}[kind]
        out.append(bytes([kind]) + ((row - pred) & 0xFF).astype(np.uint8)
                   .tobytes())
        prior = row
    return b"".join(out)


def png_bytes(px, ctype: int, depth: int = 8, plte=None, trns=None,
              interlace: bool = False, filters=(0,), level: int = 9) -> bytes:
    """A PNG of ``px`` ((h, w, channels) samples) at any colour type and
    bit depth, Adam7-interlaced if asked, each row of each pass filtered
    with ``filters`` in turn."""
    px = np.asarray(px)
    h, w = px.shape[:2]
    ch = CHANNELS[ctype]
    bpp = max(1, depth * ch // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = px[y0::dy, x0::dx]
        if sub.shape[0] and sub.shape[1]:
            raw += _filter(_pack(sub, depth), bpp, filters)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if plte is not None:
        out += _chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return (out + _chunk(b"IDAT", zlib.compress(raw, level))
            + _chunk(b"IEND", b""))


# ---- a baseline JPEG encoder -------------------------------------------------

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_DCT = np.array([[(np.sqrt(0.5) if u == 0 else 1.0) / 2
                  * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                 for u in range(8)])
#: fixed-length codes: 12 DC categories at 4 bits, 162 AC symbols at 8
_DC_SYMBOLS = list(range(12))
_AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                              for s in range(1, 11)]


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, n: int):
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            byte = (self.acc >> (self.n - 8)) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
            self.n -= 8

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _category(v: int):
    s = abs(v).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def jpeg_baseline(planes, factors, quant, ids=None, app14=None,
                  interleaved: bool = True) -> bytes:
    """A baseline JPEG of full-size component planes (uint8, (h, w)),
    each downsampled to its sampling factors from ``factors`` (the SOF's;
    a fractional ratio by nearest samples) and quantised by ``quant`` (64
    values, natural order, one table for every component). ``ids``:
    component ids (default 1, 2, 3); ``app14``: an Adobe transform byte to
    write; ``interleaved=False``: one scan per component, each over the
    component's own blocks."""
    h, w = planes[0].shape
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    comps = []
    for plane, (fh, fv) in zip(planes, factors):
        cw, chh = -(-w * fh // hmax), -(-h * fv // vmax)
        if hmax % fh or vmax % fv:   # a fractional ratio: nearest samples
            p = plane.astype(np.float64)[
                np.arange(chh) * vmax // fv][:, np.arange(cw) * hmax // fh]
        else:
            sx, sy = hmax // fh, vmax // fv
            p = np.pad(plane.astype(np.float64),
                       ((0, chh * sy - h), (0, cw * sx - w)), mode="edge")
            p = p.reshape(chh, sy, cw, sx).mean((1, 3))
        p = np.pad(p, ((0, my * fv * 8 - chh), (0, mx * fh * 8 - cw)),
                   mode="edge")
        comps.append((p - 128.0, fh, fv, -(-cw // 8), -(-chh // 8)))
    quant = np.asarray(quant, np.int64)

    def block(bits, preds, c, y0, x0):
        p = comps[c][0]
        blk = _DCT @ p[y0:y0 + 8, x0:x0 + 8] @ _DCT.T
        q = np.round(blk.reshape(-1) / quant).astype(int)
        zz = q[ZIGZAG]
        s, b = _category(int(zz[0]) - preds[c])
        preds[c] = int(zz[0])
        bits.put(_DC_SYMBOLS.index(s), 4)
        bits.put(b, s)
        run = 0
        last = max([k for k in range(1, 64) if zz[k]], default=0)
        for k in range(1, last + 1):
            if zz[k] == 0:
                run += 1
                continue
            while run > 15:
                bits.put(_AC_SYMBOLS.index(0xF0), 8)
                run -= 16
            s, b = _category(int(zz[k]))
            bits.put(_AC_SYMBOLS.index((run << 4) | s), 8)
            bits.put(b, s)
            run = 0
        if last < 63:
            bits.put(_AC_SYMBOLS.index(0x00), 8)

    scans = []
    if interleaved:
        bits, preds = _Bits(), [0] * len(comps)
        for by in range(my):
            for bx in range(mx):
                for c, (_, fh, fv, _, _) in enumerate(comps):
                    for v in range(fv):
                        for u in range(fh):
                            block(bits, preds, c, (by * fv + v) * 8,
                                  (bx * fh + u) * 8)
        bits.flush()
        scans.append((list(range(len(comps))), bytes(bits.out)))
    else:
        for c, (_, _, _, bw, bh) in enumerate(comps):
            bits, preds = _Bits(), [0] * len(comps)
            for by in range(bh):
                for bx in range(bw):
                    block(bits, preds, c, by * 8, bx * 8)
            bits.flush()
            scans.append(([c], bytes(bits.out)))

    def seg(marker: int, payload: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) \
            + payload
    ids = ids or list(range(1, len(planes) + 1))
    out = b"\xff\xd8"
    if app14 is not None:
        out += seg(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, app14]))
    out += seg(0xDB, bytes([0]) + bytes(quant[ZIGZAG].astype(np.uint8)))
    out += seg(0xC0, struct.pack(">BHHB", 8, h, w, len(planes)) + b"".join(
        bytes([i, (fh << 4) | fv, 0]) for i, (fh, fv) in zip(ids, factors)))
    out += seg(0xC4, bytes([0x00]) + bytes([0, 0, 0, 12] + [0] * 12)
               + bytes(_DC_SYMBOLS))
    out += seg(0xC4, bytes([0x10]) + bytes([0] * 7 + [162] + [0] * 8)
               + bytes(_AC_SYMBOLS))
    for members, data in scans:
        out += seg(0xDA, bytes([len(members)]) + b"".join(
            bytes([ids[c], 0x00]) for c in members) + bytes([0, 63, 0]))
        out += data
    return out + b"\xff\xd9"


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) \
        + payload


def _lossless_predict(p: int, ra: int, rb: int, rc: int) -> int:
    return (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
            rb + ((ra - rc) >> 1), (ra + rb) >> 1)[p - 1]


def jpeg_lossless(planes, factors=None, predictor: int = 1, pt: int = 0,
                  restart_rows: int = 0, ids=None, app: bytes = b"") -> bytes:
    """A lossless (SOF3) JPEG of component planes at their own sizes
    (uint8; the first one's size and factors set the image's), one
    interleaved scan with ``predictor`` (1-7) and point transform ``pt``,
    a restart marker every ``restart_rows`` MCU rows, differences coded by
    a fixed-length table (5 bits a category). ``app``: segments to write
    after SOI (a JFIF or Adobe marker)."""
    n = len(planes)
    factors = factors or [(1, 1)] * n
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    h = planes[0].shape[0] * vmax // factors[0][1]
    w = planes[0].shape[1] * hmax // factors[0][0]
    if n == 1:
        factors = [(1, 1)]
        mx, my = w, h
    else:
        mx, my = -(-w // hmax), -(-h // vmax)
    comps = [(np.pad(p.astype(np.int64) >> pt,
                     ((0, my * fv - p.shape[0]), (0, mx * fh - p.shape[1])),
                     mode="edge"), fh, fv)
             for p, (fh, fv) in zip(planes, factors)]
    bits, restarts = _Bits(), 0
    initial = 1 << (8 - pt - 1)
    for row in range(my):
        first = row == 0
        if restart_rows and row and row % restart_rows == 0:
            bits.flush()
            bits.out += bytes([0xFF, 0xD0 + restarts % 8])
            restarts += 1
            first = True
        for col in range(mx):
            for q, fh, fv in comps:
                for v in range(fv):
                    for u in range(fh):
                        y, x = row * fv + v, col * fh + u
                        if first and v == 0:
                            pred = initial if x == 0 else int(q[y, x - 1])
                        elif x == 0:
                            pred = int(q[y - 1, x])
                        else:
                            pred = _lossless_predict(
                                predictor, int(q[y, x - 1]),
                                int(q[y - 1, x]), int(q[y - 1, x - 1]))
                        diff = (int(q[y, x]) - pred + 32768) % 65536 - 32768
                        size, coded = _category(diff)
                        bits.put(size, 5)
                        bits.put(coded, size)
    bits.flush()
    ids = ids or list(range(1, n + 1))
    out = b"\xff\xd8" + app + _segment(0xC3, struct.pack(
        ">BHHB", 8, h, w, n) + b"".join(
        bytes([i, (fh << 4) | fv, 0]) for i, (fh, fv) in zip(ids, factors)))
    out += _segment(0xC4, bytes([0x00, 0, 0, 0, 0, 17] + [0] * 11)
                    + bytes(range(17)))
    if restart_rows:
        out += _segment(0xDD, struct.pack(">H", restart_rows * mx))
    out += _segment(0xDA, bytes([n]) + b"".join(bytes([i, 0x00]) for i in ids)
                    + bytes([predictor, 0, pt]))
    return out + bytes(bits.out) + b"\xff\xd9"


# ---- the system libjpeg's writer -------------------------------------------

def build_jpeg_writer(directory: str) -> str:
    """``jpeg_writer.c`` compiled against the system's libjpeg into
    ``directory``; returns the program's path."""
    exe = os.path.join(directory, "jpeg_writer")
    cc = os.environ.get("CC") or shutil.which("cc") or "gcc"
    subprocess.run([cc, "-O2", "-o", exe, os.path.join(HERE, "jpeg_writer.c"),
                    "-ljpeg"], check=True)
    return exe


def libjpeg_write(exe: str, px: np.ndarray, space: str, *options) -> bytes:
    """``px`` ((h, w, channels) uint8) written by ``jpeg_writer`` with
    ``options`` (see its header)."""
    px = np.ascontiguousarray(px, np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.raw"), os.path.join(tmp, "out.jpg")
        with open(src, "wb") as fh:
            fh.write(px.tobytes())
        subprocess.run([exe, src, dst, str(px.shape[1]), str(px.shape[0]),
                        space, *map(str, options)], check=True)
        with open(dst, "rb") as fh:
            return fh.read()


# ---- the fixtures --------------------------------------------------------------

def texture(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A texture-like RGB image: bricks with mortar, a gradient across,
    and a little noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    row = (yy // 64).astype(int)
    xs = xx + 64 * (row % 2)
    mortar = ((yy % 64) < 6) | ((xs % 128) < 6)
    shade = 0.75 + 0.25 * np.sin(xx / w * 3.0) * np.cos(yy / h * 2.0)
    brick = np.stack([170 * shade, 80 * shade + 20 * (row % 3),
                      60 * shade], -1)
    img = np.where(mortar[..., None], 200.0, brick)
    img += rng.normal(0.0, 2.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _pillow_jpeg(rgb: np.ndarray, mode: str = "RGB", **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgb, "RGB").convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pillow_cmyk(cmyk: np.ndarray, **kw) -> bytes:
    """Pillow's CMYK JPEG (its writer adds an Adobe marker)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(cmyk, "CMYK").save(buf, "JPEG", **kw)
    return buf.getvalue()


def _rgba16(h: int, w: int) -> np.ndarray:
    """Smooth 16-bit ramps with a checker in blue: every filter leaves
    small residuals, so the file stays small."""
    yy, xx = np.mgrid[0:h, 0:w]
    checker = (xx // 64 + yy // 64) % 2
    return np.stack([xx * 32, yy * 32, (xx + yy) * 16 + 30000 * checker,
                     65535 - yy * 16], -1) & 0xFFFF


def cmyk_texture(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A CMYK image: the texture's complement as C, M, Y and a ramp of
    black."""
    rgb = texture(h, w, seed)
    k = (np.arange(w)[None, :] * 160 // max(w - 1, 1)
         + np.zeros((h, 1), np.int64)).astype(np.uint8)
    return np.concatenate([255 - rgb, k[..., None]], -1)


def sky(h: int, w: int, seed: int = 0) -> np.ndarray:
    """An LDR sky: a blue gradient up to white at the horizon, a sun."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    t = yy / max(h - 1, 1)
    img = np.stack([90 + 150 * t, 140 + 100 * t, 250 - 20 * t], -1)
    sun = np.exp(-((xx - 0.7 * w) ** 2 + (yy - 0.25 * h) ** 2) / 6.0)
    img = img + 200 * sun[..., None] + rng.normal(0, 1.5, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def variant_fixtures(exe: str) -> dict:
    """name -> bytes of the JPEG variants and the sky images: ``exe`` is
    ``build_jpeg_writer``'s program. ``arith_prog_440_256.jpg`` is the
    ground texture of ``chip_smoke.py``'s variant render."""
    small = texture(53, 37, seed=2)
    cmyk = cmyk_texture(53, 37, seed=3)
    tiny = texture(16, 24, seed=4)
    out = {
        "ycck_422_37x53.jpg": libjpeg_write(
            exe, cmyk, "ycck", "-q", "85", "-s", "2,1/1,1/1,1/2,1"),
        "cmyk_plain_37x53.jpg": libjpeg_write(exe, cmyk, "cmyk", "-n"),
        "cmyk_adobe_37x53.jpg": _pillow_cmyk(cmyk),
        "sampled_440_37x53.jpg": libjpeg_write(
            exe, small, "rgb", "-s", "1,2/1,1/1,1"),
        "sampled_31_37x53.jpg": libjpeg_write(
            exe, small, "rgb", "-s", "3,1/1,1/1,1"),
        "arith_37x53.jpg": libjpeg_write(
            exe, small, "rgb", "-a", "-c", "1,4,8", "-s", "2,2/1,1/1,1"),
        "arith_prog_37x53.jpg": libjpeg_write(
            exe, small, "rgb", "-a", "-p", "simple", "-s", "2,1/1,1/1,1"),
        "arith_restart_37x53.jpg": libjpeg_write(
            exe, small, "rgb", "-a", "-r", "2"),
        # zigzag 10-63 never refined past bit 1: libjpeg does not smooth
        "prog_highfreq_37x53.jpg": libjpeg_write(
            exe, small, "rgb", "-p", "0 1 2:0-0:0:0;0:1-9:0:0;0:10-63:0:1;"
            "1:1-63:0:0;2:1-63:0:0"),
        # the luma's DC and zigzag 1-5 unrefined, the chroma only DC:
        # block smoothing, with DC interpolation in the chroma
        "prog_smoothed_37x53.jpg": libjpeg_write(
            exe, small, "rgb", "-s", "2,2/1,1/1,1", "-p",
            "0 1 2:0-0:0:1;0:1-5:0:2;0:1-5:2:1;0:6-63:0:0"),
        "arith_prog_440_256.jpg": libjpeg_write(
            exe, texture(256, 256, seed=6), "rgb", "-a", "-p", "simple",
            "-r", "8", "-s", "1,2/1,1/1,1"),
    }
    planes = [tiny[..., k] for k in range(3)]
    for p in range(1, 8):
        out[f"lossless_p{p}_24x16.jpg"] = jpeg_lossless(planes, predictor=p)
    out["lossless_pt_24x16.jpg"] = jpeg_lossless(planes, predictor=6, pt=2)
    out["lossless_restart_24x16.jpg"] = jpeg_lossless(
        [tiny[..., 0], tiny[:, ::2, 1], tiny[:, ::2, 2]],
        [(2, 1), (1, 1), (1, 1)], predictor=4, restart_rows=3)
    bright = sky(24, 48, seed=7)
    alpha = np.linspace(40, 255, 48).astype(np.uint8)[None, :].repeat(24, 0)
    palette = (bright // 64).astype(np.int64)
    index = palette[..., 0] * 16 + palette[..., 1] * 4 + palette[..., 2]
    levels = np.array([40, 110, 180, 250])
    plte = np.stack(np.meshgrid(levels, levels, levels, indexing="ij"),
                    -1).reshape(-1, 3)
    out.update({
        "sky_rgb8_48x24.png": png_bytes(bright, 2, 8, filters=(1, 2)),
        "sky_rgba8_48x24.png": png_bytes(
            np.concatenate([bright, alpha[..., None]], -1), 6, 8,
            filters=(4,)),
        "sky_palette_48x24.png": png_bytes(
            index[..., None], 3, 8, plte=plte, trns=bytes([0, 64, 128])),
        "sky_rgb16_48x24.png": png_bytes(
            bright.astype(np.int64) * 257 + 3, 2, 16, filters=(3,)),
        "sky_48x24.jpg": _pillow_jpeg(bright, quality=90),
        "sky_dim_48x24.png": png_bytes(bright // 4, 2, 8),
    })
    return out


def fixtures() -> dict:
    """name -> file bytes of the baseline and progressive JPEGs and the
    PNGs. The two 2048x2048 images are the ones whose decode time
    ``chip_smoke.py`` prints."""
    small = texture(53, 37, seed=1)
    lum = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
           14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
           18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113,
           92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100,
           103, 99]
    ycc = rgb_to_ycc(small).astype(np.uint8)
    grey = (np.arange(9 * 13).reshape(9, 13, 1) * 7) % 4
    return {
        "tex_2048_420.jpg": _pillow_jpeg(texture(2048, 2048), quality=75,
                                         subsampling=2),
        "tex_2048_rgba16_adam7.png": png_bytes(
            _rgba16(2048, 2048), 6, 16, interlace=True, filters=(1, 2, 4)),
        "prog_422_37x53.jpg": _pillow_jpeg(small, quality=50,
                                           subsampling=1, progressive=True),
        "restart_444_37x53.jpg": _pillow_jpeg(small, quality=95,
                                              subsampling=0,
                                              restart_marker_blocks=2),
        "grey_37x53.jpg": _pillow_jpeg(small, "L", quality=75),
        "sampled_411_37x53.jpg": jpeg_baseline(
            [ycc[..., k] for k in range(3)], [(4, 1), (1, 1), (1, 1)],
            lum),
        "grey2_adam7_13x9.png": png_bytes(grey, 0, 2, interlace=True,
                                          filters=(4, 3)),
        "palette4_13x9.png": png_bytes(
            (np.arange(9 * 13).reshape(9, 13, 1) * 5) % 16, 3, 4,
            plte=(np.arange(48) * 37) % 256, trns=bytes([0, 128, 255, 7]),
            filters=(1, 2)),
        "grey16_13x9.png": png_bytes(
            (np.arange(9 * 13).reshape(9, 13, 1) * 41) % 600, 0, 16,
            trns=struct.pack(">H", 0x0129), filters=(3,)),
    }


def rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    """JFIF's RGB -> YCbCr, rounded (the encoder side; any will do)."""
    r, g, b = (rgb[..., k].astype(np.float64) for k in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128 + 0.5 * r - 0.418688 * g - 0.081312 * b
    return np.clip(np.round(np.stack([y, cb, cr], -1)), 0, 255)


def pillow_rgba(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"),
                      np.uint8)


def digest(rgba: np.ndarray) -> dict:
    return {"sha256": hashlib.sha256(np.ascontiguousarray(rgba).tobytes())
            .hexdigest(), "shape": list(rgba.shape)}


def imageio_env(path: str) -> dict:
    """The JAX package's ``load_hdr_image`` array of a sky: SHA-256,
    shape and dtype."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from metal_pathtracer_tpu.ops.env import load_hdr_image

    img = load_hdr_image(path)
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes())
            .hexdigest(), "shape": list(img.shape), "dtype": str(img.dtype)}


def _write_record(path: str, record: dict) -> None:
    with open(path, "w") as fh:
        json.dump(record, fh, indent=1, sort_keys=True)
        fh.write("\n")


def main() -> None:
    record = {}
    with tempfile.TemporaryDirectory() as tmp:
        made = dict(fixtures(), **variant_fixtures(build_jpeg_writer(tmp)))
    for name, data in made.items():
        with open(os.path.join(HERE, name), "wb") as fh:
            fh.write(data)
        record[name] = digest(pillow_rgba(data))
        print(f"{name}: {len(data)} bytes, {record[name]['shape']}")
    _write_record(DIGESTS, record)
    _write_record(ENV_DIGESTS, {name: imageio_env(os.path.join(HERE, name))
                                for name in SKIES})


if __name__ == "__main__":
    main()
