"""Writers of the texture-image fixtures that ``chip_smoke.py`` decodes on
the card's host (which has no Pillow) and ``tests/test_torch_image_formats
.py`` checks, and the encoders those tests share.

    python tests/images/make_fixtures.py   # needs Pillow

writes each fixture beside this file and ``pillow_rgba.json``: Pillow's
``Image.open(...).convert("RGBA")`` of each, as the SHA-256 of its bytes
and its shape. Pillow writes the JPEGs it can write; the PNGs of depths
and layouts Pillow cannot write, and the 4:1:1 JPEG (Pillow's encoder
has no 4:1:1), are written here: ``png_bytes`` (every colour type and
depth, Adam7, each row with its own filter) and ``jpeg_baseline`` (a
baseline encoder: a float DCT, one quantisation table per component,
fixed-length Huffman codes).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DIGESTS = os.path.join(HERE, "pillow_rgba.json")

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


def jpeg_baseline(planes, factors, quant, ids=None, app14=None) -> bytes:
    """A baseline JPEG of full-size component planes (uint8, (h, w)),
    each downsampled by (h, v) divisors from ``factors`` (the SOF's
    sampling factors) and quantised by ``quant`` (64 values, natural
    order, one table for every component). ``ids``: component ids
    (default 1, 2, 3); ``app14``: an Adobe transform byte to write."""
    h, w = planes[0].shape
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    comps = []
    for plane, (fh, fv) in zip(planes, factors):
        sx, sy = hmax // fh, vmax // fv
        cw, chh = -(-w // sx), -(-h // sy)
        p = np.pad(plane.astype(np.float64),
                   ((0, chh * sy - h), (0, cw * sx - w)), mode="edge")
        p = p.reshape(chh, sy, cw, sx).mean((1, 3))
        p = np.pad(p, ((0, my * fv * 8 - chh), (0, mx * fh * 8 - cw)),
                   mode="edge")
        comps.append((p - 128.0, fh, fv))
    quant = np.asarray(quant, np.int64)
    bits, preds = _Bits(), [0] * len(comps)
    for by in range(my):
        for bx in range(mx):
            for c, (p, fh, fv) in enumerate(comps):
                for v in range(fv):
                    for u in range(fh):
                        y0, x0 = (by * fv + v) * 8, (bx * fh + u) * 8
                        blk = _DCT @ p[y0:y0 + 8, x0:x0 + 8] @ _DCT.T
                        q = np.round(blk.reshape(-1) / quant).astype(int)
                        zz = q[ZIGZAG]
                        s, b = _category(int(zz[0]) - preds[c])
                        preds[c] = int(zz[0])
                        bits.put(_DC_SYMBOLS.index(s), 4)
                        bits.put(b, s)
                        run = 0
                        last = max([k for k in range(1, 64) if zz[k]],
                                   default=0)
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
    bits.flush()

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
    out += seg(0xDA, bytes([len(planes)]) + b"".join(
        bytes([i, 0x00]) for i in ids) + bytes([0, 63, 0]))
    return out + bytes(bits.out) + b"\xff\xd9"


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


def _rgba16(h: int, w: int) -> np.ndarray:
    """Smooth 16-bit ramps with a checker in blue: every filter leaves
    small residuals, so the file stays small."""
    yy, xx = np.mgrid[0:h, 0:w]
    checker = (xx // 64 + yy // 64) % 2
    return np.stack([xx * 32, yy * 32, (xx + yy) * 16 + 30000 * checker,
                     65535 - yy * 16], -1) & 0xFFFF


def fixtures() -> dict:
    """name -> file bytes. The two 2048x2048 images are the ones whose
    decode time ``chip_smoke.py`` prints."""
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


def main() -> None:
    record = {}
    for name, data in fixtures().items():
        with open(os.path.join(HERE, name), "wb") as fh:
            fh.write(data)
        record[name] = digest(pillow_rgba(data))
        print(f"{name}: {len(data)} bytes, {record[name]['shape']}")
    with open(DIGESTS, "w") as fh:
        json.dump(record, fh, indent=1, sort_keys=True)
        fh.write("\n")


if __name__ == "__main__":
    main()
