"""Image writers and readers: PPM / PFM / PNG / EXR (incl. multilayer AOV
EXR) (``utils/image_io.py`` twin; the same bytes for the same image).

Format-for-format replacement of the reference's ImageWriter
(reference: src/renderer/ImageWriter.mm, include/renderer/ImageWriter.h:8-65):
- PPM P6 with CPU tonemap (ImageWriter.mm:164-191)
- PFM little-endian, bottom-to-top rows (ImageWriter.mm:193-215)
- PNG via zlib (the reference uses macOS ImageIO; output pixels match the
  tonemap replicas)
- uncompressed scanline EXR writer + multilayer variant with a SAMPLES
  channel and colorspace metadata (ImageWriter.mm WriteScanlineEXR/
  WriteEXR_Multilayer)
"""

from __future__ import annotations

import struct as _struct
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

import torch

from metal_pathtracer_tpu_torch.ops import tonemap as tonemap_ops


@dataclass
class TonemapSettings:
    """(reference: include/renderer/ImageWriter.h TonemapSettings)"""

    tonemapMode: int = 1
    acesVariant: int = 0
    exposure: float = 0.0
    reinhardWhitePoint: float = 1.5


def tonemap_to_u8(linear_rgb: np.ndarray, tonemap: TonemapSettings) -> np.ndarray:
    """HDR -> LDR bytes, matching the CPU replica incl. lround semantics
    (reference: ImageWriter.mm:140-177). Numpy in, the tonemap in torch on
    the CPU, like the reference's CPU tonemap replicas."""
    color = tonemap_ops.apply_tonemap(
        torch.from_numpy(np.array(linear_rgb, np.float32)),
        tonemap.tonemapMode, tonemap.acesVariant, tonemap.exposure,
        tonemap.reinhardWhitePoint)
    color = color.numpy().astype(np.float32)
    # std::lround rounds half away from zero; values are >= 0 here.
    return np.clip(np.floor(color * 255.0 + 0.5), 0, 255).astype(np.uint8)


def write_ppm(path: str, linear_rgb: np.ndarray,
              tonemap: Optional[TonemapSettings] = None) -> None:
    """Binary P6 (reference: ImageWriter.mm WritePPM:164-191)."""
    tonemap = tonemap or TonemapSettings()
    h, w = linear_rgb.shape[:2]
    ldr = tonemap_to_u8(linear_rgb, tonemap)
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode("ascii"))
        f.write(ldr.tobytes())


def read_ppm(path: str) -> np.ndarray:
    """(H,W,3) uint8 of a binary P6 file as ``write_ppm`` writes it."""
    with open(path, "rb") as f:
        data = f.read()
    parts = data.split(b"\n", 3)
    if len(parts) != 4 or parts[0] != b"P6" or parts[2] != b"255":
        raise ValueError(f"{path}: not an 8-bit binary PPM")
    w, h = map(int, parts[1].split())
    pixels = np.frombuffer(parts[3][: w * h * 3], np.uint8)
    return pixels.reshape(h, w, 3)


def write_pfm(path: str, linear_rgb: np.ndarray) -> None:
    """Little-endian PF, rows bottom-to-top
    (reference: ImageWriter.mm WritePFM:193-215)."""
    h, w = linear_rgb.shape[:2]
    data = np.asarray(linear_rgb, "<f4")
    with open(path, "wb") as f:
        f.write(f"PF\n{w} {h}\n-1.0\n".encode("ascii"))
        for y in range(h - 1, -1, -1):
            f.write(data[y].tobytes())


def read_pfm(path: str) -> np.ndarray:
    """(H,W,C) float32 of a PF (3 channels) or Pf (1) file, top row
    first."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM file")
        channels = 3 if header == b"PF" else 1
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(), dtype, count=w * h * channels)
    img = data.reshape(h, w, channels)[::-1]
    return img.astype(np.float32)


# ---------------------------------------------------------------------------
# PNG (zlib-deflate true-color, 8-bit)
# ---------------------------------------------------------------------------

def write_png(path: str, linear_rgb: np.ndarray,
              tonemap: Optional[TonemapSettings] = None) -> None:
    tonemap = tonemap or TonemapSettings()
    ldr = tonemap_to_u8(linear_rgb, tonemap)
    write_png_u8(path, ldr)


def encode_png_u8(rgb_u8: np.ndarray, level: int = 6) -> bytes:
    """In-memory PNG encode (true-color 8-bit) — the live viewer streams
    these without touching disk."""
    h, w = rgb_u8.shape[:2]
    raw = b"".join(b"\x00" + rgb_u8[y].tobytes() for y in range(h))
    compressed = zlib.compress(raw, level)

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (_struct.pack(">I", len(payload)) + tag + payload
                + _struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = _struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", compressed) + chunk(b"IEND", b""))


def write_png_u8(path: str, rgb_u8: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png_u8(rgb_u8))


# ---------------------------------------------------------------------------
# EXR: uncompressed scanline writer (+ multilayer with SAMPLES channel)
# ---------------------------------------------------------------------------

def _exr_attr(name: bytes, type_name: bytes, payload: bytes) -> bytes:
    return name + b"\x00" + type_name + b"\x00" + _struct.pack("<I", len(payload)) + payload


def _exr_channel_list(names: List[str]) -> bytes:
    # Channels must be sorted alphabetically in the file.
    out = b""
    for name in sorted(names):
        out += name.encode("ascii") + b"\x00"
        out += _struct.pack("<iIii", 2, 0, 1, 1)  # FLOAT, linear, xsamp, ysamp
    return out + b"\x00"


def write_exr(path: str, channels: Dict[str, np.ndarray],
              colorspace: str = "linear-srgb") -> None:
    """Minimal uncompressed single-part scanline EXR, FLOAT channels.

    Mirrors the reference's dependency-free writer
    (reference: ImageWriter.mm WriteScanlineEXR), including the colorspace
    string metadata attribute.
    """
    names = list(channels.keys())
    first = next(iter(channels.values()))
    h, w = first.shape[:2]
    if any(v.shape[:2] != (h, w) for v in channels.values()):
        raise ValueError("write_exr: every channel must be the same size")

    sorted_names = sorted(names)
    header = b""
    header += _exr_attr(b"channels", b"chlist", _exr_channel_list(names))
    header += _exr_attr(b"compression", b"compression", b"\x00")  # none
    box = _struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _exr_attr(b"dataWindow", b"box2i", box)
    header += _exr_attr(b"displayWindow", b"box2i", box)
    header += _exr_attr(b"lineOrder", b"lineOrder", b"\x00")  # increasing Y
    header += _exr_attr(b"pixelAspectRatio", b"float", _struct.pack("<f", 1.0))
    header += _exr_attr(b"screenWindowCenter", b"v2f", _struct.pack("<ff", 0.0, 0.0))
    header += _exr_attr(b"screenWindowWidth", b"float", _struct.pack("<f", 1.0))
    cs = colorspace.encode("ascii")
    header += _exr_attr(b"colorspace", b"string", cs)
    header += b"\x00"  # end of header

    magic = _struct.pack("<I", 20000630) + _struct.pack("<I", 2)
    scanline_data_size = w * 4 * len(names)
    scanline_size = 4 + 4 + scanline_data_size  # y + size + pixels
    table_start = len(magic) + len(header)
    data_start = table_start + 8 * h

    with open(path, "wb") as f:
        f.write(magic)
        f.write(header)
        for y in range(h):
            f.write(_struct.pack("<Q", data_start + y * scanline_size))
        for y in range(h):
            f.write(_struct.pack("<i", y))
            f.write(_struct.pack("<I", scanline_data_size))
            for name in sorted_names:
                row = np.ascontiguousarray(channels[name][y], "<f4")
                f.write(row.tobytes())


def write_exr_rgb(path: str, linear_rgb: np.ndarray,
                  colorspace: str = "linear-srgb") -> None:
    """(reference: ImageWriter.mm WriteEXR)"""
    write_exr(path, {
        "R": linear_rgb[..., 0],
        "G": linear_rgb[..., 1],
        "B": linear_rgb[..., 2],
    }, colorspace)


def write_exr_multilayer(path: str, linear_rgb: np.ndarray,
                         albedo: Optional[np.ndarray] = None,
                         normal: Optional[np.ndarray] = None,
                         samples: Optional[np.ndarray] = None,
                         colorspace: str = "linear-srgb") -> None:
    """RGB + AOV layers + per-pixel SAMPLES count
    (reference: ImageWriter.h WriteEXR_Multilayer:58-63)."""
    channels = {
        "R": linear_rgb[..., 0],
        "G": linear_rgb[..., 1],
        "B": linear_rgb[..., 2],
    }
    if albedo is not None:
        channels["albedo.R"] = albedo[..., 0]
        channels["albedo.G"] = albedo[..., 1]
        channels["albedo.B"] = albedo[..., 2]
    if normal is not None:
        channels["normal.R"] = normal[..., 0]
        channels["normal.G"] = normal[..., 1]
        channels["normal.B"] = normal[..., 2]
    if samples is not None:
        channels["SAMPLES"] = samples.astype(np.float32)
    write_exr(path, channels, colorspace)


def read_exr(path: str) -> Dict[str, np.ndarray]:
    """Reader for uncompressed scanline EXRs of FLOAT channels, as this
    module writes them (round trips, golden comparisons, environment
    maps): channel name -> (H,W) float32."""
    with open(path, "rb") as f:
        data = f.read()
    if _struct.unpack("<I", data[:4])[0] != 20000630:
        raise ValueError(f"{path}: not an OpenEXR file")
    pos = 8
    channels: List[str] = []
    width = height = 0
    while True:
        end = data.index(b"\x00", pos)
        name = data[pos:end].decode("ascii")
        if not name:
            pos = end + 1
            break
        pos = end + 1
        end = data.index(b"\x00", pos)
        type_name = data[pos:end].decode("ascii")
        pos = end + 1
        size = _struct.unpack("<I", data[pos:pos + 4])[0]
        pos += 4
        payload = data[pos:pos + size]
        pos += size
        if name == "channels":
            cpos = 0
            while payload[cpos] != 0:
                cend = payload.index(b"\x00", cpos)
                channels.append(payload[cpos:cend].decode("ascii"))
                if _struct.unpack("<i", payload[cend + 1:cend + 5])[0] != 2:
                    raise ValueError(f"{path}: only FLOAT channels are read")
                cpos = cend + 1 + 16
        elif name == "compression" and payload != b"\x00":
            raise ValueError(f"{path}: only uncompressed EXR is read")
        elif name == "dataWindow":
            x0, y0, x1, y1 = _struct.unpack("<iiii", payload)
            width, height = x1 - x0 + 1, y1 - y0 + 1

    channels_sorted = sorted(channels)
    pos += 8 * height  # skip offset table
    out = {c: np.zeros((height, width), np.float32) for c in channels}
    for _ in range(height):
        y = _struct.unpack("<i", data[pos:pos + 4])[0]
        pos += 8
        for c in channels_sorted:
            row = np.frombuffer(data[pos:pos + width * 4], "<f4")
            out[c][y] = row
            pos += width * 4
    return out


def write_image(path: str, linear_rgb: np.ndarray, fmt: str,
                tonemap: Optional[TonemapSettings] = None, **aovs) -> None:
    """Dispatch by format name (reference: ImageWriter.mm WriteImage)."""
    fmt = fmt.lower()
    if fmt == "ppm":
        write_ppm(path, linear_rgb, tonemap)
    elif fmt == "pfm":
        write_pfm(path, linear_rgb)
    elif fmt == "png":
        write_png(path, linear_rgb, tonemap)
    elif fmt == "exr":
        if aovs:
            write_exr_multilayer(path, linear_rgb, **aovs)
        else:
            write_exr_rgb(path, linear_rgb)
    else:
        raise ValueError(f"unsupported output format: {fmt}")
