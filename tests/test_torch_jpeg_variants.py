"""The JPEGs beyond baseline and Huffman progressive that the port decodes
by itself (``utils/jpeg.py``, ``hostsrc/jpeg_entropy.c``,
``hostsrc/jpeg_arith.c``, ``hostsrc/jpeg_smooth.c``), each against the
JAX package's ``gltf._decode_image`` (Pillow's ``convert("RGBA")`` over
libjpeg-turbo) bit for bit:

- CMYK (Pillow's writer: an Adobe marker; Pillow reads every CMYK file as
  Adobe's inverted ``CMYK;I``) and YCCK;
- every integer sampling ratio of factors 1-4 (4:4:0 through the fancy
  h1v2 filter, the others replicated), at odd and tiny sizes;
- 8-bit lossless at predictors 1-7, with point transforms, restarts and
  subsampling, in RGB (no JFIF or Adobe marker: libjpeg-turbo assumes
  RGB), grey and CMYK;
- arithmetic-coded sequential and progressive files (the committed
  fixtures, written by ``tests/images/jpeg_writer.c`` over libjpeg);
- block smoothing: Pillow's progressive files cut after each scan, so
  that coefficients stay unrefined or absent, and the fixtures that leave
  only high-frequency (plain decode) or low-frequency (smoothed)
  coefficients unrefined;
- components that no scan codes, and the colour-space markers as libjpeg
  latches them at the first scan.

Every refusal left is one that Pillow shares: each is shown raising in
Pillow on the same bytes. Last, a GLB textured with variant JPEGs renders
in the port as in the JAX package at the ladder's tight gate (one JAX
render). Images are made here with numpy seeds through Pillow, through
``make_fixtures``' baseline and lossless encoders, or are the committed
fixtures; ~20 s.
"""

import importlib.util
import io
import json
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from metal_pathtracer_tpu.scene.gltf import _decode_image as pillow_decode
from metal_pathtracer_tpu_torch.utils.image_io import (
    ImageFormatError,
    decode_image,
)

IMAGES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "images")
_spec = importlib.util.spec_from_file_location(
    "make_fixtures", os.path.join(IMAGES, "make_fixtures.py"))
F = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(F)

#: the committed fixtures of this file's variants (``make_fixtures
#: .variant_fixtures``), the skies excepted
with open(F.DIGESTS) as _fh:
    VARIANTS = sorted(n for n in json.load(_fh) if n.endswith(".jpg")
                      and not n.startswith(("sky", "tex_", "grey_",
                                            "prog_422", "restart_",
                                            "sampled_411")))


def _fixture(name: str) -> bytes:
    with open(os.path.join(IMAGES, name), "rb") as fh:
        return fh.read()


def _same(data: bytes):
    want = pillow_decode(data)
    got = decode_image(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _pillow(img, mode="RGB", **kw) -> bytes:
    """Pillow's JPEG of an RGB image converted to ``mode``, or of a CMYK
    image (four channels)."""
    buf = io.BytesIO()
    src = Image.fromarray(img, "CMYK") if mode == "CMYK" \
        else Image.fromarray(img, "RGB").convert(mode)
    src.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _scans(data: bytes) -> list:
    return [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]


def test_variant_fixtures_cover_the_variants():
    """Between them the committed fixtures hold each variant: what their
    headers say."""
    kinds = set()
    for name in VARIANTS:
        data = _fixture(name)
        sof = next(i for i in range(2, len(data) - 1) if data[i] == 0xFF
                   and 0xC0 <= data[i + 1] <= 0xCF
                   and data[i + 1] not in (0xC4, 0xC8, 0xCC))
        marker, n = data[sof + 1], data[sof + 9]
        kinds.add({0xC3: "lossless", 0xC9: "arithmetic",
                   0xCA: "arithmetic progressive"}.get(marker, "dct"))
        if n == 4:
            adobe = data.find(b"Adobe")
            kinds.add("cmyk plain" if adobe < 0 else
                      {0: "cmyk adobe", 2: "ycck"}[data[adobe + 11]])
        if b"\xff\xdd" in data and marker in (0xC3, 0xC9, 0xCA):
            kinds.add(f"{'lossless' if marker == 0xC3 else 'arithmetic'} "
                      "restarts")
        factors = [(data[sof + 11 + 3 * k] >> 4, data[sof + 11 + 3 * k] & 15)
                   for k in range(n)]
        if factors[0] == (1, 2):
            kinds.add("4:4:0")
        if factors[0] == (3, 1):
            kinds.add("int_upsample")
        if marker == 0xC3:
            sos = _scans(data)[0]
            kinds.add(f"predictor {data[sos + 5 + 2 * n]}")
            if data[sos + 7 + 2 * n]:
                kinds.add("point transform")
    assert kinds >= {"lossless", "arithmetic", "arithmetic progressive",
                     "cmyk plain", "cmyk adobe", "ycck", "lossless restarts",
                     "arithmetic restarts", "4:4:0", "int_upsample",
                     "point transform",
                     *(f"predictor {p}" for p in range(1, 8))}


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_fixture_matches_pillow(name):
    _same(_fixture(name))


def test_smoothing_fixtures_are_what_they_say():
    """``prog_smoothed`` changes under block smoothing, ``prog_highfreq``
    (only zigzag 10-63 unrefined) decodes plainly."""
    from metal_pathtracer_tpu_torch.utils import jpeg

    frames = {}

    def grab(frame):
        frames["f"] = frame
        return False

    for name, smoothed in (("prog_smoothed_37x53.jpg", True),
                           ("prog_highfreq_37x53.jpg", False)):
        data = _fixture(name)
        on = decode_image(data)
        original = jpeg._smoothing
        try:
            jpeg._smoothing = grab
            off = decode_image(data)
        finally:
            jpeg._smoothing = original
        assert original(frames["f"]) == smoothed
        assert (not np.array_equal(on, off)) == smoothed


@pytest.mark.parametrize("quality", [50, 90])
def test_cmyk_and_ycck_seeded(quality):
    """Pillow's CMYK writer at 53x37, 9x17 and 1x1; its bytes with the
    Adobe marker dropped (plain CMYK, read inverted all the same) and
    with transform 2 (YCCK: the same samples read as Y, Cb, Cr, K)."""
    rng = np.random.default_rng(quality)
    for h, w in ((53, 37), (9, 17), (1, 1)):
        data = _pillow(rng.integers(0, 256, (h, w, 4), dtype=np.uint8),
                       "CMYK", quality=quality)
        _same(data)
        adobe = data.index(b"Adobe") - 4
        length = struct.unpack_from(">H", data, adobe + 2)[0]
        _same(data[:adobe] + data[adobe + 2 + length:])
        ycck = bytearray(data)
        ycck[adobe + 4 + 11] = 2
        _same(bytes(ycck))


#: factor sets whose ratios cover every integer ratio of factors 1-4,
#: in one interleaved scan where its MCU holds at most 10 blocks and in a
#: scan a component otherwise
FACTOR_SETS = [[(1, 2), (1, 1), (1, 1)], [(1, 3), (1, 1), (1, 1)],
               [(1, 4), (1, 1), (1, 1)], [(3, 1), (1, 1), (1, 1)],
               [(2, 3), (1, 1), (1, 1)], [(3, 2), (1, 1), (1, 1)],
               [(2, 4), (1, 1), (1, 1)], [(4, 2), (1, 1), (1, 1)],
               [(2, 2), (1, 2), (2, 1)], [(1, 1), (2, 2), (1, 1)],
               [(4, 1), (2, 1), (1, 1)], [(1, 4), (1, 2), (1, 1)],
               [(3, 3), (1, 1), (1, 1)], [(4, 3), (1, 1), (1, 1)],
               [(3, 4), (1, 1), (1, 1)], [(4, 4), (2, 2), (1, 1)]]


@pytest.mark.parametrize("factors", FACTOR_SETS,
                         ids=lambda f: "-".join(f"{h}{v}" for h, v in f))
def test_every_integer_sampling_ratio(factors):
    """This repository's baseline encoder at each factor set, at sizes
    that leave partial MCUs and components one or two samples wide or
    high (4:4:0's vertical filter has no width rule)."""
    rng = np.random.default_rng(sum(h * 5 + v for h, v in factors))
    interleaved = sum(h * v for h, v in factors) <= 10
    for h, w in ((53, 37), (2, 9), (9, 2), (1, 1), (17, 3)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        ycc = F.rgb_to_ycc(img).astype(np.uint8)
        _same(F.jpeg_baseline([ycc[..., k] for k in range(3)], factors,
                              np.full(64, 6), interleaved=interleaved))


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_seeded(predictor):
    """Each predictor on seeded RGB planes, with and without a point
    transform and restarts every MCU row or two; subsampled RGB
    (replicated: a lossless file has no fancy upsampling); grey; CMYK
    with and without an Adobe marker."""
    rng = np.random.default_rng(predictor)
    img = rng.integers(0, 256, (11, 13, 4), dtype=np.uint8)
    rgb = [img[..., k] for k in range(3)]
    for pt in (0, 3):
        for rows in (0, 1, 2):
            _same(F.jpeg_lossless(rgb, predictor=predictor, pt=pt,
                                  restart_rows=rows))
    _same(F.jpeg_lossless([img[..., 0], img[::2, ::2, 1], img[::2, ::2, 2]],
                          [(2, 2), (1, 1), (1, 1)], predictor=predictor,
                          restart_rows=2))
    _same(F.jpeg_lossless([img[..., 0], img[:, ::3, 1], img[:, ::3, 2]],
                          [(3, 1), (1, 1), (1, 1)], predictor=predictor))
    _same(F.jpeg_lossless([img[..., 1]], predictor=predictor, pt=1,
                          restart_rows=3))
    adobe0 = F._segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0]))
    for app in (b"", adobe0):
        _same(F.jpeg_lossless([img[..., k] for k in range(4)],
                              predictor=predictor, app=app))
    _same(F.jpeg_lossless(rgb, predictor=predictor, ids=[82, 71, 66]))


@pytest.mark.parametrize("case", ["444-q90", "420-q50", "422-q75", "grey",
                                  "420-restart"])
def test_block_smoothing_of_cut_progressive_files(case):
    """Pillow's progressive file cut after each of its scans (then EOI):
    DC only (DC interpolation), DC without its refinement, AC bands first
    at a shifted bit, all as libjpeg smooths them, at 53x37 (4:2:0: the
    luma's iMCU rows of two block rows, a last one of one row), 8x40 and
    40x8."""
    sub, _, q = case.partition("-q")
    kw = {"quality": int(q or 80), "progressive": True}
    if sub == "grey":
        kw["mode"] = "L"
    else:
        kw["subsampling"] = {"444": 0, "422": 1, "420": 2}[sub[:3]]
    if case.endswith("restart"):
        kw["restart_marker_rows"] = 1
    mode = kw.pop("mode", "RGB")
    rng = np.random.default_rng(len(case))
    for h, w in ((53, 37), (8, 40), (40, 8)):
        data = _pillow(F.texture(h, w, seed=int(rng.integers(100))), mode,
                       **kw)
        scans = _scans(data)
        assert len(scans) >= 6
        for cut in scans[1:]:
            _same(data[:cut] + b"\xff\xd9")


def test_component_without_a_scan():
    """A sequential file of one scan a component whose last scan is cut:
    its third component keeps zero coefficients, as libjpeg's zeroed
    coefficient arrays leave it."""
    img = F.texture(24, 20, seed=3)
    ycc = F.rgb_to_ycc(img).astype(np.uint8)
    for factors in ([(1, 1)] * 3, [(2, 2), (1, 1), (1, 1)]):
        data = F.jpeg_baseline([ycc[..., k] for k in range(3)], factors,
                               np.full(64, 5), interleaved=False)
        _same(data)
        _same(data[:_scans(data)[2]] + b"\xff\xd9")


def test_colour_space_markers_as_libjpeg_latches_them():
    """Two Adobe markers: the last one before the first scan wins; an
    Adobe marker after the first scan changes nothing."""
    img = F.texture(24, 20, seed=8)
    rgb = F.jpeg_baseline([img[..., k] for k in range(3)], [(1, 1)] * 3,
                          np.full(64, 4), app14=0)
    adobe1 = F._segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 1]))
    _same(rgb[:2] + adobe1 + rgb[2:])
    dqt = rgb.index(b"\xff\xdb")
    _same(rgb[:dqt] + adobe1 + rgb[dqt:])
    prog = _pillow(img, quality=85, progressive=True, keep_rgb=True)
    second = _scans(prog)[1]
    _same(prog[:second] + adobe1 + prog[second:])


# ---- refusals: each one Pillow shares -------------------------------------

def _patched(data: bytes, offset: int, value: bytes) -> bytes:
    return data[:offset] + value + data[offset + len(value):]


def _refusals() -> dict:
    img = F.texture(24, 20, seed=9)
    ycc = F.rgb_to_ycc(img).astype(np.uint8)
    planes = [ycc[..., k] for k in range(3)]
    base = F.jpeg_baseline(planes, [(1, 1)] * 3, np.full(64, 8))
    sof = base.index(b"\xff\xc0")
    out = {"12-bit": _patched(base, sof + 4, b"\x0c"),
           "two components": F.jpeg_baseline(planes[:2], [(1, 1)] * 2,
                                             np.full(64, 8)),
           "DNL height": _patched(base, sof + 5, b"\x00\x00"),
           "zero width": _patched(base, sof + 7, b"\x00\x00"),
           "fractional 3x2": F.jpeg_baseline(
               planes, [(3, 1), (2, 1), (1, 1)], np.full(64, 8)),
           "11 blocks an MCU": F.jpeg_baseline(
               planes, [(3, 3), (1, 1), (1, 1)], np.full(64, 8)),
           "12 blocks an MCU": F.jpeg_baseline(
               planes, [(2, 2), (2, 2), (2, 2)], np.full(64, 8)),
           "lossless 11 blocks": F.jpeg_lossless(
               [img[..., 0], img[::3, ::3, 1], img[::3, ::3, 2]],
               [(3, 3), (1, 1), (1, 1)]),
           "lossless JFIF": F.jpeg_lossless(
               [img[..., k] for k in range(3)],
               app=F._segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")),
           "lossless Adobe 1": F.jpeg_lossless(
               [img[..., k] for k in range(3)],
               app=F._segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0,
                                                      1]))),
           "lossless YCCK": F.jpeg_lossless(
               [img[..., k % 3] for k in range(4)],
               app=F._segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0,
                                                      2])))}
    for marker in (0xC5, 0xC6, 0xC7, 0xCB, 0xCD, 0xCE, 0xCF):
        out[f"SOF{marker - 0xC0}"] = _patched(base, sof + 1, bytes([marker]))
    restart = F.jpeg_lossless([img[..., k] for k in range(3)],
                              restart_rows=2)
    dri = restart.index(b"\xff\xdd")
    for interval in (10, 41):   # rows of 20 MCUs
        out[f"lossless restart {interval}"] = _patched(
            restart, dri + 4, struct.pack(">H", interval))
    return out


REFUSALS = _refusals()


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_parity_refusal(name):
    data = REFUSALS[name]
    with pytest.raises(Exception):
        pillow_decode(data)
    with pytest.raises(ImageFormatError, match="Pillow refuses it too") \
            as err:
        decode_image(data)
    assert "Queue" not in str(err.value)


# ---- a GLB textured with variant JPEGs, against the JAX render --------------

@pytest.fixture
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_variant_textured_glb_render_matches_jax(tmp_path, _one_thread):
    """``test_torch_gltf_render.py``'s scene with its base colour the
    arithmetic progressive 4:2:2 fixture and its ground the YCCK fixture:
    40x24, 2 spp, d4, the ladder's tight gate."""
    import test_torch_gltf_render as G
    from metal_pathtracer_tpu.scene import dsl as jax_dsl
    from metal_pathtracer_tpu.scene.meshload import mesh_loader as jax_loader
    from metal_pathtracer_tpu.scene.resources import (
        SceneResources as JResources,
    )
    from metal_pathtracer_tpu.settings import RenderSettings as JSettings
    from metal_pathtracer_tpu_torch.scene import dsl
    from metal_pathtracer_tpu_torch.scene.resources import SceneResources
    from metal_pathtracer_tpu_torch.settings import RenderSettings
    from metal_pathtracer_tpu_torch.utils import meshfiles
    from test_torch_prims_render import assert_gate, render_pair

    images = G._images()
    images[0] = _fixture("arith_prog_37x53.jpg")
    images[3] = _fixture("ycck_422_37x53.jpg")
    meshfiles.write_glb(str(tmp_path / "mapped.glb"), G._meshes(),
                        G._MATERIALS, images, nodes=[
                            {"mesh": 0, "name": "ball"},
                            {"mesh": 1, "name": "ground"}])
    path = tmp_path / "mapped.scene"
    path.write_text(
        "camera target=0,0,0 distance=3.2 yaw=0.5 pitch=0.25 vfov=40\n"
        "renderer maxDepth=4 seed=23\n"
        "material type=lambert albedo=0.6,0.55,0.5\n"
        "sphere center=1.3,-0.25,-0.4 radius=0.35 material=0\n"
        "mesh path=mapped.glb\n")
    ps, pr, js, jr = RenderSettings(), SceneResources(), JSettings(), \
        JResources()
    dsl.load_scene_file(str(path), ps, pr)
    jax_dsl.load_scene_file(str(path), js, jr, mesh_loader=jax_loader)
    for got, want in zip(pr.texture_images, jr.texture_images):
        np.testing.assert_array_equal(got, want)
    assert sorted(im.shape[:2] for im in pr.texture_images) == \
        [(16, 16), (32, 32), (53, 37), (53, 37)]
    r = render_pair((ps, pr), (js, jr), G.W, G.H, G.DEPTH, G._environment,
                    G._toy_env())
    assert_gate(r, 2e-4, 0.98)
