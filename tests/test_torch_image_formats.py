"""Texture images the port decodes by itself (``utils/image_io.decode_image``:
PNG of every bit depth and colour type, interlaced or not; baseline and
progressive JPEG through ``utils/jpeg.py`` and its C entropy decoder; the
other JPEG variants in ``test_torch_jpeg_variants.py``),
against the JAX package's ``gltf._decode_image`` (Pillow's
``convert("RGBA")``), bit for bit, on images made here with numpy and
Pillow, or written by ``tests/images/make_fixtures.py`` where Pillow
cannot write them (16-bit RGB, sub-byte grey, Adam7, 4:1:1 JPEG).

Pillow's rules the decoders reproduce, pinned here: 16-bit samples keep
their high byte, but 16-bit grey (``I;16``) clips at 255; sub-byte grey
is scaled (x255, x85, x17); a tRNS colour key is compared with the 8-bit
values through its low bytes (so a 16-bit key never matches a 16-bit
image's own sample unless its low byte equals the high byte; any nonzero
key of a 1-bit image means white). The committed fixtures that
``chip_smoke.py`` decodes on the card's host are checked against the
Pillow digests recorded beside them. Last, a GLB whose textures are JPEGs
renders in the port as in the JAX package, at the ladder's tight gate
(one JAX render).
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
SIZES = ((1, 1), (5, 3), (53, 37))   # (h, w)
DEPTHS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
          (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


def _same(data: bytes):
    want = pillow_decode(data)
    got = decode_image(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ctype,depth", DEPTHS)
def test_png_every_depth_and_colour_type(ctype, depth):
    """Each size plain and interlaced, the rows filtered with all five
    filters in turn; a colour key or palette alphas where the colour type
    has them."""
    rng = np.random.default_rng(ctype * 100 + depth)
    ch = F.CHANNELS[ctype]
    top = (1 << depth) - 1
    for h, w in SIZES:
        px = rng.integers(0, top + 1, (h, w, ch))
        if ctype == 0 and depth == 16:   # around Pillow's clip at 255
            px[0, 0] = rng.choice([0, 16, 240, 255, 256, 272, 0x1234])
        kw = {}
        if ctype == 3:
            n = 1 << depth
            kw["plte"] = rng.integers(0, 256, (n, 3))
            kw["trns"] = rng.integers(0, 256, max(1, n // 3),
                                      dtype=np.uint8).tobytes()
        for interlace in (False, True):
            _same(F.png_bytes(px, ctype, depth, interlace=interlace,
                              filters=(0, 1, 2, 3, 4), **kw))
        if ctype in (0, 2):   # colour keys: the first pixel's, then its
            key = px[0, 0].astype(np.int64)   # high bits set
            for k in (key, key | 0x100):
                _same(F.png_bytes(px, ctype, depth, trns=b"".join(
                    struct.pack(">H", int(v) & 0xFFFF) for v in k)))


def test_png_pillow_quirks():
    """The traps as numbers: the high byte, the I;16 clip, the sub-byte
    scales, a 16-bit key against the low byte."""
    rgb = F.png_bytes([[[0x1234, 0xABCD, 0x00FF]]], 2, 16)
    assert decode_image(rgb)[0, 0].tolist() == [18, 171, 0, 255]
    ga = F.png_bytes([[[0x1234, 0xABCD]]], 4, 16)
    assert decode_image(ga)[0, 0].tolist() == [18, 18, 18, 171]
    values = [0, 16, 240, 256, 272]
    grey = F.png_bytes(np.array(values).reshape(1, -1, 1), 0, 16)
    assert decode_image(grey)[0, :, 0].tolist() == [0, 16, 240, 255, 255]
    for depth, scale in ((1, 255), (2, 85), (4, 17)):
        px = np.arange(1 << depth).reshape(1, -1, 1)
        got = decode_image(F.png_bytes(px, 0, depth))[0, :, 0]
        assert got.tolist() == [v * scale for v in range(1 << depth)]
    keyed = F.png_bytes([[[0x1234, 0xABCD, 0x00FF], [0x1200, 0xAB00, 0]]],
                        2, 16, trns=struct.pack(">HHH", 18, 171, 0))
    assert decode_image(keyed)[0, :, 3].tolist() == [0, 0]
    for data in (grey, keyed):
        _same(data)


def test_png_adam7_small_images_have_empty_passes():
    """Images narrower or shorter than 8 pixels leave passes without
    columns or rows, which carry no bytes at all."""
    for h, w in ((1, 1), (5, 3), (2, 7), (9, 1)):
        px = np.arange(h * w * 3).reshape(h, w, 3) % 256
        _same(F.png_bytes(px, 2, 8, interlace=True, filters=(4,)))


def _pillow_jpeg(img, mode="RGB", **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, "RGB").convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [50, 95])
def test_jpeg_subsampling_quality_and_odd_sizes(subsampling, quality):
    """4:4:4, 4:2:2 and 4:2:0, baseline and progressive, at 53x37, 1x1
    and 9x17."""
    for h, w in ((53, 37), (1, 1), (9, 17)):
        img = F.texture(h, w, seed=h + quality)
        for progressive in (False, True):
            _same(_pillow_jpeg(img, quality=quality, subsampling=subsampling,
                               progressive=progressive))


def test_jpeg_411_grey_restart_and_rgb():
    """4:1:1 (this repository's encoder: Pillow writes none), grey
    baseline and progressive, restart markers in sequential and
    progressive files, an RGB file by Adobe transform 0 and by component
    ids R, G, B."""
    img = F.texture(53, 37, seed=5)
    ycc = F.rgb_to_ycc(img).astype(np.uint8)
    planes = [ycc[..., k] for k in range(3)]
    lum = np.full(64, 6)
    cases = [F.jpeg_baseline(planes, [(4, 1), (1, 1), (1, 1)], lum),
             F.jpeg_baseline([img[..., k] for k in range(3)],
                             [(1, 1)] * 3, lum, ids=[82, 71, 66]),
             _pillow_jpeg(img, "L", quality=75),
             _pillow_jpeg(img, "L", quality=75, progressive=True),
             _pillow_jpeg(img, quality=80, subsampling=2,
                          restart_marker_blocks=3),
             _pillow_jpeg(img, quality=80, subsampling=1, progressive=True,
                          restart_marker_rows=1),
             _pillow_jpeg(img, quality=80, keep_rgb=True)]
    for data in cases:
        _same(data)


def _refusal(data, what):
    """Pillow raises on ``data``, and the port refuses it, saying so."""
    with pytest.raises(Exception):
        pillow_decode(data)
    with pytest.raises(ImageFormatError, match=what) as err:
        decode_image(data)
    assert "Pillow refuses it too" in str(err.value)


def test_jpeg_refusals():
    """What the decoder still refuses, each refused by Pillow too (every
    one in ``test_torch_jpeg_variants.py``): hierarchical and lossless
    arithmetic-coded frames, 12-bit samples, fractional sampling. What it
    refused before the variants landed now decodes as Pillow does: CMYK,
    4:4:0, and a progressive file cut before its refinement scans, which
    libjpeg block-smooths. Corrupt data and other formats raise."""
    img = F.texture(24, 16, seed=9)
    base = _pillow_jpeg(img, quality=80)
    sof = base.index(b"\xff\xc0")
    for marker, what in ((0xC5, "hierarchical"), (0xCB, "lossless arith")):
        data = bytearray(base)
        data[sof + 1] = marker
        _refusal(bytes(data), what)
    data = bytearray(base)
    data[sof + 4] = 12
    _refusal(bytes(data), "12-bit")
    ycc = F.rgb_to_ycc(img).astype(np.uint8)
    _refusal(F.jpeg_baseline([ycc[..., k] for k in range(3)],
                             [(3, 1), (2, 1), (1, 1)], np.full(64, 8)),
             "fractional")
    buf = io.BytesIO()
    Image.fromarray(img, "RGB").convert("CMYK").save(buf, "JPEG")
    _same(buf.getvalue())
    _same(F.jpeg_baseline([ycc[..., k] for k in range(3)],
                          [(1, 2), (1, 1), (1, 1)], np.full(64, 8)))
    prog = _pillow_jpeg(img, quality=80, progressive=True)
    scans = [i for i in range(len(prog) - 1) if prog[i:i + 2] == b"\xff\xda"]
    _same(prog[:scans[3]] + b"\xff\xd9")
    # a corrupted SOF: a length that disagrees with its component count
    data = bytearray(base)
    data[sof + 9] = 5
    with pytest.raises(ImageFormatError, match="corrupt JPEG"):
        decode_image(bytes(data))
    with pytest.raises(ImageFormatError, match="neither PNG nor JPEG"):
        decode_image(b"GIF89a" + bytes(20))


def test_entropy_decoder_is_built_from_the_repository():
    """The C library comes from ``hostsrc/`` into the git-ignored
    ``_build/``, named by its sources' hash."""
    from metal_pathtracer_tpu_torch.utils import nativebuild

    path = nativebuild.build_host_library()
    assert os.path.dirname(path) == nativebuild.HOST_BUILD_DIR
    assert os.path.basename(path).startswith("libmpt_host_")
    assert nativebuild.host_library()._name == path


def test_fixtures_match_pillow_digests():
    """Each committed fixture: Pillow's RGBA is still the recorded digest,
    and the port's decoder gives the same bytes."""
    with open(F.DIGESTS) as fh:
        record = json.load(fh)
    names = sorted(n for n in os.listdir(IMAGES)
                   if n.endswith((".png", ".jpg")))
    assert names == sorted(record)
    total = 0
    for name in names:
        with open(os.path.join(IMAGES, name), "rb") as fh:
            data = fh.read()
        total += len(data)
        for rgba in (F.pillow_rgba(data), decode_image(data)):
            assert F.digest(rgba) == record[name], name
    assert total < 1 << 20


# ---- a GLB with JPEG textures, rendered against the JAX package ------------

@pytest.fixture
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_jpeg_textured_glb_render_matches_jax(tmp_path, _one_thread):
    """``test_torch_gltf_render.py``'s scene with its base colour a 4:2:0
    JPEG and its ground a progressive grey JPEG: 40x24, 2 spp, d4, the
    ladder's tight gate."""
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
    rng = np.random.default_rng(23)
    images[0] = _pillow_jpeg(rng.integers(40, 256, (40, 48, 3),
                                          dtype=np.uint8),
                             quality=90, subsampling=2)
    images[3] = _pillow_jpeg(rng.integers(60, 200, (16, 16, 3),
                                          dtype=np.uint8), "L",
                             quality=90, progressive=True)
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
    assert [im.shape[:2] for im in pr.texture_images] == \
        [(40, 48), (16, 16), (32, 32), (16, 16)]
    r = render_pair((ps, pr), (js, jr), G.W, G.H, G.DEPTH, G._environment,
                    G._toy_env())
    assert_gate(r, 2e-4, 0.98)
