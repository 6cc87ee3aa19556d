"""PNG and JPEG environment maps (``ops/env.py load_hdr_image``) against
the JAX package's ``load_hdr_image``, which reads them through imageio:

- which kinds the port decodes itself (``image_io.imageio_channels``):
  those whose imageio array (imageio 2.37.4 over Pillow 12.1.0, as
  installed here) is the first channels of ``decode_image``'s RGBA, held
  against ``imageio.v3.imread`` over every PNG colour type and depth, with
  and without tRNS, and every JPEG kind;
- every kind, bright (the JAX rule linearises when any channel imageio
  returns, alpha included, exceeds 64) and dim, bit for bit against the
  JAX array;
- the same with imageio hidden: the covered kinds unchanged, the others a
  ``ValueError`` that names the kind and imageio;
- the committed sky fixtures against the JAX arrays recorded in
  ``tests/images/imageio_env.json`` (what ``chip_smoke.py`` checks on the
  card's host, which has no imageio);
- a 40x24, 2 spp render under the 8-bit PNG sky against the JAX render at
  the ladder's tight gate (one JAX render); ~15 s.
"""

import hashlib
import importlib.util
import io
import json
import os
import sys

import imageio.v3 as iio
import numpy as np
import pytest
from PIL import Image

from metal_pathtracer_tpu.ops import env as jax_env
from metal_pathtracer_tpu_torch.ops import env as env_ops
from metal_pathtracer_tpu_torch.utils.image_io import (
    decode_image,
    imageio_channels,
)

IMAGES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "images")
_spec = importlib.util.spec_from_file_location(
    "make_fixtures", os.path.join(IMAGES, "make_fixtures.py"))
F = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(F)

DEPTHS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
          (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


def _jpeg(img, mode="RGB", **kw) -> bytes:
    buf = io.BytesIO()
    src = Image.fromarray(img, "CMYK") if mode == "CMYK" \
        else Image.fromarray(img, "RGB").convert(mode)
    src.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _kinds() -> dict:
    """name -> (bytes, file suffix) of every sky kind, bright and dim."""
    rng = np.random.default_rng(31)
    out = {}
    for ctype, depth in DEPTHS:
        ch = F.CHANNELS[ctype]
        top = (1 << depth) - 1
        for tone, hi in (("bright", top), ("dim", min(top, 50))):
            px = rng.integers(0, hi + 1, (6, 10, ch))
            if ctype in (4, 6):   # alpha at most 64 in the dim images
                px[..., -1] = np.minimum(px[..., -1], 64 if depth == 8
                                         else 64 << 8)
            if depth == 16 and tone == "dim":
                px = px % 50 << 8   # the high byte decides
            kw = {}
            if ctype == 3:
                kw["plte"] = rng.integers(0, hi + 1 if hi < 256 else 256,
                                          (1 << depth, 3))
            name = f"png{ctype}-{depth}-{tone}"
            out[name] = (F.png_bytes(px, ctype, depth, **kw), ".png")
            if ctype == 3:
                out[name + "-trns"] = (F.png_bytes(
                    px, ctype, depth, trns=bytes([0, 40, 255]), **kw),
                    ".png")
            if ctype == 2:
                key = b"".join(int(v).to_bytes(2, "big") for v in px[0, 0])
                out[name + "-key"] = (F.png_bytes(px, ctype, depth,
                                                  trns=key), ".png")
    img = F.sky(16, 24, seed=5)
    cmyk = F.cmyk_texture(16, 24, seed=6)
    out.update({
        "jpeg-ycc": (_jpeg(img, quality=90), ".jpg"),
        "jpeg-ycc-dim": (_jpeg(img // 5, quality=90), ".jpeg"),
        "jpeg-rgb": (_jpeg(img, quality=90, keep_rgb=True), ".jpg"),
        "jpeg-progressive-420": (_jpeg(img, progressive=True, subsampling=2),
                                 ".jpg"),
        "jpeg-grey": (_jpeg(img, "L"), ".jpg"),
        "jpeg-cmyk": (_jpeg(cmyk, "CMYK"), ".jpg"),
        "jpeg-lossless": (F.jpeg_lossless([img[..., k] for k in range(3)],
                                          predictor=5), ".jpg"),
    })
    for name in ("arith_prog_37x53.jpg", "ycck_422_37x53.jpg",
                 "sampled_440_37x53.jpg"):
        with open(os.path.join(IMAGES, name), "rb") as fh:
            out["fixture-" + name] = (fh.read(), ".jpg")
    return out


KINDS = _kinds()


def _write(tmp_path, name: str) -> str:
    data, suffix = KINDS[name]
    path = tmp_path / f"sky{suffix}"
    path.write_bytes(data)
    return str(path)


def _bits(img: np.ndarray) -> tuple:
    return img.dtype, img.shape, np.ascontiguousarray(img).tobytes()


def test_covered_kinds_are_imageios_arrays():
    """The kinds the port decodes itself are exactly those whose imageio
    array is ``decode_image``'s first channels as uint8: RGB and RGBA at
    8 and 16 bits, palette with or without tRNS (imageio gives RGB), 16-bit
    grey + alpha, three-component JPEG. Grey PNG, 8-bit grey + alpha, grey
    and CMYK/YCCK JPEG are not."""
    covered = []
    for name, (data, suffix) in sorted(KINDS.items()):
        arr = iio.imread(data, extension=suffix)
        channels, kind = imageio_channels(data)
        assert kind
        rgba = decode_image(data)
        same = arr.dtype == np.uint8 and arr.ndim == 3 \
            and arr.shape[-1] in (3, 4) \
            and np.array_equal(arr, rgba[..., :arr.shape[-1]])
        assert same == (channels is not None), name
        if same:
            assert arr.shape[-1] == channels, name
            covered.append(name.split("-")[0])
    assert set(covered) == {"png2", "png3", "png4", "png6", "jpeg",
                            "fixture"}


@pytest.mark.parametrize("name", sorted(KINDS))
def test_sky_matches_jax(name, tmp_path):
    path = _write(tmp_path, name)
    assert _bits(env_ops.load_hdr_image(path)) == \
        _bits(jax_env.load_hdr_image(path))


@pytest.mark.parametrize("name", sorted(KINDS))
def test_sky_without_imageio(name, tmp_path, monkeypatch):
    """imageio hidden: the covered kinds give the JAX array still; the
    others raise, naming the kind and imageio."""
    path = _write(tmp_path, name)
    want = _bits(jax_env.load_hdr_image(path))
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    channels, kind = imageio_channels(KINDS[name][0])
    if channels is None:
        with pytest.raises(ValueError, match="imageio") as err:
            env_ops.load_hdr_image(path)
        assert kind in str(err.value)
    else:
        assert _bits(env_ops.load_hdr_image(path)) == want


def test_sky_fixtures_match_the_record(monkeypatch):
    """The committed skies: the JAX array is still the recorded one, and
    the port gives it without imageio."""
    with open(F.ENV_DIGESTS) as fh:
        record = json.load(fh)
    assert sorted(record) == sorted(F.SKIES)
    for name in F.SKIES:
        assert F.imageio_env(os.path.join(IMAGES, name)) == record[name]
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    for name, want in record.items():
        img = env_ops.load_hdr_image(os.path.join(IMAGES, name))
        assert {"sha256": hashlib.sha256(img.tobytes()).hexdigest(),
                "shape": list(img.shape), "dtype": str(img.dtype)} == want


def test_png_sky_render_matches_jax(tmp_path):
    """Two lambert spheres under the 8-bit PNG sky: 40x24, 2 spp, d3,
    the ladder's tight gate."""
    from metal_pathtracer_tpu.scene import dsl as jax_dsl
    from metal_pathtracer_tpu.scene.resources import (
        SceneResources as JResources,
    )
    from metal_pathtracer_tpu.settings import RenderSettings as JSettings
    from metal_pathtracer_tpu_torch.scene import dsl
    from metal_pathtracer_tpu_torch.scene.resources import SceneResources
    from metal_pathtracer_tpu_torch.settings import RenderSettings
    from test_torch_prims_render import assert_gate, render_pair

    with open(os.path.join(IMAGES, "sky_rgb8_48x24.png"), "rb") as fh:
        (tmp_path / "sky.png").write_bytes(fh.read())
    path = tmp_path / "sky.scene"
    path.write_text(
        "camera target=0,0,0 distance=4 yaw=0.3 pitch=0.15 vfov=45\n"
        "renderer maxDepth=3 seed=11\n"
        "material type=lambert albedo=0.7,0.6,0.5 name=clay\n"
        "material type=lambert albedo=0.3,0.5,0.6 name=slate\n"
        "sphere center=-0.6,0,0 radius=0.7 material=0\n"
        "sphere center=0.9,-0.2,0.3 radius=0.5 material=1\n"
        "background env=./sky.png\n")
    ps, pr, js, jr = RenderSettings(), SceneResources(), JSettings(), \
        JResources()
    dsl.load_scene_file(str(path), ps, pr)
    jax_dsl.load_scene_file(str(path), js, jr)
    envs = (env_ops.load_environment(ps.environmentMapPath, "cpu"),
            jax_env.load_environment(js.environmentMapPath))
    r = render_pair((ps, pr), (js, jr), 40, 24, 3, envs=envs)
    assert_gate(r, 2e-4, 0.98)
