"""The port's ``Renderer`` facade, display path and change detector
against the JAX package's, on the CPU (``device="cpu"``: every kernel's
plain version).

- ``tests/test_renderer_facade.py``'s six tests on ``Renderer(24, 24,
  device="cpu")`` over the procedural scene (maxDepth 3, seed 11); its
  seventh, the JAX backend's fallback to the CPU, is inverted: the port's
  ``Renderer()`` raises without a card and never falls back;
- ``detect_radiometric_change`` field by field against the JAX package's;
- the facade's render of the procedural scene against the JAX facade's
  under the ladder's gate (RMSE < 2e-4, > 98 % of pixels within 1e-5,
  equal ray counts) at maxDepth 2, 2 spp: at maxDepth 3 one pixel of
  576 takes another path (0.027 off; the curved-surface drift of ROADMAP
  Queue 3, "Understood": a sphere normal rebuilt from a hit point an ulp
  away), which the tight gate cannot hold;
- ``display()`` against the JAX ``display_image`` on the same state,
  carried across as a JAX checkpoint: without and with bloom, denoised
  at both filter types, and from a checkpoint without ``radiance_sq_sum``
  (the fixed-sigma filter in both packages); the LDR bytes equal on
  99.9 % of the values and at most 1 apart elsewhere;
- that checkpoint: ``None`` in the port, and one more frame gives the
  JAX package's moments (``frame.py:143-144``: the second moment starts
  from zeros);
- two scene loads with different ``environmentMapPath``: the second
  scene renders under the first one's map in both facades (no JAX
  render: the JAX facade's scene arrays are compared);
- import hygiene: the facade, the display path, the denoiser and the
  viewer load no ``jax`` or ``metal_pathtracer_tpu`` module, and every
  entry point of the port that takes a device defaults to the card.

Two JAX renders (the gate pair, and the frame after the old checkpoint),
a few JAX display passes.
"""

import enum
import importlib
import inspect
import os
import pkgutil
import subprocess
import sys
import textwrap
from unittest import mock

import numpy as np
import pytest
import torch

from metal_pathtracer_tpu import settings as jax_settings
from metal_pathtracer_tpu.ops import denoise as JD
from metal_pathtracer_tpu.renderer.accumulation import RenderState as JState
from metal_pathtracer_tpu.renderer.display import display_image as j_display
from metal_pathtracer_tpu.renderer.renderer import Renderer as JRenderer
import metal_pathtracer_tpu_torch
from metal_pathtracer_tpu_torch import settings as port_settings
from metal_pathtracer_tpu_torch.ops import denoise as D
from metal_pathtracer_tpu_torch.renderer import display
from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
from metal_pathtracer_tpu_torch.renderer.renderer import Renderer
from metal_pathtracer_tpu_torch.settings import RenderSettings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE_DEPTH = 2


def _setup(r, depth=3):
    r.set_default_scene()
    r.settings.maxDepth = depth
    r.settings.fixedRngSeed = 11
    r.settings.samplesPerFrame = 1
    r._applied_settings = r.settings.copy()
    return r


# ---- tests/test_renderer_facade.py on the port -----------------------------

@pytest.fixture(scope="module")
def renderer():
    r = _setup(Renderer(width=24, height=24, device="cpu"))
    r.draw_frame()
    return r


def test_progressive_accumulation(renderer):
    before = renderer.sample_count()
    renderer.draw_frame()
    assert renderer.sample_count() == before + 1


def test_capture_average_image(renderer):
    img = renderer.capture_average_image()
    assert img.shape == (24, 24, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0.0


def test_apply_settings_resets_on_radiometric_change(renderer):
    renderer.draw_frame()
    assert renderer.sample_count() > 0
    s = renderer.settings.copy()
    s.cameraYaw += 0.1
    reason = renderer.apply_settings(s)
    assert reason == "CAMERA"
    assert renderer.sample_count() == 0
    # non-radiometric change: no reset
    renderer.draw_frame()
    s2 = renderer.settings.copy()
    s2.samplesPerFrame = 4
    assert renderer.apply_settings(s2) is None
    assert renderer.sample_count() == 1


def test_resize_policy():
    r = Renderer(width=100, height=100, device="cpu")
    r.set_default_scene()
    r.settings.renderScale = 2.0
    r.resize(6000, 6000)  # 2x scale -> 12000 clamps to 8192; 67MP halves down
    w, h = r.render_size
    assert w * h <= 16 * 1024 * 1024
    assert max(w, h) <= 8192


def test_export_and_checkpoint(tmp_path, renderer):
    renderer.draw_frame()
    ppm = tmp_path / "out.ppm"
    renderer.export_to_ppm(str(ppm))
    assert ppm.stat().st_size > 0

    exr = tmp_path / "out.exr"
    renderer.save_exr(str(exr))
    from metal_pathtracer_tpu_torch.utils import image_io
    ch = image_io.read_exr(str(exr))
    assert "SAMPLES" in ch
    assert ch["SAMPLES"].max() == renderer.sample_count()

    ckpt = tmp_path / "state.npz"
    count = renderer.sample_count()
    renderer.save_checkpoint(str(ckpt))
    r2 = Renderer(device="cpu")
    r2.load_checkpoint(str(ckpt))
    assert r2.state.frame_index == count
    np.testing.assert_array_equal(r2.state.radiance_sum.numpy(),
                                  renderer.state.radiance_sum.numpy())


def test_display_and_denoise(renderer):
    renderer.settings.bloomEnabled = True
    ldr = renderer.display()
    assert ldr.shape == (24, 24, 3)
    assert 0.0 <= ldr.min() and ldr.max() <= 1.0
    renderer.settings.bloomEnabled = False

    den = D.denoise_state(renderer.state, renderer.settings).numpy()
    assert den.shape == (24, 24, 3)
    assert np.isfinite(den).all()
    noisy = renderer.state.present().numpy()

    # a smoothing filter reduces local variance
    def local_var(img):
        return np.var(np.diff(img, axis=0)) + np.var(np.diff(img, axis=1))
    assert local_var(den) <= local_var(noisy) * 1.05


def test_renderer_raises_without_a_card(monkeypatch):
    """The inverse of the JAX package's CPU fallback: with no CUDA device
    ``Renderer()`` raises, and only ``device="cpu"`` renders on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Renderer(24, 24)
    assert Renderer(24, 24, device="cpu").device.type == "cpu"


# ---- the change detector ---------------------------------------------------

def _changed(value):
    if isinstance(value, enum.IntEnum):
        return type(value)((int(value) + 1) % len(type(value)))
    if isinstance(value, bool):
        return not value
    if isinstance(value, (int, float)):
        return value + 1
    if isinstance(value, tuple):
        return tuple(v + 0.5 for v in value)
    return value + "x"


def test_radiometric_fields_are_the_jax_packages():
    assert list(port_settings._RADIOMETRIC_FIELDS.items()) \
        == list(jax_settings._RADIOMETRIC_FIELDS.items())


@pytest.mark.parametrize("field", [None] + list(
    jax_settings._RADIOMETRIC_FIELDS) + ["exposure", "denoiseEnabled"])
def test_detect_radiometric_change_matches_jax(field):
    """Each radiometric field changed alone gives both packages' reason;
    an unchanged copy and display-only edits reset nothing."""
    out = []
    for mod in (jax_settings, port_settings):
        a = mod.RenderSettings()
        b = a.copy()
        if field is not None:
            setattr(b, field, _changed(getattr(a, field)))
        out.append(mod.detect_radiometric_change(a, b))
    assert out[1] == out[0]
    expect = jax_settings._RADIOMETRIC_FIELDS.get(field)
    assert out[1] == ((True, expect) if expect else (False, ""))


# ---- against the JAX facade ------------------------------------------------

@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The JAX facade's and the port's renders of the procedural scene at
    24x24, GATE_DEPTH, 2 spp, and the JAX state as a checkpoint (and as
    one written before the second moment existed: no radiance_sq_sum)."""
    tmp = tmp_path_factory.mktemp("facade")
    j = _setup(JRenderer(24, 24), GATE_DEPTH)
    p = _setup(Renderer(24, 24, device="cpu"), GATE_DEPTH)
    j.draw_frame(2)
    p.draw_frame(2)
    path = str(tmp / "jax.npz")
    j.save_checkpoint(path)
    old = str(tmp / "jax_pre_sq_sum.npz")
    data = dict(np.load(path))
    del data["radiance_sq_sum"]
    with open(old, "wb") as fh:
        np.savez(fh, **data)
    return dict(j=j, p=p, path=path, old=old)


def test_facade_render_matches_jax(pair):
    j, p = pair["j"], pair["p"]
    img, ref = p.capture_average_image(), j.capture_average_image()
    assert p.sample_count() == j.sample_count() == 2
    assert p.state.ray_count == float(np.asarray(j.state.ray_count))
    d = np.abs(img - ref)
    rmse = float(np.sqrt((d * d).mean()))
    assert rmse < 2e-4, rmse
    assert float((d.max(-1) < 1e-5).mean()) > 0.98
    assert img.max() > 0.0


DISPLAYS = {
    "plain": dict(),
    "bloom": dict(bloomEnabled=True),
    "denoise_rt": dict(denoiseEnabled=True, denoiseFilterType=0),
    "denoise_lightmap": dict(denoiseEnabled=True, denoiseFilterType=1,
                             exposure=0.5, tonemapMode=2),
    "pre_sq_sum": dict(denoiseEnabled=True),
}


def _u8(ldr):
    return np.clip(np.floor(np.asarray(ldr, np.float32) * 255.0 + 0.5), 0,
                   255).astype(np.uint8)


@pytest.mark.parametrize("case", sorted(DISPLAYS))
def test_display_matches_jax(pair, case):
    path = pair["old"] if case == "pre_sq_sum" else pair["path"]
    js = JState.load(path)
    ps = RenderState.load(path, device="cpu")
    assert (ps.radiance_sq_sum is None) == (case == "pre_sq_sum")
    jset, pset = jax_settings.RenderSettings(), RenderSettings()
    for k, v in DISPLAYS[case].items():
        setattr(jset, k, v)
        setattr(pset, k, v)
    calls = []
    with mock.patch.object(D, "atrous_denoise",
                           side_effect=lambda *a, _f=D.atrous_denoise, **k:
                           (calls.append("port"), _f(*a, **k))[1]), \
            mock.patch.object(JD, "atrous_denoise",
                              side_effect=lambda *a, _f=JD.atrous_denoise,
                              **k: (calls.append("jax"), _f(*a, **k))[1]):
        ref = _u8(j_display(js, jset))
        got = display.display_to_u8(ps, pset)
    # the fixed-sigma filter for the old checkpoint, in both packages
    assert calls == (["jax", "port"] if case == "pre_sq_sum" else [])
    assert got.shape == ref.shape == (24, 24, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1, case
    assert (diff == 0).mean() >= 0.999, case
    if DISPLAYS[case].get("denoiseEnabled"):
        plain = display.display_to_u8(ps, RenderSettings())
        assert (got != plain).any()   # the denoiser ran


def test_pre_sq_sum_checkpoint_resumes_like_jax(pair):
    """A JAX checkpoint without ``radiance_sq_sum`` loads in the port as
    None; one more frame starts the second moment from zeros, as JAX
    ``frame.py:143-144`` does: the port's moments bit-equal to the same
    frame from a zero second moment, and within the ladder's gate of the
    JAX facade's."""
    j = _setup(JRenderer(24, 24), GATE_DEPTH)
    p = _setup(Renderer(24, 24, device="cpu"), GATE_DEPTH)
    j.load_checkpoint(pair["old"])
    p.load_checkpoint(pair["old"])
    assert j.state.radiance_sq_sum is None and p.state.radiance_sq_sum is None
    assert not p.state.variance_of_mean().any()
    zero = p.state.replace(
        radiance_sq_sum=torch.zeros_like(p.state.radiance_sum))
    j.draw_frame(1)
    p.draw_frame(1)
    q = _setup(Renderer(24, 24, device="cpu"), GATE_DEPTH)
    q._state = zero
    q.draw_frame(1)
    for k in ("radiance_sum", "radiance_sq_sum"):
        np.testing.assert_array_equal(getattr(p.state, k).numpy(),
                                      getattr(q.state, k).numpy(), err_msg=k)
    assert p.sample_count() == j.sample_count() == 3
    for k in ("radiance_sum", "radiance_sq_sum"):
        got = getattr(p.state, k).numpy()
        ref = np.asarray(getattr(j.state, k))
        d = np.abs(got - ref) / (1.0 + np.abs(ref))
        assert float(np.sqrt((d * d).mean())) < 2e-4, k
        assert float((d.max(-1) < 1e-5).mean()) > 0.98, k
    assert p.state.radiance_sq_sum.max() > 0


# ---- import hygiene and device defaults ------------------------------------

def test_interactive_path_loads_no_jax():
    """The facade, the display path, the denoiser (every tier) and the
    viewer import and run on the CPU without loading jax or any module of
    the JAX package."""
    code = textwrap.dedent("""
        import sys
        import torch
        torch.set_num_threads(1)
        from metal_pathtracer_tpu_torch.ops import denoise, denoise_unet
        from metal_pathtracer_tpu_torch.renderer.renderer import Renderer
        from metal_pathtracer_tpu_torch.viewer.server import ViewerServer
        r = Renderer(16, 16, device="cpu")
        r.load_scene_from_path("tests/scenes/smoke.scene")
        r.settings.maxDepth = 2
        r.draw_frame(2)
        r.settings.denoiseEnabled = True
        w, h = r.render_size
        assert r.display().shape == (h, w, 3)
        srv = ViewerServer(r, port=0).start()
        assert srv.stats()["error"] == ""
        srv.stop()
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                      "metal_pathtracer_tpu")]
        assert not bad, bad
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


def test_entry_points_default_to_the_card():
    """Every function or method of the port with a ``device`` parameter
    defaults it to "cuda" (or takes it from its caller: no default, or
    None for "the backend's own"); nothing defaults to the CPU."""
    found = []
    for info in pkgutil.walk_packages(metal_pathtracer_tpu_torch.__path__,
                                      "metal_pathtracer_tpu_torch."):
        if info.name.endswith("__main__"):
            continue
        mod = importlib.import_module(info.name)
        for obj in vars(mod).values():
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            fns = [obj] if inspect.isfunction(obj) else [
                getattr(v, "__func__", v) for v in vars(obj).values()
            ] if inspect.isclass(obj) else []
            for fn in fns:
                if not inspect.isfunction(fn):
                    continue
                p = inspect.signature(fn).parameters.get("device")
                if p is not None:
                    found.append((fn.__qualname__, p.default))
    names = dict(found)
    for name in ("Renderer.__init__", "RenderState.create",
                 "RenderState.load", "build_camera", "load_environment",
                 "SceneResources.build_arrays", "denoiser_params"):
        assert names.get(name) == "cuda", (name, names.get(name))
    bad = [(n, d) for n, d in found
           if d not in ("cuda", None, inspect.Parameter.empty)]
    assert not bad, bad


# ---- two scene loads: the environment stays ---------------------------------

def _two_skies(tmp):
    """Two ``.scene`` files, a lambert sphere under each one's own PFM sky
    (a blue one and a red one); returns their paths and the skies."""
    from metal_pathtracer_tpu_torch.utils import image_io

    paths, skies = [], []
    for k, tint in enumerate(((0.3, 0.5, 1.0), (1.0, 0.3, 0.2))):
        sky = np.full((8, 16, 3), tint, np.float32)
        sky[1:3, 3 + 5 * k:5 + 5 * k] = 30.0
        image_io.write_pfm(os.path.join(tmp, f"sky{k}.pfm"), sky)
        path = os.path.join(tmp, f"scene{k}.scene")
        with open(path, "w") as fh:
            fh.write("camera target=0,0,0 distance=3 yaw=0.2 pitch=0.1 "
                     "vfov=40\nrenderer maxDepth=2 seed=5\n"
                     f"background env=./sky{k}.pfm\n"
                     "material type=lambert albedo=0.6,0.6,0.6 name=m\n"
                     f"sphere center=0,{0.2 * k},0 radius=0.7 material=0\n")
        paths.append(path)
        skies.append(sky)
    return paths, skies


def test_scene_load_keeps_the_environment(tmp_path):
    """A scene loaded after another renders under the first scene's map,
    as the JAX facade does (``renderer.py _adopt:87-96`` keeps the cached
    environment; only ``apply_settings`` drops it): after loading two
    files with different ``environmentMapPath``, both facades' scene
    arrays hold the first sky's texels, bit for bit, and the port's frame
    is the one a fresh facade renders from the second file with the first
    sky's path."""
    paths, skies = _two_skies(str(tmp_path))
    j, p = JRenderer(16, 12), Renderer(16, 12, device="cpu")
    for r in (j, p):
        r.load_scene_from_path(paths[0])
        r._ensure_scene()
        r.load_scene_from_path(paths[1])
        r._ensure_scene()
        assert r.settings.environmentMapPath.endswith("sky1.pfm")
    first = np.asarray(j._scene_arrays.environment.texels)
    np.testing.assert_array_equal(first, skies[0])
    np.testing.assert_array_equal(
        p._scene_arrays.environment.texels.numpy(), first)
    p.draw_frame(1)
    fresh = Renderer(16, 12, device="cpu")
    fresh.load_scene_from_path(paths[1])
    fresh.settings.environmentMapPath = \
        paths[0].replace("scene0.scene", "sky0.pfm")
    fresh.draw_frame(1)
    np.testing.assert_array_equal(p.capture_average_image(),
                                  fresh.capture_average_image())
    # a settings change of the path drops it in both packages
    for r in (j, p):
        s = r.settings.copy()
        s.environmentMapPath = paths[0].replace("scene0.scene", "sky0.pfm")
        r.apply_settings(s)
        s = r.settings.copy()
        s.environmentMapPath = paths[1].replace("scene1.scene", "sky1.pfm")
        r.apply_settings(s)
        r._ensure_scene()
    np.testing.assert_array_equal(
        np.asarray(j._scene_arrays.environment.texels), skies[1])
    np.testing.assert_array_equal(
        p._scene_arrays.environment.texels.numpy(), skies[1])
