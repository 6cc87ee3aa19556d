"""The port's live viewer: ``tests/test_viewer.py``'s twelve tests against
the port's ``ViewerServer`` over ``Renderer(32, 24, device="cpu")`` on the
procedural scene (the plain versions render a 32x24 maxDepth-3 pass in
~0.6-1 s here), plus: ``/set?denoiseEnabled=1`` changes ``/frame.png``
to the denoised display, and a pass that raises leaves its traceback in
``last_error`` (and ``/stats``) while the loop goes on."""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from metal_pathtracer_tpu_torch.renderer.display import display_to_u8
from metal_pathtracer_tpu_torch.renderer.renderer import Renderer
from metal_pathtracer_tpu_torch.utils.image_io import decode_png
from metal_pathtracer_tpu_torch.viewer.server import ViewerServer


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def viewer(_one_thread):
    r = Renderer(32, 24, device="cpu")
    r.set_default_scene()
    s = r.settings.copy()
    s.maxDepth = 3
    r.apply_settings(s)
    server = ViewerServer(r, port=0).start()
    yield server
    server.stop()


def _get(server, path):
    # mutating endpoints are POST-only (CSRF hardening); reads stay GET
    method = "POST" if path.startswith(("/set", "/material?", "/object?")) \
        else "GET"
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}{path}", method=method)
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.read()


def _wait_spp(server, minimum, timeout=120.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        stats = json.loads(_get(server, "/stats"))
        if stats["spp"] >= minimum:
            return stats
        time.sleep(0.2)
    raise AssertionError(f"spp never reached {minimum}")


def test_progressive_loop_and_png(viewer):
    stats = _wait_spp(viewer, 2)
    assert stats["width"] == 32 and stats["height"] == 24
    png = _get(viewer, "/frame.png")
    assert png.startswith(b"\x89PNG\r\n\x1a\n")
    assert len(png) > 100


def test_index_page(viewer):
    page = _get(viewer, "/")
    assert b"metal-pathtracer-tpu" in page
    assert b"/frame.png" in page


def test_radiometric_edit_resets_accumulation(viewer):
    _wait_spp(viewer, 3)
    # pause so the restart is observable (the loop would re-accumulate
    # past the old count between two polls otherwise), then edit the
    # camera — radiometric, but StaticConfig-stable so no recompile stall
    json.loads(_get(viewer, "/set?paused=1"))
    pre = viewer.renderer.sample_count()
    assert pre >= 3
    out = json.loads(_get(viewer, "/set?cameraYaw=0.9"))
    assert out["ok"] and out["reset"] == "CAMERA"
    assert json.loads(_get(viewer, "/stats"))["reset"]
    assert viewer.renderer.sample_count() == 0  # accumulation restarted
    json.loads(_get(viewer, "/set?paused=0"))
    _wait_spp(viewer, 1)


def test_non_radiometric_edit_keeps_accumulation(viewer):
    before = _wait_spp(viewer, 2)["spp"]
    out = json.loads(_get(viewer, "/set?exposure=1.0"))
    assert out["ok"] and not out["reset"]  # exposure is display-only
    after = json.loads(_get(viewer, "/stats"))["spp"]
    assert after >= before


def test_orbit_and_pause(viewer):
    yaw0 = viewer.renderer.settings.cameraYaw
    out = json.loads(_get(viewer, "/set?orbit=0.1,0.05"))
    # orbit moves the TARGET camera; the render loop eases toward it
    # (reference: MetalRenderer.mm updateCameraSmoothing)
    assert out["motion"]
    assert viewer._cam_target[0] == pytest.approx(yaw0 + 0.1)
    t0 = time.time()
    while viewer.renderer.settings.cameraYaw == yaw0:
        assert time.time() - t0 < 120, "smoothed camera never advanced"
        time.sleep(0.1)
    json.loads(_get(viewer, "/set?paused=1"))
    assert json.loads(_get(viewer, "/stats"))["paused"]
    json.loads(_get(viewer, "/set?paused=0"))


def test_motion_preview_policy(viewer):
    """During camera motion the loop renders 1-spp passes at preview
    scale (reference: MetalRenderer.mm:906-956 drops samplesPerFrame to
    1 under motion; the TPU analogue also halves resolution); once the
    0.25 s hold expires and smoothing converges, full resolution and
    progressive accumulation resume with reset reason CAMERA."""
    # earlier tests may leave a preview still easing toward its target;
    # wait for the full-res steady state before capturing the baseline
    t0 = time.time()
    while True:
        stats = json.loads(_get(viewer, "/stats"))
        if not stats["preview"] and stats["spp"] >= 1:
            break
        assert time.time() - t0 < 180, "viewer never left preview mode"
        time.sleep(0.1)
    full_w = stats["width"]
    yaw0 = viewer.renderer.settings.cameraYaw
    saw_preview = False
    t0 = time.time()
    while time.time() - t0 < 120:
        _get(viewer, "/set?orbit=0.02,0.0")  # keep the hold window alive
        stats = json.loads(_get(viewer, "/stats"))
        if stats["preview"] and stats["width"] < full_w:
            saw_preview = True
            break
        time.sleep(0.05)
    assert saw_preview, "no preview-scale pass during sustained motion"
    # stop interacting: the viewer must land on the target at full res
    t0 = time.time()
    while time.time() - t0 < 180:
        stats = json.loads(_get(viewer, "/stats"))
        if (not stats["preview"] and stats["width"] == full_w
                and stats["spp"] >= 1 and stats["reset"] == "CAMERA"):
            break
        time.sleep(0.1)
    else:
        raise AssertionError("never returned to full-res accumulation")
    assert viewer.renderer.settings.cameraYaw != yaw0
    assert viewer.renderer.settings.cameraYaw == pytest.approx(
        viewer._cam_target[0])


def test_unknown_setting_rejected(viewer):
    out = json.loads(_get(viewer, "/set?nonsenseKey=1"))
    assert "error" in out


def test_material_editor(viewer):
    """Live material edit — the reference's UIOverlay Scene panel role:
    edits land in SceneResources, rebuild the scene, and restart
    accumulation with a MATERIAL_EDIT reset reason."""
    mats = json.loads(_get(viewer, "/materials"))
    assert mats and "base_color" in mats[0]
    _wait_spp(viewer, 1)
    out = json.loads(_get(viewer,
                          "/material?index=0&base_color=0.9,0.1,0.1"
                          "&roughness=0.25"))
    assert out["ok"] and out["reset"] == "MATERIAL_EDIT"
    m = viewer.renderer.resources.materials[0]
    assert m.base_color == (0.9, 0.1, 0.1)
    assert m.roughness == 0.25
    assert json.loads(_get(viewer, "/stats"))["reset"] == "MATERIAL_EDIT"
    _wait_spp(viewer, 1)  # renders again with the rebuilt scene


def test_mutation_requires_post_and_same_origin(viewer):
    """CSRF hardening: GET cannot mutate, and a cross-origin POST (the
    browser stamps Origin on those) is refused."""
    import urllib.error
    with pytest.raises(urllib.error.HTTPError) as err:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{viewer.port}/set?paused=1",
                timeout=30):
            pass
    assert err.value.code in (404, 405)
    req = urllib.request.Request(
        f"http://127.0.0.1:{viewer.port}/set?paused=1", method="POST",
        headers={"Origin": "http://evil.example"})
    with pytest.raises(urllib.error.HTTPError) as err:
        with urllib.request.urlopen(req, timeout=30):
            pass
    assert err.value.code == 403
    assert not json.loads(_get(viewer, "/stats"))["paused"]


def test_material_editor_rejects_bad_input(viewer):
    out = json.loads(_get(viewer, "/material?index=999&roughness=0.5"))
    assert "error" in out
    out = json.loads(_get(viewer, "/material?index=0&bogus=1"))
    assert "error" in out


def test_object_transform_panel(viewer):
    """Object panel: list transformable objects and move one with
    snapping — the reference's ImGuizmo Object panel analogue
    (UIOverlay.h:207-213), with an OBJECT_TRANSFORM reset."""
    objs = json.loads(_get(viewer, "/objects"))
    spheres = [o for o in objs if o["kind"] == "sphere"]
    assert spheres, objs
    idx = spheres[0]["index"]
    before = viewer.renderer.resources.spheres[idx].center
    out = json.loads(_get(
        viewer, f"/object?kind=sphere&index={idx}"
                "&translate=0.26,0,0&snap=0.25"))
    assert out["ok"] and out["reset"] == "OBJECT_TRANSFORM"
    after = viewer.renderer.resources.spheres[idx].center
    assert after[0] == pytest.approx(before[0] + 0.25)  # snapped
    assert json.loads(_get(viewer, "/stats"))["reset"] == "OBJECT_TRANSFORM"
    out = json.loads(_get(viewer, f"/object?kind=sphere&index=999"
                                  "&translate=1,0,0"))
    assert "error" in out
    _wait_spp(viewer, 1)  # renders again with the rebuilt scene


def test_presentation_mode_toggle(viewer):
    """Presentation mode (reference UIOverlay.h PresentationSettings
    :45-77, main.mm --presentation= :58-72): hides the panels client-side
    via the stats flag, locks the render resolution, and resets
    accumulation on toggle (resetAccumulationOnToggle default)."""
    srv = viewer
    srv.paused = True   # a 720p CPU pass would stall the suite
    srv.presentation_lock = 1   # 1280x720 lock
    out = srv.apply_query({"presentation": ["1"]})
    assert out["ok"] and out["reset"] in ("PRESENTATION_TOGGLE",
                                          "RENDER_SIZE")
    assert srv.stats()["presentation"] is True
    assert srv.renderer.settings.renderWidth == 1280
    assert srv.renderer.settings.renderHeight == 720
    # toggle back restores the previous explicit size
    out = srv.apply_query({"presentation": ["toggle"]})
    assert srv.stats()["presentation"] is False
    assert srv.renderer.settings.renderWidth != 1280 or \
        srv.renderer.settings.renderHeight != 720
    srv.paused = False


def test_denoise_toggle_changes_frame(viewer):
    """``/set?denoiseEnabled=1`` is display-only (no reset) and the next
    pass's ``/frame.png`` is the denoised display of the state."""
    _wait_spp(viewer, 2)
    out = json.loads(_get(viewer, "/set?denoiseEnabled=1"))
    assert out["ok"] and not out["reset"]
    done = json.loads(_get(viewer, "/stats"))["spp"]
    _wait_spp(viewer, done + 1)   # a pass that began after the edit
    json.loads(_get(viewer, "/set?paused=1"))
    try:
        frame = decode_png(_get(viewer, "/frame.png"))[..., :3]
        r = viewer.renderer
        denoised = display_to_u8(r.state, r.settings)
        s = r.settings.copy()
        s.denoiseEnabled = False
        plain = display_to_u8(r.state, s)
        np.testing.assert_array_equal(frame, denoised)
        assert (frame != plain).any()
    finally:
        json.loads(_get(viewer, "/set?paused=0&denoiseEnabled=0"))


def test_failed_pass_keeps_its_traceback(viewer, monkeypatch):
    """The loop survives a pass that raises, but keeps the traceback in
    ``last_error`` and ``/stats``: no frame comes silently from a failed
    pass."""
    real = viewer.renderer.draw_frame
    failed = []

    def draw_frame(*a, **k):
        if not failed:
            failed.append(1)
            raise RuntimeError("injected pass failure")
        return real(*a, **k)

    monkeypatch.setattr(viewer.renderer, "draw_frame", draw_frame)
    t0 = time.time()
    while "injected pass failure" not in viewer.last_error:
        assert time.time() - t0 < 60, "the failure was not kept"
        time.sleep(0.05)
    assert "injected pass failure" in json.loads(
        _get(viewer, "/stats"))["error"]
    before = viewer.renderer.sample_count()
    _wait_spp(viewer, before + 1)   # the loop went on
