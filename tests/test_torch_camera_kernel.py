"""The primary-ray kernel (``ops/kernels/camera.py primary_rays``,
``csrc/camera.cu``) against the plain chain, ``rng.make_seed`` then
``camera.generate_primary_rays``, on rtow's camera, a depth-of-field
camera, nonzero frame, sample and previous counts, and a slab of rows.

On the CPU the wrapper takes that chain and counts no lane. Tests marked
``cuda`` skip without a card; on one the kernel's state, origin and
direction equal the chain's on the same card bit for bit at 1280x720.
No JAX call. On a GPU machine:
``python -m pytest tests/test_torch_camera_kernel.py -q --noconftest``."""

from __future__ import annotations

import dataclasses
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

from metal_pathtracer_tpu_torch.ops import camera as camera_ops
from metal_pathtracer_tpu_torch.ops import rng as rng_ops
from metal_pathtracer_tpu_torch.ops.kernels import camera as K
from metal_pathtracer_tpu_torch.renderer import frame
from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
from metal_pathtracer_tpu_torch.scene import dsl
from metal_pathtracer_tpu_torch.scene.resources import SceneResources
from metal_pathtracer_tpu_torch.schema import (
    settings_to_static,
    settings_to_uniforms,
)
from metal_pathtracer_tpu_torch.settings import RenderSettings
from metal_pathtracer_tpu_torch.utils import spans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "portbench", "configs", "rtow.json")) as _fh:
    RTOW = json.load(_fh)["settings"]
CAMERA_KEYS = ("cameraTarget", "cameraDistance", "cameraYaw", "cameraPitch",
               "cameraVerticalFov", "cameraDefocusAngle",
               "cameraFocusDistance")
#: each case: depth of field, fixed seed, frame index (= sample count, as
#: the frame loop sets them), the largest previous count (0: none), and
#: whether the lanes are the lower half of the rows (a slab whose first
#: row is image row height // 2)
CASES = {
    "rtow": (False, 1337, 0, 0, False),
    "depth_of_field": (True, 1337, 0, 0, False),
    "counts": (True, 2 ** 32 - 5, 1_000_003, 4096, False),
    "slab": (False, 7, 3, 0, True),
}
#: the unit disk's rejection rounds (``rng._masked_rejection``)
DISK_ROUNDS = 24


def _rtow_camera(s: RenderSettings) -> RenderSettings:
    for key in CAMERA_KEYS:
        value = RTOW[key]
        setattr(s, key, tuple(value) if isinstance(value, list) else value)
    return s


def _settings(defocus: bool) -> RenderSettings:
    s = _rtow_camera(RenderSettings())
    if defocus:
        s.cameraDefocusAngle, s.cameraFocusDistance = 2.0, 10.0
    return s


def _inputs(case: str, w: int, h: int, dev):
    """The camera and the wrapper's other arguments for ``case``."""
    defocus, seed, frame_index, prev_max, slab = CASES[case]
    cam = camera_ops.build_camera(_settings(defocus), w, h, dev)
    row0 = h // 2 if slab else 0
    flat = torch.arange((h - row0) * w, device=dev)
    x, y = flat % w, flat // w + row0
    prev = torch.from_numpy(np.random.default_rng(5).integers(
        0, prev_max + 1, x.shape[0])).to(dev)
    return cam, (seed, frame_index, frame_index, x, y, prev, w, h)


def _plain(cam, seed, frame_index, sample_count, x, y, prev, w, h):
    state = rng_ops.make_seed(seed, frame_index, x, y, sample_count, prev)
    return camera_ops.generate_primary_rays(cam, x, y, w, h, state)


def _bits_equal(a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def _delta(before: dict, name: str) -> int:
    return spans.counters().get(name, 0) - before.get(name, 0)


@pytest.mark.parametrize("case", CASES)
def test_cpu_route_is_the_plain_chain(case):
    cam, args = _inputs(case, 48, 27, "cpu")
    before, launches = spans.counters(), K.primary_rays.launches
    got = K.primary_rays(cam, *args)
    assert K.primary_rays.launches == launches
    assert _delta(before, "lanes.camera") == 0
    want = _plain(cam, *args)
    assert all(_bits_equal(a, b) for a, b in zip(got, want))
    assert got[1].shape == got[2].shape == (args[3].shape[0], 3)


def test_unsupported_device_raises():
    cam, args = _inputs("rtow", 8, 4, "cpu")
    meta = [t.to("meta") for t in args[3:6]]
    with pytest.raises(ValueError, match="unsupported device"):
        K.primary_rays(cam, *args[:3], *meta, *args[6:])


def test_the_frame_loop_opens_each_sample_with_primary_rays():
    """``render_rows`` reaches the wrapper once a sample and chunk with
    the absolute pixel rows and each lane's previous count, and renders
    the same bits as with the plain chain in its place."""
    w, h, chunk, samples = 8, 6, 20, 2
    settings, resources = RenderSettings(), SceneResources()
    dsl.load_scene_file(os.path.join(REPO, "tests", "scenes",
                                     "smoke.scene"), settings, resources)
    settings = _rtow_camera(settings)
    settings.maxDepth = 2
    scene = resources.build_arrays(device="cpu")
    static = settings_to_static(settings, w, h,
                                resources.material_types_present())
    uni = settings_to_uniforms(settings,
                               camera_ops.build_camera(settings, w, h, "cpu"),
                               0, 0)
    res_state = RenderState.create(w, h, "cpu")
    res_state = res_state.replace(sample_count=torch.arange(
        w * h, dtype=torch.int64).reshape(h, w) % 3)
    calls = []

    def spy(cam, seed, frame_index, sample_count, x, y, prev, width, height):
        calls.append((frame_index, sample_count, x.clone(), y.clone(),
                      prev.clone()))
        return _plain(cam, seed, frame_index, sample_count, x, y, prev,
                      width, height)

    with mock.patch.object(K, "primary_rays", spy):
        spied = frame.render_rows(scene, uni, res_state, static, samples,
                                  row_offset=10, chunk=chunk)
    got = frame.render_rows(scene, uni, res_state, static, samples,
                            row_offset=10, chunk=chunk)
    assert len(calls) == samples * -(-w * h // chunk)
    flat = torch.arange(w * h)
    prev = res_state.sample_count.reshape(-1)
    for k, (fi, sc, x, y, p) in enumerate(calls):
        i, lo = divmod(k, -(-w * h // chunk))
        sl = slice(lo * chunk, min((lo + 1) * chunk, w * h))
        assert fi == sc == i
        assert torch.equal(x, flat[sl] % w)
        assert torch.equal(y, flat[sl] // w + 10)
        assert torch.equal(p, prev[sl] + i)
    for a, b in ((got.radiance_sum, spied.radiance_sum),
                 (got.albedo, spied.albedo), (got.normal, spied.normal)):
        assert _bits_equal(a, b)


# ---- on the card --------------------------------------------------------


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _disk_rounds(cam, args, state):
    """Each lane's rejection rounds, found from its final state: the
    state after the seed's two jitter draws, advanced two draws a round
    until it is the lane's (0 where no round up to 24 reaches it)."""
    seed, frame_index, sample_count, x, y, prev = args[:6]
    s = rng_ops.make_seed(seed, frame_index, x, y, sample_count, prev)
    s = rng_ops.pcg_hash(rng_ops.pcg_hash(s))
    rounds = torch.zeros_like(state)
    for k in range(1, DISK_ROUNDS + 1):
        s = rng_ops.pcg_hash(rng_ops.pcg_hash(s))
        rounds = torch.where((rounds == 0) & (s == state), k, rounds)
    return rounds


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernel_bit_equal_to_the_plain_chain_on_card(dev, case):
    cam, args = _inputs(case, 1280, 720, dev)
    n = args[3].shape[0]
    before, launches = spans.counters(), K.primary_rays.launches
    got = K.primary_rays(cam, *args)
    torch.cuda.synchronize()
    assert K.primary_rays.launches == launches + 1
    assert _delta(before, "lanes.camera") == n
    want = K.primary_rays_reference(cam, *args)
    for name, a, b in zip(("state", "origin", "direction"), got, want):
        assert _bits_equal(a, b), name
    rounds = _disk_rounds(cam, args, got[0])
    assert bool((rounds >= 1).all())
    # a round accepts with probability pi/4: some ~400 of 921,600 lanes
    # (~200 of a half-height slab) need 6 rounds or more
    assert int(rounds.max()) >= 6
    assert (float(cam.lens_radius) > 0.0) == CASES[case][0]


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take_on_card(dev):
    cam, args = _inputs("rtow", 64, 8, dev)
    x = args[3].to(torch.int32)
    with pytest.raises(ValueError, match="int64"):
        K.primary_rays(cam, *args[:3], x, *args[4:])
    with pytest.raises(ValueError, match="camera.origin"):
        K.primary_rays(dataclasses.replace(cam, origin=cam.origin.cpu()),
                       *args)
