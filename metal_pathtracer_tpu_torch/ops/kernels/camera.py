"""Primary rays: a sample's seeds, pixel jitter, lens draw and rays.

Replaces no TPU kernel: the JAX package leaves ``ops/rng.py make_seed``
and ``ops/camera.py generate_primary_rays`` to XLA, which fuses them.
Eager PyTorch runs the same chain (``primary_rays_reference``) as 1,540
launches a wavefront, most of them the unit disk's 24 fixed rounds of
masked rejection, each a full-width int64 or float64 op of a few
microseconds that the host takes longer to launch than the device to run.

``primary_rays`` launches ``csrc/camera.cu`` on CUDA tensors, one launch a
wavefront with no host sync (the counters are host integers, the camera is
read through device pointers), and runs ``primary_rays_reference`` on CPU
tensors. Both return (state, origin, direction): the (N,) int64 RNG state
after the camera's draws and the (N, 3) float32 origin and unnormalised
direction, the same bits on a card (the kernel places its FMAs and
divisions where the plain chain does; see the source).
"""

from __future__ import annotations

import torch

from metal_pathtracer_tpu_torch.ops import camera as camera_ops
from metal_pathtracer_tpu_torch.ops import rng as rng_ops
from metal_pathtracer_tpu_torch.ops.kernels import build
from metal_pathtracer_tpu_torch.schema import CameraUniforms
from metal_pathtracer_tpu_torch.utils.spans import count

_MASK = 0xFFFFFFFF
#: CameraUniforms' fields in the order the kernel takes their pointers
_CAMERA_FIELDS = ("origin", "lower_left", "horizontal", "vertical", "u", "v",
                  "lens_radius")


def primary_rays_reference(camera: CameraUniforms, fixed_seed: int,
                           frame_index: int, sample_count: int, x, y,
                           prev_count, width: int, height: int):
    """The plain chain: ``rng.make_seed`` then
    ``camera.generate_primary_rays``."""
    seed = rng_ops.make_seed(fixed_seed, frame_index, x, y, sample_count,
                             prev_count)
    return camera_ops.generate_primary_rays(camera, x, y, width, height, seed)


def _check(x, y, prev_count, camera: CameraUniforms, dev) -> int:
    n = x.shape[0]
    for t in (x, y, prev_count):
        if t.device != dev or t.dtype != torch.int64 or t.shape != (n,) \
                or not t.is_contiguous():
            raise ValueError(f"primary_rays: x, y and the previous counts "
                             f"must be contiguous ({n},) int64 tensors on "
                             f"{dev}")
    for name in _CAMERA_FIELDS:
        t = getattr(camera, name)
        shape = () if name == "lens_radius" else (3,)
        if t.device != dev or t.dtype != torch.float32 or t.shape != shape \
                or not t.is_contiguous():
            raise ValueError(f"primary_rays: camera.{name} must be a "
                             f"contiguous {shape} float32 tensor on {dev}")
    return n


def primary_rays(camera: CameraUniforms, fixed_seed: int, frame_index: int,
                 sample_count: int, x, y, prev_count, width: int,
                 height: int):
    """(state, origin, direction) of the lanes at pixels (x, y) with
    ``prev_count`` earlier samples. CPU tensors take the plain chain; CUDA
    tensors launch ``primary_rays_kernel``, counted in ``lanes.camera``."""
    dev = x.device
    if dev.type == "cpu":
        return primary_rays_reference(camera, fixed_seed, frame_index,
                                      sample_count, x, y, prev_count, width,
                                      height)
    if dev.type != "cuda":
        raise ValueError(f"primary_rays: unsupported device {dev}")
    n = _check(x, y, prev_count, camera, dev)
    state = torch.empty(n, dtype=torch.int64, device=dev)
    origin = torch.empty((n, 3), dtype=torch.float32, device=dev)
    direction = torch.empty((n, 3), dtype=torch.float32, device=dev)
    err = build.load().mpt_primary_rays(
        n, x.data_ptr(), y.data_ptr(), prev_count.data_ptr(),
        int(fixed_seed) & _MASK, int(frame_index) & _MASK,
        int(sample_count) & _MASK, float(width), float(height),
        build.pointers([getattr(camera, f).data_ptr()
                        for f in _CAMERA_FIELDS]),
        state.data_ptr(), origin.data_ptr(), direction.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "mpt_primary_rays")
    primary_rays.launches += 1
    count("lanes.camera", n)
    return state, origin, direction


#: launches since the last reset
primary_rays.launches = 0
