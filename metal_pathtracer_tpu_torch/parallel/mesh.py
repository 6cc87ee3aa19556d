"""Multi-GPU rendering: data parallelism over image rows on
``torch.distributed`` (``parallel/mesh.py`` twin).

One process per rank, each owning one device (a card under NCCL; any
device under gloo, the CPU in the tests). The image's rows are split into
equal slabs, padded at the bottom where the height does not divide by the
world size; every rank builds the same scene and uniforms itself and
renders its slab through ``frame.render_rows`` with global pixel
coordinates. Per-pixel RNG is seeded by the absolute pixel, so an N-rank
image is bit-equal to a one-rank image. The trace counters' deltas are
summed over the ranks (the JAX package's ``psum``), so every rank carries
the global totals; the pad rows are real off-screen rows rendered with the
image's camera, and their traces count, as they do there. The only gather
is ``gather_state``, at save time, onto the host.

The names are the JAX module's: a ``Mesh`` here is the rank's view of its
process group, which the caller initialises (``torch.distributed.
init_process_group``: ``torchrun`` on a multi-GPU host, or an explicit
TCP address, world size and rank).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from metal_pathtracer_tpu_torch.renderer import frame
from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
from metal_pathtracer_tpu_torch.renderer.frame import DEFAULT_CHUNK
from metal_pathtracer_tpu_torch.schema import StaticConfig

#: the mesh's one axis, image rows (the JAX module's name for it)
AXIS = "pixels"

#: the RenderState fields that hold an image, row-sharded
IMAGE_FIELDS = ("radiance_sum", "radiance_sq_sum", "sample_count", "albedo",
                "normal")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a 1-D mesh of ranks over image rows."""

    rank: int
    world_size: int
    device: torch.device             # where this rank renders
    group: Optional[object]          # the process group (None: default)
    collective_device: torch.device  # where its collectives run


def default_device(rank: int) -> torch.device:
    """A rank's card: ``cuda:$LOCAL_RANK`` (torchrun's variable), else
    ``cuda:rank % device_count``; raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is available; pass "
                           "device='cpu' for the plain versions")
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local) if local is not None
                        else rank % torch.cuda.device_count())


def make_mesh(device=None, group=None) -> Mesh:
    """The mesh of an initialised process group (``group``, or the
    default one). ``device`` defaults to ``default_device(rank)``. Under
    NCCL the collectives run on that card; under gloo, whose all-gather
    takes no CUDA tensors, on the CPU. The backend is the caller's
    choice: NCCL without a card raises, and so does a CUDA device without
    one."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised process group: "
                           "call torch.distributed.init_process_group first")
    rank = dist.get_rank(group)
    world = dist.get_world_size(group)
    device = default_device(rank) if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"make_mesh: {device} asked for, but no CUDA "
                           "device is available")
    if dist.get_backend(group) == "nccl":
        if device.type != "cuda":
            raise RuntimeError("make_mesh: NCCL collectives need a CUDA "
                               f"device, not {device}")
        torch.cuda.set_device(device)
        collective = device
    else:
        collective = torch.device("cpu")
    return Mesh(rank, world, device, group, collective)


def padded_height(height: int, world_size: int) -> int:
    """The height rounded up to a multiple of the world size."""
    return height + (-height) % world_size


def shard_state(state: RenderState, mesh: Mesh) -> RenderState:
    """This rank's slab of a whole-image state that every rank holds
    alike, on ``mesh.device``. A height the world size does not divide is
    padded with zero rows; a pre-sq_sum state's second moment becomes
    zeros (``mesh.py:56-72``). The slab's first row is image row
    ``rank * slab.height``."""
    if state.radiance_sq_sum is None:
        state = state.replace(
            radiance_sq_sum=torch.zeros_like(state.radiance_sum))
    pad = padded_height(state.height, mesh.world_size) - state.height
    rows = (state.height + pad) // mesh.world_size
    r0 = mesh.rank * rows

    def slab(x):
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        return x[r0:r0 + rows].to(mesh.device).clone()

    return state.replace(**{f: slab(getattr(state, f))
                            for f in IMAGE_FIELDS})


def unpad_state(state: RenderState, height: int) -> RenderState:
    """A (padded) whole-image state cut back to the image's rows."""
    return state.replace(**{
        f: None if getattr(state, f) is None else getattr(state, f)[:height]
        for f in IMAGE_FIELDS})


def replicate(tree, mesh: Mesh):
    """A ``SceneArrays`` / ``Uniforms`` tree with every tensor on
    ``mesh.device`` (each rank builds its scene itself; a tree already
    there comes back as it is). Layouts cached on a tree's objects are
    rebuilt on first use."""
    if isinstance(tree, torch.Tensor):
        return tree.to(mesh.device)
    if isinstance(tree, tuple):
        return tuple(replicate(x, mesh) for x in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: replicate(getattr(tree, f.name), mesh)
                             for f in dataclasses.fields(tree) if f.init})
    return tree


def render_samples_sharded(scene, uniforms, slab: RenderState,
                           static: StaticConfig, n_samples: int, mesh: Mesh,
                           chunk: int = DEFAULT_CHUNK) -> RenderState:
    """Advance this rank's slab by ``n_samples`` (every rank calls it with
    its own slab); the trace counters come back as the totals over every
    rank, pad rows included."""
    out = frame.render_rows(scene, uniforms, slab, static, n_samples,
                            row_offset=mesh.rank * slab.height, chunk=chunk)
    delta = torch.tensor([out.ray_count - slab.ray_count,
                          out.shadow_ray_count - slab.shadow_ray_count],
                         dtype=torch.int64, device=mesh.collective_device)
    dist.all_reduce(delta, op=dist.ReduceOp.SUM, group=mesh.group)
    rays, shadow = delta.tolist()
    return out.replace(ray_count=slab.ray_count + rays,
                       shadow_ray_count=slab.shadow_ray_count + shadow)


def gather_state(slab: RenderState, mesh: Mesh) -> RenderState:
    """Every rank's slab gathered into the whole padded state, on the
    host of every rank (the save-time gather); cut the pad rows with
    ``unpad_state``."""
    def gather(x):
        if x is None:
            return None
        part = x.to(mesh.collective_device).contiguous()
        parts = [torch.empty_like(part) for _ in range(mesh.world_size)]
        dist.all_gather(parts, part, group=mesh.group)
        return torch.cat([p.cpu() for p in parts])

    return slab.replace(**{f: gather(getattr(slab, f))
                           for f in IMAGE_FIELDS})
