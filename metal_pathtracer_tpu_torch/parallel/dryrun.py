"""Multi-process dry run of ``parallel/mesh.py`` (the counterpart of the
JAX package's ``tools/dist_dryrun.py`` and ``__graft_entry__
.dryrun_multichip``).

Every rank renders its slab of one frame, gathers the whole frame and
checks it bit for bit (radiance, second moment, sample counts, albedo,
normal) against a single-process ``render_samples`` of the same scene on
its own device, and the summed trace counters against that render's (for
a height the world size does not divide, against one ``render_rows`` over
the padded rows with the image's camera: the pad rows' traces count).

    # N cards of one host
    torchrun --nproc-per-node=N -m metal_pathtracer_tpu_torch.parallel.dryrun
    # two gloo ranks sharing one card (or the CPU: --device cpu)
    python -m metal_pathtracer_tpu_torch.parallel.dryrun --backend gloo \\
        --init-method tcp://127.0.0.1:29500 --world-size 2 --rank K \\
        --device cuda:0

``--scene``: ``toy`` (three spheres on a ground sphere, depth 4),
``bench`` (the bench-class scene at toy scale: a 320-triangle displaced
icosphere, glass and textured PBR icospheres, the HDR sky, depth 4),
``headline`` (``benchscene.build_bench_scene(8)``, depth 8) or a
``.scene`` file. Prints ``DIST_DRYRUN_OK rank=K world=N`` or exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from metal_pathtracer_tpu_torch.ops.camera import build_camera
from metal_pathtracer_tpu_torch.parallel import mesh as mesh_ops
from metal_pathtracer_tpu_torch.renderer import frame
from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
from metal_pathtracer_tpu_torch.schema import (
    settings_to_static,
    settings_to_uniforms,
)

#: ``__graft_entry__._build``'s scene
TOY_SCENE = (
    "camera target=0,0,-1 distance=3.5 yaw=0 pitch=0 vfov=45\n"
    "renderer maxDepth=4 seed=1337\n"
    "background solid=0.7,0.8,1.0\n"
    "material type=lambert albedo=0.8,0.3,0.3\n"
    "material type=metal albedo=0.9,0.9,0.9 roughness=0.2\n"
    "material type=dielectric ior=1.5\n"
    "sphere center=0,0,-1 radius=0.5 material=0\n"
    "sphere center=1,0,-1 radius=0.5 material=1\n"
    "sphere center=-1,0,-1 radius=0.5 material=2\n"
    "sphere center=0,-100.5,-1 radius=100 material=0\n")


class DryrunError(AssertionError):
    """A sharded render that differs from the single-process one."""


def build_scene(name: str, width: int, height: int, device):
    """(scene, uniforms, static) of a named scene or a ``.scene`` file,
    built on ``device``."""
    from metal_pathtracer_tpu_torch.ops import env as env_ops
    from metal_pathtracer_tpu_torch.scene import dsl
    from metal_pathtracer_tpu_torch.scene.resources import SceneResources
    from metal_pathtracer_tpu_torch.settings import (
        BackgroundMode,
        RenderSettings,
    )
    from metal_pathtracer_tpu_torch.utils import benchscene

    environment = None
    if name in ("bench", "headline"):
        settings, res, environment = benchscene.build_bench_scene(
            2 if name == "bench" else 8, device)
        if name == "bench":   # ``__graft_entry__._build_full``
            settings.maxDepth = 4
    else:
        settings, res = RenderSettings(), SceneResources()
        if name == "toy":
            dsl.parse_scene(TOY_SCENE, settings, res)
        else:
            dsl.load_scene_file(name, settings, res)
            if settings.backgroundMode == BackgroundMode.ENVIRONMENT \
                    and settings.environmentMapPath:
                environment = env_ops.load_environment(
                    settings.environmentMapPath, device)
    scene = res.build_arrays(environment=environment, device=device)
    static = settings_to_static(settings, width, height,
                                res.material_types_present(),
                                res.texture_slots_present(),
                                res.texture_uses_uv1())
    uniforms = settings_to_uniforms(
        settings, build_camera(settings, width, height, device), 0, 0)
    return scene, uniforms, static


def launch_counts() -> dict:
    """Every kernel wrapper's launch count so far, by name (each wrapper
    counts the launches of its CUDA kernel; the plain versions count
    none)."""
    from metal_pathtracer_tpu_torch.ops.kernels import (
        primitives,
        shade,
        texture,
        traverse,
    )

    return {name: fn.launches
            for mod in (traverse, shade, texture, primitives)
            for name, fn in vars(mod).items()
            if callable(fn) and hasattr(fn, "launches")}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def check_case(mesh: mesh_ops.Mesh, scene, uniforms, static, spp: int):
    """Render ``spp`` samples of the frame over the mesh (after one
    warm-up sample whose frame is dropped), gather it and hold it against
    the single-process render; raises ``DryrunError`` on
    any difference. Returns a dict: ``state`` (the gathered frame on the
    host, pad rows cut), ``padded`` (its padded height), ``slab_ms`` and
    ``single_ms`` (host clock, device synchronised), ``launches`` (each
    kernel launched by the sharded render, and how often)."""
    w, h = static.width, static.height
    dev = mesh.device
    slab = mesh_ops.shard_state(RenderState.create(w, h, dev), mesh)
    scene = mesh_ops.replicate(scene, mesh)
    uniforms = mesh_ops.replicate(uniforms, mesh)
    # a warm-up sample: the scene's kernel layouts are built on first use
    mesh_ops.render_samples_sharded(scene, uniforms, slab, static, 1, mesh)
    dist.barrier(group=mesh.group)
    _sync(dev)
    before = launch_counts()
    t0 = time.perf_counter()
    out = mesh_ops.render_samples_sharded(scene, uniforms, slab, static,
                                          spp, mesh)
    _sync(dev)
    slab_ms = 1e3 * (time.perf_counter() - t0)
    launches = {k: n - before[k] for k, n in launch_counts().items()
                if n != before[k]}
    full = mesh_ops.gather_state(out, mesh)
    padded = full.height
    full = mesh_ops.unpad_state(full, h)

    t0 = time.perf_counter()
    single = frame.render_samples(scene, uniforms,
                                  RenderState.create(w, h, dev), static, spp)
    _sync(dev)
    single_ms = 1e3 * (time.perf_counter() - t0)
    for f in mesh_ops.IMAGE_FIELDS:
        got, want = getattr(full, f), getattr(single, f).cpu()
        if not torch.equal(got, want):
            bad = (got != want).reshape(h, -1).any(1).nonzero().flatten()
            raise DryrunError(
                f"rank {mesh.rank}: {f} differs from the single render in "
                f"{bad.numel()} of {h} rows, the first {bad[:8].tolist()}")
    totals = single
    if padded != h:   # the pad rows' traces, rendered with this camera
        totals = frame.render_samples(
            scene, uniforms, RenderState.create(w, padded, dev), static, spp)
    for f in ("ray_count", "shadow_ray_count"):
        if getattr(out, f) != getattr(totals, f):
            raise DryrunError(f"rank {mesh.rank}: {f} {getattr(out, f)} "
                              f"!= {getattr(totals, f)} of the single "
                              f"render over {padded} rows")
    full = full.replace(ray_count=out.ray_count,
                        shadow_ray_count=out.shadow_ray_count)
    return dict(state=full, padded=padded, slab_ms=slab_ms,
                single_ms=single_ms, launches=launches)


def save_state(path: str, state: RenderState) -> None:
    """The gathered frame as ``.npz``: the image fields as they are and
    the trace totals as int64."""
    np.savez(path, ray_count=np.int64(state.ray_count),
             shadow_ray_count=np.int64(state.shadow_ray_count),
             **{f: getattr(state, f).numpy()
                for f in mesh_ops.IMAGE_FIELDS})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--init-method", default="env://")
    ap.add_argument("--world-size", type=int,
                    default=int(os.environ.get("WORLD_SIZE", 1)))
    ap.add_argument("--rank", type=int,
                    default=int(os.environ.get("RANK", 0)))
    ap.add_argument("--backend", default="nccl")
    ap.add_argument("--device", default=None,
                    help="default: cuda:$LOCAL_RANK, else cuda:rank %% "
                    "device count")
    ap.add_argument("--scene", default="toy")
    ap.add_argument("--width", type=int, default=16)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--out", default="",
                    help="rank 0 writes the gathered frame here (.npz)")
    args = ap.parse_args(argv)

    if args.device and torch.device(args.device).type == "cpu":
        torch.set_num_threads(1)   # CPU ranks share the host's cores
    # NCCL binds each rank to its card when the group is made
    device_id = (mesh_ops.default_device(args.rank) if args.device is None
                 else torch.device(args.device)) \
        if args.backend == "nccl" else None
    dist.init_process_group(args.backend, init_method=args.init_method,
                            world_size=args.world_size, rank=args.rank,
                            device_id=device_id)
    try:
        mesh = mesh_ops.make_mesh(device=args.device)
        t0 = time.perf_counter()
        built = build_scene(args.scene, args.width, args.height, mesh.device)
        build_s = time.perf_counter() - t0
        try:
            res = check_case(mesh, *built, args.spp)
        except DryrunError as err:
            print(f"DIST_DRYRUN_FAILED {err}", flush=True)
            return 1
        if args.out and mesh.rank == 0:
            save_state(args.out, res["state"])
        print(f"rank={mesh.rank} world={mesh.world_size} device="
              f"{mesh.device} scene={args.scene} {args.width}x"
              f"{args.height} padded={res['padded']} spp={args.spp}: "
              f"build {build_s:.2f}s, slab {res['slab_ms']:.2f} ms, single "
              f"{res['single_ms']:.2f} ms, traces "
              f"({res['state'].ray_count}, "
              f"{res['state'].shadow_ray_count}), launches="
              f"{json.dumps(res['launches'])}", flush=True)
        print(f"DIST_DRYRUN_OK rank={mesh.rank} world={mesh.world_size}",
              flush=True)
        return 0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
