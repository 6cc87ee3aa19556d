#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from ``metal_pathtracer_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, renders the
bench's lambert series (327,680-triangle displaced icosphere, 1920x1080,
maxDepth 8) through ``CudaBackend``, checks that the render went through
both kernels, and prints timings. Any failure raises; the script exits 0
only when every phase passed, and its last line is then the one-line JSON
result. Run from the repository root with no arguments:

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import importlib.metadata
import importlib.util
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

TIMED_SPP = 8
FRAME = (1920, 1080)
SUBDIVISIONS = 7        # 20 * 4^7 = 327,680 triangles
CHECK_FRAME = (160, 96)
IMAGE_GATE = dict(max_rmse=2e-4, min_within_1e5=0.98)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(prepare, reps: int) -> float:
    """Mean device milliseconds over ``reps`` runs of the callable that
    ``prepare()`` returns (set-up outside the timed window; CUDA events)."""
    total = 0.0
    for _ in range(reps):
        run = prepare()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def probes(scene, n=4096, seed=7):
    """bench.py:136-146's probe set: half the rays aimed at the mesh bounds,
    plus lanes that exclude their own nearest triangle and dead lanes."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    v0 = scene.triangles.v0.cpu().numpy()
    lo, hi = v0.min(0), v0.max(0)
    target = rng.uniform(lo, hi, (n // 2, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2] = target - o[: n // 2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(n, 1e20, np.float32)
    tmax[::61] = 0.0
    return o, d, tmax


def compare_trace(a, b):
    """K1 outputs must be equal bit for bit; returns max |t| difference."""
    t_a, tri_a, u_a, v_a = (x.cpu().numpy() for x in a)
    t_b, tri_b, u_b, v_b = (x.cpu().numpy() for x in b)
    for name, x, y in (("t", t_a, t_b), ("tri", tri_a, tri_b),
                       ("u", u_a, u_b), ("v", v_a, v_b)):
        if not np.array_equal(x.view(np.int32), y.view(np.int32)):
            bad = int((x.view(np.int32) != y.view(np.int32)).sum())
            raise AssertionError(f"K1 differs from its plain version in {name} "
                                 f"on {bad} lanes")
    return float(np.abs(t_a - t_b).max())


def image_gate(img, ref, rays, rays_ref, label):
    d = np.abs(img - ref)
    rmse = float(np.sqrt((d * d).mean()))
    within = float((d.max(-1) < 1e-5).mean())
    print(f"{label}: rmse={rmse:.3e} within_1e-5={within:.5f} "
          f"max_abs={float(d.max()):.3e} rays={rays} plain_rays={rays_ref}")
    if rays != rays_ref:
        raise AssertionError(f"{label}: ray counts differ")
    if not (rmse < IMAGE_GATE["max_rmse"]
            and within > IMAGE_GATE["min_within_1e5"]):
        raise AssertionError(f"{label}: image gate failed")
    return float(d.max())


@contextlib.contextmanager
def plain_kernels(shade_mod, traverse_mod):
    """The same depth loop with both kernel entry points replaced by their
    plain PyTorch versions (run on the card)."""
    def plain_trace(o, d, t_min, t_max, bvh, tris, ex_mesh, ex_prim):
        return traverse_mod.trace_closest_reference(
            o, d, float(t_min), t_max, bvh, tris, ex_mesh.to(torch.int32),
            ex_prim.to(torch.int32))
    with mock.patch.object(shade_mod, "trace_closest", plain_trace), \
            mock.patch.object(shade_mod, "shade_full",
                              shade_mod.shade_full_reference):
        yield


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    from metal_pathtracer_tpu import constants as C
    from metal_pathtracer_tpu_torch.ops.camera import build_camera
    from metal_pathtracer_tpu_torch.ops.integrator import PathCarry
    from metal_pathtracer_tpu_torch.ops.kernels import build
    from metal_pathtracer_tpu_torch.ops.kernels import shade as shade_mod
    from metal_pathtracer_tpu_torch.ops.kernels import traverse as trav_mod
    from metal_pathtracer_tpu_torch.renderer import frame
    from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
    from metal_pathtracer_tpu_torch.renderer.headless import CudaBackend
    from metal_pathtracer_tpu_torch.schema import (
        settings_to_static,
        settings_to_uniforms,
    )
    from metal_pathtracer_tpu_torch.utils.benchscene import (
        build_lambert_series,
    )

    dev = torch.device("cuda", 0)
    card = device_line()
    nvcc = [line for line in subprocess.run(
        [build.nvcc_path(), "--version"], capture_output=True, text=True,
        check=True).stdout.splitlines() if "release" in line]
    print(f"# card: {card}")
    triton = (importlib.metadata.version("triton")
              if importlib.util.find_spec("triton") else "absent")
    print(f"# python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} triton {triton} "
          f"nvcc: {' '.join(nvcc)}")

    # ---- set-up: build the kernels ----------------------------------------
    t0 = time.time()
    build.load()
    print(f"# kernels built+loaded in {time.time() - t0:.1f}s")
    print(build.build_log())

    settings, resources = build_lambert_series(SUBDIVISIONS)
    t0 = time.time()
    scene = resources.build_arrays(device=dev)
    print(f"# scene: {scene.triangles.count} triangles, "
          f"{scene.tri_bvh.node_count} BVH nodes, built in "
          f"{time.time() - t0:.1f}s")

    # ---- K1 on the card vs its plain version: 4096 probes, bit for bit -----
    o, d, tmax = probes(scene)
    o, d, tmax = (torch.from_numpy(x).to(dev) for x in (o, d, tmax))
    ex_mesh = torch.full((o.shape[0],), -1, dtype=torch.int32, device=dev)
    ex_prim = torch.full_like(ex_mesh, -1)
    first = trav_mod.trace_closest_reference(o, d, C.EPSILON_T, tmax,
                                             scene.tri_bvh, scene.triangles,
                                             ex_mesh, ex_prim)
    # every eighth lane excludes the triangle it just hit (self-hit rule)
    sel = torch.zeros_like(ex_mesh, dtype=torch.bool)
    sel[::8] = first[1][::8] >= 0
    ex_prim = torch.where(sel, first[1], -1)
    ex_mesh = torch.where(sel, 0, -1).to(torch.int32)
    k1 = trav_mod.trace_closest(o, d, C.EPSILON_T, tmax, scene.tri_bvh,
                                scene.triangles, ex_mesh, ex_prim)
    ref = trav_mod.trace_closest_reference(o, d, C.EPSILON_T, tmax,
                                           scene.tri_bvh, scene.triangles,
                                           ex_mesh, ex_prim)
    torch.cuda.synchronize()
    k1_err = compare_trace(k1, ref)
    print(f"K1 probes: bit-exact over {o.shape[0]} lanes, "
          f"{int((k1[1] >= 0).sum())} hits, {int(sel.sum())} excluding lanes")

    # ---- K2: 160x96, 4 spp, maxDepth 8, kernel path vs plain path ---------
    w, h = CHECK_FRAME
    static = settings_to_static(settings, w, h,
                                resources.material_types_present())
    uni = settings_to_uniforms(settings, build_camera(settings, w, h, dev),
                               0, 0)
    st_k = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                static, 4)
    with plain_kernels(shade_mod, trav_mod):
        st_p = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                    static, 4)
    k2_err = image_gate(st_k.present().cpu().numpy(),
                        st_p.present().cpu().numpy(), st_k.ray_count,
                        st_p.ray_count, f"K2 {w}x{h} 4spp kernel vs plain")

    # ---- the slice: lambert series at 1920x1080 through CudaBackend -------
    W, H = FRAME
    backend = CudaBackend()
    warm = backend.render(resources, settings, W, H, 1, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    trav_mod.trace_closest.launches = 0
    shade_mod.shade_full.launches = 0
    out = backend.render(resources, settings, W, H, TIMED_SPP, device=dev)
    launches = {"trace_closest": trav_mod.trace_closest.launches,
                "shade_full": shade_mod.shade_full.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    img = out.linear_rgb
    if not (np.isfinite(img).all() and img.max() > 0.0):
        raise AssertionError("1080p image is not finite and non-zero")
    if out.ray_count < W * H * TIMED_SPP or warm.ray_count < W * H:
        raise AssertionError(f"ray_count {out.ray_count} < pixel count")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    mrays = out.ray_count / out.total_seconds / 1e6
    print(f"lambert {W}x{H} d8: {TIMED_SPP} spp in "
          f"{out.total_seconds:.3f}s, {out.avg_ms_per_sample:.2f} ms/spp, "
          f"{mrays:.2f} Mrays/s ({out.ray_count} traces), peak "
          f"{peak / 2**20:.0f} MiB, launches {launches}, mean "
          f"{float(img.mean()):.4f} [{card}]")

    # ---- K1/K2 vs plain at the main path's shapes (first bounce) ----------
    static = settings_to_static(settings, W, H,
                                resources.material_types_present())
    uni = settings_to_uniforms(settings, build_camera(settings, W, H, dev),
                               0, 0)
    params = shade_mod.ShadeParams.of(uni, static)
    from metal_pathtracer_tpu_torch.ops import camera as camera_ops
    from metal_pathtracer_tpu_torch.ops import integrator
    from metal_pathtracer_tpu_torch.ops import rng as rng_ops
    flat = torch.arange(W * H, device=dev)
    xs, ys = flat % W, flat // W
    seed = rng_ops.make_seed(uni.fixed_rng_seed, 0, xs, ys, 0,
                             torch.zeros_like(xs))
    state, ro, rd = camera_ops.generate_primary_rays(uni.camera, xs, ys, W, H,
                                                     seed)
    carry = PathCarry.start(state, ro, rd, 0.0,
                            integrator._primary_cone_spread(uni, static))

    def trace_inputs(c):
        return (c.ray_o, c.ray_d, C.EPSILON_T,
                torch.where(c.alive, C.INFINITY_T, 0.0), scene.tri_bvh,
                scene.triangles,
                torch.where(c.prev_valid, c.prev_mesh, -1).to(torch.int32),
                torch.where(c.prev_valid, c.prev_prim, -1).to(torch.int32))

    hit0 = trav_mod.trace_closest(*trace_inputs(carry))
    shade_mod.shade_full(carry, *hit0, scene.triangles, scene.materials,
                         params, 0)
    args = trace_inputs(carry)   # the first-bounce wavefront
    n_live = int(carry.alive.sum())
    k1_ms = cuda_ms(lambda: lambda: trav_mod.trace_closest(*args), 5)
    k1_plain_ms = cuda_ms(
        lambda: lambda: trav_mod.trace_closest_reference(*args), 1)
    hit1 = trav_mod.trace_closest(*args)
    k1_err = max(k1_err, compare_trace(
        hit1, trav_mod.trace_closest_reference(*args)))

    def clone(c):
        return PathCarry(**{k: v.clone() for k, v in vars(c).items()})

    def k2_run(fn):
        def setup():
            c = clone(carry)
            return lambda: fn(c, *hit1, scene.triangles, scene.materials,
                              params, 1)
        return setup

    k2_ms = cuda_ms(k2_run(shade_mod.shade_full), 5)
    k2_plain_ms = cuda_ms(k2_run(shade_mod.shade_full_reference), 2)
    ck, cp = clone(carry), clone(carry)
    shade_mod.shade_full(ck, *hit1, scene.triangles, scene.materials,
                         params, 1)
    shade_mod.shade_full_reference(cp, *hit1, scene.triangles,
                                   scene.materials, params, 1)
    torch.cuda.synchronize()
    differ = sum(int((getattr(ck, k) != getattr(cp, k)).reshape(
        W * H, -1).any(-1).sum()) for k in ("state", "alive", "prev_prim"))
    call_err = max(float((getattr(ck, k) - getattr(cp, k)).abs().max())
                   for k in ("ray_o", "ray_d", "throughput", "radiance"))
    print(f"first bounce ({n_live} live of {W * H} lanes): K1 {k1_ms:.3f} ms "
          f"(plain {k1_plain_ms:.1f} ms, bit-exact); K2 {k2_ms:.3f} ms "
          f"(plain {k2_plain_ms:.1f} ms), K2 vs plain: max_abs_err "
          f"{call_err:.3e}, {differ} lanes with differing state/alive/prim "
          f"[{card}]")
    if differ > 1e-4 * W * H or not call_err <= 1e-4:
        raise AssertionError("K2 disagrees with its plain version")

    root = "metal_pathtracer_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        {"name": "trace_closest", "route": "cuda",
         "source": root + "traverse.cu",
         "replaces": "metal_pathtracer_tpu/ops/pallas/traverse.py:60",
         "launches": launches["trace_closest"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "shade_full", "route": "cuda",
         "source": root + "shade.cu",
         "replaces": "metal_pathtracer_tpu/ops/pallas/shade.py:1845",
         "launches": launches["shade_full"],
         "max_abs_err": max(k2_err, call_err),
         "ms": k2_ms, "plain_ms": k2_plain_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
