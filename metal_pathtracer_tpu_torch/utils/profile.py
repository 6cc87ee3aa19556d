"""Where the time goes: a ``torch.profiler`` trace of the port on one card.

Renders the textured headline (default), the untextured headline or the
lambert series at 1920x1080 d8, the refdefault cell (the headline at
1280x720 d20), the Cornell box (512x512 d8), the rtow sphere field
(1200x675 d50), the material zoo (``materials``, ``materials-env-rw``
at 960x320 d8, ``cornell-emitenv`` at 512x512 d8), the headline and the
Cornell box with MNEE on (``headline-mnee``, ``cornell-mnee``), or the
headline loaded from mesh files (``mesh-files``: PLY, OBJ and GLB
written by ``utils/meshfiles.write_headline_files`` into a temporary
directory and read through a ``.scene`` of ``mesh`` records): one
warm-up sample,
then two samples under the profiler. Prints the wall time per sample,
the device's busy share of the wall time, device time by kernel (the
port's kernels by name, the rest of the torch glue summed), the kernels'
launch counts, and in a scene with a random walk the walk pre-stage's
wall time and the K3a launches inside it (a second pass without the
profiler, each walk synchronised before and after).
Run on a machine with a CUDA device:

    python -m metal_pathtracer_tpu_torch.utils.profile \
        [--scene headline|untextured|lambert|refdefault|cornell|rtow|
                 materials|materials-env-rw|cornell-emitenv|
                 headline-mnee|cornell-mnee|mesh-files]
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

WIDTH, HEIGHT, SPP = 1920, 1080, 2
PORT_KERNELS = ("trace_closest_kernel", "trace_any_kernel",
                "live_lanes_kernel", "shade_full_kernel",
                "shade_full_sparse_kernel", "full_list_kernel",
                "shade_full_buckets_kernel", "shade_s1_kernel",
                "s2_list_kernel", "shade_s2_kernel", "shade_s2_lanes_kernel",
                "texture_stage_kernel", "sphere_nearest_kernel",
                "chunked_list_kernel", "sphere_nearest_chunked_kernel",
                "rect_nearest_kernel")


def _scene(name: str, dev):
    from metal_pathtracer_tpu_torch.utils import benchscene

    if name == "mesh-files":
        import tempfile

        from metal_pathtracer_tpu_torch.ops import env as env_ops
        from metal_pathtracer_tpu_torch.scene import dsl
        from metal_pathtracer_tpu_torch.scene.resources import SceneResources
        from metal_pathtracer_tpu_torch.settings import RenderSettings
        from metal_pathtracer_tpu_torch.utils import meshfiles

        settings, res = RenderSettings(), SceneResources()
        with tempfile.TemporaryDirectory() as tmp:
            path, _ = meshfiles.write_headline_files(tmp, 8, dev)
            dsl.load_scene_file(path, settings, res)
            env = env_ops.load_environment(settings.environmentMapPath, dev)
        return settings, res, res.build_arrays(environment=env, device=dev)
    if name in ("headline-mnee", "cornell-mnee"):
        settings, res, scene = _scene(name[:-len("-mnee")], dev)
        settings.enableMnee = True
        return settings, res, scene
    if name == "cornell":
        settings, res = benchscene.build_cornell_scene()
        env = None
    elif name == "materials":
        settings, res = benchscene.build_materials_scene()
        env = None
    elif name == "materials-env-rw":
        settings, res, env = benchscene.build_materials_env_rw_scene(dev)
    elif name == "cornell-emitenv":
        settings, res, env = benchscene.build_cornell_emitenv_scene(dev)
    elif name == "rtow":
        settings, res = benchscene.build_rtow_scene()
        env = None
    elif name == "lambert":
        settings, res = benchscene.build_lambert_series(7)
        env = None
    elif name == "untextured":
        settings, res, env = benchscene.build_untextured_bench_scene(8, dev)
    elif name == "refdefault":
        settings, res, env = benchscene.build_refdefault_scene(8, dev)
    else:
        settings, res, env = benchscene.build_bench_scene(8, dev)
    return settings, res, res.build_arrays(environment=env, device=dev)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--scene",
                        choices=["headline", "untextured", "lambert",
                                 "refdefault", "cornell", "rtow",
                                 "materials", "materials-env-rw",
                                 "cornell-emitenv", "headline-mnee",
                                 "cornell-mnee", "mesh-files"],
                        default="headline")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from metal_pathtracer_tpu_torch.ops.camera import build_camera
    from metal_pathtracer_tpu_torch.renderer import frame
    from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
    from metal_pathtracer_tpu_torch.schema import (
        settings_to_static,
        settings_to_uniforms,
    )
    from metal_pathtracer_tpu_torch.utils import benchscene

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    settings, res, scene = _scene(args.scene, dev)
    w, h = {"refdefault": benchscene.REFDEFAULT_FRAME,
            "cornell": benchscene.CORNELL_FRAME,
            "cornell-mnee": benchscene.CORNELL_FRAME,
            "cornell-emitenv": benchscene.CORNELL_FRAME,
            "materials": benchscene.MATERIALS_FRAME,
            "materials-env-rw": benchscene.MATERIALS_FRAME,
            "rtow": benchscene.RTOW_FRAME}.get(args.scene, (WIDTH, HEIGHT))
    static = settings_to_static(settings, w, h, res.material_types_present(),
                                res.texture_slots_present(),
                                res.texture_uses_uv1())
    uni = settings_to_uniforms(settings, build_camera(settings, w, h, dev),
                               0, 0)
    frame.render_samples(scene, uni, RenderState.create(w, h, dev), static, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        st = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                  static, SPP)
        torch.cuda.synchronize()
        wall = time.time() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = {e.key: (e.device_time_total, e.count) for e in events}
    total_dev = sum(t for t, _ in dev_us.values())
    port = {k: v for k, v in dev_us.items()
            if any(name in k for name in PORT_KERNELS)}
    glue = total_dev - sum(t for t, _ in port.values())
    n_glue = sum(c for k, (_, c) in dev_us.items() if k not in port)
    print(f"{args.scene} {w}x{h} d{static.max_depth}, {SPP} spp under "
          f"the profiler: {1e3 * wall / SPP:.2f} ms/spp wall, device "
          f"busy {100.0 * total_dev / 1e6 / wall:.1f} % of the wall time, "
          f"{st.ray_count} closest + {st.shadow_ray_count} shadow traces "
          f"[{card}]")
    for k, (t, c) in sorted(port.items(), key=lambda kv: -kv[1][0]):
        name = max((n for n in PORT_KERNELS if n in k), key=len)
        print(f"  {name}: {t / 1e3 / SPP:.3f} ms/spp device, "
              f"{c / SPP:.0f} launches/spp")
    print(f"  torch glue: {glue / 1e3 / SPP:.3f} ms/spp device, "
          f"{n_glue / SPP:.0f} launches/spp")
    top = sorted(((t, c, k) for k, (t, c) in dev_us.items()
                  if k not in port), reverse=True)[:12]
    for t, c, k in top:
        print(f"    {t / 1e3 / SPP:8.3f} ms/spp {c / SPP:7.0f}x "
              f"{k[:90]}")
    if static.sss_mode == 2:
        _walk_share(scene, uni, static, w, h, dev)


def _walk_share(scene, uni, static, w, h, dev):
    """The random-walk pre-stage's share of a sample's wall time: its
    calls synchronised and timed on the host clock, and the K3a launches
    inside them, over ``SPP`` samples."""
    from metal_pathtracer_tpu_torch.ops.kernels import primitives, shade
    from metal_pathtracer_tpu_torch.renderer import frame
    from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState

    real = shade.random_walks
    spent = {"s": 0.0, "k3": 0, "calls": 0, "lanes": 0}

    def timed(*args):
        torch.cuda.synchronize()
        before = primitives.sphere_nearest_brute.launches \
            + primitives.sphere_nearest_chunked.launches
        t0 = time.time()
        out = real(*args)
        torch.cuda.synchronize()
        spent["s"] += time.time() - t0
        spent["k3"] += primitives.sphere_nearest_brute.launches \
            + primitives.sphere_nearest_chunked.launches - before
        spent["calls"] += 1
        spent["lanes"] += int((out[0][:, 0] > 0.5).sum())
        return out

    shade.random_walks = timed
    try:
        t0 = time.time()
        frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                             static, SPP)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        shade.random_walks = real
    print(f"  random-walk pre-stage: {1e3 * spent['s'] / SPP:.1f} ms/spp "
          f"wall of {1e3 * wall / SPP:.1f} ms/spp, {spent['calls'] / SPP:.0f}"
          f" calls/spp over {spent['lanes'] / SPP:.0f} walk lanes/spp, "
          f"{spent['k3'] / SPP:.0f} K3 launches/spp inside it")


if __name__ == "__main__":
    main()
