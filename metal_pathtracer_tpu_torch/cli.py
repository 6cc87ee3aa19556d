"""Headless CLI of the port (``cli.py`` twin), flag-compatible with the
reference's PathTracerHeadless (reference: src/main_headless.mm:75-107
for the flag set, :389-396 for the scene-vs-path heuristic, :552-559 for
the default output path).

    python -m metal_pathtracer_tpu_torch.cli --scene cornell --width 512 \\
        --height 512 --sppTotal 8

renders on the card and writes a multilayer EXR (``--format``: exr, png,
pfm, ppm). ``--backend`` takes the JAX package's names: ``cuda`` or the
reference's ``metal`` (the card), ``cpu``, ``oracle`` or ``embree`` (the
native C++ oracle, ``native/cpu_oracle.cpp``, built on first use), and
``cpu-torch`` (torch on the CPU, every kernel's plain version; the JAX
package's ``cpu-jax``). ``--enableEmbree 1`` is an alias of ``--backend
cpu``; ``--threads`` sets the oracle's worker threads.
``--enableSoftwareRayTracing`` is accepted and ignored.
"""

from __future__ import annotations

import argparse
import os
import sys

from metal_pathtracer_tpu_torch.renderer.accumulation import CheckpointError
from metal_pathtracer_tpu_torch.renderer.headless import (
    OracleBackend,
    make_backend,
)
from metal_pathtracer_tpu_torch.scene import dsl
from metal_pathtracer_tpu_torch.scene.manager import SceneManager
from metal_pathtracer_tpu_torch.settings import RenderSettings
from metal_pathtracer_tpu_torch.utils import image_io


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpt-headless-torch",
        description="path tracer on PyTorch + CUDA, headless batch renderer")
    p.add_argument("--scene", default="",
                   help="scene name or path to .scene file")
    p.add_argument("--output", default="", help="output image path")
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--sppTotal", type=int, default=1024)
    p.add_argument("--maxDepth", type=int, default=0)
    p.add_argument("--threads", type=int, default=0,
                   help="CPU oracle worker threads (0: all cores)")
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--envRotation", type=float, default=None)
    p.add_argument("--envIntensity", type=float, default=None)
    p.add_argument("--tonemap", type=int, default=0)
    p.add_argument("--exposure", type=float, default=None)
    p.add_argument("--enableSoftwareRayTracing", type=int, default=None,
                   help="accepted for compatibility; ignored")
    p.add_argument("--enableMnee", type=int, default=None)
    p.add_argument("--format", default="",
                   choices=["", "exr", "png", "pfm", "ppm"])
    p.add_argument("--backend", default="cuda",
                   help="cuda | metal (the card), cpu | oracle | embree "
                   "(the native CPU oracle), cpu-torch (torch on the CPU)")
    p.add_argument("--enableEmbree", type=int, default=None,
                   help="compat alias: use the CPU oracle backend")
    p.add_argument("--checkpoint", default="",
                   help="render-state checkpoint path (resume if it exists)")
    p.add_argument("--verbose", action="store_true")
    return p


def resolve_scene(scene_arg: str, manager: SceneManager):
    """Scene-vs-path heuristic (reference: main_headless.mm:389-396):
    anything with a path separator or .scene suffix is a path; otherwise a
    scene name resolved against the assets directory."""
    if not scene_arg:
        return None
    if os.sep in scene_arg or scene_arg.endswith(".scene") \
            or os.path.exists(scene_arg):
        return scene_arg
    return manager.find_scene(scene_arg)


def default_output(scene_arg: str, width: int, height: int, fmt: str) -> str:
    """renders/<scene>_<WxH>.<ext> (reference: main_headless.mm:552-559)"""
    stem = os.path.splitext(os.path.basename(scene_arg or "default"))[0]
    os.makedirs("renders", exist_ok=True)
    return os.path.join("renders", f"{stem}_{width}x{height}.{fmt}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    settings = RenderSettings()
    manager = SceneManager()
    resources = manager.new_resources()

    scene_path = resolve_scene(args.scene, manager)
    if scene_path is None and args.scene:
        print(f"error: scene not found: {args.scene}", file=sys.stderr)
        return 1
    try:
        if scene_path is not None:
            manager.load_scene_from_path(scene_path, settings, resources)
        else:
            manager.load_default_scene(settings, resources)
    except (dsl.SceneParseError, OSError, NotImplementedError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1

    # CLI overrides (reference: main_headless.mm ApplyCliOverrides:418-449)
    if args.maxDepth > 0:
        settings.maxDepth = args.maxDepth
    if args.seed >= 0:
        settings.fixedRngSeed = args.seed
    if args.envRotation is not None:
        settings.environmentRotation = args.envRotation
    if args.envIntensity is not None:
        settings.environmentIntensity = args.envIntensity
    if args.tonemap > 0:
        settings.tonemapMode = max(1, min(args.tonemap, 4))
    if args.exposure is not None:
        settings.exposure = args.exposure
    if args.enableMnee is not None:
        settings.enableMnee = bool(args.enableMnee)

    width = args.width or settings.renderWidth or 1280
    height = args.height or settings.renderHeight or 720

    backend_name = "cpu" if args.enableEmbree else args.backend
    try:
        backend = make_backend(backend_name)
    except (ValueError, RuntimeError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1

    fmt = args.format or "exr"
    output = args.output or default_output(args.scene, width, height, fmt)
    extra = {"n_threads": args.threads} \
        if isinstance(backend, OracleBackend) else {}
    try:
        out = backend.render(resources, settings, width, height,
                             args.sppTotal, verbose=args.verbose,
                             checkpoint_path=args.checkpoint, **extra)
    except (CheckpointError, NotImplementedError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1

    tm = image_io.TonemapSettings(
        tonemapMode=settings.tonemapMode, acesVariant=settings.acesVariant,
        exposure=settings.exposure,
        reinhardWhitePoint=settings.reinhardWhitePoint)
    if fmt == "exr":
        image_io.write_exr_multilayer(
            output, out.linear_rgb, albedo=out.albedo, normal=out.normal,
            samples=out.sample_count)
    else:
        image_io.write_image(output, out.linear_rgb, fmt, tm)

    print(f"Rendered {out.samples} spp at {out.width}x{out.height} in "
          f"{out.total_seconds:.2f} s (~{out.avg_ms_per_sample:.2f} ms/sample)")
    print(f"[Output] {output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
