"""Parent-against-change timing on the card, two checkouts alternating.

Runs one measurement from two checkouts in separate, alternating
processes (by default parent, change, change, parent, parent, change).
Each process builds its own checkout's kernels and is timed with the
change's ``chip_smoke.py`` helpers, so both sides are measured alike:

- ``lambert``: ``chip_smoke.py``'s lambert phase of the checkout, then
  four more timed 4 spp renders at 1920x1080 d8; every ms/spp, with K2
  ``full``'s device time at the first bounce beside its window around the
  wrapper;
- ``k1``: K1 closest-hit and any-hit on the textured headline's
  wavefronts (1920x1080, 1,310,720-triangle displaced icosphere): the
  closest and environment shadow wavefronts of depths 0 and 1, kept from
  one sample of the checkout's own frame loop (``chip_smoke.py
  frame_loop_k1``), each timed three times with ``kernel_ms`` (device
  time of 5 launches back to back); the trace kernels' registers;
- ``ki`` and ``kiany``: the instanced K1, closest-hit or any-hit, on
  the depth-0 and depth-1 wavefronts of the instanced headline and the
  instanced grid (1920x1080; ``chip_smoke.py frame_loop_inst``), each
  timed three times with ``kernel_ms``, with a SHA-256 of each result
  that must agree over every process and the kernels' registers;
- ``s1``, ``s2`` and ``tex``: K2 stage s1, K2 stage s2 or the texture
  stage on the textured headline's wavefronts at the depths ``--depths``
  names (default 0, 1 and 5: the first, the second, a late one), kept
  from one sample of the checkout's own frame loop (``chip_smoke.py
  frame_loop_k2``), each timed three times with ``kernel_ms``; the
  kernel's registers and spill bytes. Each process prints a SHA-256 of
  each wavefront's result (the (N, k) output made contiguous, then the
  carry with its state: ``chip_smoke.py k2_digest``), and the run fails
  unless the digests of every process agree. A texture wrapper that reads
  the camera back on every call (before the stage took its launch
  constants from the caller) is timed with those constants computed once
  per depth;
- ``s2zoo``: K2 s2's extended instantiation the same way on
  materials-env-rw's wavefronts (``materials.scene`` at 960x320 under
  the HDR sky, the random walk's planes);
- ``full``, ``fullzoo`` and ``fulllambert``: K2 stage full on rtow
  (1200x675, 487 spheres, ~44 depths), on ``materials.scene`` (960x320;
  the extended instantiation) or on the lambert series (1920x1080, 8
  depths), every depth of one sample kept by the change's ``chip_smoke.py
  frame_loop_full`` and timed three times with ``kernel_ms``, through the
  wrapper as the frame loop calls it; medians at the depths ``--depths``
  names (default 0, 1 and 5) and of the sample's sum; each depth's lanes
  (``chip_smoke.py full_counts``) and bound; a SHA-256 of the carry after
  each named depth, which must agree over every process; the registers
  and spill bytes of the stage-full kernels;
- ``k3b``: K3b on rtow's 1200x675 closest-hit wavefronts (487 spheres)
  at the depths ``--depths`` names (default 0 and 1), kept from one
  sample of the checkout's own frame loop (``chip_smoke.py
  frame_loop_k3b``), each timed three times with ``kernel_ms``; a
  SHA-256 of each wavefront's (t, index), which must agree over every
  process; the sphere kernels' registers and spill bytes.
- ``k3c`` and ``k3a``: K3c at every launch of one sample of the Cornell
  box (512x512, six rectangles: the closest, shadow and spec-NEE chain
  rays of each depth, 24 launches), or K3a at every launch of one sample
  of materials-env-rw (960x320, eight spheres; ~217 launches, ~193 of
  them the random walk's), kept by the change's ``chip_smoke.py
  frame_loop_k3``, each timed three times with ``kernel_ms``: every K3c
  launch and K3a's first, the sums by call (closest, shadow, chain,
  walk) and a sample; a SHA-256 of each launch's (t, index), which must
  agree over every process; the kernel's registers and spill bytes.
- ``atrous``: the à-trous kernel at every iteration of ``chip_smoke.py
  ATROUS_CASES`` (fixed x4, SVGF x4, learned x4 and x5) on the 1080p
  facade state (the mesh-files scene, ``FACADE_FRAMES`` ``draw_frame(1)``
  through the checkout's ``Renderer``), each iteration kept from the
  checkout's own filter (``atrous_step``, or ``atrous_step_packed`` where
  the checkout packs its rows) and timed three times with ``kernel_ms``
  (20 launches back to back), with each filter's sum and, where there is
  one, its pack launch; a SHA-256 of the state and of each iteration's
  colour and variance, which must agree over every process; the
  kernels' registers and spill bytes and their tap loops' instruction
  counts (``chip_smoke.py atrous_sass``).
- ``atrousgrad``: the learned iteration's backward kernels (taps, gather,
  sum, and the three through ``atrous_step_grad``) at 64x64, 96x96 and
  1920x1080 on ``chip_smoke.py grad_state``, each launch kept from the
  checkout's own 4-iteration filter's backward (the vendored weights,
  ``chip_smoke.py learned_grads``) and timed three times with
  ``kernel_ms`` (10 launches back to back), the mean over the 4
  iterations; the kernels' registers and spill bytes. Each process prints
  a SHA-256 of the filter's gradients (colour, variance, MLP), which must
  agree over the processes of each side (two launches give the same
  bits) but may differ between the sides (sums in another order), and
  saves them: the change's relative-norm distance from the parent's
  closes the output.

Make the parent's checkout with ``git archive`` into a git-ignored
directory, then::

    python3 metal_pathtracer_tpu_torch/utils/ab.py \
        {lambert,k1,ki,kiany,s1,s2,s2zoo,tex,k3a,k3b,k3c,full,fullzoo,
         fulllambert,atrous,atrousgrad} \
        PARENT CHANGE

Lines starting with ``AB`` carry the numbers; per series, the medians and
quartiles of each side and the parent/change ratio of the medians close
the output, after the digest check.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import traceback

RENDERS, RENDER_SPP, FRAME = 4, 4, (1920, 1080)
K1_REPS = 3
#: ``atrousgrad``'s sizes (width, height): the tap trainer's, the U-Net
#: trainer's, 1080p
GRAD_AB_SIZES = ((64, 64), (96, 96), (1920, 1080))
#: the gradients ``atrousgrad`` digests and compares, and the keys of
#: ``chip_smoke.py learned_grads``' result they are made of
GRAD_AB_OUTPUTS = {"d_mlp": slice(0, 4), "d_color": slice(4, 5),
                   "d_var": slice(5, 6)}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def child_lambert(timer, depths):
    """The lambert phase of the checkout's ``chip_smoke.py`` with its own
    package, K2 ``full`` timed by ``timer``'s ``kernel_ms``."""
    import torch

    c = _load("chip_smoke", "chip_smoke.py")
    new = _load("chip_smoke_timer", timer)
    from metal_pathtracer_tpu_torch.ops.kernels import build
    from metal_pathtracer_tpu_torch.ops.kernels import shade as S
    from metal_pathtracer_tpu_torch.ops.kernels import traverse as T
    from metal_pathtracer_tpu_torch.renderer.headless import CudaBackend
    from metal_pathtracer_tpu_torch.utils.benchscene import (
        build_lambert_series,
    )
    window = c.cuda_ms

    def k2_timed(prepare, reps):
        if reps != 5:   # the lambert phase times K2 full with 5 runs
            return window(prepare, reps)
        d, w = new.kernel_ms(prepare, reps), window(prepare, reps)
        print(f"AB K2 full first bounce: {d:.4f} ms on the device, "
              f"{w:.4f} ms around the wrapper", flush=True)
        return w

    c.cuda_ms = k2_timed
    if hasattr(c, "timed"):
        c.timed = lambda prepare, reps: (new.kernel_ms(prepare, reps),
                                         k2_timed(prepare, reps))
    build.load()
    kernels = {"trace_closest": T.trace_closest, "trace_any": T.trace_any,
               "shade_full": S.shade_full, "shade_s1": S.shade_s1,
               "shade_s2": S.shade_s2}
    dev = torch.device("cuda", 0)
    c.lambert_path(dev, c.device_line(), kernels, {})
    settings, resources = build_lambert_series(c.LAMBERT_SUBDIVISIONS)
    backend = CudaBackend()
    backend.render(resources, settings, *FRAME, 1, device=dev)
    for rep in range(RENDERS):
        res = backend.render(resources, settings, *FRAME, RENDER_SPP,
                             device=dev)
        print(f"AB lambert {FRAME[0]}x{FRAME[1]} d8 rep {rep}: "
              f"{res.avg_ms_per_sample:.2f} ms/spp", flush=True)


def child_k1(timer, depths):
    """K1 of the checkout's package on the headline's wavefronts, kept
    from its frame loop and timed by ``timer``'s helpers."""
    import torch

    c = _load("chip_smoke_timer", timer)
    from metal_pathtracer_tpu_torch.ops.kernels import build
    from metal_pathtracer_tpu_torch.ops.kernels import traverse as T
    from metal_pathtracer_tpu_torch.utils import benchscene

    build.load()
    regs = build.register_counts(build.build_log())
    print("AB registers " + json.dumps(
        {k: v for k, v in sorted(regs.items()) if k.startswith("trace")}),
        flush=True)
    dev = torch.device("cuda", 0)
    settings, res, env = benchscene.build_bench_scene(
        c.HEADLINE_SUBDIVISIONS, dev)
    scene = res.build_arrays(environment=env, device=dev)
    static, uni = c.scene_setup(settings, res, *c.FRAME, dev)
    _, waves = c.frame_loop_k1(scene, uni, static, dev,
                               keep=tuple(c.K1_WAVES.values()))
    card = c.device_line()
    for rep in range(K1_REPS):
        for name, key in c.K1_WAVES.items():
            args = waves[key]
            fn = T.trace_closest if key[0] == "closest" else T.trace_any
            ms = c.kernel_ms(lambda: lambda: fn(*args), 5)
            print(f"AB {name} rep {rep}: {ms:.4f} ms [{card}]", flush=True)


def child_ki(which, timer, depths):
    """The instanced K1 of the checkout's package (``ki``: closest-hit,
    ``kiany``: any-hit) on the depth-0 and depth-1 wavefronts of the
    instanced headline and of the instanced grid (1920x1080, the
    1,310,720-triangle displaced icosphere placed 3 and 64 times, the
    glass icosphere 2 and 16 times), kept from one sample of the
    checkout's own frame loop (``chip_smoke.py frame_loop_inst``: the
    closest-hit launches 0 and 1, the environment shadow launches 0 and
    2), each timed three times with ``kernel_ms``; a SHA-256 of each
    wavefront's result, which must agree over every process; the
    instanced kernels' registers and spill bytes. The grid's ``.scene``
    comes from the change's ``utils/meshfiles.py`` (the timer's tree);
    ``depths`` is not used."""
    import hashlib
    import tempfile

    import torch

    c = _load("chip_smoke_timer", timer)
    meshfiles_change = _load("meshfiles_change", os.path.join(
        os.path.dirname(timer), "metal_pathtracer_tpu_torch", "utils",
        "meshfiles.py"))
    from metal_pathtracer_tpu_torch.ops import env as env_ops
    from metal_pathtracer_tpu_torch.ops.kernels import build
    from metal_pathtracer_tpu_torch.ops.kernels import traverse as T
    from metal_pathtracer_tpu_torch.scene import dsl
    from metal_pathtracer_tpu_torch.scene.resources import SceneResources
    from metal_pathtracer_tpu_torch.settings import RenderSettings
    from metal_pathtracer_tpu_torch.utils import meshfiles

    build.load()
    registers(c, build, "trace_instanced")
    dev = torch.device("cuda", 0)
    key = "closest" if which == "ki" else "any"
    fn = T.trace_instanced_closest if key == "closest" else \
        T.trace_instanced_any
    card = c.device_line()
    kept = {}
    with tempfile.TemporaryDirectory() as tmp:
        meshfiles.write_headline_files(tmp, c.HEADLINE_SUBDIVISIONS, dev)
        with open(os.path.join(tmp, "instanced_grid.scene"), "w") as fh:
            fh.write(meshfiles_change.instanced_scene_text(variant="grid"))
        for cell in ("headline", "grid"):
            settings, res = RenderSettings(), SceneResources()
            dsl.load_scene_file(os.path.join(tmp, f"instanced_{cell}.scene"),
                                settings, res)
            env = env_ops.load_environment(settings.environmentMapPath, dev)
            scene = res.build_arrays(environment=env, device=dev)
            static, uni = c.scene_setup(settings, res, *c.FRAME, dev)
            launches = (0, 1) if key == "closest" else (0, 2)
            live, waves = c.frame_loop_inst(
                scene, uni, static, dev, keep=tuple((key, k)
                                                    for k in launches))
            for depth, k in enumerate(launches):
                args = waves[key, k] if key == "closest" else \
                    waves[key, k][:5]
                h = hashlib.sha256()
                out = fn(*args)
                for x in (out if isinstance(out, tuple) else (out,)):
                    h.update(x.contiguous().cpu().numpy().tobytes())
                name = f"{which} {cell} depth {depth}"
                print(f"AB lanes {name}: {live[key][k]} live, "
                      f"{scene.n_instances} placements", flush=True)
                print(f"AB digest {name}: {h.hexdigest()}", flush=True)
                kept[name] = args
    for rep in range(K1_REPS):
        for name, args in kept.items():
            ms = c.kernel_ms(lambda: lambda: fn(*args), 5)
            print(f"AB {name} rep {rep}: {ms:.4f} ms [{card}]", flush=True)


def registers(c, build, prefix):
    """The registers and spill bytes of the checkout's kernels whose names
    start with ``prefix`` (a string or a tuple of them), from its build
    log."""
    print("AB registers, spill bytes " + json.dumps(
        {k: v for k, v in sorted(c.kernel_resources(build.build_log())
                                 .items()) if k.startswith(prefix)}),
          flush=True)


def child_k2(which, timer, depths):
    """K2 s1, K2 s2 or the texture stage of the checkout's package on the
    headline's wavefronts (``s2zoo``: s2 on materials-env-rw's) at
    ``depths``, kept from its frame loop and timed by ``timer``'s
    helpers."""
    import torch

    c = _load("chip_smoke_timer", timer)
    from metal_pathtracer_tpu_torch.ops.kernels import build
    from metal_pathtracer_tpu_torch.ops.kernels import texture as X
    from metal_pathtracer_tpu_torch.utils import benchscene

    build.load()
    stage = "s2" if which == "s2zoo" else which
    registers(c, build, {"s1": "shade_s1", "s2": "shade_s2",
                         "tex": "texture_stage"}[stage])
    if hasattr(X, "_scalars"):
        # this texture wrapper reads the camera back on every call: its
        # constants, once per depth (the frame loop below computes them)
        computed, scalars = {}, X._scalars

        def once(uniforms, static, textures, depth):
            if depth not in computed:
                computed[depth] = scalars(uniforms, static, textures, depth)
            return computed[depth]
        X._scalars = once
    dev = torch.device("cuda", 0)
    if which == "s2zoo":
        settings, res, env = benchscene.build_materials_env_rw_scene(dev)
        size = benchscene.MATERIALS_FRAME
    else:
        settings, res, env = benchscene.build_bench_scene(
            c.HEADLINE_SUBDIVISIONS, dev)
        size = c.FRAME
    scene = res.build_arrays(environment=env, device=dev)
    static, uni = c.scene_setup(settings, res, *size, dev)
    rows, kept = c.frame_loop_k2(scene, uni, static, dev, keep=depths)
    card = c.device_line()
    for depth in depths:
        out, carry = c.k2_once(kept, stage, depth)
        print(f"AB lanes {which} depth {depth}: {json.dumps(rows[depth])}",
              flush=True)
        print(f"AB digest {which} depth {depth}: "
              f"{c.k2_digest(out, carry)}", flush=True)
    for rep in range(K1_REPS):
        for depth in depths:
            ms = c.kernel_ms(c.k2_launch(kept, stage, depth), 5)
            print(f"AB {which} depth {depth} rep {rep}: {ms:.4f} ms "
                  f"[{card}]", flush=True)


def child_full(which, timer, depths):
    """K2 stage full of the checkout's package at every depth of one
    sample of rtow, materials or the lambert series, kept by ``timer``'s
    frame loop and timed by its helpers."""
    import torch

    c = _load("chip_smoke_timer", timer)
    from metal_pathtracer_tpu_torch.ops.kernels import build
    from metal_pathtracer_tpu_torch.ops.kernels import shade as S
    from metal_pathtracer_tpu_torch.utils import benchscene as B

    build.load()
    registers(c, build, ("shade_full", "full_list"))
    dev = torch.device("cuda", 0)
    settings, res = {"full": lambda: B.build_rtow_scene(c.RTOW_SEED),
                     "fullzoo": B.build_materials_scene,
                     "fulllambert": lambda: B.build_lambert_series(
                         c.LAMBERT_SUBDIVISIONS)}[which]()
    size = {"full": B.RTOW_FRAME, "fullzoo": B.MATERIALS_FRAME,
            "fulllambert": c.FRAME}[which]
    scene = res.build_arrays(device=dev)
    static, uni = c.scene_setup(settings, res, *size, dev)
    kept = c.frame_loop_full(scene, uni, static, dev)
    card = c.device_line()

    def launch(args, kw):
        def prepare():
            carry = c.clone(args[0])
            return lambda: S.shade_full(carry, *args[1:], **kw)
        return prepare

    table = scene.materials.count * len(S.MAT_COLS) * 4
    for depth, (args, kw) in enumerate(kept):
        cnt = c.full_counts(scene, args[0], args[2], kw.get("kind"))
        bound, _ = c.full_bound(cnt, table)
        old, _ = c.full_bound(cnt, table, c.K2_FULL_BEFORE)
        print(f"AB lanes {which} depth {depth}: {json.dumps(cnt)}, bound "
              f"{bound:.4f} ms ({old:.4f} at K2_FULL_BEFORE)", flush=True)
        if depth in depths:
            carry = c.clone(args[0])
            S.shade_full(carry, *args[1:], **kw)
            print(f"AB digest {which} depth {depth}: "
                  f"{c.k2_digest(None, carry)}", flush=True)
    for rep in range(K1_REPS):
        total = 0.0
        for depth, (args, kw) in enumerate(kept):
            ms = c.kernel_ms(launch(args, kw), 5)
            total += ms
            if depth in depths:
                print(f"AB {which} depth {depth} rep {rep}: {ms:.4f} ms "
                      f"[{card}]", flush=True)
        print(f"AB {which} sample of {len(kept)} depths rep {rep}: "
              f"{total:.4f} ms [{card}]", flush=True)


def child_k3b(timer, depths):
    """K3b of the checkout's package on rtow's closest-hit wavefronts at
    ``depths``, kept from its frame loop and timed by ``timer``'s
    helpers."""
    import hashlib

    import torch

    c = _load("chip_smoke_timer", timer)
    from metal_pathtracer_tpu_torch.ops.kernels import build
    from metal_pathtracer_tpu_torch.ops.kernels import primitives as P
    from metal_pathtracer_tpu_torch.utils import benchscene

    build.load()
    registers(c, build, "sphere_nearest")
    dev = torch.device("cuda", 0)
    settings, res = benchscene.build_rtow_scene(c.RTOW_SEED)
    scene = res.build_arrays(device=dev)
    static, uni = c.scene_setup(settings, res, *benchscene.RTOW_FRAME, dev)
    kept = c.frame_loop_k3b(scene, uni, static, dev)
    card = c.device_line()
    for depth in depths:
        h = hashlib.sha256()
        for x in P.sphere_nearest_chunked(*kept[depth]):
            h.update(x.contiguous().cpu().numpy().tobytes())
        print(f"AB digest k3b depth {depth}: {h.hexdigest()}", flush=True)
    for rep in range(K1_REPS):
        for depth in depths:
            args = kept[depth]
            ms = c.kernel_ms(lambda: lambda: P.sphere_nearest_chunked(*args),
                             5)
            print(f"AB k3b depth {depth} rep {rep}: {ms:.4f} ms [{card}]",
                  flush=True)


def child_k3(which, timer, depths):
    """K3c (``k3c``: every launch of one Cornell box sample) or K3a
    (``k3a``: every launch of one materials-env-rw sample, the random
    walk's included) of the checkout's package, kept by ``timer``'s
    ``frame_loop_k3`` and timed by its helpers; ``depths`` is not used."""
    import hashlib

    import torch

    c = _load("chip_smoke_timer", timer)
    from metal_pathtracer_tpu_torch.ops.kernels import build
    from metal_pathtracer_tpu_torch.ops.kernels import primitives as P
    from metal_pathtracer_tpu_torch.utils import benchscene as B

    build.load()
    name = {"k3c": "rect_nearest", "k3a": "sphere_nearest_brute"}[which]
    registers(c, build, name.replace("_brute", "_kernel"))
    dev = torch.device("cuda", 0)
    if which == "k3c":
        (settings, res), env = B.build_cornell_scene(), None
        size = B.CORNELL_FRAME
    else:
        settings, res, env = B.build_materials_env_rw_scene(dev)
        size = B.MATERIALS_FRAME
    scene = res.build_arrays(environment=env, device=dev)
    static, uni = c.scene_setup(settings, res, *size, dev)
    kept = c.frame_loop_k3(scene, uni, static, dev, name)
    fn = getattr(P, name)
    card = c.device_line()
    for k, (kind, args) in enumerate(kept):
        h = hashlib.sha256()
        for x in fn(*args):
            h.update(x.contiguous().cpu().numpy().tobytes())
        print(f"AB digest {which} launch {k:03d} ({kind}): {h.hexdigest()}",
              flush=True)
    for rep in range(K1_REPS):
        sums = {}
        for k, (kind, args) in enumerate(kept):
            ms = c.kernel_ms(lambda: lambda: fn(*args), 5)
            sums[kind] = sums.get(kind, 0.0) + ms
            if which == "k3c" or k == 0:
                print(f"AB {which} launch {k:03d} ({kind}) rep {rep}: "
                      f"{ms:.4f} ms [{card}]", flush=True)
        for kind, ms in sums.items():
            print(f"AB {which} {kind} launches of a sample rep {rep}: "
                  f"{ms:.4f} ms [{card}]", flush=True)
        print(f"AB {which} sample of {len(kept)} launches rep {rep}: "
              f"{sum(sums.values()):.4f} ms [{card}]", flush=True)


def child_atrous(timer, depths):
    """The à-trous kernel of the checkout's package at every iteration of
    ``ATROUS_CASES`` on the 1080p facade state, kept from its own filters
    and timed by ``timer``'s helpers; ``depths`` is not used."""
    import hashlib
    import tempfile
    from unittest import mock

    import torch

    c = _load("chip_smoke_timer", timer)
    from metal_pathtracer_tpu_torch.ops import denoise as D
    from metal_pathtracer_tpu_torch.ops.kernels import build
    from metal_pathtracer_tpu_torch.ops.kernels import denoise as DK
    from metal_pathtracer_tpu_torch.renderer.renderer import Renderer
    from metal_pathtracer_tpu_torch.utils import meshfiles

    build.load()
    registers(c, build, "atrous")
    print(f"AB sass {c.atrous_sass()}", flush=True)
    dev = torch.device("cuda", 0)
    card = c.device_line()
    with tempfile.TemporaryDirectory() as tmp:
        meshfiles.write_headline_files(tmp, c.HEADLINE_SUBDIVISIONS, dev)
        r = Renderer(*c.FRAME)
        r.load_scene_from_path(os.path.join(tmp, "mesh_files.scene"))
        for _ in range(c.FACADE_FRAMES):
            r.draw_frame(1)
    st = r.state

    def digest(*xs):
        h = hashlib.sha256()
        for x in xs:
            if x is not None:
                h.update(x.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()

    state = digest(st.radiance_sum, st.radiance_sq_sum, st.albedo,
                   st.normal)
    print(f"AB digest state: {state}", flush=True)
    var = st.variance_of_mean()
    tparams = D._learned_params(dev)
    args = (st.present(), st.albedo, st.normal)
    packed = hasattr(DK, "atrous_step_packed")
    name = "atrous_step_packed" if packed else "atrous_step"
    real = getattr(DK, name)
    kept = {}
    for mode, iters in c.ATROUS_CASES:
        cell = kept.setdefault(f"{mode} x{iters}", [])

        def keep(*a, **k):
            cell.append((a, k))
            return real(*a, **k)

        # a wrapper that counts on the name it is reached by
        keep.launches = getattr(real, "launches", 0)
        with mock.patch.object(DK, name, keep):
            if mode == "fixed":
                D.atrous_denoise(*args, iterations=iters)
            elif mode == "svgf":
                D.svgf_denoise(*args, var, iterations=iters)
            else:
                D.learned_denoise(*args, var, tparams, iterations=iters)
        for it, (a, k) in enumerate(cell):
            out = real(*a, **k)
            if not isinstance(out, tuple):     # the carried float4s
                out = (out[..., :3], out[..., 3])
            print(f"AB digest atrous {mode} x{iters} iteration {it}: "
                  f"{digest(out[0], None if mode == 'fixed' else out[1])}",
                  flush=True)
    for rep in range(K1_REPS):
        for cell, launches in kept.items():
            total = 0.0
            for a, k in launches:
                ms = c.kernel_ms(lambda: lambda: real(*a, **k), 20)
                total += ms
                step = (a[2] if packed else a[4]).step
                print(f"AB atrous {cell} step {step} rep {rep}: {ms:.4f} "
                      f"ms [{card}]", flush=True)
            if packed:
                cv = launches[0][0][0]
                col, v, alb, nrm = D.unpack(cv, launches[0][0][1])
                v = None if cell.startswith("fixed") else v
                ms = c.kernel_ms(lambda: lambda: DK.pack(col, v, alb, nrm),
                                 20)
                total += ms
                print(f"AB atrous {cell} pack rep {rep}: {ms:.4f} ms "
                      f"[{card}]", flush=True)
            print(f"AB atrous {cell} filter rep {rep}: {total:.4f} ms "
                  f"[{card}]", flush=True)


def child_atrousgrad(timer, depths):
    """The learned iteration's backward kernels of the checkout's package
    at ``GRAD_AB_SIZES``, kept from its own filters and timed by
    ``timer``'s helpers; the filters' gradients digested and saved to
    ``$AB_SAVE``; ``depths`` is not used."""
    import contextlib
    import hashlib
    from unittest import mock

    import numpy as np
    import torch

    c = _load("chip_smoke_timer", timer)
    from metal_pathtracer_tpu_torch.ops.kernels import build
    from metal_pathtracer_tpu_torch.ops.kernels import denoise as DK

    build.load()
    registers(c, build, "atrous_grad")
    dev = torch.device("cuda", 0)
    card = c.device_line()
    names = ("grad_taps", "grad_gather", "grad_sum", "atrous_step_grad")
    reals = {k: getattr(DK, k) for k in names}
    kept, saves = {}, {}
    for w, h in GRAD_AB_SIZES:
        calls = kept[f"{w}x{h}"] = {k: [] for k in names}

        def keeper(name, calls=calls):
            def keep(*a, **k):
                calls[name].append((a, k))
                return reals[name](*a, **k)
            # a wrapper that counts on the name it is reached by
            keep.launches = getattr(reals[name], "launches", 0)
            return keep

        with contextlib.ExitStack() as stack:
            for k in names:
                stack.enter_context(mock.patch.object(DK, k, keeper(k)))
            _, grads = c.learned_grads(c.vendored_mlp(dev),
                                       c.grad_state(h, w, dev), 4)
        for name, sl in GRAD_AB_OUTPUTS.items():
            x = torch.cat([g.detach().reshape(-1) for g in grads[sl]])
            x = x.cpu().numpy()
            saves[f"{w}x{h} {name}"] = x
            print(f"AB output {w}x{h} {name}: "
                  f"{hashlib.sha256(x.tobytes()).hexdigest()}", flush=True)
    if os.environ.get("AB_SAVE"):
        np.savez(os.environ["AB_SAVE"], **saves)
    for rep in range(K1_REPS):
        for size, calls in kept.items():
            for name in names:
                ms = sum(c.kernel_ms(lambda: lambda: reals[name](*a, **k), 10)
                         for a, k in calls[name]) / len(calls[name])
                print(f"AB atrousgrad {size} {name} rep {rep}: {ms:.4f} ms "
                      f"[{card}]", flush=True)


def lambert_value(line):
    m = re.search(r"([\d.]+) ms/spp", line)
    if m and line.startswith(("AB lambert", "lambert")):
        return "lambert 1920x1080 d8 ms/spp", float(m.group(1))
    return None


def k1_value(line):
    m = re.match(r"AB (.+) rep \d+: ([\d.]+) ms", line)
    return (m.group(1), float(m.group(2))) if m else None


#: measurement: (child run in the checkout, line -> (series, value) or None)
MEASURES = {"lambert": (child_lambert, lambert_value),
            "k1": (child_k1, k1_value),
            "ki": (functools.partial(child_ki, "ki"), k1_value),
            "kiany": (functools.partial(child_ki, "kiany"), k1_value),
            "s1": (functools.partial(child_k2, "s1"), k1_value),
            "s2": (functools.partial(child_k2, "s2"), k1_value),
            "s2zoo": (functools.partial(child_k2, "s2zoo"), k1_value),
            "tex": (functools.partial(child_k2, "tex"), k1_value),
            "k3b": (child_k3b, k1_value),
            "k3a": (functools.partial(child_k3, "k3a"), k1_value),
            "k3c": (functools.partial(child_k3, "k3c"), k1_value),
            "full": (functools.partial(child_full, "full"), k1_value),
            "fullzoo": (functools.partial(child_full, "fullzoo"), k1_value),
            "fulllambert": (functools.partial(child_full, "fulllambert"),
                            k1_value),
            "atrous": (child_atrous, k1_value),
            "atrousgrad": (child_atrousgrad, k1_value)}


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        measure, tree, timer, depths = sys.argv[2:6]
        sys.path.insert(0, tree)
        os.chdir(tree)
        try:
            from metal_pathtracer_tpu_torch.ops.kernels import build
            print("# tree", tree, "package", os.path.dirname(build.__file__),
                  flush=True)
            MEASURES[measure][0](timer, tuple(
                int(d) for d in depths.split(",")))
        except Exception:
            traceback.print_exc()
            sys.exit(1)
        return
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("measure", choices=sorted(MEASURES))
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--order", default="pccppc",
                    help="p (parent) and c (change), one process each")
    ap.add_argument("--depths", default=None,
                    help="s1, s2, s2zoo, tex, k3b, full, fullzoo, "
                    "fulllambert: the depths of the kept wavefronts "
                    "(default 0,1,5; k3b 0,1)")
    args = ap.parse_args()
    if args.depths is None:
        args.depths = "0,1" if args.measure == "k3b" else "0,1,5"
    value_of = MEASURES[args.measure][1]
    trees = {"p": ("parent", os.path.abspath(args.parent)),
             "c": ("change", os.path.abspath(args.change))}
    timer = os.path.join(trees["c"][1], "chip_smoke.py")
    series = {"parent": {}, "change": {}}
    digests, outputs, saved = {}, {}, {}
    failed = False
    tmp = tempfile.mkdtemp()
    for n, key in enumerate(args.order):
        who, tree = trees[key]
        save = os.path.join(tmp, f"{n}.npz")
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             args.measure, tree, timer, args.depths], capture_output=True,
            text=True, env=dict(os.environ, AB_SAVE=save))
        if os.path.exists(save):
            saved.setdefault(who, save)
        for line in (run.stdout + run.stderr).splitlines():
            if re.search(r"^(AB|lambert|# tree)|Error|Traceback", line):
                print(f"[{who}] {line}", flush=True)
            m = re.match(r"AB digest (.+): ([0-9a-f]+)$", line)
            if m:
                digests.setdefault(m.group(1), set()).add(m.group(2))
            # a side's own output: equal within the side, maybe not across
            m = re.match(r"AB output (.+): ([0-9a-f]+)$", line)
            if m:
                outputs.setdefault(m.group(1), {}).setdefault(
                    who, set()).add(m.group(2))
            got = value_of(line)
            if got:
                series[who].setdefault(got[0], []).append(got[1])
        print(f"[{who}] rc={run.returncode}", flush=True)
        failed |= run.returncode != 0
    for name, seen in sorted(digests.items()):
        print(f"AB digest {name}: "
              f"{'equal' if len(seen) == 1 else 'DIFFERENT'} over every "
              f"process")
        failed |= len(seen) != 1
    for name, sides in sorted(outputs.items()):
        same = all(len(v) == 1 for v in sides.values())
        across = len(set().union(*sides.values())) == 1
        print(f"AB output {name}: "
              + ", ".join(f"{who} {' '.join(sorted(v))}"
                          for who, v in sorted(sides.items()))
              + f"; {'equal' if same else 'DIFFERENT'} within each side, "
              f"{'equal' if across else 'different'} across the sides")
        failed |= not same
    if len(saved) == 2:
        import numpy as np

        with np.load(saved["parent"]) as p, np.load(saved["change"]) as c:
            for name in sorted(p.files):
                ref = p[name].astype(np.float64)
                dist = np.linalg.norm(c[name].astype(np.float64) - ref) \
                    / np.linalg.norm(ref)
                print(f"AB distance {name}: the change's relative norm "
                      f"from the parent's {dist:.3e}")
    shutil.rmtree(tmp, ignore_errors=True)
    for name in series["change"] | series["parent"]:
        med = {}
        for who in ("parent", "change"):
            values = series[who].get(name, [])
            if len(values) >= 2:
                q = statistics.quantiles(values, n=4)
                med[who] = statistics.median(values)
                print(f"AB {who} {name}: {len(values)} timings, median "
                      f"{med[who]:.4f}, quartiles {q[0]:.4f}-{q[2]:.4f}")
        if len(med) == 2:
            print(f"AB {name}: parent / change "
                  f"{med['parent'] / med['change']:.3f}x")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
