#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from ``metal_pathtracer_tpu_torch/csrc``
(one nvcc per source, in parallel), checks the primary-ray kernel
(``camera_path``) and drives the port's twelve paths:

0. the camera (``csrc/camera.cu``, a sample's seeds, jitter, unit-disk
   draw and rays in one launch): the kernel against the plain chain
   (``rng.make_seed``, ``camera.generate_primary_rays``) at 1280x720,
   921,600 lanes, on the benchmark's rtow camera (lens radius 0) and on
   the book's rtow camera (depth of field), state, origin and direction
   bit for bit (their SHA-256 on both sides printed), the rejection
   rounds' spread, the kernel's device time beside the plain chain's and
   its 56 B a lane bound, its registers; then 2 spp of the book's rtow at
   1280x720 through ``CudaBackend``, one launch and 921,600 lanes
   (``lanes.camera``) a sample, and 160x96 2 spp against the plain path,
   bit for bit;
1. the lambert series (327,680-triangle displaced icosphere under the
   gradient sky, K1 closest-hit + K2 ``full``): K1 against its plain
   version bit for bit on probes, K2 under the image gate, a 1920x1080 d8
   render through ``CudaBackend``, and both kernels timed at the first
   bounce;
2. the untextured headline (1.31M-triangle displaced icosphere, glass and
   PBR spheres, HDR sun/sky with alias NEE and spec-NEE; K1 closest-hit,
   K1 any-hit, K2 ``s1`` and ``s2``): K1 any-hit bit for bit on probes and
   on the first-depth shadow wavefront, a 160x96 2 spp render of the
   same scene at subdivision 5 through the kernels against the plain
   path, the scene at 1920x1080 d8 through ``frame.render_samples``, and
   every kernel checked at the first-depth wavefront against its plain
   version;
3. the textured headline, the bench's real one (the same scene with the
   PBR sphere's 512x512 sRGB checker; the texture stage, K1 closest-hit
   and any-hit, K2 ``s1`` and ``s2``): the same 160x96 check and 1080p
   render, every kernel timed at the first-depth wavefront against its
   plain version with its bound, the texture kernel also on a scene that
   binds all six texture slots, and the refdefault cell (the same scene
   at 1280x720, maxDepth 20); K1 closest-hit and any-hit also on the
   depth-1 wavefronts (secondary rays and their shadow rays, kept from
   one sample of the frame loop by ``frame_loop_k1``, which also counts
   the live lanes of every K1 launch; each of its launches is timed, held
   bit for bit against the plain walk and given its bound) bit for bit
   against the plain walks and timed, each with its live lanes and its
   bound beside the old one; the texture stage, K2 s1 and K2 s2 at
   every depth of one sample (kept by ``frame_loop_k2``): against their
   plain versions at depths 0 and 1, their plane-major outputs checked,
   and each depth's device time beside its bound with its live, hit and
   textured lanes;
4. the analytic primitives (the sphere kernels K3a and K3b, the rectangle
   kernel K3c, K2 ``full`` and ``s1``/``s2`` with rect-light NEE, metal and
   diffuse lights): each K3 kernel against its plain version bit for bit
   on the first- and second-depth wavefronts of the Cornell box
   (``assets/scenes/cornell.scene``, 512x512) and of the *Ray Tracing in
   One Weekend* final scene (487 spheres, 1200x675), on the Cornell box's
   rect-light shadow wavefront, and K3b against K3a (exact-t ties
   counted); K2 ``s1``/``s2`` on the Cornell box's 512x512 first-depth
   wavefront with its rect-light bank and K2 ``full`` on rtow's first two
   depths against their plain versions, carry, transients and chain bit
   for bit; the Cornell box, rtow, the smoke scene, the mixed scene and
   the open Cornell box under an environment (rect-light and environment
   NEE together) at 160x96 2 spp through the kernels against the plain
   path (RMSE 0, equal trace counts); the Cornell box at 512x512 d8 and
   rtow at 1200x675 d50 through ``CudaBackend``; each K3 and K2 stage
   timed at the first depth with its bound, K3b beside its own group
   visits and sphere tests (its schedule in plain PyTorch, bit-equal) and
   at every depth of one rtow sample (kept by ``frame_loop_k3b``), which
   gives its time a sample; K3c at every launch of one Cornell and one
   cornell-emitenv sample and K3a at every launch of one Cornell,
   materials and materials-env-rw sample (the random walk's launches
   included; kept by ``frame_loop_k3``), each bit for bit against its
   plain version, with its call (closest, shadow, spec-NEE chain, walk),
   lanes and live lanes, device time, bound and the same launch with
   every lane dead (``k3_depths``);
5. the material zoo (plastic, carpaint, subsurface in its separable and
   random-walk modes, env-modulated lights; K2's extended instantiation,
   the random-walk pre-stage over K3a): K2 ``full`` on
   ``assets/scenes/materials.scene``'s 960x320 depths 0 and 1, ``s1``/``s2``
   on materials-env-rw's first depth (the HDR sky, the random walk's planes
   fed to both sides) and ``s1`` with the emod plane on cornell-emitenv's
   first depth, against their plain versions bit for bit and timed with
   their bounds; the three configurations, a plastic + carpaint and a
   separable-SSS triangle-icosphere scene and the six-slot textured scene
   under the gradient sky (stage ``full`` with texture planes) at 160x96
   1 spp against the plain path (RMSE 0, equal trace counts); the three
   configurations at full size through ``CudaBackend``. The kernels line
   lists the extended K2 stages as ``shade_*_zoo``, with this phase's
   launches;
   then K2 ``full`` at every depth of one sample of rtow and materials
   and at the lambert series' first 3 depths (``full_path``: kept by
   ``frame_loop_full``): each of its kernels (a thread per lane, the
   sparse sweep, the listing pass and the bucket kernel) against the
   plain version bit for bit at depths 0, 1 and a sparse one, and each
   depth's time as the main path runs it and by each kernel, beside its
   bound, lanes by kind and (warp, kind) pairs;
6. headless and debug (K1's counting instantiation, K2's
   ``debugSpecularOnly`` flag and probe plane, the CLI): ``traversal_profile``
   of the textured headline's 1920x1080 first-depth wavefront and its
   shadow wavefront through ``trace_closest_stats``/``trace_any_stats``,
   their outputs bit-equal to the counter-free kernels' and their four
   totals equal to the plain walk's (whole wavefronts and 4096 probes),
   each timed beside the counter-free kernel with its bound;
   ``probe_pixel`` on the smoke scene's centre and on a headline pixel
   through the glass sphere, the rows equal to the plain path's field by
   field; the CLI on the card (``python -m ...cli --scene cornell`` at
   512x512 8 spp to a multilayer EXR, the same to a PNG, a 4 spp
   ``--checkpoint`` run resumed to 8 equal to the straight run byte for
   byte, ``read_exr`` of the EXR equal to the rendered image, the
   default scene, the 353-sphere field through K3b, at 1280x720 2 spp,
   and the JAX package's oracle-parity Cornell box at 128x128 64 spp
   through ``--backend metal`` and ``--backend oracle``, the native C++
   oracle, held to that test's gate: RMSE < 0.02, means within 0.005);
   ``debugSpecularOnly`` at 160x96 1 spp through the kernels against the
   plain path (RMSE 0) on ``materials.scene`` and the textured headline at
   subdivision 5; and each K1 and K2 instantiation's registers from the
   build log;
7. MNEE (K2 s2's fork-state export, the delta-chain estimators over K1,
   K3a and K3c): the headline with MNEE on at 160x96 2 spp (subdivision
   5) through the kernels against the plain path and at 1920x1080 d8,
   one timed sample; its MNEE-eligible and secondary-chain lanes per
   depth, and its trace count equal to the closest traces plus the
   chains' (``mnee_lanes``); s2's fork state bit for bit against its
   plain version at depths 0 and 1, the base instantiation on the
   headline and the extended one on the Cornell box with a plastic
   sphere, and s2 timed with and without the export (the kernels line's
   ``shade_s2_mnee``); the Cornell box through the CLI with
   ``--enableMnee 1 --backend metal`` at 512x512 d8; and
   ``test_oracle_parity.py test_mnee_chain_rmse``'s scene at 128x128 64
   spp through ``--backend metal`` and ``--backend oracle``, means within
   1e-5, and at 4 spp the card against the plain path on the CPU
   (``--backend cpu-torch``) under the image gate, its gap to
   the oracle the plain path's (the oracle parts from the JAX package on
   a caustic path there: ROADMAP Queue 3);
8. the mesh loaders: the headline's meshes written as files (the
   1.31M-triangle icosphere as binary PLY, the glass icosphere as OBJ,
   the checker sphere and the ground as a GLB with an embedded PNG
   checker and a 200x120 texture the atlas resamples), its sky as an EXR
   and a ``.scene`` of ``mesh`` records: the PLY and OBJ triangles,
   normals and UVs against the in-memory meshes bit for bit, the GLB's
   tangents MikkTSpace's, a 160x96 2 spp render (subdivision 5) through
   the kernels against the plain path, and the scene at 1920x1080 d8
   through the CLI with ``--backend metal``, its set-up seconds (parse,
   SAH and atlas) beside its ms/spp;
9. instancing (the instanced K1, closest-hit and any-hit, one launch
   over every placement; K2 and the texture stage rebuilding instanced
   hits): the same files with the 1.31M-triangle PLY placed three times
   (rotated, scaled) and the glass OBJ twice with ``instanced=1`` beside
   the GLB soup (``meshfiles.instanced_scene_text``): the instanced K1
   against its plain per-placement walks bit for bit on 2,048 probes
   (half of them excluding a first hit) and on the depth-0 and depth-1
   closest and shadow wavefronts of one 1920x1080 sample, each timed
   beside its bound (``ki_bound``) with its live lanes; the texture stage
   and K2 s1/s2 at depths 0 and 1 against their plain versions; the
   scene at 160x96 2 spp (subdivision 5) and its lambert variant at 1
   spp (K2 ``full``) through the kernels against the plain path and
   against the same scenes baked into world-space meshes (RMSE < 2e-3,
   ``tests/test_instancing.py``'s gate); and the scene at 1920x1080 d8
   through the CLI: ms/spp, set-up seconds, peak device memory beside
   the baked scene's triangle and tree bytes, launches a sample, the
   instanced K1 once per trace;
10. the interactive path (the ``Renderer`` facade, the display pass, the
   denoisers' à-trous kernel and U-Net, the live viewer): the facade at
   1920x1080 on the mesh-files scene, 4 ``draw_frame(1)`` (K1, the texture
   stage, K2 s1/s2) and ``display()`` with ``denoiseEnabled`` at both
   filter types (9 à-trous launches and 2 pack launches); the à-trous
   kernel against its plain version at every iteration of the fixed and
   SVGF filters (4) and the learned one (4 and 5) on that state, within
   1e-6 relative, each iteration's device time beside ``denoise_bound``
   (the first port's charge), the charge with the kernel's hoists counted
   and the lane-rate ceiling, each filter's pack launch a bit copy and
   timed;
   the à-trous kernels' registers, spills and shared memory and their
   tap loops' instruction counts (``cuobjdump -sass``); the U-Net at
   1080p with TF32 off beside ``unet_flops``; the denoised displays
   against the plain filters' within one LDR step, display ms with and
   without denoise, and the type-0 display split with CUDA events
   (``display_trace``); and ``ViewerServer`` on the Cornell box at 320x180
   over HTTP (3 spp, ``/frame.png``, a denoised pass, an orbit's preview
   and landing), failing on the loop's ``last_error``;
11. multi-GPU rendering and texture formats (``parallel/mesh.py`` on
   ``torch.distributed``; the PNG and JPEG decoders): the textured
   headline at 1920x1080 d8, 1 spp, sharded over an NCCL group of world
   size 1 in this process and over two ``parallel.dryrun`` gloo ranks
   sharing the card (540 rows each), each bit for bit against this
   process's single ``render_samples`` in all five image fields with
   equal trace totals, each rank's slab ms beside the single render's;
   the Cornell box at 512x510 d8, 2 spp, over four gloo ranks (padded to
   512 rows: K3a, K3c, K2 s1/s2), unpadded bit-equal to the single
   render, its totals those of one render over the 512 rows; the
   committed texture fixtures (``tests/images``) decoded on this host,
   their RGBA digests Pillow's, the decode times of the 2048x2048 4:2:0
   JPEG and the 2048x2048 interlaced 16-bit RGBA PNG; and the mesh-files
   scene with its ground textured by that JPEG through the CLI at
   1920x1080 d8, 1 spp, bit-equal to the same scene with the texture
   re-encoded as an 8-bit PNG;
12. the denoisers' training path (``tools/train_denoiser.py`` and
   ``tools/train_denoiser_unet.py`` of the port; the learned à-trous
   filter's backward, ``csrc/denoise.cu atrous_grad_*``): the learned
   filter's gradients (MLP, colour, variance) through the backward
   kernels against autograd through the plain version at 4 and 5
   iterations on a 256x256 state with a background band and a band of
   tied luminances, within 1e-4 relative norm; each backward kernel
   against its plain twin at every iteration, two launches of each
   bit-equal; the forward with grad bit-equal to the forward without;
   the taps kernel's registers, spills and resident warps; at 64x64,
   96x96, 256x256 and 1920x1080 each kernel against its twin and the
   forward with its weight sums bit-equal to the forward without at the
   first and last iterations of a 4-iteration filter, and one iteration's
   forward and
   backward timed beside ``grad_bound`` (the taps kernel also beside its
   issue ceiling); then 10 steps of each trainer on
   two training scenes rendered on the card at 64x64, 4 / 16 spp
   (reduced from 16 / 512), every step's gradients against the plain
   version's on the same data copied to the CPU (the tap trainer's in
   ``TRAIN_CPU_WORKERS`` CPU processes).

A kernel's time is its device time: a spin kernel holds the stream while
the host enqueues the timed launches (``kernel_ms``), so the window holds
the kernels and not their wrappers' host work, which is printed beside it
as the time around the wrapper. The texture stage takes its launch
constants from the caller and reads nothing back, so it is timed the same
way.

Each path runs with every launch count set to 0 just before it and read
just after; a kernel of the path that was never launched fails the run.
Any failure raises; the script exits 0 only when every phase passed, and
its last line is then the one-line JSON result. Run from the repository
root with no arguments:

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import importlib.metadata
import importlib.util
import json
import os
import socket
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

LAMBERT_TIMED_SPP = 4
NEE_TIMED_SPP = 8
UNTEXTURED_TIMED_SPP = 4
REFDEFAULT_TIMED_SPP = 2
FRAME = (1920, 1080)
LAMBERT_SUBDIVISIONS = 7   # 20 * 4^7 = 327,680 triangles
HEADLINE_SUBDIVISIONS = 8  # 20 * 4^8 = 1,310,720 triangles
CHECK_SUBDIVISIONS = 5
CHECK_FRAME = (160, 96)
IMAGE_GATE = dict(max_rmse=2e-4, min_within_1e5=0.98)
# texture stage vs its plain version: the state and flags bit-equal, the
# planes within this (libm log2f against torch.log2 may move a LOD)
TEX_PLANE_TOL = 1e-5
# H100 SXM data-sheet peaks: HBM bandwidth, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
ROOT = "metal_pathtracer_tpu_torch/csrc/"

# Bytes a lane's K2 launch must move, by lane kind, from the kernels'
# loads and stores (csrc/shade.cu): a live hit (less its triangle's row,
# "row": each distinct row is read once), a live miss, a dead lane (its
# alive flag), plus the per-lane output columns every lane writes; a
# first hit also writes its AOVs and flag ("first"); in a textured scene
# a hit also reads the tpbr plane and a textured lane the other 14
# (TEX_BYTES in all). s1's charges were re-derived in PR 8 from the
# kernel: a hit reads alive, index, t, u, v, ray, medium depth,
# throughput, radiance, first-hit flag and state (78 B) and writes
# radiance, throughput and state (32 B); its row is cols 0-19 (80 B).
# Before PR 8 it charged 238 + 32 B a hit with a 96 B row per hit, 60 B
# of planes per textured-scene hit, AOVs included. s2's were re-derived in
# PR 9 from the listed kernel: every lane's alive flag is read (the
# listing pass) and its 28 B of CHAIN written once ("out": the listing
# pass's zeros, or a listed lane's values); a listed lane (alive after s1,
# a hit) reads index, t, u, v, ray, 10 TRANS planes, throughput, radiance,
# state, medium depth, cone and specular depth (128 B) and one 36 B ESMP
# bank (a second bank is ``extra``), and writes the carry (92 B); its row
# is cols 0-19 (80 B) and only its textured lanes read the 14 texture
# planes past tpbr. Before PR 9 it charged 341 B a hit with a 96 B row per
# hit (``K2_S2_BEFORE``, printed beside). full's follow the kernel
# (``full_bound``): a dead lane reads its alive flag; a
# miss reads alive, index, direction, radiance and throughput (41 B) and
# writes radiance, the exclusion ids and alive (22 B); a hit reads alive,
# index, t, u, v, ray, medium depth, throughput, radiance, first-hit
# flag, state and cone (86 B) and writes radiance, medium depth, cone,
# state, ray, throughput, the exclusion ids and alive (78 B), a first hit
# also its AOVs and flag (25 B); each distinct triangle row is cols 0-19
# (80 B); an analytic hit reads its family (4 B, as every hit of a scene
# with analytic primitives does) and no u, v, and each distinct sphere or
# rectangle record once (20 B). The listing pass reads only what the
# stage reads anyway; its list is its own output (``list_bound``). The
# older charge, 145 B a hit with a 96 B row per triangle hit and nothing
# for analytic records or AOVs, is ``K2_FULL_BEFORE``, printed beside.
# Rough operation counts per live lane (float ops in the
# source) give the compute side of the bound.
K2_BYTES = {
    "shade_full": dict(hit=86 + 78, row=80, prim=20, uv=8, first=25,
                       miss=41 + 22, dead=1, out=0, ops=200),
    "shade_s1": dict(hit=78 + 32, row=80, first=1 + 24, miss=50 + 22,
                     dead=1, out=72, ops=300),
    "shade_s2": dict(hit=1 + 128 + 36 + 92, row=80, first=0, miss=0, dead=1,
                     out=28, ops=1200),
}
K2_FULL_BEFORE = dict(hit=178 + 63 - 96, row=96, row_per_hit=True, prim=0,
                      uv=0, first=0, miss=41 + 22, dead=1, out=0, ops=200)
# K2 full's lane kinds (``full_counts``): dead, a miss, then the hit's
# material type (``constants.MATERIAL_*`` order)
LANE_KINDS = ["dead", "miss", "lambert", "metal", "dielectric", "light",
              "plastic", "subsurface", "carpaint", "pbr"]
K2_S2_BEFORE = dict(hit=345 + 92 - 96, row=96, first=0, miss=1, dead=1,
                    out=28, ops=1200)
TEX_BYTES = 15 * 4
# the texture stage's float operations per textured lane, and per bound
# slot (transform, LOD, two bilinear levels)
TEX_OPS, TEX_SLOT_OPS = 400, 120
# K1: a live lane's ray in (origin, direction, t_max, exclusion ids) and
# hit out (t, tri, u, v), a dead lane's t_max in and hit out. What the
# walk needs of a touched node: 24 B of bounds, its exit link and its leaf
# range; of a touched triangle slot: three vertices, and for closest-hit
# also the triangle and mesh ids (the exclusion test and the returned
# tri), whatever the layout holds (the packed node is 32 B, the slot
# record 48 B with 4 B of padding). The bound before the packed layout
# charged 36 B a node and 40 B a slot (an index and three vertices) to
# both kernels; it is printed beside, as "old layout". ~24 flops per node
# visit and ~45 per triangle test
K1_LANE_BYTES = 36 + 16
K1_DEAD_BYTES = 4 + 16
K1_NODE_BYTES = 32
K1_CLOSEST_SLOT_BYTES, K1_ANY_SLOT_BYTES = 36 + 8, 36
K1_OLD_NODE_BYTES, K1_OLD_SLOT_BYTES = 36, 4 + 36
K1_NODE_OPS, K1_TRI_OPS = 24, 45
# the depths of one headline sample whose K1 launches ``k1_depth1`` holds
# against the plain walk and times: the first 4 of 8 (the script's
# run-time limit)
K1_CHECK_DEPTHS = 4
# the analytic-primitive cells: samples of the 160x96 checks and of the
# timed full-size renders, and rtow's layout seed
PRIM_CHECK_SPP = 2
# samples of the 160x96 kernel-against-plain checks of the headline
# phases, the material zoo and debugSpecularOnly (the script's run-time
# limit: the zoo's and debugSpecularOnly's plain paths take ~30 s a
# sample on a slow host)
NEE_CHECK_SPP = 2
ZOO_CHECK_SPP = SPEC_CHECK_SPP = 1
CORNELL_TIMED_SPP = 4
RTOW_TIMED_SPP = 2
RTOW_SEED = 0
# K3: a lane's ray in (origin, direction, t_max: 28 B) and hit out (t,
# index: 8 B); a sphere is 16 B (centre, radius), a K3b slot 20 B (with
# its index) and a group box 24 B, a rectangle 60 B (15 floats); ~25 flops
# per sphere test, ~35 per rectangle test, ~12 per group-box slab test
K3_LANE_BYTES = 28 + 8
K3_SPHERE_BYTES, K3_SLOT_BYTES, K3_BOX_BYTES, K3_RECT_BYTES = 16, 20, 24, 60
K3_SPHERE_OPS, K3_RECT_OPS, K3_BOX_OPS = 25, 35, 12
# K2's device ms at the earlier phases' first depths as PERF.md records
# them (its run G, on an NVIDIA H100 80GB HBM3, 700.00 W), printed beside
# this run's (K2_NOW) at the end: the material zoo's extended
# instantiation must leave the other paths' code as it was
K2_RUN_G = {"lambert full": 0.0417, "textured headline s1": 0.751,
            "textured headline s2": 0.361, "cornell s1": 0.1066,
            "cornell s2": 0.0560, "rtow full depth 0": 0.0726}
K2_NOW = {}
# each cell's launch counts from its main path's run (the kernels line)
MAIN_LAUNCHES = {}
# the card against the native C++ oracle (``renderer/oracle.py``): the
# JAX package's ``tests/test_oracle_parity.py test_cornell_box_rmse``
# scene and gate (RMSE < 0.02, means within 0.005), rendered through the
# CLI with ``--backend metal`` and ``--backend oracle``
ORACLE_CORNELL = """\
camera target=0,1,0 distance=3.9 yaw=1.5708 pitch=0 vfov=40
renderer maxDepth=5 seed=7
material type=lambert albedo=0.73,0.73,0.73
material type=lambert albedo=0.65,0.05,0.05
material type=lambert albedo=0.12,0.45,0.15
material type=light emit=15,15,15
rectangle x=-1,1 y=0 z=-1,1 normal=1 material=0
rectangle x=-1,1 y=2 z=-1,1 normal=-1 material=0
rectangle x=-1 y=0,2 z=-1,1 normal=1 material=2
rectangle x=1 y=0,2 z=-1,1 normal=-1 material=1
rectangle x=-1,1 y=0,2 z=-1 normal=1 material=0
rectangle x=-0.4,0.4 y=1.99 z=-0.4,0.4 normal=-1 material=3
"""
ORACLE_GATE = dict(max_rmse=0.02, max_mean_diff=0.005)
ORACLE_FRAME, ORACLE_SPP = (128, 128), 64


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(prepare, reps: int) -> float:
    """Mean milliseconds of the event window around each of ``reps`` runs
    of the callable that ``prepare()`` returns (set-up outside the window;
    CUDA events). The window holds the callable's host work too: a plain
    version's, or a kernel wrapper's checks and launch."""
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


def kernel_ms(prepare, reps: int) -> float:
    """Mean device milliseconds of a kernel over ``reps`` runs of the
    callable that ``prepare()`` returns (set-up outside the window). A
    spin kernel holds the stream while the host enqueues the runs, so the
    event window holds the kernels back to back and not the wrappers' host
    work; the spin grows until it outlasts the enqueueing."""
    cycles = 1 << 24
    for _ in range(4):
        runs = [prepare() for _ in range(reps)]
        torch.cuda.synchronize()
        hold, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        hold.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for run in runs:
            run()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if host_ms < hold.elapsed_time(start):
            return start.elapsed_time(end) / reps
        cycles *= 8
    raise AssertionError("kernel_ms: the host enqueue outlasted the spin")


def timed(prepare, reps: int):
    """(device ms of the kernel, ms of the event window around its
    wrapper): ``kernel_ms`` and ``cuda_ms`` of the same runs."""
    return kernel_ms(prepare, reps), cuda_ms(prepare, reps)


def bound_ms(n_bytes: float, n_ops: float):
    """The least time for the work: (ms, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(walk, lane_bytes, node_bytes, slot_bytes):
    """K1's bound: the lanes' own bytes, plus every node and triangle slot
    the walk touched read once, at ``node_bytes`` and ``slot_bytes``."""
    return bound_ms(lane_bytes
                    + int(walk["nodes"].sum()) * node_bytes
                    + int(walk["slots"].sum()) * slot_bytes,
                    walk["node_visits"] * K1_NODE_OPS
                    + walk["tri_tests"] * K1_TRI_OPS)


def k1_bounds(walk, lane_bytes, slot_bytes):
    """``k1_bound`` at the bytes the walk needs (``slot_bytes``: the
    closest-hit or the any-hit figure) and at the old 36 / 40 B charge:
    (ms, by, old ms)."""
    new, by = k1_bound(walk, lane_bytes, K1_NODE_BYTES, slot_bytes)
    old, _ = k1_bound(walk, lane_bytes, K1_OLD_NODE_BYTES, K1_OLD_SLOT_BYTES)
    return new, by, old


def closest_lane_bytes(n, n_live):
    return n_live * K1_LANE_BYTES + (n - n_live) * K1_DEAD_BYTES


def any_lane_bytes(n, n_live):
    """any-hit: every lane's window in and flag out, a live lane's ray"""
    return n * (4 + 1) + n_live * 24


def k2_bound(name, n_hit, n_miss, n_dead, textured=False, analytic=False,
             extra=0, table=0, n_rows=None, n_tex=None, n_first=None,
             charge=None):
    """K2's bound by lane kind. Triangle hits read ``n_rows`` distinct
    shade_packed rows (None: one per hit, the charge before PR 8); an
    analytic hit reads its family (4 B) instead, and its sphere or
    rectangle stays in cache. In a textured scene ``n_tex`` lanes (None:
    every hit) read all the texture planes, the other hits the tpbr
    plane; ``n_first`` hits write the first-hit AOVs (None: every hit).
    ``extra``: bytes more per hit (the random-walk or emod planes);
    ``table``: bytes moved once more (the material table's, read once;
    s2's fork states, written once); ``charge``: other
    per-lane charges than ``K2_BYTES[name]`` (an older charge)."""
    b = K2_BYTES[name] if charge is None else charge
    rows = 0 if analytic else n_hit if n_rows is None else n_rows
    tex = n_hit * 4 + (n_hit if n_tex is None else n_tex) * (TEX_BYTES - 4) \
        if textured else 0
    n_bytes = n_hit * (b["hit"] + extra + (4 if analytic else 0)) \
        + rows * b["row"] + tex \
        + (n_hit if n_first is None else n_first) * b["first"] \
        + n_miss * b["miss"] + n_dead * b["dead"] \
        + (n_hit + n_miss + n_dead) * b["out"] + table
    return bound_ms(n_bytes, (n_hit + n_miss) * b["ops"])


def s1_counts(carry, idx):
    """k2_bound's s1 counts of a wavefront (carry and hit index as s1
    takes them): live hits, distinct triangle rows, first hits."""
    hits = carry.alive & (idx >= 0)
    return dict(n_rows=int(torch.unique(idx[hits]).numel()),
                n_first=int((hits & carry.is_first_hit).sum()))


def s2_counts(carry, idx, tex=None):
    """k2_bound's s2 counts of a wavefront (carry and hit index as s2
    takes them): distinct triangle rows of the live lanes and, in a
    textured scene, the live lanes the texture stage textured."""
    from metal_pathtracer_tpu_torch.ops.kernels import texture as X

    out = dict(n_rows=int(torch.unique(idx[carry.alive]).numel()))
    if tex is not None:
        out["n_tex"] = int((carry.alive
                            & (tex[:, X.TEX_IDX["tpbr"]] > 0.5)).sum())
    return out


def s2_bounds(n, n_live, tex=None, carry=None, idx=None, fork=False):
    """s2's bound on a triangle wavefront at PR 9's charge (textured if
    ``tex``; with ``fork``, every lane's 8 B fork state written too) and
    at the charge before it: (ms, by, ms before)."""
    b, by = k2_bound("shade_s2", n_live, 0, n - n_live, tex is not None,
                     table=n * FORK_BYTES if fork else 0,
                     **s2_counts(carry, idx, tex))
    old, _ = k2_bound("shade_s2", n_live, 0, n - n_live, tex is not None,
                      charge=K2_S2_BEFORE)
    return b, by, old


def probes(scene, n=4096, seed=7):
    """bench.py:136-146's probe set: half the rays aimed at the mesh bounds,
    plus lanes with an empty window."""
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


def compare_flags(got, ref, label):
    if not torch.equal(got, ref):
        bad = int((got != ref).sum())
        raise AssertionError(f"{label}: any-hit flags differ on {bad} lanes")


def image_gate(img, ref, counts, counts_ref, label):
    d = np.abs(img - ref)
    rmse = float(np.sqrt((d * d).mean()))
    within = float((d.max(-1) < 1e-5).mean())
    print(f"{label}: rmse={rmse:.3e} within_1e-5={within:.5f} "
          f"max_abs={float(d.max()):.3e} traces={counts} "
          f"plain_traces={counts_ref}")
    if counts != counts_ref:
        raise AssertionError(f"{label}: ray counts differ")
    if not (rmse < IMAGE_GATE["max_rmse"]
            and within > IMAGE_GATE["min_within_1e5"]):
        raise AssertionError(f"{label}: image gate failed")
    return float(d.max())


@contextlib.contextmanager
def plain_kernels():
    """The same depth loops with every kernel entry point replaced by its
    plain PyTorch version (run on the card)."""
    from metal_pathtracer_tpu_torch.ops.kernels import camera as CK
    from metal_pathtracer_tpu_torch.ops.kernels import primitives as P
    from metal_pathtracer_tpu_torch.ops.kernels import shade as S
    from metal_pathtracer_tpu_torch.ops.kernels import texture as X
    from metal_pathtracer_tpu_torch.ops.kernels import traverse as T

    def plain_trace(o, d, t_min, t_max, bvh, tris, ex_mesh=None,
                    ex_prim=None):
        n = o.shape[0]
        return T.trace_closest_reference(
            o, d, float(t_min), t_max, bvh, tris,
            T._as_i32(ex_mesh, n, o.device), T._as_i32(ex_prim, n, o.device))

    def plain_any(o, d, t_min, t_max, bvh, tris):
        return T.trace_any_reference(o, d, float(t_min), t_max, bvh, tris)

    def plain_inst(o, d, t_min, t_max, groups, ex_mesh=None, ex_prim=None):
        n = o.shape[0]
        return T.trace_instanced_closest_reference(
            o, d, float(t_min), _lanes_tmax(o, t_max), groups,
            T._as_i32(ex_mesh, n, o.device), T._as_i32(ex_prim, n, o.device))

    def plain_inst_any(o, d, t_min, t_max, groups):
        return T.trace_instanced_any_reference(o, d, float(t_min),
                                               _lanes_tmax(o, t_max), groups)

    def plain_prims(reference):
        return lambda o, d, t_min, t_max, prims: reference(
            o, d, float(t_min), P._prepare(o, t_max), prims)

    with mock.patch.object(S, "trace_closest", plain_trace), \
            mock.patch.object(T, "trace_closest", plain_trace), \
            mock.patch.object(T, "trace_any", plain_any), \
            mock.patch.object(T, "trace_instanced_closest", plain_inst), \
            mock.patch.object(T, "trace_instanced_any", plain_inst_any), \
            mock.patch.object(P, "sphere_nearest_brute",
                              plain_prims(P.sphere_nearest_reference)), \
            mock.patch.object(P, "sphere_nearest_chunked", plain_prims(
                P.sphere_nearest_chunked_reference)), \
            mock.patch.object(P, "rect_nearest",
                              plain_prims(P.rect_nearest_reference)), \
            mock.patch.object(S, "shade_full", S.shade_full_reference), \
            mock.patch.object(S, "shade_s1", S.shade_s1_reference), \
            mock.patch.object(S, "shade_s2", S.shade_s2_reference), \
            mock.patch.object(S, "texture_stage",
                              X.texture_stage_reference), \
            mock.patch.object(CK, "primary_rays",
                              CK.primary_rays_reference):
        yield


def _lanes_tmax(o, t_max):
    """A trace's window end as the (N,) float32 tensor the wrappers make."""
    return torch.broadcast_to(torch.as_tensor(
        t_max, dtype=torch.float32, device=o.device),
        (o.shape[0],)).contiguous()


def reset_launches(kernels):
    for fn in kernels.values():
        fn.launches = 0


def clone(c):
    from metal_pathtracer_tpu_torch.ops.integrator import PathCarry
    return PathCarry(**{k: v.clone() for k, v in vars(c).items()})


def primary_carry(uni, static, dev):
    """The primary-ray wavefront of sample 0 as a fresh PathCarry."""
    from metal_pathtracer_tpu_torch.ops import camera as camera_ops
    from metal_pathtracer_tpu_torch.ops import integrator
    from metal_pathtracer_tpu_torch.ops import rng as rng_ops

    w, h = static.width, static.height
    flat = torch.arange(w * h, device=dev)
    xs, ys = flat % w, flat // w
    seed = rng_ops.make_seed(uni.fixed_rng_seed, 0, xs, ys, 0,
                             torch.zeros_like(xs))
    state, ro, rd = camera_ops.generate_primary_rays(uni.camera, xs, ys, w,
                                                     h, seed)
    return integrator.PathCarry.start(
        state, ro, rd, 0.0, integrator._primary_cone_spread(uni, static))


def trace_inputs(c, scene):
    from metal_pathtracer_tpu_torch import constants as C
    return (c.ray_o, c.ray_d, C.EPSILON_T,
            torch.where(c.alive, C.INFINITY_T, 0.0), scene.tri_bvh,
            scene.triangles,
            torch.where(c.prev_valid, c.prev_mesh, -1).to(torch.int32),
            torch.where(c.prev_valid, c.prev_prim, -1).to(torch.int32))


def carry_error(a, b, n):
    """Lanes whose state/alive/prim differ, and the largest float field
    error relative to max(1, |plain|)."""
    differ = sum(int((getattr(a, k) != getattr(b, k)).reshape(n, -1)
                     .any(-1).sum())
                 for k in ("state", "alive", "prev_prim", "last_delta",
                           "medium_depth"))
    err = max(float(((getattr(a, k) - getattr(b, k)).abs()
                     / getattr(b, k).abs().clamp_min(1.0)).max())
              for k in ("ray_o", "ray_d", "throughput", "radiance",
                        "last_pdf", "medium_stack", "cone_width"))
    return differ, err


# ---- phase 0: the camera ---------------------------------------------------

#: the primary-ray kernel's frame, and its bytes a lane: x, y and the
#: previous count in (int64), the state (int64), origin and direction out
CAMERA_FRAME = (1280, 720)
CAMERA_LANE_BYTES = 3 * 8 + 8 + 2 * 12
CAMERA_TIMED_SPP = 2


def camera_digest(rays) -> str:
    """SHA-256 of (state, origin, direction)."""
    import hashlib

    h = hashlib.sha256()
    for x in rays:
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def camera_rounds(args, state):
    """Each lane's unit-disk rounds, found from its final state (the
    state after the two jitter draws, two draws a round; 0: not found)."""
    from metal_pathtracer_tpu_torch.ops import rng as rng_ops

    seed, frame_index, sample_count, x, y, prev = args[:6]
    s = rng_ops.make_seed(seed, frame_index, x, y, sample_count, prev)
    s = rng_ops.pcg_hash(rng_ops.pcg_hash(s))
    rounds = torch.zeros_like(state)
    for k in range(1, 25):
        s = rng_ops.pcg_hash(rng_ops.pcg_hash(s))
        rounds = torch.where((rounds == 0) & (s == state), k, rounds)
    return rounds


def device_ops(run) -> int:
    """Device operations (kernels, copies, fills) that ``run()`` puts on
    the card, as the profiler records them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA for e in prof.events())


def camera_path(dev, card, kernels, out):
    """The primary-ray kernel against the plain chain, timed, then on the
    main path of one rtow render."""
    from metal_pathtracer_tpu_torch.ops.camera import build_camera
    from metal_pathtracer_tpu_torch.ops.kernels import build
    from metal_pathtracer_tpu_torch.ops.kernels import camera as CK
    from metal_pathtracer_tpu_torch.renderer import frame
    from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
    from metal_pathtracer_tpu_torch.renderer.headless import CudaBackend
    from metal_pathtracer_tpu_torch.schema import (
        settings_to_static,
        settings_to_uniforms,
    )
    from metal_pathtracer_tpu_torch.settings import RenderSettings
    from metal_pathtracer_tpu_torch.utils import benchscene as B
    from metal_pathtracer_tpu_torch.utils import spans

    W, H = CAMERA_FRAME
    n = W * H
    with open("portbench/configs/rtow.json") as fh:
        bench = json.load(fh)["settings"]
    bench_settings = RenderSettings()
    for key, value in bench.items():
        if key.startswith("camera"):
            setattr(bench_settings, key,
                    tuple(value) if isinstance(value, list) else value)
    book_settings, book_res = B.build_rtow_scene(RTOW_SEED)
    flat = torch.arange(n, device=dev)
    xs, ys = flat % W, flat // W
    bound, bound_by = bound_ms(n * CAMERA_LANE_BYTES, 0)
    regs = kernel_resources(build.build_log())["primary_rays_kernel"]
    times = {}
    for label, settings, frame_index, prev in (
            ("bench rtow, lens 0", bench_settings, 0, torch.zeros_like(xs)),
            ("book rtow, depth of field", book_settings, 5, flat % 7)):
        cam = build_camera(settings, W, H, dev)
        args = (settings.fixedRngSeed, frame_index, frame_index, xs, ys,
                prev, W, H)
        got = CK.primary_rays(cam, *args)
        want = CK.primary_rays_reference(cam, *args)
        torch.cuda.synchronize()
        dk, dp = camera_digest(got), camera_digest(want)
        if dk != dp:
            raise AssertionError(f"camera ({label}): the kernel's rays "
                                 f"differ from the plain chain's")
        rounds = camera_rounds(args, got[0])
        if int(rounds.min()) < 1 or int(rounds.max()) < 6:
            raise AssertionError(f"camera ({label}): rounds "
                                 f"{int(rounds.min())}-{int(rounds.max())}")
        counts = torch.bincount(rounds, minlength=25).tolist()
        ms, win_ms = timed(lambda: lambda: CK.primary_rays(cam, *args), 20)
        plain_ms = cuda_ms(lambda: lambda: CK.primary_rays_reference(
            cam, *args), 2)
        ops = (device_ops(lambda: CK.primary_rays(cam, *args)),
               device_ops(lambda: CK.primary_rays_reference(cam, *args)))
        if ops[0] != 1:
            raise AssertionError(f"camera ({label}): {ops[0]} device "
                                 f"operations for the kernel's call")
        times[label] = ms, plain_ms, ops[1]
        print(f"camera ({label}, lens radius {float(cam.lens_radius):.4f}) "
              f"{W}x{H}, {n} lanes: kernel digest {dk[:16]}, plain digest "
              f"{dp[:16]} (bit-equal); rounds a lane {counts[1:13]} for "
              f"1-12, most {int(rounds.max())}; kernel_ms {ms:.4f} on the "
              f"device, {win_ms:.4f} around the wrapper, plain {plain_ms:.2f}"
              f" ms, bound {bound:.4f} ms by {bound_by} "
              f"({CAMERA_LANE_BYTES} B a lane), "
              f"{100 * bound / ms:.1f} % of it; device operations: "
              f"kernel {ops[0]}, plain {ops[1]} [{card}]")

    # ---- the main path: the book's rtow through CudaBackend ------------
    backend = CudaBackend()
    backend.render(book_res, book_settings, *CHECK_FRAME, 1, device=dev)
    torch.cuda.synchronize()
    reset_launches(kernels)
    before = spans.counters().get("lanes.camera", 0)
    res = backend.render(book_res, book_settings, W, H, CAMERA_TIMED_SPP,
                         device=dev)
    launches = CK.primary_rays.launches
    lanes = spans.counters().get("lanes.camera", 0) - before
    if launches != CAMERA_TIMED_SPP or lanes != CAMERA_TIMED_SPP * n:
        raise AssertionError(f"camera: {launches} launches and {lanes} "
                             f"lanes in {CAMERA_TIMED_SPP} samples of {n}")
    print(f"camera main path: book rtow {W}x{H} d{book_settings.maxDepth} "
          f"{CAMERA_TIMED_SPP} spp through CudaBackend in "
          f"{res.total_seconds:.3f}s ({res.avg_ms_per_sample:.2f} ms/spp): "
          f"{launches} primary_rays launches, {lanes} lanes.camera [{card}]")

    # ---- 160x96 2 spp: kernel path against the plain path --------------
    w, h = CHECK_FRAME
    static = settings_to_static(book_settings, w, h,
                                book_res.material_types_present())
    uni = settings_to_uniforms(book_settings,
                               build_camera(book_settings, w, h, dev), 0, 0)
    scene = book_res.build_arrays(device=dev)
    st_k = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                static, PRIM_CHECK_SPP)
    with mock.patch.object(CK, "primary_rays", CK.primary_rays_reference):
        st_p = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                    static, PRIM_CHECK_SPP)
    for name in ("radiance_sum", "radiance_sq_sum", "albedo", "normal"):
        if not torch.equal(getattr(st_k, name).view(torch.int32),
                           getattr(st_p, name).view(torch.int32)):
            raise AssertionError(f"camera: book rtow {w}x{h} {name} "
                                 f"differs from the plain camera's")
    print(f"camera: book rtow {w}x{h} {PRIM_CHECK_SPP} spp with the kernel "
          f"and with the plain chain: bit-equal [{card}]")
    out["primary_rays"] = dict(
        source=ROOT + "camera.cu",
        # XLA in the JAX package (ops/camera.py, ops/rng.py), not a TPU
        # kernel
        replaces="metal_pathtracer_tpu/ops/camera.py:79",
        launches=launches, max_abs_err=0.0,
        ms=times["bench rtow, lens 0"][0],
        plain_ms=times["bench rtow, lens 0"][1], bound_ms=bound,
        bound_by=bound_by, registers=regs[0],
        plain_launches=times["bench rtow, lens 0"][2])


def lambert_path(dev, card, kernels, out):
    """The lambert series: K1 and K2 ``full`` checks, 1080p render, K2
    timing at the first bounce."""
    from metal_pathtracer_tpu_torch import constants as C
    from metal_pathtracer_tpu_torch.ops.camera import build_camera
    from metal_pathtracer_tpu_torch.ops.kernels import shade as S
    from metal_pathtracer_tpu_torch.ops.kernels import traverse as T
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

    settings, resources = build_lambert_series(LAMBERT_SUBDIVISIONS)
    t0 = time.time()
    scene = resources.build_arrays(device=dev)
    print(f"# lambert scene: {scene.triangles.count} triangles, "
          f"{scene.tri_bvh.node_count} BVH nodes, built in "
          f"{time.time() - t0:.1f}s")

    # ---- K1 vs its plain version: 4096 probes, bit for bit -------------
    o, d, tmax = (torch.from_numpy(x).to(dev) for x in probes(scene))
    ex_mesh = torch.full((o.shape[0],), -1, dtype=torch.int32, device=dev)
    ex_prim = torch.full_like(ex_mesh, -1)
    first = T.trace_closest_reference(o, d, C.EPSILON_T, tmax, scene.tri_bvh,
                                      scene.triangles, ex_mesh, ex_prim)
    # every eighth lane excludes the triangle it just hit (self-hit rule)
    sel = torch.zeros_like(ex_mesh, dtype=torch.bool)
    sel[::8] = first[1][::8] >= 0
    ex_prim = torch.where(sel, first[1], -1)
    ex_mesh = torch.where(sel, 0, -1).to(torch.int32)
    k1 = T.trace_closest(o, d, C.EPSILON_T, tmax, scene.tri_bvh,
                         scene.triangles, ex_mesh, ex_prim)
    ref = T.trace_closest_reference(o, d, C.EPSILON_T, tmax, scene.tri_bvh,
                                    scene.triangles, ex_mesh, ex_prim)
    torch.cuda.synchronize()
    k1_err = compare_trace(k1, ref)
    print(f"K1 probes: bit-exact over {o.shape[0]} lanes, "
          f"{int((k1[1] >= 0).sum())} hits, {int(sel.sum())} excluding lanes")

    # ---- K2: 160x96, 4 spp, maxDepth 8, kernel path vs plain path ------
    w, h = CHECK_FRAME
    static = settings_to_static(settings, w, h,
                                resources.material_types_present())
    uni = settings_to_uniforms(settings, build_camera(settings, w, h, dev),
                               0, 0)
    st_k = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                static, 4)
    with plain_kernels():
        st_p = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                    static, 4)
    image_gate(st_k.present().cpu().numpy(), st_p.present().cpu().numpy(),
               st_k.ray_count, st_p.ray_count,
               f"K2 full {w}x{h} 4spp kernel vs plain")

    # ---- the lambert series at 1920x1080 through CudaBackend -----------
    W, H = FRAME
    backend = CudaBackend()
    warm = backend.render(resources, settings, W, H, 1, device=dev)
    torch.cuda.synchronize()
    reset_launches(kernels)
    res = backend.render(resources, settings, W, H, LAMBERT_TIMED_SPP,
                         device=dev)
    launches = {k: fn.launches for k, fn in kernels.items()}
    img = res.linear_rgb
    if not (np.isfinite(img).all() and img.max() > 0.0):
        raise AssertionError("lambert 1080p image is not finite and non-zero")
    if res.ray_count < W * H * LAMBERT_TIMED_SPP or warm.ray_count < W * H:
        raise AssertionError(f"ray_count {res.ray_count} < pixel count")
    if launches["trace_closest"] <= 0 or launches["shade_full"] <= 0:
        raise AssertionError(f"a lambert-path kernel was not launched: "
                             f"{launches}")
    print(f"lambert {W}x{H} d8: {LAMBERT_TIMED_SPP} spp in "
          f"{res.total_seconds:.3f}s, {res.avg_ms_per_sample:.2f} ms/spp, "
          f"{res.ray_count / res.total_seconds / 1e6:.2f} Mrays/s "
          f"({res.ray_count} traces), launches {launches} [{card}]")

    # ---- K1/K2 vs plain at the lambert path's first bounce -------------
    static = settings_to_static(settings, W, H,
                                resources.material_types_present())
    uni = settings_to_uniforms(settings, build_camera(settings, W, H, dev),
                               0, 0)
    params = S.ShadeParams.of(uni, static)
    carry = primary_carry(uni, static, dev)
    hit0 = T.trace_closest(*trace_inputs(carry, scene))
    S.shade_full(carry, *hit0, scene.triangles, scene.materials, params, 0)
    hit1 = T.trace_closest(*trace_inputs(carry, scene))
    n = W * H
    n_live = int(carry.alive.sum())

    def k2_run(fn):
        def setup():
            c = clone(carry)
            return lambda: fn(c, *hit1, scene.triangles, scene.materials,
                              params, 1)
        return setup

    k2_ms, k2_win_ms = timed(k2_run(S.shade_full), 5)
    k2_plain_ms = cuda_ms(k2_run(S.shade_full_reference), 2)
    ck, cp = clone(carry), clone(carry)
    S.shade_full(ck, *hit1, scene.triangles, scene.materials, params, 1)
    S.shade_full_reference(cp, *hit1, scene.triangles, scene.materials,
                           params, 1)
    torch.cuda.synchronize()
    differ, call_err = carry_error(ck, cp, n)
    bound, bound_by = full_bound(
        full_counts(scene, carry, hit1[1], None),
        scene.materials.count * len(S.MAT_COLS) * 4)
    print(f"lambert first bounce ({n_live} live of {n} lanes): K2 full "
          f"{k2_ms:.4f} ms on the device, {k2_win_ms:.4f} ms around the "
          f"wrapper (plain {k2_plain_ms:.1f} ms, bound {bound:.4f} ms "
          f"by {bound_by}), vs plain: max_rel_err {call_err:.3e}, {differ} "
          f"differing lanes [{card}]")
    if differ > 1e-4 * n or not call_err <= 1e-4:
        raise AssertionError("K2 full disagrees with its plain version")
    K2_NOW["lambert full"] = k2_ms
    return k1_err


def texture_bound(scene, static, carry, hit, planes):
    """The texture stage's bound from this wavefront: every lane's alive
    flag read and its 60 B of planes written, a live lane's hit index, a
    live hit's material id (4 B per distinct triangle), a textured lane's
    t, u, v, ray, cone and state (its state written back), its triangle's
    row, UV pairs and tangents (each distinct triangle once) and the
    texels of its bound slots (at most the whole atlas), and the material
    table. Returns (ms, "bytes" or "operations", ms at the charge before
    PR 8, which gave every lane a textured lane's own 117 B)."""
    n = carry.alive.shape[0]
    live = carry.alive
    hits = live & (hit[1] >= 0)
    elig = planes[:, -1] > 0.5
    n_live, n_elig = int(live.sum()), int(elig.sum())
    slots = len(static.texture_slots)
    tri_bytes = 96 + 24 * (2 if static.texture_uv1 else 1) \
        + (48 if 2 in static.texture_slots else 0)
    n_tris = int(torch.unique(hit[1][elig]).numel())
    n_hit_tris = int(torch.unique(hit[1][hits]).numel())
    shared = n_tris * tri_bytes + min(n_elig * slots * 2 * 4 * 16,
                                      scene.textures.texels.numel() * 4) \
        + scene.materials.count * 64 * 4
    n_bytes = n * (1 + 60) + n_live * 4 + n_hit_tris * 4 \
        + n_elig * (12 + 24 + 8 + 8 + 8) + shared
    n_ops = n_elig * (TEX_OPS + TEX_SLOT_OPS * slots)
    old = bound_ms(n * (1 + 4 + 12 + 24 + 8 + 8 + 60) + n_elig * 8 + shared,
                   n_ops)[0]
    return (*bound_ms(n_bytes, n_ops), old)


def compare_texture(got, want, ck, cp, label):
    """The texture kernel against its plain version: state and the
    tpass/tpbr flags bit-equal; returns the largest plane difference."""
    from metal_pathtracer_tpu_torch.ops.kernels.texture import TEX_IDX

    if not torch.equal(ck.state, cp.state):
        raise AssertionError(f"{label}: texture-stage state differs on "
                             f"{int((ck.state != cp.state).sum())} lanes")
    for name in ("tpass", "tpbr"):
        a, b = got[:, TEX_IDX[name]], want[:, TEX_IDX[name]]
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: {name} differs on "
                                 f"{int((a != b).sum())} lanes")
    err = float((got - want).abs().max())
    if not err <= TEX_PLANE_TOL:
        raise AssertionError(f"{label}: plane difference {err}")
    return err


def texture_probe(dev, card, label, settings, res, scene, w, h, depths):
    """The texture kernel against its plain version on the primary
    wavefront of a w x h frame (every ninth lane dead) at ``depths``."""
    from metal_pathtracer_tpu_torch.ops.kernels import texture as X
    from metal_pathtracer_tpu_torch.ops.kernels import traverse as T

    static, uni = scene_setup(settings, res, w, h, dev)
    carry = primary_carry(uni, static, dev)
    carry.alive[::9] = False
    hit = T.trace_closest(*trace_inputs(carry, scene))
    err, n_elig, n_pass, n_blend = 0.0, 0, 0, 0
    tex_params = X.TexParams.of(uni, static, scene.textures)
    for depth in depths:
        ck, cp = clone(carry), clone(carry)
        got = X.texture_stage(ck, *hit, scene, uni, static, depth,
                              tex_params)
        want = X.texture_stage_reference(cp, *hit, scene, uni, static, depth)
        torch.cuda.synchronize()
        err = max(err, compare_texture(got, want, ck, cp, label))
        n_elig = int((want[:, -1] > 0.5).sum())
        n_pass = int((want[:, X.TEX_IDX["tpass"]] > 0.5).sum())
        n_blend = int((ck.state != carry.state).sum())
    if n_elig == 0:
        raise AssertionError(f"{label}: no textured lane")
    print(f"{label} {w}x{h}: texture stage vs plain at depths {depths}: "
          f"state and flags bit-equal, {n_elig} textured lanes, {n_pass} "
          f"pass-through, {n_blend} BLEND draws, largest plane difference "
          f"{err:.3e} [{card}]")
    return err


def scene_setup(settings, res, w, h, dev):
    from metal_pathtracer_tpu_torch.ops.camera import build_camera
    from metal_pathtracer_tpu_torch.schema import (
        settings_to_static,
        settings_to_uniforms,
    )

    static = settings_to_static(settings, w, h, res.material_types_present(),
                                res.texture_slots_present(),
                                res.texture_uses_uv1())
    uni = settings_to_uniforms(settings, build_camera(settings, w, h, dev),
                               0, 0)
    return static, uni


def timed_render(scene, settings, res, w, h, spp, dev, kernels):
    """One warm-up sample, then ``spp`` timed samples with the launch
    counts reset just before; returns (state, seconds, launches, peak)."""
    from metal_pathtracer_tpu_torch.renderer import frame
    from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState

    static, uni = scene_setup(settings, res, w, h, dev)
    frame.render_samples(scene, uni, RenderState.create(w, h, dev), static, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(kernels)
    t0 = time.time()
    st = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                              static, spp)
    img = st.present().cpu().numpy()     # waits for the device
    secs = time.time() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    if not (np.isfinite(img).all() and img.max() > 0.0):
        raise AssertionError("image is not finite and non-zero")
    if st.ray_count < w * h * spp:
        raise AssertionError(f"ray_count {st.ray_count} < pixels x spp")
    return st, img, secs, launches, peak


def nee_path(dev, card, kernels, out, k1_probe_err, textured):
    """The environment-NEE headline, untextured (no texture stage) or
    textured (the bench's real headline, with the texture stage); returns
    the textured headline's (settings, resources, scene arrays)."""
    from metal_pathtracer_tpu_torch import constants as C
    from metal_pathtracer_tpu_torch.ops import env as env_ops
    from metal_pathtracer_tpu_torch.ops.kernels import shade as S
    from metal_pathtracer_tpu_torch.ops.kernels import texture as X
    from metal_pathtracer_tpu_torch.ops.kernels import traverse as T
    from metal_pathtracer_tpu_torch.renderer import frame
    from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
    from metal_pathtracer_tpu_torch.utils import benchscene

    name = "headline" if textured else "headline (untextured)"
    make_scene = benchscene.build_bench_scene if textured \
        else benchscene.build_untextured_bench_scene

    def build(subdivisions):
        t0 = time.time()
        settings, res, env = make_scene(subdivisions, dev)
        scene = res.build_arrays(environment=env, device=dev)
        torch.cuda.synchronize()
        return settings, res, scene, time.time() - t0

    # ---- every kernel of the path: 160x96 at subdivision 5 vs plain -----
    settings, res, scene, _ = build(CHECK_SUBDIVISIONS)
    w, h = CHECK_FRAME
    static, uni = scene_setup(settings, res, w, h, dev)
    before = X.texture_stage.launches
    st_k = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                static, NEE_CHECK_SPP)
    if textured and X.texture_stage.launches == before:
        raise AssertionError("the textured check render launched no "
                             "texture stage")
    with plain_kernels():
        st_p = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                    static, NEE_CHECK_SPP)
    kernels_used = "texture stage + K2 s1/s2 + K1 any-hit" if textured \
        else "K2 s1/s2 + K1 any-hit"
    nee_err = image_gate(
        st_k.present().cpu().numpy(), st_p.present().cpu().numpy(),
        (st_k.ray_count, st_k.shadow_ray_count),
        (st_p.ray_count, st_p.shadow_ray_count),
        f"{name}: {kernels_used} {w}x{h} {NEE_CHECK_SPP}spp kernel vs "
        f"plain")

    # ---- the headline at full size -------------------------------------
    settings, res, scene, setup_s = build(HEADLINE_SUBDIVISIONS)
    nodes = scene.tri_bvh.packed_nodes()
    recs = scene.tri_bvh.slot_records(scene.triangles)
    print(f"# {name} scene: {scene.triangles.count} triangles, "
          f"{scene.tri_bvh.node_count} BVH nodes, "
          f"{scene.environment.width}x{scene.environment.height} sky, "
          f"set-up {setup_s:.1f}s; K1's layout: {nodes.shape[0]} packed "
          f"nodes, {nodes.numel() * 4} B, and {recs.shape[0]} slot records, "
          f"{recs.numel() * 4} B")
    if not textured:
        o, d, tmax = (torch.from_numpy(x).to(dev) for x in probes(scene))
        occ = T.trace_any(o, d, C.EPSILON_T, tmax, scene.tri_bvh,
                          scene.triangles)
        compare_flags(occ, T.trace_any_reference(o, d, C.EPSILON_T, tmax,
                                                 scene.tri_bvh,
                                                 scene.triangles),
                      "K1 any-hit probes")
        print(f"K1 any-hit probes: flags bit-equal over {o.shape[0]} lanes, "
              f"{int(occ.sum())} occluded")

    W, H = FRAME
    spp = NEE_TIMED_SPP if textured else UNTEXTURED_TIMED_SPP
    st, img, secs, launches, peak = timed_render(scene, settings, res, W, H,
                                                 spp, dev, kernels)
    path = ("trace_closest", "trace_any", "shade_s1", "shade_s2") \
        + (("texture_stage",) if textured else ())
    if min(launches[k] for k in path) <= 0:
        raise AssertionError(f"a kernel of the {name} path was not "
                             f"launched: {launches}")
    traces = st.ray_count + st.shadow_ray_count
    print(f"{name} {W}x{H} d8: {spp} spp in {secs:.3f}s, "
          f"{1e3 * secs / spp:.2f} ms/spp, {traces / secs / 1e6:.2f} Mrays/s "
          f"({st.ray_count} closest + {st.shadow_ray_count} shadow traces), "
          f"peak {peak / 2**20:.0f} MiB, set-up {setup_s:.1f}s, launches "
          f"{launches}, mean {float(img.mean()):.4f} [{card}]")

    if textured:
        # ---- refdefault: the same scene at 1280x720, maxDepth 20 --------
        # (the headline's resources and arrays; only maxDepth differs)
        ref_settings, ref_res, _ = benchscene.build_refdefault_scene(
            HEADLINE_SUBDIVISIONS, dev)
        rw, rh = benchscene.REFDEFAULT_FRAME
        st_r, img_r, secs_r, launches_r, peak_r = timed_render(
            scene, ref_settings, ref_res, rw, rh, REFDEFAULT_TIMED_SPP, dev,
            kernels)
        traces_r = st_r.ray_count + st_r.shadow_ray_count
        spp_r = REFDEFAULT_TIMED_SPP
        print(f"refdefault {rw}x{rh} d20: {spp_r} spp in {secs_r:.3f}s, "
              f"{1e3 * secs_r / spp_r:.2f} ms/spp, "
              f"{traces_r / secs_r / 1e6:.2f} Mrays/s ({st_r.ray_count} "
              f"closest + {st_r.shadow_ray_count} shadow traces), peak "
              f"{peak_r / 2**20:.0f} MiB, launches {launches_r}, mean "
              f"{float(img_r.mean()):.4f} [{card}]")

    # ---- every kernel vs plain at the first-depth wavefront ------------
    n = W * H
    static, uni = scene_setup(settings, res, W, H, dev)
    params = S.ShadeParams.of(uni, static, scene.environment)
    carry = primary_carry(uni, static, dev)
    k1_args = trace_inputs(carry, scene)
    k1_ms, k1_win = timed(lambda: lambda: T.trace_closest(*k1_args), 5)
    k1_plain_ms = cuda_ms(lambda: lambda: T.trace_closest_reference(
        *k1_args), 1)
    hit = T.trace_closest(*k1_args)
    walk = {}
    k1_err = max(k1_probe_err, compare_trace(
        hit, T.trace_closest_reference(*k1_args, walk=walk)))
    k1_b, k1_by, k1_old = k1_bounds(walk, closest_lane_bytes(n, n),
                                     K1_CLOSEST_SLOT_BYTES)

    tex = None
    if textured:
        tex_params = X.TexParams.of(uni, static, scene.textures)

        def tex_run(fn):
            def prep():
                c = clone(carry)
                return lambda: fn(c, *hit, scene, uni, static, 0, tex_params)
            return prep

        tex_ms, tex_win = timed(tex_run(X.texture_stage), 5)
        tex_plain_ms = cuda_ms(tex_run(X.texture_stage_reference), 2)
        ck, cp = clone(carry), clone(carry)
        tex = X.texture_stage(ck, *hit, scene, uni, static, 0, tex_params)
        tex_p = X.texture_stage_reference(cp, *hit, scene, uni, static, 0)
        torch.cuda.synchronize()
        tex_err = compare_texture(tex, tex_p, ck, cp,
                                  f"{name} first-depth texture stage")
        tex_b, tex_by, tex_old = texture_bound(scene, static, carry, hit,
                                               tex_p)
        carry = ck   # the stage's BLEND draws land before s1
        n_tex = int((tex_p[:, -1] > 0.5).sum())

    envbg = env_ops.environment_background(
        scene.environment, carry.ray_d, uni, static, carry.env_lod,
        carry.env_lod_active)
    envpdf = env_ops.environment_pdf(scene.environment, carry.ray_d,
                                     uni.environment_rotation)
    n_hit = int((hit[1] >= 0).sum())

    def s1_run(fn):
        def prep():
            c = clone(carry)
            return lambda: fn(c, *hit, scene.triangles, scene.materials,
                              envbg, envpdf, params, 0, tex)
        return prep

    s1_ms, s1_win = timed(s1_run(S.shade_s1), 5)
    s1_plain_ms = cuda_ms(s1_run(S.shade_s1_reference), 2)
    ck, cp = clone(carry), clone(carry)
    trans = S.shade_s1(ck, *hit, scene.triangles, scene.materials, envbg,
                       envpdf, params, 0, tex)
    trans_p = S.shade_s1_reference(cp, *hit, scene.triangles,
                                   scene.materials, envbg, envpdf, params, 0,
                                   tex)
    torch.cuda.synchronize()
    differ, s1_err = carry_error(ck, cp, n)
    s1_err = max(s1_err, float((trans - trans_p).abs().max()))
    s1_bound, s1_by = k2_bound(
        "shade_s1", n_hit, n - n_hit, 0, textured,
        n_tex=int((tex[:, -1] > 0.5).sum()) if textured else None,
        **s1_counts(carry, hit[1]))
    # the charge before PR 8: 238 + 32 B a hit, its 60 B of planes
    s1_old = bound_ms(n_hit * (270 + (TEX_BYTES if textured else 0))
                      + (n - n_hit) * 72 + n * 72, 0)[0]
    if differ > 1e-4 * n or not s1_err <= 1e-4:
        raise AssertionError(f"K2 s1 disagrees with its plain version: "
                             f"{differ} lanes, err {s1_err}")

    # the first-depth shadow wavefront (trace_paths_nee's alias + offset)
    e_dir, e_rad, e_pdf, e_valid = env_ops.sample_environment_from_uniforms(
        scene.environment, trans[:, 0], trans[:, 1], trans[:, 2], uni,
        static)
    sh_o, sh_max, do_sh = S.nee_shadow_rays(trans, hit[0], e_dir, e_pdf,
                                            e_valid, tex)
    sh_args = (sh_o, e_dir.contiguous(), C.EPSILON_T, sh_max, scene.tri_bvh,
               scene.triangles)
    any_ms, any_win = timed(lambda: lambda: T.trace_any(*sh_args), 5)
    any_plain_ms = cuda_ms(lambda: lambda: T.trace_any_reference(*sh_args), 1)
    occ = T.trace_any(*sh_args)
    walk_any = {}
    compare_flags(occ, T.trace_any_reference(*sh_args, walk=walk_any),
                  "K1 any-hit first-depth shadow wavefront")
    n_sh = int(do_sh.sum())
    # per lane: the window read and the flag written; shadow lanes also
    # read their ray; plus the nodes and triangles the walks touched up to
    # each lane's first hit
    any_bound, any_by, any_old = k1_bounds(walk_any, any_lane_bytes(n, n_sh),
                                           K1_ANY_SLOT_BYTES)
    esmp = torch.cat([e_dir, e_rad, e_pdf[:, None],
                      e_valid[:, None].to(torch.float32),
                      occ[:, None].to(torch.float32)], 1)

    n_live = int(ck.alive.sum())

    def s2_run(fn):
        def prep():
            c = clone(ck)
            return lambda: fn(c, *hit, scene.triangles, scene.materials,
                              trans, esmp, params, 0, tex)
        return prep

    s2_ms, s2_win = timed(s2_run(S.shade_s2), 5)
    s2_plain_ms = cuda_ms(s2_run(S.shade_s2_reference), 2)
    c2k, c2p = clone(ck), clone(ck)
    chain = S.shade_s2(c2k, *hit, scene.triangles, scene.materials, trans,
                       esmp, params, 0, tex)
    chain_p = S.shade_s2_reference(c2p, *hit, scene.triangles,
                                   scene.materials, trans, esmp, params, 0,
                                   tex)
    torch.cuda.synchronize()
    differ2, s2_err = carry_error(c2k, c2p, n)
    s2_err = max(s2_err, float(((chain - chain_p).abs()
                                / chain_p.abs().clamp_min(1.0)).max()))
    s2_bound, s2_by, s2_old = s2_bounds(n, n_live, tex, ck, hit[1])
    if differ2 > 1e-4 * n or not s2_err <= 1e-4:
        raise AssertionError(f"K2 s2 disagrees with its plain version: "
                             f"{differ2} lanes, err {s2_err}")
    tex_line = (f"texture stage {tex_ms:.4f} / {tex_win:.3f} ms (plain "
                f"{tex_plain_ms:.1f} ms, bound {tex_b:.4f} ms by {tex_by}, "
                f"{tex_old:.4f} at the charge before PR 8, {n_tex} "
                f"textured lanes, largest plane difference {tex_err:.2e}); "
                if textured else "")
    print(f"{name} first depth ({n} lanes, {n_hit} hits, {n_sh} shadow "
          f"rays; kernel ms on the device, then around the wrapper): K1 "
          f"{k1_ms:.3f} / {k1_win:.3f} ms (plain {k1_plain_ms:.1f} ms, bound "
          f"{k1_b:.4f} ms by {k1_by}, old layout {k1_old:.4f}, "
          f"{int(walk['nodes'].sum())} nodes "
          f"and {int(walk['slots'].sum())} triangles touched); {tex_line}"
          f"K1 any-hit {any_ms:.3f} / {any_win:.3f} ms (plain "
          f"{any_plain_ms:.1f} ms, bound "
          f"{any_bound:.4f} ms by {any_by}, old layout {any_old:.4f}, "
          f"{int(walk_any['nodes'].sum())} nodes and "
          f"{int(walk_any['slots'].sum())} triangles touched); K2 s1 "
          f"{s1_ms:.3f} / {s1_win:.3f} ms (plain {s1_plain_ms:.1f} ms, bound "
          f"{s1_bound:.4f} ms, {s1_old:.4f} at the charge before PR 8, err "
          f"{s1_err:.2e}, {differ} differing lanes); "
          f"K2 s2 {s2_ms:.3f} / {s2_win:.3f} ms (plain {s2_plain_ms:.1f} "
          f"ms, bound {s2_bound:.4f} ms, {s2_old:.4f} at the charge before "
          f"PR 9, err {s2_err:.2e}, {differ2} differing lanes) [{card}]")
    if not textured:
        return

    # ---- K1 past the first depth: live lanes per launch, depth 1 --------
    depth1_err = k1_depth1(scene, uni, static, dev, card)

    # ---- the texture stage and s1 at every depth of one sample ---------
    tex_depth_err, s1_depth_err, s2_depth_err = k2_depths(scene, uni,
                                                          static, dev, card)

    # ---- the texture kernel on the all-six-slots scene ------------------
    six_settings, six_res = benchscene.build_six_slot_scene()
    six_scene = six_res.build_arrays(device=dev)
    w6, h6 = CHECK_FRAME
    six_err = texture_probe(dev, card, "six-slot scene", six_settings,
                            six_res, six_scene, w6, h6, (0, 2))

    out["trace_closest"] = dict(
        source=ROOT + "traverse.cu",
        replaces="metal_pathtracer_tpu/ops/pallas/traverse.py:60",
        launches=launches["trace_closest"],
        max_abs_err=max(k1_err, depth1_err), ms=k1_ms,
        plain_ms=k1_plain_ms, bound_ms=k1_b, bound_by=k1_by)
    out["trace_any"] = dict(
        source=ROOT + "traverse.cu",
        replaces="metal_pathtracer_tpu/ops/pallas/traverse.py:60",
        launches=launches["trace_any"], max_abs_err=0.0, ms=any_ms,
        plain_ms=any_plain_ms, bound_ms=any_bound, bound_by=any_by)
    if textured:
        K2_NOW["textured headline s1"] = s1_ms
        K2_NOW["textured headline s2"] = s2_ms
    out["shade_s1"] = dict(
        source=ROOT + "shade.cu",
        replaces="metal_pathtracer_tpu/ops/pallas/shade.py:1845",
        launches=launches["shade_s1"],
        max_abs_err=max(nee_err, s1_err, s1_depth_err),
        ms=s1_ms, plain_ms=s1_plain_ms, bound_ms=s1_bound, bound_by=s1_by)
    out["shade_s2"] = dict(
        source=ROOT + "shade.cu",
        replaces="metal_pathtracer_tpu/ops/pallas/shade.py:1845",
        launches=launches["shade_s2"],
        max_abs_err=max(nee_err, s2_err, s2_depth_err),
        ms=s2_ms, plain_ms=s2_plain_ms, bound_ms=s2_bound, bound_by=s2_by)
    out["texture_stage"] = dict(
        source=ROOT + "texture.cu",
        # an XLA stage in the JAX package, not a TPU kernel
        replaces="metal_pathtracer_tpu/ops/pallas/shade.py:3600",
        launches=launches["texture_stage"],
        max_abs_err=max(nee_err, tex_err, six_err, tex_depth_err),
        ms=tex_ms,
        plain_ms=tex_plain_ms, bound_ms=tex_b, bound_by=tex_by)
    return settings, res, scene


#: the textured headline's K1 launches that ``k1_depth1`` and
#: ``utils/ab.py k1`` take from one sample of the frame loop, by (wrapper,
#: index in launch order): the closest-hit launch of each depth, and the
#: environment bank's shadow rays of each depth (any-hit launches by depth:
#: that bank, then the spec-NEE chain's)
K1_WAVES = {"closest depth 0": ("closest", 0),
            "shadow depth 0": ("any", 0),
            "closest depth 1": ("closest", 1),
            "shadow depth 1": ("any", 2)}


def frame_loop_k1(scene, uni, static, dev, keep=()):
    """One sample of the frame loop with K1's wrappers spied on. Returns
    the live lanes (t_max >= t_min) of every launch in launch order,
    {"closest": [...], "any": [...]}, and the inputs of the launches that
    ``keep`` names as (wrapper, index) pairs, cloned as the wrappers take
    them: {(wrapper, index): args}. A host sync per launch, so it runs
    apart from the timed renders."""
    from metal_pathtracer_tpu_torch.ops.kernels import shade as S
    from metal_pathtracer_tpu_torch.ops.kernels import traverse as T
    from metal_pathtracer_tpu_torch.renderer import frame
    from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState

    seen, kept = {"closest": [], "any": []}, {}

    def spy(fn, key):
        def traced(o, d, t_min, t_max, bvh, tris, *ex, **kw):
            n = o.shape[0]
            tm = torch.broadcast_to(torch.as_tensor(
                t_max, dtype=torch.float32, device=o.device), (n,))
            if (key, len(seen[key])) in keep:
                kept[key, len(seen[key])] = (
                    o.clone(), d.clone(), t_min, tm.clone(), bvh, tris,
                    *(T._as_i32(x, n, o.device).clone() for x in ex))
            seen[key].append(int((tm >= t_min).sum()))
            return fn(o, d, t_min, t_max, bvh, tris, *ex, **kw)
        # the wrappers count their launches on the name they are called
        # by, here the spy's
        traced.launches = 0
        return traced

    closest = spy(T.trace_closest, "closest")
    with mock.patch.object(S, "trace_closest", closest), \
            mock.patch.object(T, "trace_closest", closest), \
            mock.patch.object(T, "trace_any", spy(T.trace_any, "any")):
        frame.render_samples(scene, uni, RenderState.create(
            static.width, static.height, dev), static, 1)
    return seen, kept


def k1_launch_bound(key, args):
    """One kept K1 launch (``frame_loop_k1``): the kernel held bit for bit
    against its plain walk, and the walk's bound (``k1_bounds``) at the
    closest-hit or any-hit charge: (ms, by)."""
    from metal_pathtracer_tpu_torch.ops.kernels import traverse as T

    n, walk = args[0].shape[0], {}
    n_live = int((args[3] >= args[2]).sum())
    if key == "closest":
        compare_trace(T.trace_closest(*args),
                      T.trace_closest_reference(*args, walk=walk))
        b, by, _ = k1_bounds(walk, closest_lane_bytes(n, n_live),
                             K1_CLOSEST_SLOT_BYTES)
    else:
        compare_flags(T.trace_any(*args),
                      T.trace_any_reference(*args, walk=walk),
                      "K1 any-hit on a kept launch")
        b, by, _ = k1_bounds(walk, any_lane_bytes(n, n_live),
                             K1_ANY_SLOT_BYTES)
    return b, by


def k1_depth1(scene, uni, static, dev, card):
    """K1 past the first depth on the textured headline: the live lanes and
    the device time of every K1 launch of one sample of the frame loop,
    and closest-hit and
    any-hit on that sample's depth-1 wavefronts (secondary rays and the
    environment bank's shadow rays), bit-equal to the plain walks,
    device-timed, each with its live lanes and its bound beside the old
    one. Returns the largest |t| difference (0: equal bits)."""
    from metal_pathtracer_tpu_torch.ops.kernels import traverse as T

    # the launches of the first K1_CHECK_DEPTHS depths: one closest-hit
    # and up to two any-hit a depth
    live, waves = frame_loop_k1(scene, uni, static, dev, keep=tuple(
        (key, k) for key in ("closest", "any")
        for k in range(K1_CHECK_DEPTHS * (1 if key == "closest" else 2))))
    print(f"K1 live lanes per launch over one {static.width}x"
          f"{static.height} sample of the frame loop (closest: one per "
          f"depth; any-hit: the environment and the spec-NEE shadow rays "
          f"per depth): closest {live['closest']}, any-hit {live['any']} "
          f"[{card}]")
    kept = {key: [k for k in range(len(live[key])) if (key, k) in waves]
            for key in live}
    per_launch = {key: [kernel_ms((lambda a, fn: lambda: lambda: fn(*a))(
        waves[key, k], T.trace_closest if key == "closest" else T.trace_any),
        5) for k in kept[key]] for key in live}
    bounds = {key: [k1_launch_bound(key, waves[key, k]) for k in kept[key]]
              for key in live}
    print(f"K1 device ms per launch of that sample's first {K1_CHECK_DEPTHS} "
          "depths, each bit-equal to the "
          "plain walk, beside its bound (ms, by bytes unless marked ops): "
          + "; ".join(
              f"{key} " + ", ".join(
                  f"{ms:.4f} ({b:.4f}{'' if by == 'bytes' else ' ops'})"
                  for ms, (b, by) in zip(times, bounds[key]))
              + f" (sum {sum(times):.4f}, bounds "
              f"{sum(b for b, _ in bounds[key]):.4f})"
              for key, times in per_launch.items()) + f" [{card}]")
    args = waves[K1_WAVES["closest depth 1"]]
    sh_args = waves[K1_WAVES["shadow depth 1"]]
    n = args[0].shape[0]
    n_live = int((args[3] >= args[2]).sum())
    n_sh = int((sh_args[3] >= sh_args[2]).sum())
    walk, walk_any = {}, {}
    err = compare_trace(T.trace_closest(*args),
                        T.trace_closest_reference(*args, walk=walk))
    occ = T.trace_any(*sh_args)
    compare_flags(occ, T.trace_any_reference(*sh_args, walk=walk_any),
                  "K1 any-hit depth-1 shadow wavefront")
    ms = kernel_ms(lambda: lambda: T.trace_closest(*args), 5)
    any_ms = kernel_ms(lambda: lambda: T.trace_any(*sh_args), 5)
    b, by, b_old = k1_bounds(walk, closest_lane_bytes(n, n_live),
                             K1_CLOSEST_SLOT_BYTES)
    ab, aby, ab_old = k1_bounds(walk_any, any_lane_bytes(n, n_sh),
                                K1_ANY_SLOT_BYTES)
    print(f"K1 depth 1 ({n} lanes; device ms, bit-equal to the plain walks): "
          f"closest {ms:.4f} ms on {n_live} live lanes ({walk['node_visits']} "
          f"slab and {walk['tri_tests']} triangle tests; bound {b:.4f} ms by "
          f"{by}, old layout {b_old:.4f}; {int(walk['nodes'].sum())} nodes "
          f"and {int(walk['slots'].sum())} triangles touched); any-hit "
          f"{any_ms:.4f} ms on {n_sh} live lanes ({walk_any['node_visits']} "
          f"slab and {walk_any['tri_tests']} triangle tests; {int(occ.sum())} "
          f"occluded; bound {ab:.4f} ms by {aby}, old layout {ab_old:.4f}) "
          f"[{card}]")
    return err


def _kept(x):
    """A spied argument as a later launch takes it: tensors and carries
    cloned (a clone keeps the strides), everything else as it is."""
    from metal_pathtracer_tpu_torch.ops.integrator import PathCarry

    if isinstance(x, torch.Tensor):
        return x.clone()
    return clone(x) if isinstance(x, PathCarry) else x


def frame_loop_k2(scene, uni, static, dev, keep=()):
    """One sample of the frame loop with the texture stage and K2 s1 and
    s2 spied on. Returns per depth {"live", "hit", "textured", "s2_live"}
    (live lanes, live hits, lanes the texture stage textured, s2's live
    lanes; "textured" absent without texture) and the inputs of the three
    at the depths in ``keep``, cloned as the wrappers take them:
    {("tex" | "s1" | "s2", depth): (args, kwargs)}. A host sync per
    launch, so it runs apart from the timed renders."""
    from metal_pathtracer_tpu_torch.ops.kernels import shade as S
    from metal_pathtracer_tpu_torch.ops.kernels import texture as X
    from metal_pathtracer_tpu_torch.renderer import frame
    from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState

    rows, kept = [], {}
    real_tex, real_s1, real_s2 = S.texture_stage, S.shade_s1, S.shade_s2

    def tex_spy(*args):
        depth = len(rows)
        if depth in keep:
            kept["tex", depth] = (tuple(_kept(x) for x in args), {})
        out = real_tex(*args)
        rows.append({"textured": int((out[:, X.TEX_IDX["tpbr"]] > 0.5)
                                     .sum())})
        return out

    def s1_spy(carry, t, idx, *args, **kw):
        depth = s1_spy.calls
        s1_spy.calls += 1
        if len(rows) == depth:          # an untextured scene
            rows.append({})
        rows[depth].update(live=int(carry.alive.sum()),
                           hit=int((carry.alive & (idx >= 0)).sum()))
        if depth in keep:
            kept["s1", depth] = (tuple(_kept(x) for x in
                                       (carry, t, idx, *args)),
                                 {k: _kept(x) for k, x in kw.items()})
        return real_s1(carry, t, idx, *args, **kw)

    def s2_spy(carry, *args, **kw):
        depth = s2_spy.calls
        s2_spy.calls += 1
        rows[depth]["s2_live"] = int(carry.alive.sum())
        if depth in keep:
            kept["s2", depth] = (tuple(_kept(x) for x in (carry, *args)),
                                 {k: _kept(x) for k, x in kw.items()})
        return real_s2(carry, *args, **kw)

    # the wrappers count their launches on the name they are called by
    s1_spy.calls = s1_spy.launches = s2_spy.calls = s2_spy.launches = 0
    with mock.patch.object(S, "texture_stage", tex_spy), \
            mock.patch.object(S, "shade_s1", s1_spy), \
            mock.patch.object(S, "shade_s2", s2_spy):
        frame.render_samples(scene, uni, RenderState.create(
            static.width, static.height, dev), static, 1)
    return rows, kept


def _k2_wrapper(which):
    from metal_pathtracer_tpu_torch.ops.kernels import shade as S
    from metal_pathtracer_tpu_torch.ops.kernels import texture as X

    return {"tex": X.texture_stage, "s1": S.shade_s1,
            "s2": S.shade_s2}[which]


def k2_launch(kept, which, depth):
    """``kernel_ms``'s ``prepare`` for a kept texture-stage, s1 or s2
    launch: each run on a fresh clone of the kept carry."""
    fn = _k2_wrapper(which)
    args, kw = kept[which, depth]

    def prepare():
        a = (clone(args[0]),) + args[1:]
        return lambda: fn(*a, **kw)
    return prepare


def k2_once(kept, which, depth, fn=None):
    """One run of a kept launch on a fresh clone of its carry, by the
    wrapper (or ``fn``, e.g. the plain version): (output, carry)."""
    args, kw = kept[which, depth]
    carry = clone(args[0])
    return (fn or _k2_wrapper(which))(carry, *args[1:], **kw), carry


def k2_digest(out, carry) -> str:
    """SHA-256 of a launch's result in one layout: the (N, k) output made
    contiguous (none for stage full), then every carry tensor (the state
    included)."""
    import hashlib

    h = hashlib.sha256()
    for x in ([] if out is None else [out]) + list(vars(carry).values()):
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def kernel_resources(log: str) -> dict:
    """{instantiation: (registers, spill store bytes, spill load bytes)}
    from the build's ``-Xptxas -v`` output."""
    import re

    from metal_pathtracer_tpu_torch.ops.kernels import build

    out, current, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current, spills = build._kernel_name(m.group(1)), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            out[current] = (int(m.group(1)), *spills)
            current = None
    return out


def k2_depths(scene, uni, static, dev, card):
    """The texture stage, K2 s1 and K2 s2 at every depth of one sample of
    the textured headline's frame loop (``frame_loop_k2``): each against
    its plain version at depths 0 and 1 (the outputs plane-major; state
    and flags exact, planes within TEX_PLANE_TOL; s1's and s2's carry,
    transients and chain within 1e-4, as at the first depth), then each
    depth's device time (``kernel_ms``) beside its bound, with its live,
    hit and textured lanes, and the sums over the sample. Returns the
    largest plane, s1 and s2 differences."""
    from metal_pathtracer_tpu_torch.ops.kernels import build
    from metal_pathtracer_tpu_torch.ops.kernels import shade as S
    from metal_pathtracer_tpu_torch.ops.kernels import texture as X

    rows, kept = frame_loop_k2(scene, uni, static, dev,
                               keep=range(static.max_depth))
    n = static.width * static.height
    tex_err = s1_err = s2_err = 0.0
    for depth in (0, 1):
        got, ck = k2_once(kept, "tex", depth)
        want, cp = k2_once(kept, "tex", depth, X.texture_stage_reference)
        torch.cuda.synchronize()
        build.check_planes("texture stage", got, n, len(X.TEX))
        tex_err = max(tex_err, compare_texture(
            got, want, ck, cp, f"textured headline depth {depth} texture "
            f"stage"))
        got, ck = k2_once(kept, "s1", depth)
        want, cp = k2_once(kept, "s1", depth, S.shade_s1_reference)
        torch.cuda.synchronize()
        build.check_planes("K2 s1", got, n, len(S.TRANS))
        differ, err = carry_error(ck, cp, n)
        err = max(err, float((got - want).abs().max()))
        if differ > 1e-4 * n or not err <= 1e-4:
            raise AssertionError(f"K2 s1 at depth {depth} disagrees with its "
                                 f"plain version: {differ} lanes, err {err}")
        s1_err = max(s1_err, err)
        got, ck = k2_once(kept, "s2", depth)
        want, cp = k2_once(kept, "s2", depth, S.shade_s2_reference)
        torch.cuda.synchronize()
        build.check_planes("K2 s2", got, n, len(S.CHAIN))
        differ, err = carry_error(ck, cp, n)
        err = max(err, float(((got - want).abs()
                              / want.abs().clamp_min(1.0)).max()))
        if differ > 1e-4 * n or not err <= 1e-4:
            raise AssertionError(f"K2 s2 at depth {depth} disagrees with its "
                                 f"plain version: {differ} lanes, err {err}")
        s2_err = max(s2_err, err)
    print(f"textured headline depths 0 and 1: the texture stage, K2 s1 and "
          f"K2 s2 against their plain versions, outputs plane-major: state "
          f"and flags bit-equal, largest plane difference {tex_err:.2e}, s1 "
          f"err {s1_err:.2e}, s2 err {s2_err:.2e} [{card}]")
    sums = [0.0] * 7
    for depth, row in enumerate(rows):
        args = kept["tex", depth][0]
        tex_ms = kernel_ms(k2_launch(kept, "tex", depth), 5)
        s1_ms = kernel_ms(k2_launch(kept, "s1", depth), 5)
        s2_ms = kernel_ms(k2_launch(kept, "s2", depth), 5)
        planes, _ = k2_once(kept, "tex", depth)
        tex_b, tex_by, tex_old = texture_bound(scene, static, args[0],
                                               args[1:5], planes)
        s1_args = kept["s1", depth][0]
        s1_b, s1_by = k2_bound("shade_s1", row["hit"],
                               row["live"] - row["hit"], n - row["live"],
                               textured=True, n_tex=row["textured"],
                               **s1_counts(s1_args[0], s1_args[2]))
        s2_args = kept["s2", depth][0]
        s2_b, s2_by, s2_old = s2_bounds(n, row["s2_live"], s2_args[11],
                                        s2_args[0], s2_args[2])
        for k, x in enumerate((tex_ms, tex_b, s1_ms, s1_b, s2_ms, s2_b,
                               s2_old)):
            sums[k] += x
        print(f"textured headline depth {depth}: {row['live']} live lanes, "
              f"{row['hit']} hits, {row['textured']} textured, "
              f"{row['s2_live']} into s2; texture stage {tex_ms:.4f} ms "
              f"(bound {tex_b:.4f} ms by {tex_by}, {tex_old:.4f} at the "
              f"charge before PR 8), K2 s1 {s1_ms:.4f} ms (bound "
              f"{s1_b:.4f} ms by {s1_by}), K2 s2 {s2_ms:.4f} ms (bound "
              f"{s2_b:.4f} ms by {s2_by}, {s2_old:.4f} at the charge before "
              f"PR 9) [{card}]")
    print(f"textured headline, one sample's {len(rows)} depths: texture "
          f"stage {sums[0]:.4f} ms (bounds {sums[1]:.4f}), K2 s1 "
          f"{sums[2]:.4f} ms (bounds {sums[3]:.4f}), the two together "
          f"{sums[0] + sums[2]:.4f} ms; K2 s2 {sums[4]:.4f} ms (bounds "
          f"{sums[5]:.4f}, {sums[6]:.4f} at the charge before PR 9) "
          f"[{card}]")
    return tex_err, s1_err, s2_err


def compare_nearest(got, ref, label, count_ties=False):
    """A K3 result (t, index) against another: t bit-equal on every lane,
    the index equal too, except (``count_ties``) where two spheres give
    the same t; returns (largest |t| difference, ties)."""
    t_a, i_a = (x.cpu().numpy() for x in got)
    t_b, i_b = (x.cpu().numpy() for x in ref)
    bad_t = t_a.view(np.int32) != t_b.view(np.int32)
    bad_i = i_a != i_b
    if bad_t.any() or (bad_i.any() and not count_ties):
        raise AssertionError(f"{label}: t differs on {int(bad_t.sum())} and "
                             f"the index on {int(bad_i.sum())} lanes")
    return float(np.abs(t_a - t_b).max()), int(bad_i.sum())


def k3_bound(name, n, n_live, prims, group_tests=0):
    """A K3 kernel's bound: each lane's ray and hit, the primitive set
    once; the sphere or rectangle tests of the live lanes (K3b: each live
    lane's group box tests and the 16 sphere tests of each of its
    ``group_tests`` group visits)."""
    if name == "rect_nearest":
        return bound_ms(n * K3_LANE_BYTES + prims * K3_RECT_BYTES,
                        n_live * prims * K3_RECT_OPS)
    if name == "sphere_nearest_chunked":
        groups = (prims + 15) // 16
        return bound_ms(n * K3_LANE_BYTES + groups * (16 * K3_SLOT_BYTES
                                                      + K3_BOX_BYTES),
                        n_live * groups * K3_BOX_OPS
                        + group_tests * 16 * K3_SPHERE_OPS)
    return bound_ms(n * K3_LANE_BYTES + prims * K3_SPHERE_BYTES,
                    n_live * prims * K3_SPHERE_OPS)


def frame_loop_k3b(scene, uni, static, dev):
    """One sample of the frame loop with K3b spied on: each launch's
    inputs (origin, direction, t_min, t_max, groups), cloned, in launch
    order (on rtow, which has no light integral: one closest-hit launch a
    depth). A host sync per launch, so it runs apart from timed renders."""
    from metal_pathtracer_tpu_torch.ops.kernels import primitives as P
    from metal_pathtracer_tpu_torch.renderer import frame
    from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState

    kept, real = [], P.sphere_nearest_chunked

    def spy(*args):
        kept.append(tuple(_kept(x) for x in args))
        return real(*args)

    spy.launches = 0
    with mock.patch.object(P, "sphere_nearest_chunked", spy):
        frame.render_samples(scene, uni, RenderState.create(
            static.width, static.height, dev), static, 1)
    return kept


def k3b_depths(cell, dev, card):
    """K3b's device time at every depth of one sample of rtow at 1200x675
    (``frame_loop_k3b``), with each depth's live lanes, and the sum: the
    kernel's time a sample. Returns the sum."""
    from metal_pathtracer_tpu_torch.ops.kernels import primitives as P
    from metal_pathtracer_tpu_torch.utils import benchscene as B

    settings, res, scene, _ = cell
    static, uni = scene_setup(settings, res, *B.RTOW_FRAME, dev)
    kept = frame_loop_k3b(scene, uni, static, dev)
    total, parts = 0.0, []
    for args in kept:
        ms = kernel_ms(lambda: lambda: P.sphere_nearest_chunked(*args), 5)
        live = int((P._prepare(args[0], args[3]) >= args[2]).sum())
        total += ms
        parts.append(f"{ms:.4f} ({live})")
    print(f"K3b at each of one rtow sample's {len(kept)} depths, ms on the "
          f"device (live lanes): {', '.join(parts)}; {total:.4f} ms a "
          f"sample [{card}]")
    return total


def call_kind() -> str:
    """Which trace made a K3 launch, read from the caller's stack: "walk"
    (the random walk), "chain" (a spec-NEE chain's re-trace or shadow
    test), "shadow" (``intersect.trace_occluded``) or "closest"
    (``intersect.trace_merged``)."""
    kind, f = "closest", sys._getframe(2)
    while f is not None:
        name, path = f.f_code.co_name, f.f_code.co_filename
        if name == "sample_sss_random_walk":
            return "walk"
        if path.endswith("specnee.py"):
            return "chain"
        if name == "trace_occluded":
            kind = "shadow"
        f = f.f_back
    return kind


def frame_loop_k3(scene, uni, static, dev, name):
    """One sample of the frame loop with the K3 wrapper ``name`` of
    ``ops/kernels/primitives.py`` (``rect_nearest``, K3c;
    ``sphere_nearest_brute``, K3a) spied on: each launch as (``call_kind``,
    its inputs (origin, direction, t_min, t_max, primitives) cloned), in
    launch order. A host sync per launch, so it runs apart from timed
    renders."""
    from metal_pathtracer_tpu_torch.ops.kernels import primitives as P
    from metal_pathtracer_tpu_torch.renderer import frame
    from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState

    kept, real = [], getattr(P, name)

    def spy(*args):
        kept.append((call_kind(), tuple(_kept(x) for x in args)))
        return real(*args)

    spy.launches = 0
    with mock.patch.object(P, name, spy):
        frame.render_samples(scene, uni, RenderState.create(
            static.width, static.height, dev), static, 1)
    return kept


#: the plain version of each K3 wrapper that ``k3_depths`` times
K3_PLAIN = {"rect_nearest": "rect_nearest_reference",
            "sphere_nearest_brute": "sphere_nearest_reference"}
#: a launch "sits at the floor" within this factor of the same launch
#: with every lane dead
FLOOR_SLACK = 1.15


def k3_depths(label, name, cell, size, dev, card):
    """K3c or K3a (``name``) at every launch of one sample of a cell
    ((settings, resources, environment or None) at ``size``), kept by
    ``frame_loop_k3``: each launch bit for bit against its plain version,
    its call, lanes and live lanes, its device time beside its bound
    (``k3_bound``) and beside the same launch with every lane dead (the
    sweep's floor at that width), then the sums a sample by call. Returns
    {"ms", "bound", "launches", "floor": launches at the floor}."""
    from metal_pathtracer_tpu_torch.ops.kernels import primitives as P

    settings, res, env = cell
    scene = res.build_arrays(environment=env, device=dev)
    static, uni = scene_setup(settings, res, *size, dev)
    kept = frame_loop_k3(scene, uni, static, dev, name)
    fn, plain = getattr(P, name), getattr(P, K3_PLAIN[name])
    rows, floors = [], {}
    for k, (kind, args) in enumerate(kept):
        o, d, t_min, t_max, prims = args
        tm = P._prepare(o, t_max)
        n, live = o.shape[0], int((tm >= t_min).sum())
        compare_nearest(fn(*args), plain(o, d, t_min, tm, prims),
                        f"{name} {label} launch {k} ({kind})")
        ms = kernel_ms(lambda: lambda: fn(*args), 5)
        if n not in floors:
            dead = torch.zeros_like(tm)
            floors[n] = kernel_ms(
                lambda: lambda: fn(o, d, 1.0, dead, prims), 5)
        b, by = k3_bound(name, n, live, prims.count)
        rows.append(dict(kind=kind, n=n, live=live, ms=ms, bound=b, by=by,
                         floor=ms <= FLOOR_SLACK * floors[n]))
    print(f"{name} at each of one {label} {size[0]}x{size[1]} sample's "
          f"{len(rows)} launches, bit-equal to {K3_PLAIN[name]}; call "
          f"lanes/live: device ms (bound ms), * at the floor: " + ", ".join(
              f"{r['kind']} {r['n']}/{r['live']}: {r['ms']:.4f} "
              f"({r['bound']:.4f}){'*' if r['floor'] else ''}"
              for r in rows) + f" [{card}]")
    sums = {}
    for r in rows:
        acc = sums.setdefault(r["kind"], [0, 0.0, 0.0, 0])
        acc[0] += 1
        acc[1] += r["ms"]
        acc[2] += r["bound"]
        acc[3] += r["floor"]
    total = sum(r["ms"] for r in rows)
    bound = sum(r["bound"] for r in rows)
    print(f"{name} {label} a sample: {total:.4f} ms in {len(rows)} launches "
          f"against a bound of {bound:.4f} ({100 * bound / total:.1f} %); "
          f"by call: " + ", ".join(
              f"{kind} {c} launches {ms:.4f} ms (bound {b:.4f}; {fl} at the "
              f"floor)" for kind, (c, ms, b, fl) in sums.items())
          + "; the floor (every lane dead) at each width: " + ", ".join(
              f"{n} lanes {ms:.4f}" for n, ms in floors.items())
          + f" [{card}]")
    return dict(ms=total, bound=bound, launches=len(rows),
                floor=sum(r["floor"] for r in rows))


def k3c_depths(dev, card):
    """K3c at every launch of one sample of the Cornell box (512x512) and
    of cornell-emitenv, and K3a at every launch of one sample of the
    Cornell box, ``materials.scene`` (960x320) and materials-env-rw (its
    random walk's launches included), through ``k3_depths``."""
    from metal_pathtracer_tpu_torch.utils import benchscene as B

    cornell = (*B.build_cornell_scene(), None)
    emitenv = B.build_cornell_emitenv_scene(dev)
    for label, name, cell, size in (
            ("cornell", "rect_nearest", cornell, B.CORNELL_FRAME),
            ("cornell-emitenv", "rect_nearest", emitenv, B.CORNELL_FRAME),
            ("cornell", "sphere_nearest_brute", cornell, B.CORNELL_FRAME),
            ("materials", "sphere_nearest_brute",
             (*B.build_materials_scene(), None), B.MATERIALS_FRAME),
            ("materials-env-rw", "sphere_nearest_brute",
             B.build_materials_env_rw_scene(dev), B.MATERIALS_FRAME)):
        k3_depths(label, name, cell, size, dev, card)


def frame_loop_full(scene, uni, static, dev, keep=None):
    """One sample of the frame loop with K2 ``full`` spied on: the inputs
    of each launch (of the first ``keep`` depths; None: all), cloned as
    the wrapper takes them, in launch order (one a depth): [(args,
    kwargs)]. A host sync per launch, so it runs apart from timed
    renders."""
    from metal_pathtracer_tpu_torch.ops.kernels import shade as S
    from metal_pathtracer_tpu_torch.renderer import frame
    from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState

    kept, real = [], S.shade_full

    def spy(*args, **kw):
        if keep is None or len(kept) < keep:
            kept.append((tuple(_kept(x) for x in args),
                         {k: _kept(x) for k, x in kw.items()}))
        return real(*args, **kw)

    spy.launches = 0
    with mock.patch.object(S, "shade_full", spy):
        frame.render_samples(scene, uni, RenderState.create(
            static.width, static.height, dev), static, 1)
    return kept


def full_counts(scene, carry, idx, kind):
    """What one K2 ``full`` launch's lanes are, from its inputs: dead,
    live, misses, triangle and analytic hits, hits per material type,
    distinct triangle rows and analytic primitives of the hits, first
    hits, and the distinct (warp of 32 lanes, lane kind) pairs, a lane's
    kind being dead, a miss or its hit's material type (how much
    divergence a warp over consecutive lanes holds)."""
    from metal_pathtracer_tpu_torch import constants as C

    n = idx.shape[0]
    live = carry.alive
    hit = live & (idx >= 0)
    fam = torch.full_like(idx, C.PRIMITIVE_TRIANGLE) if kind is None \
        else kind
    safe = idx.clamp_min(0).long()
    mat = torch.zeros_like(idx)
    for f, count, prims in ((C.PRIMITIVE_TRIANGLE, scene.n_triangles,
                             scene.triangles),
                            (C.PRIMITIVE_SPHERE, scene.n_spheres,
                             scene.spheres),
                            (C.PRIMITIVE_RECTANGLE, scene.n_rects,
                             scene.rects)):
        if count:
            mat = torch.where(hit & (fam == f),
                              prims.material[safe.clamp_max(count - 1)], mat)
    mats = scene.materials
    mtype = mats.mat_type[mat.clamp(0, mats.count - 1).long()].long()
    codes = torch.where(hit, 2 + mtype, live.long())
    tri = hit & (fam == C.PRIMITIVE_TRIANGLE)
    ana = hit & ~tri
    by_kind = torch.bincount(codes, minlength=len(LANE_KINDS)).tolist()
    warps = torch.arange(n, device=idx.device) // 32
    key = (fam.long() << 32) | idx.long()
    return dict(
        n=n, dead=by_kind[0], live=int(live.sum()), miss=by_kind[1],
        tri=int(tri.sum()), analytic=int(ana.sum()),
        types={k: v for k, v in zip(LANE_KINDS[2:], by_kind[2:]) if v},
        rows=int(torch.unique(idx[tri]).numel()),
        prims=int(torch.unique(key[ana]).numel()),
        first=int((hit & carry.is_first_hit).sum()),
        pairs=int(torch.unique(warps * len(LANE_KINDS) + codes).numel()),
        warps=(n + 31) // 32, family=kind is not None)


def full_bound(counts, table, charge=None):
    """K2 ``full``'s bound for ``full_counts`` at ``charge`` (None:
    ``K2_BYTES["shade_full"]``, the kernel's; ``K2_FULL_BEFORE``, the
    older charge: a 96 B row a triangle hit, none for an analytic hit, no
    AOVs). ``table``: the material table's bytes, read once."""
    b = K2_BYTES["shade_full"] if charge is None else charge
    c = counts
    rows = c["tri"] if b.get("row_per_hit") else c["rows"]
    n_bytes = c["dead"] * b["dead"] + c["miss"] * b["miss"] \
        + c["tri"] * (b["hit"] + 4 * c["family"]) \
        + c["analytic"] * (b["hit"] + 4 - b["uv"]) + rows * b["row"] + c["prims"] * b["prim"] + c["first"] * b["first"] \
        + table
    return bound_ms(n_bytes, (c["tri"] + c["analytic"] + c["miss"])
                    * b["ops"])


def list_bound(counts, n_types):
    """The listing pass's own bound: every lane's alive flag, a live lane's
    index (and family), each distinct hit record's material id, the
    material types, a listed hit's 4 B list entry written, and the misses
    it ends (a miss's stage-full bytes)."""
    c = counts
    live_bytes = 4 + 4 * c["family"]
    n_bytes = c["n"] + c["live"] * live_bytes \
        + (c["rows"] + c["prims"]) * 4 + n_types * 4 \
        + (c["tri"] + c["analytic"]) * 4 \
        + c["miss"] * K2_BYTES["shade_full"]["miss"]
    return bound_ms(n_bytes, 0)


def bucket_bound(counts, table):
    """The bucket kernel's own bound: the hits' stage-full bytes (the
    misses ended in the listing pass, no dead lane touched) and each
    listed lane's 4 B list entry."""
    c = dict(counts, dead=0, miss=0)
    b, by = full_bound(c, table)
    extra = bound_ms((c["tri"] + c["analytic"]) * 4, 0)[0]
    return b + extra, by


def full_variants(args, kw):
    """``kernel_ms`` ``prepare``s of one kept stage-full launch: the
    wrapper as the main path calls it (``main``), each kernel forced
    (``lanes``: a thread per lane; ``sparse``: the sparse sweep, base
    instantiation only; ``buckets``: listing pass and bucket kernel), the
    listing pass alone
    (``list``), the bucket kernel alone
    on a listing made outside the window (``bucket``) and the plain
    version (``plain``)."""
    from metal_pathtracer_tpu_torch.ops.kernels import shade as S

    bare = {k: x for k, x in kw.items() if k != "n_alive"}
    fam = dict(kind=kw.get("kind"), scene=kw.get("scene"))

    def run(fn, opts, listed=False):
        def prepare():
            c = clone(args[0])
            more = dict(buckets=S.full_buckets(c, *args[1:8], **fam)) \
                if listed else {}
            return lambda: fn(c, *args[1:], **opts, **more)
        return prepare

    def listing():
        c = clone(args[0])
        return lambda: S.full_buckets(c, *args[1:8], **fam)

    out = {"main": run(S.shade_full, kw),
           "lanes": run(S.shade_full_lanes, bare),
           "buckets": run(S.shade_full_buckets, bare),
           "list": listing, "bucket": run(S.shade_full_buckets, bare, True),
           "plain": run(S.shade_full_reference, bare)}
    if not args[7].extended:
        out["sparse"] = run(S.shade_full_sparse, bare)
    return out


def check_full(args, kw, label):
    """Stage full of one kept launch against its plain version, bit for
    bit in the carry, by each kernel (a thread per lane; the listing pass
    and the bucket kernel), and the listing pass's buckets against the
    plain listing (the misses ended in the pass: their bucket empty)."""
    from metal_pathtracer_tpu_torch.ops.kernels import shade as S

    plain = {k: x for k, x in kw.items() if k != "n_alive"}
    cp = clone(args[0])
    S.shade_full_reference(cp, *args[1:], **plain)
    runs = [("a thread per lane", S.shade_full_lanes),
            ("buckets", S.shade_full_buckets)]
    if not args[7].extended:
        runs.append(("the sparse sweep", S.shade_full_sparse))
    for name, fn in runs:
        ck = clone(args[0])
        fn(ck, *args[1:], **plain)
        torch.cuda.synchronize()
        compare_bits(f"{label} K2 full ({name})", carry_pairs(ck, cp))
    c = clone(args[0])
    n = args[1].shape[0]
    got = S.bucket_lanes(S.full_buckets(c, *args[1:8], kind=kw.get("kind"),
                                        scene=kw.get("scene")), n)
    want = S.full_buckets_reference(args[0], *args[1:8], kind=kw.get("kind"),
                                    scene=kw.get("scene"))
    if len(got[0]) or any(not torch.equal(a, b)
                          for a, b in zip(got[1:], want[1:])):
        raise AssertionError(f"{label}: the listing pass's buckets differ "
                             f"from the plain listing: "
                             f"{[len(x) for x in got]} against "
                             f"{[len(x) for x in want]}")


def full_depths(name, settings, res, scene, w, h, dev, card, keep=None):
    """K2 ``full`` at every depth of one sample (the first ``keep``) of a
    cell (``frame_loop_full``): each depth's device time as the main path
    calls it, of each kernel forced, of the listing pass and of the
    bucket kernel alone, its live, hit and miss lanes, hits per material
    type, distinct (warp, lane kind) pairs, bound at the kernel's charge
    and at the older one; the sums over the sample. Each kernel against its
    plain version bit for bit at depths 0 and 1 and at the first sparse
    depth from depth 2 (under ``FULL_SPARSE_ALIVE`` of the lanes alive:
    rtow's 6, materials' 4, lambert's 2). Returns
    {"depths": [...], "sums": {...}}."""
    from metal_pathtracer_tpu_torch.ops.kernels import shade as S

    static, uni = scene_setup(settings, res, w, h, dev)
    kept = frame_loop_full(scene, uni, static, dev, keep)
    table = scene.materials.count * len(S.MAT_COLS) * 4
    n = w * h
    sparse = next((d for d, (a, _) in enumerate(kept)
                   if d >= 2 and int(a[0].alive.sum())
                   < S.FULL_SPARSE_ALIVE * n), None)
    checked = [d for d in (0, 1, sparse) if d is not None and d < len(kept)]
    for d in checked:
        check_full(*kept[d], f"{name} depth {d}")
    print(f"{name} {w}x{h}: K2 full bit-equal to its plain version at "
          f"depths {checked} by each kernel, the listing pass's buckets "
          f"equal to the plain listing's [{card}]")
    rows, sums = [], {}
    for depth, (args, kw) in enumerate(kept):
        cnt = full_counts(scene, args[0], args[2], kw.get("kind"))
        times = {k: kernel_ms(prep, 5)
                 for k, prep in full_variants(args, kw).items()
                 if k != "plain"}
        b, by = full_bound(cnt, table)
        old, _ = full_bound(cnt, table, K2_FULL_BEFORE)
        lb, _ = list_bound(cnt, scene.materials.count)
        run = S.full_schedule(args[7], depth, kw.get("n_alive"), n)
        ran = "buckets" if run is S.shade_full_buckets else \
            "the sparse sweep" if run is S.shade_full_sparse else \
            "a thread per lane"
        row = dict(times, bound=b, old=old, list_bound=lb)
        for k, x in row.items():
            sums[k] = sums.get(k, 0.0) + x
        rows.append(dict(row, counts=cnt, by=by,
                         sparse_run=run is S.shade_full_sparse))
        print(f"{name} depth {depth}: {cnt['live']} live of {n} lanes, "
              f"{cnt['tri'] + cnt['analytic']} hits {cnt['types']}, "
              f"{cnt['miss']} misses, {cnt['pairs']} (warp, kind) pairs "
              f"over {cnt['warps']} warps; K2 full {times['main']:.4f} ms "
              f"({ran}; a thread per lane {times['lanes']:.4f}, "
              + (f"the sparse sweep {times['sparse']:.4f}, "
                 if "sparse" in times else "") + f"buckets "
              f"{times['buckets']:.4f}: listing pass {times['list']:.4f}, "
              f"bucket kernel {times['bucket']:.4f}); bound {b:.4f} ms by "
              f"{by} ({old:.4f} at K2_FULL_BEFORE), listing pass's "
              f"{lb:.4f} [{card}]")
    print(f"{name}, one sample's {len(rows)} depths: K2 full "
          f"{sums['main']:.4f} ms (a thread per lane throughout "
          f"{sums['lanes']:.4f}, "
          + (f"the sparse sweep throughout {sums['sparse']:.4f}, "
             if "sparse" in sums else "") + f"buckets throughout "
          f"{sums['buckets']:.4f}, "
          f"of which listing {sums['list']:.4f}); bounds {sums['bound']:.4f}"
          f" ({sums['old']:.4f} at K2_FULL_BEFORE) [{card}]")
    return {"depths": rows, "sums": sums, "kept": kept, "table": table,
            "sparse": next((d for d, r in enumerate(rows) if r["sparse_run"]),
                           None)}


def full_path(dev, card, kernels, out):
    """K2 ``full`` at every depth of one sample of rtow (1200x675, ~44
    depths) and materials (960x320, 8) and at the lambert series' first 3
    depths (1920x1080), each kernel held against its plain version bit
    for bit at depths 0 and 1 and a sparse depth (``full_depths``); the
    kernels line's stage-full entries (the thread-per-lane and bucket
    kernels of each instantiation, the sparse sweep and the listing pass:
    each timed on a wavefront of its regime, with the launches of the
    main path's rtow or materials run)."""
    from metal_pathtracer_tpu_torch.ops.kernels import shade as S
    from metal_pathtracer_tpu_torch.utils import benchscene as B

    cells = (("rtow", lambda: B.build_rtow_scene(RTOW_SEED), B.RTOW_FRAME,
              None),
             ("materials", B.build_materials_scene, B.MATERIALS_FRAME, None),
             ("lambert", lambda: B.build_lambert_series(
                 LAMBERT_SUBDIVISIONS), FRAME, 3))
    res_by = {}
    for name, make, (w, h), keep in cells:
        settings, res = make()
        scene = res.build_arrays(device=dev)
        res_by[name] = full_depths(name, settings, res, scene, w, h, dev,
                                   card, keep)
        res_by[name]["scene"] = scene
        torch.cuda.synchronize()

    def entry(cell, depth, time_key, bound, launches_of):
        r = res_by[cell]
        args, kw = r["kept"][depth]
        if time_key == "list":
            fam = dict(kind=kw.get("kind"), scene=kw.get("scene"))
            plain = lambda: lambda: S.full_buckets_reference(
                args[0], *args[1:8], **fam)
        else:
            plain = full_variants(args, kw)["plain"]
        plain_ms = cuda_ms(plain, 2)
        b, by = bound(r["depths"][depth]["counts"], r["table"])
        return dict(source=ROOT + "shade.cu",
                    replaces="metal_pathtracer_tpu/ops/pallas/shade.py:1845",
                    launches=MAIN_LAUNCHES[launches_of[0]][launches_of[1]],
                    max_abs_err=0.0, ms=r["depths"][depth][time_key],
                    plain_ms=plain_ms, bound_ms=b, bound_by=by)

    n_types = lambda cell: res_by[cell]["scene"].materials.count
    out["shade_full"] = entry("rtow", 0, "lanes", full_bound,
                              ("rtow", "shade_full_lanes"))
    out["shade_full_sparse"] = entry("rtow", res_by["rtow"]["sparse"],
                                     "sparse", full_bound,
                                     ("rtow", "shade_full_sparse"))
    out["shade_full_buckets"] = entry("rtow", 1, "bucket", bucket_bound,
                                      ("rtow", "shade_full_buckets"))
    out["full_buckets"] = entry(
        "rtow", 1, "list", lambda c, _: list_bound(c, n_types("rtow")),
        ("rtow", "full_buckets"))
    out["shade_full_zoo"] = entry("materials", 0, "lanes", full_bound,
                                  ("materials", "shade_full_lanes"))
    out["shade_full_buckets_zoo"] = entry(
        "materials", 1, "bucket", bucket_bound,
        ("materials", "shade_full_buckets"))
    for k in ("shade_full", "shade_full_sparse", "shade_full_buckets",
              "full_buckets", "shade_full_zoo", "shade_full_buckets_zoo"):
        if out[k]["launches"] <= 0:
            raise AssertionError(f"{k} was not launched on its main path")


def exact_gate(st_k, st_p, label):
    """A render through the kernels against the plain path: the same
    image (RMSE 0) and the same closest and shadow trace counts."""
    img, ref = st_k.present().cpu().numpy(), st_p.present().cpu().numpy()
    counts = (st_k.ray_count, st_k.shadow_ray_count)
    counts_ref = (st_p.ray_count, st_p.shadow_ray_count)
    d = np.abs(img - ref)
    rmse = float(np.sqrt((d * d).mean()))
    print(f"{label}: rmse={rmse:.3e} max_abs={float(d.max()):.3e} "
          f"traces={counts} plain_traces={counts_ref}")
    if counts != counts_ref or rmse != 0.0 or not np.isfinite(img).all():
        raise AssertionError(f"{label}: kernel path differs from the plain "
                             "path")
    return float(d.max())


def prim_wavefronts(scene, settings, res, w, h, dev):
    """The primary wavefront of sample 0 and the one after a K2 ``full``
    bounce: [(label, origin, direction, t_max)], plus the primary carry
    and its (static, uniforms)."""
    from metal_pathtracer_tpu_torch import constants as C
    from metal_pathtracer_tpu_torch.ops.kernels import shade as S

    static, uni = scene_setup(settings, res, w, h, dev)
    carry = primary_carry(uni, static, dev)
    waves = []
    c = clone(carry)
    for depth in (0, 1):
        waves.append((f"depth {depth}", c.ray_o.clone(), c.ray_d.clone(),
                      torch.where(c.alive, C.INFINITY_T, 0.0)))
        if depth == 0:
            t, idx, u, v, kind = S._trace(scene, c)
            S.shade_full(c, t, idx, u, v, scene.triangles, scene.materials,
                         S.ShadeParams.of(uni, static), 0, kind=kind,
                         scene=scene)
    return waves, carry, static, uni


def cornell_shadow_wave(scene, carry, static, uni):
    """The Cornell box's first-depth rect-light shadow wavefront (s1, the
    light sample from its draws, the offset origins): (origin, direction,
    t_max)."""
    from metal_pathtracer_tpu_torch import constants as C
    from metal_pathtracer_tpu_torch.ops import integrator
    from metal_pathtracer_tpu_torch.ops.intersect import analytic_point
    from metal_pathtracer_tpu_torch.ops.kernels import shade as S

    c = clone(carry)
    t, idx, u, v, kind = S._trace(scene, c)
    rectpdf = integrator.rect_light_pdf_for_hit(
        scene, analytic_point(c.ray_o, t, c.ray_d), kind, idx, c.ray_o)
    trans = S.shade_s1(c, t, idx, u, v, scene.triangles, scene.materials,
                       None, None, S.ShadeParams.of(uni, static), 0,
                       kind=kind, scene=scene, rectpdf=rectpdf)
    l_dir, l_dist, l_pdf, _, l_valid = \
        integrator.rect_light_sample_from_uniforms(
            scene, trans[:, 10:13], trans[:, 0], trans[:, 1], trans[:, 2],
            uni, static)
    sh_o, sh_max, _ = S.nee_shadow_rays(
        trans, t, l_dir, l_pdf, l_valid, None,
        torch.clamp_min(l_dist - C.EPSILON_T, C.EPSILON_T))
    return sh_o, l_dir.contiguous(), sh_max


def compare_bits(label, pairs):
    """Every (name, kernel's tensor, plain version's tensor) equal bit for
    bit, lane by lane; raises naming the fields that are not."""
    bad = {}
    for name, got, want in pairs:
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        lanes = int((got != want).reshape(got.shape[0], -1).any(-1).sum())
        if lanes:
            bad[name] = lanes
    if bad:
        raise AssertionError(f"{label}: differs from its plain version on "
                             f"these lanes: {bad}")


def carry_pairs(a, b):
    return [(k, getattr(a, k), getattr(b, k)) for k in vars(a)]


def prim_k2(cells, dev, card):
    """K2 against its plain version at the analytic cells' full size: s1
    and s2 (rect-light NEE, emissive-hit MIS, metal, glass) on the Cornell
    box's first-depth wavefront with its rect-light bank, ``full`` on
    rtow's first two depths; carry, transients and chain bit-equal, each
    stage timed beside its bound."""
    from metal_pathtracer_tpu_torch.ops import integrator
    from metal_pathtracer_tpu_torch.ops.intersect import analytic_point
    from metal_pathtracer_tpu_torch.ops.kernels import shade as S
    from metal_pathtracer_tpu_torch.utils import benchscene as B

    out = {}
    settings, res, scene, _ = cells["cornell"]
    w, h = B.CORNELL_FRAME
    n = w * h
    static, uni = scene_setup(settings, res, w, h, dev)
    params = S.ShadeParams.of(uni, static)
    carry = primary_carry(uni, static, dev)
    t, idx, u, v, kind = S._trace(scene, carry)
    rectpdf = integrator.rect_light_pdf_for_hit(
        scene, analytic_point(carry.ray_o, t, carry.ray_d), kind, idx,
        carry.ray_o)
    hit = (t, idx, u, v, scene.triangles, scene.materials)

    def s1(fn, c):
        return fn(c, *hit, None, None, params, 0, kind=kind, scene=scene,
                  rectpdf=rectpdf)

    ck, cp = clone(carry), clone(carry)
    trans, trans_p = s1(S.shade_s1, ck), s1(S.shade_s1_reference, cp)
    torch.cuda.synchronize()
    compare_bits("K2 s1 cornell first depth",
                 carry_pairs(ck, cp) + [("trans", trans, trans_p)])
    # the rect-light bank from s1's draws, as trace_paths_nee builds it
    esmp, n_shadow = S.light_banks(scene, uni, static, trans, t)

    def s2(fn, c):
        return fn(c, *hit, trans, esmp, params, 0, kind=kind, scene=scene)

    c2k, c2p = clone(ck), clone(ck)
    chain, chain_p = s2(S.shade_s2, c2k), s2(S.shade_s2_reference, c2p)
    torch.cuda.synchronize()
    compare_bits("K2 s2 cornell first depth",
                 carry_pairs(c2k, c2p) + [("chain", chain, chain_p)])

    def prep(stage, fn, c0):
        def make():
            c = clone(c0)
            return lambda: stage(fn, c)
        return make

    n_hit = int((carry.alive & (idx >= 0)).sum())
    n_live = int(ck.alive.sum())
    s1_ms, s1_win = timed(prep(s1, S.shade_s1, carry), 5)
    s2_ms, s2_win = timed(prep(s2, S.shade_s2, ck), 5)
    K2_NOW["cornell s1"], K2_NOW["cornell s2"] = s1_ms, s2_ms
    out["shade_s1"] = (s1_ms, cuda_ms(prep(s1, S.shade_s1_reference, carry),
                                      2),
                       *k2_bound("shade_s1", n_hit, n - n_hit, 0,
                                 analytic=True))
    out["shade_s2"] = (s2_ms, cuda_ms(prep(s2, S.shade_s2_reference, ck), 2),
                       *k2_bound("shade_s2", n_live, 0, n - n_live,
                                 analytic=True))
    print(f"cornell first depth ({n} lanes, {n_hit} hits, "
          f"{int(n_shadow)} rect-light shadow rays): K2 s1 and s2 "
          f"bit-equal to their plain versions in carry, transients and "
          f"chain; s1 {s1_ms:.4f} ms on the device, {s1_win:.4f} ms around "
          f"the wrapper (plain {out['shade_s1'][1]:.1f} ms, bound "
          f"{out['shade_s1'][2]:.4f} ms by {out['shade_s1'][3]}); s2 "
          f"{s2_ms:.4f} / {s2_win:.4f} ms (plain {out['shade_s2'][1]:.1f} "
          f"ms, bound {out['shade_s2'][2]:.4f} ms by {out['shade_s2'][3]}) "
          f"[{card}]")

    settings, res, scene, _ = cells["rtow"]
    w, h = B.RTOW_FRAME
    n = w * h
    static, uni = scene_setup(settings, res, w, h, dev)
    params = S.ShadeParams.of(uni, static)
    carry = primary_carry(uni, static, dev)
    for depth in (0, 1):
        t, idx, u, v, kind = S._trace(scene, carry)

        def full(fn, c):
            fn(c, t, idx, u, v, scene.triangles, scene.materials, params,
               depth, kind=kind, scene=scene)

        ck, cp = clone(carry), clone(carry)
        full(S.shade_full, ck)
        full(S.shade_full_reference, cp)
        torch.cuda.synchronize()
        compare_bits(f"K2 full rtow depth {depth}", carry_pairs(ck, cp))
        n_live = int(carry.alive.sum())
        n_hit = int((carry.alive & (idx >= 0)).sum())
        ms, win = timed(prep(full, S.shade_full, carry), 5)
        K2_NOW[f"rtow full depth {depth}"] = ms
        plain = cuda_ms(prep(full, S.shade_full_reference, carry), 2)
        b, by = full_bound(full_counts(scene, carry, idx, kind),
                           scene.materials.count * len(S.MAT_COLS) * 4)
        print(f"rtow depth {depth} ({n_live} live of {n} lanes, {n_hit} "
              f"hits): K2 full bit-equal to its plain version in the carry; "
              f"{ms:.4f} ms on the device, {win:.4f} ms around the wrapper "
              f"(plain {plain:.1f} ms, bound {b:.4f} ms by {by}) [{card}]")
        carry = ck


def prim_timed(label, resources, settings, w, h, spp, dev, card, kernels,
               path, environment=None):
    """A warm-up, then ``spp`` samples at w x h through ``CudaBackend``
    with the launch counts reset just before; fails if a kernel of
    ``path`` was not launched. Returns the launches."""
    from metal_pathtracer_tpu_torch.renderer.headless import CudaBackend

    backend = CudaBackend()
    backend.render(resources, settings, *CHECK_FRAME, 1, device=dev,
                   environment=environment)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(kernels)
    t0 = time.time()
    res = backend.render(resources, settings, w, h, spp, device=dev,
                         environment=environment)
    wall = time.time() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    img = res.linear_rgb
    if not (np.isfinite(img).all() and img.max() > 0.0):
        raise AssertionError(f"{label}: image is not finite and non-zero")
    if res.ray_count < w * h * spp:
        raise AssertionError(f"{label}: ray_count {res.ray_count} < pixels "
                             "x spp")
    if min(launches[k] for k in path) <= 0:
        raise AssertionError(f"{label}: a kernel of the path was not "
                             f"launched: {launches}")
    traces = res.ray_count + res.shadow_ray_count
    print(f"{label} {w}x{h} d{settings.maxDepth}: {spp} spp in "
          f"{res.total_seconds:.3f}s, {res.avg_ms_per_sample:.2f} ms/spp, "
          f"{traces / res.total_seconds / 1e6:.2f} Mrays/s "
          f"({res.ray_count} closest + {res.shadow_ray_count} shadow "
          f"traces), peak {peak / 2**20:.0f} MiB, set-up "
          f"{wall - res.total_seconds:.1f}s, launches {launches}, mean "
          f"{float(img.mean()):.4f} [{card}]")
    return launches


def cornell_under_env():
    """The Cornell box without its ceiling and spheres under a 32x16 HDR
    sky with a sun block (the JAX package's ``test_fused_shade.py:
    593-605``): rect-light and environment NEE together. Returns
    (settings, resources, environment texels)."""
    from metal_pathtracer_tpu_torch.scene import dsl
    from metal_pathtracer_tpu_torch.scene.resources import SceneResources
    from metal_pathtracer_tpu_torch.settings import (
        BackgroundMode,
        RenderSettings,
    )
    from metal_pathtracer_tpu_torch.utils.benchscene import (
        cornell_scene_text,
    )

    text = "\n".join(line for line in cornell_scene_text().splitlines()
                     if not line.startswith("sphere")
                     and "y=2 z=-1,1" not in line)
    settings, res = RenderSettings(), SceneResources()
    dsl.parse_scene(text, settings, res)
    settings.backgroundMode = BackgroundMode.ENVIRONMENT
    settings.maxDepth = 4
    texels = np.full((16, 32, 3), 0.25, np.float32)
    texels[3:6, 6:9] = (40.0, 35.0, 28.0)
    texels[:, :, 2] += 0.15
    return settings, res, texels


def primitives_path(dev, card, kernels, out):
    """The analytic primitives: K3a/K3b/K3c bit for bit against their plain
    versions, the four scenes at 160x96 against the plain path, the
    Cornell box and rtow at full size through ``CudaBackend``, and each K3
    kernel timed at the first depth."""
    from metal_pathtracer_tpu_torch import constants as C
    from metal_pathtracer_tpu_torch.ops import env as env_ops
    from metal_pathtracer_tpu_torch.ops.kernels import primitives as P
    from metal_pathtracer_tpu_torch.renderer import frame
    from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
    from metal_pathtracer_tpu_torch.utils import benchscene as B

    def build(make):
        t0 = time.time()
        settings, res, *texels = make()
        env = env_ops.environment_from_texels(texels[0], dev) if texels \
            else None
        scene = res.build_arrays(environment=env, device=dev)
        torch.cuda.synchronize()
        return settings, res, scene, time.time() - t0

    cells = {"cornell": build(B.build_cornell_scene),
             "rtow": build(lambda: B.build_rtow_scene(RTOW_SEED)),
             "smoke": build(B.build_smoke_scene),
             "mixed": build(B.build_mixed_scene),
             "cornell under an environment": build(cornell_under_env)}
    for name, (_, _, scene, secs) in cells.items():
        print(f"# {name} scene: {scene.n_spheres} spheres, {scene.n_rects} "
              f"rectangles ({scene.n_rect_lights} lights), "
              f"{scene.n_triangles} triangles, "
              f"{scene.materials.count} materials, set-up {secs:.2f}s")

    # ---- K3a/K3b/K3c vs their plain versions on the cells' wavefronts ---
    t_err, ties = 0.0, 0
    first = {}
    for name, (w, h) in (("cornell", B.CORNELL_FRAME),
                         ("rtow", B.RTOW_FRAME)):
        settings, res, scene, _ = cells[name]
        waves, carry, static, uni = prim_wavefronts(scene, settings, res, w,
                                                    h, dev)
        if name == "cornell":
            waves.append(("rect-light shadow rays",
                          *cornell_shadow_wave(scene, carry, static, uni)))
        for label, o, d, tmax in waves:
            args = (o, d, C.EPSILON_T, tmax)
            checked = []
            if scene.n_rects:
                e, _ = compare_nearest(
                    P.rect_nearest(*args, scene.rects),
                    P.rect_nearest_reference(*args, scene.rects),
                    f"K3c {name} {label}")
                t_err = max(t_err, e)
                checked.append("K3c")
            brute = P.sphere_nearest_brute(*args, scene.spheres)
            e, _ = compare_nearest(
                brute, P.sphere_nearest_reference(*args, scene.spheres),
                f"K3a {name} {label}")
            t_err = max(t_err, e)
            checked.append("K3a")
            if scene.n_spheres > P.BRUTE_MAX_SPHERES:
                groups = scene.sphere_groups
                chunked = P.sphere_nearest_chunked(*args, groups)
                e, _ = compare_nearest(
                    chunked, P.sphere_nearest_chunked_reference(*args,
                                                                groups),
                    f"K3b {name} {label}")
                _, n_ties = compare_nearest(chunked, brute,
                                            f"K3b vs K3a {name} {label}",
                                            count_ties=True)
                t_err, ties = max(t_err, e), ties + n_ties
                checked.append(f"K3b (vs K3a: {n_ties} exact-t ties)")
            n_live = int((tmax > 0).sum())
            print(f"{name} {label} ({n_live} live of {o.shape[0]} lanes): "
                  f"{', '.join(checked)} bit-equal to the plain versions")
            if label == "depth 0":
                first[name] = (args, scene, n_live)

    # ---- every K3 kernel timed at the first depth ----------------------
    timing = {}
    for kname, cell, prims_of in (
            ("sphere_nearest_brute", "cornell", lambda s: s.spheres),
            ("rect_nearest", "cornell", lambda s: s.rects),
            ("sphere_nearest_chunked", "rtow", lambda s: s.sphere_groups),
            ("sphere_nearest_brute", "rtow", lambda s: s.spheres)):
        args, scene, n_live = first[cell]
        prims = prims_of(scene)
        fn = getattr(P, kname)
        plain = {"sphere_nearest_brute": P.sphere_nearest_reference,
                 "sphere_nearest_chunked": P.sphere_nearest_chunked_reference,
                 "rect_nearest": P.rect_nearest_reference}[kname]
        ms, win_ms = timed(lambda: lambda: fn(*args, prims), 20)
        plain_ms = cuda_ms(lambda: lambda: plain(*args, prims), 2)
        count = scene.n_rects if kname == "rect_nearest" else scene.n_spheres
        extra, group_tests = "", 0
        if kname == "sphere_nearest_chunked":
            # the bound counts the kernel's own schedule (groups near first,
            # the window shrinking to the best hit), held to its bits here;
            # the plain version's cull against the initial window is
            # printed beside it as the older, larger charge
            stats, own = {}, {}
            plain(*args, prims, stats=stats)
            compare_nearest(fn(*args, prims),
                            P.sphere_nearest_visits(*args, prims, stats=own),
                            "K3b against its schedule in plain PyTorch")
            group_tests = own["group_visits"]
            b_cull, _ = k3_bound(kname, args[0].shape[0], n_live, count,
                                 stats["group_tests"])
            extra = (f", its own {own['group_visits']} lane x group visits "
                     f"and {own['sphere_tests']} sphere tests; the plain "
                     f"cull's {stats['group_tests']} lane x group boxes "
                     f"passed of {n_live * prims.n_groups} would charge "
                     f"{b_cull:.4f} ms")
        b, by = k3_bound(kname, args[0].shape[0], n_live, count, group_tests)
        print(f"{kname} on the {cell} first depth ({args[0].shape[0]} lanes, "
              f"{count} primitives): {ms:.4f} ms on the device, {win_ms:.4f} "
              f"ms around the wrapper (plain {plain_ms:.1f} ms, bound "
              f"{b:.4f} ms by {by}{extra}) [{card}]")
        timing.setdefault(kname, (ms, plain_ms, b, by))

    # ---- K3b at every depth of one rtow sample ---------------------------
    k3b_depths(cells["rtow"], dev, card)

    # ---- K3c and K3a at every launch of one sample of their cells --------
    k3c_depths(dev, card)

    # ---- K2 vs its plain version at the cells' full size ----------------
    prim_k2(cells, dev, card)

    # ---- the four scenes at 160x96, kernels vs plain path ----------------
    w, h = CHECK_FRAME
    render_err = 0.0
    for name, (settings, res, scene, _) in cells.items():
        static, uni = scene_setup(settings, res, w, h, dev)
        before = {k: fn.launches for k, fn in kernels.items()}
        st_k = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                    static, PRIM_CHECK_SPP)
        used = [k for k, fn in kernels.items() if fn.launches > before[k]]
        with plain_kernels():
            st_p = frame.render_samples(scene, uni,
                                        RenderState.create(w, h, dev), static,
                                        PRIM_CHECK_SPP)
        render_err = max(render_err, exact_gate(
            st_k, st_p, f"{name} {w}x{h} {PRIM_CHECK_SPP}spp d"
            f"{settings.maxDepth} through {'+'.join(used)} vs plain"))

    # ---- the Cornell box and rtow at full size through CudaBackend -------
    settings, res, _, _ = cells["cornell"]
    launches = prim_timed("cornell", res, settings, *B.CORNELL_FRAME,
                          CORNELL_TIMED_SPP, dev, card, kernels,
                          ("sphere_nearest_brute", "rect_nearest", "shade_s1",
                           "shade_s2"))
    settings, res, _, _ = cells["rtow"]
    launches_r = prim_timed("rtow", res, settings, *B.RTOW_FRAME,
                            RTOW_TIMED_SPP, dev, card, kernels,
                            ("sphere_nearest_chunked", "shade_full",
                             "shade_full_lanes", "shade_full_sparse",
                             "shade_full_buckets", "full_buckets"))
    MAIN_LAUNCHES["rtow"] = launches_r
    print(f"K3b against K3a: {ties} exact-t ties over the rtow wavefronts")
    for kname, n_launch in (
            ("sphere_nearest_brute", launches["sphere_nearest_brute"]),
            ("sphere_nearest_chunked", launches_r["sphere_nearest_chunked"]),
            ("rect_nearest", launches["rect_nearest"])):
        ms, plain_ms, b, by = timing[kname]
        out[kname] = dict(
            source=ROOT + "primitives.cu",
            replaces={"sphere_nearest_brute":
                      "metal_pathtracer_tpu/ops/pallas/primitives.py:37",
                      "sphere_nearest_chunked":
                      "metal_pathtracer_tpu/ops/pallas/primitives.py:183",
                      "rect_nearest":
                      "metal_pathtracer_tpu/ops/pallas/primitives.py:314"}[
                          kname],
            launches=n_launch, max_abs_err=max(t_err, render_err), ms=ms,
            plain_ms=plain_ms, bound_ms=b, bound_by=by)


# ---------------------------------------------------------------------------
# The material zoo: plastic, carpaint, subsurface, env-modulated lights
# ---------------------------------------------------------------------------

MATERIALS_TIMED_SPP = 4
MATERIALS_RW_TIMED_SPP = 2
CORNELL_EMITENV_TIMED_SPP = 4
# K2 extras per lane: the random-walk planes and state a lane reads in
# full and s2 (18 floats + 8 B), the emod plane s1 reads (3 floats)
RW_BYTES, EMOD_BYTES = 18 * 4 + 8, 3 * 4


def zoo_cells(dev):
    """The material zoo's three configurations and the two triangle
    icosphere scenes of the 160x96 check: name -> (settings, resources,
    environment or None)."""
    from metal_pathtracer_tpu_torch.settings import SssMode
    from metal_pathtracer_tpu_torch.utils import benchscene as B

    rows = B.ICOSPHERE_ROWS
    pc = B.build_icosphere_scene(
        [rows["plastic"], rows["carpaint"], rows["ground"]],
        [((-1.0, 0.6, 0.0), 0.8, 0), ((1.0, 0.6, 0.0), 0.8, 1)], 13)
    sep = B.build_icosphere_scene([rows["sss"], rows["ground"]],
                                  [((0.0, 0.6, 0.0), 0.8, 0)], 23)
    sep[0].sssMode = SssMode.SEPARABLE
    six = B.build_six_slot_scene()
    six[0].maxDepth = 8
    return {"materials": (*B.build_materials_scene(), None),
            "materials-env-rw": B.build_materials_env_rw_scene(dev),
            "cornell-emitenv": B.build_cornell_emitenv_scene(dev),
            "icosphere plastic+carpaint": (*pc, None),
            "icosphere separable sss": (*sep, None),
            "six-slot textured, gradient sky": (*six, None)}


def zoo_k2(cells, dev, card, out):
    """K2 against its plain version on the zoo's full-size wavefronts, bit
    for bit: ``full`` (the extended instantiation) on materials' depths 0
    and 1; ``s1``/``s2`` on materials-env-rw's first depth with its
    environment bank and the random walk's planes fed to both; ``s1`` with
    ``emod`` on cornell-emitenv's first depth. Each timed beside its
    bound."""
    from metal_pathtracer_tpu_torch.ops import env as env_ops
    from metal_pathtracer_tpu_torch.ops import integrator
    from metal_pathtracer_tpu_torch.ops.intersect import analytic_point
    from metal_pathtracer_tpu_torch.ops.kernels import shade as S
    from metal_pathtracer_tpu_torch.utils import benchscene as B

    def prep(stage, fn, c0):
        def make():
            c = clone(c0)
            return lambda: stage(fn, c)
        return make

    def build(name, w, h):
        settings, res, env = cells[name]
        scene = res.build_arrays(environment=env, device=dev)
        static, uni = scene_setup(settings, res, w, h, dev)
        return scene, static, uni, env

    def table(scene):
        return scene.materials.count * len(S.MAT_COLS) * 4

    # ---- full on materials 960x320, depths 0 and 1 ----------------------
    w, h = B.MATERIALS_FRAME
    n = w * h
    scene, static, uni, _ = build("materials", w, h)
    params = S.ShadeParams.of(uni, static)
    assert params.extended
    carry = primary_carry(uni, static, dev)
    for depth in (0, 1):
        t, idx, u, v, kind = S._trace(scene, carry)

        def full(fn, c):
            fn(c, t, idx, u, v, scene.triangles, scene.materials, params,
               depth, kind=kind, scene=scene)

        ck, cp = clone(carry), clone(carry)
        full(S.shade_full, ck)
        full(S.shade_full_reference, cp)
        torch.cuda.synchronize()
        compare_bits(f"K2 full (zoo) materials depth {depth}",
                     carry_pairs(ck, cp))
        n_live = int(carry.alive.sum())
        n_hit = int((carry.alive & (idx >= 0)).sum())
        ms, win = timed(prep(full, S.shade_full, carry), 5)
        plain = cuda_ms(prep(full, S.shade_full_reference, carry), 2)
        b, by = full_bound(full_counts(scene, carry, idx, kind),
                           table(scene))
        print(f"materials depth {depth} ({n_live} live of {n} lanes, {n_hit} "
              f"hits): K2 full (zoo) bit-equal to its plain version in the "
              f"carry; {ms:.4f} ms on the device, {win:.4f} ms around the "
              f"wrapper (plain {plain:.1f} ms, bound {b:.4f} ms by {by}) "
              f"[{card}]")
        carry = ck

    # ---- s1/s2 on materials-env-rw's first depth, the walk's planes -----
    scene, static, uni, env = build("materials-env-rw", w, h)
    params = S.ShadeParams.of(uni, static, env)
    carry = primary_carry(uni, static, dev)
    t, idx, u, v, kind = S._trace(scene, carry)
    envbg = env_ops.environment_background(env, carry.ray_d, uni, static,
                                           carry.env_lod,
                                           carry.env_lod_active)
    envpdf = env_ops.environment_pdf(env, carry.ray_d,
                                     uni.environment_rotation)
    hit = (t, idx, u, v, scene.triangles, scene.materials)

    def s1(fn, c, **kw):
        return fn(c, *hit, envbg, envpdf, params, 0, kind=kind, scene=scene,
                  **kw)

    ck, cp = clone(carry), clone(carry)
    trans, trans_p = s1(S.shade_s1, ck), s1(S.shade_s1_reference, cp)
    torch.cuda.synchronize()
    compare_bits("K2 s1 (zoo) materials-env-rw first depth",
                 carry_pairs(ck, cp) + [("trans", trans, trans_p)])
    t0 = time.perf_counter()
    rw, rw_state = S.random_walks(scene, uni, static, ck, t, idx, u, v, kind)
    torch.cuda.synchronize()
    walk_ms = (time.perf_counter() - t0) * 1e3
    n_walk = int((rw[:, 0] > 0.5).sum())
    n_used = int(((rw[:, 0] > 0.5) & (rw[:, 7] > 0.0)).sum())
    n_exit = int((rw[:, 11] > 0.5).sum())
    esmp, _ = S.light_banks(scene, uni, static, trans, t)

    def s2(fn, c):
        return fn(c, *hit, trans, esmp, params, 0, kind=kind, scene=scene,
                  rw=rw, rw_state=rw_state)

    c2k, c2p = clone(ck), clone(ck)
    chain, chain_p = s2(S.shade_s2, c2k), s2(S.shade_s2_reference, c2p)
    torch.cuda.synchronize()
    compare_bits("K2 s2 (zoo) materials-env-rw first depth",
                 carry_pairs(c2k, c2p) + [("chain", chain, chain_p)])
    n_hit = int((carry.alive & (idx >= 0)).sum())
    n_live = int(ck.alive.sum())
    s1_ms, s1_win = timed(prep(s1, S.shade_s1, carry), 5)
    s2_ms, s2_win = timed(prep(s2, S.shade_s2, ck), 5)
    s1_plain = cuda_ms(prep(s1, S.shade_s1_reference, carry), 2)
    s2_plain = cuda_ms(prep(s2, S.shade_s2_reference, ck), 2)
    b1, by1 = k2_bound("shade_s1", n_hit, n - n_hit, 0, analytic=True,
                       table=table(scene))
    b2, by2 = k2_bound("shade_s2", n_live, 0, n - n_live, analytic=True,
                       extra=RW_BYTES, table=table(scene))
    out["shade_s1_zoo"] = dict(ms=s1_ms, plain_ms=s1_plain, bound_ms=b1,
                               bound_by=by1)
    out["shade_s2_zoo"] = dict(ms=s2_ms, plain_ms=s2_plain, bound_ms=b2,
                               bound_by=by2)
    print(f"materials-env-rw first depth ({n} lanes, {n_hit} hits, {n_walk} "
          f"walk lanes, {n_used} with a sample (coat lobe or exit), "
          f"{n_exit} exits, walk pre-stage {walk_ms:.1f} ms around it): K2 "
          f"s1 and s2 (zoo) bit-equal to "
          f"their plain versions in carry, transients and chain; s1 "
          f"{s1_ms:.4f} ms on the device, {s1_win:.4f} ms around the wrapper "
          f"(plain {s1_plain:.1f} ms, bound {b1:.4f} ms by {by1}); s2 "
          f"{s2_ms:.4f} / {s2_win:.4f} ms (plain {s2_plain:.1f} ms, bound "
          f"{b2:.4f} ms by {by2}) [{card}]")

    # ---- s1 with emod on cornell-emitenv's first depth ------------------
    w, h = B.CORNELL_FRAME
    n = w * h
    scene, static, uni, env = build("cornell-emitenv", w, h)
    params = S.ShadeParams.of(uni, static, env)
    carry = primary_carry(uni, static, dev)
    t, idx, u, v, kind = S._trace(scene, carry)
    envbg = env_ops.environment_background(env, carry.ray_d, uni, static,
                                           carry.env_lod,
                                           carry.env_lod_active)
    envpdf = env_ops.environment_pdf(env, carry.ray_d,
                                     uni.environment_rotation)
    rectpdf = integrator.rect_light_pdf_for_hit(
        scene, analytic_point(carry.ray_o, t, carry.ray_d), kind, idx,
        carry.ray_o)
    emod = S.env_modulation(scene, uni, static, carry, t, idx, u, v, kind)
    hit = (t, idx, u, v, scene.triangles, scene.materials)

    def s1e(fn, c):
        return fn(c, *hit, envbg, envpdf, params, 0, kind=kind, scene=scene,
                  rectpdf=rectpdf, emod=emod)

    ck, cp = clone(carry), clone(carry)
    trans, trans_p = s1e(S.shade_s1, ck), s1e(S.shade_s1_reference, cp)
    torch.cuda.synchronize()
    compare_bits("K2 s1 with emod cornell-emitenv first depth",
                 carry_pairs(ck, cp) + [("trans", trans, trans_p)])
    n_hit = int((carry.alive & (idx >= 0)).sum())
    ms, win = timed(prep(s1e, S.shade_s1, carry), 5)
    plain = cuda_ms(prep(s1e, S.shade_s1_reference, carry), 2)
    b, by = k2_bound("shade_s1", n_hit, n - n_hit, 0, analytic=True,
                     extra=EMOD_BYTES, table=table(scene))
    print(f"cornell-emitenv first depth ({n} lanes, {n_hit} hits): K2 s1 "
          f"with emod bit-equal to its plain version in carry and "
          f"transients; {ms:.4f} ms on the device, {win:.4f} ms around the "
          f"wrapper (plain {plain:.1f} ms, bound {b:.4f} ms by {by}) [{card}]")


def materials_path(dev, card, kernels, out):
    """The material zoo: K2's extended stages bit for bit against their
    plain versions at full size, the zoo's three configurations, two
    triangle-icosphere scenes and the six-slot textured scene (stage full
    with texture planes) at 160x96 1 spp through the kernels against the
    plain path, and the three configurations at full size through
    ``CudaBackend``."""
    from metal_pathtracer_tpu_torch.renderer import frame
    from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
    from metal_pathtracer_tpu_torch.utils import benchscene as B

    t0 = time.time()
    cells = zoo_cells(dev)
    t1 = time.time()
    zoo_k2(cells, dev, card, out)
    t2 = time.time()

    # ---- 160x96: the kernels against the plain path ---------------
    w, h = CHECK_FRAME
    render_err = 0.0
    for name, (settings, res, env) in cells.items():
        scene = res.build_arrays(environment=env, device=dev)
        static, uni = scene_setup(settings, res, w, h, dev)
        before = {k: fn.launches for k, fn in kernels.items()}
        t_k = time.time()
        st_k = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                    static, ZOO_CHECK_SPP)
        torch.cuda.synchronize()
        t_p = time.time()
        used = [k for k, fn in kernels.items() if fn.launches > before[k]]
        with plain_kernels():
            st_p = frame.render_samples(scene, uni,
                                        RenderState.create(w, h, dev), static,
                                        ZOO_CHECK_SPP)
        torch.cuda.synchronize()
        render_err = max(render_err, exact_gate(
            st_k, st_p, f"{name} {w}x{h} {ZOO_CHECK_SPP}spp d"
            f"{settings.maxDepth} through {'+'.join(used)} vs plain "
            f"({t_p - t_k:.1f}s / {time.time() - t_p:.1f}s)"))

    # ---- the three configurations at full size through CudaBackend ------
    t3 = time.time()
    runs = {}
    for name, frame_size, spp, path in (
            ("materials", B.MATERIALS_FRAME, MATERIALS_TIMED_SPP,
             ("sphere_nearest_brute", "shade_full", "shade_full_lanes",
              "shade_full_buckets", "full_buckets")),
            ("materials-env-rw", B.MATERIALS_FRAME, MATERIALS_RW_TIMED_SPP,
             ("sphere_nearest_brute", "shade_s1", "shade_s2")),
            ("cornell-emitenv", B.CORNELL_FRAME, CORNELL_EMITENV_TIMED_SPP,
             ("sphere_nearest_brute", "rect_nearest", "shade_s1",
              "shade_s2"))):
        settings, res, env = cells[name]
        runs[name] = prim_timed(name, res, settings, *frame_size, spp, dev,
                                card, kernels, path, environment=env)
    MAIN_LAUNCHES["materials"] = runs["materials"]
    for stage, cell in (("shade_s1", "materials-env-rw"),
                        ("shade_s2", "materials-env-rw")):
        out[f"{stage}_zoo"].update(
            source=ROOT + "shade.cu",
            replaces="metal_pathtracer_tpu/ops/pallas/shade.py:1845",
            launches=runs[cell][stage], max_abs_err=render_err)
    print(f"# material-zoo phase: scenes {t1 - t0:.1f}s, K2 checks "
          f"{t2 - t1:.1f}s, 160x96 renders {t3 - t2:.1f}s, timed renders "
          f"{time.time() - t3:.1f}s")


def k1_stats_bound(walk, lane_bytes, slot_bytes):
    """The counting kernel's bound: K1's, plus one left-sibling int per
    touched node and the four int64 totals written once."""
    return k1_bound(walk, lane_bytes + 32, K1_NODE_BYTES + 4, slot_bytes)


def probe_rows_equal(a, b, label):
    """Two probes' rows, field by field (NaN equal to NaN)."""
    if len(a) != len(b):
        raise AssertionError(f"{label}: {len(a)} rows against {len(b)}")
    for depth, (ra, rb) in enumerate(zip(a, b)):
        for k in ra:
            if not np.array_equal(np.float32(ra[k]), np.float32(rb[k]),
                                  equal_nan=True):
                raise AssertionError(f"{label}: depth {depth} {k} "
                                     f"{ra[k]} != {rb[k]}")


def oracle_renders(tmp, card, text=ORACLE_CORNELL, tag="oracle_cornell",
                   extra=()):
    """A scene ``text`` (default ``ORACLE_CORNELL``) through the CLI twice,
    ``--backend metal`` (the card) and ``--backend oracle`` (the native
    C++ oracle), with the CLI arguments ``extra``, each to an EXR in
    ``tmp``: returns the two linear images."""
    import os

    from metal_pathtracer_tpu_torch import cli
    from metal_pathtracer_tpu_torch.utils import image_io

    scene = os.path.join(tmp, f"{tag}.scene")
    with open(scene, "w") as fh:
        fh.write(text)
    images = []
    for backend in ("metal", "oracle"):
        path = os.path.join(tmp, f"{tag}_{backend}.exr")
        t0 = time.time()
        if cli.main(["--scene", scene, "--width", str(ORACLE_FRAME[0]),
                     "--height", str(ORACLE_FRAME[1]), "--sppTotal",
                     str(ORACLE_SPP), "--backend", backend, *extra,
                     "--output", path]) != 0:
            raise AssertionError(f"the CLI failed with --backend {backend}")
        print(f"CLI --backend {backend}: {time.time() - t0:.2f}s [{card}]")
        ch = image_io.read_exr(path)
        images.append(np.stack([ch["R"], ch["G"], ch["B"]], -1))
    return images


def oracle_gate(card_img, oracle_img, card):
    """The card's render against the oracle's at ``ORACLE_GATE``."""
    d = card_img.astype(np.float64) - oracle_img.astype(np.float64)
    rmse = float(np.sqrt((d * d).mean()))
    mean_diff = abs(float(card_img.mean()) - float(oracle_img.mean()))
    ok = (np.isfinite(card_img).all() and card_img.max() > 0.0
          and rmse < ORACLE_GATE["max_rmse"]
          and mean_diff < ORACLE_GATE["max_mean_diff"])
    print(f"the card against the native oracle, test_oracle_parity's "
          f"Cornell box at {ORACLE_FRAME[0]}x{ORACLE_FRAME[1]} {ORACLE_SPP} "
          f"spp through the CLI (--backend metal, --backend oracle): RMSE "
          f"{rmse:.3e}, means {float(card_img.mean()):.6f} / "
          f"{float(oracle_img.mean()):.6f} (gate {ORACLE_GATE}) [{card}]")
    if not ok:
        raise AssertionError("the card's render fails the oracle gate")


def headless_path(dev, card, kernels, out, headline):
    """Phase 6, the headless surface and its debug tooling: K1's counting
    kernels on the textured headline's first-depth wavefronts (closest and
    shadow) through ``traversal_profile``, their outputs bit-equal to the
    counter-free kernels' and their totals equal to the plain walk's;
    ``debugSpecularOnly`` at 160x96 against the plain path on
    ``materials.scene`` and the textured headline; ``probe_pixel`` through
    the kernels against the plain path; the CLI on the card (Cornell box
    EXR and PNG, the default scene, a checkpoint resume)."""
    import os
    import shutil
    import tempfile

    from metal_pathtracer_tpu_torch import cli
    from metal_pathtracer_tpu_torch import constants as C
    from metal_pathtracer_tpu_torch.ops import env as env_ops
    from metal_pathtracer_tpu_torch.ops.kernels import build
    from metal_pathtracer_tpu_torch.ops.kernels import shade as S
    from metal_pathtracer_tpu_torch.ops.kernels import texture as X
    from metal_pathtracer_tpu_torch.ops.kernels import traverse as T
    from metal_pathtracer_tpu_torch.renderer import frame
    from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
    from metal_pathtracer_tpu_torch.renderer.debugprobe import probe_pixel
    from metal_pathtracer_tpu_torch.renderer.headless import CudaBackend
    from metal_pathtracer_tpu_torch.utils import benchscene as B
    from metal_pathtracer_tpu_torch.utils import image_io
    from metal_pathtracer_tpu_torch.utils.stats import traversal_profile

    regs = build.register_counts(build.build_log())
    print("registers per instantiation (-Xptxas -v): " + ", ".join(
        f"{k} {v}" for k, v in sorted(regs.items())))

    # ---- the first-depth wavefronts of the textured headline -------------
    settings, res, scene = headline
    W, H = FRAME
    n = W * H
    static, uni = scene_setup(settings, res, W, H, dev)
    params = S.ShadeParams.of(uni, static, scene.environment)
    carry = primary_carry(uni, static, dev)
    k1_args = trace_inputs(carry, scene)
    hit = T.trace_closest(*k1_args)
    c = clone(carry)
    tex = X.texture_stage(c, *hit, scene, uni, static, 0,
                          X.TexParams.of(uni, static, scene.textures))
    envbg = env_ops.environment_background(
        scene.environment, c.ray_d, uni, static, c.env_lod, c.env_lod_active)
    envpdf = env_ops.environment_pdf(scene.environment, c.ray_d,
                                     uni.environment_rotation)
    trans = S.shade_s1(c, *hit, scene.triangles, scene.materials, envbg,
                       envpdf, params, 0, tex)
    e_dir, _, e_pdf, e_valid = env_ops.sample_environment_from_uniforms(
        scene.environment, trans[:, 0], trans[:, 1], trans[:, 2], uni,
        static)
    sh_o, sh_max, do_sh = S.nee_shadow_rays(trans, hit[0], e_dir, e_pdf,
                                            e_valid, tex)
    sh_args = (sh_o, e_dir.contiguous(), C.EPSILON_T, sh_max, scene.tri_bvh,
               scene.triangles)
    lanes_dielectric = torch.nonzero(
        (hit[1] >= 0) & (scene.materials.mat_type[scene.triangles.material[
            hit[1].clamp_min(0).long()].long()] == C.MATERIAL_DIELECTRIC))
    glass = int(lanes_dielectric[lanes_dielectric.shape[0] // 2])
    torch.cuda.synchronize()

    # ---- the main path of the phase, with every count reset just before --
    reset_launches(kernels)
    t_main = time.time()
    profile = traversal_profile(carry.ray_o, carry.ray_d, scene.tri_bvh,
                                scene.triangles, C.EPSILON_T, C.INFINITY_T)
    profile_any = traversal_profile(sh_o, e_dir.contiguous(), scene.tri_bvh,
                                    scene.triangles, C.EPSILON_T, sh_max,
                                    any_hit=True)
    smoke_settings, smoke_res = B.build_smoke_scene()
    sw, sh = 64, 64
    smoke_scene = smoke_res.build_arrays(device=dev)
    smoke_static, smoke_uni = scene_setup(smoke_settings, smoke_res, sw, sh,
                                          dev)
    rows_smoke = probe_pixel(smoke_scene, smoke_uni, smoke_static, sw // 2,
                             sh // 2)
    rows_glass = probe_pixel(scene, uni, static, glass % W, glass // W)
    tmp = tempfile.mkdtemp(prefix="mpt_cli_")
    cli_args = ["--scene", "cornell", "--width", "512", "--height", "512"]
    exr = os.path.join(tmp, "cornell.exr")
    png = os.path.join(tmp, "cornell.png")
    ckpt = os.path.join(tmp, "cornell.npz")
    resumed = os.path.join(tmp, "resumed.exr")
    default = os.path.join(tmp, "default.exr")
    t_cli = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "metal_pathtracer_tpu_torch.cli", *cli_args,
         "--sppTotal", "8", "--output", exr], capture_output=True,
        text=True, timeout=600)
    print(f"CLI (python -m, {time.time() - t_cli:.1f}s): "
          f"{proc.stdout.strip()} [{card}]")
    if proc.returncode != 0:
        raise AssertionError(f"the CLI failed: {proc.stderr[-2000:]}")
    torch.cuda.reset_peak_memory_stats(dev)
    for argv in ([*cli_args, "--sppTotal", "8", "--format", "png",
                  "--output", png],
                 [*cli_args, "--sppTotal", "4", "--checkpoint", ckpt,
                  "--output", os.path.join(tmp, "half.exr")],
                 [*cli_args, "--sppTotal", "8", "--checkpoint", ckpt,
                  "--output", resumed],
                 ["--width", "1280", "--height", "720", "--sppTotal", "2",
                  "--output", default]):
        if cli.main(argv) != 0:
            raise AssertionError(f"the CLI failed on {argv}")
    peak = torch.cuda.max_memory_allocated(dev)
    oracle_cells = oracle_renders(tmp, card)
    main_s = time.time() - t_main
    # every kernel but the instanced K1, which only instanced scenes run
    launches = {k: fn.launches for k, fn in kernels.items()
                if not k.startswith("trace_instanced")}
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the headless phase was not "
                             f"launched: {launches}")
    print(f"headless phase main path in {main_s:.1f}s: launches {launches}, "
          f"CLI peak {peak / 2**20:.0f} MiB [{card}]")

    # ---- the CLI's outputs -----------------------------------------------
    if open(resumed, "rb").read() != open(exr, "rb").read():
        raise AssertionError("the checkpoint resume (4 + 4 spp) differs "
                             "from the straight 8 spp render")
    cs, cr = B.build_cornell_scene()
    direct = CudaBackend().render(cr, cs, 512, 512, 8)
    ch = image_io.read_exr(exr)
    linear = np.stack([ch["R"], ch["G"], ch["B"]], -1)
    if not (np.array_equal(linear, direct.linear_rgb)
            and (ch["SAMPLES"] == 8.0).all()):
        raise AssertionError("read_exr of the CLI's EXR differs from the "
                             "rendered linear image")
    dch = image_io.read_exr(default)
    dimg = np.stack([dch["R"], dch["G"], dch["B"]], -1)
    if not (np.isfinite(dimg).all() and dimg.max() > 0.0
            and os.path.getsize(png) > 1000):
        raise AssertionError("the CLI's PNG or default-scene image is empty")
    oracle_gate(*oracle_cells, card)
    print(f"CLI: the resume (4 + 4 spp) equals the straight 8 spp EXR byte "
          f"for byte; read_exr of it equals the rendered linear image "
          f"(mean {float(linear.mean()):.4f}); default scene 1280x720 2 spp "
          f"mean {float(dimg.mean()):.4f}; PNG {os.path.getsize(png)} B")
    shutil.rmtree(tmp)

    # ---- K1 stats: outputs, counters, times and bounds --------------------
    t_k, tri_k, u_k, v_k, tot = T.trace_closest_stats(*k1_args)
    compare_trace((t_k, tri_k, u_k, v_k), hit)
    occ_k, tot_any = T.trace_any_stats(*sh_args)
    occ = T.trace_any(*sh_args)
    compare_flags(occ_k, occ, "K1 any-hit stats vs counter-free")
    # the plain walks, timed (their counts are the totals' reference)
    t0 = time.time()
    walk, walk_any = {}, {}
    st_plain = cuda_ms(lambda: lambda: T.trace_closest_reference(
        *k1_args, walk=walk), 1)
    sa_plain = cuda_ms(lambda: lambda: T.trace_any_reference(
        *sh_args, walk=walk_any), 1)
    plain_walk_s = time.time() - t0
    for label, got, w in (("closest", tot, walk), ("any-hit", tot_any,
                                                   walk_any)):
        want = T.walk_totals(w, dev)
        if not torch.equal(got, want):
            raise AssertionError(f"K1 {label} stats {got.tolist()} differ "
                                 f"from the plain walk's {want.tolist()}")
    po, pd, ptmax = (torch.from_numpy(x).to(dev) for x in probes(scene))
    pwalk = {}
    T.trace_closest_reference(po, pd, C.EPSILON_T, ptmax, scene.tri_bvh,
                              scene.triangles, T._as_i32(None, 4096, dev),
                              T._as_i32(None, 4096, dev), walk=pwalk)
    if not torch.equal(T.trace_closest_stats(po, pd, C.EPSILON_T, ptmax,
                                             scene.tri_bvh,
                                             scene.triangles)[4],
                       T.walk_totals(pwalk, dev)):
        raise AssertionError("K1 stats differ from the plain walk on the "
                             "4096 probes")
    k1_ms = kernel_ms(lambda: lambda: T.trace_closest(*k1_args), 5)
    st_ms, st_win = timed(lambda: lambda: T.trace_closest_stats(*k1_args), 5)
    any_ms = kernel_ms(lambda: lambda: T.trace_any(*sh_args), 5)
    sa_ms, sa_win = timed(lambda: lambda: T.trace_any_stats(*sh_args), 5)
    st_b, st_by = k1_stats_bound(walk, closest_lane_bytes(n, n),
                                  K1_CLOSEST_SLOT_BYTES)
    n_sh = int(do_sh.sum())
    sa_b, sa_by = k1_stats_bound(walk_any, any_lane_bytes(n, n_sh),
                                  K1_ANY_SLOT_BYTES)
    per_ray = lambda t: ", ".join(
        f"{k} {v / n:.3f}/ray" for k, v in zip(T.STATS_KEYS, t.tolist()))
    print(f"K1 stats, textured headline first depth ({n} rays, {n_sh} "
          f"shadow rays): outputs bit-equal to the counter-free kernels, "
          f"totals equal to the plain walk's (whole wavefronts, {plain_walk_s:.1f}s; "
          f"and 4096 probes); closest: {per_ray(tot)}; any-hit: "
          f"{per_ray(tot_any)} [{card}]")
    print(f"K1 stats device ms beside the counter-free kernel on the same "
          f"wavefront: closest {st_ms:.4f} / {st_win:.4f} around the wrapper "
          f"(K1 {k1_ms:.4f}; plain {st_plain:.1f} ms; bound {st_b:.4f} ms by "
          f"{st_by}); any-hit {sa_ms:.4f} / {sa_win:.4f} (K1 any-hit "
          f"{any_ms:.4f}; plain {sa_plain:.1f} ms; bound {sa_b:.4f} ms by "
          f"{sa_by}) [{card}]")
    print("traversal_profile closest: " + json.dumps(profile))
    print("traversal_profile any-hit: " + json.dumps(profile_any))

    # ---- the probe: kernels against the plain path -----------------------
    with plain_kernels():
        plain_smoke = probe_pixel(smoke_scene, smoke_uni, smoke_static,
                                  sw // 2, sh // 2)
        plain_glass = probe_pixel(scene, uni, static, glass % W, glass // W)
    probe_rows_equal(rows_smoke, plain_smoke, "smoke centre probe")
    probe_rows_equal(rows_glass, plain_glass, "headline glass probe")
    first = rows_glass[0]
    if not (first["hit"] == 1.0 and first["is_delta"] == 1.0
            and len(rows_glass) >= 2):
        raise AssertionError(f"the headline probe did not enter the glass: "
                             f"{rows_glass}")
    print(f"probe_pixel: smoke centre {len(rows_smoke)} rows, headline "
          f"pixel {(glass % W, glass // W)} through the glass "
          f"{len(rows_glass)} rows, equal to the plain path's field by "
          f"field; (material, medium event, pdf) per row "
          f"{[tuple(float(r[k]) for k in ('material', 'medium_event', 'pdf')) for r in rows_glass]}")

    # ---- debugSpecularOnly: 160x96, kernels against plain ----------------
    w, h = CHECK_FRAME
    spec_err = 0.0
    hs, hr, henv = B.build_bench_scene(CHECK_SUBDIVISIONS, dev)
    ms_, mr = B.build_materials_scene()
    for name, (s_, r_, env) in (("materials.scene", (ms_, mr, None)),
                                ("textured headline sub 5", (hs, hr, henv))):
        s_.debugSpecularOnly = True
        sc = r_.build_arrays(environment=env, device=dev)
        st_, un_ = scene_setup(s_, r_, w, h, dev)
        t_k = time.time()
        st_k = frame.render_samples(sc, un_, RenderState.create(w, h, dev),
                                    st_, SPEC_CHECK_SPP)
        torch.cuda.synchronize()
        t_p = time.time()
        with plain_kernels():
            st_p = frame.render_samples(sc, un_, RenderState.create(w, h, dev),
                                        st_, SPEC_CHECK_SPP)
        torch.cuda.synchronize()
        spec_err = max(spec_err, exact_gate(
            st_k, st_p, f"debugSpecularOnly {name} {w}x{h} "
            f"{SPEC_CHECK_SPP}spp kernels vs "
            f"plain ({t_p - t_k:.1f}s / {time.time() - t_p:.1f}s)"))

    out["trace_closest_stats"] = dict(
        source=ROOT + "traverse.cu",
        replaces="metal_pathtracer_tpu/ops/pallas/traverse.py:726",
        launches=launches["trace_closest_stats"], max_abs_err=0.0,
        ms=st_ms, plain_ms=st_plain, bound_ms=st_b, bound_by=st_by)
    out["trace_any_stats"] = dict(
        source=ROOT + "traverse.cu",
        replaces="metal_pathtracer_tpu/ops/pallas/traverse.py:726",
        launches=launches["trace_any_stats"], max_abs_err=0.0, ms=sa_ms,
        plain_ms=sa_plain, bound_ms=sa_b, bound_by=sa_by)
    for k in ("shade_s1", "shade_s2"):
        out[k]["max_abs_err"] = max(out[k]["max_abs_err"], spec_err)



# ---- phase 7: MNEE -----------------------------------------------------------

#: the headline with MNEE on: one timed sample after a warm-up
MNEE_TIMED_SPP = 1
#: samples of the MNEE and mesh-files phases' 160x96 renders through the
#: kernels against the plain path (the plain path takes ~25 s a sample
#: there, and the script has 1,200 s)
NEW_CHECK_SPP = 1
#: the Cornell box with MNEE on through the CLI
MNEE_CORNELL_SPP = 8
#: the fork state s2 writes per lane with MNEE's secondary chain on
FORK_BYTES = 8
#: the card against the native oracle on ``tests/test_oracle_parity.py
#: test_mnee_chain_rmse``'s scene (a glass sphere on a radius-100 ground
#: sphere under a rect light, both chains on), through the CLI. The two
#: are RNG twins but not bit twins there: a caustic path under the glass
#: takes another turn in the oracle than in the JAX package, and the port
#: follows the JAX package (ROADMAP Queue 3; ``tests/test_torch_mnee.py
#: test_mnee_oracle_gap_is_the_references``). So the card is held to the
#: port's plain path on the CPU (``--backend cpu-torch``, the JAX
#: render's twin) at ``IMAGE_GATE`` over ``ORACLE_MNEE_CHECK_SPP`` samples,
#: and its gap to the oracle to the plain path's; at ``ORACLE_SPP`` the
#: means must agree with the oracle's within ``ORACLE_MNEE_MEAN``
ORACLE_MNEE = """\
camera target=0,0.5,0 distance=3.2 yaw=0 pitch=0.15 vfov=45
renderer maxDepth=8 seed=11 enableSpecularNee=1 enableMnee=1 enableMneeSecondary=1
material type=lambert albedo=0.65,0.65,0.65
material type=glass ior=1.5
material type=light emit=24,22,18
sphere center=0,-100,0 radius=100 material=0
sphere center=0,0.55,0 radius=0.5 material=1
rectangle x=-0.5,0.5 y=2.2 z=-0.5,0.5 normal=-1 material=2
"""
ORACLE_MNEE_CHECK_SPP = 4
ORACLE_MNEE_MEAN = 1e-5


def mnee_lanes(scene, uni, static, dev):
    """One sample of the frame loop with the chain estimators spied on:
    per depth the closest traces, the MNEE-eligible lanes (those the
    secondary chain traces), the secondary-chain lanes (those whose chain
    sample reached the estimators) and the chain estimators' scene and
    shadow traces; and the sample's render state. A host sync per depth,
    so it runs apart from the timed renders."""
    from metal_pathtracer_tpu_torch.ops import specnee
    from metal_pathtracer_tpu_torch.ops.kernels import shade as S
    from metal_pathtracer_tpu_torch.renderer import frame
    from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState

    rows = []
    real_s1, real_dce = S.shade_s1, specnee.delta_chain_estimators
    real_chain = specnee._secondary_chain

    def s1_spy(carry, *args, **kw):
        rows.append({"closest": int(carry.alive.sum()), "eligible": 0,
                     "chain": 0})
        return real_s1(carry, *args, **kw)

    def chain_spy(*args):
        # (scene, uniforms, static, clamp, origin, ...): the chain's lanes
        got = real_chain(*args)
        rows[-1].update(eligible=int(args[4].shape[0]),
                        chain=int(got[0].sum()))
        return got

    def dce_spy(*args, **kw):
        add, n_scene, n_shadow = real_dce(*args, **kw)
        rows[-1].update(scene=int(n_scene), shadow=int(n_shadow))
        return add, n_scene, n_shadow

    s1_spy.launches = 0
    with mock.patch.object(S, "shade_s1", s1_spy), \
            mock.patch.object(specnee, "delta_chain_estimators", dce_spy), \
            mock.patch.object(specnee, "_secondary_chain", chain_spy):
        st = frame.render_samples(scene, uni, RenderState.create(
            static.width, static.height, dev), static, 1)
    return rows, st


def s2_fork_check(kept, depth, n, label):
    """A kept s2 launch with the fork-state export against its plain
    version: the fork state bit-equal (and, before the roulette's depths,
    equal to the carry state s2 commits), carry and chain within 1e-4 as
    at the headline's depths; returns the largest carry or chain
    difference."""
    from metal_pathtracer_tpu_torch.ops.kernels import build
    from metal_pathtracer_tpu_torch.ops.kernels import shade as S

    (chain, fork), ck = k2_once(kept, "s2", depth)
    (chain_p, fork_p), cp = k2_once(kept, "s2", depth, S.shade_s2_reference)
    torch.cuda.synchronize()
    build.check_planes("K2 s2", chain, n, len(S.CHAIN))
    if fork.dtype != torch.int64 or not torch.equal(fork, fork_p):
        bad = int((fork != fork_p).sum())
        raise AssertionError(f"{label}: s2's fork state differs from its "
                             f"plain version on {bad} lanes")
    if depth < 5 and not torch.equal(fork, ck.state):
        raise AssertionError(f"{label}: the fork state differs from the "
                             "committed state before the roulette's depths")
    differ, err = carry_error(ck, cp, n)
    err = max(err, float(((chain - chain_p).abs()
                          / chain_p.abs().clamp_min(1.0)).max()))
    if differ > 1e-4 * n or not err <= 1e-4:
        raise AssertionError(f"{label}: K2 s2 with the fork export disagrees "
                             f"with its plain version: {differ} lanes, err "
                             f"{err}")
    return err


def cli_run(args, kernels, label, card):
    """The port's CLI in this process with the launch counts reset just
    before: (linear image of its EXR, launches, wall seconds, the CLI's
    own "Rendered" line)."""
    import io

    from metal_pathtracer_tpu_torch import cli
    from metal_pathtracer_tpu_torch.utils import image_io

    output = args[args.index("--output") + 1]
    reset_launches(kernels)
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    said = [line for line in buf.getvalue().splitlines()
            if line.startswith("Rendered")]
    if rc != 0 or not said:
        raise AssertionError(f"{label}: the CLI failed ({rc}): "
                             f"{buf.getvalue()}")
    ch = image_io.read_exr(output)
    img = np.stack([ch["R"], ch["G"], ch["B"]], -1)
    if not (np.isfinite(img).all() and img.max() > 0.0):
        raise AssertionError(f"{label}: image is not finite and non-zero")
    print(f"{label}: {said[0]}, {wall:.2f}s of wall time with the scene's "
          f"set-up, mean {float(img.mean()):.4f}, launches {launches} "
          f"[{card}]")
    return img, launches, wall, said[0]


def mnee_path(dev, card, kernels, out):
    """Phase 7, MNEE's delta chains: the headline with MNEE on (the glass
    icosphere under the HDR sun) at 160x96 2 spp through the kernels
    against the plain path and at 1920x1080 d8 timed, its MNEE-eligible
    and secondary-chain lanes per depth and its ray counts with the chain
    traces, K2 s2's fork-state export bit for bit against its plain
    version at depths 0 and 1 in both instantiations (the base on the
    headline, the extended on the Cornell box with a plastic sphere), the
    Cornell box with ``--enableMnee 1`` through the CLI at 512x512 d8,
    and ``test_mnee_chain_rmse``'s scene through the CLI on the card and
    on the native oracle at 128x128 64 spp."""
    import os
    import tempfile

    from metal_pathtracer_tpu_torch.ops.kernels import shade as S
    from metal_pathtracer_tpu_torch.renderer import frame, oracle
    from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
    from metal_pathtracer_tpu_torch.scene import dsl
    from metal_pathtracer_tpu_torch.scene.resources import SceneResources
    from metal_pathtracer_tpu_torch.settings import RenderSettings
    from metal_pathtracer_tpu_torch.utils import benchscene

    def build(subdivisions):
        t0 = time.time()
        settings, res, env = benchscene.build_bench_scene(subdivisions, dev)
        settings.enableMnee = settings.enableMneeSecondary = True
        scene = res.build_arrays(environment=env, device=dev)
        torch.cuda.synchronize()
        return settings, res, scene, time.time() - t0

    # ---- 160x96 at subdivision 5: the kernels against plain ------
    marks = [("start", time.time())]
    settings, res, scene, _ = build(CHECK_SUBDIVISIONS)
    w, h = CHECK_FRAME
    static, uni = scene_setup(settings, res, w, h, dev)
    if not (static.enable_mnee and static.enable_mnee_secondary):
        raise AssertionError("headline-mnee: MNEE is not on")
    st_k = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                static, NEW_CHECK_SPP)
    with plain_kernels():
        st_p = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                    static, NEW_CHECK_SPP)
    check_err = image_gate(
        st_k.present().cpu().numpy(), st_p.present().cpu().numpy(),
        (st_k.ray_count, st_k.shadow_ray_count),
        (st_p.ray_count, st_p.shadow_ray_count),
        f"headline-mnee: texture stage + K1 + K2 s1/s2 (fork export) "
        f"{w}x{h} {NEW_CHECK_SPP}spp kernel vs plain")

    # ---- 1920x1080 d8: one timed sample --------------------------------
    marks.append(("160x96 check", time.time()))
    settings, res, scene, setup_s = build(HEADLINE_SUBDIVISIONS)
    W, H = FRAME
    n = W * H
    st, img, secs, launches, peak = timed_render(
        scene, settings, res, W, H, MNEE_TIMED_SPP, dev, kernels)
    path = ("trace_closest", "trace_any", "shade_s1", "shade_s2",
            "texture_stage")
    if min(launches[k] for k in path) <= 0:
        raise AssertionError(f"a kernel of the headline-mnee path was not "
                             f"launched: {launches}")
    MAIN_LAUNCHES["headline-mnee"] = launches
    traces = st.ray_count + st.shadow_ray_count
    print(f"headline-mnee {W}x{H} d8: {MNEE_TIMED_SPP} spp in {secs:.3f}s, "
          f"{1e3 * secs / MNEE_TIMED_SPP:.2f} ms/spp, "
          f"{traces / secs / 1e6:.2f} Mrays/s ({st.ray_count} closest + "
          f"{st.shadow_ray_count} shadow traces), peak {peak / 2**20:.0f} "
          f"MiB, set-up {setup_s:.1f}s, launches a sample {launches}, mean "
          f"{float(img.mean()):.4f} [{card}]")

    # ---- the chain lanes per depth, and the ray counts -----------------
    marks.append(("1080p build and sample", time.time()))
    static, uni = scene_setup(settings, res, W, H, dev)
    rows, st1 = mnee_lanes(scene, uni, static, dev)
    for depth, row in enumerate(rows):
        print(f"headline-mnee depth {depth}: {row['closest']} closest "
              f"traces, {row['eligible']} MNEE-eligible lanes, "
              f"{row['chain']} secondary-chain lanes, chain estimators "
              f"{row.get('scene', 0)} scene + {row.get('shadow', 0)} shadow "
              f"traces [{card}]")
    closest = sum(r["closest"] for r in rows)
    chain_scene = sum(r.get("scene", 0) for r in rows)
    eligible = sum(r["eligible"] for r in rows)
    if st1.ray_count != closest + chain_scene:
        raise AssertionError(f"headline-mnee: {st1.ray_count} traces counted "
                             f"against {closest} closest + {chain_scene} "
                             "chain traces")
    # no rect light: the chains' scene traces are the secondary chain's
    if eligible == 0 or chain_scene != eligible \
            or sum(r["chain"] for r in rows) == 0:
        raise AssertionError(f"headline-mnee: the secondary chain traced "
                             f"{chain_scene} rays for {eligible} eligible "
                             "lanes")
    print(f"headline-mnee, one sample: {st1.ray_count} traces = {closest} "
          f"closest + {chain_scene} secondary-chain traces; "
          f"{st1.shadow_ray_count} shadow traces [{card}]")

    # ---- s2's fork export at depths 0 and 1, timed at depth 0 -----------
    rows2, kept = frame_loop_k2(scene, uni, static, dev, keep=(0, 1))
    if not all(kept["s2", d][1].get("fork") for d in (0, 1)):
        raise AssertionError("headline-mnee: s2 was not asked for the fork "
                             "state")
    s2_err = max(s2_fork_check(kept, d, n, f"headline-mnee depth {d}")
                 for d in (0, 1))
    args, kw = kept["s2", 0]
    no_fork = {("s2", 0): (args, {**kw, "fork": False})}
    fork_ms, fork_win = timed(k2_launch(kept, "s2", 0), 5)
    plain_ms = cuda_ms(lambda: (lambda c: lambda: S.shade_s2_reference(
        c, *args[1:], **kw))(clone(args[0])), 2)
    nofork_ms = kernel_ms(k2_launch(no_fork, "s2", 0), 5)
    b, by, _ = s2_bounds(n, rows2[0]["s2_live"], args[11], args[0], args[2],
                         fork=True)
    b_off, _, _ = s2_bounds(n, rows2[0]["s2_live"], args[11], args[0],
                            args[2])
    print(f"headline-mnee depth 0 ({rows2[0]['s2_live']} lanes into s2): K2 "
          f"s2 with the fork export {fork_ms:.4f} / {fork_win:.4f} ms "
          f"(plain {plain_ms:.1f} ms, bound {b:.4f} ms by {by}), without "
          f"it {nofork_ms:.4f} ms (bound {b_off:.4f}); fork state bit-equal "
          f"to the plain version at depths 0 and 1, carry and chain err "
          f"{s2_err:.2e} [{card}]")

    # ---- the extended instantiation's export: Cornell + plastic ---------
    marks.append(("chain lanes and the export", time.time()))
    mirror = "type=metal albedo=0.95,0.95,0.95 roughness=0.02"
    text = benchscene.cornell_scene_text()
    if mirror not in text:
        raise AssertionError("cornell.scene has no mirror line to replace")
    text = text.replace(mirror,
                        "type=plastic color=0.2,0.4,0.8 coatRoughness=0.1")
    ps, pr = RenderSettings(), SceneResources()
    dsl.parse_scene(text, ps, pr)
    ps.enableMnee = True
    cscene = pr.build_arrays(device=dev)
    cw, ch = benchscene.CORNELL_FRAME
    cstatic, cuni = scene_setup(ps, pr, cw, ch, dev)
    _, ckept = frame_loop_k2(cscene, cuni, cstatic, dev, keep=(0, 1))
    if not ckept["s2", 0][0][9].extended:
        raise AssertionError("cornell-plastic-mnee: not the extended "
                             "instantiation")
    ext_err = max(s2_fork_check(ckept, d, cw * ch,
                                f"cornell-plastic-mnee depth {d}")
                  for d in (0, 1))
    print(f"cornell-plastic-mnee {cw}x{ch}: the extended s2's fork state "
          f"bit-equal to its plain version at depths 0 and 1, carry and "
          f"chain err {ext_err:.2e} [{card}]")

    out["shade_s2_mnee"] = dict(
        source=ROOT + "shade.cu",
        replaces="metal_pathtracer_tpu/ops/pallas/shade.py:1845",
        launches=launches["shade_s2"],
        max_abs_err=max(check_err, s2_err, ext_err), ms=fork_ms,
        plain_ms=plain_ms, bound_ms=b, bound_by=by)

    # ---- cornell-mnee through the CLI; the oracle's MNEE scene ---------
    marks.append(("the extended export", time.time()))
    with tempfile.TemporaryDirectory() as tmp:
        cli_run(["--scene", str(benchscene.CORNELL_PATH), "--width",
                 str(cw), "--height", str(ch), "--sppTotal",
                 str(MNEE_CORNELL_SPP), "--maxDepth", "8", "--enableMnee",
                 "1", "--backend", "metal", "--output",
                 os.path.join(tmp, "cornell_mnee.exr")], kernels,
                f"cornell-mnee {cw}x{ch} d8 --enableMnee 1 --backend metal",
                card)
        launches_c = {k: fn.launches for k, fn in kernels.items()}
        for k in ("sphere_nearest_brute", "rect_nearest", "shade_s1",
                  "shade_s2"):
            if launches_c[k] <= 0:
                raise AssertionError(f"cornell-mnee: {k} was not launched")
        MAIN_LAUNCHES["cornell-mnee"] = launches_c
        card_img, oracle_img = oracle_renders(tmp, card, ORACLE_MNEE,
                                              "oracle_mnee")
        diff = abs(float(card_img.mean()) - float(oracle_img.mean()))
        print(f"the card against the native oracle, test_mnee_chain_rmse's "
              f"scene at {ORACLE_FRAME[0]}x{ORACLE_FRAME[1]} {ORACLE_SPP} "
              f"spp through the CLI: RMSE "
              f"{oracle.rmse(card_img, oracle_img):.3e}, means within "
              f"{diff:.3e} (means gate {ORACLE_MNEE_MEAN}) [{card}]")
        if not diff < ORACLE_MNEE_MEAN:
            raise AssertionError("the card's MNEE render's mean is off the "
                                 "oracle's")
        marks.append(("cornell-mnee and the oracle at 64 spp", time.time()))
        # the card against the plain path on the CPU, and both against
        # the oracle, at fewer samples
        spp = ORACLE_MNEE_CHECK_SPP
        imgs = {}
        for backend in ("metal", "cpu-torch", "oracle"):
            imgs[backend] = cli_run(
                ["--scene", os.path.join(tmp, "oracle_mnee.scene"),
                 "--width", str(ORACLE_FRAME[0]), "--height",
                 str(ORACLE_FRAME[1]), "--sppTotal", str(spp), "--backend",
                 backend, "--output",
                 os.path.join(tmp, f"mnee_check_{backend}.exr")], kernels,
                f"test_mnee_chain_rmse's scene {spp} spp --backend "
                f"{backend}", card)[0]
        d = np.abs(imgs["metal"] - imgs["cpu-torch"])
        rmse = oracle.rmse(imgs["metal"], imgs["cpu-torch"])
        within = float((d.max(-1) < 1e-5).mean())
        gap, plain_gap = (oracle.rmse(imgs[k], imgs["oracle"])
                          for k in ("metal", "cpu-torch"))
        print(f"test_mnee_chain_rmse's scene at {ORACLE_FRAME[0]}x"
              f"{ORACLE_FRAME[1]} {spp} spp: the card against the plain "
              f"path on the CPU RMSE {rmse:.3e}, {within:.5f} of pixels "
              f"within 1e-5; against the oracle {gap:.3e}, the plain "
              f"path's {plain_gap:.3e} [{card}]")
        if not (rmse < IMAGE_GATE["max_rmse"]
                and within > IMAGE_GATE["min_within_1e5"]
                and abs(gap - plain_gap) <= 1e-2 * plain_gap + 1e-7):
            raise AssertionError("the card's MNEE render is off the plain "
                                 "path's")
    marks.append(("the plain-path check", time.time()))
    print("# MNEE phase: " + ", ".join(
        f"{name} {t - marks[k][1]:.1f}s"
        for k, (name, t) in enumerate(marks[1:])))


# ---- phase 8: mesh files -----------------------------------------------------

#: samples of the mesh-files render through the CLI
MESH_FILES_SPP = 4


def mesh_files_path(dev, card, kernels, out):
    """Phase 8, the mesh loaders: the headline's meshes written as PLY,
    OBJ and GLB files and a ``.scene`` of ``mesh`` records, loaded (the
    PLY and OBJ triangles, normals and UVs against the in-memory meshes
    bit for bit, MikkTSpace tangents, the resampled texture), rendered at
    160x96 2 spp (subdivision 5) through the kernels against the plain
    path, and at 1920x1080 d8 through the CLI with ``--backend metal``,
    its set-up seconds (parse, SAH and atlas) beside its ms/spp."""
    import os
    import tempfile

    from metal_pathtracer_tpu_torch.ops import env as env_ops
    from metal_pathtracer_tpu_torch.ops.textures import build_texture_arrays
    from metal_pathtracer_tpu_torch.renderer import frame
    from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
    from metal_pathtracer_tpu_torch.scene import dsl, tangent
    from metal_pathtracer_tpu_torch.scene.obj import transform_mesh
    from metal_pathtracer_tpu_torch.scene.resources import SceneResources
    from metal_pathtracer_tpu_torch.settings import RenderSettings
    from metal_pathtracer_tpu_torch.utils import meshfiles

    def load(path):
        settings, res = RenderSettings(), SceneResources()
        t0 = time.time()
        dsl.load_scene_file(path, settings, res)
        t1 = time.time()
        env = env_ops.load_environment(settings.environmentMapPath, dev)
        t2 = time.time()
        scene = res.build_arrays(environment=env, device=dev)
        torch.cuda.synchronize()
        t3 = time.time()
        build_texture_arrays(res.texture_images, res.texture_srgb,
                             res.texture_wrap, device=dev)
        torch.cuda.synchronize()
        times = dict(parse=t1 - t0, sky=t2 - t1, build=t3 - t2,
                     atlas=time.time() - t3)
        return settings, res, scene, times

    t_start = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        # ---- 160x96 at subdivision 5: the kernels against plain --
        small = os.path.join(tmp, "check")
        os.mkdir(small)
        path, _ = meshfiles.write_headline_files(small, CHECK_SUBDIVISIONS,
                                                 dev)
        settings, res, scene, _ = load(path)
        w, h = CHECK_FRAME
        static, uni = scene_setup(settings, res, w, h, dev)
        st_k = frame.render_samples(scene, uni,
                                    RenderState.create(w, h, dev), static,
                                    NEW_CHECK_SPP)
        with plain_kernels():
            st_p = frame.render_samples(scene, uni,
                                        RenderState.create(w, h, dev),
                                        static, NEW_CHECK_SPP)
        check_err = image_gate(
            st_k.present().cpu().numpy(), st_p.present().cpu().numpy(),
            (st_k.ray_count, st_k.shadow_ray_count),
            (st_p.ray_count, st_p.shadow_ray_count),
            f"mesh-files: texture stage + K1 + K2 s1/s2 {w}x{h} "
            f"{NEW_CHECK_SPP}spp kernel vs plain")

        # ---- the full-size files: loaded and checked ---------------------
        check_s = time.time() - t_start
        t0 = time.time()
        path, meshes = meshfiles.write_headline_files(
            tmp, HEADLINE_SUBDIVISIONS, dev)
        write_s = time.time() - t0
        sizes = {f: os.path.getsize(os.path.join(tmp, f)) for f in
                 ("dragon.ply", "glass.obj", "props.glb")}
        settings, res, scene, times = load(path)
        for k, (got, want) in enumerate(zip(res.meshes[:2], meshes[:2])):
            _, nrm = transform_mesh(want.vertices, want.normals, np.eye(4))
            for label, a, b in (
                    ("triangles", got.vertices[got.indices],
                     want.vertices[want.indices]),
                    ("UVs", got.uv0[got.indices], want.uv0[want.indices]),
                    ("normals", got.normals[got.indices],
                     nrm[want.indices])):
                if not np.array_equal(a.view(np.int32), b.view(np.int32)):
                    raise AssertionError(f"mesh-files: the {got.name} "
                                         f"{label} differ from the "
                                         "in-memory mesh")
        # MikkTSpace made the GLB meshes' tangents; on the sphere they
        # differ from the fallback's (on the flat ground they coincide)
        differ = []
        for m in res.meshes[2:]:
            mikkt = tangent.generate_tangents_mikktspace(
                m.vertices, m.normals, m.uv0, m.indices)
            if mikkt is None or not np.array_equal(m.tangents, mikkt):
                raise AssertionError(f"mesh-files: {m.name}'s tangents are "
                                     "not MikkTSpace's")
            differ.append(not np.array_equal(
                m.tangents, tangent.generate_tangents_fallback(
                    m.vertices, m.normals, m.uv0, m.indices)))
        if not differ[0]:
            raise AssertionError("mesh-files: the checker sphere's tangents "
                                 "are the fallback's")
        tex = scene.textures
        sizes_tex = [(int(tex.level_w[k, 0]), int(tex.level_h[k, 0]))
                     for k in range(len(res.texture_images))]
        if [im.shape[:2] for im in res.texture_images] != \
                [(512, 512), (120, 200)] or sizes_tex[1] != (256, 128):
            raise AssertionError(f"mesh-files: textures {sizes_tex}")
        print(f"mesh-files: {scene.triangles.count} triangles from "
              f"{sizes} bytes of files (written in {write_s:.1f}s); the PLY "
              f"and OBJ triangles and UVs bit-equal to the in-memory "
              f"meshes, their normals to the in-memory normals renormalised "
              f"as every mesh record's transform does; the GLB's tangents "
              f"MikkTSpace's; textures {sizes_tex} (the 200x120 one "
              f"resampled); set-up: parse {times['parse']:.2f}s, sky "
              f"{times['sky']:.2f}s, build_arrays (SAH, atlas, upload) "
              f"{times['build']:.2f}s, of which the atlas alone "
              f"{times['atlas']:.2f}s [{card}]")

        # ---- 1920x1080 d8 through the CLI --------------------------------
        checks_s = time.time() - t0
        W, H = FRAME
        img, launches, wall, said = cli_run(
            ["--scene", path, "--width", str(W), "--height", str(H),
             "--sppTotal", str(MESH_FILES_SPP), "--backend", "metal",
             "--output", os.path.join(tmp, "mesh_files.exr")], kernels,
            f"mesh-files {W}x{H} d8 --backend metal", card)
        for k in ("trace_closest", "trace_any", "shade_s1", "shade_s2",
                  "texture_stage"):
            if launches[k] <= 0:
                raise AssertionError(f"mesh-files: {k} was not launched")
        MAIN_LAUNCHES["mesh-files"] = launches
    print(f"# mesh-files phase: 160x96 check {check_s:.1f}s, files written, "
          f"loaded and checked {checks_s:.1f}s, the CLI render {wall:.1f}s")
    return check_err


# ---- phase 9: instancing ---------------------------------------------------

#: samples of the instanced-headline render through the CLI, and of its
#: 160x96 check against the plain path
INSTANCED_SPP, INSTANCED_CHECK_SPP = 2, 1
#: the depth of those 160x96 checks (the cells render to 8)
INSTANCED_CHECK_DEPTH = 4
#: the instanced scene against the same scene baked into world-space
#: meshes: tests/test_instancing.py test_instanced_matches_baked's gate
BAKED_MAX_RMSE = 2e-3
# instanced K1: a lane's ray in (origin, direction, t_max, exclusion ids)
# and hit out (t, tri, u, v, placement); a dead lane's t_max in and hit
# out; each placement's 128 B table row read once a launch; ~21 flops to
# map a ray into a placement's object space. The TLAS walk's own charge:
# each TLAS node and placement box it tested (32 B), the 80 B of each row
# it walked, and 24 flops a TLAS slab test
KI_LANE_BYTES = 36 + 20
KI_DEAD_BYTES = 4 + 20
KI_ROW_BYTES = 128
KI_WALK_ROW_BYTES = 80
KI_MAP_OPS = 21
#: probes of each instanced scene; every 61st lane dead (the grid's
#: sequential plain walk over 80 placements takes ~30 s a thousand
#: probes on a slow host)
KI_PROBES = 2048


def baked_resources(res):
    """``res`` with every placement of an instanced mesh baked into a
    world-space mesh, as ``tests/test_instancing.py
    test_instanced_matches_baked`` bakes them: the vertices through the
    float64 4x4, the normals through the inverse transpose, renormalised;
    the placement's material."""
    import copy
    import dataclasses

    out = copy.copy(res)
    out.meshes = list(res.meshes)
    out.mesh_instances = []
    for inst in res.mesh_instances:
        src, m = inst.source, np.asarray(inst.transform, np.float64)
        v = src.vertices @ m[:3, :3].T + m[:3, 3]
        n = src.normals @ np.linalg.inv(m)[:3, :3]
        n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
        out.meshes.append(dataclasses.replace(
            src, name=src.name + "-baked", vertices=v.astype(np.float32),
            normals=n.astype(np.float32), material=inst.material))
    return out


def world_boxes(scene):
    """Each placement's unpadded world box in float64, in flat order: the
    8 corners of its group's root box mapped local -> world."""
    lo, hi = [], []
    for g in scene.instanced:
        b = g.tri_bvh
        c = np.array([[float((b.bounds_max if k >> a & 1 else b.bounds_min)
                             [0, a]) for a in range(3)] for k in range(8)])
        for m in g.l2w.double().cpu().numpy():
            w = c @ m[:, :3].T + m[:, 3]
            lo.append(w.min(0))
            hi.append(w.max(0))
    return np.array(lo), np.array(hi)


def instanced_probes(scene, dev, n=KI_PROBES, seed=11):
    """n probes of the instanced groups: a third aimed at random points of
    placed triangles, a third grazing a face of a placement's world box
    (origin on the face's plane, no direction component across it), a
    third random; every 61st lane dead, and each live lane of the second
    half excluding the first hit of a first trace (its global instance id
    and object triangle): (o, d, t_max, ex_mesh, ex_prim)."""
    from metal_pathtracer_tpu_torch.ops.kernels import traverse as T

    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.0, 3.0, (n, 3))
    d = rng.normal(size=(n, 3))
    third = n // 3
    targets = []
    for _, _, g, i, _ in T.placements(scene.instanced):
        tri = g.triangles.shade_packed[:, :9].cpu().numpy().reshape(-1, 3, 3)
        l2w = g.l2w[i].cpu().numpy().astype(np.float64)
        k = rng.integers(0, len(tri), third)
        p = (rng.dirichlet([1.0, 1.0, 1.0], third)[:, :, None]
             * tri[k]).sum(1)
        targets.append(p @ l2w[:, :3].T + l2w[:, 3])
    pick = rng.integers(0, len(targets), third)
    d[:third] = np.stack(targets, 1)[np.arange(third), pick] - o[:third]
    lo, hi = world_boxes(scene)
    g = np.arange(third, 2 * third)
    k = rng.integers(0, len(lo), third)
    axis = rng.integers(0, 3, third)
    face = np.where(rng.integers(0, 2, third) == 0, lo[k, axis], hi[k, axis])
    centre, size = (lo[k] + hi[k]) * 0.5, hi[k] - lo[k]
    o[g] = centre + rng.uniform(-1.5, 1.5, (third, 3)) * size
    o[g, axis] = face
    d[g] = centre + rng.uniform(-0.5, 0.5, (third, 3)) * size - o[g]
    d[g, axis] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    o[g, axis] = face.astype(np.float32)
    tmax = np.full(n, 1e20, np.float32)
    tmax[::61] = 0.0
    t = lambda a: torch.from_numpy(a).to(dev)
    o, d, tmax = t(o), t(d), t(tmax)
    none = torch.full((n,), -1, dtype=torch.int32, device=dev)
    _, tri, _, _, inst = T.trace_instanced_closest(o, d, 1e-3, tmax,
                                                   scene.instanced)
    ids = instance_ids(scene, inst)
    half = torch.arange(n, device=dev) >= n // 2
    ex_mesh = torch.where(half & (inst >= 0), ids, none)
    ex_prim = torch.where(half & (inst >= 0), tri, none)
    return o, d, tmax, ex_mesh, ex_prim


def instance_ids(scene, inst):
    """The global instance id of each flat placement index (-1 stays)."""
    base = scene.instanced[0].base_id
    return torch.where(inst >= 0, inst + base, -1).to(torch.int32)


def compare_instanced(got, ref, label):
    """Instanced K1 outputs (t, tri, u, v, placement) bit for bit; returns
    the largest |t| difference (0)."""
    err = compare_trace(got[:4], ref[:4])
    if not torch.equal(got[4], ref[4]):
        raise AssertionError(f"{label}: the placement differs on "
                             f"{int((got[4] != ref[4]).sum())} lanes")
    return err


def ki_bound(scene, walk, n, n_live, any_hit=False):
    """Instanced K1's bound at the sequential walk's charge (the charge
    of the kernel as first ported): the lanes' own bytes, every
    placement's table row, and every node and triangle slot of each group
    that the walks of its placements touched read once (``k1_bound``'s
    charges); the flops of the slab and triangle tests and of mapping each
    live ray into every placement. With a TLAS walk's ``walk``
    (``trace_instanced_*_tlas_reference``) the TLAS walk's own charge:
    the TLAS nodes and placement boxes it tested and the rows it walked
    in place of every row, the rays mapped only into those. (ms, by)."""
    lane = any_lane_bytes(n, n_live) if any_hit else \
        n_live * KI_LANE_BYTES + (n - n_live) * KI_DEAD_BYTES
    slot = K1_ANY_SLOT_BYTES if any_hit else K1_CLOSEST_SLOT_BYTES
    touched = sum(int(w["nodes"].sum()) * K1_NODE_BYTES
                  + int(w["slots"].sum()) * slot
                  for w in walk.get("groups", {}).values())
    ops = walk.get("node_visits", 0) * K1_NODE_OPS \
        + walk.get("tri_tests", 0) * K1_TRI_OPS
    if "tlas_nodes" in walk:
        tlas = (int(walk["tlas_nodes"].sum()) + int(walk["boxes"].sum())) \
            * K1_NODE_BYTES + int(walk["rows"].sum()) * KI_WALK_ROW_BYTES
        return bound_ms(lane + touched + tlas,
                        ops + walk["tlas_tests"] * K1_NODE_OPS
                        + walk["placement_walks"] * KI_MAP_OPS)
    return bound_ms(lane + touched + scene.n_instances * KI_ROW_BYTES,
                    ops + n_live * scene.n_instances * KI_MAP_OPS)


def frame_loop_inst(scene, uni, static, dev, keep=()):
    """One sample of the frame loop with the instanced K1 wrappers spied
    on, as ``frame_loop_k1`` spies on K1's: the live lanes of every
    launch, {"closest": [...], "any": [...]}, and the inputs of the
    launches ``keep`` names (or of every launch: ``keep="all"``),
    {(wrapper, index): args}."""
    from metal_pathtracer_tpu_torch.ops.kernels import traverse as T
    from metal_pathtracer_tpu_torch.renderer import frame
    from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState

    seen, kept = {"closest": [], "any": []}, {}

    def spy(fn, key):
        def traced(o, d, t_min, t_max, groups, *ex):
            n = o.shape[0]
            tm = _lanes_tmax(o, t_max)
            if keep == "all" or (key, len(seen[key])) in keep:
                kept[key, len(seen[key])] = (
                    o.clone(), d.clone(), t_min, tm.clone(), groups,
                    *(T._as_i32(x, n, o.device).clone() for x in ex))
            seen[key].append(int((tm >= t_min).sum()))
            return fn(o, d, t_min, t_max, groups, *ex)
        traced.launches = 0
        return traced

    with mock.patch.object(T, "trace_instanced_closest",
                           spy(T.trace_instanced_closest, "closest")), \
            mock.patch.object(T, "trace_instanced_any",
                              spy(T.trace_instanced_any, "any")):
        frame.render_samples(scene, uni, RenderState.create(
            static.width, static.height, dev), static, 1)
    return seen, kept


def instanced_probe_check(name, scene, dev, card):
    """Both instanced kernels against the sequential plain walks on
    ``KI_PROBES`` probes of ``scene`` (``instanced_probes``: grazing rays
    included, the second half with exclusions), any-hit with every third
    window cut to 2: bit for bit. Returns the largest |t| difference
    (0)."""
    from metal_pathtracer_tpu_torch.ops.kernels import traverse as T

    o, d, tmax, ex_mesh, ex_prim = instanced_probes(scene, dev)
    n = o.shape[0]
    t0 = time.time()
    probe = (o, d, 1e-3, tmax, scene.instanced, ex_mesh, ex_prim)
    want = T.trace_instanced_closest_reference(*probe)
    err = compare_instanced(T.trace_instanced_closest(*probe), want,
                            f"{name} probes")
    hits = int((want[4] >= 0).sum())
    tm = torch.where(torch.arange(n, device=dev) % 3 == 0, 2.0, tmax)
    occ = T.trace_instanced_any(o, d, 1e-3, tm, scene.instanced)
    compare_flags(occ, T.trace_instanced_any_reference(
        o, d, 1e-3, tm, scene.instanced), f"{name} any-hit probes")
    print(f"{name}: instanced K1 and any-hit bit-equal to the sequential "
          f"plain walks on {n} probes (a third grazing world-box "
          f"faces; {hits} hits, {int(occ.sum())} occluded; "
          f"{scene.n_instances} placements) in {time.time() - t0:.1f}s "
          f"[{card}]")
    return err


#: the instanced headline's launches held against the sequential plain
#: walk, bit for bit and for the bound at its charge: depths 0 and 1
#: (closest-hit 0 and 1; any-hit 0-3, each depth's environment and
#: spec-NEE shadow rays)
KI_SEQ_CHECKS = {"closest": (0, 1), "any": (0, 1, 2, 3)}


def group_walk(walk, g):
    """Lane group ``g``'s part of a walk taken by lane group
    (``trace_instanced_*_tlas_reference`` given ``lane_group``): the
    masks and counts a walk of those lanes alone gives."""
    out = {k: (v[g] if v.dim() == 2 else int(v[g]))
           for k, v in walk.items()
           if torch.is_tensor(v) and k != "lane_group"}
    out["groups"] = {gi: {k: m[g] for k, m in masks.items()}
                     for gi, masks in walk.get("groups", {}).items()}
    return out


def instanced_k1(scene, uni, static, dev, card):
    """Instanced K1, closest and any-hit, at every launch of one sample
    (``frame_loop_inst``: 8 closest and 16 any-hit on the instanced
    headline): each held bit for bit against the plain model of its walk
    order (``trace_instanced_*_tlas_reference``, one call a wrapper over
    all its launches, walked by lane group), device-timed and printed
    beside its live lanes and its bound at the TLAS walk's own charge
    (``ki_bound``); those of depths 0 and 1 (``KI_SEQ_CHECKS``) also held
    against the sequential plain walks, the kernels' plain versions,
    with the bound at their charge (the kernel as first ported); then
    the sums of the sample. Returns (closest entry, any-hit entry) of the
    kernels line but the launches, from the first launch of each."""
    from metal_pathtracer_tpu_torch.ops.kernels import traverse as T

    live, waves = frame_loop_inst(scene, uni, static, dev, keep="all")
    print(f"instanced K1 live lanes per launch over one {static.width}x"
          f"{static.height} sample: closest {live['closest']}, any-hit "
          f"{live['any']} [{card}]")
    entry = {}
    for key, fn, ref, tref in (
            ("closest", T.trace_instanced_closest,
             T.trace_instanced_closest_reference,
             T.trace_instanced_closest_tlas_reference),
            ("any", T.trace_instanced_any, T.trace_instanced_any_reference,
             T.trace_instanced_any_tlas_reference)):
        launches = [waves[key, k] if key == "closest" else waves[key, k][:5]
                    for k in range(len(live[key]))]
        sizes = [a[0].shape[0] for a in launches]
        cat = [torch.cat([a[j] for a in launches])
               for j in range(len(launches[0])) if j not in (2, 4)]
        twalk = {"lane_group": torch.repeat_interleave(
            torch.arange(len(sizes), device=dev),
            torch.tensor(sizes, device=dev)), "n_groups": len(sizes)}
        t0 = time.time()
        model = tref(cat[0], cat[1], launches[0][2], cat[2],
                     scene.instanced, *cat[3:], walk=twalk)
        torch.cuda.synchronize()
        print(f"instanced K1 {key}: the walk model of all {len(sizes)} "
              f"launches in {time.time() - t0:.1f}s [{card}]")
        rows, err, start = [], 0.0, 0
        for k, args in enumerate(launches):
            n = sizes[k]
            n_live = int((args[3] >= args[2]).sum())
            got = fn(*args)
            if key == "closest":
                err = max(err, compare_instanced(
                    got, [x[start:start + n] for x in model],
                    f"instanced K1 launch {k} (walk model)"))
            else:
                compare_flags(got, model[start:start + n],
                              f"instanced any-hit launch {k} (walk model)")
            start += n
            tw = group_walk(twalk, k)
            ms, win = timed(lambda a=args: lambda: fn(*a), 5)
            b, by = ki_bound(scene, tw, n, n_live, key == "any")
            row = dict(ms=ms, b=b, by=by, plain=None, b_seq=None)
            seq = ""
            if k in KI_SEQ_CHECKS[key]:
                walk = {}
                torch.cuda.synchronize()
                t0 = time.time()
                want = ref(*args, walk=walk)
                torch.cuda.synchronize()
                row["plain"] = (time.time() - t0) * 1e3
                if key == "closest":
                    compare_instanced(got, want, f"instanced K1 launch {k}")
                else:
                    compare_flags(got, want, f"instanced any-hit launch {k}")
                row["b_seq"], row["by_seq"] = ki_bound(
                    scene, walk, n, n_live, key == "any")
                seq = (f"; bit-equal to the sequential plain walk, plain "
                       f"{row['plain']:.1f} ms (host clock, its walk "
                       f"counted), bound {row['b_seq']:.4f} ms by "
                       f"{row['by_seq']} at its charge "
                       f"({walk.get('node_visits', 0)} slab and "
                       f"{walk.get('tri_tests', 0)} triangle tests)")
            rows.append(row)
            print(f"instanced K1 {key} launch {k} ({n} lanes, {n_live} "
                  f"live, {scene.n_instances} placements), bit-equal to "
                  f"its walk model: {ms:.4f} ms device, {win:.4f} ms "
                  f"around the wrapper; bound {b:.4f} ms by {by} at the "
                  f"TLAS walk's charge ({tw['tlas_tests']} TLAS slab "
                  f"tests, {tw['placement_walks']} placement walks, "
                  f"{tw.get('node_visits', 0)} slab and "
                  f"{tw.get('tri_tests', 0)} triangle tests){seq} "
                  f"[{card}]")
        print(f"instanced K1 {key}: one sample's {len(rows)} launches "
              f"{sum(r['ms'] for r in rows):.4f} ms device against bounds "
              f"summing to {sum(r['b'] for r in rows):.4f} ms at the TLAS "
              f"walk's charge [{card}]")
        first = rows[0]
        bound, by = min((first["b"], first["by"]),
                        (first["b_seq"], first["by_seq"]))
        entry[key] = dict(
            source=ROOT + "traverse.cu",
            replaces="metal_pathtracer_tpu/ops/pallas/traverse.py:60",
            max_abs_err=err if key == "closest" else 0.0, ms=first["ms"],
            plain_ms=first["plain"], bound_ms=bound, bound_by=by)
    return entry["closest"], entry["any"]


def instanced_grid(scene, settings, res, dev, card):
    """The instanced-grid cell at 1920x1080 d8: one sample through the
    kernels (ms, launches a sample: the instanced K1 once per trace over
    80 placements) and the device time of the depth-0 closest-hit and
    environment any-hit launches with their live lanes."""
    from metal_pathtracer_tpu_torch.ops.kernels import traverse as T
    from metal_pathtracer_tpu_torch.renderer import frame
    from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState

    W, H = FRAME
    static, uni = scene_setup(settings, res, W, H, dev)
    live, waves = frame_loop_inst(scene, uni, static, dev,
                                  keep=(("closest", 0), ("any", 0)))
    for key, fn in (("closest", T.trace_instanced_closest),
                    ("any", T.trace_instanced_any)):
        args = waves[key, 0] if key == "closest" else waves[key, 0][:5]
        ms, win = timed(lambda a=args: lambda: fn(*a), 5)
        print(f"instanced-grid {key} depth 0 ({live[key][0]} live lanes, "
              f"{scene.n_instances} placements): {ms:.4f} ms device, "
              f"{win:.4f} ms around the wrapper [{card}]")
    before = {k: fn.launches for k, fn in
              (("closest", T.trace_instanced_closest),
               ("any", T.trace_instanced_any))}
    torch.cuda.synchronize()
    t0 = time.time()
    st = frame.render_samples(scene, uni, RenderState.create(W, H, dev),
                              static, 1)
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    img = st.present().cpu().numpy()
    if not (np.isfinite(img).all() and img.max() > 0.0):
        raise AssertionError("instanced-grid: the image is not finite and "
                             "lit")
    print(f"instanced-grid {W}x{H} d8 1 spp: {wall:.2f} ms, instanced K1 "
          f"launches {T.trace_instanced_closest.launches - before['closest']}"
          f" closest and {T.trace_instanced_any.launches - before['any']} "
          f"any-hit, mean {img.mean():.4f} [{card}]")


def empty_scenes(tmp, dev, card, kernels):
    """Scenes without any primitive on the card: a solid background and an
    environment map (the headline's EXR sky) at 160x96 2 spp through the
    kernels against the plain path (RMSE 0 expected: every lane misses),
    then at 1920x1080 1 spp, with no K1 or K3 launched."""
    import os

    from metal_pathtracer_tpu_torch.ops import env as env_ops
    from metal_pathtracer_tpu_torch.renderer import frame
    from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
    from metal_pathtracer_tpu_torch.scene import dsl
    from metal_pathtracer_tpu_torch.scene.resources import SceneResources
    from metal_pathtracer_tpu_torch.settings import RenderSettings

    traces = ("trace_closest", "trace_any", "trace_instanced_closest",
              "trace_instanced_any", "sphere_nearest_brute",
              "sphere_nearest_chunked", "rect_nearest")
    for name, line in (("solid", "background solid=0.7,0.8,1.0"),
                       ("sky", "background env=./sky.exr")):
        path = os.path.join(tmp, f"empty_{name}.scene")
        with open(path, "w") as fh:
            fh.write("camera target=0,-0.1,-0.3 distance=4.6 yaw=0.4 "
                     "pitch=0.18 vfov=42\nrenderer maxDepth=8 seed=1234\n"
                     f"{line}\nmaterial type=lambert albedo=0.5,0.5,0.5\n")
        settings, res = RenderSettings(), SceneResources()
        dsl.load_scene_file(path, settings, res)
        env = env_ops.load_environment(settings.environmentMapPath, dev) \
            if settings.environmentMapPath else None
        scene = res.build_arrays(environment=env, device=dev)
        before = {k: fn.launches for k, fn in kernels.items()}
        for (w, h), spp in ((CHECK_FRAME, 2), (FRAME, 1)):
            static, uni = scene_setup(settings, res, w, h, dev)
            st_k = frame.render_samples(scene, uni,
                                        RenderState.create(w, h, dev),
                                        static, spp)
            img = st_k.present().cpu().numpy()
            if not (np.isfinite(img).all() and img.max() > 0.0):
                raise AssertionError(f"empty {name}: not finite and lit")
            if (w, h) != CHECK_FRAME:
                continue
            with plain_kernels():
                st_p = frame.render_samples(
                    scene, uni, RenderState.create(w, h, dev), static, spp)
            image_gate(img, st_p.present().cpu().numpy(),
                       (st_k.ray_count, st_k.shadow_ray_count),
                       (st_p.ray_count, st_p.shadow_ray_count),
                       f"empty {name} {w}x{h} {spp}spp vs plain")
        used = {k: fn.launches - before[k] for k, fn in kernels.items()
                if fn.launches > before[k]}
        if any(k in used for k in traces):
            raise AssertionError(f"empty {name}: a trace kernel launched "
                                 f"for a family the scene lacks: {used}")
        print(f"empty {name}: 160x96 2 spp equal to the plain path, "
              f"1920x1080 1 spp finite; launches {used}, no trace kernel "
              f"[{card}]")


def instanced_k2(scene, uni, static, dev, card):
    """The texture stage, K2 s1 and K2 s2 with instanced lanes against
    their plain versions at depths 0 and 1 of one sample
    (``frame_loop_k2``), as ``k2_depths`` holds them, with each launch's
    SHA-256 digests (``k2_digest``) and device time."""
    from metal_pathtracer_tpu_torch.ops import intersect
    from metal_pathtracer_tpu_torch.ops.kernels import shade as S
    from metal_pathtracer_tpu_torch.ops.kernels import texture as X

    rows, kept = frame_loop_k2(scene, uni, static, dev, keep=(0, 1))
    n = static.width * static.height
    for depth in (0, 1):
        args = kept["s1", depth][0]
        carry, kind = args[0], kept["s1", depth][1]["kind"]
        inst = int((carry.alive & (kind >= intersect.KIND_INSTANCE)).sum())
        tex_args = kept["tex", depth][0]
        got, ck = k2_once(kept, "tex", depth)
        want, cp = k2_once(kept, "tex", depth, X.texture_stage_reference)
        tex_err = compare_texture(got, want, ck, cp, f"instanced-headline "
                                  f"depth {depth} texture stage")
        tpbr = got[:, X.TEX_IDX["tpbr"]] > 0.5
        inst_tex = int((tpbr & (tex_args[-1] >= intersect.KIND_INSTANCE))
                       .sum())
        digests = []
        errs = []
        for which, ref in (("s1", S.shade_s1_reference),
                           ("s2", S.shade_s2_reference)):
            got, ck = k2_once(kept, which, depth)
            want, cp = k2_once(kept, which, depth, ref)
            torch.cuda.synchronize()
            differ, err = carry_error(ck, cp, n)
            err = max(err, float(((got - want).abs()
                                  / want.abs().clamp_min(1.0)).max()))
            if differ > 1e-4 * n or not err <= 1e-4:
                raise AssertionError(
                    f"instanced-headline K2 {which} at depth {depth} "
                    f"disagrees with its plain version: {differ} lanes, "
                    f"err {err}")
            errs.append(err)
            digests.append((k2_digest(got, ck)[:12],
                            k2_digest(want, cp)[:12]))
        times = [kernel_ms(k2_launch(kept, w, depth), 5)
                 for w in ("tex", "s1", "s2")]
        print(f"instanced-headline depth {depth}: {rows[depth]['live']} "
              f"live lanes, {inst} on placements, {inst_tex} of them "
              f"textured; texture stage plane err "
              f"{tex_err:.2e}, s1 err {errs[0]:.2e}, s2 err {errs[1]:.2e} "
              f"against the plain versions; digests (kernel, plain) s1 "
              f"{digests[0]}, s2 {digests[1]}; device ms texture "
              f"{times[0]:.4f}, s1 {times[1]:.4f}, s2 {times[2]:.4f} "
              f"[{card}]")
        if depth == 0 and inst == 0:
            raise AssertionError("instanced-headline: no lane hit a "
                                 "placement")


def instanced_path(dev, card, kernels, out):
    """Phase 9, instancing: the headline's files with the displaced
    icosphere PLY placed three times and the glass icosphere OBJ twice
    with ``instanced=1`` beside the GLB soup (``meshfiles.
    instanced_scene_text``), its grid variant (64 and 16 placements) and
    its tie variant (the OBJ twice, one transform). Both instanced
    kernels against the sequential plain walks on the probes of the three
    scenes and at every launch of one instanced-headline sample, each
    launch timed beside its bound at both charges (``instanced_k1``); one
    grid sample (``instanced_grid``); the scenes without any primitive
    (``empty_scenes``);
    the texture stage and K2 s1/s2 with instanced lanes against theirs;
    160x96 renders to depth 4 through the kernels against the plain
    path (the headline and its lambert variant through K2 ``full``, 1 spp
    each)
    and against the same scenes baked into world-space meshes; then the
    scene at 1920x1080 d8 through the CLI with ``--backend metal``: its
    ms/spp, set-up seconds, peak device memory beside what the baked
    scene's triangles and trees would take, and the launches a sample,
    the instanced K1 once per trace."""
    import os
    import tempfile

    from metal_pathtracer_tpu_torch.ops import env as env_ops
    from metal_pathtracer_tpu_torch.ops.kernels import traverse as T
    from metal_pathtracer_tpu_torch.renderer import frame
    from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
    from metal_pathtracer_tpu_torch.scene import dsl
    from metal_pathtracer_tpu_torch.scene.resources import SceneResources
    from metal_pathtracer_tpu_torch.settings import RenderSettings
    from metal_pathtracer_tpu_torch.utils import meshfiles

    def load(path, bake=False):
        settings, res = RenderSettings(), SceneResources()
        t0 = time.time()
        dsl.load_scene_file(path, settings, res)
        t1 = time.time()
        if bake:
            res = baked_resources(res)
        env = env_ops.load_environment(settings.environmentMapPath, dev) \
            if settings.environmentMapPath else None
        scene = res.build_arrays(environment=env, device=dev)
        torch.cuda.synchronize()
        return settings, res, scene, dict(parse=t1 - t0,
                                          build=time.time() - t1)

    def render(settings, res, scene, w, h, spp):
        static, uni = scene_setup(settings, res, w, h, dev)
        return frame.render_samples(scene, uni,
                                    RenderState.create(w, h, dev), static,
                                    spp)

    marks = [("start", time.time())]
    with tempfile.TemporaryDirectory() as tmp:
        # ---- 160x96 at subdivision 5: kernels against plain and baked ---
        small = os.path.join(tmp, "check")
        os.mkdir(small)
        meshfiles.write_headline_files(small, CHECK_SUBDIVISIONS, dev)
        w, h = CHECK_FRAME
        check_err = 0.0
        for name, spp in (("instanced_headline", INSTANCED_CHECK_SPP),
                          ("instanced_lambert", 1)):
            path = os.path.join(small, name + ".scene")
            settings, res, scene, _ = load(path)
            settings.maxDepth = INSTANCED_CHECK_DEPTH
            if [g.count for g in scene.instanced] != [3, 2]:
                raise AssertionError(f"{name}: groups "
                                     f"{[g.count for g in scene.instanced]}")
            before = {k: fn.launches for k, fn in kernels.items()}
            st_k = render(settings, res, scene, w, h, spp)
            used = [k for k, fn in kernels.items()
                    if fn.launches > before[k]]
            with plain_kernels():
                st_p = render(settings, res, scene, w, h, spp)
            check_err = max(check_err, image_gate(
                st_k.present().cpu().numpy(), st_p.present().cpu().numpy(),
                (st_k.ray_count, st_k.shadow_ray_count),
                (st_p.ray_count, st_p.shadow_ray_count),
                f"{name} {w}x{h} {spp}spp through {'+'.join(used)} vs "
                f"plain"))
            need = ["trace_instanced_closest"] + (
                ["shade_full"] if name == "instanced_lambert" else
                ["trace_instanced_any", "shade_s1", "shade_s2",
                 "texture_stage"])
            if any(k not in used for k in need):
                raise AssertionError(f"{name}: {need} not all launched")
            bs, br, bscene, _ = load(path, bake=True)
            bs.maxDepth = INSTANCED_CHECK_DEPTH
            st_b = render(bs, br, bscene, w, h, spp)
            d = np.abs(st_k.present().cpu().numpy()
                       - st_b.present().cpu().numpy())
            rmse = float(np.sqrt((d * d).mean()))
            print(f"{name} {w}x{h} {spp}spp instanced against baked "
                  f"({bscene.triangles.count} world-space triangles): "
                  f"rmse={rmse:.3e} max_abs={float(d.max()):.3e} [{card}]")
            if not rmse < BAKED_MAX_RMSE:
                raise AssertionError(f"{name}: instanced and baked renders "
                                     f"differ (RMSE {rmse})")
        marks.append(("the 160x96 checks", time.time()))

        # ---- the full-size files: kernels at their wavefronts ------------
        path, _ = meshfiles.write_headline_files(tmp, HEADLINE_SUBDIVISIONS,
                                                 dev)
        path = os.path.join(tmp, "instanced_headline.scene")
        settings, res, scene, times = load(path)
        stored = sum(x.numel() * x.element_size()
                     for g in scene.instanced for part in
                     (g.triangles, g.tri_bvh) for x in vars(part).values()
                     if torch.is_tensor(x))
        baked = sum(x.numel() * x.element_size() * g.count
                    for g in scene.instanced for part in
                    (g.triangles, g.tri_bvh) for x in vars(part).values()
                    if torch.is_tensor(x))
        placed = sum(g.triangles.count * g.count for g in scene.instanced)
        print(f"instanced-headline: groups "
              f"{[(g.triangles.count, g.count) for g in scene.instanced]} "
              f"(object triangles, placements): "
              f"{sum(g.triangles.count for g in scene.instanced)} stored "
              f"for {placed} placed, plus {scene.n_triangles} soup; their "
              f"triangles and trees {stored / 2**20:.1f} MiB against "
              f"{baked / 2**20:.1f} MiB baked; set-up parse "
              f"{times['parse']:.2f}s, build_arrays (SAH of each group "
              f"once, atlas, upload) {times['build']:.2f}s [{card}]")
        W, H = FRAME
        static, uni = scene_setup(settings, res, W, H, dev)
        grid_settings, grid_res, grid, grid_times = load(
            os.path.join(tmp, "instanced_grid.scene"))
        _, _, tie, _ = load(os.path.join(tmp, "instanced_tie.scene"))
        groups = {name: [(g.triangles.count, g.count) for g in sc.instanced]
                  for name, sc in (("headline", scene), ("grid", grid),
                                   ("tie", tie))}
        if [c for _, c in groups["grid"]] != [64, 16] or \
                [c for _, c in groups["tie"]] != [2]:
            raise AssertionError(f"instanced scenes: groups {groups}")
        print(f"instanced scenes (object triangles, placements): {groups}; "
              f"the grid's set-up parse {grid_times['parse']:.2f}s, "
              f"build_arrays {grid_times['build']:.2f}s [{card}]")
        for name, sc in (("instanced-headline", scene),
                         ("instanced-grid", grid), ("instanced-tie", tie)):
            instanced_probe_check(name, sc, dev, card)
        marks.append(("the probes of three scenes", time.time()))
        k1_closest, k1_any = instanced_k1(scene, uni, static, dev, card)
        marks.append(("instanced K1 at every launch", time.time()))
        instanced_k2(scene, uni, static, dev, card)
        marks.append(("K2 and the texture stage", time.time()))
        instanced_grid(grid, grid_settings, grid_res, dev, card)
        del grid, tie
        marks.append(("the grid's sample", time.time()))
        empty_scenes(tmp, dev, card, kernels)
        marks.append(("the empty scenes", time.time()))

        # ---- 1920x1080 d8 through the CLI --------------------------------
        torch.cuda.reset_peak_memory_stats(dev)
        img, launches, wall, said = cli_run(
            ["--scene", path, "--width", str(W), "--height", str(H),
             "--sppTotal", str(INSTANCED_SPP), "--backend", "metal",
             "--output", os.path.join(tmp, "instanced.exr")], kernels,
            f"instanced-headline {W}x{H} d8 --backend metal", card)
        peak = torch.cuda.max_memory_allocated(dev)
        for k in ("trace_instanced_closest", "trace_instanced_any",
                  "trace_closest", "trace_any", "shade_s1", "shade_s2",
                  "texture_stage"):
            if launches[k] <= 0:
                raise AssertionError(f"instanced-headline: {k} was not "
                                     "launched")
        if launches["trace_instanced_closest"] != launches["trace_closest"] \
                or launches["trace_instanced_any"] != launches["trace_any"]:
            raise AssertionError(
                "instanced-headline: the instanced K1 must launch once per "
                f"trace: {launches}")
        per = {k: v / INSTANCED_SPP for k, v in launches.items() if v}
        print(f"instanced-headline {W}x{H} d8: peak device memory "
              f"{peak / 2**30:.2f} GiB; launches a sample {per}; the "
              f"instanced K1 once per trace ({scene.n_instances} "
              f"placements a launch) [{card}]")
        MAIN_LAUNCHES["instanced-headline"] = launches
        out["trace_instanced_closest"] = dict(
            launches=launches["trace_instanced_closest"], **k1_closest)
        out["trace_instanced_any"] = dict(
            launches=launches["trace_instanced_any"], **k1_any)
        marks.append(("the CLI render", time.time()))
    print("# instancing phase: " + ", ".join(
        f"{name} {t - marks[k][1]:.1f}s"
        for k, (name, t) in enumerate(marks[1:])))
    return check_err


# ---- phase 10: the interactive path ----------------------------------------

#: draw_frame(1) calls of the 1920x1080 facade before its displays
FACADE_FRAMES = 4
#: the filters held against their plain versions on the facade's state:
#: (mode, iterations)
ATROUS_CASES = (("fixed", 4), ("svgf", 4), ("learned", 4), ("learned", 5))
#: the à-trous kernel against its plain version, relative to 1 + |plain|
ATROUS_REL_TOL = 1e-6
# one à-trous iteration: a pixel's colour, albedo and normal read (36 B)
# and colour written (12 B); the variance-guided modes also read and write
# the luminance variance (4 B each). Float operations a tap, counted in
# the first port's csrc/denoise.cu (a thread per pixel, a transcendental
# as one): the shared part
# (albedo difference and its square, the normal dot, the weighted sums)
# 20; the fixed weight 23 more; SVGF's 30; the learned one 273 (features
# 21, the MLP's 6-16 layer 208 and 16-1 layer 32, softplus and weight
# 12); 30 a pixel for the variance blur and the normalisation
ATROUS_BYTES = {"fixed": 48, "svgf": 56, "learned": 56}
ATROUS_TAP_OPS = {"fixed": 43, "svgf": 50, "learned": 293}
ATROUS_PIXEL_OPS = 30
# the same work once the redesign's hoists are counted: a tap no longer
# forms the learned MLP's constant terms (64: f3 w1[3] once a pixel, 16
# more a pixel; f4 w1[4] + f5 w1[5] once a launch), the tap normal's n.n
# (5: once a filter, in the pack) or the radius feature (2: a table row)
ATROUS_TAP_OPS_HOISTED = {"fixed": 43, "svgf": 45, "learned": 222}
ATROUS_PIXEL_OPS_HOISTED = {"fixed": 30, "svgf": 30, "learned": 46}
# the pack launch: colour, variance, albedo and normal read (40 B), the
# carried float4 and two guide rows written (48 B); n.n 5 operations
PACK_BYTES, PACK_OPS = 88, 5
# FP32 lanes of an H100 SXM: 132 SMs x 128
F32_LANES = 132 * 128
#: the viewer cell: Cornell box at this size, passes to wait for
VIEWER_SIZE = (320, 180)
VIEWER_SPP = 3


def denoise_bound(mode: str, h: int, w: int):
    """The least time of one à-trous iteration over an h x w image: (ms,
    "bytes" or "operations")."""
    n = h * w
    return bound_ms(n * ATROUS_BYTES[mode],
                    n * (25 * ATROUS_TAP_OPS[mode] + ATROUS_PIXEL_OPS))


def denoise_ops(mode: str, h: int, w: int, hoisted: bool) -> float:
    """Float operations of one iteration, at the first port's charge or
    with the hoists counted."""
    if hoisted:
        return h * w * (25 * ATROUS_TAP_OPS_HOISTED[mode]
                        + ATROUS_PIXEL_OPS_HOISTED[mode])
    return h * w * (25 * ATROUS_TAP_OPS[mode] + ATROUS_PIXEL_OPS)


def sm_clock_mhz() -> float:
    """The card's maximum SM clock as ``nvidia-smi`` reports it (MHz)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(out.stdout.strip().splitlines()[0].split(",")[0])


def lane_rate_ms(n_ops: float, mhz: float) -> float:
    """n_ops at one FP32 operation a lane a clock over the card's 132 x 128
    lanes at ``mhz`` (ms): the lane-rate ceiling of a kernel whose every
    multiply and add is its own instruction."""
    return n_ops / (F32_LANES * mhz * 1e6) * 1e3


def unet_flops(h: int, w: int) -> float:
    """The U-Net's float operations on an h x w input padded to a
    multiple of 8: 2 x 9 x cin x cout a pixel of each convolution at its
    level (enc1, dec1 and out at full size, enc2 and dec2 at 1/2, enc3 and
    dec3 at 1/4, the bottleneck at 1/8)."""
    from metal_pathtracer_tpu_torch.ops.denoise_unet import LAYERS

    h, w = h + (-h) % 8, w + (-w) % 8
    level = {"enc1": 1, "enc2": 2, "enc3": 4, "bottle": 8, "dec3": 4,
             "dec2": 2, "dec1": 1, "out": 1}
    return sum(2.0 * 9 * cin * cout * (h // level[name]) * (w // level[name])
               for name, cin, cout in LAYERS)


@contextlib.contextmanager
def kept_calls(name, kept):
    """Each call of ``ops/kernels/denoise``'s ``name`` appended to ``kept``
    as its (args, kwargs), and passed on."""
    from metal_pathtracer_tpu_torch.ops.kernels import denoise as DK

    real = getattr(DK, name)

    def keep(*a, **k):
        kept.append((a, k))
        return real(*a, **k)

    with mock.patch.object(DK, name, keep):
        yield


def kept_atrous(kept):
    """Each iteration of the à-trous kernel on a filter's rows, kept."""
    return kept_calls("atrous_step_packed", kept)


def plain_atrous():
    """The denoisers with the à-trous filter replaced by its plain
    version (run on the card)."""
    from metal_pathtracer_tpu_torch.ops import denoise as D
    from metal_pathtracer_tpu_torch.ops.kernels import denoise as DK

    return mock.patch.object(DK, "atrous_filter", D.atrous_filter_reference)


def rel_err(got, ref):
    """(max |got - ref| / (1 + |ref|), max |got - ref|, share of values
    bit-equal)."""
    d = (got - ref).abs()
    return (float((d / (1.0 + ref.abs())).max()), float(d.max()),
            float((got == ref).float().mean()))


def packed_result(out, guide):
    """(colour (H, W, 3), variance (H, W) or None) of one packed
    iteration's result: the last one's as it is, the carried float4s'
    unpacked."""
    from metal_pathtracer_tpu_torch.ops import denoise as D

    return out if isinstance(out, tuple) else D.unpack(out, guide)[:2]


#: threads a block of each à-trous kernel (256 but the backward's taps)
ATROUS_THREADS = {"atrous_grad_taps_kernel": 64}


def atrous_resources() -> str:
    """The à-trous kernels' registers, spill bytes, stack frame and shared
    memory a block from the build's ``-Xptxas -v`` output, with blocks an
    SM at each kernel's threads a block (``ATROUS_THREADS``; by registers
    and by shared memory)."""
    import re

    from metal_pathtracer_tpu_torch.ops.kernels import build

    rows, current = [], None
    for line in build.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = build._kernel_name(m.group(1))
            frame = spill = None
            continue
        if current is None or not current.startswith("atrous"):
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame, spill = int(m.group(1)), int(m.group(2)) + int(m.group(3))
            continue
        m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$",
                      line)
        if m:
            regs, smem = int(m.group(1)), int(m.group(2) or 0)
            threads = ATROUS_THREADS.get(current, 256)
            by_regs = 65536 // (threads * ((regs + 7) // 8 * 8))
            by_smem = 233472 // (smem + 1024) if smem else 32
            most = 2048 // threads
            rows.append(f"{current} {regs} registers, {spill} B spilled, "
                        f"{frame} B stack, {smem} B smem: "
                        f"{min(most, by_regs, by_smem)} blocks of {threads} "
                        f"an SM (registers {by_regs}, smem {by_smem})")
            current = None
    return "; ".join(rows)


def atrous_sass(prefix: str = "atrous_step", loops: int = 1) -> str:
    """Instruction counts of the tap loop of each kernel instantiation
    whose name starts with ``prefix`` (the ``loops`` longest backward
    branches of its SASS that hold no other loop of 50 or more
    instructions and do not overlap, ``cuobjdump -sass`` of the built
    library; the backward's taps kernel has one a warp role): all,
    shared-memory loads, constant-bank loads (``ULDC`` into uniform
    registers, ``LDC``), the rounded-up reciprocal conversions that begin
    an integer division or modulo (``I2F.RP``), float operations reading a
    uniform register (a weight), FMUL, FADD, FFMA, MUFU, branches and
    barriers. A tap loop with no ``I2F.RP`` has no integer modulo; with
    ``LDS`` 3 a tap, no shared-memory load of a weight."""
    import re

    from metal_pathtracer_tpu_torch.ops.kernels import build

    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", build.library_path()],
                          capture_output=True, text=True, check=True).stdout
    out = []
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = build._kernel_name(part.split()[0])
        if not name or not name.startswith(prefix):
            continue
        ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)
        at = {int(a, 16): i for i, (a, _) in enumerate(ins)}
        spans = []
        for i, (_, op) in enumerate(ins):
            t = re.search(r"BRA\s+0x([0-9a-f]+)", op)
            j = at.get(int(t.group(1), 16), i) if t else i
            if j < i:
                spans.append((j, i))
        # innermost: no other loop of 50 or more instructions inside
        spans = [(j, i) for j, i in spans if not any(
            j <= c and d <= i and (c, d) != (j, i) and d - c >= 50
            for c, d in spans)]
        found = []
        for j, i in sorted(spans, key=lambda x: x[0] - x[1]):
            if len(found) < loops and all(i < a or j > b for a, b in found):
                found.append((j, i))
        pats = {"LDS": r"\bLDS", "LDC": r"\bU?LDC",
                "I2F.RP": r"\bI2F(\.U32)?\.RP\b",
                "FP ops on a uniform register": r"^F(MUL|ADD|FMA)\b.*\bUR\d",
                "FMUL": r"\bFMUL",
                "FADD": r"\bFADD", "FFMA": r"\bFFMA", "MUFU": r"\bMUFU",
                "FSEL/FMNMX/FSETP": r"\bF(SEL|MNMX|SETP)",
                "BRA": r"\bBRA\b", "BAR": r"\bBAR\b"}
        for j, i in sorted(found):
            body = [op for _, op in ins[j:i + 1]]
            out.append(f"{name}: tap loop {len(body)} instructions, "
                       + ", ".join(
                           f"{k} {sum(bool(re.search(v, op)) for op in body)}"
                           for k, v in pats.items()))
    return "; ".join(out)


def atrous_checks(state, dev, card):
    """The à-trous kernel at every iteration of each filter of
    ``ATROUS_CASES`` on ``state`` (kept from the filter as it runs, on its
    packed rows), against the plain version on the same inputs, timed
    with its bound at the first port's charge, at the hoisted charge and
    at the lane-rate ceiling; each filter's pack launch against its plain
    version, timed; the filters' outputs through the kernels against the
    plain filters. Returns (max abs error, per-iteration ms, plain ms and
    bound of the learned filter's 4 iterations, the pack's entry)."""
    from metal_pathtracer_tpu_torch.ops import denoise as D
    from metal_pathtracer_tpu_torch.ops.kernels import denoise as DK

    h, w = state.height, state.width
    var = state.variance_of_mean()
    tparams = D._learned_params(dev)
    args = (state.present(), state.albedo, state.normal)
    mhz = sm_clock_mhz()
    print(f"à-trous kernels (-Xptxas -v): {atrous_resources()} [{card}]")
    print(f"à-trous tap loops (cuobjdump -sass): {atrous_sass()}")

    def run(mode, iters):
        if mode == "fixed":
            return D.atrous_denoise(*args, iterations=iters)
        if mode == "svgf":
            return D.svgf_denoise(*args, var, iterations=iters)
        return D.learned_denoise(*args, var, tparams, iterations=iters)

    worst, learned4, pack = 0.0, None, None
    pack_bound = bound_ms(h * w * PACK_BYTES, h * w * PACK_OPS)
    for mode, iters in ATROUS_CASES:
        kept = []
        packs = DK.pack.launches
        with kept_atrous(kept):
            out_k = run(mode, iters)
        with plain_atrous():
            out_p = run(mode, iters)
        torch.cuda.synchronize()
        if len(kept) != iters or DK.pack.launches != packs + 1:
            raise AssertionError(f"{mode} x{iters}: {len(kept)} iterations, "
                                 f"{DK.pack.launches - packs} packs")
        f_rel, f_abs, f_eq = rel_err(out_k, out_p)
        # the pack launch that began this filter, against its plain version
        cv0, guide = kept[0][0][:2]
        col, v, alb, nrm = D.unpack(cv0, guide)
        v = None if mode == "fixed" else v
        pk = DK.pack(col, v, alb, nrm)
        pr = D.pack_reference(col, v, alb, nrm)
        if not (torch.equal(pk[0], pr[0]) and torch.equal(pk[1], pr[1])):
            raise AssertionError(f"{mode} x{iters}: the pack launch is not "
                                 "a bit copy")
        pack_ms = kernel_ms(lambda: (lambda: DK.pack(col, v, alb, nrm)), 20)
        pack_plain = cuda_ms(lambda: (lambda: D.pack_reference(
            col, v, alb, nrm)), 5)
        rows, ms_sum, plain_sum, bound_sum = [], 0.0, 0.0, 0.0
        hoist_sum = lane_sum = lane_old = 0.0
        for it, (a, k) in enumerate(kept):
            got, got_var = packed_result(DK.atrous_step_packed(*a, **k),
                                         a[1])
            col, v, alb, nrm = D.unpack(a[0], a[1])
            v = None if mode == "fixed" else v
            mlp = a[3]
            ref, ref_var = D.atrous_step_reference(col, v, alb, nrm, a[2],
                                                   mlp)
            torch.cuda.synchronize()
            r, e, eq = rel_err(got, ref)
            if mode != "fixed":
                rv, ev, eqv = rel_err(got_var, ref_var)
                r, e, eq = max(r, rv), max(e, ev), min(eq, eqv)
            worst = max(worst, e)
            if not r <= ATROUS_REL_TOL:
                raise AssertionError(f"atrous {mode} x{iters} iteration "
                                     f"{it}: {r} relative to plain")
            ms = kernel_ms(lambda: (lambda: DK.atrous_step_packed(*a, **k)),
                           20)
            plain = cuda_ms(lambda: (lambda: D.atrous_step_reference(
                col, v, alb, nrm, a[2], mlp)), 1)
            bound, by = denoise_bound(mode, h, w)
            hoisted, hby = bound_ms(h * w * ATROUS_BYTES[mode],
                                    denoise_ops(mode, h, w, True))
            ceil_new = lane_rate_ms(denoise_ops(mode, h, w, True), mhz)
            ceil_old = lane_rate_ms(denoise_ops(mode, h, w, False), mhz)
            ms_sum, plain_sum, bound_sum = (ms_sum + ms, plain_sum + plain,
                                            bound_sum + bound)
            hoist_sum, lane_sum, lane_old = (hoist_sum + hoisted,
                                             lane_sum + ceil_new,
                                             lane_old + ceil_old)
            rows.append(f"step {a[2].step}: {ms:.4f} ms (plain {plain:.1f}; "
                        f"bound {bound:.4f} by {by}, hoisted {hoisted:.4f} "
                        f"by {hby}, lane rate {ceil_old:.4f} / "
                        f"{ceil_new:.4f}; "
                        f"rel {r:.2e}, bit-equal {eq:.4f})")
        print(f"atrous {mode} x{iters} at {w}x{h}: kernel {ms_sum:.4f} ms "
              f"in {iters} + pack {pack_ms:.4f} ms (plain {pack_plain:.2f}, "
              f"bound {pack_bound[0]:.4f}), plain {plain_sum:.1f} ms, bound "
              f"{bound_sum:.4f} ms "
              f"({100 * bound_sum / ms_sum:.1f} % of it), hoisted "
              f"{hoist_sum:.4f} ({100 * hoist_sum / ms_sum:.1f} %), lane-rate "
              f"ceiling at {mhz:.0f} MHz {lane_old:.4f} / {lane_sum:.4f} "
              f"({100 * lane_old / ms_sum:.1f} / "
              f"{100 * lane_sum / ms_sum:.1f} %); the filter through the "
              f"kernels against the plain filter: rel {f_rel:.2e}, abs "
              f"{f_abs:.2e}, bit-equal {f_eq:.4f}; "
              + "; ".join(rows) + f" [{card}]")
        if not f_rel <= ATROUS_REL_TOL:
            raise AssertionError(f"atrous {mode} x{iters}: the filter "
                                 f"differs from the plain one ({f_rel})")
        if (mode, iters) == ("learned", 4):
            learned4 = (ms_sum / iters, plain_sum / iters, bound_sum / iters,
                        denoise_bound(mode, h, w)[1])
            pack = dict(ms=pack_ms, plain_ms=pack_plain,
                        bound_ms=pack_bound[0], bound_by=pack_bound[1])
    return worst, learned4, pack


def display_trace(r, card, reps: int = 5):
    """The denoised display of type 0 (the learned prepass, 4 iterations,
    then the U-Net) split with CUDA events in ``display_image``'s order:
    present, variance_of_mean, the luminance, the pack and the à-trous
    launches, the U-Net's features and padding, its convolutions, the
    expm1 tail, exposure + bloom + tonemap, the copy to the host. Each
    span's device ms (median of ``reps``) and the host's ms enqueueing it;
    the traced image equals ``Renderer.display``'s bit for bit."""
    from metal_pathtracer_tpu_torch.ops import denoise as D
    from metal_pathtracer_tpu_torch.ops import denoise_unet as U
    from metal_pathtracer_tpu_torch.ops import tonemap as tonemap_ops
    from metal_pathtracer_tpu_torch.ops.kernels import denoise as DK

    st, s = r.state, r.settings
    s.denoiseEnabled, s.denoiseFilterType = True, 0
    net, tparams = D._unet_params(st.albedo.device), \
        D._learned_params(st.albedo.device)
    want = r.display()
    spans = {}
    for _ in range(reps):
        marks = []

        def mark(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((name, e, time.perf_counter()))

        torch.cuda.synchronize()
        mark("start")
        avg = st.present()
        mark("present")
        var = st.variance_of_mean()
        mark("variance_of_mean")
        color, albedo, normal, variance = D._prepare(avg, st.albedo,
                                                     st.normal, var)
        lum = D._luminance(variance).contiguous()
        mlp = DK.pack_mlp(tparams)
        mark("luminance")
        cv, guide = DK.pack(color, lum, albedo, normal)
        mark("pack")
        for it in range(4):
            cv = DK.atrous_step_packed(
                cv, guide, DK.StepParams.learned(1 << it, it / 3), mlp,
                last=it == 3)
        base = cv[0]
        mark("4 à-trous launches")
        h, w = avg.shape[:2]
        ph, pw = (-h) % 8, (-w) % 8
        feats = U._pad_edge(U._features(base, avg, st.albedo, st.normal,
                                        var), ph, pw)
        mark("U-Net features + pad")
        res = net(feats[None])[0]
        mark("U-Net convolutions")
        log_out = torch.log1p(torch.clamp_min(U._pad_edge(base, ph, pw),
                                              0.0)) + res
        hdr = torch.expm1(torch.clamp_min(log_out, 0.0))[:h, :w]
        mark("expm1 tail")
        hdr = hdr * float(torch.exp2(torch.tensor(s.exposure,
                                                  dtype=torch.float32)))
        if s.bloomEnabled:
            hdr = tonemap_ops.bloom(hdr, s.bloomThreshold, s.bloomIntensity,
                                    s.bloomRadius)
        ldr = tonemap_ops.apply_tonemap(hdr, s.tonemapMode, s.acesVariant,
                                        0.0, s.reinhardWhitePoint)
        mark("exposure, bloom, tonemap")
        host = ldr.cpu().numpy()
        mark("copy to host")
        torch.cuda.synchronize()
        same = np.array_equal(host, want)
        del host
        if not same:
            raise AssertionError("display trace: the traced image differs "
                                 "from Renderer.display's")
        for (_, e0, h0), (name, e1, h1) in zip(marks, marks[1:]):
            spans.setdefault(name, []).append(
                (e0.elapsed_time(e1), (h1 - h0) * 1e3))
        spans.setdefault("whole", []).append(
            (marks[0][1].elapsed_time(marks[-1][1]),
             (marks[-1][2] - marks[0][2]) * 1e3))
    med = lambda xs: float(np.median(xs))
    print(f"denoised display type 0 at {w}x{h}, traced (device ms / host "
          f"ms enqueueing, median of {reps}; bloom "
          f"{'on' if s.bloomEnabled else 'off'}): " + ", ".join(
              f"{name} {med([d for d, _ in v]):.3f} / "
              f"{med([hh for _, hh in v]):.3f}" for name, v in spans.items())
          + f" [{card}]")
    return {name: med([d for d, _ in v]) for name, v in spans.items()}


def unet_timing(state, dev, card):
    """The vendored U-Net at the state's size on the card with TF32 off:
    its time beside its float-operation bound, its peak memory."""
    from metal_pathtracer_tpu_torch.ops import denoise as D
    from metal_pathtracer_tpu_torch.ops import denoise_unet as U

    h, w = state.height, state.width
    net = D._unet_params(dev)
    var = state.variance_of_mean()
    base = D.learned_denoise(state.present(), state.albedo, state.normal,
                             var, D._learned_params(dev))
    feats = U._pad_edge(U._features(base, state.present(), state.albedo,
                                    state.normal, var), (-h) % 8, (-w) % 8)
    flag = torch.backends.cudnn.allow_tf32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    ms = cuda_ms(lambda: (lambda: net(feats[None])), 5)
    peak = torch.cuda.max_memory_allocated(dev) - held
    if torch.backends.cudnn.allow_tf32 != flag:
        raise AssertionError("the U-Net changed the global TF32 switch")
    flops = unet_flops(h, w)
    bound, by = bound_ms(0.0, flops)
    print(f"U-Net at {w}x{h} (TF32 off, cuDNN): {ms:.3f} ms against a "
          f"bound of {bound:.3f} ms ({flops / 1e9:.2f} GFLOP at "
          f"{F32_FLOPS / 1e12:.0f} TFLOP/s, {100 * bound / ms:.1f} %), "
          f"peak {peak / 2**20:.0f} MiB above the state [{card}]")
    return ms, bound


def http(port, path, method="GET"):
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 method=method)
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.read()


def viewer_cell(dev, card, kernels):
    """The live viewer on the Cornell box at 320x180 through HTTP: passes
    accumulate, ``/frame.png`` decodes at its size, ``denoiseEnabled``
    runs the à-trous kernel in the loop, an orbit runs preview passes at
    half scale and lands at full size with reset CAMERA. Fails on the
    loop's ``last_error`` or when spp never advances."""
    from metal_pathtracer_tpu_torch.renderer.renderer import Renderer
    from metal_pathtracer_tpu_torch.utils.image_io import decode_png
    from metal_pathtracer_tpu_torch.viewer.server import ViewerServer

    w, h = VIEWER_SIZE
    r = Renderer(w, h)
    r.load_scene_from_path("assets/scenes/cornell.scene")
    s = r.settings.copy()
    s.renderWidth, s.renderHeight = w, h
    r.apply_settings(s)
    reset_launches(kernels)
    srv = ViewerServer(r, port=0).start()
    marks = [("start", time.time())]

    def stats():
        st = json.loads(http(srv.port, "/stats"))
        if st["error"]:
            raise AssertionError(f"viewer: a pass failed:\n{st['error']}")
        return st

    def wait(cond, what, timeout=120.0):
        t0 = time.time()
        while time.time() - t0 < timeout:
            st = stats()
            if cond(st):
                return st
            time.sleep(0.02)
        raise AssertionError(f"viewer: {what} never happened: {stats()}")

    try:
        st = wait(lambda st: st["spp"] >= VIEWER_SPP,
                  f"spp >= {VIEWER_SPP}")
        marks.append((f"{VIEWER_SPP} spp", time.time()))
        img = decode_png(http(srv.port, "/frame.png"))
        if img.shape != (h, w, 4) or img[..., :3].max() == 0:
            raise AssertionError(f"viewer: /frame.png {img.shape}")
        atrous_before = kernels["atrous_step"].launches
        out = json.loads(http(srv.port, "/set?denoiseEnabled=1", "POST"))
        if not out["ok"] or out["reset"]:
            raise AssertionError(f"viewer: denoiseEnabled {out}")
        done = stats()["spp"]
        wait(lambda st: st["spp"] > done, "a denoised pass")
        denoised = kernels["atrous_step"].launches - atrous_before
        if denoised <= 0:
            raise AssertionError("viewer: no à-trous launch after "
                                 "denoiseEnabled=1")
        marks.append(("a denoised pass", time.time()))
        out = json.loads(http(srv.port, "/set?orbit=0.1,0", "POST"))
        if not out["motion"]:
            raise AssertionError(f"viewer: orbit {out}")
        wait(lambda st: st["preview"] and st["width"] < w, "a preview pass")
        marks.append(("a preview pass", time.time()))
        st = wait(lambda st: not st["preview"] and st["width"] == w
                  and st["spp"] >= 1 and st["reset"] == "CAMERA",
                  "the landing at full size")
        marks.append(("the landing", time.time()))
        if abs(r.settings.cameraYaw - srv._cam_target[0]) > 1e-6:
            raise AssertionError("viewer: the camera did not land on its "
                                 "target")
    finally:
        srv.stop()
    if srv.last_error:
        raise AssertionError(f"viewer: a pass failed:\n{srv.last_error}")
    launches = {k: fn.launches for k, fn in kernels.items() if fn.launches}
    for k in ("sphere_nearest_brute", "rect_nearest", "shade_s1",
              "shade_s2", "atrous_step"):
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"viewer: {k} was not launched: {launches}")
    MAIN_LAUNCHES["viewer-cornell"] = launches
    print(f"viewer on cornell.scene at {w}x{h}: spp {st['spp']} after the "
          f"landing, {st['sps']} samples/s, {denoised} à-trous launches in "
          f"the denoised passes; launches {launches}; "
          + ", ".join(f"{name} at {t - marks[0][1]:.1f}s"
                      for name, t in marks[1:]) + f" [{card}]")


def interactive_path(dev, card, kernels, out):
    """Phase 10, the interactive path: the ``Renderer`` facade at
    1920x1080 on the mesh-files cell's scene (K1, the texture stage, K2
    s1/s2), its denoised displays (the à-trous kernel, the U-Net); the
    à-trous kernel against its plain version on that state; the U-Net's
    time beside its bound; the display against the plain filters' within
    one LDR step; the viewer over HTTP."""
    import os
    import tempfile

    from metal_pathtracer_tpu_torch.renderer.renderer import Renderer
    from metal_pathtracer_tpu_torch.utils import meshfiles

    W, H = FRAME
    marks = [("start", time.time())]
    with tempfile.TemporaryDirectory() as tmp:
        meshfiles.write_headline_files(tmp, HEADLINE_SUBDIVISIONS, dev)
        marks.append(("files written", time.time()))
        # ---- the main path: the facade, then its denoised displays ------
        reset_launches(kernels)
        r = Renderer(W, H)
        r.load_scene_from_path(os.path.join(tmp, "mesh_files.scene"))
        frame_s = []
        for _ in range(FACADE_FRAMES):
            t0 = time.time()
            r.draw_frame(1)
            torch.cuda.synchronize()
            frame_s.append(time.time() - t0)
        marks.append(("facade frames", time.time()))
        r.settings.denoiseEnabled = True
        shown = {}
        for ftype in (0, 1):
            r.settings.denoiseFilterType = ftype
            shown[ftype] = r.display()
        launches = {k: fn.launches for k, fn in kernels.items()
                    if not k.startswith("trace_instanced")}
    for k, v in launches.items():
        if v <= 0 and k in ("trace_closest", "trace_any", "shade_s1",
                            "shade_s2", "texture_stage", "atrous_step"):
            raise AssertionError(f"facade: {k} was not launched: {launches}")
    if (launches["atrous_step"], launches["atrous_pack"]) != (4 + 5, 2):
        raise AssertionError(f"facade: {launches['atrous_step']} à-trous "
                             f"iterations and {launches['atrous_pack']} "
                             "packs in the two denoised displays, not 9 "
                             "and 2")
    MAIN_LAUNCHES["facade"] = {k: v for k, v in launches.items() if v}
    if r.sample_count() != FACADE_FRAMES or r.render_size != (W, H):
        raise AssertionError(f"facade: {r.sample_count()} spp at "
                             f"{r.render_size}")
    img = r.capture_average_image()
    if not (np.isfinite(img).all() and img.max() > 0):
        raise AssertionError("facade: the image is not finite and non-zero")
    for ftype, ldr in shown.items():
        if ldr.shape != (H, W, 3) or not np.isfinite(ldr).all():
            raise AssertionError(f"facade: display {ftype} {ldr.shape}")
    print(f"facade {W}x{H} d8 (mesh-files scene): {FACADE_FRAMES} "
          f"draw_frame(1), the first {frame_s[0]:.2f}s with the scene's "
          f"build (SAH, atlas, sky), then "
          + ", ".join(f"{1e3 * s:.1f}" for s in frame_s[1:])
          + f" ms; two denoised displays; launches "
          f"{MAIN_LAUNCHES['facade']} [{card}]")

    # ---- the à-trous kernel against its plain version ----------------------
    worst, learned4, pack = atrous_checks(r.state, dev, card)
    marks.append(("à-trous checks", time.time()))
    unet_ms, unet_bound = unet_timing(r.state, dev, card)
    marks.append(("U-Net", time.time()))

    # ---- the display through the kernel against the plain filters --------
    from metal_pathtracer_tpu_torch.renderer import display as disp

    display_ms = {}
    for ftype in (0, 1):
        r.settings.denoiseFilterType = ftype
        got = disp.display_to_u8(r.state, r.settings)
        with plain_atrous():
            ref = disp.display_to_u8(r.state, r.settings)
        diff = np.abs(got.astype(int) - ref.astype(int))
        if diff.max() > 1:
            raise AssertionError(f"display type {ftype}: LDR bytes differ "
                                 f"by {diff.max()} from the plain filters'")
        display_ms[f"denoised type {ftype}"] = cuda_ms(
            lambda: r.display, 3)
        print(f"display with denoise type {ftype} at {W}x{H}: LDR bytes "
              f"equal to the plain filters' on {(diff == 0).mean():.6f} of "
              f"the values, at most {diff.max()} apart [{card}]")
    r.settings.denoiseEnabled = False
    display_ms["plain"] = cuda_ms(lambda: r.display, 3)
    print(f"display ms at {W}x{H} (to host, uint8 rounding excluded): "
          + ", ".join(f"{k} {v:.2f}" for k, v in display_ms.items())
          + f" [{card}]")
    marks.append(("displays", time.time()))
    display_trace(r, card)
    r.settings.denoiseEnabled = False
    marks.append(("display trace", time.time()))

    # ---- the viewer ---------------------------------------------------------
    viewer_cell(dev, card, kernels)
    marks.append(("viewer", time.time()))
    ms, plain_ms, bound, by = learned4
    out["atrous_step"] = dict(
        source=ROOT + "denoise.cu",
        # an XLA loop in the JAX package, not a TPU kernel
        replaces="metal_pathtracer_tpu/ops/denoise.py:48",
        launches=launches["atrous_step"], max_abs_err=worst, ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by)
    out["atrous_pack"] = dict(
        source=ROOT + "denoise.cu",
        replaces="metal_pathtracer_tpu/ops/denoise.py:48",
        launches=launches["atrous_pack"], max_abs_err=0.0, **pack)
    print(f"U-Net {unet_ms:.3f} ms (bound {unet_bound:.3f}) [{card}]")
    print("# interactive phase: " + ", ".join(
        f"{name} {t - marks[k][1]:.1f}s"
        for k, (name, t) in enumerate(marks[1:])))


# ---- phase 11: multi-GPU rendering and texture formats ---------------------

#: samples of the sharded headline; the sharded Cornell box (width,
#: height, samples: 510 rows pad to 512 over 4 ranks); the JPEG-textured
#: GLB's samples
DIST_SPP = 1
DIST_CORNELL = (512, 510, 2)
DIST_RANKS = {"headline": 2, "cornell": 4}
JPEG_GLB_SPP = 1
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(REPO_DIR, "tests", "images")
#: the fixtures whose decode times are printed, three each
BIG_FIXTURES = ("tex_2048_420.jpg", "tex_2048_rgba16_adam7.png")
#: the variant render's ground (arithmetic progressive 4:4:0) and sky
VARIANT_GROUND = "arith_prog_440_256.jpg"
VARIANT_SKY = "sky_rgb8_48x24.png"
#: the kernels of the sharded headline's and the sharded Cornell box's
#: paths, each launched by every rank
HEADLINE_KERNELS = ("trace_closest", "trace_any", "shade_s1", "shade_s2",
                    "texture_stage")
CORNELL_KERNELS = ("sphere_nearest_brute", "rect_nearest", "shade_s1",
                   "shade_s2")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(world, scene, w, h, spp, out):
    """``world`` ``parallel.dryrun`` processes over gloo, all on cuda:0,
    rank 0 writing the gathered frame to ``out``."""
    init = f"tcp://127.0.0.1:{free_port()}"
    return [subprocess.Popen(
        [sys.executable, "-m", "metal_pathtracer_tpu_torch.parallel.dryrun",
         "--backend", "gloo", "--init-method", init, "--world-size",
         str(world), "--rank", str(rank), "--device", "cuda:0", "--scene",
         scene, "--width", str(w), "--height", str(h), "--spp", str(spp),
         "--out", out], cwd=REPO_DIR, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(world)]


def finish_ranks(procs, label, timeout=600):
    """Each rank's report line (``rank=K ...``), once every rank printed
    ``DIST_DRYRUN_OK``; no rank outlives the call."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"DIST_DRYRUN_OK rank={rank}" not in text:
            raise AssertionError(f"{label}: rank {rank} failed "
                                 f"({p.returncode}):\n{text[-4000:]}")
    return [line for text in outs for line in text.splitlines()
            if line.startswith("rank=")]


def rank_launches(line: str) -> dict:
    return json.loads(line.split("launches=", 1)[1])


def compare_frame(got, want, totals, label):
    """A gathered frame (``.npz`` or ``RenderState`` on the host) against
    the single render, image fields byte for byte; traces against
    ``totals``."""
    from metal_pathtracer_tpu_torch.parallel.mesh import IMAGE_FIELDS

    def field(x, f):
        v = x[f] if isinstance(x, dict) or hasattr(x, "files") \
            else getattr(x, f)
        return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)

    for f in IMAGE_FIELDS:
        a, b = field(got, f), field(want, f)
        if a.shape != b.shape or a.dtype != b.dtype \
                or a.tobytes() != b.tobytes():
            raise AssertionError(f"{label}: {f} differs from the single "
                                 "render")
    traces = tuple(int(field(got, f)) for f in ("ray_count",
                                                "shadow_ray_count"))
    if traces != (totals.ray_count, totals.shadow_ray_count):
        raise AssertionError(f"{label}: traces {traces} != "
                             f"{(totals.ray_count, totals.shadow_ray_count)}")
    return traces


def texture_formats(card):
    """Decode every committed fixture here (no Pillow on this host): RGBA
    SHA-256 against Pillow's recorded digest; the 2048x2048 images'
    decode times, three each."""
    import hashlib

    from metal_pathtracer_tpu_torch.utils import nativebuild
    from metal_pathtracer_tpu_torch.utils.image_io import decode_image

    t0 = time.perf_counter()
    nativebuild.build_host_library()
    build_s = time.perf_counter() - t0
    with open(os.path.join(FIXTURES, "pillow_rgba.json")) as fh:
        record = json.load(fh)
    times = {}
    for name, want in sorted(record.items()):
        with open(os.path.join(FIXTURES, name), "rb") as fh:
            data = fh.read()
        runs = []
        for _ in range(3 if name in BIG_FIXTURES else 1):
            t0 = time.perf_counter()
            rgba = decode_image(data)
            runs.append(time.perf_counter() - t0)
        digest = hashlib.sha256(np.ascontiguousarray(rgba).tobytes())
        if digest.hexdigest() != want["sha256"] \
                or list(rgba.shape) != want["shape"]:
            raise AssertionError(f"texture formats: {name} decodes to "
                                 "other bytes than Pillow's")
        times[name] = runs
    print(f"texture formats: {len(record)} fixtures decoded on this host, "
          f"each RGBA digest Pillow's; the host C library built in "
          f"{build_s:.2f}s; decode seconds "
          + ", ".join(f"{n} {', '.join(f'{t:.3f}' for t in times[n])}"
                      for n in BIG_FIXTURES) + f" [{card}]")
    print("texture formats, decode ms of the others (CMYK/YCCK, sampling "
          "ratios, lossless, arithmetic, block-smoothed): "
          + ", ".join(f"{n} {1e3 * times[n][0]:.2f}" for n in sorted(times)
                      if n not in BIG_FIXTURES) + f" [{card}]")


def ldr_skies(card):
    """Each PNG and JPEG sky fixture through ``load_hdr_image`` here,
    without imageio: the array's SHA-256 against the JAX package's
    recorded in ``imageio_env.json``."""
    import hashlib

    from metal_pathtracer_tpu_torch.ops.env import load_hdr_image

    with open(os.path.join(FIXTURES, "imageio_env.json")) as fh:
        record = json.load(fh)
    ms = {}
    for name, want in sorted(record.items()):
        t0 = time.perf_counter()
        img = load_hdr_image(os.path.join(FIXTURES, name))
        ms[name] = 1e3 * (time.perf_counter() - t0)
        got = {"sha256": hashlib.sha256(img.tobytes()).hexdigest(),
               "shape": list(img.shape), "dtype": str(img.dtype)}
        if got != want:
            raise AssertionError(f"ldr skies: {name} loads to {got}, not the "
                                 f"JAX package's {want}")
    if "imageio" in sys.modules:
        raise AssertionError("ldr skies: imageio was imported")
    found = {m: importlib.util.find_spec(m) is not None
             for m in ("imageio", "PIL")}
    print(f"ldr skies: {len(record)} PNG/JPEG skies loaded without imageio "
          f"(importable here: {found}; numpy {np.__version__}), each array "
          "the JAX package's bit for bit; ms "
          + ", ".join(f"{n} {t:.2f}" for n, t in ms.items()) + f" [{card}]")


def jpeg_glb(dev, card, kernels, tmp):
    """The mesh-files scene with its ground's base colour the 2048x2048
    JPEG fixture, through the CLI, against its twin with the texture
    re-encoded as an 8-bit PNG of the decoded pixels: every EXR channel
    bit for bit."""
    from metal_pathtracer_tpu_torch.utils import image_io, meshfiles

    _, meshes = meshfiles.write_headline_files(tmp, HEADLINE_SUBDIVISIONS,
                                               dev)
    with open(os.path.join(FIXTURES, "tex_2048_420.jpg"), "rb") as fh:
        jpg = fh.read()
    twin = image_io.encode_png_u8(image_io.decode_image(jpg)[..., :3])
    W, H = FRAME
    channels = []
    for stem, image in (("ground_jpeg", jpg), ("ground_png", twin)):
        path = meshfiles.write_ground_texture_files(tmp, meshes, image, stem)
        output = os.path.join(tmp, f"{stem}.exr")
        _, launches, wall, said = cli_run(
            ["--scene", path, "--width", str(W), "--height", str(H),
             "--sppTotal", str(JPEG_GLB_SPP), "--backend", "metal",
             "--output", output], kernels,
            f"jpeg-glb {stem} {W}x{H} d8 --backend metal", card)
        for k in HEADLINE_KERNELS:
            if launches[k] <= 0:
                raise AssertionError(f"jpeg-glb: {k} was not launched")
        if stem == "ground_jpeg":
            MAIN_LAUNCHES["jpeg-glb"] = launches
        channels.append(image_io.read_exr(output))
    jpeg_ch, png_ch = channels
    if sorted(jpeg_ch) != sorted(png_ch) or any(
            jpeg_ch[k].tobytes() != png_ch[k].tobytes() for k in jpeg_ch):
        raise AssertionError("jpeg-glb: the JPEG-textured render differs "
                             "from its PNG twin")
    print(f"jpeg-glb {W}x{H} d8 {JPEG_GLB_SPP} spp: every EXR channel "
          f"({len(jpeg_ch)}) bit-equal to the PNG twin's [{card}]")
    variant_glb(card, kernels, tmp, meshes)


def variant_glb(card, kernels, tmp, meshes):
    """The mesh-files scene with its ground's base colour the arithmetic
    progressive 4:4:0 fixture under the 8-bit PNG sky, through the CLI,
    against its twin: the ground a PNG of the decoded pixels, the sky a PFM
    of ``load_hdr_image``'s own array; every EXR channel bit for bit."""
    import shutil

    from metal_pathtracer_tpu_torch.ops.env import load_hdr_image
    from metal_pathtracer_tpu_torch.utils import image_io, meshfiles

    with open(os.path.join(FIXTURES, VARIANT_GROUND), "rb") as fh:
        ground = fh.read()
    shutil.copy(os.path.join(FIXTURES, VARIANT_SKY),
                os.path.join(tmp, "sky_ldr.png"))
    image_io.write_pfm(os.path.join(tmp, "sky_ldr.pfm"),
                       load_hdr_image(os.path.join(tmp, "sky_ldr.png")))
    twin = image_io.encode_png_u8(image_io.decode_image(ground)[..., :3])
    W, H = FRAME
    channels = []
    for stem, image, sky in (("ground_variant", ground, "sky_ldr.png"),
                             ("ground_variant_png", twin, "sky_ldr.pfm")):
        path = meshfiles.write_ground_texture_files(tmp, meshes, image, stem,
                                                    sky)
        output = os.path.join(tmp, f"{stem}.exr")
        _, launches, _, _ = cli_run(
            ["--scene", path, "--width", str(W), "--height", str(H),
             "--sppTotal", str(JPEG_GLB_SPP), "--backend", "metal",
             "--output", output], kernels,
            f"variant-glb {stem} (sky {sky}) {W}x{H} d8 --backend metal",
            card)
        for k in HEADLINE_KERNELS:
            if launches[k] <= 0:
                raise AssertionError(f"variant-glb: {k} was not launched")
        if stem == "ground_variant":
            MAIN_LAUNCHES["variant-glb"] = launches
        channels.append(image_io.read_exr(output))
    var_ch, twin_ch = channels
    if sorted(var_ch) != sorted(twin_ch) or any(
            var_ch[k].tobytes() != twin_ch[k].tobytes() for k in var_ch):
        raise AssertionError("variant-glb: the variant-textured render "
                             "under the PNG sky differs from its PNG/PFM "
                             "twin")
    print(f"variant-glb {W}x{H} d8 {JPEG_GLB_SPP} spp ({VARIANT_GROUND} "
          f"ground, {VARIANT_SKY} sky): every EXR channel ({len(var_ch)}) "
          f"bit-equal to the PNG/PFM twin's [{card}]")


def multi_gpu_path(dev, card, kernels, out):
    """Phase 11: the headline sharded over NCCL (world 1, this process)
    and over two gloo ranks on this card; the Cornell box over four gloo
    ranks with pad rows; the texture fixtures (every JPEG variant among
    them) and the PNG/JPEG skies; the JPEG-textured GLB and the
    variant-textured GLB under a PNG sky."""
    import tempfile

    import torch.distributed as dist

    from metal_pathtracer_tpu_torch.parallel import dryrun
    from metal_pathtracer_tpu_torch.parallel import mesh as mesh_ops
    from metal_pathtracer_tpu_torch.renderer import frame
    from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState

    W, H = FRAME
    cw, chh, cspp = DIST_CORNELL
    cornell = os.path.join(REPO_DIR, "assets", "scenes", "cornell.scene")
    marks = [("start", time.time())]
    with tempfile.TemporaryDirectory() as tmp:
        head_npz = os.path.join(tmp, "headline.npz")
        corn_npz = os.path.join(tmp, "cornell.npz")
        # the headline's ranks build their scenes while this process
        # renders; the Cornell box's while it decodes the fixtures
        ranks = start_ranks(DIST_RANKS["headline"], "headline", W, H,
                            DIST_SPP, head_npz)
        try:
            scene, uni, static = dryrun.build_scene("headline", W, H, dev)
            single = frame.render_samples(scene, uni,
                                          RenderState.create(W, H, dev),
                                          static, DIST_SPP)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame.render_samples(scene, uni, RenderState.create(W, H, dev),
                                 static, DIST_SPP)
            torch.cuda.synchronize()
            single_ms = 1e3 * (time.perf_counter() - t0)
            marks.append(("headline built and rendered", time.time()))
            dist.init_process_group(
                "nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                world_size=1, rank=0, device_id=dev)
            try:
                mesh = mesh_ops.make_mesh(device=dev)
                res = dryrun.check_case(mesh, scene, uni, static, DIST_SPP)
            finally:
                dist.destroy_process_group()
            # counted from just before the sharded render to just after
            launches = res["launches"]
            for k in HEADLINE_KERNELS:
                if launches.get(k, 0) <= 0:
                    raise AssertionError(f"sharded-headline: {k} was not "
                                         "launched")
            MAIN_LAUNCHES["sharded-headline"] = launches
            traces = compare_frame(res["state"], single, single,
                                   "sharded-headline NCCL world 1")
            print(f"sharded-headline {W}x{H} d8 {DIST_SPP} spp, NCCL world "
                  f"1: bit-equal to the single render in the five image "
                  f"fields, traces {traces} equal; slab "
                  f"{res['slab_ms']:.2f} ms, single {single_ms:.2f} ms; "
                  f"launches {launches} [{card}]")
            marks.append(("NCCL world 1", time.time()))
        finally:
            lines = finish_ranks(ranks, "sharded-headline")
        marks.append(("headline ranks", time.time()))
        traces = compare_frame(np.load(head_npz), single, single,
                               "sharded-headline 2 gloo ranks")
        for line in lines:
            got = rank_launches(line)
            if not all(got.get(k, 0) > 0 for k in HEADLINE_KERNELS):
                raise AssertionError(f"sharded-headline: a kernel of the "
                                     f"path was not launched: {line}")
        print(f"sharded-headline {W}x{H} d8 {DIST_SPP} spp, 2 gloo ranks on "
              f"cuda:0 ({H // 2} rows each): the gathered frame bit-equal "
              f"to this process's single render ({single_ms:.2f} ms), "
              f"traces {traces} equal; the ranks (sharing the card): "
              + " | ".join(lines) + f" [{card}]")
        del scene, single

        ranks = start_ranks(DIST_RANKS["cornell"], cornell, cw, chh, cspp,
                            corn_npz)
        try:
            texture_formats(card)
            ldr_skies(card)
            marks.append(("texture formats and skies", time.time()))
        finally:
            lines = finish_ranks(ranks, "sharded-cornell")
        marks.append(("cornell ranks", time.time()))

        cscene, cuni, cstatic = dryrun.build_scene(cornell, cw, chh, dev)
        csingle = frame.render_samples(cscene, cuni,
                                       RenderState.create(cw, chh, dev),
                                       cstatic, cspp)
        padded = mesh_ops.padded_height(chh, DIST_RANKS["cornell"])
        ctotals = frame.render_samples(cscene, cuni,
                                       RenderState.create(cw, padded, dev),
                                       cstatic, cspp)
        traces = compare_frame(np.load(corn_npz), csingle, ctotals,
                               "sharded-cornell 4 gloo ranks")
        for line in lines:
            got = rank_launches(line)
            if not all(got.get(k, 0) > 0 for k in CORNELL_KERNELS):
                raise AssertionError(f"sharded-cornell: a kernel of the "
                                     f"path was not launched: {line}")
        print(f"sharded-cornell {cw}x{chh} d8 {cspp} spp, 4 gloo ranks on "
              f"cuda:0, padded to {padded} rows: bit-equal to the single "
              f"render, traces {traces} those of one render over {padded} "
              f"rows (the single render's "
              f"{(csingle.ray_count, csingle.shadow_ray_count)}); the "
              "ranks: " + " | ".join(lines) + f" [{card}]")
        marks.append(("cornell checked", time.time()))
        jpeg_glb(dev, card, kernels, tmp)
        marks.append(("jpeg-glb and variant-glb", time.time()))
    print("# multi-GPU phase: " + ", ".join(
        f"{name} {t - marks[k][1]:.1f}s"
        for k, (name, t) in enumerate(marks[1:])))


# ---- phase 12: the denoisers' training path ---------------------------------

#: the state the backward kernels are held against autograd through the
#: plain version on (square), and the iteration counts the trainers run
GRAD_STATE = 256
GRAD_ITERS = (4, 5)
#: the backward kernels' gradients against autograd through the plain
#: version, and each trainer step's against the plain version's: relative
#: norm error (float32 sums in other orders; the learned filter's feature
#: 0 divides by gstd + 1e-4, which reaches 1e-4 where a region has no
#: variance)
GRAD_REL_TOL = 1e-4
#: each backward kernel's outputs against its plain twin's on the same
#: inputs: relative norm error of each output
GRAD_KERNEL_TOL = 1e-4
#: the sizes one iteration's backward is timed at (width, height): the tap
#: trainer's renders, the U-Net trainer's, the check state, 1080p
GRAD_SIZES = ((64, 64), (96, 96), (256, 256), (1920, 1080))
#: the trainers in this phase: steps, scenes (``train_denoiser.SCENES``
#: indices: the lit box and the bench-class scene under its HDR sky),
#: render size and samples (input, reference; the trainers' own are 16
#: and 512 at 64x64 and 96x96)
TRAIN_STEPS = 10
TRAIN_SCENES = (0, 5)
TRAIN_SIZE = 64
TRAIN_SPP = (4, 16)
#: CPU processes that compute the tap trainer's plain gradients (one
#: thread each; the plain version's ~170,000 small operations a step are
#: dispatch-bound, ~4 s a step), started after its steps so they overlap
#: the U-Net trainer
TRAIN_CPU_WORKERS = 5
# The backward's work, csrc/denoise.cu atrous_grad_*: bytes a pixel that
# the whole backward must move (the rows in: colour and variance 16 B,
# guide 32; the cotangents in: 16; out: the colour and variance
# cotangents 16) and float operations: a tap's forward once at the
# hoisted charge (222) and the tap back (293: dL/dw 10, the logit's
# adjoint 7, 16 hidden units of 16 (the gate, the six parameter sums,
# the adjoints of features 0 and 3), the luminance and gstd adjoints 10,
# the gather's 10), and 60 a pixel (the blur and its adjoint, the
# divisions). Each kernel on its own: the taps kernel reads the rows,
# the cotangents and its forward's colour, variance and weight sums (84
# B; the first port's kernel read 64 and retook the sums) and writes 25
# weights and luminance adjoints (200), its pixel terms (24) and a row of
# 129 floats a block, at 222 + 283 a tap and 46 a pixel; the gather reads
# the planes and pixel terms (224)
# and writes 16, at 10 a tap and 20 a pixel; the sum reads the rows and
# writes 129 floats, an add a value
ATROUS_BWD_BYTES, ATROUS_BWD_TAP_OPS, ATROUS_BWD_PIXEL_OPS = 80, 515, 60
GRAD_TAPS_BYTES, GRAD_TAPS_TAP_OPS, GRAD_TAPS_PIXEL_OPS = 308, 505, 46
GRAD_GATHER_BYTES, GRAD_GATHER_TAP_OPS, GRAD_GATHER_PIXEL_OPS = 240, 10, 20
MLP_BYTES = 129 * 4


def grad_bound(which: str, h: int, w: int):
    """The least time of one learned iteration's backward (``all``) or of
    one of its kernels (``taps``, ``gather``, ``sum``) over an h x w
    image: (ms, "bytes" or "operations")."""
    from metal_pathtracer_tpu_torch.ops.kernels import denoise as DK

    n = h * w
    rows = DK.grad_blocks(h, w, 1)
    if which == "all":
        return bound_ms(n * ATROUS_BWD_BYTES + 2 * MLP_BYTES,
                        n * (25 * ATROUS_BWD_TAP_OPS + ATROUS_BWD_PIXEL_OPS))
    if which == "taps":
        return bound_ms(n * GRAD_TAPS_BYTES + rows * MLP_BYTES,
                        n * (25 * GRAD_TAPS_TAP_OPS + GRAD_TAPS_PIXEL_OPS))
    if which == "gather":
        return bound_ms(n * GRAD_GATHER_BYTES,
                        n * (25 * GRAD_GATHER_TAP_OPS + GRAD_GATHER_PIXEL_OPS))
    return bound_ms((rows + 1) * MLP_BYTES, rows * 129)


def grad_state(h: int, w: int, dev, seed: int = 19) -> dict:
    """A learned filter's inputs and a reference, made with numpy from a
    seed: a band of background (solid colour, no variance, zero normal
    and albedo) and a band of unlit pixels (colour 0: luminance ties where
    the variance and the AOVs differ) over gamma-distributed colour."""
    rng = np.random.default_rng(seed)
    c = rng.gamma(1.2, 0.6, (h, w, 3)).astype(np.float32)
    var = rng.uniform(0.0, 0.05, (h, w, 3)).astype(np.float32)
    a = rng.uniform(0.05, 0.95, (h, w, 3)).astype(np.float32)
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    ref = rng.gamma(1.2, 0.6, (h, w, 3)).astype(np.float32)
    band = max(h // 8, 1)
    c[:band] = (0.65, 0.75, 0.95)
    var[:band], a[:band], n[:band] = 0.0, 0.0, 0.0
    ref[:band] = c[:band]
    c[2 * band:4 * band] = 0.0
    ref[2 * band:4 * band] *= 0.05
    return {k: torch.from_numpy(v).to(dev) for k, v in
            dict(noisy=c, albedo=a, normal=n, variance=var, ref=ref).items()}


def rel_norm(got, ref) -> float:
    """|got - ref| / |ref| over every value (float64, on got's device)."""
    got = torch.cat([x.reshape(-1) for x in got]).double()
    ref = torch.cat([x.reshape(-1) for x in ref]).double().to(got.device)
    return float((got - ref).norm() / ref.norm())


def _pack_grads(grads: dict):
    return [grads[k] for k in ("w1", "b1", "w2", "b2")]


def vendored_mlp(dev) -> dict:
    """The vendored tap MLP on ``dev``, each tensor requiring grad."""
    from metal_pathtracer_tpu_torch import convert
    from metal_pathtracer_tpu_torch.ops import denoise as D

    with np.load(D.DATA_DIR + "/denoiser_weights.npz") as z:
        params = convert.denoiser_params({k: z[k] for k in z.files}, dev)
    return {k: v.requires_grad_() for k, v in params.items()}


def learned_grads(params, d, iters, plain=False):
    """(loss, gradients of the MLP's four tensors, the input colour and
    the input variance) of the learned filter's relative MSE at ``iters``
    iterations: through the backward kernels, or (``plain``) autograd
    through the plain version on the same device."""
    from metal_pathtracer_tpu_torch.tools import train_denoiser as td

    d = dict(d, noisy=d["noisy"].detach().clone().requires_grad_(),
             variance=d["variance"].detach().clone().requires_grad_())
    with plain_atrous() if plain else contextlib.nullcontext():
        loss = td.scene_error(params, d, (iters,))
        grads = torch.autograd.grad(
            loss, _pack_grads(params) + [d["noisy"], d["variance"]])
    return loss, grads


def grad_kernel_checks(kept):
    """Each kept backward's three kernels against their plain twins on
    the same inputs, two launches of each bit-equal, and its forward with
    the weight sums (the saved colour and variance) bit-equal to the
    forward without: (max abs error, max relative norm error of an
    output, the smallest share of tap weights bit-equal to the twin's)."""
    from metal_pathtracer_tpu_torch.ops import denoise as D
    from metal_pathtracer_tpu_torch.ops.kernels import denoise as DK

    worst_abs = worst_rel = 0.0
    share = 1.0
    for it, (a, k) in enumerate(kept):
        cv, guide, p, mlp, g_out, u_out = a
        # the Function's outputs, as its backward unpacks them
        saved = tuple(x.detach() for x in k["saved"])
        mlp = mlp.detach()
        g_out, u_out = DK._cotangents(g_out, u_out, *cv.shape[:2],
                                      cv.device)
        free = DK.atrous_step_packed(cv, guide, p, mlp, last=True)
        if not (torch.equal(free[0], saved[0])
                and torch.equal(free[1], saved[1])):
            raise AssertionError(f"the forward with its weight sums "
                                 f"differs from the forward without "
                                 f"(iteration {it})")
        got = DK.grad_taps(cv, guide, p, mlp, g_out, u_out, saved)
        again = DK.grad_taps(cv, guide, p, mlp, g_out, u_out, saved)
        want = D.grad_taps_reference(cv, guide, p, mlp, g_out, u_out, saved)
        share = min(share, float((got[0] == want[0]).float().mean()))
        pairs = list(zip(got[:4], want[:4]))
        sums = (DK.grad_sum(got[4]), D.grad_sum_reference(want[4]))
        pairs.append(sums)
        gather = DK.grad_gather(p, *got[:4])
        pairs += list(zip(gather, D.grad_gather_reference(p, *got[:4])))
        pairs.append((DK.grad_sum(got[4]), D.grad_sum_reference(got[4])))
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"atrous_grad_taps: two launches differ "
                                 f"(iteration {it})")
        if not (all(torch.equal(x, y) for x, y in zip(
                DK.grad_gather(p, *got[:4]), gather))
                and torch.equal(DK.grad_sum(got[4]), sums[0])):
            raise AssertionError(f"the gather or sum kernel: two launches "
                                 f"differ (iteration {it})")
        for x, y in pairs:
            worst_abs = max(worst_abs, float((x - y).abs().max()))
            worst_rel = max(worst_rel, rel_norm([x], [y]))
        if not worst_rel <= GRAD_KERNEL_TOL:
            raise AssertionError(f"a backward kernel at iteration {it} is "
                                 f"{worst_rel} from its plain twin")
        del got, again, pairs, gather
    return worst_abs, worst_rel, share


def grad_resources(card) -> None:
    """Print the taps kernel's registers and spills (``-Xptxas -v``), its
    blocks and resident warps an SM (the occupancy API), its grid and its
    two tap loops' instruction counts (``atrous_sass``)."""
    from metal_pathtracer_tpu_torch.ops.kernels import build
    from metal_pathtracer_tpu_torch.ops.kernels import denoise as DK

    regs, st, ld = kernel_resources(build.build_log())[
        "atrous_grad_taps_kernel"]
    per_sm = build.load().mpt_atrous_grad_blocks_per_sm()
    print(f"atrous_grad_taps_kernel: {regs} registers, spill stores / loads "
          f"{st} / {ld} B (-Xptxas -v); {per_sm} blocks of "
          f"{DK.GRAD_THREADS} threads an SM, "
          f"{per_sm * DK.GRAD_THREADS // 32} resident warps (occupancy API); "
          f"blocks at 64x64 "
          f"{DK.grad_blocks(64, 64, 1)}, at 96x96 {DK.grad_blocks(96, 96, 1)},"
          f" at 1920x1080 {DK.grad_blocks(1080, 1920, 1)} (one wave); "
          f"{atrous_resources()} [{card}]")
    print(f"backward tap loops (cuobjdump -sass), warp 0's and warp 1's: "
          f"{atrous_sass('atrous_grad_taps', 2)}")
    if st or ld:
        raise AssertionError("atrous_grad_taps_kernel spills")


def grad_timing(dev, card):
    """At each of ``GRAD_SIZES``: the first and last iterations of a
    4-iteration filter's backward held to their plain twins
    (``grad_kernel_checks``); one learned
    iteration's forward (the Function's: pack + the step with its weight
    sums) and backward (the three kernels; each also alone), averaged over
    the 4 iterations, beside the bounds, the taps kernel's issue ceiling
    and the plain twins' time (the first iteration's, once). Returns
    ({size: dict}, the checks' worst (abs, rel, bit-equal share))."""
    from metal_pathtracer_tpu_torch.ops import denoise as D
    from metal_pathtracer_tpu_torch.ops.kernels import denoise as DK

    mhz = sm_clock_mhz()
    rows = {}
    worst = (0.0, 0.0, 1.0)
    for w, h in GRAD_SIZES:
        params = vendored_mlp(dev)
        d = grad_state(h, w, dev)
        kept = []
        with kept_calls("atrous_step_grad", kept):
            learned_grads(params, d, 4)
        # the first and last iterations (steps 1 and 8; the 256x256
        # checks hold every iteration)
        checks = grad_kernel_checks(kept[::3])
        worst = (max(worst[0], checks[0]), max(worst[1], checks[1]),
                 min(worst[2], checks[2]))
        fwd = bwd = taps = gather = total = 0.0
        a, k = kept[0]
        g_out, u_out = DK._cotangents(a[4], a[5], h, w, dev)
        saved = tuple(x.detach() for x in k["saved"])
        plain = cuda_ms(lambda: (lambda: D.atrous_step_grad_reference(
            *a[:3], a[3].detach(), g_out, u_out, saved)), 1)
        for a, k in kept:
            cv, guide, p, mlp, g_out, u_out = a
            saved = tuple(x.detach() for x in k["saved"])
            mlp = mlp.detach()
            g_out, u_out = DK._cotangents(g_out, u_out, h, w, dev)
            col, v, alb, nrm = D.unpack(cv, guide)
            fwd += kernel_ms(lambda: (lambda: DK.atrous_step_packed(
                *DK.pack(col, v, alb, nrm), p, mlp, last=True, wsum=True)),
                10)
            bwd += kernel_ms(lambda: (lambda: DK.atrous_step_grad(
                cv, guide, p, mlp, g_out, u_out, saved)), 10)
            got = DK.grad_taps(cv, guide, p, mlp, g_out, u_out, saved)
            taps += kernel_ms(lambda: (lambda: DK.grad_taps(
                cv, guide, p, mlp, g_out, u_out, saved)), 10)
            gather += kernel_ms(lambda: (lambda: DK.grad_gather(
                p, *got[:4])), 10)
            total += kernel_ms(lambda: (lambda: DK.grad_sum(got[4])), 10)
            del got
        n = len(kept)
        row = dict(forward=fwd / n, backward=bwd / n, taps=taps / n,
                   gather=gather / n, sum=total / n, plain=plain,
                   bound=grad_bound("all", h, w),
                   bounds={x: grad_bound(x, h, w)
                           for x in ("taps", "gather", "sum")},
                   ceiling=lane_rate_ms(h * w * (
                       25 * GRAD_TAPS_TAP_OPS + GRAD_TAPS_PIXEL_OPS), mhz),
                   forward_bound=denoise_bound("learned", h, w))
        rows[(w, h)] = row
        print(f"learned iteration at {w}x{h}, mean of {n}: forward (pack + "
              f"step with weight sums) {row['forward']:.4f} ms (bound "
              f"{row['forward_bound'][0]:.4f}), backward "
              f"{row['backward']:.4f} ms (bound {row['bound'][0]:.4f} by "
              f"{row['bound'][1]}, {100 * row['bound'][0] / row['backward']:.1f}"
              f" %): taps {row['taps']:.4f} (bound "
              f"{row['bounds']['taps'][0]:.4f}, "
              f"{100 * row['bounds']['taps'][0] / row['taps']:.1f} %; issue "
              f"ceiling {row['ceiling']:.4f} at {mhz:.0f} MHz, "
              f"{100 * row['ceiling'] / row['taps']:.1f} %), gather "
              f"{row['gather']:.4f} ({row['bounds']['gather'][0]:.4f}), sum "
              f"{row['sum']:.4f} ({row['bounds']['sum'][0]:.4f}); plain twins "
              f"{row['plain']:.2f} ms (first iteration); each kernel against "
              f"its twin at steps 1 and 8: max abs {checks[0]:.3e}, max rel "
              f"{checks[1]:.3e}, tap weights bit-equal {checks[2]:.4f}, two "
              f"launches bit-equal, forward with weight sums bit-equal to "
              f"without [{card}]")
        del params, d, kept
        torch.cuda.empty_cache()
    return rows, worst


def plain_tap_grads(path: str, steps, out_path: str) -> None:
    """A worker process's work: the tap trainer's loss gradients through
    the plain version on the CPU (one thread) at each of ``steps``'
    parameters, from the data and parameters in ``path``; written to
    ``out_path``."""
    from metal_pathtracer_tpu_torch.tools import train_denoiser as td

    torch.set_num_threads(1)
    with np.load(path) as z:
        got = {k: z[k] for k in z.files}
    data = [{k: torch.from_numpy(got[f"{k}{i}"]) for k in (
        "noisy", "albedo", "normal", "variance", "ref")}
        for i in range(len(TRAIN_SCENES))]
    res = {}
    for s in steps:
        params = {k: torch.from_numpy(got[f"p{s}_{k}"]).requires_grad_()
                  for k in ("w1", "b1", "w2", "b2")}
        grads = torch.autograd.grad(td.loss_fn(params, data),
                                    _pack_grads(params))
        for k, g in zip(("w1", "b1", "w2", "b2"), grads):
            res[f"g{s}_{k}"] = g.numpy()
    np.savez(out_path, **res)


def plain_tap_workers(kept: dict, tmp: str):
    """``TRAIN_CPU_WORKERS`` processes running ``plain_tap_grads`` over the
    steps kept in ``kept`` (data and each step's parameters): [(process,
    its output file)]."""
    path = os.path.join(tmp, "tap_steps.npz")
    np.savez(path, **kept)
    procs = []
    for k in range(TRAIN_CPU_WORKERS):
        steps = list(range(k, TRAIN_STEPS, TRAIN_CPU_WORKERS))
        res = os.path.join(tmp, f"plain_{k}.npz")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke as c; "
             f"c.plain_tap_grads({path!r}, {steps!r}, {res!r})"],
            cwd=REPO_DIR, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            res))
    return procs


def finish_plain_tap(procs, timeout: int = 300) -> dict:
    """Wait for ``plain_tap_workers``' processes (killing every one on a
    failure): {step: the plain gradients (w1, b1, w2, b2)}."""
    plain = {}
    try:
        for proc, res in procs:
            text, _ = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                raise AssertionError(f"a plain-gradient worker failed:\n"
                                     f"{text[-3000:]}")
            with np.load(res) as z:
                for name in z.files:
                    s, k = name[1:].split("_")
                    plain.setdefault(int(s), {})[k] = torch.from_numpy(
                        z[name])
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {s: _pack_grads(g) for s, g in plain.items()}


def unet_steps(dev, card, stacked, errs):
    """``TRAIN_STEPS`` steps of the U-Net trainer on ``stacked`` over the
    vendored taps' prepass, each step's gradients held against the same
    step's on the CPU (``errs`` gets the relative norm errors): (seconds
    of the steps without the checks, losses)."""
    from metal_pathtracer_tpu_torch import convert
    from metal_pathtracer_tpu_torch.ops import denoise_unet as U
    from metal_pathtracer_tpu_torch.tools import train_denoiser_unet as tu

    base = tu.prepass(stacked, dev)
    feats = tu.features(base, stacked, dev)
    net = U.DenoiseUNet.from_params(convert.denoiser_params(U.init_params(
        torch.Generator().manual_seed(0)), dev))
    net.requires_grad_(True)
    check_s = [0.0]

    def check(step, batch, grads):
        t0 = time.time()
        cpu = U.DenoiseUNet.from_params(
            {k: v.detach().cpu() for k, v in net.params().items()})
        cpu.requires_grad_(True)
        _, want = tu.gradients(cpu, *(x.cpu() for x in batch))
        err = rel_norm(list(grads.values()), list(want.values()))
        errs.append(err)
        if not err <= GRAD_REL_TOL:
            raise AssertionError(f"U-Net trainer step {step}: gradients "
                                 f"{err} from the CPU's")
        check_s[0] += time.time() - t0

    t0 = time.time()
    losses, _ = tu.train(net, feats, base, stacked["noisy"], stacked["ref"],
                         TRAIN_STEPS, crop=TRAIN_SIZE, device=dev,
                         log=lambda m: None, check=check)
    torch.cuda.synchronize()
    if not np.isfinite(losses).all():
        raise AssertionError(f"U-Net trainer: losses {losses}")
    return time.time() - t0 - check_s[0], losses


def denoiser_training(dev, card, kernels, out):
    """Phase 12, the denoisers' training path: the learned filter's
    backward kernels against autograd through the plain version at 4 and
    5 iterations on a ``GRAD_STATE`` square state (ties included), each
    kernel against its plain twin and bit-equal to itself, the forward
    with grad bit-equal to the forward without; the backward timed at
    ``GRAD_SIZES``; then ``TRAIN_STEPS`` steps of each trainer on two
    scenes rendered on the card (the tap trainer is the main path: counts
    reset just before), every step's gradients held against the plain
    version's on the same data copied to the CPU."""
    import shutil
    import tempfile

    from metal_pathtracer_tpu_torch.ops import denoise as D
    from metal_pathtracer_tpu_torch.tools import train_denoiser as td
    from metal_pathtracer_tpu_torch.tools import train_denoiser_unet as tu

    marks = [("start", time.time())]
    # ---- the backward kernels against autograd through the plain version
    d = grad_state(GRAD_STATE, GRAD_STATE, dev)
    worst_abs = worst_rel = 0.0
    for iters in GRAD_ITERS:
        params = vendored_mlp(dev)
        kept = []
        with kept_calls("atrous_step_grad", kept):
            loss_k, got = learned_grads(params, d, iters)
        loss_p, want = learned_grads(params, d, iters, plain=True)
        with torch.no_grad():
            free = D.learned_denoise(d["noisy"], d["albedo"], d["normal"],
                                     d["variance"], params, iters)
        with_grad = D.learned_denoise(d["noisy"], d["albedo"], d["normal"],
                                      d["variance"], params, iters)
        if not torch.equal(free, with_grad.detach()):
            raise AssertionError(f"learned x{iters}: the forward with grad "
                                 "differs from the forward without")
        errs = (rel_norm(got[:4], want[:4]), rel_norm(got[4:5], want[4:5]),
                rel_norm(got[5:], want[5:]))
        if not max(errs) <= GRAD_REL_TOL or len(kept) != iters:
            raise AssertionError(f"learned x{iters}: the backward kernels "
                                 f"against the plain autograd {errs}, "
                                 f"{len(kept)} backward launches")
        k_abs, k_rel, k_share = grad_kernel_checks(kept)
        worst_abs, worst_rel = max(worst_abs, k_abs), max(worst_rel, k_rel)
        print(f"learned x{iters} at {GRAD_STATE}x{GRAD_STATE}: loss "
              f"{float(loss_k.detach()):.6f} (plain "
              f"{float(loss_p.detach()):.6f}); gradient "
              f"against autograd through the plain version, relative norm "
              f"error: MLP {errs[0]:.2e}, colour {errs[1]:.2e}, variance "
              f"{errs[2]:.2e}; each kernel against its plain twin at every "
              f"iteration: max abs {k_abs:.3e}, max rel {k_rel:.3e}, tap "
              f"weights bit-equal {k_share:.4f}, two launches bit-equal; "
              f"forward with grad bit-equal to without [{card}]")
        del params, kept, got, want
    marks.append(("backward checks", time.time()))
    grad_resources(card)
    timing, t_worst = grad_timing(dev, card)
    worst_abs = max(worst_abs, t_worst[0])
    marks.append(("backward timing", time.time()))

    # ---- the main path: each trainer's first steps ------------------------
    with tempfile.TemporaryDirectory() as tmp:
        specs = [td.SCENES[i] for i in TRAIN_SCENES]
        stacked = td.load_renders(specs, TRAIN_SIZE, TRAIN_SIZE, *TRAIN_SPP,
                                  device=dev, cache_dir=tmp,
                                  log=lambda m: None)
    marks.append(("renders", time.time()))
    data = [{k: torch.from_numpy(v[i]).to(dev) for k, v in stacked.items()}
            for i in range(len(specs))]
    params = {k: v.to(dev).requires_grad_() for k, v in td.init_params(
        torch.Generator().manual_seed(0)).items()}
    kept = {f"{k}{i}": stacked[k][i] for k in ("noisy", "albedo", "normal",
                                                "variance", "ref")
            for i in range(len(specs))}
    tap_grads, unet_errs = {}, []

    def tap_check(step, grads):
        for k, v in params.items():
            kept[f"p{step}_{k}"] = v.detach().cpu().numpy().copy()
        tap_grads[step] = _pack_grads(grads)

    reset_launches(kernels)
    t0 = time.time()
    best, best_loss, losses, _ = td.train(
        params, lambda p: td.loss_fn(p, data), TRAIN_STEPS,
        log=lambda m: None, check=tap_check)
    torch.cuda.synchronize()
    tap_s = time.time() - t0
    launches = {k: kernels[k].launches for k in (
        "atrous_step", "atrous_pack", "atrous_grad_taps",
        "atrous_grad_gather", "atrous_grad_sum")}
    if min(launches.values()) <= 0 or best is None or len(losses) != \
            TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"tap trainer: launches {launches}, losses "
                             f"{losses}")
    MAIN_LAUNCHES["tap trainer"] = launches
    marks.append(("tap trainer", time.time()))
    tmp = tempfile.mkdtemp()
    try:
        workers = plain_tap_workers(kept, tmp)
        unet_s, u_losses = unet_steps(dev, card, stacked, unet_errs)
        marks.append(("U-Net trainer", time.time()))
        plain = finish_plain_tap(workers)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tap_errs = [rel_norm(tap_grads[s], plain[s]) for s in range(TRAIN_STEPS)]
    if not max(tap_errs) <= GRAD_REL_TOL:
        raise AssertionError(f"tap trainer: gradients {tap_errs} from the "
                             "plain version's on the CPU")
    print(f"tap trainer, {TRAIN_STEPS} steps on scenes {TRAIN_SCENES} at "
          f"{TRAIN_SIZE}x{TRAIN_SIZE} ({TRAIN_SPP[0]} / {TRAIN_SPP[1]} spp, "
          f"reduced from 16 / 512): losses "
          + ", ".join(f"{x:.5f}" for x in losses)
          + f"; best {best_loss:.5f}; {1e3 * tap_s / TRAIN_STEPS:.1f} ms a "
          f"step; every step's gradients against the plain version's on "
          f"the same data copied to the CPU, relative norm error "
          + ", ".join(f"{e:.2e}" for e in tap_errs)
          + f"; launches {launches} [{card}]")
    print(f"U-Net trainer, {TRAIN_STEPS} steps, batch {tu.BATCH} of "
          f"{TRAIN_SIZE}x{TRAIN_SIZE} crops of the same renders over the "
          f"vendored taps' prepass: losses "
          + ", ".join(f"{x:.5f}" for x in u_losses)
          + f"; {1e3 * unet_s / TRAIN_STEPS:.1f} ms a step without the "
          f"checks; every step's gradients against the CPU's (the same "
          f"convolutions, float32), relative norm error "
          + ", ".join(f"{e:.2e}" for e in unet_errs) + f" [{card}]")
    marks.append(("plain gradients", time.time()))

    row = timing[(TRAIN_SIZE, TRAIN_SIZE)]
    for name, key in (("atrous_grad_taps", "taps"),
                      ("atrous_grad_gather", "gather"),
                      ("atrous_grad_sum", "sum")):
        bound, by = row["bounds"][key]
        out[name] = dict(
            source=ROOT + "denoise.cu",
            # JAX's autodiff of the learned filter, not a TPU kernel
            replaces="metal_pathtracer_tpu/ops/denoise.py:157",
            launches=launches[name], max_abs_err=worst_abs, ms=row[key],
            plain_ms=row["plain"], bound_ms=bound, bound_by=by)
    print("# training phase: " + ", ".join(
        f"{name} {t - marks[k][1]:.1f}s"
        for k, (name, t) in enumerate(marks[1:]))
        + f"; {marks[-1][1] - marks[0][1]:.1f}s in all")


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    from metal_pathtracer_tpu_torch.ops.kernels import build
    from metal_pathtracer_tpu_torch.ops.kernels import denoise as DK
    from metal_pathtracer_tpu_torch.ops.kernels import camera as CK
    from metal_pathtracer_tpu_torch.ops.kernels import primitives as P
    from metal_pathtracer_tpu_torch.ops.kernels import shade as S
    from metal_pathtracer_tpu_torch.ops.kernels import texture as X
    from metal_pathtracer_tpu_torch.ops.kernels import traverse as T

    t_start = time.time()
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

    t0 = time.time()
    build.load()
    print(f"# kernels built+loaded in {time.time() - t0:.1f}s")
    print(build.build_log())

    kernels = {"trace_closest": T.trace_closest, "trace_any": T.trace_any,
               "shade_full": S.shade_full, "shade_s1": S.shade_s1,
               "shade_s2": S.shade_s2, "texture_stage": X.texture_stage,
               "sphere_nearest_brute": P.sphere_nearest_brute,
               "sphere_nearest_chunked": P.sphere_nearest_chunked,
               "rect_nearest": P.rect_nearest,
               "trace_closest_stats": T.trace_closest_stats,
               "trace_any_stats": T.trace_any_stats,
               "shade_full_lanes": S.shade_full_lanes,
               "shade_full_sparse": S.shade_full_sparse,
               "shade_full_buckets": S.shade_full_buckets,
               "full_buckets": S.full_buckets,
               "trace_instanced_closest": T.trace_instanced_closest,
               "trace_instanced_any": T.trace_instanced_any,
               "primary_rays": CK.primary_rays}
    out = {}
    t0 = time.time()
    camera_path(dev, card, kernels, out)
    print(f"# camera phase took {time.time() - t0:.1f}s")
    t0 = time.time()
    k1_probe_err = lambert_path(dev, card, kernels, out)
    print(f"# lambert path phases took {time.time() - t0:.1f}s")
    for textured in (False, True):
        t0 = time.time()
        headline = nee_path(dev, card, kernels, out, k1_probe_err, textured)
        print(f"# {'textured' if textured else 'untextured'} headline "
              f"phases took {time.time() - t0:.1f}s")
    t0 = time.time()
    primitives_path(dev, card, kernels, out)
    print(f"# analytic-primitives phases took {time.time() - t0:.1f}s")
    t0 = time.time()
    materials_path(dev, card, kernels, out)
    print(f"# material-zoo phases took {time.time() - t0:.1f}s")
    t0 = time.time()
    full_path(dev, card, kernels, out)
    print(f"# K2 full depth phases took {time.time() - t0:.1f}s")
    t0 = time.time()
    headless_path(dev, card, kernels, out, headline)
    print(f"# headless and debug phases took {time.time() - t0:.1f}s")
    t0 = time.time()
    mnee_path(dev, card, kernels, out)
    print(f"# MNEE phases took {time.time() - t0:.1f}s")
    t0 = time.time()
    mesh_files_path(dev, card, kernels, out)
    print(f"# mesh-files phases took {time.time() - t0:.1f}s")
    t0 = time.time()
    instanced_path(dev, card, kernels, out)
    print(f"# instancing phases took {time.time() - t0:.1f}s")
    t0 = time.time()
    interactive_path(dev, card, dict(kernels, atrous_step=DK.atrous_step,
                                     atrous_pack=DK.pack), out)
    print(f"# interactive phases took {time.time() - t0:.1f}s")
    t0 = time.time()
    multi_gpu_path(dev, card, kernels, out)
    print(f"# multi-GPU and texture-format phases took "
          f"{time.time() - t0:.1f}s")
    t0 = time.time()
    denoiser_training(dev, card, dict(
        kernels, atrous_step=DK.atrous_step, atrous_pack=DK.pack,
        atrous_grad_taps=DK.grad_taps, atrous_grad_gather=DK.grad_gather,
        atrous_grad_sum=DK.grad_sum), out)
    print(f"# denoiser-training phase took {time.time() - t0:.1f}s")

    print("K2 device ms at the earlier phases' first depths, this run "
          "(PERF.md run G): " + ", ".join(f"{k} {K2_NOW[k]:.4f} ({v:.4f})"
                                   for k, v in K2_RUN_G.items())
          + f" [{card}]")
    print(f"# chip_smoke.py ran in {time.time() - t_start:.1f}s, the "
          f"kernels' build included")
    names = [k for k in kernels if k != "shade_full_lanes"] + [
        "shade_full_zoo", "shade_full_buckets_zoo", "shade_s1_zoo",
        "shade_s2_zoo", "shade_s2_mnee", "atrous_step", "atrous_pack",
        "atrous_grad_taps", "atrous_grad_gather", "atrous_grad_sum"]
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", library_ms=None, **out[name])
        for name in names]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
