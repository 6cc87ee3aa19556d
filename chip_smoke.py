#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from ``metal_pathtracer_tpu_torch/csrc``
(one nvcc per source, in parallel) and drives the port's eight paths:

1. the lambert series (327,680-triangle displaced icosphere under the
   gradient sky, K1 closest-hit + K2 ``full``): K1 against its plain
   version bit for bit on probes, K2 under the image gate, a 1920x1080 d8
   render through ``CudaBackend``, and both kernels timed at the first
   bounce;
2. the untextured headline (1.31M-triangle displaced icosphere, glass and
   PBR spheres, HDR sun/sky with alias NEE and spec-NEE; K1 closest-hit,
   K1 any-hit, K2 ``s1`` and ``s2``): K1 any-hit bit for bit on probes and
   on the first-depth shadow wavefront, a 160x96 4 spp render of the
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
   NEE together) at 160x96 4 spp through the kernels against the plain
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
   4 spp against the plain path (RMSE 0, equal trace counts); the three
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
   ``debugSpecularOnly`` at 160x96 4 spp through the kernels against the
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
   SAH and atlas) beside its ms/spp.

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
# the analytic-primitive cells: samples of the 160x96 checks and of the
# timed full-size renders, and rtow's layout seed
PRIM_CHECK_SPP = 4
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

    def plain_prims(reference):
        return lambda o, d, t_min, t_max, prims: reference(
            o, d, float(t_min), P._prepare(o, t_max), prims)

    with mock.patch.object(S, "trace_closest", plain_trace), \
            mock.patch.object(T, "trace_closest", plain_trace), \
            mock.patch.object(T, "trace_any", plain_any), \
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
                              X.texture_stage_reference):
        yield


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

    # ---- every kernel of the path: 160x96 4 spp at subdivision 5 vs plain
    settings, res, scene, _ = build(CHECK_SUBDIVISIONS)
    w, h = CHECK_FRAME
    static, uni = scene_setup(settings, res, w, h, dev)
    before = X.texture_stage.launches
    st_k = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                static, 4)
    if textured and X.texture_stage.launches == before:
        raise AssertionError("the textured check render launched no "
                             "texture stage")
    with plain_kernels():
        st_p = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                    static, 4)
    kernels_used = "texture stage + K2 s1/s2 + K1 any-hit" if textured \
        else "K2 s1/s2 + K1 any-hit"
    nee_err = image_gate(
        st_k.present().cpu().numpy(), st_p.present().cpu().numpy(),
        (st_k.ray_count, st_k.shadow_ray_count),
        (st_p.ray_count, st_p.shadow_ray_count),
        f"{name}: {kernels_used} {w}x{h} 4spp kernel vs plain")

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

    # every launch: one closest-hit and up to two any-hit per depth
    live, waves = frame_loop_k1(scene, uni, static, dev, keep=tuple(
        (key, k) for key in ("closest", "any")
        for k in range(2 * static.max_depth)))
    print(f"K1 live lanes per launch over one {static.width}x"
          f"{static.height} sample of the frame loop (closest: one per "
          f"depth; any-hit: the environment and the spec-NEE shadow rays "
          f"per depth): closest {live['closest']}, any-hit {live['any']} "
          f"[{card}]")
    per_launch = {key: [kernel_ms((lambda a, fn: lambda: lambda: fn(*a))(
        waves[key, k], T.trace_closest if key == "closest" else T.trace_any),
        5) for k in range(len(live[key]))] for key in live}
    bounds = {key: [k1_launch_bound(key, waves[key, k])
                    for k in range(len(live[key]))] for key in live}
    print("K1 device ms per launch of that sample, each bit-equal to the "
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
    with texture planes) at 160x96 4 spp through the kernels against the
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

    # ---- 160x96 4 spp: the kernels against the plain path ---------------
    w, h = CHECK_FRAME
    render_err = 0.0
    for name, (settings, res, env) in cells.items():
        scene = res.build_arrays(environment=env, device=dev)
        static, uni = scene_setup(settings, res, w, h, dev)
        before = {k: fn.launches for k, fn in kernels.items()}
        t_k = time.time()
        st_k = frame.render_samples(scene, uni, RenderState.create(w, h, dev),
                                    static, PRIM_CHECK_SPP)
        torch.cuda.synchronize()
        t_p = time.time()
        used = [k for k, fn in kernels.items() if fn.launches > before[k]]
        with plain_kernels():
            st_p = frame.render_samples(scene, uni,
                                        RenderState.create(w, h, dev), static,
                                        PRIM_CHECK_SPP)
        torch.cuda.synchronize()
        render_err = max(render_err, exact_gate(
            st_k, st_p, f"{name} {w}x{h} {PRIM_CHECK_SPP}spp d"
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
    launches = {k: fn.launches for k, fn in kernels.items()}
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

    # ---- debugSpecularOnly: 160x96 4 spp, kernels against plain ----------
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
                                    st_, 4)
        torch.cuda.synchronize()
        t_p = time.time()
        with plain_kernels():
            st_p = frame.render_samples(sc, un_, RenderState.create(w, h, dev),
                                        st_, 4)
        torch.cuda.synchronize()
        spec_err = max(spec_err, exact_gate(
            st_k, st_p, f"debugSpecularOnly {name} {w}x{h} 4spp kernels vs "
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
NEW_CHECK_SPP = 2
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


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    from metal_pathtracer_tpu_torch.ops.kernels import build
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
               "full_buckets": S.full_buckets}
    out = {}
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

    print("K2 device ms at the earlier phases' first depths, this run "
          "(PERF.md run G): " + ", ".join(f"{k} {K2_NOW[k]:.4f} ({v:.4f})"
                                   for k, v in K2_RUN_G.items())
          + f" [{card}]")
    print(f"# chip_smoke.py ran in {time.time() - t_start:.1f}s, the "
          f"kernels' build included")
    names = [k for k in kernels if k != "shade_full_lanes"] + [
        "shade_full_zoo", "shade_full_buckets_zoo", "shade_s1_zoo",
        "shade_s2_zoo", "shade_s2_mnee"]
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", library_ms=None, **out[name])
        for name in names]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
