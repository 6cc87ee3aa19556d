"""Per-pixel path probe (``renderer/debugprobe.py`` twin): one pixel's
sample replayed with a record per bounce, the analogue of the reference's
512-entry ``PathtraceDebugBuffer`` ring (reference:
include/MetalShaderTypes.h:270-287, shaders/pathtrace.metal:258-492).

The probe traces one lane through the same depth loops as a render, so it
runs through the kernels on a CUDA device and through their plain
versions on the CPU. Each depth leaves a ``kernels.shade.ProbeDepth``;
the row takes the hit from the trace, the throughput after absorption and
the BSDF sample from K2's probe plane, and the radiance and medium depth
from the carry after the depth (spec-NEE chains included).

On a miss the reference's row holds what its vectorised integrator
computed for every lane (``integrator.py:676-688``): the record of a
missed ``hit_spheres`` (sphere 0, at t = 1e20 along the ray) when the
scene has spheres, the empty record otherwise, and the BSDF sample drawn
there from the lane's state. K2 samples no miss, so the probe replays
that sample with the plain sampler, on the one lane (the random walk's
override, which the reference also applies there, is not replayed).
"""

from __future__ import annotations

import numpy as np
import torch

from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops import bsdf as bsdf_ops
from metal_pathtracer_tpu_torch.ops import camera as camera_ops
from metal_pathtracer_tpu_torch.ops import integrator
from metal_pathtracer_tpu_torch.ops import rng as rng_ops
from metal_pathtracer_tpu_torch.ops.intersect import HitRecord, analytic_record
from metal_pathtracer_tpu_torch.ops.kernels.shade import rebuild_hit
from metal_pathtracer_tpu_torch.ops.vecmath import dot, normalize, where3

#: per-bounce probe record fields (``integrator.py PROBE_FIELDS:193-196``)
PROBE_FIELDS = ("hit", "t", "prim_type", "prim_index", "mesh_index",
                "material", "throughput_r", "throughput_g", "throughput_b",
                "radiance_r", "radiance_g", "radiance_b", "medium_depth",
                "medium_event", "pdf", "is_delta")


def _miss_record(scene, ray_o, ray_d):
    """The reference's record of a lane that hit nothing."""
    if scene.n_spheres:
        one = torch.ones_like(ray_o[:, 0])
        zero = torch.zeros_like(one, dtype=torch.int32)
        return analytic_record(ray_o, ray_d, one * C.INFINITY_T, zero,
                               zero + C.PRIMITIVE_SPHERE, scene)
    return HitRecord.miss(ray_o.shape[:1], ray_o.device)


def _miss_sample(scene, uniforms, static, rec, d):
    """The BSDF sample the reference draws on a missed lane: (pdf,
    is_delta, medium_event)."""
    m = bsdf_ops.gather_material(scene.materials, rec.material)
    sn = rec.shading_normal
    bad = ~torch.isfinite(sn).all(-1) | (dot(sn, sn) <= 0.0)
    sn = where3(bad | (m.mat_type == C.MATERIAL_DIELECTRIC), rec.normal, sn)
    incident = normalize(d.ray_d)
    _, smp = bsdf_ops.sample_bsdf(
        m, sn, -incident, incident, rec.front_face, d.state,
        bsdf_ops.make_clamp_params(uniforms), torch.ones_like(d.t),
        static.material_types, position=rec.point, sss_mode=static.sss_mode,
        specular_only=static.debug_specular_only)
    return smp.pdf, smp.is_delta.to(torch.float32), \
        smp.medium_event.to(torch.float32)


def _row(scene, uniforms, static, d) -> np.ndarray:
    """The 16 fields of lane 0 at one depth (zeros if it entered dead)."""
    if not bool(d.alive[0]):
        return np.zeros(len(PROBE_FIELDS), np.float32)
    hit = bool(d.idx[0] >= 0)
    if hit:
        rec = rebuild_hit(d.ray_o, d.ray_d, scene.triangles, d.t, d.idx, d.u,
                          d.v, d.kind, scene)
        pdf, delta, event = d.plane[:, 3], d.plane[:, 4], d.plane[:, 5]
    else:
        rec = _miss_record(scene, d.ray_o, d.ray_d)
        pdf, delta, event = _miss_sample(scene, uniforms, static, rec, d)
    f = lambda x: float(x[0])
    return np.asarray(
        [float(hit), f(d.t), f(rec.prim_type), f(rec.prim_index),
         f(rec.mesh_index), f(rec.material), *d.plane[0, 0:3].tolist(),
         *d.radiance[0].tolist(), f(d.medium_depth), f(event), f(pdf),
         f(delta)], np.float32)


def probe_pixel(scene, uniforms, static, x: int, y: int,
                prev_count: int = 0):
    """Replay one pixel's sample and return its bounce history.

    Returns a list of dicts (one per bounce that executed) with keys
    ``PROBE_FIELDS`` plus "depth": hit ids, t, throughput, radiance so
    far, medium events, pdf, delta flag. Deterministic: the pixel's seed
    (``rng.make_seed``) is the render's, so the probe replays what the
    accumulated frame traced. The scene's device decides where it runs."""
    dev = scene.materials.mat_type.device
    xs = torch.tensor([x], dtype=torch.int64, device=dev)
    ys = torch.tensor([y], dtype=torch.int64, device=dev)
    prev = torch.tensor([prev_count], dtype=torch.int64, device=dev)
    seed = rng_ops.make_seed(uniforms.fixed_rng_seed, uniforms.frame_index,
                             xs, ys, uniforms.sample_count, prev)
    state, origin, direction = camera_ops.generate_primary_rays(
        uniforms.camera, xs, ys, static.width, static.height, seed)
    depths = []
    integrator.trace_paths(scene, uniforms, static, state, origin, direction,
                           probe=depths)
    rows = []
    for depth, d in enumerate(depths):
        record = _row(scene, uniforms, static, d)
        # all-zero rows past termination are padding, except depth 0
        if depth > 0 and not np.any(record):
            break
        row = dict(zip(PROBE_FIELDS, record))
        row["depth"] = depth
        rows.append(row)
    return rows
