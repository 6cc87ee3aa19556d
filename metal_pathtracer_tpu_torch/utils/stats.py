"""Performance stats, structured logging and the traversal profile
(``utils/stats.py`` twin).

The analogue of the reference's ``PerformanceStats`` struct and its
``--verbose`` timing logs (reference: include/renderer/PerformanceStats.h
:12-114, src/MetalRenderer.mm:958-981 for the rolling averages,
:1144-1347 for the per-ray traversal counters). Scene and shadow trace
counts arrive from ``RenderState.ray_count``/``shadow_ray_count``;
wall-clock timing is host-side around work that ends in a device
synchronisation. ``traversal_profile`` runs K1's counting instantiation
(``ops/kernels/traverse.py``) over a wavefront.

Logging keeps the reference's bracketed-tag console style (``[Timing]``,
``[Output]``, ``[Headless]``) on the standard ``logging`` module, under
this package's own logger.
"""

from __future__ import annotations

import dataclasses
import logging
import sys
import time
from typing import Optional

# ---------------------------------------------------------------------------
# Structured logging with the reference's bracketed-tag style
# ---------------------------------------------------------------------------

_FORMATTER = logging.Formatter("[%(tag)s] %(message)s")
_ROOT_NAME = "metal_pathtracer_tpu_torch"


class _TagAdapter(logging.LoggerAdapter):
    """Injects the `[Tag]` prefix the reference uses for every subsystem."""

    def process(self, msg, kwargs):
        extra = kwargs.setdefault("extra", {})
        extra.setdefault("tag", self.extra["tag"])
        return msg, kwargs


class _DynamicStdout:
    """Late-binding stdout so redirection (pytest capture, piping into a
    file after setup) is honored."""

    def write(self, s):
        sys.stdout.write(s)

    def flush(self):
        sys.stdout.flush()


def get_logger(tag: str = "Renderer") -> logging.LoggerAdapter:
    """`get_logger("Timing").info(...)` prints `[Timing] ...`."""
    base = logging.getLogger(_ROOT_NAME)
    if not base.handlers:
        handler = logging.StreamHandler(_DynamicStdout())
        handler.setFormatter(_FORMATTER)
        base.addHandler(handler)
        base.setLevel(logging.INFO)
        base.propagate = False
    return _TagAdapter(base, {"tag": tag})


def set_verbose(verbose: bool) -> None:
    """--verbose maps to DEBUG, default INFO (the reference has exactly the
    two levels: always-on bracketed logs + --verbose one-shot timings)."""
    logging.getLogger(_ROOT_NAME).setLevel(
        logging.DEBUG if verbose else logging.INFO)


# ---------------------------------------------------------------------------
# PerformanceStats
# ---------------------------------------------------------------------------

def _ema(prev: float, value: float, alpha: float = 0.1) -> float:
    """Rolling average with the reference's low-pass style
    (MetalRenderer.mm:958-981 keeps smoothed ms metrics)."""
    return value if prev == 0.0 else (1.0 - alpha) * prev + alpha * value


@dataclasses.dataclass
class PerformanceStats:
    """Rolling render metrics (reference: PerformanceStats.h:12-114).

    Trace counters arrive via `update(...)` from the counts the depth
    loops sum (RenderState.ray_count / shadow_ray_count); host-side
    timing comes from the sample-batch wall clock.
    """

    # timing (reference fields: gpuTimeMs, cpuEncodeTimeMs, frameTimeMs)
    device_ms_per_batch: float = 0.0
    frame_time_ms: float = 0.0
    # throughput (reference: samplesPerMinute; Mrays/s is the README's
    # headline metric, README.md:144-148)
    samples_per_minute: float = 0.0
    mrays_per_second: float = 0.0
    # totals
    total_samples: int = 0
    total_rays: float = 0.0
    total_shadow_rays: float = 0.0
    total_seconds: float = 0.0
    # per-sample derived counters (reference derives avg nodes/ray etc.,
    # MetalRenderer.mm:1168-1347; these are the counters the loops sum)
    rays_per_sample: float = 0.0
    shadow_ray_fraction: float = 0.0

    def update(self, *, samples: int, seconds: float, width: int, height: int,
               ray_count: float = 0.0, shadow_ray_count: float = 0.0) -> None:
        """Fold one rendered batch into the rolling stats."""
        if samples <= 0 or seconds <= 0.0:
            return
        new_rays = max(ray_count - self.total_rays, 0.0)
        new_shadow = max(shadow_ray_count - self.total_shadow_rays, 0.0)
        self.total_samples += samples
        self.total_seconds += seconds
        self.total_rays = max(ray_count, self.total_rays)
        self.total_shadow_rays = max(shadow_ray_count, self.total_shadow_rays)

        batch_ms = 1000.0 * seconds
        self.device_ms_per_batch = _ema(self.device_ms_per_batch, batch_ms)
        self.frame_time_ms = _ema(self.frame_time_ms, batch_ms / samples)
        self.samples_per_minute = _ema(
            self.samples_per_minute, 60.0 * samples / seconds)
        traced = new_rays + new_shadow
        if traced > 0.0:
            self.mrays_per_second = _ema(
                self.mrays_per_second, traced / seconds / 1e6)
            self.rays_per_sample = traced / (samples * width * height)
            self.shadow_ray_fraction = new_shadow / traced

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        parts = [f"{self.total_samples} spp in {self.total_seconds:.2f}s",
                 f"{self.samples_per_minute:.1f} samples/min"]
        if self.mrays_per_second > 0.0:
            parts.append(f"{self.mrays_per_second:.2f} Mrays/s")
            parts.append(f"{self.rays_per_sample:.2f} rays/sample-pixel")
            parts.append(f"{100.0 * self.shadow_ray_fraction:.0f}% shadow")
        return ", ".join(parts)


class BatchTimer:
    """Wall-clock for one device batch; `with BatchTimer() as t: ...` then
    `t.seconds`. The caller synchronises the device inside."""

    def __enter__(self):
        self.start = time.time()
        return self

    def __exit__(self, *exc):
        self.seconds = time.time() - self.start
        return False


def traversal_profile(origin, direction, bvh, tris, t_min=1e-3,
                      t_max=3.0e38, any_hit: bool = False) -> dict:
    """Instrumented trace of a wavefront through K1's counting
    instantiation -> the reference's traversal metric set (reference:
    src/MetalRenderer.mm:1168-1347, PerformanceStats.h:12-114), under the
    JAX package's keys (``utils/stats.py traversal_profile:162``).

    ``bvh``/``tris``: the scene's exit-link BVH and triangles
    (``SceneArrays.tri_bvh``/``triangles``; None for a scene without
    triangles, where every ray misses). The JAX package walks
    1024-ray packets through a packet tree, so where a key counts per
    packet this one counts per ray:

    - ``nodes_per_ray``: slab tests per ray;
    - ``leaf_chunks_per_ray``: leaf visits whose box passed, per ray (a
      packet tests each leaf chunk once for its rays);
    - ``leaf_prim_tests_per_ray``: triangle tests per ray;
    - ``both_children_visited_pct``: interior nodes both of whose
      children's boxes passed, per slab test, counted when the walk
      reaches the right child (the packet walk asks it at the parent);
    - ``packets``: 32-ray warps, the GPU's unit of lockstep execution
      (the JAX package's 1024-ray packets);
    - ``hit_pct``, ``shadow_early_exit_pct`` (any-hit: the occluded
      lanes, whose walk stops at the first hit) and ``hit_t_histogram``
      / ``hit_t_range`` (32 bins over the hit distances, closest-hit)
      mean the same in both.
    """
    import numpy as np
    import torch

    from metal_pathtracer_tpu_torch.ops.kernels import traverse

    n = origin.shape[0]
    if bvh is None:
        # a scene without triangles: every ray misses, nothing is walked
        totals = torch.zeros(len(traverse.STATS_KEYS), dtype=torch.int64)
        hits = np.zeros(n, bool)
        t = torch.zeros(n)
    elif any_hit:
        occ, totals = traverse.trace_any_stats(origin, direction, t_min,
                                               t_max, bvh, tris)
        hits = occ.cpu().numpy()
    else:
        t, tri, _, _, totals = traverse.trace_closest_stats(
            origin, direction, t_min, t_max, bvh, tris)
        hits = tri.cpu().numpy() >= 0
    tot = dict(zip(traverse.STATS_KEYS, totals.cpu().tolist()))
    out = {
        "rays": float(n),
        "nodes_per_ray": tot["nodes_visited"] / n,
        "leaf_chunks_per_ray": tot["leaf_chunks_tested"] / n,
        "leaf_prim_tests_per_ray": tot["leaf_prim_tests"] / n,
        "both_children_visited_pct":
            100.0 * tot["both_children_visited"]
            / max(tot["nodes_visited"], 1.0),
        "hit_pct": 100.0 * float(hits.sum()) / n,
        "packets": float(-(-n // 32)),
    }
    if any_hit:
        out["shadow_early_exit_pct"] = 100.0 * float(hits.sum()) / n
    else:
        t_np = t.cpu().numpy()[hits]
        if t_np.size:
            hist, edges = np.histogram(t_np, bins=32)
            out["hit_t_histogram"] = hist.tolist()
            out["hit_t_range"] = (float(edges[0]), float(edges[-1]))
    return out
