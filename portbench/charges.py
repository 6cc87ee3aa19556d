"""Roofline charges: the least bytes each kernel's work needs, counted
from the work itself (the live rays, lanes and hits each launch was
given), never from the port's node, slot or plane layout, and never from
the number of launches: the scene's tables (spheres, triangles,
materials, texels) are read from the cache by every launch and charged
to none, so that splitting or fusing launches leaves the charge as it
is. A bound is the larger of bytes over the peak bandwidth and
operations over the peak float32 rate (``peaks.json``); a share of the
roofline is the summed bounds of a class's launches over their summed
device time, a lower bound of the work over the time it took.

Charges (bytes, each live ray or lane of a launch):

- a closest-hit triangle trace: the ray's origin and direction (24), its
  window end (4), the triangle it skips (8) and the hit it returns (t,
  triangle, u, v: 16);
- an any-hit trace: the ray's 24 + 4 and its flag (1);
- a closest sphere or rectangle trace: the ray's 24 + 4 and the hit it
  returns (t, index: 8);
- shading a depth (K2 ``full``, or ``s1`` and ``s2`` together: charged
  once, at ``full`` or ``s1``, on the lanes alive as it starts): the path
  state in (origin, direction, throughput, radiance, RNG state: 52), its
  hit (16), the least record of the primitive hit (a sphere's centre and
  radius: 16), the path state out (52) and its alive flag (1); with a
  light integral the light sample too (direction, radiance, pdf: 28);
- the texture stage: each live hit's UVs (24), the four texels of its
  bilinear lookup (16) and the material inputs it returns (20).
"""

from __future__ import annotations

RAY = 24 + 4
CLOSEST_RAY = RAY + 8 + 16
ANY_RAY = RAY + 1
PRIMITIVE_RAY = RAY + 8
SHADE_LANE = 52 + 16 + 16 + 52 + 1
LIGHT_SAMPLE = 28
TEX_LANE = 24 + 16 + 20

TRACE_BYTES = {"closest": CLOSEST_RAY, "any": ANY_RAY,
               "spheres": PRIMITIVE_RAY, "rects": PRIMITIVE_RAY}


def call_bytes(call: dict) -> float:
    """The bytes of one counted call (``trace.Counter`` records)."""
    kind = call["kind"]
    if kind in TRACE_BYTES:
        return call["live"] * TRACE_BYTES[kind]
    if kind == "shade":
        return call["live"] * (SHADE_LANE
                               + (LIGHT_SAMPLE if call["light"] else 0))
    if kind == "texture":
        return call["live"] * TEX_LANE
    raise KeyError(f"no charge for calls of kind {kind!r}")


def bound_s(ops: float, nbytes: float, peaks: dict) -> float:
    """The least seconds the chip could take: the larger of the two."""
    return max(ops / peaks["fp32_flops_per_s"],
               nbytes / peaks["hbm_bytes_per_s"])


def share(calls: list, seconds: float, peaks: dict | None):
    """100 x the calls' summed bounds over ``seconds``; None where there
    is nothing to read."""
    if not calls or seconds <= 0.0 or peaks is None:
        return None
    return 100.0 * sum(bound_s(0.0, call_bytes(c), peaks)
                       for c in calls) / seconds
