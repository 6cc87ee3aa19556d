"""The traced run: the benchmark's own counters and spans around the
calls into each layer of the port, a profiled stretch of the cell's own
work, and its reduction to what the per-layer readers
(``portbench/metrics/``) and the ``breakdown`` read.

Only the traced run installs the wrappers, and only around its profiled
stretch. Each wrapper opens a span (``torch.profiler.record_function``:
``trace``, ``shade``, ``texture``, ``display``) around the port's call
and counts what a kernel's call was given: its live rays or lanes (a
reduction and a host read, so the profiled stretch syncs once a call
more). The count runs inside a ``portbench.count`` span, and the device
operations launched there are left out of the trace's reduction: the
wrappers add no launch and no device time to what the readers read. The
harness opens ``frame`` around each unit, and ``render`` around an
offline batch.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import re
import tempfile
import time
from unittest import mock

import torch

from portbench import cells

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPANS = ("frame", "render", "trace", "shade", "texture", "display")
#: the span around the wrappers' own counting: the device operations it
#: launches are the benchmark's, and the reduction leaves them out
COUNT_SPAN = "portbench.count"


def kernel_classes() -> dict:
    return cells.load_json(os.path.join(cells.PKG_DIR,
                                        "kernels.json"))["classes"]


def kernel_class(name: str, classes: dict) -> str:
    """The port kernel class whose pattern the device op's name holds,
    or ``glue``."""
    for cls, patterns in classes.items():
        if any(p in name for p in patterns):
            return cls
    return "glue"


def peaks_of(device_name: str):
    table = cells.load_json(os.path.join(cells.PKG_DIR, "peaks.json"))
    return table.get(device_name)


@dataclasses.dataclass
class Counter:
    """The calls the wrappers saw: one record a call (``kind``, ``live``
    lanes or ``pixels``, ``light``)."""

    calls: list = dataclasses.field(default_factory=list)

    def of(self, *kinds) -> list:
        return [c for c in self.calls if c["kind"] in kinds]


def _live(t_min, t_max) -> int:
    t_max = torch.as_tensor(t_max)
    if t_max.dim() == 0:
        return -1   # a whole wavefront: the caller's lane count
    return int((t_max >= float(t_min)).sum())


def _counted(wrapper):
    """The port's entry points count their launches on themselves
    (``fn.launches += 1`` through their module's name), which while
    patched is the wrapper's."""
    wrapper.launches = 0
    return wrapper


@contextlib.contextmanager
def instrument(counter: Counter, light_integral: bool):
    """Counting wrappers with spans around the port's kernel entry points
    (the triangle, sphere and rectangle traces, the shading stages and
    the texture stage) and a span around its display, installed at every
    name the port calls them by.
    A scene's path calls some of them; the others stay uncalled."""
    from metal_pathtracer_tpu_torch.ops import traversal
    from metal_pathtracer_tpu_torch.ops.kernels import primitives, shade
    from metal_pathtracer_tpu_torch.ops.kernels import traverse
    from metal_pathtracer_tpu_torch.renderer import display

    rf = torch.profiler.record_function

    def traced(kind, fn):
        def run(origin, direction, t_min, t_max, *a, **k):
            with rf(COUNT_SPAN):
                live = _live(t_min, t_max)
            counter.calls.append(dict(kind=kind, live=(
                origin.shape[0] if live < 0 else live)))
            with rf("trace"):
                return fn(origin, direction, t_min, t_max, *a, **k)
        return _counted(run)

    def shaded(fn, charged):
        def run(carry, *a, **k):
            if charged:
                with rf(COUNT_SPAN):
                    live = int(carry.alive.sum())
                counter.calls.append(dict(kind="shade", light=light_integral,
                                          live=live))
            with rf("shade"):
                return fn(carry, *a, **k)
        return _counted(run)

    def textured(fn):
        def run(carry, t, tri, *a, **k):
            with rf(COUNT_SPAN):
                live = int((carry.alive & (tri >= 0)).sum())
            counter.calls.append(dict(kind="texture", live=live))
            with rf("texture"):
                return fn(carry, t, tri, *a, **k)
        return _counted(run)

    def displayed(fn):
        def run(*a, **k):
            with rf("display"):
                return fn(*a, **k)
        return run

    closest = traced("closest", traverse.trace_closest)
    with mock.patch.object(traverse, "trace_closest", closest), \
            mock.patch.object(traversal, "trace_closest", closest), \
            mock.patch.object(shade, "trace_closest", closest), \
            mock.patch.object(traverse, "trace_any",
                              traced("any", traverse.trace_any)), \
            mock.patch.object(primitives, "sphere_nearest",
                              traced("spheres", primitives.sphere_nearest)), \
            mock.patch.object(primitives, "rect_nearest",
                              traced("rects", primitives.rect_nearest)), \
            mock.patch.object(shade, "shade_full",
                              shaded(shade.shade_full, True)), \
            mock.patch.object(shade, "shade_s1",
                              shaded(shade.shade_s1, True)), \
            mock.patch.object(shade, "shade_s2",
                              shaded(shade.shade_s2, False)), \
            mock.patch.object(shade, "texture_stage",
                              textured(shade.texture_stage)), \
            mock.patch.object(display, "display_to_u8",
                              displayed(display.display_to_u8)):
        yield


@dataclasses.dataclass
class Trace:
    """What a reader reads: the profiled stretch's device operations
    (name, class, start and duration in microseconds), its host spans,
    the counted calls, the units it ran (samples a pixel, or frames) and
    the wall seconds a unit took in the unprofiled window of the same
    run, the scene's counts, the card's peaks (None for a card
    ``peaks.json`` lacks) and, for a displayed job, the unprofiled
    window's render and display seconds a frame."""

    mode: str
    units: int
    window_s: float
    wall_per_unit_s: float
    device: list
    spans: list
    counter: Counter
    scene: dict
    peaks: dict | None
    split: tuple | None = None

    def of_class(self, *classes) -> list:
        return [d for d in self.device if d[1] in classes]

    def device_s(self, *classes) -> float:
        return sum(d[3] for d in self.of_class(*classes)) * 1e-6

    @property
    def busy_s(self) -> float:
        """Seconds in which an operation ran on the device: the union of
        the operations' intervals."""
        return sum(e - s for s, e in merged(self.device)) * 1e-6


def merged(device) -> list:
    """The device operations' intervals, overlaps merged: [(start, end)]
    in microseconds, in order."""
    out = []
    for _, _, s, d in sorted(device, key=lambda x: x[2]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s + d)
        else:
            out.append([s, s + d])
    return [tuple(x) for x in out]


def profile(run_units, device) -> tuple:
    """Run ``run_units()`` under the profiler; returns (device
    operations, spans, the benchmark's own operations left out, host
    seconds of the stretch): see ``reduce_events``."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    on_card = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_units()
        if on_card:
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return (*reduce_events(events, kernel_classes()), window_s)


def reduce_events(events: list, classes: dict) -> tuple:
    """(device operations, spans, own) of a chrome trace's events: each
    device operation as (name, class, start, duration), each span of
    ``SPANS`` as (name, start, end), in microseconds. A device operation
    whose launch lies inside a ``COUNT_SPAN`` (matched by the profiler's
    correlation id) is the benchmark's own and is left out; ``own`` is
    (their number, their device seconds)."""
    xs = [e for e in events if e.get("ph") == "X"]
    counts = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                    for e in xs if e.get("cat") == "user_annotation"
                    and e["name"] == COUNT_SPAN)
    starts = [c[0] for c in counts]
    own = set()
    for e in xs:
        if e.get("cat") in LAUNCH_CATS:
            ts = float(e["ts"])
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= counts[i][1]:
                own.add(e.get("args", {}).get("correlation"))
    own.discard(None)
    dev, spans, left = [], [], [0, 0.0]
    for e in xs:
        if e.get("cat") in DEVICE_CATS:
            if e.get("args", {}).get("correlation") in own:
                left[0] += 1
                left[1] += float(e.get("dur", 0.0)) * 1e-6
                continue
            dev.append((e["name"], kernel_class(e["name"], classes),
                        float(e["ts"]), float(e.get("dur", 0.0))))
        elif e.get("cat") == "user_annotation" and e["name"] in SPANS:
            spans.append((e["name"], float(e["ts"]),
                          float(e["ts"]) + float(e.get("dur", 0.0))))
    return dev, spans, tuple(left)


def short_name(name: str) -> str:
    """A device operation's name without its return type and parameters,
    its template arguments kept (they name the functor of torch's
    elementwise kernels), cut to 100 characters."""
    name = name.replace("(anonymous namespace)", "anon")
    name = re.sub(r"^void ", "", name)
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name.strip()[:100]


def breakdown(t: Trace) -> dict:
    """The ten device operations that took most time (by short name), and
    the idle gaps between device operations summed by what the host was
    doing (the innermost benchmark span around the gap's middle)."""
    ops = {}
    for name, _, _, dur in t.device:
        k = short_name(name)
        ops[k] = ops.get(k, 0.0) + dur * 1e-6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    iv = merged(t.device)
    mids = [((a[1] + b[0]) / 2.0, (b[0] - a[1]) * 1e-6)
            for a, b in zip(iv, iv[1:]) if b[0] > a[1]]
    gaps = {}
    spans = sorted(t.spans, key=lambda s: (s[1], -s[2]))
    starts = [s[1] for s in spans]
    for mid, secs in mids:
        # the innermost span holding ``mid``: the latest-starting one
        # that has not ended (spans of one thread nest)
        i = bisect.bisect_right(starts, mid) - 1
        label = "host"
        while i >= 0:
            if spans[i][2] >= mid:
                label = spans[i][0]
                break
            i -= 1
        gaps[label] = gaps.get(label, 0.0) + secs
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle]}
