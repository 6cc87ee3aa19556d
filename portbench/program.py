"""The port's own spans and counters (``metal_pathtracer_tpu_torch/utils/
spans.py``) in a traced run: which host code the device waits on, and
the host syncs a unit.

    python3 -m portbench.program --workload <cell> --seed <n> \
        --seconds <s>

runs ``portbench.run``'s ``--trace 1`` run of the cell and prints its
result line with the readers below added to ``metrics``, each idle
group's ms a unit under ``program_split`` and the profiled stretch's
counters under ``program_counters``. It keeps the chrome trace's events
that ``trace.profile`` reduces and snapshots the port's counters around
the profiled stretch (``run._traced``), and hangs both on the
``trace.Trace``: ``program_spans``, each ``mpt.*`` span and each
``portbench.count`` span as (name, start, end) in microseconds, and
``counters``, the counters' change over the stretch (None where the port
has none).

Each idle gap between device operations goes to the innermost ``mpt.*``
span holding its middle, as ``trace.breakdown`` labels gaps; a gap whose
middle lies in a ``portbench.count`` span is the benchmark's own and is
left out of every share and of the base. Every reader returns None on a
trace without an ``mpt.*`` span.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib.util
import json
import sys
from unittest import mock

from portbench import run, trace

PREFIX = "mpt."
#: the spans of each idle group; ``loop``: those spans themselves, not
#: their children
GROUPS = {"camera": ("mpt.camera",), "trace": ("mpt.trace",),
          "shade": ("mpt.shade",),
          "loop": ("mpt.depth", "mpt.sync", "mpt.sample", "mpt.accumulate")}
UNATTRIBUTED = "unattributed"


def program_spans(events: list) -> list:
    """(name, start, end) of each ``mpt.*`` and ``portbench.count`` span
    of a chrome trace's events, in microseconds."""
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur",
                                                                     0.0)))
            for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and (e["name"].startswith(PREFIX)
                 or e["name"] == trace.COUNT_SPAN)]


def _spans(t) -> list | None:
    found = getattr(t, "program_spans", None) or []
    return found if any(s[0].startswith(PREFIX) for s in found) else None


def idle_split(t) -> tuple | None:
    """({innermost ``mpt.*`` span or ``unattributed``: idle seconds},
    the benchmark's own idle seconds) of the profiled stretch."""
    found = _spans(t)
    if found is None:
        return None
    iv = trace.merged(t.device)
    spans = sorted(found, key=lambda s: (s[1], -s[2]))
    starts = [s[1] for s in spans]
    split, own = {}, 0.0
    for a, b in zip(iv, iv[1:]):
        if b[0] <= a[1]:
            continue
        mid, secs = (a[1] + b[0]) / 2.0, (b[0] - a[1]) * 1e-6
        # the innermost span holding ``mid``: spans of one thread nest
        i = bisect.bisect_right(starts, mid) - 1
        label = UNATTRIBUTED
        while i >= 0:
            if spans[i][2] >= mid:
                label = spans[i][0]
                break
            i -= 1
        if label == trace.COUNT_SPAN:
            own += secs
        else:
            split[label] = split.get(label, 0.0) + secs
    return split, own


def idle_ms_per_unit(t) -> float:
    """The unprofiled window's idle ms a unit: its wall a unit less the
    profiled device busy time a unit."""
    return 1e3 * (t.wall_per_unit_s - t.busy_s / t.units)


def shares(t) -> dict | None:
    """Each label's share of the stretch's idle time (the benchmark's own
    left out of the base)."""
    got = idle_split(t)
    if got is None:
        return None
    split = got[0]
    base = sum(split.values())
    return {k: v / base for k, v in split.items()} if base > 0 else None


def idle_group_ms(t, group: str) -> float | None:
    """The idle ms a unit spent in ``GROUPS[group]``'s spans."""
    s = shares(t)
    if s is None:
        return None
    return sum(s.get(n, 0.0) for n in GROUPS[group]) * idle_ms_per_unit(t)


def unattributed_pct(t) -> float | None:
    s = shares(t)
    return None if s is None else 100.0 * s.get(UNATTRIBUTED, 0.0)


def host_syncs_per_unit(t) -> float | None:
    counts = getattr(t, "counters", None)
    if _spans(t) is None or counts is None:
        return None
    return counts.get("host_syncs", 0) / t.units


def frame_setup_ms(t) -> float | None:
    """The mean host ms of ``mpt.frame_setup`` over the profiled frames."""
    found = [e - s for n, s, e in (_spans(t) or [])
             if n == "mpt.frame_setup"]
    return 1e-3 * sum(found) / len(found) if found else None


#: each cell mode's readers: name -> (unit, read)
READERS = {
    "offline": {
        "host_syncs_per_spp.offline": ("syncs", host_syncs_per_unit),
        "idle_camera_ms_per_spp.offline":
            ("ms", lambda t: idle_group_ms(t, "camera")),
        "idle_trace_ms_per_spp.offline":
            ("ms", lambda t: idle_group_ms(t, "trace")),
        "idle_shade_ms_per_spp.offline":
            ("ms", lambda t: idle_group_ms(t, "shade")),
        "idle_loop_ms_per_spp.offline":
            ("ms", lambda t: idle_group_ms(t, "loop")),
        "idle_unattributed_pct.offline": ("%", unattributed_pct),
    },
    "interactive": {
        "frame_setup_ms.interactive": ("ms", frame_setup_ms),
        "idle_unattributed_pct.interactive": ("%", unattributed_pct),
    },
}


def _port_counters() -> dict | None:
    if importlib.util.find_spec("metal_pathtracer_tpu_torch.utils.spans") \
            is None:
        return None
    from metal_pathtracer_tpu_torch.utils import spans

    return spans.counters()


@contextlib.contextmanager
def keeping(kept: list):
    """``run._traced`` with the stretch's events and the port's counters
    kept: each Trace it returns is appended to ``kept`` with
    ``program_spans`` and ``counters``."""
    traced, reduce_events = run._traced, trace.reduce_events
    events = []

    def keep_events(ev, classes):
        events[:] = ev
        return reduce_events(ev, classes)

    def keep(*a, **k):
        before = _port_counters()
        t = traced(*a, **k)
        after = _port_counters()
        t.program_spans = program_spans(events)
        t.counters = None if before is None else {
            n: after.get(n, 0) - before.get(n, 0) for n in after}
        kept.append(t)
        return t

    with mock.patch.object(trace, "reduce_events", keep_events), \
            mock.patch.object(run, "_traced", keep):
        yield


def main(argv=None) -> int:
    import argparse

    from portbench import cells

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    run._environment()
    import torch

    torch.set_num_threads(1)
    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench.program: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    kept = []
    with keeping(kept):
        result = run.run_cell(cell, args.seed, args.seconds, True, device)
    t = kept[0]
    checks = result.pop("checks")
    got, split = idle_split(t), shares(t)
    if got is not None:
        print(f"program: the benchmark's own idle {got[1] * 1e3:.3f} ms "
              f"left out", file=sys.stderr)
    if split is not None:
        per_unit = idle_ms_per_unit(t)
        result["program_split"] = {k: v * per_unit for k, v in sorted(
            split.items(), key=lambda kv: -kv[1])}
    result["program_counters"] = t.counters
    for name, (unit, read) in READERS[cell.traffic["mode"]].items():
        value = read(t)
        if value is not None:
            result["metrics"][name] = {"value": value, "unit": unit}
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
