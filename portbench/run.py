"""The benchmark of the PyTorch + CUDA port.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout. The cell (``BENCHMARK.json``) names a
configuration (``portbench/configs/``) and a traffic mix
(``portbench/traffic/``). The run generates the configuration's scene,
hands it to the port, warms up with one unit of the cell's work (that
and everything before it is ``setup_s``), then runs the job in a closed
loop until ``--seconds`` have passed: the window ends with the unit that
crosses it. With ``--trace 1`` the same window gives the wall time a
unit, then a profiled stretch of the cell's own work gives the per-layer
metrics. Once the window has closed and the peak memory is read, the
program's state goes and the plain reference (``portbench/reference``)
judges what the window produced (``check.py``).

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``checks`` last: each number compared with its
limit); the last lines of standard error are the same checks. Without
a card, with fewer cards than the cell asks for, or with JAX or the JAX
package loaded, the run exits with code 2 and prints no result.
"""

from __future__ import annotations

import time

START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from portbench import cells  # noqa: E402

#: top-level module names that may not be loaded, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "metal_pathtracer_tpu")


def _environment() -> None:
    """Every build and kernel cache in fixed directories of the checkout
    (the port's own, its kernels library and native helpers, already lie
    there); one CPU thread for torch and its OpenMP pool, so that the
    launching thread has its core to itself."""
    cache = os.path.join(cells.PKG_DIR, "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["OMP_NUM_THREADS"] = "1"


def _pin() -> set | None:
    """One core for the process (the highest it may use), so that every
    run launches from the same core and none is moved between cores in
    its window; returns the cores it could use before, or None where the
    system has no affinity call."""
    if not hasattr(os, "sched_setaffinity"):
        return None
    allowed = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {max(allowed)})
    return allowed


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Refused(RuntimeError):
    """The run cannot give a result (no card, a forbidden module)."""


def _guard() -> None:
    found = forbidden_modules()
    if found:
        raise Refused(f"forbidden modules loaded: {', '.join(found)}")


def card_line(device) -> dict:
    """The card's name, count and power limit (``nvidia-smi``)."""
    import torch

    line = {"kind": torch.cuda.get_device_name(device)}
    try:
        line["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        line["power_limit"] = f"unread ({exc})"
    return line


def _say(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def p95(values) -> float:
    """The 95th percentile, linear between the order statistics."""
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), 95))


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device, start: float = START) -> dict:
    """One run of ``cell``: the result's keys, ``checks`` last."""
    import torch

    from portbench import check, jobs, scenegen

    traffic = cell.traffic
    cores = _pin()
    spec = scenegen.build_spec(cell.config)
    job = jobs.JOBS[traffic["mode"]](spec, traffic, seed, device)
    on_card = torch.device(device).type == "cuda"
    job.warm()
    # the scene's and the set-up's objects live for the whole run: out of
    # the collector's way, so that no collection in the window rescans them
    gc.collect()
    gc.freeze()
    setup_s = time.time() - start
    interactive = traffic["mode"] == "interactive"
    if trace and interactive:
        job.split = ([], [])
    times, units = [], 0
    t0 = time.perf_counter()
    while True:
        s = time.perf_counter()
        units += job.step()
        e = time.perf_counter()
        times.append(e - s)
        if e - t0 >= seconds:
            break
    window_s = e - t0
    pixels = job.width * job.height
    per_unit = traffic["samples_per_frame" if interactive else "batch_spp"]
    result = {"correct": False, "attempted": len(times), "failed": 0}
    metrics, breakdown, traced = {}, None, None
    if trace:
        traced = _traced(job, cell, spec, window_s,
                         len(times) if interactive else units / pixels,
                         device)
        for m in cell.per_layer:
            from portbench.metrics import reader

            value = reader(m["name"])(traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        from portbench.trace import breakdown as reduce_breakdown

        breakdown = reduce_breakdown(traced)
    else:
        e2e = {"msamples_per_s": units / window_s / 1e6,
               "frames_per_s": len(times) / window_s,
               "frame_ms_p95": 1e3 * p95(times), "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    _guard()
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    closest, shadow = job.rays()
    spp = job.requested * pixels
    _say(f"window: {len(times)} units of {per_unit} spp, {units // pixels} "
         f"spp a pixel, {window_s:.3f} s; unit ms median "
         f"{1e3 * statistics.median(times):.3f}, p95 {1e3 * p95(times):.3f}; "
         f"setup {setup_s:.3f} s; peak memory {peak} B; traces a pixel "
         f"sample {(closest + shadow) / spp:.4f} (closest {closest / spp:.4f},"
         f" shadow {shadow / spp:.4f})")
    pix = check.sample_pixels(seed, job.width, job.height,
                              traffic["check_pixels"])
    out = job.outputs(pix)
    job.free()
    del job
    if cores is not None:
        os.sched_setaffinity(0, cores)
    t_ref = time.perf_counter()
    numbers = check.reference_numbers(spec, traffic, seed, out)
    _say(f"reference: {time.perf_counter() - t_ref:.3f} s for "
         f"{len(pix)} pixels x {out.requested} samples")
    correct, checks = check.judge(numbers, traffic["limits"])
    _guard()
    result.update(correct=correct, metrics=metrics)
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": (torch.cuda.get_device_name(device) if on_card
                 else "cpu"),
        "count": cell.chips,
        "memory_peak_bytes": peak,
    }
    if traced is not None:
        result["device"].update(busy_s=traced.busy_s,
                                window_s=traced.window_s)
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def _traced(job, cell, spec, window_s: float, units: float, device):
    """The profiled stretch with the wrappers installed: one batch of
    ``profile_units`` samples offline, as the frame loop runs a batch, or
    ``profile_units`` frames; a ``trace.Trace`` of it. ``units``: the
    samples a pixel, or the frames, of the unprofiled window."""
    import torch

    from portbench import trace

    n = cell.traffic["profile_units"]
    counter = trace.Counter()
    split = getattr(job, "split", None)

    def run_units():
        rf = torch.profiler.record_function
        with trace.instrument(counter, light_integral=False):
            if cell.traffic["mode"] == "offline":
                with rf("frame"), rf("render"):
                    job.render(n)
                return
            for _ in range(n):
                with rf("frame"):
                    job.step()

    dev, spans, own, prof_s = trace.profile(run_units, device)
    _say(f"traced: {n} samples in {prof_s:.3f} s, {len(dev)} device "
         f"operations; the wrappers' own {own[0]} ({own[1] * 1e3:.3f} ms) "
         f"left out")
    return trace.Trace(
        mode=cell.traffic["mode"], units=n, window_s=prof_s,
        wall_per_unit_s=window_s / units, device=dev, spans=spans,
        counter=counter, scene=spec.counts, peaks=trace.peaks_of(
            torch.cuda.get_device_name(device)
            if torch.device(device).type == "cuda" else "cpu"),
        split=split)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    try:
        cell = cells.load_cell(args.workload)
        import torch

        torch.set_num_threads(1)

        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            raise Refused(f"the cell needs {cell.chips} CUDA device(s); "
                          f"torch sees "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
        _say(f"card: {json.dumps(card_line(device))}")
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          device)
    except Refused as exc:
        _say(f"portbench: {exc}")
        return 2
    for name, c in result["checks"].items():
        _say(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
