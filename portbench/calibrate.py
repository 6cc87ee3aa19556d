"""The readings the limits of ``correct`` are set from, on the card.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \
        --units 12 [--control-seeds 1,2,3]

In one process, for each seed: the cell's job from an empty state under
that render seed, ``units`` units of its own work (as many as a run's
window holds, so that as many samples are compared), then every number
``check.py`` compares, for the program and, on ``--control-seeds``, for
the control (the reference with its path state in bfloat16, put in the
program's place). Each reading is one JSON line on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import cells, check, jobs, scenegen
from portbench.reference.oracle import Reference


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--units", type=int, required=True)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    cell = cells.load_cell(args.workload)
    device = torch.device("cuda", 0)
    spec = scenegen.build_spec(cell.config)
    traffic = cell.traffic
    job = jobs.JOBS[traffic["mode"]](spec, traffic, seeds[0], device)
    job.warm()
    ref = Reference(spec, traffic, seeds[0])
    for seed in seeds:
        job.reseed(seed)
        ref.reseed(seed)
        t0 = time.perf_counter()
        for _ in range(args.units):
            job.step()
        render_s = time.perf_counter() - t0
        out = job.outputs(check.sample_pixels(
            seed, job.width, job.height, traffic["check_pixels"]))
        sides = ["program"] + (["control"] if seed in controls else [])
        for side in sides:
            t0 = time.perf_counter()
            numbers = check.numbers(ref, out, control=side == "control")
            print(json.dumps(dict(
                workload=args.workload, seed=seed, side=side,
                samples=out.requested, render_s=render_s,
                reference_s=time.perf_counter() - t0, numbers=numbers)),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
