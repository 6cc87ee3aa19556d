"""Parent-against-change timing of the lambert cell on the card.

Runs ``chip_smoke.py``'s lambert phase from two checkouts in separate,
alternating processes (by default parent, change, change, parent,
parent, change), each followed by four more timed 4 spp renders at
1920x1080 d8, and prints every ms/spp with K2 ``full``'s device time at
the first bounce beside its window around the wrapper (``kernel_ms`` of
the change's ``chip_smoke.py``, applied to both trees). Each checkout
builds its own kernels. Make the parent's checkout with ``git archive``
into a git-ignored directory, then::

    python3 metal_pathtracer_tpu_torch/utils/ab_lambert.py PARENT CHANGE

Lines starting with ``AB`` carry the numbers; the medians and quartiles
of each side's ms/spp close the output.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import re
import statistics
import subprocess
import sys
import traceback

RENDERS, RENDER_SPP, FRAME = 4, 4, (1920, 1080)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def child(tree: str, timer: str) -> None:
    """The lambert phase of ``tree``'s ``chip_smoke.py`` with its own
    package, K2 ``full`` timed by ``timer``'s ``kernel_ms``."""
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    c = _load("chip_smoke", os.path.join(tree, "chip_smoke.py"))
    new = _load("chip_smoke_timer", timer)
    from metal_pathtracer_tpu_torch.ops.kernels import build
    from metal_pathtracer_tpu_torch.ops.kernels import shade as S
    from metal_pathtracer_tpu_torch.ops.kernels import traverse as T
    from metal_pathtracer_tpu_torch.renderer.headless import CudaBackend
    from metal_pathtracer_tpu_torch.utils.benchscene import (
        build_lambert_series,
    )
    print("# tree", tree, "package", os.path.dirname(build.__file__),
          flush=True)
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--order", default="pccppc",
                    help="p (parent) and c (change), one process each")
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        try:
            child(os.path.abspath(sys.argv[2]), os.path.abspath(sys.argv[3]))
        except Exception:
            traceback.print_exc()
            sys.exit(1)
        return
    args = ap.parse_args()
    trees = {"p": ("parent", os.path.abspath(args.parent)),
             "c": ("change", os.path.abspath(args.change))}
    timer = os.path.join(trees["c"][1], "chip_smoke.py")
    spp = {"parent": [], "change": []}
    failed = False
    for key in args.order:
        who, tree = trees[key]
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree,
             timer], capture_output=True, text=True)
        for line in (run.stdout + run.stderr).splitlines():
            if re.search(r"^(AB|lambert|# tree)|Error|Traceback", line):
                print(f"[{who}] {line}", flush=True)
            m = re.search(r"([\d.]+) ms/spp", line)
            if m and line.startswith(("AB lambert", "lambert")):
                spp[who].append(float(m.group(1)))
        print(f"[{who}] rc={run.returncode}", flush=True)
        failed |= run.returncode != 0
    for who, values in spp.items():
        if len(values) >= 2:
            q = statistics.quantiles(values, n=4)
            print(f"AB {who}: {len(values)} renders, median "
                  f"{statistics.median(values):.2f} ms/spp, quartiles "
                  f"{q[0]:.2f}-{q[2]:.2f}")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
