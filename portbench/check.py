"""How ``correct`` is decided: what the timed path produced against the
plain reference (``portbench/reference``).

The answers are pixels. Once the window has closed, ``check_pixels``
pixels drawn from the seed are read from the state the window
accumulated; the reference renders every sample the harness asked for at
each of them (0 .. n - 1, the warm-up's included, seeded by the upstream
recipe from the seed, the sample and the pixel) and sums them in order.
Where the program's float rounding and the reference's part a sample's
path (a grazing hit, a Fresnel or roulette draw on the edge), that
sample differs; elsewhere the two agree to a few units in the last
place.

The numbers compared, each with its limit in the traffic file:

- ``samples_gap``: the largest difference between a sampled pixel's
  sample count, or the state's frame index, and the samples a pixel the
  harness asked for (exact: limit 0);
- ``radiance_rel_p50`` and ``radiance_rel_p90``: the median and the 90th
  percentile over the sampled pixels of the largest channel's gap
  between the program's radiance sum and the reference's, relative to
  the reference's brightest channel of that pixel (floored at 1e-3 a
  sample);
- ``radiance_bias``: the gap between the program's and the reference's
  radiance summed over every sampled pixel and channel, relative to the
  reference's sum;
- a displayed job: ``ldr_off_share``, the share of the sampled pixels
  whose uint8 image differs by more than 1 in any channel from the
  reference's display of its own sums (``reference/display.py``).
"""

from __future__ import annotations

import numpy as np
import torch


def sample_pixels(seed: int, width: int, height: int, count: int) -> np.ndarray:
    """``count`` distinct flat pixel indices drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed & 0x7FFFFFFFFFFFFFFF)
    return torch.randperm(width * height, generator=g)[:count].numpy()


def pixel_gaps(program: np.ndarray, reference: np.ndarray,
               samples: int) -> np.ndarray:
    """Each pixel's largest channel gap relative to its brightest
    reference channel (floored at 1e-3 a sample)."""
    reference = reference.astype(np.float64)
    scale = np.maximum(np.abs(reference).max(-1), 1e-3 * max(samples, 1))
    return np.abs(program.astype(np.float64) - reference).max(-1) / scale


def render_numbers(out, ref_sums: np.ndarray) -> dict:
    """Every number compared for ``out`` (``jobs.Outputs``) against the
    reference's sums at its pixels."""
    counts = np.append(out.sample_count.astype(np.int64), out.frame_index)
    result = {"samples_gap": float(np.abs(counts - out.requested).max())}
    if not np.isfinite(out.radiance_sum).all():
        return dict(result, radiance_rel_p50=float("inf"),
                    radiance_rel_p90=float("inf"),
                    radiance_bias=float("inf"))
    gaps = pixel_gaps(out.radiance_sum, ref_sums, out.requested)
    ref_total = float(ref_sums.astype(np.float64).sum())
    return dict(
        result,
        radiance_rel_p50=float(np.percentile(gaps, 50)),
        radiance_rel_p90=float(np.percentile(gaps, 90)),
        radiance_bias=abs(float(out.radiance_sum.astype(np.float64).sum())
                          - ref_total) / max(ref_total, 1e-30))


def numbers(ref, out, control: bool = False) -> dict:
    """Every number compared for ``out`` against ``ref`` (a
    ``reference.oracle.Reference`` under the run's seed); with
    ``control`` the reference with its path state in bfloat16 stands in
    the program's place."""
    from portbench.reference.display import display_u8

    sums = ref.radiance_sums(out.pixels, out.requested)
    settings = ref.spec.settings
    if control:
        low = ref.radiance_sums(out.pixels, out.requested, control=True)
        image = None if out.image is None else display_u8(
            low, out.requested, settings)
        out = type(out)(out.pixels, low,
                        np.full(len(out.pixels), out.requested),
                        out.requested, out.requested, image)
    result = render_numbers(out, sums)
    if out.image is not None:
        want = display_u8(sums, out.requested, settings)
        d = np.abs(out.image.astype(np.int16) - want.astype(np.int16))
        result["ldr_off_share"] = float((d.max(-1) > 1).mean())
    return result


def reference_numbers(spec, traffic: dict, seed: int, out) -> dict:
    """Every number compared for ``out`` against the reference built for
    ``spec``, ``traffic`` and ``seed``."""
    from portbench.reference.oracle import Reference

    return numbers(Reference(spec, traffic, seed), out)


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): every number at or under its limit; ``checks``
    maps each name to its value and limit."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
