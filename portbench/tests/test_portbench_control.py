"""``correct`` comes out false for the control and for each fault the
cell can have, the timed path broken underneath a toy run on the CPU
(the harness's look for a card skipped):

- the control: the reference with its path state rounded to bfloat16
  after every depth, the nearest precision below the configuration's
  float32, in the program's place;
- a step that returns its state unchanged;
- half of each batch's lanes left out, the rest counted twice (the mean
  over the rest);
- a sample altered where it is produced (scaled by 1 + 2^-5).

There is no exchange between chips in a one-card cell."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from unittest import mock

from portbench import cells, check, jobs, run, scenegen
from metal_pathtracer_tpu_torch.ops import integrator
from metal_pathtracer_tpu_torch.renderer import frame

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, toy_cell):
    cell = toy_cell(name, spp=4)
    spec = scenegen.build_spec(cell.config)
    job = jobs.JOBS[cell.traffic["mode"]](spec, cell.traffic, 99, "cpu")
    job.warm()
    job.step()
    pix = check.sample_pixels(99, job.width, job.height, 64)
    out = job.outputs(pix)
    sound = check.reference_numbers(spec, cell.traffic, 99, out)
    assert check.judge(sound, cell.traffic["limits"])[0], sound
    from portbench.reference.oracle import Reference

    low = check.numbers(Reference(spec, cell.traffic, 99), out, control=True)
    ok, checks = check.judge(low, cell.traffic["limits"])
    assert not ok, checks


def _unchanged(scene, uniforms, state, static, n, chunk=None):
    return state


_integrate = integrator.integrate_pixels


def _half(*a, **k):
    sample, albedo, normal, stats = _integrate(*a, **k)
    kept = torch.zeros_like(sample)
    kept[0::2] = 2.0 * sample[0::2]
    return kept, albedo, normal, stats


def _altered(*a, **k):
    sample, albedo, normal, stats = _integrate(*a, **k)
    return sample * (1.0 + 2.0 ** -5), albedo, normal, stats


FAULTS = {
    "unchanged": (frame, "render_samples", _unchanged),
    "half_batch": (integrator, "integrate_pixels", _half),
    "altered_sample": (integrator, "integrate_pixels", _altered),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, toy_cell):
    cell = toy_cell(name, spp=4)
    module, attr, broken = FAULTS[fault]
    with mock.patch.object(module, attr, broken):
        result = run.run_cell(cell, 4321, 0.01, False, "cpu")
    assert not result["correct"], result["checks"]
    assert np.isfinite(result["checks"]["samples_gap"]["value"])
