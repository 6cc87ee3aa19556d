"""The plain reference against the port's CPU path (its plain
versions): a toy run of the cell's job decides ``correct``, most pixels
agreeing to rounding; the reference's own camera and material rows
against the port's; the reference imports nothing of the program."""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest

from portbench import cells, run, scenegen
from portbench.reference import oracle

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(name, toy_cell):
    cell = toy_cell(name)
    result = run.run_cell(cell, 2 ** 31 + 12345, 0.01, False, "cpu")
    assert result["correct"], result["checks"]
    checks = result["checks"]
    assert checks["samples_gap"]["value"] == 0.0
    assert checks["radiance_rel_p50"]["value"] < 1e-5
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}


def test_camera_equals_the_port_camera():
    from metal_pathtracer_tpu_torch.ops.camera import build_camera

    spec = scenegen.build_spec(cells.load_json(cells.config_path("rtow")))
    settings, _ = scenegen.apply(spec, {"max_depth": 50, "width": 1280,
                                        "height": 720}, 1, _api())
    cam = build_camera(settings, 1280, 720, device="cpu")
    want = np.concatenate([cam.origin, cam.lower_left, cam.horizontal,
                           cam.vertical, cam.u, cam.v,
                           [float(cam.lens_radius)]])
    np.testing.assert_allclose(oracle.camera(spec.settings, 1280, 720),
                               want, rtol=1e-6, atol=1e-6)


def test_material_rows_equal_the_port_packing():
    from metal_pathtracer_tpu_torch.renderer.oracle import pack_materials

    spec = scenegen.build_spec(cells.load_json(cells.config_path("rtow")))
    _, res = scenegen.apply(spec, {"max_depth": 50, "width": 8,
                                   "height": 8}, 1, _api())
    want = pack_materials(res)
    rows, sigma = oracle.material_rows(spec.materials)
    # base colour, roughness, type, IOR, thin; the absorption
    np.testing.assert_array_equal(rows[:, :7], want[:, :7])
    np.testing.assert_array_equal(sigma, want[:, 18:21])
    # no complex IOR: a metal takes its base colour as F0
    assert not want[:, 11:18].any()


def _api():
    from portbench import jobs

    return jobs.port_api()


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; import portbench.reference.oracle, "
            "portbench.check, portbench.scenegen, "
            "portbench.scenes.rtow_procedural; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = eval(out)
    for name in ("metal_pathtracer_tpu_torch", "metal_pathtracer_tpu",
                 "jax", "jaxlib", "flax"):
        assert name not in loaded
