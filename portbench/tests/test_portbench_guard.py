"""A run without a card fails and prints no result; JAX or the JAX
package loaded in the run's process (compared by whole top-level name)
fails it; a directory holding only BENCHMARK.json and the benchmark's
files fails."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import types

import pytest

from portbench import cells, run


def _main(args, tmp_path):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", *args], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                 PYTHONPATH=str(tmp_path)))


def _checkout(tmp_path, with_program: bool):
    shutil.copy(cells.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(cells.PKG_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_build",
                                                  "_cache"))
    if with_program:
        shutil.copytree(os.path.join(cells.ROOT,
                                     "metal_pathtracer_tpu_torch"),
                        tmp_path / "metal_pathtracer_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__",
                                                      "_build"))


@pytest.mark.parametrize("with_program", [True, False])
def test_no_card_no_result(tmp_path, with_program):
    _checkout(tmp_path, with_program)
    p = _main(["--workload", "rtow-offline", "--seed", "7",
               "--seconds", "1", "--trace", "0"], tmp_path)
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_forbidden_modules_by_whole_name(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "metal_pathtracer_tpu_torch_extra",
                        types.ModuleType("metal_pathtracer_tpu_torch_extra"))
    assert run.forbidden_modules() == []
    run._guard()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax"))
    assert run.forbidden_modules() == ["jax"]
    with pytest.raises(run.Refused):
        run._guard()


def test_a_forbidden_module_refuses_the_run(monkeypatch, toy_cell, capsys):
    cell = toy_cell("rtow-offline")
    monkeypatch.setitem(sys.modules, "metal_pathtracer_tpu",
                        types.ModuleType("metal_pathtracer_tpu"))
    monkeypatch.setattr(run.cells, "load_cell", lambda name: cell)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: run._guard())
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "card_line", lambda d: {})
    assert run.main(["--workload", "x", "--seed", "1", "--seconds", "1"]) == 2
    assert not capsys.readouterr().out.strip()
