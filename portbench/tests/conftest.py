"""Shared fixtures of the harness's tests: cells cut to a toy size that
the CPU renders in seconds (the port's plain versions on the CPU)."""

from __future__ import annotations

import copy

import pytest

from portbench import cells


def toy(cell: cells.Cell, width: int = 32, height: int = 18,
        depth: int = 8, spp: int = 2) -> cells.Cell:
    """``cell`` with its job at ``width`` x ``height``, ``depth``, ``spp``
    a batch, 64 checked pixels and one profiled unit; the scene kept."""
    cell = copy.deepcopy(cell)
    cell.traffic.update(width=width, height=height, max_depth=depth,
                        batch_spp=spp, check_pixels=64, profile_units=1)
    return cell


@pytest.fixture
def toy_cell():
    return lambda name, **kw: toy(cells.load_cell(name), **kw)


@pytest.fixture(autouse=True)
def _few_threads():
    """The reference's and torch's threads kept to a few."""
    import torch

    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)
