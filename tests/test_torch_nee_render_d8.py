"""The port's environment-NEE render against the JAX package's at the
bench's maxDepth 8, where Russian roulette runs from depth 5 on (the
maxDepth 5 twin in ``test_torch_nee_render.py`` never reaches it): the
same untextured headline at subdivisions 3, 40x24, 2 spp, under the same
gate, with the JAX render in a file of its own."""

import pytest
import torch

from test_torch_nee_render import assert_counters, assert_matches_jax
from test_torch_nee_render import render_pair


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module", params=[8])
def renders(request):
    return render_pair(request.param)


def test_nee_render_matches_jax(renders):
    assert_matches_jax(renders)


def test_nee_render_counters(renders):
    assert_counters(renders)
