"""Instanced scenes on the oracle backend (``native/cpu_oracle.cpp``, which
bakes every placement into world space):

- ``render_oracle`` of the port bit for bit equal to the JAX wrapper's on
  ``tests/test_instancing.py test_instanced_matches_oracle``'s scene (the
  blob placed three times): both wrappers hand the library their baked
  triangles, so equal images mean equal baked arrays; and the port's
  ``baked_meshes`` against the JAX wrapper's float64 formula directly;
- the port's plain path against the oracle on the same scene at that
  test's size (40x24, 32 spp), held to the JAX render's own gap to the
  oracle (its RMSE and mean difference, plus the port's distance to the
  JAX render), not to that test's loose RMSE < 0.01.

One JAX integrator call; ~60 s.
"""

import os
import sys

import numpy as np
import pytest
import torch

from metal_pathtracer_tpu.ops.camera import build_camera as jax_camera
from metal_pathtracer_tpu.renderer import frame as jax_frame
from metal_pathtracer_tpu.renderer import oracle as jax_oracle
from metal_pathtracer_tpu.renderer.accumulation import RenderState as JState
from metal_pathtracer_tpu.schema import settings_to_static as jax_static
from metal_pathtracer_tpu.schema import settings_to_uniforms as jax_uniforms
from metal_pathtracer_tpu_torch.renderer import oracle
from metal_pathtracer_tpu_torch.renderer.headless import make_backend

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_instanced_render import _blob_scene  # noqa: E402

W, H, SPP = 40, 24, 32


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def scene():
    assert oracle.oracle_available(), "native/build.sh failed"
    (ps, pr), (js, jr) = _blob_scene()
    for s in (ps, js):
        s.maxDepth = 4
    return ps, pr, js, jr


def test_baked_oracle_inputs_bit_equal(scene):
    ps, pr, js, jr = scene
    baked = oracle.baked_meshes(pr)
    assert len(baked) == 3 and not pr.meshes
    for mesh, inst in zip(baked, jr.mesh_instances):
        m44 = np.asarray(inst.transform, np.float64)
        want = ((inst.source.vertices @ m44[:3, :3].T)
                + m44[:3, 3]).astype(np.float32)
        np.testing.assert_array_equal(mesh.vertices.view(np.int32),
                                      want.view(np.int32))
        assert mesh.material == inst.material
    got = oracle.render_oracle(pr, ps, W, H, 4)
    want = jax_oracle.render_oracle(jr, js, W, H, 4)
    assert np.isfinite(got).all() and got.max() > 0.0
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_plain_path_within_the_jax_gap_to_the_oracle(scene):
    ps, pr, js, jr = scene
    ref = make_backend("oracle").render(pr, ps, W, H, SPP).linear_rgb[..., :3]
    port = make_backend("cpu-torch").render(pr, ps, W, H,
                                            SPP).linear_rgb[..., :3]
    st = jax_frame.render_samples(
        jr.build_arrays(), jax_uniforms(js, jax_camera(js, W, H), 0, 0),
        JState.create(W, H),
        jax_static(js, W, H, jr.material_types_present()), SPP)
    jimg = np.asarray(st.present())[..., :3]
    port_gap, jax_gap = oracle.rmse(port, ref), oracle.rmse(jimg, ref)
    to_jax = oracle.rmse(port, jimg)
    assert to_jax < 2e-4, to_jax
    assert port_gap <= jax_gap + to_jax, (port_gap, jax_gap, to_jax)
    assert abs(port.mean() - ref.mean()) <= \
        abs(jimg.mean() - ref.mean()) + to_jax
    assert jax_gap < 0.01 and port.mean() > 0.05
