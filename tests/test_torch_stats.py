"""K1's counting mode (plain walk) and the port's ``utils/stats``:

- the plain walk's four counters against totals counted by hand on a
  three-node tree (a root and two leaves), closest-hit and any-hit;
- the counting wrappers return the counter-free outputs bit for bit;
- ``traversal_profile`` against the JAX package's on 512 rays into an
  80-triangle icosphere. The JAX side runs its Pallas packet kernel in
  interpret mode (``MPT_TRACE_INTERPRET``), as ``test_packet_trace.py``
  does; that interpret compile alone takes ~75-90 s on a CPU whatever the
  input size (80 or 320 triangles, 256 or 512 rays: measured), so this
  file makes one such call (closest-hit), not two. The packet tree is not
  the port's exit-link tree and in interpret mode the JAX test holds t to
  rtol 1e-3 only, so: ``hit_pct`` equal, each ``hit_t_histogram`` bin
  within 1 count, ``hit_t_range`` within 1e-3 relative. ``rays`` and the
  hit flags (closest-hit and any-hit) equal the JAX XLA trace
  (``traversal.trace_triangles``) exactly;
- ``PerformanceStats`` and the tagged logger, ``tests/test_stats.py``'s
  cases on the port.
"""

import dataclasses
import logging
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from metal_pathtracer_tpu.ops import traversal as jax_traversal
from metal_pathtracer_tpu.scene.resources import Material as JMaterial
from metal_pathtracer_tpu.scene.resources import SceneResources as JResources
from metal_pathtracer_tpu.utils.procgen import dragon_class_scene_mesh
from metal_pathtracer_tpu_torch.ops.kernels import traverse
from metal_pathtracer_tpu_torch.scene.resources import (
    Material,
    Mesh,
    SceneResources,
)
from metal_pathtracer_tpu_torch.schema import BvhSoA
from metal_pathtracer_tpu_torch.utils import stats

N_RAYS = 512
T_MIN, T_MAX = 1e-3, 3.0e38


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _hand_tree():
    """A root over two leaves of one triangle each (x < 0 and x > 0 in the
    z = 0 plane), boxes 0.2 thick in z, and five rays: down onto the left
    triangle, down onto the right one, along +x through both leaf boxes
    (parallel to both triangles), one past the root box, one dead."""
    f = lambda x: torch.tensor(x, dtype=torch.float32)
    i = lambda x: torch.tensor(x, dtype=torch.int32)
    bvh = BvhSoA(bounds_min=f([[-1.5, -1, -.1], [-1.5, -1, -.1],
                               [.5, -1, -.1]]),
                 bounds_max=f([[1.5, 1, .1], [-.5, 1, .1], [1.5, 1, .1]]),
                 prim_offset=i([0, 0, 1]), prim_count=i([0, 1, 1]),
                 exit_index=i([3, 2, 3]), prim_indices=i([0, 1]))
    tris = SimpleNamespace(v0=f([[-1.5, -1, 0], [.5, -1, 0]]),
                           v1=f([[-.5, -1, 0], [1.5, -1, 0]]),
                           v2=f([[-1, 1, 0], [1, 1, 0]]),
                           mesh_index=i([0, 0]))
    o = f([[-1, 0, 2], [1, 0, 2], [-3, 0, 0], [5, 5, 5], [0, 0, 2]])
    d = f([[0, 0, -1], [0, 0, -1], [1, 0, 0], [0, 0, 1], [0, 0, -1]])
    tmax = f([1e20, 1e20, 1e20, 1e20, 0.0])
    return bvh, tris, o, d, tmax


def test_plain_walk_counts_by_hand():
    """Closest-hit: left ray root + left (hit) + right (fails): 3 nodes,
    1 leaf, 1 test; right ray 3 nodes (left fails), 1 leaf, 1 test, not
    "both" (its sibling failed just before); the +x ray 3 nodes, 2
    leaves, 2 tests, both children passed; the ray past the root 1 node;
    the dead ray nothing. Any-hit: the left ray stops at its hit (2
    nodes)."""
    bvh, tris, o, d, tmax = _hand_tree()
    assert bvh.left_sibling().tolist() == [-1, -1, 1]
    t, tri, _, _, totals = traverse.trace_closest_stats(o, d, 1e-3, tmax,
                                                        bvh, tris)
    assert tri.tolist() == [0, 1, -1, -1, -1]
    assert dict(zip(traverse.STATS_KEYS, totals.tolist())) == {
        "nodes_visited": 10, "leaf_chunks_tested": 4,
        "both_children_visited": 1, "leaf_prim_tests": 4}
    occ, totals = traverse.trace_any_stats(o, d, 1e-3, tmax, bvh, tris)
    assert occ.tolist() == [True, True, False, False, False]
    assert totals.tolist() == [9, 4, 1, 4]


@pytest.fixture(scope="module")
def case():
    """The icosphere in both packages (bit-identical soups), 512 rays from
    (0, 0, 4) toward Gaussian targets, the JAX XLA trace's hit flags and
    the JAX traversal profile (its packet kernel in interpret mode)."""
    jm = dragon_class_scene_mesh(1, material=0)
    jr, pr = JResources(), SceneResources()
    jr.add_material(JMaterial())
    pr.add_material(Material())
    jr.add_mesh(jm)
    pr.add_mesh(Mesh(**{f.name: getattr(jm, f.name)
                        for f in dataclasses.fields(Mesh)}))
    js, ps = jr.build_arrays(), pr.build_arrays(device="cpu")
    rng = np.random.default_rng(2)
    o = np.tile(np.array([0.0, 0.0, 4.0], np.float32), (N_RAYS, 1))
    d = rng.normal(scale=0.6, size=(N_RAYS, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    rec = jax.jit(lambda o, d: jax_traversal.trace_triangles(
        o, d, js, T_MIN, np.full(N_RAYS, T_MAX, np.float32)))(o, d)
    return dict(js=js, ps=ps, o=o, d=d, hits=np.asarray(rec.hit))


@pytest.fixture(scope="module")
def jax_profile(case):
    import os

    from metal_pathtracer_tpu.scene.packetbvh import build_packet_bvh
    from metal_pathtracer_tpu.utils.stats import traversal_profile

    tri = case["js"].triangles
    bvh = build_packet_bvh(*(np.asarray(v) for v in (tri.v0, tri.v1,
                                                     tri.v2)))
    old = os.environ.get("MPT_TRACE_INTERPRET")
    os.environ["MPT_TRACE_INTERPRET"] = "1"
    try:
        out = traversal_profile(jax.numpy.asarray(case["o"]),
                                jax.numpy.asarray(case["d"]), bvh,
                                T_MIN, T_MAX)
    finally:
        if old is None:
            del os.environ["MPT_TRACE_INTERPRET"]
        else:
            os.environ["MPT_TRACE_INTERPRET"] = old
    jax.clear_caches()
    return out


def _port_profile(case, any_hit):
    ps = case["ps"]
    return stats.traversal_profile(torch.from_numpy(case["o"]),
                                   torch.from_numpy(case["d"]), ps.tri_bvh,
                                   ps.triangles, T_MIN, T_MAX,
                                   any_hit=any_hit)


def test_counting_outputs_equal_counter_free(case):
    ps = case["ps"]
    o, d = torch.from_numpy(case["o"]), torch.from_numpy(case["d"])
    plain = traverse.trace_closest(o, d, T_MIN, T_MAX, ps.tri_bvh,
                                   ps.triangles)
    counted = traverse.trace_closest_stats(o, d, T_MIN, T_MAX, ps.tri_bvh,
                                           ps.triangles)
    for a, b in zip(plain, counted[:4]):
        assert torch.equal(a, b)
    occ = traverse.trace_any(o, d, T_MIN, T_MAX, ps.tri_bvh, ps.triangles)
    occ_s, totals = traverse.trace_any_stats(o, d, T_MIN, T_MAX, ps.tri_bvh,
                                             ps.triangles)
    assert torch.equal(occ, occ_s)
    assert torch.equal(occ, plain[1] >= 0)
    # the any-hit walk stops at each ray's first hit: never more work
    assert (totals <= counted[4]).all() and (totals > 0).all()


def test_traversal_profile_matches_jax(case, jax_profile):
    got = _port_profile(case, False)
    assert set(got) == set(jax_profile)
    assert got["rays"] == jax_profile["rays"] == N_RAYS
    assert got["hit_pct"] == jax_profile["hit_pct"] \
        == 100.0 * case["hits"].mean()
    hist, ref = np.array(got["hit_t_histogram"]), \
        np.array(jax_profile["hit_t_histogram"])
    assert hist.sum() == ref.sum() == case["hits"].sum()
    assert np.abs(hist - ref).max() <= 1, (hist, ref)
    np.testing.assert_allclose(got["hit_t_range"], jax_profile["hit_t_range"],
                               rtol=1e-3)
    assert 0.0 < got["both_children_visited_pct"] < 100.0
    assert got["nodes_per_ray"] >= 1.0
    assert got["leaf_prim_tests_per_ray"] >= got["leaf_chunks_per_ray"] > 0.0


def test_traversal_profile_any_hit(case):
    """Any-hit: the hit flags are the closest-hit trace's, so ``hit_pct``
    and ``shadow_early_exit_pct`` equal the JAX XLA trace's hit share;
    stopping at the first hit walks no more nodes than the closest-hit
    walk."""
    got = _port_profile(case, True)
    closest = _port_profile(case, False)
    share = 100.0 * case["hits"].mean()
    assert got["hit_pct"] == got["shadow_early_exit_pct"] == share
    assert "hit_t_histogram" not in got
    assert got["nodes_per_ray"] <= closest["nodes_per_ray"]
    assert got["packets"] == closest["packets"] == N_RAYS // 32


def test_perf_stats_derivations():
    p = stats.PerformanceStats()
    # one batch: 4 spp over a 10x10 image in 2 s, 1000 scene + 500 shadow
    p.update(samples=4, seconds=2.0, width=10, height=10,
             ray_count=1000.0, shadow_ray_count=500.0)
    assert p.total_samples == 4
    assert p.samples_per_minute == 120.0
    assert abs(p.mrays_per_second - 1500.0 / 2.0 / 1e6) < 1e-12
    assert abs(p.rays_per_sample - 1500.0 / (4 * 100)) < 1e-12
    assert abs(p.shadow_ray_fraction - 1.0 / 3.0) < 1e-12
    # the counters are cumulative: only their deltas count
    p.update(samples=4, seconds=2.0, width=10, height=10,
             ray_count=1800.0, shadow_ray_count=700.0)
    assert p.total_samples == 8
    assert abs(p.rays_per_sample - 1000.0 / 400) < 1e-12
    assert "spp" in p.summary() and "Mrays/s" in p.summary()


def test_perf_stats_ignores_empty_batch():
    p = stats.PerformanceStats()
    p.update(samples=0, seconds=0.0, width=8, height=8)
    assert p.total_samples == 0


def test_tagged_logger(capsys):
    log = stats.get_logger("Timing")
    stats.set_verbose(False)
    log.info("hello %d", 7)
    out = capsys.readouterr().out
    assert "[Timing] hello 7" in out
    log.debug("quiet")
    assert "quiet" not in capsys.readouterr().out
    stats.set_verbose(True)
    log.debug("loud")
    assert "[Timing] loud" in capsys.readouterr().out
    stats.set_verbose(False)


def test_logger_tags_are_per_adapter(capsys):
    a = stats.get_logger("Output")
    b = stats.get_logger("Renderer")
    a.info("one")
    b.info("two")
    out = capsys.readouterr().out
    assert "[Output] one" in out and "[Renderer] two" in out
    # the port's own logger root, beside the JAX package's
    assert logging.getLogger("metal_pathtracer_tpu_torch").handlers
