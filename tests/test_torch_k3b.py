"""K3b's near-first visit order and shrinking window, on the CPU.

The kernel (``csrc/primitives.cu sphere_nearest_chunked_kernel``) tests
the Morton groups nearest entry first and drops a group once its box entry
lies past the best t so far; it takes a candidate when (t, slot) is
lexicographically below the best. Two properties make it return the
plain version's bits (``sphere_nearest_chunked_reference``: the groups in
Morton order, strictly nearer across groups, the first of smallest t in a
group):

- the widening of the group boxes (``sphere_groups``): wherever a sphere's
  computed root t_s lies in [t_min, w], its group passes the slab test
  against [t_min, w] (so the cull drops no sphere that could win or tie);
- the tie rule: the lexicographic (t, slot) minimum is the same whatever
  the visit order. ``visits_model``, the kernel's schedule in plain
  PyTorch under any group priority, is run over reversed and shuffled
  priorities, near first and in plain priority order, on rtow's rays and
  on a scene with two identical spheres in different groups (an exact
  tie); at its default it is ``primitives.sphere_nearest_visits``.

rtow (``benchscene.build_rtow_scene(0)``: 487 spheres, 31 groups) at
120x68: its camera rays and the wavefront after one plain K2 ``full``
bounce, every 13th lane dead. No JAX call.
"""

import dataclasses

import numpy as np
import pytest
import torch

from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops import camera as camera_ops
from metal_pathtracer_tpu_torch.ops import rng as rng_ops
from metal_pathtracer_tpu_torch.ops.camera import build_camera
from metal_pathtracer_tpu_torch.ops.kernels import primitives as P
from metal_pathtracer_tpu_torch.ops.kernels import shade
from metal_pathtracer_tpu_torch.ops.integrator import PathCarry
from metal_pathtracer_tpu_torch.constants import INFINITY_T
from metal_pathtracer_tpu_torch.schema import (
    SphereGroups,
    SpheresSoA,
    settings_to_static,
    settings_to_uniforms,
)
from metal_pathtracer_tpu_torch.utils import benchscene as B

W, H = 120, 68


def rtow_waves(dev, w, h):
    """rtow's groups and its depth-0 and depth-1 wavefronts at w x h on
    ``dev`` (the bounce through ``shade_full``), every 13th lane dead:
    (groups, {name: (origin, direction, t_max)})."""
    settings, res = B.build_rtow_scene(0)
    scene = res.build_arrays(device=dev)
    static = settings_to_static(settings, w, h, res.material_types_present())
    uni = settings_to_uniforms(settings, build_camera(settings, w, h, dev),
                               0, 0)
    flat = torch.arange(w * h, device=dev)
    xs, ys = flat % w, flat // w
    seed = rng_ops.make_seed(uni.fixed_rng_seed, 0, xs, ys, 0,
                             torch.zeros_like(xs))
    state, o, d = camera_ops.generate_primary_rays(uni.camera, xs, ys, w, h,
                                                   seed)
    carry = PathCarry.start(state, o, d, 1e-3, 0.0)
    carry.alive[::13] = False
    waves = {}
    for depth in (0, 1):
        waves[f"depth {depth}"] = (
            carry.ray_o.clone(), carry.ray_d.clone(),
            torch.where(carry.alive, C.INFINITY_T, 0.0))
        if depth == 0:
            t, idx, u, v, kind = shade._trace(scene, carry)
            shade.shade_full(carry, t, idx, u, v, scene.triangles,
                             scene.materials,
                             shade.ShadeParams.of(uni, static), 0,
                             kind=kind, scene=scene)
    return scene.sphere_groups, waves


@pytest.fixture(scope="module")
def rtow():
    torch.set_num_threads(1)
    return rtow_waves("cpu", W, H)


def _bits(x):
    return x.view(torch.int32)


def visits_model(origin, direction, t_min, t_max, groups, rank=None,
                 near_first=True, stats=None):
    """K3b's schedule (``primitives.sphere_nearest_visits``) under any
    group priority: every box slab-tested once against [t_min, t_max];
    then, until none is pending, the pending group of least entry tnear
    (``near_first``; the lowest ``rank`` on a tie; without ``near_first``,
    the next in ``rank`` order) is tested, and groups whose tnear exceeds
    the window [t_min, w] are dropped, w the best t so far. A candidate is
    taken when (t, slot) is lexicographically below the best. ``rank``:
    each group's priority (default: its position). ``stats`` receives
    ``group_visits`` and ``sphere_tests``."""
    n, n_groups = origin.shape[0], groups.n_groups
    rank = torch.arange(n_groups) if rank is None else torch.as_tensor(rank)
    by_rank = torch.argsort(rank)           # groups in priority order
    inv = P.slab_inverse(direction)
    entry = torch.empty((n, n_groups))
    pending = torch.empty((n, n_groups), dtype=torch.bool)
    for col, g in enumerate(by_rank.tolist()):
        tnear, tfar = P.group_entry(origin, inv, t_min, t_max,
                                    groups.box_min[g], groups.box_max[g])
        entry[:, col], pending[:, col] = tnear, tfar >= tnear
    pending &= (t_max >= t_min)[:, None]
    center = groups.center.view(n_groups, P.SPHERE_GROUP, 3)
    radius = groups.radius.view(n_groups, P.SPHERE_GROUP)
    lanes = torch.arange(n)
    best_t = torch.full((n,), INFINITY_T)
    best_s = torch.full((n,), -1, dtype=torch.int64)
    visits = 0
    while True:
        w = torch.where(best_s >= 0, best_t, t_max)
        pending &= entry <= w[:, None]
        go = pending.any(1)
        if not bool(go.any()):
            break
        visits += int(go.sum())
        key = torch.where(pending, entry, float("inf")) if near_first \
            else (~pending).to(torch.int8)
        col = torch.argmin(key, 1)          # the first of least key
        pending[lanes, col] = False
        g = by_rank[col]
        t, valid = P.sphere_roots(origin, direction, center[g], radius[g],
                                  t_min, t_max)
        valid &= go[:, None]
        tg, j = P._nearest(t, valid)
        slot = g * P.SPHERE_GROUP + j.long()
        take = (j >= 0) & ((best_s < 0) | (tg < best_t)
                           | ((tg == best_t) & (slot < best_s)))
        best_t = torch.where(take, tg, best_t)
        best_s = torch.where(take, slot, best_s)
    if stats is not None:
        stats["group_visits"] = visits
        stats["sphere_tests"] = visits * P.SPHERE_GROUP
    return (torch.where(best_s >= 0, best_t, INFINITY_T),
            torch.where(best_s >= 0,
                        groups.index[best_s.clamp_min(0)], -1).to(torch.int32))


def groups_in_order(spheres, order):
    """A K3b layout whose group g holds the spheres ``order[16g:16g+16]``,
    each group built by ``primitives.sphere_groups`` from its own spheres
    (so its box is widened as the scene's are)."""
    parts = []
    for k in range(0, len(order), P.SPHERE_GROUP):
        idx = torch.as_tensor(order[k:k + P.SPHERE_GROUP])
        part = P.sphere_groups(SpheresSoA(center=spheres.center[idx],
                                          radius=spheres.radius[idx],
                                          material=spheres.material[idx]))
        parts.append(dataclasses.replace(
            part, index=idx[part.index.long()].to(torch.int32)))
    return SphereGroups(**{f.name: torch.cat([getattr(x, f.name)
                                              for x in parts])
                           for f in dataclasses.fields(SphereGroups)})


@pytest.mark.parametrize("wave", ["depth 0", "depth 1"])
def test_group_boxes_hold_every_root(rtow, wave):
    """For every lane, sphere slot and window [t_min, w] with the slot's
    root t_s <= w (w = t_s, a seeded w between t_s and t_max, and t_max),
    the slot's group passes the slab test against [t_min, w]."""
    groups, waves = rtow
    o, d, tmax = waves[wave]
    inv = P.slab_inverse(d)
    rng = np.random.default_rng(11)
    checked = 0
    for g in range(groups.n_groups):
        sl = slice(g * P.SPHERE_GROUP, (g + 1) * P.SPHERE_GROUP)
        t, valid = P.sphere_roots(o, d, groups.center[sl], groups.radius[sl],
                                  C.EPSILON_T, tmax)
        for j in range(P.SPHERE_GROUP):
            lanes = valid[:, j]
            if not bool(lanes.any()):
                continue
            ts = t[lanes, j]
            mid = ts + torch.from_numpy(rng.uniform(
                0.0, 1.0, ts.shape[0]).astype(np.float32)) \
                * (tmax[lanes] - ts)
            for w in (ts, torch.maximum(mid, ts), tmax[lanes]):
                ok = P.group_passes(o[lanes], inv[lanes], C.EPSILON_T, w,
                                    groups.box_min[g], groups.box_max[g])
                assert bool(ok.all()), (g, j)
            checked += int(lanes.sum())
    assert checked > 1000


ORDERS = {"morton": lambda n: None,
          "reversed": lambda n: np.arange(n)[::-1].copy(),
          "shuffled": lambda n: np.random.default_rng(5).permutation(n)}


@pytest.mark.parametrize("near_first", [True, False])
@pytest.mark.parametrize("order", sorted(ORDERS))
def test_visit_order_gives_plain_bits(rtow, order, near_first):
    """The kernel's schedule under any group priority, near first or not,
    returns the plain version's t bit for bit and its index on both
    wavefronts; near first visits fewer groups than the plain version's
    cull tests."""
    groups, waves = rtow
    for o, d, tmax in waves.values():
        args = (o, d, C.EPSILON_T, tmax, groups)
        ref_stats, stats = {}, {}
        want = P.sphere_nearest_chunked_reference(*args, stats=ref_stats)
        got = visits_model(*args, rank=ORDERS[order](groups.n_groups),
                           near_first=near_first, stats=stats)
        assert torch.equal(_bits(got[0]), _bits(want[0]))
        assert torch.equal(got[1], want[1])
        assert (want[1] >= 0).sum() > W * H // 4
        assert 0 < stats["group_visits"] <= ref_stats["group_tests"]
        assert stats["sphere_tests"] == P.SPHERE_GROUP * stats["group_visits"]


def tie_scene():
    """40 seeded spheres and a copy of sphere 3 (index 40), laid out so
    that sphere 3 sits in group 2 and its copy in group 0; rays from
    seeded origins at the pair's centre."""
    rng = np.random.default_rng(9)
    centers = rng.uniform(-6.0, 6.0, (40, 3)).astype(np.float32)
    radii = rng.uniform(0.2, 0.6, 40).astype(np.float32)
    centers = np.concatenate([centers, centers[3:4]])
    radii = np.concatenate([radii, radii[3:4]])
    spheres = SpheresSoA(center=torch.from_numpy(centers),
                         radius=torch.from_numpy(radii),
                         material=torch.zeros(41, dtype=torch.int32))
    rest = [k for k in P.morton_order(centers) if k not in (3, 40)]
    order = [40] + rest[:31] + [3] + rest[31:]
    groups = groups_in_order(spheres, order)
    n = 2000
    o = rng.uniform(-12.0, 12.0, (n, 3)).astype(np.float32)
    d = centers[3] + rng.normal(scale=0.1, size=(n, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tmax = np.full(n, C.INFINITY_T, np.float32)
    tmax[::7] = 0.0
    return spheres, groups, (torch.from_numpy(o), torch.from_numpy(d),
                             C.EPSILON_T, torch.from_numpy(tmax))


@pytest.mark.parametrize("near_first", [True, False])
def test_exact_tie_keeps_the_lowest_slot(near_first):
    """Two identical spheres in groups 0 and 2: where the pair is the
    nearest hit both give the same t, and every visit order returns the
    copy in the lower slot (group 0), as the plain version does."""
    spheres, groups, args = tie_scene()
    assert groups.n_groups == 3
    slots = groups.index.tolist()
    assert slots.index(40) < P.SPHERE_GROUP <= 2 * P.SPHERE_GROUP \
        <= slots.index(3)
    want = P.sphere_nearest_chunked_reference(*args, groups)
    brute = P.sphere_nearest_reference(*args, spheres)
    tie = brute[1] == 3          # K3a takes the lower sphere index
    assert int(tie.sum()) > 100
    assert (want[1][tie] == 40).all()
    assert torch.equal(_bits(want[0]), _bits(brute[0]))
    for order in ORDERS.values():
        got = visits_model(*args, groups, rank=order(groups.n_groups),
                           near_first=near_first)
        assert torch.equal(_bits(got[0]), _bits(want[0]))
        assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("wave", ["depth 0", "depth 1", "exact tie"])
def test_kernel_schedule_is_the_models_default(rtow, wave):
    """``primitives.sphere_nearest_visits`` (the schedule chip_smoke counts
    and the card tests hold the kernel to) is the model at its default,
    near first in group order: the same bits and the same visits."""
    if wave == "exact tie":
        _, groups, args = tie_scene()
    else:
        groups, waves = rtow
        o, d, tmax = waves[wave]
        args = (o, d, C.EPSILON_T, tmax)
    stats, want_stats = {}, {}
    got = P.sphere_nearest_visits(*args, groups, stats=stats)
    want = visits_model(*args, groups, stats=want_stats)
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(got[1], want[1])
    assert stats == want_stats and stats["group_visits"] > 0
