"""K2 stage full over buckets of one lane kind each, on the CPU.

On the card stage full lists the live lanes into buckets by key (a miss,
or 1 + the MAT_* type of the hit's material; ``csrc/shade.cu
full_list_kernel``) and runs persistent warps over the buckets, each
listed lane computing from its own lane's inputs
(``shade_full_buckets_kernel``). Two properties make that give the
thread-per-lane kernel's bits, and both are held here on the plain
versions:

- ``full_buckets_reference`` partitions the live lanes exactly: each live
  lane once, under its key, no dead lane;
- ``shade_full_reference`` applied bucket by bucket (its ``lanes``
  argument), in any order of the buckets and with the lanes shuffled
  within them, gives the bits of one whole-wavefront call: each bucket's
  call changes its own lanes only, to the whole call's values.

On rtow (``benchscene.build_rtow_scene(0)``: 487 spheres; lambert, metal
and glass) at 48x27 and ``materials.scene`` (plastic, carpaint,
subsurface, glass, metal, lambert) at 48x16, each at depths 0 and 1 (the
wavefront after one plain bounce). No JAX call: the whole-wavefront plain
version is held against the JAX package by ``test_torch_shade.py``,
``test_torch_rtow_render.py`` and ``test_torch_materials_render.py``.
Also ``full_schedule``, the wrapper's choice between the sweep and the
buckets from what the caller knows, and ``shade_full`` on the CPU.
"""

import itertools

import numpy as np
import pytest
import torch

from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops import camera as camera_ops
from metal_pathtracer_tpu_torch.ops import rng as rng_ops
from metal_pathtracer_tpu_torch.ops.camera import build_camera
from metal_pathtracer_tpu_torch.ops.integrator import PathCarry
from metal_pathtracer_tpu_torch.ops.kernels import shade
from metal_pathtracer_tpu_torch.schema import (
    settings_to_static,
    settings_to_uniforms,
)
from metal_pathtracer_tpu_torch.utils import benchscene as B

SCENES = {"rtow": (B.build_rtow_scene, (48, 27)),
          "materials": (B.build_materials_scene, (48, 16))}
CASES = [(name, depth) for name in SCENES for depth in (0, 1)]


def _clone(c):
    return PathCarry(**{k: v.clone() for k, v in vars(c).items()})


def _wavefront(name, depth):
    """The plain stage full's inputs at ``depth`` of sample 0: (carry,
    args, kwargs) as the depth loop passes them."""
    make, (w, h) = SCENES[name]
    settings, res = make() if name == "materials" else make(0)
    dev = torch.device("cpu")
    scene = res.build_arrays(device=dev)
    static = settings_to_static(settings, w, h, res.material_types_present())
    uni = settings_to_uniforms(settings, build_camera(settings, w, h, dev),
                               0, 0)
    flat = torch.arange(w * h)
    seed = rng_ops.make_seed(uni.fixed_rng_seed, 0, flat % w, flat // w, 0,
                             torch.zeros_like(flat))
    state, o, d = camera_ops.generate_primary_rays(uni.camera, flat % w,
                                                   flat // w, w, h, seed)
    carry = PathCarry.start(state, o, d, 0.0, 0.0)
    params = shade.ShadeParams.of(uni, static)
    for k in range(depth + 1):
        t, idx, u, v, kind = shade._trace(scene, carry)
        args = (t, idx, u, v, scene.triangles, scene.materials, params, k)
        kw = dict(kind=kind, scene=scene)
        if k < depth:
            shade.shade_full_reference(carry, *args, **kw)
    return scene, carry, args, kw


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-d{c[1]}")
def wave(request):
    scene, carry, args, kw = _wavefront(*request.param)
    whole = _clone(carry)
    shade.shade_full_reference(whole, *args, **kw)
    buckets = shade.full_buckets_reference(carry, *args[:6], args[6], **kw)
    return request.param, scene, carry, args, kw, whole, buckets


def _keys(scene, carry, idx, kind):
    """Each lane's key from the scene arrays (the family's material
    array), -1 on dead lanes."""
    mat = torch.zeros_like(idx)
    safe = idx.clamp_min(0).long()
    for fam, prims, count in ((C.PRIMITIVE_SPHERE, scene.spheres,
                               scene.n_spheres),
                              (C.PRIMITIVE_RECTANGLE, scene.rects,
                               scene.n_rects)):
        if count:
            on = (kind == fam) & (idx >= 0)
            mat = torch.where(on, prims.material[safe.clamp_max(count - 1)],
                              mat)
    mtype = scene.materials.mat_type[mat.long()].long()
    key = torch.where(idx >= 0, 1 + mtype, 0)
    return torch.where(carry.alive, key, -1)


def _assert_bits(a, b, label):
    for k in vars(a):
        x, y = getattr(a, k), getattr(b, k)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f"{label}: {k}"


def test_plain_listing_partitions_live_lanes(wave):
    """Every live lane once, under its own key; no dead lane; each bucket
    ascending; more than one hit key, and misses, on every wavefront."""
    (_, depth), scene, carry, args, kw, _, buckets = wave
    assert len(buckets) == len(shade.FULL_KEYS)
    keys = _keys(scene, carry, args[1], kw["kind"])
    listed = torch.cat(buckets)
    assert torch.equal(torch.sort(listed).values,
                       torch.nonzero(carry.alive).squeeze(1))
    for k, lanes in enumerate(buckets):
        assert torch.equal(keys[lanes], torch.full_like(lanes, k))
        assert torch.equal(lanes, torch.sort(lanes).values)
    assert len(buckets[0]) > 0
    assert sum(len(b) > 0 for b in buckets[1:]) >= 3
    assert not carry.alive.all() if depth else carry.alive.all()


def _orders(n_buckets):
    """Every order of up to 4 buckets; beyond that each bucket first once
    (the rotations), reversed, and two seeded shuffles."""
    ids = list(range(n_buckets))
    if n_buckets <= 4:
        return list(itertools.permutations(ids))
    rng = np.random.default_rng(5)
    return [ids[r:] + ids[:r] for r in range(n_buckets)] + [ids[::-1]] + [
        list(rng.permutation(n_buckets)) for _ in range(2)]


def test_each_bucket_alone_changes_its_lanes_only(wave):
    """One bucket's call on the wavefront changes no lane outside it and
    gives its lanes the whole call's bits."""
    _, _, carry, args, kw, whole, buckets = wave
    for k, lanes in enumerate(buckets):
        if not len(lanes):
            continue
        part = _clone(carry)
        shade.shade_full_reference(part, *args, **kw, lanes=lanes)
        inside = torch.zeros_like(carry.alive)
        inside[lanes] = True
        for f in vars(part):
            got = getattr(part, f)
            want = torch.where(inside.view(-1, *[1] * (got.dim() - 1)),
                               getattr(whole, f), getattr(carry, f))
            if got.dtype == torch.float32:
                got, want = got.view(torch.int32), want.view(torch.int32)
            assert torch.equal(got, want), (shade.FULL_KEYS[k], f)


def test_buckets_in_any_order_give_whole_call_bits(wave):
    """The buckets one after another on one carry, in every order of up to
    four buckets (rtow) and in rotations, reversed and shuffled orders of
    more (materials), the lanes shuffled within each bucket: the whole
    call's bits."""
    (name, depth), _, carry, args, kw, whole, buckets = wave
    full = [b for b in buckets if len(b)]
    rng = np.random.default_rng(11)
    for order in _orders(len(full)):
        c = _clone(carry)
        for k in order:
            lanes = full[k][torch.from_numpy(rng.permutation(len(full[k])))]
            shade.shade_full_reference(c, *args, **kw, lanes=lanes)
        _assert_bits(c, whole, f"{name} depth {depth} order {order}")


def test_wrapper_on_cpu_takes_the_plain_version(wave):
    """``shade_full`` on CPU tensors, with the caller's ``n_alive``, gives
    the plain version's bits and counts no launch."""
    _, _, carry, args, kw, whole, _ = wave
    c = _clone(carry)
    before = (shade.shade_full.launches, shade.full_buckets.launches)
    shade.shade_full(c, *args, **kw, n_alive=int(carry.alive.sum()))
    assert (shade.shade_full.launches, shade.full_buckets.launches) == before
    _assert_bits(c, whole, "shade_full on the CPU")


@pytest.mark.parametrize("types,depth,n_alive,want", [
    ((0, 1, 2), 0, 1000, "shade_full_lanes"),    # the first depth
    ((0, 1, 2), 1, None, "shade_full_buckets"),  # live lanes not known
    ((0, 1, 2), 3, 800, "shade_full_buckets"),   # several types
    ((0,), 3, 800, "shade_full_lanes"),          # one material type
    ((0, 1, 2), 3, 15, "shade_full_sparse"),     # under 1/64 alive
    ((0,), 0, 15, "shade_full_sparse"),
    ((0, 4), 3, 15, "shade_full_lanes"),         # sparse, extended
    ((0, 4), 3, 800, "shade_full_buckets"),
])
def test_schedule_from_what_the_caller_knows(types, depth, n_alive, want):
    """``full_schedule``: under 1/64 of the 1000 lanes alive the sparse
    sweep (a thread per lane for the extended instantiation: plastic is
    type 4), a thread per lane at the first depth and for one material
    type, the buckets otherwise."""
    params = shade.ShadeParams(
        background_mode=0, working_color_space=0, use_russian_roulette=True,
        background_color=(0.0, 0.0, 0.0), clamp=None, material_types=types)
    assert shade.full_schedule(params, depth, n_alive, 1000) \
        is getattr(shade, want)
