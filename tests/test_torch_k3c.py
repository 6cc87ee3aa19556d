"""K3c's layout on the CPU: the packed rectangle records the kernel reads
(and K3a's sphere records).

- ``RectsSoA.records()`` holds every SoA field bit for bit (corner,
  edge_u, edge_v, 1/|u|^2, 1/|v|^2, normal, plane, a zero pad: 64 bytes a
  rectangle) on the Cornell box and cornell-emitenv, and is made once per
  ``RectsSoA``.
- ``SpheresSoA.records()``, K3a's (S, 4) layout, holds the centre and
  radius bit for bit on ``materials.scene``.
- A plain version that reads each field from the records, as the kernel
  does (``csrc/primitives.cu rect_root``), gives ``rect_nearest_reference``'s
  bits on a Cornell wavefront: primary rays with dead lanes, and rays
  from inside the box with windows cut at a rectangle's own t.
- The window's end: a hit at exactly ``t == t_max`` is taken (the XLA
  ``hit_rects`` rule, ``ops/intersect.py:248`` of the JAX package, which
  the port follows over the Pallas kernel's ``t < t_max``), one ulp less
  drops it.

No JAX call (``test_torch_primitives.py`` holds the plain version to the
JAX package's ``hit_rects``).
"""

import numpy as np
import pytest
import torch

from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops import camera as camera_ops
from metal_pathtracer_tpu_torch.ops import rng as rng_ops
from metal_pathtracer_tpu_torch.ops.kernels import primitives as P
from metal_pathtracer_tpu_torch.schema import RectsSoA
from metal_pathtracer_tpu_torch.utils import benchscene as B

W = H = 48


def _rects(which):
    if which == "cornell":
        _, res = B.build_cornell_scene()
    else:
        _, res, _ = B.build_cornell_emitenv_scene("cpu")
    return res.build_rects_soa("cpu")


def records_plain(origin, direction, t_min, t_max, records):
    """Plain K3c reading every field from its columns of the records."""
    r = records
    soa = RectsSoA(corner=r[:, 0:3], edge_u=r[:, 3:6], edge_v=r[:, 6:9],
                   inv_len2_u=r[:, 9], inv_len2_v=r[:, 10],
                   normal=r[:, 11:14], plane=r[:, 14], material=None,
                   two_sided=None)
    return P.rect_nearest_reference(origin, direction, t_min, t_max, soa)


def _bits(x):
    return x.numpy().view(np.int32)


@pytest.mark.parametrize("which", ["cornell", "cornell-emitenv"])
def test_records_hold_the_fields(which):
    rects = _rects(which)
    rec = rects.records()
    assert rec.shape == (rects.count, 16) and rec.dtype == torch.float32
    assert rec.is_contiguous() and rects.records() is rec
    for cols, field in (((0, 3), rects.corner), ((3, 6), rects.edge_u),
                        ((6, 9), rects.edge_v),
                        ((9, 10), rects.inv_len2_u[:, None]),
                        ((10, 11), rects.inv_len2_v[:, None]),
                        ((11, 14), rects.normal),
                        ((14, 15), rects.plane[:, None])):
        np.testing.assert_array_equal(
            _bits(rec[:, cols[0]:cols[1]].contiguous()),
            _bits(field.contiguous()))
    assert (rec[:, 15] == 0).all()


def test_sphere_records_hold_the_fields():
    _, res = B.build_materials_scene()
    spheres = res.build_spheres_soa("cpu")
    rec = spheres.records()
    assert rec.shape == (spheres.count, 4) and rec.is_contiguous()
    assert spheres.records() is rec
    np.testing.assert_array_equal(_bits(rec[:, :3].contiguous()),
                                  _bits(spheres.center))
    np.testing.assert_array_equal(_bits(rec[:, 3].contiguous()),
                                  _bits(spheres.radius))


def _primary_wavefront():
    """The Cornell box's primary rays at 48x48, every seventh lane dead."""
    settings, _ = B.build_cornell_scene()
    cam = camera_ops.build_camera(settings, W, H, "cpu")
    flat = torch.arange(W * H)
    xs, ys = flat % W, flat // W
    seed = rng_ops.make_seed(3, 0, xs, ys, 0, torch.zeros_like(xs))
    _, o, d = camera_ops.generate_primary_rays(cam, xs, ys, W, H, seed)
    t_max = torch.full((W * H,), C.INFINITY_T)
    t_max[::7] = 0.0
    return o.contiguous(), d.contiguous(), t_max


def _inner_wavefront(rects, n=4096, seed=11):
    """Rays from inside the box in every direction; a third of them with
    the window cut exactly at their nearest rectangle's t."""
    rng = np.random.default_rng(seed)
    o = torch.from_numpy(rng.uniform((-0.9, 0.05, -0.9), (0.9, 1.95, 0.9),
                                     (n, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    t_max = torch.full((n,), C.INFINITY_T)
    t, i = P.rect_nearest_reference(o, d, C.EPSILON_T, t_max, rects)
    cut = (torch.arange(n) % 3 == 0) & (i >= 0)
    return o, d, torch.where(cut, t, t_max)


def test_records_plain_matches_reference():
    rects = _rects("cornell")
    rec = rects.records()
    for o, d, t_max in (_primary_wavefront(), _inner_wavefront(rects)):
        want = P.rect_nearest_reference(o, d, C.EPSILON_T, t_max, rects)
        got = records_plain(o, d, C.EPSILON_T, t_max, rec)
        assert (want[1] >= 0).sum() > o.shape[0] // 2
        np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())


def test_window_end_is_inclusive():
    """A hit at exactly t == t_max is taken; at one ulp less it is not."""
    rects = _rects("cornell")
    o, d, _ = _inner_wavefront(rects, n=512, seed=5)
    t, i = P.rect_nearest_reference(o, d, C.EPSILON_T,
                                    torch.full((512,), C.INFINITY_T), rects)
    hit = i >= 0   # the box is open at the front
    assert hit.sum() > 256
    o, d, t, i = o[hit], d[hit], t[hit], i[hit]
    for plain in (lambda tm: P.rect_nearest(o, d, C.EPSILON_T, tm, rects),
                  lambda tm: records_plain(o, d, C.EPSILON_T, tm,
                                           rects.records())):
        at_t, at_i = plain(t)
        np.testing.assert_array_equal(_bits(at_t), _bits(t))
        np.testing.assert_array_equal(at_i.numpy(), i.numpy())
        below = torch.nextafter(t, torch.zeros_like(t))
        b_t, b_i = plain(below)
        assert ((b_i != i) | (b_t < t)).all()
        assert (b_t[b_i >= 0] <= below[b_i >= 0]).all()
