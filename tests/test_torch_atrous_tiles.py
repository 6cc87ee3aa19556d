"""The à-trous kernel's addressing and its hoisted MLP, on the CPU.

``csrc/denoise.cu atrous_step_kernel`` maps each block to one coset of
the step and stages a 12 x 36 lattice tile of taps, wrapped once a tile
point at its load; ``kernels/denoise.atrous_tiles`` computes the same
addresses in PyTorch. Held here:

- every thread's 25 tap slots read exactly ``torch.roll``'s source pixel
  for its tap, and the blocks cover every pixel once, at 24x24 steps 1-16
  (the steps past 8 wrap more than once), 37x53, 1x7, 7x1 and 1080x1920
  at step 16 (1080 mod 16 = 8: taps past the edge land on another
  coset's row);
- the learned filter's MLP with its constant terms hoisted (the
  per-launch (p4 + p5) table, ``_mlp_table`` and the host's
  ``mlp_constants``, and p3 once a pixel) bit-equal to ``_mlp_logit`` on
  5,000 seeded feature rows and on every tap's features of a 48x48
  state;
- the backward taps kernel's addressing (``grad_tiles``): each lane's
  tile slot at each of its 13 steps holds its tap's roll source, and the
  two mirrored halves take every (pixel, tap) once, at 16x24, 37x53,
  1x7, 7x1 and 270x480 at step 16;
- the filters' packed path on CPU tensors (``pack``, then
  ``atrous_step_packed`` an iteration) bit-equal to the plain iterations,
  with no launch counted.

No JAX call; a few seconds.
"""

import numpy as np
import pytest
import torch

from metal_pathtracer_tpu_torch import convert
from metal_pathtracer_tpu_torch.ops import denoise as D
from metal_pathtracer_tpu_torch.ops.kernels import denoise as K

TILE_CASES = [((24, 24), s) for s in (1, 2, 4, 8, 16)] \
    + [((37, 53), s) for s in (1, 2, 4, 8, 16)] \
    + [((1, 7), s) for s in (1, 2, 4, 8, 16)] \
    + [((7, 1), s) for s in (1, 2, 4, 8, 16)] \
    + [((1080, 1920), 16)]


@pytest.mark.parametrize("size,step", TILE_CASES)
def test_tap_slots_read_the_roll_sources(size, step):
    h, w = size
    src, pix, slots = K.atrous_tiles(h, w, step)
    cy, cx, ty, tx = K.atrous_grid(h, w, step)
    assert src.shape == (cy * cx * ty * tx, K.TILE)
    assert slots.shape == (K.BX * K.BY, 25)
    assert int(slots.min()) >= 0 and int(slots.max()) < K.TILE
    valid = pix >= 0
    # the blocks cover every pixel exactly once
    assert torch.equal(torch.sort(pix[valid]).values,
                       torch.arange(h * w))
    index = torch.arange(h * w).reshape(h, w)
    for t in range(25):
        ky, kx = D._TAPS[t // 5], D._TAPS[t % 5]
        rolled = torch.roll(index, (ky * step, kx * step), (0, 1))
        got = src.gather(1, slots[:, t].expand(src.shape[0], -1))
        assert torch.equal(got[valid], rolled.reshape(-1)[pix[valid]]), \
            (size, step, ky, kx)


def test_cosets_fastest_and_tiles_stay_on_their_lattice():
    """Consecutive blocks take the cosets of one lattice tile; every tile
    point of a block lies on its coset's lattice."""
    h, w, step = 72, 136, 8
    src, pix, _ = K.atrous_tiles(h, w, step)
    cosets = step * step
    for b in (0, 1, cosets - 1, cosets, cosets + 17):
        ry, rx = divmod(b % cosets, step)
        ys, xs = src[b] // w, src[b] % w
        assert bool(((ys % step) == ry % step).all())
        assert bool(((xs % step) == rx % step).all())
    first = pix[:cosets, 0]
    assert torch.equal(first // w, torch.arange(step).repeat_interleave(step))
    assert torch.equal(first % w, torch.arange(step).repeat(step))


GRAD_TILE_CASES = [((16, 24), s) for s in (1, 2, 4, 8, 16)] \
    + [((37, 53), s) for s in (1, 3, 16)] \
    + [((1, 7), 4), ((7, 1), 2), ((270, 480), 16)]


@pytest.mark.parametrize("size,step", GRAD_TILE_CASES)
def test_grad_tap_slots_read_the_roll_sources(size, step):
    """The backward taps kernel's addressing (``kernels/denoise.
    grad_tiles``): at each of its 13 steps a lane's tile slot holds the
    roll source of its tap, and over the steps and the two mirrored
    halves every (pixel, tap) is taken exactly once."""
    h, w = size
    src, pix, tap, slots = K.grad_tiles(h, w, step)
    cy, cx, ty, tx = K.grad_grid(h, w, step)
    assert src.shape == (cy * cx * ty * tx, K.GTX * K.GTY)
    assert int(slots.min()) >= 0 and int(slots.max()) < K.GTX * K.GTY
    index = torch.arange(h * w).reshape(h, w)
    rolled = torch.stack([torch.roll(index, (ky * step, kx * step),
                                     (0, 1)).reshape(-1)
                          for ky in D._TAPS for kx in D._TAPS], 1)
    seen = torch.zeros(h * w, 25, dtype=torch.int64)
    for st in range(K.GRAD_STEPS):
        t = tap[:, st].expand_as(pix)
        live = (pix >= 0) & (t >= 0)
        got = src.gather(1, slots[:, st].expand(src.shape[0], -1))
        assert torch.equal(got[live], rolled[pix[live], t[live]]), (size, st)
        seen.index_put_((pix[live], t[live]),
                        torch.ones_like(pix[live]), accumulate=True)
    assert bool((seen == 1).all())


def _mlps():
    with np.load(D.DATA_DIR + "/denoiser_weights.npz") as z:
        vendored = K.pack_mlp(convert.denoiser_params(
            {k: z[k] for k in z.files}, "cpu"))
    rng = np.random.default_rng(17)
    wide = torch.from_numpy((rng.normal(size=K.MLP_FLOATS)
                             * rng.choice([0.01, 1.0, 30.0],
                                          K.MLP_FLOATS)).astype(np.float32))
    return {"vendored": vendored, "wide": wide}


def _bits(x):
    return x.contiguous().view(torch.int32)


IT_FEATURES = (0.0, 1 / 4, 1 / 3, 1 / 2, 2 / 3, 3 / 4, 1.0)


@pytest.mark.parametrize("name", ["vendored", "wide"])
def test_hoisted_mlp_on_seeded_rows(name):
    mlp = _mlps()[name]
    w1 = mlp[:96].reshape(6, 16)
    rng = np.random.default_rng(5)
    n = 5000
    f = np.empty((n, 6), np.float32)
    f[:, 0] = rng.gamma(0.8, 2.0, n)
    f[:, 1] = rng.uniform(0.0, 2.0, n) * (rng.random(n) < 0.8)
    f[:, 2] = rng.gamma(0.5, 0.3, n)
    f[:, 3] = np.sqrt(rng.gamma(0.7, 0.05, n) + 1e-12)
    it = rng.integers(0, len(IT_FEATURES), n)
    f[:, 4] = np.float32(np.asarray(IT_FEATURES)[it])
    r = rng.integers(0, 5, n)
    f[:, 5] = r / 4.0
    f = torch.from_numpy(f)
    want = D._mlp_logit(mlp, f)
    p3 = f[:, 3:4] * w1[3]
    for k, itf in enumerate(IT_FEATURES):
        rows = torch.from_numpy(it == k)
        table = D._mlp_table(mlp, float(np.float32(itf)))
        host = K.mlp_constants(mlp.numpy(), float(np.float32(itf)))
        assert host.shape == (K.MLP_CONST_FLOATS,)
        assert np.array_equal(host[-80:].view(np.int32),
                              table.numpy().reshape(-1).view(np.int32))
        assert np.array_equal(host[:64], w1[:4].numpy().reshape(-1))
        assert np.array_equal(host[64:97], mlp[96:].numpy())
        got = D._mlp_logit_hoisted(mlp, f[rows], p3[rows],
                                   table[torch.from_numpy(r)[rows]])
        assert torch.equal(_bits(got), _bits(want[rows])), (name, itf)


def test_hoisted_mlp_on_a_state():
    """Every tap's features of a 48x48 state at steps 1 and 8 (iteration
    features 0 and 1): the hoisted sum gives ``_mlp_logit``'s bits."""
    rng = np.random.default_rng(48)
    h = w = 48
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    color = t(rng.gamma(1.2, 0.6, (h, w, 3)))
    albedo = t(rng.uniform(0.05, 0.95, (h, w, 3)))
    normal = rng.normal(size=(h, w, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    normal[:6] = 0.0
    normal = t(normal)
    var = t(rng.gamma(0.6, 0.05, (h, w)))
    mlp = _mlps()["vendored"]
    w1 = mlp[:96].reshape(6, 16)
    gstd = torch.sqrt(torch.clamp_min(D._gauss3(var), 1e-12))
    lum_p = D._luminance(color)
    p3 = gstd[..., None] * w1[3]
    for step, itf in ((1, 0.0), (8, 1.0)):
        table = D._mlp_table(mlp, itf)
        for ky in D._TAPS:
            for kx in D._TAPS:
                shift = (ky * step, kx * step)
                f = D._tap_features(
                    lum_p, gstd, normal, albedo,
                    torch.roll(color, shift, (0, 1)),
                    torch.roll(normal, shift, (0, 1)),
                    torch.roll(albedo, shift, (0, 1)), itf,
                    (abs(ky) + abs(kx)) / 4.0)
                want = D._mlp_logit(mlp, f)
                got = D._mlp_logit_hoisted(mlp, f, p3,
                                           table[abs(ky) + abs(kx)])
                assert torch.equal(_bits(got), _bits(want)), (step, ky, kx)


@pytest.mark.parametrize("mode", ["fixed", "svgf", "learned"])
def test_packed_path_on_cpu_equals_the_plain_iterations(mode):
    rng = np.random.default_rng(9)
    h, w = 19, 23
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    color = t(rng.gamma(1.2, 0.6, (h, w, 3)))
    albedo = t(rng.uniform(0.0, 1.0, (h, w, 3)))
    normal = rng.normal(size=(h, w, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    normal[:3] = 0.0
    normal = t(normal)
    var = t(rng.gamma(0.6, 0.05, (h, w)))
    mlp = _mlps()["vendored"]
    steps = [{"fixed": K.StepParams.fixed(1 << it, 0.245 / 9 ** it, 0.125,
                                          0.08),
              "svgf": K.StepParams.svgf(1 << it, 1.5, 64.0, 0.125),
              "learned": K.StepParams.learned(1 << it, it / 4)}[mode]
             for it in range(5)]
    v = None if mode == "fixed" else var
    cv, guide = K.pack(color, v, albedo, normal)
    assert cv.shape == (h, w, 4) and guide.shape == (h, w, 8)
    back = D.unpack(cv, guide)
    for got, want in zip(back, (color, var if v is not None else
                                torch.zeros_like(var), albedo, normal)):
        assert torch.equal(got, want)
    assert torch.equal(guide[..., 7], D._dot(normal, normal))
    before = (K.atrous_step.launches, K.pack.launches)
    got, got_var = K.atrous_filter(color, v, albedo, normal, steps, mlp)
    assert (K.atrous_step.launches, K.pack.launches) == before
    want, want_var = D.atrous_filter_reference(color, v, albedo, normal,
                                               steps, mlp)
    assert torch.equal(got, want)
    if mode == "fixed":
        assert got_var is None and want_var is None
    else:
        assert torch.equal(got_var, want_var)
    one, one_var = K.atrous_step(color, v, albedo, normal, steps[0], mlp)
    ref, ref_var = D.atrous_step_reference(color, v, albedo, normal,
                                           steps[0], mlp)
    assert torch.equal(one, ref)
    assert (one_var is None) == (mode == "fixed")


def test_pack_mlp_is_made_once():
    with np.load(D.DATA_DIR + "/denoiser_weights.npz") as z:
        params = convert.denoiser_params({k: z[k] for k in z.files}, "cpu")
    a = K.pack_mlp(params)
    assert K.pack_mlp(params) is a
    assert np.array_equal(K.mlp_host(a), a.numpy())
    params = dict(params, b2=params["b2"] + 1.0)
    b = K.pack_mlp(params)
    assert b is not a
    assert float(b[128]) == float(params["b2"].reshape(-1)[0])
