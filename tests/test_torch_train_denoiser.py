"""The port's denoiser training path against the JAX package's trainers,
on the CPU.

Inputs are made with numpy from a seed. Two JAX reference calls, each
computed once in a module fixture and reused:

- ``jax.value_and_grad`` of the tap trainer's loss (``tools/
  train_denoiser.py one_scene_sq_err``: the learned filter at 4 and 5
  iterations, relative MSE) on one 24x24 scene, with respect to the MLP
  (the reference's ``init_params``) and the input colour. The scene has a
  band of background (solid colour, no variance, zero normal and albedo)
  and a band of unlit pixels (colour 0: luminances tie where the variance
  and the AOVs differ). Tolerance: relative gradient-norm error 1e-4
  (measured: the MLP 7.3e-7, the colour 4.7e-7). With torch's own
  ``abs`` backward (0 at 0, where JAX's is 1) the colour gradient misses
  it (measured 2.9e-4, 4.7e-3 on the unlit rows); the MLP's gradient
  does not move (6.8e-7): a tie inside a flat region multiplies a colour
  Jacobian that is zero there (the output of a flat neighbourhood is its
  colour whatever the weights).
- ``jax.value_and_grad`` of the U-Net trainer's ``loss_fn`` on a 2x16x16
  batch from the reference's ``init_params``: 1e-4 relative norm a
  weight (measured ~1e-6).

optax runs on identical gradients (clip + Adam at 1e-3, Adam under the
cosine schedule): the first two steps' updates within 1e-6 relative, the
third within 5e-5 (``LATER_STEPS_TOL``: XLA's float32 ``pow`` in the
bias correction). The U-Net trainer's batch draws are
taken from the JAX trainer's own loop (its ``main`` with the renders,
the prepass, the features, the jitted step and the writes replaced) and
must be the port's bit for bit. Both port trainers run two steps at toy
size, writing to ``tmp_path``. ~80 s serially, most of it the first JAX
call (eager: ~0.5 ms an operation under ``value_and_grad``).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from metal_pathtracer_tpu.ops import denoise as JD
from metal_pathtracer_tpu.ops import denoise_unet as JU
from metal_pathtracer_tpu_torch import convert
from metal_pathtracer_tpu_torch.ops import denoise as D
from metal_pathtracer_tpu_torch.ops import denoise_unet as U
from metal_pathtracer_tpu_torch.ops.kernels import denoise as K
from metal_pathtracer_tpu_torch.tools import denoise_quality as Q
from metal_pathtracer_tpu_torch.tools import train_denoiser as td
from metal_pathtracer_tpu_torch.tools import train_denoiser_unet as tu
from tools import train_denoiser as JT
from tools import train_denoiser_unet as JTU

S = 24
SKY = slice(0, 5)       # background rows
UNLIT = slice(8, 16)    # colour 0: luminance ties
GRAD_TOL = 1e-4
OPTAX_TOL = 1e-6


def _rel(a, b) -> float:
    a, b = (np.concatenate([np.asarray(x, np.float64).reshape(-1)
                            for x in v]) for v in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(1)
    c = rng.gamma(1.2, 0.6, (S, S, 3)).astype(np.float32)
    var = rng.uniform(0, 0.05, (S, S, 3)).astype(np.float32)
    a = rng.uniform(0.05, 0.95, (S, S, 3)).astype(np.float32)
    n = rng.normal(size=(S, S, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    ref = rng.gamma(1.2, 0.6, (S, S, 3)).astype(np.float32)
    c[SKY] = (0.65, 0.75, 0.95)
    var[SKY], a[SKY], n[SKY] = 0.0, 0.0, 0.0
    ref[SKY] = c[SKY]
    c[UNLIT] = 0.0
    ref[UNLIT] *= 0.05
    return dict(noisy=c, albedo=a, normal=n, variance=var, ref=ref)


@pytest.fixture(scope="module")
def mlp0():
    """The reference trainer's initial MLP (its PRNG), as numpy."""
    return {k: np.asarray(v)
            for k, v in JT.init_params(jax.random.PRNGKey(0)).items()}


@pytest.fixture(scope="module")
def jax_tap(scene, mlp0):
    """The reference trainer's per-scene loss (``one_scene_sq_err``) and
    its gradients with respect to the MLP and the input colour."""
    d = scene

    def one_scene_sq_err(params, noisy):
        scale = jnp.mean(d["ref"] ** 2) + 1e-3
        err = 0.0
        for iters in (JT.ITERS, JT.ITERS + 1):
            out = JD.learned_denoise(noisy, d["albedo"], d["normal"],
                                     d["variance"], params,
                                     iterations=iters)
            err = err + jnp.mean((out - d["ref"]) ** 2) / scale
        return err / 2.0

    loss, (g, gc) = jax.value_and_grad(one_scene_sq_err, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in mlp0.items()}, jnp.asarray(d["noisy"]))
    return float(loss), {k: np.asarray(v) for k, v in g.items()}, \
        np.asarray(gc)


def _port_tap(scene, mlp0):
    params = {k: torch.from_numpy(v.copy()).requires_grad_()
              for k, v in mlp0.items()}
    d = {k: torch.from_numpy(v) for k, v in scene.items()}
    d["noisy"] = d["noisy"].clone().requires_grad_()
    loss = td.scene_error(params, d)
    grads = torch.autograd.grad(loss, [params[k] for k in sorted(params)]
                                + [d["noisy"]])
    return float(loss.detach()), [g.numpy() for g in grads[:-1]], \
        grads[-1].numpy()


def test_learned_loss_gradient_matches_jax(scene, mlp0, jax_tap):
    loss, g, gc = _port_tap(scene, mlp0)
    jloss, jg, jgc = jax_tap
    assert abs(loss - jloss) <= 1e-6 * jloss
    assert _rel(g, [jg[k] for k in sorted(jg)]) <= GRAD_TOL
    assert _rel([gc], [jgc]) <= GRAD_TOL
    assert _rel([gc[UNLIT]], [jgc[UNLIT]]) <= GRAD_TOL
    # the ties are there: unlit pixels with colour gradient
    assert np.abs(jgc[UNLIT]).max() > 1e-5


def test_torch_abs_backward_misses_the_ties(scene, mlp0, jax_tap):
    """torch's ``abs`` backward (0 at 0) in place of JAX's (+1): the
    colour gradient misses the tolerance at the unlit rows' ties and over
    the image; the MLP's gradient sees no tie (see the module note)."""
    with mock.patch.object(D, "_abs", torch.abs):
        _, g, gc = _port_tap(scene, mlp0)
    _, jg, jgc = jax_tap
    assert _rel([gc[UNLIT]], [jgc[UNLIT]]) > 10 * GRAD_TOL
    assert _rel([gc], [jgc]) > GRAD_TOL
    assert _rel(g, [jg[k] for k in sorted(jg)]) <= GRAD_TOL


def test_jax_tie_conventions():
    x = torch.tensor([0.0, -0.0, -2.0, 3.0], requires_grad=True)
    (g,) = torch.autograd.grad(D._abs(x).sum(), x)
    assert g.tolist() == [1.0, 1.0, -1.0, 1.0]
    assert torch.equal(D._abs(x), torch.abs(x))
    z = torch.tensor([0.0, -30.0, 4.0, 90.0], requires_grad=True)
    (g,) = torch.autograd.grad(D._softplus(z).sum(), z)
    assert g[0] == 0.5
    assert torch.allclose(g, torch.sigmoid(z.detach()))
    assert torch.equal(D._softplus(z), D._softplus_value(z))
    assert float(jax.grad(jnp.abs)(0.0)) == 1.0
    assert float(jax.grad(jax.nn.softplus)(0.0)) == 0.5


def _step_inputs(seed, h=14, w=17):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    color = rng.gamma(1.2, 0.6, (h, w, 3))
    var = rng.uniform(0.0, 0.05, (h, w))
    alb = rng.uniform(0.05, 0.95, (h, w, 3))
    nrm = rng.normal(size=(h, w, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    color[2:8, 3:11], var[2:8, 3:11] = 0.4, 0.0   # a flat block
    alb[:2], nrm[:2] = 0.0, 0.0                    # background rows
    return (t(color), t(var), t(alb), t(nrm), t(rng.normal(size=(h, w, 3))),
            t(rng.normal(size=(h, w))))


def _vendored_mlp():
    with np.load(D.DATA_DIR + "/denoiser_weights.npz") as z:
        return K.pack_mlp(convert.denoiser_params(
            {k: z[k] for k in z.files}, "cpu"))


@pytest.mark.parametrize("step,it_feature", [(1, 0.0), (2, 1 / 3),
                                             (16, 1.0)])
def test_backward_twins_match_autograd(step, it_feature):
    """The backward kernels' plain twins (``grad_taps_reference``,
    ``grad_gather_reference``, ``grad_sum_reference``) against autograd
    through ``atrous_step_reference``, one iteration (step 16 wraps the
    14x17 image), at ``GRAD_TOL``. Measured: the colour and variance
    gradients <= 5e-7; the MLP's 4.4e-5 at step 16 (the flat block has no
    variance, so feature 0 reaches ~1e4 at its edge and the 129 sums over
    5,950 terms cancel: float32 sums in another order), <= 3e-6 else."""
    color, var, alb, nrm, g_out, u_out = _step_inputs(step)
    mlp = _vendored_mlp()
    p = K.StepParams.learned(step, it_feature)
    c, v, m = (x.clone().requires_grad_() for x in (color, var, mlp))
    out, out_var = D.atrous_step_reference(c, v, alb, nrm, p, m)
    want = torch.autograd.grad([out, out_var], [c, v, m], [g_out, u_out])
    cv, guide = D.pack_reference(color, var, alb, nrm)
    got = K.atrous_step_grad(cv, guide, p, mlp, g_out, u_out)
    for a, b in zip(got, want):
        assert _rel([a.numpy()], [b.numpy()]) <= GRAD_TOL
    _, _, m_only = K.atrous_step_grad(cv, guide, p, mlp, g_out, None,
                                      inputs=False)
    assert K.atrous_step_grad(cv, guide, p, mlp, g_out, None,
                              inputs=False)[0] is None
    (want_m,) = torch.autograd.grad(
        D.atrous_step_reference(c, v, alb, nrm, p, m)[0], m, g_out)
    assert _rel([m_only.numpy()], [want_m.numpy()]) <= GRAD_TOL


def test_learned_iteration_function_on_cpu():
    """``LearnedIteration`` on CPU tensors (its wrappers' plain versions):
    the forward's bits are ``atrous_step_reference``'s, the gradients
    autograd's; an input that needs no gradient gets none."""
    color, var, alb, nrm, g_out, u_out = _step_inputs(5)
    mlp = _vendored_mlp().requires_grad_()
    p = K.StepParams.learned(2, 1 / 3)
    c = color.clone().requires_grad_()
    out, out_var = K.LearnedIteration.apply(c, var, mlp, alb, nrm, p)
    ref, ref_var = D.atrous_step_reference(color, var, alb, nrm, p,
                                           mlp.detach())
    assert torch.equal(out.detach(), ref) and torch.equal(out_var.detach(),
                                                          ref_var)
    got = torch.autograd.grad((out * g_out).sum(), [c, mlp])
    c2, m2 = color.clone().requires_grad_(), mlp.detach().requires_grad_()
    want = torch.autograd.grad(
        (D.atrous_step_reference(c2, var, alb, nrm, p, m2)[0] * g_out).sum(),
        [c2, m2])
    for a, b in zip(got, want):
        assert _rel([a.numpy()], [b.numpy()]) <= GRAD_TOL


def test_filter_records_a_graph_only_in_grad_mode():
    color, var, alb, nrm, _, _ = _step_inputs(7)
    with np.load(D.DATA_DIR + "/denoiser_weights.npz") as z:
        params = convert.denoiser_params({k: z[k] for k in z.files}, "cpu")
    with torch.no_grad():
        free = D.learned_denoise(color, alb, nrm, var[..., None].expand(
            -1, -1, 3).contiguous(), params)
    for v in params.values():
        v.requires_grad_()
    mlp = K.pack_mlp(params)
    assert mlp.grad_fn is not None and K.pack_mlp(params) is not mlp
    out = D.learned_denoise(color, alb, nrm, var[..., None].expand(
        -1, -1, 3).contiguous(), params)
    assert out.requires_grad and torch.equal(out.detach(), free)
    with torch.no_grad():
        assert K.pack_mlp(params) is K.pack_mlp(params)


@pytest.fixture(scope="module")
def unet_batch():
    rng = np.random.default_rng(3)
    f = rng.normal(size=(2, 16, 16, U.IN_CH)).astype(np.float32)
    b = rng.gamma(1.0, 0.5, (2, 16, 16, 3)).astype(np.float32)
    r = (b * rng.uniform(0.7, 1.3, b.shape)).astype(np.float32)
    raw = {k: np.asarray(v)
           for k, v in JU.init_params(jax.random.PRNGKey(0)).items()}
    return f, b, r, raw


@pytest.fixture(scope="module")
def jax_unet(unet_batch):
    """The reference U-Net trainer's ``loss_fn`` and its gradients."""
    f, b, r, raw = unet_batch

    def loss_fn(params, f, b, r):
        res = JU.apply(params, f)
        log_b = jnp.log1p(jnp.maximum(b, 0.0))
        log_r = jnp.log1p(jnp.maximum(r, 0.0))
        log_mse = jnp.mean((log_b + res - log_r) ** 2)
        out = jnp.expm1(jnp.maximum(log_b + res, 0.0))
        scale = jnp.mean(r * r, axis=(1, 2, 3), keepdims=True) + 1e-3
        rel = jnp.mean((out - r) ** 2 / scale)
        return log_mse + 0.25 * rel

    loss, g = jax.value_and_grad(loss_fn)(
        {k: jnp.asarray(v) for k, v in raw.items()}, f, b, r)
    return float(loss), {k: np.asarray(v) for k, v in g.items()}


def test_unet_loss_gradient_matches_jax(unet_batch, jax_unet):
    f, b, r, raw = unet_batch
    net = U.DenoiseUNet.from_params(convert.denoiser_params(raw, "cpu"))
    net.requires_grad_(True)
    loss, grads = tu.gradients(net, *(torch.from_numpy(x) for x in (f, b, r)))
    jloss, jg = jax_unet
    assert abs(float(loss.detach()) - jloss) <= 1e-5 * jloss
    back = convert.denoiser_arrays(grads)
    for k in raw:
        assert _rel([back[k]], [jg[k]]) <= GRAD_TOL, k


def test_unet_inference_path_stays_frozen(unet_batch):
    f, _, _, raw = unet_batch
    net = U.DenoiseUNet.from_params(convert.denoiser_params(raw, "cpu"))
    x = torch.from_numpy(f)
    frozen = net(x)
    assert not frozen.requires_grad
    assert not any(p.requires_grad for p in net.parameters())
    net.requires_grad_(True)
    trained = net(x)
    assert trained.requires_grad and torch.equal(trained.detach(), frozen)
    with torch.no_grad():
        assert not net(x).requires_grad


def _optax_updates(opt, params, grads_seq):
    """Each step's updates of ``opt`` (applied as it goes), as numpy."""
    state = opt.init(params)
    out = []
    for g in grads_seq:
        updates, state = opt.update(g, state)
        params = optax.apply_updates(params, updates)
        out.append({k: np.asarray(v) for k, v in updates.items()})
    return out


def _port_updates(opt, grads_seq, clip=None):
    out = []
    for g in grads_seq:
        g = {k: torch.from_numpy(v) for k, v in g.items()}
        out.append({k: u.numpy() for k, u in opt.update(
            clip(g) if clip else g).items()})
    return out


#: from the third step on, 1 - b2^t takes one float32 rounding of b2^t
#: that XLA's ``pow`` and torch's place differently (an ulp of 0.997 is
#: 2e-5 of 1 - 0.999^3)
LATER_STEPS_TOL = 5e-5


def _assert_updates(got, want):
    for step, (a, b) in enumerate(zip(got, want)):
        tol = OPTAX_TOL if step < 2 else LATER_STEPS_TOL
        for k in b:
            assert np.abs(a[k] - b[k]).max() <= \
                tol * np.abs(b[k]).max(), (step, k)


@pytest.mark.parametrize("scale", [0.01, 5.0])
def test_clip_adam_steps_match_optax(mlp0, scale):
    """Two steps of the tap trainer's optimiser on the same gradients,
    below (scale 0.01) and above (5.0) the clipping norm: each step's
    updates within 1e-6 of optax's, relative to the largest."""
    rng = np.random.default_rng(11)
    grads_seq = [{k: (rng.normal(size=v.shape) * scale).astype(np.float32)
                  for k, v in mlp0.items()} for _ in range(2)]
    want = _optax_updates(
        optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3)),
        {k: jnp.asarray(v) for k, v in mlp0.items()},
        [{k: jnp.asarray(v) for k, v in g.items()} for g in grads_seq])
    opt = td.Adam({k: torch.from_numpy(v) for k, v in mlp0.items()}, td.LR)
    _assert_updates(_port_updates(
        opt, grads_seq, lambda g: td.clip_by_global_norm(g, td.MAX_NORM)),
        want)


def test_cosine_schedule_and_adam_match_optax(mlp0):
    sched = optax.cosine_decay_schedule(tu.LR, tu.STEPS, alpha=tu.ALPHA)
    for count in (0, 1, 2, 1234, 2500, 4999, 5000, 7000):
        got = float(td.cosine_decay(count, tu.LR, tu.STEPS, tu.ALPHA))
        want = float(sched(jnp.asarray(count, jnp.int32)))
        assert abs(got - want) <= OPTAX_TOL * want, count
    rng = np.random.default_rng(12)
    grads_seq = [{k: rng.normal(size=v.shape).astype(np.float32)
                  for k, v in mlp0.items()} for _ in range(3)]
    want = _optax_updates(
        optax.adam(sched), {k: jnp.asarray(v) for k, v in mlp0.items()},
        [{k: jnp.asarray(v) for k, v in g.items()} for g in grads_seq])
    opt = td.Adam({k: torch.from_numpy(v) for k, v in mlp0.items()},
                  lambda c: td.cosine_decay(c, tu.LR, tu.STEPS, tu.ALPHA))
    _assert_updates(_port_updates(opt, grads_seq), want)


def test_batch_draws_are_the_references():
    """The JAX U-Net trainer's loop (its ``main``, 3 steps, batch 3 of
    16x16 crops of two 24x24 scenes; the renders, the prepass, the
    features, the jitted step, the report and the write replaced) and
    ``draw_batch`` from the same seed give the same batches bit for
    bit."""
    rng = np.random.default_rng(4)
    data = {k: rng.gamma(1.0, 0.5, (2, 24, 24, 3)).astype(np.float32)
            for k in ("noisy", "albedo", "normal", "variance", "ref")}
    feats = rng.normal(size=(2, 24, 24, U.IN_CH)).astype(np.float32)
    seen = []

    def jit(fn):
        def step(params, opt_state, f, x, r):
            seen.append(tuple(np.asarray(a) for a in (f, x, r)))
            return params, opt_state, jnp.float32(0.0)
        return step

    with mock.patch.object(JTU, "load_data", lambda: data), \
            mock.patch.object(JTU.td, "H", 24), \
            mock.patch.object(JTU.td, "W", 24), \
            mock.patch.object(JTU, "CROP", 16), \
            mock.patch.object(JTU, "BATCH", 3), \
            mock.patch.object(JTU, "STEPS", 3), \
            mock.patch.object(JD, "_learned_params", lambda: None), \
            mock.patch.object(JD, "svgf_denoise", lambda *a, **k: a[0]), \
            mock.patch.object(jax, "vmap", lambda fn: lambda *a: feats), \
            mock.patch.object(jax, "jit", jit), \
            mock.patch.object(JU, "denoise", lambda *a, **k: a[0]), \
            mock.patch.object(np, "savez", lambda *a, **k: None):
        JTU.main()
    assert len(seen) == 3
    mine = np.random.default_rng(tu.SEED)
    for f, x, r in seen:
        got = tu.draw_batch(mine, feats, data["noisy"], data["noisy"],
                            data["ref"], 16, 3)
        for a, b in zip(got, (f, x, r)):
            np.testing.assert_array_equal(a, b)


def test_best_is_after_the_lowest_steps_update():
    """The kept parameters are those after the update of the step whose
    (pre-update) loss was lowest: step 1's loss here, so the parameters
    step 2 saw."""
    scripted = [3.0, 1.0, 2.0, 5.0]
    params = {"w": torch.zeros(4, requires_grad=True)}
    seen = []

    def loss(p):
        i = len(seen)
        seen.append(p["w"].detach().clone())
        lin = (p["w"] * torch.arange(1.0, 5.0)).sum()
        return lin - lin.detach() + scripted[i]

    best, best_loss, losses, _ = td.train(params, loss, steps=4,
                                          log=lambda m: None)
    assert losses == scripted and best_loss == 1.0
    assert np.array_equal(best["w"], seen[2].numpy())
    assert not np.array_equal(best["w"], seen[1].numpy())


def test_weights_round_trip_through_convert(tmp_path, mlp0):
    """A port U-Net's and tap MLP's weights to the JAX layout and back,
    bit for bit, through a written ``.npz``; the layout is the reference
    trainers' (names, shapes, float32)."""
    raw = {k: np.asarray(v)
           for k, v in JU.init_params(jax.random.PRNGKey(1)).items()}
    net = U.DenoiseUNet.from_params(convert.denoiser_params(raw, "cpu"))
    mlp = {k: torch.from_numpy(v) for k, v in mlp0.items()}
    for params, want in ((net.params(), raw), (mlp, mlp0)):
        arrays = convert.denoiser_arrays(params)
        np.savez(tmp_path / "w.npz", **arrays)
        with np.load(tmp_path / "w.npz") as z:
            back = {k: z[k] for k in z.files}
        assert sorted(back) == sorted(want)
        for k, v in want.items():
            assert back[k].dtype == np.float32
            np.testing.assert_array_equal(back[k], v, err_msg=k)
        again = convert.denoiser_params(back, "cpu")
        for k, v in params.items():
            assert torch.equal(again[k], v.detach()), k


def test_tap_trainer_two_steps_on_cpu(tmp_path):
    out = tmp_path / "taps.npz"
    run = td.main(str(out), device="cpu", steps=2, w=16, h=16, spp_in=2,
                  spp_ref=4, scenes=[0, 1], cache_dir=str(tmp_path),
                  log=lambda m: None)
    assert len(run["losses"]) == 2 and np.isfinite(run["losses"]).all()
    with np.load(out) as z:
        got = {k: z[k] for k in z.files}
    assert {k: v.shape for k, v in got.items()} == {
        "w1": (6, 16), "b1": (16,), "w2": (16, 1), "b2": (1,)}
    # the renders were cached: a second run reads them
    logs = []
    td.main(str(out), device="cpu", steps=1, w=16, h=16, spp_in=2,
            spp_ref=4, scenes=[0, 1], cache_dir=str(tmp_path),
            log=logs.append)
    assert any(m.startswith("loaded cached renders") for m in logs)


def test_unet_trainer_two_steps_on_cpu(tmp_path):
    out = tmp_path / "unet.npz"
    run = tu.main(str(out), device="cpu", steps=2, w=24, h=24, crop=16,
                  batch=2, spp_in=2, spp_ref=4, scenes=[0], extra=[0],
                  cache_dir=str(tmp_path), log=lambda m: None)
    assert len(run["losses"]) == 2 and np.isfinite(run["losses"]).all()
    assert len(run["report"]) == 2
    with np.load(out) as z:
        shapes = {k: z[k].shape for k in z.files}
    assert shapes == {k: v.shape for k, v in
                      JU.init_params(jax.random.PRNGKey(0)).items()}


def test_quality_tool_on_cpu(tmp_path):
    """``denoise_quality.evaluate`` at toy size: RMSEs of every tier for
    the vendored weights and a given file, the gates as booleans."""
    with np.load(D.DATA_DIR + "/denoiser_weights.npz") as z:
        np.savez(tmp_path / "w.npz", **{k: z[k] for k in z.files})
    got = Q.evaluate(str(tmp_path / "w.npz"), None, "cpu", size=16,
                     spp_in=2, spp_ref=4)
    assert got["vendored"]["learned"] == got["given"]["learned"]
    for case in ("vendored", "given"):
        assert isinstance(got[case]["learned_beats_svgf"], bool)
        assert np.isfinite(got[case]["unet"])
