"""Train the conv U-Net denoiser (``ops/denoise_unet.py``) through the
port: the twin of the repository's ``tools/train_denoiser_unet.py``.

Renders the tap trainer's scenes (``train_denoiser.SCENES``) and four
enclosed-GI scenes (``EXTRA_SCENES``) at 96x96, 16 spp against 512 spp,
through the port's frame loop; the held-out Cornell gate scene is never
rendered. The base the net refines is the learned tap prepass with the
port's vendored tap weights (4 iterations; SVGF without them). Then
trains the net on random 64x64 crops, a batch of 8, with flips,
transposes and an exposure scale drawn from ``np.random.default_rng(7)``
in the reference's order, so both trainers see the same batches from the
same data; loss: the log-space residual's MSE plus a quarter of the
relative MSE in linear HDR. Adam (optax's defaults) under
``optax.cosine_decay_schedule(2e-3, 5000, alpha=0.05)``, 5000 steps, no
selection: the last parameters are written.

The convolutions are ``torch.nn.functional.conv2d`` (cuDNN on the card,
TF32 off and deterministic algorithms, forward and backward: the JAX
package computes them with ``lax.conv_general_dilated``, outside any
Pallas kernel).

    python -m metal_pathtracer_tpu_torch.tools.train_denoiser_unet --out u.npz

writes the weights in the JAX package's layout (HWIO) where ``--out``
says; the vendored ``data/denoiser_unet.npz`` is not written here.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from metal_pathtracer_tpu_torch.tools import train_denoiser as td

W = H = 96
CROP = 64
BATCH = 8
STEPS = 5000
LR = 2e-3
ALPHA = 0.05
SEED = 7
LOG_EVERY = 200

# the reference's enclosed-GI scenes, as written there
EXTRA_SCENES = [
    # tall box, warm small light, two diffuse spheres
    """camera target=0,1.2,0 distance=4.6 yaw=1.35 pitch=-0.05 vfov=38
renderer maxDepth=5 seed=101
material type=lambert albedo=0.68,0.66,0.62
material type=lambert albedo=0.55,0.12,0.5
material type=lambert albedo=0.15,0.5,0.55
material type=light emit=22,17,9
sphere center=-0.5,0.45,0.3 radius=0.45 material=1
sphere center=0.6,0.35,-0.4 radius=0.35 material=2
rectangle x=-1.3,1.3 y=0 z=-1.3,1.3 normal=1 material=0
rectangle x=-1.3,1.3 y=2.8 z=-1.3,1.3 normal=-1 material=0
rectangle x=-1.3 y=0,2.8 z=-1.3,1.3 normal=1 material=1
rectangle x=1.3 y=0,2.8 z=-1.3,1.3 normal=-1 material=2
rectangle x=-1.3,1.3 y=0,2.8 z=-1.3 normal=1 material=0
rectangle x=-0.25,0.25 y=2.79 z=-0.25,0.25 normal=-1 material=3
""",
    # wide shallow box, big dim ceiling light, metal sphere
    """camera target=0,0.8,0 distance=3.4 yaw=-1.45 pitch=-0.1 vfov=46
renderer maxDepth=4 seed=103
material type=lambert albedo=0.75,0.71,0.68
material type=metal albedo=0.85,0.82,0.75 roughness=0.25
material type=lambert albedo=0.6,0.35,0.1
material type=light emit=5,5,6
sphere center=0,0.5,0 radius=0.5 material=1
rectangle x=-1.6,1.6 y=0 z=-1,1 normal=1 material=0
rectangle x=-1.6,1.6 y=1.8 z=-1,1 normal=-1 material=0
rectangle x=-1.6 y=0,1.8 z=-1,1 normal=1 material=2
rectangle x=1.6 y=0,1.8 z=-1,1 normal=-1 material=2
rectangle x=-1.6,1.6 y=0,1.8 z=-1 normal=1 material=0
rectangle x=-1.1,1.1 y=1.79 z=-0.7,0.7 normal=-1 material=3
""",
    # glass sphere in a box, hot side light (caustic-ish noise)
    """camera target=0,0.9,0 distance=4.1 yaw=1.7 pitch=-0.12 vfov=41
renderer maxDepth=6 seed=107
material type=lambert albedo=0.7,0.7,0.7
material type=dielectric ior=1.5
material type=lambert albedo=0.2,0.25,0.6
material type=light emit=30,27,21
sphere center=0,0.62,0 radius=0.6 material=1
rectangle x=-1.2,1.2 y=0 z=-1.2,1.2 normal=1 material=0
rectangle x=-1.2,1.2 y=2.2 z=-1.2,1.2 normal=-1 material=0
rectangle x=-1.2 y=0,2.2 z=-1.2,1.2 normal=1 material=2
rectangle x=1.2 y=0,2.2 z=-1.2,1.2 normal=-1 material=0
rectangle x=-1.2,1.2 y=0,2.2 z=-1.2 normal=1 material=0
rectangle x=1.19 y=1.2,1.9 z=-0.4,0.4 normal=-1 material=3
""",
    # dim green-tinted box, offset light, high-noise regime
    """camera target=0,1,0 distance=3.7 yaw=-1.6 pitch=0.05 vfov=43
renderer maxDepth=4 seed=109
material type=lambert albedo=0.62,0.7,0.6
material type=lambert albedo=0.3,0.55,0.25
material type=lambert albedo=0.5,0.48,0.45
material type=light emit=6,7,5
sphere center=0.4,0.4,0.3 radius=0.4 material=2
rectangle x=-1.1,1.1 y=0 z=-1.1,1.1 normal=1 material=0
rectangle x=-1.1,1.1 y=2.1 z=-1.1,1.1 normal=-1 material=0
rectangle x=-1.1 y=0,2.1 z=-1.1,1.1 normal=1 material=1
rectangle x=1.1 y=0,2.1 z=-1.1,1.1 normal=-1 material=1
rectangle x=-1.1,1.1 y=0,2.1 z=-1.1 normal=1 material=0
rectangle x=0.3,0.9 y=2.09 z=-0.7,-0.1 normal=-1 material=3
""",
]


def load_data(w=W, h=H, spp_in=td.SPP_IN, spp_ref=td.SPP_REF, scenes=None,
              extra=None, device="cuda", cache_dir=None, log=print) -> dict:
    """The tap trainer's scenes then ``EXTRA_SCENES`` (``scenes``, ``extra``:
    indices, default all) at w x h, each set cached on its own."""
    base = [td.SCENES[i] for i in (range(len(td.SCENES)) if scenes is None
                                   else scenes)]
    more = [EXTRA_SCENES[i] for i in (range(len(EXTRA_SCENES))
                                      if extra is None else extra)]
    sets = [td.load_renders(specs, w, h, spp_in, spp_ref, device, cache_dir,
                            name, log)
            for specs, name in ((base, "denoiser_train_data"),
                                (more, "denoiser_unet_extra")) if specs]
    return {k: np.concatenate([s[k] for s in sets]) for k in sets[0]}


def prepass(data: dict, device="cuda", iterations: int = 4) -> np.ndarray:
    """The base each scene's net refines: the learned tap filter with the
    port's vendored weights (SVGF where they are absent), (N, H, W, 3)."""
    from metal_pathtracer_tpu_torch.ops import denoise

    tparams = denoise._learned_params(device)
    bases = []
    with torch.no_grad():
        for i in range(data["ref"].shape[0]):
            args = [torch.from_numpy(data[k][i]).to(device)
                    for k in ("noisy", "albedo", "normal", "variance")]
            out = (denoise.learned_denoise(*args, tparams,
                                           iterations=iterations)
                   if tparams is not None
                   else denoise.svgf_denoise(*args, iterations=iterations))
            bases.append(out.cpu().numpy())
    return np.stack(bases).astype(np.float32)


def features(base: np.ndarray, data: dict, device="cuda") -> np.ndarray:
    """The net's 13 input channels of each scene (``_features``), numpy."""
    from metal_pathtracer_tpu_torch.ops import denoise_unet as U

    t = lambda x: torch.from_numpy(x).to(device)
    with torch.no_grad():
        return np.stack([U._features(
            t(base[i]), t(data["noisy"][i]), t(data["albedo"][i]),
            t(data["normal"][i]), t(data["variance"][i])).cpu().numpy()
            for i in range(base.shape[0])])


def draw_batch(rng, feats, base, noisy, ref, crop=CROP, batch=BATCH):
    """One step's batch, drawn as the reference draws it: scene indices,
    crop rows, crop columns, then per crop a horizontal flip, a vertical
    flip and a transpose (each at 0.5) and an exposure scale
    exp(U(-1.2, 1.2)) applied to the base, colour and reference and to the
    features that carry them. Returns (features, base, reference) crops,
    numpy (batch, crop, crop, C)."""
    n_scenes, h, w = ref.shape[:3]
    idx = rng.integers(0, n_scenes, batch)
    ys = rng.integers(0, h - crop + 1, batch)
    xs = rng.integers(0, w - crop + 1, batch)
    fb = np.stack([feats[i, y:y + crop, x:x + crop]
                   for i, y, x in zip(idx, ys, xs)])
    bb = np.stack([base[i, y:y + crop, x:x + crop]
                   for i, y, x in zip(idx, ys, xs)])
    xb = np.stack([noisy[i, y:y + crop, x:x + crop]
                   for i, y, x in zip(idx, ys, xs)])
    rb = np.stack([ref[i, y:y + crop, x:x + crop]
                   for i, y, x in zip(idx, ys, xs)])
    for b in range(batch):
        if rng.random() < 0.5:
            fb[b], bb[b], xb[b], rb[b] = (
                fb[b, :, ::-1], bb[b, :, ::-1], xb[b, :, ::-1],
                rb[b, :, ::-1])
        if rng.random() < 0.5:
            fb[b], bb[b], xb[b], rb[b] = (
                fb[b, ::-1], bb[b, ::-1], xb[b, ::-1], rb[b, ::-1])
        if rng.random() < 0.5:
            fb[b] = np.swapaxes(fb[b], 0, 1)
            bb[b] = np.swapaxes(bb[b], 0, 1)
            xb[b] = np.swapaxes(xb[b], 0, 1)
            rb[b] = np.swapaxes(rb[b], 0, 1)
        s_exp = float(np.exp(rng.uniform(-1.2, 1.2)))
        bb[b] *= s_exp
        xb[b] *= s_exp
        rb[b] *= s_exp
        # feature channels: 0-2 log1p(base), 3-5 log1p(color),
        # 12 sqrt(luma var)
        fb[b, ..., 0:3] = np.log1p(np.maximum(bb[b], 0.0))
        fb[b, ..., 3:6] = np.log1p(np.maximum(xb[b], 0.0))
        fb[b, ..., 12] *= s_exp
    return fb, bb, rb


def loss_fn(net, f, b, r):
    """The reference's loss on a batch (tensors (N, H, W, C)): the MSE of
    the log-space residual against log1p(reference), plus a quarter of
    the relative MSE of expm1(relu(log1p(base) + residual)), each crop
    scaled by its own mean square."""
    res = net(f)
    log_b = torch.log1p(torch.clamp_min(b, 0.0))
    log_r = torch.log1p(torch.clamp_min(r, 0.0))
    log_mse = torch.mean((log_b + res - log_r) ** 2)
    out = torch.expm1(torch.clamp_min(log_b + res, 0.0))
    scale = torch.mean(r * r, dim=(1, 2, 3), keepdim=True) + 1e-3
    rel = torch.mean((out - r) ** 2 / scale)
    return log_mse + 0.25 * rel


def gradients(net, f, b, r):
    """(loss, the gradient of each of ``net.params()``, by name), with the
    convolutions' backward under the forward's cuDNN flags."""
    from metal_pathtracer_tpu_torch.ops.denoise_unet import cudnn_float32

    params = net.params()
    with cudnn_float32():
        value = loss_fn(net, f, b, r)
        grads = torch.autograd.grad(value, list(params.values()))
    return value, dict(zip(params, grads))


def train(net, feats, base, noisy, ref, steps=STEPS, crop=CROP,
          batch=BATCH, device="cuda", log=print, check=None):
    """The reference's loop: a batch (``draw_batch``), the loss and its
    gradients, one Adam step at the cosine schedule's rate. ``check(step,
    (f, b, r), grads)`` (if given) sees each step's batch and gradients.
    Returns (every step's loss, every step's wall seconds)."""
    params = net.params()
    opt = td.Adam(params, lambda c: td.cosine_decay(c, LR, steps, ALPHA))
    rng = np.random.default_rng(SEED)
    losses, seconds = [], []
    t0 = time.time()
    for s in range(steps):
        t_step = time.time()
        fb, bb, rb = draw_batch(rng, feats, base, noisy, ref, crop, batch)
        f, b, r = (torch.from_numpy(np.ascontiguousarray(x)).to(device)
                   for x in (fb, bb, rb))
        value, grads = gradients(net, f, b, r)
        if check is not None:
            check(s, (f, b, r), grads)
        updates = opt.update(grads)
        with torch.no_grad():
            for k, p in params.items():
                p.add_(updates[k])
        losses.append(float(value.detach()))
        seconds.append(time.time() - t_step)
        if s % LOG_EVERY == 0 or s == steps - 1:
            log(f"step {s}: loss={losses[-1]:.5f} ({time.time() - t0:.1f}s)")
    return losses, seconds


def main(out, device="cuda", steps=STEPS, w=W, h=H, crop=CROP, batch=BATCH,
         spp_in=td.SPP_IN, spp_ref=td.SPP_REF, scenes=None, extra=None,
         cache_dir=None, log=print):
    """Render (or load) the data, build the prepass and the features,
    train from He-normal weights drawn from seed 0, write the net to
    ``out`` and report each scene's noisy, prepass and U-Net RMSE.
    Returns a dict of the run's losses and wall times."""
    from metal_pathtracer_tpu_torch import convert
    from metal_pathtracer_tpu_torch.ops import denoise_unet as U

    t0 = time.time()
    data = load_data(w, h, spp_in, spp_ref, scenes, extra, device,
                     cache_dir, log)
    base = prepass(data, device)
    feats = features(base, data, device)
    noisy = data["noisy"].astype(np.float32)
    ref = data["ref"].astype(np.float32)
    t_data = time.time() - t0
    net = U.DenoiseUNet.from_params(convert.denoiser_params(
        U.init_params(torch.Generator().manual_seed(0)), device))
    net.requires_grad_(True)
    t1 = time.time()
    losses, seconds = train(net, feats, base, noisy, ref, steps, crop, batch,
                            device=device, log=log)
    if device != "cpu":
        torch.cuda.synchronize(device)
    t_train = time.time() - t1
    report = []
    t = lambda x: torch.from_numpy(x).to(device)
    with torch.no_grad():
        for i in range(ref.shape[0]):
            un = U.denoise(t(noisy[i]), t(data["albedo"][i]),
                           t(data["normal"][i]), t(data["variance"][i]),
                           net, t(base[i])).cpu().numpy()
            e_n, e_b, e_u = (float(np.sqrt(np.mean((x - ref[i]) ** 2)))
                             for x in (noisy[i], base[i], un))
            report.append((e_n, e_b, e_u))
            log(f"scene {i}: noisy={e_n:.4f} taps={e_b:.4f} unet={e_u:.4f}")
    np.savez(out, **convert.denoiser_arrays(net.params()))
    log(f"wrote {out}")
    return dict(losses=losses, step_seconds=seconds, data_seconds=t_data,
                train_seconds=t_train, seconds=time.time() - t0,
                report=report)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="the .npz to write")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cache-dir", default=None)
    a = ap.parse_args()
    main(a.out, a.device, cache_dir=a.cache_dir)
