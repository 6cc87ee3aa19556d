"""Train the learned denoiser's tap MLP (``ops/denoise.learned_denoise``)
through the port: the twin of the repository's ``tools/train_denoiser.py``.

Renders the training scenes (``SCENES``: spheres, metal, glass, coloured
walls, rect lights, an open sky, the bench scene's class under its HDR
sky; never the held-out Cornell gate scene of
``tests/test_denoise_quality.py``) at 64x64, 16 spp with AOVs and
variance, and 512-spp references, through the port's frame loop. Then
fits the 129-float MLP end to end through the learned à-trous filter at
both iteration counts ``denoise_state`` runs (4 and 5), on relative MSE.
On the card each iteration is a ``kernels/denoise.LearnedIteration``,
whose backward launches the hand-written kernels of ``csrc/denoise.cu``;
on the CPU autograd runs through the plain version.

The optimiser is written out as optax computes it:
``optax.clip_by_global_norm(1.0)`` (``g / norm * max_norm`` where the
norm is at least ``max_norm``; no epsilon) then ``optax.adam(1e-3)``
(b1 0.9, b2 0.999, eps 1e-8 outside the square root), 600 steps. The
parameters kept are those after the update of the step whose loss was
lowest, the reference's choice (its loss was taken before that update).
The initial MLP replicates the hand-tuned SVGF weight as the reference's
``init_params`` does, drawn from a ``torch.Generator`` (not JAX's bits).

    python -m metal_pathtracer_tpu_torch.tools.train_denoiser --out w.npz

writes the weights in the JAX package's layout where ``--out`` says (the
vendored ``data/denoiser_weights.npz`` is the JAX package's file and is
not written here). Renders are cached as ``.npz`` in ``--cache-dir``
(default: the system's temporary directory), keyed on the scenes, the
port's bench-scene source and the sizes. ``--device cpu`` runs the plain
versions; the default is the card.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import os
import tempfile
import time

import numpy as np
import torch

W = H = 64
SPP_IN = 16
SPP_REF = 512
ITERS = 4
STEPS = 600
LR = 1e-3
MAX_NORM = 1.0
LOG_EVERY = 50


def _env_scene(subdivisions=2, device="cuda"):
    """A toy bench-class scene: HDR sun/sky env alias NEE + dielectric +
    lambert, textures dropped (``tools/train_denoiser.py _env_scene``)."""
    from metal_pathtracer_tpu_torch.utils.benchscene import build_bench_scene

    settings, res, environment = build_bench_scene(subdivisions, device)
    settings.maxDepth = 5
    res.texture_images.clear()
    res.texture_srgb.clear()
    res.texture_wrap.clear()
    for m in res.materials:
        m.texture_indices = (-1, -1, -1, -1, -1, -1)
    return settings, res, environment


def _env_scene_dim(subdivisions=2, device="cuda"):
    settings, res, environment = _env_scene(subdivisions, device)
    settings.environmentIntensity = 0.25
    settings.cameraYaw += 1.2
    settings.fixedRngSeed = 77
    return settings, res, environment


# the reference's training scenes, as written there
SCENES = [
    # box with a diffuse sphere + side light
    """camera target=0,1,0 distance=4.2 yaw=1.2 pitch=-0.1 vfov=42
renderer maxDepth=4 seed=11
material type=lambert albedo=0.7,0.7,0.68
material type=lambert albedo=0.2,0.3,0.7
material type=light emit=10,9,8
sphere center=0,0.7,0 radius=0.7 material=1
rectangle x=-2,2 y=0 z=-2,2 normal=1 material=0
rectangle x=-1,0.2 y=2.4 z=-1,1 normal=-1 material=2
""",
    # metal + lambert spheres under a bright sky gradient
    """camera target=0,0.5,0 distance=5 yaw=0.3 pitch=-0.15 vfov=38
renderer maxDepth=5 seed=23
background solid=0.65,0.75,0.95
material type=metal albedo=0.9,0.75,0.5 roughness=0.15
material type=lambert albedo=0.6,0.15,0.12
material type=lambert albedo=0.45,0.45,0.45
sphere center=-0.9,0.5,0 radius=0.5 material=0
sphere center=0.9,0.5,0 radius=0.5 material=1
sphere center=0,-100,0 radius=100 material=2
""",
    # glass sphere over checker-ish floor with a small hot light
    """camera target=0,0.6,0 distance=3.6 yaw=2.0 pitch=-0.2 vfov=45
renderer maxDepth=6 seed=37
material type=dielectric ior=1.5
material type=lambert albedo=0.55,0.55,0.5
material type=light emit=18,16,12
sphere center=0,0.6,0 radius=0.6 material=0
rectangle x=-3,3 y=0 z=-3,3 normal=1 material=1
rectangle x=-0.5,0.5 y=2.8 z=-0.5,0.5 normal=-1 material=2
""",
    # saturated colored box, strong indirect
    """camera target=0,1,0 distance=3.9 yaw=-1.5708 pitch=0 vfov=40
renderer maxDepth=4 seed=41
material type=lambert albedo=0.73,0.73,0.73
material type=lambert albedo=0.1,0.1,0.6
material type=lambert albedo=0.7,0.55,0.05
material type=light emit=13,13,13
rectangle x=-1,1 y=0 z=-1,1 normal=1 material=0
rectangle x=-1,1 y=2 z=-1,1 normal=-1 material=0
rectangle x=-1 y=0,2 z=-1,1 normal=1 material=1
rectangle x=1 y=0,2 z=-1,1 normal=-1 material=2
rectangle x=-1,1 y=0,2 z=1 normal=-1 material=0
rectangle x=-0.5,0.5 y=1.99 z=-0.5,0.5 normal=-1 material=3
""",
    # dim scene (noise level much higher), emissive sphere
    """camera target=0,0.8,0 distance=4.5 yaw=0.7 pitch=-0.1 vfov=40
renderer maxDepth=4 seed=53
material type=lambert albedo=0.5,0.5,0.5
material type=light emit=4,5,7
material type=metal albedo=0.8,0.8,0.85 roughness=0.35
sphere center=0.8,0.5,0.4 radius=0.5 material=2
sphere center=-0.9,0.9,-0.5 radius=0.35 material=1
rectangle x=-3,3 y=0 z=-3,3 normal=1 material=0
""",
    _env_scene,       # HDR env alias NEE (the headline scene's class)
    _env_scene_dim,   # same under 0.25x intensity (high-noise regime)
]


def render_pair(spec, w=W, h=H, spp_in=SPP_IN, spp_ref=SPP_REF,
                device="cuda") -> dict:
    """One training scene (a ``.scene`` text or a scene function) rendered on
    ``device``: the reference at ``spp_ref``, then the input at ``spp_in``
    from a fresh state (its samples the reference's first), as numpy
    (H, W, 3) ``noisy``, ``albedo``, ``normal``, ``variance`` (of the
    mean) and ``ref``."""
    from metal_pathtracer_tpu_torch.ops.camera import build_camera
    from metal_pathtracer_tpu_torch.renderer import frame
    from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
    from metal_pathtracer_tpu_torch.scene import dsl
    from metal_pathtracer_tpu_torch.scene.resources import SceneResources
    from metal_pathtracer_tpu_torch.schema import (
        settings_to_static,
        settings_to_uniforms,
    )
    from metal_pathtracer_tpu_torch.settings import RenderSettings

    if callable(spec):
        settings, res, environment = spec(device=device)
    else:
        settings, res, environment = RenderSettings(), SceneResources(), None
        dsl.parse_scene(spec, settings, res)
    scene = res.build_arrays(environment=environment, device=device)
    static = settings_to_static(settings, w, h, res.material_types_present())
    uni = settings_to_uniforms(settings, build_camera(settings, w, h, device),
                               0, 0)
    ref = frame.render_samples(scene, uni, RenderState.create(w, h, device),
                               static, spp_ref)
    st = frame.render_samples(scene, uni, RenderState.create(w, h, device),
                              static, spp_in)
    out = {"noisy": st.present(), "albedo": st.albedo, "normal": st.normal,
           "variance": st.variance_of_mean(), "ref": ref.present()}
    return {k: v.cpu().numpy() for k, v in out.items()}


def init_params(generator: torch.Generator, n_feat=6, hidden=16) -> dict:
    """The MLP set to replicate the hand-tuned SVGF weight, -log(w/w_k) =
    f0/sigma_lum + 64 ndiff + 8 ||da||^2: hidden unit j passes feature j,
    w2 carries the SVGF coefficients, the rest small random
    (``tools/train_denoiser.py init_params``), on the CPU."""
    w1 = torch.randn((n_feat, hidden), generator=generator) * 0.02
    w2 = torch.randn((hidden, 1), generator=generator) * 0.02
    w1[:, :n_feat] += torch.eye(n_feat)
    coef = torch.zeros((hidden, 1))
    coef[0, 0] = 1.0 / 1.5    # f0 = |dlum|/(gstd+eps)
    coef[1, 0] = 64.0         # ndiff ~ -log(ndot^64)
    coef[2, 0] = 8.0          # ||dalbedo||^2 / (2*0.25^2)
    return {"w1": w1, "b1": torch.zeros(hidden), "w2": w2 + coef,
            "b2": torch.zeros(1)}


def cache_path(cache_dir, specs, w, h, spp_in, spp_ref,
               name="denoiser_train_data") -> str:
    """The render cache's file, keyed on the scene specs (a function by its
    source), the port's bench-scene source and the sizes."""
    from metal_pathtracer_tpu_torch.utils import benchscene

    key = hashlib.sha1()
    for spec in specs:
        key.update((spec if isinstance(spec, str)
                    else inspect.getsource(spec)).encode())
    key.update(inspect.getsource(benchscene.build_bench_scene).encode())
    key.update(f"{w}x{h}:{spp_in}:{spp_ref}".encode())
    return os.path.join(cache_dir or tempfile.gettempdir(),
                        f"{name}_torch_{key.hexdigest()[:12]}.npz")


def load_renders(specs, w=W, h=H, spp_in=SPP_IN, spp_ref=SPP_REF,
                 device="cuda", cache_dir=None, name="denoiser_train_data",
                 log=print) -> dict:
    """``render_pair`` of each spec, stacked (N, H, W, 3) a key; read from
    the cache when it holds them, else rendered and written there."""
    from metal_pathtracer_tpu_torch.ops import denoise

    path = cache_path(cache_dir, specs, w, h, spp_in, spp_ref, name)
    if os.path.exists(path):
        with np.load(path) as z:
            log(f"loaded cached renders {path}")
            return {k: z[k] for k in z.files}
    t0 = time.time()
    data = []
    for i, spec in enumerate(specs):
        d = render_pair(spec, w, h, spp_in, spp_ref, device)
        noisy_err = float(np.sqrt(np.mean((d["noisy"] - d["ref"]) ** 2)))
        t = {k: torch.from_numpy(v).to(device) for k, v in d.items()}
        svgf = denoise.svgf_denoise(t["noisy"], t["albedo"], t["normal"],
                                    t["variance"], iterations=ITERS)
        svgf_err = float(np.sqrt(np.mean(
            (svgf.cpu().numpy() - d["ref"]) ** 2)))
        log(f"{name} scene {i}: noisy rmse={noisy_err:.4f} "
            f"svgf={svgf_err:.4f} ({time.time() - t0:.1f}s)")
        data.append(d)
    stacked = {k: np.stack([d[k] for d in data]) for k in data[0]}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **stacked)
    return stacked


def scene_error(params, d, iterations=(ITERS, ITERS + 1)):
    """One scene's loss: the relative MSE of the learned filter at each
    iteration count, halved (``one_scene_sq_err``)."""
    from metal_pathtracer_tpu_torch.ops import denoise

    scale = torch.mean(d["ref"] ** 2) + 1e-3
    err = 0.0
    for iters in iterations:
        out = denoise.learned_denoise(d["noisy"], d["albedo"], d["normal"],
                                      d["variance"], params,
                                      iterations=iters)
        err = err + torch.mean((out - d["ref"]) ** 2) / scale
    return err / 2.0


def loss_fn(params, data):
    """The mean of ``scene_error`` over the scenes (dicts of tensors)."""
    return torch.stack([scene_error(params, d) for d in data]).mean()


def _f32(x) -> float:
    return float(np.float32(x))


def clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    """``optax.clip_by_global_norm``: the norm over every leaf (sums of
    squares added in the leaves' sorted-key order); each leaf ``(g /
    norm) * max_norm`` unless the norm is below ``max_norm``."""
    norm = torch.sqrt(sum(torch.sum(grads[k] * grads[k])
                          for k in sorted(grads)))
    keep = norm < max_norm
    return {k: torch.where(keep, g, (g / norm) * _f32(max_norm))
            for k, g in grads.items()}


def cosine_decay(count: int, init_value: float, decay_steps: int,
                 alpha: float = 0.0) -> torch.Tensor:
    """``optax.cosine_decay_schedule(init_value, decay_steps, alpha)`` at
    ``count``, in float32 as optax computes it."""
    c = torch.tensor(min(count, decay_steps), dtype=torch.float32)
    cos = 0.5 * (1 + torch.cos(_f32(np.pi) * c / _f32(decay_steps)))
    return _f32(init_value) * (_f32(1 - alpha) * cos + _f32(alpha))


class Adam:
    """``optax.adam(lr)`` with its defaults (b1 0.9, b2 0.999, eps 1e-8
    outside the square root, eps_root 0) over a dict of tensors: ``update``
    takes the gradients and returns the updates to add. ``lr`` is a number
    or a function of the step count (optax's schedule count, before its
    increment)."""

    def __init__(self, params: dict, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.mu = {k: torch.zeros_like(v.detach()) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v.detach()) for k, v in params.items()}
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0

    def update(self, grads: dict) -> dict:
        lr = self.lr(self.count) if callable(self.lr) else _f32(self.lr)
        self.count += 1
        c1, c2 = _f32(1 - self.b1), _f32(1 - self.b2)
        bc1 = 1 - torch.tensor(self.b1, dtype=torch.float32) ** self.count
        bc2 = 1 - torch.tensor(self.b2, dtype=torch.float32) ** self.count
        out = {}
        for k, g in grads.items():
            self.mu[k] = c1 * g + _f32(self.b1) * self.mu[k]
            self.nu[k] = c2 * (g * g) + _f32(self.b2) * self.nu[k]
            mu_hat = self.mu[k] / bc1.to(g.device)
            nu_hat = self.nu[k] / bc2.to(g.device)
            u = mu_hat / (torch.sqrt(nu_hat) + _f32(self.eps))
            step = -lr if not torch.is_tensor(lr) else (-lr).to(g.device)
            out[k] = step * u
        return out


def train(params: dict, loss, steps=STEPS, log=print, check=None):
    """The reference's loop: the loss and its gradients, clipped, one Adam
    step; stops at a non-finite loss. ``params``: tensors that require
    grad, updated in place; ``loss(params)``: a scalar tensor; ``check(
    step, grads)`` (if given) sees each step's gradients before clipping.
    Returns (the parameters after the update of the step whose loss was
    lowest, as numpy, or None; that loss; every step's loss; every step's
    wall seconds)."""
    keys = sorted(params)
    opt = Adam(params, LR)
    best, best_loss, losses, seconds = None, np.inf, [], []
    t0 = time.time()
    for step in range(steps):
        t_step = time.time()
        value = loss(params)
        grads = dict(zip(keys, torch.autograd.grad(
            value, [params[k] for k in keys])))
        value = float(value.detach())
        if not np.isfinite(value):
            log(f"step {step}: non-finite loss, stopping")
            break
        if check is not None:
            check(step, grads)
        updates = opt.update(clip_by_global_norm(grads, MAX_NORM))
        with torch.no_grad():
            for k in keys:
                params[k].add_(updates[k])
        losses.append(value)
        if value < best_loss:
            best_loss = value
            best = {k: v.detach().cpu().numpy().copy()
                    for k, v in params.items()}
        seconds.append(time.time() - t_step)
        if step % LOG_EVERY == 0 or step == steps - 1:
            log(f"step {step}: loss {value:.5f} ({time.time() - t0:.1f}s)")
    return best, best_loss, losses, seconds


def main(out, device="cuda", steps=STEPS, w=W, h=H, spp_in=SPP_IN,
         spp_ref=SPP_REF, scenes=None, cache_dir=None, log=print):
    """Render (or load) the training set, train, write the weights to
    ``out`` (``np.savez``, the JAX package's layout) and report each
    scene's learned and SVGF RMSE. ``scenes``: indices into ``SCENES``
    (default all). Returns a dict of the run's losses and wall times."""
    from metal_pathtracer_tpu_torch.ops import denoise

    t0 = time.time()
    specs = SCENES if scenes is None else [SCENES[i] for i in scenes]
    stacked = load_renders(specs, w, h, spp_in, spp_ref, device, cache_dir,
                           log=log)
    t_data = time.time() - t0
    data = [{k: torch.from_numpy(v[i]).to(device) for k, v in stacked.items()}
            for i in range(len(specs))]
    params = {k: v.to(device).requires_grad_()
              for k, v in init_params(
                  torch.Generator().manual_seed(0)).items()}
    t1 = time.time()
    best, best_loss, losses, seconds = train(
        params, lambda p: loss_fn(p, data), steps, log=log)
    if device != "cpu":
        torch.cuda.synchronize(device)
    t_train = time.time() - t1
    if best is None:
        raise RuntimeError("training produced no finite loss; weights not "
                           "written")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, **best)
    log(f"wrote {out} (best loss {best_loss:.5f})")
    bp = {k: torch.from_numpy(v).to(device) for k, v in best.items()}
    report = []
    with torch.no_grad():
        for i, d in enumerate(data):
            args = (d["noisy"], d["albedo"], d["normal"], d["variance"])
            le = denoise.learned_denoise(*args, bp, iterations=ITERS)
            sv = denoise.svgf_denoise(*args, iterations=ITERS)
            err = float(torch.sqrt(torch.mean((le - d["ref"]) ** 2)))
            esv = float(torch.sqrt(torch.mean((sv - d["ref"]) ** 2)))
            report.append((err, esv))
            log(f"scene {i}: learned rmse={err:.4f} vs svgf {esv:.4f}")
    return dict(best_loss=best_loss, losses=losses, step_seconds=seconds,
                data_seconds=t_data, train_seconds=t_train,
                seconds=time.time() - t0, report=report)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="the .npz to write")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cache-dir", default=None)
    a = ap.parse_args()
    got = main(a.out, a.device, cache_dir=a.cache_dir)
    q = np.percentile(got["step_seconds"], [25, 50, 75]) * 1e3
    print(f"{len(got['losses'])} steps: {q[1]:.1f} ms a step median "
          f"(quartiles {q[0]:.1f}-{q[2]:.1f}); data "
          f"{got['data_seconds']:.1f} s, training {got['train_seconds']:.1f} "
          f"s, run {got['seconds']:.1f} s; loss {got['losses'][0]:.6f} -> "
          f"{got['losses'][-1]:.6f}, best {got['best_loss']:.6f}")
