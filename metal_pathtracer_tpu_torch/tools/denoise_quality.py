"""The held-out Cornell gate of ``tests/test_denoise_quality.py`` on the
port's renders: the Cornell box at 64x64, 16 spp against 512 spp,
rendered on ``device``; the RMSE to the reference and the mean of the
noisy image, SVGF, the learned taps and the U-Net over them, for the
vendored weights and for weight files given (a trainer's output); and
the JAX package's gates on them: ``test_learned_beats_svgf`` (the taps
beat SVGF, means within 0.01) and ``test_unet_beats_learned_taps`` (the
U-Net beats the taps and stays under 0.60 x the noisy RMSE, means within
0.01). Neither trainer renders this scene.

    python -m metal_pathtracer_tpu_torch.tools.denoise_quality \\
        [--taps w.npz] [--unet u.npz]

prints one JSON object; a gate missed is reported, not raised.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

CORNELL = """\
camera target=0,1,0 distance=3.9 yaw=1.5708 pitch=0 vfov=40
renderer maxDepth=4 seed=7
material type=lambert albedo=0.73,0.73,0.73
material type=lambert albedo=0.65,0.05,0.05
material type=lambert albedo=0.12,0.45,0.15
material type=light emit=15,15,15
rectangle x=-1,1 y=0 z=-1,1 normal=1 material=0
rectangle x=-1,1 y=2 z=-1,1 normal=-1 material=0
rectangle x=-1 y=0,2 z=-1,1 normal=1 material=2
rectangle x=1 y=0,2 z=-1,1 normal=-1 material=1
rectangle x=-1,1 y=0,2 z=-1 normal=1 material=0
rectangle x=-0.4,0.4 y=1.99 z=-0.4,0.4 normal=-1 material=3
"""
SIZE, SPP_IN, SPP_REF = 64, 16, 512


def _load(path, device):
    from metal_pathtracer_tpu_torch import convert

    with np.load(path) as z:
        return convert.denoiser_params({k: z[k] for k in z.files}, device)


def _rmse(a, b) -> float:
    return float(np.sqrt(np.mean((a.astype(np.float64) - b) ** 2)))


def evaluate(taps=None, unet=None, device="cuda", size=SIZE, spp_in=SPP_IN,
             spp_ref=SPP_REF) -> dict:
    """RMSEs, means and the two gates, for the vendored weights and, if
    given, the ``taps`` and ``unet`` files (each U-Net over the taps of its
    own case)."""
    from metal_pathtracer_tpu_torch.ops import denoise
    from metal_pathtracer_tpu_torch.ops import denoise_unet as U
    from metal_pathtracer_tpu_torch.tools.train_denoiser import render_pair

    d = render_pair(CORNELL, size, size, spp_in, spp_ref, device)
    ref = d["ref"]
    t = {k: torch.from_numpy(v).to(device) for k, v in d.items()}
    args = (t["noisy"], t["albedo"], t["normal"], t["variance"])
    out = {"noisy": {"rmse": _rmse(d["noisy"], ref)}}
    with torch.no_grad():
        sv = denoise.svgf_denoise(*args).cpu().numpy()
        out["svgf"] = {"rmse": _rmse(sv, ref),
                       "mean_diff": abs(float(sv.mean() - ref.mean()))}
        cases = {"vendored": (denoise._learned_params(device),
                              denoise._unet_params(device))}
        if taps or unet:
            cases["given"] = (
                _load(taps, device) if taps else cases["vendored"][0],
                U.DenoiseUNet.from_params(_load(unet, device)) if unet
                else cases["vendored"][1])
        for name, (tp, net) in cases.items():
            le = denoise.learned_denoise(*args, tp)
            un = U.denoise(*args, net, le).cpu().numpy()
            le = le.cpu().numpy()
            row = {"learned": _rmse(le, ref), "unet": _rmse(un, ref),
                   "learned_mean_diff": abs(float(le.mean() - ref.mean())),
                   "unet_mean_diff": abs(float(un.mean() - ref.mean()))}
            row["learned_beats_svgf"] = bool(
                row["learned"] < out["svgf"]["rmse"]
                and row["learned_mean_diff"] < 0.01)
            row["unet_beats_learned_taps"] = bool(
                row["unet"] < row["learned"]
                and row["unet"] < 0.60 * out["noisy"]["rmse"]
                and row["unet_mean_diff"] < 0.01)
            out[name] = row
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--taps", default=None)
    ap.add_argument("--unet", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    print(json.dumps(evaluate(a.taps, a.unet, a.device)))
