"""Where XLA:CPU's ``1/sqrt`` bits come from, and what they do to the
near-mirror GGX weights (ROADMAP Queue 3, "Understood").

XLA:CPU lowers a jitted ``1.0 / jnp.sqrt(x)`` (and ``lax.rsqrt``) to the
x86 estimate instruction ``rsqrtps`` followed by two Newton steps,
``y' = fma(y * -0.5, fma(x * y, y, -1), y)``. With the hardware estimate
that formula gives XLA's bits on every one of 65,536 inputs in [0.01, 4]
(measured); started from a portable estimate (the correctly rounded
``1/sqrt``, or it cut to the estimate's 12 bits) it gives them on only
92-96 %, and a correctly rounded ``1/sqrt`` agrees on 88.4 %. The
estimate is a table of the input's exponent parity and leading mantissa
bits that differs between x86 vendors and is not the card's, so the port
keeps IEEE ``1/sqrt`` and its gates stay statistical.

The near-mirror metal (roughness 0.02) sample weight is a ratio of two
GGX D terms; the reference's float32 weights are closer to float64 than
the port's because both D terms see XLA's correlated rsqrt roundings:
put the XLA formula into the port's ``safe_normalize`` and the port's
median error falls from 39.7 % to 11.8 % (the reference: 6.2 %). The
reference's graph shares no rounded cos^2 between the two D terms (the
sampled and the recomputed half vector are separate chains), so there
is nothing portable to share.

The estimate is read through a small C helper built with the system
compiler (x86-64 only). This is a measurement of the host's toolchain,
not a test of the port: its answer depends on the instruction XLA's LLVM
picks on the host (``rsqrtps``, or ``vrsqrt14ps`` under AVX-512) and on
the JAX version, so it is a script, run by hand from the repository's
root::

    python3 tests/xla_rsqrt_probe.py

It prints the share of inputs on which each candidate formula gives
XLA's bits, and the median sample-weight errors against float64."""

import ctypes
import os
import platform
import shutil
import subprocess
import sys
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from metal_pathtracer_tpu_torch.ops import bsdf, vecmath  # noqa: E402

import test_torch_rect_lights as rl  # noqa: E402

HELPER = r"""
#include <immintrin.h>
#include <math.h>
#include <string.h>
/* mode 0: the rsqrtps estimate; 1: the correctly rounded 1/sqrt;
   2: that cut to 12 mantissa bits */
void xla_rsqrt(const float* x, float* y, long n, int mode) {
  for (long i = 0; i < n; ++i) {
    float e;
    if (mode == 0) {
      e = _mm_cvtss_f32(_mm_rsqrt_ps(_mm_set1_ps(x[i])));
    } else {
      e = (float)(1.0 / sqrt((double)x[i]));
      if (mode == 2) {
        unsigned u;
        memcpy(&u, &e, 4);
        u &= ~((1u << 11) - 1u);
        memcpy(&e, &u, 4);
      }
    }
    for (int k = 0; k < 2; ++k) {
      float a = fmaf(x[i] * e, e, -1.0f);
      e = fmaf(e * -0.5f, a, e);
    }
    y[i] = e;
  }
}
"""


def build_helper(tmp):
    """The C helper as ``rsqrt(x, mode)`` on float32 arrays."""
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None or platform.machine() not in ("x86_64", "AMD64"):
        raise SystemExit("needs a C compiler on x86-64")
    src, lib_path = os.path.join(tmp, "h.c"), os.path.join(tmp, "h.so")
    with open(src, "w") as f:
        f.write(HELPER)
    subprocess.run([cc, "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    "-o", lib_path, src, "-lm"], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(lib_path)

    def rsqrt(x, mode=0):
        x = np.ascontiguousarray(x, np.float32)
        y = np.empty_like(x)
        lib.xla_rsqrt(ctypes.c_void_p(x.ctypes.data),
                      ctypes.c_void_p(y.ctypes.data), ctypes.c_long(x.size),
                      ctypes.c_int(mode))
        return y
    return rsqrt


def rsqrt_agreement(helper):
    """The share of 65,536 inputs in [0.01, 4] on which each formula gives
    the bits of XLA:CPU's jitted ``1.0 / jnp.sqrt``."""
    x = np.random.default_rng(0).uniform(0.01, 4.0, 1 << 16)
    x = x.astype(np.float32)
    got = np.asarray(jax.jit(lambda v: 1.0 / jnp.sqrt(v))(x)).view(np.int32)
    rounded = (1.0 / np.sqrt(x.astype(np.float64))).astype(np.float32)
    share = lambda y: float(np.mean(y.view(np.int32) == got))
    return {"two Newton steps on rsqrtps": share(helper(x, 0)),
            "two Newton steps on the rounded 1/sqrt": share(helper(x, 1)),
            "two Newton steps on it cut to 12 bits": share(helper(x, 2)),
            "the correctly rounded 1/sqrt": share(rounded)}


def near_mirror_errors(helper):
    """Median |weight / float64 weight - 1| of the roughness-0.02 metal
    sample: the reference's, the port's, and the port's with XLA's rsqrt
    in ``safe_normalize``."""
    jm, pm = rl._metal_lanes("glossy")
    n, wo, state = rl._directions(13)
    jcp, pcp = rl._clamps()

    def sample(m):
        return jax.jit(lambda n, wo, s: rl.jax_bsdf._sample_metal(
            m, n, wo, -wo, s, jcp))

    _, jo = sample(jm)(n, wo, state.astype(np.uint32))
    with jax.enable_x64():
        f64 = lambda a: a.astype(np.float64)
        _, jo64 = sample(rl._float64(jm))(f64(n), f64(wo),
                                          state.astype(np.uint32))
        w64 = np.asarray(jo64.weight)
    valid = np.asarray(jo.pdf) > 0.0

    def median_error(w):
        return float(np.median(np.abs(w[valid] / w64[valid] - 1.0)))

    def port_weights():
        _, po = bsdf._sample_metal(
            pm, torch.from_numpy(n), torch.from_numpy(wo),
            torch.from_numpy(-wo), torch.from_numpy(state.astype(np.int64)),
            pcp)
        return po.weight.numpy()

    def xla_safe_normalize(v):
        len2 = vecmath.dot(v, v)
        inv = torch.from_numpy(helper(
            torch.clamp_min(len2, 1e-38).numpy()).reshape(len2.shape))
        return v * torch.where(len2 > 0.0, inv, 0.0)[..., None]

    e_ref = median_error(np.asarray(jo.weight))
    e_port = median_error(port_weights())
    kept = bsdf.safe_normalize
    bsdf.safe_normalize = xla_safe_normalize
    try:
        e_xla = median_error(port_weights())
    finally:
        bsdf.safe_normalize = kept
    return {"reference": e_ref, "port": e_port,
            "port with XLA's rsqrt": e_xla}


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        helper = build_helper(tmp)
        print(f"jax {jax.__version__}, {platform.machine()}")
        for name, share in rsqrt_agreement(helper).items():
            print(f"XLA's 1/sqrt bits from {name}: {100 * share:.1f} %")
        for name, err in near_mirror_errors(helper).items():
            print(f"near-mirror weight, median error of the {name}: "
                  f"{100 * err:.1f} %")


if __name__ == "__main__":
    main()
