"""Vector maths over trailing-dim-3 tensors (``ops/vecmath.py`` twin).

Every helper works elementwise over any leading (wavefront) shape.

Contraction: the reference runs on XLA:CPU, which always lets LLVM fuse
``a * b + c`` into one FMA (measured: ``a*b - c*d`` comes out as
``fma(a, b, -(c*d))``, a 3-term dot as ``fma(a2, b2, fma(a1, b1, a0*b0))``).
PyTorch's eager kernels never contract across ops. So that traces and
hit records stay bit-identical to the reference, the helpers below spell
the same fused operations out with :func:`fma`, an exactly rounded
single-precision fused multiply-add; the CUDA kernels use ``__fmaf_rn`` at
the same places and are compiled with ``--fmad=false`` everywhere else.
Elementwise products are written as separate ops on purpose: fused
PyTorch kernels (``torch.linalg.cross``, ``torch.sum`` over a dim) round
or contract differently.
"""

from __future__ import annotations

import torch

from metal_pathtracer_tpu_torch.constants import LUMINANCE_WEIGHTS


def fma(a, b, c):
    """float32 ``a * b + c`` with a single rounding, like C's ``fmaf``.

    The product of two float32 values is exact in float64, and the float64
    sum is rounded to odd (TwoSum error term), so the final conversion to
    float32 rounds once, correctly. Python scalars broadcast.
    """
    a, b, c = (torch.as_tensor(x, dtype=torch.float32).double()
               for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    bump = (err != 0) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    s = torch.where(bump, bits + step, bits).view(torch.float64)
    return s.to(torch.float32)


def fdiv(a, b):
    """float32 ``a / b``, one IEEE division on every device. Writing ``/``
    with a Python number would not be: PyTorch turns ``x / t`` into
    ``reciprocal(t) * x`` and, on CUDA, ``t / x`` into ``t * (1 / x)``."""
    dev = (a if torch.is_tensor(a) else b).device
    return torch.div(torch.as_tensor(a, dtype=torch.float32, device=dev),
                     torch.as_tensor(b, dtype=torch.float32, device=dev))


def dot(a, b):
    """3-term dot product over the last axis, contracted like XLA:CPU."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1],
                                         a[..., 0] * b[..., 0]))


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([fma(a1, b2, -(a2 * b1)),
                        fma(a2, b0, -(a0 * b2)),
                        fma(a0, b1, -(a1 * b0))], -1)


def length(v):
    return torch.sqrt(torch.clamp_min(dot(v, v), 0.0))


def normalize(v):
    return v / torch.sqrt(torch.clamp_min(dot(v, v), 1e-38))[..., None]


def safe_normalize(v):
    """Normalize; zero-length vectors come back as zero (no NaN)."""
    len2 = dot(v, v)
    inv = torch.where(len2 > 0.0,
                      1.0 / torch.sqrt(torch.clamp_min(len2, 1e-38)),
                      torch.zeros_like(len2))
    return v * inv[..., None]


def luminance(rgb):
    w0, w1, w2 = LUMINANCE_WEIGHTS
    return fma(rgb[..., 2], w2, fma(rgb[..., 1], w1, rgb[..., 0] * w0))


def where3(mask, a, b):
    """Select with a per-lane mask over (...,3) vectors."""
    return torch.where(mask[..., None], a, b)


def build_onb(normal):
    """Orthonormal basis from a unit normal (reference: build_onb)."""
    nz = normal[..., 2].abs() < 0.999
    zero = torch.zeros_like(normal[..., 0])
    one = torch.ones_like(zero)
    up = torch.stack([torch.where(nz, zero, one), zero,
                      torch.where(nz, one, zero)], -1)
    tangent = normalize(cross(up, normal))
    bitangent = cross(normal, tangent)
    return tangent, bitangent


def to_world(local, normal):
    """Rotate a tangent-space vector into the frame of ``normal``."""
    tangent, bitangent = build_onb(normal)
    return fma(local[..., 2:3], normal,
               fma(local[..., 0:1], tangent, local[..., 1:2] * bitangent))


_ACESCG = ((0.613097, 0.339523, 0.047380),
           (0.070194, 0.916354, 0.013452),
           (0.020615, 0.109569, 0.869816))


def linear_srgb_to_acescg(color):
    """3x3 linear sRGB -> ACEScg (reference: pathtrace.metal:93-99).

    Row i is ``fma(m[i][2], c2, fma(m[i][1], c1, m[i][0] * c0))``, the
    order XLA:CPU evaluates the reference's einsum in."""
    c0, c1, c2 = color[..., 0], color[..., 1], color[..., 2]
    f = lambda x: torch.tensor(x, dtype=torch.float32)
    return torch.stack([fma(f(m[2]), c2, fma(f(m[1]), c1, f(m[0]) * c0))
                        for m in _ACESCG], -1)
