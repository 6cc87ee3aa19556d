"""Per-pixel PCG hash RNG, bit-compatible with ``ops/rng.py``.

State is an int64 tensor over the wavefront holding uint32 values
(PyTorch has no ``+``/``>>`` for ``uint32`` on the CPU and no
``torch.where`` for it on CUDA), so the arithmetic runs in int64 masked to
32 bits; the CUDA shade kernel does the same steps in ``uint32_t``.
Rejection loops advance only the lanes that have not yet accepted, so each
lane's draw count is the reference's.
"""

from __future__ import annotations

import math

import torch

from metal_pathtracer_tpu_torch.ops.vecmath import fma

_MASK = 0xFFFFFFFF
_INV_2_32 = 1.0 / 4294967296.0


def _u64(state):
    return state.to(torch.int64) & _MASK


def _pcg64(s):
    """One PCG output step on int64 lanes holding u32 values."""
    s = (s * 747796405 + 2891336453) & _MASK
    word = (((s >> ((s >> 28) + 4)) ^ s) * 277803737) & _MASK
    return (word >> 22) ^ word


def pcg_hash(state):
    """(reference: pathtrace.metal:55-59)"""
    return _pcg64(_u64(state))


def rand_uniform(state):
    """Advance state, return a uniform float32 in [0,1)."""
    s = _pcg64(_u64(state))
    # int64 -> float32 rounds to nearest, as XLA's u32 -> f32 does
    return s, s.to(torch.float32) * _INV_2_32


def make_seed(fixed_seed, frame_index, x, y, sample_count, previous_count):
    """(reference: pathtrace.metal:9735-9740); scalars or tensors."""
    v = (_u64(torch.as_tensor(fixed_seed, dtype=torch.int64))
         + _u64(torch.as_tensor(frame_index, dtype=torch.int64)) * 9781
         + _u64(x) * 6271 + _u64(y) * 13007
         + ((_u64(torch.as_tensor(sample_count, dtype=torch.int64))
             + _u64(previous_count)) & _MASK) * 211)
    return v & _MASK


def _masked_rejection(state, draw_fn, accept_fn, n_dims, max_iters=24):
    """Rejection sampling that advances only not-yet-accepted lanes; the
    fixed trip count is the reference's (``rng.py:51-77``)."""
    accepted = torch.zeros(state.shape, dtype=torch.bool,
                           device=state.device)
    value = torch.zeros(state.shape + (n_dims,), dtype=torch.float32,
                        device=state.device)
    for _ in range(max_iters):
        new_state, cand = draw_fn(state)
        inside = accept_fn(cand)
        value = torch.where(accepted[..., None], value, cand)
        state = torch.where(accepted, state, new_state)
        accepted = accepted | inside
    return state, value


def random_in_unit_disk(state):
    """(reference: pathtrace.metal:79-86)"""

    def draw(st):
        st, r1 = rand_uniform(st)
        st, r2 = rand_uniform(st)
        return st, torch.stack([r1, r2], -1) * 2.0 - 1.0

    def accept(p):
        # a 2-term reduce, contracted like XLA:CPU
        return fma(p[..., 1], p[..., 1], p[..., 0] * p[..., 0]) < 1.0

    return _masked_rejection(state, draw, accept, 2)


def sample_cosine_hemisphere(state):
    """Cosine-weighted hemisphere direction in tangent space."""
    state, r1 = rand_uniform(state)
    state, r2 = rand_uniform(state)
    phi = (2.0 * math.pi) * r2
    r = torch.sqrt(torch.clamp_min(r1, 0.0))
    x = torch.cos(phi) * r
    y = torch.sin(phi) * r
    z = torch.sqrt(torch.clamp_min(1.0 - r1, 0.0))
    return state, torch.stack([x, y, z], -1)
