"""The port's tracing: named spans at its layer boundaries, counters, and
the one way the render path reads a device value on the host.

- ``span(name)``: while a ``torch.profiler`` profile runs, a
  ``torch.profiler.record_function(name)``, so the span lands in the
  same trace as the device operations, on the profiler's clock, nested
  as the calls nest on the launching thread. With no profiler running it
  returns one shared context that does nothing: an entered
  ``record_function`` costs ~10 us even then, the check ~0.2 us.
- ``count(name, n)``, ``counters()`` (a copy), ``reset()``: plain
  integers, always on.
- ``host_read(x, read)``: ``read(x)`` inside an ``mpt.sync`` span,
  counted as ``host_syncs``.

Every span's name starts with ``mpt.``:

- ``mpt.frame_setup``: the facade's per-frame set-up before its render
  (``renderer/renderer.py draw_frame``);
- ``mpt.sample``: one sample of one chunk (``renderer/frame.py
  render_rows``), and in it ``mpt.accumulate``, the lane updates and
  the count sums;
- ``mpt.camera``: the seeds and the primary rays
  (``ops/integrator.py integrate_pixels``);
- ``mpt.depth``: one depth of a depth loop (``ops/kernels/shade.py
  trace_paths_fused``, ``trace_paths_nee``), and in it ``mpt.trace``
  (the closest-hit trace), ``mpt.texture`` (the texture stage),
  ``mpt.walk`` (the random walks), ``mpt.shade`` (each K2 stage's
  call), ``mpt.light`` (the environment and rect-light terms, the light
  banks with their shadow traces) and ``mpt.chain`` (the spec-NEE and
  MNEE estimators);
- ``mpt.display``: the display to uint8 (``renderer/display.py``);
- ``mpt.sync``: each ``host_read``.

Counters: ``host_syncs`` (each ``host_read``), ``depths`` (each depth
entered, the last one of a loop that ran out of live lanes included),
``lanes.trace`` (live lanes at each closest-hit trace), ``lanes.shade``
(live lanes handed to each ``full`` or ``s1`` stage), ``lanes.camera``
(lanes handed to each launch of the primary-ray kernel,
``ops/kernels/camera.py``; 0 on the CPU's plain route). None costs a
sync: each counts what the depth loop already read, or a wavefront's
length.
"""

from __future__ import annotations

import collections
import contextlib

import torch

#: the context ``span`` returns while no profiler runs
OFF = contextlib.nullcontext()

_counts = collections.Counter()


def span(name: str):
    """A ``record_function(name)`` while a profiler runs, else ``OFF``."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return OFF


def count(name: str, n: int = 1) -> None:
    _counts[name] += n


def counters() -> dict:
    """A copy of every counter."""
    return dict(_counts)


def reset() -> None:
    _counts.clear()


def host_read(x, read=int):
    """``read(x)`` (``int`` by default; ``float``, ``bool``,
    ``torch.Tensor.tolist``, ``torch.Tensor.cpu``) in an ``mpt.sync``
    span, counted as one of ``host_syncs``."""
    _counts["host_syncs"] += 1
    with span("mpt.sync"):
        return read(x)
