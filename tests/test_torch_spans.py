"""The port's spans and counters (``utils/spans.py``) on the CPU: the
no-op context with the profiler off, every span of the path under
``torch.profiler`` on a tiny ``rtow`` render and a Cornell box with a
rect-light integral, their nesting, the counters against the spans and
against the benchmark's counting wrappers, and the outputs bit-equal
with tracing on and off. No JAX call."""

from __future__ import annotations

import copy
import json
import os
from unittest import mock

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from metal_pathtracer_tpu_torch.renderer import display, frame
from metal_pathtracer_tpu_torch.renderer.renderer import Renderer
from metal_pathtracer_tpu_torch.utils import spans
from portbench import cells, jobs, scenegen, trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "assets", "scenes", "cornell.scene")
#: the spans a render of the gradient-sky path opens
FUSED_SPANS = {"mpt.sample", "mpt.accumulate", "mpt.camera", "mpt.depth",
               "mpt.trace", "mpt.walk", "mpt.shade", "mpt.sync"}


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rtow(name="rtow-offline", width=16, height=9, depth=6, spp=2):
    """A cell's job on the CPU at a toy size, the scene kept."""
    cell = copy.deepcopy(cells.load_cell(name))
    cell.traffic.update(width=width, height=height, max_depth=depth,
                        batch_spp=spp)
    spec = scenegen.build_spec(cell.config)
    return jobs.JOBS[cell.traffic["mode"]](spec, cell.traffic, 11, "cpu")


def _profiled(fn, tmp_path):
    """Run ``fn()`` under the profiler: the ``mpt.*`` spans of its chrome
    trace as (name, start, end), in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("ph") == "X"
           and e["name"].startswith("mpt.")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _within(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _delta(before: dict, name: str) -> int:
    return spans.counters().get(name, 0) - before.get(name, 0)


def test_span_off_is_the_shared_no_op_and_enters_no_record_function():
    assert not torch.autograd._profiler_enabled()
    assert spans.span("mpt.depth") is spans.OFF
    assert spans.span("mpt.sample") is spans.span("mpt.display")
    job = _rtow(depth=3, spp=1)
    with mock.patch.object(torch.profiler, "record_function",
                           side_effect=AssertionError("entered")) as rf:
        job.render(1)
        assert spans.host_read(torch.tensor(7)) == 7
    assert rf.call_count == 0
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.span("mpt.depth") is not spans.OFF


def test_counters_count_copy_and_reset():
    before = spans.counters()
    spans.count("lanes.trace", 5)
    spans.count("lanes.trace")
    assert _delta(before, "lanes.trace") == 6
    snap = spans.counters()
    snap["lanes.trace"] = -1
    assert spans.counters()["lanes.trace"] != -1
    assert spans.host_read(torch.tensor([1.5, 2.0]),
                           torch.Tensor.tolist) == [1.5, 2.0]
    assert spans.host_read(torch.tensor(True), bool) is True
    assert _delta(before, "host_syncs") == 2
    spans.reset()
    assert spans.counters() == {}


def test_offline_spans_nest_and_match_the_counters(tmp_path):
    job = _rtow()
    before = spans.counters()
    got = _profiled(lambda: job.render(2), tmp_path)
    names = {s[0] for s in got}
    assert FUSED_SPANS <= names
    assert not names & {"mpt.frame_setup", "mpt.display", "mpt.texture",
                        "mpt.light", "mpt.chain"}
    of = lambda n: [s for s in got if s[0] == n]
    samples, depths, syncs = of("mpt.sample"), of("mpt.depth"), of("mpt.sync")
    assert len(samples) == 2
    assert len(depths) == _delta(before, "depths") > 2
    for d in depths:
        assert sum(_within(d, s) for s in samples) == 1
        # the live count's read, first in its depth
        inner = [s for s in syncs if _within(s, d)]
        assert len(inner) == 1 and inner[0][1] >= d[1]
    for name in ("mpt.trace", "mpt.shade", "mpt.walk"):
        for s in of(name):
            assert any(_within(s, d) for d in depths)
    for name in ("mpt.camera", "mpt.accumulate"):
        assert len(of(name)) == 2
        for s in of(name):
            assert sum(_within(s, x) for x in samples) == 1
    assert len(syncs) == _delta(before, "host_syncs")


def test_interactive_spans(tmp_path):
    job = _rtow("rtow-interactive", depth=3)
    got = _profiled(job.step, tmp_path)
    names = [s[0] for s in got]
    assert names[0] == "mpt.frame_setup"
    assert names.count("mpt.frame_setup") == 1
    assert names.count("mpt.display") == 1
    assert names.count("mpt.sample") == job.spf
    setup = got[0]
    assert all(s[1] >= setup[2] for s in got[1:])
    show = [s for s in got if s[0] == "mpt.display"][0]
    # the uint8 image's read to the host, last in the display
    assert any(s[0] == "mpt.sync" and _within(s, show) for s in got)


def _state_tensors(state):
    return [state.radiance_sum, state.radiance_sq_sum, state.sample_count,
            state.albedo, state.normal]


def test_outputs_bit_equal_with_tracing_on_and_off(tmp_path):
    off, on = _rtow(), _rtow()
    off.render(2)
    _profiled(lambda: on.render(2), tmp_path)
    for a, b in zip(_state_tensors(off.state), _state_tensors(on.state)):
        assert torch.equal(a, b)
    assert off.rays() == on.rays()


def test_host_syncs_on_the_fused_path():
    """A depth's live count, two camera reads a sample and chunk (the lens
    radius, the primary cone's spread) and the shadow count once a
    ``render_rows`` call."""
    job = _rtow()
    n = job.width * job.height
    for chunk, samples in ((frame.DEFAULT_CHUNK, 2), (n // 3 + 1, 1)):
        before = spans.counters()
        job.state = frame.render_samples(job.scene, job.uniforms, job.state,
                                         job.static, samples, chunk=chunk)
        calls = samples * -(-n // chunk)
        assert _delta(before, "host_syncs") \
            == _delta(before, "depths") + 2 * calls + 1


def test_host_syncs_on_the_rect_light_path(tmp_path):
    """The NEE loop's reads: as the fused path's, and the spec-NEE scene
    traces' count once a sample and chunk."""
    r = Renderer(12, 10, device="cpu")
    r.load_scene_from_path(CORNELL)
    s = r.settings.copy()
    s.maxDepth, s.renderWidth, s.renderHeight = 3, 12, 10
    r.apply_settings(s)
    assert r.render_size == (12, 10)
    before = spans.counters()
    got = _profiled(lambda: r.draw_frame(2), tmp_path)
    assert _delta(before, "host_syncs") == _delta(before, "depths") \
        + 3 * 2 + 1
    names = {g[0] for g in got}
    assert {"mpt.frame_setup", "mpt.light", "mpt.chain", "mpt.shade"} \
        <= names
    depths = [g for g in got if g[0] == "mpt.depth"]
    assert len(depths) == _delta(before, "depths")
    for name in ("mpt.light", "mpt.chain"):
        for g in got:
            if g[0] == name:
                assert any(_within(g, d) for d in depths)
    before = spans.counters()
    display.display_to_u8(r.state, r.settings)
    assert _delta(before, "host_syncs") == 1


def test_lane_counters_equal_the_wrappers_counts():
    """``lanes.trace`` and ``lanes.shade`` against what
    ``portbench.trace.instrument`` counts on the same render (a sphere
    trace a depth, one ``full`` stage a depth); ``lanes.camera`` stays 0,
    since the CPU takes the camera's plain route."""
    job = _rtow(depth=8)
    counter = trace.Counter()
    before = spans.counters()
    with trace.instrument(counter, light_integral=False):
        job.render(2)
    traced = counter.of("spheres")
    shaded = counter.of("shade")
    assert traced and len(traced) == len(shaded)
    assert _delta(before, "lanes.trace") == sum(c["live"] for c in traced)
    assert _delta(before, "lanes.shade") == sum(c["live"] for c in shaded)
    assert _delta(before, "lanes.trace") == job.rays()[0]
    assert _delta(before, "lanes.camera") == 0
