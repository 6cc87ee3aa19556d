"""The readers of the port's own spans and counters
(``portbench/program.py``) on made-up chrome events, and the kept events
and counters of a toy traced stretch on the CPU."""

from __future__ import annotations

import pytest

from portbench import jobs, program, run, scenegen, trace

PEAKS = {"hbm_bytes_per_s": 1e12, "fp32_flops_per_s": 1e13}

SPANS = [("mpt.sample", 0, 1000), ("mpt.camera", 10, 200),
         ("mpt.depth", 300, 900), ("mpt.sync", 300, 330),
         ("mpt.trace", 330, 500), (trace.COUNT_SPAN, 400, 450),
         ("mpt.shade", 600, 750), ("mpt.light", 770, 890),
         ("render", 0, 1400)]
#: device operations (start, end); the one at 420 is launched inside the
#: count span: the benchmark's own
DEVICE = [(0, 20), (180, 200), (260, 270), (335, 345), (370, 380),
          (440, 450), (560, 570), (700, 710), (850, 860), (1100, 1110),
          (1300, 1310)]
#: the gaps' labels by their middles: camera 160; sample 60 + 240; sync
#: 65; trace 25; own 60 (middle 410 in the count); depth 110; shade 130;
#: light 140; unattributed 190 (middle 1205, past the sample)
IDLE = {"mpt.camera": 160, "mpt.sample": 300, "mpt.sync": 65,
        "mpt.trace": 25, "mpt.depth": 110, "mpt.shade": 130,
        "mpt.light": 140, program.UNATTRIBUTED: 190}
BUSY_US = 20 + 20 + 9 * 10


def _events(spans=SPANS, device=DEVICE):
    ev = [dict(ph="X", cat="user_annotation", name=n, ts=s, dur=e - s)
          for n, s, e in spans]
    for i, (s, e) in enumerate(device):
        ev.append(dict(ph="X", cat="kernel", name=f"void k{i}(int)", ts=s,
                       dur=e - s, args={"correlation": i}))
    ev.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel",
                   ts=410, dur=2, args={"correlation": 99}))
    ev.append(dict(ph="X", cat="kernel", name="void at::native::sum(int)",
                   ts=420, dur=5, args={"correlation": 99}))
    return ev


def _trace(events=None, counters=None, mode="offline", units=2):
    events = _events() if events is None else events
    dev, spans, _ = trace.reduce_events(events, trace.kernel_classes())
    t = trace.Trace(mode=mode, units=units, window_s=2e-3,
                    wall_per_unit_s=1e-3, device=dev, spans=spans,
                    counter=trace.Counter(), scene={}, peaks=PEAKS)
    t.program_spans = program.program_spans(events)
    t.counters = counters
    return t


def test_gaps_by_innermost_span_and_the_own_left_out():
    assert trace.reduce_events(_events(), trace.kernel_classes())[2][0] == 1
    t = _trace()
    split, own = program.idle_split(t)
    assert own == pytest.approx(60e-6)
    assert split == pytest.approx({k: v * 1e-6 for k, v in IDLE.items()})
    # the harness's own spans are neither kept nor labels
    assert not any(n == "render" for n, _, _ in t.program_spans)
    assert t.busy_s == pytest.approx(BUSY_US * 1e-6)


def test_idle_groups_add_up_to_the_unprofiled_idle():
    t = _trace(counters={"host_syncs": 90, "depths": 80})
    base = sum(IDLE.values())
    per_unit = 1.0 - BUSY_US * 1e-3 / 2
    assert program.idle_ms_per_unit(t) == pytest.approx(per_unit)
    r = {n: read(t) for n, (_, read) in program.READERS["offline"].items()}
    assert r["idle_camera_ms_per_spp.offline"] == pytest.approx(
        per_unit * 160 / base)
    assert r["idle_trace_ms_per_spp.offline"] == pytest.approx(
        per_unit * 25 / base)
    assert r["idle_shade_ms_per_spp.offline"] == pytest.approx(
        per_unit * 130 / base)
    assert r["idle_loop_ms_per_spp.offline"] == pytest.approx(
        per_unit * (300 + 65 + 110) / base)
    assert r["idle_unattributed_pct.offline"] == pytest.approx(
        100 * 190 / base)
    assert r["host_syncs_per_spp.offline"] == 45
    groups = sum(r[f"idle_{g}_ms_per_spp.offline"] for g in program.GROUPS)
    light = per_unit * program.shares(t)["mpt.light"]
    unattributed = per_unit * r["idle_unattributed_pct.offline"] / 100
    assert groups + light + unattributed == pytest.approx(per_unit)


def test_frame_setup_is_the_mean_span():
    spans = [("mpt.frame_setup", 0, 2000), ("mpt.sample", 2000, 4000),
             ("mpt.frame_setup", 5000, 6000), ("mpt.display", 7000, 7500)]
    t = _trace(_events(spans, [(0, 10), (3000, 3010)]), mode="interactive")
    assert program.frame_setup_ms(t) == pytest.approx(1.5)
    # the gap's middle, 1505, lies in the first frame's set-up
    assert program.unattributed_pct(t) == 0.0
    assert program.shares(t) == {"mpt.frame_setup": 1.0}


@pytest.mark.parametrize("spans", [
    [("render", 0, 1400)],
    [("render", 0, 1400), (trace.COUNT_SPAN, 400, 450)],
])
def test_every_reader_is_none_without_the_ports_spans(spans):
    t = _trace(_events(spans), counters={"host_syncs": 9})
    for mode in program.READERS.values():
        for _, read in mode.values():
            assert read(t) is None
    assert program.idle_split(t) is None and program.shares(t) is None
    plain = _trace()
    del plain.program_spans, plain.counters
    for _, read in program.READERS["offline"].values():
        assert read(plain) is None


def test_host_syncs_need_the_counters():
    assert program.host_syncs_per_unit(_trace(counters=None)) is None
    assert program.idle_group_ms(_trace(counters=None), "camera") > 0


def test_a_toy_stretch_keeps_its_spans_and_counters(toy_cell):
    cell = toy_cell("rtow-offline", width=8, height=6, spp=1, depth=4)
    spec = scenegen.build_spec(cell.config)
    job = jobs.OfflineJob(spec, cell.traffic, 5, "cpu")
    kept = []
    with program.keeping(kept):
        t = run._traced(job, cell, spec, 1.0, 10, "cpu")
    assert kept == [t]
    names = [n for n, _, _ in t.program_spans]
    assert {"mpt.sample", "mpt.camera", "mpt.depth", "mpt.trace",
            "mpt.shade", "mpt.sync", trace.COUNT_SPAN} <= set(names)
    assert names.count("mpt.depth") == t.counters["depths"]
    assert names.count("mpt.sync") == t.counters["host_syncs"]
    assert program.host_syncs_per_unit(t) == t.counters["host_syncs"]
    # the harness's own reduction is what it was
    assert {n for n, _, _ in t.spans} <= set(trace.SPANS)
    assert t.counter.of("spheres")
    # after the stretch, the harness's functions are its own again
    assert run._traced.__name__ == "_traced"
    assert trace.reduce_events.__name__ == "reduce_events"
