"""The traced run's reduction: roofline charges against hand counts, the
wrappers' live-lane counts on a toy wavefront, the readers on a made-up
trace, the breakdown's names and gaps."""

from __future__ import annotations

import pytest

from portbench import charges, jobs, scenegen, trace
from portbench.metrics import reader

PEAKS = {"hbm_bytes_per_s": 1e12, "fp32_flops_per_s": 1e13}
SCENE = {"spheres": 353, "materials": 335}


def test_charges_against_hand_counts():
    call = lambda kind, live, **k: charges.call_bytes(
        dict(kind=kind, live=live, **k))
    # 10 live rays: closest 10 x (24 + 4 + 8 + 16), any 10 x 29, a sphere
    # or rectangle trace 10 x (24 + 4 + 8)
    assert call("closest", 10) == 520
    assert call("any", 10) == 290
    assert call("spheres", 10) == call("rects", 10) == 360
    # shading: 10 x (52 + 16 + 16 + 52 + 1) [+ 28 with a light]
    assert call("shade", 10, light=False) == 1370
    assert call("shade", 10, light=True) == 1650
    assert call("texture", 10) == 600
    # no term a launch: two launches of 5 rays cost what one of 10 does
    calls = [dict(kind="spheres", live=5)] * 2
    assert charges.share(calls, 1e-6, PEAKS) == pytest.approx(
        charges.share([dict(kind="spheres", live=10)], 1e-6, PEAKS))
    assert charges.share(calls, 1e-6, PEAKS) == pytest.approx(
        100 * 360 / 1e12 / 1e-6)
    assert charges.share([], 1.0, PEAKS) is None
    assert charges.share(calls, 0.0, PEAKS) is None
    assert charges.share(calls, 1.0, None) is None


def test_wrappers_count_live_lanes_on_a_toy_wavefront(toy_cell):
    cell = toy_cell("rtow-offline", width=8, height=6, spp=1)
    spec = scenegen.build_spec(cell.config)
    job = jobs.OfflineJob(spec, cell.traffic, 5, "cpu")
    counter = trace.Counter()
    with trace.instrument(counter, False):
        job.render(1)
    spheres = counter.of("spheres")
    shade = counter.of("shade")
    # depth 0: every one of the 48 primary rays is live and shaded
    assert spheres[0]["live"] == 48 and shade[0]["live"] == 48
    assert len(spheres) == len(shade) <= cell.traffic["max_depth"]
    assert not any(c["light"] for c in shade)
    assert [c["live"] for c in spheres] == sorted(
        (c["live"] for c in spheres), reverse=True)
    assert not counter.of("closest", "any", "texture", "rects")
    # the wrappers leave the port's own launch counters working
    job.render(1)


def _made_up():
    dev = [("void sphere_nearest_chunked_kernel(int)", "k3", 0.0, 100.0),
           ("void at::native::foo<1>(int)", "glue", 150.0, 50.0),
           ("void shade_full_kernel<false>(int)", "k2", 190.0, 60.0),
           ("Memcpy DtoH (Device -> Pageable)", "glue", 400.0, 100.0)]
    spans = [("frame", 0.0, 600.0), ("render", 0.0, 500.0),
             ("trace", 0.0, 120.0), ("shade", 260.0, 380.0)]
    counter = trace.Counter([dict(kind="spheres", live=1000),
                             dict(kind="shade", live=1000, light=False)])
    return trace.Trace(mode="offline", units=2, window_s=6e-4,
                       wall_per_unit_s=5e-4, device=dev, spans=spans,
                       counter=counter, scene=SCENE, peaks=PEAKS)


def test_readers_on_a_made_up_trace():
    t = _made_up()
    # busy: [0, 100] + [150, 250] + [400, 500] = 300 us for 2 units
    assert t.busy_s == pytest.approx(300e-6)
    assert reader("idle_pct.offline")(t) == pytest.approx(
        100 * (1 - 150e-6 / 5e-4))
    assert reader("glue_ms_per_spp.offline")(t) == pytest.approx(0.075)
    assert reader("launches_per_spp.offline")(t) == 2.0
    assert reader("k3_roofline.offline")(t) == pytest.approx(
        100 * 36000 / 1e12 / 100e-6)
    assert reader("k2_roofline.offline")(t) == pytest.approx(
        100 * 137000 / 1e12 / 60e-6)
    assert reader("render_ms.interactive")(t) is None
    t.split = ([0.030, 0.040], [0.010, 0.012])
    assert reader("render_ms.interactive")(t) == pytest.approx(35.0)
    assert reader("display_ms.interactive")(t) == pytest.approx(11.0)
    t.peaks = None
    assert reader("k3_roofline.offline")(t) is None


def test_breakdown_names_and_gaps():
    b = trace.breakdown(_made_up())
    names = [n for n, _ in b["device_ops"]]
    assert names[0] in ("sphere_nearest_chunked_kernel", "Memcpy DtoH")
    assert "at::native::foo<1>" in names
    # gaps: [100, 150], its middle 125 past the trace span's end, inside
    # render; [250, 400], its middle 325 inside shade
    gaps = dict(b["idle_gaps"])
    assert gaps["render"] == pytest.approx(50e-6)
    assert gaps["shade"] == pytest.approx(150e-6)


def test_the_wrappers_own_device_operations_are_left_out():
    ev = lambda cat, name, ts, dur, corr=None: dict(
        ph="X", cat=cat, name=name, ts=ts, dur=dur,
        args={} if corr is None else {"correlation": corr})
    events = [
        ev("user_annotation", "trace", 0, 100),
        ev("user_annotation", trace.COUNT_SPAN, 10, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 15, 2, 1),
        ev("cuda_runtime", "cudaMemcpyAsync", 20, 2, 2),
        ev("cuda_runtime", "cudaLaunchKernel", 50, 2, 3),
        ev("kernel", "void at::native::reduce_kernel<long>(int)", 16, 3, 1),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 21, 1, 2),
        ev("kernel", "void sphere_nearest_chunked_kernel(int)", 51, 9, 3),
        ev("kernel", "void at::native::foo<1>(int)", 70, 5),
    ]
    dev, spans, own = trace.reduce_events(events, trace.kernel_classes())
    assert own == (2, pytest.approx(4e-6))
    assert [(d[0], d[1]) for d in dev] == [
        ("void sphere_nearest_chunked_kernel(int)", "k3"),
        ("void at::native::foo<1>(int)", "glue")]
    assert spans == [("trace", 0.0, 100.0)]
