"""The benchmark's arithmetic on synthetic timings and shapes: the
end-to-end readers, the busy union and attribution of a reduced profile,
and the pyramid's bytes against the kernel table in PERF.md."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from perfbench import reduce, roofline
from perfbench.harness import Run

HERE = Path(__file__).resolve().parents[1]


def reader(name):
    spec = importlib.util.spec_from_file_location(name, HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_frame_ms_is_the_whole_window_over_its_frames():
    # the window includes the final flush: 10 frames of 0.1 s and 0.5 s of
    # flush give 150 ms a frame, not the 100 ms the frames alone took
    run = Run(setup_s=20.0, frames=10, window_s=1.5, latencies_s=[0.1] * 10, trace=None,
              config=None)
    assert reader("frame_ms")(run) == pytest.approx(150.0)
    assert reader("setup_s")(run) == 20.0


def test_p90_is_over_every_frame():
    lat = [0.1] * 90 + [1.0] * 10
    run = Run(setup_s=0.0, frames=100, window_s=20.0, latencies_s=lat, trace=None, config=None)
    assert reader("frame_ms_p90")(run) == pytest.approx(np.percentile(lat, 90) * 1e3)
    assert reader("frame_ms_p90")(run) == pytest.approx(190.0)


def test_merge_and_busy_union():
    s, e = reduce._merge(np.array([5.0, 0.0, 2.0, 10.0]), np.array([7.0, 3.0, 4.0, 11.0]))
    assert s.tolist() == [0.0, 5.0, 10.0] and e.tolist() == [4.0, 7.0, 11.0]
    ops = [("k", 0.0, 3.0, 0.0), ("k", 2.0, 4.0, 1.0), ("m", 5.0, 7.0, 4.5),
           ("m", 10.0, 11.0, 9.0)]
    t = reduce.Trace(ops, {reduce.WINDOW: [(0.0, 12.0)]}, {}, (0.0, 12.0), frames=2,
                     unattributed=0)
    assert t.busy_s() == pytest.approx(7e-9)
    assert t.window_s() == pytest.approx(12e-9)


def test_attribution_by_launch_range():
    ranges = {reduce.WINDOW: [(0.0, 100.0)], "fused_track": [(0.0, 50.0)],
              "pyramid": [(10.0, 20.0)], "bench.event": [(60.0, 90.0)]}
    ops = [("a", 30.0, 31.0, 5.0),   # launched in fused_track
           ("b", 40.0, 44.0, 15.0),  # launched in the pyramid inside fused_track
           ("c", 70.0, 72.0, 65.0),  # in an event
           ("d", 95.0, 96.0, np.nan)]  # launch not found
    t = reduce.Trace(ops, ranges, {"cudaStreamSynchronize": 3}, (0.0, 100.0), frames=1,
                     unattributed=1)
    assert t.device_s(["pyramid"]) == pytest.approx(4e-9)
    assert t.device_s(["fused_track"], ["pyramid"]) == pytest.approx(1e-9)
    assert t.device_s(["bench.event"]) == pytest.approx(2e-9)
    assert t.host_s(["fused_track"], ["pyramid"]) == pytest.approx(40e-9)
    assert t.host_waits() == 3 and t.range_count("pyramid") == 1
    # idle gaps, by the innermost range open at each gap's middle
    gaps = dict(t.idle_gaps())
    assert gaps == pytest.approx({"pyramid": 30e-9, "fused_track": 9e-9, "outside": 30e-9,
                                  "bench.event": 23e-9})


def test_pyramid_bytes_match_the_kernel_table():
    # PERF.md's kernel table: the grouped K1 over a frame's 10 stacks with
    # masks moves 20.46 MB; K2's four level transitions 6.14 + 1.54 + 0.38
    # + 0.10 MB
    shapes = roofline.level_shapes(320, 1920, 5)
    assert shapes == [(320, 1920), (160, 960), (80, 480), (40, 240), (20, 120)]
    assert roofline.k1_bytes(shapes) == 20_460_000
    assert [roofline.k2_bytes([a, b]) for a, b in zip(shapes, shapes[1:])] == [
        6_144_000, 1_536_000, 384_000, 96_000]
    least, by = roofline.bound_s(roofline.pyramid_bytes(320, 1920, 5), 0.0)
    assert by == "bytes" and least == pytest.approx(28_620_000 / 3.35e12)


def test_roofline_reader_counts_every_pyramid():
    class Cfg:
        class sphere:
            height, width = 320, 1920

        class dense:
            pyramid_levels = 5

    least = 28_620_000 / 3.35e12
    ranges = {reduce.WINDOW: [(0.0, 1e9)], "pyramid": [(0.0, 10.0), (100.0, 110.0)]}
    ops = [("k2", 20.0, 20.0 + 2 * least * 1e9, 5.0), ("k1", 200.0, 200.0 + 2 * least * 1e9, 105.0)]
    t = reduce.Trace(ops, ranges, {}, (0.0, 1e9), frames=2, unattributed=0)
    run = Run(setup_s=0.0, frames=2, window_s=1.0, latencies_s=[], trace=t, config=Cfg)
    assert reader("pyramid_roofline")(run) == pytest.approx(50.0)
    empty = reduce.Trace([], {reduce.WINDOW: [(0.0, 1.0)]}, {}, (0.0, 1.0), 1, 0)
    assert reader("pyramid_roofline")(Run(0.0, 1, 1.0, [], empty, Cfg)) is None
