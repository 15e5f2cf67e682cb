"""The trackers' tracer (`utils/trace.StageTimer`) inside the port's
trackers, on the small synthetic rig: `synthetic.config(4, 3)` on the
port's own stitch maps, the first 8 captures of the 16-frame loop in the
octagon room (every frame a keyframe, connections from the third, loop
closures from the fourth, as in `test_torch_keyframe.py`).

Off, the tracer stores nothing and opens no `record_function` unless a
profiler session is running (then the program's stage names still mark
the profile).  On, every span that `process` opens descends from that
call's `frame` span, a keyframe event's phases run A, B, C (, rescue), D
with its keyframe and enqueueing frame on them, `align` carries the trips
of its GN loops, and each span lies on the profiler's range of it within
1 ms of the shared host clock.
"""

import dataclasses
import re
import sys
import time
from collections import defaultdict
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rgbd360_tpu_torch import synthetic
from rgbd360_tpu_torch.core.frame import FrameBuilder
from rgbd360_tpu_torch.registration import dense as TD
from rgbd360_tpu_torch.slam.odometry import FrameToFrameOdometry, KeyframeSLAM
from rgbd360_tpu_torch.slam.pbmap_slam import PbMapGraphSLAM
from rgbd360_tpu_torch.utils.trace import StageTimer

from test_torch_segmentation import one_torch_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import chip_smoke  # noqa: E402

SUB, LEVELS, LOOP, N = 4, 3, 16, 8
CLOCK_NS = 1_000_000  # a span's start against the profiler's range of it
SLACK_NS = 200_000  # the profiler's host times are converted from its own clock reads
PHASES = re.compile(r"^A B C( rescue)?( D)?$")


def _cfg(async_events: bool = True):
    cfg = synthetic.config(SUB, LEVELS)
    cfg = cfg.replace(map=dataclasses.replace(cfg.map, max_keyframes=8, max_edges=32))
    return chip_smoke.keyframe_config(cfg, async_events)


@pytest.fixture(scope="module")
def builder():
    cfg = _cfg()
    return FrameBuilder(synthetic.calibration(cfg.rig), cfg, device="cpu")


@pytest.fixture(scope="module")
def raws():
    return chip_smoke.loop_raws(LOOP, SUB, frames=range(N))


def _deferred(slam):
    """Every phase 'not ready' the first time it is asked, as on a busy
    card: events spread over the following frames."""
    asked = set()

    def ready(marker):
        head = slam._pending[0]
        key = id(head[0]), head[1] is not None and id(head[1])
        if key in asked:
            return True
        asked.add(key)
        return False

    slam._phase_ready = ready


def _host_ranges(prof) -> dict:
    from torch.autograd import DeviceType

    out = defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            out[ev.name()].append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return out


@pytest.fixture(scope="module")
def traced(builder, raws):
    """A deferred run with the tracer on, inside a profiler session, with
    the trips of every dense GN loop counted by wrappers (of the loop and
    of its trip's update): (tracker, spans, host ranges by name, [(loop
    start ns, loop end ns, trips)])."""
    slam = KeyframeSLAM(builder, _cfg())
    _deferred(slam)
    loops, gn_loop, gn_trip = [], TD._gn_graph_loop, TD._gn_trip
    trips = [0]

    def counted(*a, **kw):
        trips[0] += 1
        return gn_trip(*a, **kw)

    def counting(*a, **kw):
        n0, t0 = trips[0], time.time_ns()
        out = gn_loop(*a, **kw)
        loops.append((t0, time.time_ns(), trips[0] - n0))
        return out

    TD._gn_graph_loop, TD._gn_trip = counting, counted
    slam.timer.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for raw in raws:
                slam.process(raw)
            slam.flush()
    finally:
        TD._gn_graph_loop, TD._gn_trip = gn_loop, gn_trip
    return slam, slam.timer.take_spans(), _host_ranges(prof), loops


def _root(spans, sp):
    while sp.parent >= 0:
        sp = spans[sp.parent]
    return sp


def _is_phase(name):
    return name.startswith("event.") and name not in ("event.fetch", "event.drain")


def test_off_tracer_opens_no_range_and_stores_no_span(builder, raws, monkeypatch):
    opened, record_function = [], torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or record_function(name))
    slam = KeyframeSLAM(builder, _cfg())
    for raw in raws[:3]:
        slam.process(raw)
    slam.flush()
    assert not opened and not slam.timer.spans and not slam.timer.enabled
    assert slam.timer.counts["frame"] == 3 and slam.timer.counts["fused_track"] == 2
    assert slam.timer.counts["event.drain"] == 1 and slam.timer.counts["kf_pyramid.hit"] >= 1


def test_off_tracer_names_the_stages_under_a_profiler(builder, raws):
    """A profile of an untraced tracker still shows the program's stage
    ranges (the benchmark's traced runs read them); no span is stored."""
    slam = KeyframeSLAM(builder, _cfg())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for raw in raws[:3]:
            slam.process(raw)
    names = set(_host_ranges(prof))
    assert {"frame", "build", "fused_track", "stitch", "cloud", "pyramid", "segment", "register",
            "align", "track.fetch", "register_dense", "event.A"} <= names
    assert not slam.timer.spans


def test_every_span_descends_from_its_frame(traced):
    _, spans, _, _ = traced
    frames = [s for s in spans if s.name == "frame"]
    assert [f.frame for f in frames] == list(range(N))
    outside = []
    for s in spans:
        root = _root(spans, s)
        if root.name == "frame":
            assert s.frame == root.frame, s
        else:
            outside.append(s)
    # flush()'s drain, and what ran inside it, stand outside every frame
    assert outside and outside[0].name == "event.drain" and outside[0].attrs["why"] == "flush"
    assert all(_root(spans, s) is outside[0] for s in outside)
    for f in frames:
        assert {"keyframe", "lost", "relocalized", "phases", "stalled", "sweeps"} <= set(f.attrs)
        assert f.attrs["keyframe"] and not f.attrs["lost"] and not f.attrs["relocalized"]
        inside = [s for s in spans if _root(spans, s) is f]
        assert f.attrs["phases"] == sum(_is_phase(s.name) for s in inside)
        assert f.attrs["stalled"] == sum(s.name == "event.drain" for s in inside)


def test_event_phases_run_in_order_on_their_frames(traced):
    slam, spans, _, _ = traced
    by_event = defaultdict(list)
    for s in spans:
        if _is_phase(s.name):
            by_event[s.attrs["event"]].append(s)
    # keyframe 0 seeds the map without an event
    assert sorted(by_event) == list(range(1, int(slam.map.n_kf)))
    promoted = {s.frame for s in spans if s.name == "frame" and s.attrs["keyframe"]}
    spread = 0
    for k, ph in by_event.items():
        assert PHASES.match(" ".join(s.name[len("event."):] for s in ph)), (k, ph)
        enq = {s.attrs["enqueued"] for s in ph}
        assert len(enq) == 1 and enq <= promoted
        assert all(s.frame >= s.attrs["enqueued"] for s in ph)
        assert [bool(s.attrs.get("done")) for s in ph] == [False] * (len(ph) - 1) + [True]
        spread = max(spread, ph[-1].frame - ph[0].frame)
    assert spread >= 1  # the deferred events ran over later frames


def test_event_fetch_nests_in_a_phase(traced):
    _, spans, _, _ = traced
    fetches = [s for s in spans if s.name == "event.fetch"]
    assert fetches
    for s in fetches:
        parent = spans[s.parent]
        assert _is_phase(parent.name) and parent.attrs["event"] == s.attrs["event"]
    # every phase but an event's first starts with the fetch of what it awaits
    for i, s in enumerate(spans):
        if _is_phase(s.name):
            n = sum(f.parent == i for f in fetches)
            assert n == (0 if s.name == "event.A" else 1), s


def test_align_sweeps_are_the_gn_loop_trips(traced):
    _, spans, _, loops = traced

    def trips(sp):
        return sum(n for a, _, n in loops if sp.start_ns <= a <= sp.end_ns)

    aligns = [s for s in spans if s.name == "align"]
    assert aligns
    for s in aligns:
        assert s.attrs["sweeps"] == trips(s) > 0 and s.attrs["solves"] == 1
    for f in (s for s in spans if s.name == "frame"):
        solves = [s for s in spans if s.name in ("align", "register_dense")
                  and _root(spans, s) is f]
        assert f.attrs["sweeps"] == sum(trips(s) for s in solves)


def test_gn_graph_counts_are_every_loops_trips(traced):
    """The timer's `gn_graph.*` counts take every dense loop's trips, in
    frames and in the closing flush; off the card none is replayed or
    captured, and no frame tallies a replay."""
    slam, spans, _, loops = traced
    counts = slam.timer.counts
    assert counts["gn_graph.sweep"] == sum(n for _, _, n in loops) > 0
    assert counts["gn_graph.replay"] == counts["gn_graph.capture"] == 0
    assert all(s.attrs["replays"] == 0 for s in spans if s.name in ("frame", "align"))


def test_spans_sit_on_the_profilers_ranges(traced):
    """One clock: each span lies inside the profiler's range of it (its
    clock is read inside the `record_function`), and its start within 1
    ms of the range's.  A host that deschedules the tracker between the
    two reads (the suite's parallel workers share the cores) can leave a
    span's start later than that: at most 1% of them."""
    _, spans, ranges, _ = traced
    by_name = defaultdict(list)
    for s in spans:
        by_name[s.name].append((s.start_ns, s.end_ns))
    gaps = []
    for name, got in by_name.items():
        ref = sorted(ranges[name])
        assert len(ref) == len(got), name
        for (a, b), (ra, rb) in zip(sorted(got), ref):
            assert ra - SLACK_NS <= a <= b <= rb + SLACK_NS, name
            gaps.append(a - ra)
    assert sum(g >= CLOCK_NS for g in gaps) <= len(gaps) // 100


def test_stage_ranges_stay_where_they_were(traced):
    """The stage names the benchmark's readers use cover what they
    covered: the build's stages inside `fused_track` (or the split path's
    `build`), the back-end's inside the event phases."""
    _, spans, _, _ = traced
    parent = defaultdict(set)
    for s in spans:
        parent[s.name].add(spans[s.parent].name if s.parent >= 0 else None)
    for stage in ("stitch", "cloud", "pyramid", "segment"):
        assert parent[stage] <= {"fused_track", "build"} and parent[stage], stage
    assert parent["build"] == {"frame"} and parent["fused_track"] == {"frame"}
    assert parent["register"] == parent["align"] == parent["track.fetch"] == {"fused_track"}
    assert parent["register_dense"] == {"frame"}
    assert parent["loop_closure"] and parent["loop_closure"] <= {"event.A", "event.B"}
    assert parent["optimize"] and parent["optimize"] <= {"event.C", "event.rescue"}
    assert parent["partition"] and parent["partition"] <= {"event.D"}


def test_keyframe_pyramid_rebuild_span_and_counters(traced):
    slam, _, _, _ = traced
    timer, cache = StageTimer(), {}
    timer.enable()
    pyr = slam.loop_closer.kf_pyramid(slam.map, 1, cache, timer)
    assert slam.loop_closer.kf_pyramid(slam.map, 1, cache, timer) is pyr
    assert timer.counts["kf_pyramid.miss"] == timer.counts["kf_pyramid.hit"] == 1
    (sp,) = timer.spans
    assert sp.name == "kf_pyramid" and sp.attrs == {"kf": 1}
    plain = slam.loop_closer.kf_pyramid(slam.map, 1)
    assert all(torch.equal(a, b) for a, b in zip(pyr.gray, plain.gray))


def test_relocalize_spans(traced, raws):
    slam, _, _, _ = traced
    state = slam.make_state(raws[3])
    hit = slam.relocalizer.relocalize(slam.map, state.planes).success
    slam.timer.take_spans()
    found = slam._relocalize(state)
    spans = slam.timer.take_spans()
    names = [s.name for s in spans]
    assert names[:3] == ["relocalize", "event.drain", "relocalize.scan"]
    assert spans[0].attrs["success"] == (found is not None)
    assert spans[1].attrs["why"] == "relocalize"
    assert all(_root(spans, s) is spans[0] for s in spans)
    assert ("relocalize.verify" in names) == hit


def test_pbmap_tracker_spans(builder, raws):
    slam = PbMapGraphSLAM(builder, _cfg())
    slam.timer.enable()
    for raw in raws[:6]:
        slam.process(raw)
    slam.flush()
    spans = slam.timer.take_spans()
    frames = [s for s in spans if s.name == "frame"]
    assert [f.frame for f in frames] == list(range(6))
    by_event = defaultdict(list)
    for s in spans:
        if _is_phase(s.name):
            by_event[s.attrs["event"]].append(s.name[len("event."):])
    assert by_event and set(by_event) <= set(range(1, 6))
    assert all(PHASES.match(" ".join(p)) for p in by_event.values())
    parent = {spans[s.parent].name for s in spans if s.name == "loop_closure"}
    assert parent and parent <= {"event.A", "event.B"}
    assert {spans[s.parent].name for s in spans if s.name == "register_pbmap"} == {"frame"}


def test_pbmap_graph_solves_carry_their_lm_counts(builder, raws):
    """The PbMap tracker with its graph solve in float64, over the first
    half of the lap (the solves of a whole lap are alike): every
    `optimize` span carries the solve's LM iterations, rejected steps,
    keyframes and precision, and the timer's `graph.lm_iter` /
    `graph.lm_reject` counts are their sums."""
    from rgbd360_tpu_torch.slam import graph as TG

    cfg = _cfg()
    cfg = cfg.replace(graph=dataclasses.replace(cfg.graph, dtype="float64"))
    slam = PbMapGraphSLAM(builder, cfg)
    slam.timer.enable()
    before = dict(TG.LM_COUNTS)
    for raw in raws:
        slam.process(raw)
    slam.flush()
    spans = slam.timer.take_spans()
    opt = [s for s in spans if s.name == "optimize"]
    assert opt and slam.n_loop_closures > 0
    for s in opt:
        assert {"iters", "rejected", "n_kf", "dtype"} <= set(s.attrs), s.attrs
        assert 1 <= s.attrs["iters"] <= cfg.graph.max_iters
        assert 0 <= s.attrs["rejected"] <= s.attrs["iters"]
        assert 2 <= s.attrs["n_kf"] <= N and s.attrs["dtype"] == "float64"
    counts = slam.timer.counts
    assert counts["graph.lm_iter"] == sum(s.attrs["iters"] for s in opt)
    assert counts["graph.lm_reject"] == sum(s.attrs["rejected"] for s in opt)
    assert counts["graph.lm_iter"] == TG.LM_COUNTS["iter"] - before["iter"]
    assert counts["graph.lm_reject"] == TG.LM_COUNTS["reject"] - before["reject"]


def test_odometry_spans(builder, raws):
    odo = FrameToFrameOdometry(builder)
    odo.timer.enable()
    for raw in raws[:3]:
        odo.process(raw)
    spans = odo.timer.take_spans()
    frames = [s for s in spans if s.name == "frame"]
    aligns = [s for s in spans if s.name == "align"]
    assert [f.frame for f in frames] == [0, 1, 2] and len(aligns) == 2
    for a in aligns:
        f = _root(spans, a)
        assert a.attrs["sweeps"] > 0 and f.attrs["sweeps"] == a.attrs["sweeps"]
        assert f.attrs["solves"] == a.attrs["solves"] >= 1
