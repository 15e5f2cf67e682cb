"""The readers of `tools/torch_trace_lap.py` on hand-built spans: two
frames, an event whose phases spread over both and one finished by the
closing flush, host waits placed by time."""

import sys
from pathlib import Path

import pytest

from rgbd360_tpu_torch.utils.trace import Span

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import torch_trace_lap as lap  # noqa: E402

MS = 1_000_000


def _spans():
    rows = [  # name, start ms, end ms, parent, frame, attrs
        ("frame", 0, 100, -1, 0, dict(sweeps=20, solves=1)),
        ("fused_track", 0, 60, 0, 0, {}),
        ("register", 10, 20, 1, 0, {}),
        ("align", 20, 50, 1, 0, dict(sweeps=20, solves=1)),
        ("track.fetch", 50, 55, 1, 0, {}),
        ("event.A", 60, 80, 0, 0, dict(event=1, enqueued=0)),
        ("event.drain", 80, 95, 0, 0, dict(why="backpressure")),
        ("event.B", 80, 95, 6, 0, dict(event=1, enqueued=0)),
        ("event.fetch", 80, 82, 7, 0, dict(event=1)),
        ("frame", 100, 200, -1, 1, dict(sweeps=30, solves=2)),
        ("align", 100, 130, 9, 1, dict(sweeps=10, solves=1)),
        ("register_dense", 130, 160, 9, 1, dict(sweeps=20, solves=1)),
        ("event.C", 160, 190, 9, 1, dict(event=1, enqueued=0, done=True)),
        ("event.fetch", 160, 165, 12, 1, dict(event=1)),
        ("event.drain", 200, 250, -1, 1, dict(why="flush")),
        ("event.A", 200, 250, 14, 1, dict(event=2, enqueued=1, done=True)),
    ]
    return [Span(n, a * MS, b * MS, p, f, at) for n, a, b, p, f, at in rows]


WAITS = [w * MS for w in (5, 15, 25, 52, 70, 120, 140, 220)]


def test_frame_own_ms():
    # 100 - 35 ms of phases and drains, 100 - 30 ms of phase C
    assert lap.frame_own_ms(_spans()) == pytest.approx(67.5)


def test_track_gn_sweeps():
    assert lap.track_gn_sweeps(_spans()) == pytest.approx(50 / 3)


def test_track_host_waits():
    # inside register, align, track.fetch, align, register_dense; not the
    # build's time in fused_track, an event phase or the flush
    assert lap.track_host_waits(_spans(), WAITS) == pytest.approx(5 / 2)


def test_backend_fetch_ms():
    assert lap.backend_fetch_ms(_spans()) == pytest.approx(7 / 2)


def test_backend_stall_ms():
    # the backpressure drain in frame 0; the flush stands outside the frames
    assert lap.backend_stall_ms(_spans()) == pytest.approx(15 / 2)


def test_backend_lag_frames():
    assert lap.backend_lag_frames(_spans()) == pytest.approx(0.5)
    undone = [s for s in _spans() if not s.attrs.get("done")]
    assert lap.backend_lag_frames(undone) is None


def test_readers_read_none_without_spans():
    """A program that records no spans (a tracer off, or none at all)."""
    assert lap.read_all([], WAITS) == dict.fromkeys(lap.READERS)


def test_clock_gaps_against_the_profilers_ranges():
    spans = _spans()
    ranges = {}
    for i, s in enumerate(spans):
        late = 2_000_000 if i == 3 else 50_000
        ranges.setdefault(s.name, []).append((s.start_ns - late, s.end_ns + 20_000))
    got = lap.clock_gaps(spans, ranges)
    assert got["start_max_us"] == pytest.approx(2000.0) and got["end_max_us"] == pytest.approx(20.0)
    assert got["starts_over_1ms"] == 1 and got["spans"] == len(spans)
    assert lap.clock_gaps(spans, {}) is None


def test_track_replay_share():
    spans = _spans()
    spans[0].attrs["replays"] = 20
    spans[9].attrs["replays"] = 25
    assert lap.track_replay_share(spans) == pytest.approx(45 / 50)
    assert lap.track_replay_share([s for s in spans if s.name != "frame"]) is None


def test_gn_graph_counts_over_the_lap():
    """The lap's `gn_graph.*` counts (the timer's less those before it)
    and the shares of trips replayed and swept by the normal-equations
    kernel; other counters are left out."""
    before = {"gn_graph.sweep": 40, "gn_graph.replay": 10, "gn_graph.normal_eq": 10,
              "gn_graph.capture": 12}
    counts = {"gn_graph.sweep": 100, "gn_graph.replay": 70, "gn_graph.normal_eq": 40,
              "gn_graph.capture": 12, "gn_graph.coarse": 3, "kf_pyramid.hit": 5, "align": 9}
    assert lap.gn_graph_counts(counts, before) == {
        "gn_graph.sweep": 60, "gn_graph.replay": 60, "gn_graph.normal_eq": 30,
        "gn_graph.capture": 0, "gn_graph.coarse": 3, "gn_graph.replay_share": 1.0,
        "gn_graph.normal_eq_share": 0.5}
    assert lap.gn_graph_counts({"kf_pyramid.hit": 1}) == {
        "gn_graph.replay_share": None, "gn_graph.normal_eq_share": None}


def test_graph_solves():
    spans = _spans() + [
        Span("optimize", 170 * MS, 175 * MS, 12, 1,
             dict(n_kf=4, dtype="float64", iters=10, rejected=7)),
        Span("optimize", 210 * MS, 215 * MS, 15, 1,
             dict(n_kf=6, dtype="float64", iters=2, rejected=0)),
    ]
    assert lap.graph_solves(_spans()) is None
    assert lap.graph_solves(spans) == {"solves": 2, "iters": 6.0, "rejected": 3.5, "n_kf": 5.0,
                                       "dtype": ["float64"]}


def test_graph_counts_are_read_beside_the_gn_graph_counts():
    counts = {"gn_graph.sweep": 10, "gn_graph.replay": 8, "graph.lm_iter": 12,
              "graph.lm_reject": 7, "optimize": 2}
    got = lap.gn_graph_counts(counts, {"graph.lm_iter": 2, "gn_graph.sweep": 2})
    assert got == {"gn_graph.sweep": 8, "gn_graph.replay": 8, "graph.lm_iter": 10,
                   "graph.lm_reject": 7, "gn_graph.replay_share": 1.0,
                   "gn_graph.normal_eq_share": 0.0}
