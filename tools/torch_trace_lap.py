"""A tracker's spans on the card: one traced lap of a benchmark cell's
traffic (`kfslam.loop24` unless `--cell` names another) read into the
per-frame numbers of the tracker and its keyframe back-end, and what the
tracer costs.

    python3 tools/torch_trace_lap.py --seeds 1 2 3 [--laps 2] [--cell C] [--out FILE]

Needs a CUDA card.  Set-up is the benchmark cell's (`perfbench.harness`:
the configuration, calibration and traffic files; a warm-up lap on a
throwaway tracker).  Then, per seed:

- cost: a fresh tracker over `--laps` laps with the tracer off, and
  another with it on (the order alternates by seed), each timed on the
  host clock through a synchronize: `frame_ms_off`, `frame_ms_on`;
- the traced lap: a fresh tracker, lap 0 untraced, lap 1 with the tracer
  on inside a `torch.profiler` session, with the benchmark's check
  installed as a traced run installs it (`bench.*` ranges); the lap's
  spans are read by `READERS` below, the benchmark's per-layer readers
  read the profile, and `clock` gives the gaps between the spans' starts
  and ends and the profiler's ranges of them.

One JSON line per seed on standard output, then one of the dense solves'
CUDA graphs (`gn_graphs`: captured in the warm-up lap and after it, the
cache's keys, and the device bytes the cache held and reserved, read by
clearing it),
and all of them in `--out`.
The readers take the lap's spans (`utils.trace.Span`) and the start times
(ns, the profiler's host clock) of its host-wait calls; each gives a number
per traced frame, or None where the program recorded no such span.  Beside
them: the tracker's `kf_pyramid.*` counts over both laps, its `gn_graph.*`
counts over the traced lap with the shares of every dense solve's GN trips
replayed and swept by the normal-equations kernel, and the tracking solves'
own replay share (`track.replay_share`); the graph
solves' `optimize` spans (`graph_solves`: their count, LM iterations and
rejected steps a solve, keyframes, precision) and the timer's
`graph.lm_iter` / `graph.lm_reject` counts over the traced lap.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

PHASE = "event."  # event.A ... event.D, event.rescue; not event.fetch / event.drain
BACKEND_WAITS = ("event.fetch", "event.drain")
TRACKING = ("register", "align", "track.fetch", "register_pbmap", "register_dense")


def _is_phase(name: str) -> bool:
    return name.startswith(PHASE) and name not in BACKEND_WAITS


def _union_ns(iv) -> int:
    """Measure of the union of (start, end) intervals."""
    total, end = 0, None
    for s, e in sorted(iv):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _frames(spans) -> list:
    return [s for s in spans if s.name == "frame"]


def _root(spans, sp):
    while sp.parent >= 0:
        sp = spans[sp.parent]
    return sp


def frame_own_ms(spans, waits=()):
    """Mean of each `frame` span's duration less the time inside it in
    event phases, `event.fetch` and `event.drain` spans."""
    frames = _frames(spans)
    if not frames:
        return None
    inner = [(s.start_ns, s.end_ns) for s in spans
             if _is_phase(s.name) or s.name in BACKEND_WAITS]
    own = []
    for f in frames:
        iv = [(max(a, f.start_ns), min(b, f.end_ns)) for a, b in inner
              if a < f.end_ns and b > f.start_ns]
        own.append(f.end_ns - f.start_ns - _union_ns(iv))
    return 1e-6 * float(np.mean(own))


def track_gn_sweeps(spans, waits=()):
    """Mean GN loop trips of a tracking solve: the frames' `sweeps` over
    their `solves` (the fused solve's `align` and `register_dense`'s own)."""
    frames = _frames(spans)
    solves = sum(f.attrs.get("solves", 0) for f in frames)
    if not solves:
        return None
    return sum(f.attrs.get("sweeps", 0) for f in frames) / solves


def track_host_waits(spans, waits=()):
    """Host-wait calls a traced frame whose start lies inside a tracking
    span (`TRACKING`), placed by time on the shared host clock."""
    frames = _frames(spans)
    if not frames:
        return None
    iv = sorted((s.start_ns, s.end_ns) for s in spans if s.name in TRACKING)
    if not iv:
        return None
    starts = np.asarray([a for a, _ in iv])
    ends = np.maximum.accumulate(np.asarray([b for _, b in iv]))
    t = np.asarray(sorted(waits), dtype=np.int64)
    k = np.searchsorted(starts, t, side="right") - 1
    inside = (k >= 0) & (t <= ends[np.clip(k, 0, None)])
    return float(inside.sum()) / len(frames)


def backend_fetch_ms(spans, waits=()):
    """Host ms a traced frame in `event.fetch` spans."""
    frames = _frames(spans)
    if not frames:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in spans if s.name == "event.fetch") / len(frames)


def backend_stall_ms(spans, waits=()):
    """Host ms a traced frame in `event.drain` spans inside `frame`
    spans."""
    frames = _frames(spans)
    if not frames:
        return None
    ns = sum(s.end_ns - s.start_ns for s in spans
             if s.name == "event.drain" and _root(spans, s).name == "frame")
    return 1e-6 * ns / len(frames)


def backend_lag_frames(spans, waits=()):
    """Mean frames from an event's enqueueing to the frame of its last
    phase, over the events whose last phase ran in the lap."""
    lags = [s.frame - s.attrs["enqueued"] for s in spans
            if _is_phase(s.name) and s.attrs.get("done")]
    return float(np.mean(lags)) if lags else None


READERS = {
    "frame.own_ms": frame_own_ms,
    "track.gn_sweeps": track_gn_sweeps,
    "track.host_waits": track_host_waits,
    "backend.fetch_ms": backend_fetch_ms,
    "backend.stall_ms": backend_stall_ms,
    "backend.lag_frames": backend_lag_frames,
}


def graph_solves(spans) -> dict | None:
    """The lap's `optimize` spans: how many, the mean LM iterations and
    rejected steps of a solve, the mean keyframes a solve covers and the
    precisions they ran in; None without a solve."""
    opt = [s for s in spans if s.name == "optimize"]
    if not opt:
        return None
    out = {k: float(np.mean([s.attrs.get(k, np.nan) for s in opt]))
           for k in ("iters", "rejected", "n_kf")}
    return {"solves": len(opt), **out, "dtype": sorted({str(s.attrs.get("dtype")) for s in opt})}


def read_all(spans, waits) -> dict:
    return {name: fn(spans, waits) for name, fn in READERS.items()}


def track_replay_share(spans):
    """The tracking solves' GN trips replayed from a CUDA graph over all
    their trips (the frames' `replays` over `sweeps`); None without
    trips."""
    frames = _frames(spans)
    sweeps = sum(f.attrs.get("sweeps", 0) for f in frames)
    return sum(f.attrs.get("replays", 0) for f in frames) / sweeps if sweeps else None


def gn_graph_counts(counts: dict, before: dict | None = None) -> dict:
    """The timer's `gn_graph.*` and `graph.*` counts less those in
    `before`, `gn_graph.replay_share`: every dense solve's GN trips
    replayed from a CUDA graph over all their trips, and
    `gn_graph.normal_eq_share`: those whose sweep went through the
    normal-equations kernel over all (each None without trips)."""
    before = before or {}
    got = {k: v - before.get(k, 0) for k, v in counts.items()
           if k.startswith(("gn_graph.", "graph."))}
    sweeps = got.get("gn_graph.sweep", 0)
    for name in ("replay", "normal_eq"):
        got[f"gn_graph.{name}_share"] = (
            got.get(f"gn_graph.{name}", 0) / sweeps if sweeps else None)
    return got


def clock_gaps(spans, ranges: dict) -> dict | None:
    """How far each span's start and end lie from the profiler's range of
    the same name (the n-th span of a name against the n-th range; names
    whose counts differ are left out): the largest and the 99th
    percentile start gap, the largest end gap (us), and the spans whose
    start is 1 ms or more off.  None where no name matches."""
    starts, ends = [], []
    by_name: dict = {}
    for s in spans:
        by_name.setdefault(s.name, []).append((s.start_ns, s.end_ns))
    for name, got in by_name.items():
        ref = sorted(ranges.get(name, ()))
        if len(ref) != len(got):
            continue
        for (a, b), (ra, rb) in zip(sorted(got), ref):
            starts.append(abs(a - ra) * 1e-3)
            ends.append(abs(b - rb) * 1e-3)
    if not starts:
        return None
    return {"start_max_us": max(starts), "start_p99_us": float(np.percentile(starts, 99)),
            "end_max_us": max(ends), "starts_over_1ms": sum(g >= 1e3 for g in starts),
            "spans": len(starts)}


# ------------------------------------------------------------------ on the card


def _setup(cell: str):
    from perfbench import harness
    from rgbd360_tpu_torch.core.frame import FrameBuilder
    from rgbd360_tpu_torch.io.calib import Calibration

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    w = next(w for w in bench["workloads"] if w["name"] == cell)
    cfg_file = harness.load_json(harness.HERE / "configs" / f"{w['config']}.json")
    traffic = harness.load_json(harness.HERE / "traffic" / f"{w['traffic']}.json")
    cfg = harness.framework_config(cfg_file)
    cal = harness.calibration_arrays(cfg, cfg_file["calibration"])
    builder = FrameBuilder(Calibration(
        rt=cal["rt"].astype(np.float32), rt_inv=np.linalg.inv(cal["rt"]).astype(np.float32),
        k=cal["k"], clams_multipliers=cal["mult"], clams_counts=cal["counts"],
        clams_bin_width=cal["bin_w"], clams_bin_height=cal["bin_h"],
        clams_bin_depth=cal["bin_depth"]), cfg, device="cuda")
    return bench, cfg, traffic, builder, harness._tracker_class(cfg_file["tracker"])


def cost_ms(tracker, builder, traf, laps: int, on: bool) -> float:
    """Host ms a frame of a fresh tracker over `laps` laps, through its
    flush and a synchronize, with the tracer on or off."""
    import torch

    slam = tracker(builder)
    if on:
        slam.timer.enable()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(traf.n * laps):
        slam.process(traf.frame(i))
    slam.flush()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / (traf.n * laps)


def traced_lap(bench, cfg, traffic, builder, tracker, traf, seed: int, cell: str) -> dict:
    """Lap 1 of a fresh tracker with the tracer on inside a profiler
    session, with the benchmark's check installed as in a traced run:
    the six readings, the benchmark's per-layer readings, the clock gaps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from perfbench import check, harness, reduce

    slam = tracker(builder)
    rec = check.Recorder(seed, traffic["sample"])
    rec.install(slam, builder, spans=True)
    n = traf.n
    for i in range(n):
        slam.process(traf.frame(i))
    torch.cuda.synchronize()
    before = dict(slam.timer.counts)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(reduce.WINDOW):
            slam.timer.enable()
            for i in range(n, 2 * n):
                slam.process(traf.frame(i))
            slam.timer.disable()
            torch.cuda.synchronize()
    spans = slam.timer.take_spans()
    rec.uninstall()
    tr = reduce.reduce(prof, n, sorted(set(harness.RANGES) | {s.name for s in spans}))
    waits = [ev.start_ns() for ev in prof.profiler.kineto_results.events()
             if ev.device_type() != DeviceType.CUDA and ev.name() in reduce.HOST_WAITS]
    run = harness.Run(setup_s=0.0, frames=n, window_s=tr.window_s(), latencies_s=[],
                      trace=tr, config=cfg)
    old = {m["name"]: harness._reader(m["name"])(run) for m in bench["per_layer"]
           if cell in m.get("workloads", [cell])}
    counts = {k: v for k, v in slam.timer.counts.items() if k.startswith("kf_pyramid.")}
    counts.update(gn_graph_counts(slam.timer.counts, before))
    return {"new": read_all(spans, waits), "track.replay_share": track_replay_share(spans),
            "graph_solves": graph_solves(spans),
            "per_layer": old, "clock": clock_gaps(spans, tr.raw_ranges), "spans": len(spans),
            "counts": counts, "idle_gaps": tr.idle_gaps(16),
            "memory_peak_bytes": torch.cuda.max_memory_allocated()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--laps", type=int, default=2, help="laps of each cost run")
    p.add_argument("--cell", default="kfslam.loop24", help="the benchmark cell whose "
                   "configuration and traffic to run")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    import torch

    sys.path.insert(0, str(ROOT))
    from perfbench import scene
    from rgbd360_tpu_torch.registration import dense as D

    bench, cfg, traffic, builder, tracker = _setup(args.cell)
    warm = scene.LoopTraffic(traffic, args.seeds[0], "cuda")
    slam = tracker(builder)
    for i in range(warm.n):
        slam.process(warm.warmup(i))
    slam.flush()
    torch.cuda.synchronize()
    del slam
    graphs = {"captured_in_warmup": D.GN_COUNTS["capture"]}
    trafs = {seed: scene.LoopTraffic(traffic, seed, "cuda") for seed in args.seeds}
    rows = []
    # every cost run before the first profiler session, which makes later
    # launches dearer on the host
    for j, seed in enumerate(args.seeds):
        ms = {}
        for on in ((False, True) if j % 2 == 0 else (True, False)):
            ms["on" if on else "off"] = cost_ms(tracker, builder, trafs[seed], args.laps, on)
        rows.append({"seed": seed, "frame_ms_off": ms["off"], "frame_ms_on": ms["on"]})
    for row in rows:
        row.update(traced_lap(bench, cfg, traffic, builder, tracker, trafs[row["seed"]],
                              row["seed"], args.cell))
        print(json.dumps(row), flush=True)
    graphs["captured_after_warmup"] = D.GN_COUNTS["capture"] - graphs["captured_in_warmup"]
    graphs["keys"] = len(D._GRAPHS)
    torch.cuda.synchronize()
    held, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    D._GRAPHS.clear()
    gc.collect()
    torch.cuda.empty_cache()
    graphs["bytes"] = held - torch.cuda.memory_allocated()
    graphs["reserved_bytes"] = reserved - torch.cuda.memory_reserved()
    print(json.dumps({"gn_graphs": graphs}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"seeds": rows, "gn_graphs": graphs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
