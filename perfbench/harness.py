"""One run of one cell: set-up, warm-up, the measured window, the traced
laps (`--trace 1`), the check against the plain reference, the result.

Everything that belongs to a cell is data found by name under this
folder: `configs/<config>.json` (the deployment and the tracker that runs
it), `traffic/<traffic>.json` (the generator's parameters), `limits/<cell>
.json` (the limit of each number compared) and `metrics/<metric>.py` (one
reader per metric, `read(run)` -> value or None).  `BENCHMARK.json` says
which metrics a cell reports.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rgbd360_tpu")
# host ranges the traced run keeps: the program's stage regions and the
# benchmark's own
RANGES = ("stitch", "cloud", "pyramid", "segment", "build", "fused_track", "register_pbmap",
          "register_dense", "loop_closure", "optimize", "bench.register", "bench.align",
          "bench.event")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def framework_config(cfg_file: dict, subsample: int = 1):
    """The program's configuration as the file states it: the defaults,
    with the file's `framework` sections replaced field by field; a
    `subsample` over 1 (the tests' small rig) keeps every s-th sensor pixel
    and sphere pixel, with the intrinsics scaled."""
    from rgbd360_tpu_torch.config import default_config

    cfg = default_config()
    for section, fields in cfg_file["framework"].items():
        cfg = cfg.replace(**{section: dataclasses.replace(getattr(cfg, section), **fields)})
    s = subsample
    if s > 1:
        r = cfg.rig
        cfg = cfg.replace(
            rig=dataclasses.replace(r, width=r.width // s, height=r.height // s, fx=r.fx / s,
                                    fy=r.fy / s, cx=r.cx / s, cy=r.cy / s),
            sphere=dataclasses.replace(cfg.sphere, width=cfg.sphere.width // s,
                                       height=cfg.sphere.height // s),
            dense=dataclasses.replace(cfg.dense, pyramid_levels=min(cfg.dense.pyramid_levels, 3)),
        )
    return cfg


def calibration_arrays(cfg, clams: dict) -> dict:
    """The calibration the benchmark hands both sides: construction-spec
    extrinsics, the rig's pinhole and a seeded CLAMS model."""
    from perfbench import scene

    rig = cfg.rig
    rt = scene.construction_spec_rt(rig.num_sensors, float(clams["ring_radius_m"]))
    k = np.array([[rig.fx, 0.0, rig.cx], [0.0, rig.fy, rig.cy], [0.0, 0.0, 1.0]], np.float32)
    mult, counts = scene.synthetic_clams(rig.num_sensors, rig.height, rig.width,
                                         int(clams["bin_width"]), int(clams["bin_height"]),
                                         int(clams["bins"]), int(clams["seed"]))
    return dict(rt=rt, k=k, mult=mult, counts=counts, bin_w=int(clams["bin_width"]),
                bin_h=int(clams["bin_height"]), bin_depth=float(clams["bin_depth_m"]))


def _tracker_class(spec: str):
    mod, cls = spec.split(":")
    return getattr(importlib.import_module(mod), cls)


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    setup_s: float
    frames: int
    window_s: float
    latencies_s: list
    trace: object  # reduce.Trace of the traced laps, or None
    config: object  # the program's FrameworkConfig


def _frame_failed(ev) -> bool:
    return bool(ev.get("lost")) or ev.get("tracked") is False


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t0: float,
             device: str = "cuda", subsample: int = 1, max_frames: int | None = None,
             control: bool = False, bench: dict | None = None,
             traffic_overrides: dict | None = None, cfg_file: dict | None = None,
             limits: dict | None = None) -> dict:
    """One run; returns the result line's content (without `device`'s
    card fields), with the compared numbers under `checks`.  `max_frames`
    ends the window after that many frames instead of `seconds`, and
    `traffic_overrides` replaces traffic parameters (the CPU tests);
    `cfg_file` and `limits` stand in for the cell's configuration file and
    limits file (a test's configuration that has no cell yet); `control`
    also computes the control's numbers."""
    import torch

    from perfbench import check, scene

    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg_file = cfg_file or load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = {**load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
               **(traffic_overrides or {})}
    limits = limits or load_json(HERE / "limits" / f"{workload}.json")

    from rgbd360_tpu_torch.core.frame import FrameBuilder
    from rgbd360_tpu_torch.io.calib import Calibration

    marks = {"imports": time.perf_counter() - t0}
    cfg = framework_config(cfg_file, subsample)
    cal = calibration_arrays(cfg, cfg_file["calibration"])
    builder = FrameBuilder(Calibration(
        rt=cal["rt"].astype(np.float32), rt_inv=np.linalg.inv(cal["rt"]).astype(np.float32),
        k=cal["k"], clams_multipliers=cal["mult"], clams_counts=cal["counts"],
        clams_bin_width=cal["bin_w"], clams_bin_height=cal["bin_h"],
        clams_bin_depth=cal["bin_depth"]), cfg, device=device)
    tracker = _tracker_class(cfg_file["tracker"])
    marks["builder"] = time.perf_counter() - t0
    traf = scene.LoopTraffic(traffic, seed, device, subsample)
    n_lap = traf.n
    marks["traffic"] = time.perf_counter() - t0

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    # warm-up: a throwaway tracker over the warm-up laps
    warm = tracker(builder)
    for i in range(n_lap * int(traffic["warmup_laps"])):
        warm.process(traf.warmup(i))
        if i == 0:
            marks["first_frame"] = time.perf_counter() - t0
    warm.flush()
    sync()
    del warm
    gc.collect()

    # the window: a fresh tracker on an empty map
    slam = tracker(builder)
    rec = check.Recorder(seed, traffic["sample"])
    rec.install(slam, builder, spans=trace)
    trace_lo = n_lap * int(traffic["trace_first_lap"])
    trace_hi = trace_lo + n_lap * int(traffic["trace_laps"])
    prof = prof_cm = None
    lat, failed, errors = [], 0, []
    setup_s = time.perf_counter() - t0
    t_start = time.perf_counter()
    i = 0
    while True:
        if trace and i == trace_lo:
            from torch.profiler import ProfilerActivity, profile

            sync()
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device != "cpu" else [])
            prof = profile(activities=acts)
            prof.__enter__()
            prof_cm = torch.profiler.record_function("bench.window")
            prof_cm.__enter__()
        raw = traf.frame(i)
        rec.frame = i
        t1 = time.perf_counter()
        try:
            ev = slam.process(raw)
            _ = slam.trajectory[-1]
        except Exception:  # a frame that raises counts as failed; the window goes on
            ev = {"lost": True}
            if len(errors) < 3:
                errors.append(traceback.format_exc())
        t2 = time.perf_counter()
        lat.append(t2 - t1)
        failed += _frame_failed(ev)
        i += 1
        if trace and i == trace_hi:
            # the window's clock stops while the profiler shuts down, so a
            # traced window holds as many frames as an untraced one and
            # reaches the same drawn sample
            sync()
            t_pause = time.perf_counter()
            prof_cm.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            t_start += time.perf_counter() - t_pause
        done = i >= max_frames if max_frames else t2 - t_start >= seconds
        if done and (not trace or i >= trace_hi):
            break
    slam.flush()
    sync()
    t_end = time.perf_counter()
    rec.uninstall()
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    for e in errors:
        print(e, file=sys.stderr)

    # what the user sees besides the metrics: accuracy against the truth
    from perfbench.accuracy import ate_rmse

    est = np.stack(slam.trajectory)
    gt = np.stack([traf.gt(k) for k in range(len(est))])
    work = {"keyframes": int(slam.map.n_kf), "loop_closures": int(slam.n_loop_closures)}
    ms = 1e3 * np.asarray(lat)
    print(json.dumps({"ate_m": ate_rmse(est, gt), "frames": i, **work, "failed": failed,
                      "calls": rec.calls,
                      "frame_ms_p50": float(np.percentile(ms, 50)),
                      "frame_ms_p90": float(np.percentile(ms, 90)),
                      "frame_ms_p95": float(np.percentile(ms, 95)),
                      "frame_ms_max": float(ms.max()),
                      "setup_marks_s": {**marks, "warmup": setup_s}}))

    # the program's state goes before the reference runs; the recorded
    # answers stay
    del slam, builder
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    d = cfg.dense
    dense = {k: getattr(d, k) for k in (
        "min_depth", "max_depth", "pyramid_levels", "std_photo", "std_depth", "sal_intensity",
        "sal_depth", "max_iters_per_level", "tol_update", "tol_residual")}
    m = cfg.matcher
    matcher = {k: getattr(m, k) for k in (
        "min_planes_recognition", "unary_dist_d", "unary_angle_deg", "hue_threshold",
        "area_threshold", "elongation_threshold", "binary_dist_threshold",
        "binary_angle_threshold_deg", "height_threshold", "max_matches")}
    rig_args = (cal["rt"], cal["k"], (cfg.sphere.height, cfg.sphere.width),
                (cfg.rig.height, cfg.rig.width), cal["mult"], cal["counts"], cal["bin_w"],
                cal["bin_h"], cal["bin_depth"], device)
    nums = check.numbers(rec, rig_args, traf.frame, dense, matcher)
    correct, checks = check.judge(nums, limits)
    # a frame that raised or came back lost is a wrong answer
    checks["failed_frames"] = {"value": failed, "limit": 0}
    correct = correct and failed == 0
    out = {"correct": correct, "attempted": i, "failed": failed}

    tr = None
    if trace:
        from perfbench import reduce

        tr = reduce.reduce(prof, trace_hi - trace_lo, RANGES)
        if tr.unattributed:
            print(f"{tr.unattributed} device events without their launch", file=sys.stderr)
    run = Run(setup_s=setup_s, frames=i, window_s=t_end - t_start, latencies_s=lat, trace=tr,
              config=cfg)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench[kind]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        v = _reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out["metrics"] = metrics
    out["device"] = {"memory_peak_bytes": int(peak)}
    # the window's work, which host timing can change: keyframes promoted
    # and closures accepted
    out["work"] = work
    if tr is not None:
        out["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s())
        out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    if control:
        out["control"] = check.numbers(rec, rig_args, traf.frame, dense, matcher,
                                       control=True)
        out["control_correct"] = check.judge(out["control"], limits)[0]
    out["checks"] = checks
    return out


def main(argv, t0: float) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0, bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: the benchmark runs the port alone",
              file=sys.stderr)
        return 4
    out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                     **out["device"]}
    checks = out.pop("checks")
    out["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(out))
    return 0
