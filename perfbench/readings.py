"""The readings the limits are set from: one process runs a cell once per
seed at the cell's own size, load and window (the window has to reach the
calls the sample is drawn from), and prints the program's compared numbers
and, on the seeds asked for, the control's (the plain reference one
precision step down in the program's place):

    python3 perfbench/readings.py --workload kfslam.loop24 --seconds 51 \\
        --seeds 101,102,103 --control-seeds 101,102

One JSON line per seed; the last line holds, per number, the largest
program reading and the smallest control reading.  It needs a CUDA device.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)

    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 3
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    lower, upper = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = harness.run_cell(args.workload, seed, args.seconds, False, t0,
                               control=seed in ctrl)
        nums = {k: v["value"] for k, v in out["checks"].items()}
        for k, v in nums.items():
            lower[k] = max(lower.get(k, 0.0), float(v) if v is not None else float("inf"))
        for k, v in out.get("control", {}).items():
            upper[k] = min(upper.get(k, float("inf")), v)
        print(json.dumps({"seed": seed, "correct": out["correct"], "numbers": nums,
                          "control": out.get("control"),
                          "control_correct": out.get("control_correct"),
                          "frames": out["attempted"], "failed": out["failed"],
                          "frame_ms": out["metrics"].get("frame_ms", {}).get("value"),
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "program_max": lower, "control_min": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
