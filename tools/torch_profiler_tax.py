"""What one `torch.profiler` run costs the rest of a process, on one
CUDA device.

    for m in fresh one_profile kernel_phases; do
        python3 tools/torch_profiler_tax.py $m
    done

Each call is one process: it optionally profiles first (`one_profile`: a
single profiled `x + 1`; `kernel_phases`: `chip_smoke.py`'s phases b and c
with their profiler timings run at once), then runs the full-size
frame-to-frame odometry of the smoke's phase g three times and prints the
median `process` ms per tracked frame of each.  Compare the modes within one
call on the card: on an H100 a fresh process read 100-119 ms and one after a
single profiler run 129-192 ms, which is why `chip_smoke.py` takes its
profiler measurements last.  The first output line is the card's name and
power limit.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as S  # noqa: E402

MODES = ("fresh", "one_profile", "kernel_phases")


def main(argv=None) -> int:
    mode = (argv or sys.argv[1:] or ["fresh"])[0]
    if mode not in MODES:
        raise SystemExit(f"torch_profiler_tax: mode must be one of {MODES}")
    if not torch.cuda.is_available():
        raise SystemExit("torch_profiler_tax: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0])
    S._build.load()
    if mode == "one_profile":
        x = torch.zeros(16, device="cuda")
        S._profile(lambda: x + 1)
    elif mode == "kernel_phases":
        rng = np.random.default_rng(0)
        S.check_k1(rng)
        S.check_k2(rng)
        for job in S._DEFERRED:
            job()
    cfg = S.synthetic.config()
    builder = S.FrameBuilder(S.synthetic.calibration(cfg.rig), cfg)
    raws = S.synthetic_raws(S.N_FRAMES)
    S.track_odometry(builder, raws)  # warm-up
    for _ in range(3):
        run = S.track_odometry(builder, raws)
        print(f"{mode}: process median "
              f"{statistics.median(run['process_ms'][1:]):.3f} ms per tracked frame", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
