"""Stage timing (twin of `rgbd360_tpu/utils/trace.py`).

A `StageTimer` collects wall time per named region (build / pyramid /
segment / register / align ...) and wraps each region in
`torch.profiler.record_function`, so the stages show up in a profiler
trace.  PyTorch runs the card asynchronously: by default a region measures
the host's enqueue time; with `sync=True` it ends with
`torch.cuda.synchronize()` (once the program uses the card) and measures
the stage's wall time.  `trace_to` captures a `torch.profiler` trace of
a region into a directory.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import torch


class StageTimer:
    """Accumulates wall time per named stage.

    with timer.region("stitch"):
        out = stitch(...)
    print(timer.report())
    """

    def __init__(self, sync: bool = False):
        self.sync = sync
        self.times = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def region(self, name: str):
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            yield
            if self.sync and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.times[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def add(self, name: str, seconds: float):
        self.times[name] += seconds
        self.counts[name] += 1

    def report(self) -> str:
        rows = ["stage                   total ms   calls   ms/call"]
        for name in sorted(self.times, key=lambda n: -self.times[n]):
            t = self.times[name] * 1000
            c = self.counts[name]
            rows.append(f"{name:<22} {t:9.2f} {c:7d} {t / max(c, 1):9.2f}")
        return "\n".join(rows)

    def reset(self):
        self.times.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace_to(logdir: str):
    """Capture a `torch.profiler` trace of the enclosed region (host ops,
    and the card's kernels once the program uses the card) into
    `logdir/trace.json`, a Chrome trace (view it with Perfetto or
    TensorBoard).  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
