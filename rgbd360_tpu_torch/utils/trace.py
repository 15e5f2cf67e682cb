"""The trackers' tracer: spans and counters (`rgbd360_tpu/utils/trace.py`
keeps the JAX package's always-on stage timer).

A `StageTimer` is off by default.  Off, `region(name)` hands back a shared
no-op context: it reads no clock and stores nothing, and it opens a
`torch.profiler.record_function` of the name only while a profiler session
is running, so a profile still names the program's stages.  `counts`
counts every region, in both modes, and takes counters of its own.

`enable()` turns it on.  Each region is then a span: a `record_function`
of its name (the device work launched inside is attributed to it in a
profile) and a `Span` record with its start and end on the host clock
that the profiler's host events use (`time.time_ns()`), its parent span,
the tracker's frame index and its attributes.  The records stay in memory
until `take_spans()` hands them over.  `report()` sums them by name into
host ms, with each name's self time.  The card runs asynchronously, so a
span's time is the host's: the enqueue, and the waits the host makes
inside it.  For device time, run a `torch.profiler` session around the
spans (`trace_to`).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

import torch

# whether a profiler session is running: a flag read, no dispatch.  A torch
# without the probe opens the ranges always.
_profiling = getattr(torch._C._autograd, "_profiler_enabled", lambda: True)
_NULL = contextlib.nullcontext()


@dataclass
class Span:
    """One region of an enabled timer.  `start_ns` and `end_ns` are
    `time.time_ns()` (the profiler's host clock), read inside the
    region's `record_function`; `parent` is the index of the enclosing
    span in the same list (-1 at the top); `frame` the tracker's frame
    index when the span opened."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    frame: int
    attrs: dict = field(default_factory=dict)

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class _Region:
    __slots__ = ("timer", "span", "rf")

    def __init__(self, timer: "StageTimer", name: str, attrs: dict):
        self.timer = timer
        self.span = Span(name, 0, 0, -1, timer.frame, attrs)
        self.rf = torch.profiler.record_function(name)

    def __enter__(self):
        t = self.timer
        sp = self.span
        if t._open:
            sp.parent = t._open[-1][0]
        t._open.append((len(t.spans), sp))
        t.spans.append(sp)
        # the clock right after the range opens: no allocation between the
        # two reads that could start a garbage collection
        self.rf.__enter__()
        sp.start_ns = time.time_ns()
        return None

    def __exit__(self, *exc):
        self.span.end_ns = time.time_ns()
        self.timer._open.pop()
        self.rf.__exit__(*exc)
        return False


class StageTimer:
    """Spans and counters of a tracker (see the module doc).

    timer.enable()
    with timer.region("stitch"):
        out = stitch(...)
    print(timer.report())
    spans = timer.take_spans()
    """

    def __init__(self):
        self.enabled = False
        self.counts = defaultdict(int)
        self.spans: list[Span] = []
        self.frame = -1  # the tracker's frame index, stamped on each span
        self._open: list[tuple[int, Span]] = []

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def region(self, name: str, **attrs):
        """A context for the named stage; `attrs` go on its span."""
        self.counts[name] += 1
        if self.enabled:
            return _Region(self, name, attrs)
        return torch.profiler.record_function(name) if _profiling() else _NULL

    def annotate(self, **attrs) -> None:
        """Set attributes on the innermost open span (enabled only)."""
        if self.enabled and self._open:
            self._open[-1][1].attrs.update(attrs)

    def tally(self, **counts) -> None:
        """Add each count to that attribute of every open span (enabled
        only): a stage's own total and its frame's."""
        if self.enabled:
            for _, sp in self._open:
                a = sp.attrs
                for k, n in counts.items():
                    a[k] = a.get(k, 0) + n

    def take_spans(self) -> list[Span]:
        """The spans recorded so far, in opening order; the timer keeps
        none of them.  Call it between frames: a `parent` indexes the list
        the span was handed over in."""
        out, self.spans = self.spans, []
        return out

    def report(self) -> str:
        """Host ms by span name, largest first: the total, the self time
        (less the spans opened inside) and the calls, then the counters
        with no span."""
        total, child, calls = defaultdict(int), defaultdict(int), defaultdict(int)
        for sp in self.spans:
            d = sp.end_ns - sp.start_ns
            total[sp.name] += d
            calls[sp.name] += 1
            if sp.parent >= 0:
                child[self.spans[sp.parent].name] += d
        rows = ["span (host ms)          total ms    self ms   calls   ms/call"]
        for name in sorted(total, key=lambda n: -total[n]):
            t, s, c = total[name] * 1e-6, (total[name] - child[name]) * 1e-6, calls[name]
            rows.append(f"{name:<22} {t:9.2f} {s:10.2f} {c:7d} {t / c:9.2f}")
        if not self.spans:
            rows.append("(no spans: the timer is off; timer.enable() records them)")
        rest = {n: c for n, c in self.counts.items() if n not in total}
        if rest:
            rows.append("counts: " + ", ".join(f"{n} {c}" for n, c in sorted(rest.items())))
        return "\n".join(rows)

    def reset(self) -> None:
        self.counts.clear()
        self.spans = []
        self._open = []


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
