"""A `torch.profiler` session reduced to what the per-layer metrics read.

Frozen arithmetic from `chip_smoke.py` (repository commit e7cf3fe): the
device busy time is the union of the device events' intervals (without the
GPU copies of `record_function` ranges), and the host waits are the calls
in `HOST_WAITS`.  What is new here: every device event is attributed to
the host range its launch was made in, through the runtime call that
carries the same correlation id, so a layer's device time is the time of
the kernels launched inside that layer's ranges.

The profile is read from the profiler's raw events (`kineto_results`),
which avoids building the profiler's event tree for ~10^5-10^6 events.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

# CUDA runtime calls that block the host (`cudaDeviceSynchronize` is left
# out: the path never calls it, and the traced window's own closing
# synchronize is one)
HOST_WAITS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaMemcpy")
WINDOW = "bench.window"


def _merge(starts: np.ndarray, ends: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The union of intervals as sorted disjoint (starts, ends)."""
    if len(starts) == 0:
        return np.zeros(0), np.zeros(0)
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    first = np.flatnonzero(new)
    last = np.r_[first[1:] - 1, len(s) - 1]
    return s[first], run_end[last]


def _inside(t: np.ndarray, iv: tuple[np.ndarray, np.ndarray]) -> np.ndarray:
    """Which times lie inside the disjoint sorted intervals `iv`."""
    s, e = iv
    if len(s) == 0:
        return np.zeros(len(t), bool)
    k = np.searchsorted(s, t, side="right") - 1
    ok = k >= 0
    out = np.zeros(len(t), bool)
    out[ok] = t[ok] <= e[k[ok]]
    return out


def _measure(iv) -> float:
    return float(np.sum(iv[1] - iv[0]))


def _intersect(a, b):
    """Intersection of two disjoint sorted interval sets."""
    out_s, out_e = [], []
    i = j = 0
    while i < len(a[0]) and j < len(b[0]):
        lo, hi = max(a[0][i], b[0][j]), min(a[1][i], b[1][j])
        if lo < hi:
            out_s.append(lo)
            out_e.append(hi)
        if a[1][i] < b[1][j]:
            i += 1
        else:
            j += 1
    return np.asarray(out_s, float), np.asarray(out_e, float)


class Trace:
    """The reduced profile of the traced window.

    `ops`: device events (name, start, end, host launch time or NaN), in
    ns; `ranges`: host range name -> [(start, end)]; `waits`: host-wait
    calls by name.  `window` is the (start, end) of the traced window's
    own range."""

    def __init__(self, ops, ranges: dict, waits: dict, window: tuple, frames: int,
                 unattributed: int):
        self.names = [o[0] for o in ops]
        a = np.asarray([o[1:] for o in ops], float).reshape(-1, 3)
        self.start, self.end, self.launch = a[:, 0], a[:, 1], a[:, 2]
        self.ranges = {k: _merge(*map(np.asarray, zip(*v))) for k, v in ranges.items() if v}
        self.raw_ranges = ranges
        self.waits = waits
        self.window = window
        self.frames = frames
        self.unattributed = unattributed

    # ---------------------------------------------------------- queries

    def _union(self, names) -> tuple[np.ndarray, np.ndarray]:
        parts = [self.ranges[n] for n in names if n in self.ranges]
        if not parts:
            return np.zeros(0), np.zeros(0)
        return _merge(np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts]))

    def has(self, names) -> bool:
        return any(n in self.ranges for n in names)

    def device_s(self, include, exclude=()) -> float:
        """Device seconds of the events launched inside any `include`
        range and outside every `exclude` range."""
        m = _inside(self.launch, self._union(include))
        if exclude:
            m &= ~_inside(self.launch, self._union(exclude))
        return float(np.sum(self.end[m] - self.start[m])) * 1e-9

    def host_s(self, include, exclude=()) -> float:
        """Host seconds inside any `include` range and outside every
        `exclude` range."""
        inc = self._union(include)
        if not exclude:
            return _measure(inc) * 1e-9
        return (_measure(inc) - _measure(_intersect(inc, self._union(exclude)))) * 1e-9

    def range_count(self, name: str) -> int:
        return len(self.raw_ranges.get(name, ()))

    def busy(self) -> tuple[np.ndarray, np.ndarray]:
        """The union of the device intervals, inside the window."""
        iv = _merge(self.start, self.end)
        return _intersect(iv, (np.asarray([self.window[0]]), np.asarray([self.window[1]])))

    def busy_s(self) -> float:
        return _measure(self.busy()) * 1e-9

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def host_waits(self) -> int:
        return int(sum(self.waits.values()))

    # -------------------------------------------------------- breakdown

    def top_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time."""
        tot = defaultdict(float)
        for name, s, e in zip(self.names, self.start, self.end):
            tot[name] += (e - s) * 1e-9
        return [[k[:160], v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """[[host range, seconds]]: the device's idle time inside the
        window, summed by the innermost host range open at each gap's
        middle ("outside" where none is), largest first."""
        bs, be = self.busy()
        ws, we = self.window
        gs = np.r_[ws, be]
        ge = np.r_[bs, we]
        keep = ge > gs
        gs, ge = gs[keep], ge[keep]
        mid = (gs + ge) / 2
        label = np.full(len(mid), "outside", dtype=object)
        width = np.full(len(mid), np.inf)
        for name, iv in self.raw_ranges.items():
            if name == WINDOW:
                continue
            a = np.asarray(iv, float).reshape(-1, 2)
            order = np.argsort(a[:, 0])
            a = a[order]
            k = np.searchsorted(a[:, 0], mid, side="right") - 1
            ok = k >= 0
            inside = np.zeros(len(mid), bool)
            inside[ok] = mid[ok] <= a[k[ok], 1]
            w = np.where(inside, a[np.clip(k, 0, None), 1] - a[np.clip(k, 0, None), 0], np.inf)
            better = inside & (w < width)
            label[better] = name
            width[better] = w[better]
        tot = defaultdict(float)
        for lab, s, e in zip(label, gs, ge):
            tot[lab] += (e - s) * 1e-9
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def _call(ev, name, default=None):
    f = getattr(ev, name, None)
    if f is None:
        return default
    try:
        return f()
    except (RuntimeError, TypeError):
        return default


def reduce(prof, frames: int, range_names) -> Trace:
    """The Trace of a finished `torch.profiler.profile` session whose
    window is the `bench.window` range.  `range_names`: the host ranges to
    keep (program regions and the benchmark's own)."""
    from torch.autograd import DeviceType

    keep = set(range_names) | {WINDOW}
    ranges = defaultdict(list)
    waits = defaultdict(int)
    runtime = {}
    device = []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = ev.start_ns()
        dur = ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if _call(ev, "is_user_annotation", False) or name in keep:
                continue
            device.append((name, start, start + dur, ev.correlation_id()))
            continue
        if name in keep:
            ranges[name].append((start, start + dur))
        elif name.startswith("cuda"):
            runtime[ev.correlation_id()] = start
            if name in HOST_WAITS:
                waits[name] += 1
    ops, missing = [], 0
    for name, s, e, corr in device:
        t = runtime.get(corr)
        if t is None:
            missing += 1
        ops.append((name, s, e, np.nan if t is None else t))
    win = ranges.get(WINDOW)
    if not win:
        raise RuntimeError("the profile holds no bench.window range")
    window = (min(a for a, _ in win), max(b for _, b in win))
    return Trace(ops, dict(ranges), dict(waits), window, frames, missing)
