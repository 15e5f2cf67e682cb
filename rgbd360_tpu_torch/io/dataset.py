"""Sequence dataset over `sphere_images_*.bin` captures (a copy of
`rgbd360_tpu/io/dataset.py`).

Replaces the reference's sensor-grabber + file-walk loops (e.g.
`SLAM/SphereGraphSLAM.cpp:150` iterates `fexists(path/sphere_images_%d.bin)`)
with an indexable dataset that decodes frames with the native decoder
(`io.native`, built from `rgbd360_tpu_torch/native/loader.cpp` at first use;
a failed build raises) or, `SequenceDataset(native=False)` only, the
pure-Python parser (`io.bin_format`, the reference the tests hold the
decoder to), and optionally prefetches decode work on a background
thread, so host I/O overlaps device compute.
"""

from __future__ import annotations

import re
import threading
import queue
from pathlib import Path
from typing import Iterator

from rgbd360_tpu_torch.io import native as native_io
from rgbd360_tpu_torch.io.bin_format import RawRigFrame, read_rig_frame


class SequenceDataset:
    """Ordered collection of rig frames in a directory.

    Frames are discovered by the reference naming scheme
    `sphere_images_<idx>.bin` and ordered by index.
    """

    _PAT = re.compile(r"sphere_images_(\d+)\.bin$")

    def __init__(self, root: str | Path, prefetch: int = 2, native: bool = True):
        self.root = Path(root)
        self._decode = native_io.read_rig_frame if native else read_rig_frame
        found = []
        for p in sorted(self.root.glob("sphere_images_*.bin")):
            m = self._PAT.search(p.name)
            if m:
                found.append((int(m.group(1)), p))
        found.sort()
        self.indices = [i for i, _ in found]
        self.paths = [p for _, p in found]
        self.prefetch = prefetch

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int) -> RawRigFrame:
        return self._decode(self.paths[i])

    def __iter__(self) -> Iterator[RawRigFrame]:
        if self.prefetch <= 0 or len(self) <= 1:
            for p in self.paths:
                yield self._decode(p)
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        cancelled = threading.Event()

        def worker():
            try:
                for p in self.paths:
                    try:
                        item = self._decode(p)
                    except Exception as exc:  # propagate to the consumer
                        item = ("__error__", exc)
                    while not cancelled.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if cancelled.is_set() or isinstance(item, tuple):
                        return
            finally:
                while not cancelled.is_set():
                    try:
                        q.put(stop, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, tuple) and item and item[0] == "__error__":
                    raise item[1]
                yield item
        finally:
            cancelled.set()


class StreamingDataset:
    """Live capture stream over a directory being written by a producer.

    The analogue of the reference's online apps
    (`Registration/OnlineOdometryRGBD360.cpp:80-117` opens 8 OpenNI devices
    and grabs in a loop): here the "sensor" is whatever process is writing
    `sphere_images_<idx>.bin` files — the reference's own grabber
    (`Grabber/RGBD360_Grabber.cpp:91`) serializes exactly this layout — and
    the stream yields frames as they land, in index order.

    Termination mirrors the grabber's SIGINT handler
    (`Grabber/RGBD360_Grabber.cpp:63-79`): the stream ends when a
    `stop_file` appears (producer-side clean shutdown) or after
    `idle_timeout` seconds with no new frame (producer gone).

    Partially-written files are handled by retrying the decode until the
    file stops growing between polls.
    """

    _PAT = SequenceDataset._PAT

    def __init__(
        self,
        root: str | Path,
        poll: float = 0.05,
        idle_timeout: float = 10.0,
        stop_file: str = "capture_done",
    ):
        self.root = Path(root)
        self.poll = poll
        self.idle_timeout = idle_timeout
        self.stop_file = stop_file
        self.indices: list[int] = []

    def _scan(self, after: int) -> list[tuple[int, Path]]:
        out = []
        for p in self.root.glob("sphere_images_*.bin"):
            m = self._PAT.search(p.name)
            if m and int(m.group(1)) > after:
                out.append((int(m.group(1)), p))
        out.sort()
        return out

    def _decode_settled(self, path: Path) -> RawRigFrame:
        import time

        last_size = -1
        deadline = time.monotonic() + self.idle_timeout
        while True:
            try:
                size = path.stat().st_size
            except FileNotFoundError:
                size = -1
            if size > 0 and size == last_size:
                try:
                    return native_io.read_rig_frame(path)
                except Exception:
                    # mid-write torn read: fall through and re-poll
                    pass
            last_size = size
            if time.monotonic() > deadline:
                raise TimeoutError(f"frame never settled: {path}")
            time.sleep(self.poll)

    def __iter__(self) -> Iterator[RawRigFrame]:
        import time

        last_idx = -1
        last_event = time.monotonic()
        while True:
            fresh = self._scan(last_idx)
            if fresh:
                for idx, path in fresh:
                    frame = self._decode_settled(path)
                    self.indices.append(idx)
                    last_idx = idx
                    yield frame
                last_event = time.monotonic()
                continue
            if (self.root / self.stop_file).exists():
                return
            if time.monotonic() - last_event > self.idle_timeout:
                return
            time.sleep(self.poll)
