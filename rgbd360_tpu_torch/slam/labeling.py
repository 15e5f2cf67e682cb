"""Semantic plane labeling and propagation (a copy of
`rgbd360_tpu/slam/labeling.py`).

The reference supports semi-automatic labeling: a human assigns labels to
planes in one frame through a PCL viewer (`Labelization/LabelizeFrame360.cpp:
41-110`), and labels propagate along a registered sequence by matched-plane
voting at three granularities — plane / object / context
(`Labelization/LabelizeSequence.cpp:129-154`).

Here labels are a per-frame integer array aligned with the fixed-capacity
PlaneSet (one id per granularity level), plus a shared string table.  The
interactive step becomes file-based: `apps/labelize.py` renders plane
overlays to PNG with plane indices and reads label assignments from a JSON
mapping — same capability, no GUI dependency.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

LEVELS = ("plane", "object", "context")
UNLABELED = -1


@dataclass
class LabelStore:
    """Labels for a sequence of frames' plane sets.

    names: label string table (id -> name), shared across levels.
    frames: frame index -> (3, K) int32 (levels x plane slots).
    """

    capacity: int
    names: list = field(default_factory=list)
    frames: dict = field(default_factory=dict)

    def name_id(self, name: str) -> int:
        if name not in self.names:
            self.names.append(name)
        return self.names.index(name)

    def labels_for(self, frame: int) -> np.ndarray:
        if frame not in self.frames:
            self.frames[frame] = np.full((len(LEVELS), self.capacity), UNLABELED, np.int32)
        return self.frames[frame]

    def set_label(self, frame: int, plane: int, name: str, level: str = "plane"):
        lab = self.labels_for(frame)
        lab[LEVELS.index(level), plane] = self.name_id(name)

    def get_label(self, frame: int, plane: int, level: str = "plane") -> str | None:
        lab = self.labels_for(frame)
        lid = int(lab[LEVELS.index(level), plane])
        return self.names[lid] if lid >= 0 else None

    # --------------------------------------------------------- propagation

    def propagate(self, frame_from: int, frame_to: int, pairs: np.ndarray):
        """Copy labels along matched plane pairs (i_from, i_to), the
        reference's matched-plane label voting."""
        src = self.labels_for(frame_from)
        dst = self.labels_for(frame_to)
        for i, j in np.asarray(pairs):
            if i < 0 or j < 0:
                continue
            for lv in range(len(LEVELS)):
                if src[lv, i] != UNLABELED and dst[lv, j] == UNLABELED:
                    dst[lv, j] = src[lv, i]

    def propagate_sequence(self, match_fn, frames: list[int]):
        """Propagate labels along consecutive registered frames; match_fn
        (a, b) -> (M, 2) matched plane index pairs."""
        for a, b in zip(frames[:-1], frames[1:]):
            self.propagate(a, b, match_fn(a, b))

    # ----------------------------------------------------------------- IO

    def save(self, path: str) -> None:
        json.dump(
            {
                "capacity": self.capacity,
                "names": self.names,
                "frames": {str(k): v.tolist() for k, v in self.frames.items()},
            },
            open(path, "w"),
        )

    @staticmethod
    def load(path: str) -> "LabelStore":
        data = json.load(open(path))
        st = LabelStore(capacity=data["capacity"], names=list(data["names"]))
        st.frames = {
            int(k): np.asarray(v, np.int32) for k, v in data["frames"].items()
        }
        return st


def label_statistics(store: LabelStore, level: str = "plane") -> dict:
    """Count labeled planes per name across all frames."""
    lv = LEVELS.index(level)
    counts: dict[str, int] = {}
    for lab in store.frames.values():
        for lid in lab[lv]:
            if lid >= 0:
                name = store.names[int(lid)]
                counts[name] = counts.get(name, 0) + 1
    return counts
