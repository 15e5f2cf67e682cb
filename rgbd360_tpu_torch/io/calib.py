"""Rig calibration: per-sensor extrinsics, pinhole intrinsics, CLAMS models.

Mirrors the capability of the reference `include/Calib360.h`: extrinsics are
8 text files `Rt_0{1..8}.txt` holding 4x4 row-major matrices (sensor->rig),
intrinsics are the fixed QVGA pinhole matrix, and the intrinsic depth
distortion models come from CLAMS files `distortion_model{1..8}` downsampled
2x for QVGA (reference `include/Calib360.h:104-131`).

The result holds stacked numpy arrays with a leading sensor axis (a copy of
`rgbd360_tpu/io/calib.py`, field for field).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from rgbd360_tpu_torch.config import RigConfig
from rgbd360_tpu_torch.io.clams import ClamsModel, load_clams_model


@dataclass
class Calibration:
    """Stacked rig calibration.

    rt:        (S, 4, 4) float32 — sensor->rig transforms.
    rt_inv:    (S, 4, 4) float32 — rig->sensor transforms.
    k:         (3, 3) float32 — shared pinhole intrinsics.
    clams_multipliers/clams_counts: (S, nby, nbx, nbins) float32 or None.
    clams_bin_*: pixel->frustum grid parameters at working resolution.
    """

    rt: np.ndarray
    rt_inv: np.ndarray
    k: np.ndarray
    clams_multipliers: np.ndarray | None = None
    clams_counts: np.ndarray | None = None
    clams_bin_width: int = 4
    clams_bin_height: int = 3
    clams_bin_depth: float = 2.0

    @property
    def num_sensors(self) -> int:
        return self.rt.shape[0]


def load_extrinsics(path: str | Path, num_sensors: int = 8) -> np.ndarray:
    """Load `Rt_0*.txt` files (4x4 whitespace-separated, MRPT text format)."""
    path = Path(path)
    mats = []
    for s in range(1, num_sensors + 1):
        m = np.loadtxt(path / f"Rt_0{s}.txt", dtype=np.float64)
        if m.shape != (4, 4):
            raise ValueError(f"Rt_0{s}.txt: expected 4x4, got {m.shape}")
        mats.append(m)
    return np.stack(mats).astype(np.float32)


def pinhole_k(rig: RigConfig = RigConfig()) -> np.ndarray:
    return np.array(
        [[rig.fx, 0.0, rig.cx], [0.0, rig.fy, rig.cy], [0.0, 0.0, 1.0]],
        dtype=np.float32,
    )


def load_calibration(
    extrinsics_dir: str | Path,
    intrinsics_dir: str | Path | None = None,
    rig: RigConfig = RigConfig(),
    downsample_intrinsics: int = 2,
) -> Calibration:
    """Load the full rig calibration.

    `downsample_intrinsics=2` adapts the VGA CLAMS grids to QVGA, matching
    the reference `Calib360::loadIntrinsicCalibration` (`include/Calib360.h:122`).
    """
    rt = load_extrinsics(extrinsics_dir, rig.num_sensors)
    rt_inv = np.stack([np.linalg.inv(m.astype(np.float64)) for m in rt]).astype(
        np.float32
    )

    mult = counts = None
    bw, bh, bd = 4, 3, 2.0
    if intrinsics_dir is not None:
        models: list[ClamsModel] = []
        for s in range(1, rig.num_sensors + 1):
            m = load_clams_model(Path(intrinsics_dir) / f"distortion_model{s}")
            models.append(m.downsampled(downsample_intrinsics))
        bw, bh, bd = models[0].bin_width, models[0].bin_height, models[0].bin_depth
        mult = np.stack([m.multipliers for m in models])
        counts = np.stack([m.counts for m in models])

    return Calibration(
        rt=rt,
        rt_inv=rt_inv,
        k=pinhole_k(rig),
        clams_multipliers=mult,
        clams_counts=counts,
        clams_bin_width=bw,
        clams_bin_height=bh,
        clams_bin_depth=bd,
    )
