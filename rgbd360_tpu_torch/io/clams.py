"""Loader for CLAMS discrete depth distortion models.

The reference undistorts each sensor's depth map with a CLAMS
`DiscreteDepthDistortionModel` (reference
`OpenNI2_Grabber/third_party/CLAMS/discrete_depth_distortion_model.cpp`):
the image is divided into a grid of frustums (bin_width x bin_height pixels),
each holding per-depth-bin multiplicative corrections.  The model file format
(written by `DiscreteDepthDistortionModel::serialize`, `:244-258`) is:

    "DiscreteDepthDistortionModel v01\n"
    i32 width, i32 height, i32 bin_width, i32 bin_height, f64 bin_depth,
    i32 num_bins_x, i32 num_bins_y
    then num_bins_y * num_bins_x frustums, each:
        f64 max_dist, i32 num_bins, f64 bin_depth,
        4 x eigen vector [i32 sizeof][i32 rows][i32 cols][f32 data]
        (counts, total_numerators, total_denominators, multipliers)

Here the whole model becomes two dense arrays `multipliers` and `counts` of
shape (num_bins_y, num_bins_x, num_bins) — the undistortion op in
`ops/undistort.py` is then a pure gather + interpolate + multiply.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

_MAGIC = b"DiscreteDepthDistortionModel v01\n"


@dataclass
class ClamsModel:
    """Dense-array form of a CLAMS depth distortion model (one sensor).

    multipliers/counts: (num_bins_y, num_bins_x, num_bins) float32.
    width/height/bin_width/bin_height describe the pixel->frustum mapping
    (already downsampled to the working resolution).
    """

    width: int
    height: int
    bin_width: int
    bin_height: int
    bin_depth: float
    multipliers: np.ndarray
    counts: np.ndarray

    def downsampled(self, step: int) -> "ClamsModel":
        """Adapt the pixel grid for a downsampled image (reference
        `discrete_depth_distortion_model.cpp:downsampleParams`)."""
        assert self.bin_width % step == 0 and self.bin_height % step == 0
        return ClamsModel(
            width=self.width // step,
            height=self.height // step,
            bin_width=self.bin_width // step,
            bin_height=self.bin_height // step,
            bin_depth=self.bin_depth,
            multipliers=self.multipliers,
            counts=self.counts,
        )


def _read_eigen_vec(buf: memoryview, off: int):
    nbytes, rows, cols = struct.unpack_from("<iii", buf, off)
    off += 12
    assert nbytes == 4, f"expected f32 eigen data, got elem size {nbytes}"
    n = rows * cols
    data = np.frombuffer(buf, dtype="<f4", count=n, offset=off)
    return data, off + 4 * n


def load_clams_model(path: str | Path) -> ClamsModel:
    raw = Path(path).read_bytes()
    if not raw.startswith(_MAGIC):
        raise ValueError(f"{path}: bad CLAMS model magic")
    buf = memoryview(raw)
    off = len(_MAGIC)
    width, height, bin_width, bin_height = struct.unpack_from("<iiii", buf, off)
    off += 16
    (bin_depth,) = struct.unpack_from("<d", buf, off)
    off += 8
    nbx, nby = struct.unpack_from("<ii", buf, off)
    off += 8

    mult = np.empty((nby, nbx, 0), dtype=np.float32)
    counts = np.empty((nby, nbx, 0), dtype=np.float32)
    first = True
    for y in range(nby):
        for x in range(nbx):
            off += 8  # f64 max_dist (always 10.0)
            (nbins,) = struct.unpack_from("<i", buf, off)
            off += 4
            off += 8  # f64 frustum bin_depth (== model bin_depth)
            cnt, off = _read_eigen_vec(buf, off)
            _, off = _read_eigen_vec(buf, off)  # total_numerators
            _, off = _read_eigen_vec(buf, off)  # total_denominators
            m, off = _read_eigen_vec(buf, off)
            if first:
                mult = np.ones((nby, nbx, nbins), dtype=np.float32)
                counts = np.ones((nby, nbx, nbins), dtype=np.float32)
                first = False
            mult[y, x] = m
            counts[y, x] = cnt
    if off != len(raw):
        raise ValueError(f"{path}: trailing bytes ({len(raw) - off})")

    return ClamsModel(
        width=width,
        height=height,
        bin_width=bin_width,
        bin_height=bin_height,
        bin_depth=float(bin_depth),
        multipliers=mult,
        counts=counts,
    )
