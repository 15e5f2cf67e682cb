"""Point-cloud filters (reference `include/FilterPointCloud.h`; a copy of
`rgbd360_tpu/ops/filters.py`).

`filterEuclidean` = PassThrough box gate (reference defaults x in [-2, 1],
y/z in [-4, 4], `:66-71`); `filterVoxel` = VoxelGrid with 5 cm leaves
(`:73,92`).  The voxel filter hashes points to integer cells and averages
per cell — a sort/unique on host numpy (these filters feed visualization
and map export, not the hot path)."""

from __future__ import annotations

import numpy as np


def passthrough_box(
    pts: np.ndarray,
    x_range=(-2.0, 1.0),
    y_range=(-4.0, 4.0),
    z_range=(-4.0, 4.0),
) -> np.ndarray:
    """Boolean mask of points inside the box (reference filterEuclidean)."""
    pts = np.asarray(pts)
    return (
        (pts[:, 0] >= x_range[0]) & (pts[:, 0] <= x_range[1])
        & (pts[:, 1] >= y_range[0]) & (pts[:, 1] <= y_range[1])
        & (pts[:, 2] >= z_range[0]) & (pts[:, 2] <= z_range[1])
    )


def voxel_downsample(
    pts: np.ndarray, leaf: float = 0.05, colors: np.ndarray | None = None
):
    """Average points (and colors) per voxel cell; returns filtered arrays."""
    pts = np.asarray(pts, np.float64)
    finite = np.isfinite(pts).all(axis=1)
    pts = pts[finite]
    if colors is not None:
        colors = np.asarray(colors)[finite]
    if len(pts) == 0:
        return pts.astype(np.float32), colors
    cells = np.floor(pts / leaf).astype(np.int64)
    # hash 3D cells into one key
    key = (cells[:, 0] * 73856093) ^ (cells[:, 1] * 19349663) ^ (cells[:, 2] * 83492791)
    order = np.argsort(key)
    key_s = key[order]
    pts_s = pts[order]
    boundaries = np.concatenate([[True], key_s[1:] != key_s[:-1]])
    group = np.cumsum(boundaries) - 1
    n_groups = group[-1] + 1
    sums = np.zeros((n_groups, 3))
    np.add.at(sums, group, pts_s)
    counts = np.bincount(group).astype(np.float64)
    out = (sums / counts[:, None]).astype(np.float32)
    out_cols = None
    if colors is not None:
        cols_s = colors[order].astype(np.float64)
        csum = np.zeros((n_groups, colors.shape[1]))
        np.add.at(csum, group, cols_s)
        out_cols = (csum / counts[:, None]).astype(colors.dtype)
    return out, out_cols
