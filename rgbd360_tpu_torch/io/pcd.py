"""PCL `.pcd` point-cloud file writer, no PCL dependency (a copy of the
writer of `rgbd360_tpu/io/pcd.py`; the map export writes `map.pcd`).

The reference persists built keyframes as `.pcd` files plus a gzipped PbMap
(`Frame360::save`, reference `include/Frame360.h:321`; reload via
`loadCloud:187` and `load_PbMap_Cloud:213`), and `Visualization/
LoadSphere.cpp` views such a pair.  This module gives the port the same
interchange format so clouds flow to PCL-based tooling: PCD v0.7,
fields `x y z [rgb]`, `ascii` or `binary` DATA, organized or flat layouts.

RGB is packed the PCL way: the three u8 channels live in the low 24 bits of
a 4-byte word stored in a float field.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _pack_rgb(rgb: np.ndarray) -> np.ndarray:
    """(N, 3) u8 -> (N,) f32 with the PCL bit-packing."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    packed = (
        (rgb[:, 0].astype(np.uint32) << 16)
        | (rgb[:, 1].astype(np.uint32) << 8)
        | rgb[:, 2].astype(np.uint32)
    )
    return packed.view(np.float32)


def write_pcd(
    path: str | Path,
    xyz: np.ndarray,
    rgb: np.ndarray | None = None,
    binary: bool = True,
) -> int:
    """Write a point cloud as PCD v0.7; returns the number of points.

    xyz: (N, 3) or (H, W, 3) float; rgb: matching (..., 3) u8 (optional).
    NaN rows are kept (PCL's convention for invalid points in organized
    clouds) when the input is (H, W, 3); flat inputs drop non-finite rows.
    """
    xyz = np.asarray(xyz, np.float32)
    organized = xyz.ndim == 3
    if organized:
        h, w = xyz.shape[:2]
        pts = xyz.reshape(-1, 3)
        cols = None if rgb is None else np.asarray(rgb).reshape(-1, 3)
    else:
        keep = np.isfinite(xyz).all(axis=1)
        pts = xyz[keep]
        cols = None if rgb is None else np.asarray(rgb).reshape(-1, 3)[keep]
        h, w = 1, pts.shape[0]
    n = pts.shape[0]
    fields = ["x", "y", "z"] + (["rgb"] if cols is not None else [])
    nf = len(fields)
    header = "\n".join(
        [
            "# .PCD v0.7 - Point Cloud Data file format",
            "VERSION 0.7",
            "FIELDS " + " ".join(fields),
            "SIZE " + " ".join(["4"] * nf),
            "TYPE " + " ".join(["F"] * nf),
            "COUNT " + " ".join(["1"] * nf),
            f"WIDTH {w}",
            f"HEIGHT {h}",
            "VIEWPOINT 0 0 0 1 0 0 0",
            f"POINTS {n}",
            f"DATA {'binary' if binary else 'ascii'}",
            "",
        ]
    )
    body = pts if cols is None else np.column_stack([pts, _pack_rgb(cols)])
    body = body.astype(np.float32)
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(body.tobytes())
        else:
            np.savetxt(f, body, fmt="%.6g")
    return n
