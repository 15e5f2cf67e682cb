"""Offline visualization: PNG / PLY export without GUI dependencies (a copy
of `rgbd360_tpu/utils/viz.py` without its GIF writer, which only the
reference's sequence viewer uses).

Replaces the reference's PCL CloudViewer windows (reference
`include/Frame360_Visualizer.h`, `include/Map360_Visualizer.h`) with
file-based rendering suitable for headless hosts: spherical images go to
PNG, point clouds and trajectories to PLY, and the map viewer's four view
modes become the file exporter `apps/kf_slam.export_map`.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def save_png(path: str | Path, arr: np.ndarray) -> None:
    """Write an (H, W) or (H, W, 3) uint8-able array as PNG (no deps)."""
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    arr = np.clip(arr, 0, 255).astype(np.uint8)
    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw))
        + chunk(b"IEND", b"")
    )
    Path(path).write_bytes(png)


def depth_to_gray(depth: np.ndarray, max_depth: float = 6.0) -> np.ndarray:
    """Depth (m) -> displayable 0..255 grayscale."""
    return np.clip(np.asarray(depth) / max_depth * 255.0, 0, 255)


def bgr_to_rgb(img: np.ndarray) -> np.ndarray:
    return np.asarray(img)[..., ::-1]


def save_ply(
    path: str | Path,
    xyz: np.ndarray,
    rgb: np.ndarray | None = None,
    valid: np.ndarray | None = None,
) -> int:
    """Write a point cloud as binary little-endian PLY; returns #points.

    xyz (..., 3) float; rgb (..., 3) 0..255; valid optional mask.
    """
    pts = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
    mask = np.isfinite(pts).all(axis=1)
    if valid is not None:
        mask &= np.asarray(valid).reshape(-1)
    pts = pts[mask]
    n = pts.shape[0]
    has_color = rgb is not None
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {a}" for a in "xyz"]
    if has_color:
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
    header += ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode())
        if has_color:
            cols = np.asarray(rgb).reshape(-1, 3)[mask]
            cols = np.clip(cols, 0, 255).astype(np.uint8)
            rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = pts
            rec["rgb"] = cols
            f.write(rec.tobytes())
        else:
            f.write(pts.astype("<f4").tobytes())
    return n


def save_trajectory_ply(path: str | Path, poses: np.ndarray) -> None:
    """Write camera centers of (N, 4, 4) poses as a PLY polyline cloud."""
    centers = np.asarray(poses)[:, :3, 3]
    save_ply(path, centers)


def save_graph_ply(
    path: str | Path,
    centers: np.ndarray,
    edges: np.ndarray,
    colors: np.ndarray | None = None,
) -> None:
    """Write a pose graph as PLY vertices + edge elements (the
    Map360_Visualizer keyframe-topology view, reference
    `include/Map360_Visualizer.h:63-68`, as a file).

    centers (N, 3); edges (E, 2) int vertex indices; colors (N, 3) 0..255
    (e.g. one color per topological area).
    """
    centers = np.asarray(centers, np.float32).reshape(-1, 3)
    edges = np.asarray(edges, np.int32).reshape(-1, 2)
    n, e = centers.shape[0], edges.shape[0]
    has_color = colors is not None
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {a}" for a in "xyz"]
    if has_color:
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
    header += [
        f"element edge {e}",
        "property int vertex1",
        "property int vertex2",
        "end_header",
        "",
    ]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode())
        if has_color:
            cols = np.clip(np.asarray(colors).reshape(-1, 3), 0, 255).astype(np.uint8)
            rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = centers
            rec["rgb"] = cols
            f.write(rec.tobytes())
        else:
            f.write(centers.astype("<f4").tobytes())
        f.write(edges.astype("<i4").tobytes())


# Distinct colors for topological areas (reference `Miscellaneous.h:78-84`
# color LUT used by the viewers).
AREA_COLORS = np.array(
    [
        [255, 80, 80],
        [80, 200, 80],
        [90, 120, 255],
        [240, 200, 60],
        [200, 90, 220],
        [70, 220, 220],
        [245, 140, 50],
        [150, 150, 150],
    ],
    np.uint8,
)
