"""Offline visualization: PNG / GIF / PLY export without GUI dependencies (a
copy of `rgbd360_tpu/utils/viz.py`).

Replaces the reference's PCL CloudViewer windows (reference
`include/Frame360_Visualizer.h`, `include/Map360_Visualizer.h`) with
file-based rendering suitable for headless hosts: spherical images go to
PNG (a sequence to an animated GIF), point clouds and trajectories to PLY, and the map viewer's four view
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


def _lzw_encode(indices: np.ndarray, code_bits: int) -> bytes:
    """GIF-flavor LZW for a stream of palette indices (variable-width codes,
    dictionary reset at 4096 entries)."""
    clear = 1 << code_bits
    eoi = clear + 1
    out = bytearray()
    acc = 0
    nbits = 0

    def emit(code: int, width: int):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    table = {(i,): i for i in range(clear)}
    next_code = eoi + 1
    width = code_bits + 1
    emit(clear, width)
    seq: tuple = ()
    for sym in indices.tolist():
        cand = seq + (sym,)
        if cand in table:
            seq = cand
            continue
        emit(table[seq], width)
        table[cand] = next_code
        next_code += 1
        if next_code > (1 << width) and width < 12:
            width += 1
        if next_code >= 4096:
            emit(clear, width)
            table = {(i,): i for i in range(clear)}
            next_code = eoi + 1
            width = code_bits + 1
        seq = (sym,)
    if seq:
        emit(table[seq], width)
    emit(eoi, width)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def save_gif(path: str | Path, frames, fps: float = 10.0) -> None:
    """Write an animated GIF from (H, W, 3) uint8-able RGB frames (no deps).

    Covers the reference's "save video" sequence-viewer mode
    (`Visualization/LoadSequence.cpp:59-65`) on headless hosts.  Colors are
    quantized to a fixed 3-3-2 RGB palette (256 entries).
    """
    frames = [np.clip(np.asarray(f), 0, 255).astype(np.uint8) for f in frames]
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    delay_cs = max(2, int(round(100.0 / fps)))

    # 3-3-2 palette
    pal = np.zeros((256, 3), np.uint8)
    idx = np.arange(256)
    pal[:, 0] = ((idx >> 5) & 7) * 255 // 7
    pal[:, 1] = ((idx >> 2) & 7) * 255 // 7
    pal[:, 2] = (idx & 3) * 255 // 3

    out = bytearray()
    out += b"GIF89a"
    out += struct.pack("<HHBBB", w, h, 0xF7, 0, 0)  # global palette, 256 colors
    out += pal.tobytes()
    # netscape loop extension (loop forever)
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    for f in frames:
        if f.ndim == 2:
            f = np.stack([f] * 3, -1)
        q = ((f[..., 0] >> 5).astype(np.uint16) << 5) | (
            (f[..., 1] >> 5).astype(np.uint16) << 2
        ) | (f[..., 2] >> 6).astype(np.uint16)
        out += b"\x21\xf9" + struct.pack("<BBHBB", 4, 0, delay_cs, 0, 0)
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0)
        out += bytes([8])  # LZW min code size
        data = _lzw_encode(q.reshape(-1).astype(np.int32), 8)
        for i in range(0, len(data), 255):
            block = data[i : i + 255]
            out += bytes([len(block)]) + block
        out += b"\x00"
    out += b"\x3b"
    Path(path).write_bytes(bytes(out))


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
