"""Stereo/ToF spherical frame I/O (a copy of `rgbd360_tpu/io/stereo.py`;
the reference `Frame360_stereo` variant).

That variant skips the 8-sensor stitch: the spherical depth comes from a raw
binary file ([u16 height][u16 width][f32 data, (width, height)-major,
transposed on load] — reference `include/Frame360_stereo.h:268-305`) and the
RGB from a PNG (`loadRGB:318`).  Frames loaded here feed straight into the
sphere-input SLAM path (`TrackerBase.make_state_from_sphere` /
`FrameBuilder.segment_planes_from_sphere`).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class StereoSphereFrame:
    rgb: np.ndarray | None  # (H, W, 3) uint8 BGR, or None
    depth: np.ndarray  # (H, W) float32 meters


def read_stereo_depth(path: str | Path) -> np.ndarray:
    """Parse the raw depth binary: 4-byte header (u16 height, u16 width)
    then height*width float32 written column-major wrt the final image."""
    raw = Path(path).read_bytes()
    if len(raw) < 4:
        raise ValueError(f"{path}: too short for a stereo depth file")
    height, width = struct.unpack_from("<HH", raw, 0)
    n = height * width
    if len(raw) < 4 + 4 * n:
        raise ValueError(
            f"{path}: expected {4 + 4 * n} bytes for {height}x{width}, got {len(raw)}"
        )
    data = np.frombuffer(raw, dtype="<f4", count=n, offset=4)
    # file stores a (width, height) matrix that the reference transposes
    return np.ascontiguousarray(data.reshape(width, height).T)


def write_stereo_depth(path: str | Path, depth: np.ndarray) -> None:
    depth = np.asarray(depth, np.float32)
    h, w = depth.shape
    out = struct.pack("<HH", h, w) + np.ascontiguousarray(depth.T).tobytes()
    Path(path).write_bytes(out)


def read_stereo_frame(
    depth_path: str | Path, rgb_path: str | Path | None = None
) -> StereoSphereFrame:
    depth = read_stereo_depth(depth_path)
    rgb = None
    if rgb_path is not None and Path(rgb_path).exists():
        from PIL import Image

        img = np.asarray(Image.open(rgb_path).convert("RGB"))
        rgb = img[..., ::-1].copy()  # PIL gives RGB; keep BGR like captures
    return StereoSphereFrame(rgb=rgb, depth=depth)
