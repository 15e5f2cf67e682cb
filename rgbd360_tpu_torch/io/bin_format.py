"""Reader/writer for the rig's `sphere_images_*.bin` capture format (a copy
of `rgbd360_tpu/io/bin_format.py`; `RawRigFrame` is the port's one class for
a raw capture on the host, re-exported by `core.frame`).

The reference serializes each rig frame as a boost binary archive of 16
cv::Mat objects — 8x (RGB 8UC3 320x240, depth 16UC1 320x240) — followed by a
timestamp matrix (reference `include/Frame360.h:231-263` for the reader,
`:333-347` for the writer; the cv::Mat framing is defined by
`OpenNI2_Grabber/third_party/cvSerialization/cvmat_serialization.h`:
[int32 cols][int32 rows][uint64 elem_size][uint64 elem_type][raw data]).

Archive layout (verified byte-for-byte against `samples/sphere_images_1.bin`):

    [u64 len=22]["serialization::archive"][u16 libver][5 archive-header bytes]
    [8 bytes class metadata (version+tracking) for the first cv::Mat]
    16 x ([i32 cols][i32 rows][u64 elem_size][u64 elem_type][data])
    1 x empty timestamp Mat (all-zero header)

The header of every matrix carries its cols and rows, so captures of a
reduced size round-trip too.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

_SIGNATURE = b"serialization::archive"
# Archive header captured from files produced by the reference writer
# (boost 1.x binary_oarchive): library version 9 + 5 trailing header bytes.
_HEADER = struct.pack("<Q", len(_SIGNATURE)) + _SIGNATURE + bytes(
    [0x09, 0x00, 0x04, 0x08, 0x04, 0x08, 0x01]
)
_FIRST_CLASS_META = bytes(8)  # class version + tracking word for cv::Mat

CV_8UC3 = 16
CV_16UC1 = 2


@dataclass
class RawRigFrame:
    """One raw rig capture on the host: S RGB + S depth images and a
    timestamp (what `RigFrame.from_raw` takes).

    rgb:      (S, H, W, 3) uint8, BGR channel order as captured by OpenCV
              (8x240x320 for the rig).
    depth_mm: (S, H, W) uint16, depth in millimeters (0 = invalid).
    """

    rgb: np.ndarray
    depth_mm: np.ndarray
    timestamp: int = 0

    @property
    def depth_m(self) -> np.ndarray:
        """Depth in meters, float32 (0 = invalid)."""
        return self.depth_mm.astype(np.float32) * 0.001


def _read_mat(buf: memoryview, off: int):
    cols, rows = struct.unpack_from("<ii", buf, off)
    elem_size, elem_type = struct.unpack_from("<QQ", buf, off + 8)
    off += 24
    n = cols * rows * elem_size
    data = np.frombuffer(buf, dtype=np.uint8, count=n, offset=off)
    return (cols, rows, elem_size, elem_type, data), off + n


def read_rig_frame(path: str | Path, num_sensors: int = 8) -> RawRigFrame:
    """Parse one `sphere_images_*.bin` rig frame."""
    raw = Path(path).read_bytes()
    if raw[8 : 8 + len(_SIGNATURE)] != _SIGNATURE:
        raise ValueError(f"{path}: not a boost serialization archive")
    buf = memoryview(raw)
    off = len(_HEADER) + len(_FIRST_CLASS_META)

    rgbs, depths = [], []
    for _ in range(num_sensors):
        (cols, rows, esz, ety, data), off = _read_mat(buf, off)
        if ety != CV_8UC3 or esz != 3:
            raise ValueError(f"{path}: expected 8UC3 RGB mat, got type {ety}")
        rgbs.append(data.reshape(rows, cols, 3))
        (cols, rows, esz, ety, data), off = _read_mat(buf, off)
        if ety != CV_16UC1 or esz != 2:
            raise ValueError(f"{path}: expected 16UC1 depth mat, got type {ety}")
        depths.append(data.view(np.uint16).reshape(rows, cols))

    # Trailing timestamp matrix: the bundled samples store it empty; newer
    # captures store a 1x8 byte matrix holding a uint64 (reference
    # `include/Frame360.h:246-248`).
    timestamp = 0
    if off + 24 <= len(raw):
        (cols, rows, esz, _, data), off = _read_mat(buf, off)
        if cols * rows * esz == 8:
            timestamp = int(np.frombuffer(data, dtype="<u8")[0])

    return RawRigFrame(
        rgb=np.ascontiguousarray(np.stack(rgbs)),
        depth_mm=np.ascontiguousarray(np.stack(depths)),
        timestamp=timestamp,
    )


def write_rig_frame(path: str | Path, frame: RawRigFrame) -> None:
    """Serialize a rig frame in the exact reference byte layout."""
    n, rows, cols = frame.depth_mm.shape
    out = bytearray(_HEADER)
    out += _FIRST_CLASS_META
    for s in range(n):
        out += struct.pack("<iiQQ", cols, rows, 3, CV_8UC3)
        out += frame.rgb[s].astype(np.uint8).tobytes()
        out += struct.pack("<iiQQ", cols, rows, 2, CV_16UC1)
        out += frame.depth_mm[s].astype(np.uint16).tobytes()
    if frame.timestamp:
        out += struct.pack("<iiQQ", 8, 1, 1, 0)
        out += struct.pack("<Q", frame.timestamp)
    else:
        out += struct.pack("<iiQQ", 0, 0, 0, 0)
    Path(path).write_bytes(bytes(out))
