"""MRPT rawlog ingest — the `LoadRawlog` capability of the reference (a
copy of `rgbd360_tpu/io/rawlog.py`, its imports pointed at the port).

The reference's `Visualization/LoadRawlog.cpp:58-100` streams an MRPT rawlog
(a gzip file of serialized `mrpt::slam` observation objects), collects
`CObservation3DRangeScan` observations by sensor label ``RGBD1..RGBD4``,
permutes them with a fixed sensor arrangement, attaches construction-spec
ring poses (45-deg chain, first sensor 0.055 m off axis —
`LoadRawlog.cpp:72-92`), converts the float-meter range image to u16 mm
(`LoadRawlog.cpp:267-272`), and feeds the standard `Frame360` pipeline.

This module provides the same ingest path for this framework:

* the MRPT *container* wire format — gzip (``CFileGZInputStream``) stream of
  objects framed as ``[u8 0x80|len][class name][i8 version][payload][u8 0x88]``
  with ``<u32 len><bytes>`` strings — is implemented faithfully;
* *payload* codecs implement the actual MRPT 1.x wire layouts:
  ``CPose3D`` v0-v2 (v2 = translation + quaternion, 7 f64),
  ``CMatrix``/``CMatrixD`` v0 (u32 rows, u32 cols, row-major f32/f64),
  ``TCamera`` v0-v2 (focal length, 5 distortion f64, CMatrixD33 intrinsics,
  rows/cols), ``CImage`` v4-v9 (external-storage flag from v6; grayscale as
  raw row-padded bytes with an optional zlib block, color as an in-stream
  JPEG — decoded/encoded with OpenCV here), ``CObservation3DRangeScan``
  v2-v8 (maxRange, sensorPose, optional points3D with v8 pixel indices,
  optional range/intensity/confidence images, cameraParams from v2,
  intensity camera + relative pose from v4, stdError, timestamp, label,
  external-storage fields from v3, range_is_depth from v5,
  intensityImageChannel from v6, pixel-label flag from v7), and
  ``CObservation2DRangeScan`` v4-v7.  Writes are pinned at
  CObservation3DRangeScan v8 / CImage v7 / CPose3D v2 / TCamera v2 —
  exactly what MRPT 1.x emits.  A file carrying a class or version outside
  these ranges raises :class:`UnsupportedVersionError` *loudly* instead of
  misparsing, and every object's 0x88 end flag is verified so a layout
  mismatch cannot silently corrupt the stream.

Observation-only rawlogs ("format #2", what `getActionObservationPairOrObservation`
consumes at `LoadRawlog.cpp:182-188`) are supported for read and write;
sensory-frame rawlogs (format #1) are read by unwrapping each
``CSensoryFrame`` into its observations (action collections are rejected
loudly — the reference pipeline never consumes odometry actions).
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import BinaryIO, Iterable, Iterator

import numpy as np

from .bin_format import RawRigFrame

_END_FLAG = 0x88  # mrpt SERIALIZATION_END_FLAG
_GZIP_MAGIC = b"\x1f\x8b"

# Epoch offset between the MRPT TTimeStamp epoch (1601-01-01, 100 ns units —
# Windows FILETIME convention) and the unix epoch.
_MRPT_UNIX_EPOCH_100NS = 116444736000000000


class RawlogError(ValueError):
    pass


class UnknownClassError(RawlogError):
    """An object class this module has no codec for (e.g. the
    CActionCollection odometry hints interleaved in format-#1 rawlogs).
    The top-level reader resynchronizes past these — see `_resync`."""


class UnsupportedVersionError(RawlogError):
    def __init__(self, cls: str, version: int, supported: tuple[int, ...]):
        hint = (
            "; version 100 marks this framework's own pre-MRPT-codec "
            "interim format — re-export the source data with the current "
            "build"
            if version == 100
            else "; convert the capture to the sphere_images_*.bin format "
            "(io/bin_format.py) to ingest it"
        )
        super().__init__(
            f"{cls} serialization version {version} is not supported (this "
            f"build reads versions {supported}){hint}"
        )
        self.cls, self.version = cls, version


def unix_to_mrpt_timestamp(t_unix: float) -> int:
    return int(round(t_unix * 1e7)) + _MRPT_UNIX_EPOCH_100NS


def mrpt_to_unix_timestamp(ts: int) -> float:
    return (ts - _MRPT_UNIX_EPOCH_100NS) * 1e-7


# ---------------------------------------------------------------------------
# observation dataclasses

@dataclass
class TCamera:
    """mrpt::utils::TCamera (pinhole + 5-coefficient distortion)."""

    intrinsics: np.ndarray = field(default_factory=lambda: np.eye(3))
    dist: np.ndarray = field(default_factory=lambda: np.zeros(5))
    focal_length_meters: float = 0.0
    nrows: int = 480
    ncols: int = 640


@dataclass
class Obs3DRangeScan:
    """RGB-D observation (mrpt `CObservation3DRangeScan`, the payload the
    reference consumes: rangeImage, intensityImage, sensorPose, sensorLabel,
    timestamp — `LoadRawlog.cpp:199-283`)."""

    sensor_label: str = ""
    timestamp: int = 0  # MRPT TTimeStamp (100 ns since 1601)
    sensor_pose: np.ndarray = field(default_factory=lambda: np.eye(4))
    max_range: float = 10.0
    std_error: float = 0.01
    range_image: np.ndarray | None = None  # (H, W) float32 meters
    intensity_image: np.ndarray | None = None  # (H, W, 3) u8 BGR or (H, W) u8
    confidence_image: np.ndarray | None = None
    points3d: np.ndarray | None = None  # (N, 3) float32
    points3d_idxs: np.ndarray | None = None  # (N, 2) u16 (x, y) pixel origins
    camera_params: TCamera = field(default_factory=TCamera)
    camera_params_intensity: TCamera = field(default_factory=TCamera)
    rel_pose_intensity_wrt_depth: np.ndarray = field(
        default_factory=lambda: np.eye(4)
    )
    range_is_depth: bool = True
    intensity_channel: int = 0  # CH_VISIBLE


@dataclass
class Obs2DRangeScan:
    """Planar laser observation (the `LASER` label branch,
    `LoadRawlog.cpp:219-222`)."""

    sensor_label: str = ""
    timestamp: int = 0
    sensor_pose: np.ndarray = field(default_factory=lambda: np.eye(4))
    aperture: float = float(np.pi)
    right_to_left: bool = True
    max_range: float = 80.0
    ranges: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    validity: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    std_error: float = 0.01
    beam_aperture: float = 0.0
    delta_pitch: float = 0.0
    intensity: np.ndarray | None = None  # (N,) int32, v7+


# ---------------------------------------------------------------------------
# primitive wire helpers

class _Reader:
    def __init__(self, f: BinaryIO):
        self.f = f

    def bytes(self, n: int) -> bytes:
        b = self.f.read(n)
        if len(b) != n:
            raise RawlogError("unexpected end of rawlog stream")
        return b

    def u8(self) -> int:
        return self.bytes(1)[0]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.bytes(struct.calcsize(fmt)))

    def string(self) -> str:
        (n,) = self.unpack("<I")
        return self.bytes(n).decode("latin-1")

    def peek_eof(self) -> bool:
        b = self.f.read(1)
        if not b:
            return True
        self.f = _Pushback(self.f, b)
        return False


class _Pushback:
    def __init__(self, f: BinaryIO, pending: bytes):
        self._f, self._pending = f, pending

    def read(self, n: int = -1) -> bytes:
        p = self._pending
        if n is None or n < 0:
            self._pending = b""
            return p + self._f.read()
        if len(p) >= n:
            # keep the unconsumed tail (resync pushes back whole buffers,
            # not just peek_eof's single byte)
            self._pending = p[n:]
            return p[:n]
        self._pending = b""
        return p + self._f.read(n - len(p))


class _Writer:
    def __init__(self, f: BinaryIO):
        self.f = f

    def pack(self, fmt: str, *vals):
        self.f.write(struct.pack(fmt, *vals))

    def string(self, s: str):
        b = s.encode("latin-1")
        self.pack("<I", len(b))
        self.f.write(b)


def _pose_to_quat(rt: np.ndarray) -> np.ndarray:
    """4x4 -> (x, y, z, qr, qx, qy, qz) — the CPose3D v2 payload order."""
    from rgbd360_tpu_torch.apps._common import rotation_to_quaternion

    q = rotation_to_quaternion(np.asarray(rt[:3, :3], np.float64))
    return np.concatenate([np.asarray(rt[:3, 3], np.float64), q])


def _quat_to_pose(v: np.ndarray) -> np.ndarray:
    x, y, z, qr, qx, qy, qz = v
    n = np.sqrt(qr * qr + qx * qx + qy * qy + qz * qz)
    qr, qx, qy, qz = qr / n, qx / n, qy / n, qz / n
    rt = np.eye(4)
    rt[:3, :3] = [
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qr * qz), 2 * (qx * qz + qr * qy)],
        [2 * (qx * qy + qr * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qr * qx)],
        [2 * (qx * qz - qr * qy), 2 * (qy * qz + qr * qx), 1 - 2 * (qx * qx + qy * qy)],
    ]
    rt[:3, 3] = [x, y, z]
    return rt


# ---------------------------------------------------------------------------
# object-level codecs (className -> read/write of the payload)


def _read_object(r: _Reader):
    """Read one WriteObject-framed object: class name, version, payload."""
    len_byte = r.u8()
    if not len_byte & 0x80:
        raise RawlogError(
            "pre-2008 MRPT serialization (old object framing) is not supported"
        )
    try:
        name = r.bytes(len_byte & 0x7F).decode("ascii")
    except UnicodeDecodeError:
        raise UnknownClassError(
            "unreadable class name in object framing"
        ) from None
    (version,) = r.unpack("<b")
    obj = _read_payload(r, name, version)
    end = r.u8()
    if end != _END_FLAG:
        raise RawlogError(
            f"bad end-of-object flag 0x{end:02x} after {name} (expected 0x88); "
            f"the {name} v{version} payload layout in this file does not match "
            "this build's pinned codec"
        )
    return name, obj


def _write_object(w: _Writer, name: str, obj) -> None:
    w.pack("<B", 0x80 | len(name))
    w.f.write(name.encode("ascii"))
    w.pack("<b", _VERSIONS[name])
    _WRITERS[name](w, obj)
    w.pack("<B", _END_FLAG)


def _read_payload(r: _Reader, name: str, version: int):
    if name not in _READERS:
        raise UnknownClassError(
            f"unsupported rawlog object class '{name}' (supported: "
            f"{sorted(_READERS)})"
        )
    supported = _SUPPORTED_VERSIONS[name]
    if version not in supported:
        raise UnsupportedVersionError(name, version, supported)
    return _READERS[name](r, version)


def _read_cmatrix(r: _Reader, version: int) -> np.ndarray:
    """mrpt CMatrix v0: u32 rows, u32 cols, row-major f32 block."""
    rows, cols = r.unpack("<II")
    data = np.frombuffer(r.bytes(4 * rows * cols), "<f4")
    return data.reshape(rows, cols).copy()


def _write_cmatrix(w: _Writer, m: np.ndarray) -> None:
    m = np.asarray(m, np.float32)
    w.pack("<II", m.shape[0], m.shape[1])
    w.f.write(np.ascontiguousarray(m).tobytes())


def _read_cmatrixd(r: _Reader, version: int) -> np.ndarray:
    """mrpt CMatrixD v0: u32 rows, u32 cols, row-major f64 block."""
    rows, cols = r.unpack("<II")
    data = np.frombuffer(r.bytes(8 * rows * cols), "<f8")
    return data.reshape(rows, cols).copy()


def _write_cmatrixd(w: _Writer, m: np.ndarray) -> None:
    m = np.asarray(m, np.float64)
    w.pack("<II", m.shape[0], m.shape[1])
    w.f.write(np.ascontiguousarray(m).tobytes())


def _read_cpose3d(r: _Reader, version: int) -> np.ndarray:
    """mrpt CPose3D: v0 = CMatrix(f32 4x4 object), v1 = CMatrixD(4x4),
    v2 = CPose3DQuat payload [x y z qr qx qy qz] as 7 f64."""
    if version == 0:
        return np.asarray(_expect(r, "CMatrix"), np.float64).reshape(4, 4)
    if version == 1:
        return _expect(r, "CMatrixD").reshape(4, 4)
    return _quat_to_pose(np.array(r.unpack("<7d")))


def _write_cpose3d(w: _Writer, rt: np.ndarray) -> None:
    w.pack("<7d", *_pose_to_quat(rt))


def _read_tcamera(r: _Reader, version: int) -> TCamera:
    """mrpt::utils::TCamera: f64 focalLengthMeters, 5x f64 dist, 3x3
    intrinsics as a nested CMatrixD object; v0 trailed a CMatrixDouble15;
    v2 added u32 nrows, ncols."""
    cam = TCamera()
    (cam.focal_length_meters,) = r.unpack("<d")
    cam.dist = np.array(r.unpack("<5d"))
    cam.intrinsics = _expect(r, "CMatrixD").reshape(3, 3)
    if version == 0:
        _expect(r, "CMatrixD")  # legacy 1x5 distortion duplicate, discarded
    if version >= 2:
        cam.nrows, cam.ncols = r.unpack("<II")
    return cam


def _write_tcamera(w: _Writer, cam: TCamera) -> None:
    w.pack("<d", cam.focal_length_meters)
    w.pack("<5d", *np.asarray(cam.dist, np.float64))
    _write_object(w, "CMatrixD", np.asarray(cam.intrinsics, np.float64))
    w.pack("<II", cam.nrows, cam.ncols)


def _jpeg_decode(data: bytes) -> np.ndarray:
    import cv2

    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise RawlogError("embedded JPEG image could not be decoded")
    return img  # BGR, matching the MRPT/OpenCV convention used rig-wide


def _jpeg_encode(img: np.ndarray) -> bytes:
    import cv2

    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95])
    if not ok:
        raise RawlogError("JPEG encoding failed")
    return buf.tobytes()


def _read_cimage(r: _Reader, version: int) -> np.ndarray:
    """mrpt CImage v4-v9.

    Layout (CImage.cpp writeToStream): [bool externalStorage (v>=6)
    + string file if set]; bool hasColor; grayscale -> i32 width, i32
    height, i32 origin, u32 imageSize (= height * 4-byte-aligned stride),
    bool storedAsZip (u32 zip length + zlib block when set — MRPT disabled
    the zip path in practice), raw row-padded bytes; color -> u32 size +
    JPEG bytes."""
    if version >= 6 and r.u8():
        raise RawlogError(
            "CImage with external storage (image data in a side file) — "
            "re-export the rawlog with embedded images to ingest it"
        )
    color = r.u8()
    if not color:
        width, height, origin, image_size = r.unpack("<iiiI")
        del origin  # 0 = top-left for every producer the reference reads
        stored_as_zip = r.u8() if version >= 4 else True
        if stored_as_zip:
            import zlib

            (zip_len,) = r.unpack("<I")
            raw = zlib.decompress(r.bytes(zip_len))
            if len(raw) != image_size:
                raise RawlogError("CImage zip block decompressed to a wrong size")
        else:
            raw = r.bytes(image_size)
        if height <= 0 or image_size % height:
            raise RawlogError("corrupt CImage dimensions")
        stride = image_size // height
        img = np.frombuffer(raw, np.uint8).reshape(height, stride)[:, :width]
        return img.copy()
    (size,) = r.unpack("<I")
    if size == 0:  # v7+: empty images carry no JPEG block
        return np.zeros((0, 0, 3), np.uint8)
    return _jpeg_decode(r.bytes(size))


def _write_cimage(w: _Writer, img: np.ndarray) -> None:
    """Write CImage v7: grayscale raw (zip flag false), color JPEG."""
    img = np.asarray(img, np.uint8)
    w.pack("<B", 0)  # not externally stored
    color = img.ndim == 3
    w.pack("<B", int(color))
    if not color:
        height, width = img.shape
        stride = (width + 3) & ~3  # IplImage rows align to 4 bytes
        padded = np.zeros((height, stride), np.uint8)
        padded[:, :width] = img
        w.pack("<iiiI", width, height, 0, height * stride)
        w.pack("<B", 0)  # storedAsZip = false (MRPT's own default)
        w.f.write(padded.tobytes())
    elif img.size == 0:
        # mirror the reader's v7+ convention: empty color image = u32 0,
        # no JPEG block (a read 0x0 CImage must survive a rewrite)
        w.pack("<I", 0)
    else:
        data = _jpeg_encode(img)
        w.pack("<I", len(data))
        w.f.write(data)


def _read_obs3d(r: _Reader, version: int) -> Obs3DRangeScan:
    """mrpt CObservation3DRangeScan v2-v8 (CObservation3DRangeScan.cpp)."""
    o = Obs3DRangeScan()
    (o.max_range,) = r.unpack("<f")
    o.sensor_pose = _expect(r, "CPose3D")
    if r.u8():  # hasPoints3D
        (n,) = r.unpack("<I")
        if n:
            xyz = [np.frombuffer(r.bytes(4 * n), "<f4") for _ in range(3)]
            o.points3d = np.stack(xyz, axis=-1).astype(np.float32)
            if version >= 8:  # per-point source pixel indices
                ix = np.frombuffer(r.bytes(2 * n), "<u2")
                iy = np.frombuffer(r.bytes(2 * n), "<u2")
                o.points3d_idxs = np.stack([ix, iy], axis=-1).copy()
    if r.u8():  # hasRangeImage
        o.range_image = _expect(r, "CMatrix")
    if r.u8():  # hasIntensityImage
        o.intensity_image = _expect(r, "CImage")
    if r.u8():  # hasConfidenceImage
        o.confidence_image = _expect(r, "CImage")
    o.camera_params = _expect(r, "TCamera")  # v2+
    if version >= 4:
        o.camera_params_intensity = _expect(r, "TCamera")
        o.rel_pose_intensity_wrt_depth = _expect(r, "CPose3D")
    (o.std_error,) = r.unpack("<f")
    (o.timestamp,) = r.unpack("<Q")
    o.sensor_label = r.string()
    if version >= 3:  # external-storage markers
        if r.u8():
            r.string()
            raise RawlogError(
                "CObservation3DRangeScan stores its points externally; "
                "re-export with embedded data"
            )
        r.string()
        if r.u8():
            r.string()
            raise RawlogError(
                "CObservation3DRangeScan stores its range image externally; "
                "re-export with embedded data"
            )
        r.string()
    if version >= 5:
        o.range_is_depth = bool(r.u8())
    if version >= 6:
        (o.intensity_channel,) = r.unpack("<b")
    if version >= 7 and r.u8():
        raise RawlogError(
            "CObservation3DRangeScan carries pixel labels, which this build "
            "does not parse (labels live in the framework's own labeling "
            "subsystem, slam/labeling.py)"
        )
    return o


def _write_obs3d(w: _Writer, o: Obs3DRangeScan) -> None:
    """Write CObservation3DRangeScan v8 — the exact MRPT 1.x field order."""
    w.pack("<f", o.max_range)
    _write_object(w, "CPose3D", o.sensor_pose)
    w.pack("<B", int(o.points3d is not None))
    if o.points3d is not None:
        pts = np.asarray(o.points3d, np.float32)
        n = len(pts)
        w.pack("<I", n)
        if n:
            for k in range(3):
                w.f.write(np.ascontiguousarray(pts[:, k]).tobytes())
            idxs = (
                np.asarray(o.points3d_idxs, np.uint16)
                if o.points3d_idxs is not None
                else np.zeros((n, 2), np.uint16)
            )
            for k in range(2):
                w.f.write(np.ascontiguousarray(idxs[:, k]).tobytes())
    w.pack("<B", int(o.range_image is not None))
    if o.range_image is not None:
        _write_object(w, "CMatrix", o.range_image)
    w.pack("<B", int(o.intensity_image is not None))
    if o.intensity_image is not None:
        _write_object(w, "CImage", o.intensity_image)
    w.pack("<B", int(o.confidence_image is not None))
    if o.confidence_image is not None:
        _write_object(w, "CImage", o.confidence_image)
    _write_object(w, "TCamera", o.camera_params)
    _write_object(w, "TCamera", o.camera_params_intensity)
    _write_object(w, "CPose3D", o.rel_pose_intensity_wrt_depth)
    w.pack("<f", o.std_error)
    w.pack("<Q", o.timestamp)
    w.string(o.sensor_label)
    w.pack("<B", 0)  # points3D not externally stored
    w.string("")
    w.pack("<B", 0)  # range image not externally stored
    w.string("")
    w.pack("<B", int(o.range_is_depth))
    w.pack("<b", o.intensity_channel)
    w.pack("<B", 0)  # no pixel labels


def _read_obs2d(r: _Reader, version: int) -> Obs2DRangeScan:
    """mrpt CObservation2DRangeScan v4-v7: aperture, rightToLeft, maxRange,
    sensorPose, u32 N, N f32 scan, N u8 validRange, stdError, timestamp,
    beamAperture, sensorLabel; + deltaPitch (f64) from v5; + optional i32
    intensity array from v7."""
    o = Obs2DRangeScan()
    o.aperture, rtl, o.max_range = r.unpack("<fBf")
    o.right_to_left = bool(rtl)
    o.sensor_pose = _expect(r, "CPose3D")
    (n,) = r.unpack("<I")
    o.ranges = np.frombuffer(r.bytes(4 * n), "<f4").copy()
    o.validity = np.frombuffer(r.bytes(n), np.uint8).copy()
    (o.std_error,) = r.unpack("<f")
    (o.timestamp,) = r.unpack("<Q")
    (o.beam_aperture,) = r.unpack("<f")
    o.sensor_label = r.string()
    if version >= 5:
        (o.delta_pitch,) = r.unpack("<d")
    if version >= 7 and r.u8():
        o.intensity = np.frombuffer(r.bytes(4 * n), "<i4").copy()
    return o


def _write_obs2d(w: _Writer, o: Obs2DRangeScan) -> None:
    """Write CObservation2DRangeScan v6."""
    w.pack("<fBf", o.aperture, int(o.right_to_left), o.max_range)
    _write_object(w, "CPose3D", o.sensor_pose)
    ranges = np.asarray(o.ranges, np.float32)
    w.pack("<I", len(ranges))
    w.f.write(np.ascontiguousarray(ranges).tobytes())
    w.f.write(np.ascontiguousarray(np.asarray(o.validity, np.uint8)).tobytes())
    w.pack("<f", o.std_error)
    w.pack("<Q", o.timestamp)
    w.pack("<f", o.beam_aperture)
    w.string(o.sensor_label)
    w.pack("<d", o.delta_pitch)


def _read_sensory_frame(r: _Reader, version: int) -> list:
    """mrpt CSensoryFrame: u32 count + that many nested observations.
    Emitted by format-#1 rawlogs; `read_rawlog` flattens it."""
    (n,) = r.unpack("<I")
    return [_read_object(r)[1] for _ in range(n)]


def _expect(r: _Reader, want: str):
    name, obj = _read_object(r)
    if name != want:
        raise RawlogError(f"expected nested {want}, found {name}")
    return obj


_READERS = {
    "CMatrix": _read_cmatrix,
    "CMatrixD": _read_cmatrixd,
    "CPose3D": _read_cpose3d,
    "TCamera": _read_tcamera,
    "CImage": _read_cimage,
    "CObservation3DRangeScan": _read_obs3d,
    "CObservation2DRangeScan": _read_obs2d,
    "CSensoryFrame": _read_sensory_frame,
}
_WRITERS = {
    "CMatrix": _write_cmatrix,
    "CMatrixD": _write_cmatrixd,
    "CPose3D": _write_cpose3d,
    "TCamera": _write_tcamera,
    "CImage": _write_cimage,
    "CObservation3DRangeScan": _write_obs3d,
    "CObservation2DRangeScan": _write_obs2d,
}
# Version written by this build (= what MRPT 1.x itself emits) and the range
# accepted on read; versions outside the range raise UnsupportedVersionError.
_VERSIONS = {
    "CMatrix": 0,
    "CMatrixD": 0,
    "CPose3D": 2,
    "TCamera": 2,
    "CImage": 7,
    "CObservation3DRangeScan": 8,
    "CObservation2DRangeScan": 6,
}
_SUPPORTED_VERSIONS = {
    "CMatrix": tuple(range(0, 1)),
    "CMatrixD": tuple(range(0, 1)),
    "CPose3D": tuple(range(0, 3)),
    "TCamera": tuple(range(0, 3)),
    "CImage": tuple(range(4, 10)),
    "CObservation3DRangeScan": tuple(range(2, 9)),
    "CObservation2DRangeScan": tuple(range(4, 8)),
    "CSensoryFrame": tuple(range(0, 3)),
}


# ---------------------------------------------------------------------------
# file-level API

# Classes whose begin-marker the resync scan hunts for.  Their framed form
# is [0x80|len][name][i8 version]; the 14+-byte exact byte pattern plus a
# plausibility check on the version byte makes false positives negligible.
_RESYNC_CLASSES = (
    "CSensoryFrame",
    "CObservation3DRangeScan",
    "CObservation2DRangeScan",
)


def _resync(r: _Reader) -> bool:
    """Skip forward to the next begin-marker of a readable top-level class.

    MRPT's WriteObject framing carries no payload length, so objects of
    classes this module has no codec for — the `CActionCollection`
    odometry hints that format-#1 rawlogs interleave with sensory frames —
    cannot be skipped structurally.  The reference discards them too
    (`getActionObservationPairOrObservation` returns only the observation
    part, `Visualization/LoadRawlog.cpp:182-188`), so we resynchronize on
    the distinctive framed-class-name byte pattern of the classes we do
    read.  Returns True when a marker was found (stream positioned at it),
    False at end of stream."""
    pats = [
        bytes([0x80 | len(n)]) + n.encode("ascii") for n in _RESYNC_CLASSES
    ]
    maxlen = max(len(p) for p in pats)
    buf = b""
    while True:
        chunk = r.f.read(65536)
        if not chunk:
            return False
        buf += chunk
        hit = None
        for p in pats:
            start = 0
            while True:
                i = buf.find(p, start)
                if i < 0:
                    break
                # plausibility: the next byte must be a small i8 version
                if i + len(p) < len(buf) and not 0 <= buf[i + len(p)] <= 30:
                    start = i + 1
                    continue
                if i + len(p) >= len(buf):
                    # version byte not buffered yet; keep the tail and
                    # read more before deciding
                    break
                if hit is None or i < hit:
                    hit = i
                break
        if hit is not None:
            r.f = _Pushback(r.f, buf[hit:])
            return True
        buf = buf[-(maxlen + 1):]


def read_rawlog(path: str | Path) -> Iterator[Obs3DRangeScan | Obs2DRangeScan]:
    """Stream observations from a rawlog (gzip or plain), mirroring
    `getActionObservationPairOrObservation` (`LoadRawlog.cpp:182-188`):
    bare observations (format #2) yield directly; `CSensoryFrame` containers
    (format #1) are flattened into their observations; objects of classes
    with no codec here (format #1's CActionCollection odometry hints, or an
    exotic observation type inside a sensory frame) are skipped by
    resynchronizing on the next readable object's begin marker — the same
    observations-only view the reference's loader takes."""
    path = Path(path)
    with open(path, "rb") as fh:
        magic = fh.read(2)
    opener = gzip.open if magic == _GZIP_MAGIC else open
    with opener(path, "rb") as f:
        r = _Reader(f)
        while not r.peek_eof():
            try:
                name, obj = _read_object(r)
            except UnknownClassError:
                if not _resync(r):
                    return
                continue
            if name == "CSensoryFrame":
                yield from obj
            else:
                yield obj


def write_rawlog(
    path: str | Path,
    observations: Iterable[Obs3DRangeScan | Obs2DRangeScan],
    compress: bool = True,
) -> None:
    opener = gzip.open if compress else open
    with opener(Path(path), "wb") as f:
        w = _Writer(f)
        for o in observations:
            name = (
                "CObservation3DRangeScan"
                if isinstance(o, Obs3DRangeScan)
                else "CObservation2DRangeScan"
            )
            _write_object(w, name, o)


# ---------------------------------------------------------------------------
# rig assembly (LoadRawlog.cpp:69-92,230-283)

# The reference's 4-sensor capture rig stores observations in a different
# physical order than the ring index; this permutation is applied when
# assembling (`unsigned SensorArrangement[] = {3,0,2,1,...}` at
# `LoadRawlog.cpp:72`).
DEFAULT_ARRANGEMENT = (3, 0, 2, 1)


def _label_index(label: str) -> int | None:
    if label.startswith("RGBD") and label[4:].isdigit():
        return int(label[4:]) - 1
    return None


def assemble_rig_frames(
    observations: Iterable[Obs3DRangeScan | Obs2DRangeScan],
    num_sensors: int = 8,
    num_cameras: int | None = None,
    arrangement: tuple[int, ...] | None = None,
    sync_window_s: float = 0.05,
) -> Iterator[RawRigFrame]:
    """Group ``RGBD<i>`` observations into rig frames.

    A frame is emitted when one observation from every rig camera has arrived
    (`rgbd1 && rgbd2 && ...` at `LoadRawlog.cpp:230`); when the rig has fewer
    cameras than `num_sensors`, the arrangement is tiled around the ring
    exactly as the reference tiles its 4 cameras into 8 slots
    (`LoadRawlog.cpp:72,245-250`).  The camera count is `num_cameras` if
    given, else inferred from the first full cycle of distinct labels.
    `sync_window_s` guards against mixing frames when labels drop out (the
    reference's TODO at `LoadRawlog.cpp:197`).
    """
    pending: dict[int, Obs3DRangeScan] = {}
    n_labels = num_cameras or 0

    def emit(group: dict[int, Obs3DRangeScan]) -> RawRigFrame | None:
        ts = [mrpt_to_unix_timestamp(o.timestamp) for o in group.values()]
        if max(ts) - min(ts) > sync_window_s:
            return None
        if arrangement is not None:
            arr = arrangement
        elif n_labels == len(DEFAULT_ARRANGEMENT):
            arr = DEFAULT_ARRANGEMENT
        else:
            arr = tuple(range(n_labels))
        slots = [group[arr[i % len(arr)] % n_labels] for i in range(num_sensors)]
        rgb = np.stack(
            [
                o.intensity_image
                if o.intensity_image is not None and o.intensity_image.ndim == 3
                else np.repeat(
                    (o.intensity_image
                     if o.intensity_image is not None
                     else np.zeros(o.range_image.shape, np.uint8))[..., None],
                    3, axis=-1,
                )
                for o in slots
            ]
        )
        # float meters -> u16 mm, the reference's convertTo(CV_16UC1, 1000)
        depth = np.stack(
            [
                np.clip(np.nan_to_num(o.range_image) * 1000.0, 0, 65535).astype(
                    np.uint16
                )
                for o in slots
            ]
        )
        return RawRigFrame(
            rgb=rgb,
            depth_mm=depth,
            timestamp=max(o.timestamp for o in group.values()),
        )

    for obs in observations:
        if not isinstance(obs, Obs3DRangeScan):
            continue  # LASER observations ride along; not part of the rig
        idx = _label_index(obs.sensor_label)
        if idx is None:
            continue
        if idx in pending:
            if not n_labels:
                # the first full cycle just ended: it fixes the camera count
                # and itself forms the first frame
                n_labels = len(pending)
                frame = emit(pending)
                if frame is not None:
                    yield frame
            # otherwise a label dropped out mid-frame; discard the stale set
            pending = {}
        pending[idx] = obs
        if n_labels and len(pending) == n_labels:
            frame = emit(pending)
            if frame is not None:
                yield frame
                pending = {}
            else:
                newest = max(pending, key=lambda k: pending[k].timestamp)
                pending = {newest: pending[newest]}
    if not n_labels and pending:
        # stream ended within the first cycle: all observations seen form one
        # frame (a single-capture rawlog)
        n_labels = len(pending)
        frame = emit(pending)
        if frame is not None:
            yield frame


def rig_frame_to_observations(
    frame: RawRigFrame,
    sensor_poses: np.ndarray | None = None,
    timestamp: int | None = None,
) -> list[Obs3DRangeScan]:
    """Inverse of :func:`assemble_rig_frames` for one frame — lets any rig
    capture be exported as a rawlog (and powers round-trip tests)."""
    from rgbd360_tpu_torch.calibration.spec import construction_spec_rt

    n = frame.rgb.shape[0]
    poses = sensor_poses if sensor_poses is not None else construction_spec_rt(n)
    ts = timestamp if timestamp is not None else int(frame.timestamp)
    return [
        Obs3DRangeScan(
            sensor_label=f"RGBD{i + 1}",
            timestamp=ts,
            sensor_pose=np.asarray(poses[i], np.float64),
            range_image=frame.depth_mm[i].astype(np.float32) * 0.001,
            intensity_image=frame.rgb[i],
        )
        for i in range(n)
    ]
