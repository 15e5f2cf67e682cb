"""mrpt-binary PbMap (``.pbmap``) interop (a copy of `rgbd360_tpu/io/pbmap.py`;
its PlaneSet bridge builds the port's `PlaneSet` of tensors).

The reference persists each built keyframe as a PCD cloud plus a gzipped
mrpt-serialized plane set, and reloads the pair with
`Frame360::savePlanes`/`loadPbMap`/`load_PbMap_Cloud`
(`include/Frame360.h:196,213,313,321`); the `LoadSphere`
viewer consumes exactly those files (`Visualization/LoadSphere.cpp`).  This
module reads and writes that format so keyframes produced by the C++
reference interoperate with this framework.

Wire format: a gzip stream (``mrpt::utils::CFileGZOutputStream``) holding ONE
mrpt-serialized object — the same ``[u8 0x80|len][class name][i8 version]
[payload][u8 0x88]`` framing as rawlogs (`io/rawlog.py`).

``PbMap`` v0 payload: ``u32 n`` + n nested ``Plane`` objects.

``Plane`` v0 payload (mrpt::pbmap::Plane::writeToStream, MRPT 1.x —
pinned here field by field since MRPT cannot be linked in this environment;
the 0x88 end-flag check turns any layout mismatch into a loud
:class:`rgbd360_tpu_torch.io.rawlog.RawlogError` instead of silent misparsing):

    u32  numObservations
    f32  areaVoxels
    f32  areaHull
    f32  elongation
    3f32 v3normal
    3f32 v3center
    3f32 v3PpalDir
    3f32 v3colorNrgb
    f32  dominantIntensity
    u8   bDominantColor
    vector<f32> hist_H           (u32 count + data; 37 bins: 36 hue + gray)
    vector<i32> inliers          (u32 count + data)
    string label, label_object, label_context
    u32  n + n * 3f32 polygonContour points

The plane offset ``d`` is not serialized (recomputed as ``-n . c`` on load,
as the reference recomputes it from the inlier centroid).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from rgbd360_tpu_torch.io.rawlog import (
    _END_FLAG,
    _GZIP_MAGIC,
    RawlogError,
    UnsupportedVersionError,
    _Reader,
    _Writer,
)

_PBMAP_VERSION = 0
_PLANE_VERSION = 0


@dataclass
class PbPlane:
    """One serialized plane (mrpt::pbmap::Plane payload subset)."""

    num_observations: int = 0
    area_voxels: float = 0.0
    area_hull: float = 0.0
    elongation: float = 1.0
    normal: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    center: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    ppal_dir: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    color_nrgb: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    dominant_intensity: float = 0.0
    b_dominant_color: bool = False
    hist_h: np.ndarray = field(default_factory=lambda: np.zeros(37, np.float32))
    inliers: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    label: str = ""
    label_object: str = ""
    label_context: str = ""
    polygon: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))

    @property
    def d(self) -> float:
        return float(-np.dot(self.normal, self.center))


def _read_framed(r: _Reader, want: str, supported: tuple[int, ...]):
    len_byte = r.u8()
    if not len_byte & 0x80:
        raise RawlogError("pre-2008 MRPT object framing is not supported")
    name = r.bytes(len_byte & 0x7F).decode("ascii")
    if name != want:
        raise RawlogError(f"expected a serialized {want}, found {name}")
    (version,) = r.unpack("<b")
    if version not in supported:
        raise UnsupportedVersionError(name, version, supported)
    return version


def _end(r: _Reader, name: str) -> None:
    flag = r.u8()
    if flag != _END_FLAG:
        raise RawlogError(
            f"bad end-of-object flag 0x{flag:02x} after {name} (expected "
            "0x88); the file's layout does not match this build's pinned "
            f"{name} codec"
        )


def _begin(w: _Writer, name: str, version: int) -> None:
    w.pack("<B", 0x80 | len(name))
    w.f.write(name.encode("ascii"))
    w.pack("<b", version)


def _read_plane(r: _Reader) -> PbPlane:
    _read_framed(r, "Plane", (_PLANE_VERSION,))
    p = PbPlane()
    (p.num_observations,) = r.unpack("<I")
    p.area_voxels, p.area_hull, p.elongation = r.unpack("<3f")
    p.normal = np.array(r.unpack("<3f"), np.float32)
    p.center = np.array(r.unpack("<3f"), np.float32)
    p.ppal_dir = np.array(r.unpack("<3f"), np.float32)
    p.color_nrgb = np.array(r.unpack("<3f"), np.float32)
    (p.dominant_intensity,) = r.unpack("<f")
    p.b_dominant_color = bool(r.u8())
    (nh,) = r.unpack("<I")
    p.hist_h = np.frombuffer(r.bytes(4 * nh), "<f4").copy()
    (ni,) = r.unpack("<I")
    p.inliers = np.frombuffer(r.bytes(4 * ni), "<i4").copy()
    p.label = r.string()
    p.label_object = r.string()
    p.label_context = r.string()
    (npoly,) = r.unpack("<I")
    p.polygon = np.frombuffer(r.bytes(12 * npoly), "<f4").reshape(npoly, 3).copy()
    _end(r, "Plane")
    return p


def _write_plane(w: _Writer, p: PbPlane) -> None:
    _begin(w, "Plane", _PLANE_VERSION)
    w.pack("<I", int(p.num_observations))
    w.pack("<3f", float(p.area_voxels), float(p.area_hull), float(p.elongation))
    for v in (p.normal, p.center, p.ppal_dir, p.color_nrgb):
        w.pack("<3f", *np.asarray(v, np.float32))
    w.pack("<f", float(p.dominant_intensity))
    w.pack("<B", int(p.b_dominant_color))
    hist = np.asarray(p.hist_h, "<f4")
    w.pack("<I", len(hist))
    w.f.write(hist.tobytes())
    inl = np.asarray(p.inliers, "<i4")
    w.pack("<I", len(inl))
    w.f.write(inl.tobytes())
    w.string(p.label)
    w.string(p.label_object)
    w.string(p.label_context)
    poly = np.asarray(p.polygon, "<f4").reshape(-1, 3)
    w.pack("<I", len(poly))
    w.f.write(np.ascontiguousarray(poly).tobytes())
    w.pack("<B", _END_FLAG)


def read_pbmap(path: str | Path) -> list[PbPlane]:
    """Load a gzipped mrpt-binary PbMap (`Frame360::loadPbMap`,
    `include/Frame360.h:196`)."""
    path = Path(path)
    with open(path, "rb") as fh:
        magic = fh.read(2)
    opener = gzip.open if magic == _GZIP_MAGIC else open
    with opener(path, "rb") as f:
        r = _Reader(f)
        _read_framed(r, "PbMap", (_PBMAP_VERSION,))
        (n,) = r.unpack("<I")
        planes = [_read_plane(r) for _ in range(n)]
        _end(r, "PbMap")
    return planes


def write_pbmap(path: str | Path, planes: list[PbPlane], compress: bool = True) -> None:
    """Write a gzipped mrpt-binary PbMap (`Frame360::savePlanes`,
    `include/Frame360.h:313`)."""
    opener = gzip.open if compress else open
    with opener(Path(path), "wb") as f:
        w = _Writer(f)
        _begin(w, "PbMap", _PBMAP_VERSION)
        w.pack("<I", len(planes))
        for p in planes:
            _write_plane(w, p)
        w.pack("<B", _END_FLAG)


# ---------------------------------------------------------------------------
# PlaneSet bridge

def _host(a) -> np.ndarray:
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def planeset_to_pbplanes(ps, labels: list[str] | None = None) -> list[PbPlane]:
    """Convert a framework PlaneSet (padded tensors on any device, or numpy
    arrays) to PbPlane records (valid slots only)."""
    valid = _host(ps.valid)
    out: list[PbPlane] = []
    normal = _host(ps.normal).astype(np.float32)
    center = _host(ps.center).astype(np.float32)
    hull = _host(ps.hull).astype(np.float32)
    hue = _host(ps.hue_hist).astype(np.float32)
    color = _host(ps.main_color).astype(np.float32)
    area = _host(ps.area).astype(np.float32)
    elong = _host(ps.elongation).astype(np.float32)
    n_inl = _host(ps.n_inliers)
    for k in np.where(valid)[0]:
        n = normal[k]
        # principal direction: any unit vector in the plane (the hull's
        # longest chord direction when available)
        poly = hull[k]
        if len(poly) >= 2:
            chord = poly[len(poly) // 2] - poly[0]
            nrm = np.linalg.norm(chord)
            ppal = chord / nrm if nrm > 1e-9 else np.zeros(3, np.float32)
        else:
            ppal = np.zeros(3, np.float32)
        out.append(
            PbPlane(
                num_observations=int(n_inl[k]),
                area_voxels=float(area[k]),
                area_hull=float(area[k]),
                elongation=float(elong[k]),
                normal=n,
                center=center[k],
                ppal_dir=ppal.astype(np.float32),
                color_nrgb=color[k],
                dominant_intensity=float(color[k].mean()),
                b_dominant_color=bool(color[k].max() > 0),
                hist_h=hue[k],
                label=(labels[int(k)] if labels else ""),
                polygon=poly,
            )
        )
    return out


def pbplanes_to_planeset(
    planes: list[PbPlane], max_planes: int = 32, hull_dirs: int = 16, device=None
):
    """Convert PbPlane records to a padded framework PlaneSet of tensors on
    `device` (the card when None; for matching / registration of
    reference-produced keyframes)."""
    import dataclasses

    import torch

    from rgbd360_tpu_torch import resolve_device
    from rgbd360_tpu_torch.ops.segmentation import PlaneSet

    device = resolve_device(device)

    k = max_planes
    ps = PlaneSet(
        normal=np.zeros((k, 3), np.float32),
        center=np.zeros((k, 3), np.float32),
        d=np.zeros(k, np.float32),
        curvature=np.zeros(k, np.float32),
        area=np.zeros(k, np.float32),
        elongation=np.ones(k, np.float32),
        n_inliers=np.zeros(k, np.float32),
        hull=np.zeros((k, hull_dirs, 3), np.float32),
        hue_hist=np.zeros((k, 37), np.float32),
        main_color=np.zeros((k, 3), np.float32),
        valid=np.zeros(k, bool),
    )
    for i, p in enumerate(planes[:k]):
        ps.normal[i] = p.normal
        ps.center[i] = p.center
        ps.d[i] = p.d
        ps.area[i] = p.area_hull
        ps.elongation[i] = max(p.elongation, 1.0)
        ps.n_inliers[i] = max(p.num_observations, len(p.inliers))
        poly = np.asarray(p.polygon, np.float32)
        if len(poly):
            # resample the contour to the fixed hull capacity
            idx = np.linspace(0, len(poly) - 1, hull_dirs).round().astype(int)
            ps.hull[i] = poly[idx]
        else:
            ps.hull[i] = p.center[None, :]
        h = np.asarray(p.hist_h, np.float32)
        if len(h) == 37:
            ps.hue_hist[i] = h
        elif len(h):  # different bin count: resample, preserve mass
            x_new = np.linspace(0, 1, 37)
            x_old = np.linspace(0, 1, len(h))
            ps.hue_hist[i] = np.interp(x_new, x_old, h)
            s = ps.hue_hist[i].sum()
            if s > 0:
                ps.hue_hist[i] *= h.sum() / s
        ps.main_color[i] = p.color_nrgb
        ps.valid[i] = True
    return PlaneSet(
        *[torch.from_numpy(getattr(ps, f.name)).to(device)
          for f in dataclasses.fields(PlaneSet)]
    )
