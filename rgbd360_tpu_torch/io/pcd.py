"""PCL `.pcd` point-cloud file I/O (reader + writer), no PCL dependency (a
copy of `rgbd360_tpu/io/pcd.py`).

The reference persists built keyframes as `.pcd` files plus a gzipped PbMap
(`Frame360::save`, reference `include/Frame360.h:321`; reload via
`loadCloud:187` and `load_PbMap_Cloud:213`), and `Visualization/
LoadSphere.cpp` views such a pair.  This module gives the port the same
interchange format so clouds flow to/from PCL-based tooling: PCD v0.7,
fields `x y z [rgb]`, `ascii` or `binary` DATA, organized or flat layouts.

RGB is packed the PCL way: the three u8 channels live in the low 24 bits of
a 4-byte word stored in a float field.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_SIZES = {"F": {4: "f4", 8: "f8"}, "I": {1: "i1", 2: "i2", 4: "i4"},
          "U": {1: "u1", 2: "u2", 4: "u4"}}


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


def _unpack_rgb(f: np.ndarray) -> np.ndarray:
    """(N,) f32/u32 packed -> (N, 3) u8."""
    u = np.ascontiguousarray(np.asarray(f)).view(np.uint32)
    return np.stack(
        [(u >> 16) & 0xFF, (u >> 8) & 0xFF, u & 0xFF], axis=-1
    ).astype(np.uint8)


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


def read_pcd(path: str | Path) -> tuple[np.ndarray, np.ndarray | None]:
    """Read a PCD v0.7 file -> (xyz (N, 3) f32, rgb (N, 3) u8 or None).

    Handles ascii and binary DATA, arbitrary extra fields (skipped), and
    both `rgb`/`rgba` packed-color fields regardless of their declared
    TYPE (PCL writes them as F or U depending on version).
    """
    raw = Path(path).read_bytes()
    lines = []
    off = 0
    while True:
        nl = raw.index(b"\n", off)
        line = raw[off:nl].decode("ascii", "replace").strip()
        off = nl + 1
        if line.startswith("#") or not line:
            continue
        lines.append(line)
        if line.split()[0].upper() == "DATA":
            break
    hdr = {l.split()[0].upper(): l.split()[1:] for l in lines}
    fields = [f.lower() for f in hdr["FIELDS"]]
    sizes = [int(s) for s in hdr["SIZE"]]
    types = [t.upper() for t in hdr["TYPE"]]
    counts = [int(c) for c in hdr.get("COUNT", ["1"] * len(fields))]
    n = int(hdr["POINTS"][0])
    mode = hdr["DATA"][0].lower()

    np_fields = []
    for name, size, typ, cnt in zip(fields, sizes, types, counts):
        base = _SIZES[typ][size]
        for c in range(cnt):
            np_fields.append((f"{name}{'' if cnt == 1 else c}", "<" + base))
    dt = np.dtype(np_fields)

    if mode == "binary":
        arr = np.frombuffer(raw[off : off + n * dt.itemsize], dtype=dt)
    elif mode == "ascii":
        flat = np.loadtxt(
            raw[off:].decode("ascii", "replace").splitlines(), ndmin=2
        )
        arr = np.zeros(n, dt)
        for i, (name, _) in enumerate(np_fields):
            arr[name] = flat[:n, i].astype(dt[name])
    else:
        raise ValueError(f"unsupported PCD DATA mode: {mode}")

    xyz = np.stack(
        [arr["x"].astype(np.float32), arr["y"].astype(np.float32),
         arr["z"].astype(np.float32)], axis=-1,
    )
    rgb = None
    for cname in ("rgb", "rgba"):
        if cname in fields:
            rgb = _unpack_rgb(arr[cname])
            break
    return xyz, rgb
