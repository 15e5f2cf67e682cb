"""The native capture decoder (`rgbd360_tpu_torch/native/loader.cpp`, a copy
of the reference's `native/loader.cpp` with a plain C interface).

On first use `load()` compiles the source with `g++` into
`build/rgbd360_tpu_torch/` of the checkout, named by a hash of the source
and flags, and loads it with `ctypes`; a failed build raises with the
compiler's stderr.  `read_rig_frame(path)` decodes one capture into a
`RawRigFrame` byte-equal to `io.bin_format.read_rig_frame`'s, and
`read_rig_frame_batch(paths)` decodes several on a pool of threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from rgbd360_tpu_torch.io.bin_format import RawRigFrame
from rgbd360_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[1] / "native" / "loader.cpp"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_ERR_LEN = 512

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"librgbd360_loader_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native capture decoder cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        tmp = os.path.join(tmp_dir, out.name)
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def load() -> ctypes.CDLL:
    """The decoder's library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                _compile(out)
            lib = ctypes.CDLL(str(out))
            p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
            ip = ctypes.POINTER(ctypes.c_int)
            lib.rgbd360_rig_frame_shape.argtypes = [s, ip, ip, p, i]
            lib.rgbd360_read_rig_frame.argtypes = [s, i, i, i, p, p, p, p, i]
            lib.rgbd360_read_rig_frame_batch.argtypes = [
                ctypes.POINTER(s), i, i, i, i, p, p, p, i, p, i]
            for f in (lib.rgbd360_rig_frame_shape, lib.rgbd360_read_rig_frame,
                      lib.rgbd360_read_rig_frame_batch):
                f.restype = i
            _lib = lib
        return _lib


def _check(code: int, err) -> None:
    if code != 0:
        raise ValueError(err.value.decode(errors="replace"))


def _shape(lib, path: str) -> tuple[int, int]:
    rows, cols = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(lib.rgbd360_rig_frame_shape(path.encode(), ctypes.byref(rows),
                                       ctypes.byref(cols), err, _ERR_LEN), err)
    return rows.value, cols.value


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def read_rig_frame(path, num_sensors: int = 8) -> RawRigFrame:
    """Decode one `sphere_images_*.bin` rig frame natively."""
    lib = load()
    path = str(path)
    rows, cols = _shape(lib, path)
    rgb = np.empty((num_sensors, rows, cols, 3), np.uint8)
    depth = np.empty((num_sensors, rows, cols), np.uint16)
    ts = np.zeros(1, np.uint64)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(lib.rgbd360_read_rig_frame(path.encode(), num_sensors, rows, cols, _ptr(rgb),
                                      _ptr(depth), _ptr(ts), err, _ERR_LEN), err)
    return RawRigFrame(rgb=rgb, depth_mm=depth, timestamp=int(ts[0]))


def read_rig_frame_batch(paths, num_sensors: int = 8, n_threads: int = 4) -> list[RawRigFrame]:
    """Decode captures of one shape natively on `n_threads` threads."""
    lib = load()
    paths = [str(p) for p in paths]
    if not paths:
        return []
    rows, cols = _shape(lib, paths[0])
    n = len(paths)
    rgb = np.empty((n, num_sensors, rows, cols, 3), np.uint8)
    depth = np.empty((n, num_sensors, rows, cols), np.uint16)
    ts = np.zeros(n, np.uint64)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(lib.rgbd360_read_rig_frame_batch(c_paths, n, num_sensors, rows, cols, _ptr(rgb),
                                            _ptr(depth), _ptr(ts), n_threads, err, _ERR_LEN),
           err)
    return [RawRigFrame(rgb=rgb[i], depth_mm=depth[i], timestamp=int(ts[i])) for i in range(n)]
