"""Build and load the port's CUDA kernels.

The `.cu` sources under `rgbd360_tpu_torch/csrc/` expose a plain C
interface.  On first use `load()` compiles them with `nvcc`, one process
per source, all started together, links the objects into one shared
library under `build/rgbd360_tpu_torch/` of the checkout, named by a hash of
the sources and flags (so an edited source builds anew), and loads it with
`ctypes`.  No PyTorch headers are involved, which keeps the build to
seconds.  A failed build raises with nvcc's stderr.
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

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "rgbd360_tpu_torch"

# -prec-div=true is nvcc's default and is kept explicit; --fmad=false keeps
# a*b+c from contracting.  Both are needed for bit-equality with the
# reference, and --use_fast_math must never appear here.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-prec-div=true", "--fmad=false",
]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the port's CUDA kernels cannot be built"
        )
    return path


def _sources() -> list[Path]:
    srcs = sorted(SRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    return srcs


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librgbd360_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands as parallel processes; raise on the first failure,
    after every process has ended."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cmds
    ]
    errors = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    if errors:
        raise RuntimeError("\n".join(errors))


def _compile(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objs = [os.path.join(tmp_dir, src.stem + ".o") for src in _sources()]
        _run_all([
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            for src, obj in zip(_sources(), objs)
        ])
        tmp = os.path.join(tmp_dir, out.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # (group, blocks, stream)
    lib.rgbd360_fused_gradients_levels.argtypes = [p, i, p]
    lib.rgbd360_fused_gradients_levels.restype = i
    # (gray, gray_out, c_gray, depth, depth_out, c_depth, h, w, circular_rows,
    #  lo, hi, vec_gray, vec_depth, stream)
    lib.rgbd360_level_down.argtypes = [p, p, i, p, p, i, i, i, i, f, f, i, i, p]
    lib.rgbd360_level_down.restype = i
    # (result, stream)
    lib.rgbd360_check_fast_reciprocal.argtypes = [p, p]
    lib.rgbd360_check_fast_reciprocal.restype = i
    lib.rgbd360_cuda_error_string.argtypes = [i]
    lib.rgbd360_cuda_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                _compile(out)
            lib = ctypes.CDLL(str(out))
            _bind(lib)
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.rgbd360_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
