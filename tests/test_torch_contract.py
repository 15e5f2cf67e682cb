"""The port's contract with the card machine, which has no jax: the port and
`chip_smoke.py` import with every jax import blocked, and `chip_smoke.py`
refuses to run (non-zero exit, no result line) without a CUDA device."""

import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

SLICE_MODULES = [
    "rgbd360_tpu_torch",
    "rgbd360_tpu_torch.calibration.spec",
    "rgbd360_tpu_torch.convert",
    "rgbd360_tpu_torch.core.frame",
    "rgbd360_tpu_torch.ops._build",
    "rgbd360_tpu_torch.ops.camera",
    "rgbd360_tpu_torch.ops.hopper_kernels",
    "rgbd360_tpu_torch.ops.pyramid",
    "rgbd360_tpu_torch.ops.se3",
    "rgbd360_tpu_torch.ops.stitch",
    "rgbd360_tpu_torch.ops.undistort",
    "rgbd360_tpu_torch.registration.dense",
    "rgbd360_tpu_torch.synthetic",
    "chip_smoke",
]

_BLOCKER = textwrap.dedent(
    """
    import importlib, sys

    class BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib"):
                raise ImportError("jax is blocked: " + name)
            return None

    sys.meta_path.insert(0, BlockJax())
    for m in sys.argv[1:]:
        importlib.import_module(m)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    assert not leaked, leaked
    print("imported", len(sys.argv) - 1, "modules without jax")
    """
)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKER, *SLICE_MODULES],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert f"imported {len(SLICE_MODULES)} modules" in proc.stdout


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_refuses_without_cuda(tmp_path, alone):
    """No CUDA device (and, alone, no port beside it): non-zero exit and no
    result line."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    env = _env()
    if alone:
        cwd = tmp_path
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
        env.pop("PYTHONPATH")
    proc = subprocess.run(
        [sys.executable, str(script)],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
