"""The port's contract with the card machine, which has no jax: the port and
`chip_smoke.py` import with every import of jax and of the JAX package
(`rgbd360_tpu` and all its submodules, the jax-free ones included) blocked,
no source file of theirs names such an import, and `chip_smoke.py` refuses
to run (non-zero exit, no result line) without a CUDA device."""

import ast
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
    "rgbd360_tpu_torch.apps.grabber",
    "rgbd360_tpu_torch.calibration.spec",
    "rgbd360_tpu_torch.config",
    "rgbd360_tpu_torch.convert",
    "rgbd360_tpu_torch.core.frame",
    "rgbd360_tpu_torch.io.calib",
    "rgbd360_tpu_torch.io.clams",
    "rgbd360_tpu_torch.ops._build",
    "rgbd360_tpu_torch.ops.bilateral",
    "rgbd360_tpu_torch.ops.camera",
    "rgbd360_tpu_torch.ops.hopper_kernels",
    "rgbd360_tpu_torch.ops.pyramid",
    "rgbd360_tpu_torch.ops.se3",
    "rgbd360_tpu_torch.ops.segmentation",
    "rgbd360_tpu_torch.ops.stitch",
    "rgbd360_tpu_torch.ops.undistort",
    "rgbd360_tpu_torch.registration.dense",
    "rgbd360_tpu_torch.registration.planes",
    "rgbd360_tpu_torch.slam.graph",
    "rgbd360_tpu_torch.slam.loop_closure",
    "rgbd360_tpu_torch.slam.map",
    "rgbd360_tpu_torch.slam.odometry",
    "rgbd360_tpu_torch.slam.relocalizer",
    "rgbd360_tpu_torch.slam.topological",
    "rgbd360_tpu_torch.synthetic",
    "rgbd360_tpu_torch.utils.host",
    "rgbd360_tpu_torch.utils.metrics",
    "rgbd360_tpu_torch.utils.trace",
    "chip_smoke",
]

_BLOCKER = textwrap.dedent(
    """
    import importlib, sys

    BLOCKED = ("jax", "jaxlib", "rgbd360_tpu")

    class BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, BlockJax())
    for m in sys.argv[1:]:
        importlib.import_module(m)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
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


def _imported_names(path: Path) -> list[str]:
    """Every module a source file imports, anywhere in it."""
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    return names


def test_chip_smoke_imports_only_the_port():
    """`chip_smoke.py` names no module of the JAX package (`rgbd360_tpu.*`)
    nor jax itself."""
    names = _imported_names(ROOT / "chip_smoke.py")
    tops = {name.split(".")[0] for name in names}
    assert "rgbd360_tpu_torch" in tops
    assert not tops & {"rgbd360_tpu", "jax", "jaxlib"}, sorted(names)


def test_slice_modules_cover_the_package():
    """Every module of the port is in SLICE_MODULES (so the blocked import
    above reaches it)."""
    pkg = ROOT / "rgbd360_tpu_torch"
    found = set()
    for path in pkg.rglob("*.py"):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        found.add(".".join(parts))
    packages = {m for m in found if (ROOT / m.replace(".", "/")).is_dir()}
    missing = found - packages - set(SLICE_MODULES)
    assert not missing, sorted(missing)


def _port_sources() -> list[Path]:
    return sorted((ROOT / "rgbd360_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    """No `.py` of the port, nor `chip_smoke.py`, imports `jax`, `jaxlib` or
    anything of `rgbd360_tpu` (at top level or inside a function)."""
    bad = [n for n in _imported_names(path)
           if n.split(".")[0] in ("rgbd360_tpu", "jax", "jaxlib")]
    assert not bad, bad


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


def test_mesh_is_not_ported_yet():
    """The sharded paths wait for `parallel/sharded.py`: `mesh=` raises and
    names the roadmap item, on the tracker, the loop closer and the
    relocaliser."""
    from rgbd360_tpu_torch import synthetic
    from rgbd360_tpu_torch.core.frame import FrameBuilder
    from rgbd360_tpu_torch.slam.loop_closure import LoopCloser
    from rgbd360_tpu_torch.slam.odometry import KeyframeSLAM
    from rgbd360_tpu_torch.slam.relocalizer import Relocalizer

    cfg = synthetic.config(5, 3)
    builder = FrameBuilder(synthetic.calibration(cfg.rig), cfg, device="cpu")
    for make in (lambda: KeyframeSLAM(builder, mesh=object()),
                 lambda: LoopCloser(cfg, mesh=object()),
                 lambda: Relocalizer(cfg, mesh=object())):
        with pytest.raises(NotImplementedError, match="P8"):
            make()


def test_keyframe_slam_lands_on_the_card_by_default():
    """`KeyframeSLAM(FrameBuilder(calib, cfg))` with no device asks for the
    card and raises where there is none; on the CPU by request, its map
    lives where the builder does."""
    import torch

    from rgbd360_tpu_torch import synthetic
    from rgbd360_tpu_torch.core.frame import FrameBuilder
    from rgbd360_tpu_torch.slam.odometry import KeyframeSLAM

    cfg = synthetic.config(5, 3)
    cal = synthetic.calibration(cfg.rig)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            KeyframeSLAM(FrameBuilder(cal, cfg))
    slam = KeyframeSLAM(FrameBuilder(cal, cfg, device="cpu"))
    assert slam.map.device.type == "cpu" and slam.map.gray.dtype == torch.bfloat16
    assert slam.map.kf_capacity == 64 and slam.map.edge_capacity == 512
