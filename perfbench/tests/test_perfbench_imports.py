"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program.  Module names are compared
by their whole top-level name: the port's `rgbd360_tpu_torch` begins with
the JAX package's `rgbd360_tpu`."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "rgbd360_tpu"}
# the yardstick: what it computes may take nothing from the program
PLAIN = ("reference.py", "scene.py", "roofline.py", "reduce.py", "accuracy.py", "check.py")


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources():
    return sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", PLAIN)
def test_yardstick_imports_nothing_of_the_program(name):
    assert "rgbd360_tpu_torch" not in top_level_imports(HERE / name)


def test_names_compared_whole(monkeypatch):
    import rgbd360_tpu_torch  # noqa: F401  (the port's name begins with the JAX package's)

    monkeypatch.setitem(sys.modules, "rgbd360_tpu_torch.x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rgbd360_tpu.core", sys)
    assert "rgbd360_tpu" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert "jaxlib" in harness.forbidden_modules()


def test_a_run_loads_no_jax():
    """A fresh process that loads the harness, the program and the
    reference, as a run does, holds none of the forbidden modules."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from perfbench import harness, check, reference, scene, reduce\n"
        "from rgbd360_tpu_torch.slam.odometry import KeyframeSLAM\n"
        "print(harness.forbidden_modules())\n" % str(HERE.parent)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_refuses_without_cuda():
    """Without a CUDA device the entry exits non-zero and prints no result."""
    code = (
        "import sys, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "sys.argv = ['run.py', '--workload', 'kfslam.loop24', '--seed', '1', '--seconds', '1']\n"
        "sys.path.insert(0, %r)\n"
        "from perfbench.harness import main\n"
        "sys.exit(main(sys.argv[1:], 0.0))\n" % str(HERE.parent)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
