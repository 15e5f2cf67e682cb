"""The port's apps `odometry --parallax-refine`, `view_frame`,
`load_rawlog` and `labelize` against the reference's own `main` on the
same files, at a small size (`synthetic.config(4, 3)`: the calibration
directory, `--no-intrinsics`, and the walk's 6 captures, written by
`synthetic.write_app_inputs`), through phase m's own functions
(`chip_smoke.check_refined_steps`, `run_view` / `check_view`,
`run_rawlog` / `check_rawlog`, `run_labelize` / `check_labels`) against
the golden tool's `odometry_refined_jax` and `labelize_jax` run live.

The port's builder holds the reference's stitch maps (the refined
stitch's first pass feeds its second; the maps differ on the sensor-tie
columns).  Tolerances: the odometry steps within 5e-4 m / 2e-4 rad of the
reference's or of the nearest of its solves from jittered seeds (phase
i's rule); the label statistics equal; the rawlog's depth and the PbMap
read back equal."""

import sys
from pathlib import Path

import numpy as np
import pytest

from rgbd360_tpu_torch import synthetic
from rgbd360_tpu_torch.io.bin_format import read_rig_frame
from rgbd360_tpu_torch.io.dataset import SequenceDataset

from test_torch_apps import port_builder
from test_torch_segmentation import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]
import chip_smoke  # noqa: E402

SUB, LEVELS = 4, 3
JITTERS = 3


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return synthetic.write_app_inputs(tmp_path_factory.mktemp("extras"), SUB, loop_frames=0)


@pytest.fixture(scope="module")
def builder(paths):
    return port_builder(paths, synthetic.config(SUB, LEVELS))


@pytest.fixture(scope="module")
def calib(paths):
    return ["--calib", str(paths["calib"]), "--no-intrinsics", "--device", "cpu"]


def test_odometry_parallax_refine(paths, builder):
    """`odometry --parallax-refine` over the walk: phase m's step gate
    against the reference app's run with the same flag."""
    import torch_port_golden as G
    from rgbd360_tpu_torch.apps import odometry

    golden = G.odometry_refined_jax(paths, synthetic.config(SUB, LEVELS), JITTERS)
    _, traj = odometry.run(SequenceDataset(paths["walk"]), chip_smoke.refined_builder(builder))
    chip_smoke.check_refined_steps(traj, golden, "odometry --parallax-refine")


def test_odometry_main_accepts_flag(paths, calib, monkeypatch):
    """The app's own `main` builds a refined builder from the flag."""
    from rgbd360_tpu_torch.apps import odometry

    seen = {}
    monkeypatch.setattr(odometry, "run", lambda ds, b, **kw: seen.update(b=b) or (None, None))
    odometry.main([str(paths["walk"])] + calib + ["--parallax-refine"])
    assert seen["b"].config.sphere.parallax_refine


def test_labelize(paths, builder, calib, tmp_path):
    import torch_port_golden as G

    golden = G.labelize_jax(paths, synthetic.config(SUB, LEVELS), tmp_path)
    stats = chip_smoke.run_labelize(paths, tmp_path, builder, calib)
    chip_smoke.check_labels(stats, golden, "labelize")


def test_labelize_render(paths, builder, calib, tmp_path):
    """`labelize render`: an overlay PNG and the planes' metadata per frame."""
    import json

    from rgbd360_tpu_torch.apps import labelize

    labelize.main(["render", str(paths["walk"]), "--out", str(tmp_path)] + calib, builder=builder)
    meta = json.loads((tmp_path / "frame_1_planes.json").read_text())
    assert meta and {"plane", "center", "area"} <= set(meta[0])
    assert len(list(tmp_path.glob("frame_*_planes.png"))) == synthetic.APPS_WALK_FRAMES


def test_view_frame(paths, builder, calib, tmp_path):
    chip_smoke.check_view(chip_smoke.run_view(paths, tmp_path, builder, calib, builder.config),
                          "view_frame")


def test_load_rawlog(paths, builder, calib, tmp_path):
    walk = sorted(paths["walk"].glob("sphere_images_*.bin"),
                  key=lambda p: int(p.stem.rsplit("_", 1)[1]))
    raws = [read_rig_frame(p) for p in walk[:2]]
    chip_smoke.check_rawlog(chip_smoke.run_rawlog(raws, tmp_path, builder, calib), raws,
                            "load_rawlog")


def test_load_rawlog_matches_reference(paths, calib, tmp_path):
    """`load_rawlog --to-bin` of the same rawlog writes the same capture
    files as the reference app."""
    from rgbd360_tpu.apps import load_rawlog as j_load
    from rgbd360_tpu_torch.apps import load_rawlog
    from rgbd360_tpu_torch.io.rawlog import write_rawlog

    walk = sorted(paths["walk"].glob("sphere_images_*.bin"))[:2]
    write_rawlog(tmp_path / "w.rawlog", chip_smoke.gray_observations([read_rig_frame(p)
                                                                     for p in walk]))
    assert load_rawlog.main([str(tmp_path / "w.rawlog"), "--out", str(tmp_path / "p"),
                             "--to-bin"] + calib) == 2
    assert j_load.main([str(tmp_path / "w.rawlog"), "--out", str(tmp_path / "r"), "--to-bin"]) == 2
    for f in sorted((tmp_path / "r").iterdir()):
        assert (tmp_path / "p" / f.name).read_bytes() == f.read_bytes()


def test_save_gif_same_bytes_as_reference(tmp_path):
    """`utils/viz.save_gif` (a copy): the reference's bytes for the same
    frames, gray and color."""
    from rgbd360_tpu.utils.viz import save_gif as j_save_gif
    from rgbd360_tpu_torch.utils.viz import save_gif

    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (24, 40, 3)) for _ in range(3)] + [rng.integers(0, 256, (24, 40))]
    save_gif(tmp_path / "p.gif", frames, fps=5)
    j_save_gif(tmp_path / "r.gif", frames, fps=5)
    assert (tmp_path / "p.gif").read_bytes() == (tmp_path / "r.gif").read_bytes()
    chip_smoke.check_gif(tmp_path / "p.gif", 4, (24, 40), "gif")


def test_trace_to_writes_a_chrome_trace(tmp_path):
    """`utils/trace.trace_to` on `torch.profiler`: the region's stage
    annotations land in `trace.json`."""
    import json

    import torch

    from rgbd360_tpu_torch.utils.trace import StageTimer, trace_to

    timer = StageTimer()
    timer.enable()
    with trace_to(tmp_path / "tr"):
        with timer.region("stitch"):
            torch.ones(64).cumsum(0)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "stitch" for e in events)
    assert timer.counts["stitch"] == 1
