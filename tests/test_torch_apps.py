"""The port's apps (`apps/odometry.py`, `apps/kf_slam.py`,
`apps/grabber.py`) against the reference's own `main` on the same capture
files, at a small size: `synthetic.config(4, 3)`, a calibration directory
of the construction-spec extrinsics (`--no-intrinsics`), the first 8
frames of the 24-frame loop with their ground truth and 4 frames of the
walk, written with the port's `write_rig_frame`.  The reference runs
through `tools/torch_port_golden.py`'s `reference_apps` (its
`default_config` and calibration loader patched to the small rig); the
port runs each app's `run` with a builder of the same configuration on the
CPU, holding the reference builder's stitch maps (the two packages' maps
differ on the sensor-tie columns).  The `--pbmap --plane-ba` run is in
`test_torch_apps_pbmap.py`.

Tolerances.  Odometry: each frame's step within 5e-4 m / 2e-4 rad of the
reference's (the smoke's odometry gate); `--keyframe` trajectories within
5e-3 m / 1e-3 rad (`test_torch_keyframe.py`'s small-size bound: every
tracked solve at this size is a degraded one).  `kf_slam`, with synchronous keyframe events in
both packages (with deferred ones the trajectory depends on when an
event's poses land): decisions exact (keyframes, edges, closures, areas);
trajectories and tracked edges' poses within the smoke's KF_TOL, 0.02 m /
0.01 rad (measured 8.3e-3 m and 1.9e-2 m: without the CLAMS model every
tracked solve here is a degraded one and ends on its accept-if-improved
exit, see `chip_smoke.py`); the closures' poses and the chi2 they weigh
are not compared (measured: two closures of the same keyframes accepted
through heading rescues on different aliases of the eightfold room, 2.8
rad apart, in runs that pass every gate).  `--online` over a finished capture directory: the plain
run's trajectory, bit for bit.  Files: exist and are not empty.
"""

import dataclasses
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rgbd360_tpu_torch import convert, synthetic
from rgbd360_tpu_torch.apps import grabber, kf_slam, odometry
from rgbd360_tpu_torch.core.frame import FrameBuilder
from rgbd360_tpu_torch.io.calib import load_calibration
from rgbd360_tpu_torch.io.dataset import SequenceDataset, StreamingDataset

from test_torch_segmentation import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]
import chip_smoke  # noqa: E402

# The first 8 frames of the 24-frame loop (15 degrees per frame): in the
# eightfold-symmetric octagon room a 16-frame loop turns 22.5 degrees per
# frame, where the two yaw aliases +-22.5 of a wall-only plane registration
# tie exactly (measured: equal greedy votes, 447.2034, in both packages;
# which one wins is a rounding coin toss inside the matcher's reduction).
SUB, LEVELS, LOOP, N, WALK = 4, 3, 24, 8, 4
STEP_TOL_M, STEP_TOL_RAD = 5e-4, 2e-4
SMALL_TOL_M, SMALL_TOL_RAD = 5e-3, 1e-3
OUT_FILES = chip_smoke.APP_OUT_FILES


def small_config(async_events: bool = False):
    cfg = synthetic.config(SUB, LEVELS)
    cfg = cfg.replace(map=dataclasses.replace(cfg.map, max_keyframes=8, max_edges=32))
    return chip_smoke.keyframe_config(cfg, async_events)


def write_inputs(root: Path) -> dict:
    paths = {"calib": root / "calib", "loop": root / "loop", "walk": root / "walk"}
    synthetic.write_calibration(paths["calib"], small_config().rig)
    synthetic.write_captures(paths["loop"], synthetic.loop_captures(LOOP, SUB, frames=range(N)),
                             synthetic.loop_poses(LOOP)[:N])
    synthetic.write_captures(paths["walk"], synthetic.captures(WALK, SUB))
    paths["gt"] = paths["loop"] / "gt_poses.txt"
    return paths


def port_builder(paths: dict, cfg) -> FrameBuilder:
    """The port's builder of the apps' calibration directory at `cfg`,
    holding the reference builder's stitch maps."""
    from _reference import reference_builder

    calib = load_calibration(paths["calib"] / "Extrinsics", None, rig=cfg.rig)
    b = FrameBuilder(calib, cfg, device="cpu")
    params = reference_builder(cfg)._params
    maps = {k: np.asarray(params[k]) for k in ("sensor", "u", "v", "scale", "valid")}
    b.load_state_dict(convert.stitch_maps_state_dict(maps, LEVELS), strict=False)
    return b


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return write_inputs(tmp_path_factory.mktemp("apps"))


@pytest.fixture(scope="module")
def builder(paths):
    return port_builder(paths, small_config())


@pytest.fixture(scope="module")
def reference(paths):
    import torch_port_golden as G

    cfg = small_config()
    return {"odometry": G.apps_odometry_jax(paths, cfg),
            "odometry_kf": G.apps_odometry_jax(paths, cfg, keyframe=True),
            "kf_slam": G.apps_kf_slam_jax(paths, cfg)}


def _steps(t):
    return np.linalg.inv(t[:-1]) @ t[1:]


def test_odometry_app_matches_reference(paths, builder, reference, tmp_path):
    _, traj = odometry.run(SequenceDataset(paths["walk"]), builder, out=tmp_path)
    assert traj.shape == (WALK, 4, 4)
    chip_smoke._gate_gaps("odometry steps", _steps(traj), _steps(reference["odometry"]),
                          STEP_TOL_M, STEP_TOL_RAD)
    for name in ("trajectory.txt", "trajectory.ply"):
        assert (tmp_path / name).stat().st_size > 0
    rows = np.loadtxt(tmp_path / "trajectory.txt")
    np.testing.assert_allclose(rows[:, 1:4], traj[:, :3, 3], atol=1e-6)

    # --online over the finished directory (its capture_done marker set)
    live = tmp_path / "live"
    shutil.copytree(paths["walk"], live)
    (live / "capture_done").touch()
    _, online = odometry.run(StreamingDataset(live, idle_timeout=5), builder)
    np.testing.assert_array_equal(online, traj)


def test_keyframe_odometry_app_matches_reference(paths, builder, reference):
    tracker, traj = odometry.run(SequenceDataset(paths["walk"]), builder, keyframe=True)
    chip_smoke._gate_gaps("keyframe odometry", traj, reference["odometry_kf"],
                          SMALL_TOL_M, SMALL_TOL_RAD)
    assert tracker.events[0]["keyframe"]


def test_kf_slam_app_matches_reference(paths, builder, reference, tmp_path):
    slam, ba = kf_slam.run(SequenceDataset(paths["loop"]), builder, gt=str(paths["gt"]),
                           timing=True, out=tmp_path)
    assert ba is None
    got = chip_smoke.keyframe_record(slam, np.loadtxt(paths["gt"]).reshape(-1, 4, 4))
    chip_smoke.check_keyframe_run(got, reference["kf_slam"], "kf_slam app", closures=False)
    n_kf = int(slam.map.n_kf)
    names = list(OUT_FILES) + [f"kf_{k:03d}.ply" for k in range(n_kf)]
    chip_smoke.check_app_files(tmp_path, names, "kf_slam app")
    leaves = np.load(tmp_path / "map.npz")
    np.testing.assert_array_equal(leaves["leaf_0"], n_kf)  # the map's n_kf, reloadable
    head = (tmp_path / "map.pcd").read_bytes()[:200].decode("ascii", "replace")
    assert "FIELDS x y z rgb" in head and "DATA binary" in head


def test_parallax_refine_raises(paths, monkeypatch):
    """`--parallax-refine` (which raised NotImplementedError until the
    refined stitch was ported; the test keeps its name): each app builds a
    refined builder and nothing raises.  The refined runs themselves are
    held in tests/test_torch_extras_apps.py."""
    argv = [str(paths["walk"]), "--calib", str(paths["calib"]), "--no-intrinsics",
            "--parallax-refine", "--device", "cpu"]
    for app in (odometry, kf_slam):
        seen = {}
        monkeypatch.setattr(app, "run", lambda ds, b, **kw: seen.update(b=b) or (None, None))
        app.main(argv)
        assert seen["b"].config.sphere.parallax_refine, app.__name__


def test_apps_need_a_device_or_the_card(paths):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the apps' default device is the card")
    argv = [str(paths["walk"]), "--calib", str(paths["calib"]), "--no-intrinsics"]
    for app in (odometry, kf_slam):
        with pytest.raises(RuntimeError, match="CUDA"):
            app.main(argv)


def test_grabber_synth_and_repack_match_reference(tmp_path):
    """`synth` writes the reference's bytes; `repack` re-serializes and
    verifies; both read back through `SequenceDataset`."""
    from rgbd360_tpu.apps import grabber as jgrabber

    args = ["--frames", "2", "--trajectory", "loop", "--room", "octagon", "--seed", "3"]
    grabber.main(["synth", str(tmp_path / "port"), *args])
    jgrabber.main(["synth", str(tmp_path / "ref"), *args])
    for name in ("sphere_images_1.bin", "sphere_images_2.bin", "gt_poses.txt"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()
    grabber.main(["repack", str(tmp_path / "port"), str(tmp_path / "repacked")])
    a, b = SequenceDataset(tmp_path / "port"), SequenceDataset(tmp_path / "repacked")
    assert a.indices == b.indices == [1, 2]
    for x, y in zip(a, b):
        assert np.array_equal(x.rgb, y.rgb) and np.array_equal(x.depth_mm, y.depth_mm)
    gt = np.loadtxt(tmp_path / "port" / "gt_poses.txt").reshape(-1, 4, 4)
    np.testing.assert_allclose(gt, grabber.synth_trajectory_poses("loop", 2), atol=1e-9)
