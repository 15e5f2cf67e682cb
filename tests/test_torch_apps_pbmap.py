"""`kf_slam --pbmap --plane-ba` of the port against the reference's own
`main` on the same capture files, at the small size of
`test_torch_apps.py` (its inputs and builder), with synchronous keyframe
events in both packages (a deferred PbMap run's closures depend on when
its events run).

`kf_slam --pbmap` solves its pose graph in float64, as the reference's
g2o does; the JAX package solves it in float32, and on these small graphs
the two land within the tolerances below.

Tolerances.  The tracker's decisions, edges and closures exact, its PbMap
registrations' poses within `chip_smoke.PB_EDGE_TOL`; the keyframes' poses
are not compared (their heights come only from the loop closures, see
`test_torch_pbmap_slam.py`).  The planar BA (`chip_smoke.check_plane_ba`):
the same associations (integers), chi2 within 5e-3 relative (measured
2e-4), poses within 5e-3 m / 1e-3 rad along the directions its landmarks
observe (here only walls are associated: the vertical is unobserved and
keeps the tracker's heights, measured 0.46 m apart).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rgbd360_tpu_torch.apps import kf_slam
from rgbd360_tpu_torch.io.dataset import SequenceDataset
from rgbd360_tpu_torch.slam import pbmap_slam

from test_torch_segmentation import one_torch_thread  # noqa: F401
from test_torch_apps import SMALL_TOL_M, SMALL_TOL_RAD, port_builder, small_config, write_inputs

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return write_inputs(tmp_path_factory.mktemp("apps_pbmap"))


def test_make_tracker_picks_each_trackers_graph_precision(paths):
    """`kf_slam --pbmap` builds the PbMap tracker with its graph solve in
    float64 and the rest of the builder's configuration; `kf_slam` builds
    `KeyframeSLAM` on the builder's configuration (float32 by default)."""
    from rgbd360_tpu_torch.slam.odometry import KeyframeSLAM

    cfg = small_config()
    builder = port_builder(paths, cfg)
    pb = kf_slam.make_tracker(builder, pbmap=True)
    assert isinstance(pb, pbmap_slam.PbMapGraphSLAM)
    assert pb.config.graph.dtype == "float64"
    assert pb.config.replace(graph=cfg.graph) == cfg
    kf = kf_slam.make_tracker(builder)
    assert isinstance(kf, KeyframeSLAM) and kf.config == cfg
    assert kf.config.graph.dtype == "float32"


def test_pbmap_plane_ba_app_matches_reference(paths, monkeypatch):
    import torch_port_golden as G

    cfg = small_config()
    ref = G.apps_kf_slam_jax(paths, cfg, pbmap=True, plane_ba=True)
    solves = []
    solve = pbmap_slam.optimize_pose_graph

    def spy(graph, *args, **kw):
        out = solve(graph, *args, **kw)
        solves.append((kw.get("dtype"), out[0].dtype))
        return out

    monkeypatch.setattr(pbmap_slam, "optimize_pose_graph", spy)
    slam, ba = kf_slam.run(SequenceDataset(paths["loop"]), port_builder(paths, cfg), pbmap=True,
                           plane_ba_=True, gt=str(paths["gt"]))
    # every graph solve of the app's tracker ran in float64
    assert solves and set(solves) == {("float64", torch.float64)}
    got = chip_smoke.pbmap_record(slam, np.loadtxt(paths["gt"]).reshape(-1, 4, 4))
    assert got["n_loop_closures"] >= 1 and int(got["no_assoc"]) == 0
    chip_smoke.check_pbmap_run(got, ref, "kf_slam --pbmap", poses=False)
    from rgbd360_tpu_torch import convert

    prob = convert.plane_ba_problem_to_numpy(ba["problem"])
    got_ba = dict(poses=ba["poses"].numpy(), chi2=ba["chi2"], iters=ba["iters"], obs_kf=prob[2],
                  obs_pl=prob[3], normals=prob[1][:, :3])
    chip_smoke.check_plane_ba(got_ba, ref, "kf_slam --pbmap --plane-ba",
                              (SMALL_TOL_M, SMALL_TOL_RAD))
    # the refined poses are the map's
    np.testing.assert_array_equal(slam.map.opt_poses[: len(prob[0])].numpy(), ba["poses"].numpy())
