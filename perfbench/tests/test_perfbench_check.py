"""The check's own parts on the CPU: the sample drawn from the seed before
the window, the wrapping of the program's calls, and the reference's dense
solve on a pair whose answer is known."""

import json

import numpy as np
import pytest
import torch

from perfbench import check, harness, scene
from perfbench import reference as R

SAMPLE = {"frames": [3, 72], "solves": [3, 48], "graphs": [4, 16]}


def test_the_sample_is_drawn_from_the_seed_before_the_window():
    a, b, c = (check.Recorder(s, SAMPLE) for s in (2**31 + 1, 2**31 + 1, 2**31 + 2))
    assert a.drawn == b.drawn and a.drawn != c.drawn
    for kind, (k, n) in SAMPLE.items():
        assert len(a.drawn[kind]) == k and all(0 <= i < n for i in a.drawn[kind])
    hits = [a._draw("graphs") for _ in range(20)]
    assert sorted(i for i in hits if i is not None) == sorted(a.drawn["graphs"])
    assert a.calls["graphs"] == 20


def test_install_refuses_a_tracker_it_has_no_solvers_for():
    class Tracker:
        aligner = plane_reg = None

    with pytest.raises(KeyError):
        check.Recorder(1, SAMPLE).install(Tracker(), object(), spans=False)


def test_the_harness_lists_the_solvers_of_every_configured_tracker():
    for cfg in harness.HERE.glob("configs/*.json"):
        module = json.loads(cfg.read_text())["tracker"].split(":")[0]
        assert module in check.GRAPH_SOLVERS


def _pyramid_of_a_capture(levels=3):
    cfg = harness.framework_config(harness.load_json(
        harness.HERE / "configs" / "kfslam_rig8_qvga.json"), subsample=4)
    cal = harness.calibration_arrays(cfg, {"ring_radius_m": 0.055, "bin_width": 4,
                                           "bin_height": 3, "bins": 5, "bin_depth_m": 2.0,
                                           "seed": 0})
    rig = R.Rig.build(cal["rt"], cal["k"], (cfg.sphere.height, cfg.sphere.width),
                      (cfg.rig.height, cfg.rig.width), cal["mult"], cal["counts"],
                      cal["bin_w"], cal["bin_h"], cal["bin_depth"], "cpu")
    tex, depth = scene.render(scene.loop_poses(24, 0.8)[0], cal["rt"], 5.0, 1.7, subsample=4)
    rgb = torch.stack([tex, tex, tex], -1).to(torch.uint8).numpy()
    gray, d = R.sphere(rgb, depth.numpy().astype(np.uint16), rig)
    d_cfg = cfg.dense
    dense = {k: getattr(d_cfg, k) for k in (
        "min_depth", "max_depth", "std_photo", "std_depth", "sal_intensity", "sal_depth",
        "max_iters_per_level", "tol_update", "tol_residual")}
    dense["pyramid_levels"] = levels
    return R.pyramid(gray, d, levels, rig.seam_mask(), dense["min_depth"],
                     dense["max_depth"]), dense


def test_reference_dense_solve_returns_to_a_known_pose():
    """A frame against itself from a seed 2 cm and 0.6 degrees off: the
    solve goes back to the identity, and a solve of no steps stays put."""
    pyr, cfg = _pyramid_of_a_capture()
    init = R.se3_exp(torch.tensor([0.02, -0.01, 0.01, 0.0, 0.01, 0.0]))
    pose, ill = R.dense_solve(pyr, pyr, init, cfg)
    assert not ill
    assert float(torch.linalg.norm(pose[:3, 3])) < 2e-3
    assert float(torch.linalg.norm(R.so3_log(pose[:3, :3].double()))) < 2e-3
    still, _ = R.dense_solve(pyr, pyr, init, {**cfg, "max_iters_per_level": 0})
    assert torch.equal(still, init)
