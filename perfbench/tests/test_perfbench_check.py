"""The check's own parts on the CPU: the sample drawn from the seed before
the window, the wrapping of the program's calls, the reference's dense
solve on a pair whose answer is known, and the reference's plane
registration against the program's on seeded plane sets and the octagon
room's captures."""

import json
import math

import numpy as np
import pytest
import torch

from perfbench import check, harness, scene
from perfbench import reference as R

SAMPLE = {"frames": [3, 72], "solves": [3, 48], "graphs": [4, 16], "registrations": [3, 80]}


def test_the_sample_is_drawn_from_the_seed_before_the_window():
    a, b, c = (check.Recorder(s, SAMPLE) for s in (2**31 + 1, 2**31 + 1, 2**31 + 2))
    assert a.drawn == b.drawn and a.drawn != c.drawn
    for kind, (k, n) in SAMPLE.items():
        assert len(a.drawn[kind]) == k and all(0 <= i < n for i in a.drawn[kind])
    hits = [a._draw("graphs") for _ in range(20)]
    assert sorted(i for i in hits if i is not None) == sorted(a.drawn["graphs"])
    assert a.calls["graphs"] == 20


def _first_stream_draws(seed, sample):
    """The draws of `frames`, `graphs` and `solves` as the check made them
    before it had other kinds: one stream, the kinds in sorted order."""
    rng = np.random.default_rng([int(seed), 7])
    return {kind: {int(i) for i in rng.choice(int(n), size=min(int(k), int(n)), replace=False)}
            for kind, (k, n) in sorted(sample.items())}


@pytest.mark.parametrize("seed", [1, 2**31 + 1, 2147484001, 2147484013, 3000001413,
                                  3000001501, 3000001514, 2**32 + 5])
def test_the_first_kinds_draw_as_before(seed):
    """Adding `registrations` leaves the frames, solves and graphs drawn for
    every seed as they were; a kind the sample leaves out is drawn as none."""
    sample = harness.load_json(harness.HERE / "traffic" / "loop24.json")["sample"]
    before = _first_stream_draws(seed, {k: sample[k] for k in check.FIRST_STREAM})
    rec = check.Recorder(seed, sample)
    assert {k: rec.drawn[k] for k in check.FIRST_STREAM} == before
    assert len(rec.drawn["registrations"]) == sample["registrations"][0]
    bare = check.Recorder(seed, {"frames": sample["frames"]})
    assert bare.drawn["frames"] == before["frames"]
    assert bare.drawn["registrations"] == set() and bare._draw("registrations") is None


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


# ------------------------------------------------------ plane registration

MODES = {"PLANAR_3DOF": R.PLANAR_3DOF, "PLANAR_ODOMETRY_3DOF": R.PLANAR_ODOMETRY_3DOF}


def _matcher():
    from rgbd360_tpu_torch.config import MatcherConfig

    m = MatcherConfig()
    return m, {k: getattr(m, k) for k in (
        "min_planes_recognition", "unary_dist_d", "unary_angle_deg", "hue_threshold",
        "area_threshold", "elongation_threshold", "binary_dist_threshold",
        "binary_angle_threshold_deg", "height_threshold", "max_matches")}


def _fields(ps) -> dict:
    return {f: getattr(ps, f) for f in R.PLANE_FIELDS}


def _seeded_planes(seed: int, k: int = 32, n_valid: int = 12):
    """A plane set of `k` slots, `n_valid` valid, drawn from `seed`, and the
    same planes seen from a pose 0.2 m and 10 degrees away with noise, in
    another order: the program's `PlaneSet`s."""
    from rgbd360_tpu_torch.ops.segmentation import PlaneSet

    g = torch.Generator().manual_seed(seed)
    normal = torch.nn.functional.normalize(torch.randn(k, 3, generator=g), dim=-1)
    center = 3.0 * torch.randn(k, 3, generator=g)
    area = 0.5 + 4.0 * torch.rand(k, generator=g)
    elong = 1.0 + 2.0 * torch.rand(k, generator=g)
    hue = torch.softmax(2.0 * torch.randn(k, 37, generator=g), -1)
    valid = torch.arange(k) < n_valid
    c, s = math.cos(0.17), math.sin(0.17)
    rot = torch.tensor([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])  # about the up axis x
    t = torch.tensor([0.0, 0.15, -0.13])
    perm = torch.cat([torch.randperm(n_valid, generator=g), torch.arange(n_valid, k)])
    n2 = (normal @ rot) + 0.003 * torch.randn(k, 3, generator=g)
    n2 = torch.nn.functional.normalize(n2, dim=-1)
    c2 = (center - t) @ rot + 0.01 * torch.randn(k, 3, generator=g)

    def make(nrm, ctr, idx):
        return PlaneSet(normal=nrm[idx], center=ctr[idx], d=-(nrm * ctr).sum(-1)[idx],
                        curvature=torch.zeros(k), area=area[idx], elongation=elong[idx],
                        n_inliers=torch.full((k,), 100.0), hull=torch.zeros(k, 4, 3),
                        hue_hist=hue[idx], main_color=torch.zeros(k, 3), valid=valid[idx])

    return make(normal, center, torch.arange(k)), make(n2, c2, perm)


def _octagon_planes(frames=(0, 1, 3, 12)):
    """The program's plane sets of loop captures of the octagon room, at
    subsample 4."""
    from rgbd360_tpu_torch.core.frame import FrameBuilder, RigFrame
    from rgbd360_tpu_torch.io.calib import Calibration

    cfg_file = harness.load_json(harness.HERE / "configs" / "kfslam_rig8_qvga.json")
    cfg = harness.framework_config(cfg_file, subsample=4)
    cal = harness.calibration_arrays(cfg, cfg_file["calibration"])
    builder = FrameBuilder(Calibration(
        rt=cal["rt"].astype(np.float32), rt_inv=np.linalg.inv(cal["rt"]).astype(np.float32),
        k=cal["k"], clams_multipliers=cal["mult"], clams_counts=cal["counts"],
        clams_bin_width=cal["bin_w"], clams_bin_height=cal["bin_h"],
        clams_bin_depth=cal["bin_depth"]), cfg, device="cpu")
    traffic = scene.LoopTraffic(harness.load_json(harness.HERE / "traffic" / "loop24.json"),
                                2**31 + 21, "cpu", subsample=4)
    return [builder.build_full(RigFrame.from_raw(traffic.frame(i), "cpu"))[2] for i in frames]


def _agree(ref, trg, mode):
    from rgbd360_tpu_torch.registration.planes import PlaneRegistration

    m, mcfg = _matcher()
    res = PlaneRegistration(m).register(ref, trg, mode)
    n = int(res.n_matches)
    pairs = [tuple(p) for p in res.pairs[:n].tolist()]
    want = R.plane_register(_fields(ref), _fields(trg), mcfg, mode)
    limits = harness.load_json(harness.HERE / "limits" / "kfslam.loop24.json")
    assert pairs == want["pairs"]
    assert check.match_gap(_fields(ref), _fields(trg), pairs, mcfg, mode) == 0.0
    assert bool(res.success) == want["success"]
    gap = R.se3_inv(want["pose"].double()) @ res.pose.double()
    assert float(torch.linalg.norm(gap[:3, 3])) <= limits["plane_pose_gap_m"]
    assert float(torch.linalg.norm(R.so3_log(gap[:3, :3]))) <= limits["plane_pose_gap_rad"]
    assert check.info_gap(res.information, want["information"]) <= limits["plane_info_gap"]
    return n, want


@pytest.mark.parametrize("mode", MODES.values(), ids=MODES.keys())
@pytest.mark.parametrize("seed", [2**31 + 31, 2**31 + 32, 2**31 + 33])
def test_plane_reference_agrees_on_seeded_sets(seed, mode):
    ref, trg = _seeded_planes(seed)
    n, want = _agree(ref, trg, mode)
    assert n >= 3 and want["success"]


@pytest.mark.parametrize("mode", MODES.values(), ids=MODES.keys())
def test_plane_reference_agrees_on_the_octagon(mode):
    planes = _octagon_planes()
    for a, b in ((0, 1), (1, 2), (0, 3)):
        _agree(planes[a], planes[b], mode)


def test_match_gap_reads_the_shortfall_and_its_ones():
    """The reference's own match set reads 0, a lower-voted live pick its
    shortfall, a pick that is not live 1, a set stopped early 1."""
    ref, trg = _seeded_planes(2**31 + 31)
    _, mcfg = _matcher()
    r, t = _fields(ref), _fields(trg)
    want = R.plane_register(r, t, mcfg, R.PLANAR_3DOF)["pairs"]
    assert len(want) >= 3
    cand = R.plane_candidates(r, t, mcfg, R.PLANAR_3DOF)
    cons = R.plane_consistency(r, t, cand, mcfg)
    votes = R.plane_votes(cons, cand, R.plane_vote_weights(r, t))
    live_votes = sorted({float(v) for v in votes.reshape(-1) if v > 0}, reverse=True)
    lower = [tuple(divmod(int(i), cand.shape[1])) for i in torch.nonzero(
        votes.reshape(-1) == live_votes[1])[:, 0]][0]
    gap = check.match_gap(r, t, [lower], mcfg, R.PLANAR_3DOF)
    assert gap == 1.0  # stopped after one pick while the reference votes on
    shortfall = (live_votes[0] - live_votes[1]) / live_votes[0]
    rest = R.plane_greedy(cons, R.plane_live_after(cand, cons, *lower),
                          R.plane_vote_weights(r, t), mcfg["max_matches"] - 1)
    assert check.match_gap(r, t, [lower] + rest, mcfg, R.PLANAR_3DOF) == pytest.approx(
        shortfall, rel=1e-6)
    dead = next((i, j) for i in range(cand.shape[0]) for j in range(cand.shape[1])
                if not cand[i, j])
    assert check.match_gap(r, t, [dead] + want[1:], mcfg, R.PLANAR_3DOF) == 1.0
    assert check.match_gap(r, t, want[:-1], mcfg, R.PLANAR_3DOF) == 1.0
    assert check.match_gap(r, t, want, mcfg, R.PLANAR_3DOF) == 0.0
