"""The check that decides `correct`, driven through a whole run of the
cell on the CPU at a small size (subsample 4: 8x60x80 sensors, a 80x480
sphere, 3 levels), with the harness's look for a card skipped: a sound run
is correct and its control (the plain reference one precision step down in
the program's place) is not; a run with the timed path broken underneath
is not correct, once for each fault a cell can have.  The cells run on one
card, so no exchange between cards can be left out.  The control at the
cells' own size, on the card, is `test_control_on_the_card`."""

import math
import time

import pytest
import torch

from perfbench import check, harness

SAMPLE = {"frames": [3, 12], "solves": [3, 8], "graphs": [4, 8], "registrations": [3, 10]}
SMALL = dict(device="cpu", subsample=4, max_frames=12,
             traffic_overrides={"warmup_laps": 0, "noise_laps": 1, "sample": SAMPLE})
PLANE_NUMBERS = ("plane_match_gap", "plane_pose_gap_m", "plane_pose_gap_rad", "plane_info_gap")


def run(cell, seed=2**31 + 11, **kw):
    return harness.run_cell(cell, seed, 0.0, False, time.perf_counter(), **SMALL, **kw)


@pytest.mark.parametrize("cell", ["kfslam.loop24"])
def test_sound_run_is_correct_and_its_control_is_not(cell):
    out = run(cell, control=True)
    assert out["correct"], out["checks"]
    assert not out["control_correct"], out["control"]
    assert out["failed"] == 0 and out["attempted"] == 12
    limits = harness.load_json(harness.HERE / "limits" / f"{cell}.json")
    assert set(out["checks"]) == set(limits) | {"failed_frames"}
    # the control of the plane registration alone is not correct either
    planes = {k: limits[k] for k in PLANE_NUMBERS}
    assert not check.judge({k: out["control"][k] for k in planes}, planes)[0], out["control"]


# ---------------------------------------------------------------- faults


def stale_sphere(mp):
    """A step that returns its state unchanged: the frame build hands back
    the previous capture's sphere."""
    from rgbd360_tpu_torch.core.frame import FrameBuilder

    orig = FrameBuilder._build_impl
    last = []

    def build(self, rgb, depth, timer=None):
        out = orig(self, rgb, depth, timer)
        if last:
            out = last[0]
        last[:] = [out]
        return out

    mp.setattr(FrameBuilder, "_build_impl", build)


def unchanged_graph(mp):
    """A step that returns its state unchanged: the pose-graph solve gives
    back its input poses."""
    from rgbd360_tpu_torch.slam import graph

    def lm(g, max_iters, lm_lambda0, lm_step, chi2_of, step_of):
        return g.poses.clone(), chi2_of(g.poses), 0

    mp.setattr(graph, "_lm_loop", lm)


def unmoved_solve(mp):
    """A step that returns its state unchanged: the dense solve takes no
    step at any level and returns its init pose, with the normal matrix and
    residuals of that pose."""
    from rgbd360_tpu_torch.registration import dense

    orig = dense._gn_level

    def gn_level(*a):
        return orig(*a[:-1], 0)

    mp.setattr(dense, "_gn_level", gn_level)


def raising_frame(mp):
    """An answer that never comes: the frame build of the fifth capture
    raises, and the window goes on without that frame's pose."""
    from rgbd360_tpu_torch.core.frame import FrameBuilder

    orig = FrameBuilder.build_full
    calls = []

    def build_full(self, *a, **kw):
        calls.append(1)
        if len(calls) == 5:
            raise RuntimeError("planted fault")
        return orig(self, *a, **kw)

    mp.setattr(FrameBuilder, "build_full", build_full)


def half_the_sensors(mp):
    """Half of the batch left out: the stitch sees the depth of four of the
    eight sensors."""
    from rgbd360_tpu_torch.ops import stitch

    orig = stitch.stitch_batch

    def stitch_batch(maps, rgb, depth):
        depth = depth.clone()
        depth[:, 4:] = 0.0
        return orig(maps, rgb, depth)

    mp.setattr(stitch, "stitch_batch", stitch_batch)


def half_the_pixels(mp):
    """Half of the batch left out: the dense solve's sweep over half of the
    source pixels, its means taken over the rest."""
    from rgbd360_tpu_torch.registration import dense

    orig = dense._hess_grad_packed

    def sweep(src_gray, pts, valid_src, *a, **kw):
        valid_src = valid_src.clone()
        valid_src[..., valid_src.shape[-1] // 2:] = False
        return orig(src_gray, pts, valid_src, *a, **kw)

    mp.setattr(dense, "_hess_grad_packed", sweep)


def altered_pose(mp):
    """An answer altered where it is produced: the dense solve's pose moved
    by 5 mm after its statistics were taken."""
    from rgbd360_tpu_torch.registration import dense

    orig = dense.DenseAligner._align_impl

    def align(self, *a, **kw):
        res = orig(self, *a, **kw)
        res.pose = res.pose.clone()
        res.pose[..., 0, 3] += 0.005
        return res

    mp.setattr(dense.DenseAligner, "_align_impl", align)


def altered_graph(mp):
    """An answer altered where it is produced: the pose-graph solve's
    poses moved by 1 cm, horizontally."""
    from rgbd360_tpu_torch.slam import graph

    orig = graph._lm_loop

    def lm(*a, **kw):
        poses, chi2, iters = orig(*a, **kw)
        poses = poses.clone()
        poses[1:, 1, 3] += 0.01
        return poses, chi2, iters

    mp.setattr(graph, "_lm_loop", lm)


def _altered_registration(mp, alter):
    """`PlaneRegistration.register` with `alter(result)` applied to what it
    returns."""
    from rgbd360_tpu_torch.registration import planes

    orig = planes.PlaneRegistration.register

    def register(self, ref, trg, mode=planes.PLANAR_3DOF):
        res = orig(self, ref, trg, mode)
        alter(res)
        return res

    mp.setattr(planes.PlaneRegistration, "register", register)


def lower_voted_pick(mp):
    """An answer altered where it is produced: the plane matcher's first
    greedy step takes the live pair of the lowest positive vote, not the
    highest (the program's own gates and votes, a single pair's loop)."""
    from rgbd360_tpu_torch.registration import planes

    orig = planes.match_planes

    def match(ref, trg, cfg, mode=planes.PLANAR_3DOF):
        if ref.valid.ndim != 1 or trg.valid.ndim != 1:
            return orig(ref, trg, cfg, mode)
        cand = planes.unary_compatibility(ref, trg, cfg, mode)
        cons = planes.binary_consistency(ref, trg, cand, cfg)
        k1, k2 = cand.shape
        w = torch.sqrt(torch.clamp(ref.area[:, None], min=1e-3)
                       * torch.clamp(trg.area[None, :], min=1e-3))
        cons_f = cons.reshape(k1 * k2, k1 * k2).float()
        chosen = torch.full((cfg.max_matches, 2), -1, dtype=torch.int32)
        live, n = cand, 0
        for step in range(cfg.max_matches):
            votes = (cons_f @ torch.where(live, w, 0.0).reshape(-1)).reshape(k1, k2) * w
            votes = torch.where(live, votes, -1.0).reshape(-1)
            if not float(votes.max()) > 0.0:
                break
            best = int(torch.argmax(votes))
            if step == 0:
                low = torch.where(votes > 0.0, votes, math.inf)
                best = int(torch.argmin(low))
            i, j = divmod(best, k2)
            chosen[n] = torch.tensor([i, j], dtype=torch.int32)
            n += 1
            live = live & cons[i, j]
            live[i, :] = False
            live[:, j] = False
        return chosen.to(cand.device), torch.tensor(n, dtype=torch.int32, device=cand.device)

    mp.setattr(planes, "match_planes", match)


def rotated_plane_pose(mp):
    """An answer altered where it is produced: the registration's pose
    turned by 1e-3 rad about the up axis."""
    c, s = math.cos(1e-3), math.sin(1e-3)
    turn = torch.tensor([[1.0, 0.0, 0.0, 0.0], [0.0, c, -s, 0.0], [0.0, s, c, 0.0],
                         [0.0, 0.0, 0.0, 1.0]])

    def alter(res):
        res.pose = turn.to(res.pose) @ res.pose

    _altered_registration(mp, alter)


def scaled_plane_information(mp):
    """An answer altered where it is produced: the registration's
    information matrix scaled by 1.01."""
    def alter(res):
        res.information = res.information * 1.01

    _altered_registration(mp, alter)


def flipped_plane_success(mp):
    """An answer altered where it is produced: the registration's `success`
    flipped."""
    def alter(res):
        res.success = ~res.success

    _altered_registration(mp, alter)


FAULTS = {
    "kfslam.loop24": [stale_sphere, unchanged_graph, unmoved_solve, half_the_sensors,
                      half_the_pixels, altered_pose, altered_graph, raising_frame,
                      lower_voted_pick, rotated_plane_pose, scaled_plane_information,
                      flipped_plane_success],
}
# the number each fault of the plane registration has to fail by itself
PLANE_FAULTS = {lower_voted_pick: "plane_match_gap", rotated_plane_pose: "plane_pose_gap_rad",
                scaled_plane_information: "plane_info_gap",
                flipped_plane_success: "plane_pose_gap_m"}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run(cell)
    assert not out["correct"], out["checks"]
    if fault in PLANE_FAULTS:
        c = out["checks"][PLANE_FAULTS[fault]]
        assert not float(c["value"]) <= c["limit"], out["checks"]


def test_pbmap_tracker_runs_through_the_check():
    """`PbMapGraphSLAM` (the configuration held here: `kf_slam --pbmap` on
    the cell's rig) over one lap: the check takes its tracker module, and
    the run is correct with the sphere, pyramid, plane registration and
    graph numbers present (it makes no single-pair dense solve)."""
    cfg_file = {**harness.load_json(harness.HERE / "configs" / "kfslam_rig8_qvga.json"),
                "name": "pbmap_rig8_qvga",
                "tracker": "rgbd360_tpu_torch.slam.pbmap_slam:PbMapGraphSLAM"}
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    bench = {**bench, "workloads": [{"name": "pbmap.loop24", "config": "pbmap_rig8_qvga",
                                     "traffic": "loop24", "chips": 1}]}
    limits = {k: v for k, v in harness.load_json(
        harness.HERE / "limits" / "kfslam.loop24.json").items() if not k.startswith("track_")}
    out = harness.run_cell("pbmap.loop24", 2**31 + 11, 0.0, False, time.perf_counter(),
                           **{**SMALL, "max_frames": 24}, bench=bench, cfg_file=cfg_file,
                           limits=limits)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 24 and out["work"]["loop_closures"] > 0
    for name in limits:
        assert out["checks"][name]["value"] is not None, name


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_control_on_the_card(seed):
    """At the cell's own size on the card: the program is correct and the
    control is not (a 30-frame window, the sample drawn from it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read at the cell's own size")
    out = harness.run_cell("kfslam.loop24", seed, 0.0, False, time.perf_counter(),
                           max_frames=30, control=True,
                           traffic_overrides={"sample": {"frames": [3, 30], "solves": [3, 28],
                                                         "graphs": [4, 4],
                                                         "registrations": [3, 28]}})
    assert out["correct"], out["checks"]
    assert not out["control_correct"], out["control"]
