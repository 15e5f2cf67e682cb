"""The check that decides `correct`, driven through a whole run of the
cell on the CPU at a small size (subsample 4: 8x60x80 sensors, a 80x480
sphere, 3 levels), with the harness's look for a card skipped: a sound run
is correct and its control (the plain reference one precision step down in
the program's place) is not; a run with the timed path broken underneath
is not correct, once for each fault a cell can have.  The cells run on one
card, so no exchange between cards can be left out.  The control at the
cells' own size, on the card, is `test_control_on_the_card`."""

import time

import pytest
import torch

from perfbench import harness

SMALL = dict(device="cpu", subsample=4, max_frames=12,
             traffic_overrides={"warmup_laps": 0, "noise_laps": 1,
                                "sample": {"frames": [3, 12], "solves": [3, 8], "graphs": [4, 8]}})


def run(cell, seed=2**31 + 11, **kw):
    return harness.run_cell(cell, seed, 0.0, False, time.perf_counter(), **SMALL, **kw)


@pytest.mark.parametrize("cell", ["kfslam.loop24"])
def test_sound_run_is_correct_and_its_control_is_not(cell):
    out = run(cell, control=True)
    assert out["correct"], out["checks"]
    assert not out["control_correct"], out["control"]
    assert out["failed"] == 0 and out["attempted"] == 12
    assert set(out["checks"]) == set(harness.load_json(
        harness.HERE / "limits" / f"{cell}.json")) | {"failed_frames"}


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


FAULTS = {
    "kfslam.loop24": [stale_sphere, unchanged_graph, unmoved_solve, half_the_sensors,
                      half_the_pixels, altered_pose, altered_graph, raising_frame],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run(cell)
    assert not out["correct"], out["checks"]


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
                                                         "graphs": [4, 4]}})
    assert out["correct"], out["checks"]
    assert not out["control_correct"], out["control"]
