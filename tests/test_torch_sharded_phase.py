"""`chip_smoke.py` phase n's stage checks, driven on the CPU at a small
size (`synthetic.config(4, 3)`): `sharded_stages_rank` on 2 gloo ranks
(spawned, under a timeout) and its gate `check_stages` (each sharded stage
against its single-device counterpart at the reference's bounds), and the
planar BA problem the phase solves is the reference's own test problem."""

import dataclasses

import jax
import numpy as np

import chip_smoke
from rgbd360_tpu_torch import synthetic
from rgbd360_tpu_torch.parallel.spawn import run_ranks

from test_plane_ba import _make_problem

SUB, LEVELS = 4, 3


def test_box_problem_is_the_references():
    """The same draws as `tests/test_plane_ba._make_problem`: poses to 1e-7
    (the two packages' `se3_exp` in float32), everything else equal."""
    ref, _, _ = _make_problem(n_kf=8, noise=0.003, perturb=0.05, seed=2)
    got = chip_smoke.box_plane_ba_problem("cpu")
    for f, a in zip(dataclasses.fields(got), jax.tree_util.tree_leaves(ref)):
        b = getattr(got, f.name).numpy()
        assert b.shape == np.asarray(a).shape, f.name
        assert np.abs(b.astype(np.float64) - np.asarray(a, np.float64)).max() <= 1e-7, f.name


def test_sharded_stages_on_two_ranks(tmp_path):
    raws = chip_smoke.loop_raws(chip_smoke.LOOP_FRAMES, SUB)
    raws_path = str(tmp_path / "loop.npz")
    np.savez(raws_path, rgb=np.stack([r.rgb for r in raws]),
             depth=np.stack([r.depth_mm for r in raws]))
    paths = synthetic.write_app_inputs(tmp_path / "apps", SUB, loop_frames=0)
    golden = dict(np.load(chip_smoke.REGISTRATION_GOLDEN))
    seq = {"walk": str(paths["walk"]), "calib": str(paths["calib"]),
           "seeds": chip_smoke.golden_seeds(golden, "seq_pb_poses", "seq_pb_success")}
    ranks = run_ranks(chip_smoke.sharded_stages_rank, 2, "gloo", "cpu",
                      args=(raws_path, SUB, LEVELS, seq), timeout=400, threads=2)
    chip_smoke.check_stages(ranks[0])
    a, b = (r["seq"]["traj"] for r in ranks)
    assert np.array_equal(a, b) and np.isfinite(a).all()
    assert ranks[0]["scan_sharded_collectives"] == 1


def test_sharded_deferred_tracker_is_the_single_one_on_its_cadence(tmp_path):
    """Phase n's deferred sharded tracker on 2 gloo ranks against the
    single-device tracker with deferred events on the same deterministic
    poll cadence (rank 0 runs it in the same world) over the first 12
    captures of the loop: the same decisions, both trajectories within
    SHARDED_TOL_M (dense LM against the distributed LM-PCG), the ranks
    agreeing, and events in flight across frame boundaries."""
    raws = chip_smoke.loop_raws(12, SUB)
    raws_path = str(tmp_path / "loop.npz")
    np.savez(raws_path, rgb=np.stack([r.rgb for r in raws]),
             depth=np.stack([r.depth_mm for r in raws]))
    ranks = run_ranks(chip_smoke.sharded_tracker_rank, 2, "gloo", "cpu",
                      args=(raws_path, SUB, LEVELS, ("async",)), timeout=400, threads=2)
    got, single = ranks[0]["async"], ranks[0]["async_single"]
    assert got["deterministic"] and single["deterministic"] and "async_single" not in ranks[1]
    assert (got["pending_after"] > 0).any()
    assert np.array_equal(got["trajectory"], ranks[1]["async"]["trajectory"])
    chip_smoke.check_keyframe_decisions(got, single, "sharded vs single, deferred")
    assert not got["left_pending"] and not single["left_pending"]
    assert got["agree_trajectory"] and got["agree_schedule"]
    for k in ("trajectory", "optimized_trajectory"):
        assert chip_smoke._pose_gaps(got[k], single[k])[0] <= chip_smoke.SHARDED_TOL_M, k
