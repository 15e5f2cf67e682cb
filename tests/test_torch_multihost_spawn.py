"""TRUE multi-process runs of the port (twin of
`tests/test_multihost_spawn.py`): separate OS processes, spawned, that
rendezvous through a FileStore in a gloo process group on the CPU, each
under its own timeout (`parallel.spawn.run_ranks`).

* a cross-process psum over the global mesh: each rank's shard reaches
  the global array, every rank sees the same sum and agrees;
* the PRODUCTION tracker, `KeyframeSLAM(mesh=)`, at the reference worker's
  32x192 configuration on 2 ranks: events stay in flight across frame
  boundaries on the deterministic poll cadence, the ranks agree on the
  pending-queue schedule and the trajectory, and the trajectory is held to
  the single-rank port's and to the JAX tracker's on the same frames at
  the reference's own bound, 5e-3 m (the sharded run solves the graph
  with distributed LM-PCG where the single ones use dense LM, and its
  events land on other frames).
"""

import numpy as np
import pytest

from rgbd360_tpu_torch.parallel.spawn import run_ranks

from _torch_ranks import psum_worker, raise_before_collective, tracker_rank

RANK_TIMEOUT_S = 300
N_FRAMES = 4
TRACK_TOL_M = 5e-3  # the reference's sharded-vs-single bound


def test_two_process_distributed_psum():
    runs = run_ranks(psum_worker, 2, "gloo", "cpu", timeout=RANK_TIMEOUT_S, threads=1)
    for out in runs:
        assert out["sum"] == 0 + 1 + 2 + 3 and out["agree"] is True


def test_rank_failure_ends_the_call_at_once():
    """A rank that raises while its peer waits in a collective fails the
    call with its traceback at once, not at the timeout."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails before the collective"):
        run_ranks(raise_before_collective, 2, "gloo", "cpu", timeout=RANK_TIMEOUT_S, threads=1)
    assert time.monotonic() - t0 < RANK_TIMEOUT_S / 5


@pytest.fixture(scope="module")
def jax_tracker():
    """The JAX tracker, single device, on the same frames and configuration
    as the reference's TRACKER_WORKER."""
    from dataclasses import replace

    from __graft_entry__ import _box_room_sphere
    from rgbd360_tpu.calibration.solver import construction_spec_rt
    from rgbd360_tpu.config import default_config
    from rgbd360_tpu.core.frame import FrameBuilder
    from rgbd360_tpu.io.calib import Calibration
    from rgbd360_tpu.slam.odometry import KeyframeSLAM

    cfg = default_config()
    cfg = cfg.replace(
        rig=replace(cfg.rig, width=32, height=24, fx=26.0, fy=26.0, cx=15.5, cy=11.5),
        sphere=replace(cfg.sphere, width=192, height=32),
        dense=replace(cfg.dense, pyramid_levels=2),
        seg=replace(cfg.seg, min_inliers=40),
        map=replace(cfg.map, max_keyframes=16, max_edges=32),
        kf=replace(cfg.kf, select_kf_icp_dist=1e-6, min_dist_keyframes=1e-6),
    )
    rt = construction_spec_rt(8)
    calib = Calibration(
        rt=np.asarray(rt, np.float32),
        rt_inv=np.linalg.inv(np.asarray(rt)).astype(np.float32),
        k=np.array([[26.0, 0, 15.5], [0, 26.0, 11.5], [0, 0, 1]], np.float32),
    )
    slam = KeyframeSLAM(FrameBuilder(calib), cfg)
    for i in range(N_FRAMES):
        g, d = _box_room_sphere(32, 192, np.array([0.04 * i, 0.0, 0.02 * i]))
        slam.process_state(slam.make_state_from_sphere(g, d))
    slam.flush()
    return np.stack(slam.trajectory), int(slam.map.n_kf)


def test_two_process_production_tracker(jax_tracker):
    runs = run_ranks(tracker_rank, 2, "gloo", "cpu", args=(N_FRAMES,),
                     timeout=RANK_TIMEOUT_S, threads=1)
    ref_traj, ref_n_kf = jax_tracker
    for out in runs:
        assert out["deterministic"] and not out["lost"]
        assert sum(1 for p in out["pending_after"] if p > 0) >= 1, out["pending_after"]
        assert out["agree_schedule"] and out["agree_traj"]
        assert out["n_kf"] == out["single_n_kf"] == ref_n_kf
        assert np.isfinite(out["opt_poses"]).all()
        for other in (out["single_traj"], ref_traj):
            assert np.abs(out["traj"] - other).max() < TRACK_TOL_M, np.abs(out["traj"] - other).max()
    assert np.array_equal(runs[0]["traj"], runs[1]["traj"])
