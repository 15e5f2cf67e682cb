"""A kidnapped rig through `KeyframeSLAM` in both packages at
`synthetic.config(4, 3)`: six frames of the 24-frame loop, a blind capture
(no depth: every solve is ill-posed, the tracker declares itself lost), then
two frames from the far side of the loop, where the relocaliser scans the
map, dense-verifies the plane hypothesis and falls back on the
three-family yaw rescue.

Compared exactly: the per-frame `keyframe`, `lost` and `relocalized` flags,
the frames at which the yaw rescue ran, and the edges.  Trajectories: the
small-size bounds of `test_torch_keyframe.py` (5e-3 m, 1e-3 rad) up to the
relocalisation; after it, the pose comes out of the relocaliser's dense
verification from a plane seed in a room with eight equivalent headings,
so only the keyframe relocalised TO is compared, not the pose.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from rgbd360_tpu_torch import synthetic
from rgbd360_tpu_torch.slam.odometry import KeyframeSLAM

from test_torch_segmentation import one_torch_thread  # noqa: F401
from test_torch_keyframe import SMALL_TOL_M, SMALL_TOL_RAD, SUB, _cfg, builder  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import chip_smoke  # noqa: E402

ORDER = [0, 1, 2, 3, 4, 5, None, 18, 19]
BLIND = ORDER.index(None)


@pytest.fixture(scope="module")
def runs(builder):  # noqa: F811
    import torch_port_golden

    loop = synthetic.loop_captures(synthetic.KIDNAP_LOOP_FRAMES, SUB,
                                   frames=[i for i in ORDER if i is not None])
    by_frame = dict(zip([i for i in ORDER if i is not None], loop))
    caps = [by_frame.get(i, (np.zeros_like(loop[0][0]), np.zeros_like(loop[0][1])))
            for i in ORDER]
    gt = synthetic.kidnap_poses(synthetic.loop_poses(synthetic.KIDNAP_LOOP_FRAMES), ORDER)
    raws = [chip_smoke.RawRigFrame(rgb=rgb, depth_mm=d) for rgb, d in caps]
    # synchronous events in both: the trajectory then does not depend on
    # when a deferred event's optimized poses are applied
    slam = KeyframeSLAM(builder, _cfg(False))
    got = chip_smoke.run_kidnap(slam, raws, gt)
    ref = torch_port_golden.kidnap_run_jax(caps, config=_cfg(False), gt=gt, async_events=False)
    return slam, got, ref


def test_lost_then_relocalized_as_the_reference(runs):
    _, got, ref = runs
    assert got["lost"].tolist() == [i == BLIND for i in range(len(ORDER))]
    assert got["relocalized"][BLIND + 1:].any() and not got["relocalized"][: BLIND + 1].any()
    for k in ("keyframe", "lost", "relocalized", "coarse_frames", "edges"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert int(got["n_loop_closures"]) == int(ref["n_loop_closures"])


def test_trajectory_up_to_the_relocalisation(runs):
    _, got, ref = runs
    dt, dr = chip_smoke._pose_gaps(got["trajectory"][: BLIND + 1], ref["trajectory"][: BLIND + 1])
    assert dt < SMALL_TOL_M and dr < SMALL_TOL_RAD, (dt, dr)
    # the blind frame keeps the last pose
    np.testing.assert_array_equal(got["trajectory"][BLIND], got["trajectory"][BLIND - 1])


def test_tracker_state_after_the_relocalisation(runs):
    slam, got, _ = runs
    assert not slam.lost and slam.track_rel is not None and not slam._pending
    assert np.isfinite(got["trajectory"]).all()
    assert slam._n_kf_host == int(slam.map.n_kf) == int(got["keyframe"].sum())
