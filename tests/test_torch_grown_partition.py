"""A deferred keyframe event's partition on a map that grew under it
(ROADMAP F1), for `KeyframeSLAM`.

With `max_keyframes=4` and `partition_every_n_kf=2`, keyframe 3's event is
due to partition; it clones the SSO matrix (4x4) at phase D and is held
there (`chip_smoke.hold_partitions`) until the next keyframe is promoted,
which doubles the map.  The port partitions the keyframes the snapshot
covers and keeps the area of every later keyframe; the covered keyframes'
areas equal the reference's `topological.partition_map` on the same
snapshot.  The reference's own tracker, held the same way, raises there
(`ValueError: could not broadcast`): a known fault of the reference, not
a parity target.  Exact comparisons (integer labels of one host function
on one snapshot).  The loop is the first 8 frames of the 16-frame loop at
`synthetic.config(4, 3)`, where every frame becomes a keyframe.
"""

import dataclasses
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from rgbd360_tpu_torch import synthetic
from rgbd360_tpu_torch.core.frame import FrameBuilder
from rgbd360_tpu_torch.slam.odometry import KeyframeSLAM

from test_torch_segmentation import one_torch_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SUB, LEVELS, LOOP, N = 4, 3, 16, 8


def grown_config():
    cfg = synthetic.config(SUB, LEVELS)
    cfg = cfg.replace(map=dataclasses.replace(cfg.map, max_keyframes=4, max_edges=32,
                                              partition_every_n_kf=2))
    return chip_smoke.keyframe_config(cfg, True)


def _awaits_sso(struct) -> bool:
    return struct is not None and any(
        getattr(x, "ndim", 0) == 2 and x.shape[0] == x.shape[1] for x in struct)


def hold_reference(slam) -> None:
    """The reference tracker's twin of `chip_smoke.hold_partitions`, whose
    readiness the port decides in `_phase_ready`: the reference decides it
    inside its `_poll_pending`, so that poller is replaced by one that
    advances every phase at once (as the CPU's always-ready schedule of
    the port) except an event awaiting the SSO snapshot, which waits until
    a later keyframe has been promoted.  Its piggybacked fetch is dropped
    (each advance fetches its own values); a drain advances everything."""
    poll, held = slam._poll_pending, {}  # generator -> live keyframes when first held

    def poll_holding(block=False):
        slam._head_prefetch = None
        if block:
            return poll(True)
        while slam._pending:
            gen, struct = slam._pending[0][:2]
            if _awaits_sso(struct) and slam._n_kf_host <= held.setdefault(gen, slam._n_kf_host):
                return None
            slam._advance_head()
        return None

    slam._poll_pending = poll_holding


def reference_partition(sso: np.ndarray, n_cov: int, threshold: float) -> np.ndarray:
    from rgbd360_tpu.slam.topological import partition_map

    full, _ = partition_map(types.SimpleNamespace(area=np.zeros(len(sso), np.int32)), threshold,
                            sso=sso, n_kf=n_cov)
    return np.asarray(full)[:n_cov]


def check_grown_partitions(slam, log, cfg) -> None:
    """The port's held run: completed, nothing pending, one partition on a
    grown map at least, covered keyframes as the reference partitions the
    snapshot, later keyframes unchanged, the host mirror equal to the map."""
    assert not slam._pending
    assert slam.map.kf_capacity > cfg.map.max_keyframes
    grown = [(sso, n_kf, before, areas) for sso, n_kf, before, areas in log if len(sso) < n_kf]
    assert grown, "no partition met a grown map"
    for sso, n_kf, before, areas in log:
        n_cov = min(n_kf, len(sso))
        want = reference_partition(sso, n_cov, cfg.map.sso_partition_threshold)
        np.testing.assert_array_equal(areas[:n_cov], want)
        np.testing.assert_array_equal(areas[n_cov:n_kf], before[n_cov:n_kf])
    chip_smoke.check_held_partitions(log, cfg, "grown partition")
    n_kf = int(slam.map.n_kf)
    if hasattr(slam, "_area_host"):
        assert slam._area_host == slam.map.area[:n_kf].tolist()
    assert int(slam.map.n_areas) >= int(slam.map.area[:n_kf].max()) + 1


@pytest.fixture(scope="module")
def raws():
    return chip_smoke.loop_raws(LOOP, SUB, frames=range(N))


def test_port_partitions_the_snapshot_of_a_grown_map(raws):
    cfg = grown_config()
    slam = KeyframeSLAM(FrameBuilder(synthetic.calibration(cfg.rig), cfg, device="cpu"), cfg)
    log = chip_smoke.hold_partitions(slam)
    for raw in raws:
        slam.process(raw)
    slam.flush()
    assert all(e["keyframe"] for e in slam.events)
    check_grown_partitions(slam, log, cfg)


def test_reference_tracker_raises_there(raws):
    """A known fault of the reference (the port's is repaired): held the
    same way, its deferred partition writes the grown map's labels into a
    snapshot-sized slice."""
    from _reference import reference_builder
    from rgbd360_tpu.io.bin_format import RawRigFrame
    from rgbd360_tpu.slam.odometry import KeyframeSLAM as JKeyframeSLAM

    cfg = grown_config()
    slam = JKeyframeSLAM(reference_builder(cfg))
    hold_reference(slam)
    with pytest.raises(ValueError, match="broadcast"):
        for raw in raws:
            slam.process(RawRigFrame(rgb=raw.rgb, depth_mm=raw.depth_mm))
        slam.flush()
