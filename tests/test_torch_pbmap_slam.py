"""`PbMapGraphSLAM` of the port (`slam/pbmap_slam.py`) against the
reference's, on the first 8 frames of the 16-frame loop in the octagon room
at `synthetic.config(4, 3)` (map capacity 4 keyframes, so the map grows
twice), both on the reference builder's stitch maps (as
`test_torch_keyframe.py`).

Tolerances.  The tracker's decisions (keyframe flags, the reference
keyframe of every frame, frames without association) are exact.  With
synchronous events the edges, loop closures and partition are exact too,
and the PbMap registrations' poses within `chip_smoke.PB_EDGE_TOL`
(1e-3; measured ~1e-5).  The keyframes' poses are compared only up to the
first optimization, at 5e-3 m / 1e-3 rad (measured 9e-5 m): a wall-only
registration carries no information on the vertical translation, so the
heights come only from the loop closures, whose salient verifications at
this size are degraded solves with several solutions (measured: one
closure 0.75 m apart between the packages, the later poses 5.9 cm apart,
vertically).  Deferred events against synchronous ones: the tracker's
decisions exact, nothing pending after `flush()`; which closures a
deferred event verifies depends on when it runs (the reference's own
deferred run closes 25 loops where its synchronous one closes 35 over the
16 frames), so those are not compared.  The map grown under a deferred
partition: exact, as in `test_torch_grown_partition.py`.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

from rgbd360_tpu_torch import convert, synthetic
from rgbd360_tpu_torch.core.frame import FrameBuilder
from rgbd360_tpu_torch.slam.pbmap_slam import PbMapGraphSLAM

from test_torch_segmentation import one_torch_thread  # noqa: F401
from test_torch_grown_partition import check_grown_partitions, grown_config, hold_reference

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[1] / "tools")]
import chip_smoke  # noqa: E402

SUB, LEVELS, LOOP, N = 4, 3, 16, 8
TOL_M, TOL_RAD = 5e-3, 1e-3


def _cfg(async_events: bool):
    cfg = synthetic.config(SUB, LEVELS)
    cfg = cfg.replace(map=dataclasses.replace(cfg.map, max_keyframes=4, max_edges=16))
    return chip_smoke.keyframe_config(cfg, async_events)


@pytest.fixture(scope="module")
def builder():
    from _reference import reference_builder

    cfg = _cfg(False)
    b = FrameBuilder(synthetic.calibration(cfg.rig), cfg, device="cpu")
    params = reference_builder(cfg)._params
    maps = {k: np.asarray(params[k]) for k in ("sensor", "u", "v", "scale", "valid")}
    b.load_state_dict(convert.stitch_maps_state_dict(maps, LEVELS), strict=False)
    return b


@pytest.fixture(scope="module")
def raws():
    return chip_smoke.loop_raws(LOOP, SUB, frames=range(N))


@pytest.fixture(scope="module")
def gt():
    return synthetic.loop_poses(LOOP)[:N]


def _run(slam, raws, gt) -> dict:
    for raw in raws:
        slam.process(raw)
    slam.flush()
    assert not slam._pending
    return chip_smoke.pbmap_record(slam, gt)


@pytest.fixture(scope="module")
def sync_run(builder, raws, gt):
    return _run(PbMapGraphSLAM(builder, _cfg(False)), raws, gt)


@pytest.fixture(scope="module")
def reference_run(raws, gt):
    import torch_port_golden as G

    return G.pbmap_run_jax([(r.rgb, r.depth_mm) for r in raws], False, _cfg(False), gt)[1]


def test_sync_matches_reference(sync_run, reference_run):
    got, ref = sync_run, reference_run
    assert got["keyframe"].sum() >= 6 and got["n_loop_closures"] >= 1
    chip_smoke.check_pbmap_run(got, ref, "PbMap, synchronous events", poses=False)
    np.testing.assert_array_equal(got["loop_closures"], ref["loop_closures"])
    # the frame of the first keyframe event that closes a loop (and optimizes)
    first = int(np.flatnonzero(got["keyframe"])[np.argmax(got["loop_closures"] > 0)])
    chip_smoke._gate_gaps("PbMap poses before the first optimization",
                          got["trajectory"][:first], ref["trajectory"][:first], TOL_M, TOL_RAD)


def test_deferred_matches_sync_decisions(builder, raws, gt, sync_run):
    """Events really deferred (every phase not ready the first time it is
    asked, as on a busy card) and the CPU's always-ready schedule."""
    from test_torch_keyframe import _deferred

    slam = PbMapGraphSLAM(builder, _cfg(True))
    _deferred(slam)
    max_pending = 0
    for raw in raws:
        slam.process(raw)
        max_pending = max(max_pending, len(slam._pending))
    slam.flush()
    assert 1 <= max_pending <= 2 and not slam._pending
    rec = chip_smoke.pbmap_record(slam, gt)
    chip_smoke.check_pbmap_run(rec, sync_run, "PbMap, deferred events", events=False, poses=False)
    assert slam.kf_event_dispatches and len(slam.kf_event_dispatches) == int(rec["keyframe"].sum()) - 1

    plain = _run(PbMapGraphSLAM(builder, _cfg(True)), raws, gt)
    chip_smoke.check_pbmap_run(plain, sync_run, "PbMap, ready events", poses=False)


def test_partition_of_a_map_grown_under_a_deferred_event(raws):
    """F1 for PbMapGraphSLAM (it promotes every tracked frame): the port
    partitions the snapshot's keyframes and keeps the later ones' areas;
    the reference's own tracker, held the same way, raises (a known fault
    of the reference, not a parity target)."""
    from _reference import reference_builder
    from rgbd360_tpu.io.bin_format import RawRigFrame
    from rgbd360_tpu.slam.pbmap_slam import PbMapGraphSLAM as JPbMapGraphSLAM

    cfg = grown_config()
    slam = PbMapGraphSLAM(FrameBuilder(synthetic.calibration(cfg.rig), cfg, device="cpu"), cfg)
    log = chip_smoke.hold_partitions(slam)
    for raw in raws:
        slam.process(raw)
    slam.flush()
    check_grown_partitions(slam, log, cfg)

    ref = JPbMapGraphSLAM(reference_builder(cfg))
    hold_reference(ref)
    with pytest.raises(ValueError, match="broadcast"):
        for raw in raws:
            ref.process(RawRigFrame(rgb=raw.rgb, depth_mm=raw.depth_mm))
        ref.flush()
