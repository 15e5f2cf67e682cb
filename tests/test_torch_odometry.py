"""`FrameToFrameOdometry` in both packages over 4 synthetic frames at a
reduced size (`synthetic.config(subsample=4, pyramid_levels=3)`): the
trajectory, the seed chain, the PbMap results and the plane sets, through
the very functions `chip_smoke.py`'s phase g runs on the card
(`track_odometry`, `check_odometry`) and the golden tool's reference run
(`tools/torch_port_golden.odometry_jax`)."""

import sys
from pathlib import Path

import numpy as np
import pytest

from rgbd360_tpu_torch import convert, synthetic
from rgbd360_tpu_torch.core.frame import FrameBuilder

from test_torch_segmentation import one_torch_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import chip_smoke  # noqa: E402
import torch_port_golden  # noqa: E402
from _reference import reference_builder  # noqa: E402

N, SUB, LEVELS = 4, 4, 3
# On the reference's stitch maps the two packages solve the same pyramids:
# measured 1.5e-8 m apart (ulps through a few GN steps).
SAME_MAPS_TOL = 1e-6


@pytest.fixture(scope="module")
def reference():
    return torch_port_golden.odometry_jax(N, SUB, LEVELS)


@pytest.fixture(scope="module")
def raws():
    return chip_smoke.synthetic_raws(N, SUB)


def _builder(reference_maps: bool) -> FrameBuilder:
    cfg = synthetic.config(SUB, LEVELS)
    cal = synthetic.calibration(cfg.rig)
    builder = FrameBuilder(cal, cfg, device="cpu")
    if reference_maps:
        params = reference_builder(cfg)._params
        maps = {k: np.asarray(params[k]) for k in ("sensor", "u", "v", "scale", "valid")}
        builder.load_state_dict(convert.stitch_maps_state_dict(maps, LEVELS), strict=False)
    return builder


def test_odometry_passes_phase_g_gates(reference, raws):
    """The port on its own stitch maps, held to phase g's gates: every frame
    tracked at 0.1 +- 0.02 m, rel within 5e-4 m / 2e-4 rad, the same seeds,
    PbMap success and pose, plane counts and matched planes."""
    got = chip_smoke.track_odometry(_builder(False), raws)
    assert set(reference) <= set(got)
    for k, v in reference.items():
        assert got[k].shape == v.shape, (k, got[k].shape, v.shape)
    gaps = chip_smoke.check_odometry(got, reference)
    np.testing.assert_array_equal(got["pb_matches"], reference["pb_matches"])
    assert gaps["pb_m"] < 1e-4 and gaps["plane_area"] < 1e-4, gaps
    assert got["process_ms"].shape == (N,)


def test_odometry_on_reference_maps(reference, raws):
    """On the reference's stitch maps: the trajectory, the residual
    statistics and the seeds to SAME_MAPS_TOL; the PbMap pairs equal."""
    got = chip_smoke.track_odometry(_builder(True), raws)
    np.testing.assert_allclose(got["rel"], reference["rel"], atol=SAME_MAPS_TOL)
    np.testing.assert_allclose(got["seeds"], reference["seeds"], atol=SAME_MAPS_TOL)
    np.testing.assert_allclose(got["av_depth_residual"], reference["av_depth_residual"], rtol=1e-5)
    np.testing.assert_allclose(got["sso"], reference["sso"], rtol=1e-6)
    np.testing.assert_array_equal(got["tracked"], reference["tracked"])
    np.testing.assert_array_equal(got["pb_success"], reference["pb_success"])
    np.testing.assert_allclose(got["pb_pose"], reference["pb_pose"], atol=1e-5)
