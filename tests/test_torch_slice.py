"""The whole slice in both packages: raw synthetic rig captures ->
`FrameBuilder.build_with_pyramid` -> `DenseAligner.align`, at a reduced
size (8x48x64 rig, 64x384 sphere, 3 levels); and the twin of
`__graft_entry__.entry()`'s forward step."""

import sys
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

from rgbd360_tpu.config import DenseRegConfig
from rgbd360_tpu.registration import dense as JD
from rgbd360_tpu_torch import synthetic
from rgbd360_tpu_torch.core.frame import FrameBuilder
from rgbd360_tpu_torch.core.frame import RigFrame
from rgbd360_tpu_torch.registration import dense as TD

from __graft_entry__ import _synthetic_pair

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import chip_smoke  # noqa: E402
import torch_port_golden  # noqa: E402


def test_smoke_slice_matches_golden_script():
    """`chip_smoke.track_pairs` (the port, on the CPU) and the golden
    script's reference run, on the same synthetic inputs at the reduced
    size: one pair.  The two builders' stitch maps differ on the sensor-tie
    columns (~0.2% of the pixels at this width), which moved the solution
    by 1.0e-4 m and 1.4e-5 rad when measured; the bounds leave a 5x
    margin."""
    n, sub, levels = 2, 5, 3
    ref = torch_port_golden.track_pairs_jax(n, sub, levels)
    cfg = synthetic.config(sub, levels)
    builder = FrameBuilder(synthetic.calibration(cfg.rig), cfg)
    frames = [
        RigFrame(torch.from_numpy(rgb), torch.from_numpy(d))
        for rgb, d in synthetic.captures(n, sub)
    ]
    got = chip_smoke.track_pairs(builder, TD.DenseAligner(cfg.dense), frames)
    dt, dr = chip_smoke._pose_gaps(got["poses"], ref["poses"])
    assert dt < 5e-4 and dr < 2e-4, (dt, dr)
    np.testing.assert_array_equal(got["iters"], ref["iters"])
    np.testing.assert_array_equal(got["ill_posed"], ref["ill_posed"])
    np.testing.assert_allclose(got["errors"], ref["errors"], rtol=2e-3)
    np.testing.assert_allclose(got["sso"], ref["sso"], atol=2e-3)
    h_ref = ref["hessians"]
    assert np.abs(got["hessians"] - h_ref).max() <= 1e-2 * np.abs(h_ref).max()


def test_entry_forward_twin():
    """`entry()`'s fwd (pyramids of both frames with uniform seam masks,
    then the 3-level PHOTO_DEPTH alignment) on `_synthetic_pair` at 64x384
    in both packages: pose to 1e-4, Hessian to 1e-3 of its norm, error to
    1e-3 relative (the per-sweep differences of test_torch_dense, through
    the whole coarse-to-fine solve)."""
    cfg = DenseRegConfig(pyramid_levels=3)
    g1, d1, g2, d2 = _synthetic_pair(64, 384)

    def fwd(g1, d1, g2, d2, init):
        p1 = JD.build_frame_pyramid(g1, d1, cfg)
        p2 = JD.build_frame_pyramid(g2, d2, cfg)
        res = JD.DenseAligner(cfg)._align_impl(p1, p2, init, JD.PHOTO_DEPTH)
        return res.pose, res.hessian, res.error, res.iters

    pj, hj, ej, ij = jax.device_get(jax.jit(fwd)(g1, d1, g2, d2, jnp.eye(4)))

    t = [torch.tensor(np.asarray(a)) for a in (g1, d1, g2, d2)]
    p1 = TD.build_frame_pyramid(t[0], t[1], cfg)
    p2 = TD.build_frame_pyramid(t[2], t[3], cfg)
    res = TD.DenseAligner(cfg).align(p1, p2, torch.eye(4), TD.PHOTO_DEPTH)
    np.testing.assert_allclose(res.pose.numpy(), pj, atol=1e-4)
    assert np.abs(res.hessian.numpy() - hj).max() <= 1e-3 * np.abs(hj).max()
    np.testing.assert_allclose(float(res.error), float(ej), rtol=1e-3)
    np.testing.assert_array_equal(res.iters.numpy(), ij)
    assert not bool(res.ill_posed)
