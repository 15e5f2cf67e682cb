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
from rgbd360_tpu_torch import convert, synthetic
from rgbd360_tpu_torch.core.frame import FrameBuilder
from rgbd360_tpu_torch.core.frame import RigFrame
from rgbd360_tpu_torch.registration import dense as TD

from __graft_entry__ import _synthetic_pair

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import chip_smoke  # noqa: E402
import torch_port_golden  # noqa: E402
from _reference import reference_builder  # noqa: E402


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
    builder = FrameBuilder(synthetic.calibration(cfg.rig), cfg, device="cpu")
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


def test_smoke_batch_matches_golden_script():
    """`chip_smoke`'s batch phases (the port, on the CPU) and the golden
    script's reference run, on the same synthetic inputs at a reduced size
    (8x60x80 rig, 80x480 sphere, 3 levels) and the same stitch maps: every
    golden key the port reproduces, with the golden's shapes, and the
    golden's gates pass.  Measured within 1.6e-7 m of the reference."""
    sub, levels = 4, 3
    ref = torch_port_golden.batch_jax(sub, levels, jittered=False)
    cfg = synthetic.config(sub, levels)
    cal = synthetic.calibration(cfg.rig)
    builder = FrameBuilder(cal, cfg, device="cpu")
    params = reference_builder(cfg)._params
    maps = {k: np.asarray(params[k]) for k in ("sensor", "u", "v", "scale", "valid")}
    builder.load_state_dict(convert.stitch_maps_state_dict(maps, levels), strict=False)
    aligner = TD.DenseAligner(chip_smoke.batch_dense_config(cfg))
    frames = [
        RigFrame(torch.from_numpy(rgb), torch.from_numpy(d))
        for rgb, d in synthetic.captures(chip_smoke.BATCH_FRAMES, sub)
    ]
    _, res = chip_smoke.track_batch(builder, aligner, *chip_smoke.batch_inputs(builder, frames))
    got = chip_smoke._result_np(res, "batch")
    targets, _ = chip_smoke.align_targets(builder, aligner, frames)
    got.update(targets)
    for k, v in got.items():
        assert v.shape == ref[k].shape, (k, v.shape, ref[k].shape)
    assert {k for k in ref if "branch" not in k} - set(got) == {"coarse_candidates"}
    for prefix in ("batch", "targets"):
        np.testing.assert_array_equal(got[f"{prefix}_iters"], ref[f"{prefix}_iters"])
        dt, dr = chip_smoke._pose_gaps(got[f"{prefix}_poses"], ref[f"{prefix}_poses"])
        assert dt < 1e-5 and dr < 1e-5, (prefix, dt, dr)
        matched = chip_smoke._gate_branches(
            prefix, got[f"{prefix}_poses"], ref[f"{prefix}_branch_poses"]
        )
        np.testing.assert_array_equal(matched, 0)
    chip_smoke.check_coarse(got, ref)


def test_entry_forward_twin():
    """`entry()`'s fwd (pyramids of both frames with uniform seam masks,
    then the 3-level PHOTO_DEPTH alignment) on `_synthetic_pair` at 64x384
    in both packages (the port's is `rgbd360_tpu_torch.entry.entry`): pose
    to 1e-4, Hessian to 1e-3 of its norm, error to 1e-3 relative (the
    per-sweep differences of test_torch_dense, through the whole
    coarse-to-fine solve)."""
    from rgbd360_tpu_torch.entry import entry

    cfg = DenseRegConfig(pyramid_levels=3)
    g1, d1, g2, d2 = _synthetic_pair(64, 384)

    def fwd(g1, d1, g2, d2, init):
        p1 = JD.build_frame_pyramid(g1, d1, cfg)
        p2 = JD.build_frame_pyramid(g2, d2, cfg)
        res = JD.DenseAligner(cfg)._align_impl(p1, p2, init, JD.PHOTO_DEPTH)
        return res.pose, res.hessian, res.error, res.iters

    pj, hj, ej, ij = jax.device_get(jax.jit(fwd)(g1, d1, g2, d2, jnp.eye(4)))

    fn, args = entry(64, 384, device="cpu")
    for a, b in zip(args[:4], (g1, d1, g2, d2)):  # the port's copy of the inputs
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    res = fn(*args)
    np.testing.assert_allclose(res.pose.numpy(), pj, atol=1e-4)
    assert np.abs(res.hessian.numpy() - hj).max() <= 1e-3 * np.abs(hj).max()
    np.testing.assert_allclose(float(res.error), float(ej), rtol=1e-3)
    np.testing.assert_array_equal(res.iters.numpy(), ij)
    assert not bool(res.ill_posed)
