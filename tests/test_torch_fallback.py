"""The tracker's seed chain past its first seed, and the rest of the
tracker's surface, in both packages at a reduced size
(`synthetic.config(subsample=4, pyramid_levels=3)`, the reference's
stitch maps): a forced fallback that runs every seed and the yaw-grid
rescue, `make_state_from_sphere`, the `DenseAligner.intrinsics` repair,
`fetch` and `StageTimer`."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rgbd360_tpu.registration import dense as JD
from rgbd360_tpu.slam.odometry import FrameToFrameOdometry as JaxOdometry
from rgbd360_tpu_torch import convert, synthetic
from rgbd360_tpu_torch.core.frame import FrameBuilder, RigFrame
from rgbd360_tpu_torch.registration import dense as TD
from rgbd360_tpu_torch.slam import odometry as TO
from rgbd360_tpu_torch.utils.trace import StageTimer

from test_torch_segmentation import assert_plane_sets_match, one_torch_thread  # noqa: F401

from _reference import reference_builder

SUB, LEVELS = 4, 3
# The same pyramids on both sides (reference maps): the coarse rescue's
# refined poses agree within 1e-5 (tests/test_torch_batch.py), and so do the
# full solves from them.
POSE_ATOL = 1e-5


def _config(**kf):
    cfg = synthetic.config(SUB, LEVELS)
    return cfg.replace(kf=dataclasses.replace(cfg.kf, **kf)) if kf else cfg


def _builder(cfg, jb=None) -> FrameBuilder:
    """The port's builder on the reference builder `jb`'s stitch maps."""
    cal = synthetic.calibration(cfg.rig)
    builder = FrameBuilder(cal, cfg, device="cpu")
    params = (jb or reference_builder(cfg))._params
    maps = {k: np.asarray(params[k]) for k in ("sensor", "u", "v", "scale", "valid")}
    builder.load_state_dict(
        convert.stitch_maps_state_dict(maps, cfg.dense.pyramid_levels), strict=False)
    return builder


def _record_seeds(tracker, to_np) -> list:
    """The seeds the tracker's chain passes to `aligner.align`, in order."""
    seeds, align = [], tracker.aligner.align

    def record(src, trg, init_pose=None, *args, **kw):
        seeds.append(np.array(to_np(init_pose), np.float32))
        return align(src, trg, init_pose, *args, **kw)

    tracker.aligner.align = record
    return seeds


def test_forced_fallback_reaches_the_yaw_rescue():
    """`fallback_error = 0` accepts no solve: `align_with_fallback` tries
    the chain's seeds (a motion seed, a 0.1 m walk seed, identity already
    tried), then the two best novel hypotheses of the 16-heading yaw grid,
    and returns the best good result.  Both packages, on the same
    pyramids, try the same seeds and return the same pose."""
    cfg = _config(fallback_error=0.0)
    jb = reference_builder(cfg)
    tb = _builder(cfg, jb)
    pyrs = [tb.build_with_pyramid(RigFrame(torch.from_numpy(r), torch.from_numpy(d)))[1]
            for r, d in synthetic.captures(2, SUB)]
    jpyrs = [JD.FramePyramid(**{f: tuple(jnp.asarray(x.numpy()) for x in getattr(p, f))
                                for f in TD._CHANNELS}) for p in pyrs]
    chain = [np.eye(4), synthetic.walk_seeds([0.1])[0]]
    jt, tt = JaxOdometry(jb), TO.FrameToFrameOdometry(tb)
    ref_seeds = _record_seeds(jt, np.asarray)
    got_seeds = _record_seeds(tt, lambda t: t.cpu().numpy())
    ref = jax.device_get(jt.align_with_fallback(jpyrs[1], jpyrs[0], chain))
    got = tt.align_with_fallback(pyrs[1], pyrs[0], chain)
    assert len(ref_seeds) == 4 and len(got_seeds) == 4
    np.testing.assert_allclose(np.stack(got_seeds), np.stack(ref_seeds), atol=POSE_ATOL)
    # the rescue's hypotheses are headings: rotations far from the chain's
    yaw = np.arctan2(np.stack(got_seeds)[2:, 2, 1], np.stack(got_seeds)[2:, 1, 1])
    assert np.abs(yaw).max() > 0.3, yaw
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=POSE_ATOL)
    assert float(got.error) == pytest.approx(float(ref.error), rel=1e-4)
    assert abs(float(got.pose[0, 3]) - 0.09) < 0.01 and not bool(got.ill_posed)


def test_dense_aligner_keeps_its_intrinsics():
    """The tracker reads `aligner.intrinsics` to choose the spherical yaw
    rescue; the port's aligner used to lack the attribute.  A pinhole
    aligner (`intrinsics=K`, which raised before the pinhole path was
    ported) keeps the reference's K, as float32."""
    aligner = TD.DenseAligner(_config().dense)
    assert aligner.intrinsics is None
    k = synthetic.calibration(_config().rig).k
    from rgbd360_tpu import config as jconfig

    ref = JD.DenseAligner(convert.config_to_reference(_config().dense, jconfig), intrinsics=k)
    got = TD.DenseAligner(_config().dense, intrinsics=k)
    assert got.intrinsics.dtype == torch.float32
    np.testing.assert_array_equal(got.intrinsics.numpy(), np.asarray(ref.intrinsics, np.float32))


def test_make_state_from_sphere_matches_reference():
    """Tracking state from a bare sphere (the stereo-style input): the
    pyramid and the sphere's own plane set, from the reference's sphere.
    At a 160x960 sphere: the tracker segments it at a quarter of that, and
    the tests' usual 80x480 sphere leaves too few points for any plane."""
    cfg = synthetic.config(2, LEVELS)
    jb = reference_builder(cfg)
    tb = _builder(cfg, jb)
    rgb, d = synthetic.captures(1, 2)[0]
    sphere = tb.build(RigFrame(torch.from_numpy(rgb), torch.from_numpy(d)))
    gray, depth, srgb = sphere.sphere_gray, sphere.sphere_depth, sphere.sphere_rgb
    ref = jax.device_get(JaxOdometry(jb).make_state_from_sphere(
        *(jnp.asarray(a.numpy()) for a in (gray, depth, srgb))))
    got = TO.FrameToFrameOdometry(tb).make_state_from_sphere(gray, depth, srgb)
    assert got.sphere.cloud_xyz.shape == (1, 1, 1, 3)
    for f in ("gray", "depth", "gray_gx", "depth_gy"):
        for lvl in range(LEVELS):
            np.testing.assert_allclose(getattr(got.pyramid, f)[lvl].numpy(),
                                       np.asarray(getattr(ref.pyramid, f)[lvl]),
                                       rtol=1e-5, atol=1e-5, err_msg=f"{f}[{lvl}]")
    as_np = lambda p: {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}
    assert_plane_sets_match(as_np(got.planes), as_np(ref.planes))
    assert int(got.planes.valid.sum()) >= 1


def test_fetch_is_one_host_copy_of_a_result():
    """Every tensor field comes back with its dtype, shape and value, from
    one float64 buffer (exact for f32, int32/int64 and bool); a host field
    (the GN loop's `sweeps` and `replays`) comes back as it was."""
    res = TD.AlignResult(
        pose=torch.randn(4, 4), hessian=torch.randn(6, 6), error=torch.tensor(0.25),
        av_photo_residual=torch.tensor(1.5), av_depth_residual=torch.tensor(2.5),
        sso=torch.tensor(0.75), iters=torch.tensor([3, 0, 10]), ill_posed=torch.tensor(True),
        sweeps=17, replays=16,
    )
    out = TO.fetch((res, [torch.arange(5, dtype=torch.int32)], "tag"))
    got, (ints,), tag = out
    assert tag == "tag" and isinstance(got, TD.AlignResult)
    assert (got.sweeps, got.replays) == (17, 16)
    for f in dataclasses.fields(res):
        a, b = getattr(got, f.name), getattr(res, f.name)
        if f.name in ("sweeps", "replays"):
            continue
        assert a.dtype == b.dtype and a.device.type == "cpu" and torch.equal(a, b), f.name
    assert ints.dtype == torch.int32 and ints.tolist() == [0, 1, 2, 3, 4]


def test_stage_timer_regions():
    """Off, a region only counts; enabled, each region is a span with its
    parent, the frame index and its attributes (`annotate` sets them on the
    innermost open span, `tally` adds to every open span), `report` gives
    host ms by name with self time, `take_spans` hands the spans over and
    `reset` clears counts and spans."""
    timer = StageTimer()
    with timer.region("segment"):
        pass
    assert timer.counts == {"segment": 1} and not timer.spans
    timer.enable()
    timer.frame = 3
    with timer.region("build", n=1):
        with timer.region("segment"):
            timer.tally(sweeps=2)
        timer.annotate(done=True)
    timer.counts["kf_pyramid.hit"] += 1
    assert timer.counts == {"segment": 2, "build": 1, "kf_pyramid.hit": 1}
    build, seg = timer.spans
    assert (build.name, build.parent, seg.name, seg.parent) == ("build", -1, "segment", 0)
    assert build.frame == seg.frame == 3
    assert build.attrs == {"n": 1, "sweeps": 2, "done": True} and seg.attrs == {"sweeps": 2}
    assert build.start_ns <= seg.start_ns <= seg.end_ns <= build.end_ns
    report = timer.report()
    assert "self ms" in report and "segment" in report and "kf_pyramid.hit 1" in report
    assert timer.take_spans() == [build, seg] and not timer.spans
    timer.disable()
    with timer.region("build"):
        pass
    assert not timer.spans and timer.counts["build"] == 2
    timer.reset()
    assert not timer.counts and not timer.spans
