"""The batched tracking path in both packages, at a reduced size
(`synthetic.config(subsample=4, pyramid_levels=3)`: 8x60x80 rig, 80x480
sphere) with the batch bench's salient budget, which thins every level
there: the batch stitch and build, the batch pyramid, the batched
`_align_impl` (the reference vmaps it), `batch_align_targets`,
`coarse_errors` and `coarse_align`.  The port's builder is loaded with the
reference's stitch maps (`convert.stitch_maps_state_dict`), so the two
packages stitch with the same maps; tests/test_torch_ops.py covers the maps."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rgbd360_tpu.ops import se3 as jse3
from rgbd360_tpu.ops import stitch as jst
from rgbd360_tpu.registration import dense as JD
from rgbd360_tpu_torch import convert, synthetic
from rgbd360_tpu_torch.core.frame import FrameBuilder
from rgbd360_tpu_torch.ops import stitch as tst
from rgbd360_tpu_torch.registration import dense as TD

from _reference import reference_builder

SUB, LEVELS = 4, 3
FIELDS = ("gray", "depth", "gray_gx", "gray_gy", "depth_gx", "depth_gy")
# The reference's jitted build fuses multiply-adds (tests/test_torch_ops.py).
DEPTH_RTOL, GRAY_ATOL = 4.8e-7, 2.4e-7
# tests/test_torch_pyramid.py: K2 and the banded matmuls sum in other orders.
LEVEL_RTOL = 1e-6
# The solves on the same pyramids: measured on the CPU within 1e-7 m of the
# reference (ulps of the sums and the trig, through a few GN steps).
POSE_ATOL = 1e-5
# The batched solve against the port's own unbatched one: the same steps
# with the reductions over other shapes, measured within 1e-7 m.
BATCH_ATOL = 1e-6


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _to_torch(pyr) -> TD.FramePyramid:
    return TD.FramePyramid(**{f: tuple(_t(x) for x in getattr(pyr, f)) for f in FIELDS})


@pytest.fixture(scope="module")
def setup():
    """Both builders on the reference's maps, the aligners, the 5 raw
    captures, and the reference's keyframe and batch pyramids."""
    cfg = synthetic.config(SUB, LEVELS)
    cal = synthetic.calibration(cfg.rig)
    jb = reference_builder(cfg)
    tb = FrameBuilder(cal, cfg, device="cpu")
    maps = {k: np.asarray(jb._params[k]) for k in ("sensor", "u", "v", "scale", "valid")}
    tb.load_state_dict(convert.stitch_maps_state_dict(maps, LEVELS), strict=False)
    dcfg = dataclasses.replace(cfg.dense, salient_pixels=synthetic.BATCH_SALIENT_PIXELS)
    jdcfg = dataclasses.replace(jb.config.dense, salient_pixels=synthetic.BATCH_SALIENT_PIXELS)
    caps = synthetic.captures(5, SUB)
    rgbs = np.stack([c[0] for c in caps[1:]])
    depths = np.stack([c[1] for c in caps[1:]])
    from rgbd360_tpu.core.frame import RigFrame

    pyrs = [
        jb.build_with_pyramid(RigFrame(jnp.asarray(r), jnp.asarray(d)))[1] for r, d in caps
    ]
    seam = JD.seam_masks_per_level(jst.seam_mask_from_maps(jb.maps, 1), LEVELS)
    sg, sd = jb.build_gray_depth_batch(jnp.asarray(rgbs), jnp.asarray(depths))
    pyr_b = jax.jit(lambda g, d: JD.build_frame_pyramid_batch(g, d, jb.config.dense, seam))(sg, sd)
    return dict(cfg=cfg, jb=jb, tb=tb, dcfg=dcfg, jdcfg=jdcfg, caps=caps, rgbs=rgbs, depths=depths,
                pyrs=pyrs, seam=seam, sg=sg, sd=sd, pyr_b=pyr_b)


def test_stitch_maps_state_carries_the_seam_masks(setup):
    for lvl in range(LEVELS):
        np.testing.assert_array_equal(
            setup["tb"].seam_levels[lvl].numpy(), np.asarray(setup["seam"][lvl])
        )


def test_stitch_batches_bit_equal(setup, rng):
    """`stitch_batch` and `stitch_gray_depth_batch` on the same maps: one
    gather for the batch, bit for bit, and each frame equals `stitch`."""
    jb, tb = setup["jb"], setup["tb"]
    rgbs = setup["rgbs"][:3]
    depth = (setup["depths"][:3].astype(np.float32) * np.float32(0.001)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.05] = 0.0
    gray = rng.uniform(0.0, 1.0, depth.shape).astype(np.float32)
    for jf, tf, a in (
        (jst.stitch_batch, tst.stitch_batch, rgbs),
        (jst.stitch_gray_depth_batch, tst.stitch_gray_depth_batch, gray),
    ):
        ref = jf(jb.maps, jnp.asarray(a), jnp.asarray(depth))
        got = tf(tb.maps, _t(a), _t(depth))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    srgb, sdep = tst.stitch(tb.maps, _t(rgbs[1]), _t(depth[1]))
    brgb, bdep = tst.stitch_batch(tb.maps, _t(rgbs), _t(depth))
    assert torch.equal(srgb, brgb[1]) and torch.equal(sdep, bdep[1])


def test_build_gray_depth_batch_matches_reference(setup):
    """Gray per sensor from the raw capture, then one stitch: bit-equal to
    the reference's un-jitted build, and within the jitted build's fused
    multiply-adds."""
    jb, tb = setup["jb"], setup["tb"]
    rgbs, depths = jnp.asarray(setup["rgbs"]), jnp.asarray(setup["depths"])
    g, d = tb.build_gray_depth_batch(_t(setup["rgbs"]), _t(setup["depths"]))
    g_ref, d_ref = jb._build_gray_depth_batch_impl(jb._params, rgbs, depths)
    np.testing.assert_array_equal(g.numpy(), np.asarray(g_ref))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(setup["sd"]), rtol=DEPTH_RTOL, atol=0)
    np.testing.assert_allclose(g.numpy(), np.asarray(setup["sg"]), rtol=0, atol=GRAY_ATOL)
    with pytest.raises(ValueError, match="builder on"):
        tb.build_gray_depth_batch(torch.zeros(1, device="meta"), torch.zeros(1, device="meta"))


def test_build_gray_depth_batch_on_own_maps(setup):
    """The port's own stitch maps differ from the reference's on the
    sensor-tie columns and by ulps in `scale` (tests/test_torch_ops.py);
    everywhere else the batch build is bit-equal to the reference's
    un-jitted one."""
    jb = setup["jb"]
    own = FrameBuilder(synthetic.calibration(setup["cfg"].rig), setup["cfg"], device="cpu")
    g, d = own.build_gray_depth_batch(_t(setup["rgbs"]), _t(setup["depths"]))
    g_ref, d_ref = jb._build_gray_depth_batch_impl(
        jb._params, jnp.asarray(setup["rgbs"]), jnp.asarray(setup["depths"])
    )
    same = np.ones(g.shape[1:], bool)
    for k in ("sensor", "u", "v", "scale", "valid"):
        same &= getattr(own, k).numpy() == np.asarray(jb._params[k])
    assert same.mean() > 0.9, same.mean()
    np.testing.assert_array_equal(g.numpy()[:, same], np.asarray(g_ref)[:, same])
    np.testing.assert_array_equal(d.numpy()[:, same], np.asarray(d_ref)[:, same])


def test_build_frame_pyramid_batch_matches_reference(setup):
    """From the reference's spheres: levels within LEVEL_RTOL, gradients
    within 8x the level's largest input difference (the bound of
    tests/test_torch_pyramid.py), and each frame bit-equal to the port's
    unbatched build."""
    tb, pyr_b = setup["tb"], setup["pyr_b"]
    sg, sd = _t(setup["sg"]), _t(setup["sd"])
    got = TD.build_frame_pyramid_batch(sg, sd, setup["cfg"].dense, tb.seam_levels)
    for lvl in range(LEVELS):
        for img, grads in (("gray", ("gray_gx", "gray_gy")), ("depth", ("depth_gx", "depth_gy"))):
            ref = np.asarray(getattr(pyr_b, img)[lvl])
            g = getattr(got, img)[lvl].numpy()
            np.testing.assert_allclose(g, ref, rtol=LEVEL_RTOL, atol=1e-7)
            delta = np.abs(g - ref).max()
            for name in grads:
                err = np.abs(getattr(got, name)[lvl].numpy() - np.asarray(getattr(pyr_b, name)[lvl]))
                assert err.max() <= 8 * delta, (name, lvl, err.max(), delta)
    for b, one in enumerate(TD.unstack_pyramid(got)):
        ref = TD.build_frame_pyramid(sg[b], sd[b], setup["cfg"].dense, tb.seam_levels)
        for f in FIELDS:
            for lvl in range(LEVELS):
                assert torch.equal(getattr(one, f)[lvl], getattr(ref, f)[lvl]), (b, f, lvl)


@pytest.fixture(scope="module")
def batch_solve(setup):
    """The reference's `jax.vmap(aligner._align_impl)` of the batch against
    keyframe 0 (the batch bench's step), and the port's batched solve on the
    same pyramids, seeded one step short of each offset."""
    aligner = JD.DenseAligner(setup["jdcfg"])
    seeds = synthetic.walk_seeds(0.1 * np.arange(4))
    ref = jax.device_get(jax.jit(jax.vmap(
        lambda p, s: aligner._align_impl(p, setup["pyrs"][0], s, JD.PHOTO_DEPTH)
    ))(setup["pyr_b"], jnp.asarray(seeds)))
    src, trg = _to_torch(setup["pyr_b"]), _to_torch(setup["pyrs"][0])
    got = TD.DenseAligner(setup["dcfg"]).align(src, trg, _t(seeds))
    return ref, got, src, trg, seeds


def test_batched_align_matches_vmapped_reference(batch_solve):
    ref, got, _, _, _ = batch_solve
    assert got.pose.shape == (4, 4, 4) and got.iters.shape == (4, LEVELS)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=POSE_ATOL)
    np.testing.assert_allclose(got.error.numpy(), np.asarray(ref.error), rtol=1e-4)
    np.testing.assert_allclose(got.sso.numpy(), np.asarray(ref.sso), atol=1e-6)
    np.testing.assert_allclose(got.av_depth_residual.numpy(), np.asarray(ref.av_depth_residual), rtol=1e-4)
    h_ref = np.asarray(ref.hessian)
    assert np.abs(got.hessian.numpy() - h_ref).max() <= 1e-4 * np.abs(h_ref).max()
    np.testing.assert_array_equal(got.ill_posed.numpy(), np.asarray(ref.ill_posed))
    # the batch runs levels where its elements take different step counts
    assert len({tuple(r) for r in got.iters.tolist()}) > 1


def test_batched_align_matches_unbatched(setup, batch_solve):
    """Each element of the batched solve is its own unbatched `align`: a
    finished element keeps its state while the others step on."""
    _, got, src, trg, seeds = batch_solve
    aligner = TD.DenseAligner(setup["dcfg"])
    for b, one_src in enumerate(TD.unstack_pyramid(src)):
        one = aligner.align(one_src, trg, _t(seeds[b]))
        assert one.pose.shape == (4, 4)
        np.testing.assert_array_equal(one.iters.numpy(), got.iters[b].numpy())
        np.testing.assert_allclose(one.pose.numpy(), got.pose[b].numpy(), atol=BATCH_ATOL)
        np.testing.assert_allclose(float(one.error), float(got.error[b]), rtol=1e-5)


@pytest.mark.parametrize("n", [3, 1])
def test_batch_align_targets_matches_reference(setup, n):
    """Frame 4 against the first n frames (3: odd, with no padding; 1),
    each seeded one step short of its offset."""
    pyrs = setup["pyrs"]
    seeds = list(synthetic.walk_seeds(0.1 * np.arange(3, 3 - n, -1)))
    ref = JD.batch_align_targets(JD.DenseAligner(setup["jdcfg"]), pyrs[4], pyrs[:n], seeds)
    aligner = TD.DenseAligner(setup["dcfg"])
    tp = [_to_torch(p) for p in pyrs]
    got = TD.batch_align_targets(aligner, tp[4], tp[:n], seeds)
    assert got.pose.shape == (n, 4, 4) and got.pose.device.type == "cpu"
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=POSE_ATOL)
    np.testing.assert_allclose(got.error.numpy(), np.asarray(ref.error), rtol=1e-4)
    # the dispatch half stays on the source's device; one element is `align`
    disp = TD.batch_align_targets_dispatch(aligner, tp[4], tp[:n], seeds)
    assert torch.equal(disp.pose, got.pose)
    one = aligner.align(tp[4], tp[0], _t(seeds[0]))
    np.testing.assert_allclose(one.pose.numpy(), got.pose[0].numpy(), atol=BATCH_ATOL)


def test_batch_align_targets_refusals(setup):
    tp = _to_torch(setup["pyrs"][0])
    aligner = TD.DenseAligner(setup["dcfg"])
    with pytest.raises(ValueError, match="at least one"):
        TD.batch_align_targets(aligner, tp, [], [])
    with pytest.raises(ValueError, match="seeds"):
        TD.batch_align_targets(aligner, tp, [tp, tp], [np.eye(4)])


def test_coarse_errors_and_coarse_align_match_reference(setup):
    """Frame 1 against frame 0 over 8 yaw hypotheses at the coarsest level
    (the tracker rescue): the static errors, and the refined poses and
    errors after 10 unguarded GN steps."""
    pyrs = setup["pyrs"]
    ja = JD.DenseAligner(setup["jdcfg"])
    ta = TD.DenseAligner(setup["dcfg"])
    src, trg = _to_torch(pyrs[1]), _to_torch(pyrs[0])
    cands = jse3.yaw_grid(8).astype(np.float32)
    np.testing.assert_allclose(
        ta.coarse_errors(src, trg, cands).numpy(),
        np.asarray(ja.coarse_errors(pyrs[1], pyrs[0], jnp.asarray(cands))), rtol=1e-4,
    )
    poses_j, errs_j = ja.coarse_align(pyrs[1], pyrs[0], jnp.asarray(cands))
    poses_t, errs_t = ta.coarse_align(src, trg, _t(cands))
    np.testing.assert_allclose(poses_t.numpy(), np.asarray(poses_j), atol=POSE_ATOL)
    np.testing.assert_allclose(errs_t.numpy(), np.asarray(errs_j), rtol=1e-4)
    assert int(np.argmin(errs_t.numpy())) == int(np.argmin(np.asarray(errs_j)))
