"""Parity of the port's dense aligner with the reference: the GN sweep
(`_hess_grad_packed`), one GN level, the salient selection and the whole
salient + dense-polish alignment.  Both packages get the reference's own
pyramids, so only the aligner differs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rgbd360_tpu.config import DenseRegConfig
from rgbd360_tpu.ops import se3 as jse3
from rgbd360_tpu.registration import dense as JD
from rgbd360_tpu_torch.registration import dense as TD

from __graft_entry__ import _synthetic_pair

CFG = DenseRegConfig(pyramid_levels=3)
FIELDS = ("gray", "depth", "gray_gx", "gray_gy", "depth_gx", "depth_gy")


def _to_torch(pyr) -> TD.FramePyramid:
    return TD.FramePyramid(
        **{f: tuple(torch.tensor(np.asarray(x)) for x in getattr(pyr, f)) for f in FIELDS}
    )


@pytest.fixture(scope="module")
def pair():
    """Reference pyramids (64x384, 3 levels) of the flagship synthetic pair,
    in both packages' types, and a perturbed pose near the solution."""
    g1, d1, g2, d2 = _synthetic_pair(64, 384)
    build = jax.jit(lambda g, d: JD.build_frame_pyramid(g, d, CFG))
    src = build(g2, d2)
    trg = build(g1, d1)
    pose = np.asarray(jse3.se3_exp(jnp.array([0.01, -0.02, 0.015, 0.004, 0.03, -0.01])))
    return src, trg, _to_torch(src), _to_torch(trg), pose


@pytest.mark.parametrize("method", [JD.PHOTO_CONSISTENCY, JD.DEPTH_CONSISTENCY, JD.PHOTO_DEPTH])
@pytest.mark.parametrize("lvl", [0, 2])
def test_hess_grad_packed_parity(pair, method, lvl):
    """One GN sweep at a fixed pose.  The warp rounds continuous pixel
    coordinates that differ by ulps, so a pixel or two may sample another
    target pixel; with the sums' reordering that stays within 1e-3 of the
    Hessian's and gradient's norms and 1e-4 relative on the error."""
    src, trg, tsrc, ttrg, pose = pair
    jl = {f: getattr(src, f)[lvl] for f in FIELDS}
    jt = {f: getattr(trg, f)[lvl] for f in FIELDS}
    pts, valid = JD._src_points(jl["depth"], CFG)
    hj, gj, sj = jax.jit(JD._hess_grad_packed, static_argnums=(5, 6))(
        jl["gray"], pts, valid, JD._pack_target(jt), jnp.asarray(pose), CFG, method
    )
    tl = {f: getattr(tsrc, f)[lvl] for f in FIELDS}
    tt = {f: getattr(ttrg, f)[lvl] for f in FIELDS}
    pts_t, valid_t = TD._src_points(tl["depth"], CFG)
    ht, gt, st = TD._hess_grad_packed(
        tl["gray"], pts_t, valid_t, TD._pack_target(tt), torch.tensor(pose), CFG, method
    )
    hj, gj = np.asarray(hj), np.asarray(gj)
    assert np.abs(ht.numpy() - hj).max() <= 1e-3 * np.abs(hj).max()
    assert np.abs(gt.numpy() - gj).max() <= 1e-3 * np.abs(gj).max()
    np.testing.assert_allclose(float(st["mean_err"]), float(sj["mean_err"]), rtol=1e-4)
    for k in sj:
        if k.endswith("_n") or k == "visible":
            assert abs(int(st[k]) - int(sj[k])) <= 2, (k, int(st[k]), int(sj[k]))


def test_gn_level_parity(pair):
    """One full GN level from a perturbed seed: the same accepted-step
    count and the same pose to 1e-5 (the per-sweep differences above, fed
    through a 6x6 solve and a few steps)."""
    src, trg, tsrc, ttrg, pose = pair
    lvl = 1
    pts, valid = JD._src_points(src.depth[lvl], CFG)
    pack = JD._pack_target({f: getattr(trg, f)[lvl] for f in FIELDS})
    pj, ej, itj, illj, hj, _ = jax.jit(
        lambda p: JD._gn_level(
            src.gray[lvl], pts, valid, pack, p, jnp.array(False), CFG,
            JD.PHOTO_DEPTH, 0, None, CFG.max_iters_per_level,
        )
    )(jnp.asarray(pose))
    pts_t, valid_t = TD._src_points(tsrc.depth[lvl], CFG)
    pack_t = TD._pack_target({f: getattr(ttrg, f)[lvl] for f in FIELDS})
    pt, et, itt, illt, ht, _ = TD._gn_level(
        tsrc.gray[lvl], pts_t, valid_t, pack_t, torch.tensor(pose),
        torch.tensor(False), CFG, TD.PHOTO_DEPTH, 0, None, CFG.max_iters_per_level,
    )
    assert int(itt) == int(itj) and int(itj) > 0
    assert bool(illt) == bool(illj)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5)
    np.testing.assert_allclose(float(et), float(ej), rtol=1e-4)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-3, atol=1e-3 * np.abs(np.asarray(hj)).max())


def _reference_salient_indices(pyr, lvl, k, cfg):
    """The reference's stratified selection (`dense.py:891-910`)."""
    d = pyr.depth[lvl]
    valid = (d > cfg.min_depth) & (d < cfg.max_depth)
    score = (
        jnp.abs(pyr.gray_gx[lvl]) + jnp.abs(pyr.gray_gy[lvl])
        + jnp.abs(pyr.depth_gx[lvl]) + jnp.abs(pyr.depth_gy[lvl])
    )
    score = jnp.where(valid, score, -1.0).reshape(-1)
    k = min(k, score.shape[0])
    tile = score.shape[0] // k
    tiles = score[: k * tile].reshape(k, tile)
    return np.asarray(jnp.arange(k) * tile + jnp.argmax(tiles, axis=1))


def test_salient_selection_same_indices(pair):
    src, _, tsrc, _, _ = pair
    aligner = TD.DenseAligner(CFG)
    for lvl, k in ((0, 2000), (1, 500), (2, 384)):
        np.testing.assert_array_equal(
            aligner._salient_indices(tsrc, lvl, k).numpy(),
            _reference_salient_indices(src, lvl, k, CFG),
        )


def test_salient_align_with_polish(pair):
    """The salient branch (every level <= 2 thinned) plus 2 dense polish
    iterations: the same iteration counts and poses within 1e-4."""
    src, trg, tsrc, ttrg, _ = pair
    cfg = DenseRegConfig(pyramid_levels=3, salient_pixels=2000, polish_iters=2)
    rj = JD.DenseAligner(cfg).align(src, trg)
    rt = TD.DenseAligner(cfg).align(tsrc, ttrg)
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), atol=1e-4)
    np.testing.assert_allclose(float(rt.error), float(rj.error), rtol=1e-3)
    np.testing.assert_allclose(float(rt.sso), float(rj.sso), atol=1e-4)
    assert bool(rt.ill_posed) == bool(rj.ill_posed)


def test_unported_options_raise(pair):
    _, _, tsrc, ttrg, _ = pair
    with pytest.raises(NotImplementedError):
        TD.DenseAligner(DenseRegConfig(bilinear=True))
    with pytest.raises(NotImplementedError):
        TD.DenseAligner(CFG, intrinsics=np.eye(3))
    aligner = TD.DenseAligner(CFG)
    with pytest.raises(NotImplementedError):
        aligner.align(tsrc, ttrg, occlusion=1)
    with pytest.raises(NotImplementedError):
        aligner.coarse_errors(tsrc, ttrg, None)
    with pytest.raises(NotImplementedError):
        aligner.coarse_align(tsrc, ttrg, None)
    with pytest.raises(NotImplementedError):
        TD.batch_align_targets(aligner, tsrc, [ttrg], [np.eye(4)])
    with pytest.raises(NotImplementedError):
        TD._pack_target({}, bilinear=True)
