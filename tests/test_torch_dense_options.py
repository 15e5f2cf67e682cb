"""Parity of the dense aligner's options with the reference: the
validity-weighted bilinear target sampling (`DenseRegConfig.bilinear`, the
24-channel pack), the occlusion modes 1 and 2 (the z-buffer and the
dynamic mask), batched as well; and the small ports that ride with them:
`ops/pyramid.build_pyramid`, `ops/undistort.undistort_depth`,
`FrameBuilder.undistort`, `entropy_from_hessian` and the viz helpers.

Scenes: the reference tests' exact box room on the sphere (a copy of
`tests/test_dense.py`'s renderer), and the flagship synthetic pair, whose
sinusoidal depth occludes itself under a sideways step.

Tolerances.  Bit for bit: the 24-channel pack (a stack and shifted
copies), the z-buffer's occlusion mask fed the reference's own warp terms
(a scatter-min and a comparison), `undistort_depth` (the same operations
in the same order), the viz helpers.  One sweep: 1e-3 of the Hessian's
and gradient's norms, 1e-4 relative on the error, a count or two (the
warp's rounding of coordinates that differ by ulps, as in
`test_torch_dense.py`).  Whole alignments: the same iteration counts and
the pose within 1e-4.  `build_pyramid`: 1e-6 relative (K2's plain version
sums its taps in another order than the reference's banded matmul, as in
`test_torch_pyramid.py`).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rgbd360_tpu.config import DenseRegConfig
from rgbd360_tpu.ops import pyramid as jpyr
from rgbd360_tpu.ops import se3 as jse3
from rgbd360_tpu.ops import undistort as jund
from rgbd360_tpu.registration import dense as JD
from rgbd360_tpu.utils import viz as jviz
from rgbd360_tpu_torch import convert, synthetic
from rgbd360_tpu_torch.ops import pyramid as tpyr
from rgbd360_tpu_torch.ops import undistort as tund
from rgbd360_tpu_torch.registration import dense as TD
from rgbd360_tpu_torch.utils import viz as tviz

from __graft_entry__ import _synthetic_pair

CFG = DenseRegConfig(pyramid_levels=3)
FIELDS = TD._CHANNELS
POSE_ATOL = 1e-4


def _box_room_sphere(h, w, origin, half_extents=(3.0, 1.4, 4.0)):
    """Exact spherical depth + world-locked texture of an axis-aligned box
    room seen from `origin` (float32 gray, radial depth in metres)."""
    rows, cols = np.arange(h), np.arange(w)
    phi = (h / 2 - 0.5 - rows) * (2 * np.pi / w)
    theta = cols * (2 * np.pi / w)
    sp, cp = np.sin(phi)[:, None], np.cos(phi)[:, None]
    st, ct = np.sin(theta)[None, :], np.cos(theta)[None, :]
    v = np.stack([np.broadcast_to(sp, (h, w)), -cp * st, -cp * ct], axis=-1)
    t_best = np.full((h, w), np.inf)
    for ax in range(3):
        for sign in (-1.0, 1.0):
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (sign * half_extents[ax] - origin[ax]) / v[..., ax]
            t_best = np.minimum(t_best, np.where((t > 1e-3) & np.isfinite(t), t, np.inf))
    hit = origin[None, None, :] + t_best[..., None] * v
    gray = (0.5 + 0.2 * np.sin(2.7 * hit[..., 0]) + 0.18 * np.cos(3.1 * hit[..., 1] + 1.0)
            + 0.15 * np.sin(2.3 * hit[..., 2] + 0.5))
    return gray.astype(np.float32), t_best.astype(np.float32)


def _to_torch(pyr) -> TD.FramePyramid:
    return TD.FramePyramid(
        **{f: tuple(torch.tensor(np.asarray(x)) for x in getattr(pyr, f)) for f in FIELDS}
    )


def _ref_pyramid(g, d, cfg=CFG):
    return jax.jit(lambda g, d: JD.build_frame_pyramid(g, d, cfg))(g, d)


@pytest.fixture(scope="module")
def box_room():
    """Reference pyramids (80x480, 3 levels) of the box room from the origin
    and from two displaced viewpoints, in both packages' types."""
    origins = [np.zeros(3), np.array([0.06, 0.01, 0.04]), np.array([-0.04, 0.02, 0.07])]
    pyrs = [_ref_pyramid(*_box_room_sphere(80, 480, o)) for o in origins]
    return pyrs, [_to_torch(p) for p in pyrs]


@pytest.fixture(scope="module")
def bumpy():
    """The flagship pair (64x384), whose sinusoidal depth occludes itself,
    its reference pyramids, and a pose with a 0.3 m sideways step."""
    g1, d1, g2, d2 = _synthetic_pair(64, 384)
    src, trg = _ref_pyramid(g2, d2), _ref_pyramid(g1, d1)
    pose = np.asarray(jse3.se3_exp(jnp.array([0.05, 0.3, -0.1, 0.02, 0.05, -0.03])))
    return src, trg, _to_torch(src), _to_torch(trg), pose


@pytest.mark.parametrize("wrap", [True, False])
def test_pack_target_bilinear_bit_equal(box_room, wrap):
    pyrs, tpyrs = box_room
    for lvl in (0, 2):
        jp = JD._pack_target({f: getattr(pyrs[0], f)[lvl] for f in FIELDS}, True, wrap)
        tp = TD._pack_target({f: getattr(tpyrs[0], f)[lvl] for f in FIELDS}, True, wrap)
        assert tp.shape[-1] == 24
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # a batch of targets packs each element on its own
    both = TD.stack_pyramids(tpyrs[:2])
    tb = TD._pack_target({f: getattr(both, f)[1] for f in FIELDS}, True, wrap)
    for i in range(2):
        jp = JD._pack_target({f: getattr(pyrs[i], f)[1] for f in FIELDS}, True, wrap)
        np.testing.assert_array_equal(tb[i].numpy(), np.asarray(jp))


@pytest.mark.parametrize("lvl", [0, 1])
def test_zbuffer_mask_bit_equal(bumpy, lvl):
    """The occlusion test on the reference's own warp terms: the port's
    scatter-min z-buffer leaves visible exactly the pixels the reference's
    `_residual_terms(occlusion=1)` does, and this pose occludes some."""
    src, trg, _, _, pose = bumpy
    pts, valid = JD._src_points(src.depth[lvl], CFG)
    pack = JD._pack_target({f: getattr(trg, f)[lvl] for f in FIELDS})
    h, w = pack.shape[:2]
    wt = JD._warp_terms(jnp.asarray(pose), pts, valid, h, w)
    ref = JD._residual_terms(src.gray[lvl], pts, valid, pack, jnp.asarray(pose), CFG,
                             JD.PHOTO_DEPTH, occlusion=1)
    twt = {k: torch.tensor(np.asarray(wt[k])) for k in ("r", "c", "rho", "visible")}
    got = twt["visible"] & ~TD._occluded(twt, h, w, ())
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref["visible"]))
    assert int(twt["visible"].sum()) - int(got.sum()) > 0  # some are occluded


@pytest.mark.parametrize("bilinear,occlusion", [(True, 0), (False, 2), (True, 2)])
def test_sweep_options_parity(bumpy, bilinear, occlusion):
    """One sweep with the 24-channel bilinear sampling and/or occlusion
    mode 2 (the z-buffer and the 0.3 m dynamic mask) at a fixed pose."""
    src, trg, tsrc, ttrg, pose = bumpy
    cfg = dataclasses.replace(CFG, bilinear=bilinear)
    tcfg = convert.config_from_reference(cfg)
    lvl = 0
    jl, jt = ({f: getattr(p, f)[lvl] for f in FIELDS} for p in (src, trg))
    pts, valid = JD._src_points(jl["depth"], cfg)
    pack = JD._pack_target(jt, bilinear)
    rj = jax.jit(JD._residual_terms, static_argnums=(5, 6, 7))(
        jl["gray"], pts, valid, pack, jnp.asarray(pose), cfg, JD.PHOTO_DEPTH, occlusion)
    hj, gj, sj = jax.jit(JD._hess_grad, static_argnums=(3, 4, 5))(
        jl, jt, jnp.asarray(pose), cfg, JD.PHOTO_DEPTH, occlusion)
    tl, tt = ({f: getattr(p, f)[lvl] for f in FIELDS} for p in (tsrc, ttrg))
    tpts, tvalid = TD._src_points(tl["depth"], tcfg)
    rt = TD._residual_terms(tl["gray"], tpts, tvalid, TD._pack_target(tt, bilinear),
                            torch.tensor(pose), tcfg, TD.PHOTO_DEPTH, occlusion)
    ht, gt, st = TD._hess_grad(tl, tt, torch.tensor(pose), tcfg, TD.PHOTO_DEPTH, occlusion)
    for k in ("visible", "photo_mask", "depth_mask") + (("dynamic_mask",) if occlusion else ()):
        assert abs(int(rt[k].sum()) - int(np.asarray(rj[k]).sum())) <= 2, k
    for k in ("photo_res", "depth_res"):
        np.testing.assert_allclose(float(torch.sum(rt[k] ** 2)),
                                   float(jnp.sum(rj[k] ** 2)), rtol=1e-3, err_msg=k)
    hj, gj = np.asarray(hj), np.asarray(gj)
    assert np.abs(ht.numpy() - hj).max() <= 1e-3 * np.abs(hj).max()
    assert np.abs(gt.numpy() - gj).max() <= 1e-3 * np.abs(gj).max()
    np.testing.assert_allclose(float(st["mean_err"]), float(sj["mean_err"]), rtol=1e-4)


@pytest.mark.parametrize("bilinear", [False, True])
def test_box_room_align_matches_reference(box_room, bilinear):
    """The reference's bilinear scene (`test_bilinear_beats_nearest_on_
    exact_geometry`): each sampler's whole alignment against the
    reference's."""
    pyrs, tpyrs = box_room
    cfg = dataclasses.replace(CFG, bilinear=bilinear)
    rj = JD.DenseAligner(cfg).align(pyrs[0], pyrs[1])
    rt = TD.DenseAligner(convert.config_from_reference(cfg)).align(tpyrs[0], tpyrs[1])
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), atol=POSE_ATOL)
    np.testing.assert_allclose(float(rt.av_depth_residual), float(rj.av_depth_residual),
                               rtol=1e-3)
    assert not bool(rt.ill_posed)


def test_batched_options_match_reference_vmap(box_room):
    """One source against two targets in one batched solve with bilinear
    sampling and occlusion mode 1 (one z-buffer per element) against the
    reference's vmapped `_align_impl`."""
    pyrs, tpyrs = box_room
    cfg = dataclasses.replace(CFG, bilinear=True)
    aligner = JD.DenseAligner(cfg)
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), pyrs[1], pyrs[2])
    rj = jax.jit(jax.vmap(lambda t, s: aligner._align_impl(pyrs[0], t, s, JD.PHOTO_DEPTH, 1)))(
        stacked, jnp.stack([jnp.eye(4)] * 2))
    rt = TD.DenseAligner(convert.config_from_reference(cfg))._align_impl(
        tpyrs[0], TD.stack_pyramids(tpyrs[1:]), torch.eye(4).expand(2, 4, 4), TD.PHOTO_DEPTH, 1)
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), atol=POSE_ATOL)
    np.testing.assert_allclose(rt.sso.numpy(), np.asarray(rj.sso), atol=1e-3)


def test_build_pyramid_matches_reference(rng):
    img = rng.uniform(0, 1, (64, 384)).astype(np.float32)
    got = tpyr.build_pyramid(torch.from_numpy(img), 4)
    ref = jpyr.build_pyramid(jnp.asarray(img), 4)
    assert [tuple(x.shape) for x in got] == [x.shape for x in ref]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_undistort_depth_bit_equal(rng):
    """`undistort_depth` on `synthetic.py`'s seeded CLAMS tables (both the
    interpolating and the nearest-bin branches), and the per-pixel-table
    form the frame build uses gives the same depths."""
    s, h, w = 2, 24, 32
    mult, counts = synthetic.synthetic_clams(s, h, w)
    depth = rng.uniform(0.2, 11.0, (s, h, w)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.1] = 0.0
    ref = np.asarray(jund.undistort_depth(jnp.asarray(depth), jnp.asarray(mult),
                                          jnp.asarray(counts), 4, 3, 2.0))
    got = tund.undistort_depth(torch.from_numpy(depth), torch.from_numpy(mult),
                               torch.from_numpy(counts), 4, 3, 2.0)
    np.testing.assert_array_equal(got.numpy(), ref)
    m_img, c_img = tund.precompute_pixel_tables(torch.from_numpy(mult),
                                                torch.from_numpy(counts), 4, 3, h, w)
    np.testing.assert_array_equal(
        tund.undistort_depth_pixeltab(torch.from_numpy(depth), m_img, c_img, 2.0).numpy(), ref)
    assert not np.array_equal(ref, depth)


def test_frame_builder_undistort_matches_reference():
    """`FrameBuilder.undistort` of a raw capture (u16 mm in, metres out)
    at the small rig with the synthetic CLAMS model."""
    from _reference import reference_builder
    from rgbd360_tpu.core.frame import RigFrame as JRigFrame
    from rgbd360_tpu_torch.core.frame import FrameBuilder, RigFrame

    cfg = synthetic.config(4, 3)
    rgb, depth = synthetic.captures(1, 4)[0]
    jb = reference_builder(cfg)
    ref = jb.undistort(JRigFrame(rgb=jnp.asarray(rgb), depth=jnp.asarray(depth)))
    tb = FrameBuilder(synthetic.calibration(cfg.rig), cfg, device="cpu")
    got = tb.undistort(RigFrame(rgb=torch.from_numpy(rgb), depth=torch.from_numpy(depth)))
    assert got.depth.dtype == torch.float32
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(ref.depth))
    np.testing.assert_array_equal(got.rgb.numpy(), rgb)
    # float metres pass through the conversion unchanged
    again = tb.undistort(RigFrame(rgb=got.rgb, depth=torch.from_numpy(depth * np.float32(0.001))))
    assert again.depth.dtype == torch.float32


def test_entropy_and_viz_helpers(rng):
    a = rng.normal(size=(6, 6)).astype(np.float32)
    info = a @ a.T + 6 * np.eye(6, dtype=np.float32)
    np.testing.assert_allclose(float(TD.entropy_from_hessian(torch.from_numpy(info))),
                               float(JD.entropy_from_hessian(jnp.asarray(info))), rtol=1e-5)
    img = rng.uniform(0, 255, (4, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(tviz.bgr_to_rgb(img), jviz.bgr_to_rgb(img))
    d = rng.uniform(0, 9, (4, 5)).astype(np.float32)
    np.testing.assert_array_equal(tviz.depth_to_gray(d), np.asarray(jviz.depth_to_gray(d)))
