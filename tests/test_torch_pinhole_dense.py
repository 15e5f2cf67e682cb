"""Parity of the port's pinhole dense path and its joint rig aligner with
the reference (`registration/dense.py` with `intrinsics=K`,
`registration/rig_dense.py`), on the reference tests' own analytic scene:
a textured room corner rendered through the exact pinhole model (a copy of
`tests/test_pinhole_dense.py`'s renderer, in numpy), at 120x160 and 3
levels.  Both packages get the same seeded float32 inputs; the aligners
are fed the reference's own pyramids, so only the aligner differs, and the
pyramid builds are compared on their own.

Tolerances.  `scale_intrinsics` and the 24-channel pack: bit for bit.  One
sweep (`_hess_grad_packed`): the warp rounds continuous coordinates that
differ by ulps, so a pixel or two may sample another target pixel; with
the sums' reordering that stays within 1e-3 of the Hessian's and
gradient's norms and 1e-4 relative on the error (the spherical sweep's
bound in `test_torch_dense.py`).  Whole alignments: the same iteration
counts and the pose within 1e-4 (those differences through a few GN
steps).  The rig's levels and gradients: LEVEL_RTOL and 8x the level's
largest difference, as `test_torch_pyramid.py` bounds the sphere's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rgbd360_tpu.config import DenseRegConfig
from rgbd360_tpu.ops import se3 as jse3
from rgbd360_tpu.registration import dense as JD
from rgbd360_tpu.registration import rig_dense as JR
from rgbd360_tpu_torch import convert
from rgbd360_tpu_torch.ops import pyramid as tpyr
from rgbd360_tpu_torch.registration import dense as TD
from rgbd360_tpu_torch.registration import rig_dense as TR

H, W = 120, 160
K = np.array([[130.0, 0.0, 79.5], [0.0, 130.0, 59.5], [0.0, 0.0, 1.0]], np.float32)
CFG = DenseRegConfig(pyramid_levels=3, sal_intensity=0.0, sal_depth=0.0)
TCFG = convert.config_from_reference(CFG)
FIELDS = TD._CHANNELS
LEVEL_RTOL = 1e-6
POSE_ATOL = 1e-4

# Room corner: four planes n.p = d in world coordinates, all facing the
# origin, ~2.5-4 m away (wall, side wall, floor, ceiling).
_PLANES = np.array(
    [
        [0.0, 0.0, 1.0, 3.2],
        [0.9, 0.1, 0.42, 2.8],
        [-0.15, 0.95, 0.28, 3.6],
        [0.1, -0.95, 0.3, 2.4],
    ],
    dtype=np.float64,
)
_PLANES[:, :3] /= np.linalg.norm(_PLANES[:, :3], axis=1, keepdims=True)


def _render_pinhole(pose_wc, k=K, h=H, w=W):
    """Exact RGB-D render of the corner scene from a camera-to-world pose
    (float32 gray in [0, 1] and z-depth in metres, 0 where no plane)."""
    pose_wc = np.asarray(pose_wc, np.float64)
    u = (np.arange(w) - k[0, 2]) / k[0, 0]
    v = (np.arange(h) - k[1, 2]) / k[1, 1]
    ray_c = np.stack([np.broadcast_to(u[None, :], (h, w)),
                      np.broadcast_to(v[:, None], (h, w)), np.ones((h, w))], axis=-1)
    r, t = pose_wc[:3, :3], pose_wc[:3, 3]
    ray_w = ray_c @ r.T
    n, d = _PLANES[:, :3], _PLANES[:, 3]
    denom = np.einsum("hwk,pk->hwp", ray_w, n)
    z = (d - n @ t)[None, None, :] / np.where(np.abs(denom) > 1e-6, denom, 1e-6)
    z = np.where(z > 0.1, z, np.inf)
    depth = np.min(z, axis=-1)
    depth = np.where(np.isfinite(depth), depth, 0.0)
    p_w = t + ray_w * depth[..., None]
    gray = (0.5 + 0.18 * np.sin(2.1 * p_w[..., 0]) + 0.14 * np.cos(1.7 * p_w[..., 1] + 0.6)
            + 0.12 * np.sin(1.3 * p_w[..., 2] + 1.1))
    gray = np.where(depth > 0, gray, 0.0)
    return gray.astype(np.float32), depth.astype(np.float32)


def _twist(xi) -> np.ndarray:
    return np.asarray(jse3.se3_exp(jnp.asarray(xi, jnp.float32)), np.float64)


def _to_torch(pyr) -> TD.FramePyramid:
    return TD.FramePyramid(
        **{f: tuple(torch.tensor(np.asarray(x)) for x in getattr(pyr, f)) for f in FIELDS}
    )


@pytest.fixture(scope="module")
def corner():
    """The reference's pinhole pyramids of the corner seen from the origin
    (source) and from a known motion (target), in both packages' types."""
    g1, d1 = _render_pinhole(np.eye(4))
    g2, d2 = _render_pinhole(_twist([0.05, -0.04, 0.06, 0.012, -0.018, 0.02]))
    build = jax.jit(lambda g, d: JD.build_frame_pyramid(g, d, CFG, spherical=False))
    src, trg = build(g1, d1), build(g2, d2)
    return src, trg, _to_torch(src), _to_torch(trg)


def test_scale_intrinsics_bit_equal():
    for lvl in range(4):
        np.testing.assert_array_equal(
            TD.scale_intrinsics(torch.from_numpy(K), lvl).numpy(),
            np.asarray(JD.scale_intrinsics(jnp.asarray(K), lvl)),
        )


@pytest.mark.parametrize("bilinear", [False, True])
@pytest.mark.parametrize("lvl", [0, 1])
def test_pinhole_sweep_parity(corner, bilinear, lvl):
    """One pinhole sweep (the points, the pack with edge-clamped columns,
    the projection Jacobian and the -e_z depth term) at a fixed pose."""
    src, trg, tsrc, ttrg = corner
    pose = _twist([0.03, -0.02, 0.05, 0.01, -0.01, 0.015]).astype(np.float32)
    intr = JD.scale_intrinsics(jnp.asarray(K), lvl)
    jl = {f: getattr(src, f)[lvl] for f in FIELDS}
    jt = {f: getattr(trg, f)[lvl] for f in FIELDS}
    cfg = dataclasses.replace(CFG, bilinear=bilinear)
    hj, gj, sj = jax.jit(JD._hess_grad, static_argnums=(3, 4, 5))(
        jl, jt, jnp.asarray(pose), cfg, JD.PHOTO_DEPTH, 0, intr)
    ht, gt, st = TD._hess_grad(
        {f: getattr(tsrc, f)[lvl] for f in FIELDS}, {f: getattr(ttrg, f)[lvl] for f in FIELDS},
        torch.from_numpy(pose), convert.config_from_reference(cfg), TD.PHOTO_DEPTH, 0,
        TD.scale_intrinsics(torch.from_numpy(K), lvl))
    hj, gj = np.asarray(hj), np.asarray(gj)
    assert np.abs(ht.numpy() - hj).max() <= 1e-3 * np.abs(hj).max()
    assert np.abs(gt.numpy() - gj).max() <= 1e-3 * np.abs(gj).max()
    np.testing.assert_allclose(float(st["mean_err"]), float(sj["mean_err"]), rtol=1e-4)
    for k in ("photo_n", "depth_n", "visible"):
        assert abs(int(st[k]) - int(sj[k])) <= 2, (k, int(st[k]), int(sj[k]))


@pytest.mark.parametrize(
    "method,bilinear,occlusion,salient",
    [(JD.PHOTO_DEPTH, False, 0, 0), (JD.DEPTH_CONSISTENCY, False, 0, 0),
     (JD.PHOTO_DEPTH, True, 0, 0), (JD.PHOTO_DEPTH, False, 1, 0),
     (JD.PHOTO_DEPTH, False, 2, 0), (JD.PHOTO_DEPTH, False, 0, 2000)],
)
def test_pinhole_align_matches_reference(corner, method, bilinear, occlusion, salient):
    """`DenseAligner(intrinsics=K).align` from identity: each method, the
    bilinear sampler, both occlusion modes, and the salient subset (with
    its pinhole backprojection at the selected pixels) plus the dense
    polish."""
    src, trg, tsrc, ttrg = corner
    cfg = dataclasses.replace(CFG, bilinear=bilinear, salient_pixels=salient,
                              polish_iters=2 if salient else 0)
    rj = JD.DenseAligner(cfg, intrinsics=jnp.asarray(K)).align(
        src, trg, method=method, occlusion=occlusion)
    rt = TD.DenseAligner(convert.config_from_reference(cfg), intrinsics=K).align(
        tsrc, ttrg, method=method, occlusion=occlusion)
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), atol=POSE_ATOL)
    np.testing.assert_allclose(float(rt.error), float(rj.error), rtol=1e-3)
    np.testing.assert_allclose(float(rt.sso), float(rj.sso), atol=1e-3)
    assert bool(rt.ill_posed) == bool(rj.ill_posed) is False


def test_pinhole_coarse_align_matches_reference(corner):
    """`coarse_errors` and `coarse_align` with the coarsest level's K over
    a few yaw hypotheses."""
    src, trg, tsrc, ttrg = corner
    poses = np.stack([_twist([0, 0, 0, 0, a, 0]) for a in (-0.05, 0.0, 0.05)]).astype(np.float32)
    jal = JD.DenseAligner(CFG, intrinsics=jnp.asarray(K))
    tal = TD.DenseAligner(TCFG, intrinsics=K)
    np.testing.assert_allclose(tal.coarse_errors(tsrc, ttrg, poses).numpy(),
                               np.asarray(jal.coarse_errors(src, trg, jnp.asarray(poses))),
                               rtol=1e-4)
    pj, ej = jal.coarse_align(src, trg, jnp.asarray(poses), iters=4)
    pt, et = tal.coarse_align(tsrc, ttrg, poses, iters=4)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=POSE_ATOL)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-3)


# ------------------------------------------------------------- rig (joint)


def _rig_extrinsics() -> np.ndarray:
    """Two sensors looking 50 degrees apart about the rig's vertical (y)
    axis, mounted 5.5 cm off-centre like the reference rig."""
    rts = []
    for ang in (0.0, np.deg2rad(50.0)):
        rt = _twist([0, 0, 0, 0, ang, 0])
        rt[:3, 3] = rt[:3, :3] @ np.array([0.0, 0.0, -0.055])
        rts.append(rt)
    return np.stack(rts).astype(np.float32)


def _render_rig(robot_pose, rts):
    views = [_render_pinhole(np.asarray(robot_pose, np.float64) @ rt) for rt in rts]
    return np.stack([g for g, _ in views]), np.stack([d for _, d in views])


@pytest.fixture(scope="module")
def rig():
    rts = _rig_extrinsics()
    g1, d1 = _render_rig(np.eye(4), rts)
    g2, d2 = _render_rig(_twist([0.05, -0.03, 0.04, 0.01, 0.025, -0.015]), rts)
    return rts, (g1, d1), (g2, d2)


def test_rig_pyramid_within_bound(rig):
    """`build_rig_pyramid`: the sensors as the batch of one build (K1 and
    K2's plain versions here).  The reference builds this pyramid with
    `allow_pallas=False`; its jnp gradients are the function that K1
    computes (`test_torch_pyramid.py` holds them bit for bit on the same
    levels), so the two pyramids agree to the levels' ulps."""
    _, (g, d), _ = rig
    jp = JR.build_rig_pyramid(jnp.asarray(g), jnp.asarray(d), CFG)
    tp = TR.build_rig_pyramid(torch.from_numpy(g), torch.from_numpy(d), TCFG)
    for lvl in range(CFG.pyramid_levels):
        assert tp.gray[lvl].shape == (2, H >> lvl, W >> lvl)
        for img, gx, gy in (("gray", "gray_gx", "gray_gy"), ("depth", "depth_gx", "depth_gy")):
            ref = np.asarray(getattr(jp, img)[lvl])
            got = getattr(tp, img)[lvl].numpy()
            np.testing.assert_allclose(got, ref, rtol=LEVEL_RTOL, atol=1e-7)
            delta = np.abs(got - ref).max()
            for name in (gx, gy):
                err = np.abs(getattr(tp, name)[lvl].numpy() - np.asarray(getattr(jp, name)[lvl]))
                assert err.max() <= 8 * delta, (name, lvl, err.max(), delta)
    stack = torch.stack([torch.tensor(np.asarray(jp.gray[1])), torch.tensor(np.asarray(jp.depth[1]))])
    sx, sy = tpyr.gradient_xy_multi(stack.reshape(-1, H >> 1, W >> 1))
    np.testing.assert_array_equal(sx[:2].numpy(), np.asarray(jp.gray_gx[1]))
    np.testing.assert_array_equal(sy[2:].numpy(), np.asarray(jp.depth_gy[1]))


@pytest.mark.parametrize("bilinear,occlusion", [(False, 0), (True, 0), (False, 2)])
def test_rig_joint_matches_reference(rig, bilinear, occlusion):
    """`RigDenseAligner.align`: the sensors as the sweep's batch, folded
    through their adjoints, against the reference's vmap on the same
    pyramids (the reference's own)."""
    rts, (g1, d1), (g2, d2) = rig
    cfg = dataclasses.replace(CFG, bilinear=bilinear)
    src = JR.build_rig_pyramid(jnp.asarray(g1), jnp.asarray(d1), cfg)
    trg = JR.build_rig_pyramid(jnp.asarray(g2), jnp.asarray(d2), cfg)
    rj = JR.RigDenseAligner(jnp.asarray(K), jnp.asarray(rts), cfg).align(
        src, trg, occlusion=occlusion)
    rt = TR.RigDenseAligner(K, rts, convert.config_from_reference(cfg)).align(
        _to_torch(src), _to_torch(trg), occlusion=occlusion)
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), atol=POSE_ATOL)
    hj = np.asarray(rj.hessian)
    assert np.abs(rt.hessian.numpy() - hj).max() <= 1e-3 * np.abs(hj).max()
    for k in ("error", "av_photo_residual", "av_depth_residual", "sso"):
        np.testing.assert_allclose(float(getattr(rt, k)), float(getattr(rj, k)), rtol=1e-3,
                                   err_msg=k)
    assert bool(rt.ill_posed) == bool(rj.ill_posed) is False
