"""Parity of the port's pyramid with the reference: level transitions
(banded matmuls), the K1 gradients and the whole alignment pyramid."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rgbd360_tpu.config import DenseRegConfig
from rgbd360_tpu.ops import pyramid as jpyr
from rgbd360_tpu.registration import dense as JD
from rgbd360_tpu_torch.ops import pyramid as tpyr
from rgbd360_tpu_torch.registration import dense as TD

# The banded matmuls sum 5 (blur) or 4 (box) terms per output in another
# order than XLA's dot: a few ulps, 1e-6 relative.
LEVEL_RTOL = 1e-6


def _frame(rng, h, w):
    gray = rng.uniform(0, 1, (h, w)).astype(np.float32)
    gray = np.where(rng.uniform(size=(h, w)) < 0.2, np.round(gray * 4) / 4, gray)
    depth = rng.uniform(0.5, 8.0, (h, w))
    depth = np.where(rng.uniform(size=(h, w)) < 0.15, 0.0, depth).astype(np.float32)
    return gray.astype(np.float32), depth


@pytest.mark.parametrize("shape", [(64, 384), (10, 14), (9, 14)])
def test_level_down_parity(rng, shape):
    g, d = _frame(rng, *shape)
    np.testing.assert_allclose(
        tpyr.pyr_down(torch.from_numpy(g)).numpy(),
        np.asarray(jpyr.pyr_down(jnp.asarray(g))), rtol=LEVEL_RTOL, atol=1e-7,
    )
    np.testing.assert_allclose(
        tpyr.pyr_down_depth(torch.from_numpy(d), 0.3, 20.0).numpy(),
        np.asarray(jpyr.pyr_down_depth(jnp.asarray(d), 0.3, 20.0)),
        rtol=LEVEL_RTOL,
    )
    g2t, d2t = tpyr.fused_level_down(torch.from_numpy(g), torch.from_numpy(d), 0.3, 20.0)
    g2j, d2j = jpyr.fused_level_down(jnp.asarray(g), jnp.asarray(d), 0.3, 20.0)
    np.testing.assert_allclose(g2t.numpy(), np.asarray(g2j), rtol=LEVEL_RTOL, atol=1e-7)
    np.testing.assert_allclose(d2t.numpy(), np.asarray(d2j), rtol=LEVEL_RTOL)
    for a, b in zip(
        tpyr.build_depth_pyramid(torch.from_numpy(d), 2),
        jpyr.build_depth_pyramid(jnp.asarray(d), 2),
    ):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=LEVEL_RTOL)


def test_mask_seams_equal(rng):
    grad = rng.normal(size=(16, 384)).astype(np.float32)
    np.testing.assert_array_equal(
        tpyr.mask_seams(torch.from_numpy(grad), 8, 1).numpy(),
        np.asarray(jpyr.mask_seams(jnp.asarray(grad), 8, 1)),
    )


@pytest.fixture(scope="module")
def pyramids():
    """The reference's and the port's pyramid of one 64x384 frame, 3
    levels, with a random seam mask."""
    rng = np.random.default_rng(5)
    cfg = DenseRegConfig(pyramid_levels=3)
    g, d = _frame(rng, 64, 384)
    seam = rng.uniform(size=(64, 384)) > 0.05
    jp = JD.build_frame_pyramid(
        jnp.asarray(g), jnp.asarray(d), cfg, JD.seam_masks_per_level(seam, 3)
    )
    tp = TD.build_frame_pyramid(
        torch.from_numpy(g), torch.from_numpy(d), cfg,
        TD.seam_masks_per_level(torch.from_numpy(seam), 3),
    )
    return jp, tp, seam, cfg


def test_gradients_bit_equal_on_reference_levels(pyramids):
    """K1's plain version fed the reference's own level images gives the
    reference's seam-masked gradients bit for bit."""
    jp, _, seam, cfg = pyramids
    for lvl in range(cfg.pyramid_levels):
        stack = torch.stack(
            [torch.tensor(np.asarray(jp.gray[lvl])), torch.tensor(np.asarray(jp.depth[lvl]))]
        )
        sx, sy = tpyr.gradient_xy_multi(stack)
        m = torch.from_numpy(seam[:: 2**lvl, :: 2**lvl].astype(np.float32))
        for got, ref in (
            (sx[0] * m, jp.gray_gx), (sy[0] * m, jp.gray_gy),
            (sx[1] * m, jp.depth_gx), (sy[1] * m, jp.depth_gy),
        ):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref[lvl]))
        gx, gy = tpyr.gradient_xy(stack[0])
        np.testing.assert_array_equal(gx.numpy(), sx[0].numpy())
        np.testing.assert_array_equal(gy.numpy(), sy[0].numpy())


def test_chained_pyramid_within_bound(pyramids):
    """The port's whole pyramid.  Its levels differ from the reference's by
    a few ulps (LEVEL_RTOL).  The harmonic mean g = 2fb/(f+b) moves by at
    most 2 per unit change of f or b, each a difference of two inputs, and a
    monotonicity flip only happens where |f| or |b| is that small: so each
    gradient stays within 8x the level's largest input difference."""
    jp, tp, _, cfg = pyramids
    for lvl in range(cfg.pyramid_levels):
        for img, gx, gy in (("gray", "gray_gx", "gray_gy"), ("depth", "depth_gx", "depth_gy")):
            ref = np.asarray(getattr(jp, img)[lvl])
            got = getattr(tp, img)[lvl].numpy()
            np.testing.assert_allclose(got, ref, rtol=LEVEL_RTOL, atol=1e-7)
            delta = np.abs(got - ref).max()
            for name in (gx, gy):
                err = np.abs(getattr(tp, name)[lvl].numpy() - np.asarray(getattr(jp, name)[lvl]))
                assert err.max() <= 8 * delta, (name, lvl, err.max(), delta)
