"""Parity of the port's pyramid with the reference: level transitions
(banded matmuls), the K1 gradients and the whole alignment pyramid."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rgbd360_tpu.config import DenseRegConfig
from rgbd360_tpu.ops import pyramid as jpyr
from rgbd360_tpu.registration import dense as JD
from rgbd360_tpu_torch import convert
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
        torch.from_numpy(g), torch.from_numpy(d), convert.config_from_reference(cfg),
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


def _per_level_pyramid(gray, depth, cfg, seam_levels):
    """The pyramid as it was built before the grouped K1 launch and the
    fused level transition: per level a pyrDown of the gray, the depth's
    valid mean through the 0/1 matmul pair, one gradient call on the
    (gray, depth) stack, and two multiplies by the seam mask."""
    levels = [(gray, depth)]
    for _ in range(cfg.pyramid_levels - 1):
        g, d = levels[-1]
        h, w = g.shape[-2:]
        valid = (d > cfg.min_depth) & (d < cfg.max_depth)
        x = torch.cat([torch.where(valid, d, 0.0), valid.to(d.dtype)]).reshape(-1, h, w)
        a, b = (m.expand(x.shape[0], *m.shape).contiguous()
                for m in tpyr._box_sum_mats(h, w, d.device))
        out = torch.bmm(torch.bmm(a, x), b).reshape(2, *d.shape[:-2], h // 2, w // 2)
        levels.append((tpyr.pyr_down(g), tpyr._valid_mean(out[0], out[1])))
    grads = []
    for lvl, (g, d) in enumerate(levels):
        h, w = g.shape[-2:]
        sx, sy = tpyr.gradient_xy_multi(torch.stack([g, d]).reshape(-1, h, w))
        m = seam_levels[lvl].to(sx.dtype)[:h, :w]
        sx, sy = sx * m, sy * m
        grads.append((sx.reshape(2, *g.shape), sy.reshape(2, *g.shape)))
    return TD.FramePyramid(
        gray=tuple(g for g, _ in levels), depth=tuple(d for _, d in levels),
        gray_gx=tuple(gx[0] for gx, _ in grads), gray_gy=tuple(gy[0] for _, gy in grads),
        depth_gx=tuple(gx[1] for gx, _ in grads), depth_gy=tuple(gy[1] for _, gy in grads),
    )


@pytest.mark.parametrize("batch", [None, 3], ids=["frame", "batch3"])
def test_build_pyramid_equals_the_per_level_form(batch):
    """`_build_pyramid` (4 fused level transitions, one grouped gradient
    call with the masks inside) gives the per-level form's FramePyramid bit
    for bit on the CPU, for one frame and for a batch, with bool and float
    seam masks."""
    rng = np.random.default_rng(11)
    cfg = convert.config_from_reference(DenseRegConfig(pyramid_levels=4))
    lead = () if batch is None else (batch,)
    g = np.stack([_frame(rng, 64, 384)[0] for _ in range(batch or 1)]).reshape(*lead, 64, 384)
    d = np.stack([_frame(rng, 64, 384)[1] for _ in range(batch or 1)]).reshape(*lead, 64, 384)
    d[..., :16, :32] = 25.0  # beyond max_depth: blocks with no valid depth
    g, d = torch.from_numpy(g), torch.from_numpy(d)
    seam = TD.seam_masks_per_level(torch.from_numpy(rng.uniform(size=(64, 384)) > 0.05), 4)
    ref = _per_level_pyramid(g, d, cfg, seam)
    for masks in (seam, tuple(m.to(torch.float32) for m in seam)):
        got = TD._build_pyramid(g, d, cfg, masks, 8, True)
        for f in TD._CHANNELS:
            for lvl in range(4):
                a, b = getattr(got, f)[lvl], getattr(ref, f)[lvl]
                assert a.shape == b.shape == (*lead, 64 >> lvl, 384 >> lvl)
                assert torch.equal(a, b), (f, lvl)
    assert (ref.depth[1] == 0).any()


def test_build_pyramid_uniform_seams_equal_the_per_level_form(rng):
    """Without a builder mask the uniform seam columns are masked after the
    grouped call, as `mask_seams` of each level's stack did."""
    cfg = convert.config_from_reference(DenseRegConfig(pyramid_levels=3))
    g, d = (torch.from_numpy(a) for a in _frame(rng, 64, 384))
    got = TD.build_frame_pyramid(g, d, cfg)
    half = max(1, cfg.seam_mask_px // 2)
    for lvl in range(3):
        sx, sy = tpyr.gradient_xy_multi(torch.stack([got.gray[lvl], got.depth[lvl]]))
        sx, sy = tpyr.mask_seams(sx, 8, half), tpyr.mask_seams(sy, 8, half)
        assert torch.equal(got.gray_gx[lvl], sx[0]) and torch.equal(got.depth_gy[lvl], sy[1])
    plain = TD.build_frame_pyramid(g, d, cfg, spherical=False)
    assert not torch.equal(plain.gray_gx[0], got.gray_gx[0])


def test_builder_lands_on_the_card_unless_asked_for_the_cpu():
    """`FrameBuilder(calib, cfg)` and `RigFrame.from_raw(raw)` take the card
    and raise where there is none; `device="cpu"` builds on the CPU."""
    import rgbd360_tpu_torch
    from rgbd360_tpu_torch import synthetic
    from rgbd360_tpu_torch.core.frame import FrameBuilder, RawRigFrame, RigFrame

    cfg = synthetic.config(5, 3)
    cal = synthetic.calibration(cfg.rig)
    raw = RawRigFrame(*synthetic.captures(1, 5)[0])
    cpu = FrameBuilder(cal, cfg, device="cpu")
    assert {b.device.type for b in cpu.buffers()} == {"cpu"}
    assert RigFrame.from_raw(raw, "cpu").rgb.device.type == "cpu"
    assert cpu.build_from_raw(raw).sphere_gray.device.type == "cpu"
    if torch.cuda.is_available():
        assert rgbd360_tpu_torch.default_device().type == "cuda"
        assert {b.device.type for b in FrameBuilder(cal, cfg).buffers()} == {"cuda"}
        assert RigFrame.from_raw(raw).depth.device.type == "cuda"
    else:
        for call in (rgbd360_tpu_torch.default_device, lambda: FrameBuilder(cal, cfg),
                     lambda: RigFrame.from_raw(raw)):
            with pytest.raises(RuntimeError, match='device="cpu"'):
                call()
    assert rgbd360_tpu_torch.resolve_device("cpu") == torch.device("cpu")
