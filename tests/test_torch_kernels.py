"""K1 (`fused_gradients`): the port's plain version against the TPU
kernel (Pallas, interpret mode on the CPU) and the reference's plain form,
bit for bit; the grouped form and its seam masks; and the tile plan of the
CUDA launch, emulated here over every path shape and awkward ones.  The
CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py and by chip_smoke.py, on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rgbd360_tpu.ops import pallas_kernels as K
from rgbd360_tpu.ops import pyramid as P
from rgbd360_tpu_torch.ops import hopper_kernels as HK


def _plateau_image(rng, shape):
    """Values with ~30% plateaus (equal neighbours), ~10% zeros and mixed
    slopes, so every branch of the harmonic mean is reached."""
    x = rng.uniform(0.0, 4.0, shape)
    x = np.where(rng.uniform(size=shape) < 0.3, np.round(x), x)
    x = np.where(rng.uniform(size=shape) < 0.1, 0.0, x)
    return x.astype(np.float32)


@pytest.mark.parametrize("shape", [(32, 256), (64, 384)])
def test_plain_matches_pallas_kernel(rng, shape):
    img = _plateau_image(rng, shape)
    gx0, gy0 = K.fused_gradients(jnp.asarray(img), 16)
    gx1, gy1 = HK.fused_gradients_plain(torch.from_numpy(img))
    np.testing.assert_array_equal(gx1.numpy(), np.asarray(gx0))
    np.testing.assert_array_equal(gy1.numpy(), np.asarray(gy0))


def test_plain_matches_gradient_xy_multi(rng):
    imgs = np.stack([_plateau_image(rng, (64, 384)), _plateau_image(rng, (64, 384))])
    sx0, sy0 = P.gradient_xy_multi(jnp.asarray(imgs))
    before = HK.fused_gradients.launches
    sx1, sy1 = HK.fused_gradients(torch.from_numpy(imgs))
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert HK.fused_gradients.launches == before
    np.testing.assert_array_equal(sx1.numpy(), np.asarray(sx0))
    np.testing.assert_array_equal(sy1.numpy(), np.asarray(sy0))


def test_wrapper_raises_on_devices_without_kernel():
    with pytest.raises(ValueError, match="no kernel"):
        HK.fused_gradients(torch.zeros((2, 8, 8), device="meta"))


LEVEL_SHAPES = [(320, 1920), (160, 960), (80, 480), (40, 240), (20, 120)]
SMALL_LEVELS = [(64, 384), (32, 192), (16, 96)]


def _level_stacks(rng, b, shapes):
    """(stacks, masks): per level a gray and a depth (b, H, W) stack and the
    level's (H, W) bool mask, once per stack."""
    stacks = [_plateau_image(rng, (b, h, w)) for h, w in shapes for _ in range(2)]
    masks = [m for h, w in shapes for m in [rng.uniform(size=(h, w)) > 0.1] * 2]
    return stacks, masks


@pytest.mark.parametrize("b", [1, 3])
def test_levels_plain_with_masks_matches_reference(rng, b):
    """`fused_gradients_levels_plain` with masks is the reference's
    `gradient_xy_multi` times the mask, per level, bit for bit."""
    stacks, masks = _level_stacks(rng, b, SMALL_LEVELS)
    got = HK.fused_gradients_levels_plain(
        [torch.from_numpy(x) for x in stacks], [torch.from_numpy(m) for m in masks]
    )
    assert len(got) == len(stacks)
    for x, m, (gx, gy) in zip(stacks, masks, got):
        sx, sy = P.gradient_xy_multi(jnp.asarray(x))
        mf = jnp.asarray(m.astype(np.float32))
        np.testing.assert_array_equal(gx.numpy(), np.asarray(sx * mf))
        np.testing.assert_array_equal(gy.numpy(), np.asarray(sy * mf))


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_group_equals_per_level_calls(rng, masked):
    """The grouped wrapper (on the CPU: the plain version) equals one
    `fused_gradients` call per stack, and counts no launch."""
    stacks, masks = _level_stacks(rng, 2, SMALL_LEVELS)
    stacks = [torch.from_numpy(x) for x in stacks]
    masks = [torch.from_numpy(m) for m in masks] if masked else None
    before = HK.fused_gradients.launches
    got = HK.fused_gradients_levels(stacks, masks)
    assert HK.fused_gradients.launches == before
    for i, (x, (gx, gy)) in enumerate(zip(stacks, got)):
        rx, ry = HK.fused_gradients(x, masks[i] if masked else None)
        assert torch.equal(gx, rx) and torch.equal(gy, ry)
        px, py = HK.fused_gradients_plain(x)
        if masked:
            m = masks[i].to(torch.float32)
            px, py = px * m, py * m
        assert torch.equal(gx, px) and torch.equal(gy, py)
    assert HK.fused_gradients_levels([]) == []


def test_levels_wrapper_checks():
    x = torch.zeros((2, 8, 8))
    with pytest.raises(ValueError, match="one mask"):
        HK.fused_gradients_levels([x, x], [None])
    with pytest.raises(ValueError, match="mask"):
        HK.fused_gradients_levels([x], [torch.ones((8, 8))])  # not bool
    with pytest.raises(ValueError, match="mask"):
        HK.fused_gradients_levels([x], [torch.ones((4, 8), dtype=torch.bool)])
    with pytest.raises(TypeError):
        HK.fused_gradients_levels([x, x.double()])
    with pytest.raises(ValueError):
        HK.fused_gradients_levels([x[0]])
    with pytest.raises(ValueError, match="no kernel"):
        HK.fused_gradients_levels([x, torch.zeros((2, 8, 8), device="meta")])


def _k1_coverage(shapes, aligned):
    """Emulates the kernel's block -> stack -> tile -> pixel mapping over
    the plan: per stack, how often each pixel is written.  Raises if a
    thread would touch a pixel outside its stack."""
    plan, blocks = HK.gradient_plan(shapes, aligned)
    rows = HK.GRAD_ROWS
    counts = [np.zeros(s, np.int32) for s in shapes]
    for block in range(blocks):
        which = 0
        for i in range(1, len(plan)):  # the kernel's scan
            if block >= plan[i]["first_block"]:
                which = i
        p, (c, h, w) = plan[which], shapes[which]
        assert w % p["vec"] == 0
        for warp in range(HK.GRAD_WARPS):
            tile = (block - p["first_block"]) * HK.GRAD_WARPS + warp
            if tile >= p["tiles"]:
                continue
            tx, rest = tile % p["tiles_x"], tile // p["tiles_x"]
            ty, ch = rest % p["tiles_y"], rest // p["tiles_y"]
            assert 0 <= ch < c
            x0, y0 = tx * 32 * p["vec"], ty * rows
            assert x0 < w and y0 < h  # no tile lies wholly outside
            counts[which][ch, y0 : y0 + rows, x0 : x0 + 32 * p["vec"]] += 1
    return plan, blocks, counts


_PATH_GROUPS = {
    "frame": [(1, h, w) for h, w in LEVEL_SHAPES for _ in range(2)],
    "batch4": [(4, h, w) for h, w in LEVEL_SHAPES for _ in range(2)],
    "single_c2": [(2, 320, 1920)],
    "single_c8_small": [(8, 20, 120)],
    "awkward": [(3, 22, 36), (1, 6, 6), (5, 38, 124), (2, 9, 131), (1, 3, 5), (2, 33, 130),
                (1, 1, 7), (2, 5, 1)],
    "with_empty": [(2, 8, 8), (0, 8, 8), (1, 4, 12)],
}


@pytest.mark.parametrize("pointers", ["aligned", "misaligned", "mixed"])
@pytest.mark.parametrize("group", sorted(_PATH_GROUPS))
def test_gradient_plan_covers_every_pixel_once(group, pointers):
    shapes = _PATH_GROUPS[group]
    aligned = {"aligned": [True] * len(shapes), "misaligned": [False] * len(shapes),
               "mixed": [i % 2 == 0 for i in range(len(shapes))]}[pointers]
    plan, blocks, counts = _k1_coverage(shapes, aligned)
    for cnt in counts:
        assert (cnt == 1).all()
    assert blocks == sum(p["blocks"] for p in plan)
    for p, (c, h, w), ok in zip(plan, shapes, aligned):
        assert p["vec"] == (4 if ok and w % 4 == 0 else 1)
        assert p["tiles"] == c * p["tiles_x"] * p["tiles_y"]


def test_gradient_plan_choices():
    """Every pyramid width takes 16-byte accesses; a misaligned pointer or
    an odd width takes the one-pixel instantiation."""
    frame = _PATH_GROUPS["frame"]
    plan, blocks = HK.gradient_plan(frame, [True] * len(frame))
    assert {p["vec"] for p in plan} == {4}
    assert blocks == plan[-1]["first_block"] + plan[-1]["blocks"]
    assert HK.gradient_plan([(2, 160, 960)], [False])[0][0]["vec"] == 1
    assert HK.gradient_plan([(2, 160, 958)], [True])[0][0]["vec"] == 1
