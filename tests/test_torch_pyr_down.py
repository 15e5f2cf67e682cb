"""K2 (`fused_pyr_down`): the port's plain version against the TPU kernel
(Pallas, interpret mode on the CPU) and its circular-row form against the
reference's pyrDown; `fused_level_down` (gray and depth in one launch)
against the reference's; the wrapper's checks; and the tile plan and window
indexing of the CUDA launch, emulated here over every path shape and
awkward ones.  The CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py and by chip_smoke.py, on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rgbd360_tpu.ops import pallas_kernels as K
from rgbd360_tpu.ops import pyramid as jpyr
from rgbd360_tpu_torch.ops import hopper_kernels as HK
from rgbd360_tpu_torch.ops import pyramid as tpyr

# XLA on the CPU fuses the Pallas body's multiply-adds (interpret mode runs
# it as XLA code), so the kernel rounds once where the plain version rounds
# twice: measured at most 1.19e-7 = 1 ulp of the [0, 1) inputs.
PALLAS_ATOL = 2e-7
# The reference's pyrDown is two banded matmuls, which sum the 5 taps of
# each axis in another order than K2: a few ulps (tests/test_torch_pyramid.py).
LEVEL_RTOL = 1e-6


def _image(rng, shape):
    """[0, 1) values with ~20% plateaus and ~10% zeros."""
    x = rng.uniform(0.0, 1.0, shape)
    x = np.where(rng.uniform(size=shape) < 0.2, np.round(x * 4) / 4, x)
    return np.where(rng.uniform(size=shape) < 0.1, 0.0, x).astype(np.float32)


@pytest.mark.parametrize("shape,block_rows", [((320, 1920), 8), ((32, 256), 8)])
def test_plain_matches_pallas_kernel(rng, shape, block_rows):
    """Edge-clamped rows: the Pallas kernel's own padding, on all rows."""
    img = _image(rng, shape)
    ref = np.asarray(K.fused_pyr_down(jnp.asarray(img), block_rows))
    got = HK.fused_pyr_down(torch.from_numpy(img)[None])[0].numpy()
    assert got.shape == ref.shape == (shape[0] // 2, shape[1] // 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=PALLAS_ATOL)


@pytest.mark.parametrize("shape", [(320, 1920), (40, 240), (10, 14)])
def test_circular_matches_reference_pyr_down(rng, shape):
    """Circular rows: the reference's banded-matmul pyrDown, for a stack."""
    imgs = np.stack([_image(rng, shape) for _ in range(3)])
    got = HK.fused_pyr_down_circular(torch.from_numpy(imgs)).numpy()
    for c in range(3):
        ref = np.asarray(jpyr.pyr_down(jnp.asarray(imgs[c])))
        np.testing.assert_allclose(got[c], ref, rtol=LEVEL_RTOL, atol=1e-7)


def test_row_modes_differ_only_on_border_rows(rng):
    """Edge and circular rows read other rows only within 2 of a border,
    and the two forms are otherwise the same arithmetic, bit for bit."""
    x = torch.from_numpy(_image(rng, (2, 64, 96)))
    edge, circ = HK.fused_pyr_down(x), HK.fused_pyr_down_circular(x)
    assert torch.equal(edge[:, 1:-1], circ[:, 1:-1])
    assert not torch.equal(edge[:, 0], circ[:, 0])


def test_pyramid_pyr_down_takes_k2_for_even_shapes(rng):
    """`ops/pyramid.pyr_down` on (H, W) and (B, H, W) is the circular K2
    form; odd shapes keep the roll chain."""
    x = torch.from_numpy(_image(rng, (4, 40, 240)))
    ref = HK.fused_pyr_down_circular(x)
    assert torch.equal(tpyr.pyr_down(x), ref)
    assert torch.equal(tpyr.pyr_down(x[1]), ref[1])
    odd = torch.from_numpy(_image(rng, (9, 14)))
    np.testing.assert_allclose(
        tpyr.pyr_down(odd).numpy(), np.asarray(jpyr.pyr_down(jnp.asarray(odd.numpy()))),
        rtol=LEVEL_RTOL, atol=1e-7,
    )


def test_wrapper_cpu_path_and_refusals():
    x = torch.zeros((2, 8, 8))
    before = HK.fused_pyr_down.launches
    HK.fused_pyr_down(x)
    HK.fused_pyr_down_circular(x)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert HK.fused_pyr_down.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        HK.fused_pyr_down(torch.zeros((2, 8, 8), device="meta"))
    with pytest.raises(TypeError):
        HK.fused_pyr_down(x.double())
    with pytest.raises(ValueError, match="even"):
        HK.fused_pyr_down_circular(torch.zeros((2, 9, 8)))
    with pytest.raises(ValueError, match="even"):
        HK.fused_pyr_down(torch.zeros((8, 8)))
    with pytest.raises(ValueError, match="contiguous"):
        HK.fused_pyr_down(torch.zeros((2, 8, 16))[:, :, ::2])


# The gray of a level transition against the reference's banded matmuls:
# another summation order, measured at most 4.77e-7 on unit-range inputs
# (4 ulps of values near 1).
LEVEL_DOWN_GRAY_ATOL = 4.77e-7
TRANSITION_SHAPES = [(320, 1920), (160, 960), (80, 480), (40, 240)]
AWKWARD = [(22, 36), (6, 6), (38, 124), (10, 264), (10, 134), (2, 2), (4, 4)]


def _depth(rng, shape):
    """Depths below, inside and above the valid range (0.3-20 m), zeros,
    and a block with no valid depth at all."""
    d = rng.uniform(0.0, 25.0, shape)
    d = np.where(rng.uniform(size=shape) < 0.2, 0.0, d)
    d[..., : shape[-2] // 4, : shape[-1] // 4] = 0.1
    return d.astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 384), (40, 240), (10, 14)])
def test_level_down_plain_matches_reference(rng, shape):
    """`fused_level_down_plain` against the reference's `fused_level_down`:
    the depth bit for bit (2-addend block sums), the gray within the ulps of
    the summation order."""
    g, d = _image(rng, shape), _depth(rng, shape)
    g2j, d2j = jpyr.fused_level_down(jnp.asarray(g), jnp.asarray(d), 0.3, 20.0)
    g2, d2 = HK.fused_level_down_plain(torch.from_numpy(g), torch.from_numpy(d), 0.3, 20.0)
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d2j))
    np.testing.assert_allclose(g2.numpy(), np.asarray(g2j), rtol=0, atol=LEVEL_DOWN_GRAY_ATOL)
    assert (d2.numpy() == 0).any() and (d2.numpy() > 0).any()


def test_level_down_wrapper_on_cpu(rng):
    """The wrapper on CPU stacks: the plain version (no launch counted),
    equal to the separate pyrDown and depth mean; and its checks."""
    g = torch.from_numpy(_image(rng, (3, 16, 24)))
    d = torch.from_numpy(_depth(rng, (3, 16, 24)))
    before = HK.fused_pyr_down.launches
    g2, d2 = HK.fused_level_down(g, d, 0.3, 20.0)
    assert HK.fused_pyr_down.launches == before
    assert torch.equal(g2, HK.fused_pyr_down_circular(g))
    assert torch.equal(d2, tpyr.pyr_down_depth(d, 0.3, 20.0))
    g2p, d2p = tpyr.fused_level_down(g[0], d[0], 0.3, 20.0)  # one (H, W) image
    assert torch.equal(g2p, g2[0]) and torch.equal(d2p, d2[0])
    with pytest.raises(ValueError, match="share"):
        HK.fused_level_down(g, d[:, :8].contiguous(), 0.3, 20.0)
    with pytest.raises(TypeError):
        HK.fused_level_down(g, d.double(), 0.3, 20.0)
    with pytest.raises(ValueError, match="even"):
        HK.fused_level_down(g[:, :15], d[:, :15], 0.3, 20.0)
    with pytest.raises(ValueError, match="no kernel"):
        HK.fused_level_down(g.to("meta"), d.to("meta"), 0.3, 20.0)


def _window_index(i: int, n: int, circular: bool = True) -> int:
    """Where the kernel's loader reads window row or column `i` of an axis
    of length `n`: wrapped, or clamped to the edge (rows of
    `fused_pyr_down`); twin of `wrap` and the clamp in csrc/pyr_down.cu."""
    return i % n if circular else min(max(i, 0), n - 1)


def _emulate_blur_launch(img, circular, aligned):
    """The CUDA launch's tile algorithm in numpy over the plan: per block,
    the staged window (rows wrapped or clamped, columns wrapped per 16-byte
    chunk or per element), the vertical blur per window column, the
    horizontal blur at the even columns.  Returns (out, writes per output);
    raises if a load would leave the image."""
    c, h, w = img.shape
    plan = HK.level_down_plan(c, 0, h, w, aligned, False)
    th, span, rows = HK.LD_TILE_H, plan["span"], plan["rows"]
    assert rows == 2 * th + 3 and span == 2 * HK.LD_TILE_W + 8
    out = np.zeros((c, h // 2, w // 2), np.float32)
    writes = np.zeros(out.shape, np.int32)
    k0, k1, k2 = np.float32(1 / 16), np.float32(4 / 16), np.float32(6 / 16)

    def blur5(m2, m1, mid, p1, p2):
        return k0 * (m2 + p2) + k1 * (m1 + p1) + k2 * mid

    gx, gy, gz = plan["grid"]
    assert gz == c
    for z in range(gz):
        for by in range(gy):
            for bx in range(gx):
                ox0, oy0 = bx * HK.LD_TILE_W, by * th
                col0, row0 = 2 * ox0 - 4, 2 * oy0 - 2
                ys = [_window_index(row0 + r, h, circular) for r in range(rows)]
                if plan["vec_gray"]:
                    assert w % 4 == 0 and col0 % 4 == 0
                    xs = [4 * _window_index(col0 // 4 + k // 4, w // 4) + k % 4
                          for k in range(span)]
                else:
                    xs = [_window_index(col0 + k, w) for k in range(span)]
                assert 0 <= min(ys) and max(ys) < h and 0 <= min(xs) and max(xs) < w
                win = img[z][np.ix_(ys, xs)]
                for ty in range(th):
                    oy = oy0 + ty
                    if oy >= h // 2:
                        continue
                    v = blur5(*(win[2 * ty + d] for d in range(5)))
                    n = min(HK.LD_TILE_W, w // 2 - ox0)
                    taps = [v[2 + d : 2 + d + 2 * n : 2] for d in range(5)]
                    out[z, oy, ox0 : ox0 + n] = blur5(*taps)
                    writes[z, oy, ox0 : ox0 + n] += 1
    return out, writes


@pytest.mark.parametrize("circular", [False, True], ids=["edge", "circular"])
@pytest.mark.parametrize("shape", TRANSITION_SHAPES[1:] + AWKWARD, ids=str)
def test_level_down_plan_and_window_give_the_plain_result(rng, shape, circular):
    """The plan's tiles write every output exactly once, every staged index
    lies inside the image, and the tile algorithm on those windows is the
    plain version bit for bit; with 16-byte chunks and with the 4-byte
    loader."""
    img = _image(rng, (2, *shape))
    ref = HK.fused_pyr_down_plain(torch.from_numpy(img), circular).numpy()
    for aligned in (True, False):
        out, writes = _emulate_blur_launch(img, circular, aligned)
        assert (writes == 1).all()
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("shape", TRANSITION_SHAPES + AWKWARD, ids=str)
@pytest.mark.parametrize("b", [1, 4])
def test_level_down_plan_grid(shape, b):
    """The grid covers the outputs of the B gray and B depth channels, and a
    width or pointer that does not allow 16-byte accesses takes the 4-byte
    loader."""
    h, w = shape
    plan = HK.level_down_plan(b, b, h, w)
    gx, gy, gz = plan["grid"]
    th = HK.LD_TILE_H
    assert gz == 2 * b
    assert (gx - 1) * HK.LD_TILE_W < w // 2 <= gx * HK.LD_TILE_W
    assert (gy - 1) * th < h // 2 <= gy * th
    assert plan["vec_gray"] == plan["vec_depth"] == (w % 4 == 0)
    off = HK.level_down_plan(b, b, h, w, gray_aligned=False, depth_aligned=False)
    assert not off["vec_gray"] and not off["vec_depth"]
    assert HK.level_down_plan(b, 0, h, w)["grid"][2] == b
    with pytest.raises(ValueError):
        HK.level_down_plan(b, b, h + 1, w)
