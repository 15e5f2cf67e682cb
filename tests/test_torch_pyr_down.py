"""K2 (`fused_pyr_down`): the port's plain version against the TPU kernel
(Pallas, interpret mode on the CPU) and its circular-row form against the
reference's pyrDown; the wrapper's checks.  The CUDA kernel itself is held
against the plain version in tests/test_torch_cuda.py and by chip_smoke.py,
on the card."""

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
