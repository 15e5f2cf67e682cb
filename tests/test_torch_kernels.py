"""K1 (`fused_gradients`): the port's plain version against the TPU
kernel (Pallas, interpret mode on the CPU) and the reference's plain form,
bit for bit.  The CUDA kernel itself is held against the plain version in
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
