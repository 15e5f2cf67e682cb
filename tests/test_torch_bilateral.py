"""The bilateral depth filter in both packages: `ops/bilateral.py`'s
`bilateral_depth` and `_bilateral_pass`, on depth with holes, steps and
noise, at the cloud stage's sigmas and a narrower window."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rgbd360_tpu.ops import bilateral as JB
from rgbd360_tpu_torch.ops import bilateral as TB

from test_torch_segmentation import one_torch_thread  # noqa: F401

# XLA's exp and its fused multiply-adds round differently from PyTorch's
# over the 2 x 40 taps: measured within 5.4e-7 relative (a few ulps).
RTOL = 2e-6


def _depth(rng, shape):
    """Piecewise-planar depth (2-6 m) with steps, 1 mm noise, ~10% holes
    (zeros) and a few negative (invalid) values."""
    *lead, h, w = shape
    rows = np.arange(h)[:, None] / h
    cols = np.arange(w)[None, :] / w
    d = np.where(cols < 0.4, 2.0 + rows, np.where(cols < 0.7, 4.0 + 0.5 * cols, 6.0 - rows))
    d = np.broadcast_to(d, shape) + rng.normal(0.0, 1e-3, shape)
    d = np.where(rng.uniform(size=shape) < 0.1, 0.0, d)
    d = np.where(rng.uniform(size=shape) < 0.01, -1.0, d)
    return d.astype(np.float32)


@pytest.mark.parametrize("shape,sigma_s,sigma_r", [
    ((2, 30, 40), 10.0, 0.05),  # the cloud stage's sigmas on a sensor stack
    ((48, 64), 3.0, 0.1),
])
def test_bilateral_depth_matches_reference(rng, shape, sigma_s, sigma_r):
    d = _depth(rng, shape)
    ref = np.asarray(JB.bilateral_depth(jnp.asarray(d), sigma_s=sigma_s, sigma_r=sigma_r))
    got = TB.bilateral_depth(torch.from_numpy(d), sigma_s=sigma_s, sigma_r=sigma_r).numpy()
    invalid = d <= 0
    np.testing.assert_array_equal(got[invalid], d[invalid])  # pass through untouched
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)
    # edge-preserving: the filtered steps stay steps
    assert np.abs(got - d)[~invalid].max() < 0.05


@pytest.mark.parametrize("axis", [-1, -2])
def test_bilateral_pass_matches_reference(rng, axis):
    d = _depth(rng, (40, 56))
    valid = d > 0
    d0 = np.where(valid, d, 0.0).astype(np.float32)
    ref = jax.jit(lambda x, v: JB._bilateral_pass(x, v, 10.0, 0.05, axis))(
        jnp.asarray(d0), jnp.asarray(valid))
    got = TB._bilateral_pass(torch.from_numpy(d0), torch.from_numpy(valid), 10.0, 0.05, axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=0)
