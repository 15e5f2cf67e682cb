"""The port's CUDA kernels against their plain versions, on the card.

This file imports torch only, so it also runs on a machine without jax:

    RGBD360_TEST_TPU=1 python -m pytest -p no:cacheprovider tests/test_torch_cuda.py

(`RGBD360_TEST_TPU=1` keeps tests/conftest.py from setting up jax.)  Where
`torch.cuda.is_available()` is False every test skips with its reason.
"""

import numpy as np
import pytest
import torch

from rgbd360_tpu_torch.ops import hopper_kernels as HK


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")


def _plateau_image(rng, shape):
    x = rng.uniform(0.0, 4.0, shape)
    x = np.where(rng.uniform(size=shape) < 0.3, np.round(x), x)
    x = np.where(rng.uniform(size=shape) < 0.1, 0.0, x)
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 320, 1920), (8, 20, 120), (1, 3, 5)])
def test_fused_gradients_kernel_matches_plain(cuda, shape):
    x = _plateau_image(np.random.default_rng(0), shape).cuda()
    before = HK.fused_gradients.launches
    gx, gy = HK.fused_gradients(x)
    px, py = HK.fused_gradients_plain(x)
    torch.cuda.synchronize()
    assert HK.fused_gradients.launches == before + 1
    assert torch.equal(gx, px) and torch.equal(gy, py)


@pytest.mark.cuda
def test_fused_gradients_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((2, 8, 8), device="cuda")
    with pytest.raises(TypeError):
        HK.fused_gradients(x.double())
    with pytest.raises(ValueError):
        HK.fused_gradients(x[:, :, ::2])
    with pytest.raises(ValueError):
        HK.fused_gradients(x[0])


@pytest.mark.cuda
@pytest.mark.parametrize("circular", [False, True], ids=["edge", "circular"])
@pytest.mark.parametrize("shape", [(4, 320, 1920), (1, 40, 240), (2, 6, 8)])
def test_fused_pyr_down_kernel_matches_plain(cuda, shape, circular):
    x = _plateau_image(np.random.default_rng(1), shape).cuda()
    kernel = HK.fused_pyr_down_circular if circular else HK.fused_pyr_down
    before = HK.fused_pyr_down.launches
    out = kernel(x)
    ref = HK.fused_pyr_down_plain(x, circular)
    torch.cuda.synchronize()
    assert HK.fused_pyr_down.launches == before + 1
    assert out.shape == (shape[0], shape[1] // 2, shape[2] // 2)
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_fused_pyr_down_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((2, 8, 8), device="cuda")
    with pytest.raises(TypeError):
        HK.fused_pyr_down(x.double())
    with pytest.raises(ValueError):
        HK.fused_pyr_down(torch.zeros((2, 8, 16), device="cuda")[:, :, ::2])
    with pytest.raises(ValueError):
        HK.fused_pyr_down_circular(torch.zeros((2, 7, 8), device="cuda"))
    with pytest.raises(ValueError):
        HK.fused_pyr_down(x[0])
