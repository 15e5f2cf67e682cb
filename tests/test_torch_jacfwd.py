"""`torch.func.jacfwd` through the port's SE(3) exponentials keeps the
input's dtype (float32) for one vector as for a batch, and matches
`jax.jacfwd` of the reference's functions.  Before the repair, a single
rotation vector of shape (3,) gave float64 tangents (its 0-dim |w|^2
combined with Python floats promoted them under jacfwd), and a (6,) twist
failed in `se3_exp`'s matrix product.  Tolerance 1e-6: the derivatives of
closed forms evaluated in float32 by both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd360_tpu.ops import se3 as JS
from rgbd360_tpu_torch.ops import se3 as TS

RNG = np.random.default_rng(7)
W = RNG.normal(0, 0.3, 3).astype(np.float32)
XI = RNG.normal(0, 0.3, 6).astype(np.float32)


@pytest.mark.parametrize("name, x", [
    ("so3_exp", W), ("so3_exp", W[None]), ("so3_exp", np.zeros(3, np.float32)),
    ("se3_exp", XI), ("se3_exp", XI[None]), ("se3_exp", np.zeros(6, np.float32)),
], ids=["so3-(3,)", "so3-(1,3)", "so3-zero", "se3-(6,)", "se3-(1,6)", "se3-zero"])
def test_jacfwd_keeps_float32_and_matches_jax(name, x):
    jt = torch.func.jacfwd(getattr(TS, name))(torch.from_numpy(x))
    assert jt.dtype == torch.float32
    jj = np.asarray(jax.jacfwd(getattr(JS, name))(jnp.asarray(x)))
    assert jt.shape == jj.shape
    np.testing.assert_allclose(jt.numpy(), jj, atol=1e-6)
