"""Parity of the port's projective ICP (`registration/icp.py`) with the
reference: the closed-form 3x3 inverse, the organized normals, and each
variant's whole coarse-to-fine solve (point-to-point, point-to-plane,
GICP) over 4-level depth pyramids, as the apps build them.  Scenes: the
reference tests' exact box room on the sphere (a copy of
`tests/test_dense.py`'s renderer) seen from two viewpoints, and the
flagship pair's sinusoidal depth, at 80x480 and 64x384.

Tolerances.  `_inv3_sym`: a few ulps (XLA fuses multiply-adds that
PyTorch's CPU kernels round separately; the adjugate's differences of
products cancel, so the bound is relative to the largest entry of each
result, 8 ulps).  `_target_normals`: 1e-5 (measured 4.7e-6): the points
come from sin/cos that differ by an ulp between the libraries, and the
normal is a cross product of central differences of points ~3 m away
spaced a few cm apart, which grows an ulp of the points ~100x.  The solves: the loop has a fixed
iteration count and no accept test, so only the sums' order and the
warp's rounding of coordinates that differ by ulps separate the packages:
poses within 1e-5 m / rad, the correspondence count within 0.05%, the rms
and the Hessian within 1e-3 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rgbd360_tpu.config import DenseRegConfig
from rgbd360_tpu.ops import pyramid as jpyr
from rgbd360_tpu.registration import icp as JI
from rgbd360_tpu_torch import convert
from rgbd360_tpu_torch.ops import pyramid as tpyr
from rgbd360_tpu_torch.registration import icp as TI

from __graft_entry__ import _synthetic_pair
from test_torch_dense_options import _box_room_sphere

ULP = float(np.finfo(np.float32).eps)
CFG = DenseRegConfig()
TCFG = convert.config_from_reference(CFG)
POSE_ATOL = 1e-5
NORMAL_ATOL = 1e-5
# half extents (vertical first): the reference's room (3.0, 1.4, 4.0)
# hides its floor from the +-30 degrees of an 80x480 sphere, and the ICP
# then slides along the vertical (measured 5.4 mm apart, point-to-plane)
ROOM = (1.0, 1.6, 2.5)


def _pose_gap(a, b) -> tuple[float, float]:
    """(m, rad) between two poses; the angle from the chord |Ra - Rb|_F =
    2 sqrt(2) sin(angle / 2), which keeps its precision near 0 (an arccos
    of the trace does not)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    chord = np.linalg.norm(a[:3, :3] - b[:3, :3]) / (2 * np.sqrt(2))
    return float(np.linalg.norm(a[:3, 3] - b[:3, 3])), float(2 * np.arcsin(min(chord, 1.0)))


@pytest.fixture(scope="module")
def depths():
    """Spherical depths: a box room low enough that its floor and ceiling
    are in view (every direction observed), from the origin and from a
    displaced viewpoint, and the bumpy pair."""
    _, d0 = _box_room_sphere(80, 480, np.zeros(3), ROOM)
    _, d1 = _box_room_sphere(80, 480, np.array([0.07, -0.02, 0.05]), ROOM)
    _, b0, _, b1 = _synthetic_pair(64, 384)
    return {"room": (d1, d0), "bumpy": (np.asarray(b1), np.asarray(b0))}


def test_inv3_sym_within_ulps(rng):
    """Random symmetric matrices, GICP's own S = 2I - k(nn^T + mm^T) with
    unit normals, and ones with tiny and negative determinants (clamped to
    1e-12 exactly as the reference's)."""
    a = rng.normal(size=(400, 3, 3)).astype(np.float32)
    s = a + np.swapaxes(a, -1, -2)
    n = rng.normal(size=(400, 2, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    k = np.float32(1 - JI.GICP_EPSILON)
    g = (2 * np.eye(3, dtype=np.float32) - k * n[:, 0, :, None] * n[:, 0, None, :]
         - k * n[:, 1, :, None] * n[:, 1, None, :])
    tiny = np.tile(np.diag([1e-5, 1e-4, 1.0]).astype(np.float32), (4, 1, 1))
    tiny[2:, 0, 0] = -1e-5  # negative determinant
    for m in (s, g, tiny):
        ref = np.asarray(JI._inv3_sym(jnp.asarray(m)))
        got = TI._inv3_sym(torch.from_numpy(m)).numpy()
        scale = np.abs(ref).max(axis=(-2, -1), keepdims=True)
        assert (np.abs(got - ref) <= 8 * ULP * scale).all(), np.abs(got - ref).max()
    assert np.isfinite(TI._inv3_sym(torch.from_numpy(tiny)).numpy()).all()


@pytest.mark.parametrize("scene", ["room", "bumpy"])
def test_target_normals_within_ulps(depths, scene):
    """Organized normals (both axes wrap, rows too): unit or zero vectors,
    within a few ulps of the reference's, and zero at the same pixels."""
    d = depths[scene][0]
    ref = np.asarray(JI._target_normals(jnp.asarray(d)))
    got = TI._target_normals(torch.tensor(d)).numpy()
    np.testing.assert_array_equal(np.abs(got).sum(-1) == 0, np.abs(ref).sum(-1) == 0)
    assert np.abs(got - ref).max() <= NORMAL_ATOL, np.abs(got - ref).max()


@pytest.mark.parametrize("scene", ["room", "bumpy"])
@pytest.mark.parametrize("variant", [JI.POINT_TO_POINT, JI.POINT_TO_PLANE, JI.GICP])
def test_icp_variant_matches_reference(depths, scene, variant):
    """`ICPAligner(variant).align(src_pyr, trg_pyr)` from identity over
    4-level depth pyramids: pose, Hessian, rms and correspondence count."""
    src, trg = depths[scene]
    jp = [tuple(jpyr.build_depth_pyramid(jnp.asarray(x), 4)) for x in (src, trg)]
    tp = [tpyr.build_depth_pyramid(torch.tensor(x), 4) for x in (src, trg)]
    pj, hj, ej, nj = JI.ICPAligner(CFG, variant=variant).align(*jp)
    pt, ht, et, nt = TI.ICPAligner(TCFG, variant=variant).align(*tp)
    dt, dr = _pose_gap(pt.numpy(), np.asarray(pj))
    assert dt <= POSE_ATOL and dr <= POSE_ATOL, (dt, dr)
    assert abs(float(nt) - float(nj)) <= 5e-4 * float(nj), (float(nt), float(nj))
    np.testing.assert_allclose(float(et), float(ej), rtol=1e-3)
    hj = np.asarray(hj)
    assert np.abs(ht.numpy() - hj).max() <= 1e-3 * np.abs(hj).max()
    assert float(nt) > 1000
