"""PbMap registration in both packages (`registration/planes.py`), on the
reference's own plane sets of two consecutive synthetic frames (8x60x80
rig) carried across by `convert`: the unary and binary masks and the greedy
match set equal, the closed-form pose and `register` within 1e-5."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rgbd360_tpu.config import MatcherConfig
from rgbd360_tpu.core.frame import RigFrame as JaxRig
from rgbd360_tpu.ops import segmentation as JS
from rgbd360_tpu.registration import planes as JP
from rgbd360_tpu_torch import convert, synthetic
from rgbd360_tpu_torch.ops import segmentation as TS
from rgbd360_tpu_torch.registration import planes as TP

from test_torch_segmentation import one_torch_thread  # noqa: F401

from _reference import reference_builder

MODES = [TP.DEFAULT_6DOF, TP.PLANAR_3DOF, TP.ODOMETRY_6DOF, TP.PLANAR_ODOMETRY_3DOF]
# The pose's SVD, eigh and dets of 3x3 matrices through another LAPACK
# build: measured within 1e-7 of the reference on these sets.
POSE_ATOL = 1e-5
CFG = MatcherConfig()
TCFG = convert.config_from_reference(CFG)  # the port's own dataclass


@pytest.fixture(scope="module")
def plane_sets():
    """The reference's plane sets of frames 0 and 1 (numpy), and the same
    sets in the port."""
    jb = reference_builder(synthetic.config(4, 3))
    ref = [jax.device_get(jb.build_full(JaxRig(jnp.asarray(r), jnp.asarray(d)))[2])
           for r, d in synthetic.captures(2, 4)]
    return ref, [convert.plane_set_from_numpy(p) for p in ref]


def _jax(planes) -> JS.PlaneSet:
    return JS.PlaneSet(**{f.name: jnp.asarray(getattr(planes, f.name))
                          for f in dataclasses.fields(planes)})


def test_plane_set_convert_round_trip(plane_sets):
    ref, port = plane_sets
    back = convert.plane_set_to_numpy(port[0])
    for f in dataclasses.fields(JS.PlaneSet):
        a = np.asarray(getattr(ref[0], f.name))
        assert back[f.name].dtype == a.dtype, f.name
        np.testing.assert_array_equal(back[f.name], a)
    assert port[0].valid.sum() >= 3


@pytest.mark.parametrize("mode", MODES)
def test_masks_and_matches_equal(plane_sets, mode):
    (r0, r1), (t0, t1) = plane_sets
    j0, j1 = _jax(r0), _jax(r1)
    cand_ref = JP.unary_compatibility(j0, j1, CFG, mode)
    cand = TP.unary_compatibility(t0, t1, TCFG, mode)
    np.testing.assert_array_equal(cand.numpy(), np.asarray(cand_ref))
    assert cand.any()
    np.testing.assert_array_equal(
        TP.binary_consistency(t0, t1, cand, TCFG).numpy(),
        np.asarray(JP.binary_consistency(j0, j1, cand_ref, CFG)),
    )
    pairs_ref, n_ref = jax.jit(lambda a, b: JP.match_planes(a, b, CFG, mode))(j0, j1)
    pairs, n = TP.match_planes(t0, t1, TCFG, mode)
    np.testing.assert_array_equal(pairs.numpy(), np.asarray(pairs_ref))
    assert int(n) == int(n_ref) and pairs.dtype == torch.int32


@pytest.mark.parametrize("mode", [TP.PLANAR_3DOF, TP.ODOMETRY_6DOF])
def test_pose_and_register_match_reference(plane_sets, mode):
    (r0, r1), (t0, t1) = plane_sets
    j0, j1 = _jax(r0), _jax(r1)
    pairs_ref, n_ref = jax.jit(lambda a, b: JP.match_planes(a, b, CFG, mode))(j0, j1)
    pose_ref, info_ref, obs_ref = jax.jit(JP.pose_from_matches)(j0, j1, pairs_ref, n_ref)
    pose, info, obs = TP.pose_from_matches(t0, t1, torch.from_numpy(np.array(pairs_ref)),
                                           torch.tensor(int(n_ref), dtype=torch.int32))
    np.testing.assert_allclose(pose.numpy(), np.asarray(pose_ref), atol=POSE_ATOL)
    np.testing.assert_allclose(info.numpy(), np.asarray(info_ref), rtol=1e-4, atol=POSE_ATOL)
    assert bool(obs) == bool(obs_ref)

    ref = jax.device_get(JP.PlaneRegistration(CFG).register(j0, j1, mode))
    got = TP.PlaneRegistration(TCFG).register(t0, t1, mode)
    assert bool(got.success) == bool(ref.success) and bool(got.success)
    np.testing.assert_array_equal(got.pairs.numpy(), np.asarray(ref.pairs))
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=POSE_ATOL)
    np.testing.assert_allclose(float(got.area_matched), float(ref.area_matched), rtol=1e-6)


def test_register_recovers_a_known_motion(plane_sets):
    """Frame 0's planes against themselves moved by a known yaw and shift
    (`transform_planes`): both packages recover it."""
    (r0, _), (t0, _) = plane_sets
    a = 0.1
    motion = np.eye(4, dtype=np.float32)
    motion[1:3, 1:3] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    motion[:3, 3] = [0.0, 0.05, -0.1]
    inv = np.linalg.inv(motion).astype(np.float32)
    moved = TS.transform_planes(t0, torch.from_numpy(inv))
    got = TP.PlaneRegistration(TCFG).register(t0, moved, TP.PLANAR_3DOF)
    ref = JP.PlaneRegistration(CFG).register(_jax(r0), JS.transform_planes(_jax(r0), jnp.asarray(inv)),
                                             TP.PLANAR_3DOF)
    assert bool(got.success) and bool(ref.success)
    np.testing.assert_allclose(got.pose.numpy(), motion, atol=1e-4)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=POSE_ATOL)
