"""The leading keyframe axis through `registration/planes.py`: the batched
matcher and pose against a loop over the unbatched functions and against
the reference's `vmap` (the loop closer's `_batch_match_impl` and the
relocaliser's `_batch_impl`), on the plane sets of synthetic frames at
`synthetic.config(4, 3)` stacked into a map of 6 keyframes (one of them
empty, one a shuffled copy).

Tolerances.  Matches and counts are integers and must be equal.  A batched
pose goes through the same steps as its unbatched twin, but its small
products run as batched matrix products, so sums may round differently:
1e-5 m / 1e-5 rad against the loop and against the reference (measured
4e-7), information matrices 1e-4 relative to their largest entry.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd360_tpu_torch import convert, synthetic
from rgbd360_tpu_torch.core.frame import FrameBuilder, RigFrame
from rgbd360_tpu_torch.ops.segmentation import PlaneSet
from rgbd360_tpu_torch.registration import planes as TP

from test_torch_segmentation import one_torch_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SUB, LEVELS = 4, 3
POSE_TOL = 1e-5


def _stack(sets) -> PlaneSet:
    return PlaneSet(**{
        f.name: torch.stack([getattr(p, f.name) for p in sets]) for f in dataclasses.fields(PlaneSet)
    })


def _index(planes: PlaneSet, i) -> PlaneSet:
    return PlaneSet(**{f.name: getattr(planes, f.name)[i] for f in dataclasses.fields(PlaneSet)})


@pytest.fixture(scope="module")
def plane_sets():
    """(map planes with a leading axis of 6, query planes)."""
    cfg = synthetic.config(SUB, LEVELS)
    builder = FrameBuilder(synthetic.calibration(cfg.rig), cfg, device="cpu")
    sets = [
        builder.build_full(RigFrame.from_raw(raw, "cpu"))[2]
        for raw in chip_smoke.loop_raws(16, SUB, frames=[0, 1, 2, 15, 8])
    ]
    query = sets.pop(1)
    perm = torch.randperm(query.d.shape[0], generator=torch.Generator().manual_seed(0))
    empty = PlaneSet(**{f.name: torch.zeros_like(getattr(query, f.name))
                        for f in dataclasses.fields(PlaneSet)})
    sets += [_index(sets[0], perm), empty]
    assert sum(int(p.valid.sum()) for p in sets) > 20
    return _stack(sets), query


def _jax_sets(map_planes, query):
    from rgbd360_tpu.ops.segmentation import PlaneSet as JPlaneSet

    to = lambda p: JPlaneSet(**{k: jnp.asarray(v) for k, v in convert.plane_set_to_numpy(p).items()})  # noqa: E731
    return to(map_planes), to(query)


def test_batched_masks_equal_the_loop(plane_sets):
    map_planes, query = plane_sets
    cfg = synthetic.config(SUB, LEVELS).matcher
    for mode in (TP.PLANAR_3DOF, TP.ODOMETRY_6DOF):
        cand = TP.unary_compatibility(map_planes, query, cfg, mode)
        cons = TP.binary_consistency(map_planes, query, cand, cfg)
        for i in range(cand.shape[0]):
            one = _index(map_planes, i)
            c1 = TP.unary_compatibility(one, query, cfg, mode)
            assert torch.equal(cand[i], c1)
            assert torch.equal(cons[i], TP.binary_consistency(one, query, c1, cfg))
    assert cand.shape == (6, 32, 32) and cons.shape == (6, 32, 32, 32, 32)


def test_batched_matcher_equals_loop_and_vmap(plane_sets):
    map_planes, query = plane_sets
    cfg = synthetic.config(SUB, LEVELS).matcher
    pairs, n = TP.match_planes(map_planes, query, cfg, TP.PLANAR_3DOF)
    pose, info, obs = TP.pose_from_matches(map_planes, query, pairs, n)
    assert int(n.max()) >= 5 and int(n[-1]) == 0
    for i in range(pairs.shape[0]):
        one = _index(map_planes, i)
        p1, n1 = TP.match_planes(one, query, cfg, TP.PLANAR_3DOF)
        assert torch.equal(pairs[i], p1) and int(n[i]) == int(n1)
        pose1, info1, obs1 = TP.pose_from_matches(one, query, p1, n1)
        dt, dr = chip_smoke._pose_gaps(pose[i : i + 1].numpy(), pose1[None].numpy())
        assert dt < POSE_TOL and dr < POSE_TOL, (i, dt, dr)
        np.testing.assert_allclose(info[i].numpy(), info1.numpy(),
                                   atol=1e-4 * max(1.0, float(info1.abs().max())))
        assert bool(obs[i]) == bool(obs1)

    # the reference's vmap over the same stacked sets
    from rgbd360_tpu import config as jconfig
    from rgbd360_tpu.registration import planes as JP

    jmap, jquery = _jax_sets(map_planes, query)
    jcfg = convert.config_to_reference(cfg, jconfig)

    def one(kf_planes):
        jp, jn = JP.match_planes(kf_planes, jquery, jcfg, JP.PLANAR_3DOF)
        return (jp, jn) + JP.pose_from_matches(kf_planes, jquery, jp, jn)

    jp, jn, jpose, jinfo, jobs = jax.device_get(jax.jit(jax.vmap(one))(jmap))
    np.testing.assert_array_equal(pairs.numpy(), jp)
    np.testing.assert_array_equal(n.numpy(), jn)
    np.testing.assert_array_equal(obs.numpy(), jobs)
    dt, dr = chip_smoke._pose_gaps(pose.numpy(), jpose)
    assert dt < POSE_TOL and dr < POSE_TOL, (dt, dr)
    np.testing.assert_allclose(info.numpy(), jinfo, atol=1e-4 * float(np.abs(jinfo).max()))


def test_both_sides_batched_and_register(plane_sets):
    """A batch on both sides (each keyframe against its own query) and
    `register` with a leading axis: element i is the unbatched call."""
    map_planes, query = plane_sets
    reg = TP.PlaneRegistration(synthetic.config(SUB, LEVELS).matcher)
    queries = _stack([query, _index(map_planes, 0)] * 3)
    res = reg.register(map_planes, queries)
    for i in range(6):
        one = reg.register(_index(map_planes, i), _index(queries, i))
        assert torch.equal(res.pairs[i], one.pairs)
        assert bool(res.success[i]) == bool(one.success)
        dt, dr = chip_smoke._pose_gaps(res.pose[i : i + 1].numpy(), one.pose[None].numpy())
        assert dt < POSE_TOL and dr < POSE_TOL
        np.testing.assert_allclose(float(res.area_matched[i]), float(one.area_matched), rtol=1e-6)
    assert bool(res.success[1])  # a frame against itself
    assert not bool(res.success[-1]) and torch.equal(res.pose[-1], torch.eye(4))


def test_match_against_keyframes_equals_the_reference_scans(plane_sets):
    """The scan both the loop closer and the relocaliser run."""
    from rgbd360_tpu import config as jconfig
    from rgbd360_tpu.slam.loop_closure import LoopCloser
    from rgbd360_tpu.slam.relocalizer import Relocalizer

    map_planes, query = plane_sets
    cfg = synthetic.config(SUB, LEVELS)
    jcfg = convert.config_to_reference(cfg, jconfig)
    gate = np.array([True, True, False, True, True, True])
    jmap, jquery = _jax_sets(map_planes, query)
    got = TP.match_against_keyframes(map_planes, query, torch.from_numpy(gate), cfg.matcher)
    for ref in (
        jax.device_get(LoopCloser(jcfg)._batch_match(jquery, jmap, jnp.asarray(gate))),
        jax.device_get(Relocalizer(jcfg)._batch(jmap, jquery, jnp.asarray(gate))),
    ):
        np.testing.assert_array_equal(got[0].numpy(), ref[0])
        np.testing.assert_allclose(got[1].numpy(), ref[1], rtol=1e-6)
        dt, dr = chip_smoke._pose_gaps(got[2].numpy(), ref[2])
        assert dt < POSE_TOL and dr < POSE_TOL, (dt, dr)
        np.testing.assert_array_equal(got[4].numpy(), ref[4])
    assert int(got[0][2]) == 0 and not bool(got[4][2])  # gated off


def test_non_finite_padded_slots_poison_nothing(plane_sets):
    """A padded (invalid) plane slot may hold anything, non-finite values
    included (a degenerate slot's eigendecomposition on the card): neither
    the cross-sensor merge nor the matcher's votes may let it reach a valid
    plane.  (`False * nan` is nan, and one nan in a matrix product's operand
    reaches every row: both take a select instead of a product.)"""
    from rgbd360_tpu_torch.ops import segmentation as seg_ops

    map_planes, query = plane_sets
    cfg = synthetic.config(SUB, LEVELS)
    one = _index(map_planes, 0)
    assert int((~one.valid).sum()) > 0

    def poisoned(p):
        bad = {}
        for f in dataclasses.fields(PlaneSet):
            a = getattr(p, f.name)
            if a.dtype == torch.bool:
                bad[f.name] = a
            else:
                pad = (~p.valid).reshape(p.valid.shape + (1,) * (a.ndim - p.valid.ndim))
                bad[f.name] = torch.where(pad, torch.nan, a)
        return PlaneSet(**bad)

    pairs, n = TP.match_planes(one, query, cfg.matcher, TP.PLANAR_3DOF)
    for ref, trg in ((poisoned(one), query), (one, poisoned(query)), (poisoned(one), poisoned(query))):
        p2, n2 = TP.match_planes(ref, trg, cfg.matcher, TP.PLANAR_3DOF)
        assert int(n2) == int(n) >= 5 and torch.equal(p2, pairs)
    res, res_bad = (TP.PlaneRegistration(cfg.matcher).register(r, query) for r in (one, poisoned(one)))
    assert bool(res_bad.success) and torch.equal(res.pose, res_bad.pose)

    merged, merged_bad = (seg_ops.merge_plane_sets(c, cfg.seg) for c in (one, poisoned(one)))
    assert torch.equal(merged.valid, merged_bad.valid) and int(merged.valid.sum()) >= 5
    for f in dataclasses.fields(PlaneSet):
        a, b = getattr(merged, f.name), getattr(merged_bad, f.name)
        assert torch.equal(a[merged.valid], b[merged.valid]), f.name


def _degenerate_cloud(h=24, w=32):
    """An organized sensor cloud (1, H, W, 3) with one planar patch and
    three isolated pixels (one-pixel segments: rank-0 scatter matrices,
    rounding noise) and nothing else valid: every other slot of the
    sensor's plane set is padding (no member, an all-zero scatter
    matrix)."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    xyz = np.stack([(xx - w / 2) * 0.02, (yy - h / 2) * 0.02, np.full((h, w), 2.0)], -1)
    valid = np.zeros((h, w), bool)
    valid[2:18, 2:28] = True  # the plane
    xyz[20, 25:27] = [[0.4, 0.3, 1.0], [0.5, 0.9, 3.0]]
    valid[20, 25:27] = True  # two pixels too far apart to join
    xyz[22, 30] = [0.1, -0.7, 1.4]
    valid[22, 30] = True
    rgb = np.full((h, w, 3), 128, np.uint8)
    return (torch.from_numpy(xyz.astype(np.float32))[None], torch.from_numpy(rgb)[None],
            torch.from_numpy(valid)[None])


def _assert_all_finite(planes: PlaneSet, what: str):
    for f in dataclasses.fields(PlaneSet):
        a = getattr(planes, f.name)
        if a.is_floating_point():
            assert torch.isfinite(a).all(), f"{what}: non-finite `{f.name}` (padding included)"


def test_degenerate_slots_are_finite(monkeypatch):
    """F2: a padded plane slot's non-finite value.  A degenerate slot's
    scatter matrix (all zero for the padding, rank 0 for a one-pixel
    segment) is where a solver's output is least defined; here `eigh` is
    made to return NaN for those (on the CPU it does not, nor did the
    card's in any probe), and the plane set must stay finite.  With
    `_slot_eigh` every field of every slot is finite, and the padding's
    eigenvectors are the identity's, as LAPACK gives the reference."""
    from rgbd360_tpu_torch.ops import segmentation as seg_ops

    cfg = synthetic.config(SUB, LEVELS).seg
    cfg = dataclasses.replace(cfg, min_inliers=20, max_planes_sensor=16)
    xyz, rgb, valid = _degenerate_cloud()
    plain = seg_ops.segment_planes_sensor(xyz, rgb, valid, cfg)
    counts = plain.n_inliers[0].tolist()
    assert int(plain.valid.sum()) == 1 and counts.count(1.0) >= 3 and counts.count(0.0) >= 1
    _assert_all_finite(plain, "CPU eigh")
    pad = plain.n_inliers[0] == 0
    np.testing.assert_array_equal(plain.normal[0][pad].numpy(),
                                  np.tile([1.0, 0.0, 0.0], (int(pad.sum()), 1)))

    eigh = torch.linalg.eigh

    def card_like_eigh(a):
        val, vec = eigh(a)
        singular = torch.linalg.matrix_norm(a) < 1e-5  # all zero, or rounding noise
        return (torch.where(singular[..., None], torch.nan, val),
                torch.where(singular[..., None, None], torch.nan, vec))

    monkeypatch.setattr(torch.linalg, "eigh", card_like_eigh)
    guarded = seg_ops.segment_planes_sensor(xyz, rgb, valid, cfg)
    _assert_all_finite(guarded, "NaN-returning eigh")
    for f in ("valid", "n_inliers"):
        assert torch.equal(getattr(guarded, f), getattr(plain, f))
    merged = seg_ops.merge_plane_sets(seg_ops.concat_sets(guarded), cfg)
    _assert_all_finite(merged, "merged")


def test_built_plane_sets_are_finite(plane_sets):
    """Every slot of every plane set the front end builds is finite."""
    map_planes, query = plane_sets
    _assert_all_finite(map_planes, "map planes")
    _assert_all_finite(query, "query planes")
