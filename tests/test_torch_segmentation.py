"""Plane segmentation in both packages (`ops/segmentation.py`): the banded
box filter, the connected-component scans, the hue bins, the top-k ties,
the per-sensor segmentation, `transform_planes` and the cross-sensor merge.
Plane sets are compared as sets (matched by nearest centre): near-equal
areas may order the compacted slots differently."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rgbd360_tpu.config import SegmentationConfig
from rgbd360_tpu.ops import segmentation as JS
from rgbd360_tpu_torch import convert
from rgbd360_tpu_torch.ops import segmentation as TS

from test_planes import _box_scene

# Normals, centres and areas through the moments' one-hot matmuls and the
# 3x3 eigh (another LAPACK build, another summation order).  The covariance
# is E[p p^T] - c c^T in f32, which cancels: on the box scene's noise-free
# planes the normals' off-axis components (~1e-5) are rounding, and the two
# packages' differ by up to 2.4e-5 (measured); centres agree to ~1e-6.  The
# area also moves with the free sign of the in-plane eigenvectors (it picks
# the hull's traversal direction).
PLANE_ATOL = 1e-4
AREA_RTOL = 1e-5
CFG = SegmentationConfig(min_area=0.1)
TCFG = convert.config_from_reference(CFG)  # the port's own dataclass


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's eager PyTorch calls, restored
    after it.  The suite runs files in parallel workers, and PyTorch's
    thread pool on every worker would oversubscribe the cores on these
    small tensors (measured: the same port run 1.3 s alone, ~40 s inside
    the parallel suite)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(planes) -> dict:
    return {f.name: np.asarray(getattr(planes, f.name)) for f in dataclasses.fields(planes)}


def assert_plane_sets_match(got: dict, ref: dict, atol=PLANE_ATOL, area_rtol=AREA_RTOL):
    """Same number of valid planes; each reference plane's nearest port
    plane (by centre) agrees in normal, centre, offset, inliers, area and
    hull (as a point set)."""
    gv, rv = got["valid"].astype(bool), ref["valid"].astype(bool)
    assert gv.sum() == rv.sum(), (gv.sum(), rv.sum())
    if rv.sum() == 0:
        return
    gc, rc = got["center"][gv], ref["center"][rv]
    near = np.argmin(np.linalg.norm(rc[:, None] - gc[None], axis=-1), axis=1)
    assert len(set(near.tolist())) == len(near), "two reference planes matched one"
    for k, tol in (("normal", atol), ("center", atol), ("d", atol)):
        np.testing.assert_allclose(got[k][gv][near], ref[k][rv], atol=tol, err_msg=k)
    np.testing.assert_allclose(got["n_inliers"][gv][near], ref["n_inliers"][rv], rtol=1e-6)
    np.testing.assert_allclose(got["area"][gv][near], ref["area"][rv], rtol=area_rtol)
    gh, rh = got["hull"][gv][near], ref["hull"][rv]
    # hulls as point sets: each reference vertex lies on the port's closed
    # polygon.  (Not vertex for vertex: along a straight region edge the
    # extreme point of a direction is a tie among the edge's pixels, and an
    # ulp in the in-plane basis picks another one.)
    a, b = gh, np.roll(gh, -1, axis=1)  # (P, R, 3) edges a -> b
    ab = b - a
    t = np.einsum("prk,pqrk->pqr", ab, rh[:, :, None] - a[:, None]) / np.maximum(
        np.sum(ab * ab, -1), 1e-12)[:, None]
    foot = a[:, None] + np.clip(t, 0, 1)[..., None] * ab[:, None]
    d = np.linalg.norm(rh[:, :, None] - foot, axis=-1).min(axis=2)
    assert d.max() < 1e-4, d.max()


@pytest.mark.parametrize("n,k", [(30, 8), (40, 8), (120, 8), (7, 3), (16, 1)])
def test_box_band_bit_equal(n, k):
    np.testing.assert_array_equal(TS._box_band(n, k), JS._box_band(n, k))


def test_box_blur_and_normals_match_reference():
    xyz, _, valid = _box_scene()
    x = np.moveaxis(np.asarray(xyz), -1, 0)
    np.testing.assert_allclose(
        TS._box_blur(_t(x), 8).numpy(), np.asarray(JS._box_blur(jnp.asarray(x), 8)),
        rtol=1e-6, atol=1e-6,
    )
    ref = np.asarray(JS.estimate_normals(xyz, valid))
    got = TS.estimate_normals(_t(xyz), _t(valid)).numpy()
    # where the smoothed tangents nearly cancel (the box's edges) the cross
    # product's ulps are amplified: measured 1.5e-5, elsewhere ~1e-7
    np.testing.assert_allclose(got, ref, atol=5e-5)


def _compat(rng, lead, h, w, p):
    return (rng.uniform(size=(*lead, h - 1, w)) < p, rng.uniform(size=(*lead, h, w - 1)) < p)


@pytest.mark.parametrize("p", [0.5, 0.9, 0.97])
def test_connected_labels_bit_equal(rng, p):
    """Both scan directions and the alternation schedule, on seeded compat
    masks (sparse to nearly fully connected), one sensor stack in one call."""
    h, w = 30, 40
    cr, cc = _compat(rng, (3,), h, w, p)
    valid = np.ones((h, w), bool)
    got = TS._connected_labels(_t(cr), _t(cc), _t(np.ones((3, h, w), bool)), 24)
    ref = jax.jit(jax.vmap(lambda r, c: JS._connected_labels(r, c, jnp.asarray(valid), 24)))(
        jnp.asarray(cr), jnp.asarray(cc))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.dtype == torch.int32


@pytest.mark.parametrize("axis", [0, 1])
def test_seg_min_scan_bit_equal(rng, axis):
    h, w = 24, 33
    lab = rng.permutation(h * w).reshape(h, w).astype(np.int32)
    rf, rb = rng.uniform(size=(2, h, w)) < 0.3
    ref = JS._seg_min_scan(jnp.asarray(lab), jnp.asarray(rf), jnp.asarray(rb), axis)
    got = TS._seg_min_scan(_t(lab), _t(rf), _t(rb), axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_hue_bins_exact(rng):
    """Every hue branch, including negative g - b (floor-mod wraps it into
    bins 30-35) and the gray bin."""
    rgb = rng.integers(0, 256, (4000, 3)).astype(np.float32)
    rgb[:50] = [10.0, 5.0, 200.0]  # max = r, g - b < 0
    rgb[50:100] = [30.0, 30.0, 30.0]  # gray
    ref = np.asarray(JS._rgb_to_hue_hist(jnp.asarray(rgb), None, 16))
    got = TS._rgb_to_hue_hist(_t(rgb)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[:50] >= 30).all() and (got[:50] <= 35).all()
    assert set(range(37)) <= set(got.tolist())


def test_top_k_ties_lower_index_first(rng):
    """Integer counts with many ties: the port's ranks are `lax.top_k`'s."""
    counts = rng.integers(0, 5, (3, 200)).astype(np.float32)
    _, ref = jax.lax.top_k(jnp.asarray(counts), 16)
    np.testing.assert_array_equal(TS._top_indices(_t(counts), 16).numpy(), np.asarray(ref))


def test_compact_top_ties(rng):
    """`_compact_top` with equal areas and many invalid slots (all scoring
    -1), and with padding to a larger capacity."""
    k = 12
    ps = dict(
        normal=rng.normal(size=(k, 3)), center=rng.normal(size=(k, 3)), d=rng.normal(size=k),
        curvature=rng.uniform(size=k), area=np.repeat([2.0, 1.0, 3.0], 4),
        elongation=rng.uniform(size=k), n_inliers=rng.uniform(size=k),
        hull=rng.normal(size=(k, 4, 3)), hue_hist=rng.uniform(size=(k, 37)),
        main_color=rng.uniform(size=(k, 3)), valid=rng.uniform(size=k) < 0.6,
    )
    ps = {a: (v.astype(np.float32) if v.dtype != bool else v) for a, v in ps.items()}
    for k_out in (8, 16):
        ref = JS._compact_top(JS.PlaneSet(**{a: jnp.asarray(v) for a, v in ps.items()}), k_out)
        got = TS._compact_top(convert.plane_set_from_numpy(ps), k_out)
        for name, v in _np(ref).items():
            np.testing.assert_array_equal(getattr(got, name).numpy(), v, err_msg=name)


@pytest.fixture(scope="module")
def box_sensors():
    """Two sensors: the box scene, and the same scene seen from a camera
    moved along x (so their plane sets differ); (xyz, rgb, valid) stacks."""
    xyz, rgb, valid = (np.asarray(a) for a in _box_scene())
    xyz2 = xyz + np.float32([0.2, 0.0, 0.0])
    return np.stack([xyz, xyz2]), np.stack([rgb, rgb]), np.stack([valid, valid])


@pytest.fixture(scope="module")
def box_ref(box_sensors):
    """The reference's per-sensor plane sets of `box_sensors` (vmapped, as
    `FrameBuilder.segment_planes` runs them), on the host."""
    seg = jax.jit(jax.vmap(lambda x, c, v: JS.segment_planes_sensor(x, c, v, CFG)))
    return jax.device_get(seg(*(jnp.asarray(a) for a in box_sensors)))


def test_segment_planes_sensor_matches_reference(box_sensors, box_ref):
    """One batched call over the sensors, each against the reference's
    per-sensor segmentation."""
    xyz, rgb, valid = box_sensors
    got = TS.segment_planes_sensor(_t(xyz), _t(rgb), _t(valid), TCFG)
    assert got.normal.shape == (2, TCFG.max_planes_sensor, 3)
    assert got.hull.shape == (2, TCFG.max_planes_sensor, TCFG.hull_dirs, 3)
    for s in range(2):
        ref = {k: v[s] for k, v in _np(box_ref).items()}
        assert ref["valid"].sum() >= 3
        assert_plane_sets_match({k: v[s] for k, v in _np(got).items()}, ref)
        np.testing.assert_allclose(got.hue_hist[s].numpy()[ref["valid"]].sum(-1), 1.0, rtol=1e-6)


def test_transform_and_merge_match_reference(box_sensors, box_ref):
    """Per-sensor sets moved into the rig frame (one batched
    `transform_planes`) and merged: the two sensors see the same room, so
    their planes merge pairwise."""
    xyz, rgb, valid = box_sensors
    c, s = np.cos(0.3), np.sin(0.3)
    rt = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    rt[0, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    rt[0, :3, 3] = [0.1, -0.2, 0.3]
    rt[1] = rt[0]
    rt[1, :3, 3] -= rt[0, :3, :3] @ np.float32([0.2, 0.0, 0.0])  # undo the shift
    per = TS.segment_planes_sensor(_t(xyz), _t(rgb), _t(valid), TCFG)
    moved = TS.transform_planes(per, _t(rt))
    merged = TS.merge_plane_sets(TS.concat_sets(moved), TCFG)
    assert merged.valid.shape == (TCFG.max_planes,)

    ref_sets = []
    for k in range(2):
        one = JS.PlaneSet(**{n: jnp.asarray(v[k]) for n, v in _np(box_ref).items()})
        ref_sets.append(JS.transform_planes(one, jnp.asarray(rt[k])))
        assert_plane_sets_match({n: v[k] for n, v in _np(moved).items()}, _np(ref_sets[-1]))
    ref = _np(jax.jit(lambda sets: JS.merge_plane_sets(sets, CFG))(ref_sets))
    got = _np(merged)
    assert_plane_sets_match(got, ref)
    # merging halved the count: every wall seen by both sensors became one
    assert ref["valid"].sum() * 2 == sum(int(s.valid.sum()) for s in ref_sets)


def test_vertical_planes_mask(box_ref):
    ref = JS.PlaneSet(**{n: jnp.asarray(v[0]) for n, v in _np(box_ref).items()})
    got = convert.plane_set_from_numpy(jax.device_get(ref))
    np.testing.assert_array_equal(
        TS.vertical_planes_mask(got).numpy(), np.asarray(JS.vertical_planes_mask(ref))
    )
