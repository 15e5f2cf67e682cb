"""`Map360` of the port against the reference's, leaf by leaf, after every
method: the leaves are compared in the order `jax.tree_util.tree_flatten`
gives (the dataclasses' fields), through `convert.map_to_numpy`.  All
leaves are held bit-equal (the updates only copy values; the gray/depth
payload is rounded to bfloat16 to nearest even by both packages).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd360_tpu import config as jconfig
from rgbd360_tpu.ops.segmentation import PlaneSet as JPlaneSet
from rgbd360_tpu.slam.map import Map360 as JMap
from rgbd360_tpu_torch import config as tconfig, convert
from rgbd360_tpu_torch.slam.map import Map360 as TMap, tree_leaves

H, W, P, R = 8, 24, 6, 8  # sphere, planes, hull directions


def empties(n=4, e=6):
    return (
        JMap.empty(jconfig.MapConfig(max_keyframes=n, max_edges=e), H, W, P, R),
        TMap.empty(tconfig.MapConfig(max_keyframes=n, max_edges=e), H, W, P, R, "cpu"),
    )


def jax_leaves(jm) -> list:
    out = []
    for x in jax.tree_util.tree_leaves(jm):
        a = np.asarray(x)
        out.append(a.astype(np.float32) if a.dtype.name == "bfloat16" else a)
    return out


def assert_same(jm, tm):
    got, ref = convert.map_to_numpy(tm), jax_leaves(jm)
    assert len(got) == len(ref) == 27
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape and a.dtype == b.dtype, (i, a.shape, b.shape, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")


def keyframe(rng):
    """(pose, gray, depth, planes as {field: array}) of one random keyframe."""
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = rng.normal(size=3)
    gray = rng.uniform(0, 255, (H, W)).astype(np.float32)
    depth = rng.uniform(0.3, 12, (H, W)).astype(np.float32)
    planes = {
        f.name: rng.uniform(0, 1, np.asarray(getattr(empties()[0].planes, f.name)).shape[1:])
        .astype(np.float32)
        for f in dataclasses.fields(JPlaneSet)
    }
    planes["valid"] = planes["valid"] > 0.5
    return pose, gray, depth, planes


def add_both(jm, tm, kf, area_id=None, n_live=None):
    pose, gray, depth, planes = kf
    jm = jm.add_keyframe(
        jnp.asarray(pose), jnp.asarray(gray), jnp.asarray(depth),
        JPlaneSet(**{k: jnp.asarray(v) for k, v in planes.items()}),
        area_id=area_id, n_live=n_live,
    )
    tm = tm.add_keyframe(
        torch.from_numpy(pose), torch.from_numpy(gray), torch.from_numpy(depth),
        convert.plane_set_from_numpy(planes), area_id=area_id, n_live=n_live,
    )
    return jm, tm


def test_empty_and_leaf_order():
    jm, tm = empties()
    assert_same(jm, tm)
    assert tm.gray.dtype == torch.bfloat16 and tm.depth.dtype == torch.bfloat16
    assert len(tree_leaves(tm)) == len(jax.tree_util.tree_leaves(jm))


def test_add_keyframe_payload_bit_equal():
    """Keyframes with and without the host count; the bfloat16 payload is
    bit-equal (round to nearest even in both)."""
    rng = np.random.default_rng(0)
    jm, tm = empties()
    jm, tm = add_both(jm, tm, keyframe(rng))
    jm, tm = add_both(jm, tm, keyframe(rng), area_id=2, n_live=1)
    assert_same(jm, tm)
    assert int(tm.n_kf) == 2
    # values that sit exactly between two bfloat16 neighbours
    ties = np.float32([1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8, 255.5, 3.00390625])
    kf = list(keyframe(rng))
    kf[1][0, :4] = ties
    kf[2][0, :4] = ties
    jm, tm = add_both(jm, tm, tuple(kf))
    assert_same(jm, tm)


def test_add_keyframe_grows_when_full():
    rng = np.random.default_rng(1)
    jm, tm = empties(n=2)
    for i in range(3):
        jm, tm = add_both(jm, tm, keyframe(rng), n_live=i)
    assert tm.kf_capacity == 4 and tm.edge_capacity == 6
    assert_same(jm, tm)


def _edges(rng, e):
    rel = np.tile(np.eye(4, dtype=np.float32), (e, 1, 1))
    rel[:, :3, 3] = rng.normal(size=(e, 3))
    info = rng.uniform(1, 2, (e, 6, 6)).astype(np.float32)
    return rel, info


def test_add_edge_and_add_edges():
    rng = np.random.default_rng(2)
    jm, tm = empties()
    for i in range(3):
        jm, tm = add_both(jm, tm, keyframe(rng), n_live=i)
    rel, info = _edges(rng, 4)
    jm = jm.add_edge(0, 1, jnp.asarray(rel[0]), jnp.asarray(info[0]), sso=0.7)
    tm = tm.add_edge(0, 1, rel[0], info[0], sso=0.7)
    jm = jm.add_edge(1, 2, jnp.asarray(rel[1]), jnp.asarray(info[1]), sso=0.5, is_loop=True, n_live=1)
    tm = tm.add_edge(1, 2, rel[1], info[1], sso=0.5, is_loop=True, n_live=1)
    assert_same(jm, tm)
    # a batch with a duplicate pair carrying one sso (the promotion slate)
    ij = np.array([[0, 2], [0, 2]], np.int32)
    ssos, lcs = np.float32([0.25, 0.25]), np.array([False, True])
    jm = jm.add_edges(jnp.asarray(ij), jnp.asarray(rel[2:]), jnp.asarray(info[2:]),
                      jnp.asarray(ssos), jnp.asarray(lcs), n_live=2)
    tm = tm.add_edges(ij, rel[2:], info[2:], ssos, lcs, n_live=2)
    assert_same(jm, tm)
    assert int(tm.n_edges) == 4
    # an empty batch changes nothing
    assert tm.add_edges(np.zeros((0, 2), np.int32), rel[:0], info[:0], ssos[:0], lcs[:0], 4) is tm


def test_add_edges_grows_the_edge_axis_only():
    rng = np.random.default_rng(3)
    jm, tm = empties(n=4, e=2)
    for i in range(2):
        jm, tm = add_both(jm, tm, keyframe(rng), n_live=i)
    rel, info = _edges(rng, 3)
    ij = np.array([[0, 1], [0, 1], [1, 0]], np.int32)
    ssos, lcs = np.float32([0.5, 0.5, 0.5]), np.array([False, False, True])
    jm = jm.add_edges(jnp.asarray(ij), jnp.asarray(rel), jnp.asarray(info), jnp.asarray(ssos),
                      jnp.asarray(lcs), n_live=0)
    tm = tm.add_edges(ij, rel, info, ssos, lcs, n_live=0)
    assert tm.kf_capacity == 4 and tm.edge_capacity == 4
    assert_same(jm, tm)


@pytest.mark.parametrize("kw", [{}, {"kf_capacity": 8}, {"edge_capacity": 12},
                                {"kf_capacity": 2, "edge_capacity": 3}],
                         ids=["both", "keyframes", "edges", "no_shrink"])
def test_grow(kw):
    rng = np.random.default_rng(4)
    jm, tm = empties()
    for i in range(3):
        jm, tm = add_both(jm, tm, keyframe(rng), n_live=i)
    rel, info = _edges(rng, 1)
    jm = jm.add_edge(0, 2, jnp.asarray(rel[0]), jnp.asarray(info[0]), sso=0.3, n_live=0)
    tm = tm.add_edge(0, 2, rel[0], info[0], sso=0.3, n_live=0)
    grown = tm.grow(**kw)
    assert_same(jm.grow(**kw), grown)
    if kw.get("kf_capacity") == 2:
        assert grown is tm  # capacities never shrink
    else:
        assert grown is not tm and grown.sso is not tm.sso


def test_with_optimized_and_save_load(tmp_path):
    rng = np.random.default_rng(5)
    jm, tm = empties()
    for i in range(2):
        jm, tm = add_both(jm, tm, keyframe(rng), n_live=i)
    poses = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(4, 3))
    jm, tm = jm.with_optimized(jnp.asarray(poses)), tm.with_optimized(torch.from_numpy(poses))
    assert_same(jm, tm)
    assert tm.opt_poses.data_ptr() != tm.graph.poses.data_ptr()
    # each package loads the other's archive
    jm.save(str(tmp_path / "j.npz"))
    tm.save(str(tmp_path / "t.npz"))
    assert_same(jm, TMap.load(str(tmp_path / "j.npz"), empties()[1]))
    assert_same(JMap.load(str(tmp_path / "t.npz"), empties()[0]), tm)


def test_convert_bridge_both_ways():
    rng = np.random.default_rng(6)
    jm, tm = empties()
    for i in range(3):
        jm, tm = add_both(jm, tm, keyframe(rng), n_live=i)
    carried = convert.map_from_numpy(jax_leaves(jm), empties()[1])
    assert_same(jm, carried)
    assert carried.gray.dtype == torch.bfloat16 and carried.n_kf.dtype == torch.int32
    flat, treedef = jax.tree_util.tree_flatten(jm)
    back = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(a, dtype=x.dtype) for a, x in zip(convert.map_to_numpy(tm), flat)]
    )
    assert_same(back, tm)
    # a larger reference map keeps its capacities through a smaller template
    big = convert.map_from_numpy(jax_leaves(jm.grow()), empties()[1])
    assert big.kf_capacity == 8 and big.edge_capacity == 12
