"""The port's `parallel/` (sharded stages on `torch.distributed`, the
multi-process glue) against the JAX package's, on the inputs of
`tests/test_parallel.py`.

Every function of `parallel/sharded.py` runs on 2 and on 4 gloo ranks on
the CPU (spawned processes, a FileStore rendezvous, each rank under its
own timeout), and the reference's function on conftest's 8-device CPU
mesh.  Tolerances:

* pose graph (dense LM, LM-PCG, LM-PCG with DCS) against the JAX sharded
  solve: the reference's own, chi2 rtol 0.05 and poses atol 5e-3 (LM steps
  on different reductions of the same f32 normal equations), and
  against the port's single-device solve, where only the psum's order of
  summation differs: poses atol 1e-5;
* planar BA: the reference's own 1e-5, against the JAX sharded solve and
  the port's single-device solve after 10 LM iterations.  The reference's
  test stops after 12, where the 12th step is decided by the rounding of
  the sums (the directions the 4-parameter planes leave free): the two
  packages' single-device solves part there by 1.4e-5, and so do the
  port's 4-rank and single-device solves (measured); after 12 the port's
  sharded solve is held to the single-device parity bound of
  test_torch_plane_ba (1e-4), chi2 to 1e-3 relative, the same LM count;
* the plane scan: equal match counts, observability and matched area
  (integer decisions and a sum of the same areas), poses and information
  to 1e-4 of their scale (the pose solve of one keyframe, unsharded math);
* the pair sweep: Hessian and gradient within 1e-3 of their norms, error
  1e-4 relative (test_torch_dense's sweep tolerance); against the port's
  own unsharded sweep, bit-equal (the same batched reduction per pair).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rgbd360_tpu.config import DenseRegConfig, MatcherConfig
from rgbd360_tpu.ops import se3 as jse3
from rgbd360_tpu.parallel import sharded as JS
from rgbd360_tpu.registration import dense as JD
from rgbd360_tpu.registration.planes import ODOMETRY_6DOF
from rgbd360_tpu_torch.parallel import multihost as MH, sharded as S
from rgbd360_tpu_torch.parallel.spawn import run_ranks

from __graft_entry__ import _synthetic_pair
from _torch_ranks import multihost_helpers, stages
from test_plane_ba import _make_problem
from test_planes import TestMatching
from test_slam import TestRobustDCS, _ring_graph

RANK_TIMEOUT_S = 240
N_KF_SCAN = 16


def _np(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _planes_np(ps) -> dict:
    return {f.name: np.asarray(getattr(ps, f.name)) for f in dataclasses.fields(ps)}


@pytest.fixture(scope="module")
def jmesh():
    return JS.make_mesh(8)


@pytest.fixture(scope="module")
def inputs():
    ring, _ = _ring_graph(n=16)
    dcs, _, loop_mask, _ = TestRobustDCS()._ring_with_false_lc(n=16)
    prob, _, _ = _make_problem(n_kf=8, noise=0.003, perturb=0.05, seed=2)
    ref, trg, _ = TestMatching()._two_sets([0.1, 0, 0.05, 0, 0.02, 0])
    b, h, w = 8, 16, 128
    g1, d1, g2, d2 = _synthetic_pair(h, w)
    cfg = DenseRegConfig(pyramid_levels=1)
    tpyr = JD.build_frame_pyramid(g2, d2, cfg)
    tpack = JD._pack_target({k: getattr(tpyr, k)[0] for k in
                             ("gray", "depth", "gray_gx", "gray_gy", "depth_gx", "depth_gy")})
    twists = np.random.default_rng(3).normal(0, 0.01, (b, 6)).astype(np.float32)
    poses = np.stack([np.asarray(jse3.se3_exp(jnp.asarray(t))) for t in twists])
    gate = np.ones(N_KF_SCAN, bool)
    gate[5] = False  # a gated-off keyframe
    return {
        "ring": _np(ring), "dcs": _np(dcs), "dcs_loop_mask": np.asarray(loop_mask),
        "ba": _np(prob), "scan_ref": _planes_np(ref), "scan_trg": _planes_np(trg),
        "scan_n_kf": N_KF_SCAN, "scan_gate": gate,
        "pa_gray": np.broadcast_to(np.asarray(g1), (b, h, w)).copy(),
        "pa_depth": np.broadcast_to(np.asarray(d1), (b, h, w)).copy(),
        "pa_pack": np.broadcast_to(np.asarray(tpack), (b,) + tpack.shape).copy(),
        "pa_poses": poses,
    }


@pytest.fixture(scope="module")
def ref(jmesh, inputs):
    """The JAX sharded functions on the 8-device mesh."""
    from rgbd360_tpu.ops.segmentation import PlaneSet
    from rgbd360_tpu.slam.graph import PoseGraph
    from rgbd360_tpu.slam.plane_ba import PlaneBAProblem

    ring = PoseGraph(*map(jnp.asarray, inputs["ring"]))
    dcs = PoseGraph(*map(jnp.asarray, inputs["dcs"]))
    prob = PlaneBAProblem(*map(jnp.asarray, inputs["ba"]))
    stacked = PlaneSet(**{k: jnp.broadcast_to(jnp.asarray(v), (N_KF_SCAN,) + v.shape)
                          for k, v in inputs["scan_ref"].items()})
    trg = PlaneSet(**{k: jnp.asarray(v) for k, v in inputs["scan_trg"].items()})
    out = {
        "graph": JS.distributed_pose_graph(jmesh, ring, max_iters=15),
        "pcg": JS.distributed_pose_graph_pcg(jmesh, ring, max_iters=15),
        "dcs": JS.distributed_pose_graph_pcg(
            jmesh, dcs, max_iters=15, loop_mask=jnp.asarray(inputs["dcs_loop_mask"])),
        "ba": JS.distributed_plane_ba(jmesh, prob, max_iters=12),
        "ba10": JS.distributed_plane_ba(jmesh, prob, max_iters=10),
        "scan": JS.sharded_plane_scan(jmesh, stacked, trg, jnp.asarray(inputs["scan_gate"]),
                                      MatcherConfig(), ODOMETRY_6DOF),
        "pair": JS.sharded_pair_align(
            jmesh, *(jnp.asarray(inputs[k]) for k in ("pa_gray", "pa_depth", "pa_pack",
                                                      "pa_poses")),
            DenseRegConfig(pyramid_levels=1), JD.PHOTO_DEPTH),
    }
    return jax.tree_util.tree_map(np.asarray, jax.device_get(out))


@pytest.fixture(scope="module", params=[2, 4], ids=["2-ranks", "4-ranks"])
def port(request, inputs):
    """Every sharded function on `request.param` gloo ranks; rank 0's
    results, and every rank's."""
    runs = run_ranks(stages, request.param, "gloo", "cpu", args=(inputs,),
                     timeout=RANK_TIMEOUT_S, threads=1)
    return request.param, runs


def _gap(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def test_ranks_agree(port):
    """Every rank returns the same (gathered, replicated) results, bit for
    bit: all collectives hand every rank the same sums."""
    _, runs = port
    for r in runs[1:]:
        for k in ("graph", "pcg", "dcs", "ba", "scan", "pair"):
            for a, b in zip(runs[0][k], r[k]):
                assert np.array_equal(np.asarray(a), np.asarray(b)), k


@pytest.mark.parametrize("key", ["graph", "pcg", "dcs"])
def test_distributed_pose_graph_matches_reference(port, ref, key):
    _, runs = port
    poses, chi2, iters = runs[0][key]
    rp, rc, _ = ref[key]
    np.testing.assert_allclose(float(chi2), float(rc), rtol=0.05)
    np.testing.assert_allclose(poses.numpy(), rp, atol=5e-3)
    sp, sc, s_it = runs[0][f"{key}_single"]
    assert _gap(poses, sp) <= 1e-5, (key, _gap(poses, sp))
    np.testing.assert_allclose(float(chi2), float(sc), rtol=1e-4)


def test_distributed_pcg_collectives(port):
    """The LM-PCG makes 3 collectives per CG step (all_gather, psum_scatter,
    psum), the reference's count, and per LM iteration 6 more: one
    reduction of the normal blocks, the CG's first step (3), the delta's
    all_gather and the psum of the new chi2; plus the initial chi2."""
    _, runs = port
    r = runs[0]
    lm = r["pcg"][2]
    assert r["pcg_coll"] == 1 + 6 * lm + 3 * sum(r["pcg_cg"]), (r["pcg_coll"], lm, r["pcg_cg"])


def test_distributed_plane_ba_matches_reference(port, ref):
    _, runs = port
    poses, planes, _, _ = runs[0]["ba10"]
    rp, rpl, _, _ = ref["ba10"]
    np.testing.assert_allclose(poses.numpy(), rp, atol=1e-5)
    np.testing.assert_allclose(planes.numpy(), rpl, atol=1e-5)
    sp, spl, _, _ = runs[0]["ba10_single"]
    assert _gap(poses, sp) <= 1e-5 and _gap(planes, spl) <= 1e-5
    poses, planes, chi2, iters = runs[0]["ba"]
    rp, rpl, rc, r_it = ref["ba"]
    np.testing.assert_allclose(poses.numpy(), rp, atol=1e-4)
    np.testing.assert_allclose(planes.numpy(), rpl, atol=1e-4)
    np.testing.assert_allclose(float(chi2), float(rc), rtol=1e-3)
    assert iters == int(r_it)
    sp, spl, sc, _ = runs[0]["ba_single"]
    assert _gap(poses, sp) <= 1e-4 and _gap(planes, spl) <= 1e-4
    np.testing.assert_allclose(float(chi2), float(sc), rtol=1e-3)


def test_sharded_plane_scan_matches_reference(port, ref):
    _, runs = port
    n_m, area, pose, info, obs = (x.numpy() for x in runs[0]["scan"])
    rn, ra, rp, ri, ro = ref["scan"]
    assert n_m.shape == (N_KF_SCAN,)
    np.testing.assert_array_equal(n_m, rn)
    np.testing.assert_array_equal(obs, ro)
    assert n_m[5] == 0 and not obs[5] and n_m[0] >= 6  # the gate; the reference's own bound
    np.testing.assert_allclose(area, ra, rtol=1e-6)
    assert _gap(pose, rp) <= 1e-4 * np.abs(rp).max()
    assert _gap(info, ri) <= 1e-4 * np.abs(ri).max()
    for a, b in zip(runs[0]["scan"], runs[0]["scan_single"]):
        assert np.array_equal(a.numpy(), b.numpy())


def test_sharded_pair_align_matches_reference(port, ref):
    _, runs = port
    h, g, e = (x.numpy() for x in runs[0]["pair"])
    rh, rg, re = ref["pair"]
    assert h.shape == (8, 6, 6)
    assert _gap(h, rh) <= 1e-3 * np.abs(rh).max()
    assert _gap(g, rg) <= 1e-3 * np.abs(rg).max()
    np.testing.assert_allclose(e, re, rtol=1e-4)
    for a, b in zip(runs[0]["pair"], runs[0]["pair_single"]):
        assert np.array_equal(a.numpy(), b.numpy())


def test_divisibility_errors(port):
    """A graph or a problem whose capacities do not divide by the mesh size
    raises ValueError, as the reference's."""
    _, runs = port
    assert runs[0]["raised"] == ["pcg", "ba"]


def test_multihost_helpers_single_process():
    """The glue degrades to the local case in one process (the reference's
    `test_multihost_helpers_single_process`): initialize() is a no-op, the
    meshes are a world of one, the converters round-trip, a hierarchical
    psum over the (host, device) mesh sums, agreement is trivially true."""
    import torch

    assert MH.initialize() is False
    gm = MH.global_mesh("kf")
    assert gm.size == 1 and gm.rank == 0 and gm.group is None
    hm = MH.hosts_mesh()
    assert hm.shape == (1, 1)
    x = torch.arange(4, dtype=torch.float32).reshape(1, 4)
    gx = MH.host_local_to_global(gm, 0, x)
    assert torch.equal(gx, x)
    y = torch.ones(1, 1, 8)
    assert float(S.psum(hm["host"], S.psum(hm["device"], y.sum()))) == y.numel()
    assert torch.equal(MH.global_to_host_local(gm, 0, gx), x)
    assert MH.all_hosts_agree(1.25)
    with pytest.raises(ValueError):
        S.make_mesh(2)  # never a smaller mesh than asked for


def test_multihost_helpers_two_ranks():
    """The same glue in a 2-rank gloo group: each rank's piece reaches the
    whole array in rank order and back, the (host, device) mesh is 1 x 2
    on one host, the hierarchical psum counts every element, agreement
    holds on an agreed value and fails on the rank's own number."""
    runs = run_ranks(multihost_helpers, 2, "gloo", "cpu", timeout=RANK_TIMEOUT_S, threads=1)
    for r, out in enumerate(runs):
        assert out["initialized"] is True and out["size"] == 2 and out["rank"] == r
        assert out["hosts_shape"] == (1, 2)
        np.testing.assert_array_equal(out["full"].numpy(), [0, 1, 2, 3])
        assert out["back_equal"] and out["total"] == 6.0
        assert out["agree"] is True and out["disagree"] is False
