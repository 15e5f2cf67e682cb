"""The port's pose-graph solvers (`rgbd360_tpu_torch/slam/graph.py`) against
the reference's on seeded ring graphs (`synthetic.ring_graph`: noisy
odometry around a circle, true loop closures and one wrong closure),
carried across with `convert.pose_graph_from_numpy`.

Tolerances.  One assembly (H, b, chi2) is the same arithmetic in another
summation order: 1e-5 relative to the largest entry.  A solved graph goes
through up to 10 LM steps whose 6N x 6N solves come from different LAPACK
routines (and, for PCG, up to 100 CG steps each), so the final chi2 is held
to 1e-3 relative and the poses to 1e-4 m / 1e-4 rad; measured here 4e-6
relative on the dense solver.  The LM iteration count is held equal while
the cost still moves (a cap of 3 iterations); once both solvers sit on the
f32 noise floor of chi2 (from iteration 3 on these graphs) the reference's
own `improved & rel_impr < 1e-6` exit is decided by the last bit of two
sums (measured: the reference stops after 9 iterations, the port runs all
10, both at chi2 0.68404), so the full run's count is not compared.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd360_tpu.slam import graph as JG
from rgbd360_tpu_torch import convert, synthetic
from rgbd360_tpu_torch.slam import graph as TG

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

POSE_TOL = 1e-4  # m and rad
CHI2_RTOL = 1e-3


ring_graph = synthetic.ring_graph


def both(leaves):
    jg = JG.PoseGraph(*(jnp.asarray(a) for a in leaves))
    return jg, convert.pose_graph_from_numpy(leaves)


def _gaps(a, b):
    """Largest translation (m) and rotation (rad) gap between pose stacks."""
    import chip_smoke

    return chip_smoke._pose_gaps(a, b)


@pytest.mark.parametrize("dcs", [False, True], ids=["plain", "dcs"])
def test_one_assembly_matches(dcs):
    """H, b and chi2 of ONE assembly, to 1e-5 of the largest entry."""
    leaves, loop_mask, _ = ring_graph(12, 16, 32)
    jg, tg = both(leaves)
    jd = (jnp.asarray(loop_mask), jnp.asarray(10.0)) if dcs else None
    td = (torch.from_numpy(loop_mask), 10.0) if dcs else None
    jh, jb, jc = JG._graph_normal_equations(jg.poses, jg, jd)
    th, tb, tc = TG._graph_normal_equations(tg.poses, tg, td)
    jh, jb = np.asarray(jh), np.asarray(jb)
    # the gauge prior (1e6) would hide everything else under a relative bound
    prior = np.zeros_like(jh)
    prior[:6, :6] = 1e6 * np.eye(6)
    np.testing.assert_allclose(th.numpy() - prior, jh - prior, atol=1e-5 * np.abs(jh - prior).max())
    np.testing.assert_allclose(tb.numpy(), jb, atol=1e-5 * np.abs(jb).max())
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-5)


def test_edge_terms_and_matvec_match_dense():
    """The matrix-free pieces against the dense H of the same port: H x,
    the block diagonal and b."""
    leaves, _, _ = ring_graph(12, 16, 32)
    _, tg = both(leaves)
    n = 16
    h, b, _ = TG._graph_normal_equations(tg.poses, tg)
    m_e, b_j, _, i, j = TG._edge_terms(tg.poses, tg)
    d, p = TG._incidence(i, j, n, torch.float32)
    prior = TG._prior_diag(tg, torch.float32)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(n, 6)).astype(np.float32))
    # live vertices only: the 1e6 gauge prior dominates vertex 0's rows
    y = TG._hx(m_e, d, prior, 0.0 * prior, x)
    np.testing.assert_allclose(y.numpy()[1:], (h @ x.reshape(-1)).reshape(n, 6).numpy()[1:],
                               rtol=1e-4, atol=1e-2)
    bd = TG._block_diag(m_e, p, prior, 0.0 * prior)
    hb = h.reshape(n, 6, n, 6)
    for v in range(n):
        np.testing.assert_allclose(bd[v].numpy(), hb[v, :, v, :].numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose((d.mT @ b_j).reshape(-1).numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dcs", [False, True], ids=["plain", "dcs"])
def test_dense_lm_matches(dcs):
    leaves, loop_mask, gt = ring_graph(12, 16, 32, wrong=dcs)
    jg, tg = both(leaves)
    jp, jc, ji = JG.optimize_pose_graph(
        jg, 10, loop_mask=jnp.asarray(loop_mask) if dcs else None)
    tl = torch.from_numpy(loop_mask) if dcs else None
    tp, tc, ti = TG.optimize_pose_graph(tg, 10, loop_mask=tl)
    assert 3 <= ti <= 10
    assert TG.optimize_pose_graph(tg, 3, loop_mask=tl)[2] == int(
        JG.optimize_pose_graph(jg, 3, loop_mask=jnp.asarray(loop_mask) if dcs else None)[2])
    np.testing.assert_allclose(float(tc), float(jc), rtol=CHI2_RTOL)
    dt, dr = _gaps(tp.numpy()[:12], np.asarray(jp)[:12])
    assert dt < POSE_TOL and dr < POSE_TOL, (dt, dr)
    # and the solve is a solve: close to the ground truth, far below the
    # dead-reckoned start
    assert _gaps(tp.numpy()[:12], gt)[0] < 0.05


def test_dcs_switches_off_the_wrong_closure():
    leaves, loop_mask, _ = ring_graph(12, 16, 32)
    jg, tg = both(leaves)
    lm = torch.from_numpy(loop_mask)
    tp, _, _ = TG.optimize_pose_graph(tg, 10, loop_mask=lm)
    s = TG.loop_closure_switches(tg, tp, lm).numpy()
    jp, _, _ = JG.optimize_pose_graph(jg, 10, loop_mask=jnp.asarray(loop_mask))
    js = np.asarray(JG.loop_closure_switches(jg, jp, jnp.asarray(loop_mask)))
    n_edges = int(leaves[5].sum())
    wrong = n_edges - 1
    assert s[wrong] < 0.25, s[:n_edges]
    assert (s[:wrong] > 0.9).all(), s[:n_edges]
    np.testing.assert_allclose(s, js, atol=1e-3)


@pytest.mark.parametrize("dcs", [False, True], ids=["plain", "dcs"])
def test_pcg_matches_reference_and_dense(dcs):
    """LM-PCG against the reference's (chi2, poses, LM iterations) and
    against the port's dense LM."""
    leaves, loop_mask, _ = ring_graph(24, 32, 64, seed=1, wrong=dcs)
    jg, tg = both(leaves)
    jl = jnp.asarray(loop_mask) if dcs else None
    tl = torch.from_numpy(loop_mask) if dcs else None
    jp, jc, ji = JG.optimize_pose_graph_pcg(jg, 10, loop_mask=jl)
    counts = []
    tp, tc, ti = TG.optimize_pose_graph_pcg(tg, 10, loop_mask=tl, cg_counts=counts)
    assert len(counts) == ti and max(counts) <= 100
    assert TG.optimize_pose_graph_pcg(tg, 2, loop_mask=tl)[2] == int(
        JG.optimize_pose_graph_pcg(jg, 2, loop_mask=jl)[2])
    np.testing.assert_allclose(float(tc), float(jc), rtol=CHI2_RTOL)
    dt, dr = _gaps(tp.numpy()[:24], np.asarray(jp)[:24])
    assert dt < POSE_TOL and dr < POSE_TOL, (dt, dr)
    dp, dc, _ = TG.optimize_pose_graph(tg, 10, loop_mask=tl)
    # two linear solvers, one minimum: the reference holds its own pair to
    # this bound (tests/test_slam.py)
    np.testing.assert_allclose(float(tc), float(dc), rtol=1e-2)
    dt, dr = _gaps(tp.numpy()[:24], dp.numpy()[:24])
    assert dt < 5e-3 and dr < 5e-3, (dt, dr)


def test_pcg_inner_solver_matches():
    """`_pcg` on one SPD system: the reference's iterate and count."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(24, 24)).astype(np.float32)
    h = a @ a.T + 24 * np.eye(24, dtype=np.float32)
    b = rng.normal(size=(4, 6)).astype(np.float32)
    dinv = 1.0 / np.diag(h)
    jx, jn = JG._pcg(lambda x: (jnp.asarray(h) @ x.reshape(-1)).reshape(4, 6),
                     lambda r: r * jnp.asarray(dinv).reshape(4, 6), jnp.asarray(b), 50, 1e-6)
    th, tdinv = torch.from_numpy(h), torch.from_numpy(dinv)
    tx, tn = TG._pcg(lambda x: (th @ x.reshape(-1)).reshape(4, 6),
                     lambda r: r * tdinv.reshape(4, 6), torch.from_numpy(b), 50, 1e-6)
    assert tn == int(jn)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(tx.numpy().reshape(-1), np.linalg.solve(h, b.reshape(-1)), atol=1e-4)


def test_chi2_and_empty_graph():
    leaves, _, _ = ring_graph(12, 16, 32)
    jg, tg = both(leaves)
    np.testing.assert_allclose(float(TG.graph_chi2(tg)), float(JG.graph_chi2(jg)), rtol=1e-5)
    te, je = TG.PoseGraph.empty(4, 8), JG.PoseGraph.empty(4, 8)
    for a, b in zip(convert.pose_graph_to_numpy(te), jax.tree_util.tree_leaves(je)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert TG.optimize_pose_graph(te, 10)[2] == int(JG.optimize_pose_graph(je, 10)[2])
