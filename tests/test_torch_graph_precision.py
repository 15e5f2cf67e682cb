"""The pose-graph solve's precision (`GraphConfig.dtype`).

float64 is the reference's own (g2o solves in double): on a graph whose
odometry edges carry plane-registration information from walls alone (no
vertical translation, the normal matrix held there by the 1e-6 priors) and
whose loop edges move the solution, one of them wrong by half a turn, the
program's float64 solve ends at the cost of the benchmark's plain float64
LM (`perfbench/reference.graph_solve`) to 1e-9 of it.  float32 stays the
solver as it was before the precision option, bit for bit, on the
solvers' graphs: `GRAPH_GOLDEN` holds that solver's outputs, recorded on
the CPU with one thread by

    python tests/test_torch_graph_precision.py --record

on the solver without the option (its calls pass no `dtype`).
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench import reference as R  # noqa: E402
from rgbd360_tpu_torch import convert, synthetic  # noqa: E402
from rgbd360_tpu_torch.config import GraphConfig  # noqa: E402
from rgbd360_tpu_torch.ops import se3  # noqa: E402
from rgbd360_tpu_torch.parallel.sharded import distributed_pose_graph_pcg, make_mesh  # noqa: E402
from rgbd360_tpu_torch.slam import graph as G  # noqa: E402

GRAPH_GOLDEN = Path(__file__).resolve().parent / "data" / "graph_float32_golden.npz"
LEAVES = ("poses", "vmask", "edges_ij", "rel", "info", "emask")
COST_RTOL = 1e-9


def wall_graph(seed: int = 3):
    """`synthetic.ring_graph` (12 poses dead-reckoned around a 2 m circle,
    3 closures across it and one wrong closure between two poses half a
    turn apart) with each odometry edge's information that of plane
    registration against 2-4 walls: normals horizontal, weights by area,
    so the translation is seen along the walls' normals and never
    vertically (rank 5).  Returns (leaves, loop_mask)."""
    leaves, loop_mask, _ = synthetic.ring_graph(12, 16, 32, seed=seed)
    rng = np.random.default_rng(seed)
    info = leaves[4].astype(np.float64)
    for e in np.flatnonzero(leaves[5] & ~loop_mask):
        lam = np.zeros((6, 6))
        for _ in range(rng.integers(2, 5)):
            a = rng.uniform(0, 2 * np.pi)
            n = np.array([np.cos(a), np.sin(a), 0.0])
            w = rng.uniform(1e3, 2e4)  # area / noise, as the registration weighs a pair
            nx = np.array([[0, -n[2], n[1]], [n[2], 0, -n[0]], [-n[1], n[0], 0]])
            lam[:3, :3] += w * np.outer(n, n)  # the plane's distance: n . t
            lam[3:, 3:] += w * nx.T @ nx  # its normal: n x w
        info[e] = lam
    leaves[4] = info.astype(np.float32)
    return leaves, loop_mask


def _graph(leaves, dtype=torch.float32):
    g = convert.pose_graph_from_numpy(leaves)
    if dtype == torch.float32:
        return g
    return dataclasses.replace(g, poses=g.poses.to(dtype), rel=g.rel.to(dtype),
                               info=g.info.to(dtype))


def _reference(leaves, loop_mask):
    """The plain float64 LM's poses and the robust cost function, on the
    live part of the graph."""
    n = int(leaves[1].sum())
    em = leaves[5]
    edges = tuple(torch.from_numpy(np.asarray(a)) for a in (
        leaves[2][em], leaves[3][em], leaves[4][em], loop_mask[em]))
    start = torch.from_numpy(leaves[0][:n])
    ref = R.graph_solve(start, *edges, 10.0, 10, 1e-5, 10.0, dtype=torch.float64)

    def cost(poses):
        return R.graph_cost(poses[:n], *edges, 10.0)

    return ref, cost, cost(start)


def test_wall_graph_is_rank_deficient_and_moves():
    leaves, loop_mask = wall_graph()
    odo = leaves[5] & ~loop_mask
    assert np.all(np.abs(leaves[4][odo][:, 2, :]) == 0)  # no vertical translation
    assert all(np.linalg.matrix_rank(i.astype(np.float64)) == 5 for i in leaves[4][odo])
    ref, cost, c_in = _reference(leaves, loop_mask)
    assert cost(ref) < 0.05 * c_in


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_float64_solve_ends_at_the_references_cost(solver, record_property):
    """The dense solve (the reference's g2o semantics) to 1e-9 of the
    reference's cost; LM-PCG, whose CG ends at a tolerance, to the 1e-2 the
    two linear solvers are held to (`test_torch_graph.py`)."""
    leaves, loop_mask = wall_graph()
    ref, cost, c_in = _reference(leaves, loop_mask)
    lm = torch.from_numpy(loop_mask)
    solve = G.optimize_pose_graph if solver == "dense" else G.optimize_pose_graph_pcg
    # the graph in float64 (the poses come back in it, unrounded) and in
    # float32 (the map's own)
    p64, c64, _ = solve(_graph(leaves, torch.float64), 10, lm_lambda0=1e-5, lm_step=10.0,
                        loop_mask=lm, dcs_phi=10.0, dtype="float64")
    p32, _, _ = solve(_graph(leaves), 10, lm_lambda0=1e-5, lm_step=10.0, loop_mask=lm,
                      dcs_phi=10.0, dtype="float32")
    assert p64.dtype == c64.dtype == torch.float64
    c_ref = cost(ref)
    gap64 = abs(cost(p64) - c_ref) / c_ref
    gap32 = abs(cost(p32) - c_ref) / c_ref
    record_property("float32_gap", gap32)
    record_property("float64_gap", gap64)
    assert gap64 <= (COST_RTOL if solver == "dense" else 1e-2), (gap64, gap32)
    assert np.isfinite(gap32), gap32
    if solver == "dense":  # the cost it minimizes is the reference's
        np.testing.assert_allclose(float(c64), c_ref, rtol=COST_RTOL)


def test_float64_solve_of_a_float32_graph():
    """A float32 graph (the map's) solved in float64 comes back in float64,
    as the graph cast to float64 gives it; the graph is left as it was."""
    leaves, loop_mask = wall_graph()
    lm = torch.from_numpy(loop_mask)
    g = _graph(leaves)
    p, c, _ = G.optimize_pose_graph(g, 10, loop_mask=lm, dtype="float64")
    raw, c_raw, _ = G.optimize_pose_graph(_graph(leaves, torch.float64), 10, loop_mask=lm)
    assert p.dtype == c.dtype == torch.float64
    assert torch.equal(p, raw) and torch.equal(c, c_raw)
    assert g.poses.dtype == g.rel.dtype == g.info.dtype == torch.float32


def test_distributed_pcg_takes_the_precision():
    """A world of one is the single-device solve, at float64 too."""
    leaves, loop_mask = wall_graph()
    lm = torch.from_numpy(loop_mask)
    g = _graph(leaves)
    a = distributed_pose_graph_pcg(make_mesh(), g, 10, loop_mask=lm, dtype="float64")
    b = G.optimize_pose_graph_pcg(g, 10, loop_mask=lm, dtype="float64")
    assert a[0].dtype == torch.float64
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2] == b[2]


def test_float64_log_is_exact_where_float32s_guards_bias_it():
    """`se3_log` in float64 against the reference's log, across the small
    angles where float32's division guard biases theta / sin(theta) and the
    angles near pi; float32 keeps its guard."""
    torch.manual_seed(0)
    for th in (1e-6, 1e-4, 1e-2, 1.0, 3.05, 3.14):
        xi = torch.randn(64, 6, dtype=torch.float64)
        xi[:, 3:] *= th / xi[:, 3:].norm(dim=1, keepdim=True)
        t = R.se3_exp(xi)
        t[:, :3, :3] += 1e-7 * torch.randn(64, 3, 3, dtype=torch.float64)  # float32-stored
        a, b = se3.se3_log(t), R.se3_log(t)
        assert float(((a - b).norm(dim=1) / b.norm(dim=1)).max()) < 1e-9, th
    r = R.se3_exp(torch.tensor([[0.0, 0, 0, 1e-3, 0, 0]], dtype=torch.float64))
    w32 = se3.so3_log(r[:, :3, :3].float())
    # theta (2 sin theta) / (2 sin theta + 1e-8): 5e-9 rad short of 1e-3
    assert 1e-3 - float(w32[0, 0]) == pytest.approx(1e-3 * 1e-8 / 2e-3, rel=0.1)


def _float32_solves() -> dict:
    """Every solver's (poses, chi2, iters) on the solvers' graphs in
    float32, with one thread, passing no `dtype`."""
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        reg = np.load(ROOT / "rgbd360_tpu_torch" / "data" / "registration_golden.npz")
        graphs = {
            "ring": synthetic.ring_graph(12, 16, 32)[:2],
            "ring_pcg": synthetic.ring_graph(24, 32, 64, seed=1)[:2],
            "wall": wall_graph(),
            "seq": ([reg[f"seq_graph_{k}"] for k in LEAVES], None),
        }
        for name, (leaves, loop_mask) in graphs.items():
            for robust in ((False, True) if loop_mask is not None else (False,)):
                lm = torch.from_numpy(loop_mask) if robust else None
                solvers = {"dense": G.optimize_pose_graph}
                if name != "seq":
                    solvers["pcg"] = G.optimize_pose_graph_pcg
                for s, fn in solvers.items():
                    p, c, it = fn(_graph(leaves), 10, loop_mask=lm)
                    key = f"{name}_{s}_{'dcs' if robust else 'plain'}"
                    out[f"{key}_poses"] = p.numpy()
                    out[f"{key}_chi2"] = c.numpy()
                    out[f"{key}_iters"] = np.int64(it)
    finally:
        torch.set_num_threads(threads)
    return out


def test_float32_is_the_solver_as_it_was(monkeypatch):
    """`dtype="float32"` (the default's), and no `dtype`, give the recorded
    solver's poses, chi2 and iteration counts bit for bit."""
    golden = np.load(GRAPH_GOLDEN)
    solvers = (G.optimize_pose_graph, G.optimize_pose_graph_pcg)
    for dtype in (None, "float32", torch.float32):
        for fn in solvers:
            monkeypatch.setattr(G, fn.__name__, lambda *a, _f=fn, **kw: _f(*a, dtype=dtype, **kw))
        got = _float32_solves()
        assert set(got) == set(golden.files)
        for k in golden.files:
            np.testing.assert_array_equal(got[k], golden[k], err_msg=f"{k} ({dtype})")
    assert GraphConfig().dtype == "float32"


if __name__ == "__main__" and "--record" in sys.argv:
    GRAPH_GOLDEN.parent.mkdir(exist_ok=True)
    np.savez(GRAPH_GOLDEN, **_float32_solves())
    print(f"wrote {GRAPH_GOLDEN}")
