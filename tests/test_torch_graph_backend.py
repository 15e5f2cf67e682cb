"""`slam/graph_backend.py` of the port against the reference's: the
reference's own `TestGraphBackend` cases (`tests/test_misc.py:89-111`) in
both packages, and the g2o text codec compared between them.

Tolerances.  Optimized poses: 1e-5 m between the packages (the same LM on
a two-vertex graph; the reductions round in another order) and the
reference's own 1e-2 m against the ground truth.  The g2o files of the
two optimized graphs read back within the same 1e-5; of one seeded graph:
equal text (both write the same float32 inputs with `%.9g`), and what the
port reads back equal to what the reference reads back.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd360_tpu.ops import se3 as jse3
from rgbd360_tpu.slam import graph_backend as JG
from rgbd360_tpu_torch.slam import graph_backend as TG


def _step() -> np.ndarray:
    return np.asarray(jse3.se3_exp(jnp.array([1.0, 0, 0, 0, 0, 0])))


def _build(module, **kw):
    g = module.GraphOptimizerBackend(max_vertices=8, max_edges=8, **kw)
    g.add_vertex(np.eye(4))
    g.add_vertex(np.eye(4))  # wrong initial guess for vertex 1
    g.add_edge(0, 1, _step(), np.eye(6) * 100)
    return g


def test_incremental_api_matches_reference(tmp_path):
    ref, got = _build(JG), _build(TG, device="cpu")
    chi2_r, iters_r = ref.optimize()
    chi2, iters = got.optimize()
    poses = got.get_poses()
    np.testing.assert_allclose(poses[1][:3, 3], [1, 0, 0], atol=1e-2)
    np.testing.assert_allclose(poses, ref.get_poses(), atol=1e-5)
    assert iters == iters_r and abs(chi2 - chi2_r) <= 1e-6 + 1e-3 * abs(chi2_r)
    for g, name in ((ref, "ref.g2o"), (got, "port.g2o")):
        g.save_graph(str(tmp_path / name))
    text = (tmp_path / "port.g2o").read_text()
    assert "VERTEX_SE3:QUAT 0" in text and "EDGE_SE3:QUAT 0 1" in text and "FIX 0" in text
    for x, y in zip(TG.read_g2o(tmp_path / "port.g2o"), JG.read_g2o(tmp_path / "ref.g2o")):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=1e-5)


def test_unknown_and_unported_backends():
    """An unknown backend raises; the sharded one (ported with
    `parallel/sharded.py`) builds, and without a process group solves over
    a world of one: the edge-sharded LM's math, equal to the dense
    backend's solve to 1e-6 (the same normal equations, packed into one
    reduction)."""
    with pytest.raises(ValueError):
        TG.GraphOptimizerBackend(backend="ceres", device="cpu")
    solved = []
    for backend in ("dense", "sharded"):
        g = TG.GraphOptimizerBackend(max_vertices=8, max_edges=8, backend=backend, device="cpu")
        for i in range(4):
            g.add_vertex(np.eye(4))
        for i in range(3):
            rel = np.eye(4)
            rel[0, 3] = 1.0 + 0.1 * i
            g.add_edge(i, i + 1, rel, np.eye(6) * 10)
        solved.append((g.optimize(), g.get_poses()))
    (c_d, it_d), p_d = solved[0]
    (c_s, it_s), p_s = solved[1]
    assert it_d == it_s and abs(c_d - c_s) <= 1e-6 + 1e-5 * abs(c_d)
    np.testing.assert_allclose(p_s, p_d, atol=1e-6)


def test_needs_a_device_or_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        TG.GraphOptimizerBackend()


def test_g2o_round_trip_matches_reference(tmp_path):
    """A seeded graph written by the port's writer reads back, in both
    packages' readers, as the reference's own round trip does; and a file
    the port loads into a builder writes out the same text again."""
    rng = np.random.default_rng(0)
    n, e = 5, 7
    xi = rng.normal(0, 0.3, (n, 6))
    poses = np.stack([np.asarray(jse3.se3_exp(jnp.asarray(x))) for x in xi]).astype(np.float32)
    ij = np.stack([np.arange(e) % n, (np.arange(e) + 1 + np.arange(e) // n) % n], 1)
    rels = np.stack([np.linalg.inv(poses[i]) @ poses[j] for i, j in ij]).astype(np.float32)
    a = rng.normal(size=(e, 6, 6))
    infos = (a @ a.transpose(0, 2, 1) + 6 * np.eye(6)).astype(np.float32)
    TG.write_g2o(tmp_path / "port.g2o", poses, ij, rels, infos, fixed=(0,))
    JG.write_g2o(tmp_path / "ref.g2o", poses, ij, rels, infos, fixed=(0,))
    assert (tmp_path / "port.g2o").read_text() == (tmp_path / "ref.g2o").read_text()
    got, ref = TG.read_g2o(tmp_path / "port.g2o"), JG.read_g2o(tmp_path / "port.g2o")
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    np.testing.assert_allclose(got[0], poses, atol=1e-6)
    np.testing.assert_allclose(got[3], infos, rtol=1e-6)

    g = TG.GraphOptimizerBackend(max_vertices=8, max_edges=8, device="cpu")
    g.load_graph(str(tmp_path / "port.g2o"))
    assert (g.n_vertices, g.n_edges) == (n, e)
    g.save_graph(str(tmp_path / "again.g2o"))
    back = TG.read_g2o(tmp_path / "again.g2o")
    np.testing.assert_allclose(back[0], got[0], atol=1e-6)
    np.testing.assert_array_equal(back[1], got[1])
    with pytest.raises(ValueError, match="capacity"):
        TG.GraphOptimizerBackend(max_vertices=2, max_edges=2, device="cpu").load_graph(
            str(tmp_path / "port.g2o"))


def test_sharded_backend_on_two_ranks_matches_reference():
    """`GraphOptimizerBackend(backend="sharded")` built through the API on 2
    gloo ranks (spawned, under a timeout) against the reference's sharded
    backend (its 8-device CPU mesh) and the port's dense backend, on a
    seeded 12-vertex ring with a closure: poses within the reference's
    sharded-vs-single bound 5e-3 m of the reference's (LM on reductions of
    the same f32 normal equations in another order) and within 1e-5 of the
    port's dense solve (measured 7.5e-7), chi2 within 1e-5 relative, every
    rank equal.  The LM iteration counts are not compared: chi2 reaches
    the f32 noise floor here, where the relative-improvement exit is
    decided by rounding (2 ranks stop after 3 iterations, one device runs
    all 10; ROADMAP 3)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from _torch_ranks import graph_backend_rank
    from rgbd360_tpu_torch.parallel.spawn import run_ranks
    from test_slam import _ring_graph

    g, _ = _ring_graph(n=12)
    n_e = int(np.asarray(g.emask).sum())
    poses = np.asarray(g.poses)
    edges = [(int(i), int(j), np.asarray(g.rel)[e], np.asarray(g.info)[e])
             for e, (i, j) in enumerate(np.asarray(g.edges_ij)[:n_e])]
    ref = JG.GraphOptimizerBackend(max_vertices=12, max_edges=8 * ((n_e + 7) // 8),
                                   backend="sharded")
    dense = TG.GraphOptimizerBackend(max_vertices=12, max_edges=8 * ((n_e + 7) // 8),
                                     device="cpu")
    for b in (ref, dense):
        for p in poses:
            b.add_vertex(p)
        for i, j, rel, info in edges:
            b.add_edge(i, j, rel, info)
    chi2_r, _ = ref.optimize()
    chi2_d, _ = dense.optimize()
    runs = run_ranks(graph_backend_rank, 2, "gloo", "cpu", args=(poses, edges, 10),
                     timeout=240, threads=1)
    for out in runs:
        np.testing.assert_allclose(out["poses"], ref.get_poses(), atol=5e-3)
        np.testing.assert_allclose(out["poses"], dense.get_poses(), atol=1e-5)
        np.testing.assert_allclose(out["chi2"], chi2_r, rtol=0.05)
        np.testing.assert_allclose(out["chi2"], chi2_d, rtol=1e-5)
        assert np.array_equal(out["poses"], runs[0]["poses"])
