"""SE(3) pose-graph optimization (twin of `rgbd360_tpu/slam/graph.py`).

Per-edge residuals e_ij = log(Z_ij^-1 T_i^-1 T_j), first-order jacobians via
the adjoint, the (6N x 6N) normal matrix and a dense Levenberg-Marquardt
solve (`optimize_pose_graph`); for larger maps `optimize_pose_graph_pcg`
swaps the dense solve for a matrix-free block-Jacobi-preconditioned
conjugate-gradient solver whose H-matvec runs over the edge list.  Gauge
freedom is fixed by a strong prior on vertex 0.

The per-edge blocks are assembled through a one-hot incidence product, not
a scatter-add: `index_add` on the card accumulates with atomics, whose order
changes the f32 sums from run to run, and a matrix product does not.  With
S_i, S_j the (E, N) one-hot rows of an edge's vertices and D = S_j - S_i,
H's blocks are sum_e D[e,a] D[e,b] h_e, b is D^T b_e, the matvec is
D^T (m_e (D x)), and the block diagonal is (S_i + S_j)^T m_e.

The reference's two `lax.while_loop`s are Python loops here that read their
condition with ONE host sync per iteration (the LM loop reads whether the
step was taken and `done`, the CG loop its convergence test), which gives
the reference's iteration counts, accept/reject decisions and early exits.
Every LM iteration and every rejected step adds to `LM_COUNTS`.

Both solvers compute in the `dtype` they are given (`GraphConfig.dtype`;
the graph's own by default): the edge terms, the DCS scale, the normal
equations, the damped solve, the cost and the accept test.  They return
the poses and chi2 in that precision; a float32 map rounds the poses as it
stores them (`Map360.with_optimized`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from rgbd360_tpu_torch.ops import se3


@dataclass
class PoseGraph:
    """Fixed-capacity pose graph.

    poses:   (N, 4, 4) vertex poses (world <- keyframe)
    vmask:   (N,) bool vertex validity
    edges_ij:(E, 2) int32 vertex indices, -1 padded
    rel:     (E, 4, 4) measured relative pose Z_ij with x_i = Z_ij x_j
    info:    (E, 6, 6) measurement information
    emask:   (E,) bool edge validity
    """

    poses: torch.Tensor
    vmask: torch.Tensor
    edges_ij: torch.Tensor
    rel: torch.Tensor
    info: torch.Tensor
    emask: torch.Tensor

    @staticmethod
    def empty(n: int, e: int, device=None) -> "PoseGraph":
        return PoseGraph(
            poses=torch.eye(4, device=device).repeat(n, 1, 1),
            vmask=torch.zeros((n,), dtype=torch.bool, device=device),
            edges_ij=torch.full((e, 2), -1, dtype=torch.int32, device=device),
            rel=torch.eye(4, device=device).repeat(e, 1, 1),
            info=torch.eye(6, device=device).repeat(e, 1, 1),
            emask=torch.zeros((e,), dtype=torch.bool, device=device),
        )


# every LM iteration of every solve, and the steps rejected among them
LM_COUNTS = {"iter": 0, "reject": 0}


def _in_dtype(graph: PoseGraph, dtype) -> PoseGraph:
    """`graph` with its poses, measurements and information in `dtype` (a
    torch dtype or its name, as `GraphConfig.dtype` gives it; None keeps the
    graph's own, and so does the graph's own dtype: the graph itself)."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if dt is None or dt == graph.poses.dtype:
        return graph
    return dataclasses.replace(graph, poses=graph.poses.to(dt), rel=graph.rel.to(dt),
                               info=graph.info.to(dt))


def _edge_residuals(poses, graph: PoseGraph):
    """Per-edge residual twists, and the edges' (clamped) vertex indices."""
    i = torch.clamp(graph.edges_ij[:, 0], min=0).long()
    j = torch.clamp(graph.edges_ij[:, 1], min=0).long()
    m = se3.se3_inverse(graph.rel) @ se3.se3_inverse(poses[i]) @ poses[j]
    return se3.se3_log(m), i, j


_adjoint = se3.adjoint  # SE(3) adjoint (..., 6, 6) for twist order (v, w)


def _dcs_scale(e, lam, dcs, dtype):
    """Per-edge Dynamic Covariance Scaling factors s_e in (0, 1]
    (Agarwal et al., ICRA'13): s_e = min(1, 2*phi / (phi + chi2_e)), applied
    as Lambda_e <- s_e^2 Lambda_e on the edges `loop_w` marks.  A consistent
    loop closure keeps s ~ 1; a wrong one is driven toward 0."""
    loop_w, phi = dcs
    c_e = torch.einsum("ei,eil,el->e", e, lam, e)
    s = torch.clamp(2.0 * phi / torch.clamp(phi + c_e, min=1e-12), max=1.0)
    return torch.where(loop_w, s, torch.ones_like(s)).to(dtype)


def _incidence(i, j, n: int, dtype):
    """(D, P): the (E, N) signed and unsigned incidence matrices S_j - S_i
    and S_j + S_i of the edge list (see the module doc)."""
    s_i = torch.nn.functional.one_hot(i, n).to(dtype)
    s_j = torch.nn.functional.one_hot(j, n).to(dtype)
    return s_j - s_i, s_j + s_i


def _edge_terms(poses, graph: PoseGraph, dcs=None):
    """Per-edge quantities shared by chi2 / gradient / matvec:
    m_e = a_e^T Lambda_e a_e (E, 6, 6), the b contributions (E, 6), chi2,
    and the vertex indices."""
    e, i, j = _edge_residuals(poses, graph)
    w = graph.emask.to(poses.dtype)
    # first-order jacobian of e wrt left-multiplicative updates on T_i/T_j:
    # e(d) ~ e0 + Adj(T_j^-1) (d_j - d_i); J_j = a, J_i = -a
    a = _adjoint(se3.se3_inverse(poses[j]))
    lam = graph.info * w[:, None, None]
    if dcs is not None:
        s = _dcs_scale(e, lam, dcs, poses.dtype)
        lam = lam * (s * s)[:, None, None]
    aw = torch.einsum("eki,ekl->eil", a, lam)  # A^T * info
    m_e = torch.einsum("eil,elm->eim", aw, a)  # (E, 6, 6) PSD blocks
    b_j = torch.einsum("eil,el->ei", aw, e)
    chi2 = torch.sum(torch.einsum("ei,eil,el->e", e, lam, e))
    return m_e, b_j, chi2, i, j


def _prior_diag(graph: PoseGraph, dtype):
    """(N, 6, 6): the gauge prior on vertex 0 and a tiny prior on live (a
    unit one on padded) vertices, so H stays SPD."""
    eye6 = torch.eye(6, dtype=dtype, device=graph.vmask.device)
    # 1e-6 rounded to `dtype`, not to float32 first
    one = torch.ones_like(graph.vmask, dtype=dtype)
    scale = torch.where(graph.vmask, 1e-6 * one, one)
    prior = scale[:, None, None] * eye6
    prior[0] += 1e6 * eye6
    return prior


def _graph_normal_equations(poses, graph: PoseGraph, dcs=None):
    """Assemble H (N*6, N*6), b (N*6) and total chi2."""
    n = poses.shape[0]
    h_jj, b_j, chi2, i, j = _edge_terms(poses, graph, dcs)
    d, _ = _incidence(i, j, n, poses.dtype)
    # blocks (N, 6, N, 6): +h at (j, j) and (i, i), -h at (i, j) and (j, i)
    h = torch.einsum("ea,eb,eij->aibj", d, d, h_jj)
    b = d.mT @ b_j
    idx = torch.arange(n, device=poses.device)
    h[idx, :, idx, :] += _prior_diag(graph, poses.dtype)
    return h.reshape(n * 6, n * 6), b.reshape(-1), chi2


def _lm_loop(graph: PoseGraph, max_iters: int, lm_lambda0, lm_step, chi2_of, step_of):
    """The LM schedule both solvers share: `step_of(poses, lam)` gives
    (delta (N, 6), chi2 at poses), `chi2_of(poses)` the cost, all in the
    graph's dtype.  One host sync per iteration: whether the step was
    taken and the loop condition's `done`, read together."""
    poses = graph.poses
    lam = torch.tensor(lm_lambda0, dtype=poses.dtype, device=poses.device)
    chi2 = chi2_of(poses)
    iters, done = 0, False
    while iters < max_iters and not done:
        delta, chi2 = step_of(poses, lam)
        new_poses = se3.se3_exp(delta) @ poses
        chi2_new = chi2_of(new_poses)
        improved = chi2_new < chi2
        poses = torch.where(improved, new_poses, poses)
        lam = torch.where(improved, lam / lm_step, lam * lm_step)
        rel_impr = (chi2 - chi2_new) / torch.clamp(chi2, min=1e-12)
        chi2 = torch.where(improved, chi2_new, chi2)
        iters += 1
        taken, done = torch.stack((improved, improved & (rel_impr < 1e-6))).tolist()
        LM_COUNTS["iter"] += 1
        LM_COUNTS["reject"] += not taken
    return poses, chi2, iters


def optimize_pose_graph(
    graph: PoseGraph,
    max_iters: int = 10,
    lm_lambda0: float = 1e-5,
    lm_step: float = 10.0,
    loop_mask: torch.Tensor | None = None,
    dcs_phi: float = 10.0,
    dtype: str | torch.dtype | None = None,
):
    """Levenberg-Marquardt over the whole graph with a dense solve; returns
    (poses, chi2, iters): tensors on the graph's device in the solve's
    precision, and a Python int.

    loop_mask: optional (E,) bool marking loop-closure edges; when given,
    those edges are robustified with Dynamic Covariance Scaling at kernel
    width `dcs_phi` (odometry edges stay hard), so wrong loop closures are
    suppressed instead of folding the trajectory (see `_dcs_scale`).
    dtype: the precision of the whole solve (module doc)."""
    g = _in_dtype(graph, dtype)
    n = g.poses.shape[0]
    dcs = None if loop_mask is None else (loop_mask, dcs_phi)
    eye = torch.eye(n * 6, dtype=g.poses.dtype, device=g.poses.device)

    def step(poses, lam):
        h, b, chi2 = _graph_normal_equations(poses, g, dcs)
        damped = h + lam * torch.diag(torch.diagonal(h)) + 1e-9 * eye
        delta = -torch.linalg.solve_ex(damped, b[:, None])[0][:, 0]
        return delta.reshape(n, 6), chi2

    return _lm_loop(
        g, max_iters, lm_lambda0, lm_step,
        lambda poses: _edge_terms(poses, g, dcs)[2], step,
    )


def graph_chi2(graph: PoseGraph) -> torch.Tensor:
    return _edge_terms(graph.poses, graph)[2]


def loop_closure_switches(
    graph: PoseGraph,
    poses: torch.Tensor,
    loop_mask: torch.Tensor,
    dcs_phi: float = 10.0,
) -> torch.Tensor:
    """Per-edge DCS switch values s_e in (0, 1] at the given solution.
    Edges with s well below 1 (e.g. < 0.25) are inconsistent loop closures;
    callers prune them by clearing `emask`."""
    e, _, _ = _edge_residuals(poses, graph)
    lam = graph.info * graph.emask.to(poses.dtype)[:, None, None]
    return _dcs_scale(e, lam, (loop_mask, dcs_phi), poses.dtype)


# ----------------------------------------------------- matrix-free PCG path


def _hx(m_e, d, prior, lm_diag, x):
    """H @ x without materializing H: the graph Laplacian structure
    y_j += m_e (x_j - x_i), y_i -= m_e (x_j - x_i), plus the diagonal priors
    and the LM damping term.  `d` is the signed incidence matrix."""
    y = d.mT @ torch.einsum("eil,el->ei", m_e, d @ x)
    return y + torch.einsum("nil,nl->ni", prior + lm_diag, x)


def _block_diag(m_e, p, prior, lm_diag):
    """Block-diagonal of H (N, 6, 6) for the Jacobi preconditioner; `p` is
    the unsigned incidence matrix."""
    return torch.einsum("ea,eij->aij", p, m_e) + prior + lm_diag


def _pcg(matvec, precond, b, iters: int, tol: float):
    """Pipelined (Chronopoulos-Gear) preconditioned CG on H x = b (H SPD):
    textbook PCG in exact arithmetic, with both scalars of an update,
    gamma = (r, u) and delta = (w, u), from one reduction over a stacked
    (2, N, 6) tensor, and the convergence test on gamma (the M-norm of r).
    Returns (x, iterations); one host sync per iteration."""
    x = torch.zeros_like(b)
    r = b
    u = precond(r)
    w = matvec(u)
    gd = torch.sum(torch.stack([r, w]) * u[None], dim=(1, 2))
    gamma, delta = gd[0], gd[1]
    alpha = gamma / torch.clamp(delta, min=1e-30)
    floor = tol * tol * torch.clamp(gamma, min=1e-30)
    p, s, n_it = u, w, 0
    while n_it < iters and bool(gamma > floor):
        x = x + alpha * p
        r = r - alpha * s
        u = precond(r)
        w = matvec(u)
        gd = torch.sum(torch.stack([r, w]) * u[None], dim=(1, 2))
        gamma_new, delta = gd[0], gd[1]
        beta = gamma_new / torch.clamp(gamma, min=1e-30)
        alpha = gamma_new / torch.clamp(
            delta - beta * gamma_new / torch.clamp(alpha, min=1e-30), min=1e-30
        )
        p = u + beta * p
        s = w + beta * s
        gamma = gamma_new
        n_it += 1
    return x, n_it


def optimize_pose_graph_pcg(
    graph: PoseGraph,
    max_iters: int = 10,
    cg_iters: int = 100,
    cg_tol: float = 1e-6,
    lm_lambda0: float = 1e-5,
    lm_step: float = 10.0,
    loop_mask: torch.Tensor | None = None,
    dcs_phi: float = 10.0,
    cg_counts: list | None = None,
    dtype: str | torch.dtype | None = None,
):
    """LM with a matrix-free block-Jacobi PCG linear solver: the residual
    model, LM schedule and precision (`dtype`) of `optimize_pose_graph`, but
    the (6N, 6N) normal matrix is never built.  `cg_counts`, when given,
    receives each LM iteration's CG iteration count.  Returns (poses, chi2,
    iters)."""
    g = _in_dtype(graph, dtype)
    n = g.poses.shape[0]
    dt = g.poses.dtype
    prior = _prior_diag(g, dt)
    dcs = None if loop_mask is None else (loop_mask, dcs_phi)
    eye6 = torch.eye(6, dtype=dt, device=g.poses.device)

    def step(poses, lam):
        m_e, b_j, chi2, i, j = _edge_terms(poses, g, dcs)
        d, p = _incidence(i, j, n, dt)
        b = d.mT @ b_j
        bd0 = _block_diag(m_e, p, prior, 0.0 * prior)
        lm_diag = lam * bd0 * eye6  # damp the diagonal
        bd_inv = torch.linalg.inv_ex(bd0 + lm_diag + 1e-9 * eye6)[0]
        delta, n_cg = _pcg(
            lambda x: _hx(m_e, d, prior, lm_diag, x),
            lambda r: torch.einsum("nil,nl->ni", bd_inv, r),
            -b, cg_iters, cg_tol,
        )
        if cg_counts is not None:
            cg_counts.append(n_cg)
        return delta, chi2

    return _lm_loop(
        g, max_iters, lm_lambda0, lm_step,
        lambda poses: _edge_terms(poses, g, dcs)[2], step,
    )
