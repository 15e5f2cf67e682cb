"""The map-scale SLAM stages sharded over ranks (twin of
`rgbd360_tpu/parallel/sharded.py`), on `torch.distributed`.

The reference shards the map's keyframe, edge and observation axes over a
`jax.sharding.Mesh` inside one controller, with XLA collectives doing the
reductions.  The port is SPMD: one process per rank, each holding the
replicated map, its poses and its graph.  Rank r computes block
[r*n/W, (r+1)*n/W) of the sharded axis (what `P("kf")` gives device r of a
W-device mesh), and the outputs the reference leaves sharded come back
GATHERED on every rank, so callers read them as they read the
single-device path's.

  * `sharded_plane_scan`: the loop closer's and relocaliser's batch plane
    matcher with the keyframe axis sharded;
  * `sharded_pair_align`: one dense GN sweep for a batch of pairs, sharded
    over pairs;
  * `distributed_pose_graph`: pose-graph LM with the EDGE set sharded: each
    rank assembles the normal equations of its edges, a psum forms the
    global ones, the dense solve runs replicated;
  * `distributed_pose_graph_pcg`: edge- AND vertex-sharded matrix-free
    LM-PCG (pipelined Chronopoulos-Gear CG, 3 collectives per CG step);
  * `distributed_plane_ba`: observation-sharded planar BA (Schur complement
    over plane landmarks).

The three collectives the reference uses are built on `all_reduce` alone
(the one collective that every backend supports on CUDA tensors, gloo
included): `psum` is the all-reduce; `all_gather` (tiled) is the
all-reduce of a zero buffer holding the rank's block at its offset, which
is exact (a sum of one value and zeros); `psum_scatter` (tiled) is the
all-reduce followed by taking the rank's block.  Every loop exit (an LM
accept, a CG convergence test) reads an all-reduced scalar, which is the
same on every rank, so all ranks leave on the same iteration.

A `Mesh` built without a process group is a world of one: its collectives
are the identity and every function here is its single-device
counterpart's math.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from dataclasses import dataclass

import torch
import torch.distributed as dist

from rgbd360_tpu_torch.config import MatcherConfig
from rgbd360_tpu_torch.registration.planes import (
    PLANAR_3DOF,
    _matched_area,
    match_planes,
    pose_from_matches,
)
from rgbd360_tpu_torch.slam import plane_ba as B
from rgbd360_tpu_torch.slam.graph import (
    PoseGraph,
    _edge_terms,
    _in_dtype,
    _incidence,
    _lm_loop,
    _prior_diag,
)

# Collective calls made by this module, by kind (`psum`, `all_gather`,
# `psum_scatter`); each is ONE `all_reduce` on the wire.  A caller reads the
# difference around a region to count a region's collectives.
COLLECTIVES: Counter = Counter()


@dataclass(frozen=True, eq=False)
class Mesh:
    """A one-axis mesh of ranks: the process group (None for a world of one
    without `torch.distributed`), this process's rank in it, its size, the
    axis name, and the device this rank computes on (None: the device of
    the tensors it is given)."""

    group: object | None
    rank: int
    size: int
    axis: str = "kf"
    device: torch.device | None = None

    def block(self, n: int, what: str = "axis") -> tuple[int, int]:
        """This rank's [start, stop) of a sharded axis of length n."""
        if n % self.size:
            raise ValueError(
                f"the sharded {what} ({n}) must be divisible by the mesh size ({self.size})"
            )
        b = n // self.size
        return self.rank * b, (self.rank + 1) * b


def make_mesh(n_devices: int | None = None, axis: str = "kf", device=None, group=None) -> Mesh:
    """The mesh over `group` (the default process group when None), or a
    world of one when `torch.distributed` is not initialized.  `n_devices`,
    when given, must equal the group's size: the mesh never shrinks or
    falls back to another set of devices."""
    if group is not None or dist.is_initialized():
        g = group if group is not None else dist.group.WORLD
        size, rank = dist.get_world_size(g), dist.get_rank(g)
    else:
        g, size, rank = None, 1, 0
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"a mesh of {n_devices} ranks was asked for, but the process group has {size}"
        )
    return Mesh(g, rank, size, axis, None if device is None else torch.device(device))


# ----------------------------------------------------------- collectives


def _all_reduce(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    if mesh.group is None:
        return x
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous().clone()
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=mesh.group)
    return wire.to(torch.bool) if x.dtype == torch.bool else wire


def psum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the mesh, on every rank."""
    COLLECTIVES["psum"] += 1
    return _all_reduce(mesh, x)


def all_gather(mesh: Mesh, block: torch.Tensor) -> torch.Tensor:
    """The ranks' blocks concatenated along dim 0 in rank order (tiled), on
    every rank: the all-reduce of a zero buffer holding this rank's block at
    its offset (exact: every element is one rank's value plus zeros).  A
    bool block comes back bool."""
    COLLECTIVES["all_gather"] += 1
    if mesh.group is None:
        return block
    b = block.shape[0]
    wire = block.to(torch.uint8) if block.dtype == torch.bool else block
    full = torch.zeros((mesh.size * b,) + tuple(block.shape[1:]), dtype=wire.dtype,
                       device=block.device)
    full[mesh.rank * b:(mesh.rank + 1) * b] = wire
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=mesh.group)
    return full.to(torch.bool) if block.dtype == torch.bool else full


def psum_scatter(mesh: Mesh, full: torch.Tensor) -> torch.Tensor:
    """This rank's block (dim 0, tiled) of the sum of `full` over the mesh."""
    COLLECTIVES["psum_scatter"] += 1
    lo, hi = mesh.block(full.shape[0], "scatter dimension")
    return _all_reduce(mesh, full)[lo:hi]


def _gather_packed(mesh: Mesh, parts: list) -> list:
    """All-gather several per-row float32 blocks (the same leading length)
    in ONE collective: packed side by side, gathered, split back into the
    original shapes and dtypes (integer and bool values below 2^24 are
    exact in float32)."""
    rows = parts[0].shape[0]
    flat = torch.cat([p.reshape(rows, -1).to(torch.float32) for p in parts], dim=1)
    full = all_gather(mesh, flat)
    out, col = [], 0
    for p in parts:
        k = p[0].numel() if rows else 0
        piece = full[:, col:col + k].reshape((full.shape[0],) + tuple(p.shape[1:]))
        out.append(piece > 0.5 if p.dtype == torch.bool else piece.to(p.dtype))
        col += k
    return out


def _rows(x, lo: int, hi: int):
    """The rows [lo, hi) of every field of a dataclass of tensors."""
    return dataclasses.replace(
        x, **{f.name: getattr(x, f.name)[lo:hi] for f in dataclasses.fields(x)}
    )


# ------------------------------------------------------------- plane scan


def sharded_plane_scan(
    mesh: Mesh, map_planes, query, gate: torch.Tensor, cfg: MatcherConfig,
    mode: int = PLANAR_3DOF,
):
    """Batch plane matching of one query against all keyframes, with the
    leading keyframe axis sharded: each rank matches the query against its
    block.  Returns (n_matches, area, pose, info, observable), gathered on
    every rank (one collective)."""
    lo, hi = mesh.block(gate.shape[0], "keyframe axis")
    local = _rows(map_planes, lo, hi)
    pairs, n = match_planes(local, query, cfg, mode)
    pose, info, obs = pose_from_matches(local, query, pairs, n)
    g = gate[lo:hi]
    n = torch.where(g, n, torch.zeros_like(n))
    return tuple(_gather_packed(mesh, [n, _matched_area(local, pairs), pose, info, obs & g]))


# ------------------------------------------------------------ pair align


def sharded_pair_align(mesh: Mesh, src_gray, src_depth, trg_pack, poses, cfg, method):
    """One dense GN sweep for a batch of pairs, sharded over the pair axis.
    Returns per-pair (hessian, gradient, mean_err), gathered on every rank
    (one collective)."""
    from rgbd360_tpu_torch.registration import dense as D

    lo, hi = mesh.block(poses.shape[0], "pair axis")
    gray, pts, valid = D._flat_points(src_depth[lo:hi], src_gray[lo:hi], cfg)
    h, g, stats = D._hess_grad_packed(gray, pts, valid, trg_pack[lo:hi], poses[lo:hi], cfg, method)
    return tuple(_gather_packed(mesh, [h, g, stats["mean_err"]]))


# ------------------------------------------------------- distributed graph


def _edge_shard(mesh: Mesh, graph: PoseGraph) -> PoseGraph:
    """This rank's block of the graph's edges, with every vertex live (the
    vertex mask enters only the replicated prior)."""
    lo, hi = mesh.block(graph.edges_ij.shape[0], "edge capacity")
    return PoseGraph(
        poses=graph.poses,
        vmask=torch.ones_like(graph.vmask),
        edges_ij=graph.edges_ij[lo:hi],
        rel=graph.rel[lo:hi],
        info=graph.info[lo:hi],
        emask=graph.emask[lo:hi],
    )


def distributed_pose_graph(
    mesh: Mesh,
    graph: PoseGraph,
    max_iters: int = 10,
    lm_lambda0: float = 1e-5,
    lm_step: float = 10.0,
):
    """Pose-graph LM with edge-sharded normal-equation assembly.

    Poses are replicated; each rank assembles the normal equations of its
    block of edges; ONE psum per assembly forms the global H, b and chi2 on
    every rank; the dense solve runs replicated.  Returns (poses, chi2,
    iters) as `slam.graph.optimize_pose_graph` does.  The edge capacity
    must divide by the mesh size."""
    n = graph.poses.shape[0]
    dtype = graph.poses.dtype
    local = _edge_shard(mesh, graph)
    prior = _prior_diag(graph, dtype)
    idx = torch.arange(n, device=graph.poses.device)
    eye = torch.eye(n * 6, dtype=dtype, device=graph.poses.device)

    def normal_eq(poses):
        h_jj, b_j, chi2, i, j = _edge_terms(poses, local)
        d, _ = _incidence(i, j, n, dtype)
        h = torch.einsum("ea,eb,eij->aibj", d, d, h_jj)
        b = d.mT @ b_j
        # the BA collective: one reduction of the partial normal equations
        red = psum(mesh, torch.cat([h.reshape(-1), b.reshape(-1), chi2.reshape(1)]))
        h = red[: n * n * 36].reshape(n, 6, n, 6).clone()
        h[idx, :, idx, :] += prior
        return h.reshape(n * 6, n * 6), red[n * n * 36:-1], red[-1]

    def step(poses, lam):
        h, b, chi2 = normal_eq(poses)
        damped = h + lam * torch.diag(torch.diagonal(h)) + 1e-9 * eye
        delta = -torch.linalg.solve_ex(damped, b[:, None])[0][:, 0]
        return delta.reshape(n, 6), chi2

    def chi2_of(poses):
        return psum(mesh, _edge_terms(poses, local)[2])

    return _lm_loop(graph, max_iters, lm_lambda0, lm_step, chi2_of, step)


def _pcg_sharded(mesh: Mesh, matvec, precond, b, iters: int, tol: float):
    """Pipelined (Chronopoulos-Gear) PCG whose state vectors are sharded by
    vertex: the recurrence and the M-norm stopping rule of `slam.graph._pcg`
    (gamma = (r, M^-1 r) against tol^2 gamma_0), with both scalars of an
    update, gamma and delta, from ONE psum.  A CG step costs 3 collectives:
    the all_gather and psum_scatter inside `matvec`, and that psum.  The
    stopping test reads the all-reduced gamma (one host sync per
    iteration), the same on every rank.  Returns (x block, iterations)."""

    def dots2(r, w, u):  # `slam.graph._pcg`'s reduction, on the block
        return psum(mesh, torch.sum(torch.stack([r, w]) * u[None], dim=(1, 2)))

    x = torch.zeros_like(b)
    r = b
    u = precond(r)
    w = matvec(u)
    gd = dots2(r, w, u)
    gamma, delta = gd[0], gd[1]
    alpha = gamma / torch.clamp(delta, min=1e-30)
    floor = tol * tol * torch.clamp(gamma, min=1e-30)
    p, s, n_it = u, w, 0
    while n_it < iters and bool(gamma > floor):
        x = x + alpha * p
        r = r - alpha * s
        u = precond(r)
        w = matvec(u)
        gd = dots2(r, w, u)
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


def distributed_pose_graph_pcg(
    mesh: Mesh,
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
    """Edge- AND vertex-sharded, matrix-free pose-graph LM-PCG.

    The edge arrays shard over the mesh, and so do the CG state vectors and
    the block-Jacobi preconditioner (by vertex); poses stay replicated (both
    endpoints of a local edge need them).  Each H-matvec is all_gather(x) ->
    local edge sweep -> psum_scatter(y).  With `loop_mask`, the marked edges
    are robustified by DCS on the local shard (a per-edge formula).  The
    residual model, LM schedule and stopping rules are
    `slam.graph.optimize_pose_graph_pcg`'s, and so is its precision
    (`dtype`); `cg_counts`, when given, receives each LM iteration's CG
    count.  Returns (poses, chi2, iters).  The vertex and edge capacities
    must divide by the mesh size."""
    graph = _in_dtype(graph, dtype)
    n = graph.poses.shape[0]
    e_cap = graph.edges_ij.shape[0]
    if n % mesh.size or e_cap % mesh.size:
        raise ValueError(
            f"graph capacity (N={n}, E={e_cap}) must be divisible by the mesh size ({mesh.size})"
        )
    dtype = graph.poses.dtype
    vlo, vhi = mesh.block(n, "vertex capacity")
    elo, ehi = mesh.block(e_cap, "edge capacity")
    local = _edge_shard(mesh, graph)
    prior_sh = _prior_diag(graph, dtype)[vlo:vhi]
    dcs = None if loop_mask is None else (loop_mask[elo:ehi], dcs_phi)
    eye6 = torch.eye(6, dtype=dtype, device=graph.poses.device)

    def step(poses, lam):
        m_e, b_j, chi2_l, i, j = _edge_terms(poses, local, dcs)
        d, p = _incidence(i, j, n, dtype)
        # the right-hand side, the Jacobi blocks and chi2 in ONE reduction;
        # each rank keeps its vertex block of the first two
        red = psum(mesh, torch.cat([
            (d.mT @ b_j).reshape(-1),
            torch.einsum("ea,eij->aij", p, m_e).reshape(-1),
            chi2_l.reshape(1),
        ]))
        b_sh = red[: n * 6].reshape(n, 6)[vlo:vhi]
        bd0_sh = red[n * 6:-1].reshape(n, 6, 6)[vlo:vhi] + prior_sh
        chi2 = red[-1]
        lm_diag_sh = lam * bd0_sh * eye6
        bd_inv_sh = torch.linalg.inv_ex(bd0_sh + lm_diag_sh + 1e-9 * eye6)[0]

        def matvec(x_sh):
            x = all_gather(mesh, x_sh)  # (N, 6)
            y = d.mT @ torch.einsum("eil,el->ei", m_e, d @ x)
            return psum_scatter(mesh, y) + torch.einsum("nil,nl->ni", prior_sh + lm_diag_sh, x_sh)

        delta_sh, n_cg = _pcg_sharded(
            mesh, matvec, lambda r: torch.einsum("nil,nl->ni", bd_inv_sh, r),
            -b_sh, cg_iters, cg_tol,
        )
        if cg_counts is not None:
            cg_counts.append(n_cg)
        return all_gather(mesh, delta_sh), chi2

    def chi2_of(poses):
        return psum(mesh, _edge_terms(poses, local, dcs)[2])

    return _lm_loop(graph, max_iters, lm_lambda0, lm_step, chi2_of, step)


# ------------------------------------------------------ distributed plane BA


def distributed_plane_ba(
    mesh: Mesh,
    prob,
    max_iters: int = 10,
    cg_iters: int = 50,
    cg_tol: float = 1e-6,
    lm_lambda0: float = 1e-4,
    lm_step: float = 10.0,
):
    """Observation-sharded planar bundle adjustment (Schur complement over
    plane landmarks, reduced over the mesh).

    The OBSERVATION arrays shard across ranks; poses and plane landmarks
    stay replicated.  The blocks of the normal equations are one psum of
    each rank's sums; every Schur matvec is: local observation sweep ->
    psum of the (M, 4) landmark intermediate -> local sweep -> psum of the
    (N, 6) pose result.  The solver is `slam.plane_ba.optimize_plane_ba`'s
    (`plane_ba._solve` with these reductions).  The observation count must
    divide by the mesh size (pad with zero-weight observations)."""
    lo, hi = mesh.block(prob.obs.shape[0], "observation count (pad with w=0 observations)")
    local = B.PlaneBAProblem(
        poses=prob.poses, planes=prob.planes, obs_kf=prob.obs_kf[lo:hi],
        obs_pl=prob.obs_pl[lo:hi], obs=prob.obs[lo:hi], w=prob.w[lo:hi],
    )
    return B._solve(
        local, max_iters, cg_iters, cg_tol, lm_lambda0, lm_step,
        reduce=lambda x: psum(mesh, x),
    )
