"""Planar bundle adjustment: joint poses + plane-landmark refinement (twin of
`rgbd360_tpu/slam/plane_ba.py`).

Keyframe poses and GLOBAL plane landmarks are optimized together against
the per-keyframe plane observations the segmentation produces (reference
`Frame360::getPlanes`, `include/Frame360.h:615`; the structure of planar
BA, Zhou et al., "An Efficient Planar Bundle Adjustment Algorithm").

Model.  World plane k: (n_k, d_k) with n_k . x + d_k = 0, |n_k| = 1.
Keyframe i pose T_i (world <- kf).  Its prediction in the keyframe frame:

    n_ik = R_i^T n_k,      d_ik = n_k . t_i + d_k

Observation: the segmented plane (n_obs, d_obs) in the keyframe frame, with
scalar weight w (e.g. inlier count).  Residual r = [n_ik - n_obs,
d_ik - d_obs] (4,).  Its Jacobians at the zero increment (a left twist
xi = (v, w) on the pose, `se3_exp(xi) @ T`, and an additive 4-vector on
the plane), in closed form (the reference takes them from `jax.jacfwd`):

    d n_ik / d w  = R^T [n]x        d n_ik / d v = 0
    d d_ik / d w  = (t x n)^T       d d_ik / d v = n^T
    d n_ik / d dn = R^T             d d_ik / d dn = t^T,  d d_ik / d dd = 1

Solver.  Gauss-Newton/LM with the SCHUR COMPLEMENT over plane landmarks:
observations couple one pose with one plane only, so H_ll is block-diagonal
(4x4 per plane) and the reduced pose system

    S = H_pp - H_pl H_ll^-1 H_lp

is applied MATRIX-FREE: every S-matvec is two observation sweeps around the
block-diagonal H_ll^-1, O(obs) work, no (6N)^2 matrix; block-Jacobi PCG
solves it and plane updates back-substitute in closed form.  The
reference's scatter-adds by pose and plane id are one-hot incidence
products here (as in `slam/graph.py`), so a solve is bit-identical run to
run on the card; its two `while_loop`s are Python loops with one host sync
per CG and per LM iteration.  Gauge: pose 0 is pinned with a strong prior.
Plane normals are renormalized after each accepted step.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rgbd360_tpu_torch.ops import se3


@dataclass
class PlaneBAProblem:
    """Fixed-capacity planar BA problem.

    poses:   (N, 4, 4) initial keyframe poses (world <- kf)
    planes:  (M, 4) initial world planes [nx, ny, nz, d], |n| = 1
    obs_kf:  (O,) int64 keyframe index per observation
    obs_pl:  (O,) int64 plane index per observation
    obs:     (O, 4) observed [n (kf frame), d]
    w:       (O,) float32 observation weights (0 = padding)
    """

    poses: torch.Tensor
    planes: torch.Tensor
    obs_kf: torch.Tensor
    obs_pl: torch.Tensor
    obs: torch.Tensor
    w: torch.Tensor


def predict_plane(pose: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    """World plane -> keyframe-frame plane [n, d] under pose (world <- kf);
    batched over leading axes."""
    r = pose[..., :3, :3]
    t = pose[..., :3, 3]
    n_w = plane[..., :3]
    n_c = (n_w[..., None, :] @ r)[..., 0, :]  # R^T n
    d_c = torch.sum(n_w * t, dim=-1) + plane[..., 3]
    return torch.cat([n_c, d_c[..., None]], dim=-1)


def _obs_terms(poses, planes, prob):
    """Per-observation residuals (O, 4), pose and plane Jacobians (O, 4, 6)
    and (O, 4, 4) at the zero increment (closed form, see the module doc),
    the weights, and the weighted chi2."""
    p_i = poses[prob.obs_kf]
    l_k = planes[prob.obs_pl]
    r = predict_plane(p_i, l_k) - prob.obs
    rot_t = p_i[:, :3, :3].mT
    t = p_i[:, :3, 3]
    n = l_k[:, :3]
    o = n.shape[0]
    zeros3 = torch.zeros((o, 3, 3), dtype=n.dtype, device=n.device)
    top = torch.cat([zeros3, rot_t @ se3.skew(n)], dim=-1)  # (O, 3, 6)
    bottom = torch.cat([n, torch.linalg.cross(t, n)], dim=-1)[:, None, :]  # (O, 1, 6)
    jp = torch.cat([top, bottom], dim=-2)
    zcol = torch.zeros((o, 3, 1), dtype=n.dtype, device=n.device)
    one = torch.ones((o, 1, 1), dtype=n.dtype, device=n.device)
    jl = torch.cat([torch.cat([rot_t, zcol], dim=-1),
                    torch.cat([t[:, None, :], one], dim=-1)], dim=-2)
    w = prob.w
    chi2 = torch.sum(w * torch.sum(r * r, dim=-1))
    return r, jp, jl, w, chi2


def _onehot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(O, n) incidence of observations on poses or planes (one-hot rows):
    the scatter-adds by id are products with its transpose."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).to(dtype)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _normal_blocks(poses, planes, prob, lam, reduce=_identity):
    """All GN blocks needed by the Schur solve: per-observation Jacobians,
    the incidence matrices `s_p` (O, N) and `s_l` (O, M), residual
    gradients b_p (N, 6) / b_l (M, 4), the damped block diagonals hpp
    (N, 6, 6) and hll_inv (M, 4, 4), and chi2.  `reduce` sums the
    observation sums over the shards of an observation-sharded problem
    (ONE call for all of them; the identity on one device) and is kept in
    the blocks for the matvecs."""
    n = poses.shape[0]
    m = planes.shape[0]
    dtype = poses.dtype
    r, jp, jl, w, chi2 = _obs_terms(poses, planes, prob)
    s_p = _onehot(prob.obs_kf, n, dtype)
    s_l = _onehot(prob.obs_pl, m, dtype)
    wj = w[:, None, None]

    sums = reduce(torch.cat([
        (s_p.mT @ (wj * jp.mT @ jp).reshape(-1, 36)).reshape(-1),
        (s_l.mT @ (wj * jl.mT @ jl).reshape(-1, 16)).reshape(-1),
        (s_p.mT @ (w[:, None] * (jp.mT @ r[..., None])[..., 0])).reshape(-1),
        (s_l.mT @ (w[:, None] * (jl.mT @ r[..., None])[..., 0])).reshape(-1),
        chi2.reshape(1),
    ]))
    hpp, hll, b_p, b_l, chi2 = torch.split(sums, [36 * n, 16 * m, 6 * n, 4 * m, 1])
    hpp, hll = hpp.reshape(n, 6, 6), hll.reshape(m, 4, 4)
    b_p, b_l, chi2 = b_p.reshape(n, 6), b_l.reshape(m, 4), chi2[0]

    # gauge prior on pose 0 + floor so empty poses/planes stay invertible
    eye6 = torch.eye(6, dtype=dtype, device=poses.device)
    hpp = hpp + 1e-6 * eye6
    hpp[0] += 1e8 * eye6
    hpp = hpp + lam * hpp * eye6  # LM damping on the diagonal
    eye4 = torch.eye(4, dtype=dtype, device=poses.device)
    hll = hll + 1e-6 * eye4
    hll = hll + lam * hll * eye4
    hll_inv = torch.linalg.inv(hll)
    return dict(jp=jp, jl=jl, w=w, s_p=s_p, s_l=s_l, i=prob.obs_kf, k=prob.obs_pl,
                hpp=hpp, hll_inv=hll_inv, b_p=b_p, b_l=b_l, chi2=chi2, reduce=reduce)


def _bmv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., a, b) @ (..., b)."""
    return (a @ x[..., None])[..., 0]


def _hlp(t, x):
    """H_lp x (M, 4): per observation jl^T (jp x_i), summed by plane."""
    return t["reduce"](
        t["s_l"].mT @ (t["w"][:, None] * _bmv(t["jl"].mT, _bmv(t["jp"], x[t["i"]])))
    )


def _hpl(t, y_l):
    """H_pl y_l (N, 6): per observation jp^T (jl y_k), summed by pose."""
    return t["reduce"](
        t["s_p"].mT @ (t["w"][:, None] * _bmv(t["jp"].mT, _bmv(t["jl"], y_l[t["k"]])))
    )


def _schur_matvec(t, x):
    """S @ x = H_pp x - H_pl H_ll^-1 H_lp x, matrix-free over observations."""
    y_l = _bmv(t["hll_inv"], _hlp(t, x))
    return _bmv(t["hpp"], x) - _hpl(t, y_l)


def _schur_rhs(t):
    """-b_p + H_pl H_ll^-1 b_l (the reduced right-hand side)."""
    return -t["b_p"] + _hpl(t, _bmv(t["hll_inv"], t["b_l"]))


def _back_substitute(t, dx_p):
    """delta_l = -H_ll^-1 (b_l + H_lp dx_p)."""
    return -_bmv(t["hll_inv"], t["b_l"] + _hlp(t, dx_p))


def _pcg(matvec, precond, b, iters: int, tol: float):
    """Preconditioned CG on S x = b, the reference's textbook recurrence;
    stops after `iters` iterations or once |r|^2 <= tol^2 |b|^2 (one host
    sync per iteration).  Returns (x, iterations)."""
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    b2 = torch.sum(b * b)
    it = 0
    while it < iters and bool(torch.sum(r * r) > tol * tol * b2):
        hp = matvec(p)
        alpha = rz / torch.clamp(torch.sum(p * hp), min=1e-30)
        x = x + alpha * p
        r = r - alpha * hp
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + beta * p
        rz = rz_new
        it += 1
    return x, it


def _solve(prob, max_iters, cg_iters, cg_tol, lm_lambda0, lm_step, reduce=_identity):
    """The LM loop of `optimize_plane_ba` over the observations of `prob`,
    their sums taken through `reduce` (see `_normal_blocks`): the identity
    here, a psum over the mesh in `parallel.sharded.distributed_plane_ba`.
    Every quantity the loop and the CG test read is reduced, so all shards
    take the same steps."""
    poses, planes = prob.poses, prob.planes
    lam = torch.tensor(lm_lambda0, dtype=poses.dtype, device=poses.device)
    chi2 = reduce(_obs_terms(poses, planes, prob)[4])
    iters, done = 0, False
    while iters < max_iters and not done:
        t = _normal_blocks(poses, planes, prob, lam, reduce)
        hpp_inv = torch.linalg.inv(t["hpp"])
        dx_p, _ = _pcg(
            lambda x: _schur_matvec(t, x),
            lambda r: _bmv(hpp_inv, r),
            _schur_rhs(t), cg_iters, cg_tol,
        )
        dx_l = _back_substitute(t, dx_p)
        new_poses = se3.se3_exp(dx_p) @ poses
        new_planes = planes + dx_l
        # renormalize plane normals (4-dof overparametrized update)
        norm = torch.clamp(torch.linalg.norm(new_planes[:, :3], dim=1, keepdim=True), min=1e-9)
        new_planes = torch.cat([new_planes[:, :3] / norm, new_planes[:, 3:] / norm], dim=1)
        chi2_new = reduce(_obs_terms(new_poses, new_planes, prob)[4])
        improved = chi2_new < t["chi2"]
        rel_impr = (t["chi2"] - chi2_new) / torch.clamp(t["chi2"], min=1e-12)
        poses = torch.where(improved, new_poses, poses)
        planes = torch.where(improved, new_planes, planes)
        lam = torch.where(improved, lam / lm_step, lam * lm_step)
        chi2 = torch.where(improved, chi2_new, t["chi2"])
        iters += 1
        done = bool(improved & (rel_impr < 1e-8))
    return poses, planes, chi2, iters


def optimize_plane_ba(
    prob: PlaneBAProblem,
    max_iters: int = 10,
    cg_iters: int = 50,
    cg_tol: float = 1e-6,
    lm_lambda0: float = 1e-4,
    lm_step: float = 10.0,
):
    """LM planar BA with matrix-free Schur-complement PCG.

    Returns (poses, planes, chi2, iters): tensors on the problem's device
    and a Python int.  Pose 0 is the gauge.  One host sync per LM
    iteration (its exit test) and per CG iteration."""
    return _solve(prob, max_iters, cg_iters, cg_tol, lm_lambda0, lm_step)


def associate_planes(
    poses, plane_sets, max_planes: int, cos_thresh: float = 0.97, d_thresh: float = 0.15,
    device=None,
):
    """Greedy data association of per-keyframe PlaneSets into global plane
    landmarks using the current pose estimates (host-side, runs once before
    BA; the reference's plane identity tracking is its matched-plane
    bookkeeping in `LabelizeSequence.cpp:129-154`).

    poses: per keyframe a (4, 4) pose (array or tensor); plane_sets: list
    over keyframes of PlaneSet (kf frame).  Returns a PlaneBAProblem on
    `device` (the device of the first plane set when None; capacities:
    len(plane_sets) poses, max_planes landmarks, all valid observations)."""
    if device is None:
        device = plane_sets[0].d.device if plane_sets else "cpu"

    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    poses_np = [host(p) for p in poses]
    globals_n: list[np.ndarray] = []
    globals_d: list[float] = []
    obs_kf, obs_pl, obs, w = [], [], [], []

    for i, ps in enumerate(plane_sets):
        valid = host(ps.valid)
        normals = host(ps.normal)
        ds = host(ps.d)
        ninl = host(ps.n_inliers)
        r = poses_np[i][:3, :3]
        t = poses_np[i][:3, 3]
        for j in np.where(valid)[0]:
            n_kf = normals[j]
            d_kf = float(ds[j])
            # to world: n_w = R n_kf, d_w = d_kf - n_w . t
            n_w = r @ n_kf
            d_w = d_kf - float(n_w @ t)
            # match against existing landmarks
            best = -1
            for g, (gn, gd) in enumerate(zip(globals_n, globals_d)):
                if float(gn @ n_w) > cos_thresh and abs(gd - d_w) < d_thresh:
                    best = g
                    break
            if best < 0:
                if len(globals_n) >= max_planes:
                    continue
                globals_n.append(n_w)
                globals_d.append(d_w)
                best = len(globals_n) - 1
            obs_kf.append(i)
            obs_pl.append(best)
            obs.append(np.concatenate([n_kf, [d_kf]]))
            w.append(max(float(ninl[j]), 1.0))

    planes = np.zeros((max_planes, 4), np.float32)
    for g, (gn, gd) in enumerate(zip(globals_n, globals_d)):
        planes[g, :3] = gn
        planes[g, 3] = gd
    o = len(obs)

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    return PlaneBAProblem(
        poses=put(np.stack(poses_np).astype(np.float32)),
        planes=put(planes),
        obs_kf=put(np.asarray(obs_kf, np.int64), torch.int64),
        obs_pl=put(np.asarray(obs_pl, np.int64), torch.int64),
        obs=put(np.stack(obs).astype(np.float32) if o else np.zeros((0, 4), np.float32)),
        w=put(np.asarray(w, np.float32) if o else np.zeros((0,), np.float32)),
    )
