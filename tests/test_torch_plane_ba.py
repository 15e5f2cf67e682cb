"""Planar BA of the port (`slam/plane_ba.py`) against the reference's
(`rgbd360_tpu/slam/plane_ba.py`) on the same seeded numpy problems: the
six walls of a box room seen from a short walk with yaw (the reference's
own `tests/test_plane_ba.py` scene).

Tolerances.  The closed-form Jacobian blocks against `jax.jacfwd`'s and
`torch.func.jacfwd`'s: 1e-6 absolute (entries are O(1) rotations, offsets
and lever arms; the two differ by the f32 rounding of one product).  One
Schur-PCG step against the explicit dense (6N+4M) solve: 1e-4 (the
reference's bound).  A whole LM solve against the reference's: poses
2e-5 m / 2e-5 rad and planes 2e-5 on the exact problem, 1e-4 on the
noisy one (the reductions run in another order, and the noisy problem's
pose-0 prior of 1e8 amplifies rounding in the reduced system); chi2
within 1e-3 relative or 1e-9 absolute (the exact problem ends on the f32
noise floor); LM iteration counts equal while chi2 still moves
(`rel_impr < 1e-8` is a coin toss on the noise floor, as in
`slam/graph`).  Data association: integers, equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd360_tpu.slam import plane_ba as JB
from rgbd360_tpu_torch import convert
from rgbd360_tpu_torch.ops import se3 as tse3
from rgbd360_tpu_torch.ops.segmentation import PlaneSet
from rgbd360_tpu_torch.slam import plane_ba as TB

BLOCK_TOL = 1e-6


def _box_planes():
    """Six planes of a 6x8x3 m room (world frame), n.x + d = 0."""
    return np.array(
        [[1, 0, 0, 3.0], [-1, 0, 0, 3.0], [0, 1, 0, 1.5], [0, -1, 0, 1.5],
         [0, 0, 1, 4.0], [0, 0, -1, 4.0]], np.float32)


def _exp(xi) -> np.ndarray:
    return tse3.se3_exp(torch.tensor(np.asarray(xi), dtype=torch.float64)).numpy()


def _predict(pose, plane) -> np.ndarray:
    return np.concatenate([plane[:3] @ pose[:3, :3], [plane[:3] @ pose[:3, 3] + plane[3]]])


def _problem(n_kf=6, noise=0.0, perturb=0.05, seed=0) -> tuple[list, np.ndarray]:
    """(leaves of a PlaneBAProblem in the reference's order, ground truth)."""
    rng = np.random.default_rng(seed)
    planes_gt = _box_planes()
    gt = [np.eye(4)]
    for _ in range(n_kf - 1):
        gt.append(gt[-1] @ _exp([0.25, 0.02, 0.1, 0.01, 0.06, 0.0]))
    gt = np.stack(gt)
    obs_kf, obs_pl, obs, w = [], [], [], []
    for i in range(n_kf):
        for k in range(len(planes_gt)):
            pred = _predict(gt[i], planes_gt[k]) + rng.normal(0, noise, 4)
            pred[:3] /= np.linalg.norm(pred[:3])
            obs_kf.append(i), obs_pl.append(k), obs.append(pred), w.append(100.0)
    poses0 = np.stack([gt[i] @ _exp(rng.normal(0, perturb, 6)) for i in range(n_kf)])
    poses0[0] = gt[0]  # gauge
    planes0 = planes_gt + rng.normal(0, perturb, planes_gt.shape)
    planes0[:, :3] /= np.linalg.norm(planes0[:, :3], axis=1, keepdims=True)
    leaves = [poses0.astype(np.float32), planes0.astype(np.float32),
              np.asarray(obs_kf, np.int32), np.asarray(obs_pl, np.int32),
              np.asarray(obs, np.float32), np.asarray(w, np.float32)]
    return leaves, gt


def _both(leaves):
    return (JB.PlaneBAProblem(*(jnp.asarray(a) for a in leaves)),
            convert.plane_ba_problem_from_numpy(leaves))


def _gaps(a, b) -> tuple[float, float]:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    dt = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1).max()
    dr = np.abs(a[:, :3, :3] - b[:, :3, :3]).max()
    return float(dt), float(dr)


def test_converters_round_trip():
    leaves, _ = _problem(n_kf=3)
    back = convert.plane_ba_problem_to_numpy(convert.plane_ba_problem_from_numpy(leaves))
    for a, b in zip(leaves, back):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_obs_blocks_match_jacfwd():
    """The closed-form 4x6 and 4x4 blocks equal the reference's `jax.jacfwd`
    blocks and `torch.func.jacfwd` of the port's own residual."""
    leaves, _ = _problem(n_kf=4, noise=0.003, perturb=0.2, seed=5)
    jprob, tprob = _both(leaves)
    r_j, jp_j, jl_j, w_j, chi2_j = jax.device_get(JB._obs_terms(jprob.poses, jprob.planes, jprob))
    r_t, jp_t, jl_t, w_t, chi2_t = TB._obs_terms(tprob.poses, tprob.planes, tprob)
    np.testing.assert_allclose(r_t.numpy(), r_j, atol=BLOCK_TOL)
    np.testing.assert_allclose(jp_t.numpy(), jp_j, atol=BLOCK_TOL)
    np.testing.assert_allclose(jl_t.numpy(), jl_j, atol=BLOCK_TOL)
    np.testing.assert_allclose(float(chi2_t), float(chi2_j), rtol=1e-5)

    def residual(xi, dpi, pose, plane, obs):
        return TB.predict_plane(tse3.se3_exp(xi) @ pose, plane + dpi) - obs

    # autodiff in float64 (the closed form is held to it at f32's precision)
    z6, z4 = torch.zeros(6, dtype=torch.float64), torch.zeros(4, dtype=torch.float64)
    for o in range(0, len(leaves[2]), 5):
        args = (tprob.poses[tprob.obs_kf[o]].double(), tprob.planes[tprob.obs_pl[o]].double(),
                tprob.obs[o].double())
        jp = torch.func.jacfwd(residual, argnums=0)(z6, z4, *args)
        jl = torch.func.jacfwd(residual, argnums=1)(z6, z4, *args)
        np.testing.assert_allclose(jp_t[o].numpy(), jp.numpy(), atol=BLOCK_TOL)
        np.testing.assert_allclose(jl_t[o].numpy(), jl.numpy(), atol=BLOCK_TOL)


def test_schur_pcg_matches_full_dense_solve():
    """One GN step through the Schur-PCG path equals the explicit full
    (6N+4M) dense normal-equation solve; the assembled blocks equal the
    reference's."""
    leaves, _ = _problem(n_kf=4, noise=0.002, perturb=0.05, seed=1)
    jprob, prob = _both(leaves)
    t = TB._normal_blocks(prob.poses, prob.planes, prob, torch.tensor(0.0))
    tj = jax.device_get(JB._normal_blocks(jprob.poses, jprob.planes, jprob, jnp.array(0.0)))
    for k in ("b_p", "b_l"):
        np.testing.assert_allclose(t[k].numpy(), tj[k], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t["hpp"].numpy(), tj["hpp"], rtol=1e-5, atol=1e-3)
    n, m = prob.poses.shape[0], prob.planes.shape[0]
    r, jp, jl, w, _ = (x.double().numpy() if torch.is_tensor(x) else x
                       for x in TB._obs_terms(prob.poses, prob.planes, prob))
    dim = 6 * n + 4 * m
    h, b = np.zeros((dim, dim)), np.zeros(dim)
    for o, (i, k) in enumerate(zip(leaves[2], leaves[3])):
        sp = slice(6 * i, 6 * i + 6)
        sl = slice(6 * n + 4 * k, 6 * n + 4 * k + 4)
        h[sp, sp] += w[o] * jp[o].T @ jp[o]
        h[sl, sl] += w[o] * jl[o].T @ jl[o]
        h[sp, sl] += w[o] * jp[o].T @ jl[o]
        h[sl, sp] += w[o] * jl[o].T @ jp[o]
        b[sp] += w[o] * jp[o].T @ r[o]
        b[sl] += w[o] * jl[o].T @ r[o]
    h[: 6 * n, : 6 * n] += 1e-6 * np.eye(6 * n)
    h[:6, :6] += 1e8 * np.eye(6)
    h[6 * n:, 6 * n:] += 1e-6 * np.eye(4 * m)
    delta = np.linalg.solve(h, -b)
    hpp_inv = torch.linalg.inv(t["hpp"])
    dx_p, n_cg = TB._pcg(lambda x: TB._schur_matvec(t, x), lambda rr: TB._bmv(hpp_inv, rr),
                         TB._schur_rhs(t), 200, 1e-10)
    dx_l = TB._back_substitute(t, dx_p)
    assert 0 < n_cg <= 200
    np.testing.assert_allclose(dx_p.numpy(), delta[: 6 * n].reshape(n, 6), atol=1e-4)
    np.testing.assert_allclose(dx_l.numpy(), delta[6 * n:].reshape(m, 4), atol=1e-4)


@pytest.mark.parametrize("noise, perturb, seed, tol", [(0.0, 0.08, 0, 2e-5), (0.004, 0.06, 3, 1e-4)],
                         ids=["exact", "noisy"])
def test_optimize_plane_ba_matches_reference(noise, perturb, seed, tol):
    leaves, gt = _problem(noise=noise, perturb=perturb, seed=seed)
    jprob, prob = _both(leaves)
    jp, jl, jchi2, jit = jax.device_get(JB.optimize_plane_ba(jprob, max_iters=15))
    poses, planes, chi2, iters = TB.optimize_plane_ba(prob, max_iters=15)
    dt, dr = _gaps(poses.numpy(), jp)
    assert dt < tol and dr < tol, (dt, dr)
    np.testing.assert_allclose(planes.numpy(), jl, atol=tol)
    assert abs(float(chi2) - float(jchi2)) <= max(1e-3 * float(jchi2), 1e-9), (chi2, jchi2)
    # iteration counts: equal while chi2 still moves (the exit test is a
    # coin toss once chi2 sits on the f32 noise floor)
    if float(jchi2) > 1e-6:
        assert iters == int(jit)
    err0 = np.linalg.norm(leaves[0][:, :3, 3] - gt[:, :3, 3], axis=1).max()
    err = np.linalg.norm(poses.numpy()[:, :3, 3] - gt[:, :3, 3], axis=1).max()
    assert err < (1e-3 if noise == 0 else 0.25 * err0), (err0, err)


def test_second_solve_is_identical():
    """The incidence products make a solve deterministic (bit for bit)."""
    leaves, _ = _problem(noise=0.004, perturb=0.06, seed=3)
    prob = convert.plane_ba_problem_from_numpy(leaves)
    a, b = TB.optimize_plane_ba(prob), TB.optimize_plane_ba(prob)
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3])) and a[3] == b[3]


def test_empty_observations():
    """A problem without observations (obs (0, 4)) solves to its start."""
    leaves, _ = _problem(n_kf=3)
    leaves = leaves[:2] + [np.zeros(0, np.int32), np.zeros(0, np.int32),
                           np.zeros((0, 4), np.float32), np.zeros(0, np.float32)]
    jprob, prob = _both(leaves)
    poses, planes, chi2, iters = TB.optimize_plane_ba(prob)
    jres = jax.device_get(JB.optimize_plane_ba(jprob))
    assert float(chi2) == float(jres[2]) == 0.0
    np.testing.assert_allclose(poses.numpy(), jres[0], atol=1e-6)
    np.testing.assert_allclose(planes.numpy(), jres[1], atol=1e-6)


def _plane_sets(poses, cap=8):
    """Per-keyframe plane sets (numpy fields) of the box walls seen from
    `poses`, padded to `cap` slots with invalid ones."""
    out = []
    for pose in poses:
        preds = [_predict(pose, p) for p in _box_planes()]
        pad = cap - len(preds)
        normal = np.stack([p[:3] for p in preds] + [np.zeros(3)] * pad).astype(np.float32)
        d = np.asarray([p[3] for p in preds] + [0.0] * pad, np.float32)
        z = np.zeros(cap, np.float32)
        out.append(dict(normal=normal, center=np.zeros((cap, 3), np.float32), d=d,
                        curvature=z, area=z + 1, elongation=z + 1, n_inliers=z + 100,
                        hull=np.zeros((cap, 4, 3), np.float32),
                        hue_hist=np.zeros((cap, 37), np.float32),
                        main_color=np.zeros((cap, 3), np.float32),
                        valid=np.arange(cap) < len(preds)))
    return out


def test_associate_planes_matches_reference():
    """The same landmarks and the same integer observation lists."""
    from rgbd360_tpu.ops.segmentation import PlaneSet as JPlaneSet

    poses = [np.eye(4, dtype=np.float32),
             _exp([0.3, 0.0, 0.1, 0.0, 0.05, 0.0]).astype(np.float32),
             _exp([0.5, 0.1, 0.1, 0.02, 0.1, 0.0]).astype(np.float32)]
    sets = _plane_sets(poses)
    jprob = JB.associate_planes([jnp.asarray(p) for p in poses],
                                [JPlaneSet(**{k: jnp.asarray(v) for k, v in s.items()}) for s in sets],
                                max_planes=16)
    prob = TB.associate_planes(poses, [convert.plane_set_from_numpy(s) for s in sets], max_planes=16)
    got, ref = convert.plane_ba_problem_to_numpy(prob), jax.device_get(jprob)
    np.testing.assert_array_equal(got[2], ref.obs_kf)
    np.testing.assert_array_equal(got[3], ref.obs_pl)
    np.testing.assert_allclose(got[1], ref.planes, atol=1e-6)
    np.testing.assert_allclose(got[4], ref.obs, atol=0)
    np.testing.assert_allclose(got[5], ref.w, atol=0)
    assert int(ref.obs_pl.max()) + 1 == 6  # one landmark per wall
    assert isinstance(convert.plane_set_from_numpy(sets[0]), PlaneSet)
