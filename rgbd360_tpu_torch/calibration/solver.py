"""Extrinsic calibration solvers: pairwise and joint 8-sensor (twin of
`rgbd360_tpu/calibration/solver.py`).

Re-implements the behavior of the reference's calibration core (reference
`include/Calibrator.h`):

  * `PairCalibrator` — closed-form rotation by SVD of the normal correlation
    (`CalibrateRotation:373`), manifold Gauss-Newton refinement
    (`CalibrateRotationManifold:498`), least-squares translation
    (`CalibrateTranslation:644`), Fisher information
    (`calcFIMRotation:267`/`calcFIMTranslation:296`).
  * `RigCalibrator` — joint calibration of all sensors with sensor 0 fixed
    ((S-1)*3-dof rotation Levenberg-Marquardt with the full stacked
    Hessian, reference `Calibrator::CalibrateRotation:871`; joint linear
    translation solve, `CalibrateTranslation:1067`), seeded from the
    construction spec (45-deg ring, `loadConstructionSpecs:763`), guarded
    by the correspondence conditioning number (`calcConditioning:1191`).

The rotation solves run in float32 on a torch device (the card unless the
caller names one), as the reference runs them in jax's float32, with the
exact Jacobians of the manifold retraction from `torch.func.jacfwd` (the
reference's `jax.jacfwd`); the closed forms, the translation solves and
the information matrices are float64 numpy on the host, as there.
"""

from __future__ import annotations

import numpy as np
import torch

from rgbd360_tpu_torch import resolve_device
from rgbd360_tpu_torch.calibration.control_planes import ControlPlanes
from rgbd360_tpu_torch.calibration.spec import construction_spec_rt
from rgbd360_tpu_torch.ops import se3

__all__ = [
    "calibrate_pair_rotation", "refine_pair_rotation", "calibrate_pair_translation",
    "fim_rotation", "fim_translation", "conditioning", "PairCalibrator",
    "construction_spec_rt", "RigCalibrator",
]


def _f32(x, device) -> torch.Tensor:
    """float32 tensor on `device` (jax's float32 of the reference)."""
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


# ----------------------------------------------------------------- pairwise


def calibrate_pair_rotation(n_a, n_b, w=None) -> np.ndarray:
    """Closed-form rotation R with n_a ~ R n_b (weighted SVD/Procrustes)."""
    n_a = np.asarray(n_a, np.float64)
    n_b = np.asarray(n_b, np.float64)
    w = np.ones(len(n_a)) if w is None else np.asarray(w, np.float64)
    corr = (n_a * w[:, None]).T @ n_b
    u, _, vt = np.linalg.svd(corr)
    s = np.diag([1.0, 1.0, np.linalg.det(u @ vt)])
    return u @ s @ vt


def refine_pair_rotation(
    r0, n_a, n_b, w=None, iters: int = 10, prior_weight: float = 0.0, device=None
) -> np.ndarray:
    """Manifold Gauss-Newton refinement of a pair rotation (reference
    `CalibrateRotationManifold:498`).

    prior_weight > 0 adds a quadratic prior anchoring the rotation to the
    seed r0 (scaled by the total correspondence weight): under thin or
    degenerate normal sets the unobservable component then stays at the
    seed instead of wandering with noise — the online-calibration use.
    Runs in float32 on `device` (the card when None)."""
    device = resolve_device(device)
    n_a = _f32(n_a, device)
    n_b = _f32(n_b, device)
    w = torch.ones(len(n_a), device=device) if w is None else _f32(w, device)
    sw = torch.sqrt(w)[:, None]
    lam = prior_weight * float(torch.sum(w))
    eye = torch.eye(3, device=device)
    zero = torch.zeros(3, device=device)

    def residuals(rotvec, r_base):
        r = se3.so3_exp(rotvec) @ r_base
        return ((n_a - n_b @ r.T) * sw).reshape(-1)

    r = _f32(r0, device)
    acc = zero  # total rotation from the seed (for the prior)
    for _ in range(iters):
        j = torch.func.jacfwd(residuals)(zero, r)
        res = residuals(zero, r)
        h = j.T @ j + lam * eye
        g = j.T @ res + lam * acc
        delta = -torch.linalg.solve(h + 1e-9 * eye, g)
        r = se3.so3_exp(delta) @ r
        acc = acc + delta
        if float(torch.linalg.norm(delta)) < 1e-10:
            break
    return r.cpu().numpy()


def calibrate_pair_translation(n_a, d_a, d_b, r, w=None) -> np.ndarray:
    """LS translation from plane offsets: with x_a = R x_b + t and the
    n.x + d = 0 convention, d_b = d_a + n_a . t  =>  n_a . t = d_b - d_a."""
    n_a = np.asarray(n_a, np.float64)
    rhs = np.asarray(d_b, np.float64) - np.asarray(d_a, np.float64)
    w = np.ones(len(rhs)) if w is None else np.asarray(w, np.float64)
    a = n_a * np.sqrt(w)[:, None]
    b = rhs * np.sqrt(w)
    ata = a.T @ a
    return np.linalg.solve(ata + 1e-12 * np.eye(3), a.T @ b)


def fim_rotation(n_a, n_b, r, w=None) -> np.ndarray:
    """Fisher information of the rotation estimate (reference
    `calcFIMRotation:267`): sum w * skew(R n_b) skew(R n_b)^T."""
    n_b = np.asarray(n_b, np.float64)
    w = np.ones(len(n_b)) if w is None else np.asarray(w, np.float64)
    rn = n_b @ np.asarray(r).T
    out = np.zeros((3, 3))
    for k in range(len(rn)):
        sk = np.array(
            [
                [0, -rn[k, 2], rn[k, 1]],
                [rn[k, 2], 0, -rn[k, 0]],
                [-rn[k, 1], rn[k, 0], 0],
            ]
        )
        out += w[k] * sk @ sk.T
    return out


def fim_translation(n_a, w=None) -> np.ndarray:
    """Fisher information of the translation (reference
    `calcFIMTranslation:296`): sum w * n n^T."""
    n_a = np.asarray(n_a, np.float64)
    w = np.ones(len(n_a)) if w is None else np.asarray(w, np.float64)
    return (n_a * w[:, None]).T @ n_a


def conditioning(n_a) -> float:
    """Conditioning number of the normal set: s_max / s_min of the stacked
    normals (reference `calcConditioning:1191` / `Calibrator.h:163`)."""
    s = np.linalg.svd(np.asarray(n_a, np.float64), compute_uv=False)
    return float(s[0] / max(s[-1], 1e-12))


class PairCalibrator:
    """Extrinsic calibration of one sensor pair from plane correspondences;
    the rotation's refinement runs on `device` (the card when None)."""

    def __init__(self, threshold_conditioning: float = 8000.0, device=None):
        self.threshold_conditioning = threshold_conditioning
        self.device = resolve_device(device)

    def calibrate(self, n_a, d_a, n_b, d_b, w=None, r0=None):
        """Returns (rt (4, 4) with x_a = rt @ x_b, diagnostics dict).

        r0: optional rotation seed.  When given, the closed-form Procrustes
        solve is skipped and the manifold GN refines FROM the seed — under
        thin or degenerate data (e.g. only floor/ceiling normals early in an
        online run) the unobservable rotation component then stays at the
        current estimate instead of being picked arbitrarily from the null
        space.  This is how the reference's online calibrators behave: they
        refine the running estimate as correspondences accumulate
        (`Calibration/OnlineCalibration.cpp:112-150`)."""
        cond = conditioning(n_a)
        r = calibrate_pair_rotation(n_a, n_b, w) if r0 is None else np.asarray(r0)
        r = refine_pair_rotation(
            r, n_a, n_b, w, prior_weight=0.0 if r0 is None else 0.05, device=self.device
        )
        t = calibrate_pair_translation(n_a, d_a, d_b, r, w)
        rt = np.eye(4)
        rt[:3, :3] = r
        rt[:3, 3] = t
        diag = dict(
            conditioning=cond,
            well_conditioned=cond < self.threshold_conditioning,
            fim_rotation=fim_rotation(n_a, n_b, r, w),
            fim_translation=fim_translation(n_a, w),
            rot_error=float(
                np.mean(1.0 - np.sum(np.asarray(n_a) * (np.asarray(n_b) @ r.T), axis=1))
            ),
        )
        return rt, diag


# -------------------------------------------------------------------- joint


class RigCalibrator:
    """Joint extrinsic calibration of the full ring from control planes;
    the rotations' solve runs on `device` (the card when None)."""

    def __init__(self, num_sensors: int = 8, threshold_conditioning: float = 8000.0,
                 device=None):
        self.num_sensors = num_sensors
        self.threshold_conditioning = threshold_conditioning
        self.device = resolve_device(device)

    def _stack(self, cp: ControlPlanes):
        rows = []
        for (a, b), p in sorted(cp.pairs.items()):
            for k in range(len(p["w"])):
                rows.append(
                    (a, b, p["n_a"][k], p["d_a"][k], p["n_b"][k], p["d_b"][k], p["w"][k])
                )
        if not rows:
            raise ValueError("no control planes")
        a_idx = np.array([r[0] for r in rows])
        b_idx = np.array([r[1] for r in rows])
        n_a = np.stack([r[2] for r in rows])
        d_a = np.array([r[3] for r in rows])
        n_b = np.stack([r[4] for r in rows])
        d_b = np.array([r[5] for r in rows])
        w = np.array([r[6] for r in rows])
        return a_idx, b_idx, n_a, d_a, n_b, d_b, w

    def calibrate_rotations(
        self,
        cp: ControlPlanes,
        rt0: np.ndarray,
        iters: int = 10,
        prior_weight: float = 0.0,
    ):
        """Joint (S-1)*3-dof rotation GN, sensor 0 fixed (reference
        `Calibrator::CalibrateRotation:871`).

        `prior_weight` adds a quadratic prior pulling each sensor's rotation
        toward rt0 (in units comparable to the summed correspondence
        weights) — used when the correspondence set is thin/noisy and the
        goal is to *refine* an existing calibration."""
        s_n = self.num_sensors
        dev = self.device
        a_idx, b_idx, n_a, _, n_b, _, w = self._stack(cp)
        rots = _f32(rt0[:, :3, :3], dev)
        rots_prior = rots
        n_a_j = _f32(n_a, dev)
        n_b_j = _f32(n_b, dev)
        sw = torch.sqrt(_f32(w, dev))[:, None]
        ai = torch.as_tensor(a_idx, device=dev)
        bi = torch.as_tensor(b_idx, device=dev)
        pw = float(np.sqrt(np.float32(prior_weight))) if prior_weight > 0 else 0.0
        fixed = torch.zeros((1, 3), device=dev)
        n_unk = (s_n - 1) * 3
        eye = torch.eye(n_unk, device=dev)

        def rotate(deltas, rots):
            # deltas: (S-1, 3); sensor 0 fixed
            return se3.so3_exp(torch.cat([fixed, deltas], dim=0)) @ rots

        def residuals(deltas, rots):
            r_new = rotate(deltas, rots)
            # rig-frame normals must agree across the pair
            res = (
                (r_new[ai] @ n_a_j[..., None])[..., 0]
                - (r_new[bi] @ n_b_j[..., None])[..., 0]
            ) * sw
            out = res.reshape(-1)
            if prior_weight > 0:
                drift = se3.so3_log(r_new[1:] @ rots_prior[1:].mT)
                out = torch.cat([out, pw * drift.reshape(-1)])
            return out

        # Levenberg-Marquardt with step acceptance: real correspondence sets
        # can leave individual links near-degenerate (few, near-parallel
        # normals), where undamped GN blows up.
        lam = 1e-3
        z = torch.zeros((s_n - 1, 3), device=dev)
        err = float(torch.sum(residuals(z, rots) ** 2))
        for _ in range(iters):
            j = torch.func.jacfwd(residuals)(z, rots).reshape(-1, n_unk)
            res = residuals(z, rots)
            h = j.T @ j
            g = j.T @ res
            stepped = False
            for _ in range(8):  # inner damping search
                damped = h + lam * (torch.diag(torch.diag(h)) + 1e-9 * eye)
                delta = -torch.linalg.solve(damped, g).reshape(s_n - 1, 3)
                cand = rotate(delta, rots)
                new_err = float(torch.sum(residuals(z, cand) ** 2))
                if new_err < err:
                    rots, err = cand, new_err
                    lam = max(lam / 10.0, 1e-9)
                    stepped = True
                    break
                lam *= 10.0
            if not stepped or float(torch.linalg.norm(delta)) < 1e-10:
                break
        return rots.cpu().numpy()

    def calibrate_translations(
        self,
        cp: ControlPlanes,
        rots: np.ndarray,
        rt0: np.ndarray,
        prior_weight: float = 0.0,
    ):
        """Joint linear translation solve, sensor 0 fixed (reference
        `Calibrator::CalibrateTranslation:1067`).

        Rig-frame plane offset seen from sensor s: d_rig = d_s - (R_s n_s).t_s;
        equality across a pair gives one equation in (t_a, t_b).
        """
        s_n = self.num_sensors
        a_idx, b_idx, n_a, d_a, n_b, d_b, w = self._stack(cp)
        n_unk = (s_n - 1) * 3
        amat = np.zeros((len(w), n_unk))
        rhs = np.zeros(len(w))
        t0 = rt0[0, :3, 3]  # gauge: sensor 0 translation fixed to the prior
        for k in range(len(w)):
            a, b = a_idx[k], b_idx[k]
            na_rig = rots[a] @ n_a[k]
            nb_rig = rots[b] @ n_b[k]
            # d_a - na_rig.t_a = d_b - nb_rig.t_b
            # =>  -na_rig.t_a + nb_rig.t_b = d_b - d_a
            sw = np.sqrt(w[k])
            rhs[k] = (d_b[k] - d_a[k]) * sw
            if a > 0:
                amat[k, (a - 1) * 3 : a * 3] -= na_rig * sw
            else:
                rhs[k] += (na_rig @ t0) * sw
            if b > 0:
                amat[k, (b - 1) * 3 : b * 3] += nb_rig * sw
            else:
                rhs[k] -= (nb_rig @ t0) * sw
        if prior_weight > 0:
            # quadratic prior toward the initial translations
            pw = np.sqrt(prior_weight)
            amat = np.vstack([amat, pw * np.eye(n_unk)])
            rhs = np.concatenate([rhs, pw * rt0[1:, :3, 3].reshape(-1)])
        sol, *_ = np.linalg.lstsq(amat, rhs, rcond=None)
        return np.vstack([t0, sol.reshape(s_n - 1, 3)])

    def calibrate(
        self,
        cp: ControlPlanes,
        rt0: np.ndarray | None = None,
        prior_weight: float = 0.0,
    ):
        """Full joint calibration; returns ((S, 4, 4), diagnostics)."""
        if rt0 is None:
            rt0 = construction_spec_rt(self.num_sensors)
        _, _, n_a, _, _, _, _ = self._stack(cp)
        cond = conditioning(n_a)
        rots = self.calibrate_rotations(cp, rt0, prior_weight=prior_weight)
        ts = self.calibrate_translations(cp, rots, rt0, prior_weight=prior_weight)
        rt = np.tile(np.eye(4), (self.num_sensors, 1, 1))
        rt[:, :3, :3] = rots
        rt[:, :3, 3] = ts
        a_idx, b_idx, n_a, d_a, n_b, d_b, w = self._stack(cp)
        rot_err = float(
            np.mean(
                np.linalg.norm(
                    np.einsum("kij,kj->ki", rots[a_idx], n_a)
                    - np.einsum("kij,kj->ki", rots[b_idx], n_b),
                    axis=1,
                )
            )
        )
        diag = dict(
            conditioning=cond,
            well_conditioned=cond < self.threshold_conditioning,
            rot_error=rot_err,
            n_correspondences=len(w),
        )
        return rt, diag
