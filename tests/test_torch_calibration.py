"""The port's calibration modules against the reference's: `ops/ransac.py`,
`calibration/solver.py`, `calibration/control_planes.py`,
`calibration/laser.py` and `calibration/tof.py`, with the reference's own
scenes (`tests/test_calibration.py`, `tests/test_extras.py`).

RANSAC's hypotheses come from `jax.random` in the reference, which
PyTorch cannot reproduce: the core is fed the reference's own index
triples and holds its plane (within float32 rounding: RANSAC_TOL) and
inlier mask (up to RANSAC_FLIPS points within rounding of the
threshold); the public function, with the port's own seeded hypotheses,
is held statistically.  The rotation solves run in float32 in both
packages (the reference's `jax.jacfwd` is `torch.func.jacfwd` here): the
port's solve on the same correspondences within 1e-5 of the reference's
(measured 7.4e-6 at most); the closed forms, the translation solves, the
information matrices and the laser solver are the same float64 numpy code
(bit-equal)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rgbd360_tpu import calibration as J
from rgbd360_tpu.calibration import solver as JS
from rgbd360_tpu_torch import calibration as T
from rgbd360_tpu_torch import synthetic
from rgbd360_tpu_torch.calibration import solver as TS
from rgbd360_tpu_torch.ops import ransac

from test_torch_segmentation import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]
import chip_smoke  # noqa: E402

SOLVE_ATOL = 1e-5
DEV = "cpu"


def _observe(rt, planes):
    """Plane (n, d) in the rig -> (n_s, d_s) in the sensor with x_rig = rt x_s."""
    n, d = planes
    return n @ rt[:3, :3], d + n @ rt[:3, 3]


def _random_planes(k=30, seed=0):
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(k, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    return n, rng.uniform(0.5, 4.0, k)


def _ring_cp(mod, rt_true, noise=0.001, k=40, seed=0):
    rng = np.random.default_rng(seed)
    cp = mod.ControlPlanes(rt_true.shape[0])
    planes = _random_planes(k, seed)
    for s in range(rt_true.shape[0]):
        a, b = s, (s + 1) % rt_true.shape[0]
        n_a, d_a = _observe(rt_true[a], planes)
        n_b, d_b = _observe(rt_true[b], planes)
        keep = (np.abs(n_a[:, 2]) > 0.15) & (np.abs(n_b[:, 2]) > 0.15)
        n_a = n_a + rng.normal(0, noise, n_a.shape)
        n_a /= np.linalg.norm(n_a, axis=1, keepdims=True)
        cp.add(a, b, n_a[keep], d_a[keep], n_b[keep], d_b[keep])
    return cp


def _perturbed(rt, seed=3):
    return chip_smoke.perturbed_rt(rt, seed)


# ------------------------------------------------------------------ RANSAC

@pytest.fixture(scope="module")
def golden_ransac():
    import torch_port_golden as G

    return G.ransac_jax()


def test_ransac_core_on_reference_triples(golden_ransac):
    """Phase m's gate (`chip_smoke.check_ransac`): the core on the
    reference's triples, and `ransac_plane` with its own hypotheses."""
    chip_smoke.check_ransac(golden_ransac, DEV, "ransac")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_core_random_scenes(seed):
    """The core on random scenes and triples, with invalid and NaN points:
    the reference's winner and count."""
    from rgbd360_tpu.ops import ransac as JR

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3, 3, (600, 3)).astype(np.float32)
    pts[:400, 2] = 0.7 + rng.normal(0, 0.005, 400)
    valid = rng.uniform(size=600) > 0.1
    key = jax.random.PRNGKey(seed)
    idx = np.asarray(jax.random.randint(key, (256, 3), 0, 600))
    jn, jd, jc = JR._ransac_plane_core(jnp.asarray(pts), jnp.asarray(valid), key,
                                       jnp.float32(0.02), 256)
    tn, td, tc = ransac._ransac_plane_core(torch.from_numpy(pts), torch.from_numpy(valid),
                                           torch.from_numpy(idx.astype(np.int64)), 0.02)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=chip_smoke.RANSAC_TOL)
    assert abs(float(td) - float(jd)) < chip_smoke.RANSAC_TOL
    assert abs(int(tc) - int(jc)) <= chip_smoke.RANSAC_FLIPS


def test_ransac_dominant_plane_with_outliers():
    rng = np.random.default_rng(3)
    n_true = np.array([0.2, -0.5, 0.84])
    n_true /= np.linalg.norm(n_true)
    basis = np.linalg.svd(n_true[None, :])[2][1:]
    pts_in = -1.7 * n_true + rng.uniform(-2, 2, (2000, 2)) @ basis + rng.normal(0, 0.004, (2000, 3))
    pts = np.vstack([pts_in, rng.uniform(-4, 4, (600, 3))])
    n, d, inl = ransac.ransac_plane(pts, dist_threshold=0.03, device=DEV)
    assert d >= 0
    sign = np.sign(np.dot(n, n_true)) or 1.0
    assert np.dot(sign * n, n_true) > 0.9999 and abs(sign * d - 1.7) < 0.01
    assert inl[:2000].mean() > 0.98 and inl[2000:].mean() < 0.05


def test_ransac_invalid_points_never_vote():
    rng = np.random.default_rng(0)
    a = np.column_stack([rng.uniform(-1, 1, (300, 2)), np.full(300, 0.5)])
    b = np.column_stack([rng.uniform(-1, 1, (900, 2)), np.full(900, 2.0)])
    pts = np.vstack([a, b])
    n, d, inl = ransac.ransac_plane(pts, np.arange(len(pts)) < 300, dist_threshold=0.02,
                                    device=DEV)
    assert abs(abs(n[2]) - 1.0) < 1e-4 and abs(d - 0.5) < 0.01 and not inl[300:].any()


def test_ransac_nan_points_and_errors():
    rng = np.random.default_rng(1)
    pts = np.column_stack([rng.uniform(-1, 1, (400, 2)), np.zeros(400)])
    pts[::7] = np.nan
    n, d, inl = ransac.ransac_plane(pts, dist_threshold=0.02, device=DEV)
    assert abs(abs(n[2]) - 1.0) < 1e-4 and abs(d) < 0.01 and not inl[::7].any()
    with pytest.raises(ValueError):
        ransac.ransac_plane(np.zeros((2, 3)), device=DEV)
    with pytest.raises(ValueError):
        ransac.ransac_plane(np.zeros((5, 2)), device=DEV)


def test_fit_plane_lsq_matches_reference():
    from rgbd360_tpu.ops.ransac import fit_plane_lsq as j_fit

    rng = np.random.default_rng(4)
    pts = np.column_stack([rng.uniform(-1, 1, (200, 2)), 0.3 + rng.normal(0, 0.01, 200)])
    w = rng.uniform(0.5, 1.5, 200)
    tn, td = ransac.fit_plane_lsq(pts, w, device=DEV)
    jn, jd = j_fit(pts, w)
    assert td >= 0 and abs(td - jd) < 1e-5
    np.testing.assert_allclose(np.abs(tn), np.abs(jn), atol=1e-5)


# ------------------------------------------------------------------ solver

def test_pair_calibration_parity_and_recovery():
    """The reference's `test_recover_known_extrinsic`, and the port's pair
    solve against the reference's, seeded and unseeded."""
    rng = np.random.default_rng(1)
    rt_true = chip_smoke.se3_exp_np([0.05, -0.03, 0.02, 0.1, 0.7, -0.05])
    planes = _random_planes()
    n_a, d_a = _observe(np.eye(4), planes)
    n_b, d_b = _observe(rt_true, planes)
    n_a += rng.normal(0, 0.002, n_a.shape)
    rt, diag = TS.PairCalibrator(device=DEV).calibrate(n_a, d_a, n_b, d_b)
    ref, ref_diag = JS.PairCalibrator().calibrate(n_a, d_a, n_b, d_b)
    np.testing.assert_allclose(rt, ref, atol=SOLVE_ATOL)
    dt, dr = chip_smoke._twist_gap(rt, rt_true)
    assert dt < 0.02 and dr < 0.01 and diag["well_conditioned"]
    np.testing.assert_array_equal(diag["fim_translation"], ref_diag["fim_translation"])
    r0 = ref[:3, :3] @ chip_smoke.se3_exp_np([0, 0, 0, 0.01, 0.02, -0.01])[:3, :3]
    np.testing.assert_allclose(TS.PairCalibrator(device=DEV).calibrate(n_a, d_a, n_b, d_b, r0=r0)[0],
                               JS.PairCalibrator().calibrate(n_a, d_a, n_b, d_b, r0=r0)[0],
                               atol=SOLVE_ATOL)


@pytest.mark.parametrize("prior", [0.0, 0.05])
def test_refine_pair_rotation_parity(prior):
    rng = np.random.default_rng(2)
    planes = _random_planes(20, 2)
    rt = chip_smoke.se3_exp_np([0, 0, 0, 0.3, -0.2, 0.1])
    n_a, _ = _observe(np.eye(4), planes)
    n_b, _ = _observe(rt, planes)
    n_a = n_a + rng.normal(0, 0.003, n_a.shape)
    r0 = rt[:3, :3] @ chip_smoke.se3_exp_np([0, 0, 0, 0.02, 0.0, -0.03])[:3, :3]
    got = TS.refine_pair_rotation(r0, n_a, n_b, prior_weight=prior, device=DEV)
    ref = JS.refine_pair_rotation(r0, n_a, n_b, prior_weight=prior)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=SOLVE_ATOL)


def test_degenerate_conditioning_flagged():
    n = np.tile(np.array([1.0, 0, 0]), (20, 1))
    assert TS.conditioning(n) == JS.conditioning(n) > 8000.0


@pytest.mark.parametrize("prior", [0.0, 500.0])
def test_joint_calibration_parity_and_recovery(prior):
    """The reference's `test_recover_reference_rig` scene on the
    construction-spec ring, from a perturbed seed: the port's rig within
    SOLVE_ATOL of the reference's, and (without a prior) the truth within
    the reference's bounds (0.02 m, 0.01 rad)."""
    rt_true = TS.construction_spec_rt()
    rt0 = _perturbed(rt_true)
    got, diag = TS.RigCalibrator(device=DEV).calibrate(_ring_cp(T, rt_true), rt0, prior)
    ref, ref_diag = JS.RigCalibrator().calibrate(_ring_cp(J, rt_true), rt0, prior)
    np.testing.assert_allclose(got, ref, atol=SOLVE_ATOL)
    assert abs(diag["rot_error"] - ref_diag["rot_error"]) < 1e-5
    if prior == 0.0:
        dt, dr = chip_smoke._relative_gaps(got, rt_true)
        assert dt < 0.02 and dr < 0.01, (dt, dr)


def test_construction_spec_one_definition():
    from rgbd360_tpu_torch.calibration import spec

    assert TS.construction_spec_rt is spec.construction_spec_rt
    np.testing.assert_array_equal(TS.construction_spec_rt(), JS.construction_spec_rt())


def test_fim_and_translation_bit_equal():
    planes = _random_planes(12, 5)
    rt = chip_smoke.se3_exp_np([0.1, 0.0, -0.05, 0.2, 0.1, 0.0])
    n_a, d_a = _observe(np.eye(4), planes)
    n_b, d_b = _observe(rt, planes)
    w = np.linspace(1, 3, 12)
    np.testing.assert_array_equal(TS.fim_rotation(n_a, n_b, rt[:3, :3], w),
                                  JS.fim_rotation(n_a, n_b, rt[:3, :3], w))
    np.testing.assert_array_equal(TS.calibrate_pair_translation(n_a, d_a, d_b, rt[:3, :3], w),
                                  JS.calibrate_pair_translation(n_a, d_a, d_b, rt[:3, :3], w))


# --------------------------------------------------------- control planes

def test_control_planes_save_load(tmp_path):
    cp = T.ControlPlanes(8)
    cp.add(0, 1, [[1, 0, 0]], [1.0], [[0, 1, 0]], [2.0], [5.0])
    cp.add(1, 2, [[0, 0, 1]], [0.5], [[0, 1, 0]], [1.5])
    cp.save(str(tmp_path / "cp.txt"))
    back = J.ControlPlanes.load(str(tmp_path / "cp.txt"))
    assert back.count(0, 1) == 1 and back.count(1, 2) == 1
    np.testing.assert_allclose(T.ControlPlanes.load(str(tmp_path / "cp.txt")).pairs[(0, 1)]["d_b"], [2.0])


def test_collect_control_planes_parity():
    """`collect_control_planes` over three loop captures' per-sensor clouds
    (built by the port, given to both packages): the port's batched
    segmentation and the reference's vmapped one give the same matches
    within phase m's control-plane tolerances."""
    from rgbd360_tpu_torch.core.frame import FrameBuilder, RigFrame

    cfg = synthetic.config(4, 3)
    b = FrameBuilder(chip_smoke.extras_calibration(cfg), cfg, device=DEV)
    frames = []
    for rgb, dmm in synthetic.loop_captures(8, 4, frames=[0, 3, 6]):
        f = b.build(RigFrame(torch.from_numpy(rgb), torch.from_numpy(dmm)))
        frames.append((f.local_xyz.numpy(), f.cloud_rgb.numpy(), f.cloud_valid.numpy()))
    rt = b.rt.numpy().astype(np.float64)
    got = T.collect_control_planes(frames, rt, device=DEV)
    ref = J.collect_control_planes(frames, rt)
    rows = lambda cp: np.asarray([[a, bb, *p["n_a"][k], p["d_a"][k], *p["n_b"][k], p["d_b"][k],  # noqa: E731
                                   p["w"][k]] for (a, bb), p in sorted(cp.pairs.items())
                                  for k in range(len(p["w"]))])
    assert sum(got.count(*k) for k in got.pairs) > 0
    chip_smoke.check_control_planes(rows(got), rows(ref), "collect")


# ------------------------------------------------------------ laser, ToF

@pytest.mark.parametrize("seed", [0, 1, 2, 7, 13])
def test_laser_recovery_bit_equal(seed):
    """The reference's `TestLaserCalibration` scene: recovered within its
    bounds, and bit-equal to the reference's (the same float64 code)."""
    from rgbd360_tpu.calibration.laser import LaserCalibrator as JLaser
    from rgbd360_tpu_torch.calibration.laser import LaserCalibrator

    rng = np.random.default_rng(seed)
    normals = np.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0], [0.577, 0.577, 0.577]])
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    ds = np.array([2.0, 1.5, 3.0, 2.5])
    rt_true = chip_smoke.se3_exp_np([0.1, -0.05, 0.2, 0.05, 0.1, -0.08])
    rinv = np.linalg.inv(rt_true)
    pts, idx = [], []
    for k, (nk, dk) in enumerate(zip(normals, ds)):
        basis = np.linalg.svd(nk[None])[2][1:]
        x = -dk * nk + rng.uniform(-2, 2, (40, 2)) @ basis
        pts.append(x @ rinv[:3, :3].T + rinv[:3, 3])
        idx.append(np.full(40, k))
    pts = np.vstack(pts) + rng.normal(0, 0.003, (160, 3))
    idx = np.concatenate(idx)
    rt, diag = LaserCalibrator().calibrate(normals, ds, pts, idx)
    np.testing.assert_array_equal(rt, JLaser().calibrate(normals, ds, pts, idx)[0])
    dt, dr = chip_smoke._twist_gap(rt, rt_true)
    assert dt < 0.02 and dr < 0.01 and diag["rms"] < 0.01


def test_tof_collect_and_solve(tmp_path):
    """`collect_tof_correspondences` + `calibrate_tof` on phase m's ToF
    rawlog (range images with gray intensity images): the correspondences
    and the extrinsic of the reference's within TOF_TOL (the port's RANSAC
    draws its own hypotheses, the refit lands on the same inliers), the
    truth within the reference's bounds (1 cm, 0.5 degree)."""
    from rgbd360_tpu.calibration.tof import calibrate_tof as j_solve
    from rgbd360_tpu.calibration.tof import collect_tof_correspondences as j_collect
    from rgbd360_tpu_torch.calibration.tof import calibrate_tof, collect_tof_correspondences

    paths = chip_smoke.write_tof_laser_inputs(tmp_path)
    got = collect_tof_correspondences(str(paths["tof"]), device=DEV)
    ref = j_collect(str(paths["tof"]))
    assert got.shape == ref.shape == (8, 8)
    np.testing.assert_allclose(got, ref, atol=chip_smoke.TOF_TOL[0])
    rt, diag = calibrate_tof(got, device=DEV)
    chip_smoke.check_rig(rt, j_solve(ref)[0], chip_smoke.TOF_TOL, "tof vs the reference's")
    chip_smoke.check_rig(rt, chip_smoke.se3_exp_np(chip_smoke.TOF_RT), chip_smoke.TOF_TRUTH,
                         "tof vs the truth")
    assert diag["well_conditioned"]
    with pytest.raises(ValueError):
        calibrate_tof(got[:2], device=DEV)
