"""Parity of the port's ops with the reference package: se3, camera,
the construction spec, CLAMS undistortion, stitch maps, the stitch and the
gray conversion.  Inputs come from numpy seeds and feed both packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rgbd360_tpu.calibration.solver import construction_spec_rt as jax_spec_rt
from rgbd360_tpu.config import RigConfig, default_config
from rgbd360_tpu.core.frame import FrameBuilder as JaxFrameBuilder
from rgbd360_tpu.ops import camera as jcam, se3 as jse3, stitch as jst
from rgbd360_tpu.ops import undistort as jund
from rgbd360_tpu_torch import convert, synthetic
from rgbd360_tpu_torch.calibration.spec import construction_spec_rt
from rgbd360_tpu_torch.core.frame import FrameBuilder
from rgbd360_tpu_torch.ops import camera as tcam, se3 as tse3, stitch as tst
from rgbd360_tpu_torch.ops import undistort as tund

# asin/atan2/sin/cos and 3-term sums differ by a few ulps between XLA's and
# PyTorch's CPU kernels: 1e-6 absolute on O(1) values (~8 ulps).
TRIG_TOL = 1e-6


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def test_se3_parity(rng):
    xi = rng.normal(0, 0.6, (64, 6)).astype(np.float32)
    xi[:8] *= 1e-5  # the small-angle Taylor branches
    xi[8:12, 3:] = np.pi * 0.97 * xi[8:12, 3:] / np.linalg.norm(
        xi[8:12, 3:], axis=1, keepdims=True
    )  # near pi
    t_j = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    t_t = tse3.se3_exp(_t(xi)).numpy()
    np.testing.assert_allclose(t_t, t_j, atol=TRIG_TOL)
    np.testing.assert_allclose(
        tse3.se3_log(_t(t_j)).numpy(), np.asarray(jse3.se3_log(jnp.asarray(t_j))),
        atol=2e-5,  # the log's arccos near pi amplifies ulps (d acos ~ 1/sin)
    )
    np.testing.assert_allclose(
        tse3.se3_inverse(_t(t_j)).numpy(),
        np.asarray(jse3.se3_inverse(jnp.asarray(t_j))), atol=TRIG_TOL,
    )
    np.testing.assert_allclose(
        tse3.adjoint(_t(t_j)).numpy(), np.asarray(jse3.adjoint(jnp.asarray(t_j))),
        atol=TRIG_TOL,
    )
    pts = rng.normal(0, 3, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tse3.transform_points(_t(t_j[0]), _t(pts)).numpy(),
        np.asarray(jse3.transform_points(jnp.asarray(t_j[0]), jnp.asarray(pts))),
        atol=1e-5,  # 3 m points
    )
    dt_t, dr_t = tse3.pose_distance(_t(t_j[:32]), _t(t_j[32:]))
    dt_j, dr_j = jse3.pose_distance(jnp.asarray(t_j[:32]), jnp.asarray(t_j[32:]))
    np.testing.assert_allclose(dt_t.numpy(), np.asarray(dt_j), atol=TRIG_TOL)
    np.testing.assert_allclose(dr_t.numpy(), np.asarray(dr_j), atol=1e-5)
    np.testing.assert_array_equal(tse3.yaw_grid(16), jse3.yaw_grid(16))


def test_camera_parity(rng):
    h, w = 64, 384
    np.testing.assert_allclose(
        tcam.sphere_rays(h, w).numpy(), np.asarray(jcam.sphere_rays(h, w)),
        atol=TRIG_TOL,
    )
    depth = rng.uniform(0.5, 6.0, (h, w)).astype(np.float32)
    np.testing.assert_allclose(
        tcam.sphere_backproject(_t(depth)).numpy(),
        np.asarray(jcam.sphere_backproject(jnp.asarray(depth))), atol=1e-5,
    )
    pts = rng.normal(0, 3, (h, w, 3)).astype(np.float32)
    rc_t, rho_t = tcam.sphere_project(_t(pts), h, w)
    rc_j, rho_j = jcam.sphere_project(jnp.asarray(pts), h, w)
    # pixel coordinates: ~1e-6 rad of asin/atan2 ulps times w/(2 pi) px/rad
    np.testing.assert_allclose(rc_t.numpy(), np.asarray(rc_j), atol=1e-4)
    np.testing.assert_allclose(rho_t.numpy(), np.asarray(rho_j), rtol=TRIG_TOL)
    r = rng.integers(0, h, 100)
    c = rng.integers(0, w, 100)
    np.testing.assert_allclose(
        tcam.sphere_rays_at(torch.from_numpy(r), torch.from_numpy(c), h, w).numpy(),
        np.asarray(jcam.sphere_rays_at(jnp.asarray(r), jnp.asarray(c), h, w)),
        atol=TRIG_TOL,
    )
    k = np.array([[52.5, 0, 31.9], [0, 52.5, 23.9], [0, 0, 1]], np.float32)
    d = rng.uniform(0.5, 6.0, (48, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tcam.pinhole_backproject(_t(d), _t(k)).numpy(),
        np.asarray(jcam.pinhole_backproject(jnp.asarray(d), jnp.asarray(k))),
        rtol=TRIG_TOL,
    )
    uv_t, z_t = tcam.pinhole_project(_t(pts), _t(k))
    uv_j, z_j = jcam.pinhole_project(jnp.asarray(pts), jnp.asarray(k))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-5)
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    np.testing.assert_allclose(
        tcam.radial_scale(_t(k), 48, 64).numpy(),
        np.asarray(jcam.radial_scale(jnp.asarray(k), 48, 64)), rtol=TRIG_TOL,
    )


def test_construction_spec_equal():
    for n in (8, 6):
        np.testing.assert_array_equal(construction_spec_rt(n), jax_spec_rt(n))


def test_undistort_bit_equal(rng):
    rig = synthetic.config(5).rig
    cal = synthetic.calibration(rig)
    # depths over every bin, exact bin edges and half-bin points, invalid 0s
    depth = rng.uniform(0.0, 11.0, (8, rig.height, rig.width)).astype(np.float32)
    depth.reshape(-1)[:40] = np.arange(40, dtype=np.float32) * 0.5
    depth[rng.uniform(size=depth.shape) < 0.05] = 0.0
    args = (cal.clams_bin_width, cal.clams_bin_height, rig.height, rig.width)
    m_j, c_j = jund.precompute_pixel_tables(
        jnp.asarray(cal.clams_multipliers), jnp.asarray(cal.clams_counts), *args
    )
    m_t, c_t = tund.precompute_pixel_tables(
        _t(cal.clams_multipliers), _t(cal.clams_counts), *args
    )
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    out_j = jund.undistort_depth_pixeltab(jnp.asarray(depth), m_j, c_j, 2.0)
    out_t = tund.undistort_depth_pixeltab(_t(depth), m_t, c_t, 2.0)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


def test_stitch_maps_parity():
    # The maps are calibration-only and cheap, so they are compared at the
    # full 320x1920 sphere: the sensor choice ties exactly on the 8 columns
    # half-way between sensors, where ulps decide (~8/W of the pixels), so
    # the share of flipped pixels is a full-size property.
    rig = RigConfig()
    cal = synthetic.calibration(rig)
    args = (320, 1920, rig.height, rig.width)
    mj = jst.compute_stitch_maps(jnp.asarray(cal.rt_inv), jnp.asarray(cal.k), *args)
    mt = tst.compute_stitch_maps(_t(cal.rt_inv), _t(cal.k), *args)
    for name in ("sensor", "u", "v", "valid"):
        same = (getattr(mt, name).numpy() == np.asarray(getattr(mj, name))).mean()
        assert same >= 0.999, (name, same)
    # the radial scale wherever both chose the same sensor and it is read
    # (invalid pixels project near z = 0, where the scale is huge and
    # ill-conditioned, and the stitch masks them)
    agree = (mt.sensor.numpy() == np.asarray(mj.sensor)) & np.asarray(mj.valid)
    np.testing.assert_allclose(
        mt.scale.numpy()[agree], np.asarray(mj.scale)[agree], atol=1e-6
    )
    np.testing.assert_array_equal(
        tst.seam_mask_from_maps(mt, 1).numpy().mean(),
        np.asarray(jst.seam_mask_from_maps(mj, 1)).mean(),
    )


@pytest.fixture(scope="module")
def small_builders():
    """(reference builder, port builder loaded with the reference's maps
    through `convert`, config, captures) at the 8x48x64 rig."""
    cfg = synthetic.config(5, pyramid_levels=3)
    cal = synthetic.calibration(cfg.rig)
    jb = JaxFrameBuilder(cal, cfg)
    tb = FrameBuilder(cal, cfg)
    params = {k: np.asarray(v) for k, v in jb._params.items()}
    seam = np.asarray(jst.seam_mask_from_maps(jb.maps, 1))
    levels = [seam[:: 2**i, :: 2**i] for i in range(cfg.dense.pyramid_levels)]
    tb.load_state_dict(convert.frame_builder_state_dict(params, levels))
    return jb, tb, cfg, synthetic.captures(2, 5)


def test_convert_loads_reference_state(small_builders):
    jb, tb, _, _ = small_builders
    for k, v in jb._params.items():
        np.testing.assert_array_equal(getattr(tb, k).numpy(), np.asarray(v))
    with pytest.raises(KeyError):
        convert.frame_builder_state_dict({"bogus": np.zeros(1)}, [])


def test_stitch_and_gray_bit_equal_on_same_maps(small_builders, rng):
    jb, tb, _, caps = small_builders
    rgb, depth_mm = caps[0]
    depth = (depth_mm.astype(np.float32) * np.float32(0.001)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.05] = 0.0
    srgb_j, sd_j = jst.stitch(jb.maps, jnp.asarray(rgb), jnp.asarray(depth))
    srgb_t, sd_t = tst.stitch(tb.maps, torch.from_numpy(rgb), torch.from_numpy(depth))
    np.testing.assert_array_equal(srgb_t.numpy(), np.asarray(srgb_j))
    np.testing.assert_array_equal(sd_t.numpy(), np.asarray(sd_j))
    np.testing.assert_array_equal(
        tst.rgb_to_gray(srgb_t).numpy(), np.asarray(jst.rgb_to_gray(srgb_j))
    )


def test_frame_build_matches_reference(small_builders):
    """The whole build (u16 mm -> undistort -> stitch -> gray) on the same
    maps.  The reference's build is one jitted XLA program whose fused
    multiply-adds round the CLAMS interpolation and the gray sum once
    instead of twice: depth to 4 ulps, gray to 2 ulps of 1.0."""
    jb, tb, _, caps = small_builders
    rgb, depth_mm = caps[1]
    from rgbd360_tpu.core.frame import RigFrame as JaxRig
    from rgbd360_tpu_torch.core.frame import RigFrame

    sj = jb.build(JaxRig(jnp.asarray(rgb), jnp.asarray(depth_mm)))
    st = tb.build(RigFrame(torch.from_numpy(rgb), torch.from_numpy(depth_mm)))
    np.testing.assert_array_equal(st.sphere_rgb.numpy(), np.asarray(sj.sphere_rgb))
    np.testing.assert_allclose(
        st.sphere_depth.numpy(), np.asarray(sj.sphere_depth), rtol=4.8e-7, atol=0
    )
    np.testing.assert_allclose(
        st.sphere_gray.numpy(), np.asarray(sj.sphere_gray), rtol=0, atol=2.4e-7
    )
    assert st.sphere_depth.dtype == torch.float32
    with pytest.raises(ValueError, match="builder on"):
        tb.build(RigFrame(torch.zeros(1, device="meta"), torch.zeros(1, device="meta")))
