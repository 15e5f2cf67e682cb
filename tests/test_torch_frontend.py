"""The per-frame front end in both packages, at a reduced size
(`synthetic.config(subsample=4, pyramid_levels=3)`: 8x60x80 rig, 80x480
sphere, 8x30x40 clouds): the 2x downsamples, the cloud stage (bilateral,
depth gate, backprojection, rig transform, NaN for invalid points),
`build_full` (build + pyramid + planes), `build` and `segment_planes` of
a batch (the reference's `build_batch` and `segment_planes_batch`) and
`segment_planes_from_sphere`.  The port's
builder stitches with the reference's maps (`convert`), so the spheres
and pyramids are the same; the clouds do not read the maps."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rgbd360_tpu.core import frame as JF
from rgbd360_tpu_torch import convert, synthetic
from rgbd360_tpu_torch.core import frame as TF

from test_torch_segmentation import assert_plane_sets_match, one_torch_thread  # noqa: F401

from _reference import reference_inputs

SUB, LEVELS = 4, 3
# The clouds through the bilateral (XLA's exp and fused multiply-adds, see
# tests/test_torch_bilateral.py) and the rig transform's 3-term dot
# products: measured within 4.3e-6 m at 2-6 m.
CLOUD_ATOL_M = 2e-5
# tests/test_torch_batch.py: the reference's jitted build fuses multiply-adds.
SPHERE_RTOL = 1e-6
LEVEL_ATOL = 1e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _builders(downsample_cloud=True, bilateral=True):
    cfg = synthetic.config(SUB, LEVELS)
    cfg = cfg.replace(rig=dataclasses.replace(cfg.rig, bilateral=bilateral))
    cal = synthetic.calibration(cfg.rig)
    jcfg, jcal = reference_inputs(cfg)
    jb = JF.FrameBuilder(jcal, jcfg, downsample_cloud=downsample_cloud)
    tb = TF.FrameBuilder(cal, cfg, downsample_cloud=downsample_cloud, device="cpu")
    maps = {k: np.asarray(jb._params[k]) for k in ("sensor", "u", "v", "scale", "valid")}
    tb.load_state_dict(convert.stitch_maps_state_dict(maps, LEVELS), strict=False)
    return jb, tb


@pytest.fixture(scope="module")
def setup():
    jb, tb = _builders()
    caps = synthetic.captures(2, SUB)
    return dict(jb=jb, tb=tb, caps=caps)


def _assert_clouds_match(got, ref):
    np.testing.assert_array_equal(got["cloud_valid"], ref["cloud_valid"])
    np.testing.assert_array_equal(got["cloud_rgb"], ref["cloud_rgb"])
    np.testing.assert_allclose(got["local_xyz"], ref["local_xyz"], rtol=0, atol=CLOUD_ATOL_M)
    np.testing.assert_allclose(got["cloud_xyz"], ref["cloud_xyz"], rtol=0, atol=CLOUD_ATOL_M,
                               equal_nan=True)
    assert (np.isnan(got["cloud_xyz"]).any(-1) == ~got["cloud_valid"]).all()
    for k in ("sphere_rgb", "sphere_gray", "sphere_depth"):
        np.testing.assert_allclose(got[k], ref[k], rtol=SPHERE_RTOL, atol=3e-7, err_msg=k)


def test_downsamples_bit_equal(rng):
    """Even shapes (the block-sum matmuls) and odd shapes (the reshape
    path), with holes; integer-valued rgb."""
    for shape in ((2, 30, 40), (7, 9)):
        d = rng.uniform(0.5, 6.0, shape).astype(np.float32)
        d[rng.uniform(size=shape) < 0.3] = 0.0
        np.testing.assert_array_equal(TF.downsample2_depth(_t(d)).numpy(),
                                      np.asarray(JF.downsample2_depth(jnp.asarray(d))))
    rgb = rng.integers(0, 256, (2, 30, 40, 3)).astype(np.float32)
    np.testing.assert_array_equal(TF.downsample2_rgb(_t(rgb)).numpy(),
                                  np.asarray(JF.downsample2_rgb(jnp.asarray(rgb))))


@pytest.mark.parametrize("downsample_cloud,bilateral", [(True, True), (False, False)])
def test_cloud_stage_matches_reference(setup, downsample_cloud, bilateral):
    jb, tb = (setup["jb"], setup["tb"]) if downsample_cloud else _builders(False, False)
    rgb, d = setup["caps"][0]
    d = d.copy()  # holes (0 = invalid) and depths past max_depth: NaN points
    d[:, 10:20, 20:40] = 0
    d[:3, 40:50, :30] = 12000
    ref = _np(jax.device_get(jb.build(JF.RigFrame(jnp.asarray(rgb), jnp.asarray(d)))))
    got = _np(tb.build(TF.RigFrame(_t(rgb), _t(d))))
    hc = 30 if downsample_cloud else 60
    assert got["cloud_xyz"].shape == (8, hc, hc * 4 // 3, 3)
    _assert_clouds_match(got, ref)
    assert 0.3 < got["cloud_valid"].mean() < 1.0


@pytest.fixture(scope="module")
def full(setup):
    """`build_full` of capture 0 in both packages."""
    rgb, d = setup["caps"][0]
    ref = jax.device_get(setup["jb"].build_full(JF.RigFrame(jnp.asarray(rgb), jnp.asarray(d))))
    got = setup["tb"].build_full(TF.RigFrame(_t(rgb), _t(d)))
    return ref, got


def test_build_full_matches_reference(full):
    (rs, rp, rpl), (gs, gp, gpl) = full
    _assert_clouds_match(_np(gs), _np(rs))
    for f in ("gray", "depth", "gray_gx", "gray_gy", "depth_gx", "depth_gy"):
        for lvl in range(LEVELS):
            np.testing.assert_allclose(getattr(gp, f)[lvl].numpy(), np.asarray(getattr(rp, f)[lvl]),
                                       rtol=1e-5, atol=LEVEL_ATOL, err_msg=f"{f}[{lvl}]")
    assert gpl.valid.shape == (32,)
    assert_plane_sets_match(_np(gpl), _np(rpl))
    assert int(gpl.valid.sum()) >= 8


def test_build_batch_matches_per_frame_and_reference(setup, full):
    """B = 2 in one `build` call: each frame bit-equal to the port's own
    single-frame `build`, and within the cloud tolerance of the reference's
    `build_batch`; `segment_planes` of the batch (the reference's
    `segment_planes_batch`) is the per-frame segmentation."""
    tb, jb = setup["tb"], setup["jb"]
    rgbs = np.stack([c[0] for c in setup["caps"]])
    depths = np.stack([c[1] for c in setup["caps"]])
    got = tb.build(TF.RigFrame(_t(rgbs), _t(depths)))
    assert got.cloud_xyz.shape[:2] == (2, 8) and got.sphere_gray.shape[0] == 2
    for b in range(2):
        one = tb.build(TF.RigFrame(_t(rgbs[b]), _t(depths[b])))
        for f in dataclasses.fields(one):
            assert torch.equal(getattr(got, f.name)[b].nan_to_num(-7.0),
                               getattr(one, f.name).nan_to_num(-7.0)), (b, f.name)
    ref = _np(jax.device_get(jb.build_batch(jnp.asarray(rgbs), jnp.asarray(depths))))
    _assert_clouds_match(_np(got), ref)

    planes = tb.segment_planes(got)
    assert planes.valid.shape == (2, 32)
    single = full[1][2]
    for name, v in _np(single).items():
        np.testing.assert_allclose(getattr(planes, name)[0].numpy(), v, rtol=1e-6, atol=1e-6,
                                   err_msg=name)


def test_segment_planes_from_sphere_matches_reference(full, setup):
    """Planes straight from the sphere (the stereo-style input), with and
    without the sphere's rgb."""
    rs = full[0][0]
    depth, rgb = np.asarray(rs.sphere_depth), np.asarray(rs.sphere_rgb)
    for use_rgb in (True, False):
        ref = setup["jb"].segment_planes_from_sphere(
            jnp.asarray(depth), jnp.asarray(rgb) if use_rgb else None, downsample=2)
        got = setup["tb"].segment_planes_from_sphere(
            _t(depth), _t(rgb) if use_rgb else None, downsample=2)
        assert_plane_sets_match(_np(got), _np(jax.device_get(ref)))
