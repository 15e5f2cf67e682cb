"""The parallax-refined stitch in both packages, at a reduced size
(`synthetic.config(subsample=4, pyramid_levels=3)`: 8x60x80 rig, 80x480
sphere): `refine_stitch_maps`, `stitch_refined`, `fast_stitch`, and
`FrameBuilder`'s refined branch in `build`, `build_with_pyramid` and
`build_full` (a batch never refines, as the reference's `build_batch`).
The port's builder holds the reference's stitch maps
(`convert.stitch_maps_state_dict`): the two packages' maps differ on the
sensor-tie columns, and the first pass feeds the second.

Tolerances (`chip_smoke`'s): the refined integer maps equal except on
STITCH_FLIP_FRAC of the pixels (each ray's sensor coordinates round
differently: PyTorch's 3x3 products have no fused multiply-adds, XLA's
may; measured on the CPU 1 pixel of 614,400 at full size, none here), the
refined depth within STITCH_DEPTH_RTOL relative wherever the indices
agree (measured 2.1e-7), the gray within 2.4e-7 there (the reference's
jitted gray fuses multiply-adds, tests/test_torch_ops.py)."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rgbd360_tpu.core.frame import RigFrame as JRigFrame
from rgbd360_tpu.ops import stitch as jst
from rgbd360_tpu_torch import convert, synthetic
from rgbd360_tpu_torch.core.frame import FrameBuilder, RigFrame
from rgbd360_tpu_torch.ops import stitch as tst

from _reference import reference_inputs
from test_torch_segmentation import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]
import chip_smoke  # noqa: E402

SUB, LEVELS = 4, 3
GRAY_ATOL = 2.4e-7
MAP_KEYS = ("sensor", "u", "v", "scale", "valid")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _refined(cfg):
    return cfg.replace(sphere=dataclasses.replace(cfg.sphere, parallax_refine=True))


@pytest.fixture(scope="module")
def setup():
    """The reference's plain and refined builders (the rig's calibration
    without CLAMS, as the apps' `--no-intrinsics` directory), the port's
    on the reference's maps, and the walk's first two captures."""
    from rgbd360_tpu.core.frame import FrameBuilder as JFrameBuilder

    cfg = synthetic.config(SUB, LEVELS)
    ref_cfg, cal = reference_inputs(cfg)
    cal = dataclasses.replace(cal, clams_multipliers=None, clams_counts=None)
    jplain = JFrameBuilder(cal, ref_cfg)
    jref = JFrameBuilder(cal, _refined(ref_cfg))
    tb = FrameBuilder(chip_smoke.extras_calibration(cfg), _refined(cfg), device="cpu")
    maps = {k: np.asarray(jplain._params[k]) for k in MAP_KEYS}
    tb.load_state_dict(convert.stitch_maps_state_dict(maps, LEVELS), strict=False)
    caps = synthetic.captures(2, SUB)
    return dict(cfg=cfg, jplain=jplain, jref=jref, tb=tb, caps=caps, maps=maps)


def _jframe(cap):
    return JRigFrame(jnp.asarray(cap[0]), jnp.asarray(cap[1]))


def _tframe(cap):
    return RigFrame(torch.from_numpy(cap[0]), torch.from_numpy(cap[1]))


def _close_where_same(got_d, ref_d, same, what):
    flips = float(np.mean(~same))
    rel = np.abs(got_d - ref_d)[same] / np.maximum(np.abs(ref_d[same]), 1e-6)
    assert flips <= chip_smoke.STITCH_FLIP_FRAC, (what, flips)
    assert rel.max() <= chip_smoke.STITCH_DEPTH_RTOL, (what, rel.max())
    np.testing.assert_array_equal(got_d[same] > 0, ref_d[same] > 0, err_msg=what)


@pytest.mark.parametrize("frame", [0, 1])
def test_refine_stitch_maps(setup, frame):
    """The refined maps of a first-pass depth: the integer maps equal
    except on STITCH_FLIP_FRAC, the scale within 2 ulps; the sensor and
    validity maps carried over unchanged."""
    cfg, cap = setup["cfg"], setup["caps"][frame]
    depth = cap[1].astype(np.float32) * 0.001
    p = setup["jplain"]._params
    jm = jst.StitchMaps(**{k: p[k] for k in MAP_KEYS})
    d0 = np.asarray(jst.stitch(jm, jnp.asarray(cap[0]), jnp.asarray(depth))[1])
    ref = jst.refine_stitch_maps(jm, jnp.asarray(d0), p["rt_inv"], p["k"],
                                 cfg.rig.height, cfg.rig.width)
    tb = setup["tb"]
    got = tst.refine_stitch_maps(tb.maps, _t(d0), tb.rt_inv, tb.k, cfg.rig.height, cfg.rig.width)
    same = (got.u.numpy() == np.asarray(ref.u)) & (got.v.numpy() == np.asarray(ref.v))
    assert np.mean(~same) <= chip_smoke.STITCH_FLIP_FRAC
    np.testing.assert_allclose(got.scale.numpy()[same], np.asarray(ref.scale)[same], rtol=2.4e-7)
    np.testing.assert_array_equal(got.sensor.numpy(), np.asarray(ref.sensor))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert got.u.dtype == torch.int32 and got.scale.dtype == torch.float32


@pytest.mark.parametrize("frame", [0, 1])
def test_stitch_refined(setup, frame):
    """`stitch_refined` on the same maps: RGB equal and depth within
    STITCH_DEPTH_RTOL wherever both sampled the same pixel."""
    cap = setup["caps"][frame]
    depth = cap[1].astype(np.float32) * 0.001
    p = setup["jplain"]._params
    jm = jst.StitchMaps(**{k: p[k] for k in MAP_KEYS})
    j_rgb, j_d = jst.stitch_refined(jm, jnp.asarray(cap[0]), jnp.asarray(depth), p["rt"],
                                    p["rt_inv"], p["k"])
    tb = setup["tb"]
    t_rgb, t_d = tst.stitch_refined(tb.maps, _t(cap[0]), _t(depth), tb.rt, tb.rt_inv, tb.k)
    same = np.all(t_rgb.numpy() == np.asarray(j_rgb), axis=-1)
    _close_where_same(t_d.numpy(), np.asarray(j_d), same, "stitch_refined")
    assert t_rgb.dtype == torch.float32 and t_d.shape == tuple(np.asarray(j_d).shape)


def test_fast_stitch_bit_equal(setup):
    """The concatenation-only panorama: a pure rearrangement, bit-equal."""
    rgb = setup["caps"][0][0]
    np.testing.assert_array_equal(tst.fast_stitch(_t(rgb)).numpy(),
                                  np.asarray(jst.fast_stitch(jnp.asarray(rgb))))


@pytest.mark.parametrize("entry", ["build", "build_with_pyramid", "build_full"])
def test_builder_refined_branch(setup, entry):
    """`FrameBuilder` with `parallax_refine` takes the refined stitch in
    every single-frame entry point, like the reference's `_build_impl`;
    the refined sphere's gray and depth match the reference's within the
    module's tolerances, and the cloud stage (which no stitch enters) is
    the plain build's."""
    tb, cap = setup["tb"], setup["caps"][1]
    out = getattr(tb, entry)(_tframe(cap))
    sphere = out if entry == "build" else out[0]
    ref = setup["jref"].build(_jframe(cap))
    same = np.all(sphere.sphere_rgb.numpy() == np.asarray(ref.sphere_rgb), axis=-1)
    _close_where_same(sphere.sphere_depth.numpy(), np.asarray(ref.sphere_depth), same, entry)
    np.testing.assert_allclose(sphere.sphere_gray.numpy()[same],
                               np.asarray(ref.sphere_gray)[same], atol=GRAY_ATOL)
    if entry != "build":
        pyr = out[1]
        np.testing.assert_array_equal(pyr.depth[0].numpy(), sphere.sphere_depth.numpy())
        assert len(pyr.depth) == LEVELS
    plain = setup["jplain"].build(_jframe(cap))
    np.testing.assert_array_equal(np.nan_to_num(sphere.cloud_xyz.numpy()),
                                  np.nan_to_num(tb.build(_tframe(cap)).cloud_xyz.numpy()))
    assert sphere.cloud_valid.shape == tuple(np.asarray(plain.cloud_valid).shape)


def test_refined_differs_from_plain(setup):
    """The refined and the plain spheres of one capture differ (the second
    pass moves samples), and a batch build never refines: each element of
    a batch equals the plain single build."""
    tb, caps = setup["tb"], setup["caps"]
    plain_b = FrameBuilder(chip_smoke.extras_calibration(setup["cfg"]), setup["cfg"], device="cpu")
    plain_b.load_state_dict(convert.stitch_maps_state_dict(setup["maps"], LEVELS), strict=False)
    refined = tb.build(_tframe(caps[0])).sphere_depth
    plain = plain_b.build(_tframe(caps[0])).sphere_depth
    assert (refined != plain).float().mean() > 0.5
    batch = tb.build(RigFrame(torch.stack([_t(c[0]) for c in caps]),
                              torch.stack([_t(c[1]) for c in caps])))
    for i, cap in enumerate(caps):
        np.testing.assert_array_equal(batch.sphere_depth[i].numpy(),
                                      plain_b.build(_tframe(cap)).sphere_depth.numpy())


def test_refined_sample_gate(setup):
    """Phase m's gate on the refined stitch (`chip_smoke.check_refined_sample`)
    against the golden tool's reference sample, live at this size."""
    import torch_port_golden as G
    from rgbd360_tpu_torch.io.bin_format import RawRigFrame

    rgb, dmm = setup["caps"][0]
    raw = RawRigFrame(rgb=rgb, depth_mm=dmm, timestamp=0)
    golden = G.stitch_sample_jax(setup["cfg"], raw, n=512)
    plain_b = FrameBuilder(chip_smoke.extras_calibration(setup["cfg"]), setup["cfg"], device="cpu")
    plain_b.load_state_dict(convert.stitch_maps_state_dict(setup["maps"], LEVELS), strict=False)
    gaps = chip_smoke.check_refined_sample(plain_b, raw, golden, "refined sample")
    assert gaps["flips"] <= chip_smoke.STITCH_FLIP_FRAC
    # the port's own maps against the analytic room: the same errors as the
    # reference's within 5% (at this size the refined error is no 0.2x of
    # the plain one, so the full-size gates are not asserted)
    own = FrameBuilder(chip_smoke.extras_calibration(setup["cfg"]), setup["cfg"], device="cpu")
    chip_smoke.check_octagon(chip_smoke.octagon_errors(own, raw), golden, "octagon",
                             absolute=False)
