"""The port's own copies of the reference's plain-Python modules (`config`,
`io.calib`, `apps.grabber`) held to the reference: the same defaults field
for field, `convert`'s rebuilders in both directions, and the synthetic
captures byte for byte from the same seed."""

import dataclasses

import numpy as np
import pytest

from rgbd360_tpu import config as JC
from rgbd360_tpu.apps import grabber as JG
from rgbd360_tpu.calibration.solver import construction_spec_rt as jax_spec_rt
from rgbd360_tpu.io import calib as JCAL
from rgbd360_tpu_torch import config as TC
from rgbd360_tpu_torch import convert, synthetic
from rgbd360_tpu_torch.apps import grabber as TG
from rgbd360_tpu_torch.io import calib as TCAL

_CONFIG_CLASSES = sorted(
    name for name, obj in vars(JC).items()
    if dataclasses.is_dataclass(obj) and isinstance(obj, type)
)


def _asdict_shared(obj):
    """`dataclasses.asdict` of a config dataclass without the port's own
    fields (`config.PORT_FIELDS`), nested ones too."""
    if not dataclasses.is_dataclass(obj):
        return obj
    own = TC.PORT_FIELDS.get(type(obj).__name__, ())
    return {f.name: _asdict_shared(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if f.name not in own}


def test_default_config_equal():
    assert _asdict_shared(TC.default_config()) == dataclasses.asdict(JC.default_config())
    assert type(TC.default_config()).__module__ == "rgbd360_tpu_torch.config"


@pytest.mark.parametrize("name", _CONFIG_CLASSES)
def test_config_class_twin(name):
    """Every config dataclass of the reference has a twin of the same fields,
    types and defaults, frozen and hashable like it; the port's own fields
    (`PORT_FIELDS`) come last."""
    ref, port = getattr(JC, name), getattr(TC, name)
    own = TC.PORT_FIELDS.get(name, ())
    fields = [(f.name, f.type) for f in dataclasses.fields(port)]
    assert fields[:len(fields) - len(own)] == [(f.name, f.type) for f in dataclasses.fields(ref)]
    assert [n for n, _ in fields[len(fields) - len(own):]] == list(own)
    assert _asdict_shared(port()) == dataclasses.asdict(ref())
    assert hash(port()) == hash(port())
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(port(), dataclasses.fields(port)[0].name, 0)


def _non_default(mod):
    cfg = mod.default_config()
    return cfg.replace(
        rig=dataclasses.replace(cfg.rig, width=64, height=48, fx=52.5, bilateral=False),
        dense=dataclasses.replace(cfg.dense, pyramid_levels=3, salient_pixels=2000),
        kf=dataclasses.replace(cfg.kf, fallback_error=0.0),
    )


def test_config_from_reference_round_trips():
    ref = _non_default(JC)
    port = convert.config_from_reference(ref)
    assert type(port) is TC.FrameworkConfig and type(port.dense) is TC.DenseRegConfig
    assert port == _non_default(TC)
    assert _asdict_shared(port) == dataclasses.asdict(ref)
    back = convert.config_to_reference(port, JC)
    assert type(back) is JC.FrameworkConfig and back == ref
    # a part converts on its own
    assert convert.config_from_reference(ref.seg) == port.seg


def test_port_fields_cross_at_their_defaults_only():
    """The port's own fields: filled with their defaults from the
    reference, left behind at their defaults, refused elsewhere (the
    reference has no such configuration)."""
    assert set(TC.PORT_FIELDS) <= set(_CONFIG_CLASSES)
    port = convert.config_from_reference(JC.default_config())
    assert port.graph.dtype == "float32" and port == TC.default_config()
    assert convert.config_to_reference(port, JC) == JC.default_config()
    f64 = port.replace(graph=dataclasses.replace(port.graph, dtype="float64"))
    with pytest.raises(ValueError, match="dtype"):
        convert.config_to_reference(f64, JC)


def test_config_rebuild_refuses_other_fields():
    @dataclasses.dataclass(frozen=True)
    class RigConfig:
        width: int = 1

    with pytest.raises(TypeError, match="differ in fields"):
        convert.config_from_reference(RigConfig())


def test_pinhole_k_bit_equal():
    np.testing.assert_array_equal(TCAL.pinhole_k(), JCAL.pinhole_k())
    rig = _non_default(TC).rig
    np.testing.assert_array_equal(
        TCAL.pinhole_k(rig), JCAL.pinhole_k(convert.config_to_reference(rig, JC))
    )


def test_calibration_converts_both_ways():
    cal = synthetic.calibration(synthetic.config(5).rig)
    assert type(cal) is TCAL.Calibration and cal.num_sensors == 8
    ref = convert.calibration_to_reference(cal, JCAL.Calibration)
    assert type(ref) is JCAL.Calibration
    back = convert.calibration_from_reference(ref)
    assert type(back) is TCAL.Calibration
    for f in dataclasses.fields(TCAL.Calibration):
        a, b, c = (getattr(x, f.name) for x in (cal, ref, back))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_load_extrinsics_twin(tmp_path, rng):
    mats = rng.normal(size=(8, 4, 4))
    for s in range(8):
        np.savetxt(tmp_path / f"Rt_0{s + 1}.txt", mats[s])
    np.testing.assert_array_equal(
        TCAL.load_extrinsics(tmp_path), JCAL.load_extrinsics(tmp_path)
    )
    got, ref = TCAL.load_calibration(tmp_path), JCAL.load_calibration(tmp_path)
    np.testing.assert_array_equal(got.rt_inv, ref.rt_inv)
    assert got.clams_multipliers is None


@pytest.mark.parametrize("room", ["octagon", "cylinder"])
def test_synth_capture_bit_equal(room):
    """The same bytes from the same seed, with an explicit rig and pose and
    with the defaults (the construction-spec rig, the legacy walk)."""
    rt = jax_spec_rt()
    pose = TG.synth_trajectory_poses("loop", 5)[2]
    for kw in (dict(rt=rt, pose=pose, radius=5.0), dict()):
        got = TG.synth_capture(3, seed=7, room=room, **kw)
        ref = JG.synth_capture(3, seed=7, room=room, **kw)
        np.testing.assert_array_equal(got.rgb, ref.rgb)
        np.testing.assert_array_equal(got.depth_mm, ref.depth_mm)
        assert got.timestamp == ref.timestamp


@pytest.mark.parametrize("kind", ["walk", "loop"])
def test_synth_trajectory_poses_bit_equal(kind):
    np.testing.assert_array_equal(
        TG.synth_trajectory_poses(kind, 7), JG.synth_trajectory_poses(kind, 7)
    )
