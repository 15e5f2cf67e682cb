"""The reference (JAX) package's builder for a config of the port: shared
by the port's parity tests and by `tools/torch_port_golden.py`."""

from __future__ import annotations

from rgbd360_tpu import config as reference_config
from rgbd360_tpu.core.frame import FrameBuilder
from rgbd360_tpu.io.calib import Calibration
from rgbd360_tpu_torch import convert, synthetic


def reference_inputs(cfg) -> tuple:
    """(config, calibration) for the reference package from a port
    `FrameworkConfig` (e.g. `synthetic.config(...)`): the reference's own
    dataclasses, rebuilt field by field, and the synthetic calibration of
    the config's rig."""
    return (
        convert.config_to_reference(cfg, reference_config),
        convert.calibration_to_reference(synthetic.calibration(cfg.rig), Calibration),
    )


def reference_builder(cfg) -> FrameBuilder:
    """The reference `FrameBuilder` of a port `FrameworkConfig`."""
    cfg, cal = reference_inputs(cfg)
    return FrameBuilder(cal, cfg)
