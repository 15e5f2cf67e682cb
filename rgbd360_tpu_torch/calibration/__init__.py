"""Extrinsic calibration of the rig (twin of `rgbd360_tpu/calibration`)."""
from rgbd360_tpu_torch.calibration.control_planes import (
    ControlPlanes,
    collect_control_planes,
)
from rgbd360_tpu_torch.calibration.solver import (
    PairCalibrator,
    RigCalibrator,
    calibrate_pair_rotation,
    calibrate_pair_translation,
    fim_rotation,
    fim_translation,
    conditioning,
)

__all__ = [
    "ControlPlanes",
    "collect_control_planes",
    "PairCalibrator",
    "RigCalibrator",
    "calibrate_pair_rotation",
    "calibrate_pair_translation",
    "fim_rotation",
    "fim_translation",
    "conditioning",
]
