"""Carry the reference package's state into the port.

`frame_builder_state_dict` turns the reference `FrameBuilder._params`
(given as numpy arrays: `sensor`, `u`, `v`, `scale`, `valid`, `rt`,
`rt_inv`, `k` and, with a CLAMS model, `clams_m_img`, `clams_c_img`) and
its per-level seam masks into a state dict for the port's
`core.frame.FrameBuilder`:

    builder.load_state_dict(frame_builder_state_dict(params, seam_levels))

Both packages then stitch with the very same gather maps.
`stitch_maps_state_dict` carries only the stitch maps (and the seam masks
they give), for `load_state_dict(..., strict=False)`.
`config_from_reference` and `calibration_from_reference` rebuild the port's
own `config` dataclasses and `io.calib.Calibration` from the reference's,
field by field; `config_to_reference` and `calibration_to_reference` go the
other way, given the reference's module or class (this module imports
nothing of the reference package).
`plane_set_from_numpy` and `plane_set_to_numpy` carry a plane set (the
reference's `PlaneSet` with numpy fields) across, both ways.
`map_from_numpy` / `map_to_numpy` and `pose_graph_from_numpy` /
`pose_graph_to_numpy` carry a keyframe map and a pose graph across leaf by
leaf: the leaves are the reference's `jax.tree_util.tree_flatten` of its
`Map360` / `PoseGraph` (the dataclasses' fields in order), as numpy arrays
with bfloat16 widened to float32, as `Map360.save` writes them.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping, Sequence

import numpy as np
import torch

from rgbd360_tpu_torch import config as _config
from rgbd360_tpu_torch.io.calib import Calibration


def _rebuild(obj, module):
    """The dataclass of `obj`'s class name in `module`, rebuilt from `obj`
    field by field (nested dataclasses too); a missing or extra field
    raises."""
    cls = getattr(module, type(obj).__name__)
    names = {f.name for f in dataclasses.fields(cls)}
    have = {f.name for f in dataclasses.fields(obj)}
    if names != have:
        raise TypeError(
            f"{cls.__module__}.{cls.__name__} and {type(obj).__module__}."
            f"{type(obj).__name__} differ in fields {sorted(names ^ have)}"
        )
    values = {}
    for name in names:
        v = getattr(obj, name)
        values[name] = _rebuild(v, module) if dataclasses.is_dataclass(v) else v
    return cls(**values)


def config_from_reference(cfg):
    """The port's twin of a reference config dataclass (a `FrameworkConfig`
    or any of its parts), rebuilt field by field."""
    return _rebuild(cfg, _config)


def config_to_reference(cfg, reference_config):
    """A port config dataclass as the class of the same name in
    `reference_config` (the reference's `config` module)."""
    return _rebuild(cfg, reference_config)


def _calibration_as(calib, cls):
    return cls(**{f.name: getattr(calib, f.name) for f in dataclasses.fields(cls)})


def calibration_from_reference(calib) -> Calibration:
    """The port's `io.calib.Calibration` from the reference's (the same
    arrays, not copies)."""
    return _calibration_as(calib, Calibration)


def calibration_to_reference(calib: Calibration, reference_calibration):
    """A port calibration as `reference_calibration` (the reference's
    `io.calib.Calibration` class)."""
    return _calibration_as(calib, reference_calibration)

_DTYPES = {
    "sensor": torch.int32,
    "u": torch.int32,
    "v": torch.int32,
    "scale": torch.float32,
    "valid": torch.bool,
    "rt": torch.float32,
    "rt_inv": torch.float32,
    "k": torch.float32,
    "clams_m_img": torch.float32,
    "clams_c_img": torch.float32,
}


def frame_builder_state_dict(
    params: Mapping[str, np.ndarray], seam_levels: Sequence[np.ndarray]
) -> dict[str, torch.Tensor]:
    """State dict of `core.frame.FrameBuilder` from the reference builder's
    parameters and per-level seam masks (numpy arrays)."""
    unknown = set(params) - set(_DTYPES)
    if unknown:
        raise KeyError(f"no buffer for reference parameters {sorted(unknown)}")
    state = {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(_DTYPES[k])
        for k, v in params.items()
    }
    for lvl, m in enumerate(seam_levels):
        state[f"seam_{lvl}"] = torch.from_numpy(np.ascontiguousarray(m, dtype=bool))
    return state


_MAP_KEYS = ("sensor", "u", "v", "scale", "valid")


def stitch_maps_state_dict(
    maps: Mapping[str, np.ndarray], levels: int
) -> dict[str, torch.Tensor]:
    """State dict of the builder's stitch maps, from the reference builder's
    `sensor`, `u`, `v`, `scale` and `valid` (numpy arrays of any integer /
    float width), and of the `levels` per-level seam masks they give."""
    from rgbd360_tpu_torch.ops import stitch
    from rgbd360_tpu_torch.registration import dense

    state = frame_builder_state_dict({k: maps[k] for k in _MAP_KEYS}, [])
    seam = stitch.seam_mask_from_maps(stitch.StitchMaps(**state), 1)
    for lvl, m in enumerate(dense.seam_masks_per_level(seam, levels)):
        state[f"seam_{lvl}"] = m
    return state


def plane_set_from_numpy(planes, device=None):
    """The port's `ops.segmentation.PlaneSet` from a plane set whose fields
    (attributes, or keys of a mapping) are numpy arrays: e.g. the
    reference's `PlaneSet` after `jax.device_get`."""
    from rgbd360_tpu_torch.ops.segmentation import PlaneSet

    get = planes.__getitem__ if isinstance(planes, Mapping) else planes.__getattribute__
    return PlaneSet(**{
        f.name: torch.from_numpy(np.array(get(f.name))).to(device)
        for f in dataclasses.fields(PlaneSet)
    })


def plane_set_to_numpy(planes) -> dict[str, np.ndarray]:
    """{field: numpy array} of the port's PlaneSet, on the host (the
    reference's `PlaneSet(**{k: jnp.asarray(v) ...})` takes it back)."""
    return {f.name: getattr(planes, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(planes)}


def map_to_numpy(map360) -> list[np.ndarray]:
    """The leaves of the port's `slam.map.Map360` as host numpy arrays, in
    the reference's flattening order (bfloat16 widened to float32)."""
    return map360.to_numpy()


def map_from_numpy(leaves: Sequence[np.ndarray], template):
    """The port's `Map360` from the reference map's leaves; `template` (a
    port map, e.g. `Map360.empty(...)`) gives the dtypes and the device, the
    leaves their own capacities."""
    return type(template).from_numpy(leaves, template)


def pose_graph_to_numpy(graph) -> list[np.ndarray]:
    """The leaves of the port's `slam.graph.PoseGraph` as numpy arrays."""
    return [getattr(graph, f.name).detach().cpu().numpy() for f in dataclasses.fields(graph)]


def pose_graph_from_numpy(leaves: Sequence[np.ndarray], device=None):
    """The port's `PoseGraph` from the reference graph's leaves (poses,
    vmask, edges_ij, rel, info, emask)."""
    from rgbd360_tpu_torch.slam.graph import PoseGraph

    return PoseGraph(*(torch.from_numpy(np.array(a)).to(device) for a in leaves))
