"""Carry the reference package's state into the port.

`frame_builder_state_dict` turns the reference `FrameBuilder._params`
(given as numpy arrays: `sensor`, `u`, `v`, `scale`, `valid`, `rt`,
`rt_inv`, `k` and, with a CLAMS model, `clams_m_img`, `clams_c_img`) and
its per-level seam masks into a state dict for the port's
`core.frame.FrameBuilder`:

    builder.load_state_dict(frame_builder_state_dict(params, seam_levels))

Both packages then stitch with the very same gather maps.  The config
dataclasses are shared as they are and need no conversion.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence

import numpy as np
import torch

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
