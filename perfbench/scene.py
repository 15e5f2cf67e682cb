"""The benchmark's traffic generator: the 8-sensor rig in the textured
octagon room, frozen here so that later changes to the program cannot move
the yardstick.

Frozen copies (repository commit e7cf3fe), each rewritten to run on the
card in large calls, with the arithmetic unchanged:

- `construction_spec_rt`: `rgbd360_tpu_torch/calibration/spec.py`.
- `synthetic_clams`: `rgbd360_tpu_torch/synthetic.py`.
- `loop_poses`: `synth_trajectory_poses("loop", ...)` of
  `rgbd360_tpu_torch/apps/grabber.py`.
- `render`: the geometry and texture of `synth_capture(room="octagon")` of
  the same file, without its noise; `add_noise` adds the noise.

The render is the noise-free part of a capture (depth in millimetres and
the texture before noise), done once per lap position; the noise is drawn
per lap and frame from the run's seed with a `torch.Generator` on the
render's device.  So the set-up's cost does not grow with the window, and
the same seed gives the same captures.  The grabber draws its noise with
numpy; the draws differ, their law (N(0, 2) grey levels, clipped and
truncated to uint8) does not.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

# The rig's QVGA pinhole (`synth_capture`'s constants)
SENSOR_H, SENSOR_W = 240, 320
FX = FY = 262.5
CX, CY = 159.5, 119.5


@dataclass
class Capture:
    """One raw rig capture on the host, as the grabber hands it over.

    rgb: (S, H, W, 3) uint8 BGR; depth_mm: (S, H, W) uint16 millimetres."""

    rgb: np.ndarray
    depth_mm: np.ndarray


def construction_spec_rt(num_sensors: int = 8, radius: float = 0.055) -> np.ndarray:
    """(S, 4, 4) sensor->rig transforms of the construction-spec ring:
    sensors 2pi/S apart, `radius` from the rig's up (x) axis."""
    rts = []
    for s in range(num_sensors):
        ang = 2.0 * np.pi * s / num_sensors
        z = np.array([0.0, -np.sin(ang), -np.cos(ang)])
        x = np.array([0.0, np.cos(ang), -np.sin(ang)])
        y = np.cross(z, x)
        rt = np.eye(4)
        rt[:3, :3] = np.stack([x, y, z], axis=1)
        rt[:3, 3] = z * radius
        rts.append(rt)
    return np.stack(rts)


def pinhole_k(subsample: int = 1) -> np.ndarray:
    """(3, 3) float32 intrinsics of the rig's sensors at 1/`subsample`."""
    s = subsample
    return np.array([[FX / s, 0.0, CX / s], [0.0, FY / s, CY / s], [0.0, 0.0, 1.0]], np.float32)


def synthetic_clams(num_sensors: int, h: int, w: int, bin_width: int = 4,
                    bin_height: int = 3, nbins: int = 5, seed: int = 0):
    """(multipliers, counts), each (S, nby, nbx, nbins) float32: a smooth
    radial pattern at most ~0.5% from 1 plus 0.05% noise; ~5% of the bins
    under the CLAMS minimum count of 50."""
    rng = np.random.default_rng(seed)
    nby, nbx = -(-h // bin_height), -(-w // bin_width)
    shape = (num_sensors, nby, nbx, nbins)
    yy = np.linspace(-1.0, 1.0, nby)[:, None]
    xx = np.linspace(-1.0, 1.0, nbx)[None, :]
    r2 = (xx * xx + yy * yy) / 2.0
    amp = rng.uniform(0.5, 1.0, num_sensors)[:, None, None, None]
    ramp = np.linspace(0.0, 1.0, nbins)
    mult = 1.0 + 0.005 * amp * r2[None, :, :, None] * ramp
    mult = mult + 0.0005 * rng.uniform(-1.0, 1.0, shape)
    counts = rng.uniform(60.0, 1000.0, shape)
    counts[rng.uniform(size=shape) < 0.05] = 10.0
    return mult.astype(np.float32), counts.astype(np.float32)


def loop_poses(n: int, radius: float) -> np.ndarray:
    """(n, 4, 4) world_T_rig poses on a closed circle of `radius` metres in
    the horizontal (y, z) plane, heading tangent; the frame after the last
    closes back onto the first."""
    poses = np.tile(np.eye(4), (n, 1, 1))
    theta = 2 * np.pi * np.arange(n) / n
    poses[:, 1, 3] = radius * np.sin(theta)
    poses[:, 2, 3] = radius * (np.cos(theta) - 1.0)
    c, s = np.cos(theta), np.sin(theta)
    poses[:, 1, 1] = c
    poses[:, 1, 2] = -s
    poses[:, 2, 1] = s
    poses[:, 2, 2] = c
    return poses


def _octagon_hit(o, d, inradius: float, half_height: float):
    """Sensor z-depth of the first hit on the octagonal prism room seen
    from inside: 8 vertical walls at `inradius` from the x axis, floor and
    ceiling at x = -/+ `half_height`.  o (S, 3) origins, d (S, h, w, 3)
    directions parameterized by sensor z-depth."""
    phis = (torch.arange(8, dtype=d.dtype, device=d.device) + 0.5) * (math.pi / 4)
    normals = torch.stack([torch.zeros_like(phis), torch.sin(phis), torch.cos(phis)], -1)
    den = d @ normals.T  # (S, h, w, 8)
    num = inradius - o @ normals.T  # (S, 8)
    num = num[:, None, None, :]
    inf = torch.tensor(math.inf, dtype=d.dtype, device=d.device)
    t_wall = torch.where(den > 1e-9, num / torch.clamp(den, min=1e-9), inf)
    dx = d[..., 0]
    ox = o[:, 0, None, None]
    t_up = torch.where(dx > 1e-9, (half_height - ox) / torch.clamp(dx, min=1e-9), inf)
    t_dn = torch.where(dx < -1e-9, (-half_height - ox) / torch.clamp(dx, max=-1e-9), inf)
    return torch.minimum(t_wall.min(dim=-1).values, torch.minimum(t_up, t_dn))


def render(pose: np.ndarray, rt: np.ndarray, inradius: float, half_height: float,
           subsample: int = 1, device="cpu"):
    """The noise-free capture of the rig at `pose` (4x4 world_T_rig), every
    `subsample`-th sensor pixel: (texture (S, h, w) float64 before noise,
    depth (S, h, w) uint16 millimetres as int32), on `device`, in float64
    like the grabber."""
    f64 = torch.float64
    s = subsample
    u = (torch.arange(0, SENSOR_W, s, dtype=f64, device=device) - CX) / FX
    v = (torch.arange(0, SENSOR_H, s, dtype=f64, device=device) - CY) / FY
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d_sensor = torch.stack([uu, vv, torch.ones_like(uu)], dim=-1)  # (h, w, 3)
    g = torch.as_tensor(np.asarray(pose, np.float64) @ rt, dtype=f64, device=device)  # (S, 4, 4)
    r3, t3 = g[:, :3, :3], g[:, :3, 3]
    d_rig = torch.einsum("hwj,sij->shwi", d_sensor, r3)  # d_sensor @ r3.T per sensor
    z = _octagon_hit(t3, d_rig, inradius, half_height)
    hit = t3[:, None, None, :] + z[..., None] * d_rig
    axial = hit[..., 0]
    azim = torch.atan2(hit[..., 1], hit[..., 2])
    depth = torch.clamp(z * 1000, 0, 65535).to(torch.int32)
    tex = (
        128
        + 55 * torch.sin(4 * azim) * torch.cos(5.0 * axial)
        + 35 * torch.sin(11 * azim + 2.0 * axial)
        + 30 * torch.sin(7.31 * azim - 3.17 * axial + 1.7)
        + 20 * torch.cos(13.73 * azim + 5.91 * axial)
    )
    return tex, depth


def add_noise(tex: torch.Tensor, std: float, gen: torch.Generator) -> torch.Tensor:
    """(..., S, h, w, 3) uint8 BGR from noise-free textures (..., S, h, w):
    N(0, std) grey levels added, clipped to [0, 255] and truncated, the red
    channel at 0.9 of the others, as the grabber does."""
    noise = torch.randn(tex.shape, generator=gen, device=tex.device, dtype=torch.float32)
    t = torch.clamp(tex + std * noise.to(tex.dtype), 0, 255).to(torch.uint8)
    red = torch.clamp(t.to(torch.float64) * 0.9, 0, 255).to(torch.uint8)
    return torch.stack([t, t, red], dim=-1)


class LoopTraffic:
    """The captures of a closed loop driven lap after lap.

    `params` is the traffic file's content.  Set-up renders the lap's
    `lap_frames` positions once and draws `noise_laps` laps of noise from
    `seed`, plus one lap for the warm-up; lap L of the window uses noise
    lap L mod `noise_laps`.  `frame(i)` is the i-th capture of the window,
    `warmup(i)` the warm-up's, `gt(i)` the ground-truth pose of window
    frame i (laps repeat the same poses)."""

    def __init__(self, params: dict, seed: int, device, subsample: int = 1):
        self.params = params
        self.n = int(params["lap_frames"])
        self.subsample = subsample
        self.rt = construction_spec_rt(int(params["num_sensors"]), float(params["ring_radius_m"]))
        self.poses = loop_poses(self.n, float(params["path_radius_m"]))
        tex, depth = [], []
        for p in self.poses:
            t, d = render(p, self.rt, float(params["room_inradius_m"]),
                          float(params["room_half_height_m"]), subsample, device)
            tex.append(t)
            depth.append(d)
        tex = torch.stack(tex)
        self.depth = torch.stack(depth).cpu().numpy().astype(np.uint16)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        laps = int(params["noise_laps"]) + 1
        self.rgb = [add_noise(tex, float(params["noise_std"]), gen).cpu().numpy()
                    for _ in range(laps)]

    def _capture(self, lap: int, pos: int) -> Capture:
        return Capture(rgb=self.rgb[lap][pos], depth_mm=self.depth[pos])

    def frame(self, i: int) -> Capture:
        lap, pos = divmod(i, self.n)
        return self._capture(lap % (len(self.rgb) - 1), pos)

    def warmup(self, i: int) -> Capture:
        return self._capture(len(self.rgb) - 1, i % self.n)

    def gt(self, i: int) -> np.ndarray:
        return self.poses[i % self.n]
