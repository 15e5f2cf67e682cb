"""The frozen traffic generator at subsample 4 on the CPU: the same
geometry as the port's grabber, the noise drawn from the seed."""

import numpy as np
import torch

from perfbench import scene

PARAMS = dict(lap_frames=24, num_sensors=8, ring_radius_m=0.055, path_radius_m=0.8,
              room_inradius_m=5.0, room_half_height_m=1.7, noise_laps=2, noise_std=2.0)


def test_render_is_the_grabbers_capture():
    from rgbd360_tpu_torch.apps.grabber import synth_capture, synth_trajectory_poses

    rt = scene.construction_spec_rt()
    poses = scene.loop_poses(24, 0.8)
    np.testing.assert_allclose(poses, synth_trajectory_poses("loop", 24, radius=0.8))
    for i in (0, 7):
        tex, depth = scene.render(poses[i], rt, 5.0, 1.7, subsample=4)
        raw = synth_capture(i, seed=i, radius=5.0, rt=rt, pose=poses[i], room="octagon")
        np.testing.assert_array_equal(depth.numpy(), raw.depth_mm[:, ::4, ::4])
        # the grabber's blue channel is the texture plus N(0, 2) noise
        diff = raw.rgb[:, ::4, ::4, 0].astype(float) - np.clip(tex.numpy(), 0, 255)
        assert abs(diff.mean()) < 0.6 and 1.5 < diff.std() < 2.5


def test_seed_draws_the_noise_and_nothing_else():
    a = scene.LoopTraffic(PARAMS, 2**31 + 5, "cpu", subsample=4)
    b = scene.LoopTraffic(PARAMS, 2**31 + 5, "cpu", subsample=4)
    c = scene.LoopTraffic(PARAMS, 2**31 + 6, "cpu", subsample=4)
    for i in (0, 23, 24, 47, 48):
        np.testing.assert_array_equal(a.frame(i).rgb, b.frame(i).rgb)
        np.testing.assert_array_equal(a.frame(i).depth_mm, c.frame(i).depth_mm)
        assert not np.array_equal(a.frame(i).rgb, c.frame(i).rgb)
    # laps repeat the poses, each with noise of its own; lap 2 reuses lap 0's
    assert not np.array_equal(a.frame(0).rgb, a.frame(24).rgb)
    np.testing.assert_array_equal(a.frame(0).rgb, a.frame(48).rgb)
    assert not np.array_equal(a.warmup(0).rgb, a.frame(0).rgb)
    np.testing.assert_array_equal(a.gt(25), a.poses[1])
    cap = a.frame(3)
    assert cap.rgb.shape == (8, 60, 80, 3) and cap.rgb.dtype == np.uint8
    assert cap.depth_mm.shape == (8, 60, 80) and cap.depth_mm.dtype == np.uint16
    assert cap.rgb.flags.c_contiguous and cap.depth_mm.flags.c_contiguous
    # BGR: red at 0.9 of the others
    g = cap.rgb[..., 1].astype(float)
    np.testing.assert_array_equal(cap.rgb[..., 2], (g * 0.9).astype(np.uint8))


def test_noise_law():
    tex = torch.full((200, 300), 100.0, dtype=torch.float64)
    gen = torch.Generator().manual_seed(3)
    bgr = scene.add_noise(tex, 2.0, gen)
    v = bgr[..., 0].double() - 100.0 + 0.5  # truncation moves the mean by ~0.5
    assert abs(float(v.mean())) < 0.05 and abs(float(v.std()) - 2.0) < 0.1
