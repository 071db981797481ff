"""The mocap ingest of lifelike_tpu_torch vs the JAX reference, on the CPU.

Item 1: leg IK / FK (reachable and unreachable targets), the BVH parser and
its forward kinematics, retargeting, mirroring and load_raw_clips against
the JAX package at 1e-10, on a small quadruped BVH written here (the joint
names retarget's candidate lists accept; the raw reference captures are not
in the repository). Item 2: the distill_prior twin's window mining and
resampling against tools/distill_prior.py's on a constructed trajectory.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelike_tpu.motion import bvh as jbvh
from lifelike_tpu.motion import retarget as jretarget
from lifelike_tpu.robot import ik as jik
from lifelike_tpu_torch.motion import bvh, retarget
from lifelike_tpu_torch.robot import ik
from lifelike_tpu_torch.tools import distill_prior

from tests.torch_port_util import F64, assert_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, parent, rest offset (BVH Y-up: x forward, y up, z right), end offset)
LEGS = (("b_RightArm", 0.26, 0.08, ("b_RightForeArm", "b_RightHand")),
        ("b_LeftArm", 0.26, -0.08, ("b_LeftForeArm", "b_LeftHand")),
        ("b_RightLegUpper", -0.26, 0.08, ("b_RightLeg", "b_RightAnkle")),
        ("b_LeftLegUpper", -0.26, -0.08, ("b_LeftLeg", "b_LeftToe")))


def write_bvh(path, n_frames=40, seed=0):
    """A quadruped BVH: a Hips root with six channels and a Spine, four
    three-segment legs with ZXY rotation channels, animated with seeded
    sinusoids while the root walks forward along x."""
    rng = np.random.default_rng(seed)
    lines = ["HIERARCHY", "ROOT Hips", "{", "  OFFSET 0.0 0.0 0.0",
             "  CHANNELS 6 Xposition Yposition Zposition Zrotation Xrotation Yrotation",
             "  JOINT Spine", "  {", "    OFFSET 0.1 0.02 0.0",
             "    CHANNELS 3 Zrotation Xrotation Yrotation",
             "    End Site", "    {", "      OFFSET 0.1 0.0 0.0", "    }", "  }"]
    for root, x, z, (mid, end) in LEGS:
        lines += [f"  JOINT {root}", "  {", f"    OFFSET {x} -0.02 {z}",
                  "    CHANNELS 3 Zrotation Xrotation Yrotation",
                  f"    JOINT {mid}", "    {", "      OFFSET 0.0 -0.22 0.0",
                  "      CHANNELS 3 Zrotation Xrotation Yrotation",
                  f"      JOINT {end}", "      {", "        OFFSET 0.02 -0.22 0.0",
                  "        CHANNELS 3 Zrotation Xrotation Yrotation",
                  "        End Site", "        {", "          OFFSET 0.03 -0.04 0.0",
                  "        }", "      }", "    }", "  }"]
    lines += ["}", "MOTION", f"Frames: {n_frames}", "Frame Time: 0.0166667"]
    t = np.arange(n_frames) / 60.0
    n_rot = 3 + 4 * 9
    phase = rng.uniform(0, 2 * np.pi, n_rot)
    amp = rng.uniform(2.0, 15.0, n_rot)
    for i in range(n_frames):
        root = [0.8 * t[i], 0.5 + 0.01 * np.sin(6 * t[i]), 0.02 * np.sin(3 * t[i]),
                2.0 * np.sin(4 * t[i]), 1.5 * np.cos(5 * t[i]), 3.0 * np.sin(2 * t[i])]
        rot = amp * np.sin(2 * np.pi * 1.5 * t[i] + phase)
        lines.append(" ".join(f"{v:.6f}" for v in root + list(rot)))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _check_ik():
    rng = np.random.default_rng(3)
    q = np.stack([rng.uniform(-0.8, 0.8, 512), rng.uniform(-2.0, 1.0, 512),
                  rng.uniform(0.1, 2.4, 512)], axis=-1)
    sy = np.where(rng.uniform(size=512) < 0.5, -1.0, 1.0)
    assert_close(ik.leg_fk(torch.as_tensor(q), torch.as_tensor(sy)),
                 jik.leg_fk(jnp.asarray(q), jnp.asarray(sy)), rtol=1e-10, atol=1e-10)
    # targets inside the annulus, beyond its reach (> 0.45 m), inside its
    # hole (next to the hip) and on the lateral offset's singular circle
    p = np.concatenate([
        0.3 * rng.standard_normal((256, 3)),
        0.6 * rng.standard_normal((64, 3)) + np.array([0.0, 0.0, -0.8]),
        0.01 * rng.standard_normal((64, 3)),
        np.stack([np.zeros(64), 0.09 * np.cos(np.linspace(0, np.pi, 64)),
                  -0.09 * np.sin(np.linspace(0, np.pi, 64))], axis=-1),
    ])
    sy = np.resize([-1.0, 1.0], len(p))
    got = ik.leg_ik(torch.as_tensor(p), torch.as_tensor(sy))
    assert got.dtype == F64 and bool(torch.isfinite(got).all())
    assert_close(got, jik.leg_ik(jnp.asarray(p), jnp.asarray(sy)), rtol=1e-10, atol=1e-10)
    p4 = 0.3 * rng.standard_normal((32, 4, 3)) - np.array([0.0, 0.0, 0.25])
    assert_close(ik.all_legs_ik(torch.as_tensor(p4)), jik.all_legs_ik(jnp.asarray(p4)),
                 rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(ik.HIP_OFFSET, jik.HIP_OFFSET)


def _check_bvh_and_retarget(tmp_path):
    d = tmp_path / "raw"
    d.mkdir()
    write_bvh(str(d / "a.bvh"), 40, seed=0)
    write_bvh(str(d / "b.bvh"), 25, seed=1)
    (d / "notes.txt").write_text("not a clip")
    clip, jclip = bvh.parse_bvh(str(d / "a.bvh")), jbvh.parse_bvh(str(d / "a.bvh"))
    assert clip.names == jclip.names and clip.channels == jclip.channels
    for f in ("parents", "offsets", "chan_start", "frames"):
        np.testing.assert_array_equal(getattr(clip, f), getattr(jclip, f), err_msg=f)
    assert clip.frame_time == jclip.frame_time and clip.num_frames == 40
    assert sorted(clip.end_offsets) == sorted(jclip.end_offsets)
    pos, rot = bvh.forward_kinematics(clip)
    jpos, jrot = jbvh.forward_kinematics(jclip)
    np.testing.assert_allclose(pos, jpos, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(rot, jrot, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(bvh.to_z_up(pos), jbvh.to_z_up(jpos), rtol=0, atol=0)

    cfg = retarget.RetargetConfig(joint_limit_margin=0.01)
    frames = retarget.retarget_clip(clip, cfg)
    want = jretarget.retarget_clip(jclip, jretarget.RetargetConfig(joint_limit_margin=0.01))
    assert frames.shape == (40, 19) and frames.dtype == np.float32
    np.testing.assert_allclose(frames, want, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(retarget.mirror_frames(frames), jretarget.mirror_frames(want),
                               rtol=0, atol=0)
    np.testing.assert_allclose(retarget.mirror_frames(retarget.mirror_frames(frames)), frames,
                               rtol=0, atol=0)
    clips = retarget.load_raw_clips(str(d), device="cpu")
    jclips = jretarget.load_raw_clips(str(d))
    np.testing.assert_allclose(clips.frames.numpy(), np.asarray(jclips.frames), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_array_equal(clips.lengths.numpy(), [40, 40, 25, 25])
    assert (clips.frame_step, clips.margin) == (jclips.frame_step, jclips.margin)
    one = retarget.load_raw_clips(str(d / "b.bvh"), mirror=False, device="cpu")
    np.testing.assert_array_equal(one.lengths.numpy(), [25])
    bad = tmp_path / "bad.bvh"
    bad.write_text((d / "a.bvh").read_text().replace("Frames: 40", "Frames: 41"))
    with pytest.raises(ValueError):
        bvh.parse_bvh(str(bad))


def test_ik_bvh_and_retarget_match_reference(tmp_path):
    _check_ik()
    _check_bvh_and_retarget(tmp_path)


def _trajectory():
    """Two episodes of 50 Hz states (T, 19): a walk, a crouched crawl window
    at two speeds, then a mount onto a step, with a heading drift."""
    eps = []
    for e, (T, spd) in enumerate(((220, 0.9), (180, 1.2))):
        t = np.arange(T) * 0.02
        x = np.cumsum(np.full(T, spd * 0.02) * (1.0 + 0.3 * np.sin(3 * t + e)))
        z = np.full(T, 0.33)
        z[30:130] = 0.2 + 0.02 * np.sin(5 * t[30:130])
        z[150:165] = np.linspace(0.2, 0.5, 15)
        z[165:] = 0.5
        yaw = 0.4 + 0.1 * e + 0.05 * np.sin(t)
        quat = np.stack([0.01 * np.sin(t), 0.02 * np.cos(t), np.sin(yaw / 2), np.cos(yaw / 2)], -1)
        quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
        joints = 0.3 * np.sin(np.outer(t, np.arange(1, 13)))
        states = np.concatenate([x[:, None], 0.1 * np.sin(t)[:, None], z[:, None], quat, joints],
                                axis=1).astype(np.float32)
        eps.append(dict(states=states, fell=False))
    return eps


def test_distill_prior_mining_matches_reference():
    spec = importlib.util.spec_from_file_location(
        "jax_distill_prior", os.path.join(REPO, "tools", "distill_prior.py"))
    jdp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jdp)
    eps = _trajectory()
    for kw in ({}, dict(z_max=0.25, widths=(40, 60))):
        hit = distill_prior.find_crawl(eps, **kw)
        assert hit is not None and hit == jdp.find_crawl(eps, **kw)
    for kw in ({}, dict(rise_min=0.25, pre=5, post=5)):
        hit = distill_prior.find_mantle(eps, **kw)
        assert hit is not None and hit == jdp.find_mantle(eps, **kw)
    assert distill_prior.find_crawl(eps, z_max=0.1) is None
    s = eps[1]["states"]
    np.testing.assert_array_equal(distill_prior._yaw_of(s[:, 3:7]), jdp._yaw_of(s[:, 3:7]))
    np.testing.assert_array_equal(distill_prior._quat_mul(s[:, 3:7], s[::-1, 3:7]),
                                  jdp._quat_mul(s[:, 3:7], s[::-1, 3:7]))
    ei, t0, W, spd = distill_prior.find_crawl(eps)
    got = distill_prior.reorient_resample(eps[ei]["states"][t0:t0 + W])
    want = jdp.reorient_resample(eps[ei]["states"][t0:t0 + W])
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    assert got.shape[1] == 19 and abs(got[0, 0]) < 1e-6 and abs(got[0, 1]) < 1e-6
    assert abs(distill_prior._yaw_of(got[0, 3:7])) < 1e-6  # heading +x at frame 0
