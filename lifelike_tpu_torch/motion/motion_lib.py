"""Mocap motion library: clips as device tensors + batched interpolation.

Port of lifelike_tpu.motion.motion_lib (the parts the PMC tracking MPC
uses). Clip format as the reference MotionLib: JSON files with
`FrameDuration` (1/120 s) and `Frames` of 19 floats [x, y, z, qx, qy, qz, qw,
12 joint angles], leg order FR, FL, HR, HL. All clips are packed into one
padded (num_clips, max_len, 19) float32 tensor; interpolation lerps
positions/joints, slerps orientation and finite-differences velocities over
one frame step (reference motion_lib.py:117-166).

Every index is clamped explicitly: a JAX gather clamps an out-of-range index
where PyTorch would raise.
"""
import json
import os
from typing import NamedTuple

import numpy as np
import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.math import quat

# Future-goal horizon offsets in seconds (reference motion_lib.py:44).
TIME_FUTURE = (1.0 / 30.0, 1.0 / 15.0, 1.0 / 3.0, 1.0)


class MotionClips(NamedTuple):
    """Packed clip data (tensors on one device)."""

    frames: torch.Tensor  # (C, T_max, 19) float32, padded with the last frame
    lengths: torch.Tensor  # (C,) int32 frame counts
    frame_step: float  # seconds per frame (1/120)
    margin: int  # end-of-clip margin in frames (motion_lib.py:35)

    @property
    def num_clips(self):
        return self.frames.shape[0]


class FrameState(NamedTuple):
    """Interpolated reference state, same schema as RobotState."""

    base_pos: torch.Tensor  # (..., 3)
    base_orn: torch.Tensor  # (..., 4)
    base_lin_vel: torch.Tensor  # (..., 3)
    base_ang_vel: torch.Tensor  # (..., 3)
    joint_pos: torch.Tensor  # (..., 12)
    joint_vel: torch.Tensor  # (..., 12)


def load_clips(data_path, policy_step=1.0 / 50.0, limit=None, device="cuda") -> MotionClips:
    """Load JSON clip files — a directory of *.txt, one file, or a list of
    files (clip index = position in the list)."""
    if isinstance(data_path, (list, tuple)):
        files = list(data_path)
    elif os.path.isdir(data_path):
        files = sorted(
            os.path.join(data_path, f)
            for f in os.listdir(data_path)
            if f.endswith("txt")
        )
    else:
        files = [data_path]
    if limit:
        files = files[:limit]
    frames, frame_step = [], None
    for f in files:
        with open(f) as fh:
            d = json.load(fh)
        frames.append(np.asarray(d["Frames"], np.float32))
        frame_step = frame_step or float(d["FrameDuration"])
    return pack_clips(frames, frame_step=frame_step, policy_step=policy_step,
                      device=device)


def pack_clips(frame_arrays, frame_step, policy_step=1.0 / 50.0, device="cuda") -> MotionClips:
    dev = _device.resolve_device(device)
    lengths = np.array([len(f) for f in frame_arrays], dtype=np.int32)
    T = int(lengths.max())
    packed = np.zeros((len(frame_arrays), T, 19), dtype=np.float32)
    for i, f in enumerate(frame_arrays):
        if f.shape[1] != 19:
            raise ValueError(f"clip {i}: expected (N, 19) frames, got {f.shape}")
        packed[i, : len(f)] = f
        packed[i, len(f):] = f[-1]  # pad with last frame (never sampled)
    frame_rate = int(round(1.0 / frame_step))
    margin = int(np.ceil(policy_step / frame_step)) + frame_rate + 2
    return MotionClips(
        frames=torch.as_tensor(packed, device=dev),
        lengths=torch.as_tensor(lengths, device=dev),
        frame_step=frame_step,
        margin=margin,
    )


def _clip_index(clips: MotionClips, clip_idx):
    ci = torch.as_tensor(clip_idx, device=clips.frames.device).long()
    return ci.clamp(0, clips.num_clips - 1)


def _interp(clips: MotionClips, clip_idx, t):
    """Interpolate clip `clip_idx` at time `t` (both broadcastable)."""
    fs = clips.frame_step
    t = torch.as_tensor(t, device=clips.frames.device)
    if not t.is_floating_point():
        t = t.to(torch.get_default_dtype())
    ci = _clip_index(clips, clip_idx)
    frame_id = torch.floor(t / fs).to(torch.int64)
    # JAX computes int * python-float as a weak float64 and casts it to t's
    # dtype before the subtraction; do the same.
    frac = (t - (frame_id.to(torch.float64) * fs).to(t.dtype)) / fs
    max_id = clips.lengths.long()[ci] - 2
    frame_id = torch.minimum(torch.clamp_min(frame_id, 0), max_id)
    T = clips.frames.shape[1]
    flat = clips.frames.reshape(-1, clips.frames.shape[-1])

    def rows(fid):  # frames[ci, fid] as one index_select, which vmap batches
        lin = ci * T + fid.clamp(0, T - 1)
        return flat.index_select(0, lin.reshape(-1)).reshape(lin.shape + flat.shape[-1:])

    return rows(frame_id), rows(frame_id + 1), frac[..., None]


def sample_frame(clips: MotionClips, clip_idx, t) -> FrameState:
    """Reference-state lookup, matching motion_lib.py interpolation exactly."""
    fc, fn, frac = _interp(clips, clip_idx, t)
    fs = clips.frame_step
    base_pos = fc[..., 0:3] + frac * (fn[..., 0:3] - fc[..., 0:3])
    base_orn = quat.slerp(fc[..., 3:7], fn[..., 3:7], frac[..., 0])
    base_lin_vel = (fn[..., 0:3] - fc[..., 0:3]) / fs
    base_ang_vel = quat.diff_rotvec(fn[..., 3:7], fc[..., 3:7]) / fs
    joint_pos = fc[..., 7:] + frac * (fn[..., 7:] - fc[..., 7:])
    joint_vel = (fn[..., 7:] - fc[..., 7:]) / fs
    return FrameState(
        base_pos=base_pos,
        base_orn=base_orn,
        base_lin_vel=base_lin_vel,
        base_ang_vel=base_ang_vel,
        joint_pos=joint_pos,
        joint_vel=joint_vel,
    )


def sample_future(clips: MotionClips, clip_idx, t):
    """Future reference states at t + TIME_FUTURE, stacked on a new axis -2
    (reference motion_lib.py:75-86)."""
    t = torch.as_tensor(t, device=clips.frames.device)
    offsets = torch.tensor(TIME_FUTURE, dtype=torch.float64, device=t.device)
    ts = t[..., None] + offsets
    ci = torch.as_tensor(clip_idx, device=t.device)[..., None]
    return sample_frame(clips, ci, ts)


def future_goal_features(base_pos, base_orn, future: FrameState):
    """Relative future-goal features in the robot base frame: per future
    frame [delta_pos_base (3), rotvec of the relative rotation (3),
    joint_pos (12)] -> (..., 72). Reference primitive_level_env.py:299-317."""
    q_inv = quat.inv(base_orn)[..., None, :]
    dpos = quat.rotate(q_inv, future.base_pos - base_pos[..., None, :])
    rel = quat.mul(q_inv, future.base_orn)
    rv = quat.to_rotvec(rel)
    feats = torch.cat([dpos, rv, future.joint_pos], dim=-1)
    return feats.reshape(tuple(feats.shape[:-2]) + (-1,))


def is_ended(clips: MotionClips, clip_idx, t):
    """End-of-clip check (reference motion_lib.py:168-172)."""
    t = torch.as_tensor(t, device=clips.frames.device)
    frame_id = torch.floor(t / clips.frame_step).to(torch.int64)
    return frame_id >= clips.lengths.long()[_clip_index(clips, clip_idx)] - clips.margin - 1


def make_synthetic_clip(num_frames=240, frame_step=1.0 / 120.0, seed=0):
    """A smooth synthetic walking-ish clip (numpy; no reference data needed)."""
    rng = np.random.default_rng(seed)
    t = np.arange(num_frames) * frame_step
    frames = np.zeros((num_frames, 19), dtype=np.float32)
    frames[:, 0] = 0.5 * t  # forward drift
    frames[:, 2] = 0.33 + 0.01 * np.sin(2 * np.pi * 1.5 * t)
    yaw = 0.05 * np.sin(2 * np.pi * 0.2 * t)
    frames[:, 5] = np.sin(yaw / 2)
    frames[:, 6] = np.cos(yaw / 2)
    base = np.array([-0.03, -0.75, 1.6] * 4, dtype=np.float32)
    phase = rng.uniform(0, 2 * np.pi, size=12).astype(np.float32)
    amp = np.array([0.05, 0.25, 0.3] * 4, dtype=np.float32)
    frames[:, 7:] = base + amp * np.sin(
        2 * np.pi * 1.5 * t[:, None] + phase[None, :]
    )
    return frames
