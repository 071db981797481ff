"""Mocap motion library: clips as device tensors + batched interpolation.

Port of lifelike_tpu.motion.motion_lib. Clip
format as the reference MotionLib: JSON files with `FrameDuration` (1/120 s)
and `Frames` of 19 floats [x, y, z, qx, qy, qz, qw, 12 joint angles], leg
order FR, FL, HR, HL, read by the C++ parser (_native) with the json module
for files it rejects. All clips are packed into one padded (num_clips,
max_len, 19) float32 tensor; interpolation lerps positions/joints, slerps
orientation and finite-differences velocities over one frame step
(reference motion_lib.py:117-166). Jump-event obstacles (`ObstacleEvents`)
are found on the host at load time; prioritized clip re-sampling
p ~ (1 - avg_reward)^factor (`PrioritizedClipSampler`) stays on the host, as
do the gait variants that feed the traversal controllers' prior bank
(`crouch_variant`, `crawl_variant`, `highstep_variant`: numpy in, numpy
out).

Every index is clamped explicitly: a JAX gather clamps an out-of-range index
where PyTorch would raise.
"""
import json
import os
from typing import NamedTuple

import numpy as np
import torch

from lifelike_tpu_torch import _device, _native
from lifelike_tpu_torch.math import quat
from lifelike_tpu_torch.utils.obstacle import obstacles_in_frames

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
    files (clip index = position in the list). `load_clips.parsed_by` then
    lists, per file, the path that read it: "native" or "json"."""
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
    frames, frame_step, parsed_by = [], None, []
    for f in files:
        parsed = _native.parse_clip_file(f)
        parsed_by.append("json" if parsed is None else "native")
        if parsed is None:
            with open(f) as fh:
                d = json.load(fh)
            parsed = (np.asarray(d["Frames"], np.float32), d["FrameDuration"])
        frames.append(parsed[0])
        frame_step = frame_step or float(parsed[1])
    load_clips.parsed_by = parsed_by
    return pack_clips(frames, frame_step=frame_step, policy_step=policy_step,
                      device=device)


load_clips.parsed_by = []


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


class ObstacleEvents(NamedTuple):
    """Jump-event obstacles per clip, padded to K events (tensors on one
    device), from utils.obstacle.obstacles_in_frames at load time: xy / yaw
    the ground-projected obstacle pose, time the clip time of the jump
    peak."""

    xy: torch.Tensor  # (C, K, 2) float32
    yaw: torch.Tensor  # (C, K) float32
    time: torch.Tensor  # (C, K) float32, padded with +inf
    count: torch.Tensor  # (C,) int32


def extract_obstacles(frame_arrays, frame_step, k_max=4, device="cuda") -> ObstacleEvents:
    dev = _device.resolve_device(device)
    C = len(frame_arrays)
    xy = np.zeros((C, k_max, 2), np.float32)
    yaw = np.zeros((C, k_max), np.float32)
    time = np.full((C, k_max), np.inf, np.float32)
    count = np.zeros((C,), np.int32)
    rate = int(round(1.0 / frame_step))
    for i, f in enumerate(frame_arrays):
        ev = obstacles_in_frames(np.asarray(f), rate)
        if ev is None:
            continue
        k = min(len(ev["time"]), k_max)
        xy[i, :k] = ev["pos"][:k, :2]
        yaw[i, :k] = ev["yaw"][:k]
        time[i, :k] = ev["time"][:k]
        count[i] = k
    return ObstacleEvents(*(torch.as_tensor(a, device=dev) for a in (xy, yaw, time, count)))


def current_obstacle(ev: ObstacleEvents, clip_idx, t):
    """Active obstacle pose at clip time t: the event index advances once t
    passes event_time + 0.5 s (reference primitive_level_env.py:262-268).
    Returns (xy (..., 2), yaw (...,), active (...,) bool)."""
    dev = ev.time.device
    ci = torch.as_tensor(clip_idx, device=dev).long()
    t = torch.as_tensor(t, device=dev)
    times = ev.time[ci]  # (..., K)
    count = ev.count.long()[ci]
    idx = torch.sum(t[..., None] > times + 0.5, dim=-1)
    idx = torch.minimum(idx, torch.clamp_min(count - 1, 0))
    xy = torch.take_along_dim(ev.xy[ci], idx[..., None, None], dim=-2)[..., 0, :]
    yaw = torch.take_along_dim(ev.yaw[ci], idx[..., None], dim=-1)[..., 0]
    return xy, yaw, count > 0


def obstacle_collision(xy, yaw, height, points):
    """True when any world point (..., P, 3) is inside the obstacle box
    (half extents [0.025, 0.5, height] at yaw; reference :182-188)."""
    d = points[..., :2] - xy[..., None, :]
    cs, sn = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    local_x = cs * d[..., 0] + sn * d[..., 1]
    local_y = -sn * d[..., 0] + cs * d[..., 1]
    inside = (local_x.abs() < 0.025) & (local_y.abs() < 0.5) & (points[..., 2] < 2.0 * height)
    return torch.any(inside, dim=-1)


class PrioritizedClipSampler:
    """Host-side prioritized clip re-sampling: p ~ (1 - avg_reward)^factor
    (reference primitive_level_env.py:236-240). Feed per-episode average
    rewards; pass `.probabilities` (float64 on `device`) to
    envs.primitive.reset."""

    def __init__(self, num_clips, factor=3.0, device="cuda"):
        self.device = _device.resolve_device(device)
        self.factor = factor
        self.avg_reward = np.zeros(num_clips)
        self._p = np.ones(num_clips) / num_clips

    def update(self, clip_idx, episode_avg_reward):
        idx = np.asarray(clip_idx).reshape(-1)
        r = np.asarray(episode_avg_reward).reshape(-1)
        self.avg_reward[idx] = r
        w = (1.0 - self.avg_reward) ** self.factor
        self._p = w / w.sum()

    def update_sums(self, reward_sum, episode_count):
        """Batch update from per-clip accumulators: for every clip with at
        least one ended episode, avg_reward becomes the mean episode-average
        reward (last write wins, as the reference's per-episode assignment
        at primitive_level_env.py:236)."""
        cnt = np.asarray(episode_count)
        rs = np.asarray(reward_sum)
        seen = cnt > 0
        if not seen.any():
            return
        self.avg_reward[seen] = rs[seen] / cnt[seen]
        w = (1.0 - np.clip(self.avg_reward, 0.0, 1.0)) ** self.factor
        self._p = w / w.sum()

    @property
    def probabilities(self):
        return torch.as_tensor(self._p, device=self.device)


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


def crouch_variant(frames, hip_delta=0.45, knee_delta=0.9, knee_max=2.50,
                   drop=None, joint_lower=None, joint_upper=None):
    """Synthesize a crouch-walk clip from walk frames (N, 19): fold the hips
    and knees, clamp to joint limits, and lower the base accordingly.

    The reference clip library has walk/run/jump/sit families but no crawl;
    the hole courses (0.25-0.3 m gaps under elevated blocks) need one, so
    the skill bank synthesizes it — the gait prior is a sampling PRIOR, not
    a dynamics ground truth, and the MPC's noise + physics rollouts adapt
    it. hip_y is joint index 1 of each leg triple, knee index 2 (leg-major
    FR, FL, HR, HL); drop defaults to the height loss implied by the leg
    geometry (thigh 0.2115 + shank 0.24 chain), ~0.16 m.
    """
    out = np.array(frames, np.float32, copy=True)
    q = out[:, 7:].reshape(-1, 4, 3)
    q[:, :, 1] -= hip_delta
    q[:, :, 2] = np.minimum(q[:, :, 2] + knee_delta, knee_max)
    if joint_lower is not None and joint_upper is not None:
        # retargeted mocap can slightly exceed URDF limits; a synthesized
        # prior should not add to that
        q[:] = np.clip(q, np.reshape(joint_lower, (4, 3)),
                       np.reshape(joint_upper, (4, 3)))
    if drop is None:
        drop = 0.16
    out[:, 2] = np.maximum(out[:, 2] - drop, 0.12)
    return out


def crawl_variant(frames, pose=(0.0, -0.2, 2.25), gain=0.3,
                  base_height=0.13, joint_lower=None, joint_upper=None,
                  knee_cap=2.45):
    """Synthesize a LOW crawl clip: a flat crawl pose plus the walk clip's
    joint oscillation scaled by `gain` (keeps the stepping rhythm at low
    amplitude).

    crouch_variant bottoms out at a ~0.25 m total height because the walk's
    knee / wheel points swing above the base; the default pose (q1, q2, q3)
    = (0, -0.2, 2.25) at gain 0.3 gives base ~0.15 m and a top of ~0.22 m
    over the gait cycle, inside the 0.25-0.3 m hole gaps of the reference
    courses. knee_cap keeps the oscillation off the 2.544 rad URDF knee
    limit.
    """
    out = np.array(frames, np.float32, copy=True)
    q = out[:, 7:].reshape(-1, 4, 3)
    mean = q.mean(axis=0, keepdims=True)
    posa = np.reshape(np.asarray(pose, np.float32), (1, 1, 3))
    q[:] = posa + gain * (q - mean)
    q[:, :, 2] = np.minimum(q[:, :, 2], knee_cap)
    if joint_lower is not None and joint_upper is not None:
        q[:] = np.clip(q, np.reshape(joint_lower, (4, 3)),
                       np.reshape(joint_upper, (4, 3)))
    out[:, 2] = base_height
    return out


def highstep_variant(frames, gain=1.6, lift=0.10, joint_lower=None,
                     joint_upper=None):
    """Synthesize a high-stepping climb gait from walk frames (N, 19):
    amplify each leg's hip / knee oscillation about its temporal mean by
    `gain` (taller swing arcs: foot clearance for 0.1-0.25 m cube steps)
    and raise the base by `lift` so the stance legs extend, giving the
    climb headroom. Like crouch_variant this is a sampling PRIOR.
    """
    out = np.array(frames, np.float32, copy=True)
    q = out[:, 7:].reshape(-1, 4, 3)
    mean = q.mean(axis=0, keepdims=True)
    q[:, :, 1:] = mean[:, :, 1:] + gain * (q[:, :, 1:] - mean[:, :, 1:])
    if joint_lower is not None and joint_upper is not None:
        q[:] = np.clip(q, np.reshape(joint_lower, (4, 3)),
                       np.reshape(joint_upper, (4, 3)))
    out[:, 2] += lift
    return out
