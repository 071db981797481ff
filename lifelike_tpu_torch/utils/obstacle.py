"""Obstacle events extracted from mocap jumps.

Port of lifelike_tpu.utils.obstacle (reference utils/obstacle.py): find
base-height peaks above 0.5 m at least 120 frames apart in a clip; each peak
spawns an obstacle at the jump position (yaw-only orientation) synced to the
clip time. Peak finding runs on the host at clip-load time (numpy), making
the tables the env reads on the device.
"""
import numpy as np


def obstacles_in_frames(frames, frame_rate):
    """frames: (T, 19) clip array. Returns dict {pos (K, 3), yaw (K,),
    time (K,)} or None when the clip has no jumps."""
    frames = np.asarray(frames)
    if frames.ndim != 2 or frames.shape[1] != 19:
        raise ValueError(f"expected (T, 19) frames, got {frames.shape}")
    from scipy.signal import find_peaks  # slow to import: loaded with the first clip

    peak_ids, _ = find_peaks(frames[:, 2], height=0.5, distance=120)
    if len(peak_ids) == 0:
        return None
    pos = frames[peak_ids, 0:3]
    q = frames[peak_ids, 3:7]
    # yaw-only projection (reference get_obstacle_pose :27-33)
    yaw = np.arctan2(
        2.0 * (q[:, 3] * q[:, 2] + q[:, 0] * q[:, 1]),
        1.0 - 2.0 * (q[:, 1] ** 2 + q[:, 2] ** 2),
    )
    return {"pos": pos, "yaw": yaw, "time": peak_ids / frame_rate}


def obstacle_pose(pos, yaw):
    """Ground-projected obstacle pose: position at z = 0, yaw-only quaternion."""
    p = np.array([pos[0], pos[1], 0.0])
    q = np.array([0.0, 0.0, np.sin(yaw / 2.0), np.cos(yaw / 2.0)])
    return p, q
