"""Raw BVH dog-mocap -> MAX robot retargeting.

Port of lifelike_tpu.motion.retarget: produces the 19-float frame format of
the reference's retargeted clips (root pos 3, root quat xyzw 4, 12 joint
angles) directly from raw Labrador captures, including the `_mir` mirrored
variants.

Method
- BVH forward kinematics (motion/bvh.py), converted to Z-up.
- Root frame from leg-root midpoints: x = front->hind axis, y = right->left,
  z = x cross y — carries pitch / roll through jumps.
- Anisotropic morphological scale: horizontal by body-length ratio (MAX hip
  spacing 0.39 m / the dog's), vertical by stance-height ratio (MAX stand
  0.31 m / the dog's).
- Foot targets per leg in the base frame -> analytic 3-DoF IK (robot/ik.py,
  float64 tensors on the CPU), clamped to the URDF joint limits.

Host-side data ingest; the output packs straight into motion_lib.pack_clips.
"""
import os
from typing import NamedTuple

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R

from lifelike_tpu_torch.motion import bvh as bvh_mod
from lifelike_tpu_torch.motion import motion_lib
from lifelike_tpu_torch.robot import ik
from lifelike_tpu_torch.robot.model import build_max_model

# (leg root, ground-contact end effector); fallbacks cover naming quirks
# across the reference captures (e.g. 'b__LeftFinger' double underscore).
LEG_JOINTS = {
    "FR": (("b_RightArm",), ("b_RightFinger", "b_RightHand")),
    "FL": (("b_LeftArm",), ("b__LeftFinger", "b_LeftFinger", "b_LeftHand")),
    "HR": (("b_RightLegUpper",), ("b_RightToe", "b_RightAnkle")),
    "HL": (("b_LeftLegUpper",), ("b_LeftToe", "b_LeftAnkle")),
}
LEG_ORDER = ("FR", "FL", "HR", "HL")

MAX_BODY_LEN = 2 * 0.195  # front-to-hind hip spacing (max_urdf_data JOINTS)
MAX_STAND_HEIGHT = 0.31  # reference retarget stance height (walkrun root z)
FOOT_RADIUS = 0.025


class RetargetConfig(NamedTuple):
    stand_height: float = MAX_STAND_HEIGHT
    body_len: float = MAX_BODY_LEN
    ground_percentile: float = 5.0  # foot-height percentile taken as ground
    joint_limit_margin: float = 0.0  # rad, shrink limits when clamping


def _find(clip, candidates):
    for n in candidates:
        if n in clip.names:
            return clip.names.index(n)
    raise KeyError(f"none of {candidates} in BVH skeleton")


def _orthonormal_root(front_mid, hind_mid, left_mid, right_mid):
    """Per-frame root rotation matrices (N, 3, 3), columns = base axes."""
    x = front_mid - hind_mid
    x = x / np.linalg.norm(x, axis=-1, keepdims=True)
    y_raw = left_mid - right_mid
    z = np.cross(x, y_raw)
    z = z / np.linalg.norm(z, axis=-1, keepdims=True)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=-1)


def retarget_clip(clip: bvh_mod.BVHClip, config: RetargetConfig = RetargetConfig()):
    """BVH clip -> (N, 19) float32 retargeted frames [pos 3, quat xyzw 4,
    joints 12]."""
    pos, _ = bvh_mod.forward_kinematics(clip)
    p = bvh_mod.to_z_up(pos)

    roots = {}
    feet = {}
    for leg, (root_names, foot_names) in LEG_JOINTS.items():
        roots[leg] = p[:, _find(clip, root_names)]
        feet[leg] = p[:, _find(clip, foot_names)]

    # ground = low percentile of all contact-point heights
    all_feet_z = np.stack([feet[leg][:, 2] for leg in LEG_ORDER])
    ground = np.percentile(all_feet_z, config.ground_percentile)

    front_mid = 0.5 * (roots["FR"] + roots["FL"])
    hind_mid = 0.5 * (roots["HR"] + roots["HL"])
    left_mid = 0.5 * (roots["FL"] + roots["HL"])
    right_mid = 0.5 * (roots["FR"] + roots["HR"])
    centroid = 0.5 * (front_mid + hind_mid)

    dog_body_len = float(np.linalg.norm(front_mid - hind_mid, axis=-1).mean())
    dog_stance = float(np.median(centroid[:, 2] - ground))
    s_xy = config.body_len / dog_body_len
    s_z = config.stand_height / dog_stance

    def scale(q):
        out = q.copy()
        out[..., :2] *= s_xy
        out[..., 2] = (q[..., 2] - ground) * s_z
        return out

    R_root = _orthonormal_root(front_mid, hind_mid, left_mid, right_mid)
    root_pos = scale(centroid)
    quat = R.from_matrix(R_root).as_quat()  # scipy = xyzw, the clip convention

    # foot targets in the base frame, relative to each leg's joint1 origin
    p_rel = np.zeros((clip.num_frames, 4, 3))
    for li, leg in enumerate(LEG_ORDER):
        d = scale(feet[leg]) - root_pos  # world offset, scaled
        d_base = np.einsum("nij,ni->nj", R_root, d)  # R^T d
        d_base[:, 2] += FOOT_RADIUS  # contact point -> sphere center
        p_rel[:, li] = d_base - ik.HIP_OFFSET[li]

    q = ik.all_legs_ik(torch.as_tensor(p_rel)).numpy()  # (N, 4, 3)

    model = build_max_model()
    lo = np.asarray(model.joint_lower) + config.joint_limit_margin
    hi = np.asarray(model.joint_upper) - config.joint_limit_margin
    q = np.clip(q, lo.reshape(4, 3), hi.reshape(4, 3))

    return np.concatenate(
        [root_pos, quat, q.reshape(clip.num_frames, 12)], axis=-1
    ).astype(np.float32)


def mirror_frames(frames):
    """Left-right mirror of retargeted frames (the reference's *_mir clips).

    Reflection about the xz-plane: y negated; quaternion (x, y, z, w) ->
    (-x, y, -z, w); legs swap FR<->FL, HR<->HL with the abduction (joint1)
    sign flipped (pitch joints rotate about y and are mirror-invariant).
    """
    f = np.asarray(frames)
    out = f.copy()
    out[..., 1] = -f[..., 1]  # root y
    out[..., 3] = -f[..., 3]  # qx
    out[..., 5] = -f[..., 5]  # qz
    j = f[..., 7:].reshape(f.shape[:-1] + (4, 3))
    jm = j[..., [1, 0, 3, 2], :].copy()  # swap left / right legs
    jm[..., 0] = -jm[..., 0]  # abduction sign
    out[..., 7:] = jm.reshape(f.shape[:-1] + (12,))
    return out


def load_raw_clips(data_path, policy_step=1.0 / 50.0, mirror=True,
                   config: RetargetConfig = RetargetConfig(), limit=None, device="cuda"):
    """Parse + retarget every *.bvh under data_path (or the one file) into a
    motion_lib.MotionClips pack on `device`; with mirror=True each clip is
    followed by its mirror."""
    if os.path.isdir(data_path):
        files = sorted(os.path.join(data_path, f) for f in os.listdir(data_path)
                       if f.endswith(".bvh"))
    else:
        files = [data_path]
    if limit:
        files = files[:limit]
    frames, frame_step = [], None
    for f in files:
        clip = bvh_mod.parse_bvh(f)
        ret = retarget_clip(clip, config)
        frames.append(ret)
        if mirror:
            frames.append(mirror_frames(ret))
        frame_step = frame_step or clip.frame_time
    return motion_lib.pack_clips(frames, frame_step=frame_step, policy_step=policy_step,
                                 device=device)
