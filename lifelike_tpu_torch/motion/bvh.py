"""BVH raw-mocap parser and forward kinematics (host-side, numpy).

Port of lifelike_tpu.motion.bvh (its own copy; numpy and scipy, no
tensors): the reference ships its raw Labrador-Retriever captures as
standard BVH but no loader. Parse the hierarchy + motion block, evaluate
world-space joint positions / rotations, and hand off to motion/retarget.py,
which maps the dog skeleton onto the MAX robot's 19-float frame format.
Vectorized over frames (one hierarchy pass of ~60 joints).
"""
from typing import Dict, List, NamedTuple

import numpy as np
from scipy.spatial.transform import Rotation as R


class BVHClip(NamedTuple):
    names: List[str]  # J joint names, topological (parents first)
    parents: np.ndarray  # (J,) int, -1 for root
    offsets: np.ndarray  # (J, 3) rest offsets from parent
    channels: List[List[str]]  # per joint, e.g. ['Xposition', ..., 'Yrotation']
    chan_start: np.ndarray  # (J,) column of this joint's first channel
    end_offsets: Dict[int, np.ndarray]  # joint index -> End Site offset
    frames: np.ndarray  # (N, C) motion data
    frame_time: float

    @property
    def num_frames(self):
        return self.frames.shape[0]

    def index(self, name: str) -> int:
        return self.names.index(name)


def parse_bvh(path) -> BVHClip:
    """Parse a BVH file (HIERARCHY + MOTION blocks)."""
    with open(path) as f:
        tokens = f.read().split()
    pos = 0

    names, parents, offsets, channels = [], [], [], []
    end_offsets = {}
    stack = []  # joint indices of open '{' scopes

    def expect(tok):
        nonlocal pos
        if tokens[pos] != tok:
            raise ValueError(f"expected {tok!r} at token {pos}, got {tokens[pos]!r}")
        pos += 1

    expect("HIERARCHY")
    while tokens[pos] != "MOTION":
        tok = tokens[pos]
        if tok in ("ROOT", "JOINT"):
            names.append(tokens[pos + 1])
            parents.append(stack[-1] if stack else -1)
            offsets.append(np.zeros(3))
            channels.append([])
            pos += 2
            expect("{")
            stack.append(len(names) - 1)
        elif tok == "OFFSET":
            off = np.array([float(tokens[pos + i]) for i in (1, 2, 3)])
            offsets[stack[-1]] = off
            pos += 4
        elif tok == "CHANNELS":
            n = int(tokens[pos + 1])
            channels[stack[-1]] = tokens[pos + 2 : pos + 2 + n]
            pos += 2 + n
        elif tok == "End":
            expect("End")
            expect("Site")
            expect("{")
            expect("OFFSET")
            end_offsets[stack[-1]] = np.array(
                [float(tokens[pos + i]) for i in (0, 1, 2)]
            )
            pos += 3
            expect("}")
        elif tok == "}":
            stack.pop()
            pos += 1
        else:
            raise ValueError(f"unexpected token {tok!r} at {pos}")

    expect("MOTION")
    expect("Frames:")
    num_frames = int(tokens[pos])
    pos += 1
    expect("Frame")
    expect("Time:")
    frame_time = float(tokens[pos])
    pos += 1
    data = np.asarray(tokens[pos:], dtype=np.float64)
    total = sum(len(c) for c in channels)
    if data.size != num_frames * total:
        raise ValueError(f"{data.size} motion values for {num_frames} frames x {total} channels")
    frames = data.reshape(num_frames, total)

    chan_start = np.zeros(len(names), dtype=np.int64)
    acc = 0
    for j, c in enumerate(channels):
        chan_start[j] = acc
        acc += len(c)

    return BVHClip(
        names=names,
        parents=np.asarray(parents, dtype=np.int64),
        offsets=np.asarray(offsets),
        channels=channels,
        chan_start=chan_start,
        end_offsets=end_offsets,
        frames=frames,
        frame_time=frame_time,
    )


def _local_rotation(clip: BVHClip, j: int) -> np.ndarray:
    """Per-frame local rotation matrices (N, 3, 3) for joint j."""
    rot_chans = [c for c in clip.channels[j] if c.endswith("rotation")]
    if not rot_chans:
        return np.broadcast_to(np.eye(3), (clip.num_frames, 3, 3))
    order = "".join(c[0].upper() for c in rot_chans)  # e.g. 'ZXY', intrinsic
    cols = [
        clip.chan_start[j] + clip.channels[j].index(c) for c in rot_chans
    ]
    euler = clip.frames[:, cols]
    return R.from_euler(order, euler, degrees=True).as_matrix()


def _local_translation(clip: BVHClip, j: int) -> np.ndarray:
    """Per-frame local translation (N, 3): rest offset + position channels."""
    t = np.broadcast_to(clip.offsets[j], (clip.num_frames, 3)).copy()
    for ax, name in enumerate(("Xposition", "Yposition", "Zposition")):
        if name in clip.channels[j]:
            col = clip.chan_start[j] + clip.channels[j].index(name)
            t[:, ax] = clip.frames[:, col]  # an animated translation replaces the offset
    return t


def forward_kinematics(clip: BVHClip):
    """World positions (N, J, 3) and rotations (N, J, 3, 3), BVH axes."""
    N, J = clip.num_frames, len(clip.names)
    pos = np.zeros((N, J, 3))
    rot = np.zeros((N, J, 3, 3))
    for j in range(J):
        Rl = _local_rotation(clip, j)
        tl = _local_translation(clip, j)
        p = clip.parents[j]
        if p < 0:
            pos[:, j] = tl
            rot[:, j] = Rl
        else:
            pos[:, j] = pos[:, p] + np.einsum("nij,nj->ni", rot[:, p], tl)
            rot[:, j] = rot[:, p] @ Rl
    return pos, rot


def to_z_up(p):
    """Map BVH Y-up world points (..., 3) to the robot's Z-up convention."""
    return np.stack([p[..., 0], -p[..., 2], p[..., 1]], axis=-1)
