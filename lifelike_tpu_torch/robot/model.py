"""MAX quadruped model: static kinematic-tree arrays (port of lifelike_tpu.robot.model).

The reference loads max.urdf into PyBullet (reference legged_robot.py:207-264);
here the same URDF data (extracted to max_urdf_data.py by tools/extract_urdf.py)
is compiled into dense numpy arrays shaped for leg-vectorized computation:
13 moving bodies = base + 4 legs x 3 links, with fixed child links (feet,
wheels, handles) fused into their moving parents as composite inertia and
recorded as attachment frames (contact spheres / end-effectors).

Leg order is FR, FL, HR, HL and joints are ordered leg-major
(joint_{leg}{1,2,3}) — identical to the reference actuated joint ordering
(reference utils/constants.py:175-177) and the mocap LegOrder.
"""
from dataclasses import dataclass, field

import numpy as np

from lifelike_tpu_torch.robot import max_urdf_data as D

LEG_NAMES = ("FR", "FL", "HR", "HL")
NUM_LEGS = 4
LINKS_PER_LEG = 3
NUM_JOINTS = NUM_LEGS * LINKS_PER_LEG  # 12 actuated DoF
NUM_BODIES = 1 + NUM_JOINTS  # base + 12 links


def _rpy_to_matrix(rpy):
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def _fuse(mass_a, com_a, I_a, mass_b, com_b, I_b):
    """Combine two rigid bodies expressed in one common frame."""
    m = mass_a + mass_b
    if m == 0.0:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    com = (mass_a * com_a + mass_b * com_b) / m

    def shift(mass, c, I):
        d = c - com
        return I + mass * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

    return m, com, shift(mass_a, com_a, I_a) + shift(mass_b, com_b, I_b)


@dataclass(frozen=True)
class MaxModel:
    """Static model arrays. All frames: joint origins have zero rpy in max.urdf
    (asserted at build), so link frames differ from parents only by the joint
    rotation; offsets are pure translations."""

    # Per-leg, per-link arrays, shape (4, 3, ...)
    joint_offset: np.ndarray  # (4, 3, 3) joint origin in parent frame
    joint_axis: np.ndarray  # (4, 3, 3) revolute axis in child frame
    link_mass: np.ndarray  # (4, 3)
    link_com: np.ndarray  # (4, 3, 3) COM in link frame (fixed children fused)
    link_inertia: np.ndarray  # (4, 3, 3, 3) rotational inertia about COM
    joint_lower: np.ndarray  # (4, 3)
    joint_upper: np.ndarray  # (4, 3)
    joint_effort: np.ndarray  # (4, 3)
    joint_velocity: np.ndarray  # (4, 3)
    joint_damping: np.ndarray  # (4, 3)
    joint_friction: np.ndarray  # (4, 3)
    # Base (handles fused)
    base_mass: float
    base_com: np.ndarray  # (3,)
    base_inertia: np.ndarray  # (3, 3)
    # Attachment points
    foot_offset: np.ndarray  # (4, 3) foot sphere center in link3 frame
    foot_radius: float
    wheel_offset: np.ndarray  # (4, 3) wheel center in link2 frame
    wheel_radius: float
    handle_offset: np.ndarray  # (2, 3) front/hind handle in base frame
    # Convenience
    total_mass: float = field(default=0.0)

    @property
    def joint_lower_flat(self):
        return self.joint_lower.reshape(-1)

    @property
    def joint_upper_flat(self):
        return self.joint_upper.reshape(-1)


def build_max_model() -> MaxModel:
    links = D.LINKS
    joints = {j["name"]: j for j in D.JOINTS}

    joint_offset = np.zeros((NUM_LEGS, LINKS_PER_LEG, 3))
    joint_axis = np.zeros((NUM_LEGS, LINKS_PER_LEG, 3))
    link_mass = np.zeros((NUM_LEGS, LINKS_PER_LEG))
    link_com = np.zeros((NUM_LEGS, LINKS_PER_LEG, 3))
    link_inertia = np.zeros((NUM_LEGS, LINKS_PER_LEG, 3, 3))
    lower = np.zeros((NUM_LEGS, LINKS_PER_LEG))
    upper = np.zeros((NUM_LEGS, LINKS_PER_LEG))
    effort = np.zeros((NUM_LEGS, LINKS_PER_LEG))
    velocity = np.zeros((NUM_LEGS, LINKS_PER_LEG))
    damping = np.zeros((NUM_LEGS, LINKS_PER_LEG))
    friction = np.zeros((NUM_LEGS, LINKS_PER_LEG))
    foot_offset = np.zeros((NUM_LEGS, 3))
    wheel_offset = np.zeros((NUM_LEGS, 3))

    foot_radius = None
    for li, leg in enumerate(LEG_NAMES):
        for ji in range(LINKS_PER_LEG):
            j = joints[f"joint_{leg}{ji + 1}"]
            assert j["type"] == "revolute"
            assert np.allclose(j["rpy"], 0.0), "joint frames assumed untilted"
            joint_offset[li, ji] = j["xyz"]
            joint_axis[li, ji] = j["axis"]
            lower[li, ji] = j["limit"]["lower"]
            upper[li, ji] = j["limit"]["upper"]
            effort[li, ji] = j["limit"]["effort"]
            velocity[li, ji] = j["limit"]["velocity"]
            damping[li, ji] = j["damping"]
            friction[li, ji] = j["friction"]
            L = links[f"link_{leg}{ji + 1}"]
            m, com, I = L["mass"], np.asarray(L["com"]), np.asarray(L["inertia"])
            # Fuse fixed children: foot (on link3), wheel (on link2).
            if ji == 2:
                jf = joints[f"joint_{leg}4"]
                foot_offset[li] = jf["xyz"]
                Lf = links[f"link_{leg}4"]
                m, com, I = _fuse(
                    m, com, I,
                    Lf["mass"], np.asarray(jf["xyz"]) + np.asarray(Lf["com"]),
                    np.asarray(Lf["inertia"]),
                )
                for kind, _, _, params in Lf["collisions"]:
                    if kind == "sphere":
                        foot_radius = float(params[0])
            if ji == 1:
                jw = joints[f"joint_{leg}W"]
                wheel_offset[li] = jw["xyz"]
                Lw = links[f"link_{leg}W"]
                m, com, I = _fuse(
                    m, com, I,
                    Lw["mass"], np.asarray(jw["xyz"]) + np.asarray(Lw["com"]),
                    np.asarray(Lw["inertia"]),
                )
            link_mass[li, ji] = m
            link_com[li, ji] = com
            link_inertia[li, ji] = I

    # Base with handles fused.
    B = links["body"]
    bm, bc, bI = B["mass"], np.asarray(B["com"]), np.asarray(B["inertia"])
    handle_offset = np.zeros((2, 3))
    for hi, hname in enumerate(("front", "hind")):
        jh = joints[f"joint_{hname}_handle"]
        handle_offset[hi] = jh["xyz"]
        Lh = links[f"link_{hname}_handle"]
        bm, bc, bI = _fuse(
            bm, bc, bI,
            Lh["mass"], np.asarray(jh["xyz"]) + np.asarray(Lh["com"]),
            np.asarray(Lh["inertia"]),
        )

    wheel_radius = 0.0
    for kind, _, _, params in links["link_FRW"]["collisions"]:
        if kind in ("sphere", "cylinder"):
            wheel_radius = float(params[0])

    total = bm + float(link_mass.sum())
    return MaxModel(
        joint_offset=joint_offset,
        joint_axis=joint_axis,
        link_mass=link_mass,
        link_com=link_com,
        link_inertia=link_inertia,
        joint_lower=lower,
        joint_upper=upper,
        joint_effort=effort,
        joint_velocity=velocity,
        joint_damping=damping,
        joint_friction=friction,
        base_mass=float(bm),
        base_com=bc,
        base_inertia=bI,
        foot_offset=foot_offset,
        foot_radius=float(foot_radius),
        wheel_offset=wheel_offset,
        wheel_radius=wheel_radius,
        handle_offset=handle_offset,
        total_mass=total,
    )
