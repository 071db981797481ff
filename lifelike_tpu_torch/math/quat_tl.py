"""Quaternion ops in tile layout: component axis LEADING, batch TRAILING.

Port of lifelike_tpu.math.quat_tl. A quaternion is (4, *B) with components
(x, y, z, w); vectors are (3, *B). On the GPU the trailing batch axes are
the contiguous candidate axis, so every op is a coalesced elementwise pass.
"""
import math

import torch

_EPS = 1e-8


def normalize(q):
    return q / torch.sqrt(torch.sum(q * q, dim=0)).clamp_min(_EPS)


def mul(q1, q2):
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ]
    )


def inv(q):
    x, y, z, w = q
    return torch.stack([-x, -y, -z, w])


def cross(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0])


def rotate(q, v):
    qv = q[:3]
    qw = q[3]
    t = 2.0 * cross(qv, v)
    return v + qw * t + cross(qv, t)


def rotate_inv(q, v):
    return rotate(inv(q), v)


def to_matrix(q):
    """(4, *B) -> (3, 3, *B) rotation matrix."""
    x, y, z, w = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)])
    r1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)])
    r2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)])
    return torch.stack([r0, r1, r2])


def from_rotvec(rv):
    angle = torch.sqrt(torch.sum(rv * rv, dim=0))
    half = 0.5 * angle
    k = 0.5 * torch.sinc(half / math.pi)
    return normalize(torch.cat([rv * k, torch.cos(half)[None]], dim=0))


def integrate(q, omega_world, dt):
    """q' = exp(omega*dt) o q, omega (3, *B) world frame."""
    return normalize(mul(from_rotvec(omega_world * dt), q))


def rel_angle(q_a, q_b):
    """|rotation angle| of q_a o q_b^{-1} — the root-pose error metric."""
    d = mul(q_a, inv(q_b))
    s = torch.sqrt(torch.sum(d[:3] * d[:3], dim=0))
    return 2.0 * torch.atan2(s, d[3].abs())
