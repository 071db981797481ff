"""Quaternion and SO(3) utilities (xyzw order, scipy convention).

Port of lifelike_tpu.math.quat. Quaternions are tensors whose last axis is
4 (x, y, z, w), vectors last axis 3; every function broadcasts over leading
batch axes.
"""
import math

import torch

_EPS = 1e-8


def normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(_EPS)


def mul(q1, q2):
    """Hamilton product: rotation q1∘q2 (apply q2 first, then q1)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def inv(q):
    """Inverse of a unit quaternion (conjugate)."""
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype, device=q.device)


def cross(a, b):
    """Cross product over the last axis, broadcasting and promoting dtypes
    like jnp.cross."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q: R(q) @ v."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * cross(qv, v)
    return v + qw * t + cross(qv, t)


def rotate_inv(q, v):
    """Rotate v by the inverse of q: R(q)^T @ v."""
    return rotate(inv(q), v)


def to_matrix(q):
    """Quaternion -> 3x3 rotation matrix (scipy as_matrix convention)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def from_rotvec(rv):
    """Axis-angle rotation vector -> quaternion. Small-angle safe."""
    angle = torch.linalg.vector_norm(rv, dim=-1, keepdim=True)
    half = 0.5 * angle
    k = 0.5 * torch.sinc(half / math.pi)  # exact at angle = 0
    return normalize(torch.cat([rv * k, torch.cos(half)], dim=-1))


def to_rotvec(q):
    """Quaternion -> axis-angle rotation vector (scipy as_rotvec convention)."""
    q = torch.where(q[..., 3:4] < 0.0, -q, q)  # shortest arc
    sin_half = torch.linalg.vector_norm(q[..., :3], dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(sin_half[..., 0], q[..., 3])[..., None]
    scale = torch.where(sin_half > _EPS, angle / sin_half.clamp_min(_EPS), 2.0)
    return q[..., :3] * scale


def slerp(q0, q1, t):
    """Spherical linear interpolation, t in [0, 1] broadcast against the
    quaternion batch. Matches scipy Slerp."""
    t = torch.as_tensor(t, device=q0.device)[..., None]
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0.0, -q1, q1)
    d = d.abs().clamp_max(1.0 - 1e-7)
    theta = torch.acos(d)
    sin_theta = torch.sin(theta)
    w0 = torch.sin((1.0 - t) * theta) / sin_theta
    w1 = torch.sin(t * theta) / sin_theta
    # fall back to lerp for nearly-parallel quaternions
    close = sin_theta < 1e-5
    w0 = torch.where(close, 1.0 - t, w0)
    w1 = torch.where(close, t, w1)
    return normalize(w0 * q0 + w1 * q1)


def integrate(q, omega_world, dt):
    """q' = exp(omega*dt) ∘ q (world-frame angular velocity)."""
    return normalize(mul(from_rotvec(omega_world * dt), q))


def diff_rotvec(q_to, q_from):
    """Rotation vector of q_to ∘ q_from^{-1} (world-frame relative rotation)."""
    return to_rotvec(mul(q_to, inv(q_from)))



def yaw(q):
    """Heading yaw of the body x-axis projected to the ground plane."""
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=q.dtype, device=q.device)
    fwd = rotate(q, x_axis)
    return torch.atan2(fwd[..., 1], fwd[..., 0])


def from_yaw(yaw_angle):
    half = 0.5 * yaw_angle
    zeros = torch.zeros_like(half)
    return torch.stack([zeros, zeros, torch.sin(half), torch.cos(half)], dim=-1)
