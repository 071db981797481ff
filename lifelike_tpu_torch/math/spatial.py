"""6D spatial-vector algebra (Featherstone convention, [angular; linear]).

Port of lifelike_tpu.math.spatial. All ops broadcast over leading batch
axes; shapes use trailing (6,), (3, 3) or (6, 6) axes.
"""
import torch

from lifelike_tpu_torch.math.quat import cross


def skew(v):
    """3-vector -> 3x3 skew-symmetric cross-product matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def spatial_inertia(mass, com, inertia_com):
    """Spatial inertia (6x6) of a body about a frame origin.

    mass: scalar or broadcastable (..., 1, 1); com: (..., 3) COM offset from
    the frame origin; inertia_com: (..., 3, 3) about the COM.
    Layout: [[I_o, m*cx], [m*cx^T, m*1]] with I_o = I_com + m*cx*cx^T.
    """
    cx = skew(com)
    cxT = cx.transpose(-1, -2)
    I_o = inertia_com + mass * cx @ cxT
    eye = torch.eye(3, dtype=cx.dtype, device=cx.device)
    m_eye = torch.broadcast_to(mass * eye, cx.shape)
    top = torch.cat([torch.broadcast_to(I_o, cx.shape), mass * cx], dim=-1)
    bot = torch.cat([mass * cxT, m_eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def cross_motion(v, m):
    """Spatial cross product v x m for motion vectors ([w; vl])."""
    w, vl = v[..., :3], v[..., 3:]
    mw, ml = m[..., :3], m[..., 3:]
    return torch.cat([cross(w, mw), cross(w, ml) + cross(vl, mw)], dim=-1)


def cross_force(v, f):
    """Spatial cross product v x* f for force vectors."""
    w, vl = v[..., :3], v[..., 3:]
    fw, fl = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, fw) + cross(vl, fl), cross(w, fl)], dim=-1)


def apply_inertia(I6, m):
    """I6 @ m for a motion vector m -> force vector."""
    return torch.einsum("...ij,...j->...i", I6, m)
