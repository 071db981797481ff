"""Compliant contact model for foot/wheel spheres against terrain.

Port of lifelike_tpu.physics.contact: a regularized spring-damper normal
force plus smooth Coulomb friction, tuned so static penetration is ~1 mm and
500 Hz substep integration stays stable — against the ground plane and
against axis-aligned boxes (signed distance field, tops and vertical faces
alike).
"""
from typing import NamedTuple

import torch


class ContactParams(NamedTuple):
    """Stability constraint (explicit 500 Hz substeps, ~0.2 kg effective foot
    mass): kn=1.2e4 gives ~2.7 mm static penetration at 32 N/foot."""

    kn: float = 1.2e4  # normal stiffness (N/m)
    dn: float = 50.0  # normal damping (N s/m)
    v_slip: float = 0.1  # friction regularization velocity (m/s)
    fric_visc_cap: float = 80.0  # max effective tangential viscosity (N s/m)
    mu: float = 0.5  # lateral friction; reference default foot friction 0.5


def box_sdf(center, half, p, eps=1e-9):
    """Signed distance + outward unit normal of points to axis-aligned boxes.

    center/half: (..., 3); p: (..., 3) (shapes broadcast). dist > 0 outside
    with the closest-feature normal; dist < 0 inside with the pushout normal
    of the least-penetrated face, averaged over faces tied for it.
    """
    r = p - center
    q = r.abs() - half
    outside = torch.clamp_min(q, 0.0)
    d_out = torch.sqrt(torch.sum(outside * outside, dim=-1) + eps)
    d_in = torch.amax(q, dim=-1)  # negative inside, 0 on the surface
    inside = d_in < 0.0
    dist = torch.where(inside, d_in, d_out)

    sign = torch.where(r >= 0.0, 1.0, -1.0).to(r.dtype)
    n_out = sign * outside / d_out[..., None]
    face = (q >= torch.amax(q, dim=-1, keepdim=True)).to(r.dtype)
    face = face / torch.sum(face, dim=-1, keepdim=True).clamp_min(1.0)
    n_in = sign * face
    normal = torch.where(inside[..., None], n_in, n_out)
    return dist, normal


def _sphere_surface_force(dist, normal, vel, radius, params: ContactParams, mu):
    """Compliant force on a sphere center at signed distance `dist` from a
    surface with outward `normal`."""
    pen = torch.clamp_min(radius - dist, 0.0)
    in_contact = pen > 0.0
    vn = torch.sum(vel * normal, dim=-1)
    fn = params.kn * pen + params.dn * torch.clamp_min(-vn, 0.0) * in_contact
    fn = torch.clamp_min(fn, 0.0) * in_contact
    vt = vel - vn[..., None] * normal
    vt_norm = torch.sqrt(torch.sum(vt * vt, dim=-1) + 1e-12)
    coef = torch.clamp_max(
        mu * fn / torch.sqrt(vt_norm**2 + params.v_slip**2), params.fric_visc_cap
    )
    return fn[..., None] * normal - coef[..., None] * vt


def sphere_boxes_force(pos, vel, radius, center, half, active, params: ContactParams, mu):
    """Total contact force on spheres from a masked set of boxes.

    pos/vel: (..., P, 3); center/half: (..., N, 3); active: (..., N).
    Returns (..., P, 3) forces summed over the boxes. mu: scalar or
    broadcastable to (..., P).
    """
    dist, normal = box_sdf(
        center[..., None, :, :], half[..., None, :, :], pos[..., :, None, :]
    )  # (..., P, N), (..., P, N, 3)
    mu_b = mu if not torch.is_tensor(mu) or mu.dim() == 0 else mu[..., None]
    f = _sphere_surface_force(dist, normal, vel[..., :, None, :], radius, params, mu_b)
    f = f * active.to(f.dtype)[..., None, :, None]
    return torch.sum(f, dim=-2)


def sphere_ground_force(pos, vel, radius, ground_height, ground_normal,
                        params: ContactParams, mu=None):
    """Contact force on spheres of `radius` at world positions `pos`.

    pos/vel: (..., 3); ground_height: (...,); ground_normal: (..., 3) unit
    normal. Returns world-frame forces (..., 3).
    """
    mu = params.mu if mu is None else mu
    gap = (pos[..., 2] - ground_height) - radius  # plane-aligned fast path
    pen = torch.clamp_min(-gap, 0.0)
    in_contact = pen > 0.0

    vn = torch.sum(vel * ground_normal, dim=-1)
    fn = params.kn * pen + params.dn * torch.clamp_min(-vn, 0.0) * in_contact
    fn = torch.clamp_min(fn, 0.0) * in_contact

    vt = vel - vn[..., None] * ground_normal
    # eps inside the sqrt keeps the slip norm differentiable at rest
    vt_norm = torch.sqrt(torch.sum(vt * vt, dim=-1) + 1e-12)
    coef = torch.clamp_max(
        mu * fn / torch.sqrt(vt_norm**2 + params.v_slip**2), params.fric_visc_cap
    )
    ft = -coef[..., None] * vt
    return fn[..., None] * ground_normal + ft
