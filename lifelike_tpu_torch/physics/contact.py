"""Compliant contact model for foot/wheel spheres against the ground plane.

Port of lifelike_tpu.physics.contact (plane path): a regularized
spring-damper normal force plus smooth Coulomb friction, tuned so static
penetration is ~1 mm and 500 Hz substep integration stays stable.
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
