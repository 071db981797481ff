"""Shared inputs for the lifelike_tpu_torch parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages: to the
JAX reference as jnp arrays, to the port through compat.from_jax.
"""
import numpy as np
import torch

# The port's CPU tests run many small eager ops, side by side with other test
# files in xdist workers: one intra-op thread each keeps a worker from
# spawning (and spin-waiting) a thread per core beside the others.
torch.set_num_threads(1)

STAND = np.array([-0.028, -0.779, 1.687] * 4)
CPU = "cpu"
F64 = torch.float64


def random_robot_state(rng, batch=(), pos_noise=0.01, vel_noise=0.2):
    """A perturbed standing state (feet near the ground, so contact is live)."""
    b = tuple(batch)
    orn = np.array([0.0, 0.0, 0.0, 1.0]) + 0.05 * rng.standard_normal(b + (4,))
    orn /= np.linalg.norm(orn, axis=-1, keepdims=True)
    return dict(
        base_pos=np.array([0.0, 0.0, 0.33]) + pos_noise * rng.standard_normal(b + (3,)),
        base_orn=orn,
        base_lin_vel=vel_noise * rng.standard_normal(b + (3,)),
        base_ang_vel=vel_noise * rng.standard_normal(b + (3,)),
        joint_pos=STAND + 0.1 * rng.standard_normal(b + (12,)),
        joint_vel=2.5 * vel_noise * rng.standard_normal(b + (12,)),
    )


def np_of(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(got, want, rtol, atol):
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=rtol, atol=atol)


def assert_tree_close(got, want, rtol, atol):
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_allclose(np_of(g), np_of(w), rtol=rtol, atol=atol, err_msg=name)


STAND_POSE = np.array([-0.0278, -0.7790, 1.6873, -0.0276, -0.7777, 1.6838,
                       -0.0278, -0.7334, 1.5669, -0.0276, -0.7319, 1.5632])


def stand_state(pos=(0.0, 0.0, 0.33), vel=(0.4, 0.0, 0.0), yaw=0.0):
    """Standing pose (numpy, unbatched) at `pos` heading `yaw`."""
    return dict(
        base_pos=np.array(pos, np.float64),
        base_orn=np.array([0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)]),
        base_lin_vel=np.array(vel, np.float64),
        base_ang_vel=np.zeros(3),
        joint_pos=STAND_POSE.copy(),
        joint_vel=np.zeros(12),
    )


def contact_scene(model, state, capacity=12):
    """Box table (numpy center, half, active, target_pos) around `state`
    such that every kind of box contact fires from the first substep: a step
    4 mm up into foot 0, a hurdle whose -x top edge sits under foot 1 (4 mm
    up into it), a block 3 mm into wheel 2's outer side and a wall 10 mm
    into the trunk proxy's +y side; behind them the two corridor walls and a
    hole bar, the rest inactive padding. Needs the feet off the ground, e.g.
    stand_state(pos=(0, 0, 0.36))."""
    from lifelike_tpu_torch.physics import dynamics
    from lifelike_tpu_torch.physics.dynamics import RobotState

    rs = RobotState(*(torch.as_tensor(state[f], dtype=F64) for f in RobotState._fields))
    kin = dynamics.forward_kinematics(model, rs)
    foot, wheel = kin.p_foot.numpy(), kin.p_wheel.numpy()
    rf, rw = model.foot_radius, model.wheel_radius
    base = state["base_pos"]

    def on_ground(x, y, hx, hy, top):
        return [x, y, top / 2], [hx, hy, top / 2]

    side = np.sign(wheel[2, 1])
    rows = [
        on_ground(foot[0, 0], foot[0, 1], 0.06, 0.06, foot[0, 2] - rf + 0.004),
        on_ground(foot[1, 0] + 0.05, foot[1, 1], 0.05, 0.05, foot[1, 2] - rf + 0.004),
        ([wheel[2, 0], wheel[2, 1] + side * (rw - 0.003 + 0.05), wheel[2, 2]],
         [0.05, 0.05, 0.05]),
        ([base[0], base[1] + 0.05 + 0.07 - 0.010 + 0.1, base[2] + 0.15], [0.3, 0.1, 0.2]),
        ([5.0, 1.2, 1.0], [100.0, 0.1, 1.0]),
        ([5.0, -1.2, 1.0], [100.0, 0.1, 1.0]),
        ([base[0] + 0.6, 0.0, 0.42], [0.05, 1.1, 0.15]),
    ]
    center = np.zeros((capacity, 3))
    half = np.zeros((capacity, 3))
    for i, (c, h) in enumerate(rows):
        center[i], half[i] = c, h
    active = np.arange(capacity) < len(rows)
    return dict(center=center, half=half, active=active,
                target_pos=np.array([base[0] + 4.0, 0.3, 0.0]))


def screened_gate(got, want, shifted, tol):
    """Kernel `got` vs plain `want` at rtol = atol = tol over the values whose
    plain result stays within tol when the start shifts by 1e-10 m
    (`shifted`: the plain result from shifted_start; None gates every
    value). Contact chaos amplifies such a shift, and rounding differences
    alike. Returns the number of values gated."""
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())
    limit = tol + tol * want.abs()
    gated = torch.ones_like(want, dtype=torch.bool)
    if shifted is not None:
        gated = (shifted - want).abs() <= limit
    bad = ((got - want).abs() > limit) & gated
    assert not bool(bad.any()), float((got - want).abs()[gated].max())
    return int(gated.sum())


def shifted_start(tl):
    """A TLState start moved by 1e-10 m along x."""
    x = tl.base_pos.new_tensor([1e-10, 0.0, 0.0]).reshape(3, 1, 1)
    return tl._replace(base_pos=tl.base_pos + x)
