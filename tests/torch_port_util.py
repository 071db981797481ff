"""Shared inputs for the lifelike_tpu_torch parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages: to the
JAX reference as jnp arrays, to the port through compat.from_jax.
"""
import numpy as np
import torch

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
