"""lifelike_tpu_torch foundations vs the JAX reference: math, robot model,
tile-layout constants and transposes, motion library, compat conversions.

Tolerances: model data and layout transposes are exact; float64 math is held
at 1e-12 (same formulas, different op order at most).
"""
import jax.numpy as jnp
import numpy as np
import torch

from lifelike_tpu.math import quat as jquat
from lifelike_tpu.math import quat_tl as jquat_tl
from lifelike_tpu.motion import motion_lib as jml
from lifelike_tpu.physics import batched as JB
from lifelike_tpu.physics.dynamics import RobotState as JRobotState
from lifelike_tpu.robot.model import build_max_model as j_build_max_model
from lifelike_tpu_torch.compat import from_jax
from lifelike_tpu_torch.math import quat, quat_tl
from lifelike_tpu_torch.motion import motion_lib
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.robot.model import MaxModel, build_max_model

from tests.torch_port_util import CPU, F64, assert_close, assert_tree_close, random_robot_state

JMODEL = j_build_max_model()
TOL = dict(rtol=1e-12, atol=1e-12)


def _quats(rng, n):
    q = rng.standard_normal((n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _check_build_max_model_is_exact():
    got, want = build_max_model(), JMODEL
    assert isinstance(got, MaxModel)
    for name in MaxModel.__dataclass_fields__:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)
    conv = from_jax.max_model(want)
    for name in MaxModel.__dataclass_fields__:
        np.testing.assert_array_equal(np.asarray(getattr(conv, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)


def _check_tl_constants_are_exact(dtype):
    got = B.tl_constants(build_max_model(), dtype=getattr(torch, dtype), device=CPU)
    want = JB.tl_constants(JMODEL, dtype=getattr(jnp, dtype))
    conv = from_jax.tl_constants(want, device=CPU)
    for name, g, w, cv in zip(B.TLConstants._fields, got, want, conv):
        if isinstance(w, float):
            assert g == w and cv == w, name
            continue
        assert str(g.dtype).endswith(dtype), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(cv.numpy(), np.asarray(w), err_msg=name)


def _check_tl_from_state_and_back_are_exact():
    rng = np.random.default_rng(0)
    d = random_robot_state(rng, batch=(6,))
    want = JB.tl_from_state(JRobotState(**{k: jnp.asarray(v) for k, v in d.items()}),
                            batch2d=(2, 3))
    port_state = from_jax.robot_state(JRobotState(**d), CPU, F64)
    got = B.tl_from_state(port_state, batch2d=(2, 3))
    for name, g, w in zip(B.TLState._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    back = B.state_from_tl(got, batch_shape=(6,))
    for name, g, w in zip(port_state._fields, back, port_state):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)
    default = B.tl_from_state(port_state)
    assert default.base_pos.shape == (3, 6, 1)


def _check_quat_ops_match_reference():
    rng = np.random.default_rng(1)
    q1, q2 = _quats(rng, 16), _quats(rng, 16)
    v = rng.standard_normal((16, 3))
    rv = 0.7 * rng.standard_normal((16, 3))
    rv[0] = 0.0  # exact zero rotation: the sinc branch
    t = rng.uniform(size=16)
    T = lambda x: torch.as_tensor(x)
    J = jnp.asarray
    assert_close(quat.mul(T(q1), T(q2)), jquat.mul(J(q1), J(q2)), **TOL)
    assert_close(quat.rotate(T(q1), T(v)), jquat.rotate(J(q1), J(v)), **TOL)
    assert_close(quat.rotate_inv(T(q1), T(v)), jquat.rotate_inv(J(q1), J(v)), **TOL)
    assert_close(quat.to_matrix(T(q1)), jquat.to_matrix(J(q1)), **TOL)
    assert_close(quat.from_rotvec(T(rv)), jquat.from_rotvec(J(rv)), **TOL)
    assert_close(quat.to_rotvec(T(q1)), jquat.to_rotvec(J(q1)), **TOL)
    assert_close(quat.slerp(T(q1), T(q2), T(t)), jquat.slerp(J(q1), J(q2), J(t)), **TOL)
    assert_close(quat.slerp(T(q1), T(q1), T(t)), jquat.slerp(J(q1), J(q1), J(t)), **TOL)
    assert_close(quat.integrate(T(q1), T(rv), 0.002), jquat.integrate(J(q1), J(rv), 0.002), **TOL)
    assert_close(quat.diff_rotvec(T(q1), T(q2)), jquat.diff_rotvec(J(q1), J(q2)), **TOL)
    # tile layout: component axis leading
    qa, qb, w = q1.T.reshape(4, 4, 4), q2.T.reshape(4, 4, 4), rv.T.reshape(3, 4, 4)
    assert_close(quat_tl.rel_angle(T(qa), T(qb)), jquat_tl.rel_angle(J(qa), J(qb)), **TOL)
    assert_close(quat_tl.integrate(T(qa), T(w), 0.002),
                 jquat_tl.integrate(J(qa), J(w), 0.002), **TOL)
    assert_close(quat_tl.to_matrix(T(qa)), jquat_tl.to_matrix(J(qa)), **TOL)


def _clips_pair(seed=0, n=480):
    frames = jml.make_synthetic_clip(n, seed=seed)
    np.testing.assert_array_equal(motion_lib.make_synthetic_clip(n, seed=seed), frames)
    other = jml.make_synthetic_clip(300, seed=seed + 1)
    jc = jml.pack_clips([frames, other], frame_step=1.0 / 120.0)
    pc = motion_lib.pack_clips([frames, other], frame_step=1.0 / 120.0, device=CPU)
    return jc, pc


def _check_pack_clips_and_compat_are_exact():
    jc, pc = _clips_pair()
    np.testing.assert_array_equal(pc.frames.numpy(), jc.frames)
    np.testing.assert_array_equal(pc.lengths.numpy(), jc.lengths)
    assert (pc.frame_step, pc.margin) == (jc.frame_step, jc.margin)
    conv = from_jax.motion_clips(jc, device=CPU)
    np.testing.assert_array_equal(conv.frames.numpy(), jc.frames)
    assert conv.margin == jc.margin


def _check_sample_frame_matches_reference_incl_out_of_range(dtype):
    """Times before the start and past the end of a clip clamp the frame
    index exactly as the reference's clamped gathers do."""
    jc, pc = _clips_pair()
    rng = np.random.default_rng(2)
    t = rng.uniform(-0.5, 5.0, size=(24,)).astype(dtype)
    ci = rng.integers(0, 2, size=(24,))
    want = jml.sample_frame(jc, jnp.asarray(ci), jnp.asarray(t))
    got = motion_lib.sample_frame(pc, torch.as_tensor(ci), torch.as_tensor(t))
    tol = TOL if dtype == "float64" else dict(rtol=1e-5, atol=1e-5)
    assert_tree_close(got, want, **tol)
    np.testing.assert_array_equal(
        motion_lib.is_ended(pc, torch.as_tensor(ci), torch.as_tensor(t)).numpy(),
        np.asarray(jml.is_ended(jc, jnp.asarray(ci), jnp.asarray(t))),
    )


def _check_future_goal_features_match_reference():
    jc, pc = _clips_pair()
    rng = np.random.default_rng(3)
    d = random_robot_state(rng, batch=(5,))
    t = rng.uniform(0.0, 2.0, size=(5,))
    ci = np.zeros(5, np.int64)
    jf = jml.future_goal_features(jnp.asarray(d["base_pos"]), jnp.asarray(d["base_orn"]),
                                  jml.sample_future(jc, jnp.asarray(ci), jnp.asarray(t)))
    pf = motion_lib.future_goal_features(
        torch.as_tensor(d["base_pos"]), torch.as_tensor(d["base_orn"]),
        motion_lib.sample_future(pc, torch.as_tensor(ci), torch.as_tensor(t)))
    assert pf.shape == (5, 72)
    assert_close(pf, jf, **TOL)


def _check_load_clips_json_path(tmp_path):
    import json

    frames = motion_lib.make_synthetic_clip(200)
    path = tmp_path / "clip.txt"
    path.write_text(json.dumps({"FrameDuration": 1.0 / 120.0, "Frames": frames.tolist()}))
    got = motion_lib.load_clips(str(path), device=CPU)
    want = jml.load_clips(str(path))
    np.testing.assert_array_equal(got.frames.numpy(), np.asarray(want.frames))
    assert got.margin == want.margin


def _check_tracking_terms_match_reference():
    """Reward, fall / divergence / blowup predicates on states that include
    falls (large tilts), divergence and a non-finite row."""
    from lifelike_tpu.costs import tracking as jtracking
    from lifelike_tpu.physics.dynamics import RobotState as JRS
    from lifelike_tpu_torch.costs import tracking

    rng = np.random.default_rng(4)
    d = random_robot_state(rng, batch=(16,))
    tilt = _quats(rng, 16)
    d["base_orn"][8:] = tilt[8:]  # half of the rows tumbled
    d["base_pos"][4:6] += 1.5  # diverged rows
    d["joint_vel"][3, 0] = np.nan
    d["base_lin_vel"][2, 1] = 2e3
    r = random_robot_state(rng, batch=(16,))
    feet = rng.standard_normal((16, 4, 3))
    ref_feet = rng.standard_normal((16, 4, 3))
    J = lambda dd: JRS(**{k: jnp.asarray(v) for k, v in dd.items()})
    P = lambda dd: from_jax.robot_state(J(dd), CPU, F64)
    w = jtracking.TrackingWeights(0.3, 0.05, 0.1, 0.5, 0.05)
    want = jtracking.tracking_reward(J(d), jnp.asarray(feet), J(r), jnp.asarray(ref_feet), w)
    got = tracking.tracking_reward(P(d), torch.as_tensor(feet), P(r), torch.as_tensor(ref_feet),
                                   tracking.TrackingWeights(*w))
    assert_close(got, want, **TOL)
    for name in ("fall_terminated", "blown_up"):
        np.testing.assert_array_equal(getattr(tracking, name)(P(d)).numpy(),
                                      np.asarray(getattr(jtracking, name)(J(d))), err_msg=name)
    np.testing.assert_array_equal(tracking.divergence_terminated(P(d), P(r)).numpy(),
                                  np.asarray(jtracking.divergence_terminated(J(d), J(r))))
    assert tracking.fall_terminated(P(d)).any() and tracking.blown_up(P(d)).sum() == 2


# Each test file of the port holds at most two test items: pytest-xdist's
# loadfile scheduler queues files by item count, so files this small run
# after the long reference files and do not lengthen the tier-1 run.


def test_model_constants_and_layouts_are_exact():
    _check_build_max_model_is_exact()
    for dtype in ("float32", "float64"):
        _check_tl_constants_are_exact(dtype)
    _check_tl_from_state_and_back_are_exact()
    _check_pack_clips_and_compat_are_exact()


def test_math_motion_and_costs_match_reference(tmp_path):
    _check_quat_ops_match_reference()
    for dtype in ("float32", "float64"):
        _check_sample_frame_matches_reference_incl_out_of_range(dtype)
    _check_future_goal_features_match_reference()
    _check_load_clips_json_path(tmp_path)
    _check_tracking_terms_match_reference()
