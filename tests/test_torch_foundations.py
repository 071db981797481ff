"""lifelike_tpu_torch foundations vs the JAX reference: math, robot model,
tile-layout constants and transposes, motion library, compat conversions.

Tolerances: model data and layout transposes are exact; float64 math is held
at 1e-12 (same formulas, different op order at most).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from lifelike_tpu.math import quat as jquat
from lifelike_tpu.math import quat_tl as jquat_tl
from lifelike_tpu.math import spatial as jspatial
from lifelike_tpu.motion import motion_lib as jml
from lifelike_tpu.physics import batched as JB
from lifelike_tpu.physics.dynamics import RobotState as JRobotState
from lifelike_tpu.robot.model import build_max_model as j_build_max_model
from lifelike_tpu.solver import rollout_tl as jrollout_tl
from lifelike_tpu_torch.compat import from_jax
from lifelike_tpu_torch.math import quat, quat_tl, spatial
from lifelike_tpu_torch.motion import motion_lib
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.robot.model import MaxModel, build_max_model
from lifelike_tpu_torch.solver import rollout_tl

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
    yaw = rng.uniform(-4.0, 4.0, size=16)
    # tile layout: component axis leading
    qa, qb, w = q1.T.reshape(4, 4, 4), q2.T.reshape(4, 4, 4), rv.T.reshape(3, 4, 4)
    vt = v.T.reshape(3, 4, 4)
    i6 = rng.standard_normal((16, 6, 6))
    i6 = i6 @ i6.transpose(0, 2, 1)

    @jax.jit
    def reference(q1, q2, v, rv, t, yaw, qa, qb, w, vt, i6):
        return dict(
            mul=jquat.mul(q1, q2), rotate=jquat.rotate(q1, v),
            rotate_inv=jquat.rotate_inv(q1, v), to_matrix=jquat.to_matrix(q1),
            from_rotvec=jquat.from_rotvec(rv), to_rotvec=jquat.to_rotvec(q1),
            slerp=jquat.slerp(q1, q2, t), slerp_same=jquat.slerp(q1, q1, t),
            integrate=jquat.integrate(q1, rv, 0.002), diff_rotvec=jquat.diff_rotvec(q1, q2),
            yaw=jquat.yaw(q1), from_yaw=jquat.from_yaw(yaw),
            rel_angle_tl=jquat_tl.rel_angle(qa, qb), integrate_tl=jquat_tl.integrate(qa, w, 0.002),
            to_matrix_tl=jquat_tl.to_matrix(qa), yaw_tl=jrollout_tl.yaw_tl(qa),
            rotate_tl=jquat_tl.rotate(qa, vt), rotate_inv_tl=jquat_tl.rotate_inv(qa, vt),
            transform_inertia=jspatial.transform_inertia(jquat.to_matrix(q1), rv, i6),
        )

    want = reference(*(jnp.asarray(x) for x in (q1, q2, v, rv, t, yaw, qa, qb, w, vt, i6)))
    T = torch.as_tensor
    got = dict(
        mul=quat.mul(T(q1), T(q2)), rotate=quat.rotate(T(q1), T(v)),
        rotate_inv=quat.rotate_inv(T(q1), T(v)), to_matrix=quat.to_matrix(T(q1)),
        from_rotvec=quat.from_rotvec(T(rv)), to_rotvec=quat.to_rotvec(T(q1)),
        slerp=quat.slerp(T(q1), T(q2), T(t)), slerp_same=quat.slerp(T(q1), T(q1), T(t)),
        integrate=quat.integrate(T(q1), T(rv), 0.002), diff_rotvec=quat.diff_rotvec(T(q1), T(q2)),
        yaw=quat.yaw(T(q1)), from_yaw=quat.from_yaw(T(yaw)),
        rel_angle_tl=quat_tl.rel_angle(T(qa), T(qb)), integrate_tl=quat_tl.integrate(T(qa), T(w), 0.002),
        to_matrix_tl=quat_tl.to_matrix(T(qa)), yaw_tl=rollout_tl.yaw_tl(T(qa)),
        rotate_tl=quat_tl.rotate(T(qa), T(vt)), rotate_inv_tl=quat_tl.rotate_inv(T(qa), T(vt)),
        transform_inertia=spatial.transform_inertia(quat.to_matrix(T(q1)), T(rv), T(i6)),
    )
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), **TOL, err_msg=name)


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
    # op by op: jitted, XLA rounds the float32 clip's finite differences
    # differently (a 1-ulp float32 change, beyond this check's 1e-12)
    want = jml.sample_frame(jc, jnp.asarray(ci), jnp.asarray(t))
    want_ended = jml.is_ended(jc, jnp.asarray(ci), jnp.asarray(t))
    got = motion_lib.sample_frame(pc, torch.as_tensor(ci), torch.as_tensor(t))
    tol = TOL if dtype == "float64" else dict(rtol=1e-5, atol=1e-5)
    assert_tree_close(got, want, **tol)
    np.testing.assert_array_equal(
        motion_lib.is_ended(pc, torch.as_tensor(ci), torch.as_tensor(t)).numpy(),
        np.asarray(want_ended),
    )


def _check_future_goal_features_match_reference():
    jc, pc = _clips_pair()
    rng = np.random.default_rng(3)
    d = random_robot_state(rng, batch=(5,))
    t = rng.uniform(0.0, 2.0, size=(5,))
    ci = np.zeros(5, np.int64)
    jf = jax.jit(lambda p, o, c, s: jml.future_goal_features(p, o, jml.sample_future(jc, c, s)))(
        jnp.asarray(d["base_pos"]), jnp.asarray(d["base_orn"]), jnp.asarray(ci), jnp.asarray(t))
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

    @jax.jit
    def reference(s, feet, r, ref_feet):
        return (jtracking.tracking_reward(s, feet, r, ref_feet, w),
                dict(fall_terminated=jtracking.fall_terminated(s),
                     blown_up=jtracking.blown_up(s)),
                jtracking.divergence_terminated(s, r))

    want, want_flags, want_div = reference(J(d), jnp.asarray(feet), J(r), jnp.asarray(ref_feet))
    got = tracking.tracking_reward(P(d), torch.as_tensor(feet), P(r), torch.as_tensor(ref_feet),
                                   tracking.TrackingWeights(*w))
    assert_close(got, want, **TOL)
    for name in ("fall_terminated", "blown_up"):
        np.testing.assert_array_equal(getattr(tracking, name)(P(d)).numpy(),
                                      np.asarray(want_flags[name]), err_msg=name)
    np.testing.assert_array_equal(tracking.divergence_terminated(P(d), P(r)).numpy(),
                                  np.asarray(want_div))
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
