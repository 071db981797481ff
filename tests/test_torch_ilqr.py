"""The iLQR layer of lifelike_tpu_torch (solver/ilqr.py) and the MPPI top-k
seeds it refines (solver/mppi_tl.py) vs the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages, float64
and substeps 1 unless a check says otherwise. Each problem's step and cost
values are held at 1e-9: the tracking problem on the synthetic clip, the
traversal problem on a box table where feet and a wheel touch boxes (the
base clear of every box), and at a base over a box's footprint, and the
chase problem for both roles. The port's `linearize` is held to JAX's on
the tracking problem (S 2, H 2) at 1e-9 of each block's scale; the
traversal and chase cost gradients and Hessians to JAX's at 1e-9, and
their step Jacobians to central differences of the port's own step (which
is held to JAX) at 1e-6 of the block's scale.

One difference from the reference, at a point where the gradient does not
exist: over a box's footprint the clearance hinge's norm is sqrt(0); JAX's
gradient there is NaN (inf x 0), and so is the port's (costs/traversal.py
computes the norm as jnp.linalg.norm does, where torch.linalg.vector_norm
would give 0). The check asserts the NaN pattern equals JAX's.

The second item holds mppi_update(return_topk=...) to JAX's
mppi_step(return_topk=...) with the same injected noise (the candidates in
exact order, their costs at 1e-9) and the port's single-sequence
ilqr_solve to its ilqr_solve_batch at the reference test's tolerances
(test_riccati_pallas.py:113-116).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from lifelike_tpu.motion import motion_lib as jml
from lifelike_tpu.physics import batched as JB
from lifelike_tpu.physics import engine as jengine
from lifelike_tpu.physics.dynamics import RobotState as JRobotState
from lifelike_tpu.robot.model import build_max_model as j_build_max_model
from lifelike_tpu.scene.boxes import BoxScene as JBoxScene
from lifelike_tpu.solver import ilqr as jilqr
from lifelike_tpu.solver import mppi as jmppi
from lifelike_tpu.solver import mppi_tl as jmppi_tl
from lifelike_tpu.solver import rollout_tl as jrollout_tl
from lifelike_tpu_torch.compat import from_jax
from lifelike_tpu_torch.motion import motion_lib
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.physics import engine
from lifelike_tpu_torch.physics.dynamics import RobotState
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.scene.boxes import BoxScene
from lifelike_tpu_torch.solver import ilqr, mppi, mppi_tl

from tests.torch_port_util import (
    CPU,
    F64,
    assert_close,
    contact_scene,
    np_of,
    random_robot_state,
    stand_state,
)

JMODEL = j_build_max_model()
MODEL = build_max_model()
PARAMS = dict(kd=1.0, max_tau=16.0, substeps=1)


def T(x, dtype=F64):
    return torch.as_tensor(np.array(x), dtype=dtype)


def flat(d):
    """numpy state dict -> flattened (37,) state."""
    return np.concatenate([d[f] for f in RobotState._fields])


def close_to_scale(got, want, tol, label):
    """|got - want| <= tol x max(|want|, 1), NaN where JAX has NaN."""
    w = np_of(want)
    scale = max(float(np.nanmax(np.abs(w))) if np.isfinite(w).any() else 1.0, 1.0)
    np.testing.assert_allclose(np_of(got), w, rtol=0, atol=tol * scale, err_msg=label)


def off_the_edges(d, shift=(0.0017, -0.0009, 0.0004)):
    """d with the base moved by `shift` and turning and sinking a little:
    contact_scene puts foot 1 exactly over a hurdle's edge, and a standing
    state's contact points have a normal velocity of exactly 0, both kinks
    (of the box SDF, of the damping's clamp) where central differences
    average the two sides; moved, every contact stays live and smooth."""
    return dict(d, base_pos=d["base_pos"] + np.array(shift),
                base_lin_vel=d["base_lin_vel"] + np.array([0.0, 0.01, -0.013]),
                base_ang_vel=d["base_ang_vel"] + np.array([0.02, -0.01, 0.015]))


def _check_state_and_config():
    rng = np.random.default_rng(1)
    d = random_robot_state(rng, batch=(3,))
    d["base_orn"] = 1.7 * d["base_orn"]  # off the unit sphere: unflatten normalizes
    x = np.concatenate([d[f] for f in RobotState._fields], axis=-1)
    js = jilqr.unflatten_state(jnp.asarray(x))
    ps = ilqr.unflatten_state(T(x))
    for f, a, b in zip(RobotState._fields, ps, js):
        assert_close(a, b, rtol=1e-12, atol=1e-12)
    assert_close(ilqr.flatten_state(ps), jilqr.flatten_state(js), rtol=1e-12, atol=1e-12)
    assert (ilqr.STATE_DIM, ilqr.ACT_DIM) == (jilqr.STATE_DIM, jilqr.ACT_DIM)
    # the config: the port's defaults are the reference's; a reference config
    # carries across field by field
    assert ilqr.ILQRConfig()._fields == jilqr.ILQRConfig()._fields
    assert tuple(ilqr.ILQRConfig()) == tuple(jilqr.ILQRConfig())
    jcfg = jilqr.ILQRConfig(iterations=2, reg=3e-3, line_search=(1.0, 0.3), reg_up=7.0,
                            lin_substeps=2)
    pcfg = from_jax.ilqr_config(jcfg)
    assert isinstance(pcfg, ilqr.ILQRConfig) and tuple(pcfg) == tuple(jcfg)
    jp = jengine.PhysicsParams(substeps=10)
    lp = ilqr.coarse_lin_params(from_jax.physics_params(jp), 2)
    jlp = jilqr.coarse_lin_params(jp, 2)
    assert (lp.substeps, lp.dt) == (jlp.substeps, jlp.dt)


def _jax_point_fn(make):
    """jit of (x, u, t, *args) -> (x', cost, cost grads, cost Hessians xx,
    uu) of the problem make(*args) at one point."""
    def fn(x, u, t, *args):
        step_fn, cost_fn = make(*args)
        gx, gu = jax.grad(cost_fn, argnums=(0, 1))(x, u, t)
        return (step_fn(x, u, t), cost_fn(x, u, t), gx, gu,
                jax.hessian(cost_fn, argnums=0)(x, u, t), jax.hessian(cost_fn, argnums=1)(x, u, t))

    return jax.jit(fn)


def _fd_jacobians(step_fn, x, u, t, h=1e-6):
    """Central differences of step_fn at (x, u) in every input direction,
    all 2 x 49 perturbed points in one batch: (A (37, 37), B (37, 12))."""
    n, m = x.shape[0], u.shape[0]
    E = torch.eye(n + m, dtype=x.dtype) * h
    xs = torch.cat([x + E[:, :n], x - E[:, :n]])
    us = torch.cat([u + E[:, n:], u - E[:, n:]])
    out = step_fn(xs, us, t)
    J = ((out[: n + m] - out[n + m:]) / (2 * h)).T
    return J[:, :n], J[:, n:]


def _check_point(label, jfn, jargs, step_fn, cost_fn, x, u, t, jac_vs_fd=True):
    """Port problem vs the JAX one at (x, u, t): the step and the cost at
    1e-9; the cost gradients and Hessians (port: ilqr.linearize) at 1e-9 of
    each block's scale; the step Jacobians against central differences of
    the port's own step at 1e-6 of the block's scale."""
    want = jfn(jnp.asarray(x), jnp.asarray(u), jnp.asarray(t, jnp.float64), *jargs)
    px, pu, pt = T(x), T(u), T(t)
    assert_close(step_fn(px, pu, pt), want[0], rtol=1e-9, atol=1e-9)
    assert_close(cost_fn(px, pu, pt), want[1], rtol=1e-9, atol=1e-9)
    # linearize at a one-point trajectory whose step index is t
    H = int(t) + 1
    xs = px.expand(1, H, 37).clone()
    us = pu.expand(1, H, 12).clone()
    lin = ilqr.linearize(step_fn, cost_fn, xs, us)
    A, Bm, cx, cu, Cxx, Cuu = (o[0, -1] for o in lin)
    for name, g, w in (("cx", cx, want[2]), ("cu", cu, want[3]), ("Cxx", Cxx, want[4]),
                       ("Cuu", Cuu, want[5])):
        close_to_scale(g, w, 1e-9, f"{label} {name}")
    if jac_vs_fd:
        A_fd, B_fd = _fd_jacobians(step_fn, px, pu, pt)
        close_to_scale(A, A_fd, 1e-6, f"{label} A")
        close_to_scale(Bm, B_fd, 1e-6, f"{label} B")
    return cx


def _check_tracking(rng):
    # the clip's frames in float64: jitted XLA divides the float32 frame
    # differences by the frame step 1 float32 ulp apart from the eager port,
    # which moves the velocity terms' gradients by ~1e-9
    jclips = jml.pack_clips([jml.make_synthetic_clip(480)], frame_step=1.0 / 120.0)
    jclips = jclips._replace(frames=jnp.asarray(jclips.frames, jnp.float64))
    jp = jengine.PhysicsParams(substeps=1)
    t0 = jnp.asarray(0.3, jnp.float64)  # a typed float64 clip time (see the verify notes)

    def jmake(*_):
        return jilqr.make_problem(JMODEL, jp, jclips, jnp.asarray(0), t0)

    clips = from_jax.motion_clips(jclips, device=CPU)
    step_fn, cost_fn = ilqr.make_problem(MODEL, from_jax.physics_params(jp), clips,
                                         torch.tensor(0), T(0.3))
    d = random_robot_state(rng, vel_noise=0.1)
    x, u = flat(d), 0.05 * rng.standard_normal(12)
    _check_point("tracking", _jax_point_fn(jmake), (), step_fn, cost_fn, x, u, 1.0,
                 jac_vs_fd=False)
    # linearize over a batch of trajectories, S 2 x H 2, against JAX's
    S, H = 2, 2
    xs = np.stack([np.stack([flat(random_robot_state(rng, vel_noise=0.1)) for _ in range(H)])
                   for _ in range(S)])
    us = 0.05 * rng.standard_normal((S, H, 12))
    jstep, jcost = jmake()
    want = jax.jit(lambda a, b: jilqr.linearize(jstep, jcost, a, b))(jnp.asarray(xs),
                                                                     jnp.asarray(us))
    got = ilqr.linearize(step_fn, cost_fn, T(xs), T(us))
    for name, g, w in zip(("A", "B", "cx", "cu", "Cxx", "Cuu"), got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        close_to_scale(g, w, 1e-9, f"linearize {name}")


def _check_traversal(rng):
    jp = jengine.PhysicsParams(**PARAMS)
    pp = from_jax.physics_params(jp)

    def jmake(q0, center, half, active, target):
        sc = JBoxScene(center, half, active, target)
        return jilqr.make_traversal_problem(JMODEL, jp, sc, target, 1.2, q0)

    jfn = _jax_point_fn(jmake)
    # feet and a wheel touching boxes, the base clear of every box (off the
    # origin, where the inactive padding boxes sit)
    d = stand_state(pos=(0.013, -0.007, 0.36))
    table = contact_scene(MODEL, d)
    for label, state, jac in (("traversal, contact", off_the_edges(d), True),
                              ("traversal, over the padding", stand_state(pos=(0.0, 0.0, 0.36)),
                               False)):
        x, u = flat(state), 0.03 * rng.standard_normal(12)
        jargs = (jnp.asarray(state["joint_pos"]), *(jnp.asarray(table[k]) for k in
                                                      ("center", "half", "active",
                                                       "target_pos")))
        scene = BoxScene(T(table["center"]), T(table["half"]), torch.as_tensor(table["active"]),
                         T(table["target_pos"]))
        step_fn, cost_fn = ilqr.make_traversal_problem(MODEL, pp, scene, scene.target_pos, 1.2,
                                                       T(state["joint_pos"]))
        cx = _check_point(label, jfn, jargs, step_fn, cost_fn, x, u, 0.0, jac_vs_fd=jac)
        # over the zero-size padding boxes at the origin the clearance norm is
        # sqrt(0): NaN in the base's x and y in both packages, finite elsewhere
        assert torch.isnan(cx).any().item() == (not jac), (label, cx)


def _check_chase(rng):
    jp = jengine.PhysicsParams(**PARAMS)
    pp = from_jax.physics_params(jp)
    H = 4
    opp = np.stack([np.array([1.0 - 0.1 * i, 0.2, 0.33]) for i in range(H)])
    flag = np.array([0.0, 1.5, 0.25])

    def jmake(q0, role, center, half, active):
        sc = JBoxScene(center, half, active, jnp.zeros(3))
        return jilqr.make_chase_problem(JMODEL, jp, sc, jnp.asarray(opp), jnp.asarray(flag),
                                        role, q0)

    jfn = _jax_point_fn(jmake)
    d = stand_state(pos=(-0.021, 0.012, 0.36), yaw=0.3)
    table = contact_scene(MODEL, d)
    scene = BoxScene(T(table["center"]), T(table["half"]), torch.as_tensor(table["active"]),
                     T(table["target_pos"]))
    for chaser in (True, False):
        x, u = flat(off_the_edges(d)), 0.03 * rng.standard_normal(12)
        jargs = (jnp.asarray(d["joint_pos"]), jnp.asarray(chaser),
                 *(jnp.asarray(table[k]) for k in ("center", "half", "active")))
        step_fn, cost_fn = ilqr.make_chase_problem(MODEL, pp, scene, T(opp), T(flag),
                                                   torch.tensor(chaser), T(d["joint_pos"]))
        # t = 2: the cost reads the opponent's position at step 2
        _check_point(f"chase, chaser={chaser}", jfn, jargs, step_fn, cost_fn, x, u, 2.0)


def _check_topk():
    """mppi_update(return_topk=...) vs JAX mppi_step(return_topk=...) with
    the normals JAX drew: the candidates in exact order, the costs at 1e-9."""
    cfg = jmppi.MPPIConfig(horizon=2, population=128, iterations=2, sigma=0.1)
    jp = jengine.PhysicsParams(substeps=1)
    jc = jml.pack_clips([jml.make_synthetic_clip(480)], frame_step=1.0 / 120.0)
    rng = np.random.default_rng(4)
    d = random_robot_state(rng, batch=(1,), vel_noise=0.05)
    jtl = JB.tl_from_state(JRobotState(**{k: jnp.asarray(v) for k, v in d.items()}))
    jref = jrollout_tl.precompute_reference(JMODEL, jc, jnp.asarray(0), jnp.asarray(0.3),
                                            cfg.horizon, jp.dt * jp.substeps)
    u0 = 0.05 * rng.standard_normal((cfg.horizon, 4, 3))
    key = jax.random.PRNGKey(11)
    jcon = JB.tl_constants(JMODEL, dtype=jnp.float64)
    want, jdiag = jax.jit(lambda k, u: jmppi_tl.mppi_step(
        jcon, jp, cfg, k, jtl, u, jref, return_topk=5))(key, jnp.asarray(u0))
    shape = (cfg.horizon, 4, 3, 1, 128)
    eps = [torch.as_tensor(np.array(jax.random.normal(k, shape, jnp.float64)))
           for k in jax.random.split(key, cfg.iterations)]
    pc = B.tl_constants(MODEL, dtype=F64, device=CPU)
    got, diag = mppi_tl.mppi_step(pc, from_jax.physics_params(jp), mppi.MPPIConfig(*cfg), None,
                                  from_jax.tl_state(jtl, CPU, F64), T(u0),
                                  from_jax.ref_traj(jref, CPU, F64), eps=eps, return_topk=5)
    assert_close(got, want, rtol=1e-9, atol=1e-9)
    assert diag["u_topk"].shape == (5, cfg.horizon, 4, 3)
    assert_close(diag["cost_topk"], jdiag["cost_topk"], rtol=1e-9, atol=1e-9)
    # the same candidates in the same order: each row is exactly one noise draw
    assert_close(diag["u_topk"], jdiag["u_topk"], rtol=1e-12, atol=1e-12)
    assert bool(torch.all(diag["cost_topk"][1:] >= diag["cost_topk"][:-1]))
    # ties go to the lower candidate index, as jax.lax.top_k breaks them
    u_cand = torch.arange(4.0, dtype=F64).reshape(1, 1, 1, 1, 4).expand(2, 4, 3, 1, 4)
    u_top, c_top = mppi_tl._topk(u_cand, T([[2.0, 1.0, 1.0, 0.5]]), 3)
    assert_close(c_top, [0.5, 1.0, 1.0], rtol=0, atol=0)
    assert u_top[:, 0, 0, 0].tolist() == [3.0, 1.0, 2.0]


def _check_single_vs_batch():
    """The port's ilqr_solve per sequence vs its ilqr_solve_batch, on the
    reference test's standing problem (float32, substeps 2, H 3, two
    iterations, a too-high and a too-low seed), at that test's tolerances:
    reg enters Quu after B'VB in the single path and through Cuu in the
    batched one, float32 reassociation amplified by contact physics."""
    f32 = torch.float32
    stand = [-0.028, -0.779, 1.687] * 4
    frames = np.zeros((240, 19), dtype=np.float32)
    frames[:, 2] = 0.33
    frames[:, 6] = 1.0
    frames[:, 7:] = np.asarray(stand)
    clips = motion_lib.pack_clips([frames], frame_step=1.0 / 120.0, device=CPU)
    params = engine.PhysicsParams(substeps=2)
    step_fn, cost_fn = ilqr.make_problem(MODEL, params, clips, torch.tensor(0),
                                         torch.tensor(0.0))
    s0 = RobotState(T([0.0, 0.0, 0.33], f32), T([0.0, 0.0, 0.0, 1.0], f32),
                    torch.zeros(3), torch.zeros(3), T(stand, f32), torch.zeros(12))
    H = 3
    x0 = ilqr.flatten_state(s0)
    cfg = ilqr.ILQRConfig(iterations=2)
    us = torch.stack([torch.full((H, 12), 0.25), torch.full((H, 12), -0.15)])
    u_b, info = ilqr.ilqr_solve_batch(step_fn, cost_fn, x0.expand(2, 37), us, cfg,
                                      use_pallas=False)
    for s in range(2):
        u_s, info_s = ilqr.ilqr_solve(step_fn, cost_fn, x0, us[s], cfg)
        assert_close(u_b[s], u_s, rtol=5e-3, atol=1e-5)
        assert_close(info["final_cost"][s], info_s["final_cost"], rtol=1e-3, atol=0)
        assert info_s["cost_history"].shape == (cfg.iterations,)
    fin, ini = np_of(info["final_cost"]), np_of(info["initial_cost"])
    assert (fin <= ini).all()  # iLQR never accepts a worse sequence
    assert (fin < ini).any()  # and the bad seed does get polished


# Each test file of the port holds at most two test items (ROADMAP.md ground
# rules): the checks are plain helpers called in turn.


def test_ilqr_problems_match_reference():
    rng = np.random.default_rng(2)
    _check_state_and_config()
    _check_tracking(rng)
    _check_traversal(rng)
    _check_chase(rng)


def test_mppi_topk_and_ilqr_solves():
    _check_topk()
    _check_single_vs_batch()
