"""The hard-contact impulse plant of lifelike_tpu_torch (physics/impulse.py
and its sweep, ops/pgs_cuda.py) vs the JAX reference and the numpy oracle,
on the CPU.

Inputs are made with numpy from a seed and handed to both packages, float64
throughout. The row build, the dynamics helpers, the SDF and the tangent
basis are held at 1e-12, the friction maps exactly; the plain sweep at 1e-12
on the reference Pallas test's random SPD system and on a 129-row system
with a per-element mu; substep / control_step at 1e-9 on a flat walking
batch (per-element mu, compensated) and on a box scene. Against
tools/bullet_oracle.py (no JAX) the port is held at the JAX tests' own
levels: 1e-7 over 10 walking steps, 1e-9 for the joint-limit push-back,
1e-6 over 15 steps through box contact. The kernel (K5) is held to its
plain version on a card only (f32 1e-5, the Pallas kernel's tolerance, on
the reference tests' systems; f64 1e-9), also at batches its one-warp
blocks do not divide, two leading batch axes and a non-contiguous J.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelike_tpu.physics import batched as JB
from lifelike_tpu.physics import dynamics as JD
from lifelike_tpu.physics import engine as jengine
from lifelike_tpu.physics import impulse as JI
from lifelike_tpu.physics.dynamics import RobotState as JRobotState
from lifelike_tpu.robot.model import build_max_model as j_build_max_model
from lifelike_tpu.scene.boxes import BoxScene as JBoxScene
from lifelike_tpu_torch.compat import from_jax
from lifelike_tpu_torch.ops import pgs_cuda
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.physics import dynamics, impulse, oracle_traces
from lifelike_tpu_torch.physics.dynamics import RobotState
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.scene.boxes import BoxScene

from tests.torch_port_util import (
    CPU,
    F64,
    STAND_POSE,
    assert_close,
    contact_scene,
    np_of,
    stand_state,
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from bullet_oracle import BulletOracle, OracleState  # noqa: E402

JMODEL = j_build_max_model()
MODEL = build_max_model()
FIELDS = RobotState._fields


def T(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def _states(d):
    """numpy state dict -> (JAX RobotState, port RobotState), float64."""
    return (JRobotState(**{k: jnp.asarray(np.asarray(v, np.float64)) for k, v in d.items()}),
            RobotState(**{k: T(v) for k, v in d.items()}))


def _scenes(sd):
    """numpy box table -> (JAX BoxScene, port BoxScene)."""
    return (JBoxScene(**{k: jnp.asarray(v) for k, v in sd.items()}),
            BoxScene(**{k: torch.as_tensor(np.array(v)) for k, v in sd.items()}))


def _near_boxes(rng, n):
    """n standing states 3 cm above the ground, perturbed, and contact_scene's
    box table around them: every kind of box contact fires."""
    base = stand_state(pos=(0.0, 0.0, 0.36))
    sd = contact_scene(MODEL, base)
    st = {k: np.broadcast_to(v, (n,) + v.shape).copy() for k, v in base.items()}
    st["base_pos"] = st["base_pos"] + 1e-3 * rng.standard_normal((n, 3))
    st["joint_pos"] = st["joint_pos"] + 0.02 * rng.standard_normal((n, 12))
    st["base_lin_vel"] = st["base_lin_vel"] + 0.1 * rng.standard_normal((n, 3))
    st["joint_vel"] = 0.5 * rng.standard_normal((n, 12))
    return st, sd


def _check_rows_and_helpers(rng):
    """minv_apply_rows, solve_spd6, _tangent_basis, _box_sdf and _build_rows
    (flat and box scene) at 1e-12; the friction maps exactly."""
    np.testing.assert_array_equal(impulse._MU_IDX, JI._MU_IDX)
    np.testing.assert_array_equal(impulse._MU_IDX_BOX, JI._MU_IDX_BOX)
    assert (impulse.N_ROWS, impulse.N_ROWS_BOX) == (JI.N_ROWS, JI.N_ROWS_BOX) == (60, 129)
    np.testing.assert_array_equal(impulse._TRUNK_OFFSETS_HARD, jengine._TRUNK_OFFSETS_HARD)

    st, sd = _near_boxes(rng, 3)
    js, s = _states(st)
    jscene, scene = _scenes(sd)
    rows = rng.standard_normal((3, 7, 18))
    A6 = rng.standard_normal((4, 6, 6))
    A6 = A6 @ A6.transpose(0, 2, 1) + np.eye(6)
    b6 = rng.standard_normal((4, 6))
    A6_tl, b6_tl = np.moveaxis(A6, 0, -1)[..., None, :], np.moveaxis(b6, 0, -1)[..., None, :]
    normals = rng.standard_normal((6, 3))
    normals[0], normals[1], normals[2] = [0, 0, 1], [0, 0, -1], [1e-4, 0, 1]
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    # inside points tied between faces (two, then all three), outside points
    pts = np.array([[0.05, 0.05, 0.0], [0.0, 0.0, 0.0], [0.02, -0.06, 0.03],
                    [0.3, 0.1, -0.2], [0.0, 0.0, 0.25]])
    centers = np.array([[0.0, 0.0, 0.0], [0.2, 0.0, 0.1]])
    halves = np.array([[0.1, 0.1, 0.1], [0.05, 0.2, 0.1]])
    p = impulse.ImpulseParams()

    def reference(js, rows, A6_tl, b6_tl, normals, pts):
        kin = JD.forward_kinematics(JMODEL, js)
        Mb, F, Ml = JD.mass_matrix_blocks(JMODEL, kin, js.base_pos, js.base_pos)
        fac = JD.factor_dynamics(Mb, F, Ml)
        flat = JI._build_rows(JMODEL, JI.ImpulseParams(), js, kin)
        box = JI._build_rows(JMODEL, JI.ImpulseParams(), js, kin, scene=jscene)
        return (JD.minv_apply_rows(fac, rows), JD.minv_apply_rows(fac, box[0]),
                JB.solve_spd6(A6_tl, b6_tl), JI._tangent_basis(normals),
                JI._box_sdf(pts, centers, halves), flat, box)

    want = jax.jit(reference)(js, rows, A6_tl, b6_tl, normals, pts)
    kin = dynamics.forward_kinematics(MODEL, s)
    Mb, F, Ml = dynamics.mass_matrix_blocks(MODEL, kin, s.base_pos, s.base_pos)
    fac = dynamics.factor_dynamics(Mb, F, Ml)
    flat = impulse._build_rows(MODEL, p, s, kin)
    box = impulse._build_rows(MODEL, p, s, kin, scene=scene)
    got = (dynamics.minv_apply_rows(fac, T(rows)), dynamics.minv_apply_rows(fac, box[0]),
           B.solve_spd6(T(A6_tl), T(b6_tl)), impulse._tangent_basis(T(normals)),
           impulse._box_sdf(T(pts), T(centers), T(halves)), flat, box)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert_close(g, w, rtol=1e-12, atol=1e-12)
    assert flat[0].shape == (3, 60, 18) and box[0].shape == (3, 129, 18)
    # the checks reach what they are meant to: the z-parallel branch, tied
    # faces averaged, and active box rows of every sphere kind
    t1 = np_of(got[3][0])
    np.testing.assert_allclose(t1[:3], [[0, 1, 0], [0, -1, 0], [0, 1, 0]], atol=1e-4)  # n x x
    assert_close(got[4][1][0, 0], [0.5, 0.5, 0.0], rtol=0, atol=0)  # the tie, averaged
    box_hi = np_of(box[3])[:, 24:24 + 69:3]  # normal rows: feet, wheels, trunk
    assert np.isinf(box_hi[:, :4]).any() and np.isinf(box_hi[:, 4:8]).any()
    assert np.isinf(box_hi[:, 8:]).any()


def _sweep_systems(rng):
    """The reference Pallas test's random SPD system (B 128, 60 rows, scalar
    mu, 4 iterations) and a 129-row one with a per-element mu, warm-start
    impulses and bilateral rows, as numpy (v, lam0, J, MinvJT, d, b, lo, hi,
    mu, mu_idx, iterations)."""
    out = []
    for R, mu_idx in ((60, impulse._MU_IDX), (129, impulse._MU_IDX_BOX)):
        Bn, NV = 128, 18
        A = rng.normal(size=(NV, NV)) * 0.3
        Minv = A @ A.T + np.eye(NV)
        J = rng.normal(size=(Bn, R, NV)) * 0.5
        MinvJT = np.einsum("brj,jk->brk", J, Minv)
        d = np.einsum("bri,bri->br", J, MinvJT)
        v = rng.normal(size=(Bn, NV))
        b = rng.normal(size=(Bn, R)) * 0.1
        active = rng.uniform(size=(Bn, R)) > 0.3
        if R == 60:
            lam0 = np.zeros((Bn, R))
            lo = np.zeros((Bn, R))
            mu = 0.5
        else:
            lam0 = rng.uniform(0.0, 0.05, (Bn, R)) * active
            lo = -0.01 * (rng.uniform(size=(Bn, R)) > 0.8)
            mu = rng.uniform(0.4, 3.0, Bn)
        hi = np.where(active, np.inf, 0.0)
        out.append((v, lam0, J, MinvJT, d, b, lo, hi, mu, mu_idx, 4))
    return out


def _check_plain_sweep(rng):
    """pgs_sweep_plain, impulse._pgs and the CPU wrapper vs JAX _pgs, 1e-12."""
    systems = _sweep_systems(rng)

    def reference(arrays):  # the maps and iteration counts are static
        return [JI._pgs(JI.ImpulseParams(mu=x[8], iterations=a[10]), *x[:8], mu_idx=a[9])
                for x, a in zip(arrays, systems)]

    want = jax.jit(reference)([tuple(jnp.asarray(x) for x in a[:9]) for a in systems])
    launches = pgs_cuda.pgs_sweep.launches
    for a, w in zip(systems, want):
        t = [T(x) for x in a[:9]]
        p = impulse.ImpulseParams(mu=t[8], iterations=a[10])
        for got in (pgs_cuda.pgs_sweep_plain(*t, a[9], iterations=a[10]),
                    impulse._pgs(p, *t[:8], mu_idx=a[9]),
                    pgs_cuda.pgs_sweep(*t, a[9], iterations=a[10])):
            assert_close(got[0], w[0], rtol=1e-12, atol=1e-12)
            assert_close(got[1], w[1], rtol=1e-12, atol=1e-12)
        assert float(np.abs(np.asarray(w[1])).max()) > 0.0
    # on CPU tensors the wrapper runs the plain version: no kernel launch
    assert pgs_cuda.pgs_sweep.launches == launches


def _walk_batch(rng, n):
    """n perturbed starts of the walk trace, with per-element targets."""
    tr = oracle_traces.load("walk", device=CPU)
    st = {f: np.broadcast_to(np_of(x), (n,) + tuple(x.shape)).copy()
          for f, x in zip(FIELDS, tr.init)}
    st["joint_pos"] = st["joint_pos"] + 0.01 * rng.standard_normal((n, 12))
    st["joint_vel"] = st["joint_vel"] + 0.1 * rng.standard_normal((n, 12))
    st["base_lin_vel"] = st["base_lin_vel"] + 0.05 * rng.standard_normal((n, 3))
    tgt = np_of(tr.targets[0]) + 0.02 * rng.standard_normal((n, 12))
    return st, tgt


def _check_steps(rng):
    """control_step and substep vs JAX at 1e-9: a flat walking batch of 4
    with per-element mu and warm-start impulses through the compensated
    integrator (2 substeps), and one robot on the box scene of
    tests/test_impulse_boxes.py (a substep)."""
    st, tgt = _walk_batch(rng, 4)
    mu = rng.uniform(0.4, 3.0, 4)
    lam = rng.uniform(0.0, 0.02, (4, 60))
    comp = (1e-9 * rng.standard_normal((4, 3)), 1e-9 * rng.standard_normal((4, 12)))
    centers = np.array([[0.20, 0.0, 0.05], [0.45, 0.0, 0.075], [0.10, 0.35, 0.40]])
    halves = np.array([[0.12, 0.5, 0.05], [0.05, 0.5, 0.075], [0.10, 0.10, 0.10]])
    sd = dict(center=centers, half=halves, active=np.ones(3, bool), target_pos=np.zeros(3))
    bst = dict(base_pos=np.array([0.0, 0.0, 0.42]), base_orn=np.array([0.0, 0.0, 0.0, 1.0]),
               base_lin_vel=np.array([0.5, 0.0, 0.0]), base_ang_vel=np.zeros(3),
               joint_pos=STAND_POSE.copy(), joint_vel=np.zeros(12))
    jscene, scene = _scenes(sd)
    p2 = impulse.ImpulseParams(substeps=2)

    def reference(js, lam, tgt, comp, mu, jb):
        pj = JI.ImpulseParams(substeps=2)
        flat = JI.control_step(JMODEL, pj._replace(mu=mu), js, lam, tgt, comp=comp)
        lb = JI.init_lam((), jnp.float64, scene=jscene)
        return flat, JI.substep(JMODEL, pj, jb, lb, jnp.asarray(STAND_POSE), scene=jscene)

    js, s = _states(st)
    jb, sb = _states(bst)
    want = jax.jit(reference)(js, jnp.asarray(lam), jnp.asarray(tgt),
                              tuple(jnp.asarray(c) for c in comp), jnp.asarray(mu), jb)
    step = impulse.make_control_step(MODEL, p2._replace(mu=T(mu)), compensated=True)
    flat = step((s, T(lam), tuple(T(c) for c in comp)), T(tgt))
    lb = impulse.init_lam((), F64, scene=scene, device=CPU)
    one = impulse.substep(MODEL, p2, sb, lb, T(STAND_POSE), scene=scene)
    for g, w in zip(jax.tree.leaves((flat, one)), jax.tree.leaves(want)):
        assert_close(g, w, rtol=1e-9, atol=1e-9)
    assert float(np_of(flat[1]).max()) > 0.0 and float(np_of(one[1][24:93]).max()) > 0.0


def _check_oracle():
    """The JAX tests' oracle checks with the port in their place (no JAX):
    walk 10 control steps 1e-7, joint-limit push-back 1e-9, the box scene 15
    steps 1e-6."""
    tr = oracle_traces.load("walk", device=CPU)
    init = {f: np_of(x).astype(float) for f, x in zip(FIELDS, tr.init)}
    step = impulse.make_control_step(MODEL, impulse.ImpulseParams())
    s, lam = tr.init, impulse.init_lam((), F64, device=CPU)
    orc = BulletOracle(MODEL)
    so = OracleState(**{k: v.copy() for k, v in init.items()})
    for t in range(10):
        s, lam = step((s, lam), tr.targets[t])
        so = orc.control_step(so, np_of(tr.targets[t]))
    assert float(np.max(np.abs(np_of(s.joint_pos) - so.joint_pos))) < 1e-7
    assert float(np.max(np.abs(np_of(s.base_pos) - so.base_pos))) < 1e-7

    q, qd = np.zeros(12), np.zeros(12)
    q[0], qd[0] = MODEL.joint_upper_flat[0] + 0.05, 1.0  # past the limit, moving out
    lim = dict(base_pos=np.array([0.0, 0.0, 5.0]), base_orn=np.array([0.0, 0.0, 0.0, 1.0]),
               base_lin_vel=np.zeros(3), base_ang_vel=np.zeros(3), joint_pos=q, joint_vel=qd)
    s1, _ = impulse.substep(MODEL, impulse.ImpulseParams(kp=0.0, kd=0.0, max_tau=0.0),
                            RobotState(**{k: T(v) for k, v in lim.items()}),
                            impulse.init_lam((), F64, device=CPU), T(np.zeros(12)))
    so = BulletOracle(MODEL, kp=0.0, kd=0.0, max_tau=0.0).substep(
        OracleState(**{k: v.copy() for k, v in lim.items()}), np.zeros(12))
    assert float(s1.joint_vel[0]) <= 1e-9
    assert abs(float(s1.joint_vel[0]) - so.joint_vel[0]) < 1e-9

    centers = np.array([[0.20, 0.0, 0.05], [0.45, 0.0, 0.075], [0.10, 0.35, 0.40]])
    halves = np.array([[0.12, 0.5, 0.05], [0.05, 0.5, 0.075], [0.10, 0.10, 0.10]])
    scene = BoxScene(T(centers), T(halves), torch.ones(3, dtype=torch.bool), T(np.zeros(3)))
    init = dict(base_pos=np.array([0.0, 0.0, 0.42]), base_orn=np.array([0.0, 0.0, 0.0, 1.0]),
                base_lin_vel=np.array([0.5, 0.0, 0.0]), base_ang_vel=np.zeros(3),
                joint_pos=STAND_POSE.copy(), joint_vel=np.zeros(12))
    s = RobotState(**{k: T(v) for k, v in init.items()})
    lam = impulse.init_lam((), F64, scene=scene, device=CPU)
    step = impulse.make_control_step(MODEL, impulse.ImpulseParams(), scene=scene)
    orc = BulletOracle(MODEL, scene=(centers, halves))
    so = OracleState(**{k: v.copy() for k, v in init.items()})
    for _ in range(15):
        s, lam = step((s, lam), T(STAND_POSE))
        so = orc.control_step(so, STAND_POSE)
    assert float(np.max(np.abs(np_of(s.joint_pos) - so.joint_pos))) < 1e-6
    assert float(np.max(np.abs(np_of(s.base_pos) - so.base_pos))) < 1e-6
    assert so.base_pos[2] > 0.25  # the platform holds the front feet up


def _check_params_carry_across(rng):
    mu = rng.uniform(0.4, 3.0, 5)
    jp = JI.ImpulseParams(kp=40.0, mu=jnp.asarray(mu), substeps=4, iterations=7,
                          ext_force=np.array([1.0, -2.0, 3.0]), use_pallas_pgs=True)
    p = from_jax.impulse_params(jp, device=CPU, dtype=F64)
    assert isinstance(p, impulse.ImpulseParams) and p._fields == JI.ImpulseParams._fields
    for f in p._fields:
        assert_close(getattr(p, f), np.asarray(getattr(jp, f)), rtol=0, atol=0)
    assert torch.is_tensor(p.mu) and isinstance(p.kp, float) and p.use_pallas_pgs is True
    # the port's defaults are the reference's
    for f, got, want in zip(p._fields, impulse.ImpulseParams(), JI.ImpulseParams()):
        assert_close(got, np.asarray(want), rtol=0, atol=0)


# Each test file of the port holds at most two test items (ROADMAP.md ground
# rules): the checks are plain helpers called in turn.


def test_impulse_plant_matches_reference_and_oracle():
    rng = np.random.default_rng(5)
    _check_rows_and_helpers(rng)
    _check_plain_sweep(rng)
    _check_steps(rng)
    _check_oracle()
    _check_params_carry_across(rng)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA PGS kernel has no CPU mode")
    return torch.device("cuda")


def _batch_cuts(args):
    """Sweep arguments (v, lam0, J, MinvJT, d, b, lo, hi, mu) of a B-robot
    system cut to batches that K5's one-warp blocks do not divide (B 5; B
    257, robot i being robot i mod B), to two leading axes ((2, 3)), and
    with a non-contiguous J of the same values."""
    n = args[0].shape[0]

    def cut(f):
        return [f(x) if torch.is_tensor(x) and x.dim() > 0 and x.shape[0] == n else x
                for x in args]

    noncontig = list(args)
    noncontig[2] = args[2].transpose(-1, -2).contiguous().transpose(-1, -2)
    assert not noncontig[2].is_contiguous()
    return [cut(lambda x: x[:5]),
            cut(lambda x: x[torch.arange(257, device=x.device) % n]),
            cut(lambda x: x[:6].reshape((2, 3) + tuple(x.shape[1:]))),
            noncontig]


@pytest.mark.cuda
def test_pgs_kernel_matches_plain(cuda_device):
    """K5 vs pgs_sweep_plain on the card at chip_smoke.py phase 8a's shapes:
    the two random systems (60 rows with a scalar mu, 129 rows with a
    per-element one), each also cut to B 5, B 257, a (2, 3) batch and with
    a non-contiguous J; a walking substep's system (B 128, 3 iterations) and
    the 129-row hurdle system (the hurdle trace's start, box rows active)
    with a per-element mu at B 256 and for one robot;
    float64 at 1e-9, float32 at 1e-5 except on the hurdle system at B 256,
    whose plain sweep itself moves by far more than that when its rounding
    changes: there the kernel's distance from the float64 sweep of the same
    inputs may be at most twice the plain version's, plus 1e-5. The
    one-robot hurdle system, the closed loop's shape, keeps 1e-5."""
    rng = np.random.default_rng(9)
    systems = _sweep_systems(rng)
    st, tgt = _walk_batch(rng, 128)
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-9)):
        def dev(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=cuda_device)

        cases = []
        for a in systems:
            args = [dev(x) for x in a[:9]]
            idx = torch.as_tensor(a[9], device=cuda_device)
            cases += [(c, idx, a[10], False) for c in [args] + _batch_cuts(args)]
        walk = RobotState(**{k: dev(v) for k, v in st.items()})
        *sysw, idx = impulse.sweep_system(MODEL, impulse.ImpulseParams(iterations=3), walk,
                                          impulse.init_lam((128,), dtype, device=cuda_device),
                                          dev(tgt))
        cases.append((sysw + [dev(0.5)], idx, 3, False))
        tr = oracle_traces.load("hurdle", dtype=dtype, device=cuda_device)
        for n in (256, 1):
            s = RobotState(*(x.expand((n,) + tuple(x.shape)) for x in tr.init))
            s = s._replace(joint_pos=s.joint_pos + dev(0.01 * rng.standard_normal((n, 12))))
            mu = dev(rng.uniform(0.4, 3.0, n))
            *sysb, idx = impulse.sweep_system(
                MODEL, impulse.ImpulseParams(mu=mu), s,
                impulse.init_lam((n,), dtype, scene=tr.scene, device=cuda_device),
                tr.targets[0], scene=tr.scene)
            assert bool(torch.isinf(sysb[7][:, 24:93:3]).any())  # box contacts active
            cases.append((sysb + [mu], idx, 10, dtype == torch.float32 and n > 1))
        for args, idx, iters, floor_gate in cases:
            before = pgs_cuda.pgs_sweep.launches
            got = pgs_cuda.pgs_sweep(*args, idx, iterations=iters)
            want = pgs_cuda.pgs_sweep_plain(*args, idx, iterations=iters)
            torch.cuda.synchronize()
            assert pgs_cuda.pgs_sweep.launches == before + 1
            assert got[0].shape == args[0].shape and got[1].shape == args[1].shape
            if floor_gate:
                exact = pgs_cuda.pgs_sweep_plain(*(x.double() for x in args), idx,
                                                 iterations=iters)
                floor = max(float((w.double() - e).abs().max()) for w, e in zip(want, exact))
                k_err = max(float((g.double() - e).abs().max()) for g, e in zip(got, exact))
                assert k_err <= 2.0 * floor + tol, (k_err, floor)
            else:
                for g, w in zip(got, want):
                    assert_close(g, w, rtol=0, atol=tol)
