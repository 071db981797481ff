"""Heightmap terrain on the tile-layout MPC path of lifelike_tpu_torch vs the
JAX reference, on the CPU.

The tile-layout engine, the tracking rollout, mppi_step, the receding-horizon
controller and the sharded step take a `terrain_fn` in the reference's
position: p (4, 3, Bs, L) -> (heights (4, Bs, L), normals (4, 3, Bs, L)).
Neither package has a tile-layout heightmap, so each side here wraps its own
scene.boxes.heightmap_at in a small adapter that moves the tile axes around
it. The scene is a low platform (the robot stands on its top) with a step
3 mm up under one front foot. float64 throughout: the engine, the rollout and
mppi_step (fed the normals JAX draws and JAX's own reference) at 1e-9, the
controller, which interpolates the float32 clip itself, at 1e-8 (see
tests/test_torch_traversal.py). A terrain never reaches the K1 wrapper; an
explicit plane gives exactly the plane's costs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from lifelike_tpu.motion import motion_lib as jml
from lifelike_tpu.physics import batched as JB
from lifelike_tpu.physics import engine as jengine
from lifelike_tpu.physics import engine_tl as jengine_tl
from lifelike_tpu.physics.dynamics import RobotState as JRobotState
from lifelike_tpu.robot.model import build_max_model as j_build_max_model
from lifelike_tpu.scene import boxes as jboxes
from lifelike_tpu.solver import mppi as jmppi
from lifelike_tpu.solver import mppi_tl as jmppi_tl
from lifelike_tpu.solver import rollout_tl as jrollout_tl
from lifelike_tpu_torch.compat import from_jax
from lifelike_tpu_torch.ops import rollout_cuda
from lifelike_tpu_torch.parallel import mesh as meshlib
from lifelike_tpu_torch.parallel import sharded_solve
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.physics import dynamics, engine_tl
from lifelike_tpu_torch.physics.dynamics import RobotState
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.scene import boxes
from lifelike_tpu_torch.solver import mppi, mppi_tl, rollout_tl

from tests.torch_port_util import CPU, F64, assert_close, assert_tree_close, random_robot_state

JMODEL = j_build_max_model()
MODEL = build_max_model()
H, L = 3, 128  # horizon, population 128
TOP = 0.1  # the platform's top (m)


def tile_heightmap(scene):
    """The port's tile-layout heightmap: boxes.heightmap_at with the tile
    axes moved behind the legs."""
    def fn(p):  # (4, 3, Bs, L)
        h = boxes.heightmap_at(scene, p[:, :2].permute(2, 3, 0, 1)).permute(2, 0, 1)
        n = torch.zeros_like(p)
        n[:, 2] = 1.0
        return h, n
    return fn


def jtile_heightmap(scene):
    """The same adapter around the JAX package's heightmap_at."""
    def fn(p):
        h = jnp.moveaxis(jboxes.heightmap_at(scene, jnp.moveaxis(p[:, :2], (0, 1), (2, 3))),
                         2, 0)
        return h, jnp.zeros_like(p).at[:, 2].set(1.0)
    return fn


def tile_plane(p):
    """An explicit plane: heights 0, normals +z."""
    n = torch.zeros_like(p)
    n[:, 2] = 1.0
    return torch.zeros_like(p[:, 0]), n


def _robot(rng, batch):
    """Perturbed standing states on the platform (numpy, float64)."""
    d = random_robot_state(rng, batch=batch, vel_noise=0.05)
    d["base_pos"] = d["base_pos"] + np.array([0.0, 0.0, TOP])
    return d


def _scenes(rng):
    """(JAX scene, port scene): the platform (half extents 2 x 2 x 0.05 m,
    centre z 0.05, as tests/test_box_contact.py's) and a 3 mm step under
    front foot 0 of the unperturbed stance, in a table of 4 slots with one
    inactive box under the robot (its top must not count)."""
    d = _robot(np.random.default_rng(0), (1,))
    rs = RobotState(*(torch.as_tensor(d[f][0]) for f in RobotState._fields))
    foot = dynamics.forward_kinematics(MODEL, rs).p_foot[0].numpy()
    center = np.array([[0.0, 0.0, 0.05], [foot[0], foot[1], TOP - 0.02],
                       [0.0, 0.0, 0.3], [3.0, 0.0, 0.2]])
    half = np.array([[2.0, 2.0, 0.05], [0.06, 0.06, 0.023], [0.5, 0.5, 0.3], [0.1, 1.0, 0.2]])
    active = np.array([True, True, False, True])
    tgt = np.zeros(3)
    js = jboxes.BoxScene(jnp.asarray(center), jnp.asarray(half), jnp.asarray(active),
                         jnp.asarray(tgt))
    return js, from_jax.box_scene(js, CPU, F64)


def _tl_pair(d):
    jtl = JB.tl_from_state(JRobotState(**{k: jnp.asarray(v) for k, v in d.items()}))
    return jtl, from_jax.tl_state(jtl, CPU, F64)


def _check_engine(rng, jscene, scene):
    """engine_tl.control_step on the heightmap, a (2, 4) tile of states
    standing on the platform, exact and frozen mass."""
    d = _robot(rng, (2, 4))
    jtl = JB.tl_from_state(JRobotState(**{k: jnp.asarray(v) for k, v in d.items()}),
                           batch2d=(2, 4))
    tl = from_jax.tl_state(jtl, CPU, F64)
    tgt = d["joint_pos"].reshape(2, 4, 4, 3).transpose(2, 3, 0, 1) + 0.05 * rng.standard_normal(
        (4, 3, 2, 4))
    jc = JB.tl_constants(JMODEL, dtype=jnp.float64)
    c = B.tl_constants(MODEL, dtype=F64, device=CPU)
    for freeze in (1, 2):
        jp = jengine.PhysicsParams(substeps=2, mass_freeze=freeze)
        want = jax.jit(lambda s, u: jengine_tl.control_step(
            jc, jp, s, u, jtile_heightmap(jscene)))(jtl, jnp.asarray(tgt))
        got = engine_tl.control_step(c, from_jax.physics_params(jp), tl, torch.as_tensor(tgt),
                                     tile_heightmap(scene))
        assert_tree_close(got, want, rtol=1e-9, atol=1e-9)
        # the feet stand on the heightmap: on the plane the robots drop
        flat = engine_tl.control_step(c, from_jax.physics_params(jp), tl, torch.as_tensor(tgt))
        assert float((flat.base_lin_vel - got.base_lin_vel).abs().max()) > 1e-2


def _inputs(rng):
    """Both packages' solve inputs, float64: JAX's reference trajectory on the
    synthetic clip (handed to the port as it is), one start state on the
    platform, a warm start, the normals of two MPPI iterations."""
    cfg = jmppi.MPPIConfig(horizon=H, population=L, iterations=2, sigma=0.1)
    jp = jengine.PhysicsParams(substeps=2)
    jclips = jml.pack_clips([jml.make_synthetic_clip(480)], frame_step=1.0 / 120.0)
    jtl, tl = _tl_pair(_robot(rng, (1,)))
    jref = jax.jit(lambda t: jrollout_tl.precompute_reference(
        JMODEL, jclips, jnp.asarray(0), t, H, jp.dt * jp.substeps))(jnp.asarray(0.3, jnp.float64))
    u0 = 0.05 * rng.standard_normal((H, 4, 3))
    key = jax.random.PRNGKey(9)
    eps = [torch.as_tensor(np.array(jax.random.normal(k, (H, 4, 3, 1, L), jnp.float64)))
           for k in jax.random.split(key, cfg.iterations)]
    return dict(cfg=cfg, jp=jp, jclips=jclips, jtl=jtl, tl=tl, jref=jref, u0=u0, key=key,
                eps=eps, pcfg=mppi.MPPIConfig(*cfg), pp=from_jax.physics_params(jp),
                ref=from_jax.ref_traj(jref, CPU, F64),
                jc=JB.tl_constants(JMODEL, dtype=jnp.float64),
                c=B.tl_constants(MODEL, dtype=F64, device=CPU))


class _K1Calls:
    """Stands in for the K1 wrapper and counts the calls that reach it."""

    def __init__(self, monkeypatch):
        self.calls, self.wrapped = 0, rollout_cuda.rollout_tracking_fused
        monkeypatch.setattr(rollout_cuda, "rollout_tracking_fused", self)

    def __call__(self, *a, **k):
        self.calls += 1
        return self.wrapped(*a, **k)


def _check_rollout_and_mppi_step(x, jscene, scene, k1):
    """rollout_tracking and mppi_step with the heightmap vs JAX; an explicit
    plane gives bitwise the plane's costs; only the plane reaches K1."""
    rng = np.random.default_rng(3)
    u = 0.05 * rng.standard_normal((H, 4, 3, 1, L))
    jstate = jax.tree.map(lambda a: jnp.broadcast_to(a, a.shape[:-2] + (1, L)), x["jtl"])
    jterrain = jtile_heightmap(jscene)

    @jax.jit
    def jax_side(uc, key, u0):
        cost, final = jrollout_tl.rollout_tracking(x["jc"], x["jp"], jstate, uc, x["jref"],
                                                   jterrain)
        return cost, final, jmppi_tl.mppi_step(x["jc"], x["jp"], x["cfg"], key, x["jtl"], u0,
                                               x["jref"], jterrain)

    want, want_final, (jplan, jdiag) = jax_side(jnp.asarray(u), x["key"], jnp.asarray(x["u0"]))
    terrain = tile_heightmap(scene)
    got, got_final = rollout_tl.rollout_tracking(x["c"], x["pp"], x["tl"], torch.as_tensor(u),
                                                 x["ref"], terrain)
    assert_close(got, want, rtol=1e-9, atol=1e-9)
    assert_tree_close(got_final, want_final, rtol=1e-9, atol=1e-9)
    plane, _ = rollout_tl.rollout_tracking(x["c"], x["pp"], x["tl"], torch.as_tensor(u), x["ref"])
    explicit, _ = rollout_tl.rollout_tracking(x["c"], x["pp"], x["tl"], torch.as_tensor(u),
                                              x["ref"], tile_plane)
    assert torch.equal(explicit, plane)
    assert float((plane - got).abs().max()) > 1e-3  # the heightmap changes the costs

    calls = k1.calls
    plan, diag = mppi_tl.mppi_step(x["c"], x["pp"], x["pcfg"], None, x["tl"],
                                   torch.as_tensor(x["u0"]), x["ref"], terrain, eps=x["eps"])
    assert k1.calls == calls  # a terrain never reaches K1
    assert_close(plan, jplan, rtol=1e-9, atol=1e-9)
    for k in ("best_cost", "weighted_cost"):
        assert_close(diag[k], jdiag[k], rtol=1e-9, atol=1e-9)
    # an explicit plane on the eager route vs the K1 route (its plain version here)
    eplan, ediag = mppi_tl.mppi_step(x["c"], x["pp"], x["pcfg"], None, x["tl"],
                                     torch.as_tensor(x["u0"]), x["ref"], tile_plane, eps=x["eps"])
    assert k1.calls == calls
    kplan, kdiag = mppi_tl.mppi_step(x["c"], x["pp"], x["pcfg"], None, x["tl"],
                                     torch.as_tensor(x["u0"]), x["ref"], eps=x["eps"])
    assert k1.calls == calls + 2  # one K1 call per MPPI iteration
    assert torch.equal(eplan, kplan) and torch.equal(ediag["best_cost"], kdiag["best_cost"])
    return plan, diag


def _check_sharded_step(x, scene, plan, diag, k1):
    """The sharded step with the heightmap in a world of one: the plan of
    mppi_step, K1 untouched."""
    calls = k1.calls
    u, d = sharded_solve.sharded_mppi_step(meshlib.make_mesh(CPU), x["c"], x["pp"], x["pcfg"],
                                           None, x["tl"], torch.as_tensor(x["u0"]), x["ref"],
                                           tile_heightmap(scene), eps=x["eps"])
    assert k1.calls == calls
    assert_close(u, plan, rtol=1e-12, atol=1e-12)
    assert_close(d["weighted_cost"], diag["weighted_cost"], rtol=1e-12, atol=1e-12)
    assert_close(d["best_cost"], diag["best_cost"], rtol=0, atol=0)


def _check_controller(x, jscene, scene, k1):
    """make_mpc_controller on the heightmap, two receding-horizon solves
    from a state on the platform, vs JAX's."""
    cfg = x["cfg"]._replace(iterations=1)
    jctrl = jmppi_tl.make_mpc_controller(JMODEL, x["jc"], x["jp"], x["jclips"], cfg,
                                         terrain_fn=jtile_heightmap(jscene))
    ctrl = mppi_tl.make_mpc_controller(MODEL, x["c"], x["pp"],
                                       from_jax.motion_clips(x["jclips"], device=CPU),
                                       mppi.MPPIConfig(*cfg), terrain_fn=tile_heightmap(scene),
                                       device=CPU)
    d = _robot(np.random.default_rng(4), ())
    jrobot = JRobotState(**{k: jnp.asarray(v) for k, v in d.items()})
    robot = from_jax.robot_state(jrobot, CPU, F64)
    ju, u = jnp.zeros((H, 4, 3)), torch.zeros((H, 4, 3), dtype=F64)
    calls = k1.calls
    for i in range(2):
        k = jax.random.PRNGKey(20 + i)
        t = 0.3 + 0.02 * i
        jtgt, ju, jdiag = jctrl(k, jrobot, jnp.asarray(0), jnp.asarray(t, jnp.float64), ju)
        eps = [torch.as_tensor(np.array(jax.random.normal(k1_, (H, 4, 3, 1, L), jnp.float64)))
               for k1_ in jax.random.split(k, 1)]
        tgt, u, diag = ctrl(None, robot, 0, torch.tensor(t, dtype=F64), u, eps=eps)
        for got, want in ((tgt, jtgt), (u, ju), (diag["best_cost"], jdiag["best_cost"]),
                          (diag["weighted_cost"], jdiag["weighted_cost"])):
            assert_close(got, want, rtol=1e-8, atol=1e-8)
    assert k1.calls == calls
    assert float(u.abs().max()) > 1e-3  # the plan moved


# Each test file of the port holds at most two test items: pytest-xdist's
# loadfile scheduler queues files by item count, so files this small run
# after the long reference files and do not lengthen the tier-1 run.


def test_tile_engine_and_rollout_on_heightmap_match_reference(monkeypatch):
    jscene, scene = _scenes(np.random.default_rng(1))
    _check_engine(np.random.default_rng(2), jscene, scene)
    k1 = _K1Calls(monkeypatch)
    x = _inputs(np.random.default_rng(5))
    plan, diag = _check_rollout_and_mppi_step(x, jscene, scene, k1)
    _check_sharded_step(x, scene, plan, diag, k1)


def test_tile_controller_on_heightmap_matches_reference(monkeypatch):
    jscene, scene = _scenes(np.random.default_rng(1))
    k1 = _K1Calls(monkeypatch)
    _check_controller(_inputs(np.random.default_rng(6)), jscene, scene, k1)
