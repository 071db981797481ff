"""The hard-contact plant of lifelike_tpu_torch against its golden traces,
and the env layer that reaches it (envs.playground with hard_contact,
envs.primitive.step_autoreset, envs.factory) against the JAX reference, on
the CPU.

Item 1 steps physics.impulse.control_step (the plain PGS sweep on the CPU)
in float64 over the golden hard-contact traces, walk / run / stand batched
as three robots with their own targets for all 50 control steps, hurdle
through its box scene for the first 10 (all 50 run on the card in
chip_smoke.py phase 8b), and holds the joint positions to the traces'
criterion max |dq| < 1e-5 rad; the port's copies of the traces are
byte-identical to the JAX package's. Item 2 holds one env step of every
factory bundle, the hard-contact playground step and the autoreset steps to
JAX at 1e-9 (float64, the same push and friction draws on both sides: the
states are carried over by compat.from_jax), the configs field by field,
and drives the EPMC closed loop on the hard-contact plant.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelike_tpu.envs import factory as jfactory
from lifelike_tpu.envs import primitive as jprimitive
from lifelike_tpu.motion import motion_lib as jml
from lifelike_tpu.physics.dynamics import RobotState as JRobotState
from lifelike_tpu_torch.bin import run_mpc
from lifelike_tpu_torch.compat import from_jax
from lifelike_tpu_torch.envs import factory, playground
from lifelike_tpu_torch.motion import motion_lib
from lifelike_tpu_torch.physics import impulse, oracle_traces
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.scene import playground_gen

from tests.test_torch_scene import _jax_env_state
from tests.torch_port_util import CPU, F64, assert_close, contact_scene, np_of, stand_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = build_max_model()
H = 50  # control steps of every golden trace
H_BOX = 10  # of the hurdle trace here (129 rows, ~0.3 s a step on the CPU);
# chip_smoke.py phase 8b runs all 50 through the CUDA kernel


def _check_trace_copies():
    for name in oracle_traces.NAMES:
        with open(os.path.join(REPO, "lifelike_tpu", "data", "oracle_traces",
                               f"{name}.npz"), "rb") as f:
            want = f.read()
        with open(oracle_traces.path(name), "rb") as f:
            assert f.read() == want, name


def test_plant_meets_golden_traces():
    _check_trace_copies()
    p = impulse.ImpulseParams()
    flat = [oracle_traces.load(n, device=CPU) for n in ("walk", "run", "stand")]
    s = type(flat[0].init)(*(torch.stack(x) for x in zip(*(t.init for t in flat))))
    targets = torch.stack([t.targets for t in flat], dim=1)  # (H, 3, 12) own targets
    want = np.stack([t.joint_pos for t in flat], axis=1)
    lam = impulse.init_lam((3,), F64, device=CPU)
    errs = []
    for t in range(H):
        s, lam = impulse.control_step(MODEL, p, s, lam, targets[t])
        errs.append(np.abs(np_of(s.joint_pos) - want[t]).max(-1))
    errs = np.stack(errs)  # (H, 3)
    assert errs.max() < 1e-5, errs[[0, 9, 24, 49]]

    tr = oracle_traces.load("hurdle", device=CPU)
    assert tr.scene is not None and tr.meta["scenario"] == "hurdle"
    s, lam = tr.init, impulse.init_lam((), F64, scene=tr.scene, device=CPU)
    errs = []
    for t in range(H_BOX):
        s, lam = impulse.control_step(MODEL, p, s, lam, tr.targets[t], scene=tr.scene)
        errs.append(float(np.abs(np_of(s.joint_pos) - tr.joint_pos[t]).max()))
    assert max(errs) < 1e-5, errs
    assert float(lam[24:93].abs().max()) > 0.0  # box rows carried impulses


def _same_config(got, want, path="cfg"):
    """Field by field: the same NamedTuple layout, equal leaves."""
    if hasattr(want, "_fields"):
        assert type(got).__name__ == type(want).__name__, path
        assert got._fields == want._fields, path
        for f in got._fields:
            _same_config(getattr(got, f), getattr(want, f), f"{path}.{f}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_config(g, w, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np_of(got) if torch.is_tensor(got) else np.asarray(got),
                                      np.asarray(want), err_msg=path)


def _tree_close(got, want, tol=1e-9):
    """Nested states: every leaf, in order, at rtol = atol = tol."""
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert_close(a, b, rtol=tol, atol=tol)


def _row(tree, i):
    """Batch row i of every leaf."""
    return jax.tree.map(lambda x: x[i], tree)


def _f64(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x, tree)


def _bundles(tmp_path):
    frames = motion_lib.make_synthetic_clip(240)
    clip = tmp_path / "clip.txt"
    clip.write_text(json.dumps({"FrameDuration": 1.0 / 120.0, "Frames": frames.tolist()}))
    env_config = dict(data_path=str(clip), kp=45.0, kd=0.8, max_tau=17.0, hard_contact=True,
                      env_randomize_config={"element_id": 1, "friction_range": (0.5, 2.0)})
    out = {}
    for name in ("tracking", "playground", "chase_tag"):
        jb = getattr(jfactory, f"create_{name}_game")(**env_config)
        b = getattr(factory, f"create_{name}_game")(device=CPU, **env_config)
        assert b.name == jb.name == name and b.num_agents == jb.num_agents
        _same_config(b.cfg, jb.cfg, name)
        out[name] = (jb, b)
    assert out["playground"][1].cfg.hard_contact and out["playground"][1].cfg.params.kp == 45.0
    return out, env_config


def _check_bundle_device(bundles, env_config):
    """A bundle runs on its own device only: built for the card, it refuses
    a generator or a state on the CPU instead of stepping there. With no
    card here the "meta" device stands in for it (as the card would be, it
    is not the CPU generator's device)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            factory.create_playground_game(device="cuda")
    for name, (_, cpu_bundle) in bundles.items():
        assert cpu_bundle.device == torch.device("cpu")
        s, _ = cpu_bundle.reset(torch.Generator().manual_seed(0), batch=(2,))
        b = getattr(factory, f"create_{name}_game")(device="meta", **env_config)
        assert b.device == torch.device("meta")
        a = torch.zeros((2, 2, 12) if name == "chase_tag" else (2, 12))
        a = {"A_LLC": a} if name == "chase_tag" else a
        for call in (lambda: b.reset(torch.Generator()), lambda: b.step(s, a, None),
                     lambda: b.step_autoreset(s, a, None)):
            with pytest.raises(ValueError, match="runs on meta; got a"):
                call()


def _check_tracking(jb, b, rng):
    """One tracking step vs JAX, then primitive.step_autoreset with row 1
    past its clip's end: row 0 is the step's, row 1 starts afresh."""
    jclips, clips = jb.clips, b.clips
    _same_config(clips, jclips, "clips")

    def start(t0):  # jitted: op by op JAX compiles every primitive
        f = jml.sample_frame(jclips, jnp.zeros(2, jnp.int32), t0)
        robot = JRobotState(*(jnp.asarray(x, jnp.float64) for x in f))
        prop = jprimitive._proprioception(robot)
        return jprimitive.PrimitiveEnvState(
            robot=robot, t=t0.astype(jnp.float64), clip_idx=jnp.zeros(2, jnp.int32),
            prop_hist=jnp.repeat(prop[:, None], jprimitive.STACK, axis=1),
            act_hist=jnp.zeros((2, jprimitive.STACK, jprimitive.ACTION_SIZE)),
            steps=jnp.asarray([4, 9], jnp.int32), ep_ret=jnp.asarray([1.5, 2.0]))

    jenv = jax.jit(start)(jnp.asarray([0.3, 1.6]))  # row 1 ends its clip this step
    env = from_jax.primitive_env_state(jenv, CPU, F64)
    a = 0.05 * rng.standard_normal((2, 12))
    jenv2, jobs, jr, jdone, jinfo = jax.jit(jb.step)(jenv, jnp.asarray(a))
    env2, obs, r, done, info = b.step(env, torch.as_tensor(a))
    _tree_close(env2, jenv2)
    _tree_close(obs, jobs)
    assert_close(r, jr, rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(done.numpy(), [False, True])
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))

    gen = torch.Generator().manual_seed(1)
    env3, obs3, r3, done3, _ = b.step_autoreset(env, torch.as_tensor(a), gen)
    assert_close(r3, jr, rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(done3.numpy(), [False, True])
    _tree_close(_row(env3, 0), _row(jenv2, 0))
    _tree_close(_row(obs3, 0), _row(jobs, 0))
    assert int(env3.steps[1]) == 0 and float(env3.ep_ret[1]) == 0.0
    assert float(env3.t[1]) < 1.6 and not bool(env3.act_hist[1].any())


def _check_playground(jb, b, rng):
    """The hard-contact playground step on a box course (every kind of box
    contact active) vs JAX: state, observation, reward, done, info; then
    step_autoreset: row 0 is the step's, row 1 (at its target) restarts.
    The reference's hard plant steps one robot (its box rows take a scene
    without batch axes), so JAX steps each row alone and the port both rows
    at once."""
    # the box table at the generator's capacity, so that a reset row fits it
    sd = contact_scene(MODEL, stand_state(pos=(0.0, 0.0, 0.36)), playground_gen.CAPACITY)
    js = _jax_env_state(rng, sd, (2,))
    s = from_jax.playground_state(js, CPU, F64)
    a = 0.05 * rng.standard_normal((2, 12))
    jstep = jax.jit(jb.step)
    want = [jstep(_row(js, i), jnp.asarray(a[i]), jax.random.PRNGKey(0)) for i in (0, 1)]
    got = b.step(s, torch.as_tensor(a), torch.Generator())
    for i, (js2, jobs, jr, jdone, jinfo) in enumerate(want):
        s2, obs, r, done, info = _row(got, i)
        _tree_close(s2, js2)
        _tree_close(obs, jobs)
        assert_close(r, jr, rtol=1e-9, atol=1e-9)
        assert bool(done) == bool(jdone) == (i == 1)  # row 1 reached its target
        for k in jinfo:
            assert_close(info[k], jinfo[k], rtol=1e-9, atol=1e-9)
    # the hard plant is not the compliant one on this course
    soft = playground.step(MODEL, b.cfg._replace(hard_contact=False), s, torch.as_tensor(a),
                           torch.Generator())[0]
    assert float((soft.robot.joint_pos - got[0].robot.joint_pos).abs().max()) > 1e-4

    gen = torch.Generator().manual_seed(2)
    s3, obs3, r3, done3, _ = b.step_autoreset(s, torch.as_tensor(a), gen)
    assert_close(r3, got[2], rtol=0, atol=0)
    _tree_close(_row(s3, 0), want[0][0])
    _tree_close(_row(obs3, 0), want[0][1])
    assert int(s3.counter[1]) == 0
    assert_close(s3.robot.base_pos[1], [0.0, 0.0, 0.5], rtol=0, atol=0)


def _check_chase_tag(jb, b, rng):
    """One Chase Tag step of the factory bundle vs JAX from a JAX reset."""
    js, _ = jax.jit(lambda k: jb.reset(k, batch=(2,)))(jax.random.PRNGKey(3))
    js = _f64(js)
    s = from_jax.chase_tag_state(js, CPU, F64)
    a = 0.05 * rng.standard_normal((2, 2, 12))
    js2, _, jr, jdone, _ = jax.jit(jb.step)(js, {"A_LLC": jnp.asarray(a)},
                                            jax.random.PRNGKey(0))
    s2, _, r, done, _ = b.step(s, {"A_LLC": torch.as_tensor(a)}, torch.Generator())
    _tree_close(s2.robots, js2.robots)
    assert_close(r, jr, rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))


def test_env_layer_matches_reference(tmp_path):
    rng = np.random.default_rng(61)
    bundles, env_config = _bundles(tmp_path)
    _check_bundle_device(bundles, env_config)
    _check_tracking(*bundles["tracking"], rng)
    _check_playground(*bundles["playground"], rng)
    _check_chase_tag(*bundles["chase_tag"], rng)
    # the EPMC closed loop on the hard-contact plant, on the CPU
    args = run_mpc.parse_args(["--task=epmc", "--element_id=1", "--device=cpu",
                               "--population=128", "--horizon=3", "--steps=2", "--seed=1"])
    cfg = playground.PlaygroundConfig(scene=playground_gen.PlaygroundConfig(element_id=1),
                                      hard_contact=True)
    out = run_mpc.run_epmc(args, log=lambda m: None, env_cfg=cfg)
    assert len(out["step_rewards"]) == 2 and np.isfinite(out["step_rewards"]).all()
    assert len(out["t_plant"]) == 2
