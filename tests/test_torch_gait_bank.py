"""The EPMC gait bank of lifelike_tpu_torch vs the JAX reference, on the CPU.

Item 1: the gait variants of motion_lib (numpy, bitwise equal to JAX's) and
the multigait traversal controller against JAX's (XLA path, fused=False) in
float64 at 1e-8 — two priors (default weights; crawl weights with speed
scale 0.9 and their own gait weight), force_sel -1 then 1, the normals JAX
draws from its per-prior key splits injected — plus the prior selection's
NaN and tie rules against jnp.argmin.

Item 2: the make_eval twin's host functions against tools/make_eval.py's on
constructed scenes (gating for elements 1-3 under both cube skills, the
approach cap, both clip-time protocols, the opt-in speed floors), its prior
bank for elements 1-3 against the JAX tool's (the synthetic walk / jump
frames written as clip files for it), and 3 CPU control steps of
eval_traversal and of debug_traversal at population 64, H 3.
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelike_tpu.costs import traversal as jtraversal
from lifelike_tpu.motion import motion_lib as jml
from lifelike_tpu.physics import batched as JB
from lifelike_tpu.physics import engine as jengine
from lifelike_tpu.physics.dynamics import RobotState as JRobotState
from lifelike_tpu.robot.model import build_max_model as j_build_max_model
from lifelike_tpu.scene import boxes as jboxes
from lifelike_tpu.solver import mpc_tasks as jmpc_tasks
from lifelike_tpu.solver import mppi as jmppi
from lifelike_tpu_torch.compat import from_jax
from lifelike_tpu_torch.costs import traversal
from lifelike_tpu_torch.motion import motion_lib
from lifelike_tpu_torch.ops import traversal_cuda
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.solver import mpc_tasks, mppi
from lifelike_tpu_torch.tools import debug_traversal
from lifelike_tpu_torch.tools import make_eval as me

from tests.torch_port_util import CPU, F64, assert_close, contact_scene, stand_state

JMODEL = j_build_max_model()
MODEL = build_max_model()
H, L = 3, 64  # horizon, population
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRAWL = dict(height_min=0.14, height=8.0, pose=0.0, crawl_gap=0.18, ceiling=0.20)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check_variants():
    walk = jml.make_synthetic_clip(480)
    lo, hi = np.asarray(JMODEL.joint_lower), np.asarray(JMODEL.joint_upper)
    np.testing.assert_array_equal(MODEL.joint_lower.reshape(-1), lo.reshape(-1))
    np.testing.assert_array_equal(motion_lib.make_synthetic_clip(480), walk)
    for name, kw in (("crouch_variant", dict(hip_delta=0.4, knee_delta=1.1)),
                     ("crouch_variant", dict(drop=0.2)),
                     ("crawl_variant", dict()),
                     ("crawl_variant", dict(gain=0.5, base_height=0.15)),
                     ("highstep_variant", dict(gain=2.2, lift=0.14)),
                     ("highstep_variant", dict())):
        for limits in ({}, dict(joint_lower=lo, joint_upper=hi)):
            got = getattr(motion_lib, name)(walk, **kw, **limits)
            want = getattr(jml, name)(walk, **kw, **limits)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {kw} {bool(limits)}")


def _check_select_prior():
    for costs in ([1.0, np.nan, 0.0, np.nan], [2.0, 0.0, 0.0], [np.inf, 3.0], [np.nan]):
        want = int(jnp.argmin(jnp.asarray(costs)))
        assert int(mpc_tasks.select_prior(torch.tensor(costs, dtype=F64))) == want, costs
        assert int(mpc_tasks.select_prior(torch.tensor(costs, dtype=F64), 0)) == 0


def _check_multigait_controller():
    """Two replans (the second from the first's warm starts) of the port's
    multigait controller against JAX's, float64, normals injected."""
    rng = np.random.default_rng(61)
    jp = jengine.PhysicsParams(kd=1.0, max_tau=16.0, substeps=1, mass_freeze=1)
    pp = from_jax.physics_params(jp)
    cfg = jmppi.MPPIConfig(horizon=H, population=L, iterations=1, sigma=0.15)
    pcfg = mppi.MPPIConfig(*cfg)
    jc = JB.tl_constants(JMODEL, dtype=jnp.float64)
    c = B.tl_constants(MODEL, dtype=F64, device=CPU)
    walk = jml.make_synthetic_clip(480)
    jclips = jml.pack_clips([walk, jml.crawl_variant(walk)], frame_step=1.0 / 120.0)
    clips = from_jax.motion_clips(jclips, device=CPU)
    st = stand_state(pos=(0.0, 0.0, 0.36), vel=(0.5, 0.0, 0.0))
    st["joint_vel"] = 0.1 * rng.standard_normal(12)
    sd = contact_scene(MODEL, st, capacity=16)
    jrobot = JRobotState(**{k: jnp.asarray(v) for k, v in st.items()})
    jscene = jboxes.BoxScene(**{k: jnp.asarray(v) for k, v in sd.items()})
    robot = from_jax.robot_state(jrobot, CPU, F64)
    scene = from_jax.box_scene(jscene, CPU, F64)
    jpriors = [(0, None), (1, jtraversal.TraversalWeights(**CRAWL), 0.9, 0.7)]
    priors = [(0, None), (1, traversal.TraversalWeights(**CRAWL), 0.9, 0.7)]
    jctrl = jmpc_tasks.make_multigait_traversal_controller(
        JMODEL, jc, jp, cfg, jclips, jpriors, reward_type="average_speed", gait_weight=1.2)
    ctrl = mpc_tasks.make_multigait_traversal_controller(
        MODEL, c, pp, pcfg, clips, priors, reward_type="average_speed", gait_weight=1.2,
        device=CPU)
    shape = (H, 4, 3, 1, L)

    def eps_of(key):
        """JAX's normals: one key split per prior, then one per iteration."""
        out = []
        for _ in priors:
            key, k = jax.random.split(key)
            out.append([torch.as_tensor(np.array(jax.random.normal(ki, shape, jnp.float64)))
                        for ki in jax.random.split(k, cfg.iterations)])
        return out

    ju = jnp.zeros((2, H, 4, 3))
    u = torch.zeros((2, H, 4, 3), dtype=F64)
    tp = torch.as_tensor(sd["target_pos"])
    before = traversal_cuda.rollout_traversal_fused.launches
    for i, force in enumerate((-1, 1)):
        key = jax.random.PRNGKey(20 + i)
        t_clips = np.array([0.3 + 0.02 * i, 0.5 + 0.02 * i])
        jtgt, ju, jsel, jdiag = jctrl(key, jrobot, jscene, jscene.target_pos, jnp.asarray(1.1),
                                      jnp.asarray(t_clips), ju, jnp.asarray(force, jnp.int32))
        tgt, u, sel, diag = ctrl(None, robot, scene, tp, torch.tensor(1.1, dtype=F64),
                                 torch.as_tensor(t_clips), u, force, eps=eps_of(key))
        assert int(sel) == int(jsel) and (force < 0 or int(sel) == force)
        # 1e-8: the gait term reads the float32 clip's finite differences,
        # which jitted XLA rounds differently (tests/test_torch_traversal.py)
        for got, want in ((tgt, jtgt), (u, ju), (diag["prior_costs"], jdiag["prior_costs"])):
            assert_close(got, want, rtol=1e-8, atol=1e-8)
    assert traversal_cuda.rollout_traversal_fused.launches == before  # plain version on the CPU
    assert float(u.abs().max()) > 1e-3  # the plans moved
    pc = diag["prior_costs"]
    assert bool(torch.isfinite(pc).all()) and float((pc[0] - pc[1]).abs()) > 1e-6


def test_gait_variants_and_multigait_controller_match_reference():
    _check_variants()
    _check_select_prior()
    _check_multigait_controller()


class _Scene:
    """A constructed course: a ground plane, a hole bar (bottom 0.25, top
    0.35), a 0.1 m apron, a 0.25 m cube and an inactive tall box."""

    def __init__(self):
        self.center = np.array([[0.0, 0.0, -1.0], [3.0, 0.0, 0.30], [5.0, 0.0, 0.05],
                                [6.0, 0.0, 0.125], [8.0, 0.0, 0.2]], np.float32)
        self.half = np.array([[50.0, 50.0, 1.0], [0.05, 1.0, 0.05], [0.4, 1.0, 0.05],
                              [0.3, 1.0, 0.125], [0.2, 1.0, 0.2]], np.float32)
        self.active = np.array([True, True, True, True, False])


def _write_clip(path, frames):
    with open(path, "w") as f:
        json.dump({"FrameDuration": 1.0 / 120.0, "Frames": frames.tolist()}, f)


def _check_host_functions(jme, monkeypatch):
    scene = _Scene()
    xs = np.arange(-1.0, 8.0, 0.05)
    for cube_skill in (None, "highstep", "mantle"):
        if cube_skill is None:
            monkeypatch.delenv("LIFELIKE_CUBE_SKILL", raising=False)
        else:
            monkeypatch.setenv("LIFELIKE_CUBE_SKILL", cube_skill)
        for eid in (0, 1, 2, 3):
            for x in xs:
                base = np.array([x, 0.0, 0.3])
                assert me.gate_skill(scene, base, eid) == jme.gate_skill(scene, base, eid)
                assert me.approach_speed_cap(scene, base, eid, 1.3) == \
                    jme.approach_speed_cap(scene, base, eid, 1.3)
    # the cube gating of the unset variable is the mantle's (top > 0.15:
    # the 0.1 m apron is not gated), the bank's the high step (note R7)
    monkeypatch.delenv("LIFELIKE_CUBE_SKILL", raising=False)
    assert me.gate_skill(scene, np.array([4.5, 0.0, 0.3]), 3) == 0
    for skill in (dict(kind="loop", loop=(0.5, 4.5)),
                  dict(kind="play", t0=0.7, end=2.4, rewind=0.06)):
        for t in (0.0, 0.7, 1.5, 2.39, 2.4, 4.49, 4.6):
            for engaged in (False, True):
                assert me.advance_skill_clip(t, skill, engaged) == \
                    jme.advance_skill_clip(t, skill, engaged)
    for var in ("LIFELIKE_CLIMB_SPD", "LIFELIKE_CRAWL_SPD", "LIFELIKE_WALK_SPD_FLOOR"):
        monkeypatch.setenv(var, "1.25")
    for eid in (1, 2, 3):
        for gate in (-1, 0, 1):
            for x in (0.0, 2.5):
                base = np.array([x, 0.0, 0.3])
                got = me.skill_speed_floor(scene, base, eid, gate, torch.tensor(0.9))
                want = jme.skill_speed_floor(scene, base, eid, gate, jnp.asarray(0.9))
                assert float(got) == pytest.approx(float(want), abs=1e-7), (eid, gate, x)
    for var in ("LIFELIKE_CLIMB_SPD", "LIFELIKE_CRAWL_SPD", "LIFELIKE_WALK_SPD_FLOOR"):
        monkeypatch.delenv(var)
    assert me.parse_models("pmc=a.model,sepmc=b.model") == {"pmc": "a.model",
                                                              "sepmc": "b.model"}
    with pytest.raises(ValueError):
        me.parse_models("pmc")


def _check_prior_bank(jme, tmp_path, monkeypatch):
    """The bank for elements 1-3 against the JAX tool's, which reads its walk
    / jump clips from files: the port's synthetic clips, written as such."""
    monkeypatch.delenv("LIFELIKE_CUBE_SKILL", raising=False)
    for name, seed in (("WALK_CLIP", me.WALK_SEED), ("JUMP_CLIP", me.JUMP_SEED)):
        path = str(tmp_path / f"{name}.txt")
        _write_clip(path, me.clip_frames(me.SYNTHETIC, seed))
        monkeypatch.setattr(jme, name, path)
    for eid in (1, 2, 3):
        clips, priors, skill = me.build_prior_bank(MODEL, eid, device=CPU)
        jclips, jpriors, jskill = jme.build_prior_bank(JMODEL, eid)
        np.testing.assert_array_equal(clips.frames.numpy(), np.asarray(jclips.frames))
        np.testing.assert_array_equal(clips.lengths.numpy(), np.asarray(jclips.lengths))
        assert (clips.frame_step, clips.margin) == (jclips.frame_step, jclips.margin)
        assert [(p[0],) + tuple(p[2:]) for p in priors] == \
            [(p[0],) + tuple(p[2:]) for p in jpriors]
        assert [None if len(p) < 2 or p[1] is None else tuple(p[1]) for p in priors] == \
            [None if len(p) < 2 or p[1] is None else tuple(p[1]) for p in jpriors]
        assert skill == jskill
    assert priors == [(0, None), (3, None)]  # element 3, the variable unset: the high step
    assert clips.num_clips == 6 and int(clips.lengths[4]) == 3 * 142  # the crawl tiled 3x
    for name in ("hole_crawl", "cube_mantle"):  # the port's copies: the same frames
        with open(os.path.join(me.PRIOR_DIR, f"{name}.json")) as f:
            got = json.load(f)
        with open(os.path.join(REPO, "lifelike_tpu", "data", "priors", f"{name}.json")) as f:
            want = json.load(f)
        assert got["Frames"] == want["Frames"] and got["FrameDuration"] == want["FrameDuration"]


def _check_closed_loops(capsys):
    """3 control steps of eval_traversal (the hole course: the crawl prior
    and the gating) and of debug_traversal on the CPU."""
    before = traversal_cuda.rollout_traversal_fused.launches
    res = me.eval_traversal(1, 3, 2, L, H, device=CPU)
    (r,) = res
    assert r["steps"] == 3 and len(r["sel"]) == 3 and set(r["sel"]) <= {0, 1}
    assert r["outcome"] in ("timeout", "fall", "reached")
    assert np.isfinite(r["reward"]) and np.isfinite(r["progress"])
    assert len(r["solve_ms"]) == len(r["plant_ms"]) == 3
    _, done = debug_traversal.main(["--device=cpu", "--element=1", f"--population={L}",
                                    f"--horizon={H}", "--cap=2", "--log_every=1"])
    assert "t=   1" in capsys.readouterr().out
    assert traversal_cuda.rollout_traversal_fused.launches == before


def test_make_eval_host_functions_bank_and_loop_match_reference(tmp_path, monkeypatch, capsys):
    jme = _jax_tool("make_eval")
    _check_host_functions(jme, monkeypatch)
    _check_prior_bank(jme, tmp_path, monkeypatch)
    _check_closed_loops(capsys)
