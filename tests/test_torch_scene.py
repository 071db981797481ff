"""Scene queries, box contact, the box-contact plant and the playground env
of lifelike_tpu_torch vs the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages, float64
throughout: the SDF, perception and prune geometry are held at 1e-12, the
contact forces, the physics with boxes and the playground step (plant,
reward, done, observation) at 1e-9. The corridor prune must pick the same
boxes as jax.lax.top_k where distances tie. Random parts (scene generation,
reset, pushes, joystick re-targeting) draw from a torch.Generator, which
never agrees with jax.random; they are held by their invariants and
statistics, and the deterministic step is compared from a state in which no
draw acts (no re-target due, the push mid-interval).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lifelike_tpu.envs import playground as jplayground
from lifelike_tpu.envs import randomizer as jrandomizer
from lifelike_tpu.physics import batched as JB
from lifelike_tpu.physics import contact as jcontact
from lifelike_tpu.physics import engine as jengine
from lifelike_tpu.physics import engine_tl as jengine_tl
from lifelike_tpu.physics.dynamics import RobotState as JRobotState
from lifelike_tpu.robot.model import build_max_model as j_build_max_model
from lifelike_tpu.scene import boxes as jboxes
from lifelike_tpu_torch.bin import run_mpc
from lifelike_tpu_torch.compat import from_jax
from lifelike_tpu_torch.envs import playground, randomizer
from lifelike_tpu_torch.physics import batched as B
from lifelike_tpu_torch.physics import contact, engine, engine_tl
from lifelike_tpu_torch.physics.contact import ContactParams
from lifelike_tpu_torch.physics.dynamics import RobotState
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.scene import boxes, playground_gen

from tests.torch_port_util import (
    CPU,
    F64,
    assert_close,
    assert_tree_close,
    contact_scene,
    random_robot_state,
    stand_state,
)

JMODEL = j_build_max_model()
MODEL = build_max_model()


def T(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def _geometry_inputs(rng):
    """numpy inputs of the geometry and contact checks."""
    sd = contact_scene(MODEL, stand_state(pos=(0.0, 0.0, 0.36)))
    c, h = np.array([0.0, 0.0, 1.0]), np.array([1.0, 2.0, 1.0])
    ties = np.array([
        [0.5, 1.5, 1.0],  # inside, x and y faces tied: normal (1/2, 1/2, 0)
        [0.5, 1.5, 1.5],  # inside, all three tied: (1/3, 1/3, 1/3)
        [-0.9, 0.0, 1.0],  # inside, -x face nearest
        [2.0, 3.0, 1.0],  # outside, edge region
    ])
    dirs = rng.standard_normal((30, 3))
    dirs[:3] = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, -1.0]]  # axis-parallel rays
    # three poses near the boxes and one far away, where every lidar ray misses
    yaw = rng.uniform(0, 2 * np.pi, 4)
    orn = np.stack([0.05 * rng.standard_normal(4), 0.05 * rng.standard_normal(4),
                    np.sin(yaw / 2), np.cos(yaw / 2)], -1)
    return dict(
        box_c=c, box_h=h, sdf_pts=np.concatenate([c + rng.uniform(-2.5, 2.5, (64, 3)), ties]),
        sph_pos=sd["center"][:7][rng.integers(0, 7, 20)] + rng.uniform(-0.12, 0.12, (20, 3)),
        sph_vel=rng.standard_normal((20, 3)), sph_mu=rng.uniform(0.4, 3.0, (20,)),
        xy=rng.uniform(-0.5, 0.8, (40, 2)),
        ray_o=rng.uniform(-0.3, 0.3, (30, 3)) + [0.0, 0.0, 0.2],
        ray_d=dirs / np.linalg.norm(dirs, axis=-1, keepdims=True),
        pose_pos=np.array([[0.0, 0.0, 0.36], [0.1, -0.05, 0.3], [0.3, 0.1, 0.4],
                           [30.0, 40.0, 0.4]]),
        pose_yaw=yaw, pose_orn=orn / np.linalg.norm(orn, axis=-1, keepdims=True),
        **{"scene_" + k: v for k, v in sd.items()},
    )


def _jax_geometry(x):
    """Every JAX result the geometry checks compare with (one jit)."""
    scene = jboxes.BoxScene(*(x["scene_" + k] for k in jboxes.BoxScene._fields))
    cp = jcontact.ContactParams()
    out = {}
    out["sdf"] = jcontact.box_sdf(x["box_c"], x["box_h"], x["sdf_pts"])
    out["force"] = jcontact.sphere_boxes_force(x["sph_pos"], x["sph_vel"], 0.025, scene.center,
                                               scene.half, scene.active, cp, x["sph_mu"])
    tpos = x["sph_pos"].reshape(5, 4, 3).transpose(0, 2, 1)[..., None]
    tvel = x["sph_vel"].reshape(5, 4, 3).transpose(0, 2, 1)[..., None]
    out["force_tl"] = jengine_tl.sphere_boxes_force(tpos, tvel, 0.025,
                                                    jengine_tl.tl_scene(scene), cp, 0.8)
    out["height"] = jboxes.heightmap_at(scene, x["xy"])
    out["ray"] = jboxes.ray_box_distance(scene, x["ray_o"], x["ray_d"], 3.0)
    out["lidar"] = jboxes.lidar(scene, x["pose_pos"], x["pose_yaw"])
    out["p2d"] = jboxes.perception_height(scene, x["pose_pos"], x["pose_orn"])
    out["front"] = jboxes.perception_front(scene, x["pose_pos"], x["pose_orn"])
    return out


def _check_geometry(rng):
    """Box SDF (incl. tied faces), sphere-box forces (readable and tile),
    heightmap, ray casts, lidar (incl. the miss quirk), the perception
    grids."""
    x = _geometry_inputs(rng)
    want = jax.jit(_jax_geometry)({k: jnp.asarray(v) for k, v in x.items()})
    scene = boxes.BoxScene(*(T(x["scene_" + k]) for k in ("center", "half")),
                           torch.as_tensor(x["scene_active"]), T(x["scene_target_pos"]))
    cp = ContactParams()
    d, n = contact.box_sdf(T(x["box_c"]), T(x["box_h"]), T(x["sdf_pts"]))
    assert_close(d, want["sdf"][0], rtol=1e-12, atol=1e-12)
    assert_close(n, want["sdf"][1], rtol=1e-12, atol=1e-12)
    assert_close(n[64:66], [[0.5, 0.5, 0.0], [1 / 3, 1 / 3, 1 / 3]], rtol=0, atol=1e-15)
    got = contact.sphere_boxes_force(T(x["sph_pos"]), T(x["sph_vel"]), 0.025, scene.center,
                                     scene.half, scene.active, cp, T(x["sph_mu"]))
    assert_close(got, want["force"], rtol=1e-9, atol=1e-9)
    assert float(got.abs().max()) > 1.0  # contact is live
    tpos = T(x["sph_pos"]).reshape(5, 4, 3).permute(0, 2, 1)[..., None]
    tvel = T(x["sph_vel"]).reshape(5, 4, 3).permute(0, 2, 1)[..., None]
    got = engine_tl.sphere_boxes_force(tpos, tvel, 0.025, engine_tl.tl_scene(scene), cp, 0.8)
    assert_close(got, want["force_tl"], rtol=1e-9, atol=1e-9)

    assert_close(boxes.heightmap_at(scene, T(x["xy"])), want["height"], rtol=1e-12, atol=1e-12)
    assert_close(boxes.ray_box_distance(scene, T(x["ray_o"]), T(x["ray_d"]), 3.0), want["ray"],
                 rtol=1e-12, atol=1e-12)
    pos, orn = T(x["pose_pos"]), T(x["pose_orn"])
    lid = boxes.lidar(scene, pos, T(x["pose_yaw"]))
    assert_close(lid, want["lidar"], rtol=1e-12, atol=1e-12)
    assert_close(lid[3], np.full(128, np.linalg.norm(x["pose_pos"][3])), rtol=1e-14, atol=0)
    assert_close(boxes.perception_height(scene, pos, orn), want["p2d"], rtol=1e-12, atol=1e-12)
    front = boxes.perception_front(scene, pos, orn)
    assert_close(front, want["front"], rtol=1e-12, atol=1e-12)
    assert float(front[:3].min()) < 3.0 and bool((front[3] == 3.0).all())


def _check_prune_picks_the_same_boxes():
    """Ten boxes straddle the corridor (distance 0, tied), two lie off it,
    two are inactive (inf): k = 8 must take the lowest-index tied boxes."""
    n = 14
    center = np.zeros((n, 3))
    half = np.full((n, 3), 0.1)
    order = [3, 0, 7, 12, 1, 9, 5, 11, 2, 8]  # the boxes on the corridor
    center[order, 0] = np.linspace(0.2, 1.8, len(order))
    center[[4, 13], 1] = [1.0, -0.7]
    center[[6, 10], 0] = 0.5  # on the corridor too, but inactive
    active = np.ones(n, bool)
    active[[6, 10]] = False
    jscene = jboxes.BoxScene(jnp.asarray(center), jnp.asarray(half), jnp.asarray(active),
                             jnp.zeros(3))
    scene = from_jax.box_scene(jscene, CPU, F64)
    p0, p1 = np.array([0.0, 0.0, 0.3]), np.array([2.0, 0.0, 0.3])

    @jax.jit
    def jprune(sc, a, b):
        return ([jboxes.nearest_boxes_corridor(sc, a, b, k) for k in (8, 13)],
                [jboxes.nearest_boxes(sc, a, k) for k in (8, 13)])

    want_corridor, want_nearest = jprune(jscene, jnp.asarray(p0), jnp.asarray(p1))
    for i, k in enumerate((8, 13)):
        got = boxes.nearest_boxes_corridor(scene, T(p0), T(p1), k)
        assert_tree_close(got, want_corridor[i], rtol=0, atol=0)
        assert_tree_close(boxes.nearest_boxes(scene, T(p0), k), want_nearest[i], rtol=0, atol=0)
    got = boxes.nearest_boxes_corridor(scene, T(p0), T(p1), 8)
    assert_close(got.center[:, 0], center[sorted(order)[:8], 0], rtol=0, atol=0)
    empty = boxes.empty_scene(6, batch=(2,), dtype=F64, device=CPU)
    assert_tree_close(empty, jboxes.empty_scene(6, batch=(2,), dtype=jnp.float64), rtol=0, atol=0)
    assert empty.active.dtype == torch.bool


def _check_engines_with_boxes(rng):
    """One substep of the readable engine (box scene; heightmap terrain) and
    of the tile engine (exact, then frozen-mass) with box contact on the
    feet, the wheels and the trunk."""
    sd = contact_scene(MODEL, stand_state(pos=(0.0, 0.0, 0.36)))
    jscene = jboxes.BoxScene(**{k: jnp.asarray(v) for k, v in sd.items()})
    scene = from_jax.box_scene(jscene, CPU, F64)
    jp = jengine.PhysicsParams(kd=1.0, max_tau=16.0, foot_friction=0.9)
    pp = from_jax.physics_params(jp)
    base = stand_state(pos=(0.0, 0.0, 0.36))
    d = random_robot_state(rng, batch=(4,), pos_noise=0.002, vel_noise=0.1)
    d["base_pos"] = base["base_pos"] + 0.002 * rng.standard_normal((4, 3))
    d["joint_pos"] = base["joint_pos"] + 0.01 * rng.standard_normal((4, 12))
    target = d["joint_pos"] + 0.05 * rng.standard_normal((4, 12))
    jtgt_tl = target.T.reshape(4, 3, 1, 4)
    jc = JB.tl_constants(JMODEL, dtype=jnp.float64)

    @jax.jit
    def jsteps(st, tgt, tgt_tl):
        plant = jengine.substep(JMODEL, jp, st, tgt, scene=jscene)
        hmap = jengine.substep(JMODEL, jp, st, tgt, terrain_fn=jboxes.terrain_height_fn(jscene))
        tl = JB.tl_from_state(st, batch2d=(1, 4))
        jts = jengine_tl.tl_scene(jscene)
        exact = jengine_tl.substep(jc, jp, tl, tgt_tl, scene=jts)
        frozen = jengine_tl.substep(jc, jp, exact, tgt_tl, frozen=jengine_tl.freeze_mass(jc, tl),
                                    scene=jts)
        return plant, hmap, exact, frozen

    want = jsteps(JRobotState(**{k: jnp.asarray(v) for k, v in d.items()}), jnp.asarray(target),
                  jnp.asarray(jtgt_tl))
    state = RobotState(**{k: T(v) for k, v in d.items()})
    got = engine.substep(MODEL, pp, state, T(target), scene=scene)
    assert_tree_close(got, want[0], rtol=1e-9, atol=1e-9)
    plane = engine.substep(MODEL, pp, state, T(target))
    assert float((got.base_lin_vel - plane.base_lin_vel).abs().max()) > 1e-3  # boxes act
    got = engine.substep(MODEL, pp, state, T(target), terrain_fn=boxes.terrain_height_fn(scene))
    assert_tree_close(got, want[1], rtol=1e-9, atol=1e-9)

    c = B.tl_constants(MODEL, dtype=F64, device=CPU)
    tl = B.tl_from_state(state, batch2d=(1, 4))
    ts = engine_tl.tl_scene(scene)
    got = engine_tl.substep(c, pp, tl, T(jtgt_tl), scene=ts)
    assert_tree_close(got, want[2], rtol=1e-9, atol=1e-9)
    got = engine_tl.substep(c, pp, got, T(jtgt_tl), frozen=engine_tl.freeze_mass(c, tl), scene=ts)
    assert_tree_close(got, want[3], rtol=1e-9, atol=1e-9)


# Each test file of the port holds at most two test items: pytest-xdist's
# loadfile scheduler queues files by item count, so files this small run
# after the long reference files and do not lengthen the tier-1 run.


def test_scene_queries_and_box_contact_match_reference():
    rng = np.random.default_rng(41)
    _check_geometry(rng)
    _check_prune_picks_the_same_boxes()
    _check_engines_with_boxes(rng)


def _jax_env_state(rng, sd, batch):
    """A mid-episode playground state (numpy -> JAX, float64): counter 5 of a
    100-step re-targeting period and the push 3 steps into an active
    interval, so a step draws nothing that acts. Row 1 is 0.3 m from its
    target (the step reaches it)."""
    n = batch[0]
    base = stand_state(pos=(0.0, 0.0, 0.36), vel=(0.5, 0.1, 0.0))
    robot = {k: np.broadcast_to(v, batch + v.shape).copy() for k, v in base.items()}
    robot["joint_vel"] = 0.2 * rng.standard_normal(batch + (12,))
    target = np.broadcast_to(sd["target_pos"], batch + (3,)).copy()
    target[1] = [0.3, 0.0, 0.0]
    scene = {k: np.broadcast_to(v, batch + v.shape).copy() for k, v in sd.items()}
    scene["target_pos"] = target
    f64 = lambda x: jnp.asarray(np.asarray(x, np.float64))
    jrobot = JRobotState(**{k: f64(v) for k, v in robot.items()})
    prop = jax.jit(jplayground._proprioception)(jrobot)  # op by op compiles each primitive
    diff = np.linalg.norm((target - robot["base_pos"])[..., :2], axis=-1)
    return jplayground.PlaygroundState(
        robot=jrobot,
        scene=jboxes.BoxScene(**{k: jnp.asarray(v) for k, v in scene.items()}),
        push=jrandomizer.PushState(count=jnp.full(batch, 3, jnp.int32),
                                   force=f64(rng.uniform(-20, 20, batch + (3,)))),
        counter=jnp.full(batch, 5, jnp.int32), target_pos=f64(target),
        target_spd=f64(rng.uniform(0.5, 3.0, batch)),
        cmd_vary_freq=jnp.full(batch, 100, jnp.int32), last_pos_diff=f64(diff),
        init_pos_diff=f64(diff + 0.5), total_spd=f64(rng.uniform(0, 3, batch)),
        max_spd=f64(rng.uniform(0, 1, batch)), friction=f64(rng.uniform(0.4, 3.0, batch)),
        noise_bias=f64(0.02 * rng.standard_normal(batch + (4,))),
        prop_hist=jnp.repeat(prop[..., None, :], 3, axis=-2),
        act_hist=f64(0.05 * rng.standard_normal(batch + (3, 12))),
    )


def _check_step_matches_reference(rng, element_id):
    sd = contact_scene(MODEL, stand_state(pos=(0.0, 0.0, 0.36)))
    jcfg = jplayground.PlaygroundConfig(
        params=jengine.PhysicsParams(kd=1.0, max_tau=16.0, substeps=2),
        scene=jplayground.playground_gen.PlaygroundConfig(element_id=element_id))
    cfg = playground.PlaygroundConfig(
        params=from_jax.physics_params(jcfg.params),
        scene=playground_gen.PlaygroundConfig(element_id=element_id))
    js = _jax_env_state(rng, sd, (2,))
    s = from_jax.playground_state(js, CPU, F64)
    jstep = jax.jit(lambda st, a: jplayground.step(JMODEL, jcfg, st, a, jax.random.PRNGKey(0)))
    for _ in range(2):
        a = 0.05 * rng.standard_normal((2, 12))
        js, jobs, jr, jdone, jinfo = jstep(js, jnp.asarray(a))
        s, obs, r, done, info = playground.step(MODEL, cfg, s, T(a), torch.Generator())
        assert_tree_close(s.robot, js.robot, rtol=1e-9, atol=1e-9)
        assert_tree_close(obs, jobs, rtol=1e-9, atol=1e-9)
        assert_close(r, jr, rtol=1e-9, atol=1e-9)
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        for k in jinfo:
            assert_close(info[k], jinfo[k], rtol=1e-9, atol=1e-9)
        for f in ("counter", "target_pos", "target_spd", "last_pos_diff", "total_spd",
                  "max_spd", "prop_hist", "act_hist"):
            assert_close(getattr(s, f), getattr(js, f), rtol=1e-9, atol=1e-9)
        assert_tree_close(s.push, js.push, rtol=1e-9, atol=1e-9)
    assert bool(done[1]) and not bool(done[0])  # row 1 reached its target


def _check_generate_and_reset():
    gen = torch.Generator().manual_seed(3)
    for eid in range(4):
        pc = playground_gen.PlaygroundConfig(element_id=eid)
        scenes = [playground_gen.generate(gen, pc, F64) for _ in range(64)]
        center = torch.stack([s.center for s in scenes])
        half = torch.stack([s.half for s in scenes])
        active = torch.stack([s.active for s in scenes])
        target = torch.stack([s.target_pos for s in scenes])
        assert center.shape == (64, playground_gen.CAPACITY, 3)
        if eid == 0:
            assert not bool(active.any())
            assert_close(target, np.tile([8.0, 0.0, 0.0], (64, 1)), rtol=0, atol=0)
            continue
        assert bool(active[:, :2].all())  # corridor walls
        width = 2 * half[:, 0, 1]
        gap = 2 * (center[:, 0, 1] - half[:, 0, 1])
        assert bool(((width >= 0.02) & (width <= 0.5) & (gap >= 1.0) & (gap <= 20.0)).all())
        assert abs(float(width.mean()) - 0.26) < 0.05 and abs(float(gap.mean()) - 10.5) < 2.0
        elems = active[:, 2:]
        n_active = elems.sum(-1)
        if eid in (1, 2):
            assert bool(((n_active % 2 == 0) & (n_active >= 2) & (n_active <= 18)).all())
            assert 7.0 < float(n_active.float().mean()) < 13.0  # 2 x U{1..9}: mean 10
            ec, eh = center[:, 2:20], half[:, 2:20]
            assert bool((ec[:, 1:, 0] > ec[:, :-1, 0]).all())  # along +x
            gaps = (ec[:, 1:, 0] - eh[:, 1:, 0]) - (ec[:, :-1, 0] + eh[:, :-1, 0])
            assert float(gaps.min()) >= 1.0 - 1e-9 and float(gaps.max()) <= 3.0 + 1e-9
            if eid == 1:  # hurdles on the ground, 5-15 cm high
                h = 2 * eh[..., 2]
                assert bool(((h >= 0.05) & (h <= 0.15)).all())
                assert_close(ec[..., 2], eh[..., 2], rtol=0, atol=1e-15)
            else:  # 0.3 m blocks over a 0.25-0.3 m crawl gap
                bottom = ec[..., 2] - eh[..., 2]
                assert bool(((bottom >= 0.25) & (bottom <= 0.3)).all())
            # the target lies within 1 m of the end of the first n obstacles
            last = torch.gather(ec[..., 0] + eh[..., 0] + 0.0, 1, (n_active // 2 - 1)[:, None])
            assert bool(((target[:, 0] - last[:, 0]).abs() <= 3.0 + 1.0).all())
        else:  # cube sets of four, 2 x U{1..4} sets
            assert bool(((n_active % 8 == 0) & (n_active >= 8) & (n_active <= 32)).all())
            tops = 2 * half[:, 2:34, 2]
            assert_close(tops[:, :4], np.tile([0.1, 0.25, 0.25, 0.1], (64, 1)), rtol=0,
                         atol=1e-15)

    cfg = playground.PlaygroundConfig(scene=playground_gen.PlaygroundConfig(element_id=1))
    gen = torch.Generator().manual_seed(4)
    s, obs = playground.reset(MODEL, cfg, gen, batch=(256,), dtype=F64)
    yaw = torch.atan2(s.robot.base_orn[:, 2], s.robot.base_orn[:, 3]) * 2 % (2 * math.pi)
    assert abs(float(yaw.mean()) - math.pi) < 0.3 and abs(float(torch.cos(yaw).mean())) < 0.15
    assert_close(s.robot.base_pos, np.tile([0.0, 0.0, 0.5], (256, 1)), rtol=0, atol=0)
    for x, (lo, hi) in ((s.friction, cfg.friction_range), (s.target_spd, cfg.target_spd_range),
                        (s.cmd_vary_freq, cfg.cmd_vary_freq_range)):
        assert bool(((x >= lo) & (x < hi)).all())
        assert abs(float(x.double().mean()) - (lo + hi) / 2) < 0.1 * (hi - lo)
    assert not bool(s.noise_bias.any())  # the default config has no observation noise
    assert_close(s.init_pos_diff, torch.linalg.vector_norm(s.scene.target_pos[:, :2], dim=-1),
                 rtol=1e-15, atol=0)
    assert tuple(obs.percep_2d.shape) == (256, 25, 13) and tuple(obs.percep_1d.shape) == (256, 128)
    assert bool((obs.prop == obs.prop[:, :33].repeat(1, 3)).all())
    assert s.push.count.unique().tolist() == [-25]


def _check_pushes_and_retargeting():
    """The push schedule is deterministic and must equal the reference's;
    the forces and the joystick re-targets are held by their ranges and
    means."""
    dt = 0.02
    jpc = jrandomizer.PushConfig()
    jps = jrandomizer.push_reset(jax.random.PRNGKey(0), jpc, dt, (512,))
    gen = torch.Generator().manual_seed(5)
    ps = randomizer.push_reset(gen, randomizer.PushConfig(), dt, (512,), F64)
    mags = []
    for i in range(90):
        jps, jf = jrandomizer.push_step(jax.random.PRNGKey(i), jpc, jps, dt)
        ps, f = randomizer.push_step(gen, randomizer.PushConfig(), ps, dt)
        np.testing.assert_array_equal((f != 0).any(-1).numpy(), np.asarray((jf != 0).any(-1)))
        np.testing.assert_array_equal(ps.count.numpy(), np.asarray(jps.count))
        if bool((f != 0).any()):
            mags.append(f)
    # nine steps of the force drawn at reset (counts 1-9), then ten of the
    # one drawn at the first resample (count 50 -> 0, then 1-9)
    assert len(mags) == 19
    f = torch.stack(mags)
    horiz = torch.linalg.vector_norm(f[..., :2], dim=-1)
    assert float(horiz.max()) <= 50.0 and float(f[..., 2].min()) >= 0.0
    assert float(f[..., 2].max()) <= 10.0
    for i in (0, -1):
        assert abs(float(horiz[i].mean()) - 25.0) < 2.5
        assert abs(float(f[i, :, 2].mean()) - 5.0) < 0.5

    cfg = playground.PlaygroundConfig(
        params=engine.PhysicsParams(kd=1.0, max_tau=16.0, substeps=1),
        scene=playground_gen.PlaygroundConfig(element_id=0))
    gen = torch.Generator().manual_seed(6)
    s, _ = playground.reset(MODEL, cfg, gen, batch=(128,), dtype=F64)
    start = s.robot.base_pos
    s2, _, r, _, _ = playground.step(MODEL, cfg, s, torch.zeros(128, 12, dtype=F64), gen)
    to_target = (s2.target_pos - start)[:, :2]  # counter 0: every env re-targets
    assert_close(torch.linalg.vector_norm(to_target, dim=-1), np.full(128, 100.0), rtol=1e-12,
                 atol=0)
    theta = torch.atan2(to_target[:, 1], to_target[:, 0])
    assert abs(float(torch.cos(theta).mean())) < 0.2 and abs(float(torch.sin(theta).mean())) < 0.2
    assert not torch.equal(s2.target_spd, s.target_spd)
    assert bool(torch.isfinite(r).all())

    s3, _, _, done, _ = playground.step_autoreset(
        MODEL, cfg, s2._replace(counter=torch.full_like(s2.counter, cfg.max_steps - 1)),
        torch.zeros(128, 12, dtype=F64), gen)
    assert bool(done.all()) and not bool(s3.counter.any())  # every env timed out and restarted


def test_playground_env_matches_reference():
    rng = np.random.default_rng(42)
    _check_step_matches_reference(rng, element_id=1)
    _check_step_matches_reference(rng, element_id=0)
    _check_generate_and_reset()
    _check_pushes_and_retargeting()
    out = run_mpc.main(["--task=epmc", "--element_id=1", "--device=cpu", "--population=128",
                        "--horizon=3", "--steps=2", "--seed=1"])
    assert len(out["step_rewards"]) == 2 and np.isfinite(out["step_rewards"]).all()
    assert len(out["falls"]) == 2 and len(out["t_solve"]) == 2
    # the hard-contact plant steps (tests/test_torch_hard_contact.py holds it to JAX)
    cfg = playground.PlaygroundConfig(
        params=engine.PhysicsParams(kd=1.0, max_tau=16.0, substeps=2),
        scene=playground_gen.PlaygroundConfig(element_id=1), hard_contact=True)
    gen = torch.Generator().manual_seed(8)
    s, _ = playground.reset(MODEL, cfg, gen, batch=(2,), dtype=F64)
    s2, obs, r, done, _ = playground.step(MODEL, cfg, s, torch.zeros(2, 12, dtype=F64), gen)
    assert bool(torch.isfinite(r).all()) and not bool(done.any())
    for x in tuple(s2.robot) + tuple(obs):
        assert bool(torch.isfinite(x).all())
    assert float((s2.robot.base_pos - s.robot.base_pos).abs().max()) > 0.0
