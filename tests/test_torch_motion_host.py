"""The host side of the port's motion library vs the JAX reference: the C++
clip parser (lifelike_tpu_torch._native, built with g++) and load_clips'
json path, the jump-event obstacles, their collision test and the
prioritized clip sampler, and the primitive env's obstacle termination.

The parser's frames equal the JAX package's native parser's and the json
module's exactly; the obstacle tables and the sampler's probabilities are
exact; current_obstacle and obstacle_collision are held exactly against one
jitted JAX function over a grid of times and points.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lifelike_tpu import _native as j_native
from lifelike_tpu.motion import motion_lib as jml
from lifelike_tpu_torch import _native
from lifelike_tpu_torch.envs import primitive
from lifelike_tpu_torch.motion import motion_lib
from lifelike_tpu_torch.robot.model import build_max_model
from lifelike_tpu_torch.utils.obstacle import obstacles_in_frames

from tests.torch_port_util import CPU


def _write_clip(path, n_frames, seed, escape_key=False):
    """A clip file in the reference format. escape_key: spell FrameDuration
    with a JSON escape, which the json module reads and the native parser's
    restricted grammar rejects."""
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(n_frames, 19)).round(6).tolist()
    text = json.dumps({"FrameDuration": 1.0 / 120.0, "LegOrder": ["FR", "FL", "HR", "HL"],
                       "Frames": frames})
    if escape_key:
        text = text.replace('"FrameDuration"', '"Frame\\u0044uration"')
    path.write_text(text)
    return np.asarray(frames, np.float32)


def _check_clip_parser(tmp_path):
    p = tmp_path / "clip_ret.txt"
    expect = _write_clip(p, 11, seed=1)
    frames, fd = _native.parse_clip_file(str(p))
    jframes, jfd = j_native.parse_clip_file(str(p))
    np.testing.assert_array_equal(frames, jframes)
    np.testing.assert_array_equal(frames, expect)
    assert fd == jfd and abs(fd - 1.0 / 120.0) < 1e-12
    assert _native.library_path().startswith(_native.BUILD_DIR)
    bad = tmp_path / "bad.txt"
    bad.write_text("{not json at all")
    assert _native.parse_clip_file(str(bad)) is None and j_native.parse_clip_file(str(bad)) is None

    # load_clips: the native parser where it can, the json module where not
    d = tmp_path / "clips"
    d.mkdir()
    for i in range(3):
        _write_clip(d / f"c{i}_ret.txt", 5 + i, seed=i, escape_key=i == 1)
    clips = motion_lib.load_clips(str(d), device=CPU)
    assert motion_lib.load_clips.parsed_by == ["native", "json", "native"]
    want = jml.load_clips(str(d))
    np.testing.assert_array_equal(clips.frames.numpy(), np.asarray(want.frames))
    np.testing.assert_array_equal(clips.lengths.numpy(), np.asarray(want.lengths))
    assert clips.frame_step == want.frame_step and clips.margin == want.margin


def test_clip_parser_matches_reference(tmp_path):
    _check_clip_parser(tmp_path)


def _jump_clip():
    """Clip with two clear jumps above 0.5 m, > 120 frames apart, heading
    along a yawed line (tests/test_obstacles.py's clip, turned)."""
    t = np.arange(600)
    frames = np.zeros((600, 19), np.float32)
    frames[:, 2] = 0.33
    frames[:, 5] = np.sin(0.15)
    frames[:, 6] = np.cos(0.15)
    for peak in (150, 400):
        frames[:, 2] += 0.4 * np.exp(-0.5 * ((t - peak) / 10.0) ** 2)
    frames[:, 0] = 0.01 * t
    frames[:, 1] = 0.003 * t
    return frames


def _check_obstacles_and_sampler():
    flat = np.zeros((240, 19), np.float32)
    flat[:, 6] = 1.0
    clips = [_jump_clip(), flat]
    assert obstacles_in_frames(flat, 120) is None
    ev = motion_lib.extract_obstacles(clips, 1.0 / 120.0, device=CPU)
    jev = jml.extract_obstacles(clips, 1.0 / 120.0)
    for name, g, w in zip(ev._fields, ev, jev):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert ev.count.tolist() == [2, 0]

    ci = np.array([0, 0, 0, 0, 1, 1])
    ts = np.array([0.1, 1.2, 1.76, 2.0, 0.5, 3.0])
    rng = np.random.default_rng(4)
    pts = np.concatenate([ev.xy.numpy()[ci, (ts > 1.75).astype(int)][:, None, :]
                          + 0.3 * rng.uniform(-1, 1, (6, 5, 2)),
                          rng.uniform(0.0, 0.5, (6, 5, 1))], axis=-1)

    @jax.jit
    def reference(ci, ts, pts):
        xy, yaw, active = jml.current_obstacle(jev, ci, ts)
        return xy, yaw, active, jml.obstacle_collision(xy, yaw, 0.2, pts)

    want = reference(*(jnp.asarray(x) for x in (ci, ts, pts)))
    xy, yaw, active = motion_lib.current_obstacle(ev, torch.as_tensor(ci), torch.as_tensor(ts))
    got = (xy, yaw, active, motion_lib.obstacle_collision(xy, yaw, 0.2, torch.as_tensor(pts)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert active.tolist() == [True] * 4 + [False] * 2
    assert 0 < int(got[3].sum()) < 6  # some rows hit, some miss

    s, js = (motion_lib.PrioritizedClipSampler(4, factor=3.0, device=CPU),
             jml.PrioritizedClipSampler(4, factor=3.0))
    np.testing.assert_array_equal(s.probabilities.numpy(), np.asarray(js.probabilities))
    for sampler in (s, js):
        sampler.update([1], [0.9])
        sampler.update_sums(np.array([0.0, 0.0, 1.5, 0.4]), np.array([0, 0, 2, 1]))
    p = s.probabilities.numpy()
    np.testing.assert_array_equal(p, np.asarray(js.probabilities))
    assert p[1] < p[0] and abs(p.sum() - 1.0) < 1e-12


def _check_primitive_env_obstacle_termination():
    """tests/test_obstacles.py::test_primitive_env_obstacle_termination on
    the port: the robot teleported onto the first jump obstacle ends the
    episode only when the obstacle option is on."""
    model = build_max_model()
    clip = _jump_clip()
    clips = motion_lib.pack_clips([clip], frame_step=1.0 / 120.0, device=CPU)
    obstacles = motion_lib.extract_obstacles([clip], 1.0 / 120.0, device=CPU)
    base = primitive.PrimitiveEnvConfig()
    cfg = base._replace(params=base.params._replace(substeps=2), set_obstacle=True,
                        obstacle_height=5.0)  # a giant box: a hit at the jump spot
    gen = torch.Generator()
    gen.manual_seed(0)
    env, _ = primitive.reset(model, clips, cfg, gen)
    xy = obstacles.xy[0, 0].double()
    env = env._replace(t=torch.tensor(0.6, dtype=env.t.dtype),
                       robot=env.robot._replace(base_pos=torch.stack(
                           [xy[0], xy[1], torch.tensor(0.33, dtype=torch.float64)]).to(
                               env.robot.base_pos.dtype)))
    zero = torch.zeros(12)
    _, _, _, done, _ = primitive.step(model, clips, cfg, env, zero, obstacles=obstacles)
    assert bool(done)
    _, _, _, done_off, _ = primitive.step(model, clips, cfg._replace(set_obstacle=False), env,
                                          zero, obstacles=obstacles)
    assert not bool(done_off)


def test_obstacles_sampler_and_env_match_reference():
    _check_obstacles_and_sampler()
    _check_primitive_env_obstacle_termination()
