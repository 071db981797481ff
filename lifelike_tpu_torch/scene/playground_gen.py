"""Procedural playground terrain, randomized per scenario.

Port of lifelike_tpu.scene.playground_gen: the procedural vocabulary of
the reference's obstacle courses as fixed-capacity masked box tables
(scene.boxes.BoxScene), drawn from a torch.Generator:

  element 0: joystick (no obstacles; far target)
  element 1: hurdle course — corridor walls + n in [1, 10) low boxes at
             random spacing, then the target, then n more
  element 2: hole course — elevated blocks leaving a crawl gap
  element 3: cube staircase sets (easy variant)

All elements except joystick add the random-width corridor walls: gap ~
U(wall_gap_offset), width ~ U(wall_width_offset), two 200 x w x 2 boxes at
x = 5. The draws differ from jax.random's; the distributions are the same.
"""
from typing import NamedTuple

import torch

from lifelike_tpu_torch.scene.boxes import BoxScene

CAPACITY = 48
MAX_OBJ = 9  # reference: np.random.randint(1, 10)


class PlaygroundConfig(NamedTuple):
    element_id: int = 0  # 0 joystick, 1 hurdles, 2 holes, 3 cubes
    wall_width_offset: tuple = (0.02, 0.5)
    wall_gap_offset: tuple = (1.0, 20.0)
    hurdle_min_height: float = 0.05
    hurdle_max_height: float = 0.15
    hole_min_gap: float = 0.25
    hole_max_gap: float = 0.3
    hole_block_height: float = 0.3
    min_distance: float = 1.0
    max_distance: float = 3.0
    element_length: float = 0.1


def _uniform(gen, shape, lo, hi, dtype):
    u = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
    return lo + (hi - lo) * u


def _randint(gen, lo, hi):
    """One integer in [lo, hi) as a 0-d tensor on the generator's device."""
    return torch.randint(lo, hi, (), generator=gen, device=gen.device)


def _walls(gen, cfg: PlaygroundConfig, dtype):
    width = _uniform(gen, (), *cfg.wall_width_offset, dtype)
    gap = _uniform(gen, (), *cfg.wall_gap_offset, dtype)
    y = gap / 2.0 + width / 2.0
    five, one = torch.full_like(y, 5.0), torch.ones_like(y)
    centers = torch.stack([torch.stack([five, y, one]), torch.stack([five, -y, one])])
    halves = torch.stack([torch.full_like(y, 100.0), width / 2.0, one]).expand(2, 3)
    return centers, halves, gap


def _course(gen, cfg: PlaygroundConfig, kind, gap_width, dtype):
    """Sequential obstacle course along +x (hurdles kind=1 / holes kind=2).

    Returns (centers (2*MAX_OBJ, 3), halves, active, target_x): the first n
    obstacles precede the target, n more follow it."""
    n = _randint(gen, 1, MAX_OBJ + 1)
    dist = _uniform(gen, (2 * MAX_OBJ,), cfg.min_distance, cfg.max_distance, dtype)
    length = cfg.element_length
    # cur_len recurrence: pos_x = cur_len + dist/2; cur_len += dist + length
    cum = torch.cumsum(dist + length, dim=0)
    cur_len_before = torch.cat([torch.zeros_like(cum[:1]), cum[:-1]])
    pos_x = cur_len_before + dist / 2.0

    if kind == 1:
        h = _uniform(gen, (2 * MAX_OBJ,), cfg.hurdle_min_height, cfg.hurdle_max_height, dtype)
        pos_z = h / 2.0
    else:
        gap_h = _uniform(gen, (2 * MAX_OBJ,), cfg.hole_min_gap, cfg.hole_max_gap, dtype)
        h = torch.full_like(pos_x, cfg.hole_block_height)
        pos_z = h / 2.0 + gap_h

    centers = torch.stack([pos_x, torch.zeros_like(pos_x), pos_z], dim=-1)
    halves = torch.stack(
        [torch.full_like(pos_x, length / 2.0), (gap_width / 2.0).expand_as(pos_x), h / 2.0],
        dim=-1,
    )
    idx = torch.arange(2 * MAX_OBJ, device=pos_x.device)
    active = idx < 2 * n
    # target after the first n obstacles: cur_len + U(-1, 1)
    cur_len_at_n = torch.sum(torch.where(idx < n, dist + length, torch.zeros_like(dist)))
    target_x = cur_len_at_n + _uniform(gen, (), -1.0, 1.0, dtype)
    return centers, halves, active, target_x


def _cubes(gen, cfg: PlaygroundConfig, gap_width, dtype):
    """Easy cube staircase sets: per set a 10 / 25 cm step-up, then 25 / 10
    cm step-down; num_set ~ U{1..4} before the target, num_set more after."""
    num_set = _randint(gen, 1, 5)
    max_sets = 8  # 2 * 4
    dist = _uniform(gen, (max_sets,), 0.0, 1.0, dtype)
    set_len = dist + 5.0
    cum = torch.cumsum(set_len, dim=0)
    start = torch.cat([torch.zeros_like(cum[:1]), cum[:-1]]) + dist  # (8,)
    # per set (x_center offset, length, height) of the four cubes
    xs = start[:, None] + torch.tensor([1.0, 1.75, 2.5, 3.25], dtype=dtype, device=dist.device)
    hs = torch.tensor([0.1, 0.25, 0.25, 0.1], dtype=dtype, device=dist.device).expand_as(xs)
    centers = torch.stack([xs, torch.zeros_like(xs), hs / 2.0], dim=-1).reshape(-1, 3)
    halves = torch.stack(
        [torch.full_like(xs, 0.25), (gap_width / 2.0).expand_as(xs), hs / 2.0], dim=-1
    ).reshape(-1, 3)
    set_idx = torch.arange(max_sets, device=dist.device).repeat_interleave(4)
    active = set_idx < 2 * num_set
    before = torch.arange(max_sets, device=dist.device) < num_set
    target_x = (torch.sum(torch.where(before, set_len, torch.zeros_like(set_len)))
                + _uniform(gen, (), -3.0, 3.0, dtype))
    return centers, halves, active, target_x


def generate(gen: torch.Generator, cfg: PlaygroundConfig, dtype=torch.float32) -> BoxScene:
    """One randomized scenario scene on the generator's device."""
    dev = gen.device
    centers = torch.zeros((CAPACITY, 3), dtype=dtype, device=dev)
    halves = torch.zeros((CAPACITY, 3), dtype=dtype, device=dev)
    active = torch.zeros((CAPACITY,), dtype=torch.bool, device=dev)

    if cfg.element_id == 0:
        target = torch.tensor([8.0, 0.0, 0.0], dtype=dtype, device=dev)
        return BoxScene(centers, halves, active, target)
    if cfg.element_id not in (1, 2, 3):
        raise ValueError(f"unknown element_id {cfg.element_id}")

    wc, wh, gap = _walls(gen, cfg, dtype)
    centers[:2] = wc
    halves[:2] = wh
    active[:2] = True
    if cfg.element_id in (1, 2):
        ec, eh, ea, tx = _course(gen, cfg, cfg.element_id, gap, dtype)
    else:
        ec, eh, ea, tx = _cubes(gen, cfg, gap, dtype)
    n = ec.shape[0]
    centers[2:2 + n] = ec
    halves[2:2 + n] = eh
    active[2:2 + n] = ea
    target = torch.stack([tx, torch.zeros_like(tx), torch.zeros_like(tx)])
    return BoxScene(centers, halves, active, target)
