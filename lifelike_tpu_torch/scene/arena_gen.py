"""Chase-Tag arena (BulletStaticsV4 parity) as BoxScene data.

Port of lifelike_tpu.scene.arena_gen (reference
max_game/bullet_static_entities.py:830-1019): a 5x5 m walled box (walls
0.01 thick, 2 m tall at +-2.5) with optional elements per config — 5 random
cubes (0.5-1.0 footprint, 0.05-0.25 tall, anywhere in +-2; the table keeps
a sixth, inactive row), one full-width hurdle at x=0 (0.05-0.15 tall), one
full-length hole bar (0.3 thick at gap 0.25-0.3). The draws come from a
torch.Generator: the distributions are the reference's, the numbers not.
"""
from typing import NamedTuple

import torch

from lifelike_tpu_torch.scene.boxes import BoxScene

CAPACITY = 12  # table rows with every element enabled; generate() sizes each
               # table to its config (4 walls + the enabled elements)
N_CUBE_ROWS = 6
N_CUBES = 5  # reference: randint(5, 6) == 5

_WALL = 0.01, 5.0, 2.0  # thickness, length, height


class ArenaConfig(NamedTuple):
    rand_cube: bool = False
    hurdle: bool = False
    hole: bool = False


def capacity(cfg: ArenaConfig) -> int:
    """Rows of the table of `cfg`: inactive rows would cost contact work in
    every rollout, so the table holds only what the config can populate."""
    return 4 + N_CUBE_ROWS * bool(cfg.rand_cube) + bool(cfg.hurdle) + bool(cfg.hole)


def _uniform(gen, shape, lo, hi, dtype):
    u = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
    return lo + (hi - lo) * u


def draw(generator, cfg: ArenaConfig, dtype=torch.float32) -> dict:
    """The random numbers of one arena: cube heights / centers / lengths /
    widths (6 rows), the hurdle height and the hole gap, for the enabled
    elements."""
    g = generator
    out = {}
    if cfg.rand_cube:
        out["cube_h"] = _uniform(g, (N_CUBE_ROWS,), 0.05, 0.25, dtype)
        out["cube_xy"] = _uniform(g, (N_CUBE_ROWS, 2), -2.0, 2.0, dtype)
        out["cube_len"] = _uniform(g, (N_CUBE_ROWS,), 0.5, 1.0, dtype)
        out["cube_wid"] = _uniform(g, (N_CUBE_ROWS,), 0.5, 1.0, dtype)
    if cfg.hurdle:
        out["hurdle_h"] = _uniform(g, (), 0.05, 0.15, dtype)
    if cfg.hole:
        out["hole_gap"] = _uniform(g, (), 0.25, 0.3, dtype)
    return out


def assemble(cfg: ArenaConfig, draws: dict, dtype=torch.float32, device="cpu") -> BoxScene:
    """The arena table of `cfg` from its random numbers (see `draw`)."""
    n = capacity(cfg)
    centers = torch.zeros((n, 3), dtype=dtype, device=device)
    halves = torch.zeros((n, 3), dtype=dtype, device=device)
    active = torch.zeros((n,), dtype=torch.bool, device=device)

    w, l, h = _WALL
    centers[:4] = torch.tensor(
        [[0, 2.5, h / 2], [0, -2.5, h / 2], [2.5, 0, h / 2], [-2.5, 0, h / 2]], dtype=dtype)
    halves[:4] = torch.tensor(
        [[l / 2, w / 2, h / 2], [l / 2, w / 2, h / 2],
         [w / 2, l / 2, h / 2], [w / 2, l / 2, h / 2]], dtype=dtype)
    active[:4] = True
    idx = 4
    d = {k: v.to(device=device, dtype=dtype) for k, v in draws.items()}
    if cfg.rand_cube:
        hgt, pos = d["cube_h"], d["cube_xy"]
        rows = slice(idx, idx + N_CUBE_ROWS)
        centers[rows] = torch.stack([pos[:, 0], pos[:, 1], hgt / 2], dim=-1)
        halves[rows] = torch.stack([d["cube_len"] / 2, d["cube_wid"] / 2, hgt / 2], dim=-1)
        active[rows] = torch.arange(N_CUBE_ROWS, device=device) < N_CUBES
        idx += N_CUBE_ROWS
    if cfg.hurdle:
        hgt = d["hurdle_h"]
        centers[idx, 2] = hgt / 2
        halves[idx] = torch.stack([torch.full_like(hgt, 0.05), torch.full_like(hgt, 2.5), hgt / 2])
        active[idx] = True
        idx += 1
    if cfg.hole:
        centers[idx, 2] = 0.15 + d["hole_gap"]
        halves[idx] = torch.tensor([2.5, 0.05, 0.15], dtype=dtype)
        active[idx] = True
    return BoxScene(centers, halves, active, torch.zeros(3, dtype=dtype, device=device))


def generate(generator, cfg: ArenaConfig = ArenaConfig(), dtype=torch.float32,
             device=None) -> BoxScene:
    """One randomized arena, on `device` (default: the generator's)."""
    dev = generator.device if device is None else torch.device(device)
    return assemble(cfg, draw(generator, cfg, dtype), dtype, dev)
