"""Fixed Chase-Tag arenas V1-V3 + the version selector (GameManager parity).

Port of lifelike_tpu.scene.arena_fixed. The reference builds these from
URDF assets:
- BulletStatics (V1): 10x10 m walled arena with two mid walls, a central
  cube, stamp rows on +-x, hurdle rows on y=+-4 (reference
  max_game/bullet_static_entities.py:8-257); `small=True` halves it using
  the small/ asset set.
- BulletStaticsV2: 5x6 m arena with a 4x3 m central block, a cube/stamp row
  at y=2, two hurdles, and optional elevated "hole" bars (:260-496).
- BulletStaticsV3: 6x7 m arena of 1 m cubes, stamps, thin walls and hurdles
  (:499-827).
- GameManager: thin selector over versions + the height-randomization hook
  (max_game/game_manager.py:5-18); V4 is the procedural arena in
  scene/arena_gen.py.

Each arena is a static box list (centers/halves from the URDF <box size>
values and load poses; yaw-90 placements swap x/y extents) padded to one
shared capacity. The reference's `randomize_height` offsets only the
movable elements (never the walls); `to_scene` reproduces that with an
element mask, drawing from a torch.Generator.
"""
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.scene import arena_gen
from lifelike_tpu_torch.scene.boxes import BoxScene

CAPACITY = 24


class FixedArena(NamedTuple):
    """Static (host-side numpy) arena description."""

    centers: np.ndarray  # (CAPACITY, 3)
    halves: np.ndarray  # (CAPACITY, 3)
    element: np.ndarray  # (CAPACITY,) bool — height-randomizable
    active: np.ndarray  # (CAPACITY,) bool


def _pack(rows) -> FixedArena:
    """rows: (center(3), size(3), rotated, element). rotated swaps x/y size."""
    centers = np.zeros((CAPACITY, 3), np.float32)
    halves = np.zeros((CAPACITY, 3), np.float32)
    element = np.zeros((CAPACITY,), bool)
    active = np.zeros((CAPACITY,), bool)
    if len(rows) > CAPACITY:
        raise ValueError(f"{len(rows)} boxes exceed the capacity {CAPACITY}")
    for i, (c, s, rot, el) in enumerate(rows):
        sx, sy, sz = s
        if rot:
            sx, sy = sy, sx
        centers[i] = c
        halves[i] = (sx / 2.0, sy / 2.0, sz / 2.0)
        element[i] = el
        active[i] = True
    return FixedArena(centers, halves, element, active)


def arena_v1(small: bool = False) -> FixedArena:
    """BulletStatics: reference bullet_static_entities.py:8-257."""
    if not small:
        wall, mid = (10, 0.1, 2), (6, 0.1, 2)
        rows = [
            ((0, 5, 1), wall, False, False),
            ((0, -5, 1), wall, False, False),
            ((5, 0, 1), wall, True, False),
            ((-5, 0, 1), wall, True, False),
            ((0, -3, 1), mid, False, False),
            ((0, 3, 1), mid, False, False),
            ((0, 0, 0), (2, 2, 1), False, True),  # central cube
        ]
        for sgn in (1, -1):  # stamp rows on +-x (:81-134)
            rows += [
                ((2 * sgn, 0, 0), (0.5, 2, 0.8), False, True),
                ((3 * sgn, 0, 0), (0.5, 2, 0.5), False, True),
                ((3.75 * sgn, 0, 0), (0.5, 2, 0.2), False, True),
            ]
        for ys in (1, -1):  # hurdle rows on y=+-4, side bars at x=+-4 (:136-232)
            rows += [
                ((-2, 4 * ys, 0), (0.1, 2, 0.2), False, True),
                ((0, 4 * ys, 0), (0.1, 2, 0.4), False, True),
                ((2, 4 * ys, 0), (0.1, 2, 0.3), False, True),
                ((-4, 3 * ys, 0), (0.1, 2, 0.3), True, True),
                ((4, 3 * ys, 0), (0.1, 2, 0.3), True, True),
            ]
        return _pack(rows)
    # small/ asset set: halved layout, stamp3/hurdle2/side bars omitted
    wall, mid = (6, 0.1, 2), (3, 0.1, 2)
    rows = [
        ((0, 2.5, 1), wall, False, False),
        ((0, -2.5, 1), wall, False, False),
        ((3, 0, 1), wall, True, False),
        ((-3, 0, 1), wall, True, False),
        ((0, -1.5, 0), mid, False, False),
        ((0, 1.5, 0), mid, False, False),
        ((0, 0, 0), (1, 1, 1), False, True),
    ]
    for sgn in (1, -1):
        rows += [
            ((1.0 * sgn, 0, 0), (0.5, 1, 0.8), False, True),
            ((1.75 * sgn, 0, 0), (0.5, 1, 0.5), False, True),
        ]
    for ys in (1, -1):
        rows += [
            ((-1, 2 * ys, 0), (0.1, 1, 0.2), False, True),
            ((1, 2 * ys, 0), (0.1, 1, 0.3), False, True),
        ]
    return _pack(rows)


def arena_v2(holes: bool = False) -> FixedArena:
    """BulletStaticsV2: reference bullet_static_entities.py:260-496."""
    wall = (6, 0.01, 2)
    rows = [
        ((0, 2.5, 1), wall, False, False),
        ((0, -2.5, 1), wall, False, False),
        ((3, 0, 1), wall, True, False),
        ((-3, 0, 1), wall, True, False),
        ((0, 0, 0), (4.0, 3.0, 1.5), False, False),  # mid_walls3 block (:328-332)
        # cube/stamp row at y=2 (:334-391)
        ((0, 2, 0), (1.1, 1.1, 1.12), False, True),
        ((1, 2, 0), (0.5, 1, 0.8), False, True),
        ((1.75, 2, 0), (0.5, 1, 0.5), False, True),
        ((-1, 2, 0), (0.5, 1, 0.8), False, True),
        ((-1.75, 2, 0), (0.5, 1, 0.5), False, True),
        # hurdles (:392-415)
        ((-2.5, 1, 0), (1.0, 0.1, 0.2), False, True),
        ((-2.5, -1, 0), (1.0, 0.1, 0.3), False, True),
    ]
    if holes:  # elevated bars to crawl under (:417-463)
        bar = (0.1, 1.0, 0.4)
        rows += [
            ((-1, -2, 0.4), bar, False, True),
            ((1, -2, 0.4), bar, False, True),
            ((2.5, 1, 0.5), bar, True, True),
            ((2.5, -1, 0.5), bar, True, True),
        ]
    return _pack(rows)


def arena_v3() -> FixedArena:
    """BulletStaticsV3: reference bullet_static_entities.py:499-827."""
    wall = (10, 1, 2)
    rows = [
        ((0, 3, 1), wall, False, False),
        ((0, -3, 1), wall, False, False),
        ((3.5, 0, 1), wall, True, False),
        ((-3.5, 0, 1), wall, True, False),
        # thin inner walls (walls2, loaded yaw-90 in _create_cubes :678-689)
        ((-2, 1.25, 0), (2.5, 0.01, 0.8), True, False),
        ((2, 1.25, 0), (2.5, 0.01, 0.8), True, False),
    ]
    cube = (1, 1, 1)
    for xy in [(2.5, 2), (-2.5, 2), (-1, 1.5), (1, 1.5),
               (1, 0), (-1, 0), (-1, -1.5), (1, -1.5)]:
        rows.append(((xy[0], xy[1], -0.1), cube, False, True))
    rows += [
        ((-2.5, 1, 0), (0.5, 1, 0.5), False, True),  # stamp2
        ((2.5, 1, 0), (0.5, 1, 0.5), False, True),
        ((-2.5, 0.25, 0), (0.5, 1, 0.2), False, True),  # stamp3
        ((2.5, 0.25, 0), (0.5, 1, 0.2), False, True),
        # hurdles (:691-755)
        ((0, -1.5, 0), (1.0, 0.1, 0.3), False, True),
        ((0, 0, 0), (1.0, 0.1, 0.3), False, True),
        ((0, 1.5, 0), (1.0, 0.1, 0.3), False, True),
        ((-1, -1, 0), (1.0, 0.1, 0.3), True, True),
        ((1, 1, 0), (1.0, 0.1, 0.3), True, True),
    ]
    return _pack(rows)


def to_scene(arena: FixedArena, generator=None, height_offset: Tuple[float, float] = (0.0, 0.0),
             batch: Tuple[int, ...] = (), dtype=torch.float32, device=None) -> BoxScene:
    """FixedArena -> BoxScene, with the reference randomize_height semantics:
    each *element* (never a wall) gets an independent uniform z offset drawn
    from `generator` (on the generator's device unless `device` is given)."""
    if device is None:
        device = generator.device if generator is not None else "cuda"
    dev = _device.resolve_device(device)
    b = tuple(batch)
    centers = torch.as_tensor(arena.centers, dtype=dtype, device=dev).expand(
        b + (CAPACITY, 3)).clone()
    if generator is not None and tuple(height_offset) != (0.0, 0.0):
        lo, hi = height_offset
        u = torch.rand(b + (CAPACITY,), generator=generator, dtype=dtype,
                       device=generator.device).to(dev)
        off = (lo + (hi - lo) * u) * torch.as_tensor(arena.element, dtype=dtype, device=dev)
        centers[..., 2] = centers[..., 2] + off
    return BoxScene(
        center=centers,
        half=torch.as_tensor(arena.halves, dtype=dtype, device=dev).expand(b + (CAPACITY, 3)),
        active=torch.as_tensor(arena.active, device=dev).expand(b + (CAPACITY,)),
        target_pos=torch.zeros(b + (3,), dtype=dtype, device=dev),
    )


def make_arena(version: str = "v2", generator=None,
               element_config: Optional[arena_gen.ArenaConfig] = None, holes: bool = False,
               small: bool = False, height_offset: Tuple[float, float] = (0.0, 0.0),
               batch: Tuple[int, ...] = (), dtype=torch.float32, device=None) -> BoxScene:
    """GameManager parity (reference max_game/game_manager.py:5-18):
    version selects the v1/v2/v3 fixed arenas or the procedural v4;
    height_offset is the reset-time randomize_height hook."""
    if version == "v4":
        if generator is None:
            raise ValueError("v4 is procedural; it needs a generator")
        cfg = element_config or arena_gen.ArenaConfig()
        b = tuple(batch)
        scenes = [arena_gen.generate(generator, cfg, dtype, device)
                  for _ in range(int(np.prod(b)) if b else 1)]
        if not b:
            return scenes[0]
        return BoxScene(*(torch.stack(x).reshape(b + x[0].shape) for x in zip(*scenes)))
    arenas = {
        "v1": lambda: arena_v1(small=small),
        "v2": lambda: arena_v2(holes=holes),
        "v3": arena_v3,
    }
    if version not in arenas:
        raise ValueError(f"unknown arena version {version!r}")
    return to_scene(arenas[version](), generator, height_offset, batch, dtype, device)
