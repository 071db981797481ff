"""Scene-as-data: axis-aligned box worlds with analytic perception queries.

Port of lifelike_tpu.scene.boxes. A scene is a fixed-size table of boxes
with an active mask (randomized per scenario without changing shapes), and
every ray query is a closed-form batched slab test:

  * heightmap_at: top-down height probe (percep_2d, 25x13 grid)
  * lidar: 128 horizontal rays (percep_1d), with the reference's miss
    semantics (miss -> hit position [0, 0, 0] -> distance |ray origin|)
  * perception_front: 25x13 forward depth rays (miss -> the full 3 m)

Rays see only boxes; the ground contributes height 0 through the miss path.
"""
import math
from typing import NamedTuple

import torch

from lifelike_tpu_torch import _device
from lifelike_tpu_torch.math import quat

LIDAR_RAYS = 128
LIDAR_LEN = 20.0
FRONT_LEN = 3.0


class BoxScene(NamedTuple):
    """Leaves broadcast over leading batch axes; N = fixed box capacity."""

    center: torch.Tensor  # (..., N, 3)
    half: torch.Tensor  # (..., N, 3)
    active: torch.Tensor  # (..., N) bool
    target_pos: torch.Tensor  # (..., 3)


def empty_scene(capacity, batch=(), dtype=torch.float32, device="cuda"):
    """A scene of `capacity` inactive boxes (and a target at the origin)."""
    device = _device.resolve_device(device)
    b = tuple(batch)
    return BoxScene(
        center=torch.zeros(b + (capacity, 3), dtype=dtype, device=device),
        half=torch.zeros(b + (capacity, 3), dtype=dtype, device=device),
        active=torch.zeros(b + (capacity,), dtype=torch.bool, device=device),
        target_pos=torch.zeros(b + (3,), dtype=dtype, device=device),
    )


def heightmap_at(scene: BoxScene, xy):
    """Terrain height at (..., P, 2) points: the highest top among covering
    active boxes, 0 on plain ground."""
    d = (xy[..., :, None, :] - scene.center[..., None, :, :2]).abs()
    inside = torch.all(d <= scene.half[..., None, :, :2], dim=-1)
    inside = inside & scene.active[..., None, :]
    top = scene.center[..., None, :, 2] + scene.half[..., None, :, 2]
    return torch.amax(torch.where(inside, top, torch.zeros_like(top)), dim=-1)


def _slab(o, d, lo, hi, eps=1e-9):
    """Per-axis slab entry/exit for rays o + t d against [lo, hi]."""
    safe = torch.where(d.abs() < eps, torch.where(d >= 0, eps, -eps).to(d.dtype), d)
    inv = 1.0 / safe
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    return torch.minimum(t0, t1), torch.maximum(t0, t1)


def ray_box_distance(scene: BoxScene, origin, direction, max_len):
    """First-hit distance of rays (..., R, 3 origin / direction) against all
    boxes; inf when no hit within max_len."""
    o = origin[..., :, None, :]  # (..., R, 1, 3)
    d = direction[..., :, None, :]
    lo = scene.center[..., None, :, :] - scene.half[..., None, :, :]
    hi = scene.center[..., None, :, :] + scene.half[..., None, :, :]
    tmin, tmax = _slab(o, d, lo, hi)
    t_entry = torch.amax(tmin, dim=-1)
    t_exit = torch.amin(tmax, dim=-1)
    hit = (t_entry <= t_exit) & (t_exit >= 0.0) & (t_entry <= max_len)
    t_hit = torch.where(t_entry >= 0.0, t_entry, torch.zeros_like(t_entry))  # inside -> 0
    t_hit = torch.where(hit & scene.active[..., None, :], t_hit,
                        torch.full_like(t_hit, math.inf))
    return torch.amin(t_hit, dim=-1)  # (..., R)


def lidar(scene: BoxScene, base_pos, yaw):
    """128-ray horizontal distances. base_pos (..., 3), yaw (...,). A miss
    reproduces the reference quirk: hit position [0, 0, 0], so the distance
    is |base_pos|."""
    rays = torch.arange(LIDAR_RAYS, dtype=base_pos.dtype, device=base_pos.device)
    angles = yaw[..., None] + 2.0 * math.pi * rays / LIDAR_RAYS
    direction = torch.stack(
        [torch.cos(angles), torch.sin(angles), torch.zeros_like(angles)], dim=-1
    )
    origin = torch.broadcast_to(base_pos[..., None, :], direction.shape)
    t = ray_box_distance(scene, origin, direction, LIDAR_LEN)
    miss_dist = torch.linalg.vector_norm(base_pos, dim=-1)[..., None]
    return torch.where(torch.isfinite(t) & (t <= LIDAR_LEN), t, miss_dist)


def _rect_grid(a_min, a_max, an, b_min, b_max, bn, dtype, device):
    """Row-major (a-major) flattened rectangle grid (reference
    utils/constants.py compute_terrain_rectangle)."""
    a = torch.linspace(a_min, a_max, an, dtype=dtype, device=device)
    b = torch.linspace(b_min, b_max, bn, dtype=dtype, device=device)
    A, Bg = torch.meshgrid(a, b, indexing="ij")
    return A.reshape(-1), Bg.reshape(-1)


def perception_height(scene: BoxScene, base_pos, base_orn):
    """25x13 top-down height grid in the base frame: x in [-1.2, 1.2] (25),
    y in [-0.6, 0.6] (13), rotated by the full base rotation."""
    gx, gy = _rect_grid(-1.2, 1.2, 25, -0.6, 0.6, 13, base_pos.dtype, base_pos.device)
    pts = torch.stack([gx, gy, torch.zeros_like(gx)], dim=-1)  # (325, 3)
    world = quat.rotate(base_orn[..., None, :], pts) + base_pos[..., None, :]
    h = heightmap_at(scene, world[..., :2])
    return h.reshape(tuple(h.shape[:-1]) + (25, 13))


def perception_front(scene: BoxScene, base_pos, base_orn):
    """25x13 forward depth rays: origins on the base-frame rectangle y in
    [-0.25, 0.25] (25) x z in [-0.3, 0.1] (13), direction +x (base frame),
    length 3 m; a miss reads 3 m."""
    gy, gz = _rect_grid(-0.25, 0.25, 25, -0.3, 0.1, 13, base_pos.dtype, base_pos.device)
    froms = torch.stack([torch.zeros_like(gy), gy, gz], dim=-1)  # (325, 3)
    dirs = torch.zeros_like(froms)
    dirs[..., 0] = 1.0
    o = quat.rotate(base_orn[..., None, :], froms) + base_pos[..., None, :]
    d = quat.rotate(base_orn[..., None, :], torch.broadcast_to(dirs, o.shape))
    t = torch.clamp_max(ray_box_distance(scene, o, d, FRONT_LEN), FRONT_LEN)
    return t.reshape(tuple(t.shape[:-1]) + (25, 13))


def _take_nearest(scene: BoxScene, dist, k):
    """The k boxes of least `dist` (inactive boxes at inf). A stable
    ascending sort puts the lower box index first among equal distances,
    as jax.lax.top_k does in the reference; torch.topk makes no such
    promise."""
    dist = torch.where(scene.active, dist, torch.full_like(dist, math.inf))
    d_sorted, idx = torch.sort(dist, stable=True)
    idx, d_sorted = idx[..., :k], d_sorted[..., :k]
    return BoxScene(
        center=scene.center[idx],
        half=scene.half[idx],
        active=scene.active[idx] & torch.isfinite(d_sorted),
        target_pos=scene.target_pos,
    )


def nearest_boxes(scene: BoxScene, pos, k):
    """Sub-scene of the k active boxes nearest to `pos` (3,) in the ground
    plane (unbatched scene)."""
    d = (pos[:2] - scene.center[..., :2]).abs() - scene.half[..., :2]
    dist = torch.linalg.vector_norm(torch.clamp_min(d, 0.0), dim=-1)
    return _take_nearest(scene, dist, k)


def nearest_boxes_corridor(scene: BoxScene, p0, p1, k):
    """Sub-scene of the k active boxes nearest the SEGMENT p0 -> p1 (the
    reachable corridor of a receding-horizon solve), ranked in the ground
    plane. p0/p1: (3,) world points; unbatched scene."""
    a = p0[:2]
    seg = p1[:2] - a
    seg_len2 = torch.sum(seg * seg) + 1e-12
    t = torch.clamp((scene.center[..., :2] - a) @ seg / seg_len2, 0.0, 1.0)
    q = a + t[..., None] * seg  # (N, 2)
    d = (q - scene.center[..., :2]).abs() - scene.half[..., :2]
    dist = torch.linalg.vector_norm(torch.clamp_min(d, 0.0), dim=-1)
    return _take_nearest(scene, dist, k)


def terrain_height_fn(scene: BoxScene):
    """Heightmap-only terrain for the physics engines: p (..., 4, 3) ->
    (heights (..., 4), normals +z). Box tops act as raised ground and
    vertical faces exert no force; pass the scene itself to
    engine.control_step(scene=...) for the full box contact."""

    def fn(p):
        h = heightmap_at(scene, p[..., :2])
        n = torch.zeros_like(p)
        n[..., 2] = 1.0
        return h, n

    return fn
