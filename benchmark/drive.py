"""The RGB-D drive the front-end cells map: a robot that drives a closed
loop through a room of boxes, rendered by ray casting on the card (or the
CPU) from the run's seed. Imports nothing of the program.

The room is an axis-aligned box (floor, walls, ceiling); the objects are
axis-aligned boxes on the floor, some of them close beside the loop so
that they fill much of a frame. Every face carries its object's colour,
a shade by its direction and a checker texture, so the images have edges.
The camera rides the loop (an ellipse at a fixed height) looking along it
with a seeded yaw wobble; poses continue around the loop as frames cycle.

Depth is the camera-frame z of the first hit, in metres (the ray of pixel
(u, v) is ((u - cx) / fx, (v - cy) / fy, 1) in the camera frame, so the
hit's parameter is its depth).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Drive:
    images: np.ndarray     # (N, H, W, 3) uint8
    depths: np.ndarray     # (N, H, W) float32 m
    poses: np.ndarray      # (N, 4, 4) float64 camera -> world
    dt: float

    def __len__(self):
        return len(self.images)

    def frame(self, t) -> np.ndarray:
        """Frame indices of times t (the loop cycles)."""
        return np.rint(np.asarray(t, np.float64) / self.dt).astype(np.int64) % len(self)


class LoopPoses:
    """Camera poses by time around the cycled loop (MapRunner's pose
    source: pose(t), t0, tf)."""

    def __init__(self, drive: Drive, t0: float, tf: float):
        self.drive, self.t0, self.tf = drive, t0, tf

    def pose(self, t):
        return self.drive.poses[int(self.drive.frame(t))]


def _boxes(scene: dict, rng: np.random.Generator, loop_xy) -> np.ndarray:
    """(n, 2, 3) lo/hi corners of the objects: `boxes` placed at random
    clear of the loop by `clearance_m`, and `near_boxes` beside it."""
    rx, ry = scene["room_m"][0] / 2, scene["room_m"][1] / 2
    out = []
    while len(out) < scene["boxes"]:
        size = rng.uniform(*scene["box_size_m"], size=3)
        c = rng.uniform([-rx + size[0], -ry + size[1]], [rx - size[0], ry - size[1]])
        gap = np.min(np.linalg.norm(loop_xy - c, axis=1)) - np.linalg.norm(size[:2]) / 2
        if gap >= scene["clearance_m"]:
            out.append(np.stack([[c[0] - size[0] / 2, c[1] - size[1] / 2, 0.0],
                                 [c[0] + size[0] / 2, c[1] + size[1] / 2, size[2]]]))
    for k in rng.choice(len(loop_xy), scene["near_boxes"], replace=False):
        size = rng.uniform(*scene["box_size_m"], size=3)
        a, b = loop_xy[k], loop_xy[(k + 1) % len(loop_xy)]
        side = np.array([b[1] - a[1], a[0] - b[0]])
        side /= max(np.linalg.norm(side), 1e-9)
        c = a + side * rng.choice([-1.0, 1.0]) * (np.linalg.norm(size[:2]) / 2
                                                  + scene["near_gap_m"])
        out.append(np.stack([[c[0] - size[0] / 2, c[1] - size[1] / 2, 0.0],
                             [c[0] + size[0] / 2, c[1] + size[1] / 2, size[2]]]))
    return np.asarray(out, np.float64)


def _loop(scene: dict, n: int, rng: np.random.Generator):
    """Positions (n, 3) and headings (n,) around the ellipse."""
    a, b = scene["loop_radii_m"]
    phase = rng.uniform(0, 2 * np.pi)
    sense = rng.choice([-1.0, 1.0])
    th = phase + sense * 2 * np.pi * np.arange(n) / n
    xy = np.stack([a * np.cos(th), b * np.sin(th)], 1)
    tangent = sense * np.stack([-a * np.sin(th), b * np.cos(th)], 1)
    k = rng.integers(2, 6)
    wobble = scene["yaw_wobble_rad"] * np.sin(k * th + rng.uniform(0, 2 * np.pi))
    heading = np.arctan2(tangent[:, 1], tangent[:, 0]) + wobble
    pos = np.concatenate([xy, np.full((n, 1), scene["camera_height_m"])], 1)
    return pos, heading


def _pose(pos, heading) -> np.ndarray:
    """Camera -> world: z along the heading, x to the right, y down."""
    f = np.array([np.cos(heading), np.sin(heading), 0.0])
    right = np.array([np.sin(heading), -np.cos(heading), 0.0])
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, [0.0, 0.0, -1.0], f, pos
    return T


def render(scene: dict, camera: dict, frames: int, dt: float, seed: int, device) -> Drive:
    """The drive of `frames` frames, from `seed`."""
    rng = np.random.default_rng([int(seed) % (2**63), 0xD41E])
    pos, heading = _loop(scene, frames, rng)
    boxes = _boxes(scene, rng, pos[:, :2])
    poses = np.stack([_pose(p, h) for p, h in zip(pos, heading)])
    nb = len(boxes)
    colours = rng.uniform(40, 230, size=(nb + 6, 3))
    checker = rng.uniform(*scene["checker_m"], size=nb + 6)
    H, W = camera["height"], camera["width"]
    fx, fy, cx, cy = camera["fx"], camera["fy"], camera["cx"], camera["cy"]
    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    v, u = torch.meshgrid(torch.arange(H, **f64), torch.arange(W, **f64), indexing="ij")
    rays_c = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1).reshape(-1, 3)
    lo = torch.as_tensor(boxes[:, 0], **f64)
    hi = torch.as_tensor(boxes[:, 1], **f64)
    rx, ry = scene["room_m"][0] / 2, scene["room_m"][1] / 2
    room_lo = torch.tensor([-rx, -ry, 0.0], **f64)
    room_hi = torch.tensor([rx, ry, scene["room_m"][2]], **f64)
    col = torch.as_tensor(colours, **f64)
    chk = torch.as_tensor(checker, **f64)
    shade = torch.tensor([0.75, 0.9, 1.0], **f64)
    images = np.empty((frames, H, W, 3), np.uint8)
    depths = np.empty((frames, H, W), np.float32)
    for i in range(frames):
        R = torch.as_tensor(poses[i, :3, :3], **f64)
        o = torch.as_tensor(poses[i, :3, 3], **f64)
        d = rays_c @ R.T                                           # (P, 3)
        inv = 1.0 / torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
        t1 = (lo[None] - o) * inv[:, None]                         # (P, nb, 3)
        t2 = (hi[None] - o) * inv[:, None]
        tmin, axis = torch.minimum(t1, t2).max(-1)
        tmax = torch.maximum(t1, t2).min(-1).values
        hit = (tmax >= tmin) & (tmin > 1e-6)
        tbox = torch.where(hit, tmin, torch.full_like(tmin, float("inf")))
        tb, ib = tbox.min(-1)
        ab = torch.gather(axis, 1, ib[:, None])[:, 0]
        # the room, seen from inside: the nearest exit face
        tr1 = (room_lo - o) * inv
        tr2 = (room_hi - o) * inv
        tr, ar = torch.maximum(tr1, tr2).min(-1)
        far = (torch.gather(tr2, 1, ar[:, None])[:, 0] == tr).long()
        in_box = tb < tr
        t = torch.where(in_box, tb, tr)
        # the room's six faces each have a colour of their own
        obj = torch.where(in_box, ib, nb + 2 * ar + far)
        ax = torch.where(in_box, ab, ar)
        pt = o + d * t[:, None]
        s = chk[obj]
        cell = torch.floor(pt / s[:, None]).long().sum(-1) % 2
        rgb = col[obj] * shade[ax][:, None] * (0.7 + 0.3 * cell.double())[:, None]
        images[i] = rgb.clamp(0, 255).round().to(torch.uint8).reshape(H, W, 3).cpu().numpy()
        depths[i] = t.to(torch.float32).reshape(H, W).cpu().numpy()
    return Drive(images=images, depths=depths, poses=poses, dt=dt)
