"""Visualization: segment outlines/ids drawn on camera images, observation
mask overlays, and 3D object-map renders (host copy of roman_tpu/viz.py).

Parity with reference roman/viz.py (visualize_map_on_img :17-42,
visualize_observations_on_img :44-84, 3D view :86-276) and
roman/align/align_viz.py. The reference renders 3D through open3d
offscreen; here matplotlib 3D serves that role (no GL dependency).

matplotlib and OpenCV are imported inside the functions that draw or
write video, so the module imports where they are missing (the machine
with the card has no matplotlib); a function that needs one raises an
ImportError naming it there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from roman_tpu_torch.utils import require


def pyplot(what: str):
    """matplotlib.pyplot on the offscreen Agg backend."""
    require("matplotlib", what).use("Agg")
    return require("matplotlib.pyplot", what)


def _seg_color(seg_id: int):
    rng = np.random.default_rng(seg_id)
    return tuple(int(c) for c in rng.integers(0, 255, 3))


def visualize_map_on_img(img: np.ndarray, pose: np.ndarray, segments) -> np.ndarray:
    """Draw 2D convex-hull outlines + ids of mapped segments (reference
    viz.py:17-42). img: (H, W, 3) uint8 BGR/RGB; pose: T_world_camera."""
    cv = require("cv2", "visualize_map_on_img")
    out = img.copy()
    for seg in segments:
        outline = seg.outline_2d(pose)
        if outline is None or len(outline) < 2:
            continue
        color = _seg_color(seg.id)
        pts = outline.astype(np.int32).reshape(-1, 1, 2)
        cv.polylines(out, [pts], isClosed=True, color=color, thickness=2)
        c = pts.reshape(-1, 2).mean(axis=0).astype(int)
        cv.putText(out, str(seg.id), tuple(c), cv.FONT_HERSHEY_SIMPLEX, 0.5,
                   color, 1, cv.LINE_AA)
    return out


def visualize_observations_on_img(img: np.ndarray, observations) -> np.ndarray:
    """Overlay observation masks (reference viz.py:44-84)."""
    out = img.astype(np.float32)
    for k, obs in enumerate(observations):
        if obs.mask is None:
            continue
        color = np.array(_seg_color(k), np.float32)
        m = obs.mask.astype(bool)
        out[m] = 0.55 * out[m] + 0.45 * color
    return out.astype(np.uint8)


def plot_map_3d(segments, ax=None, color_by_id: bool = True, trajectory=None,
                max_points_per_seg: int = 200, time_range=None,
                show_labels: bool = False, show_origin: bool = False):
    """3D scatter of the object map + trajectory (open3d third-person view
    equivalent, viz.py:86-276; time_range/show_labels/show_origin mirror
    the reference visualize_3d flags, demo/o3d_viz.py:17-27)."""
    plt = pyplot("plot_map_3d")

    if ax is None:
        fig = plt.figure(figsize=(8, 8))
        ax = fig.add_subplot(projection="3d")
    for seg in segments:
        if time_range is not None:
            first = getattr(seg, "first_seen", None)
            last = getattr(seg, "last_seen", first)
            if first is not None and (last < time_range[0]
                                      or first > time_range[1]):
                continue
        pts = getattr(seg, "points", None)
        if pts is None:
            c = np.asarray(seg.center).reshape(1, 3)
            pts = c
        if len(pts) > max_points_per_seg:
            # ceil stride so the cap actually holds (floor stride lets
            # lengths just above the cap plot up to ~2x of it)
            pts = pts[:: -(-len(pts) // max_points_per_seg)]
        col = np.array(_seg_color(seg.id)) / 255.0 if color_by_id else None
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=2, color=col)
        if show_labels:
            c = np.asarray(seg.center).reshape(3)
            ax.text(c[0], c[1], c[2], str(seg.id), fontsize=6)
    if show_origin:
        for axis, col in zip(np.eye(3), ("r", "g", "b")):
            ax.plot([0, axis[0]], [0, axis[1]], [0, axis[2]], color=col)
    if trajectory is not None:
        tr = np.asarray(trajectory)
        ax.plot(tr[:, 0, 3], tr[:, 1, 3], tr[:, 2, 3], color="black", linewidth=1)
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.set_zlabel("z (m)")
    return ax


def plot_registration_3d(submap1, submap2, associations: np.ndarray, ax=None,
                         z_lift: float = 5.0):
    """Two submaps + association lines (align_viz.py equivalent)."""
    plt = pyplot("plot_registration_3d")

    if ax is None:
        fig = plt.figure(figsize=(8, 8))
        ax = fig.add_subplot(projection="3d")
    c1 = np.stack([np.asarray(s.center).reshape(3) for s in submap1.segments])
    c2 = np.stack([np.asarray(s.center).reshape(3) for s in submap2.segments])
    ax.scatter(c1[:, 0], c1[:, 1], c1[:, 2], color="maroon", s=12, label="submap 1")
    ax.scatter(c2[:, 0], c2[:, 1], c2[:, 2] + z_lift, color="blue", s=12,
               label="submap 2 (+z)")
    for a, b in np.asarray(associations).reshape(-1, 2):
        ax.plot([c1[a, 0], c2[b, 0]], [c1[a, 1], c2[b, 1]],
                [c1[a, 2], c2[b, 2] + z_lift], color="lawngreen", linewidth=0.8)
    ax.legend()
    return ax


def plot_correspondences(map1, map2, correspondences: np.ndarray, ax=None):
    """2D correspondence plot (reference roman/utils.py:21-48)."""
    plt = pyplot("plot_correspondences")

    if ax is None:
        _, ax = plt.subplots()
    c1 = np.stack([np.asarray(o.center).reshape(3) for o in map1])
    c2 = np.stack([np.asarray(o.center).reshape(3) for o in map2])
    ax.scatter(c1[:, 0], c1[:, 1], color="maroon", s=10)
    ax.scatter(c2[:, 0], c2[:, 1], color="blue", s=10)
    for a, b in np.asarray(correspondences).reshape(-1, 2):
        ax.plot([c1[a, 0], c2[b, 0]], [c1[a, 1], c2[b, 1]],
                color="lawngreen", linestyle="dotted")
    ax.set_aspect("equal")
    return ax


# ------------------------------------------------------------------------ #
# offscreen 3D rendering + video compositing (reference viz.py:86-276:
# open3d offscreen third-person render composited next to the camera
# image; matplotlib-Agg serves as the GL-free renderer here)
# ------------------------------------------------------------------------ #

def render_map_frame(segments, trajectory, pose, t: Optional[float] = None,
                     view_radius: float = 20.0, figsize=(5, 5),
                     dpi: int = 100) -> np.ndarray:
    """One third-person 3D frame of the map around the current pose.

    segments: SegmentData list (only those first_seen <= t are drawn when
    t is given); trajectory (T, 4, 4) poses up to now; pose (4, 4) current.
    Returns an RGB uint8 image.
    """
    plt = pyplot("render_map_frame")

    fig = plt.figure(figsize=figsize, dpi=dpi)
    ax = fig.add_subplot(projection="3d")
    p = np.asarray(pose)[:3, 3]
    for seg in segments:
        if t is not None and getattr(seg, "first_seen", 0.0) > t:
            continue
        c = np.asarray(seg.center).reshape(3)
        if np.linalg.norm(c[:2] - p[:2]) > view_radius:
            continue
        col = np.array(_seg_color(seg.id)) / 255.0
        ax.scatter([c[0]], [c[1]], [c[2]], s=14, color=col)
        if getattr(seg, "extent", None) is not None:
            e = np.asarray(seg.extent).reshape(3) / 2.0
            # wireframe AABB around the center
            corners = c + np.array([[sx, sy, sz] for sx in (-e[0], e[0])
                                    for sy in (-e[1], e[1])
                                    for sz in (-e[2], e[2])])
            for a, b in ((0, 1), (0, 2), (0, 4), (3, 1), (3, 2), (3, 7),
                         (5, 1), (5, 4), (5, 7), (6, 2), (6, 4), (6, 7)):
                ax.plot(*zip(corners[a], corners[b]), color=col,
                        linewidth=0.5, alpha=0.6)
    tr = np.asarray(trajectory)
    if len(tr):
        ax.plot(tr[:, 0, 3], tr[:, 1, 3], tr[:, 2, 3], color="black",
                linewidth=1.5)
    ax.scatter([p[0]], [p[1]], [p[2]], color="red", s=40, marker="^")
    ax.set_xlim(p[0] - view_radius, p[0] + view_radius)
    ax.set_ylim(p[1] - view_radius, p[1] + view_radius)
    ax.set_zlim(p[2] - 5.0, p[2] + 5.0)
    # third-person view: elevated, behind the robot's heading
    yaw = np.degrees(np.arctan2(pose[1, 0], pose[0, 0]))
    ax.view_init(elev=35.0, azim=yaw + 180.0)
    ax.set_axis_off()
    fig.tight_layout(pad=0)
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return img


def compose_frames(cam_img: Optional[np.ndarray],
                   map_img: np.ndarray) -> np.ndarray:
    """Side-by-side composite of the camera image and the 3D render
    (reference run.py:169-198 visualization compositing)."""
    if cam_img is None:
        return map_img
    cam = np.asarray(cam_img)
    if cam.dtype != np.uint8:
        cam = (np.clip(cam, 0, 1) * 255).astype(np.uint8)
    if cam.ndim == 2:
        cam = np.stack([cam] * 3, axis=-1)
    h = map_img.shape[0]
    if cam.shape[0] != h:
        cv = require("cv2", "compose_frames")
        w = int(cam.shape[1] * h / cam.shape[0])
        cam = cv.resize(cam, (w, h))
    return np.concatenate([cam, map_img], axis=1)


def write_video(frames, path: str, fps: float = 6.0) -> str:
    """Write frames (list of HxWx3 uint8) to a video file. Falls back from
    mp4 to MJPG avi when the codec is unavailable."""
    cv = require("cv2", "write_video")
    assert len(frames), "no frames"
    h, w = frames[0].shape[:2]
    attempts = [(path, "mp4v")] if path.endswith(".mp4") else []
    attempts.append((path.rsplit(".", 1)[0] + ".avi", "MJPG"))
    for out_path, codec in attempts:
        vw = cv.VideoWriter(out_path, cv.VideoWriter_fourcc(*codec), fps,
                            (w, h))
        if not vw.isOpened():
            continue
        for f in frames:
            if f.shape[:2] != (h, w):
                f = cv.resize(f, (w, h))
            vw.write(cv.cvtColor(f, cv.COLOR_RGB2BGR))
        vw.release()
        return out_path
    raise RuntimeError("no usable video codec (tried mp4v, MJPG)")


def render_map_video(roman_map, path: str, fps: float = 6.0,
                     stride: int = 4, view_radius: float = 20.0,
                     cam_imgs=None) -> str:
    """Third-person map-building video over a RomanMap's trajectory
    (reference viz.py:86-276 composited video)."""
    frames = []
    traj = np.asarray(roman_map.trajectory)
    times = np.asarray(roman_map.times)
    for k in range(0, len(times), max(stride, 1)):
        img = render_map_frame(roman_map.segments, traj[: k + 1], traj[k],
                               t=float(times[k]), view_radius=view_radius)
        cam = cam_imgs[k] if cam_imgs is not None else None
        frames.append(compose_frames(cam, img))
    return write_video(frames, path, fps)
