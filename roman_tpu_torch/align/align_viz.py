"""Association geometries and their offscreen renders (port of
roman_tpu/align/align_viz.py; reference roman/align/align_viz.py:1-204
and demo/association_vid.py:63-317).

create_association_geometries returns plain arrays; the renders draw them with
matplotlib and the camera-frame video draws with OpenCV, as roman_tpu
does, pixel for pixel. Both packages are imported through
``utils.require`` inside the functions that draw, so the module imports
where they are missing (the machine with the card has no matplotlib) and a
function that needs one raises an ImportError naming it, before it
writes anything.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from roman_tpu_torch.data.camera import CameraParams
from roman_tpu_torch.data.pose_data import PoseData
from roman_tpu_torch.ops.geometry import convex_hull_2d
from roman_tpu_torch.utils import require
from roman_tpu_torch.viz import pyplot, write_video


def create_association_geometries(submap1, submap2, associations,
                                  T_align: Optional[np.ndarray] = None,
                                  z_lift: float = 0.0):
    """Geometry arrays for one registered submap pair.

    associations: (k, 2) indices into the two submaps' segment lists.
    T_align (4, 4) maps submap2's frame onto submap1's (applied when
    given, the reference's aligned view); z_lift offsets submap2 for the
    unaligned side-by-side view.

    Returns dict with centers1 (n, 3), centers2 (m, 3) (transformed),
    lines (k, 2, 3) association segments, colors1/colors2 (n/m, 3).
    """
    c1 = np.stack([np.asarray(s.center).reshape(3) for s in submap1.segments])
    c2 = np.stack([np.asarray(s.center).reshape(3) for s in submap2.segments])
    if T_align is not None:
        c2 = c2 @ np.asarray(T_align)[:3, :3].T + np.asarray(T_align)[:3, 3]
    else:
        c2 = c2 + np.array([0.0, 0.0, z_lift])
    assoc = np.asarray(associations).reshape(-1, 2)
    lines = np.stack([c1[assoc[:, 0]], c2[assoc[:, 1]]], axis=1) \
        if len(assoc) else np.zeros((0, 2, 3))
    colors1 = np.tile(np.array([[0.55, 0.0, 0.0]]), (len(c1), 1))  # maroon
    colors2 = np.tile(np.array([[0.0, 0.0, 0.8]]), (len(c2), 1))   # blue
    return dict(centers1=c1, centers2=c2, lines=lines,
                colors1=colors1, colors2=colors2)


def render_association_geometries(geoms: dict, ax=None, title: str = ""):
    """Draw geometry arrays from create_association_geometries."""
    plt = pyplot("render_association_geometries")

    if ax is None:
        fig = plt.figure(figsize=(8, 8))
        ax = fig.add_subplot(projection="3d")
    c1, c2 = geoms["centers1"], geoms["centers2"]
    ax.scatter(c1[:, 0], c1[:, 1], c1[:, 2], c=geoms["colors1"], s=14,
               label="submap 1")
    ax.scatter(c2[:, 0], c2[:, 1], c2[:, 2], c=geoms["colors2"], s=14,
               label="submap 2")
    for seg in geoms["lines"]:
        ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], color="lawngreen",
                linewidth=0.9)
    ax.legend()
    if title:
        ax.set_title(title)
    return ax


def align_viz(submaps1, submaps2, results, output_dir: str,
              num_req_assoc: int = 4, aligned: bool = True,
              z_lift: float = 5.0) -> List[str]:
    """Render every accepted loop-closure pair (reference align_viz.py):
    aligned=True applies the estimated T (overlapping view); otherwise the
    side-by-side +z view. Returns the written paths."""
    plt = pyplot("align_viz")

    os.makedirs(output_dir, exist_ok=True)
    na = results.clipper_num_associations
    written = []
    for i in range(na.shape[0]):
        for j in range(na.shape[1]):
            if not na[i, j] >= num_req_assoc:
                continue
            assoc = results.associated_objs_mat[i][j]
            if len(assoc) == 0:
                continue
            T = results.T_ij_hat_mat[i, j] if aligned else None
            if T is not None and not np.isfinite(T).all():
                T = None
            g = create_association_geometries(
                submaps1[i], submaps2[j], assoc, T_align=T,
                z_lift=0.0 if T is not None else z_lift)
            ax = render_association_geometries(
                g, title=f"submaps ({i}, {j}): {int(na[i, j])} assoc")
            path = os.path.join(output_dir, f"assoc_{i:03d}_{j:03d}.png")
            plt.savefig(path, dpi=120)
            plt.close("all")
            written.append(path)
    return written


def submap_viz(submaps, output_path: str, cols: int = 5):
    """Grid of per-submap object plots (reference submap_viz.py)."""
    plt = pyplot("submap_viz")

    n = len(submaps)
    rows = (n + cols - 1) // cols
    fig = plt.figure(figsize=(3 * cols, 3 * rows))
    for k, sm in enumerate(submaps):
        ax = fig.add_subplot(rows, cols, k + 1, projection="3d")
        c = np.stack([np.asarray(s.center).reshape(3) for s in sm.segments]) \
            if sm.segments else np.zeros((0, 3))
        if len(c):
            ax.scatter(c[:, 0], c[:, 1], c[:, 2], s=8)
        ax.set_title(f"submap {sm.id} ({len(c)} objs)", fontsize=8)
        ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(output_path, dpi=100)
    plt.close(fig)
    return output_path


# ---------------------------------------------------------------------------
# camera-frame association video (reference demo/association_vid.py:63-317)
# ---------------------------------------------------------------------------

def _project_outline(points_world, T_world_cam, camera):
    """2D convex hull (pixels) of a world-frame cloud seen by the camera,
    or None when nothing projects in front of / inside the frame
    (reference Segment.outline_2d path, segment.py:406-418)."""
    T = np.linalg.inv(T_world_cam)
    pc = points_world @ T[:3, :3].T + T[:3, 3]
    pc = pc[pc[:, 2] > 0.1]
    if len(pc) < 3:
        return None
    u = camera.fx * pc[:, 0] / pc[:, 2] + camera.cx
    v = camera.fy * pc[:, 1] / pc[:, 2] + camera.cy
    px = np.stack([u, v], axis=1)
    inside = ((px[:, 0] >= 0) & (px[:, 0] < camera.width)
              & (px[:, 1] >= 0) & (px[:, 1] < camera.height))
    px = px[inside]
    if len(px) < 3:
        return None
    return convex_hull_2d(px)


def _match_color(j):
    rng = np.random.default_rng(j * 7919 + 13)
    return tuple(int(c) for c in rng.integers(64, 255, 3))


def association_camera_video(results, submaps, roman_maps, out_path,
                             idx=None, fps=10.0, min_segment_dist=15.0,
                             time_buffer=1.0, camera=None, img_data=None,
                             show_ids=True):
    """Camera-frame association video for one submap pair: each frame
    composes the two robots' camera images side by side, overlays the
    MATCHED segments' reprojected outlines (consistent color per match)
    and draws a green line between the nearest outline pixels of each
    match visible in both views — the reference demo/association_vid.py
    capability (:226-315, camera_only layout) on the port's artifacts.

    results: SubmapAlignResults; submaps: [list, list] (segments in
    submap center frame, as built by submaps_from_roman_map); roman_maps:
    [RomanMap, RomanMap] (trajectory provides per-time camera poses).
    idx: (i, j) submap pair, default = argmax associations. img_data:
    optional [ImgData, ImgData]; when None (synthetic demo worlds have no
    camera recordings), a two-tone canvas stands in — the overlays still
    come from real point reprojections through the camera model.

    Returns (video_path, n_frames).
    """
    cv = require("cv2", "association_camera_video")
    if camera is None:
        camera = CameraParams.simple()
    if idx is None:
        num = np.nan_to_num(results.clipper_num_associations, nan=0.0)
        idx = np.unravel_index(np.argmax(num), num.shape)
    i0, j0 = int(idx[0]), int(idx[1])
    assoc = np.asarray(results.associated_objs_mat[i0][j0])
    assert len(assoc) > 0, "no associations between the chosen submaps"

    # segments back into each robot's odometry frame (reference :196-199)
    pair = [submaps[0][i0], submaps[1][j0]]
    matched = []
    for a, b in assoc:
        sa = pair[0].segments[int(a)].transformed(pair[0].pose_gravity_aligned)
        sb = pair[1].segments[int(b)].transformed(pair[1].pose_gravity_aligned)
        matched.append((sa, sb))

    # synchronized time windows over the matched segments (:132-149)
    ranges = []
    for i in range(2):
        t0 = min(s[i].first_seen for s in matched) - time_buffer
        tf = max(s[i].last_seen for s in matched) + time_buffer
        ranges.append([t0, tf])
    dur = min(r[1] - r[0] for r in ranges)
    for r in ranges:
        extra = (r[1] - r[0]) - dur
        r[0] += extra / 2
        r[1] -= extra / 2

    pose_data = [
        PoseData.from_times_and_poses(m.times, m.trajectory, time_tol=20.0)
        for m in roman_maps
    ]

    W, H = camera.width, camera.height
    frames = []
    for t in np.arange(0.0, dur, 1.0 / fps):
        canvas = np.zeros((H, 2 * W, 3), np.uint8)
        seen = np.zeros((len(matched), 2), bool)
        outlines = [[None] * 2 for _ in matched]
        for i in range(2):
            t_i = ranges[i][0] + t
            if img_data is not None and img_data[i] is not None:
                img = np.ascontiguousarray(img_data[i].nearest(t_i)[0][0])
                if img.shape[:2] != (H, W):
                    img = cv.resize(img, (W, H))
            else:
                img = np.full((H, W, 3), 235, np.uint8)
                img[H // 2:] = 205  # ground band
            T_wc = pose_data[i].pose(t_i)
            pos = T_wc[:3, 3]
            for j, segs in enumerate(matched):
                seg = segs[i]
                if seg.points is None:
                    continue
                if np.linalg.norm(np.asarray(seg.center).reshape(3) - pos) \
                        >= min_segment_dist:
                    continue
                outline = _project_outline(seg.points, T_wc, camera)
                if outline is None:
                    continue
                color = _match_color(j)
                pts = outline.astype(np.int32).reshape(-1, 1, 2)
                cv.polylines(img, [pts], isClosed=True, color=color,
                             thickness=2)
                if show_ids:
                    c = pts.reshape(-1, 2).mean(axis=0).astype(int)
                    cv.putText(img, str(j), tuple(c),
                               cv.FONT_HERSHEY_SIMPLEX, 0.6, color, 2,
                               cv.LINE_AA)
                seen[j, i] = True
                outlines[j][i] = outline + np.array([W * i, 0.0])
            canvas[:, W * i:W * (i + 1)] = img
        # green match lines between nearest outline pixels (:260-286)
        for j in range(len(matched)):
            if not seen[j].all():
                continue
            a, b = outlines[j]
            d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
            ia, ib = np.unravel_index(np.argmin(d), d.shape)
            cv.line(canvas, tuple(a[ia].astype(np.int32)),
                    tuple(b[ib].astype(np.int32)), (0, 255, 0), 2)
        frames.append(canvas)

    assert frames, "empty time window"
    out = write_video(frames, out_path, fps=fps)
    return out, len(frames)
