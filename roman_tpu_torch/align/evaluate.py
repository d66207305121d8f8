"""Offline alignment evaluation: success rates by viewpoint change,
loop-closure precision/recall sweeps with AUC, place-recognition recall
(host copy of roman_tpu/align/evaluate.py).

Parity with reference roman/align/evaluate.py (SubmapAlignEvaluator):
- alignment success rate bucketed by GT yaw difference 0/90/180 deg
  (:211-231, buckets at <30 / 30-150 / >150 per :30-35)
- LC precision/recall with TP = robots-nearby AND predicted AND
  pose-correct (:233-288)
- PR sweeps over the #associations (or submap-similarity) threshold ->
  AUC (:290-322)
- place-recognition recall@1 over the aggregated similarity matrix
  (:324-396)
- timing summary (:398-406)
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from roman_tpu_torch.align.results import SubmapAlignResults


@dataclasses.dataclass
class EvalParams:
    angle_threshold_deg: float = 10.0
    distance_threshold_m: float = 5.0
    nearby_threshold_m: Optional[float] = None  # default: use robots_nearby mask
    min_assoc: int = 4
    # place recognition (reference evaluate.py EvalParams :36-58)
    evaluation_distance_m: float = 10.0
    place_rec_overlap_dist: float = 30.0
    place_rec_require_pose_success: bool = False
    place_rec_rm_no_overlap_queries: bool = True
    place_rec_sweep_num_assoc: tuple = (0, 20)
    # camera-frustum overlap filtering (reference :436-502)
    rm_non_camera_overlap: bool = False
    cam_view_dist_bounds: tuple = (0.0, 20.0)
    T_ij_uses_rdf: bool = False


@dataclasses.dataclass
class PR:
    precision: float
    recall: float
    tp: int
    fp: int
    fn: int


@dataclasses.dataclass
class PRSweep:
    thresholds: np.ndarray
    precisions: np.ndarray
    recalls: np.ndarray

    @property
    def auc(self) -> float:
        """Area under the PR curve (trapezoid over recall); thresholds
        with no predictions (nan precision) are skipped."""
        ok = np.isfinite(self.precisions) & np.isfinite(self.recalls)
        rs = self.recalls[ok]
        ps = self.precisions[ok]
        if len(rs) == 0:
            return float("nan")
        order = np.argsort(rs)
        r = np.concatenate([[0.0], rs[order]])
        p = np.concatenate([[ps[order[0]]], ps[order]])
        return float(np.trapezoid(p, r))


# --------------------------------------------------------------------- #
# camera frustum overlap (reference evaluate.py:436-502, sans shapely)
# --------------------------------------------------------------------- #

def _convex_polys_intersect(a: np.ndarray, b: np.ndarray) -> bool:
    """Separating-axis test for two convex 2D polygons (n, 2)."""
    for poly in (a, b):
        n = len(poly)
        for i in range(n):
            edge = poly[(i + 1) % n] - poly[i]
            axis = np.array([-edge[1], edge[0]])
            pa = a @ axis
            pb = b @ axis
            if pa.max() < pb.min() or pb.max() < pa.min():
                return False
    return True


def camera_trapezoid(cam_pose: np.ndarray, K: np.ndarray, width: float,
                     height: float, dist_bounds=(0.0, 20.0)) -> np.ndarray:
    """Ground-plane (XY) trapezoid of the camera's view between the near
    and far distance bounds (reference _get_camera_trapezoid_views)."""
    near, far = dist_bounds
    uvd = np.array([
        [0.0, height / 2, near],
        [0.0, height / 2, far],
        [width, height / 2, far],
        [width, height / 2, near],
    ])
    Kinv = np.linalg.inv(K)
    pts = (Kinv @ np.stack([uvd[:, 0], uvd[:, 1], np.ones(4)], axis=0)) * uvd[:, 2]
    pts_cam = pts.T  # (4, 3) RDF camera frame
    pts_w = pts_cam @ cam_pose[:3, :3].T + cam_pose[:3, 3]
    return pts_w[:, :2]


def camera_views_overlap(T_c1_c2: np.ndarray, cam1, cam2,
                         dist_bounds=(0.0, 20.0),
                         T_ij_uses_rdf: bool = False) -> bool:
    """Do the two cameras' view trapezoids intersect in the ground plane?
    (reference _camera_views_overlap, evaluate.py:465-486)."""
    from roman_tpu_torch.params.data_params import T_FLURDF

    if T_ij_uses_rdf:
        pose1 = T_FLURDF
        pose2 = T_FLURDF @ T_c1_c2
    else:
        pose1 = T_FLURDF
        pose2 = T_c1_c2 @ T_FLURDF
    t1 = camera_trapezoid(pose1, cam1.K, cam1.width, cam1.height, dist_bounds)
    t2 = camera_trapezoid(pose2, cam2.K, cam2.width, cam2.height, dist_bounds)
    return _convex_polys_intersect(t1, t2)


def rm_non_camera_overlap(results: SubmapAlignResults, cam1, cam2,
                          params: EvalParams) -> SubmapAlignResults:
    """Mark nearby pairs whose camera frustums cannot overlap as
    not-nearby (reference _rm_non_camera_overlap, evaluate.py:437-451)."""
    nearby = results.robots_nearby_mat
    for i in range(nearby.shape[0]):
        for j in range(nearby.shape[1]):
            if not np.isnan(nearby[i, j]) and not camera_views_overlap(
                results.T_ij_mat[i, j], cam1, cam2,
                params.cam_view_dist_bounds, params.T_ij_uses_rdf,
            ):
                nearby[i, j] = np.nan
    return results


class SubmapAlignEvaluator:
    def __init__(self, results: List[SubmapAlignResults],
                 params: EvalParams = EvalParams(),
                 robot_pairs: Optional[List[tuple]] = None,
                 camera_params: Optional[list] = None):
        """results: one SubmapAlignResults per robot pair. robot_pairs
        gives each result's (i, j) robot indices for multi-robot
        aggregation (defaults to all i<j pairs in order, the reference's
        robot_pairs property). camera_params (per robot) enables
        rm_non_camera_overlap."""
        self.params = params
        if robot_pairs is None:
            n = int(np.ceil((1 + np.sqrt(1 + 8 * len(results))) / 2))
            robot_pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
            robot_pairs = robot_pairs[:len(results)]
        self.robot_pairs = robot_pairs
        self.n_robots = max(max(p) for p in robot_pairs) + 1 if robot_pairs else 2
        if params.rm_non_camera_overlap and camera_params is not None:
            results = [
                rm_non_camera_overlap(r, camera_params[i], camera_params[j],
                                      params)
                for r, (i, j) in zip(results, robot_pairs)
            ]
        self.results = results

    # ---- multi-robot block aggregation (reference :510-584) ----
    def _aggregate_matrix(self, name: str) -> np.ndarray:
        by_pair = {p: getattr(r, name) for p, r in zip(self.robot_pairs,
                                                       self.results)}
        sizes = {}
        for (i, j), m in by_pair.items():
            sizes[i] = m.shape[0]
            sizes[j] = m.shape[1]
        blocks = []
        for i in range(self.n_robots):
            row = []
            for j in range(self.n_robots):
                if (i, j) in by_pair:
                    row.append(np.asarray(by_pair[(i, j)], float))
                elif (j, i) in by_pair:
                    row.append(np.asarray(by_pair[(j, i)], float).T)
                else:
                    row.append(np.full((sizes.get(i, 0), sizes.get(j, 0)),
                                       np.nan))
            blocks.append(np.concatenate(row, axis=1))
        return np.concatenate(blocks, axis=0)

    # ---- flattened views over all robot pairs ----
    def _collect(self):
        rows = []
        for res in self.results:
            nearby = ~np.isnan(res.robots_nearby_mat)
            n0, n1 = res.clipper_num_associations.shape
            for i in range(n0):
                for j in range(n1):
                    rows.append(dict(
                        nearby=bool(nearby[i, j]),
                        yaw=res.submap_yaw_diff_mat[i, j],
                        angle_err=res.clipper_angle_mat[i, j],
                        dist_err=res.clipper_dist_mat[i, j],
                        n_assoc=res.clipper_num_associations[i, j],
                        sim=(res.similarity_mat[i, j]
                             if res.similarity_mat is not None else np.nan),
                    ))
        return rows

    def _correct(self, row) -> bool:
        return (
            not np.isnan(row["angle_err"]) and not np.isnan(row["dist_err"])
            and row["angle_err"] < self.params.angle_threshold_deg
            and row["dist_err"] < self.params.distance_threshold_m
        )

    def evaluate_align_success_rate(self):
        """Success rate per GT-yaw bucket (reference :211-231)."""
        buckets = {"0": [], "90": [], "180": []}
        for row in self._collect():
            if not row["nearby"] or np.isnan(row["yaw"]):
                continue
            if row["yaw"] < 30:
                b = "0"
            elif row["yaw"] < 150:
                b = "90"
            else:
                b = "180"
            buckets[b].append(self._correct(row))
        return {k: (float(np.mean(v)) if v else float("nan"), len(v))
                for k, v in buckets.items()}

    def evaluate_precision_recall(self, min_assoc: Optional[int] = None) -> PR:
        """Reference-exact PR (reference evaluate.py:233-288):
        TP = nearby AND predicted AND pose-correct; FP = predicted AND
        pose-INCORRECT (a nearby pair registered to the wrong transform
        is an FP even though it overlaps); recall denominator =
        num_relevant = ALL nearby pairs, so a nearby pair that was
        predicted-but-wrong still counts against recall — tp/(tp+fn)
        with fn only for unpredicted positives would inflate recall to
        1.0 on a grid where every nearby pair is predicted but half are
        misregistered."""
        thr = self.params.min_assoc if min_assoc is None else min_assoc
        tp = fp = num_relevant = 0
        for row in self._collect():
            predicted = (not np.isnan(row["n_assoc"])) and row["n_assoc"] >= thr
            positive = row["nearby"]
            correct = self._correct(row)
            num_relevant += positive
            if predicted and positive and correct:
                tp += 1
            elif predicted and not correct:
                fp += 1
        fn = num_relevant - tp
        precision = tp / max(tp + fp, 1)
        recall = tp / max(num_relevant, 1)
        return PR(precision, recall, tp, fp, fn)

    def evaluate_precision_recall_sweep(self, max_thresh: int = 40) -> PRSweep:
        threshs = np.arange(1, max_thresh + 1)
        ps, rs = [], []
        for t in threshs:
            pr = self.evaluate_precision_recall(min_assoc=int(t))
            ps.append(pr.precision)
            rs.append(pr.recall)
        return PRSweep(threshs, np.asarray(ps), np.asarray(rs))

    def recall_at_1(self) -> float:
        """Simple recall@1: for each query submap (row) with any nearby
        match, does the argmax-similarity column land on a nearby one?"""
        hits, total = 0, 0
        for res in self.results:
            if res.similarity_mat is None:
                score = np.nan_to_num(res.clipper_num_associations, nan=-1.0)
            else:
                score = np.nan_to_num(res.similarity_mat, nan=-np.inf)
            nearby = ~np.isnan(res.robots_nearby_mat)
            for i in range(score.shape[0]):
                if not nearby[i].any():
                    continue
                total += 1
                if nearby[i, int(np.argmax(score[i]))]:
                    hits += 1
        return hits / max(total, 1)

    def evaluate_place_recognition(self, num_associations_thresh: int = 3) -> PR:
        """Aggregated multi-robot place recognition (reference :324-396):
        the similarity score is the #associations block matrix over all
        robots; a query succeeds when its argmax column is within
        place_rec_overlap_dist (and optionally pose-correct)."""
        sim = self._aggregate_matrix("clipper_num_associations")
        dist = self._aggregate_matrix("robots_nearby_mat")
        eval_m = dist < self.params.evaluation_distance_m
        overlap = dist < self.params.place_rec_overlap_dist
        success = None
        if self.params.place_rec_require_pose_success:
            ang = self._aggregate_matrix("clipper_angle_mat")
            de = self._aggregate_matrix("clipper_dist_mat")
            success = ((ang <= self.params.angle_threshold_deg)
                       & (de <= self.params.distance_threshold_m))
        if self.params.place_rec_rm_no_overlap_queries:
            rows = np.any(eval_m, axis=1)
            cols = np.any(eval_m, axis=0)
            sim = sim[rows][:, cols]
            overlap = overlap[rows][:, cols]
            if success is not None:
                success = success[rows][:, cols]
        if sim.shape[0] == 0 or sim.shape[1] == 0:
            return PR(float("nan"), float("nan"), 0, 0, 0)
        sim_f = np.where(np.isnan(sim), -np.inf, sim)
        arg = np.argmax(sim_f, axis=1)
        rows = np.arange(sim.shape[0])
        max_sim = sim_f[rows, arg]
        rec0 = overlap[rows, arg].astype(bool)
        if success is not None:
            rec0 &= success[rows, arg].astype(bool)
        tp = int(np.sum((max_sim >= num_associations_thresh) & rec0))
        fp = int(np.sum((max_sim >= num_associations_thresh) & ~rec0))
        fn = int(np.sum((max_sim < num_associations_thresh) | ~rec0))
        p = tp / (tp + fp) if tp + fp > 0 else float("nan")
        r = tp / (tp + fn) if tp + fn > 0 else float("nan")
        return PR(p, r, tp, fp, fn)

    def evaluate_place_recognition_sweep(self) -> PRSweep:
        """Sweep the #associations threshold (reference :381-396)."""
        lo, hi = self.params.place_rec_sweep_num_assoc
        threshs = np.arange(lo, hi + 1)
        prs = [self.evaluate_place_recognition(int(t)) for t in threshs]
        return PRSweep(
            threshs,
            np.asarray([x.precision for x in prs]),
            np.asarray([x.recall for x in prs]),
        )

    def evaluate_timing(self):
        times = np.concatenate([np.asarray(r.timing_list) for r in self.results
                                if len(r.timing_list)])
        if len(times) == 0:
            return dict(mean=float("nan"), total=0.0, count=0)
        return dict(mean=float(np.mean(times)), total=float(np.sum(times)),
                    count=int(len(times)))

    def report(self) -> str:
        sr = self.evaluate_align_success_rate()
        pr = self.evaluate_precision_recall()
        sweep = self.evaluate_precision_recall_sweep()
        r1 = self.recall_at_1()
        prec_pr = self.evaluate_place_recognition()
        prec_sweep = self.evaluate_place_recognition_sweep()
        tm = self.evaluate_timing()
        lines = [
            "Alignment success rate by GT yaw difference:",
            *(f"  {k:>4} deg: {v[0]:.3f} ({v[1]} pairs)" for k, v in sr.items()),
            f"Loop closures (>= {self.params.min_assoc} assoc): "
            f"P={pr.precision:.3f} R={pr.recall:.3f} "
            f"(tp={pr.tp} fp={pr.fp} fn={pr.fn})",
            f"PR sweep AUC: {sweep.auc:.3f}",
            f"Place recognition recall@1: {r1:.3f}",
            f"Place recognition (aggregated, >=3 assoc): "
            f"P={prec_pr.precision:.3f} R={prec_pr.recall:.3f}",
            f"Place recognition sweep AUC: {prec_sweep.auc:.3f}",
            f"Registration timing: {tm['mean']*1e3:.2f} ms/pair avg over "
            f"{tm['count']} pairs ({tm['total']:.2f} s total)",
        ]
        return "\n".join(lines)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Evaluate submap alignment results")
    ap.add_argument("results", nargs="+", help="align .pkl result files "
                    "(one per robot pair, (0,1),(0,2),(1,2),... order)")
    ap.add_argument("--angle-thresh", type=float, default=10.0)
    ap.add_argument("--dist-thresh", type=float, default=5.0)
    ap.add_argument("--min-assoc", type=int, default=4)
    ap.add_argument("--rm-overlap", action="store_true",
                    help="drop nearby pairs whose camera frustums cannot "
                         "overlap (reference evaluate.py:436-502)")
    ap.add_argument("--cam", type=float, nargs=3, metavar=("W", "H", "F"),
                    default=(640.0, 480.0, 500.0),
                    help="camera width/height/focal for --rm-overlap")
    ap.add_argument("--overlap-dist-bounds", type=float, nargs=2,
                    default=(0.0, 20.0))
    args = ap.parse_args(argv)
    results = [SubmapAlignResults.load(p) for p in args.results]
    params = EvalParams(args.angle_thresh, args.dist_thresh,
                        min_assoc=args.min_assoc,
                        rm_non_camera_overlap=args.rm_overlap,
                        cam_view_dist_bounds=tuple(args.overlap_dist_bounds))
    cams = None
    if args.rm_overlap:
        from roman_tpu_torch.data.camera import CameraParams

        w, h, f = args.cam
        n = int(np.ceil((1 + np.sqrt(1 + 8 * len(results))) / 2))
        cams = [CameraParams.simple(width=int(w), height=int(h), f=f)] * n
    ev = SubmapAlignEvaluator(results, params, camera_params=cams)
    print(ev.report())


if __name__ == "__main__":
    main()
