"""Point-cloud maintenance ops: statistical outlier removal and the
largest DBSCAN cluster, batched over padded point buffers, with numpy
twins for the host mapper.

Port of roman_tpu/ops/pointcloud.py, the counterparts of the open3d calls
in the reference's Segment (_cleanup_points, segment.py:177-193;
final_cleanup, segment.py:195-220). The host twin of the cluster mask
runs DBSCAN with scipy's cKDTree and the connected components of the
core graph; roman_tpu calls scikit-learn, which the port does not need.
"""

from __future__ import annotations

import numpy as np
import torch

_BIG = 1e9


def _pair_d2(points: torch.Tensor) -> torch.Tensor:
    """(..., n, n) squared distances, summed x, y, z in that order, one
    coordinate at a time (no (..., n, n, 3) intermediate)."""
    d2 = None
    for x in points.unbind(-1):
        d = x[..., :, None] - x[..., None, :]
        d2 = d * d if d2 is None else d2 + d * d
    return d2


def statistical_outlier_mask(points: torch.Tensor, mask: torch.Tensor,
                             nb_neighbors: int = 10,
                             std_ratio: float = 1.0) -> torch.Tensor:
    """Keep-mask of statistical outlier removal, o3d-exact
    (RemoveStatisticalOutliers, reference segment.py:183-184): a point's
    statistic is the mean distance to its nb_neighbors nearest points,
    itself included (distance 0); the cloud's std uses N - 1; a point is
    kept iff 0 < avg < mean + std_ratio * std.

    points (..., n, 3), mask (..., n) -> keep (..., n), a subset of mask.
    Only the k smallest distances' values matter, so topk's order of
    equal values does not."""
    d2 = _pair_d2(points)
    pair_ok = mask[..., :, None] & mask[..., None, :]
    d2 = torch.where(pair_ok, d2, torch.full_like(d2, _BIG))
    k = min(nb_neighbors, points.shape[-2])
    knn_d2 = torch.topk(d2, k, dim=-1, largest=False).values
    knn_d = torch.sqrt(torch.clamp(knn_d2, min=0.0))
    knn_valid = knn_d < float(np.sqrt(_BIG)) * 0.5
    nvalid = torch.clamp(knn_valid.sum(dim=-1), min=1)
    mean_d = torch.where(knn_valid, knn_d, torch.zeros_like(knn_d)).sum(dim=-1) / nvalid

    mf = mask.to(points.dtype)
    n = torch.clamp(mf.sum(dim=-1), min=1.0)
    mu = (mean_d * mf).sum(dim=-1) / n
    var = ((mean_d - mu[..., None]) ** 2 * mf).sum(dim=-1) / torch.clamp(n - 1.0, min=1.0)
    thresh = mu + std_ratio * torch.sqrt(var)
    return mask & (mean_d > 0.0) & (mean_d < thresh[..., None])


def largest_cluster_mask(points: torch.Tensor, mask: torch.Tensor,
                         eps: float = 0.25, min_points: int = 10,
                         adaptive_spacing_factor: float | None = None
                         ) -> torch.Tensor:
    """Keep-mask of the largest DBSCAN cluster (reference final_cleanup,
    segment.py:195-220), batched over leading dims.

    As sklearn's DBSCAN: core points have >= min_points neighbors within
    eps (self included); clusters are the connected components of the
    core-core eps graph (transitive closure by ceil(log2 P) squarings of
    the float adjacency, exact in f32 with TF32 off); a cluster's label is
    its lowest core index, and a border point joins the lowest label among
    the cores within eps. With no cluster every point is kept.

    adaptive_spacing_factor: the row's eps becomes max(eps, factor *
    median nearest-neighbor distance), for pools stored at a coarsened
    resolution (roman_tpu/ops/pointcloud.py:56-88).

    points (..., P, 3), mask (..., P) -> keep (..., P), a subset of mask.
    """
    P = points.shape[-2]
    d2 = _pair_d2(points)
    pair_ok = mask[..., :, None] & mask[..., None, :]
    eye = torch.eye(P, dtype=torch.bool, device=points.device)
    if adaptive_spacing_factor is not None:
        nn_d2 = torch.where(pair_ok & ~eye, d2, torch.full_like(d2, _BIG)).min(dim=-1).values
        nn_d = torch.sqrt(torch.where(mask & (nn_d2 < _BIG * 0.5), nn_d2,
                                      torch.zeros_like(nn_d2)))
        ok = mask & (nn_d > 0)
        srt = torch.sort(torch.where(ok, nn_d, torch.full_like(nn_d, float("inf"))),
                         dim=-1).values
        nvalid = ok.sum(dim=-1)
        mid = torch.clamp(torch.div(nvalid - 1, 2, rounding_mode="floor"), 0, P - 1)
        med = torch.gather(srt, -1, mid[..., None])[..., 0]
        med = torch.where(torch.isfinite(med), med, torch.zeros_like(med))
        eps_eff = torch.clamp(adaptive_spacing_factor * med, min=eps)
        eps2 = (eps_eff * eps_eff)[..., None, None]
    else:
        eps2 = eps * eps
    within = pair_ok & (d2 <= eps2)             # self included (d2 = 0)
    n_nbr = within.sum(dim=-1)
    core = mask & (n_nbr >= min_points)

    adj = (within & core[..., :, None] & core[..., None, :]).to(torch.float32)
    n_sq = max(int(np.ceil(np.log2(max(P, 2)))), 1)
    for _ in range(n_sq):
        adj = torch.clamp(adj + torch.matmul(adj, adj), max=1.0)
    reach = adj > 0.5

    idx = torch.arange(P, device=points.device)
    big = torch.full((), P, dtype=torch.int64, device=points.device)
    core_label = torch.where(reach, idx, big).min(dim=-1).values
    core_label = torch.where(core, core_label, big)
    border_label = torch.where(within & core[..., None, :],
                               core_label[..., None, :], big).min(dim=-1).values
    label = torch.where(core, core_label, torch.where(mask, border_label, big))

    member = (label[..., :, None] == idx) & (label < P)[..., :, None]
    counts = member.sum(dim=-2)                 # size of the cluster rooted at idx
    best = torch.argmax(counts, dim=-1)
    any_cluster = counts.max(dim=-1).values > 0
    keep = label == best[..., None]
    return mask & torch.where(any_cluster[..., None], keep, torch.ones_like(keep))


# ---------------------------------------------------------------------------
# numpy twins (host mapper)
# ---------------------------------------------------------------------------

def dbscan_labels_np(points: np.ndarray, eps: float, min_points: int) -> np.ndarray:
    """sklearn.cluster.DBSCAN(eps, min_samples=min_points).labels_ with
    scipy: neighbors within eps (self included, distance <= eps), core
    points with >= min_points neighbors, clusters the connected components
    of the core graph numbered in the order of their lowest core index,
    a border point in the lowest-numbered cluster with a core within eps,
    -1 for noise."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree

    pts = np.asarray(points, np.float64)
    n = len(pts)
    nbrs = cKDTree(pts).query_ball_point(pts, r=eps)
    core = np.array([len(x) >= min_points for x in nbrs], bool)
    labels = np.full(n, -1, np.int64)
    if not core.any():
        return labels
    rows = np.concatenate([np.full(len(x), i) for i, x in enumerate(nbrs)])
    cols = np.concatenate([np.asarray(x, np.int64) for x in nbrs])
    cc = core[rows] & core[cols]
    graph = coo_matrix((np.ones(cc.sum()), (rows[cc], cols[cc])), shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    core_idx = np.flatnonzero(core)
    # number the components of core points by their lowest core index
    first_core = {}
    for i in core_idx:
        first_core.setdefault(comp[i], i)
    order = sorted(first_core, key=first_core.get)
    number = {c: k for k, c in enumerate(order)}
    labels[core_idx] = [number[comp[i]] for i in core_idx]
    for i in np.flatnonzero(~core):
        near = [labels[j] for j in nbrs[i] if core[j]]
        if near:
            labels[i] = min(near)
    return labels


def largest_cluster_mask_np(points: np.ndarray, eps: float = 0.25,
                            min_points: int = 10) -> np.ndarray:
    """Keep-mask of the largest DBSCAN cluster (reference final_cleanup,
    segment.py:195-220), host side. Where everything is noise all points
    are kept (the reference's argmax over an empty array would throw)."""
    pts = np.asarray(points)
    if len(pts) == 0:
        return np.zeros(0, dtype=bool)
    labels = dbscan_labels_np(pts, eps, min_points)
    valid = labels >= 0
    if not np.any(valid):
        return np.ones(len(pts), dtype=bool)
    largest = np.argmax(np.bincount(labels[valid]))
    return labels == largest


def statistical_outlier_mask_np(points: np.ndarray, nb_neighbors: int = 10,
                                std_ratio: float = 1.0) -> np.ndarray:
    """Numpy twin of statistical_outlier_mask (o3d
    remove_statistical_outlier): squared distances by the Gram trick and
    the k nearest by np.partition."""
    pts = np.asarray(points, np.float64)
    n = len(pts)
    if n <= 1:
        return np.ones(n, dtype=bool)
    sq = np.einsum("ij,ij->i", pts, pts)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (pts @ pts.T)
    np.fill_diagonal(d2, 0.0)
    k = min(nb_neighbors, n)
    part = np.partition(d2, k - 1, axis=1)[:, :k]
    mean_d = np.sqrt(np.maximum(part, 0.0)).mean(axis=1)
    thresh = mean_d.mean() + std_ratio * mean_d.std(ddof=1)
    return (mean_d > 0.0) & (mean_d < thresh)
