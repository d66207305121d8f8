"""A plain reference of the device mapper's frames, as the configuration
runs it (mapper_backend: device), written slot by slot in numpy with no
pool, graph or batching trick. Imports nothing of the program.

The device mapper's map carries on over thousands of frames, and a single
near-tie decided the other way (a point on a voxel boundary, an outlier
threshold) would part the two maps for good. So the reference follows the
program step by step: it starts from the program's own pool state before a
batch of frames and runs the batch's frames from the batch's inputs (the
observations the front end handed over), and the program's state after the
batch is held against it. What one frame does (in the program's order):

1. the observations' camera points go to the world by the frame's pose
   (float32 products);
2. association: each tracked (nursery or active) segment against each
   observation by the IoU of their occupied voxels at iou_voxel_size;
   pairs under the low end of geometric_score_range score nothing, the
   rest (iou - lo) / (hi - lo); an auction with rejection (eps 1e-3, 64
   sweeps, ties to the lower index) assigns observations to segments;
3. a matched segment takes the union of its points and the observation's,
   voxel means at segment_voxel_size, statistical outlier removal (10
   neighbours, one standard deviation, the point itself among its
   neighbours), and the means again at the finest of 1, 2 and 4 times
   the voxel size whose occupied voxels fit the pool row (past that, the
   row keeps the voxels of lowest hashed key); its descriptor is the
   running mean of its observations' descriptors, normalized; its
   sightings, last time and last robot position are updated;
4. the lifecycle, if the frame has an observation: nursery -> active at
   min_sightings; active -> inactive and nursery -> empty when unseen for
   max_t_no_sightings; inactive -> graveyard when unseen for
   segment_graveyard_time or when the robot is segment_graveyard_dist from
   where it last saw it;
5. each unmatched observation opens a nursery segment in the next free
   slot (outlier removal on its points), with the next id;
6. up to max_merges_per_frame merges: the most overlapping pair (IoU at
   iou_voxel_size at least the low end) with one side dirty (touched,
   opened or merged this frame, among the first O + max_merges dirty
   slots), one side tracked and the other tracked or inactive; the higher
   slot merges into the lower (points as in 3, descriptors weighted by
   their counts, sightings added, the lower id, the earlier first and the
   later last sighting), which is active or nursery by its sightings.

Precision: F32 as the program, CONTROL rounds the world points, the voxel
means and the descriptors to bfloat16.

Near-ties: outlier removal keeps a point by a strict comparison of its
statistic with the cloud's mean plus one standard deviation, and regular
clouds tie there exactly: three collinear points spaced 1:2 (a thin
mask's voxel means) give statistics u, 4u/3 and 5u/3, the largest equal
to the threshold, and float32 rounding keeps or drops it on either side.
So the reference notes each point whose statistic lies within SOR_KNIFE
(a share of the threshold) of it, and closest() takes such near-ties the
other way as well, the nearest first: the program is held to the
reference that agrees with it best under some reading of its near-ties.
"""

from __future__ import annotations

import numpy as np

EMPTY, NURSERY, ACTIVE, INACTIVE, GRAVEYARD = 0, 1, 2, 3, 4
INVALID = 2**31 - 1
AUCTION_ITERS = 64
AUCTION_EPS = np.float32(1e-3)
SOR_NEIGHBOURS = 10
# compare(): the float32 arithmetic of the two sides differs in order
# (voxel sums, norms), by some 1e-7 of a point's coordinate and 1e-14 of a
# descriptor's 1 - cosine; bfloat16 moves a point by up to 2e-2 m at 8 m
POINT_TOL_M = 1e-4
DESC_TOL = 1e-6
# outlier_keep(): float32 sums of ten distances and the cloud's mean and
# deviation round by some 1e-6 of the threshold on the program's side
SOR_KNIFE = 1e-5
# closest(): the reference's runs a batch may take, the first included
KNIFE_RUNS = 16
FIELDS = ("points", "points_valid", "descriptors", "desc_count", "status", "num_sightings",
          "first_seen", "last_seen", "seg_id", "last_obs_pos", "next_id")


def bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (to nearest, ties to even)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _mix32(h):
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def voxel_index(points: np.ndarray, voxel: float) -> np.ndarray:
    """floor(p * f32(1 / voxel)) in float32, as int64 (n, 3)."""
    inv = np.float32(1.0) / np.float32(voxel)
    return np.floor(points.astype(np.float32) * inv).astype(np.int32).astype(np.int64)


def hashed_key(idx: np.ndarray) -> np.ndarray:
    """The pool's signed 32-bit key of voxel indices (n, 3): murmur fmix32
    chained over z, y, x of the int32 coordinates."""
    v = idx & 0xFFFFFFFF
    h = _mix32(v[:, 2])
    h = _mix32(h ^ v[:, 1])
    h = _mix32(h ^ v[:, 0])
    key = np.where(h >= 2**31, h - 2**32, h)
    return np.where(key == INVALID, 0, key)


def voxel_means(points: np.ndarray, voxel: float, rnd, cap: int = None) -> np.ndarray:
    """The mean of each occupied voxel's points; with cap, the cap voxels
    of lowest hashed key."""
    if len(points) == 0:
        return points
    idx = voxel_index(points, voxel)
    uniq, inv = np.unique(idx, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    sums = np.zeros((len(uniq), 3), np.float64)
    np.add.at(sums, inv, points.astype(np.float64))
    cnt = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
    means = rnd((sums / cnt[:, None]).astype(np.float32))
    if cap is not None and len(means) > cap:
        means = means[np.argsort(hashed_key(uniq), kind="stable")[:cap]]
    return means


class Knives:
    """The near-ties of outlier removal that one run of the reference
    meets, numbered in the order met, each with its distance from the
    threshold as a share of it (gaps); those numbered in `flip` it takes
    the other way."""

    def __init__(self, flip=()):
        self.flip, self.gaps = frozenset(flip), []

    @property
    def met(self) -> int:
        return len(self.gaps)

    def decide(self, keep: np.ndarray, gap: np.ndarray) -> np.ndarray:
        for i in np.flatnonzero(gap <= SOR_KNIFE):
            if self.met in self.flip:
                keep[i] = not keep[i]
            self.gaps.append(float(gap[i]))
        return keep


def outlier_keep(points: np.ndarray, knives: Knives = None) -> np.ndarray:
    """Statistical outlier removal's keep mask: a point's statistic is the
    mean distance to its nearest SOR_NEIGHBOURS points (itself among them);
    kept iff 0 < statistic < mean + std (std over n - 1). With knives, a
    statistic within SOR_KNIFE of the threshold is a near-tie, decided
    by knives."""
    n = len(points)
    if n == 0:
        return np.zeros(0, bool)
    p = points.astype(np.float32)
    d2 = np.zeros((n, n), np.float32)
    for c in range(3):
        d = p[:, c][:, None] - p[:, c][None, :]
        d2 += d * d
    k = min(SOR_NEIGHBOURS, n)
    knn = np.sqrt(np.maximum(np.partition(d2, k - 1, axis=1)[:, :k], 0)).astype(np.float64)
    mean_d = knn.mean(1)
    mu = mean_d.mean()
    std = np.sqrt(((mean_d - mu) ** 2).sum() / max(n - 1.0, 1.0))
    thresh = mu + std
    keep = (mean_d > 0) & (mean_d < thresh)
    if knives is None:
        return keep
    gap = np.where(mean_d > 0, np.abs(mean_d - thresh) / max(thresh, 1e-30), np.inf)
    return knives.decide(keep, gap)


def cleanup(points: np.ndarray, vs: float, cap: int, rnd, knives: Knives = None) -> np.ndarray:
    """A row's points after an insert: voxel means, outlier removal, then
    the means at the finest of 1, 2, 4 x vs that fits cap."""
    fine = voxel_means(points, vs, rnd)
    fine = fine[outlier_keep(fine, knives)]
    for lvl in range(3):
        size = vs * 2.0 ** lvl
        if len(np.unique(voxel_index(fine, size), axis=0)) <= cap or lvl == 2:
            return voxel_means(fine, size, rnd, cap)


def iou(a: set, b: set) -> np.float32:
    inter = len(a & b)
    union = len(a) + len(b) - inter
    return np.float32(inter) / np.float32(max(union, 1)) if union > 0 else np.float32(0)


def auction(benefit: np.ndarray, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Rows (observations) to columns (segments) maximizing benefit with
    rejection: an auction of AUCTION_ITERS sweeps, every unassigned row
    with a positive best value bidding for its best column (ties to the
    lower column), each column to its highest bidder (ties to the lower
    row); entries off the valid rows and columns are -1e9. -> column of
    each row, -1 unassigned."""
    n, m = benefit.shape
    benefit = np.where(rows[:, None] & cols[None, :], benefit, np.float32(-1e9)).astype(np.float32)
    price = np.zeros(m, np.float32)
    owner = np.full(m, -1)
    for _ in range(AUCTION_ITERS):
        assigned = np.isin(np.arange(n), owner)
        value = benefit - price[None, :]
        best = np.argmax(value, 1)
        v1 = value[np.arange(n), best]
        rest = value.copy()
        rest[np.arange(n), best] = -np.inf
        v2 = rest.max(1)
        bid = (v1 - v2 + AUCTION_EPS).astype(np.float32)
        want = ~assigned & (v1 > 0)
        bids = np.where(want[:, None] & (np.arange(m)[None, :] == best[:, None]),
                        bid[:, None], np.float32(-1e9))
        win = bids.max(0)
        row = np.argmax(bids, 0)
        has = win > -5e8
        price = np.where(has, price + win, price).astype(np.float32)
        owner = np.where(has, row, owner)
    match = np.full(n, -1)
    for j in np.flatnonzero(owner >= 0):
        match[owner[j]] = j
    return match


class Pool:
    """The pool state as plain arrays, one row a slot."""

    def __init__(self, st: dict):
        self.status = np.asarray(st["status"]).astype(np.int64).copy()
        self.seg_id = np.asarray(st["seg_id"]).astype(np.int64).copy()
        self.num_sightings = np.asarray(st["num_sightings"]).astype(np.int64).copy()
        self.first_seen = np.asarray(st["first_seen"], np.float32).copy()
        self.last_seen = np.asarray(st["last_seen"], np.float32).copy()
        self.last_obs_pos = np.asarray(st["last_obs_pos"], np.float32).copy()
        self.desc = np.asarray(st["descriptors"], np.float32).copy()
        self.desc_count = np.asarray(st["desc_count"], np.float32).copy()
        self.next_id = int(np.asarray(st["next_id"]))
        pv = np.asarray(st["points_valid"], bool)
        pts = np.asarray(st["points"], np.float32)
        self.points = [pts[i][pv[i]] for i in range(len(pv))]


def _keys(points: np.ndarray, vs: float) -> set:
    return set(map(tuple, voxel_index(points, vs))) if len(points) else set()


def _index(keys: list, rows: np.ndarray) -> dict:
    """voxel -> the rows (of those flagged) that occupy it."""
    index = {}
    for r in np.flatnonzero(rows):
        for k in keys[r]:
            index.setdefault(k, []).append(r)
    return index


def _sharing(keys: set, index: dict) -> list:
    """The indexed rows that share a voxel with `keys`, in order: only they
    can score an IoU above 0."""
    return sorted({r for k in keys for r in index.get(k, ())})


def frame(pool: Pool, params, t, T, pts_cam, val, desc, mask, rnd,
          knives: Knives = None) -> None:
    """One frame of the device mapper on `pool`, in place; knives decides
    outlier removal's near-ties."""
    p = params
    S, P = len(pool.status), p.max_points_per_segment
    lo, hi = p.geometric_score_range
    t = np.float32(t)
    R, tr = np.asarray(T, np.float32)[:3, :3], np.asarray(T, np.float32)[:3, 3]
    obs = [rnd((pts_cam[o][val[o]].astype(np.float32) @ R.T + tr).astype(np.float32))
           if mask[o] else np.zeros((0, 3), np.float32) for o in range(len(mask))]
    O = len(obs)
    vs_iou, vs = p.iou_voxel_size, p.segment_voxel_size
    okeys = [_keys(x, vs_iou) for x in obs]
    skeys = [_keys(x, vs_iou) for x in pool.points]
    tracked = (pool.status == NURSERY) | (pool.status == ACTIVE)
    benefit = np.zeros((O, S), np.float32)
    index = _index(skeys, tracked)
    for o in np.flatnonzero(mask):
        for s in _sharing(okeys[o], index):
            v = iou(skeys[s], okeys[o])
            if v >= lo:
                benefit[o, s] = (v - np.float32(lo)) / np.float32(max(hi - lo, 1e-9))
    match = auction(benefit, mask, tracked)
    touched = np.zeros(S, bool)
    dsum = pool.desc * pool.desc_count[:, None]
    for o in np.flatnonzero(match >= 0):
        s = match[o]
        touched[s] = True
        pool.points[s] = cleanup(np.concatenate([pool.points[s], obs[o]]), vs, P, rnd, knives)
        dsum[s] = dsum[s] + desc[o]
        pool.desc_count[s] += 1
    for s in np.flatnonzero(touched):
        d = dsum[s] / max(pool.desc_count[s], 1.0)
        pool.desc[s] = rnd((d / max(np.linalg.norm(d), 1e-9)).astype(np.float32))
    pool.num_sightings += touched
    pool.last_seen = np.where(touched, t, pool.last_seen).astype(np.float32)
    pool.last_obs_pos[touched] = tr
    if mask.any():
        st = pool.status
        st[(st == NURSERY) & (pool.num_sightings >= p.min_sightings)] = ACTIVE
        stale = (t - pool.last_seen) > np.float32(p.max_t_no_sightings)
        st[(st == ACTIVE) & stale] = INACTIVE
        st[(st == NURSERY) & stale] = EMPTY
        far = np.sqrt(((pool.last_obs_pos - tr) ** 2).sum(1)) > p.segment_graveyard_dist
        old = (t - pool.last_seen) > np.float32(p.segment_graveyard_time)
        st[(st == INACTIVE) & (far | old)] = GRAVEYARD
    free = list(np.flatnonzero(pool.status == EMPTY))
    dirty = touched.copy()
    for o in np.flatnonzero(mask & (match < 0)):
        if not free:
            break
        s = free.pop(0)
        x = obs[o][:P]
        pool.points[s] = x[outlier_keep(x, knives)]
        pool.desc[s] = rnd((desc[o] / max(np.linalg.norm(desc[o]), 1e-9)).astype(np.float32))
        pool.desc_count[s] = 1.0
        pool.status[s], pool.num_sightings[s] = NURSERY, 1
        pool.first_seen[s] = pool.last_seen[s] = t
        pool.last_obs_pos[s] = tr
        pool.seg_id[s] = pool.next_id
        pool.next_id += 1
        dirty[s] = True
    for _ in range(int(p.max_merges_per_frame)):
        skeys = [_keys(x, vs_iou) for x in pool.points]
        act = (pool.status == NURSERY) | (pool.status == ACTIVE)
        tr3 = act | (pool.status == INACTIVE)
        rows = np.flatnonzero(dirty)[:min(O + int(p.max_merges_per_frame), S)]
        index = _index(skeys, tr3)
        best, pair = np.float32(-1), None
        for r in rows:
            for c in _sharing(skeys[r], index):
                if r == c or not ((act[r] and tr3[c]) or (tr3[r] and act[c])):
                    continue
                v = iou(skeys[r], skeys[c])
                if v >= lo and v > best:
                    best, pair = v, (r, c)
        if pair is None:
            break
        a, b = min(pair), max(pair)
        pool.points[a] = cleanup(np.concatenate([pool.points[a], pool.points[b]]), vs, P, rnd,
                                 knives)
        wa, wb = pool.desc_count[a], pool.desc_count[b]
        d = (pool.desc[a] * wa + pool.desc[b] * wb) / max(wa + wb, 1.0)
        pool.desc[a] = rnd((d / max(np.linalg.norm(d), 1e-9)).astype(np.float32))
        pool.desc_count[a] += wb
        pool.num_sightings[a] += pool.num_sightings[b]
        pool.first_seen[a] = min(pool.first_seen[a], pool.first_seen[b])
        if pool.last_seen[b] > pool.last_seen[a]:
            pool.last_obs_pos[a] = pool.last_obs_pos[b]
        pool.last_seen[a] = max(pool.last_seen[a], pool.last_seen[b])
        pool.seg_id[a] = min(pool.seg_id[a], pool.seg_id[b])
        pool.status[a] = ACTIVE if pool.num_sightings[a] >= p.min_sightings else NURSERY
        pool.status[b], pool.seg_id[b] = EMPTY, -1
        pool.points[b] = np.zeros((0, 3), np.float32)
        dirty[a], dirty[b] = True, False


def empty_state(slots: int, points: int, desc_dim: int) -> dict:
    """The pool before the first frame: every slot empty."""
    return dict(points=np.zeros((slots, points, 3), np.float32),
                points_valid=np.zeros((slots, points), bool),
                descriptors=np.zeros((slots, desc_dim), np.float32),
                desc_count=np.zeros(slots, np.float32), status=np.zeros(slots, np.int64),
                num_sightings=np.zeros(slots, np.int64), first_seen=np.zeros(slots, np.float32),
                last_seen=np.full(slots, -1e9, np.float32), seg_id=np.full(slots, -1),
                last_obs_pos=np.zeros((slots, 3), np.float32), next_id=0)


def run_batch(before: dict, inputs: tuple, params, rnd=lambda x: x,
              knives: Knives = None) -> Pool:
    """The batch's frames from the program's state before them. inputs:
    (times (B,), poses (B, 4, 4), camera points (B, O, Q, 3), valid (B, O,
    Q), descriptors (B, O, D), observation mask (B, O))."""
    pool = Pool(before)
    times, poses, pts, val, desc, mask = (np.asarray(x) for x in inputs)
    D = pool.desc.shape[1]
    for f in range(len(times)):
        d = np.zeros((desc.shape[1], D), np.float32)
        d[:, :desc.shape[2]] = desc[f]
        frame(pool, params, times[f], poses[f], pts[f], val[f].astype(bool), d,
              mask[f].astype(bool), rnd, knives)
    return pool


def as_state(pool: Pool) -> dict:
    """A reference pool as the fields compare() reads."""
    P = max([len(x) for x in pool.points] + [1])
    pts = np.zeros((len(pool.points), P, 3), np.float32)
    pv = np.zeros((len(pool.points), P), bool)
    for i, x in enumerate(pool.points):
        pts[i, :len(x)], pv[i, :len(x)] = x, True
    return dict(status=pool.status, seg_id=pool.seg_id, num_sightings=pool.num_sightings,
                first_seen=pool.first_seen, last_seen=pool.last_seen, points=pts,
                points_valid=pv, descriptors=pool.desc)


def compare(pool: Pool, after: dict, tol_m: float = POINT_TOL_M) -> dict:
    """The program's state after the batch against the reference's:
    map_mismatch, the share of live slots (not empty on either side) that
    differ in status, id, sightings, first or last sighting time, in a
    point with no point of the other side within tol_m (either way), or in
    a descriptor by more than DESC_TOL in 1 - cosine."""
    status = np.asarray(after["status"]).astype(np.int64)
    live = (status != EMPTY) | (pool.status != EMPTY)
    same = (live & (status == pool.status)
            & (np.asarray(after["seg_id"]).astype(np.int64) == pool.seg_id)
            & (np.asarray(after["num_sightings"]).astype(np.int64) == pool.num_sightings)
            & (np.asarray(after["first_seen"], np.float32) == pool.first_seen)
            & (np.asarray(after["last_seen"], np.float32) == pool.last_seen))
    pv = np.asarray(after["points_valid"], bool)
    pts = np.asarray(after["points"], np.float32)
    desc = np.asarray(after["descriptors"], np.float64)
    for s in np.flatnonzero(same):
        a, b = pts[s][pv[s]].astype(np.float64), pool.points[s].astype(np.float64)
        if len(a) != len(b):
            same[s] = False
            continue
        if len(a):
            d = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1))
            if d.min(1).max() > tol_m or d.min(0).max() > tol_m:
                same[s] = False
                continue
        r = pool.desc[s].astype(np.float64)
        den = np.linalg.norm(desc[s]) * np.linalg.norm(r)
        if den > 0 and 1.0 - float(desc[s] @ r) / den > DESC_TOL:
            same[s] = False
    return dict(map_mismatch=float((live & ~same).sum() / max(live.sum(), 1)))


def closest(before: dict, inputs: tuple, params, after: dict) -> dict:
    """compare() of the tested side's state after the batch (`after`)
    with the float32 reference's, its near-ties of outlier removal taken
    either way: starting from the plain run, the near-ties met after the
    last one taken the other way are tried one at a time, the nearest
    first, and the first that lowers the mismatch is kept, until the
    mismatch is 0, none lowers it, or KNIFE_RUNS runs are made. Returns
    the least map_mismatch, the near-ties of the plain run
    (map_near_ties) and the runs made (map_runs)."""

    def run(flip):
        knives = Knives(flip)
        pool = run_batch(before, inputs, params, knives=knives)
        return compare(pool, after)["map_mismatch"], knives

    flip = ()
    best, knives = run(flip)
    met, runs = knives.met, 1
    while best > 0.0 and runs < KNIFE_RUNS:
        start = flip[-1] + 1 if flip else 0
        order = sorted(range(start, knives.met), key=lambda i: knives.gaps[i])
        for i in order[:KNIFE_RUNS - runs]:
            mm, k = run(flip + (i,))
            runs += 1
            if mm < best:
                flip, best, knives = flip + (i,), mm, k
                break
        else:
            break
    return dict(map_mismatch=best, map_near_ties=met, map_runs=runs)
