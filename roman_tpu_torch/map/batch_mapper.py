"""Segment mapper whose whole map lives on the device.

Port of roman_tpu/map/batch_mapper.py. The segment map is a set of
capacity-padded pools (points, descriptors, lifecycle counters) in
tensors on the mapper's device. Each frame runs association scoring
(voxel IOU and cosine), assignment (the auction with rejection), point
integration with voxel downsampling and statistical outlier removal, the
lifecycle (nursery -> active -> inactive -> graveyard) and a bounded merge
to fixpoint. A frame batch is a Python loop over frames with no host
sync; the host reads the device only in maybe_spill's occupancy check
(every ``spill_check_every`` batches) and in the export.

Semantics follow the host Mapper (roman_tpu_torch.map.mapper), which is
this mapper's referee; see roman_tpu's module docstring for the sizing
rules (adaptive voxel coarsening of a pool row past
max_points_per_segment, SOR before the capped downsample).

Where the JAX program differs in form:

- the merge-to-fixpoint ``lax.while_loop`` becomes exactly
  ``max_merges_per_frame`` iterations with a flag on the device that stops
  merging once an iteration finds no pair. An iteration that merges
  nothing changes nothing, so every later one would change nothing too:
  the result is the same, and the host never waits for the device;
- ``lax.scan`` over a batch's frames becomes a Python loop;
- stable sorts (dirty rows first, touched rows first) are
  ``torch.argsort(..., stable=True)`` of an integer cast of the mask;
- a scatter with ``mode="drop"`` writes into one spare row past the end,
  which is then cut off.

On a CUDA device update_batch replays a CUDA graph of one frame's step
(_FrameGraph): a frame is some 7,500 small kernels, and issuing them one
by one from Python left the card idle 93% of the time. The graph holds
the same kernels; only who launches them changes.

``device=None`` means ``cuda``; a host without a card raises unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from roman_tpu_torch.data.camera import CameraParams
from roman_tpu_torch.device import resolve_device
from roman_tpu_torch.map.roman_map import RomanMap, SegmentData
from roman_tpu_torch.ops.geometry import obb_volume_extent, shape_attributes
from roman_tpu_torch.ops.hungarian import auction_assignment
from roman_tpu_torch.ops.pointcloud import (largest_cluster_mask,
                                            statistical_outlier_mask)
from roman_tpu_torch.ops.voxel import (_INVALID, sorted_unique_keys,
                                       voxel_downsample, voxel_downsample_np,
                                       voxel_iou_cross_keys)
from roman_tpu_torch.params.mapper_params import MapperParams

# lifecycle states (reference mapper.py:93-127). INACTIVE segments are
# still merge targets (the reference's merge scans segments +
# inactive_segments, mapper.py:277); GRAVEYARD is terminal and spillable.
EMPTY, NURSERY, ACTIVE, INACTIVE, GRAVEYARD = 0, 1, 2, 3, 4
RETIRED = GRAVEYARD

AUCTION_ITERS = 64


@dataclasses.dataclass
class MapState:
    points: torch.Tensor          # (S, P, 3) f32
    points_valid: torch.Tensor    # (S, P) bool
    descriptors: torch.Tensor     # (S, D) f32, running mean (unit)
    desc_count: torch.Tensor      # (S,) f32
    status: torch.Tensor          # (S,) int32
    num_sightings: torch.Tensor   # (S,) int32
    first_seen: torch.Tensor      # (S,) f32
    last_seen: torch.Tensor       # (S,) f32
    seg_id: torch.Tensor          # (S,) int32, -1 empty
    # robot position at each segment's last observation: the reference's
    # inactive->graveyard distance rule compares the current robot pose
    # with seg.last_observation.pose (mapper.py:113-123)
    last_obs_pos: torch.Tensor    # (S, 3) f32
    next_id: torch.Tensor         # () int32
    # sorted unique voxel keys at the association voxel size, refreshed
    # only for rows whose points change
    vox_keys: torch.Tensor        # (S, P) int32, _INVALID-padded
    vox_n: torch.Tensor           # (S,) int32

    def replace(self, **changes) -> "MapState":
        return dataclasses.replace(self, **changes)


def init_state(capacity: int, points_per_seg: int, desc_dim: int,
               device=None) -> MapState:
    S, P, D = capacity, points_per_seg, desc_dim
    dev = resolve_device(device)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return MapState(
        points=full((S, P, 3), 0.0, torch.float32),
        points_valid=full((S, P), False, torch.bool),
        descriptors=full((S, D), 0.0, torch.float32),
        desc_count=full((S,), 0.0, torch.float32),
        status=full((S,), EMPTY, torch.int32),
        num_sightings=full((S,), 0, torch.int32),
        first_seen=full((S,), 0.0, torch.float32),
        last_seen=full((S,), -1e9, torch.float32),
        seg_id=full((S,), -1, torch.int32),
        last_obs_pos=full((S, 3), 0.0, torch.float32),
        next_id=full((), 0, torch.int32),
        vox_keys=full((S, P), _INVALID, torch.int32),
        vox_n=full((S,), 0, torch.int32),
    )


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt((x * x).sum(dim=-1, keepdim=keepdim))


def _set_rows(arr: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """A new tensor: arr with rows idx set to vals; an index equal to
    len(arr) is dropped (JAX's .at[idx].set(vals, mode="drop"))."""
    ext = torch.cat([arr, arr[:1]])
    if not isinstance(vals, torch.Tensor):
        # a fill on the device: a Python value would be copied from the host
        vals = torch.full((), vals, dtype=arr.dtype, device=arr.device)
    ext[idx] = vals
    return ext[:arr.shape[0]]


def _add_rows(arr: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """A new tensor: arr with vals added at rows idx; an index equal to
    len(arr) is dropped."""
    ext = torch.cat([arr, torch.zeros_like(arr[:1])])
    ext.index_add_(0, idx, vals)
    return ext[:arr.shape[0]]


def _row(arr: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """arr[i] for a one-element index tensor i, without a host sync."""
    return arr.index_select(0, i)[0]


_FIELDS = [f.name for f in dataclasses.fields(MapState)]


def _clone_state(state: MapState) -> MapState:
    return MapState(**{k: getattr(state, k).clone() for k in _FIELDS})


class _FrameGraph:
    """One frame of update_batch captured as a CUDA graph: static input
    buffers (the pool state and one frame's inputs), the step, and the
    copy of the new state back into the state buffers, so that replaying
    it once per frame advances the state in place."""

    def __init__(self, mapper: "BatchMapper", O: int, Q: int, D: int):
        dev = mapper.device
        self.state = init_state(mapper.params.max_segments,
                                mapper.params.max_points_per_segment, D, dev)
        self.inputs = (torch.zeros((), dtype=torch.float32, device=dev),
                       torch.zeros((4, 4), dtype=torch.float32, device=dev),
                       torch.zeros((O, Q, 3), dtype=torch.float32, device=dev),
                       torch.zeros((O, Q), dtype=torch.bool, device=dev),
                       torch.zeros((O, D), dtype=torch.float32, device=dev),
                       torch.zeros((O,), dtype=torch.bool, device=dev))
        # a first run on a side stream does the lazy initializations that
        # capture does not allow (torch.cuda.graphs' warmup)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            mapper._frame(self.state, *self.inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            out = mapper._frame(self.state, *self.inputs)
            for k in _FIELDS:
                getattr(self.state, k).copy_(getattr(out, k))

    def run(self, state: MapState, frames) -> MapState:
        """The frames (tuples of the six inputs) from `state`; returns a
        new MapState (the buffers are reused by the next call)."""
        for k in _FIELDS:
            getattr(self.state, k).copy_(getattr(state, k))
        for frame in frames:
            for buf, x in zip(self.inputs, frame):
                buf.copy_(x)
            self.graph.replay()
        return _clone_state(self.state)


def _first_true_order(mask: torch.Tensor) -> torch.Tensor:
    """Indices with mask True first, each group in index order (the
    stable jnp.argsort(~mask))."""
    return torch.argsort((~mask).to(torch.int32), stable=True)


class BatchMapper:
    def __init__(self, params: MapperParams, camera: CameraParams,
                 desc_dim: int = 64, obs_capacity: int = 32, device=None):
        self.params = params
        self.camera = camera
        self.desc_dim = desc_dim
        self.obs_capacity = obs_capacity
        self.device = resolve_device(device)
        self.state = init_state(params.max_segments, params.max_points_per_segment,
                                desc_dim, self.device)
        self.poses: List[np.ndarray] = []
        self.times: List[float] = []
        self.frame_descriptors: List[np.ndarray] = []
        self._T_camera_flu = np.eye(4)
        self._graphs = {}
        # GRAVEYARD segments spilled off the device (maybe_spill), so
        # max_segments bounds the live segments only
        self._spilled: List[SegmentData] = []
        self._updates_since_spill_check = 0
        self.spill_check_every = 4
        self.spill_threshold = 0.7

    def set_T_camera_flu(self, T: np.ndarray):
        """Camera->FLU convention of the exported trajectory only
        (reference Mapper.set_T_camera_flu)."""
        self._T_camera_flu = np.asarray(T)

    # ------------------------------------------------------------------ #
    def _step(self, state: MapState, t, robot_pos, obs_pts, obs_valid,
              obs_desc, obs_mask) -> MapState:
        """One frame (roman_tpu/map/batch_mapper.py:160-471). obs_pts
        (O, Q, 3) world frame; obs_valid (O, Q); obs_desc (O, D); obs_mask
        (O,) real observations; t a 0-d f32 tensor; robot_pos (3,) for the
        graveyard distance rule."""
        p = self.params
        S = p.max_segments
        P = p.max_points_per_segment
        O = obs_pts.shape[0]
        vs_iou = p.iou_voxel_size
        vs_seg = p.segment_voxel_size
        geo_lo, geo_hi = p.geometric_score_range
        use_sem = p.semantic_association_method is not None
        sem_lo, sem_hi = p.semantic_score_range
        iom = p.geometric_association_method == "iom"
        sor = p.segment_outlier_removal_std
        dev = obs_pts.device
        status = state.status
        trackable = (status == NURSERY) | (status == ACTIVE)

        # ---- association scores (segment x observation) ----
        k_obs, n_obs = sorted_unique_keys(obs_pts, obs_valid, vs_iou)
        iou = voxel_iou_cross_keys(state.vox_keys, state.vox_n, k_obs, n_obs,
                                   iom_as_iou=iom)                 # (S, O)
        geo_norm = (iou - geo_lo) / max(geo_hi - geo_lo, 1e-9)
        score = geo_norm
        if use_sem:
            cos = state.descriptors @ obs_desc.T
            # a missing descriptor on either side scores 1.0, as
            # Mapper._semantic_score does
            has_desc = (state.desc_count > 0)[:, None] & (_norm(obs_desc) > 1e-9)[None, :]
            cos = torch.where(has_desc, cos, torch.ones_like(cos))
            sem_norm = (cos - sem_lo) / max(sem_hi - sem_lo, 1e-9)
            ok_pair = (iou >= geo_lo) & (cos >= sem_lo)
            score = torch.sqrt(torch.clamp(geo_norm * sem_norm, min=0.0))
        else:
            ok_pair = iou >= geo_lo
        benefit = torch.where(ok_pair & trackable[:, None] & obs_mask[None, :],
                              score, torch.zeros_like(score))
        match = auction_assignment(benefit.T, obs_mask, trackable,
                                   n_iters=AUCTION_ITERS)         # (O,)
        matched = match >= 0
        seg_of_obs = torch.where(matched, match, torch.full_like(match, S))

        # ---- integrate matched observations ----
        Q = obs_pts.shape[1]
        add_pts = _set_rows(torch.zeros((S, Q, 3), dtype=torch.float32, device=dev),
                            seg_of_obs,
                            torch.where(matched[:, None, None], obs_pts,
                                        torch.zeros_like(obs_pts)))
        add_val = _set_rows(torch.zeros((S, Q), dtype=torch.bool, device=dev),
                            seg_of_obs, obs_valid & matched[:, None])
        touched = _set_rows(torch.zeros((S,), dtype=torch.bool, device=dev),
                            seg_of_obs, matched)
        # only the <= O matched rows change: gather them, downsample
        # uncapped, SOR on the fine cloud, then the capped downsample with
        # adaptive coarsening (host order, segment.py _cleanup_points)
        R0 = min(O, S)
        t_rows = _first_true_order(touched)[:R0]
        row_touched = touched[t_rows]
        old_pts = state.points[t_rows]
        old_val = state.points_valid[t_rows]
        comb_pts = torch.cat([old_pts, add_pts[t_rows]], dim=1)
        comb_val = torch.cat([old_val, add_val[t_rows]], dim=1)
        fine_pts, fine_val = voxel_downsample(comb_pts, comb_val, vs_seg)
        if sor is not None:
            fine_val = statistical_outlier_mask(fine_pts, fine_val, 10, sor)
        new_pts, new_val = voxel_downsample(fine_pts, fine_val, vs_seg,
                                            capacity=P, max_coarsen_levels=2)
        points = state.points.index_copy(
            0, t_rows, torch.where(row_touched[:, None, None], new_pts, old_pts))
        points_valid = state.points_valid.index_copy(
            0, t_rows, torch.where(row_touched[:, None], new_val, old_val))
        rk, rn = sorted_unique_keys(new_pts, new_val, vs_iou)
        vox_keys = state.vox_keys.index_copy(
            0, t_rows, torch.where(row_touched[:, None], rk, state.vox_keys[t_rows]))
        vox_n = state.vox_n.index_copy(
            0, t_rows, torch.where(row_touched, rn, state.vox_n[t_rows]))

        # descriptors: running mean
        add_desc = _add_rows(torch.zeros_like(state.descriptors), seg_of_obs,
                             torch.where(matched[:, None], obs_desc,
                                         torch.zeros_like(obs_desc)))
        add_cnt = _add_rows(torch.zeros_like(state.desc_count), seg_of_obs,
                            matched.to(torch.float32))
        desc = state.descriptors * state.desc_count[:, None] + add_desc
        desc_count = state.desc_count + add_cnt
        desc = desc / torch.clamp(desc_count[:, None], min=1.0)
        desc = desc / torch.clamp(_norm(desc, keepdim=True), min=1e-9)

        num_sightings = state.num_sightings + touched.to(torch.int32)
        last_seen = torch.where(touched, t, state.last_seen)
        last_obs_pos = torch.where(touched[:, None], robot_pos[None, :],
                                   state.last_obs_pos)

        # ---- lifecycle (reference mapper.py:93-127), gated on the frame
        # having an observation: an empty frame is a no-op (mapper.py:56-57)
        has_obs = obs_mask.any()

        def lc(pred, new, status):
            return torch.where(has_obs & pred, new, status)

        status = lc((status == NURSERY) & (num_sightings >= p.min_sightings),
                    ACTIVE, status)
        stale = t - last_seen > p.max_t_no_sightings
        status = lc((status == ACTIVE) & stale, INACTIVE, status)
        status = lc((status == NURSERY) & stale, EMPTY, status)
        # inactive -> graveyard when too old, or when the robot moved away
        # from its pose at the segment's last observation
        far = _norm(last_obs_pos - robot_pos[None, :]) > p.segment_graveyard_dist
        old = t - last_seen > p.segment_graveyard_time
        status = lc((status == INACTIVE) & (far | old), GRAVEYARD, status)

        # ---- new segments from unmatched observations ----
        new_obs = obs_mask & ~matched
        free = status == EMPTY
        free_rank = torch.cumsum(free.to(torch.int64), dim=0) - 1
        obs_rank = torch.cumsum(new_obs.to(torch.int64), dim=0) - 1
        # the slot of each new observation: the obs_rank-th free slot
        rank_idx = torch.where(free & (free_rank < O), free_rank,
                               torch.full_like(free_rank, O))
        slot_of_rank = _set_rows(torch.full((O,), S, dtype=torch.int64, device=dev),
                                 rank_idx, torch.arange(S, device=dev))
        obs_slot = torch.where(new_obs, slot_of_rank[torch.clamp(obs_rank, 0, O - 1)],
                               torch.full_like(obs_rank, S))
        can_place = new_obs & (obs_slot < S)
        tgt = torch.where(can_place, obs_slot, torch.full_like(obs_slot, S))

        def place(arr, vals):
            return _set_rows(arr, tgt, vals)

        q = min(Q, P)
        init_pts = torch.zeros((O, P, 3), dtype=torch.float32, device=dev)
        init_pts[:, :q] = obs_pts[:, :q]
        init_val = torch.zeros((O, P), dtype=torch.bool, device=dev)
        init_val[:, :q] = obs_valid[:, :q]
        if sor is not None:
            # Segment creation runs _cleanup_points too
            init_val = statistical_outlier_mask(init_pts, init_val, 10, sor)
        points = place(points, init_pts)
        points_valid = place(points_valid, init_val)
        pk, pn = sorted_unique_keys(init_pts, init_val, vs_iou)
        vox_keys = place(vox_keys, pk)
        vox_n = place(vox_n, pn)
        dnorm = obs_desc / torch.clamp(_norm(obs_desc, keepdim=True), min=1e-9)
        desc = place(desc, dnorm)
        desc_count = place(desc_count, 1.0)
        status = place(status, NURSERY)
        num_sightings = place(num_sightings, 1)
        first_seen = place(state.first_seen, t)
        last_seen = place(last_seen, t)
        last_obs_pos = place(last_obs_pos, robot_pos)
        placed = can_place.to(torch.int32)
        new_ids = state.next_id + torch.cumsum(placed, dim=0, dtype=torch.int32) - 1
        seg_id = place(state.seg_id, torch.where(can_place, new_ids,
                                                 torch.full_like(new_ids, -1)))
        next_id = state.next_id + placed.sum(dtype=torch.int32)

        # ---- merge to fixpoint (reference mapper.py:251-314): merge the
        # highest-IOU mergeable pair, max_merges_per_frame times, on the
        # merged pools each time. Only dirty rows (touched, spawned or just
        # merged) can form a new pair, so the scan is (R, S).
        spawned = _set_rows(torch.zeros((S,), dtype=torch.bool, device=dev),
                            tgt, can_place)
        dirty = touched | spawned
        R = min(O + int(p.max_merges_per_frame), S)
        slots = torch.arange(S, device=dev)
        merging = torch.ones((), dtype=torch.bool, device=dev)
        for _ in range(int(p.max_merges_per_frame)):
            activeish = (status == NURSERY) | (status == ACTIVE)
            track3 = activeish | (status == INACTIVE)
            rows = _first_true_order(dirty)[:R]
            pair_iou = voxel_iou_cross_keys(vox_keys[rows], vox_n[rows], vox_keys,
                                            vox_n, iom_as_iou=iom)   # (R, S)
            # one side tracked, the other tracked or INACTIVE
            mergeable = (dirty[rows][:, None] & (rows[:, None] != slots[None, :])
                         & ((activeish[rows][:, None] & track3[None, :])
                            | (track3[rows][:, None] & activeish[None, :]))
                         & (pair_iou >= geo_lo))
            flat = torch.where(mergeable, pair_iou,
                               torch.full_like(pair_iou, -1.0)).reshape(-1)
            best = torch.argmax(flat).reshape(1)
            merging = merging & (flat.index_select(0, best)[0] > 0)
            gbest = rows.index_select(0, torch.div(best, S, rounding_mode="floor"))
            cbest = best % S
            # merge b into a, a the lower slot (the reference keeps seg1)
            a = torch.minimum(gbest, cbest)
            b = torch.maximum(gbest, cbest)
            mpts = torch.cat([_row(points, a), _row(points, b)], dim=0)
            mval = torch.cat([_row(points_valid, a), _row(points_valid, b)]) & merging
            mf_pts, mf_val = voxel_downsample(mpts, mval, vs_seg)
            if sor is not None:
                # update_from_segment -> _cleanup_points
                mf_val = statistical_outlier_mask(mf_pts[None], mf_val[None], 10, sor)[0]
            md_pts, md_val = voxel_downsample(mf_pts, mf_val, vs_seg, capacity=P,
                                              max_coarsen_levels=2)
            is_a = (slots == a) & merging
            is_b = (slots == b) & merging
            points = torch.where(is_a[:, None, None], md_pts[None], points)
            points_valid = torch.where(is_a[:, None], md_val[None], points_valid)
            mk, mn = sorted_unique_keys(md_pts, md_val, vs_iou)
            vox_keys = torch.where(is_a[:, None], mk[None], vox_keys)
            vox_keys = torch.where(is_b[:, None], _INVALID, vox_keys)
            vox_n = torch.where(is_a, mn, vox_n)
            vox_n = torch.where(is_b, 0, vox_n)
            wa = _row(desc_count, a)
            wb = _row(desc_count, b)
            mdesc = (_row(desc, a) * wa + _row(desc, b) * wb) / torch.clamp(wa + wb, min=1.0)
            mdesc = mdesc / torch.clamp(_norm(mdesc), min=1e-9)
            desc = torch.where(is_a[:, None], mdesc[None], desc)
            desc_count = desc_count + torch.where(is_a, wb, 0.0)
            num_sightings = num_sightings + torch.where(is_a, _row(num_sightings, b), 0)
            first_seen = torch.where(is_a, torch.minimum(first_seen, _row(first_seen, b)),
                                     first_seen)
            # the merged track's last observation is the later one's
            use_b = _row(last_seen, b) > _row(last_seen, a)
            last_obs_pos = torch.where((is_a & use_b)[:, None], _row(last_obs_pos, b),
                                       last_obs_pos)
            last_seen = torch.where(is_a, torch.maximum(last_seen, _row(last_seen, b)),
                                    last_seen)
            seg_id = torch.where(is_a, torch.minimum(seg_id, _row(seg_id, b)), seg_id)
            # the merged segment is alive again; sightings pick its state
            new_a = torch.where(num_sightings >= p.min_sightings, ACTIVE, NURSERY)
            status = torch.where(is_a, new_a.to(status.dtype), status)
            status = torch.where(is_b, EMPTY, status)
            seg_id = torch.where(is_b, -1, seg_id)
            dirty = (dirty | is_a) & ~is_b

        return MapState(
            points=points, points_valid=points_valid, descriptors=desc,
            desc_count=desc_count, status=status, num_sightings=num_sightings,
            first_seen=first_seen, last_seen=last_seen, seg_id=seg_id,
            last_obs_pos=last_obs_pos, next_id=next_id,
            vox_keys=vox_keys, vox_n=vox_n)

    def _frame(self, state: MapState, t, T, pts, val, desc, mask) -> MapState:
        """One frame of update_batch: the camera-frame points moved to the
        world by the pose T (4, 4), then the step."""
        R, tr = T[:3, :3], T[:3, 3]
        pw = torch.einsum("ij,oqj->oqi", R, pts) + tr
        pw = torch.where(val[..., None], pw, torch.zeros_like(pw))
        return self._step(state, t, tr, pw, val, desc, mask)

    # ------------------------------------------------------------------ #
    def ensure_desc_dim(self, d: int):
        """Widen the descriptor pool to d dims in place (zero-padding the
        state), for streams whose first frames carry no descriptors."""
        if d <= self.desc_dim:
            return
        desc = torch.zeros(self.state.descriptors.shape[:-1] + (d,),
                           dtype=torch.float32, device=self.device)
        desc[..., :self.desc_dim] = self.state.descriptors
        self.state = self.state.replace(descriptors=desc)
        self.desc_dim = d
        self._graphs = {}

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def update_batch(self, times, poses, points, points_valid, descriptors,
                     obs_mask, frame_descriptors=None):
        """Mapper.update over B frames: times (B,); poses (B, 4, 4); points
        (B, O, Q, 3) in the CAMERA frame; points_valid (B, O, Q);
        descriptors (B, O, D); obs_mask (B, O). The inputs go to the
        device once; the frames then run with no host sync (on a CUDA
        device, as replays of a CUDA graph of one frame)."""
        self.poses += [np.asarray(p) for p in poses]
        self.times += [float(t) for t in times]
        if frame_descriptors is not None:
            self.frame_descriptors += [np.asarray(f) for f in frame_descriptors]
        D = descriptors.shape[-1]
        if D > self.desc_dim:
            # widen instead of truncating 768-d embeddings
            self.ensure_desc_dim(D)
        if D != self.desc_dim:
            fixed = np.zeros(descriptors.shape[:-1] + (self.desc_dim,), np.float32)
            fixed[..., :D] = np.asarray(descriptors)
            descriptors = fixed
        ts = self._f32(times)
        Ts = self._f32(poses)
        pts = self._f32(points)
        val = torch.as_tensor(np.asarray(points_valid, bool), device=self.device)
        desc = self._f32(descriptors)
        mask = torch.as_tensor(np.asarray(obs_mask, bool), device=self.device)
        frames = [(ts[f], Ts[f], pts[f], val[f], desc[f], mask[f])
                  for f in range(len(ts))]
        if self.device.type == "cuda":
            key = tuple(pts.shape[1:3]) + (self.desc_dim,)
            if key not in self._graphs:
                self._graphs[key] = _FrameGraph(self, *key)
            self.state = self._graphs[key].run(self.state, frames)
        else:
            state = self.state
            for frame in frames:
                state = self._frame(state, *frame)
            self.state = state
        self.maybe_spill()

    def _fit_points(self, pts: np.ndarray) -> np.ndarray:
        """An observation's cloud cut to <= max_points_per_segment without
        spatial bias: voxel-downsample first (host parity), then an even
        stride if the footprint is still too large."""
        Q = self.params.max_points_per_segment
        if len(pts) <= Q:
            return pts
        down = voxel_downsample_np(pts, self.params.segment_voxel_size)
        if len(down) > Q:
            down = down[np.linspace(0, len(down) - 1, Q).astype(int)]
        return down.astype(np.float32)

    def _widen_for(self, observations):
        wid = max((np.asarray(o.semantic_descriptor).reshape(-1).size
                   for o in observations
                   if o.semantic_descriptor is not None), default=0)
        if wid > self.desc_dim:
            self.ensure_desc_dim(wid)

    def _pack(self, clouds, observations):
        O = self.obs_capacity
        Q = self.params.max_points_per_segment
        obs_pts = np.zeros((O, Q, 3), np.float32)
        obs_val = np.zeros((O, Q), bool)
        obs_desc = np.zeros((O, self.desc_dim), np.float32)
        obs_mask = np.zeros((O,), bool)
        for k, (cloud, obs) in enumerate(zip(clouds, observations[:O])):
            pts = self._fit_points(np.asarray(cloud))
            n = min(len(pts), Q)
            obs_pts[k, :n] = pts[:n]
            obs_val[k, :n] = True
            if obs.semantic_descriptor is not None:
                d = np.asarray(obs.semantic_descriptor).reshape(-1)[: self.desc_dim]
                obs_desc[k, : len(d)] = d
            obs_mask[k] = n > 0
        return obs_pts, obs_val, obs_desc, obs_mask

    def pack_observations(self, observations):
        """An Observation list as padded arrays, camera frame."""
        self._widen_for(observations)
        O = self.obs_capacity
        return self._pack([o.point_cloud for o in observations[:O]], observations)

    def update(self, t: float, pose: np.ndarray, observations,
               frame_descriptor: Optional[np.ndarray] = None):
        """Mapper.update's contract (mapper.py:47): observations carry
        camera-frame clouds and descriptors. One frame, its step issued op
        by op (update_batch is the fast path on a card)."""
        self.poses.append(np.asarray(pose))
        self.times.append(float(t))
        if frame_descriptor is not None:
            self.frame_descriptors.append(np.asarray(frame_descriptor))
        if len(observations) == 0:
            # an empty frame is a no-op beyond the history (mapper.py:56-57)
            return
        self._widen_for(observations)
        O = self.obs_capacity
        obs_pts, obs_val, obs_desc, obs_mask = self._pack(
            [o.transformed_points for o in observations[:O]], observations)
        self.state = self._step(
            self.state, self._f32(t), self._f32(np.asarray(pose)[:3, 3]),
            self._f32(obs_pts), torch.as_tensor(obs_val, device=self.device),
            self._f32(obs_desc), torch.as_tensor(obs_mask, device=self.device))
        self.maybe_spill()

    def _export_arrays(self):
        """The export program (roman_tpu/map/batch_mapper.py:632-700) on the
        device, then one fetch of each field: the retirement cleanup (the
        largest DBSCAN cluster of every row, eps scaled to a coarsened
        row's spacing), OBB volume and extent and the shape attributes."""
        st = self.state
        keep = largest_cluster_mask(st.points, st.points_valid,
                                    eps=self.params.clustering_epsilon,
                                    adaptive_spacing_factor=1.6)
        vol, extent = obb_volume_extent(st.points, keep)
        attrs = shape_attributes(st.points, keep)

        def host(x):
            return x.cpu().numpy()

        return (host(st.points), host(keep), host(st.descriptors),
                host(st.desc_count), host(st.first_seen), host(st.last_seen),
                host(vol), host(extent), host(attrs), host(st.status),
                host(st.num_sightings), host(st.seg_id))

    def _export_segments(self, statuses, include_mature_nursery=False):
        """SegmentData records and their slots for the pool slots whose
        status is in `statuses`. include_mature_nursery adds NURSERY slots
        with num_sightings >= min_sightings, which the host mapper promotes
        within the same update (mapper.py:122-127)."""
        (points, points_valid, desc, desc_count, first_seen, last_seen,
         vol, extent, attrs, status, num_sightings, seg_id) = self._export_arrays()
        export_mask = np.isin(status, list(statuses))
        if include_mature_nursery:
            export_mask |= (status == NURSERY) & (
                num_sightings >= self.params.min_sightings)
        segments, slots = [], []
        for i in np.flatnonzero(export_mask):
            pv = points_valid[i]
            if not pv.any():
                continue
            pts = points[i][pv]
            segments.append(SegmentData(
                id=int(seg_id[i]),
                center=pts.mean(axis=0),
                volume=float(vol[i]),
                linearity=float(attrs[i, 0]),
                planarity=float(attrs[i, 1]),
                scattering=float(attrs[i, 2]),
                extent=extent[i],
                semantic_descriptor=desc[i] if desc_count[i] > 0 else None,
                first_seen=float(first_seen[i]),
                last_seen=float(last_seen[i]),
                points=pts.astype(np.float32),
            ))
            slots.append(i)
        return segments, slots

    def maybe_spill(self, force: bool = False):
        """Move GRAVEYARD segments off the device when the pool fills up
        (checked every spill_check_every updates): they are never
        associated, merged or updated again, so they are exported (with the
        cleanup) to a host list and their slots freed."""
        self._updates_since_spill_check += 1
        if not force and self._updates_since_spill_check < self.spill_check_every:
            return
        self._updates_since_spill_check = 0
        status = self.state.status.cpu().numpy()
        if not force and (status > EMPTY).mean() < self.spill_threshold:
            return
        if not (status == RETIRED).any():
            return
        segs, slots = self._export_segments((RETIRED,))
        self._spilled += segs
        if not slots:
            return
        mask = np.zeros(len(status), bool)
        mask[slots] = True
        m = torch.as_tensor(mask, device=self.device)
        st = self.state
        self.state = st.replace(
            status=torch.where(m, EMPTY, st.status),
            seg_id=torch.where(m, -1, st.seg_id),
            points_valid=st.points_valid & ~m[:, None],
            desc_count=torch.where(m, 0.0, st.desc_count),
            num_sightings=torch.where(m, 0, st.num_sightings),
            last_seen=torch.where(m, -1e9, st.last_seen),
            vox_keys=torch.where(m[:, None], _INVALID, st.vox_keys),
            vox_n=torch.where(m, 0, st.vox_n),
        )

    def get_roman_map(self) -> RomanMap:
        """The spilled segments and the pool's ACTIVE, INACTIVE, GRAVEYARD
        and mature NURSERY slots as a RomanMap (the host map's graveyard +
        inactive + graduated segments, mapper.py:335-349)."""
        segments, _ = self._export_segments(
            (ACTIVE, INACTIVE, GRAVEYARD), include_mature_nursery=True)
        segments = list(self._spilled) + segments
        return RomanMap(
            segments=segments,
            trajectory=(np.stack(self.poses) @ self._T_camera_flu
                        if self.poses else np.zeros((0, 4, 4))),
            times=np.asarray(self.times),
            descriptors=(np.stack(self.frame_descriptors)
                         if self.frame_descriptors else None),
        )
