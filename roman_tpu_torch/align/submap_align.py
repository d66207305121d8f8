"""All-pairs submap alignment: the alignment stage from submaps to results.

Port of roman_tpu/align/submap_align.py (reference
roman/align/submap_align.py iterates the (i, j) submap pair grid serially,
one C++ CLIPPER solve + Arun SVD per pair, :93-201). Here the pair grid is
registered in batches on the card by ``PairGridRegistrar``, then the same
gating, post-filters, error metrics and result matrices as the reference
are filled in on the host:

- distance / AABB gating into robots_nearby (:96-103)
- shared-segment removal for single-robot loop closure (:108-115)
- GT relative pose + yaw difference (:117-129)
- submap-descriptor cosine gate (:131-149)
- skip_distance hard gate (:136-142)
- upside-down rejection and roll/pitch removal (:167-172)
- per-pair angular/translation error vs (GT) relative pose (:159-175)
- result matrices incl. percent associations (:186-200)
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch
import yaml

from roman_tpu_torch import tracing
from roman_tpu_torch.align import registration as reg
from roman_tpu_torch.align.invariants import SubmapFeatures
from roman_tpu_torch.align.registration import RegistrationConfig, RegistrationResult
from roman_tpu_torch.align.results import SubmapAlignResults, save_submap_align_results
from roman_tpu_torch.data.pose_data import PoseData
from roman_tpu_torch.device import to_device, to_host
from roman_tpu_torch.map.roman_map import (
    RomanMap,
    Submap,
    SubmapParams,
    load_roman_map,
    submaps_from_roman_map,
    submaps_to_features,
)
from roman_tpu_torch.ops import se3_np
from roman_tpu_torch.parallel.mesh import (Mesh, home_device, pad_to_multiple,
                                             pair_slices, replicated)
from roman_tpu_torch.params.submap_align_params import (
    SubmapAlignInputOutput,
    SubmapAlignParams,
)
from roman_tpu_torch.utils import aabb_intersects, expandvars_recursive


class PairGridRegistrar:
    """Registers arbitrary batches of submap pairs, chunk by chunk.

    Each chunk of pair indices gathers its features on the device and goes
    through the method's registration (roman_tpu/align/submap_align.py:
    206-219): ``register_clipper`` for the ROMAN family (five kernel
    launches per chunk on the card for geometric-mean fusion: the fused
    path's four and Arun's), ``register_clipper_prune`` for clipper+prune
    (the same five launches, with a pruned association mask),
    ``register_ransac`` for ransac (torch code; its draws are made once
    per call for the whole pair list from `seed`, and each pair takes its
    own row wherever it runs). For the
    CLIPPER methods, pairs whose homotopy did not converge are then
    re-solved once, unsharded on the first device, at
    ``registration.rescue_solver`` budget and spliced back; ransac has no
    homotopy and no rescue. chunk_size bounds the device memory of a
    chunk: its (chunk, N, N) bf16 affinity is 5.12 MB per pair at
    capacity 40.

    With a mesh (``parallel.mesh``), the chunk is rounded up to a multiple
    of the mesh size, the features and id tables are replicated on every
    mesh device, and each chunk's pairs are split across the devices
    (``pair_slices``); the results stay on the devices until every chunk
    is launched, then come home once a device. Without one, everything
    runs on `device` (default cuda).
    """

    def __init__(self, cfg: RegistrationConfig, single_robot_lc: bool = False,
                 chunk_size: int = 64, mesh: Optional[Mesh] = None, device=None):
        self.cfg = cfg
        self.single_robot_lc = single_robot_lc
        self.device = home_device(mesh, device)
        self.mesh = mesh if mesh is not None else Mesh((self.device,))
        if mesh is not None:
            chunk_size = pad_to_multiple(max(chunk_size, mesh.size), mesh.size)
        self.chunk_size = chunk_size
        self.rescued = 0  # pairs the last call re-solved at rescue budget

    def _launch(self, f1: SubmapFeatures, f2: SubmapFeatures, ids1, ids2,
                cfg: RegistrationConfig, draws=None):
        """Launch the registration of a batch of pairs; returns a function
        that finishes it into a RegistrationResult. For the CLIPPER methods
        the launch is solve_clipper and the finish is Arun's T_align (a
        kernel), ok and converged: on the card neither waits for the
        device, so the host gathers and launches the next chunk while the
        card runs this one, and the first wait of a call is its results'
        copy home. A chunk launches all of its shards before it finishes
        any. Ransac runs whole in the launch."""
        if self.single_robot_lc:
            # remove segments whose ids appear in both submaps
            # (submap_align.py:108-115)
            shared1 = torch.any(
                ids1[..., :, None] == torch.where(f2.valid, ids2, -2)[..., None, :],
                dim=-1)
            shared2 = torch.any(
                ids2[..., :, None] == torch.where(f1.valid, ids1, -2)[..., None, :],
                dim=-1)
            f1 = dataclasses.replace(f1, valid=f1.valid & ~shared1)
            f2 = dataclasses.replace(f2, valid=f2.valid & ~shared2)
        if cfg.method == "ransac":
            res = reg.register_ransac(f1, f2, cfg, draws)
            return lambda: res
        if cfg.method == "clipper+prune":
            F1, F2 = f1.ratio_feats.shape[-1], f2.ratio_feats.shape[-1]
            mask = reg.prune_mask(
                f1, f2, cfg,
                pca_attrs1=f1.ratio_feats[..., :3] if F1 >= 3 else None,
                volume1=f1.ratio_feats[..., 3] if F1 >= 4 else None,
                pca_attrs2=f2.ratio_feats[..., :3] if F2 >= 3 else None,
                volume2=f2.ratio_feats[..., 3] if F2 >= 4 else None,
                descriptors1=f1.descriptors if f1.descriptors.shape[-1] else None,
                descriptors2=f2.descriptors if f2.descriptors.shape[-1] else None)
            out = reg.solve_clipper(f1, f2, cfg, mask)
            return lambda: reg.gravity_check(reg.finish_clipper(f1, f2, cfg, *out), cfg)
        out = reg.solve_clipper(f1, f2, cfg)
        return lambda: reg.finish_clipper(f1, f2, cfg, *out)

    def _run(self, mesh: Mesh, data, pair_i, pair_j, cfg: RegistrationConfig,
             times=None, draws=None) -> RegistrationResult:
        """Register pairs (pair_i[p], pair_j[p]) chunk by chunk, each
        chunk's pairs split across the mesh's shards; data[k] holds
        (feats1, feats2, ids1, ids2) on shard k's device. Returns the
        result on the CPU, in pair order, with u dropped."""
        P, C, n = len(pair_i), self.chunk_size, mesh.size
        chunks = [np.arange(s, min(s + C, P)) for s in range(0, P, C)]
        pieces = [[rows[sl] for sl in pair_slices(len(rows), n)] for rows in chunks]
        starts = np.cumsum([[0] * n] + [[len(p) for p in c] for c in pieces], axis=0)
        own = [np.concatenate([c[k] for c in pieces]) for k in range(n)]
        # each shard's pair indices and draws go up once, before the first
        # launch: a pageable copy returns only when it is done, so a copy a
        # chunk would hold the other devices back
        with tracing.span("engine.stage"):
            up = [(to_device(pair_i[rows], dev), to_device(pair_j[rows], dev),
                   None if draws is None else to_device(draws[torch.as_tensor(rows)], dev))
                  for rows, dev in zip(own, mesh.devices)]
        parts = [[] for _ in range(n)]

        for c, rows in enumerate(chunks):
            t0 = time.perf_counter()
            finish = []
            for k in range(n):
                sl = slice(int(starts[c][k]), int(starts[c + 1][k]))
                if sl.start == sl.stop:
                    continue
                with tracing.span("engine.gather"):
                    ii, jj, dr = (None if x is None else x[sl] for x in up[k])
                    f1, f2, ids1, ids2 = data[k]
                    chunk = (f1.map(lambda x: x[ii]), f2.map(lambda x: x[jj]),
                             ids1[ii], ids2[jj])
                finish.append((k, self._launch(*chunk, cfg, dr)))
            for k, done in finish:
                parts[k].append(done())
            if times is not None:
                for dev in set(mesh.devices):
                    if dev.type == "cuda":
                        tracing.count_sync(dev)
                        torch.cuda.synchronize(dev)
                times[rows] = (time.perf_counter() - t0) / len(rows)

        def home(name):
            if name == "u" or getattr(parts[0][0], name) is None:
                return None
            x = torch.cat([to_host(torch.cat([getattr(r, name) for r in p]))
                           for p in parts if p])
            out = torch.empty_like(x)
            out[order] = x
            return out

        with tracing.span("engine.home"):
            order = torch.as_tensor(np.concatenate(own))
            return RegistrationResult(**{f.name: home(f.name)
                                         for f in dataclasses.fields(RegistrationResult)})

    def __call__(self, feats1: SubmapFeatures, feats2: SubmapFeatures,
                 ids1_all, ids2_all, pair_i, pair_j, seed: int = 0,
                 timed: bool = False):
        """feats*: SubmapFeatures over all submaps of each robot;
        ids*_all: (S, capacity) segment ids; pair_i/pair_j: (P,) submap
        indices to register; seed: the ransac draws' seed. Returns a
        RegistrationResult of numpy arrays of length P (u dropped;
        converged None for ransac), and with timed=True also the (P,)
        per-pair wall times (chunk time / chunk size, a chunk's time
        covering all of its shards)."""
        with tracing.span("engine.call"):
            P = len(pair_i)
            self.rescued = 0
            if P == 0:
                return (None, np.zeros(0)) if timed else None
            pair_i = np.asarray(pair_i)
            pair_j = np.asarray(pair_j)
            with tracing.span("engine.stage"):
                data = replicated((feats1, feats2, np.asarray(ids1_all),
                                   np.asarray(ids2_all)), self.mesh)
            times = np.zeros(P) if timed else None
            draws = (reg.ransac_draws(seed, P, self.cfg.ransac_iter)
                     if self.cfg.method == "ransac" else None)
            res = self._run(self.mesh, data, pair_i, pair_j, self.cfg, times, draws)
            if res.converged is not None:
                with tracing.span("engine.rescue"):
                    bad = np.flatnonzero(~res.converged.numpy())
                    self.rescued = int(bad.size)
                    tracing.count("engine.rescued_pairs", self.rescued)
                    if bad.size:
                        rcfg = dataclasses.replace(self.cfg,
                                                   solver=reg.rescue_solver(self.cfg.solver))
                        res2 = self._run(Mesh(self.mesh.devices[:1]), data[:1],
                                         pair_i[bad], pair_j[bad], rcfg)
                        res = reg.splice_rescued(res, res2, bad)

            with tracing.span("engine.home"):
                out = RegistrationResult(**{
                    f.name: None if getattr(res, f.name) is None else getattr(res, f.name).numpy()
                    for f in dataclasses.fields(RegistrationResult)})
            return (out, times) if timed else out


def submap_align(sm_params: SubmapAlignParams, sm_io: SubmapAlignInputOutput,
                 mesh: Optional[Mesh] = None, chunk_size: int = 64,
                 precomputed_submaps: Optional[List[List[Submap]]] = None,
                 roman_maps: Optional[List[RomanMap]] = None,
                 device=None, seed: int = 0) -> SubmapAlignResults:
    """Full alignment stage; equivalent of reference submap_align
    (submap_align.py:28-220), writing the same artifact set. Registers on
    `device` (default cuda; device="cpu" runs the plain PyTorch path), or
    with each chunk's pairs split across `mesh` (``parallel.mesh``; its
    first device is then the stage's device); seed is the ransac draws'
    seed."""
    device = home_device(mesh, device)
    # --- load ground truth pose data (submap_align.py:41-58) ---
    gt_pose_data = [None, None]
    for i, yaml_file in enumerate(sm_io.input_gt_pose_yaml):
        if yaml_file is not None:
            if sm_io.robot_env is not None:
                os.environ[sm_io.robot_env] = sm_io.robot_names[i]
            with open(expandvars_recursive(yaml_file)) as f:
                gt_args = yaml.safe_load(f)
            gt_pose_data[i] = PoseData.from_yaml_spec(gt_args)

    # --- load maps, build submaps (submap_align.py:60-65) ---
    if roman_maps is None:
        if not sm_io.input_type_pkl:
            raise NotImplementedError("only map pickles are supported as input")
        roman_maps = [load_roman_map(sm_io.inputs[i]) for i in range(2)]
    if precomputed_submaps is None:
        submap_params = SubmapParams.from_submap_align_params(sm_params)
        submap_params.use_minimal_data = True
        submaps = [
            submaps_from_roman_map(roman_maps[i], submap_params, gt_pose_data[i])
            for i in range(2)
        ]
    else:
        submaps = precomputed_submaps

    total_t0 = time.time()
    cfg = sm_params.get_registration_config()
    results = align_submap_lists(
        submaps, cfg, sm_params, sm_io, gt_pose_data, mesh=mesh,
        chunk_size=chunk_size, device=device, seed=seed,
    )
    results.total_time = time.time() - total_t0

    save_submap_align_results(results, submaps, roman_maps)
    return results


def align_submap_lists(submaps, cfg: RegistrationConfig,
                       sm_params: SubmapAlignParams, sm_io: SubmapAlignInputOutput,
                       gt_pose_data=(None, None), mesh: Optional[Mesh] = None,
                       chunk_size: int = 64, device=None,
                       seed: int = 0) -> SubmapAlignResults:
    """Core grid alignment on prebuilt submap lists (the registration split
    across `mesh` when one is given)."""
    device = home_device(mesh, device)
    n0, n1 = len(submaps[0]), len(submaps[1])
    cap = sm_params.submap_max_size

    if n0 == 0 or n1 == 0:
        # A degenerate map (e.g. perception produced no segments) must
        # not kill the multi-stage pipeline: emit a well-formed empty
        # result so the g2o/json artifacts exist with zero loop closures
        # and the rpgo stage still runs on odometry (failure-recovery
        # posture; the reference has no equivalent guard and crashes).
        nanmat = np.full((n0, n1), np.nan)
        return SubmapAlignResults(
            robots_nearby_mat=nanmat.copy(),
            clipper_angle_mat=nanmat.copy(),
            clipper_dist_mat=nanmat.copy(),
            clipper_num_associations=np.zeros((n0, n1), int),
            similarity_mat=None,
            submap_yaw_diff_mat=nanmat.copy(),
            associated_objs_mat=[[np.zeros((0, 2), int)] * n1] * n0,
            T_ij_mat=np.zeros((n0, n1, 4, 4)),
            T_ij_hat_mat=np.full((n0, n1, 4, 4), np.nan),
            timing_list=[],
            submap_align_params=sm_params,
            submap_io=sm_io,
        )

    feats = []
    auxs = []
    desc_dim = sm_params.semantics_dim if cfg.feature_flags[4] or cfg.method == "clipper+prune" else 0
    for k in range(2):
        f, aux = submaps_to_features(submaps[k], cfg, capacity=cap,
                                     desc_dim=desc_dim, device=device)
        feats.append(f)
        auxs.append(aux)

    # ---- host-side gating (submap_align.py:96-149) ----
    pos0 = (auxs[0]["positions_gt"] if auxs[0]["positions_gt"] is not None
            else auxs[0]["positions"])
    pos1 = (auxs[1]["positions_gt"] if auxs[1]["positions_gt"] is not None
            else auxs[1]["positions"])
    dist = np.linalg.norm(pos0[:, None, :] - pos1[None, :, :], axis=-1)

    nearby = np.full((n0, n1), np.nan)
    for i in range(n0):
        for j in range(n1):
            if (
                not sm_params.force_fill_submaps
                and sm_params.submap_radius is not None
                and dist[i, j] < sm_params.submap_radius * 2
            ) or (
                (sm_params.force_fill_submaps or sm_params.submap_radius is None)
                and aabb_intersects(
                    submaps[0][i].segments_as_global_points,
                    submaps[1][j].segments_as_global_points,
                )
            ):
                nearby[i, j] = dist[i, j]

    # GT relative pose + yaw difference (submap_align.py:117-129)
    T_w0 = (auxs[0]["poses_gravity_gt"] if gt_pose_data[0] is not None
            else auxs[0]["poses_gravity"])
    T_w1 = (auxs[1]["poses_gravity_gt"] if gt_pose_data[1] is not None
            else auxs[1]["poses_gravity"])
    T_ij_mat = np.einsum("iab,jbc->ijac", np.linalg.inv(T_w0), T_w1)
    yaw_diff = np.abs(np.rad2deg(se3_np.T_to_xyzrpy(T_ij_mat)[..., 5]))
    submap_yaw_diff_mat = np.where(~np.isnan(nearby), yaw_diff, np.nan)

    # submap descriptor similarity gate (submap_align.py:131-149)
    if sm_params.submap_descriptor is not None:
        similarity_mat = np.array(
            [[Submap.similarity(submaps[0][i], submaps[1][j]) for j in range(n1)]
             for i in range(n0)]
        )
    else:
        similarity_mat = np.full((n0, n1), np.inf)

    run_mask = (dist <= sm_io.skip_distance) & (
        similarity_mat >= sm_params.submap_descriptor_thresh
    )
    pair_i, pair_j = np.nonzero(run_mask)

    # ---- the batched registration (device) ----
    registrar = PairGridRegistrar(
        cfg, single_robot_lc=sm_params.single_robot_lc, chunk_size=chunk_size,
        mesh=mesh, device=device,
    )
    t0 = time.time()
    if sm_params.per_pair_timing:
        res, times = registrar(
            feats[0], feats[1], auxs[0]["seg_ids"], auxs[1]["seg_ids"],
            pair_i, pair_j, seed=seed, timed=True,
        )
        timing_list = list(times)
    else:
        res = registrar(
            feats[0], feats[1], auxs[0]["seg_ids"], auxs[1]["seg_ids"],
            pair_i, pair_j, seed=seed,
        )
        # one batched dispatch: attribute wall time uniformly
        reg_time = time.time() - t0
        n_solved = max(len(pair_i), 1)
        timing_list = [reg_time / n_solved] * len(pair_i)

    # ---- host-side post-filters + matrices ----
    angle_mat = np.full((n0, n1), np.nan)
    dist_mat = np.full((n0, n1), np.nan)
    num_assoc = np.full((n0, n1), np.nan)
    pct_assoc = np.full((n0, n1), np.nan)
    T_ij_hat_mat = np.full((n0, n1, 4, 4), np.nan)
    assoc_mat = [[np.zeros((0, 2), np.int64) for _ in range(n1)] for _ in range(n0)]

    # pairs hard-gated by skip_distance (submap_align.py:136-142)
    skip = dist > sm_io.skip_distance
    num_assoc[skip] = 0
    pct_assoc[skip] = 0.0

    # pairs gated by descriptor similarity -> "no match" record
    desc_gated = (~run_mask) & (~skip)
    for i, j in zip(*np.nonzero(desc_gated)):
        theta, d = 180.0, 1e6
        if not np.isnan(nearby[i, j]):
            angle_mat[i, j] = theta
            dist_mat[i, j] = d
        num_assoc[i, j] = 0
        pct_assoc[i, j] = 0.0

    if res is not None and len(pair_i):
        T_hat = res.T_align.copy()
        ok = res.ok.copy()
        rpy = se3_np.T_to_xyzrpy(T_hat)[:, 3:]
        if sm_params.dim == 3 and sm_params.force_rm_upside_down:
            upside_down = (np.abs(rpy[:, 0]) > np.deg2rad(90.0)) | (
                np.abs(rpy[:, 1]) > np.deg2rad(90.0)
            )
            ok = ok & ~upside_down
        if sm_params.dim == 3 and sm_params.force_rm_lc_roll_pitch:
            T_hat = se3_np.transform_rm_roll_pitch(T_hat)

        T_ij_sel = T_ij_mat[pair_i, pair_j]
        # guard: failed registrations carry garbage T; inv of near-singular
        # matrices is fine for error reporting since ok[k] gates usage
        T_hat_safe = np.where(np.isfinite(T_hat).all(axis=(1, 2), keepdims=True), T_hat,
                              np.eye(4))
        T_err = np.einsum("pab,pbc->pac", np.linalg.inv(T_hat_safe), T_ij_sel)
        theta_all = se3_np.rotation_magnitude(T_err[:, :3, :3])
        d_all = np.linalg.norm(T_err[:, : sm_params.dim, 3], axis=-1)

        for k, (i, j) in enumerate(zip(pair_i, pair_j)):
            if ok[k]:
                theta, d = float(theta_all[k]), float(d_all[k])
                T_ij_hat_mat[i, j] = T_hat[k]
                sel = np.argwhere(np.asarray(res.sel[k]))
                assoc_mat[i][j] = sel
                count = int(res.count[k])
            else:
                # InsufficientAssociations / GravityConstraint path
                # (submap_align.py:179-184)
                theta, d = np.pi, 1e6
                count = 0
            if not np.isnan(nearby[i, j]):
                angle_mat[i, j] = np.abs(np.rad2deg(theta)) if ok[k] else 180.0
                dist_mat[i, j] = d
            num_assoc[i, j] = count
            len_i, len_j = len(submaps[0][i]), len(submaps[1][j])
            if sm_params.single_robot_lc:
                # registration ran on the submaps WITH shared segments
                # removed (reference prunes the deepcopied submaps and
                # divides by the pruned lengths, submap_align.py:108-115)
                inter = len({s.id for s in submaps[0][i].segments}
                            & {s.id for s in submaps[1][j].segments})
                len_i, len_j = len_i - inter, len_j - inter
            denom = np.mean([len_i, len_j])
            pct_assoc[i, j] = count / denom if denom > 0 else 0.0

    return SubmapAlignResults(
        robots_nearby_mat=nearby,
        clipper_angle_mat=angle_mat,
        clipper_dist_mat=dist_mat,
        clipper_num_associations=num_assoc,
        similarity_mat=similarity_mat if sm_params.submap_descriptor is not None else None,
        submap_yaw_diff_mat=submap_yaw_diff_mat,
        associated_objs_mat=assoc_mat,
        T_ij_mat=T_ij_mat,
        T_ij_hat_mat=T_ij_hat_mat,
        timing_list=timing_list,
        submap_align_params=sm_params,
        submap_io=sm_io,
    )
