"""The pipeline's three sharded steps over an n-device mesh, each held
against its unsharded run (port of __graft_entry__.py::dryrun_multichip,
:109-248).

- ``grid_step``: the chunked pair grid at flagship shapes (capacity 40,
  768-d descriptors, 6 submaps, 36 pairs) through ``PairGridRegistrar``
  with each chunk's pairs split across the mesh;
- ``mapping_step``: one ``BatchMapper`` frame for each of n robots, robot r
  mapped on the mesh's device r (mapping is a filter over time, so its
  parallel axis is robots);
- ``pgo_step``: one Gauss-Newton step of the pose-graph solve with its
  edges split across the mesh: each shard forms its edges' terms on its
  device, and the per-vertex sums of the gradient, the preconditioner
  blocks and every CG matvec are added on the mesh's first device, in
  shard order (the reduction XLA inserts under a sharded edge axis).

With ``get_mesh(n, device="cuda:0")`` (or "cpu") the shards are virtual,
all on one device: how a one-card host exercises the split.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from roman_tpu_torch.align.invariants import SubmapFeatures
from roman_tpu_torch.align.registration import RegistrationConfig
from roman_tpu_torch.align.submap_align import PairGridRegistrar
from roman_tpu_torch.data.camera import CameraParams
from roman_tpu_torch.map.batch_mapper import BatchMapper, MapState
from roman_tpu_torch.ops import se3
from roman_tpu_torch.parallel.mesh import Mesh, get_mesh, pair_slices
from roman_tpu_torch.params.mapper_params import MapperParams
from roman_tpu_torch.rpgo.solver import (RPGOSolverParams, _edge_matvec,
                                         _edge_terms, _gn_step, _Graph,
                                         _pcg_update)
from roman_tpu_torch.sim import world

GRID_CFG = RegistrationConfig(method="roman", cos_min=0.5, cos_max=0.9)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def make_pair_batch(P: int = 4, cap: int = 16, desc_dim: int = 32,
                    seed: int = 0) -> dict:
    """P seeded sim pair problems padded to `cap` objects and stacked:
    numpy arrays keyed as world.pad_problem's, float32 but for the bool
    masks (__graft_entry__.py:16-31)."""
    rng = np.random.default_rng(seed)
    pads = [world.pad_problem(world.make_pair_problem(
        rng, n_common=cap // 2, n_only1=cap // 4, n_only2=cap // 4,
        desc_dim=desc_dim), cap) for _ in range(P)]
    return {k: np.stack([d[k] for d in pads]).astype(
        np.float32 if pads[0][k].dtype != bool else bool) for k in pads[0]}


def batch_features(stack: dict, side: int, device) -> SubmapFeatures:
    """The SubmapFeatures of one side (1 or 2) of make_pair_batch's
    problems: pca and volume as ratio features, the descriptors."""
    ratio = np.concatenate([stack[f"pca{side}"], stack[f"volume{side}"][..., None]],
                           axis=-1)
    return SubmapFeatures(
        centers=torch.as_tensor(stack[f"centers{side}"], device=device),
        ratio_feats=torch.as_tensor(ratio, device=device),
        descriptors=torch.as_tensor(stack[f"desc{side}"], device=device),
        valid=torch.as_tensor(stack[f"valid{side}"], device=device))


def grid_step(mesh: Mesh, cap: int = 40, desc_dim: int = 768,
              n_sub: int = 6) -> dict:
    """Every submap of one robot against every one, n_sub x n_sub pairs,
    at chunk 2n over the mesh and unsharded on its first device: equal
    selections and counts, T_align within 1e-4, the diagonal's counts >= 3
    (each submap against itself)."""
    home = mesh.devices[0]
    feats = batch_features(make_pair_batch(P=n_sub, cap=cap, desc_dim=desc_dim,
                                           seed=3), 1, home)
    ids = np.arange(n_sub * cap, dtype=np.int32).reshape(n_sub, cap)
    gi, gj = (g.reshape(-1) for g in np.meshgrid(np.arange(n_sub), np.arange(n_sub),
                                                 indexing="ij"))
    chunk = 2 * mesh.size
    res = PairGridRegistrar(GRID_CFG, chunk_size=chunk, mesh=mesh)(
        feats, feats, ids, ids, gi, gj)
    ref = PairGridRegistrar(GRID_CFG, chunk_size=chunk, device=home)(
        feats, feats, ids, ids, gi, gj)
    _require(res.sel.shape == (n_sub * n_sub, cap, cap), f"sel {res.sel.shape}")
    diag = res.count.reshape(n_sub, n_sub).diagonal()
    _require(bool((diag >= 3).all()), f"diagonal counts {diag}")
    _require(np.array_equal(res.sel, ref.sel) and np.array_equal(res.count, ref.count),
             "the sharded grid's selections differ from the unsharded grid's")
    T_err = float(np.max(np.abs(res.T_align - ref.T_align)))
    _require(T_err <= 1e-4, f"T_align differs by {T_err} from the unsharded grid")
    return dict(pairs=len(gi), chunk=chunk, total_assoc=int(res.count.sum()),
                T_err=T_err, same_bytes=all(
                    np.array_equal(getattr(res, f), getattr(ref, f))
                    for f in ("sel", "count", "T_align", "ok", "score", "converged")))


def _map_one(device, pts, val, desc, mask) -> MapState:
    """One frame of a fresh BatchMapper (32 segments of 32 points, 8-d
    descriptors) on `device`, at t = 0 and the identity pose."""
    mp = MapperParams(max_segments=32, max_points_per_segment=32,
                      min_sightings=2, geometric_score_range=(0.1, 1.0))
    mapper = BatchMapper(mp, CameraParams.simple(), desc_dim=8, obs_capacity=4,
                         device=device)
    mapper.update_batch(np.zeros(1), np.eye(4)[None], pts[None], val[None],
                        desc[None], mask[None])
    return mapper.state


def mapping_step(mesh: Mesh) -> dict:
    """One frame of 4 observations of 16 points for each of n robots (seed
    7), robot r on mesh.devices[r]: every robot spawns segments, and each
    robot's pool equals that robot mapped alone on the first device."""
    R, O, Q = mesh.size, 4, 16
    rng = np.random.default_rng(7)
    pts = rng.uniform(0, 5, (R, O, Q, 3)).astype(np.float32)
    val = np.ones((R, O, Q), bool)
    desc = rng.normal(size=(R, O, 8)).astype(np.float32)
    mask = np.ones((R, O), bool)
    states = [_map_one(dev, pts[r], val[r], desc[r], mask[r])
              for r, dev in enumerate(mesh.devices)]
    spawned = [int((s.status > 0).sum()) for s in states]
    _require(min(spawned) >= 1, f"live segments a robot {spawned}")
    for r, s in enumerate(states):
        alone = _map_one(mesh.devices[0], pts[r], val[r], desc[r], mask[r])
        for f in dataclasses.fields(MapState):
            _require(torch.equal(getattr(s, f.name).cpu(), getattr(alone, f.name).cpu()),
                     f"robot {r}'s {f.name} differs from the robot mapped alone")
    return dict(robots=R, segments=spawned)


def pgo_step(mesh: Mesh) -> dict:
    """One GN step (10 CG iterations, damping 1e-6, gauge weight 1e6) on a
    seeded chain of V = 4n poses and E = 8n edges, the edges split across
    the mesh, against the unsharded _gn_step: poses within 1e-5."""
    n, home = mesh.size, mesh.devices[0]
    V, E = 4 * n, 8 * n
    rng = np.random.default_rng(1)
    T = se3.se3_exp(torch.as_tensor(rng.normal(size=(V, 6)).astype(np.float32)
                                    * 0.1)).to(home)
    ii = np.arange(E) % (V - 1)
    jj = ii + 1
    Tm = se3.se3_exp(torch.as_tensor(rng.normal(size=(E, 6)).astype(np.float32)
                                     * 0.1)).double().numpy()
    info = np.tile(np.eye(6), (E, 1, 1))
    w = torch.ones(E, dtype=torch.float32)
    params = RPGOSolverParams(cg_iters=10, damping=1e-6, gauge_weight=1e6)
    ref = _gn_step(_Graph(V, ii, jj, Tm, info, home), T, w.to(home), params)

    graphs = [_Graph(V, ii[s], jj[s], Tm[s], info[s], dev)
              for s, dev in zip(pair_slices(E, n), mesh.devices)]
    terms = [_edge_terms(g, T.to(dev), w[s].to(dev))
             for g, s, dev in zip(graphs, pair_slices(E, n), mesh.devices)]

    def total(parts):  # the shards' (V, ...) sums, added on home in shard order
        out = parts[0].to(home)
        for p in parts[1:]:
            out = out + p.to(home)
        return out

    def matvec(x):
        return total([_edge_matvec(g, t[0], x.to(dev))
                      for g, t, dev in zip(graphs, terms, mesh.devices)])

    T2 = _pcg_update(T, total([t[1] for t in terms]), total([t[2] for t in terms]),
                     matvec, graphs[0].gauge, params)
    err = float(torch.max(torch.abs(T2 - ref)))
    _require(err <= 1e-5, f"sharded GN step differs by {err} from the unsharded one")
    chi2 = float(sum(g.chi2(T2.to(dev)).sum().cpu()
                     for g, dev in zip(graphs, mesh.devices)))
    return dict(vertices=V, edges=E, max_abs_err=err, chi2=chi2)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The three steps over get_mesh(n_devices, device): the first n
    visible cards, or n virtual shards on `device`. Raises if a step
    disagrees with its unsharded run; returns each step's numbers."""
    mesh = get_mesh(n_devices, device)
    out = dict(mesh=repr(mesh), grid=grid_step(mesh), mapping=mapping_step(mesh),
               pgo=pgo_step(mesh))
    print(f"dryrun_multichip({n_devices}): {out['mesh']}: grid of "
          f"{out['grid']['pairs']} pairs ok (total assoc {out['grid']['total_assoc']}, "
          f"T_align within {out['grid']['T_err']:.2e}), mapping step ok (segments "
          f"{out['mapping']['segments']}), GN step ok (within "
          f"{out['pgo']['max_abs_err']:.2e})", flush=True)
    return out
