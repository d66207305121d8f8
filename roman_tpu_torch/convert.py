"""Carry state across from roman_tpu.

The alignment engine's state is the per-submap features and the solver
configuration; the perception nets' is their weights. These helpers take
them as plain numpy arrays and Python values (for example
``jax.tree.map(np.asarray, f)`` of a roman_tpu SubmapFeatures,
``dataclasses.asdict`` of its RegistrationConfig, or the flax variables of
its ViT and YoloSeg as numpy pytrees), so this module needs nothing of JAX.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

from roman_tpu_torch.align.clipper import ClipperSolveParams
from roman_tpu_torch.align.invariants import SubmapFeatures
from roman_tpu_torch.align.registration import RegistrationConfig
from roman_tpu_torch.device import resolve_device

# RegistrationConfig fields of roman_tpu that select its TPU engine; the
# port has no counterpart (the device of the tensors decides)
_TPU_ONLY = {"use_pallas", "pallas_pairs_per_step", "pallas_interpret"}


def features_from_numpy(centers, ratio_feats, descriptors, valid,
                        device=None) -> SubmapFeatures:
    """SubmapFeatures on `device` (default cuda) from numpy arrays: centers
    (..., n, 3), ratio_feats (..., n, F), descriptors (..., n, D) as
    float32, valid (..., n) as bool."""
    dev = resolve_device(device)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return SubmapFeatures(
        centers=f32(centers), ratio_feats=f32(ratio_feats),
        descriptors=f32(descriptors),
        valid=torch.tensor(np.asarray(valid, bool), device=dev))


def _solver(fields) -> ClipperSolveParams:
    if isinstance(fields, ClipperSolveParams):
        return fields
    if not isinstance(fields, dict):
        fields = {f.name: getattr(fields, f.name)
                  for f in dataclasses.fields(ClipperSolveParams)}
    return ClipperSolveParams(**fields)


def solver_params_from_fields(**fields):
    """The port's ClipperSolveParams or RegistrationConfig from the fields
    of roman_tpu's.

    Fields of ClipperSolveParams only (warmup_iters, outer_iters,
    inner_iters, active_eps, n_restarts) give a ClipperSolveParams. Any
    other field gives a RegistrationConfig; its ``solver`` may be a dict
    of those fields or an object that has them, and the TPU engine fields
    (use_pallas, pallas_pairs_per_step, pallas_interpret) are dropped.
    """
    solve_names = {f.name for f in dataclasses.fields(ClipperSolveParams)}
    if fields and set(fields) <= solve_names:
        return ClipperSolveParams(**fields)
    kw = {k: v for k, v in fields.items() if k not in _TPU_ONLY}
    if "solver" in kw:
        kw["solver"] = _solver(kw["solver"])
    if kw.get("feature_overrides") is not None:
        kw["feature_overrides"] = tuple(kw["feature_overrides"])
    return RegistrationConfig(**kw)


# ---------------------------------------------------------------------------
# perception weights: flax variables -> the port's state dicts
# ---------------------------------------------------------------------------

def _flatten(tree, prefix=()):
    for key, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _flatten(sub, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(sub, np.float32)


def _flax_to_torch(variables) -> Dict[str, torch.Tensor]:
    """flax variables ({'params': ..., 'batch_stats': ...}, numpy leaves)
    of a module whose torch counterpart has the same module names ->
    state dict. Layouts: Conv kernels HWIO -> OIHW; ConvTranspose kernels
    (kh, kw, in, out) -> (in, out, kh, kw) with the spatial taps flipped
    (flax applies them unflipped, torch as a transposed convolution);
    Dense kernels (in, out) -> (out, in); LayerNorm/BatchNorm scale ->
    weight; batch stats mean/var -> running_mean/running_var."""
    out = {}
    for path, v in _flatten(variables.get("params", {})):
        *mods, leaf = path
        if leaf == "kernel" and v.ndim == 4 and mods[-1] == "upsample":
            v, leaf = v[::-1, ::-1].transpose(2, 3, 0, 1), "weight"
        elif leaf == "kernel" and v.ndim == 4:
            v, leaf = v.transpose(3, 2, 0, 1), "weight"
        elif leaf == "kernel":
            v, leaf = v.T, "weight"
        elif leaf == "scale":
            leaf = "weight"
        out[".".join(mods + [leaf])] = torch.tensor(np.ascontiguousarray(v))
    for path, v in _flatten(variables.get("batch_stats", {})):
        *mods, leaf = path
        name = {"mean": "running_mean", "var": "running_var"}[leaf]
        out[".".join(mods + [name])] = torch.tensor(np.ascontiguousarray(v))
    return out


def vit_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """roman_tpu ViT (DINOv2 or CLIP) variables -> the port's ViT state
    dict (``perception.vit.ViT.load_state_dict``)."""
    return _flax_to_torch(variables)


def yoloseg_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """roman_tpu YoloSeg variables (params and batch_stats) -> the port's
    YoloSeg state dict."""
    return _flax_to_torch(variables)
