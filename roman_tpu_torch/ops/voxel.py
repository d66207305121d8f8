"""Voxel-grid occupancy and IOU/IOM over padded point sets, batched.

Port of roman_tpu/ops/voxel.py (reference roman/map/voxel_grid.py).
Occupancy is a row of *sorted integer voxel keys* over a padded point set;
intersections count equal keys. Every op has a fixed shape and batches
over leading dimensions.

Conventions match the reference: a voxel's index is floor(p / voxel_size)
(integer-aligned world grid), occupancy is binary, iou = |I| / |U|, iom =
|I| / min(|A|, |B|) (voxel_grid.py:75-83).

The keys are roman_tpu's bit for bit: the same chained murmur ``fmix32``
over the int32 voxel coordinates. torch has no full unsigned 32-bit
arithmetic, so the hash runs on int64 values held in [0, 2**32) and its
products are split so that no int64 product overflows.
"""

from __future__ import annotations

import numpy as np
import torch

_INVALID = 2**31 - 1
_MASK32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for int64 h in [0, 2**32): c split in 16-bit
    halves keeps every product below 2**49."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def voxel_keys(points: torch.Tensor, mask: torch.Tensor,
               voxel_size) -> torch.Tensor:
    """Hashed int32 voxel keys of the valid points; _INVALID for padding.

    mix(x ^ mix(y ^ mix(z))) over the voxel coordinates floor(p / vs)
    truncated to int32, as roman_tpu computes them
    (roman_tpu/ops/voxel.py:35-60) inside the jit of its mapper and front
    end: there the voxel size is a constant, and XLA folds the division
    into a multiply by f32(1 / vs), so the keys are floor(p * f32(1 / vs)).
    The two differ for points on a voxel boundary, e.g. a depth of 1.5 m at
    0.05 m voxels. A key equal to _INVALID becomes 0, so padding never
    aliases a real voxel."""
    inv = float(np.float32(1.0) / np.float32(voxel_size))   # a scalar: no kernel
    v = torch.floor(points * inv).to(torch.int32).to(torch.int64)
    vu = v & _MASK32
    h = _mix32(vu[..., 2])
    h = _mix32(h ^ vu[..., 1])
    h = _mix32(h ^ vu[..., 0])
    key = torch.where(h >= 2**31, h - 2**32, h).to(torch.int32)
    key = torch.where(key == _INVALID, torch.zeros_like(key), key)
    return torch.where(mask, key, torch.full_like(key, _INVALID))


def _first_of_run(s: torch.Tensor) -> torch.Tensor:
    """True where a sorted row starts a run of equal valid keys."""
    first = torch.ones_like(s, dtype=torch.bool)
    first[..., 1:] = s[..., 1:] != s[..., :-1]
    return first & (s != _INVALID)


def _sorted_unique(keys: torch.Tensor):
    """(sorted keys with duplicates set to _INVALID and sorted again, so
    the unique keys fill the prefix; number of unique keys)."""
    s = torch.sort(keys, dim=-1).values
    first = _first_of_run(s)
    uniq = torch.where(first, s, torch.full_like(s, _INVALID))
    uniq = torch.sort(uniq, dim=-1).values
    return uniq, first.sum(dim=-1, dtype=torch.int32)


def sorted_unique_keys(points: torch.Tensor, mask: torch.Tensor, voxel_size):
    """(sorted unique voxel keys (..., n), occupied count (...,)): the
    cached occupancy of a pool row, read by voxel_iou_cross_keys."""
    return _sorted_unique(voxel_keys(points, mask, voxel_size))


def _iou_from_counts(inter, n1, n2, iom_as_iou):
    inter = inter.to(torch.float32)
    n1 = n1.to(torch.float32)
    n2 = n2.to(torch.float32)
    denom = torch.minimum(n1, n2) if iom_as_iou else n1 + n2 - inter
    return torch.where(denom > 0, inter / torch.clamp(denom, min=1.0),
                       torch.zeros_like(inter))


def voxel_iou_points(points1, mask1, points2, mask2, voxel_size,
                     iom_as_iou: bool = False) -> torch.Tensor:
    """Voxel IOU (or IOM) between two padded point sets (..., n, 3) and
    (..., m, 3), paired along the leading dims. Returns (...,)."""
    k1, n1 = sorted_unique_keys(points1, mask1, voxel_size)
    k2, n2 = sorted_unique_keys(points2, mask2, voxel_size)
    hit = ((k1[..., :, None] == k2[..., None, :])
           & (k1[..., :, None] != _INVALID)).any(dim=-1)
    return _iou_from_counts(hit.sum(dim=-1), n1, n2, iom_as_iou)


def voxel_iou_cross(points1, mask1, points2, mask2, voxel_size,
                    iom_as_iou: bool = False) -> torch.Tensor:
    """All-pairs voxel IOU: points1 (S, P, 3), points2 (O, Q, 3) -> (S, O),
    with each set keyed once."""
    k1, n1 = sorted_unique_keys(points1, mask1, voxel_size)
    k2, n2 = sorted_unique_keys(points2, mask2, voxel_size)
    return voxel_iou_cross_keys(k1, n1, k2, n2, iom_as_iou=iom_as_iou)


def voxel_iou_cross_keys(k1, n1, k2, n2, iom_as_iou: bool = False,
                         method: str | None = None) -> torch.Tensor:
    """voxel_iou_cross over precomputed sorted_unique_keys outputs:
    k1 (S, P), k2 (O, Q) -> (S, O).

    Each row's keys are unique, so |A ∩ B| is the number of equal (p, q)
    key pairs. Two methods with the same counts (roman_tpu/ops/voxel.py:
    258-322):

    - "compare": broadcast equality, blocked over O so the (S, P, blk, Q)
      intermediate stays near 32 M elements;
    - "searchsorted" (the default): each key of k2 is looked up in every
      sorted row of k1, O(S * O * Q * log P). roman_tpu picks "compare"
      only on the TPU, where a binary search serializes.
    """
    S, P = k1.shape
    O, Q = k2.shape
    method = method or "searchsorted"
    if method == "compare":
        valid1 = k1 != _INVALID
        blk = max(1, min(O, int(32_000_000 // max(S * P * Q, 1))))
        parts = []
        for s in range(0, O, blk):
            k2b = k2[s:s + blk]
            eq = ((k1[:, :, None, None] == k2b[None, None, :, :])
                  & valid1[:, :, None, None])
            parts.append(eq.sum(dim=(1, 3), dtype=torch.int32))
        inter = torch.cat(parts, dim=1)
    elif method == "searchsorted":
        flat2 = k2.reshape(1, O * Q).expand(S, O * Q).contiguous()
        idx = torch.searchsorted(k1.contiguous(), flat2)
        got = ((torch.gather(k1, 1, torch.clamp(idx, max=P - 1)) == flat2)
               & (flat2 != _INVALID))
        inter = got.reshape(S, O, Q).sum(dim=-1, dtype=torch.int32)
    else:
        raise ValueError(f"unknown method {method!r}")
    return _iou_from_counts(inter, n1[:, None], n2[None, :], iom_as_iou)


def voxel_downsample(points: torch.Tensor, mask: torch.Tensor, voxel_size,
                     capacity: int | None = None,
                     max_coarsen_levels: int = 0):
    """Voxel-grid downsample: the mean of the points in each occupied
    voxel (o3d voxel_down_sample, reference segment.py:181).

    points (..., n, 3), mask (..., n) -> (out (..., cap, 3), out_mask
    (..., cap)) with cap = capacity or n; outputs are ordered by voxel key,
    and voxels past cap (the highest keys) are dropped.

    max_coarsen_levels > 0: a row whose occupied-voxel count exceeds cap
    doubles its voxel size (up to that many times, the finest level that
    fits) before downsampling, so the footprint is kept at a coarser
    resolution (roman_tpu/ops/voxel.py:115-140).

    Each voxel's sum is accumulated in sorted order by index_add_, as
    XLA's scatter-add does on the CPU.
    """
    n = points.shape[-2]
    cap = capacity or n
    lead = points.shape[:-2]
    keys = voxel_keys(points, mask, voxel_size)
    if max_coarsen_levels > 0:
        key_levels = [keys] + [
            voxel_keys(points, mask, voxel_size * (2.0 ** lvl))
            for lvl in range(1, max_coarsen_levels + 1)]
        occ = torch.stack([
            _first_of_run(torch.sort(k, dim=-1).values).sum(dim=-1)
            for k in key_levels], dim=-1)                  # (..., L+1)
        fits = occ <= cap
        lvl = torch.argmax(fits.to(torch.int32), dim=-1)   # finest that fits
        lvl = torch.where(fits.any(dim=-1), lvl,
                          torch.full_like(lvl, max_coarsen_levels))
        stacked = torch.stack(key_levels, dim=-1)          # (..., n, L+1)
        keys = torch.gather(stacked, -1,
                            lvl[..., None, None].expand(*lead, n, 1))[..., 0]

    order = torch.argsort(keys, dim=-1, stable=True)
    skeys = torch.gather(keys, -1, order)
    spts = torch.gather(points, -2, order[..., None].expand(*lead, n, 3))
    valid = skeys != _INVALID
    first = _first_of_run(skeys)
    gid = torch.cumsum(first.to(torch.int64), dim=-1) - 1   # voxel rank
    # padding and ranks past cap go to the overflow bucket cap
    gid = torch.where(valid & (gid < cap), gid, torch.full_like(gid, cap))

    rows = int(np.prod(lead))
    flat_gid = (gid.reshape(rows, n)
                + (cap + 1) * torch.arange(rows, device=points.device)[:, None])
    vf = valid.to(points.dtype)
    sums = torch.zeros((rows * (cap + 1), 3), dtype=points.dtype,
                       device=points.device)
    sums.index_add_(0, flat_gid.reshape(-1),
                    (spts * vf[..., None]).reshape(rows * n, 3))
    cnts = torch.zeros((rows * (cap + 1),), dtype=torch.float32,
                       device=points.device)
    cnts.index_add_(0, flat_gid.reshape(-1), vf.reshape(-1).to(torch.float32))
    sums = sums.reshape(*lead, cap + 1, 3)[..., :cap, :]
    cnts = cnts.reshape(*lead, cap + 1)[..., :cap]
    out_mask = cnts > 0
    out = sums / torch.clamp(cnts, min=1.0)[..., None]
    return out, out_mask


# ---------------------------------------------------------------------------
# numpy twins: the host mapper's ops and test oracles (roman_tpu/ops/voxel.py)
# ---------------------------------------------------------------------------

def voxel_set(points: np.ndarray, voxel_size: float) -> set:
    v = np.floor(np.asarray(points) / voxel_size).astype(np.int64)
    return set(map(tuple, v))


def voxel_iou_np(points1: np.ndarray, points2: np.ndarray, voxel_size: float,
                 iom_as_iou: bool = False) -> float:
    s1 = voxel_set(points1, voxel_size)
    s2 = voxel_set(points2, voxel_size)
    inter = len(s1 & s2)
    if iom_as_iou:
        denom = min(len(s1), len(s2))
    else:
        denom = len(s1) + len(s2) - inter
    return inter / denom if denom > 0 else 0.0


def voxel_downsample_np(points: np.ndarray, voxel_size: float) -> np.ndarray:
    pts = np.asarray(points, dtype=np.float64)
    if len(pts) == 0:
        return pts
    keys = np.floor(pts / voxel_size).astype(np.int64)
    _, inv, cnt = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((len(cnt), 3))
    np.add.at(sums, inv.reshape(-1), pts)
    return sums / cnt[:, None]
