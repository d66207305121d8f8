"""Device meshes and the pair-axis layout (port of roman_tpu/parallel/mesh.py).

The reference is a single-process serial pipeline; its one parallel hot
loop is the all-pairs submap registration grid. Here, as in roman_tpu,
that grid is the unit of data parallelism: the submap features are small
(at most a few hundred objects of ~780 floats), so they are replicated on
every device, and the pair axis is split across the devices.

One host process drives every device of a mesh, as JAX's single
controller does: a ``Mesh`` is an ordered tuple of ``torch.device``s
under one axis name, and a caller passes it around as an object, with no
launcher and no process group. ``get_mesh(n, device=...)`` names one
device n times: n virtual shards on one device, the port's form of JAX's
``--xla_force_host_platform_device_count``. It is only made when asked
for by name.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from roman_tpu_torch import tracing
from roman_tpu_torch.device import resolve_device


def _canonical(device) -> torch.device:
    """torch.device(device), with a CUDA device's index filled in (a bare
    "cuda" is the current device), so that two names of one device
    compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices along the axis ``"pairs"``. Shard k of
    every split lives on devices[k]; a device may appear more than once
    (virtual shards)."""

    devices: Tuple[torch.device, ...]
    axis_name = "pairs"

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices",
                           tuple(_canonical(d) for d in self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh({self.axis_name}={self.size}: "
                + ", ".join(str(d) for d in self.devices) + ")")


def get_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A mesh over the visible CUDA devices, or virtual shards on one.

    With device unset: the first n_devices visible CUDA devices, or all
    of them; raises RuntimeError when there is no card or fewer cards
    than asked for. With device given ("cpu" or one CUDA device):
    n_devices (default 1) virtual shards on that device.
    """
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices must be at least 1, got {n_devices}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' for virtual "
                "shards on the CPU")
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if n > count:
            raise RuntimeError(
                f"asked for {n} CUDA devices, {count} visible; pass device= "
                "for virtual shards on one device")
        return Mesh(tuple(torch.device("cuda", k) for k in range(n)))
    dev = _canonical(resolve_device(device))
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"{dev} is not visible "
                           f"({torch.cuda.device_count()} CUDA devices)")
    return Mesh((dev,) * (1 if n_devices is None else n_devices))


def home_device(mesh: Optional[Mesh], device=None) -> torch.device:
    """The device an entry point works on: the mesh's first device, or
    resolve_device(device) without a mesh. Raises ValueError when both are
    given and name different devices."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and _canonical(resolve_device(device)) != mesh.devices[0]:
        raise ValueError(f"device {device} disagrees with the mesh's first "
                         f"device {mesh.devices[0]}")
    return mesh.devices[0]


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pair_slices(n_rows: int, n_shards: int) -> List[slice]:
    """The rows of each shard: contiguous pieces of ceil(n_rows / n_shards)
    rows, the last ones short or empty, no pad rows (the layout of JAX's
    padded P(axis) sharding, minus the pads)."""
    step = -(-n_rows // n_shards)
    return [slice(min(k * step, n_rows), min((k + 1) * step, n_rows))
            for k in range(n_shards)]


def _tree_map(fn, tree):
    """fn applied to every tensor and numpy array of a tree of tuples,
    lists, dicts and dataclasses; other leaves pass through."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def shard_pairs(tree, mesh: Mesh) -> list:
    """Split the leading (pair) axis of every tensor of `tree` across the
    mesh: returns one tree a shard, shard k holding the rows
    pair_slices(P, n)[k] on mesh.devices[k]."""
    sizes = set()
    _tree_map(lambda x: sizes.add(x.shape[0]), tree)
    if len(sizes) > 1:
        raise ValueError(f"the tree's leading axes differ: {sorted(sizes)}")
    P = sizes.pop() if sizes else 0
    return [_tree_map(lambda x, s=s, d=d: torch.as_tensor(x[s], device=d), tree)
            for s, d in zip(pair_slices(P, mesh.size), mesh.devices)]


def replicated(tree, mesh: Mesh) -> list:
    """One copy of `tree` a shard, on that shard's device (virtual shards
    on one device share one copy)."""
    copies = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = _tree_map(lambda x, d=d: _copy_to(x, d), tree)
    return [copies[d] for d in mesh.devices]


def _copy_to(x, device: torch.device) -> torch.Tensor:
    """torch.as_tensor(x, device=device), counting the host's wait where a
    host array goes to a card (a pageable copy returns when it is done)."""
    if (isinstance(x, np.ndarray) or x.device.type == "cpu") and x.nbytes:
        tracing.count_sync(device)
    return torch.as_tensor(x, device=device)
