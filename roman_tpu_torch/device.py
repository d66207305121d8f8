"""Device selection, copies across the host boundary, and float32
numerics for the port.

Exact f32 dots are a correctness requirement of the alignment engine: bf16
or TF32 rounding of distances and eigenvector entries shrinks solved
cliques (CLAUDE.md "Performance rules", README "f32 geometric cores"). So
TF32 is switched off for matmuls and cuDNN once, when the package is
imported.

A copy between host memory and a card returns only when it is done, so
the host waits for the card's stream. ``to_device`` and ``to_host`` are
the port's copies across that boundary, and each counts its wait
(``tracing.count_sync``); a copy of nothing does not wait and is not
counted.
"""

from __future__ import annotations

import numpy as np
import torch

from roman_tpu_torch import tracing

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    None means ``cuda``. Asking for a CUDA device on a host without one
    raises: the port never carries on quietly on the CPU. Pass
    ``device="cpu"`` to run the plain PyTorch path.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def to_device(x, device) -> torch.Tensor:
    """torch.as_tensor(x, device=device) for a tensor or a numpy array,
    counting the host's wait where host memory goes to a card."""
    device = torch.device(device)
    if (isinstance(x, np.ndarray) or x.device.type == "cpu") and x.nbytes:
        tracing.count_sync(device)
    return torch.as_tensor(x, device=device)


def to_host(x: torch.Tensor) -> torch.Tensor:
    """x.cpu(), counting the host's wait where x is on a card."""
    if x.nbytes:
        tracing.count_sync(x.device)
    return x.cpu()
