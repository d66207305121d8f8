"""Device selection and float32 numerics for the port.

Exact f32 dots are a correctness requirement of the alignment engine: bf16
or TF32 rounding of distances and eigenvector entries shrinks solved
cliques (CLAUDE.md "Performance rules", README "f32 geometric cores"). So
TF32 is switched off for matmuls and cuDNN once, when the package is
imported.
"""

from __future__ import annotations

import torch

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
