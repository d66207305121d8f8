"""Saving and restoring the perception nets' weights: the counterpart of
roman_tpu/perception/checkpoints.py (orbax there).

The reference loads torch .pt weights on every run (fastsam_wrapper.py:
90-188). Here a converted state dict is saved once with ``torch.save``
and restored with ``torch.load(weights_only=True)``, so the conversion
runs once and loading never unpickles code.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import torch


def save_params(state_dict: Dict[str, torch.Tensor], path: str):
    path = os.path.abspath(os.path.expanduser(path))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def load_params(path: str, like: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """The saved state dict; with `like`, its keys and shapes must match."""
    sd = torch.load(os.path.abspath(os.path.expanduser(path)), map_location="cpu",
                    weights_only=True)
    if like is not None:
        bad = {k for k in set(sd) | set(like)
               if k not in sd or k not in like or sd[k].shape != like[k].shape}
        if bad:
            raise ValueError(f"checkpoint {path} does not match: {sorted(bad)[:5]}")
    return sd


def load_or_convert(ckpt_path: str, torch_path: str, convert_fn: Callable,
                    like: Optional[Dict[str, torch.Tensor]] = None):
    """Restore the checkpoint if present; otherwise convert the upstream
    weights with convert_fn(torch_path) and save the result for next time."""
    if os.path.exists(os.path.expanduser(ckpt_path)):
        return load_params(ckpt_path, like)
    params = convert_fn(torch_path)
    save_params(params, ckpt_path)
    return params
