"""Explicit device selection.

Replaces ``longphase_s_tpu/ops/vote_scan.py:208 ensure_backend``, which
switched JAX to the CPU when the accelerator failed to come up. Here the
caller names the device and gets it or an error: a CUDA request on a
machine without a usable CUDA device raises.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``"cpu"``, ``"cuda"`` or ``"cuda:N"`` -> a concrete ``torch.device``.

    Raises RuntimeError for a CUDA device that is not available and
    ValueError for any other device type."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: use 'cpu' or 'cuda'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is false")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"device {dev} requested but only "
                           f"{torch.cuda.device_count()} CUDA device(s) exist")
    return torch.device("cuda", index)
