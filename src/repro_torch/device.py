"""Device resolution for the port's entry points.

Every entry point takes ``device=None`` and runs on the CUDA card unless
the caller names another device. Without a card, ``None`` and ``"cuda"``
raise instead of carrying on silently on the CPU; tests pass
``device="cpu"``.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device, as ``cuda:<index>`` so that
    devices compare equal; raises when a CUDA device is asked for and
    ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev if dev.index is not None else torch.device(
        "cuda", torch.cuda.current_device())
