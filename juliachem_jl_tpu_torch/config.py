"""Numerical configuration and the default device.

Everything numerical is float64, as in the JAX package (chemistry needs
~1e-8 Eh); torch's default dtype is float32, so every tensor the package
creates names its dtype.  The default device is the card (``cuda``); the CPU
runs only when the caller names it, through ``initialize("cpu")`` or a
``device="cpu"`` argument.
"""

from __future__ import annotations

import torch

DTYPE = torch.float64

DEFAULT_DEVICE = torch.device("cuda")
_default_device = DEFAULT_DEVICE


def set_default_device(device) -> torch.device:
    global _default_device
    _default_device = resolve_device(device)
    return _default_device


def reset_default_device() -> None:
    """Back to the card default (checked when next used, not here)."""
    global _default_device
    _default_device = DEFAULT_DEVICE


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, or the default one when None.  A CUDA
    device without CUDA is an error, never a quiet CPU run."""
    device = _default_device if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device
