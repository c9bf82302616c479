"""Numerical configuration and the default device.

Everything numerical is float64, as in the JAX package (chemistry needs
~1e-8 Eh); torch's default dtype is float32, so every tensor the package
creates names its dtype.  The default device is set by ``initialize`` and
can be overridden per call.
"""

from __future__ import annotations

import torch

DTYPE = torch.float64

_default_device = torch.device("cpu")


def set_default_device(device) -> torch.device:
    global _default_device
    _default_device = resolve_device(device)
    return _default_device


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, or the default one when None.  A CUDA
    device without CUDA is an error, never a quiet CPU run."""
    device = _default_device if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device
