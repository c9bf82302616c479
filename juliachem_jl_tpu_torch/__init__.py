"""juliachem_jl_tpu_torch — the PyTorch / CUDA port of juliachem_jl_tpu.

Closed-shell RHF, density-fitted and conventional (direct SCF), with
properties, through the same entry points as the JAX package (``initialize /
io.read_input / molecule.run / basis.run / models.rhf.energy /
models.properties.run / finalize``, or ``run_file`` / ``run_spec``).  Plain
tensor code is torch in float64 on the card unless the caller names the CPU
(``initialize("cpu")`` or ``device="cpu"``); the hot kernels are CUDA C++ for Hopper
(``csrc/``, built with nvcc at first use), each with a plain torch version
beside it that CPU tensors take.

This package never imports jax or juliachem_jl_tpu.
"""

from __future__ import annotations

import torch

from . import config
from . import io  # noqa: F401
from . import molecule  # noqa: F401
from . import basis  # noqa: F401
from . import models  # noqa: F401
from .driver import run_file, run_spec  # noqa: F401
from .utils import constants  # noqa: F401
from .utils.timings import Timings  # noqa: F401

__version__ = "0.1.0"


def initialize(device=None) -> torch.device:
    """Lifecycle entry (JuliaChem.initialize analog): set the default device
    (``"cuda"`` when none is given; raises RuntimeError without CUDA, the
    CPU runs only as ``initialize("cpu")``) and make float32 products true
    float32 (no TF32), as the JAX package's f32 phase is."""
    if device is None:
        device = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return config.set_default_device(device)


def finalize() -> None:
    """Lifecycle exit (JuliaChem.finalize analog): back to the card default."""
    config.reset_default_device()
