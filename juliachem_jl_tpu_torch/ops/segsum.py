"""J/K accumulation of the conventional Fock builders (plain version).

Port of ``juliachem_jl_tpu/ops/segsum.py``.  The JAX package reduces the
digestion's value streams through a two-level gather-sum plan precomputed on
the host (``GatherPlan``, ``_reduce_into``) because XLA's scatter-add on the
TPU serialises conflicting updates.  The port needs no plan: on the card the
same sums are the f64 ``atomicAdd`` epilogue of kernels K5 and K6
(csrc/eri4c.cuh), and the plain versions of those kernels add their value
streams here, with ``index_add_``.
"""

from __future__ import annotations

import torch


def reduce_into(acc: torch.Tensor, targets: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """acc (flat) += vals summed by target index; returns acc."""
    return acc.index_add_(0, targets.reshape(-1), vals.reshape(-1))
