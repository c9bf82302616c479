"""Cauchy-Schwarz screening bounds.

Q_ab = sqrt(max |(ab|ab)|) per shell pair; |(ab|cd)| <= Q_ab Q_cd.
Port of ``juliachem_jl_tpu/ops/schwarz.py``; feeds the DF screening
criterion of SchwarzScreening.jl.
"""

from __future__ import annotations

import numpy as np
import torch

from .eri import eri_block
from .pairs import PairBlock


def pair_schwarz(block: PairBlock, device) -> torch.Tensor:
    """Q values for each pair in a PairBlock: sqrt(max |(ab|ab)|)."""
    idx = np.arange(block.n)
    vals = eri_block(block, block, idx, idx, device)  # [N, nab, nab] diagonal quartets
    return torch.sqrt(vals.abs().reshape(block.n, -1).amax(dim=1))


def df_pair_mask(q: torch.Tensor, sigma: float, metric_max: float) -> torch.Tensor:
    """Keep shell pair ab when (ab|ab) >= sigma^2 / max_P (P|P) (the
    expression of ``juliachem_jl_tpu/ops/native.py::df_pair_mask``)."""
    return q * q >= sigma**2 / metric_max
