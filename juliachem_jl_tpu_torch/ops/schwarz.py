"""Cauchy-Schwarz screening bounds.

Q_ab = sqrt(max |(ab|ab)|) per shell pair; |(ab|cd)| <= Q_ab Q_cd.
Port of ``juliachem_jl_tpu/ops/schwarz.py``; feeds the DF screening
criterion of SchwarzScreening.jl and the conventional quartet screening.
The diagonal quartets go through kernel K4 on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..basis.structs import Basis
from .eri import eri_block
from .pairs import PairBlock, unique_pair_blocks


def pair_schwarz(block: PairBlock, device) -> torch.Tensor:
    """Q values for each pair in a PairBlock: sqrt(max |(ab|ab)|)."""
    idx = np.arange(block.n)
    vals = eri_block(block, block, idx, idx, device)  # [N, nab, nab] diagonal quartets
    return torch.sqrt(vals.abs().reshape(block.n, -1).amax(dim=1))


def shell_pair_bounds(basis: Basis, device) -> np.ndarray:
    """Symmetric (nshell, nshell) matrix of Schwarz Q values (host)."""
    nsh = basis.nshell
    Q = np.zeros((nsh, nsh))
    for blk in unique_pair_blocks(basis):
        q = pair_schwarz(blk, device).cpu().numpy()
        Q[blk.ish, blk.jsh] = q
        Q[blk.jsh, blk.ish] = q
    return Q


def df_pair_mask(q: torch.Tensor, sigma: float, metric_max: float) -> torch.Tensor:
    """Keep shell pair ab when (ab|ab) >= sigma^2 / max_P (P|P) (the
    expression of ``juliachem_jl_tpu/ops/native.py::df_pair_mask``)."""
    return q * q >= sigma**2 / metric_max


def staircase_limits(qb: np.ndarray, qk_desc: np.ndarray,
                     cutoff: float) -> np.ndarray:
    """For each bra value qb[r], how many of the descending-sorted ket
    values survive qk >= cutoff / qb[r] (none when qb[r] <= 0)."""
    with np.errstate(divide="ignore"):
        thresh = np.where(qb > 0.0, cutoff / np.where(qb > 0.0, qb, 1.0),
                          np.inf)
    return np.searchsorted(-qk_desc, -thresh, side="right")


def screened_quartets(qb: np.ndarray, qk: np.ndarray, cutoff: float,
                      same_block: bool) -> tuple[np.ndarray, np.ndarray]:
    """(rows, cols) of the quartets with qk[c] >= cutoff / qb[r], r <= c
    when same_block, in row-major order: the quartet set of the JAX
    package's C++ emitter (``ops/native.py::screened_quartets``).  Per bra
    row, a searchsorted over the descending-sorted ket values; memory is
    O(survivors), never O(n_bra x n_ket)."""
    qb = np.asarray(qb, dtype=np.float64)
    qk = np.asarray(qk, dtype=np.float64)
    order = np.argsort(-qk, kind="stable")
    lim = staircase_limits(qb, qk[order], cutoff)
    r = np.repeat(np.arange(len(qb), dtype=np.int64), lim)
    start = np.cumsum(lim) - lim
    c = order[np.arange(len(r), dtype=np.int64) - np.repeat(start, lim)]
    if same_block:
        keep = c >= r
        r, c = r[keep], c[keep]
    srt = np.lexsort((c, r))
    return r[srt], c[srt].astype(np.int64)
