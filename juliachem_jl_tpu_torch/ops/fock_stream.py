"""Streaming conventional Fock build with on-device quartet enumeration.

Port of ``juliachem_jl_tpu/ops/fock_stream.py``.  Pairs of each class are
sorted by Schwarz value, descending; the surviving quartets
{(r, c): q_b[r] * q_k[c] >= cutoff} of a (bra class, ket class) block pair
then form a staircase — for bra pair r the survivors are the prefix
c < lim[r] — so one [n_bra] cumulative count array ``cum`` describes them.
Kernel K5 in staircase mode (csrc/eri4c.cuh) decodes each flat index
t -> (r, c) on the card (binary search in cum), computes the ERI block and
digests it into J/K: host and device memory stay O(pairs).  Its plain
version decodes with ``torch.searchsorted``.  Same quartet set and weights
as ``ops/fock.py``'s batches.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import config
from ..basis.structs import Basis
from ..models.scf import FockBuilder
from ..utils.timings import Timings
from . import kernels
from .eri import PairTable, eri4c_plain, pair_table, plain_chunk
from .fock import DEFAULT_CUTOFF, digest_plain, launch_eri4c_jk, schwarz_blocks
from .schwarz import staircase_limits


def staircase(qb: np.ndarray, qk: np.ndarray, cutoff: float,
              same_block: bool) -> np.ndarray:
    """lim[r] for descending-sorted bra and ket values; within one block
    the quartets (r, c) with c <= r."""
    lim = staircase_limits(qb, qk, cutoff)
    if same_block:
        lim = np.minimum(lim, np.arange(1, len(qb) + 1))
    return lim


def count_screened_quartets(basis: Basis, cutoff: float = DEFAULT_CUTOFF,
                            pair_cutoff_scale: float = 1.0e-4,
                            device=None, schwarz=None) -> int:
    """Exact surviving-quartet count via the staircase (host, O(pairs log
    pairs) after the Schwarz diagonal) — the builder-selection estimate of
    models/rhf.py.  schwarz: the result of ``schwarz_blocks`` for these
    arguments, when the caller has it."""
    device = config.resolve_device(device)
    schwarz = schwarz or schwarz_blocks(basis, cutoff, pair_cutoff_scale,
                                        device)
    qs = [np.sort(q)[::-1] for q in schwarz[3]]
    return sum(int(staircase(qb, qs[j], cutoff, i == j).sum())
               for i, qb in enumerate(qs) for j in range(i, len(qs)))


def decode_staircase(cum: torch.Tensor, t: torch.Tensor,
                     bra: PairTable, ket: PairTable, same_block: bool):
    """(r, c, weight) of flat quartet indices t (plain form of K5's
    staircase decode)."""
    r = torch.searchsorted(cum, t, right=True)
    base = torch.where(r > 0, cum[(r - 1).clamp(min=0)],
                       torch.zeros_like(r))
    c = t - base

    def diag(tab, i):
        return torch.where(tab.meta[i, 4] != 0, 0.5, 1.0).to(torch.float64)

    w = diag(bra, r) * diag(ket, c)
    if same_block:
        w = torch.where(r == c, 0.5 * w, w)
    return r, c, w


def eri4c_jk_staircase_plain(JK, bra: PairTable, ket: PairTable,
                             cum: torch.Tensor, n: int, same_block: bool,
                             D) -> None:
    """Plain torch version of K5 in staircase mode (same arguments)."""
    csize = plain_chunk(bra, ket)
    for t0 in range(0, n, csize):
        t = torch.arange(t0, min(t0 + csize, n), dtype=torch.int64,
                         device=cum.device)
        r, c, w = decode_staircase(cum, t, bra, ket, same_block)
        digest_plain(JK, eri4c_plain(bra, ket, r, c), w, D, bra, ket, r, c)


def eri4c_jk_staircase(JK, bra: PairTable, ket: PairTable, cum: torch.Tensor,
                       n: int, same_block: bool, D) -> None:
    """Kernel K5, staircase mode: the first n quartets described by cum
    (int64 [n_bra], cumulative counts), decoded, computed and digested into
    JK [2, nbf, nbf] (J, K) against D."""
    if bra.pair.is_cuda:
        launch_eri4c_jk(JK, D, bra, ket, n, cum=cum, same_block=same_block)
    else:
        eri4c_jk_staircase_plain(JK, bra, ket, cum, n, same_block, D)


@dataclass
class _SortedBlock:
    table: PairTable
    q: np.ndarray        # [n] Schwarz values, descending (host)


@dataclass
class _ClassPair:
    bi: int
    ki: int
    same: bool
    N: int               # surviving quartets
    lim: np.ndarray      # [n_bra] host staircase
    cum: torch.Tensor    # [n_bra] int64 cumulative counts on the device


class StreamingDirectFock(FockBuilder):
    """Schwarz-staircase, device-enumerated direct Fock (the conventional
    scale mode past ~3e7 quartets; reference composite-index walk analog).
    schwarz: as for ``count_screened_quartets``."""

    def __init__(self, basis: Basis, cutoff: float = DEFAULT_CUTOFF,
                 pair_cutoff_scale: float = 1.0e-4, device=None,
                 schwarz=None):
        device = config.resolve_device(device)
        self.nbf = basis.nbf
        self.device = device
        self.blocks: list[_SortedBlock] = []
        schwarz = schwarz or schwarz_blocks(basis, cutoff, pair_cutoff_scale,
                                            device)
        for b, q in zip(*schwarz[2:]):
            order = np.argsort(-q, kind="stable")
            self.blocks.append(_SortedBlock(pair_table(b.select(order), device),
                                            q[order]))
        self.pairs: list[_ClassPair] = []
        for i, bb in enumerate(self.blocks):
            for j in range(i, len(self.blocks)):
                lim = staircase(bb.q, self.blocks[j].q, cutoff, i == j)
                N = int(lim.sum())
                if N:
                    self.pairs.append(_ClassPair(
                        bi=i, ki=j, same=i == j, N=N, lim=lim,
                        cum=torch.as_tensor(np.cumsum(lim), dtype=torch.int64,
                                            device=device)))
        self.n_quartets = sum(cp.N for cp in self.pairs)

    def jk_halves(self, D, iteration=None, timings: Timings | None = None):
        D = D.to(device=self.device, dtype=torch.float64).contiguous()
        JK = torch.zeros((2, self.nbf, self.nbf), dtype=torch.float64,
                         device=self.device)
        for cp in self.pairs:
            eri4c_jk_staircase(JK, self.blocks[cp.bi].table,
                               self.blocks[cp.ki].table, cp.cum, cp.N,
                               cp.same, D)
        return JK[0] + JK[0].T, JK[1] + JK[1].T

    def two_electron_fock(self, D, iteration, timings: Timings, C_occ=None,
                          precision: str = "f64"):
        J, K = self.jk_halves(D, iteration, timings)
        return J - 0.5 * K

    def finalize(self):
        self.blocks = []
        self.pairs = []
