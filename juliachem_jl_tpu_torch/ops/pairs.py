"""Shell-pair enumeration into class-shaped batch arrays.

The TPU analog of the reference's precomputed ShellPair list
(deps/src/jeri-core.hpp:77-89): for each angular-momentum class pair we build
padded numpy batch arrays that feed the jitted integral kernels with fixed
shapes.  Schwarz masking later prunes these lists (SchwarzScreening.jl analog)
before they reach the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..basis.structs import Basis, ncart


@dataclass
class PairBlock:
    """A batch of same-class shell pairs."""

    la: int
    lb: int
    ish: np.ndarray    # [N] global shell index of the first shell
    jsh: np.ndarray    # [N]
    aexp: np.ndarray   # [N, Ka]
    bexp: np.ndarray   # [N, Kb]
    acoef: np.ndarray  # [N, Ka]
    bcoef: np.ndarray  # [N, Kb]
    A: np.ndarray      # [N, 3]
    B: np.ndarray      # [N, 3]
    off_a: np.ndarray  # [N] basis-function offsets
    off_b: np.ndarray

    @property
    def n(self) -> int:
        return len(self.ish)

    @property
    def nbf_block(self) -> tuple[int, int]:
        return ncart(self.la), ncart(self.lb)

    def select(self, keep: np.ndarray) -> "PairBlock":
        """Subset (e.g. after Schwarz screening)."""
        return PairBlock(
            la=self.la, lb=self.lb,
            ish=self.ish[keep], jsh=self.jsh[keep],
            aexp=self.aexp[keep], bexp=self.bexp[keep],
            acoef=self.acoef[keep], bcoef=self.bcoef[keep],
            A=self.A[keep], B=self.B[keep],
            off_a=self.off_a[keep], off_b=self.off_b[keep],
        )


def _make_block(basis: Basis, la: int, lb: int, rows: np.ndarray, cols: np.ndarray) -> PairBlock:
    """rows/cols: indices *within* the (la)/(lb) ShellClass arrays."""
    ca, cb = basis.classes[la], basis.classes[lb]
    return PairBlock(
        la=la, lb=lb,
        ish=ca.shell_idx[rows], jsh=cb.shell_idx[cols],
        aexp=ca.exps[rows], bexp=cb.exps[cols],
        acoef=ca.coefs[rows], bcoef=cb.coefs[cols],
        A=ca.centers[rows], B=cb.centers[cols],
        off_a=ca.offsets[rows], off_b=cb.offsets[cols],
    )


def unique_pair_blocks(basis: Basis) -> list[PairBlock]:
    """Each unordered shell pair exactly once (la <= lb class order;
    triangular within a class).  Analog of the reference's lower-triangular
    shell-pair list (jeri-core.hpp:77-89)."""
    blocks = []
    ls = sorted(basis.classes)
    for ia, la in enumerate(ls):
        for lb in ls[ia:]:
            na = basis.classes[la].nshell
            nb = basis.classes[lb].nshell
            if la == lb:
                rows, cols = np.triu_indices(na)
            else:
                rows, cols = np.meshgrid(np.arange(na), np.arange(nb), indexing="ij")
                rows, cols = rows.ravel(), cols.ravel()
            blocks.append(_make_block(basis, la, lb, rows, cols))
    return blocks


def block_scatter_indices(block: PairBlock):
    """Index arrays [N, nca, ncb] mapping a computed block into (nbf, nbf)."""
    nca, ncb = block.nbf_block
    ia = block.off_a[:, None, None] + np.arange(nca)[None, :, None]
    ib = block.off_b[:, None, None] + np.arange(ncb)[None, None, :]
    ia = np.broadcast_to(ia, (block.n, nca, ncb))
    ib = np.broadcast_to(ib, (block.n, nca, ncb))
    return ia, ib
