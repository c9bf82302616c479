"""Spin-resolved J/K on the packed screened-DF path (UHF/ROHF at scale).

Port of ``juliachem_jl_tpu/models/df_screened_jk.py``.  The closed-shell
ScreenedDFFockBuilder fuses J - K/2 into one pass over the packed Q-blocks of
B; open-shell SCF needs (J(Da+Db), K(Da), K(Db)).  This builder makes one
pass (``ScreenedDFFockBuilder.sweep_factors``, K2 for each exchange
factor): each block serves J of the total density, K(Da) and K(Db) while
it is on the card, so a host-streamed B crosses to the card once a build
(the JAX package makes two passes, ``_k_pass``).  The blocks are sized for
the larger factor.

Factor conventions: uhf.py passes factor-1 spin densities (Da = Ca Ca^T);
the sweep builds K(C C^T) from explicit orbitals, which is K(Da).  Without
orbitals (the SAD first iteration) the factor is ``signed_factor(2 D)``,
whose sqrt(|w| / 2) scaling then gives K(D) for a factor-1 D.
"""

from __future__ import annotations

import torch

from ..utils.timings import JCTC, Timings
from .df import signed_factor
from .df_screened import ScreenedDFFockBuilder, _sync


class ScreenedDFJKBuilder(ScreenedDFFockBuilder):
    """ScreenedDFFockBuilder plus the spin-resolved two_electron_jk."""

    @staticmethod
    def _spin_factor(D, C_occ):
        if C_occ is not None and C_occ.shape[1] > 0:
            return C_occ.contiguous(), None
        Cs, s = signed_factor(2.0 * D)
        return Cs.contiguous(), s

    def two_electron_jk(self, Da, Db, iteration, timings: Timings,
                        Ca=None, Cb=None):
        d = torch.cat([(Da + Db).reshape(-1)[self._pq_flat], Da.new_zeros(1)])
        Cs_a, s_a = self._spin_factor(Da, Ca)
        Cs_b, s_b = self._spin_factor(Db, Cb)
        blocks = self.blocks(torch.float64,
                             max(Cs_a.shape[1], Cs_b.shape[1]))
        with timings.timed(JCTC.K_time, iteration):
            (Ka, Kb), Jp = self.sweep_factors(blocks, d, [(Cs_a, s_a),
                                                          (Cs_b, s_b)])
            _sync(Da.device)
        with timings.timed(JCTC.J_time, iteration):
            J = self.scatter_j(Jp)
        return J, Ka, Kb
