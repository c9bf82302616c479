"""Quartet-sharded conventional (direct-SCF) Fock build over the ranks.

Port of ``juliachem_jl_tpu/ops/fock_sharded.py``.  The reference walks the
composite triangular shell-quartet index space in strided batches across MPI
ranks x threads (SCF.jl:683-744, Indicies.jl:5-7) and Allreduces the per-rank
skeleton Fock (SCF.jl:623).  Here the Schwarz-screened symmetry-unique
quartet batches of ``ScreenedDirectFock`` are split evenly over the ranks
(each class batch into world-size contiguous shares), every rank digests its
share with kernel K5 in list mode into its own J/K workspace, and one
``all_reduce`` of the workspaces per build replaces MPI.Allreduce.  Static
sharding, as the reference's default (Constants.jl:54): load balance comes
from splitting each class batch evenly, not from work stealing.
"""

from __future__ import annotations

import torch

from ..basis.structs import Basis
from ..parallel.mesh import Mesh, make_mesh
from ..utils.timings import JCTC, Timings
from .fock import DEFAULT_CUTOFF, ScreenedDirectFock, eri4c_jk


def share(n: int, world: int, rank: int) -> slice:
    """Rank ``rank``'s contiguous share of n items split ``world`` ways
    (sizes differ by at most one)."""
    q, r = divmod(n, world)
    lo = rank * q + min(rank, r)
    return slice(lo, lo + q + (rank < r))


class ShardedDirectFock(ScreenedDirectFock):
    """Multi-rank screened direct Fock (the §2.3 'rank-parallel
    conventional Fock' analog: quartet sharding over the ranks, direct mode:
    the integrals are recomputed every build, never cached)."""

    def __init__(self, basis: Basis, mesh: Mesh | None = None,
                 n_devices: int | None = None,
                 cutoff: float = DEFAULT_CUTOFF,
                 timings: Timings | None = None, device=None, schwarz=None):
        self.mesh = mesh if mesh is not None else make_mesh(n_devices,
                                                            device=device)
        super().__init__(basis, cutoff, incore=False, device=self.mesh.device,
                         schwarz=schwarz)
        m = self.mesh
        for g in self.groups:
            part = share(g.sel_bra.shape[0], m.world, m.rank)
            g.sel_bra, g.sel_ket = g.sel_bra[part], g.sel_ket[part]
            g.weight = g.weight[part]
        if timings is not None:
            timings.non_timing_data[JCTC.gpu_num_devices] = str(m.world)

    def jk_halves(self, D, iteration=None, timings: Timings | None = None):
        D = D.to(device=self.device, dtype=torch.float64).contiguous()
        JK = torch.zeros((2, self.nbf, self.nbf), dtype=torch.float64,
                         device=self.device)
        for g in self.groups:
            eri4c_jk(JK, g.bra, g.ket, g.sel_bra, g.sel_ket, g.weight, D)
        # one reduction per build (MPI.Allreduce analog)
        JK, = self.mesh.all_reduce_cat(JK)
        return JK[0] + JK[0].T, JK[1] + JK[1].T
