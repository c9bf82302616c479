"""Spin-resolved J/K over the rank grid (multi-device UHF/ROHF).

Port of ``juliachem_jl_tpu/parallel/shard_jk.py``.  One pass over this
rank's Q-blocks of packed B computes the Coulomb vector of the total density
together with BOTH spin exchanges: each block goes through kernel K2 for the
alpha and then the beta factor while it is hot, and one ``all_reduce``
finishes all three reductions.  The open-shell analog of
``shard.packed_fock_step`` (the reference's GPUDF.jl has no open-shell
counterpart: its SCF is RHF-only).
"""

from __future__ import annotations

from .mesh import Mesh


def packed_jk_step(mesh: Mesh, builder, d, Cs_a, s_a, Cs_b, s_b):
    """(J, Ka, Kb) f64 on packed B (``make_packed_jk_step``) from factor-1
    spin densities D_s = sum_k s_k c_k c_k^T (s None for orbitals): Ka, Kb
    are K(Da), K(Db), and J is J(Da + Db) when d packs Da + Db."""
    blocks = builder.q_blocks(builder.B, max(Cs_a.shape[1], Cs_b.shape[1]))
    Ka = Kb = Jp = None
    for blk in blocks:
        ka, jp = builder.sweep([blk], d, Cs_a, s_a)
        kb, _ = builder.sweep([blk], None, Cs_b, s_b)
        Ka, Kb, Jp = ((ka, kb, jp) if Ka is None
                      else (Ka + ka, Kb + kb, Jp + jp))
    Ka, Kb, Jp = mesh.all_reduce_cat(Ka, Kb, Jp)
    return builder.scatter_j(Jp), Ka.double(), Kb.double()
