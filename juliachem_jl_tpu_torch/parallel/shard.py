"""Sharded density-fitted Fock builds: per-rank work, then collectives.

Port of ``juliachem_jl_tpu/parallel/shard.py``.  The JAX package runs each
of these as one ``shard_map`` over its mesh; here every rank of the process
group runs the body on its own device and the ``psum`` / ``all_gather``
become ``torch.distributed`` collectives (``Mesh``):

  reference                                  here
  ---------                                  ----
  aux partition over ranks/GPUs              this rank's Q rows of B
  (DynamicLoad.jl:160-203)
  per-rank W/K/J partials                    per-rank K2 sweep / products
  MPI.Allreduce!(fock)                       one all_reduce per build
  (DensityFitting.jl:68-71)
  MPI.Bcast! of C each iteration             every rank holds D and C

The packed steps run kernel K2 (``ScreenedDFFockBuilder.sweep``) on this
rank's Q-blocks; the dense q x k step is library products plus collectives,
as it is XLA products in the JAX package.
"""

from __future__ import annotations

import torch

from ..models import linalg
from ..utils.timings import JCTC, Timings
from .mesh import Mesh


def packed_fock_step(mesh: Mesh, builder, src: torch.Tensor, d, Cs, s):
    """G = J - K/2 on packed B (``make_packed_fock_step``): this rank's
    Q-blocks of ``src`` (its rows of B, or their f32 copy for the
    mixed-precision phase) swept through K2 (``builder.sweep``, the
    ``ScreenedDFFockBuilder`` machinery) for K_half = sum (W s)^T W and the
    packed Coulomb vector, then ONE all_reduce of (K_half, J_packed).  d is
    the packed density in the compute dtype, D = 2 sum_k s_k c_k c_k^T
    (s None for orbitals).  Returns the f64 G [nbf, nbf]."""
    blocks = builder.q_blocks(src, Cs.shape[1])
    K, Jp = builder.sweep(blocks, d, Cs, s)
    K, Jp = mesh.all_reduce_cat(K, Jp)
    return builder.scatter_j(Jp) - K.double()


def packed_fock_phases(mesh: Mesh, builder, d, Cs, s, iteration,
                       timings: Timings):
    """``make_packed_fock_phases``: the same G in two passes over B, J then
    K, each with its own all_reduce, wall-timed as J_time and K_time (the
    reference's per-phase telemetry, JCTiming.jl:15-105; used when
    ``profile_fock`` asks for it)."""
    dev = d.device
    with timings.timed(JCTC.J_time, iteration):
        blocks = builder.q_blocks(builder.B, 0)
        _, Jp = builder.sweep(blocks, d, Cs[:, :0], None)
        Jp, = mesh.all_reduce_cat(Jp)
        J = builder.scatter_j(Jp)
        _sync(dev)
    with timings.timed(JCTC.K_time, iteration):
        K, _ = builder.sweep(builder.q_blocks(builder.B, Cs.shape[1]), None,
                             Cs, s)
        K, = mesh.all_reduce_cat(K)
        _sync(dev)
    return J - K


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def df_fock_step(mesh: Mesh, B_blk: torch.Tensor, D: torch.Tensor,
                 Cocc: torch.Tensor, nbf: int) -> torch.Tensor:
    """Dense q x k G = J - K/2 (``make_df_fock_step``): this rank holds the
    block B[Q of its q index, :, columns of its k index] [A_l, nbf, ncol]
    of a [A_pad, nbf, nbf_pad] B (``shard_B``); D [nbf, nbf_pad] padded and
    Cocc [nbf, nocc] replicated.  V sums over "k", W's columns gather over
    "k", the partial G columns sum over "q" and gather over "k".  Returns
    G [nbf, nbf]."""
    ncol = B_blk.shape[2]
    c0 = mesh.k_index * ncol
    Dcols = D[:, c0:c0 + ncol]
    V = torch.einsum("qmn,mn->q", B_blk, Dcols)
    V, = mesh.all_reduce_cat(V, axis="k")            # full V_Q of this row
    Jcols = torch.einsum("qmn,q->mn", B_blk, V)      # [nbf, ncol]
    W = torch.einsum("qmn,mi->qin", B_blk, Cocc)     # [A_l, nocc, ncol]
    Wg = mesh.all_gather(W, dim=2, axis="k")         # [A_l, nocc, nbf_pad]
    Kcols = torch.einsum("qim,qin->mn", Wg[:, :, :nbf], W)
    Gcols, = mesh.all_reduce_cat(Jcols - Kcols, axis="q")
    return mesh.all_gather(Gcols, dim=1, axis="k")[:, :nbf]


def scf_step(mesh: Mesh, B_blk, H, X, D, Cocc, nbf_pad: int):
    """One SCF iteration over the rank grid (``make_scf_step``): the dense
    q x k Fock build, the Roothaan eigensolve and the energy.  Returns
    (F, D_new, Cocc_new, eps, E_elec)."""
    nbf, nocc = D.shape[0], Cocc.shape[1]
    D_pad = torch.nn.functional.pad(D, (0, nbf_pad - nbf))
    F = H + df_fock_step(mesh, B_blk, D_pad, Cocc, nbf)
    eps, C, D_new = linalg.roothaan_step(F, X, nocc)
    E_elec = 0.5 * torch.sum(D_new * (H + F))
    return F, D_new, C[:, :nocc], eps, E_elec


def shard_B(mesh: Mesh, B: torch.Tensor) -> torch.Tensor:
    """This rank's block of a [A_pad, nbf, nbf_pad] B (A_pad a multiple of
    nq, nbf_pad of nk): Q rows of its q index, columns of its k index, on
    its device (the JAX package's P("q", None, "k") placement)."""
    A_l = B.shape[0] // mesh.nq
    ncol = B.shape[2] // mesh.nk
    q, k = mesh.q_index, mesh.k_index
    return B[q * A_l:(q + 1) * A_l, :, k * ncol:(k + 1) * ncol].to(
        mesh.device).contiguous()
