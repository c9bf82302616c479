"""Electron-repulsion integrals, class-batched McMurchie-Davidson, in torch.

Port of ``juliachem_jl_tpu/ops/eri.py``: every (la,lb,lc,ld) class is one
tensor program over a batch of quartets, structured as two batched
contractions over the Hermite axis —

    (ab|cd)[n] = Eab[n] . M[n] . Ecd[n]^T,
    M[n][h,h'] = (-1)^{|h'|} R_{h+h'}(alpha, P-Q)

This plain torch version serves the setup phase (Schwarz diagonal, SAD
atomic ERIs); the 4-center hand kernel is later work (ROADMAP.md B10).
"""

from __future__ import annotations

import math

import torch

from ..basis.structs import Basis
from .boys import boys
from .class_tables import combine_tables
from .mcmurchie import hermite_expansion, pair_primitive_data, r_tensor
from .pairs import PairBlock

TWO_PI_POW_2_5 = 2.0 * math.pi**2.5


def as_f64(x, device) -> torch.Tensor:
    """A host array (or tensor) as a float64 tensor on ``device``."""
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def bra_hermite(la, lb, aexp, bexp, acoef, bcoef, A, B):
    """Hermite expansion of a pair batch: returns (Eab[N,K2,nab,nh], p[N,K2],
    P[N,K2,3]) with contraction coefficients and axial factors folded in."""
    prim = pair_primitive_data(aexp, bexp, acoef, bcoef, A, B)
    Eab = hermite_expansion(la, lb, prim)
    return Eab, prim["p"], prim["P"]


def eri_class(la, lb, lc, ld, aexp, bexp, acoef, bcoef, A, B,
              cexp, dexp, ccoef, dcoef, C, D) -> torch.Tensor:
    """Quartet-class body -> blocks [N, nca*ncb, ncc*ncd] (the plain form of
    ``_eri_kernel_body``)."""
    Lb = la + lb
    Lk = lc + ld
    L = Lb + Lk
    comb, sign = combine_tables(Lb, Lk)
    Eab, p, P = bra_hermite(la, lb, aexp, bexp, acoef, bcoef, A, B)
    Ecd, q, Q = bra_hermite(lc, ld, cexp, dexp, ccoef, dcoef, C, D)

    PQ = P[:, :, None, :] - Q[:, None, :, :]          # [N,K2b,K2k,3]
    psum = p[:, :, None] + q[:, None, :]
    alpha = p[:, :, None] * q[:, None, :] / psum
    Targ = alpha * torch.sum(PQ**2, dim=-1)
    pref = TWO_PI_POW_2_5 / (p[:, :, None] * q[:, None, :] * torch.sqrt(psum))
    F = boys(Targ, L) * pref[..., None]
    R = r_tensor(L, alpha, PQ, F)                     # [N,K2b,K2k,nherm(L)]

    dev = R.device
    M = R[..., torch.as_tensor(comb, dtype=torch.long, device=dev)] \
        * as_f64(sign, dev)[None, None, None, None, :]
    # contract ket: T1[n,kb,h,cd] = sum_{kk,h'} M * Ecd
    T1 = torch.einsum("nqkhg,nkcg->nqhc", M, Ecd)
    # contract bra: out[n,ab,cd] = sum_{kb,h} Eab * T1
    return torch.einsum("nqah,nqhc->nac", Eab, T1)


def eri_block(bra: PairBlock, ket: PairBlock, sel_bra, sel_ket, device,
              chunk: int = 1024) -> torch.Tensor:
    """ERI blocks for quartets (bra[sel_bra[i]], ket[sel_ket[i]]).

    Returns [len(sel), nca*ncb, ncc*ncd] on ``device``."""
    n = len(sel_bra)
    outs = []
    for s in range(0, n, chunk):
        ib, ik = sel_bra[s:s + chunk], sel_ket[s:s + chunk]
        outs.append(eri_class(
            bra.la, bra.lb, ket.la, ket.lb,
            *(as_f64(x[ib], device) for x in (bra.aexp, bra.bexp, bra.acoef,
                                              bra.bcoef, bra.A, bra.B)),
            *(as_f64(x[ik], device) for x in (ket.aexp, ket.bexp, ket.acoef,
                                              ket.bcoef, ket.A, ket.B))))
    return torch.cat(outs, dim=0)


def full_eri_tensor(basis: Basis, device) -> torch.Tensor:
    """Dense (mu nu | lam sig) tensor — for tiny systems (the SAD atoms).

    Computes only symmetry-unique quartets and scatters all 8 index images
    of every block at once."""
    import numpy as np

    from .pairs import unique_pair_blocks

    nbf = basis.nbf
    G = torch.zeros((nbf, nbf, nbf, nbf), dtype=torch.float64, device=device)
    blocks = unique_pair_blocks(basis)
    for bi, bra in enumerate(blocks):
        for bj in range(bi, len(blocks)):
            ket = blocks[bj]
            if bi == bj:
                sel_b, sel_k = np.triu_indices(bra.n)
            else:
                ii, kk = np.meshgrid(np.arange(bra.n), np.arange(ket.n), indexing="ij")
                sel_b, sel_k = ii.ravel(), kk.ravel()
            nca, ncb = bra.nbf_block
            ncc, ncd = ket.nbf_block
            v = eri_block(bra, ket, sel_b, sel_k, device).reshape(
                -1, nca, ncb, ncc, ncd)

            def idx(off, sel, nc, axis):
                shape = [-1, 1, 1, 1, 1]
                shape[axis] = nc
                i = off[sel][:, None] + np.arange(nc)[None, :]
                return torch.as_tensor(i, device=device).reshape(
                    [len(sel)] + shape[1:])

            a = idx(bra.off_a, sel_b, nca, 1)
            b = idx(bra.off_b, sel_b, ncb, 2)
            c = idx(ket.off_a, sel_k, ncc, 3)
            d = idx(ket.off_b, sel_k, ncd, 4)
            for i0, i1, i2, i3 in ((a, b, c, d), (b, a, c, d), (a, b, d, c),
                                   (b, a, d, c), (c, d, a, b), (d, c, a, b),
                                   (c, d, b, a), (d, c, b, a)):
                G.index_put_((i0, i1, i2, i3), v)
    return G
