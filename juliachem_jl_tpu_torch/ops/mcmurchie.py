"""McMurchie-Davidson recurrences, batched for class-shaped inputs.

Port of ``juliachem_jl_tpu/ops/mcmurchie.py`` to torch: the recurrences run
at Python level over static angular momenta and produce tensor programs over
batched primitive data, on whatever device the inputs live on.

Conventions (Helgaker/Jorgensen/Olsen ch. 9):
  E_t^{ij}  — Hermite expansion coefficients of a 1D Gaussian product,
              including the exp(-mu AB^2) prefactor.
  R^0_{tuv} — Hermite Coulomb integrals built from Boys F_n by downward
              recursion.
"""

from __future__ import annotations

import torch

from .boys import boys  # noqa: F401  (re-exported, as in the JAX package)
from .class_tables import herm_list, pair_tables


def pair_primitive_data(aexp, bexp, acoef, bcoef, A, B):
    """Flatten a batch of contracted shell pairs into primitive-pair arrays.

    aexp: [N, Ka], bexp: [N, Kb], coefficients likewise, A/B: [N, 3].
    Returns dict with all [N, K2] / [N, K2, 3] primitive-pair quantities
    (K2 = Ka*Kb).  Padded primitives carry coefficient 0 (exponent 1) so they
    contribute exactly zero.
    """
    N, Ka = aexp.shape
    Kb = bexp.shape[1]
    a = torch.repeat_interleave(aexp, Kb, dim=1)      # [N, K2]
    b = bexp.repeat(1, Ka)
    cc = (acoef[:, :, None] * bcoef[:, None, :]).reshape(N, Ka * Kb)
    p = a + b
    mu = a * b / p
    P = (a[:, :, None] * A[:, None, :] + b[:, :, None] * B[:, None, :]) / p[:, :, None]
    AB = A - B                                        # [N, 3]
    return {
        "a": a, "b": b, "p": p, "mu": mu, "cc": cc,
        "P": P, "PA": P - A[:, None, :], "PB": P - B[:, None, :],
        "AB": AB,
    }


def e_dense(la: int, lb: int, prim) -> torch.Tensor:
    """Dense per-dimension E-coefficient table.

    Returns E[N, K2, 3, la+1, lb+1, la+lb+1] with zeros where t > i+j.
    """
    p, mu = prim["p"], prim["mu"]
    PA, PB = prim["PA"], prim["PB"]                   # [N, K2, 3]
    AB = prim["AB"]                                   # [N, 3]
    oo2p = (0.5 / p)[:, :, None]                      # [N, K2, 1]
    zero = torch.zeros_like(PA)

    e = {(0, 0, 0): torch.exp(-mu[:, :, None] * AB[:, None, :] ** 2)}

    def get(i, j, t):
        if t < 0 or t > i + j:
            return zero
        return e[(i, j, t)]

    for i in range(1, la + 1):
        for t in range(i + 1):
            e[(i, 0, t)] = (
                oo2p * get(i - 1, 0, t - 1)
                + PA * get(i - 1, 0, t)
                + (t + 1) * get(i - 1, 0, t + 1)
            )
    for j in range(1, lb + 1):
        for i in range(la + 1):
            for t in range(i + j + 1):
                e[(i, j, t)] = (
                    oo2p * get(i, j - 1, t - 1)
                    + PB * get(i, j - 1, t)
                    + (t + 1) * get(i, j - 1, t + 1)
                )

    L = la + lb
    rows = []
    for i in range(la + 1):
        cols = []
        for j in range(lb + 1):
            cols.append(torch.stack([get(i, j, t) for t in range(L + 1)], dim=-1))
        rows.append(torch.stack(cols, dim=-2))
    return torch.stack(rows, dim=-3)                  # [N,K2,3,la+1,lb+1,L+1]


def hermite_expansion(la: int, lb: int, prim, fold_coefs: bool = True) -> torch.Tensor:
    """Bra/ket Hermite expansion matrix Eab[N, K2, nca*ncb, nherm(la+lb)].

    Axial normalization factors and (optionally) the primitive-pair
    contraction coefficients are folded in, so downstream contraction is a
    pure matmul over the Hermite axis.
    """
    tab = pair_tables(la, lb)
    E = e_dense(la, lb, prim)
    dev = E.device

    def ix(name, shape):
        return torch.as_tensor(tab[name], device=dev).reshape(shape)

    Ex, Ey, Ez = E[:, :, 0], E[:, :, 1], E[:, :, 2]
    nca, ncb, nh = tab["nca"], tab["ncb"], tab["nh"]
    cshape, hshape = (nca, ncb, 1), (1, 1, nh)
    Eab = (
        Ex[:, :, ix("ix_a", cshape), ix("ix_b", cshape), ix("t", hshape)]
        * Ey[:, :, ix("iy_a", cshape), ix("iy_b", cshape), ix("u", hshape)]
        * Ez[:, :, ix("iz_a", cshape), ix("iz_b", cshape), ix("v", hshape)]
    )                                                  # [N,K2,nca,ncb,nh]
    N, K2 = Eab.shape[:2]
    Eab = Eab.reshape(N, K2, nca * ncb, nh)
    Eab = Eab * torch.as_tensor(tab["axial"], dtype=Eab.dtype,
                                device=dev)[None, None, :, None]
    if fold_coefs:
        Eab = Eab * prim["cc"][:, :, None, None]
    return Eab


def r_tensor(L: int, alpha, X, F) -> torch.Tensor:
    """Hermite Coulomb integrals R^0_{tuv} stacked in herm_list(L) order.

    alpha: [...], X: [..., 3] (the P-Q separation), F: [..., L+1] Boys values
    (any linear prefactor may be pre-multiplied into F).
    Returns [..., nherm(L)].
    """
    Xd = [X[..., 0], X[..., 1], X[..., 2]]
    m2a = -2.0 * alpha
    pows = [torch.ones_like(alpha)]
    for n in range(1, L + 1):
        pows.append(pows[-1] * m2a)

    memo = {}

    def R(n, t, u, v):
        if t < 0 or u < 0 or v < 0:
            return None
        key = (n, t, u, v)
        if key in memo:
            return memo[key]
        if t == u == v == 0:
            val = pows[n] * F[..., n]
        elif t > 0:
            lo = R(n + 1, t - 2, u, v)
            hi = R(n + 1, t - 1, u, v)
            val = Xd[0] * hi if lo is None else (t - 1) * lo + Xd[0] * hi
        elif u > 0:
            lo = R(n + 1, t, u - 2, v)
            hi = R(n + 1, t, u - 1, v)
            val = Xd[1] * hi if lo is None else (u - 1) * lo + Xd[1] * hi
        else:
            lo = R(n + 1, t, u, v - 2)
            hi = R(n + 1, t, u, v - 1)
            val = Xd[2] * hi if lo is None else (v - 1) * lo + Xd[2] * hi
        memo[key] = val
        return val

    return torch.stack([R(0, t, u, v) for (t, u, v) in herm_list(L)], dim=-1)


__all__ = ["pair_primitive_data", "e_dense", "hermite_expansion", "r_tensor", "boys"]
