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

from functools import lru_cache

import numpy as np
import torch

from .boys import boys  # noqa: F401  (re-exported, as in the JAX package)
from .class_tables import herm_index, herm_list, pair_tables


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

    The recursions E^{i,0}_t = E^{i-1,0}_{t-1} / 2p + PA E^{i-1,0}_t + (t+1)
    E^{i-1,0}_{t+1} (then the same in j with PB) step over i, then j, with
    every t (and, for j, every i) at once: the same operations as the JAX
    package's entry-by-entry recursion, in a few launches a step.
    """
    p, mu = prim["p"], prim["mu"]
    PA, PB = prim["PA"], prim["PB"]                   # [N, K2, 3]
    AB = prim["AB"]                                   # [N, 3]
    T = la + lb + 1
    tco = torch.arange(1, T + 1, dtype=p.dtype, device=p.device)

    def step(E, P, oo2p):
        # E [..., T] -> the next i (or j), every t at once (zero outside)
        pad = torch.zeros_like(E[..., :1])
        down = torch.cat([pad, E[..., :-1]], dim=-1)          # E_{t-1}
        up = torch.cat([E[..., 1:], pad], dim=-1)             # E_{t+1}
        return oo2p * down + P * E + tco * up

    e00 = torch.exp(-mu[:, :, None] * AB[:, None, :] ** 2)   # [N, K2, 3]
    E = torch.zeros(e00.shape + (T,), dtype=e00.dtype, device=e00.device)
    E[..., 0] = e00
    oo2p = (0.5 / p)[:, :, None, None]                # [N, K2, 1, 1]
    rows = [E]
    for _ in range(la):
        rows.append(step(rows[-1], PA[..., None], oo2p))
    cols = [torch.stack(rows, dim=-2)]                # [N, K2, 3, la+1, T]
    for _ in range(lb):
        cols.append(step(cols[-1], PB[..., None, None], oo2p[..., None]))
    return torch.stack(cols, dim=-2)                  # [N,K2,3,la+1,lb+1,T]


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


@lru_cache(maxsize=None)
def _r_layers(L: int, device: torch.device):
    """Per recursion level n = L-1 .. 0, the gather maps of ``r_tensor``'s
    layer over herm_list(L - n) from the layer above (herm_list(L - n - 1)):
    the index of each entry's "hi" and "lo" source, the dimension it
    recurses in (the first of t, u, v that is nonzero) and the lo
    coefficient (that index minus 1; 0 where the scalar recursion has no
    lo term).  Entry 0 of every layer, (0,0,0), is the Boys term."""
    layers = []
    for n in range(L - 1, -1, -1):
        below = herm_index(L - n - 1)
        hi, lo, dim, coef = [], [], [], []
        for (t, u, v) in herm_list(L - n)[1:]:
            d = 0 if t > 0 else (1 if u > 0 else 2)
            k = (t, u, v)[d]
            step = [0, 0, 0]
            step[d] = 1
            hi.append(below[(t - step[0], u - step[1], v - step[2])])
            has_lo = k >= 2
            lo.append(below[(t - 2 * step[0], u - 2 * step[1],
                             v - 2 * step[2])] if has_lo else 0)
            dim.append(d)
            coef.append(float(k - 1) if has_lo else 0.0)
        layers.append(tuple(torch.as_tensor(np.asarray(x), device=device)
                            for x in (hi, lo, dim, coef)))
    return layers


def r_tensor(L: int, alpha, X, F) -> torch.Tensor:
    """Hermite Coulomb integrals R^0_{tuv} stacked in herm_list(L) order.

    alpha: [...], X: [..., 3] (the P-Q separation), F: [..., L+1] Boys values
    (any linear prefactor may be pre-multiplied into F).
    Returns [..., nherm(L)].

    The JAX package's scalar recursion (R^n_{tuv} = (t-1) R^{n+1}_{t-2,u,v}
    + X R^{n+1}_{t-1,u,v}, in the first nonzero index) evaluated a level n
    at a time over all of its (t, u, v) with gathers (``_r_layers``): the
    same operations on every entry, in a few launches a level.
    """
    m2a = -2.0 * alpha
    pows = [torch.ones_like(alpha)]
    for n in range(1, L + 1):
        pows.append(pows[-1] * m2a)
    R = (pows[L] * F[..., L])[..., None]
    for n, (hi, lo, dim, coef) in zip(range(L - 1, -1, -1),
                                      _r_layers(L, alpha.device)):
        rest = coef * R[..., lo] + X[..., dim] * R[..., hi]
        R = torch.cat([(pows[n] * F[..., n])[..., None], rest], dim=-1)
    return R


__all__ = ["pair_primitive_data", "e_dense", "hermite_expansion", "r_tensor", "boys"]
