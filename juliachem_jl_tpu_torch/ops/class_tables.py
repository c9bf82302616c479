"""Static (trace-time) index tables for angular-momentum classes.

Everything here is plain numpy computed once per (la, lb[, lc, ld]) class and
baked into the jitted kernels as constants — the TPU-first replacement for the
reference's per-quartet recursive dispatch.  Tables:

* Hermite index enumeration (t,u,v with t+u+v <= L) and its index map.
* Gather maps turning per-dimension E-coefficient tables into the bra/ket
  Hermite expansion matrices E[comp_pair, hermite].
* The combination map R_combined[h_bra, h_ket] = (-1)^{|h_ket|} R[h_bra+h_ket]
  used to express a shell-quartet ERI block as two batched matmuls
  (MXU-friendly; replaces the scalar 6-loop digestion of jeri-tei.hpp).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..basis.structs import axial_normalization, cart_components, ncart


@lru_cache(maxsize=None)
def herm_list(L: int) -> tuple[tuple[int, int, int], ...]:
    """Hermite (t,u,v) triples with t+u+v <= L, graded by total order."""
    out = []
    for s in range(L + 1):
        for t in range(s, -1, -1):
            for u in range(s - t, -1, -1):
                out.append((t, u, s - t - u))
    return tuple(out)


@lru_cache(maxsize=None)
def herm_index(L: int) -> dict:
    return {tuv: i for i, tuv in enumerate(herm_list(L))}


def nherm(L: int) -> int:
    return (L + 1) * (L + 2) * (L + 3) // 6


@lru_cache(maxsize=None)
def pair_tables(la: int, lb: int):
    """Gather maps for the bra (or ket) Hermite expansion of an (la,lb) pair.

    Returns dict with:
      ix/iy/iz_a, ix/iy/iz_b: [nca, ncb] int arrays of per-dimension angular
          momenta for each component pair;
      t, u, v: [nh] int arrays of Hermite indices (order = herm_list(la+lb));
      axial: [nca*ncb] product of axial normalization factors.
    """
    ca = np.array(cart_components(la))  # [nca, 3]
    cb = np.array(cart_components(lb))
    nca, ncb = ncart(la), ncart(lb)
    hl = np.array(herm_list(la + lb))   # [nh, 3]

    tabs = {}
    for d, name in enumerate("xyz"):
        tabs[f"i{name}_a"] = np.broadcast_to(ca[:, d][:, None], (nca, ncb)).copy()
        tabs[f"i{name}_b"] = np.broadcast_to(cb[:, d][None, :], (nca, ncb)).copy()
    tabs["t"], tabs["u"], tabs["v"] = hl[:, 0], hl[:, 1], hl[:, 2]
    ax = np.outer(axial_normalization(la), axial_normalization(lb)).reshape(-1)
    tabs["axial"] = ax
    tabs["nca"], tabs["ncb"], tabs["nh"] = nca, ncb, len(hl)
    tabs["L"] = la + lb
    return tabs


@lru_cache(maxsize=None)
def combine_tables(L_bra: int, L_ket: int):
    """R-combination map for a quartet class.

    R_combined[hb, hk] = sign[hk] * R_full[comb[hb, hk]] where
    comb[hb, hk] = herm_index(L)[tuv_bra + tuv_ket], L = L_bra + L_ket and
    sign[hk] = (-1)^{t+u+v of the ket triple} (McMurchie-Davidson phase).
    """
    hb = herm_list(L_bra)
    hk = herm_list(L_ket)
    L = L_bra + L_ket
    idx = herm_index(L)
    comb = np.zeros((len(hb), len(hk)), dtype=np.int32)
    for i, (t, u, v) in enumerate(hb):
        for j, (tt, uu, vv) in enumerate(hk):
            comb[i, j] = idx[(t + tt, u + uu, v + vv)]
    sign = np.array([(-1.0) ** sum(tuv) for tuv in hk])
    return comb, sign
