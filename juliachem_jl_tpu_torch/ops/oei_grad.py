"""First-derivative one-electron integrals (gradients of S, T, V).

Port of ``juliachem_jl_tpu/ops/oei_grad.py`` (the reference's OEIEngine
derivative blocks, deps/src/jeri-oei.hpp:67-199, and their assembly in
src/rhf/gradient/GradHelpers.jl:65-467), as batched torch on the
calculation's device: the JAX package runs these on host numpy.  Built on
the McMurchie-Davidson machinery of ops/oei.py with the operator identity

    d/dAx  phi_i = 2a phi_{i+1} - i phi_{i-1}

applied inside the primitive contraction (the 2a weight is per primitive).
For the two-center S and T, translational invariance gives d/dB = -d/dA.
For the nuclear attraction dV/dA + dV/dB + sum_C dV/dC = 0, with the
per-nucleus (Hellmann-Feynman) term from the Hermite-Coulomb shift
dR_tuv/dCx = -R_{t+1,u,v}.  The scatter into the [natom, 3, nbf, nbf]
matrices is ``index_put_`` with accumulation on the device.
"""

from __future__ import annotations

import math
from collections import Counter
from functools import lru_cache

import numpy as np
import torch

from ..basis.structs import Basis, axial_normalization, cart_components, ncart
from .boys import boys_rows
from .class_tables import herm_index, herm_list, nherm
from .eri import as_f64
from .mcmurchie import e_dense, pair_primitive_data, r_tensor
from .oei import _block_args
from .pairs import PairBlock, block_scatter_indices, unique_pair_blocks

# per-chunk bound (elements) of the largest [N, K2, natom, nherm] or
# [N, K2, nca, ncb, nherm] intermediate
_WORKSET = 2.0e7


@lru_cache(maxsize=None)
def component_tables(la: int, lb: int):
    """Per-dimension angular momenta of each (bra, ket) component pair:
    two int64 arrays [3, nca, ncb]."""
    ca = np.array(cart_components(la))   # [nca, 3]
    cb = np.array(cart_components(lb))
    nca, ncb = ncart(la), ncart(lb)
    ia = np.broadcast_to(ca.T[:, :, None], (3, nca, ncb))
    ib = np.broadcast_to(cb.T[:, None, :], (3, nca, ncb))
    return ia.copy(), ib.copy()


@lru_cache(maxsize=None)
def _expansion_index(la: int, lb: int, L: int, dim, delta: int, side: str,
                     device: torch.device):
    """Per dimension the (i, j, t) index tensors of ``expansion``, on the
    device, built once."""
    ia, ib = component_tables(la, lb)
    hl = np.asarray(herm_list(L))
    out = []
    for d in range(3):
        i_d, j_d = ia[d], ib[d]
        if dim == d:
            if side == "bra":
                i_d = np.maximum(i_d + delta, 0)
            else:
                j_d = np.maximum(j_d + delta, 0)
        out.append(tuple(torch.as_tensor(x, device=device) for x in (
            i_d[:, :, None], j_d[:, :, None], hl[:, d][None, None, :])))
    return tuple(out)


def expansion(E, la: int, lb: int, L: int, dim=None, delta=0, side="bra"):
    """Gather the 3D Hermite expansion of the (la, lb) component pairs over
    herm_list(L) from the dense per-dimension table E [N,K2,3,Imax,Jmax,
    Tmax], with an optional +1/-1 angular-momentum shift (delta) in one
    dimension on one side ("bra" or "ket").  Returns [N, K2, nca, ncb,
    nh'].  Negative indices are clamped to 0: callers weight those entries
    by the original index, which is zero exactly where the clamp applied."""
    out = 1.0
    for d, (i_t, j_t, t_t) in enumerate(
            _expansion_index(la, lb, L, dim, delta, side, E.device)):
        out = out * E[:, :, d, i_t, j_t, t_t]
    return out


def _stv_grad_block(la: int, lb: int, aexp, bexp, acoef, bcoef, A, B, coords,
                    Z, work: Counter | None = None):
    """Per-pair dS/dA, dT/dA (d/dB = -d/dA), dV/dA, dV/dB [N, 3, nca, ncb]
    and the per-nucleus dV/dC [N, natom, 3, nca, ncb] of one chunk of a
    class pair (the JAX package's ``_stv_grad_kernel``); the pairs are
    counted into ``work`` under ("stv", la, lb, K2, natom) when given."""
    dev = aexp.device
    nca, ncb = ncart(la), ncart(lb)
    L = la + lb
    Lg = L + 1
    ax = as_f64(np.outer(axial_normalization(la), axial_normalization(lb)),
                dev)
    ia_t, ib_t = component_tables(la, lb)
    hlL = herm_list(L)
    idxG = herm_index(Lg)
    # index of each herm(L) triple's +1-in-dim-d image inside herm(L+1)
    shift_maps = [
        torch.as_tensor([idxG[(t + (d == 0), u + (d == 1), v + (d == 2))]
                         for (t, u, v) in hlL], device=dev)
        for d in range(3)
    ]
    natom = coords.shape[0]
    if work is not None:
        work[("stv", la, lb, aexp.shape[1] * bexp.shape[1], natom)] += \
            aexp.shape[0]
    prim = pair_primitive_data(aexp, bexp, acoef, bcoef, A, B)
    p, a, b, cc = prim["p"], prim["a"], prim["b"], prim["cc"]
    pref = (math.pi / p) ** 1.5 * cc                       # [N,K2]
    a2 = (2.0 * a)[:, :, None, None]

    # dense E with bra extended by 1, ket by 2 (kinetic needs j+2)
    E = e_dense(la + 1, lb + 2, prim)

    def idx(x):
        return torch.as_tensor(x, device=dev)

    def g(d, i_d, j_d):
        return E[:, :, d, idx(i_d), idx(j_d), 0]           # [N,K2,nca,ncb]

    iw = [idx(ia_t[d]).to(E.dtype) for d in range(3)]
    e0 = [g(d, ia_t[d], ib_t[d]) for d in range(3)]
    de = []
    for d in range(3):
        plus = g(d, ia_t[d] + 1, ib_t[d])
        minus = g(d, np.maximum(ia_t[d] - 1, 0), ib_t[d])
        de.append(a2 * plus - iw[d][None, None] * minus)

    def k1d(d, i_d):
        j_d = ib_t[d]
        jj = idx(j_d).to(E.dtype)[None, None]
        b4 = b[:, :, None, None]
        e_0 = g(d, i_d, j_d)
        e_2 = g(d, i_d, j_d + 2)
        e_m = g(d, i_d, np.maximum(j_d - 2, 0))
        return (-2.0 * b4**2 * e_2 + b4 * (2.0 * jj + 1.0) * e_0
                - 0.5 * jj * (jj - 1.0) * torch.where(jj >= 2, e_m, 0.0))

    k0 = [k1d(d, ia_t[d]) for d in range(3)]
    dk = []
    for d in range(3):
        plus = k1d(d, ia_t[d] + 1)
        minus = k1d(d, np.maximum(ia_t[d] - 1, 0))
        dk.append(a2 * plus - iw[d][None, None] * minus)

    def contract(x):
        return torch.einsum("nk,nkab->nab", pref, x) * ax

    dS = torch.stack([contract(de[0] * e0[1] * e0[2]),
                      contract(e0[0] * de[1] * e0[2]),
                      contract(e0[0] * e0[1] * de[2])], dim=1)
    dT = torch.stack([
        contract(dk[0] * e0[1] * e0[2]
                 + de[0] * (k0[1] * e0[2] + e0[1] * k0[2])),
        contract(e0[0] * dk[1] * e0[2]
                 + de[1] * (k0[0] * e0[2] + e0[0] * k0[2])),
        contract(e0[0] * e0[1] * dk[2]
                 + de[2] * (k0[0] * e0[1] + e0[0] * k0[1])),
    ], dim=1)

    # ---- nuclear attraction derivatives ----------------------------------
    PC = prim["P"][:, :, None, :] - coords[None, None, :, :]
    Targ = p[:, :, None] * torch.sum(PC**2, dim=-1)
    F = boys_rows(Targ, Lg)
    F = F * (-(2.0 * math.pi / p))[:, :, None, None] * Z[None, None, :, None]
    alpha = p[:, :, None].expand(Targ.shape)
    R = r_tensor(Lg, alpha, PC, F)                          # [N,K2,natom,nhG]
    Rsum = R.sum(dim=2)                                     # [N,K2,nhG]
    axf = ax.reshape(-1)
    ccw = cc[:, :, None, None, None]
    N, K2 = p.shape

    def vcontract(Eexp, Rarr):
        # Eexp [N,K2,nca,ncb,nh'], Rarr [N,K2,nh'] -> [N,a,b]
        Ee = Eexp.reshape(N, K2, nca * ncb, -1)
        out = torch.einsum("nkah,nkh->na", Ee, Rarr)
        return (out * axf[None, :]).reshape(N, nca, ncb)

    b2 = (2.0 * b)[:, :, None, None, None]
    dVA, dVB = [], []
    for d in range(3):
        w_a = iw[d][None, None, :, :, None]
        Ed_a = (a2[..., None] * expansion(E, la, lb, Lg, d, +1, "bra")
                - w_a * expansion(E, la, lb, Lg, d, -1, "bra")) * ccw
        dVA.append(vcontract(Ed_a, Rsum))
        jw = idx(ib_t[d]).to(E.dtype)[None, None, :, :, None]
        Ed_b = (b2 * expansion(E, la, lb, Lg, d, +1, "ket")
                - jw * expansion(E, la, lb, Lg, d, -1, "ket")) * ccw
        dVB.append(vcontract(Ed_b, Rsum))
    dVA = torch.stack(dVA, dim=1)                          # [N,3,a,b]
    dVB = torch.stack(dVB, dim=1)

    # per-nucleus Hellmann-Feynman term: dV/dCx = -sum E R^{(C)}_{t+1}
    Eab = (expansion(E, la, lb, L) * ccw).reshape(N, K2, nca * ncb, -1)
    dVC = []
    for d in range(3):
        Rs = R[..., shift_maps[d]]                         # [N,K2,natom,nhL]
        out = -torch.einsum("nkah,nkch->nca", Eab, Rs)
        dVC.append((out * axf[None, None, :]).reshape(N, natom, nca, ncb))
    dVC = torch.stack(dVC, dim=2)                          # [N,natom,3,a,b]
    return dS, dT, dVA, dVB, dVC


def _chunk(blk: PairBlock, natom: int) -> int:
    """Pairs per chunk: bound the [N,K2,natom,nherm(L+1)] nuclear R and the
    [N,K2,nca,ncb,nherm(L+1)] expansions to _WORKSET elements."""
    k2 = blk.aexp.shape[1] * blk.bexp.shape[1]
    nca, ncb = blk.nbf_block
    per = k2 * nherm(blk.la + blk.lb + 1) * max(natom, nca * ncb)
    return max(16, int(_WORKSET / max(per, 1)))


def _scatter(M: torch.Tensor, blk: PairBlock, atoms, vals: torch.Tensor
             ) -> None:
    """vals [n, 3, nca, ncb] -> M[atoms, :, ia, ib] with atoms [n]; or, with
    atoms None, the per-nucleus vals [n, natom, 3, nca, ncb] -> M[c, :, ia,
    ib] for every nucleus c; and the mirror image of the off-diagonal pairs
    (the JAX package's ``scat``)."""
    dev = M.device
    ia, ib = (torch.as_tensor(np.array(x), device=dev)
              for x in block_scatter_indices(blk))
    xyz = torch.arange(3, device=dev)[:, None, None]
    if atoms is None:   # one leading axis more: the nuclei
        at = torch.arange(M.shape[0], device=dev)[None, :, None, None, None]
        ia, ib = ia[:, None, None], ib[:, None, None]
    else:
        at = atoms[:, None, None, None]
        ia, ib = ia[:, None], ib[:, None]
    M.index_put_((at, xyz, ia, ib), vals, accumulate=True)
    off = torch.as_tensor(blk.ish != blk.jsh, device=dev)
    if bool(off.any()):
        at_off = at if atoms is None else at[off]
        M.index_put_((at_off, xyz, ib[off].transpose(-1, -2),
                      ia[off].transpose(-1, -2)),
                     vals[off].transpose(-1, -2), accumulate=True)


def stv_gradients(basis: Basis, mol, device, work: Counter | None = None):
    """Full derivative matrices dS, dT, dV [natom, 3, nbf, nbf] (f64 tensors
    on ``device``; the GradHelpers.jl:65-467 assembly analog); ``work``
    counts the pairs evaluated (``_stv_grad_block``)."""
    nbf, natom = basis.nbf, mol.natom
    coords = as_f64(mol.coords, device)
    Z = as_f64(mol.z, device)
    dS, dT, dV = (torch.zeros((natom, 3, nbf, nbf), dtype=torch.float64,
                              device=device) for _ in range(3))
    atom_of = torch.as_tensor(np.asarray(basis.shell_atom), device=device)
    for blk in unique_pair_blocks(basis):
        size = _chunk(blk, natom)
        parts = [[], [], [], [], []]
        for s0 in range(0, blk.n, size):
            res = _stv_grad_block(blk.la, blk.lb, *_block_args(
                blk, slice(s0, s0 + size), device), coords, Z, work)
            for ps, r in zip(parts, res):
                ps.append(r)
        ds, dt, dva, dvb, dvc = (torch.cat(ps, dim=0) for ps in parts)
        at_a = atom_of[torch.as_tensor(blk.ish, device=device)]
        at_b = atom_of[torch.as_tensor(blk.jsh, device=device)]
        _scatter(dS, blk, at_a, ds)
        _scatter(dS, blk, at_b, -ds)     # translational invariance
        _scatter(dT, blk, at_a, dt)
        _scatter(dT, blk, at_b, -dt)
        _scatter(dV, blk, at_a, dva)
        _scatter(dV, blk, at_b, dvb)
        _scatter(dV, blk, None, dvc)
    return dS, dT, dV
