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
dR_tuv/dCx = -R_{t+1,u,v}.  ``stv_gradients`` scatters the blocks into the
[natom, 3, nbf, nbf] matrices with ``index_put_`` (the JAX package's
assembly, kept for the parity tests).  The gradient itself never forms
them on the card: ``one_electron_gradient`` is the wrapper of kernel K10
(csrc/oei_grad.cuh), which contracts each class's derivative blocks with
D and W into [natom, 3] as it computes them, one launch a class.
``stv_grad_plain`` is K10's plain version on the same tables (K9's packing
with the shells' atoms).
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


# ------------------------------------------------------------------ K10

def stv_grad_tables(basis: Basis, device) -> list:
    """Every class of unique shell pairs of ``basis`` packed for K10 and its
    plain version (``oei.stv_table`` with the shells' atoms), after
    checking that K10 has them all (NotImplementedError before anything
    reaches ``device``)."""
    from .oei import check_stv_class, stv_table

    for la in basis.classes:
        check_stv_class(la, la)
    atom_of = np.asarray(basis.shell_atom)
    return [stv_table(blk, device, atom_of)
            for blk in unique_pair_blocks(basis)]


def _stv_work(work, tab, natom):
    if work is None:
        return
    c = tab.meta[:, 4].cpu().numpy()
    vals, n = np.unique(c, return_counts=True)
    for v, k in zip(vals.tolist(), n.tolist()):
        work[("stv", tab.la, tab.lb, v, natom)] += k


def _stv_grad_rows(tab, s: torch.Tensor, rows: slice, atoms):
    """``_stv_grad_block`` over the live primitive pairs ``rows`` of one
    K10 table (``s``: the pair of each), each a pair of one primitive (the
    blocks are linear in them)."""
    pr, cen = tab.prim[rows], tab.pair[s]
    one = torch.ones_like(pr[:, :1])
    return _stv_grad_block(tab.la, tab.lb, pr[:, 0:1], pr[:, 1:2],
                              pr[:, 2:3], one, cen[:, :3], cen[:, 3:],
                              atoms[:, :3], atoms[:, 3])


def stv_grad_plain(tables, atoms: torch.Tensor, D: torch.Tensor,
                   W: torch.Tensor, work: Counter | None = None
                   ) -> torch.Tensor:
    """K10's plain version: the same function from the same tables
    (``stv_grad_tables``; ``atoms`` [natom, 4] from ``oei.atom_table``),
    on their device: [natom, 3] f64, sum D (dT + dV) - W dS.  The live
    primitive pairs go through ``_stv_grad_block`` in chunks, each a pair of
    one primitive, and are contracted with their pair's D and W blocks at
    once: no [natom, 3, nbf, nbf] matrix exists."""
    natom = atoms.shape[0]
    grad = torch.zeros((natom, 3), dtype=torch.float64, device=D.device)
    for tab in tables:
        _stv_work(work, tab, natom)
        if tab.n == 0:
            continue
        nca, ncb = ncart(tab.la), ncart(tab.lb)
        meta = tab.meta.long()
        ia = meta[:, 0, None] + torch.arange(nca, device=D.device)
        ib = meta[:, 1, None] + torch.arange(ncb, device=D.device)
        wt = (2 - meta[:, 2]).to(torch.float64)[:, None, None]
        Dw = wt * D[ia[:, :, None], ib[:, None, :]]
        Ww = wt * W[ia[:, :, None], ib[:, None, :]]
        per = nherm(tab.la + tab.lb + 1) * max(natom, nca * ncb) \
            + 3 * natom * nca * ncb
        size = max(16, int(_WORKSET / per))
        seg = torch.repeat_interleave(
            torch.arange(tab.n, device=D.device), meta[:, 4])
        for r0 in range(0, tab.prim.shape[0], size):
            s = seg[r0:r0 + size]
            dS, dT, dVA, dVB, dVC = _stv_grad_rows(
                tab, s, slice(r0, r0 + size), atoms)
            d, w = Dw[s], Ww[s]
            gS = (torch.einsum("nab,nkab->nk", d, dT)
                  - torch.einsum("nab,nkab->nk", w, dS))
            grad.index_add_(0, meta[s, 5],
                            gS + torch.einsum("nab,nkab->nk", d, dVA))
            grad.index_add_(0, meta[s, 6],
                            torch.einsum("nab,nkab->nk", d, dVB) - gS)
            grad += torch.einsum("nab,nckab->ck", d, dVC)
    return grad


def stv_grad_class(tab, atoms: torch.Tensor, D: torch.Tensor,
                   W: torch.Tensor, grad: torch.Tensor,
                   group: int | None = None,
                   work: Counter | None = None) -> None:
    """Kernel K10: add one class's share of sum D (dT + dV) - W dS to grad
    [natom, 3] (f64, on the card).  It launches K10 with ``group`` lanes a
    shell pair (default ``kernels.stv_group`` of the nuclei) and raises
    ValueError for tensors that are not on the card."""
    from . import kernels
    from .oei import check_stv_class

    if not grad.is_cuda:
        raise ValueError(f"stv_grad_class: K10 runs on CUDA tensors, got "
                         f"{grad.device}")
    check_stv_class(tab.la, tab.lb)
    natom = atoms.shape[0]
    group = kernels.stv_group(natom) if group is None else group
    if group not in kernels.STV_GROUPS:
        raise ValueError(f"stv_grad_class: group {group} not in "
                         f"{kernels.STV_GROUPS}")
    nbf = D.shape[0]
    for x, dt in ((D, torch.float64), (W, torch.float64),
                  (grad, torch.float64), (tab.prim, torch.float64),
                  (tab.pair, torch.float64), (tab.meta, torch.int32),
                  (atoms, torch.float64)):
        if x.dtype != dt or x.device != grad.device or not x.is_contiguous():
            raise ValueError(f"stv_grad_class: expected contiguous {dt} on "
                             f"{grad.device}, got {x.dtype} on {x.device}")
    if (D.shape != (nbf, nbf) or W.shape != D.shape
            or grad.shape != (natom, 3) or tab.meta.shape[1] != 7):
        raise ValueError("stv_grad_class: D, W [nbf, nbf], grad [natom, 3] "
                         "and a table with the shells' atoms")
    _stv_work(work, tab, natom)
    if tab.n == 0:
        return
    kernels.launch("jc_stv_grad", tab.la, tab.lb, group, tab.prim.data_ptr(),
                   tab.pair.data_ptr(), tab.meta.data_ptr(), tab.n,
                   atoms.data_ptr(), natom, D.data_ptr(), W.data_ptr(), nbf,
                   grad.data_ptr(), cls=(tab.la, tab.lb))


def one_electron_gradient(basis: Basis, mol, D: torch.Tensor,
                          W: torch.Tensor, work: Counter | None = None
                          ) -> torch.Tensor:
    """sum_pq D_pq (dT + dV)_pq/dR_k - sum_pq W_pq dS_pq/dR_k [natom, 3] on
    D's device: K10 on the card, one launch a class (``work`` counts the
    pairs by class and live primitive count).  On the CPU the contraction
    of the derivative matrices (``stv_gradients``, the JAX package's
    assembly): its last bits are the ones the CPU tests' optimizations
    were written against (a BFGS path flips on one ulp of the gradient),
    and K10's plain version, ``stv_grad_plain``, is held to it."""
    from .oei import atom_table

    dev = D.device
    if dev.type != "cuda":
        dS, dT, dV = stv_gradients(basis, mol, dev, work)
        return (torch.einsum("pq,kdpq->kd", D, dT + dV)
                - torch.einsum("pq,kdpq->kd", W, dS))
    tables = stv_grad_tables(basis, dev)
    atoms = atom_table(mol, dev)
    D, W = D.contiguous(), W.contiguous()
    grad = torch.zeros((mol.natom, 3), dtype=torch.float64, device=dev)
    for tab in tables:
        stv_grad_class(tab, atoms, D, W, grad, work=work)
    return grad
