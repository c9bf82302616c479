"""One-electron integrals: overlap, kinetic, nuclear attraction, dipole.

Port of ``juliachem_jl_tpu/ops/oei.py``.  Every angular-momentum class pair
is evaluated as one batched McMurchie-Davidson tensor program over the whole
pair block, as plain torch on the calculation's device (the JAX package runs
these on host numpy).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..basis.structs import Basis, axial_normalization
from .boys import boys
from .class_tables import nherm, pair_tables
from .eri import as_f64
from .mcmurchie import e_dense, hermite_expansion, pair_primitive_data, r_tensor
from .pairs import PairBlock, block_scatter_indices, unique_pair_blocks

# per-chunk working-set bound (elements) for the nuclear-attraction R tensor
_WORKSET = 2.0e7


def _tables(la, lb, device):
    tab = pair_tables(la, lb)
    out = {k: torch.as_tensor(tab[k], device=device)
           for k in ("ix_a", "ix_b", "iy_a", "iy_b", "iz_a", "iz_b")}
    out["ax"] = as_f64(np.outer(axial_normalization(la),
                                axial_normalization(lb)), device)
    return tab, out


def _gather_1d(E, t, j_shift: int = 0):
    """Per-dimension E(i,j,0) tables gathered to component-pair shape.

    E: [N,K2,3,la+1,lbx+1,L+1]; returns (ex, ey, ez) each [N,K2,nca,ncb]
    evaluated at (i_a, i_b + j_shift, t=0).
    """
    ex = E[:, :, 0, t["ix_a"], t["ix_b"] + j_shift, 0]
    ey = E[:, :, 1, t["iy_a"], t["iy_b"] + j_shift, 0]
    ez = E[:, :, 2, t["iz_a"], t["iz_b"] + j_shift, 0]
    return ex, ey, ez


def _stv_block(la, lb, aexp, bexp, acoef, bcoef, A, B, coords, Z):
    """S/T/V blocks for one chunk of a pair class (tensors, f64)."""
    tab, t = _tables(la, lb, aexp.device)
    nca, ncb, L = tab["nca"], tab["ncb"], tab["L"]

    prim = pair_primitive_data(aexp, bexp, acoef, bcoef, A, B)
    p, b, cc = prim["p"], prim["b"], prim["cc"]
    pref = (math.pi / p) ** 1.5 * cc                    # [N,K2]

    # E with ket angular momentum extended by 2 (for kinetic)
    E = e_dense(la, lb + 2, prim)
    ex0, ey0, ez0 = _gather_1d(E, t, 0)
    ex2, ey2, ez2 = _gather_1d(E, t, 2)

    b4 = b[:, :, None, None]

    def k1d(e0, e2, i_a, i_b, d):
        # K(i,j) = -2 b^2 E(i,j+2) + b(2j+1) E(i,j) - j(j-1)/2 E(i,j-2)
        low = E[:, :, d, i_a, torch.clamp(i_b - 2, min=0), 0]
        jj = i_b.to(E.dtype)[None, None]
        return (
            -2.0 * b4**2 * e2
            + b4 * (2.0 * jj + 1.0) * e0
            - 0.5 * jj * (jj - 1.0) * torch.where(jj >= 2, low, 0.0)
        )

    kx = k1d(ex0, ex2, t["ix_a"], t["ix_b"], 0)
    ky = k1d(ey0, ey2, t["iy_a"], t["iy_b"], 1)
    kz = k1d(ez0, ez2, t["iz_a"], t["iz_b"], 2)

    s3 = ex0 * ey0 * ez0
    t3 = kx * ey0 * ez0 + ex0 * ky * ez0 + ex0 * ey0 * kz
    S = torch.einsum("nk,nkab->nab", pref, s3)
    T = torch.einsum("nk,nkab->nab", pref, t3)

    # nuclear attraction
    Eab = hermite_expansion(la, lb, prim)               # [N,K2,nab,nh]
    PC = prim["P"][:, :, None, :] - coords[None, None, :, :]
    Targ = p[:, :, None] * torch.sum(PC**2, dim=-1)     # [N,K2,natom]
    F = boys(Targ, L)
    F = F * (-(2.0 * math.pi / p))[:, :, None, None] * Z[None, None, :, None]
    alpha = p[:, :, None].expand(Targ.shape)
    R = r_tensor(L, alpha, PC, F)                       # [N,K2,natom,nh]
    Rsum = R.sum(dim=2)
    V = torch.einsum("nkah,nkh->na", Eab, Rsum).reshape(-1, nca, ncb)

    return S * t["ax"], T * t["ax"], V  # V already axial-normalized via Eab


def _dipole_block(la, lb, aexp, bexp, acoef, bcoef, A, B, origin):
    """Dipole-moment integral blocks <a| r_d - C_d |b> (tensors, f64)."""
    tab, t = _tables(la, lb, aexp.device)
    prim = pair_primitive_data(aexp, bexp, acoef, bcoef, A, B)
    p, cc = prim["p"], prim["cc"]
    pref = (math.pi / p) ** 1.5 * cc
    E = e_dense(la, lb + 1, prim)
    ex0, ey0, ez0 = _gather_1d(E, t, 0)
    ex1, ey1, ez1 = _gather_1d(E, t, 1)
    BC = B - origin[None, :]                            # [N,3]
    bc = BC[:, None, None, None, :]
    mx = ex1 + bc[..., 0] * ex0
    my = ey1 + bc[..., 1] * ey0
    mz = ez1 + bc[..., 2] * ez0
    dip = torch.stack(
        [mx * ey0 * ez0, ex0 * my * ez0, ex0 * ey0 * mz], dim=-1
    )                                                   # [N,K2,a,b,3]
    out = torch.einsum("nk,nkabd->nabd", pref, dip)
    return out * t["ax"][None, :, :, None]


def _block_chunks(blk: PairBlock, natom: int):
    """Chunk sizes bounding the [N,K2,natom,nherm] nuclear R working set."""
    k2 = blk.aexp.shape[1] * blk.bexp.shape[1]
    per = k2 * max(natom, 1) * nherm(blk.la + blk.lb)
    return max(64, int(_WORKSET / max(per, 1)))


def _block_args(blk: PairBlock, sl: slice, device):
    return [as_f64(x[sl], device) for x in
            (blk.aexp, blk.bexp, blk.acoef, blk.bcoef, blk.A, blk.B)]


def _scatter_sym(M: torch.Tensor, block: PairBlock, vals: torch.Tensor) -> None:
    """Scatter pair-block values into a symmetric matrix (both triangles).
    A trailing axis of vals (dipole components) rides along."""
    ia, ib = (torch.as_tensor(np.array(i), device=M.device)
              for i in block_scatter_indices(block))
    M.index_put_((ia, ib), vals, accumulate=True)
    off = torch.as_tensor(block.ish != block.jsh, device=M.device)
    if bool(off.any()):
        M.index_put_((ib[off].transpose(1, 2), ia[off].transpose(1, 2)),
                     vals[off].transpose(1, 2), accumulate=True)


def overlap_kinetic_nuclear(basis: Basis, mol, device):
    """Full S, T, V matrices (f64 tensors on ``device``).

    Replaces EnergyHelpers.compute_overlap/ke/nah (EnergyHelpers.jl:25-140).
    """
    nbf = basis.nbf
    S, T, V = (torch.zeros((nbf, nbf), dtype=torch.float64, device=device)
               for _ in range(3))
    coords = as_f64(mol.coords, device)
    Z = as_f64(mol.z, device)
    for blk in unique_pair_blocks(basis):
        chunk = _block_chunks(blk, mol.natom)
        ss, ts, vs = [], [], []
        for s0 in range(0, blk.n, chunk):
            s, t, v = _stv_block(blk.la, blk.lb,
                                 *_block_args(blk, slice(s0, s0 + chunk), device),
                                 coords, Z)
            ss.append(s)
            ts.append(t)
            vs.append(v)
        _scatter_sym(S, blk, torch.cat(ss, dim=0))
        _scatter_sym(T, blk, torch.cat(ts, dim=0))
        _scatter_sym(V, blk, torch.cat(vs, dim=0))
    return S, T, V


def dipole_matrices(basis: Basis, device, origin=None):
    """<mu| r - origin |nu> for x,y,z; replaces PropEngine dipole blocks
    (deps/src/jeri-prop.hpp:43-53)."""
    nbf = basis.nbf
    out = torch.zeros((nbf, nbf, 3), dtype=torch.float64, device=device)
    origin = as_f64(np.zeros(3) if origin is None else origin, device)
    for blk in unique_pair_blocks(basis):
        chunk = _block_chunks(blk, 1)
        ds = [_dipole_block(blk.la, blk.lb,
                            *_block_args(blk, slice(s0, s0 + chunk), device),
                            origin)
              for s0 in range(0, blk.n, chunk)]
        _scatter_sym(out, blk, torch.cat(ds, dim=0))
    return out[..., 0], out[..., 1], out[..., 2]
