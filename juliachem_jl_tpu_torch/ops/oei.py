"""One-electron integrals: overlap, kinetic, nuclear attraction, dipole.

Port of ``juliachem_jl_tpu/ops/oei.py``.  ``overlap_kinetic_nuclear`` is
the wrapper of kernel K9 (csrc/oei*.cu): on the card it packs each
angular-momentum class of unique shell pairs once (``stv_tables``: the live
primitive pairs, both coefficients nonzero, of each pair and where its
block lands) and launches K9 a class, which sums over the nuclei in its own
body and stores S, T and V straight into the matrices.  On the CPU it runs
``overlap_kinetic_nuclear_plain``, the JAX package's chunked McMurchie-
Davidson tensor program over the padded pair blocks (which the JAX package
runs on host numpy), K9's oracle.  ``stv_class`` is K9's wrapper for one
class and takes CUDA tensors only.  ``dipole_matrices`` stays plain torch
on the calculation's device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..basis.structs import Basis, axial_normalization, ncart
from . import kernels
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


def overlap_kinetic_nuclear_plain(basis: Basis, mol, device):
    """Full S, T, V matrices (f64 tensors on ``device``), as the JAX
    package computes them: each padded pair block in chunks bounding the
    [N, K2, natom, nherm] R tensor, scattered with ``index_put_``."""
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


# ------------------------------------------------------------------ K9

# angular momenta K9 is instantiated for (JC_STV_CLASSES, csrc/oei.cu)
STV_MAX_L = 4


@dataclass
class StvTable:
    """One (la, lb) class of unique shell pairs as K9 reads it.

    prim: [np, 3] f64, a, b and ca cb of each pair's live primitive pairs
    (both coefficients nonzero; a pair's rows contiguous, in the padded
    block's (i, j) order); pair: [n, 6] f64, the centres A, B; meta: [n, 5]
    int32, off_a, off_b, ish == jsh, the pair's first row of ``prim`` and
    its count (and, for K10 and K11, [n, 7]: the atoms of the two shells;
    ``stv_table``).  The pairs are sorted by count, most first, so that the
    groups of a warp walk similar counts."""

    la: int
    lb: int
    prim: torch.Tensor
    pair: torch.Tensor
    meta: torch.Tensor

    @property
    def n(self) -> int:
        return self.meta.shape[0]


def check_stv_class(la: int, lb: int) -> None:
    """Raise NotImplementedError for a class K9 is not instantiated for."""
    if max(la, lb) > STV_MAX_L:
        raise NotImplementedError(
            f"K9 is not instantiated for class ({la}, {lb}): it stops at g "
            "shells (l = 4)")


def stv_table(blk: PairBlock, device, atom_of=None) -> StvTable:
    """Pack one unique pair block for K9 (``StvTable``), on ``device``.
    With ``atom_of`` (each shell's atom), for K10 and K11: meta gains two
    columns, the atoms of the two shells (a unit partner, jsh < 0, takes
    its first shell's)."""
    ka, kb = blk.aexp.shape[1], blk.bexp.shape[1]
    aexp, bexp, acoef, bcoef = (as_f64(x, device) for x in (
        blk.aexp, blk.bexp, blk.acoef, blk.bcoef))
    live_a, live_b = acoef != 0.0, bcoef != 0.0
    count = live_a.sum(1) * live_b.sum(1)
    order = torch.sort(-count, stable=True).indices
    live = live_a[order][:, :, None] & live_b[order][:, None, :]
    flat = torch.nonzero(live.reshape(-1)).reshape(-1)
    rows = order[flat // (ka * kb)]
    ia = rows * ka + flat % (ka * kb) // kb
    jb = rows * kb + flat % kb
    prim = torch.stack([aexp.reshape(-1)[ia], bexp.reshape(-1)[jb],
                        acoef.reshape(-1)[ia] * bcoef.reshape(-1)[jb]], dim=1)
    count = count[order]
    idx = order.cpu().numpy()
    cols = [blk.off_a[idx], blk.off_b[idx], blk.ish[idx] == blk.jsh[idx]]
    if atom_of is not None:
        ish, jsh = blk.ish[idx], blk.jsh[idx]
        atom_of = np.asarray(atom_of)
        cols += [atom_of[ish], atom_of[np.where(jsh >= 0, jsh, ish)]]
    host = np.stack(cols, axis=1)
    host = torch.as_tensor(host.astype(np.int64), device=device)
    meta = torch.cat([host[:, :3], (torch.cumsum(count, 0) - count)[:, None],
                      count[:, None], host[:, 3:]], dim=1).to(torch.int32)
    pair = as_f64(np.concatenate([blk.A, blk.B], axis=1), device)[order]
    return StvTable(la=blk.la, lb=blk.lb, prim=prim.contiguous(),
                    pair=pair.contiguous(), meta=meta.contiguous())


def stv_tables(basis: Basis, device) -> list[StvTable]:
    """Every class of unique shell pairs of ``basis`` packed for K9, after
    checking that K9 has them all (NotImplementedError before anything
    reaches ``device``)."""
    for la in basis.classes:
        check_stv_class(la, la)
    return [stv_table(blk, device) for blk in unique_pair_blocks(basis)]


def atom_table(mol, device) -> torch.Tensor:
    """[natom, 4] f64: each nucleus's x, y, z and charge."""
    return as_f64(np.concatenate([np.asarray(mol.coords, dtype=np.float64),
                                  np.asarray(mol.z, dtype=np.float64)[:, None]],
                                 axis=1), device)


def stv_targets(tab: StvTable, nbf: int) -> np.ndarray:
    """[n, nab, 2] int64 flat indices i * nbf + j that each pair's block
    element is stored at: the block, then its transpose, which is the block
    itself on the diagonal (ish == jsh): the unique pairs cover nbf x nbf
    once."""
    meta = tab.meta.cpu().numpy().astype(np.int64)
    i = meta[:, 0, None, None] + np.arange(ncart(tab.la))[None, :, None]
    j = meta[:, 1, None, None] + np.arange(ncart(tab.lb))[None, None, :]
    i, j = (np.broadcast_to(x, (tab.n, ncart(tab.la), ncart(tab.lb)))
            .reshape(tab.n, -1) for x in (i, j))
    diag = meta[:, 2, None] != 0
    return np.stack([i * nbf + j, np.where(diag, i * nbf + j, j * nbf + i)],
                    axis=-1)


def stv_class(tab: StvTable, atoms: torch.Tensor, S, T, V,
              group: int | None = None) -> None:
    """Kernel K9: the (la, lb) class's elements of S, T and V ([nbf, nbf]
    f64, row-major), stored (no accumulation) at ``stv_targets``.

    It launches K9 with ``group`` lanes a shell pair (default
    ``kernels.stv_group`` of the nuclei) and raises ValueError for tensors
    that are not on the card."""
    if not S.is_cuda:
        raise ValueError(f"stv_class: K9 runs on CUDA tensors, got {S.device}")
    if tab.n == 0:
        return
    check_stv_class(tab.la, tab.lb)
    group = kernels.stv_group(atoms.shape[0]) if group is None else group
    if group not in kernels.STV_GROUPS:
        raise ValueError(f"stv_class: group {group} not in "
                         f"{kernels.STV_GROUPS}")
    nbf = S.shape[0]
    for x, dt in ((S, torch.float64), (T, torch.float64), (V, torch.float64),
                  (tab.prim, torch.float64), (tab.pair, torch.float64),
                  (tab.meta, torch.int32), (atoms, torch.float64)):
        if x.dtype != dt or x.device != S.device or not x.is_contiguous():
            raise ValueError(f"stv_class: expected contiguous {dt} on "
                             f"{S.device}, got {x.dtype} on {x.device}")
    if S.shape != (nbf, nbf) or T.shape != S.shape or V.shape != S.shape:
        raise ValueError("stv_class: S, T, V must be [nbf, nbf]")
    kernels.launch("jc_stv", tab.la, tab.lb, group, tab.prim.data_ptr(),
                   tab.pair.data_ptr(), tab.meta.data_ptr(), tab.n,
                   atoms.data_ptr(), atoms.shape[0], S.data_ptr(),
                   T.data_ptr(), V.data_ptr(), nbf, cls=(tab.la, tab.lb))


def overlap_kinetic_nuclear(basis: Basis, mol, device):
    """Full S, T, V matrices (f64 tensors on ``device``): K9 on the card,
    one launch a class, into matrices it fills whole; the plain version
    (``overlap_kinetic_nuclear_plain``) on the CPU.

    Replaces EnergyHelpers.compute_overlap/ke/nah (EnergyHelpers.jl:25-140).
    """
    device = torch.device(device)
    if device.type != "cuda":
        return overlap_kinetic_nuclear_plain(basis, mol, device)
    tables = stv_tables(basis, device)
    atoms = atom_table(mol, device)
    nbf = basis.nbf
    S, T, V = (torch.empty((nbf, nbf), dtype=torch.float64, device=device)
               for _ in range(3))
    for tab in tables:
        stv_class(tab, atoms, S, T, V)
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
