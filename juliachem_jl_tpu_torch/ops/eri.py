"""Electron-repulsion integrals, class-batched McMurchie-Davidson, in torch.

Port of ``juliachem_jl_tpu/ops/eri.py``: every (la,lb,lc,ld) class is one
tensor program over a batch of quartets, structured as two batched
contractions over the Hermite axis —

    (ab|cd)[n] = Eab[n] . M[n] . Ecd[n]^T,
    M[n][h,h'] = (-1)^{|h'|} R_{h+h'}(alpha, P-Q)

``eri4c_class`` is the wrapper of kernel K4 (csrc/eri4c.cuh): on CUDA pair
tables it launches the kernel; on CPU ones it runs ``eri_class``, the plain
form of the JAX package's ``_eri_kernel_body``.  ``eri_block`` and
``full_eri_tensor`` (the Schwarz diagonal, the in-core Fock fill, DenseFock
and the SAD atoms) go through it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..basis.structs import Basis, ncart
from . import kernels
from .boys import boys
from .class_tables import combine_tables, nherm
from .mcmurchie import hermite_expansion, pair_primitive_data, r_tensor
from .pairs import PairBlock

TWO_PI_POW_2_5 = 2.0 * math.pi**2.5

# pair classes of K4/K5/K6 in the order of unique_pair_blocks; a class
# (bra | ket) is instantiated when the ket's pair class is the bra's or a
# later one (the i <= j walk over the pair blocks)
PAIR_CLASSES = tuple((a, b) for a in range(5) for b in range(a, 5))
# plain version: elements of the largest per-quartet intermediate per chunk
_PLAIN_BUDGET = 2.0e7


def as_f64(x, device) -> torch.Tensor:
    """A host array (or tensor) as a float64 tensor on ``device``."""
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def check_kernel_class(name: str, la, lb, lc, ld) -> None:
    """Raise NotImplementedError for a class the 4-center kernels lack."""
    bra, ket = (la, lb), (lc, ld)
    if (bra not in PAIR_CLASSES or ket not in PAIR_CLASSES
            or PAIR_CLASSES.index(ket) < PAIR_CLASSES.index(bra)):
        raise NotImplementedError(
            f"{name} is not instantiated for class ({la}{lb}|{lc}{ld}): "
            "the 4-center kernels stop at g shells (l = 4)")


def bra_hermite(la, lb, aexp, bexp, acoef, bcoef, A, B):
    """Hermite expansion of a pair batch: returns (Eab[N,K2,nab,nh], p[N,K2],
    P[N,K2,3]) with contraction coefficients and axial factors folded in."""
    prim = pair_primitive_data(aexp, bexp, acoef, bcoef, A, B)
    Eab = hermite_expansion(la, lb, prim)
    return Eab, prim["p"], prim["P"]


def live_pairs(acoef, bcoef) -> torch.Tensor:
    """[N, Ka*Kb] bool: primitive pairs whose coefficients are both
    nonzero (in pair_primitive_data's order)."""
    return ((acoef != 0)[:, :, None] & (bcoef != 0)[:, None, :]).reshape(
        acoef.shape[0], -1)


def eri_class(Lb, Lk, Eab, p, P, live_b, Ecd, q, Q, live_k) -> torch.Tensor:
    """Quartet-class body -> blocks [N, nca*ncb, ncc*ncd] (the plain form of
    ``_eri_kernel_body``), from the quartets' bra and ket Hermite
    expansions (``bra_hermite``: Eab, p, P; Ecd, q, Q) and live primitive
    pairs (``live_pairs``), Lb = la + lb, Lk = lc + ld."""
    L = Lb + Lk
    comb, sign = combine_tables(Lb, Lk)

    PQ = P[:, :, None, :] - Q[:, None, :, :]          # [N,K2b,K2k,3]
    psum = p[:, :, None] + q[:, None, :]
    alpha = p[:, :, None] * q[:, None, :] / psum
    Targ = alpha * torch.sum(PQ**2, dim=-1)
    pref = TWO_PI_POW_2_5 / (p[:, :, None] * q[:, None, :] * torch.sqrt(psum))
    # Boys and R only where both primitive pairs have nonzero
    # coefficients, as the kernels loop: the terms of the padding of a
    # class to its largest contraction are exactly zero either way
    live = live_b[:, :, None] & live_k[:, None, :]
    F = boys(Targ[live], L) * pref[live][:, None]
    R = Targ.new_zeros(Targ.shape + (nherm(L),))      # [N,K2b,K2k,nherm(L)]
    R[live] = r_tensor(L, alpha[live], PQ[live], F)

    dev = R.device
    M = R[..., torch.as_tensor(comb, dtype=torch.long, device=dev)] \
        * as_f64(sign, dev)[None, None, None, None, :]
    # contract ket: T1[n,kb,h,cd] = sum_{kk,h'} M * Ecd
    T1 = torch.einsum("nqkhg,nkcg->nqhc", M, Ecd)
    # contract bra: out[n,ab,cd] = sum_{kb,h} Eab * T1
    return torch.einsum("nqah,nqhc->nac", Eab, T1)


@dataclass
class PairTable:
    """A PairBlock as the 4-center kernels read it, on one device.

    pair: [n, 2Ka+2Kb+6] f64 = aexp | acoef | bexp | bcoef | A | B, each
    shell's primitives of nonzero coefficient first (the padding of a class
    to its largest contraction moves to the end);
    meta: [n, 5] int32 = off_a, off_b, nonzero primitives of a and of b,
    ish == jsh.  The kernels loop over the nonzero primitives only."""

    la: int
    lb: int
    Ka: int
    Kb: int
    pair: torch.Tensor
    meta: torch.Tensor

    @property
    def n(self) -> int:
        return self.pair.shape[0]

    def columns(self, sel: torch.Tensor):
        """(aexp, bexp, acoef, bcoef, A, B) of the rows sel (plain form)."""
        Ka, Kb = self.Ka, self.Kb
        x = self.pair[sel]
        o = 2 * Ka + 2 * Kb
        return (x[:, :Ka], x[:, 2 * Ka:2 * Ka + Kb], x[:, Ka:2 * Ka],
                x[:, 2 * Ka + Kb:o], x[:, o:o + 3], x[:, o + 3:o + 6])

    def hermite(self, sel: torch.Tensor):
        """(Eab, p, P, live) of the rows sel (``bra_hermite``,
        ``live_pairs``; plain form), each row's expansion computed once for
        the table: a quartet batch visits each pair row many times."""
        h = self.__dict__.get("_hermite")
        if h is None:
            aexp, bexp, acoef, bcoef, A, B = self.columns(slice(None))
            h = (*bra_hermite(self.la, self.lb, aexp, bexp, acoef, bcoef, A,
                              B), live_pairs(acoef, bcoef))
            self.__dict__["_hermite"] = h
        return tuple(x[sel] for x in h)


def pair_table(block: PairBlock, device) -> PairTable:
    """Pack a PairBlock for K4/K5/K6 (and their plain versions)."""

    def nonzero_first(exps, coefs):
        order = np.argsort(coefs == 0.0, axis=1, kind="stable")
        return (np.take_along_axis(exps, order, 1),
                np.take_along_axis(coefs, order, 1),
                (coefs != 0.0).sum(axis=1))

    aexp, acoef, ka = nonzero_first(block.aexp, block.acoef)
    bexp, bcoef, kb = nonzero_first(block.bexp, block.bcoef)
    pair = np.concatenate([aexp, acoef, bexp, bcoef, block.A, block.B], axis=1)
    meta = np.stack([block.off_a, block.off_b, ka, kb,
                     block.ish == block.jsh], axis=1).astype(np.int32)
    return PairTable(la=block.la, lb=block.lb, Ka=aexp.shape[1],
                     Kb=bexp.shape[1],
                     pair=as_f64(np.ascontiguousarray(pair), device),
                     meta=torch.as_tensor(meta, device=device))


def plain_chunk(bra: PairTable, ket: PairTable) -> int:
    """Quartets per chunk of the plain versions."""
    L = bra.la + bra.lb + ket.la + ket.lb
    work = (bra.Ka * bra.Kb * ket.Ka * ket.Kb
            * max(nherm(L), nherm(bra.la + bra.lb) * nherm(ket.la + ket.lb)))
    return max(1, int(_PLAIN_BUDGET / work))


def eri4c_plain(bra: PairTable, ket: PairTable, sel_bra, sel_ket):
    """Plain torch version of K4 (same arguments as ``eri4c_class``)."""
    out = []
    csize = plain_chunk(bra, ket)
    for s in range(0, len(sel_bra), csize):
        out.append(eri_class(bra.la + bra.lb, ket.la + ket.lb,
                             *bra.hermite(sel_bra[s:s + csize]),
                             *ket.hermite(sel_ket[s:s + csize])))
    nab, ncd = (ncart(bra.la) * ncart(bra.lb), ncart(ket.la) * ncart(ket.lb))
    if not out:
        return bra.pair.new_zeros((0, nab, ncd))
    return torch.cat(out, dim=0)


def check_tables(name: str, bra: PairTable, ket: PairTable, *ints) -> None:
    """The checks of a 4-center wrapper before it launches: every tensor
    contiguous, on the pair tables' device, of the type the kernel reads."""
    dev = bra.pair.device
    for t, dt in ((bra.pair, torch.float64), (ket.pair, torch.float64),
                  (bra.meta, torch.int32), (ket.meta, torch.int32), *ints):
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dt} on {dev}, got "
                             f"{t.dtype} on {t.device}")
    check_kernel_class(name, bra.la, bra.lb, ket.la, ket.lb)


def eri4c_class(bra: PairTable, ket: PairTable, sel_bra: torch.Tensor,
                sel_ket: torch.Tensor) -> torch.Tensor:
    """Kernel K4: (ab|cd) blocks [N, nab, ncd] of the quartets
    (bra[sel_bra[i]], ket[sel_ket[i]]); sel_*: int64 [N] on the tables'
    device."""
    if sel_bra.shape != sel_ket.shape or sel_bra.dim() != 1:
        raise ValueError("eri4c_class: sel_bra and sel_ket must be [N]")
    if not bra.pair.is_cuda:
        return eri4c_plain(bra, ket, sel_bra, sel_ket)
    check_tables("eri4c_class", bra, ket, (sel_bra, torch.int64),
                 (sel_ket, torch.int64))
    nab, ncd = (ncart(bra.la) * ncart(bra.lb), ncart(ket.la) * ncart(ket.lb))
    n = sel_bra.shape[0]
    out = torch.empty((n, nab, ncd), dtype=torch.float64,
                      device=bra.pair.device)
    if n:
        kernels.launch("jc_eri4c", bra.la, bra.lb, ket.la, ket.lb,
                       bra.pair.data_ptr(), bra.Ka, bra.Kb,
                       bra.meta.data_ptr(), ket.pair.data_ptr(), ket.Ka,
                       ket.Kb, ket.meta.data_ptr(), sel_bra.data_ptr(),
                       sel_ket.data_ptr(), n, out.data_ptr(),
                       cls=(bra.la, bra.lb, ket.la, ket.lb))
    return out


def eri4c_geometry(bra: PairTable, ket: PairTable) -> dict:
    """K5's launch geometry for the class pair of two CUDA pair tables, as
    csrc/eri4c_launch.cuh computes it: the route it was built with ("lane",
    "warp" or "block"), ket tile (CT of NCD components), bra tile (AT of
    NAB components), primitive quartets a round (RS), bra and ket
    primitive pairs a round (RB, RK: the block route's rounds; the class's
    padded pairs Kab, Kcd elsewhere), warps a block, shared-memory bytes a
    block and a warp, and the blocks an SM holds (CUDA's occupancy
    calculator).  Nothing is launched."""
    import ctypes

    check_kernel_class("eri4c_geometry", bra.la, bra.lb, ket.la, ket.lb)
    out = (ctypes.c_longlong * 9)()
    lib = kernels.library()
    rc = lib.jc_eri4c_geometry(bra.la, bra.lb, ket.la, ket.lb, bra.Ka, bra.Kb,
                               ket.Ka, ket.Kb, out)
    if rc != 0:
        raise RuntimeError(f"jc_eri4c_geometry failed: CUDA error {rc} "
                           f"({lib.jc_error_string(rc).decode()})")
    route, CT, RS, W, nbytes, blocks, AT, RB, RK = list(out)
    # the block route reports a block's bytes, the others a warp's
    block_bytes = nbytes if route == 2 else nbytes * W
    return {"route": ("warp", "lane", "block")[route], "CT": CT, "AT": AT,
            "RS": RS, "RB": RB, "RK": RK, "Kab": bra.Ka * bra.Kb,
            "Kcd": ket.Ka * ket.Kb, "warps_per_block": W,
            "warp_bytes": block_bytes // W, "block_bytes": block_bytes,
            "blocks_per_sm": blocks, "warps_per_sm": blocks * W}


def eri_block(bra: PairBlock, ket: PairBlock, sel_bra, sel_ket, device,
              ) -> torch.Tensor:
    """ERI blocks for quartets (bra[sel_bra[i]], ket[sel_ket[i]]), through
    K4 on the card.  Returns [len(sel), nca*ncb, ncc*ncd] on ``device``."""
    bt = pair_table(bra, device)
    kt = bt if ket is bra else pair_table(ket, device)

    def idx(sel):
        return torch.as_tensor(np.asarray(sel, dtype=np.int64), device=device)

    return eri4c_class(bt, kt, idx(sel_bra), idx(sel_ket))


def full_eri_tensor(basis: Basis, device) -> torch.Tensor:
    """Dense (mu nu | lam sig) tensor — for small systems (DenseFock, the
    SAD atoms).

    Computes only symmetry-unique quartets and scatters all 8 index images
    of every block at once."""
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
