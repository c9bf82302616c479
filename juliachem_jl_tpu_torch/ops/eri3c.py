"""3-center (Q|mu nu) and 2-center (P|Q) integrals for density fitting.

Port of ``juliachem_jl_tpu/ops/eri3c.py``.  Both reduce to one class kernel
over (bra shell pair) x (auxiliary shell): a bra pair against an aux shell
with a "unit" partner (exponent 0, coefficient 1 — the reference's xs_xx
trick).  The 2-center metric runs the same kernel with a unit shell as the
first bra shell, so its bra class is (0, lP).

``eri3c_class`` is the wrapper of kernel K1 (csrc/eri3c*.cu): on a CUDA
output it launches the kernel, which writes straight into the device-resident
B; on a CPU output it runs ``eri3c_class_plain``, the torch form of the JAX
package's host path (``_three_center_host``).  Both read the same packing:
each pair class as a ``PairTable`` (``ops/eri.py::pair_table``: each shell's
primitives of nonzero coefficient first, their counts in ``meta``), its
rows sorted by their first output column (``k1_pairs``), and each aux
class as an ``AuxTable`` (nonzero primitives first, their counts, and the
aux Hermite expansion built once per build: ``aux_table``).  Every (aux
row, column) target is written by exactly one (pair, aux function), so both
plain stores (kernel) and accumulation into a zeroed B (plain) are exact.
An f32 ``out`` (the ``df_b_dtype: "f32"`` build) gets each f64 value
rounded once at the store, as the JAX package casts each f64 block
(``ops/eri3c.py:185-186,269``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..basis.structs import Basis, ncart
from . import kernels
from .boys import boys
from .class_tables import combine_tables, nherm
from .eri import (TWO_PI_POW_2_5, PairTable, as_f64, bra_hermite, live_pairs,
                  pair_table)
from .mcmurchie import r_tensor
from .pairs import PairBlock, unique_pair_blocks

# (la, lb, lq) classes compiled into K1 (JC_ERI3C_CASES in
# csrc/eri3c_launch.cuh): la <= lb <= 4 primary pairs against aux shells up
# to g; the 2-center metric's bras (0, lP) are primary classes
KERNEL_CLASSES = frozenset(
    (la, lb, lq) for la, lb in kernels.ERI3C_BRAS for lq in range(5))

# plain version: elements of the largest [Pc, K2, Nq, Kq, ...] intermediate
# per pair chunk
_PLAIN_BUDGET = 2.0e7


@dataclass
class AuxTable:
    """One aux class as K1 reads it, on one device.

    table: [nq, 2Kq+3] f64 = qexp | qcoef | Q, each shell's primitives of
    nonzero coefficient first; kq: [nq] int32, their counts; qrow: [nq]
    int64, each shell's first row; ecd: [nq, Kq, ncart(lq), nherm(lq)] f64,
    the Hermite expansion of each primitive against the unit shell with
    the coefficient, the axial norms and the sign (-1)^|g| folded in (zero
    for the padding; ``aux_hermite``)."""

    lq: int
    Kq: int
    table: torch.Tensor
    kq: torch.Tensor
    qrow: torch.Tensor
    ecd: torch.Tensor

    @property
    def nq(self) -> int:
        return self.table.shape[0]


def aux_table(lq: int, exps, coefs, centers, offsets, device) -> AuxTable:
    """Pack one aux class for K1 (and its plain version)."""
    order = np.argsort(coefs == 0.0, axis=1, kind="stable")
    exps = np.take_along_axis(exps, order, 1)
    coefs = np.take_along_axis(coefs, order, 1)
    table = as_f64(np.ascontiguousarray(
        np.concatenate([exps, coefs, centers], axis=1)), device)
    Kq = exps.shape[1]
    return AuxTable(
        lq=lq, Kq=Kq, table=table,
        kq=torch.as_tensor((coefs != 0.0).sum(axis=1).astype(np.int32),
                           device=device),
        qrow=torch.as_tensor(np.asarray(offsets, dtype=np.int64),
                             device=device),
        ecd=aux_hermite(lq, table))


def aux_hermite(lq: int, table: torch.Tensor) -> torch.Tensor:
    """[nq, Kq, ncart(lq), nherm(lq)]: each aux primitive's Hermite
    expansion against the unit shell (``bra_hermite`` with the unit shell
    second, as the JAX package's host path expands it), times (-1)^|g|."""
    Kq = (table.shape[1] - 3) // 2
    qexp, qcoef, Q = table[:, :Kq], table[:, Kq:2 * Kq], table[:, 2 * Kq:]
    Ecd, _, _ = bra_hermite(lq, 0, qexp, torch.zeros_like(qexp[:, :1]),
                            qcoef, torch.ones_like(qcoef[:, :1]), Q, Q)
    _, sign = combine_tables(0, lq)
    return (Ecd * as_f64(sign, table.device)).contiguous()


@dataclass
class K1Pairs:
    """One pair class as K1 reads it: its PairTable with the rows sorted by
    their first output column (so that neighbouring lanes store into
    neighbouring columns), and per row its output columns cols, cols_t
    [n, nab] int64 and whether it is mirrored, mirror [n] uint8."""

    table: PairTable
    cols: torch.Tensor
    cols_t: torch.Tensor
    mirror: torch.Tensor


def k1_pairs(block: PairBlock, col_of, device) -> K1Pairs:
    """Pack a PairBlock for K1; col_of(ia, ib) maps basis-function indices
    to output columns.  The sort permutes the pairs only: every target is
    still written by one (pair, aux function)."""
    ia, ib = _pair_bf_indices_flat(block)
    cols = np.asarray(col_of(ia, ib), dtype=np.int64).reshape(block.n, -1)
    cols_t = np.asarray(col_of(ib, ia), dtype=np.int64).reshape(block.n, -1)
    order = np.argsort(cols[:, 0], kind="stable")
    blk = block.select(order)

    def dev(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    return K1Pairs(table=pair_table(blk, device),
                   cols=dev(cols[order], torch.int64),
                   cols_t=dev(cols_t[order], torch.int64),
                   mirror=dev(blk.ish != blk.jsh, torch.uint8))


def eri3c_class_plain(out, bra: PairTable, aux: AuxTable, cols, cols_t,
                      mirror):
    """Plain torch version of K1 (same arguments as ``eri3c_class``): the
    Boys function and R only for the primitive products of nonzero
    coefficients, as the kernel loops."""
    la, lb, lq = bra.la, bra.lb, aux.lq
    n, nq, Kq, ncq = bra.n, aux.nq, aux.Kq, ncart(lq)
    aexp, bexp, acoef, bcoef, A, B = bra.columns(slice(None))
    qexp, qcoef = aux.table[:, :Kq], aux.table[:, Kq:2 * Kq]
    Q = aux.table[:, 2 * Kq:]
    # the aux primitive's centre as the JAX host path forms it, from its
    # pair with the unit shell (exponent 0): (q Q + 0 Q) / q
    q = qexp + 0.0
    Qcen = (qexp[:, :, None] * Q[:, None, :] + 0.0 * Q[:, None, :]) \
        / q[:, :, None]
    Lb = la + lb
    L = Lb + lq
    comb, _ = combine_tables(Lb, lq)
    comb = torch.as_tensor(comb, dtype=torch.long, device=out.device)
    Eab, p, P = bra_hermite(la, lb, aexp, bexp, acoef, bcoef, A, B)
    live_b = live_pairs(acoef, bcoef)                    # [n, K2]
    live_q = qcoef != 0                                  # [nq, Kq]
    rows = aux.qrow[:, None] + torch.arange(ncq, device=out.device)[None, :]
    k2b = p.shape[1]
    work = k2b * nq * Kq * max(nherm(L), nherm(Lb) * nherm(lq))
    csize = max(1, int(_PLAIN_BUDGET / max(work, 1)))
    for s in range(0, n, csize):
        e = min(s + csize, n)
        PQ = P[s:e, :, None, None, :] - Qcen[None, None, :, :, :]
        psum = p[s:e, :, None, None] + q[None, None, :, :]
        alpha = p[s:e, :, None, None] * q[None, None, :, :] / psum
        Targ = alpha * torch.sum(PQ**2, dim=-1)
        pref = TWO_PI_POW_2_5 / (
            p[s:e, :, None, None] * q[None, None, :, :] * torch.sqrt(psum))
        live = live_b[s:e, :, None, None] & live_q[None, None, :, :]
        F = boys(Targ[live], L) * pref[live][:, None]
        R = Targ.new_zeros(Targ.shape + (nherm(L),))    # [Pc,K2b,Nq,Kq,nh]
        R[live] = r_tensor(L, alpha[live], PQ[live], F)
        T1 = torch.einsum("pkqrhg,qrcg->pkhqc", R[..., comb], aux.ecd)
        blk = torch.einsum("pkah,pkhqc->paqc", Eab[s:e], T1)   # [Pc,nab,Nq,ncq]
        blk = blk.to(out.dtype)
        r4 = rows[None, None, :, :].expand(blk.shape)
        out.index_put_((r4, cols[s:e, :, None, None].expand(blk.shape)),
                       blk, accumulate=True)
        m = mirror[s:e].bool()
        if bool(m.any()):
            bm = blk[m]
            out.index_put_((rows[None, None, :, :].expand(bm.shape),
                            cols_t[s:e][m][:, :, None, None].expand(bm.shape)),
                           bm, accumulate=True)


def eri3c_class(out, bra: PairTable, aux: AuxTable, cols, cols_t, mirror):
    """Kernel K1: (Q | ab) for one (la, lb | lq) class, written into
    ``out[aux.qrow[q] + c, cols[p, ab]]`` (and ``cols_t`` where
    ``mirror[p]``).

    out: [A, width] f64, or f32 (computed in f64, rounded at the store;
    counted as ``eri3c_f32``); bra: the pair class (``k1_pairs``' table);
    aux: the aux class (``aux_table``); cols/cols_t: [n, nab] int64;
    mirror: [n] uint8.  All on one device, contiguous.  Each class runs on
    the route of ``kernels.eri3c_route``."""
    la, lb, lq = bra.la, bra.lb, aux.lq
    n, nq = bra.n, aux.nq
    nab = ncart(la) * ncart(lb)
    if cols.shape != (n, nab) or cols_t.shape != (n, nab) \
            or mirror.shape != (n,) or aux.qrow.shape != (nq,) \
            or aux.kq.shape != (nq,) \
            or aux.table.shape[1] != 2 * aux.Kq + 3 \
            or aux.ecd.shape != (nq, aux.Kq, ncart(lq), nherm(lq)):
        raise ValueError("eri3c_class: inconsistent shapes")
    if out.dim() != 2:
        raise ValueError("eri3c_class: out must be [A, width]")
    if n == 0 or nq == 0:
        return
    if not out.is_cuda:
        eri3c_class_plain(out, bra, aux, cols, cols_t, mirror)
        return
    if (la, lb, lq) not in KERNEL_CLASSES:
        raise NotImplementedError(
            f"K1 is not instantiated for class ({la},{lb}|{lq}): it stops "
            "at g shells (l = 4)")
    if out.dtype not in (torch.float64, torch.float32):
        raise ValueError("eri3c_class: out must be f64 or f32")
    for t, dt in ((out, out.dtype), (bra.pair, torch.float64),
                  (bra.meta, torch.int32), (aux.table, torch.float64),
                  (aux.kq, torch.int32), (aux.qrow, torch.int64),
                  (aux.ecd, torch.float64), (cols, torch.int64),
                  (cols_t, torch.int64), (mirror, torch.uint8)):
        if t.dtype != dt or t.device != out.device or not t.is_contiguous():
            raise ValueError("eri3c_class: expected contiguous "
                             f"{dt} on {out.device}, got {t.dtype} on "
                             f"{t.device}")
    f32 = out.dtype == torch.float32
    kernels.launch("jc_eri3c", la, lb, lq, bra.pair.data_ptr(),
                   bra.meta.data_ptr(), n, bra.Ka, bra.Kb,
                   aux.table.data_ptr(), aux.kq.data_ptr(),
                   aux.qrow.data_ptr(), aux.ecd.data_ptr(), nq, aux.Kq,
                   cols.data_ptr(), cols_t.data_ptr(), mirror.data_ptr(),
                   out.data_ptr(), int(f32), out.stride(0),
                   count_as="eri3c_f32" if f32 else "eri3c",
                   cls=(la, lb, lq))


def eri3c_geometry(la: int, lb: int, lq: int, Ka: int, Kb: int,
                   Kq: int) -> dict:
    """K1's launch geometry for a class, as csrc/eri3c.cuh computes it: the
    route it was built with ("lane" or "block") and the block route's body
    ("t1": R across the block and T1 on DMMA; "thread"; None on the lane
    route), aux shells a block (QT; 1 on the lane route), threads and
    shared-memory bytes a block and the blocks an SM holds (CUDA's
    occupancy calculator).  Nothing is launched."""
    import ctypes

    if (la, lb, lq) not in KERNEL_CLASSES:
        raise NotImplementedError(f"K1 has no class ({la},{lb}|{lq})")
    out = (ctypes.c_longlong * 5)()
    lib = kernels.library()
    rc = lib.jc_eri3c_geometry(la, lb, lq, Ka, Kb, Kq, out)
    if rc != 0:
        raise RuntimeError(f"jc_eri3c_geometry failed: CUDA error {rc} "
                           f"({lib.jc_error_string(rc).decode()})")
    route, QT, threads, nbytes, blocks = list(out)
    return {"route": ("lane", "block", "block")[route],
            "body": (None, "thread", "t1")[route], "QT": QT,
            "threads": threads, "smem_bytes": nbytes,
            "blocks_per_sm": blocks}


def aux_unit_blocks(aux: Basis) -> list[PairBlock]:
    """Each auxiliary shell as the second shell of a pair whose first shell
    is the unit shell: bra blocks (0, lP) of the 2-center metric."""
    blocks = []
    for l, cl in sorted(aux.classes.items()):
        n = cl.nshell
        blocks.append(
            PairBlock(
                # ish == jsh: a unit pair is never mirrored
                la=0, lb=l,
                ish=cl.shell_idx, jsh=cl.shell_idx,
                aexp=np.zeros((n, 1)), bexp=cl.exps,
                acoef=np.ones((n, 1)), bcoef=cl.coefs,
                A=cl.centers, B=cl.centers,
                off_a=np.zeros(n, dtype=np.int64), off_b=cl.offsets,
            )
        )
    return blocks


def aux_tables(aux: Basis, device) -> list[AuxTable]:
    """Every aux class of the basis as K1 reads it (built once per build,
    before the class loop)."""
    return [aux_table(l, cl.exps, cl.coefs, cl.centers, cl.offsets, device)
            for l, cl in sorted(aux.classes.items())]


def _pair_bf_indices_flat(block: PairBlock):
    """Flattened per-pair component index arrays [n, nca*ncb]."""
    nca, ncb = block.nbf_block
    ia = block.off_a[:, None, None] + np.arange(nca)[None, :, None]
    ib = block.off_b[:, None, None] + np.arange(ncb)[None, None, :]
    ia = np.broadcast_to(ia, (block.n, nca, ncb)).reshape(block.n, -1)
    ib = np.broadcast_to(ib, (block.n, nca, ncb)).reshape(block.n, -1)
    return ia, ib


def _fill(out, pair_blocks, auxs, col_of) -> None:
    """Run K1 for every (pair class, aux class); col_of(ia, ib) maps basis
    function indices to output columns."""
    for blk in pair_blocks:
        if blk.n == 0:
            continue
        kp = k1_pairs(blk, col_of, out.device)
        for aux in auxs:
            eri3c_class(out, kp.table, aux, kp.cols, kp.cols_t, kp.mirror)


def two_center_metric(aux: Basis, device) -> torch.Tensor:
    """(P|Q) Coulomb metric over the auxiliary basis
    (TwoCenterIntegrals.jl analog): [A, A] f64 on ``device``."""
    A = aux.nbf
    out = torch.zeros((A, A), dtype=torch.float64, device=device)
    # bra (unit, P): the column of (P|Q) is P's function index
    _fill(out, aux_unit_blocks(aux), aux_tables(aux, device),
          lambda ia, ib: ib)
    return out


def three_center_tensor(
    primary: Basis,
    aux: Basis,
    device,
    pair_blocks: list[PairBlock] | None = None,
    col_map: np.ndarray | None = None,
    packed_width: int | None = None,
    out_dtype: torch.dtype = torch.float64,
    col_range: tuple[int, int] | None = None,
) -> torch.Tensor:
    """(Q | mu nu) integrals, accumulated on ``device`` in ``out_dtype``
    (f64, or f32: computed in f64 and rounded at the store, so an f32 B is
    never allocated in f64).

    pair_blocks may be pre-screened unique pair blocks; default is all
    unique pairs.  Both (mu,nu) and (nu,mu) entries are filled.

    Dense mode (col_map None): returns (A, nbf, nbf).
    Packed mode: col_map is an int64 [nbf*nbf] host lookup mapping flat
    (mu,nu) to a packed screened-pq column, with screened-out entries
    pointing at a trash column npq = col_map.max(); returns (A, npq+1) with
    the trash column zeroed.
    Packed mode with ``col_range`` (c0, c1), c1 <= npq: the packed columns
    [c0, c1) alone, as (A, c1 - c0 + 1) with a zero trash column last.  K1
    runs only for the pairs with an output column in the range, chosen on
    the host; their other columns go to the local trash column, which is
    zeroed after (K1's plain stores race there harmlessly: every column of
    the range is still written by exactly one (pair, aux function)).
    """
    A, nbf = aux.nbf, primary.nbf
    if pair_blocks is None:
        pair_blocks = unique_pair_blocks(primary)
    packed = col_map is not None
    if col_range is not None:
        if not packed:
            raise ValueError("three_center_tensor: col_range needs col_map")
        c0, c1 = col_range
        trash = c1 - c0
        pair_blocks = [b for b in (_pairs_in_range(b, col_map, nbf, c0, c1)
                                   for b in pair_blocks) if b.n]

        def col_of(ia, ib):
            g = col_map[ia * nbf + ib]
            return np.where((g >= c0) & (g < c1), g - c0, trash)

        out = torch.zeros((A, trash + 1), dtype=out_dtype, device=device)
        _fill(out, pair_blocks, aux_tables(aux, device), col_of)
        out[:, -1] = 0.0
        return out
    if packed:
        width = packed_width if packed_width is not None else int(col_map.max()) + 1
    else:
        width = nbf * nbf
    out = torch.zeros((A, width), dtype=out_dtype, device=device)

    def col_of(ia, ib):
        flat = ia * nbf + ib
        return col_map[flat] if packed else flat

    _fill(out, pair_blocks, aux_tables(aux, device), col_of)
    if packed:
        out[:, -1] = 0.0  # trash column (screened-out scatter target)
        return out
    return out.reshape(A, nbf, nbf)


def _pairs_in_range(block: PairBlock, col_map, nbf: int, c0: int,
                    c1: int) -> PairBlock:
    """The pairs of ``block`` that K1 writes into a packed column in [c0,
    c1): through cols, or through cols_t where the pair is mirrored."""
    ia, ib = _pair_bf_indices_flat(block)

    def hit(cols):
        return ((cols >= c0) & (cols < c1)).any(axis=1)

    keep = hit(col_map[ia * nbf + ib])
    mirror = block.ish != block.jsh
    keep[mirror] |= hit(col_map[ib[mirror] * nbf + ia[mirror]])
    return block.select(keep)
