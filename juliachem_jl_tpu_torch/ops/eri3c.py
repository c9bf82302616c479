"""3-center (Q|mu nu) and 2-center (P|Q) integrals for density fitting.

Port of ``juliachem_jl_tpu/ops/eri3c.py``.  Both reduce to one class kernel
over (bra shell pair) x (auxiliary shell): a bra pair against an aux shell
with a "unit" partner (exponent 0, coefficient 1 — the reference's xs_xx
trick).  The 2-center metric runs the same kernel with a unit shell as the
first bra shell, so its bra class is (0, lP).

``eri3c_class`` is the wrapper of kernel K1 (csrc/eri3c*.cu): on a CUDA
output it launches the kernel, which writes straight into the device-resident
B; on a CPU output it runs ``eri3c_class_plain``, the torch form of the JAX
package's host path (``_three_center_host``).  Every (aux row, column) target
is written by exactly one (pair, aux function), so both plain stores (kernel)
and accumulation into a zeroed B (plain) are exact.
"""

from __future__ import annotations

import numpy as np
import torch

from ..basis.structs import Basis, ncart
from . import kernels
from .boys import boys
from .class_tables import combine_tables, nherm
from .eri import TWO_PI_POW_2_5, as_f64, bra_hermite
from .mcmurchie import r_tensor
from .pairs import PairBlock, unique_pair_blocks

# (la, lb, lq) classes compiled into K1: la <= lb <= 2 primary pairs against
# aux shells up to g, plus the (0, lP) unit bra of the 2-center metric
KERNEL_CLASSES = frozenset(
    (la, lb, lq)
    for la, lb in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2), (0, 3), (0, 4))
    for lq in range(5))

# plain version: elements of the largest [Pc, K2, Nq, Kq, ...] intermediate
# per pair chunk
_PLAIN_BUDGET = 2.0e7


def pack_pairs(blk: PairBlock, device) -> torch.Tensor:
    """[n, 2Ka+2Kb+6] f64: aexp | acoef | bexp | bcoef | A | B."""
    return as_f64(np.concatenate([blk.aexp, blk.acoef, blk.bexp, blk.bcoef,
                                  blk.A, blk.B], axis=1), device)


def pack_aux(exps, coefs, centers, device) -> torch.Tensor:
    """[nq, 2Kq+3] f64: qexp | qcoef | Q."""
    return as_f64(np.concatenate([exps, coefs, centers], axis=1), device)


def eri3c_class_plain(out, la, lb, lq, Ka, Kb, pair, aux, qrow, cols, cols_t,
                      mirror):
    """Plain torch version of K1 (same arguments as ``eri3c_class``)."""
    Kq = (aux.shape[1] - 3) // 2
    n, nq, ncq = pair.shape[0], aux.shape[0], ncart(lq)
    o = np.cumsum([0, Ka, Ka, Kb, Kb, 3, 3])
    aexp, acoef, bexp, bcoef, A, B = (pair[:, o[i]:o[i + 1]] for i in range(6))
    qexp, qcoef, Q = aux[:, :Kq], aux[:, Kq:2 * Kq], aux[:, 2 * Kq:]
    Lb = la + lb
    L = Lb + lq
    comb, sign = combine_tables(Lb, lq)
    comb = torch.as_tensor(comb, dtype=torch.long, device=out.device)
    sign = as_f64(sign, out.device)
    Eab, p, P = bra_hermite(la, lb, aexp, bexp, acoef, bcoef, A, B)
    # the unit partner is ONE primitive (exponent 0, coefficient 1); giving
    # it Kq primitives, as juliachem_jl_tpu/ops/eri3c.py:168,570 does,
    # counts a contracted aux shell Kq times (ROADMAP.md C7)
    Ecd, q, Qcen = bra_hermite(lq, 0, qexp, torch.zeros_like(qexp[:, :1]),
                               qcoef, torch.ones_like(qcoef[:, :1]), Q, Q)
    rows = qrow[:, None] + torch.arange(ncq, device=out.device)[None, :]
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
        F = boys(Targ, L) * pref[..., None]
        R = r_tensor(L, alpha, PQ, F)                # [Pc,K2b,Nq,Kq,nherm]
        M = R[..., comb] * sign[None, None, None, None, :]
        T1 = torch.einsum("pkqrhg,qrcg->pkhqc", M, Ecd)
        blk = torch.einsum("pkah,pkhqc->paqc", Eab[s:e], T1)   # [Pc,nab,Nq,ncq]
        r4 = rows[None, None, :, :].expand(blk.shape)
        out.index_put_((r4, cols[s:e, :, None, None].expand(blk.shape)),
                       blk, accumulate=True)
        m = mirror[s:e].bool()
        if bool(m.any()):
            bm = blk[m]
            out.index_put_((rows[None, None, :, :].expand(bm.shape),
                            cols_t[s:e][m][:, :, None, None].expand(bm.shape)),
                           bm, accumulate=True)


def eri3c_class(out, la, lb, lq, Ka, Kb, pair, aux, qrow, cols, cols_t,
                mirror):
    """Kernel K1: (Q | ab) for one (la, lb | lq) class, written into
    ``out[qrow[q] + c, cols[p, ab]]`` (and ``cols_t`` where ``mirror[p]``).

    out: [A, width] f64; pair: [n, 2Ka+2Kb+6] (``pack_pairs``); aux:
    [nq, 2Kq+3] (``pack_aux``); qrow: [nq] int64; cols/cols_t: [n, nab]
    int64; mirror: [n] uint8.  All on one device, contiguous."""
    n, nq = pair.shape[0], aux.shape[0]
    nab = ncart(la) * ncart(lb)
    if pair.shape[1] != 2 * Ka + 2 * Kb + 6 or cols.shape != (n, nab) \
            or cols_t.shape != (n, nab) or mirror.shape != (n,) \
            or qrow.shape != (nq,) or (aux.shape[1] - 3) % 2:
        raise ValueError("eri3c_class: inconsistent shapes")
    if out.dim() != 2:
        raise ValueError("eri3c_class: out must be [A, width]")
    if n == 0 or nq == 0:
        return
    if not out.is_cuda:
        eri3c_class_plain(out, la, lb, lq, Ka, Kb, pair, aux, qrow, cols,
                          cols_t, mirror)
        return
    if (la, lb, lq) not in KERNEL_CLASSES:
        raise NotImplementedError(
            f"K1 is not instantiated for class ({la},{lb}|{lq})")
    for t, dt in ((out, torch.float64), (pair, torch.float64),
                  (aux, torch.float64), (qrow, torch.int64),
                  (cols, torch.int64), (cols_t, torch.int64),
                  (mirror, torch.uint8)):
        if t.dtype != dt or t.device != out.device or not t.is_contiguous():
            raise ValueError("eri3c_class: expected contiguous "
                             f"{dt} on {out.device}, got {t.dtype} on "
                             f"{t.device}")
    kernels.launch("jc_eri3c", la, lb, lq, pair.data_ptr(), n, Ka, Kb,
                   aux.data_ptr(), qrow.data_ptr(), nq, (aux.shape[1] - 3) // 2,
                   cols.data_ptr(), cols_t.data_ptr(), mirror.data_ptr(),
                   out.data_ptr(), out.stride(0))


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


def _aux_classes(aux: Basis, device):
    """Per aux class: (lq, packed shells, first row of each shell)."""
    return [(l, pack_aux(cl.exps, cl.coefs, cl.centers, device),
             torch.as_tensor(cl.offsets, dtype=torch.int64, device=device))
            for l, cl in sorted(aux.classes.items())]


def _pair_bf_indices_flat(block: PairBlock):
    """Flattened per-pair component index arrays [n, nca*ncb]."""
    nca, ncb = block.nbf_block
    ia = block.off_a[:, None, None] + np.arange(nca)[None, :, None]
    ib = block.off_b[:, None, None] + np.arange(ncb)[None, None, :]
    ia = np.broadcast_to(ia, (block.n, nca, ncb)).reshape(block.n, -1)
    ib = np.broadcast_to(ib, (block.n, nca, ncb)).reshape(block.n, -1)
    return ia, ib


def _fill(out, pair_blocks, aux_classes, col_of) -> None:
    """Run K1 for every (pair class, aux class); col_of(ia, ib) maps basis
    function indices to output columns."""
    dev = out.device
    for blk in pair_blocks:
        if blk.n == 0:
            continue
        ia, ib = _pair_bf_indices_flat(blk)
        cols, cols_t = (torch.as_tensor(np.array(col_of(i, j)),
                                        dtype=torch.int64, device=dev)
                        for i, j in ((ia, ib), (ib, ia)))
        mirror = torch.as_tensor(blk.ish != blk.jsh, dtype=torch.uint8,
                                 device=dev)
        pair = pack_pairs(blk, dev)
        for lq, aux_t, qrow in aux_classes:
            eri3c_class(out, blk.la, blk.lb, lq, blk.aexp.shape[1],
                        blk.bexp.shape[1], pair, aux_t, qrow, cols, cols_t,
                        mirror)


def two_center_metric(aux: Basis, device) -> torch.Tensor:
    """(P|Q) Coulomb metric over the auxiliary basis
    (TwoCenterIntegrals.jl analog): [A, A] f64 on ``device``."""
    A = aux.nbf
    out = torch.zeros((A, A), dtype=torch.float64, device=device)
    # bra (unit, P): the column of (P|Q) is P's function index
    _fill(out, aux_unit_blocks(aux), _aux_classes(aux, device),
          lambda ia, ib: ib)
    return out


def three_center_tensor(
    primary: Basis,
    aux: Basis,
    device,
    pair_blocks: list[PairBlock] | None = None,
    col_map: np.ndarray | None = None,
    packed_width: int | None = None,
) -> torch.Tensor:
    """(Q | mu nu) integrals, accumulated on ``device``.

    pair_blocks may be pre-screened unique pair blocks; default is all
    unique pairs.  Both (mu,nu) and (nu,mu) entries are filled.

    Dense mode (col_map None): returns (A, nbf, nbf).
    Packed mode: col_map is an int64 [nbf*nbf] host lookup mapping flat
    (mu,nu) to a packed screened-pq column, with screened-out entries
    pointing at a trash column npq = col_map.max(); returns (A, npq+1) with
    the trash column zeroed.
    """
    A, nbf = aux.nbf, primary.nbf
    if pair_blocks is None:
        pair_blocks = unique_pair_blocks(primary)
    packed = col_map is not None
    if packed:
        width = packed_width if packed_width is not None else int(col_map.max()) + 1
    else:
        width = nbf * nbf
    out = torch.zeros((A, width), dtype=torch.float64, device=device)

    def col_of(ia, ib):
        flat = ia * nbf + ib
        return col_map[flat] if packed else flat

    _fill(out, pair_blocks, _aux_classes(aux, device), col_of)
    if packed:
        out[:, -1] = 0.0  # trash column (screened-out scatter target)
        return out
    return out.reshape(A, nbf, nbf)
