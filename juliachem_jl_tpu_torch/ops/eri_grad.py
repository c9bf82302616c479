"""First-derivative 4-center ERIs and the two-electron gradient terms.

Port of ``juliachem_jl_tpu/ops/eri_grad.py`` as batched torch on the
calculation's device (the JAX package runs these on host numpy).  Built on
the class-batched McMurchie-Davidson factorization of ops/eri.py with the
derivative identity applied inside the contraction (ops/oei_grad.py):

    d/dAx (ab|cd) = 2a (a+1x,b|cd) - ax (a-1x,b|cd)

exact for the contracted integral.  Differentiating a bra component raises
the Hermite order by one, so R runs to L+1 and the bra combination table is
combine_tables(L_bra+1, L_ket); likewise for B and C.  The fourth center
comes from translational invariance: dD = -(dA + dB + dC).

Conventional: the permutation-symmetrized two-particle density

    G~_mnls = 1/2 D_mn D_ls - 1/8 (D_ml D_ns + D_ms D_nl)

over every ordered pair of unique shell-pair blocks, Schwarz-screened, each
side weighted by its pair weight (2 - delta); every class pair is
evaluated for its shell pairs grouped by whether each shell is contracted
(``live_groups``): an uncontracted shell never carries the padding of its
class's most contracted one.  Batches are sized by bytes (``_budget``), and
the per-atom sums are ``index_add_`` on the device.

Density fitting: the fit algebra on the dense (A|pq) that kernel K1 builds
(``ops/eri3c.py::three_center_tensor``), then the 3-center derivative over
every (aux shell, unique primary pair) and the metric derivative over the
unordered pairs of aux shells on two atoms, contracted with gamma and
Omega as they are computed: kernel K11 (csrc/eri3c_grad.cuh) on the card,
its plain version (the same tables, ``eri_grad_class`` on each primitive
product) on the CPU.
"""

from __future__ import annotations

from collections import Counter
from functools import lru_cache

import numpy as np
import torch

from ..basis.structs import Basis, axial_normalization, ncart
from .boys import boys_rows
from .class_tables import combine_tables, nherm
from .eri import TWO_PI_POW_2_5, as_f64
from .mcmurchie import e_dense, pair_primitive_data, r_tensor
from .oei_grad import component_tables, expansion
from .pairs import PairBlock, unique_pair_blocks


def _budget(device) -> float:
    """Elements of the largest per-batch intermediate: ~0.8 GB of f64 on
    the card, ~0.16 GB on the CPU."""
    return 1.0e8 if torch.device(device).type == "cuda" else 2.0e7


@lru_cache(maxsize=None)
def _class_tables(la, lb, lc, ld, device: torch.device):
    """The constant tensors of one class of ``eri_grad_class`` on the
    device, built once: axial norms, the derivative weights (each
    component's angular momentum per dimension) and the bra- and ket-side
    R combination maps with their signs."""
    Lb, Lk = la + lb, lc + ld

    def f64(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               device=device)

    def weights(l1, l2):
        ia, ib = component_tables(l1, l2)
        return ([f64(ia[d])[None, None, :, :, None] for d in range(3)],
                [f64(ib[d])[None, None, :, :, None] for d in range(3)])

    def comb(L1, L2):
        c, sign = combine_tables(L1, L2)
        return (torch.as_tensor(c, dtype=torch.long, device=device),
                f64(sign)[None, None, None, None, :])

    return {
        "ax_b": f64(np.outer(axial_normalization(la),
                             axial_normalization(lb)).reshape(-1)),
        "ax_k": f64(np.outer(axial_normalization(lc),
                             axial_normalization(ld)).reshape(-1)),
        "w_b": weights(la, lb), "w_k": weights(lc, ld),
        "bra": comb(Lb + 1, Lk),    # bra-side derivative
        "ket": comb(Lb, Lk + 1),    # ket-side derivative
    }


def eri_grad_class(la, lb, lc, ld, aexp, bexp, acoef, bcoef, A, B,
                   cexp, dexp, ccoef, dcoef, C, D, need_b: bool = True,
                   work: Counter | None = None):
    """Per-quartet derivative blocks (dA, dB, dC), each [N, 3, nab, ncd]
    (the JAX package's ``_eri_grad_kernel``); dB is None when not
    ``need_b`` (a unit partner's derivative is zero).  dD = -(dA + dB + dC)
    is left to the caller.  The quartets are counted into ``work`` under
    ("eri", la, lb, lc, ld, K2b, K2k) when given."""
    tab = _class_tables(la, lb, lc, ld, aexp.device)
    (wa, wb), (wc, _) = tab["w_b"], tab["w_k"]
    Lb, Lk = la + lb, lc + ld
    nab, ncd = ncart(la) * ncart(lb), ncart(lc) * ncart(ld)
    ax_b, ax_k = tab["ax_b"], tab["ax_k"]

    def fold(Eexp, ax, cc):
        # [N,K2,na,nb,nh] -> [N,K2,na*nb,nh] with axial norms + coefficients
        N, K2 = Eexp.shape[:2]
        out = Eexp.reshape(N, K2, -1, Eexp.shape[-1])
        return out * ax[None, None, :, None] * cc[:, :, None, None]

    def combined(R, side):
        comb, sign = tab[side]
        return R[..., comb] * sign

    if work is not None:
        work[("eri", la, lb, lc, ld, aexp.shape[1] * bexp.shape[1],
              cexp.shape[1] * dexp.shape[1])] += aexp.shape[0]
    prim_b = pair_primitive_data(aexp, bexp, acoef, bcoef, A, B)
    prim_k = pair_primitive_data(cexp, dexp, ccoef, dcoef, C, D)
    Eb = e_dense(la + 1, lb + 1, prim_b)
    Ek = e_dense(lc + 1, ld + 1, prim_k)
    p, q = prim_b["p"], prim_k["p"]
    cc_b, cc_k = prim_b["cc"], prim_k["cc"]

    PQ = prim_b["P"][:, :, None, :] - prim_k["P"][:, None, :, :]
    psum = p[:, :, None] + q[:, None, :]
    alpha = p[:, :, None] * q[:, None, :] / psum
    Targ = alpha * torch.sum(PQ**2, dim=-1)
    pref = TWO_PI_POW_2_5 / (p[:, :, None] * q[:, None, :] * torch.sqrt(psum))
    F = boys_rows(Targ, Lb + Lk + 1) * pref[..., None]
    R = r_tensor(Lb + Lk + 1, alpha, PQ, F)       # [N,K2b,K2k,nherm(L+1)]

    # ---- bra-center derivatives (A, B) -----------------------------------
    Ecd0 = fold(expansion(Ek, lc, ld, Lk), ax_k, cc_k)
    T1 = torch.einsum("nqkhg,nkcg->nqhc", combined(R, "bra"), Ecd0)
    a2 = (2.0 * prim_b["a"])[:, :, None, None, None]
    b2 = (2.0 * prim_b["b"])[:, :, None, None, None]
    N = Targ.shape[0]
    dA = Targ.new_empty((N, 3, nab, ncd))
    dB = Targ.new_empty((N, 3, nab, ncd)) if need_b else None
    for d in range(3):
        dE_A = fold(a2 * expansion(Eb, la, lb, Lb + 1, d, +1, "bra")
                    - wa[d] * expansion(Eb, la, lb, Lb + 1, d, -1, "bra"),
                    ax_b, cc_b)
        dA[:, d] = torch.einsum("nqah,nqhc->nac", dE_A, T1)
        if need_b:
            dE_B = fold(b2 * expansion(Eb, la, lb, Lb + 1, d, +1, "ket")
                        - wb[d] * expansion(Eb, la, lb, Lb + 1, d, -1, "ket"),
                        ax_b, cc_b)
            dB[:, d] = torch.einsum("nqah,nqhc->nac", dE_B, T1)
    del T1

    # ---- ket-center derivative (C) ---------------------------------------
    Eab0 = fold(expansion(Eb, la, lb, Lb), ax_b, cc_b)
    S = torch.einsum("nqah,nqkhg->nkag", Eab0, combined(R, "ket"))
    c2 = (2.0 * prim_k["a"])[:, :, None, None, None]
    dC = torch.empty_like(dA)
    for d in range(3):
        dE_C = fold(c2 * expansion(Ek, lc, ld, Lk + 1, d, +1, "bra")
                    - wc[d] * expansion(Ek, lc, ld, Lk + 1, d, -1, "bra"),
                    ax_k, cc_k)
        dC[:, d] = torch.einsum("nkag,nkcg->nac", S, dE_C)
    return dA, dB, dC


def _quartet_work(la, lb, lc, ld, K2b: int, K2k: int) -> int:
    """Elements of the largest per-quartet intermediate of
    ``eri_grad_class``."""
    Lb, Lk = la + lb, lc + ld
    nab, ncd = ncart(la) * ncart(lb), ncart(lc) * ncart(ld)
    return (K2b * K2k * max(nherm(Lb + Lk + 1), nherm(Lb + 1) * nherm(Lk),
                            nherm(Lb) * nherm(Lk + 1))
            + K2b * nab * nherm(Lb + 1) + K2k * ncd * nherm(Lk + 1))


def batch_size(la, lb, lc, ld, K2b: int, K2k: int, device) -> int:
    """Quartets per batch of ``eri_grad_class`` for the device's budget."""
    return max(1, int(_budget(device)
                      / _quartet_work(la, lb, lc, ld, K2b, K2k)))


def live_groups(blk: PairBlock) -> list[tuple[np.ndarray, PairBlock]]:
    """The rows of a pair block in up to four groups, by whether each shell
    is contracted (more than one primitive of nonzero coefficient): for
    each group its row indices into ``blk`` and the block of those rows
    with each shell's primitives of nonzero coefficient first, trimmed to
    the group's largest live count.  So an uncontracted shell never carries
    the padding of its class's most contracted one, and the groups stay
    few: each is a stream of batches, and on the card the batches of a
    small system are bound by their launches."""

    def nonzero_first(exps, coefs):
        order = np.argsort(coefs == 0.0, axis=1, kind="stable")
        return (np.take_along_axis(exps, order, 1),
                np.take_along_axis(coefs, order, 1),
                np.maximum((coefs != 0.0).sum(axis=1), 1))

    aexp, acoef, ka = nonzero_first(blk.aexp, blk.acoef)
    bexp, bcoef, kb = nonzero_first(blk.bexp, blk.bcoef)
    out = []
    for ca in (False, True):
        for cb in (False, True):
            rows = np.nonzero(((ka > 1) == ca) & ((kb > 1) == cb))[0]
            if not len(rows):
                continue
            na, nb = int(ka[rows].max()), int(kb[rows].max())
            out.append((rows, PairBlock(
                la=blk.la, lb=blk.lb, ish=blk.ish[rows], jsh=blk.jsh[rows],
                aexp=aexp[rows, :na], bexp=bexp[rows, :nb],
                acoef=acoef[rows, :na], bcoef=bcoef[rows, :nb],
                A=blk.A[rows], B=blk.B[rows], off_a=blk.off_a[rows],
                off_b=blk.off_b[rows])))
    return out


class _Side:
    """One pair block's columns on the device, for gathering quartets."""

    def __init__(self, blk: PairBlock, device, atom_of):
        self.blk = blk
        self.cols = [as_f64(x, device) for x in
                     (blk.aexp, blk.bexp, blk.acoef, blk.bcoef, blk.A, blk.B)]
        def t(x):
            return torch.as_tensor(np.asarray(x, dtype=np.int64),
                                   device=device)

        self.off_a, self.off_b = t(blk.off_a), t(blk.off_b)
        self.atom_a = t(atom_of[blk.ish])
        self.atom_b = t(atom_of[np.maximum(blk.jsh, 0)])
        self.w = (t(blk.ish != blk.jsh) + 1).to(torch.float64)
        self.nc = blk.nbf_block
        self.K2 = blk.aexp.shape[1] * blk.bexp.shape[1]

    def take(self, sel):
        return [x[sel] for x in self.cols]

    def rows(self, sel, which: str):
        """[n, nc] basis-function indices of the first or second shell."""
        off, nc = ((self.off_a, self.nc[0]) if which == "a"
                   else (self.off_b, self.nc[1]))
        return off[sel][:, None] + torch.arange(nc, device=off.device)[None]


def two_electron_gradient(basis: Basis, mol, D: torch.Tensor,
                          cutoff: float = 1.0e-11, spin_densities=None,
                          work: Counter | None = None) -> torch.Tensor:
    """dE_2e/dR [natom, 3] on D's device: Schwarz-screened contraction of
    the derivative quartet blocks with the symmetrized two-particle density
    G~ (module docstring), over every ordered pair of unique shell-pair
    blocks, so each side needs only its own pair weight (2 - delta).

    spin_densities=(Da, Db) switches to the UHF two-particle density
    (factor-1 spin densities; D must then be the total Da+Db):
        G~ = 1/2 Dt_mn Dt_ls - 1/4 sum_s (Ds_ml Ds_ns + Ds_ms Ds_nl)
    which reduces to the closed-shell expression for Da = Db = D/2.
    ``work`` counts the quartets evaluated (``eri_grad_class``)."""
    from .schwarz import pair_schwarz

    device = D.device
    grad = torch.zeros((mol.natom, 3), dtype=torch.float64, device=device)
    atom_of = np.asarray(basis.shell_atom)
    blocks = unique_pair_blocks(basis)
    # the Schwarz bound of each pair (K4's diagonal quartets on the card)
    bounds = [pair_schwarz(blk, device).cpu().numpy() for blk in blocks]
    d_scale = max(float(D.abs().max()), 1e-30) ** 2
    sides = [[(rows, _Side(g, device, atom_of))
              for rows, g in live_groups(blk)] for blk in blocks]
    exch_mats = ([D] if spin_densities is None else list(spin_densities))
    exch_w = 0.125 if spin_densities is None else 0.25

    for bi in range(len(blocks)):
        for bj in range(len(blocks)):
            for rows_b, bra in sides[bi]:
                qb = bounds[bi][rows_b]
                for rows_k, ket in sides[bj]:
                    qk = bounds[bj][rows_k]
                    ii, jj = np.nonzero(
                        qb[:, None] * qk[None, :] * d_scale > cutoff)
                    if len(ii) == 0:
                        continue
                    _quartet_grad(grad, D, exch_mats, exch_w, bra, ket,
                                  torch.as_tensor(ii, device=device),
                                  torch.as_tensor(jj, device=device), work)
    return grad


def _quartet_grad(grad, D, exch_mats, exch_w, bra: _Side, ket: _Side, ii, jj,
                  work):
    """Add the quartets (bra[ii], ket[jj]) of one group pair to grad."""
    b, k = bra.blk, ket.blk
    nca, ncb = bra.nc
    ncc, ncd = ket.nc
    size = batch_size(b.la, b.lb, k.la, k.lb, bra.K2, ket.K2, D.device)
    for s in range(0, ii.numel(), size):
        ib, ik = ii[s:s + size], jj[s:s + size]
        n = ib.numel()
        dA, dB, dC = eri_grad_class(b.la, b.lb, k.la, k.lb, *bra.take(ib),
                                    *ket.take(ik), work=work)
        oa, ob = bra.rows(ib, "a"), bra.rows(ib, "b")
        oc, od = ket.rows(ik, "a"), ket.rows(ik, "b")
        D_mn = D[oa[:, :, None], ob[:, None, :]].reshape(n, -1)
        D_ls = D[oc[:, :, None], od[:, None, :]].reshape(n, -1)
        gam = 0.5 * D_mn[:, :, None] * D_ls[:, None, :]
        for M in exch_mats:
            M_ml = M[oa[:, :, None, None, None], oc[:, None, None, :, None]]
            M_ns = M[ob[:, None, :, None, None], od[:, None, None, None, :]]
            M_ms = M[oa[:, :, None, None, None], od[:, None, None, None, :]]
            M_nl = M[ob[:, None, :, None, None], oc[:, None, None, :, None]]
            gam = gam - exch_w * (M_ml * M_ns + M_ms * M_nl).reshape(
                n, nca * ncb, ncc * ncd)
        w = (bra.w[ib] * ket.w[ik])[:, None]
        fA = w * torch.einsum("nac,ndac->nd", gam, dA)
        fB = w * torch.einsum("nac,ndac->nd", gam, dB)
        fC = w * torch.einsum("nac,ndac->nd", gam, dC)
        fD = -(fA + fB + fC)
        grad.index_add_(0, bra.atom_a[ib], fA)
        grad.index_add_(0, bra.atom_b[ib], fB)
        grad.index_add_(0, ket.atom_a[ik], fC)
        grad.index_add_(0, ket.atom_b[ik], fD)


# ---------------------------------------------------------------------------
# Density-fitted (RI) two-electron gradient
# ---------------------------------------------------------------------------


def aux_unit_blocks(aux: Basis) -> list[PairBlock]:
    """Each auxiliary shell first, a unit s shell second (exponent 0,
    coefficient 1): the bra of the 3-center and metric derivatives (the
    JAX package's ``ops/eri3c.py::aux_unit_blocks``).  The unit shell's
    derivative vanishes identically, so the aux center's derivative is the
    kernel's bra-A one."""
    blocks = []
    for l, cl in sorted(aux.classes.items()):
        n = cl.nshell
        blocks.append(PairBlock(
            la=l, lb=0, ish=cl.shell_idx, jsh=np.full(n, -1),
            aexp=cl.exps, bexp=np.zeros((n, 1)), acoef=cl.coefs,
            bcoef=np.ones((n, 1)), A=cl.centers, B=cl.centers,
            off_a=cl.offsets, off_b=np.zeros(n, dtype=np.int64)))
    return blocks


def dense_three_center(primary: Basis, aux: Basis, device) -> torch.Tensor:
    """(A|pq) [naux, nbf, nbf] on ``device`` over every unique primary pair,
    unscreened (the JAX package's ``_dense_three_center``): kernel K1 in
    dense mode on the card, its plain version on the CPU."""
    from .eri3c import three_center_tensor

    return three_center_tensor(primary, aux, device)


def df_fit_terms(P3: torch.Tensor, M: torch.Tensor, D: torch.Tensor,
                 spin_densities=None):
    """The fit algebra of the RI gradient: (gamma [A, nbf, nbf], Omega
    [A, A]) with gamma = M^-1 U and Omega = sym(M^-1 (P3 gamma^T)), from the
    (fitted-space) 3-center rows P3 [A, nbf, nbf] and metric M [A, A]:

        U_A = 1/2 (P3_A . D) D - 1/4 D P3_A D,  or for spin densities
        U_A = 1/2 (P3_A . Dt) Dt - 1/2 sum_s Ds P3_A Ds.

    D P3_A D is two batched products.  One LU factorisation of M serves
    both solves: gamma is solved by column chunks back into U's storage,
    and Omega is one [A, A] product P3 gamma^T then a solve on [A, A] (the
    JAX package solves M with U and with P3, (M^-1 P3) gamma^T: the same
    numbers).  So no more than two A x nbf^2 tensors, P3 and U, are alive
    at once (w32's Cartesian (A|pq) is 23 GB)."""
    A, nbf = P3.shape[0], P3.shape[1]
    P3f = P3.reshape(A, -1)
    v = P3f @ D.reshape(-1)
    U = torch.empty_like(P3)
    rows = max(1, int(_budget(P3.device) / (nbf * nbf)))
    for s in range(0, A, rows):
        blk = P3[s:s + rows]
        if spin_densities is None:
            U[s:s + rows] = (0.5 * v[s:s + rows, None, None] * D[None]
                             - 0.25 * (D @ blk @ D))
        else:
            Da, Db = spin_densities
            U[s:s + rows] = (0.5 * v[s:s + rows, None, None] * D[None]
                             - 0.5 * (Da @ blk @ Da + Db @ blk @ Db))
    lu = torch.linalg.lu_factor(M)
    Uf = U.reshape(A, -1)
    cols = max(1, int(_budget(P3.device) / A))
    for c in range(0, Uf.shape[1], cols):
        Uf[:, c:c + cols] = torch.linalg.lu_solve(*lu, Uf[:, c:c + cols])
    Omega = torch.linalg.lu_solve(*lu, P3f @ Uf.T)     # M^-1 (P3 gamma^T)
    Omega = 0.5 * (Omega + Omega.T)
    return U, Omega


def df_gamma_omega(primary: Basis, aux: Basis, D: torch.Tensor,
                   spin_densities=None, sph_aux: bool = True, lap=None):
    """gamma [A, nbf, nbf] and Omega [A, A] of the DF gradient at D, in
    Cartesian aux rows, on D's device: K1's dense (A|pq) and the metric,
    projected to the solid-harmonic aux space when ``sph_aux`` (and the
    aux set has a d shell or higher), ``df_fit_terms``, then lifted back.
    P3 is dropped before the lift, and the lift goes by column chunks
    (``_budget``), so that no more than two A x nbf^2 tensors are alive at
    once.  ``lap(key)``, when given, is called after "three_center",
    "metric" and "fit"."""
    from ..basis.spherical import (aux_needs_sph, lift_rows_sph,
                                   project_metric_sph, project_rows_sph_)
    from .eri3c import two_center_metric

    lap = lap or (lambda key: None)
    device = D.device
    nbf, naux = primary.nbf, aux.nbf
    P3 = dense_three_center(primary, aux, device)
    lap("three_center")
    M = two_center_metric(aux, device)
    lap("metric")
    sph = sph_aux and aux_needs_sph(aux)
    if sph:
        P3 = project_rows_sph_(aux, P3.reshape(naux, -1)).reshape(-1, nbf, nbf)
        M = project_metric_sph(aux, M)
    gamma, Omega = df_fit_terms(P3, M, D, spin_densities)
    del P3, M
    if sph:
        gamma = lift_rows_sph(aux, gamma,
                              cols=int(_budget(device) / naux))
        Omega = lift_rows_sph(aux, lift_rows_sph(aux, Omega).T.contiguous())
    gamma, Omega = gamma.contiguous(), Omega.contiguous()
    lap("fit")
    return gamma, Omega


# ------------------------------------------------------------------ K11

# angular momenta K11 is instantiated for (csrc/eri3c_grad.cu): the aux
# shells and the primary shells to g
DF_GRAD_MAX_L = 4


def check_df_grad_classes(primary: Basis, aux: Basis) -> None:
    """Raise NotImplementedError for a basis K11 is not instantiated for."""
    for name, b in (("primary", primary), ("auxiliary", aux)):
        top = max(b.classes)
        if top > DF_GRAD_MAX_L:
            raise NotImplementedError(
                f"K11 is not instantiated for l = {top} in the {name} basis: "
                "it stops at g shells (l = 4)")


def df_grad_tables(primary: Basis, aux: Basis, device):
    """K11's tables and its plain version's: the aux shells, each with a
    unit partner (``aux_unit_blocks``), and the unique primary pairs, packed
    as ``oei.stv_table`` packs them with the shells' atoms (live primitive
    pairs; sorted by count, then by (p, q)), after checking that K11 has
    every class (NotImplementedError before anything reaches ``device``)."""
    from .oei import stv_table

    check_df_grad_classes(primary, aux)
    atom_a, atom_p = np.asarray(aux.shell_atom), np.asarray(primary.shell_atom)
    return ([stv_table(b, device, atom_a) for b in aux_unit_blocks(aux)],
            [stv_table(b, device, atom_p) for b in unique_pair_blocks(primary)])


def _counts(tab) -> np.ndarray:
    return tab.meta[:, 4].cpu().numpy()


def _metric_pairs(ti, tj) -> tuple[np.ndarray, np.ndarray]:
    """The shell pairs (i, j) of two aux tables that the metric term sums:
    unordered (i < j within one table) and on two different atoms."""
    mi, mj = ti.meta.cpu().numpy(), tj.meta.cpu().numpy()
    i, j = np.meshgrid(np.arange(ti.n), np.arange(tj.n), indexing="ij")
    keep = mi[i, 5] != mj[j, 5]
    if ti is tj:
        keep &= i < j
    return i[keep], j[keep]


def _eri_work(work, ti, tj, metric: bool) -> None:
    """work[("eri", la, -1, lp, lq, ka, kp)] += the items of those live
    primitive counts (-1: a unit partner; the metric's lq is -1 too)."""
    if work is None:
        return
    ca, cp = _counts(ti), _counts(tj)
    if not len(ca) or not len(cp):
        return
    if metric:
        i, j = _metric_pairs(ti, tj)
        hist = np.zeros((ca.max() + 1, cp.max() + 1), dtype=np.int64)
        np.add.at(hist, (ca[i], cp[j]), 1)
    else:   # every aux shell meets every pair
        hist = np.outer(np.bincount(ca), np.bincount(cp))
    for x, y in zip(*np.nonzero(hist)):
        work[("eri", ti.la, -1, tj.la, -1 if metric else tj.lb, int(x),
              int(y))] += int(hist[x, y])


def _segs(tab) -> torch.Tensor:
    """The pair (or aux shell) of each row of a table's ``prim``."""
    return torch.repeat_interleave(
        torch.arange(tab.n, device=tab.meta.device), tab.meta[:, 4].long())


def _grad_items(ti, tj, seg_i, seg_j, ra, rp):
    """eri_grad_class on the primitive rows ra of the aux table ti (the
    bra, with its unit partner) and rp of the table tj (the ket): each row
    a shell, or shell pair, of one primitive (seg_*: the shell or pair of
    each row).  Returns (shells of ra, pairs of rp, dA, dC)."""
    pa, pp = ti.prim[ra], tj.prim[rp]
    sa, sp = seg_i[ra], seg_j[rp]
    A, cen = ti.pair[sa, :3], tj.pair[sp]
    one = torch.ones_like(pa[:, :1])
    dA, _, dC = eri_grad_class(
        ti.la, 0, tj.la, tj.lb, pa[:, 0:1], pa[:, 1:2], pa[:, 2:3], one, A, A,
        pp[:, 0:1], pp[:, 1:2], pp[:, 2:3], one, cen[:, :3], cen[:, 3:],
        need_b=False)
    return sa, sp, dA, dC


def three_center_grad_plain(aux_t, pair_t, gamma: torch.Tensor,
                            grad: torch.Tensor,
                            work: Counter | None = None) -> None:
    """K11's plain version, 3-center instance: add 2 sum gamma_{A,pq}
    d(A|pq) over every (aux shell, unique pair) of the tables
    (``df_grad_tables``) to grad [natom, 3]: every (aux primitive, live
    primitive pair) through ``eri_grad_class`` in batches, each batch
    contracted with its gamma blocks at once."""
    dev = grad.device
    for ti in aux_t:
        for tj in pair_t:
            _eri_work(work, ti, tj, False)
            nra, nrp = ti.prim.shape[0], tj.prim.shape[0]
            total = nra * nrp
            if total == 0:
                continue
            nca, ncp, ncq = ncart(ti.la), ncart(tj.la), ncart(tj.lb)
            ma, mp = ti.meta.long(), tj.meta.long()
            seg_i, seg_j = _segs(ti), _segs(tj)
            size = batch_size(ti.la, 0, tj.la, tj.lb, 1, 1, dev)
            for s in range(0, total, size):
                flat = torch.arange(s, min(s + size, total), device=dev)
                sa, sp, dA, dC = _grad_items(ti, tj, seg_i, seg_j,
                                             flat // nrp, flat % nrp)
                oa = ma[sa, 0, None] + torch.arange(nca, device=dev)
                op = mp[sp, 0, None] + torch.arange(ncp, device=dev)
                oq = mp[sp, 1, None] + torch.arange(ncq, device=dev)
                g = gamma[oa[:, :, None, None], op[:, None, :, None],
                          oq[:, None, None, :]].reshape(-1, nca, ncp * ncq)
                w = (2.0 * (2 - mp[sp, 2])).to(torch.float64)[:, None]
                fA = w * torch.einsum("nac,ndac->nd", g, dA)
                fC = w * torch.einsum("nac,ndac->nd", g, dC)
                grad.index_add_(0, ma[sa, 5], fA)
                grad.index_add_(0, mp[sp, 5], fC)
                grad.index_add_(0, mp[sp, 6], -(fA + fC))


def metric_grad_plain(aux_t, Omega: torch.Tensor, grad: torch.Tensor,
                      work: Counter | None = None) -> None:
    """K11's plain version, 2-center instance: add -sum Omega_AB dM_AB to
    grad [natom, 3] over the unordered pairs of aux shells on two different
    atoms (``_metric_pairs``; a pair on one atom adds nothing), each
    weighted by 2: dM/dA of each (primitive, primitive) through
    ``eri_grad_class``, its negative to the second shell's atom."""
    dev = grad.device
    for a, ti in enumerate(aux_t):
        for tj in aux_t[a:]:
            _eri_work(work, ti, tj, True)
            i, j = _metric_pairs(ti, tj)
            if not len(i):
                continue
            # every (row of shell i, row of shell j) of the kept pairs
            ci, cj = _counts(ti), _counts(tj)
            nk = ci[i] * cj[j]
            ii, jj = np.repeat(i, nk), np.repeat(j, nk)
            k = np.arange(nk.sum()) - np.repeat(np.cumsum(nk) - nk, nk)
            p0i = ti.meta[:, 3].cpu().numpy()
            p0j = tj.meta[:, 3].cpu().numpy()
            ra = torch.as_tensor(p0i[ii] + k // cj[jj], device=dev)
            rp = torch.as_tensor(p0j[jj] + k % cj[jj], device=dev)
            nci, ncj = ncart(ti.la), ncart(tj.la)
            mi, mj = ti.meta.long(), tj.meta.long()
            seg_i, seg_j = _segs(ti), _segs(tj)
            size = batch_size(ti.la, 0, tj.la, 0, 1, 1, dev)
            for s in range(0, len(ra), size):
                si, sj, dA, _ = _grad_items(ti, tj, seg_i, seg_j,
                                            ra[s:s + size], rp[s:s + size])
                oi = mi[si, 0, None] + torch.arange(nci, device=dev)
                oj = mj[sj, 0, None] + torch.arange(ncj, device=dev)
                om = Omega[oi[:, :, None], oj[:, None, :]]
                fA = -2.0 * torch.einsum("nac,ndac->nd", om, dA)
                grad.index_add_(0, mi[si, 5], fA)
                grad.index_add_(0, mj[sj, 5], -fA)


def _k11_args(ti, tj, G: torch.Tensor, grad: torch.Tensor, what: str):
    for x, dt in ((G, torch.float64), (grad, torch.float64),
                  (ti.prim, torch.float64), (ti.pair, torch.float64),
                  (ti.meta, torch.int32), (tj.prim, torch.float64),
                  (tj.pair, torch.float64), (tj.meta, torch.int32)):
        if x.dtype != dt or x.device != grad.device or not x.is_contiguous():
            raise ValueError(f"{what}: expected contiguous {dt} on "
                             f"{grad.device}, got {x.dtype} on {x.device}")
    if ti.meta.shape[1] != 7 or tj.meta.shape[1] != 7 or grad.shape[1] != 3:
        raise ValueError(f"{what}: tables with the shells' atoms and grad "
                         "[natom, 3]")
    return (ti.prim.data_ptr(), ti.pair.data_ptr(), ti.meta.data_ptr(), ti.n,
            tj.prim.data_ptr(), tj.pair.data_ptr(), tj.meta.data_ptr(), tj.n,
            G.data_ptr())


def eri3c_grad_class(ti, tj, gamma: torch.Tensor, grad: torch.Tensor,
                     work: Counter | None = None) -> None:
    """Kernel K11, 3-center instance: add the class (ti.la | tj.la tj.lb)'s
    share of 2 sum gamma_{A,pq} d(A|pq) to grad [natom, 3] (f64, on the
    card); gamma [A, nbf, nbf] contiguous.  Raises ValueError for tensors
    that are not on the card, NotImplementedError for a class above g."""
    from . import kernels

    if not grad.is_cuda:
        raise ValueError(f"eri3c_grad_class: K11 runs on CUDA tensors, got "
                         f"{grad.device}")
    if max(ti.la, tj.la, tj.lb) > DF_GRAD_MAX_L:
        raise NotImplementedError(f"K11 is not instantiated for class "
                                  f"({ti.la}|{tj.la}{tj.lb})")
    nbf = gamma.shape[1]
    if gamma.dim() != 3 or gamma.shape[2] != nbf:
        raise ValueError("eri3c_grad_class: gamma must be [A, nbf, nbf]")
    args = _k11_args(ti, tj, gamma, grad, "eri3c_grad_class")
    _eri_work(work, ti, tj, False)
    if ti.n == 0 or tj.n == 0:
        return
    kernels.launch("jc_eri3c_grad", ti.la, tj.la, tj.lb, 0, *args,
                   nbf * nbf, nbf, 2.0, grad.data_ptr(), grad.shape[0],
                   cls=(ti.la, tj.la, tj.lb))


def metric_grad_class(ti, tj, Omega: torch.Tensor, grad: torch.Tensor,
                      work: Counter | None = None) -> None:
    """Kernel K11, 2-center instance: add the aux class pair (ti.la |
    tj.la)'s share of -sum Omega_AB dM_AB to grad [natom, 3] (f64, on the
    card), ti.la <= tj.la (ti is tj for one class); Omega [A, A]
    contiguous.  Counted as ``launches["metric_grad"]``."""
    from . import kernels

    if not grad.is_cuda:
        raise ValueError(f"metric_grad_class: K11 runs on CUDA tensors, got "
                         f"{grad.device}")
    if max(ti.la, tj.la) > DF_GRAD_MAX_L or ti.la > tj.la:
        raise NotImplementedError(f"K11 is not instantiated for the metric "
                                  f"class ({ti.la}|{tj.la})")
    if Omega.dim() != 2 or Omega.shape[0] != Omega.shape[1]:
        raise ValueError("metric_grad_class: Omega must be [A, A]")
    args = _k11_args(ti, tj, Omega, grad, "metric_grad_class")
    _eri_work(work, ti, tj, True)
    if ti.n == 0 or tj.n == 0:
        return
    kernels.launch("jc_eri3c_grad", ti.la, tj.la, 0, 1, *args,
                   Omega.shape[0], 1, -2.0, grad.data_ptr(), grad.shape[0],
                   count_as="metric_grad", cls=(ti.la, tj.la))


def df_two_electron_gradient(primary: Basis, aux: Basis, mol, D: torch.Tensor,
                             spin_densities=None, sph_aux: bool = True,
                             timings: dict | None = None,
                             work: Counter | None = None) -> torch.Tensor:
    """dE_2e/dR [natom, 3] on D's device of the RI-fitted two-electron
    energy

        E_2e = sum_pqrs Gamma_pqrs (pq|A) M^-1_AB (B|rs),
        Gamma = 1/2 D_pq D_rs - 1/4 D_pr D_qs

    = 2 sum_{A,pq} gamma_{A,pq} d(A|pq) - sum_{AB} Omega_AB dM_AB
    (``df_fit_terms``; spin_densities=(Da, Db) switches to the UHF fitted
    functional, D = Da + Db).

    sph_aux=True (the default, as the energy path's ``df_spherical_aux``)
    does the fit algebra in the solid-harmonic-projected aux space the SCF
    fitted in, then lifts gamma and Omega back to Cartesian aux rows through
    the geometry-independent per-shell transform T (d(A'|pq) = T^T d(A|pq)
    and dM' = T^T dM T, so the lifted contractions are exact).  With
    ``timings`` (a dict), the synchronised wall of each part is recorded:
    ``three_center`` (K1's dense (A|pq)), ``metric``, ``fit``,
    ``three_center_derivative``, ``metric_derivative``; ``work`` counts
    the items the derivative terms evaluate (``_eri_work``).  The
    derivative terms are kernel K11 on the card (``eri3c_grad_class``,
    ``metric_grad_class``), its plain versions on the CPU."""
    import time

    device = D.device
    clock = [time.perf_counter()]

    def lap(key):
        if timings is None:
            return
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        timings[key] = timings.get(key, 0.0) + t - clock[0]
        clock[0] = t

    gamma, Omega = df_gamma_omega(primary, aux, D, spin_densities, sph_aux,
                                  lap)

    grad = torch.zeros((mol.natom, 3), dtype=torch.float64, device=device)
    aux_t, pair_t = df_grad_tables(primary, aux, device)
    # ---- 3-center term: 2 sum_{A,pq} gamma d(A|pq) ------------------------
    if device.type == "cuda":
        for ti in aux_t:
            for tj in pair_t:
                eri3c_grad_class(ti, tj, gamma, grad, work)
    else:
        three_center_grad_plain(aux_t, pair_t, gamma, grad, work)
    lap("three_center_derivative")
    del gamma
    # ---- 2-center (metric) term: - sum Omega_AB dM_AB --------------------
    if device.type == "cuda":
        for a, ti in enumerate(aux_t):
            for tj in aux_t[a:]:
                metric_grad_class(ti, tj, Omega, grad, work)
    else:
        metric_grad_plain(aux_t, Omega, grad, work)
    lap("metric_derivative")
    return grad
