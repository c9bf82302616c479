"""Conventional (direct-SCF) Fock builders.

Port of ``juliachem_jl_tpu/ops/fock.py`` (the reference's Fock build,
SCF.jl:606-1054): quartets are grouped by angular-momentum class,
Schwarz-screened at setup into static batches, and each batch is digested
against D into non-symmetric J/K workspaces.

Symmetry handling: each symmetry-unique quartet (unordered bra pair, unordered
ket pair, unordered pair-of-pairs) carries weight
    v = 1 / ((1+d_AB)(1+d_CD)(1+d_{AB,CD}))
and is accumulated into non-symmetric J/K workspaces for its four bra-side
images; the final J/K are symmetrised (J + J^T), as the reference's
skeleton-Fock + symmetrise scheme (SCF.jl:626-641).

On the card the digestion is kernel K5 (``eri4c_jk``: ERI + digestion fused,
direct mode) or K6 (``digest_jk``: cached blocks, in-core mode, filled once by
K4; each class pair on its route of ``kernels.digest_route``, as built:
``digest_geometry``), both summing into J/K with f64 atomics; on the CPU
their plain versions run (``_digest_vals`` + ``index_add_``).  Targets come
from the pair offsets, so no per-quartet index streams are kept; the JAX
package's TPU workarounds (nbf padding, bucketed chunk counts, the
gather-sum plan) are not ported.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import config
from ..basis.structs import Basis, ncart
from ..models.scf import FockBuilder
from ..utils.timings import Timings
from . import kernels
from .eri import (PairTable, check_kernel_class, check_tables, eri4c_class,
                  eri4c_plain, full_eri_tensor, pair_table, plain_chunk)
from .pairs import PairBlock, unique_pair_blocks
from .schwarz import pair_schwarz, screened_quartets
from .segsum import reduce_into

DEFAULT_CUTOFF = 1.0e-10  # Schwarz |(ab|cd)| cutoff (reference uses 1e-10, SCF.jl:1011)
INCORE_BUDGET_ELEMENTS = 400_000_000  # f64 ERI elements cached in-core


def incore_budget() -> int:
    """In-core ERI budget in elements (``JCHEM_INCORE_BUDGET``, read as the
    JAX package reads it, else INCORE_BUDGET_ELEMENTS)."""
    env = os.environ.get("JCHEM_INCORE_BUDGET")
    return int(float(env)) if env else INCORE_BUDGET_ELEMENTS


class JKFock(FockBuilder):
    """A builder that digests one symmetric density D into (J, K)
    (``jk_halves``): RHF's G = J - K/2, and UHF's spin-resolved J/K from two
    passes."""

    def jk_halves(self, D, iteration=None, timings: Timings | None = None):
        raise NotImplementedError

    def two_electron_fock(self, D, iteration, timings: Timings, C_occ=None,
                          precision: str = "f64"):
        J, K = self.jk_halves(D, iteration, timings)
        return J - 0.5 * K

    def two_electron_jk(self, Da, Db, iteration, timings: Timings,
                        Ca=None, Cb=None):
        """(J(Dt), K(Da), K(Db)) from two digestion passes: J and K are
        linear in D, so with Dt = Da + Db and Ds = Da - Db,
        K(Da) = [K(Dt) + K(Ds)] / 2 and K(Db) = [K(Dt) - K(Ds)] / 2; one
        pass when Da == Db."""
        J, Kt = self.jk_halves(Da + Db, iteration, timings)
        if torch.equal(Da, Db):
            Ka = 0.5 * Kt
            return J, Ka, Ka
        _, Ks = self.jk_halves(Da - Db, iteration, timings)
        return J, 0.5 * (Kt + Ks), 0.5 * (Kt - Ks)


class DenseFock(JKFock):
    """Full in-memory ERI tensor; correctness reference for small systems."""

    def __init__(self, basis: Basis, device=None):
        self.G = full_eri_tensor(basis, config.resolve_device(device))

    def jk_halves(self, D, iteration=None, timings=None):
        J = torch.einsum("pqrs,rs->pq", self.G, D)
        K = torch.einsum("prqs,rs->pq", self.G, D)
        return J, K

    def finalize(self):
        self.G = None


@dataclass
class QuartetBatch:
    """A screened batch of symmetry-unique quartets of one class."""

    bra: PairBlock
    ket: PairBlock
    sel_bra: np.ndarray      # [N] indices into bra block
    sel_ket: np.ndarray      # [N]
    weight: np.ndarray       # [N] symmetry weights v


def schwarz_blocks(basis: Basis, cutoff: float, pair_cutoff_scale: float,
                   device):
    """(all unique pair blocks, their Q values, the kept blocks and their Q
    values) after dropping pairs with Q < cutoff * scale / max Q."""
    blocks = unique_pair_blocks(basis)
    qvals = [pair_schwarz(b, device).cpu().numpy() for b in blocks]
    qmax = max((q.max() for q in qvals if len(q)), default=1.0)
    pair_cut = cutoff * pair_cutoff_scale / max(qmax, 1e-30)
    kept, kept_q = [], []
    for b, q in zip(blocks, qvals):
        keep = q >= pair_cut
        if keep.any():
            kept.append(b.select(keep))
            kept_q.append(q[keep])
    return blocks, qvals, kept, kept_q


def build_quartet_batches(
    basis: Basis, cutoff: float = DEFAULT_CUTOFF,
    pair_cutoff_scale: float = 1.0e-4, device=None, schwarz=None,
) -> tuple[list[QuartetBatch], np.ndarray]:
    """Enumerate Schwarz-screened symmetry-unique quartet batches.

    Returns (batches, Q) where Q is the shell-pair Schwarz matrix (host).
    Quartets with Q_ab * Q_cd < cutoff are dropped (the reference computes
    the same bound per quartet at SCF.jl:916-933).  schwarz: the result of
    ``schwarz_blocks`` for these arguments, when the caller has it."""
    device = config.resolve_device(device)
    blocks, qvals, kept, kept_q = schwarz or schwarz_blocks(
        basis, cutoff, pair_cutoff_scale, device)
    batches: list[QuartetBatch] = []
    for i, (bra, qb) in enumerate(zip(kept, kept_q)):
        for j in range(i, len(kept)):
            ket, qk = kept[j], kept_q[j]
            same_block = i == j
            r, c = screened_quartets(qb, qk, cutoff, same_block)
            if len(r) == 0:
                continue
            w = np.ones(len(r))
            w *= np.where(bra.ish[r] == bra.jsh[r], 0.5, 1.0)
            w *= np.where(ket.ish[c] == ket.jsh[c], 0.5, 1.0)
            if same_block:
                w *= np.where(r == c, 0.5, 1.0)
            batches.append(QuartetBatch(bra=bra, ket=ket, sel_bra=r,
                                        sel_ket=c, weight=w))

    Q = np.zeros((basis.nshell, basis.nshell))
    for b, q in zip(blocks, qvals):
        Q[b.ish, b.jsh] = q
        Q[b.jsh, b.ish] = q
    return batches, Q


def _digest_vals(I, w, D, bra: PairTable, ket: PairTable, sel_bra, sel_ket):
    """Per-quartet J/K value streams (the torch einsums of the JAX package's
    ``_digest_vals_body``, ops/fock.py:297-316) and their targets in the
    flat [2 * nbf * nbf] workspace (J then K), from the pair offsets."""
    nca, ncb, ncc, ncd = (ncart(bra.la), ncart(bra.lb), ncart(ket.la),
                          ncart(ket.lb))
    N, nbf = I.shape[0], D.shape[0]
    I4 = (I * w[:, None, None]).reshape(N, nca, ncb, ncc, ncd)
    mb, mk = bra.meta[sel_bra].long(), ket.meta[sel_ket].long()

    def rng(off, nc):
        return off[:, None] + torch.arange(nc, device=off.device)[None, :]

    ia, ib = rng(mb[:, 0], nca), rng(mb[:, 1], ncb)
    ic, idd = rng(mk[:, 0], ncc), rng(mk[:, 1], ncd)

    def gD(u, v):
        return D[u[:, :, None], v[:, None, :]]

    vals = (2.0 * torch.einsum("nabcd,ncd->nab", I4, gD(ic, idd)),
            2.0 * torch.einsum("nabcd,nab->ncd", I4, gD(ia, ib)),
            torch.einsum("nabcd,nbd->nac", I4, gD(ib, idd)),
            torch.einsum("nabcd,nbc->nad", I4, gD(ib, ic)),
            torch.einsum("nabcd,nad->nbc", I4, gD(ia, idd)),
            torch.einsum("nabcd,nac->nbd", I4, gD(ia, ic)))
    P2 = nbf * nbf

    def flat(u, v, base):
        return (base + u[:, :, None] * nbf + v[:, None, :]).reshape(N, -1)

    targets = (flat(ia, ib, 0), flat(ic, idd, 0), flat(ia, ic, P2),
               flat(ia, idd, P2), flat(ib, ic, P2), flat(ib, idd, P2))
    return (torch.cat([v.reshape(N, -1) for v in vals], dim=1),
            torch.cat(targets, dim=1))


def digest_plain(JK, I, w, D, bra, ket, sel_bra, sel_ket) -> None:
    """Plain digestion of blocks I [N, nab, ncd] into JK [2, nbf, nbf]."""
    vals, targets = _digest_vals(I, w, D, bra, ket, sel_bra, sel_ket)
    reduce_into(JK.view(-1), targets, vals)


def _check_jk(name: str, JK, D, bra: PairTable) -> int:
    nbf = D.shape[0]
    if D.shape != (nbf, nbf) or JK.shape != (2, nbf, nbf):
        raise ValueError(f"{name}: D must be [nbf, nbf] and JK [2, nbf, nbf]")
    for t in (JK, D):
        if t.dtype != torch.float64 or t.device != bra.pair.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: JK and D must be contiguous float64 "
                             f"on {bra.pair.device}")
    return nbf


def digest_jk(JK, I, bra: PairTable, ket: PairTable, sel_bra, sel_ket,
              weight, D) -> None:
    """Kernel K6: JK[0] (J) and JK[1] (K) += the six-image digestion of the
    cached blocks I [N, nab, ncd] of quartets (sel_bra, sel_ket) with their
    symmetry weights, against the symmetric D [nbf, nbf].  Quartets in bra-row
    order (``screened_quartets``) let the lane route sum the targets that
    consecutive blocks share before its atomics; any order gives the same
    J/K."""
    n = sel_bra.shape[0]
    if I.shape[0] != n or sel_ket.shape != (n,) or weight.shape != (n,):
        raise ValueError("digest_jk: inconsistent quartet counts")
    if not bra.pair.is_cuda:
        digest_plain(JK, I, weight, D, bra, ket, sel_bra, sel_ket)
        return
    nbf = _check_jk("digest_jk", JK, D, bra)
    check_tables("digest_jk", bra, ket, (sel_bra, torch.int64),
                 (sel_ket, torch.int64), (weight, torch.float64),
                 (I, torch.float64))
    if n:
        cls = (bra.la, bra.lb, ket.la, ket.lb)
        kernels.launch("jc_digest_jk", *cls, bra.meta.data_ptr(),
                       ket.meta.data_ptr(), sel_bra.data_ptr(),
                       sel_ket.data_ptr(), weight.data_ptr(), n, I.data_ptr(),
                       D.data_ptr(), nbf, JK.data_ptr(), cls=cls)


def digest_geometry(bra: PairTable, ket: PairTable) -> dict:
    """K6's launch geometry for the class pair of two CUDA pair tables, as
    csrc/eri4c_launch.cuh built it: the route ("lane", "block" or "warp"),
    warps a block, shared-memory bytes a warp (the block route: a block,
    also as ``block_bytes``) and the blocks an SM holds (CUDA's occupancy
    calculator).  Nothing is launched."""
    import ctypes

    cls = (bra.la, bra.lb, ket.la, ket.lb)
    check_kernel_class("digest_geometry", *cls)
    out = (ctypes.c_longlong * 4)()
    lib = kernels.library()
    rc = lib.jc_digest_jk_geometry(*cls, out)
    if rc != 0:
        raise RuntimeError(f"jc_digest_jk_geometry failed: CUDA error {rc} "
                           f"({lib.jc_error_string(rc).decode()})")
    route, W, nbytes, blocks = list(out)
    route = {0: "warp", 1: "lane", 2: "block"}[route]
    return {"route": route, "warps_per_block": W,
            "warp_bytes": nbytes // W if route == "block" else nbytes,
            "block_bytes": nbytes if route == "block" else nbytes * W,
            "blocks_per_sm": blocks, "warps_per_sm": blocks * W}


def launch_eri4c_jk(JK, D, bra: PairTable, ket: PairTable, n: int, *,
                    sel_bra=None, sel_ket=None, weight=None, cum=None,
                    same_block: bool = False, t0: int = 0) -> None:
    """Launch K5 on the card over the quartets t0 .. t0 + n - 1, in list
    mode (sel_bra, sel_ket, weight) or in staircase mode (cum); counted per
    mode."""
    nbf = _check_jk("eri4c_jk", JK, D, bra)
    ints = ((cum, torch.int64),) if cum is not None else (
        (sel_bra, torch.int64), (sel_ket, torch.int64),
        (weight, torch.float64))
    check_tables("eri4c_jk", bra, ket, *ints)
    if n == 0:
        return

    def ptr(t):
        return None if t is None else t.data_ptr()

    kernels.launch("jc_eri4c_jk", bra.la, bra.lb, ket.la, ket.lb,
                   bra.pair.data_ptr(), bra.Ka, bra.Kb, bra.meta.data_ptr(),
                   ket.pair.data_ptr(), ket.Ka, ket.Kb, ket.meta.data_ptr(),
                   ptr(sel_bra), ptr(sel_ket), ptr(weight), ptr(cum),
                   0 if cum is None else cum.shape[0], int(same_block), n,
                   t0, D.data_ptr(), nbf, JK.data_ptr(),
                   count_as="eri4c_jk_stair" if cum is not None
                   else "eri4c_jk_list", cls=(bra.la, bra.lb, ket.la, ket.lb))


def eri4c_jk_plain(JK, bra: PairTable, ket: PairTable, sel_bra, sel_ket,
                   weight, D) -> None:
    """Plain torch version of K5 in list mode (same arguments)."""
    csize = plain_chunk(bra, ket)
    for s in range(0, sel_bra.shape[0], csize):
        sb, sk = sel_bra[s:s + csize], sel_ket[s:s + csize]
        digest_plain(JK, eri4c_plain(bra, ket, sb, sk), weight[s:s + csize],
                     D, bra, ket, sb, sk)


def eri4c_jk(JK, bra: PairTable, ket: PairTable, sel_bra, sel_ket, weight,
             D) -> None:
    """Kernel K5, list mode: the ERI blocks of quartets (sel_bra, sel_ket)
    digested at once into JK (as ``digest_jk``), never stored."""
    n = sel_bra.shape[0]
    if sel_ket.shape != (n,) or weight.shape != (n,):
        raise ValueError("eri4c_jk: inconsistent quartet counts")
    if bra.pair.is_cuda:
        launch_eri4c_jk(JK, D, bra, ket, n, sel_bra=sel_bra, sel_ket=sel_ket,
                        weight=weight)
    else:
        eri4c_jk_plain(JK, bra, ket, sel_bra, sel_ket, weight, D)


@dataclass
class _Group:
    """Device form of one quartet batch."""

    bra: PairTable
    ket: PairTable
    sel_bra: torch.Tensor
    sel_ket: torch.Tensor
    weight: torch.Tensor
    vol: int                 # ERI elements of the batch
    I: torch.Tensor = None   # cached blocks (in-core mode)


class ScreenedDirectFock(JKFock):
    """Class-batched, Schwarz-screened direct Fock build (replaces
    SCF.jl:665-1054).

    incore: cache the screened ERI blocks (K4) at the first build and digest
    them every iteration (K6); otherwise recompute and digest them every
    iteration (K5, list mode).  Auto-enabled when the screened integral
    volume fits ``incore_budget()``.  schwarz: as for
    ``build_quartet_batches``."""

    def __init__(self, basis: Basis, cutoff: float = DEFAULT_CUTOFF,
                 incore: bool | None = None, device=None, schwarz=None):
        device = config.resolve_device(device)
        self.nbf = basis.nbf
        self.device = device
        self.batches, self.Q = build_quartet_batches(
            basis, cutoff, device=device, schwarz=schwarz)
        tables: dict[int, PairTable] = {}

        def table(b: PairBlock) -> PairTable:
            if id(b) not in tables:
                tables[id(b)] = pair_table(b, device)
            return tables[id(b)]

        def idx(x):
            return torch.as_tensor(x, dtype=torch.int64, device=device)

        self.groups = [
            _Group(bra=table(b.bra), ket=table(b.ket), sel_bra=idx(b.sel_bra),
                   sel_ket=idx(b.sel_ket),
                   weight=torch.as_tensor(b.weight, dtype=torch.float64,
                                          device=device),
                   vol=len(b.sel_bra) * ncart(b.bra.la) * ncart(b.bra.lb)
                   * ncart(b.ket.la) * ncart(b.ket.lb))
            for b in self.batches]
        self.n_quartets = sum(len(b.sel_bra) for b in self.batches)
        if incore is None:
            incore = sum(g.vol for g in self.groups) <= incore_budget()
        self.incore = incore

    def fill_incore(self) -> None:
        """Cache every batch's ERI blocks (K4)."""
        for g in self.groups:
            if g.I is None:
                g.I = eri4c_class(g.bra, g.ket, g.sel_bra, g.sel_ket)

    def jk_halves(self, D, iteration=None, timings: Timings | None = None):
        """Digest one symmetric density into (J, K) such that the RHF
        two-electron part is J - 0.5 K (both symmetrised, DenseFock
        index convention)."""
        D = D.to(device=self.device, dtype=torch.float64).contiguous()
        JK = torch.zeros((2, self.nbf, self.nbf), dtype=torch.float64,
                         device=self.device)
        if self.incore:
            self.fill_incore()
        for g in self.groups:
            if self.incore:
                digest_jk(JK, g.I, g.bra, g.ket, g.sel_bra, g.sel_ket,
                          g.weight, D)
            else:
                eri4c_jk(JK, g.bra, g.ket, g.sel_bra, g.sel_ket, g.weight, D)
        return JK[0] + JK[0].T, JK[1] + JK[1].T

    def finalize(self):
        for g in self.groups:
            g.I = None
