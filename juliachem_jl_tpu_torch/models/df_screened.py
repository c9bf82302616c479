"""Screened (packed-pq) density-fitted Fock build — the scale path.

Port of ``juliachem_jl_tpu/models/df_screened.py`` (the reference's
ScreenedDF.jl as packed tensors):

  reference (ScreenedDF.jl)                  here
  -------------------------                  ----
  sparse_pq_index_map + contiguous           PackedScreen.col_map (flat
  non-zero ranges per p (:16-77)             (mu,nu) -> packed column; trash
                                             column for screened-out entries)
  B stored [rank_Q, screened_pq] (:98-105)   B stored [A, npq+1] (both index
                                             orders packed; last col zero)
  per-p gemms over non-zero rows for W       per-Q-block kernel K2: the gather
  (:242-289)                                 through col_map fused into
                                             W = B_block C, no dense tile
  blocked lower-triangle exchange            optional upper block triangle of
  (:385-641)                                 K = W^T W (k_blocks > 1)
  screened symmetric J via per-p gemv        packed matvec pair
  (:318-365)                                 V = B d, J = V B

B lives on the device.  The JAX package's host-streamed mode and its B/raw
caches are not ported: a B that does not fit the device budget raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import eri3c, kernels
from ..utils.timings import JCTC, Timings
from .df import fitted_metric_and_rows, screened_pair_blocks, signed_factor
from .scf import FockBuilder


@dataclass
class PackedScreen:
    """Sparse pq bookkeeping (SchwarzScreening.jl / ScreenedDF.jl:16-77
    analog).  Both (mu,nu) and (nu,mu) of every surviving pair are packed,
    so J needs no off-diagonal doubling and K tiles are symmetric."""

    nbf: int
    npq: int
    pq_flat: np.ndarray   # [npq] int64 flat (mu*nbf+nu) of packed col c
    col_map: np.ndarray   # [nbf*nbf] int64 -> packed col; npq = trash

    @property
    def fill(self) -> float:
        return self.npq / float(self.nbf * self.nbf)


def build_packed_screen(primary, pair_blocks) -> PackedScreen:
    """Packed column map over the basis-function products of the surviving
    (Schwarz/sigma-screened) shell pairs."""
    nbf = primary.nbf
    flats = []
    for b in pair_blocks:
        nca, ncb = b.nbf_block
        ia = b.off_a[:, None, None] + np.arange(nca)[None, :, None]
        ib = b.off_b[:, None, None] + np.arange(ncb)[None, None, :]
        ia = np.broadcast_to(ia, (b.n, nca, ncb)).ravel()
        ib = np.broadcast_to(ib, (b.n, nca, ncb)).ravel()
        flats.append(ia * nbf + ib)
        flats.append(ib * nbf + ia)
    pq_flat = np.unique(np.concatenate(flats)) if flats else np.empty(0, np.int64)
    npq = len(pq_flat)
    col_map = np.full(nbf * nbf, npq, dtype=np.int64)
    col_map[pq_flat] = np.arange(npq, dtype=np.int64)
    return PackedScreen(nbf=nbf, npq=npq, pq_flat=pq_flat, col_map=col_map)


def build_B_packed(primary, aux, opts, device,
                   timings: Timings | None = None):
    """Packed B[A, npq+1] with the metric folded in, plus the screen maps.

    Same pipeline as df.build_B (2-center metric -> screening -> 3-center ->
    triangular solve) but the 3-center tensor is written directly into
    packed columns — the dense [A, nbf, nbf] intermediate never exists."""
    timings = timings or Timings()
    with timings.timed(JCTC.two_center_time):
        metric = eri3c.two_center_metric(aux, device)
    with timings.timed(JCTC.screening_time):
        pair_blocks = screened_pair_blocks(
            primary, opts.df_screening_sigma,
            float(torch.diagonal(metric).max()), device)
        screen = build_packed_screen(primary, pair_blocks)
    with timings.timed(JCTC.three_center_time):
        P3 = eri3c.three_center_tensor(
            primary, aux, device, pair_blocks, col_map=screen.col_map,
            packed_width=screen.npq + 1)
    with timings.timed(JCTC.B_time):
        B = fitted_metric_and_rows(aux, metric, P3, opts)
        del P3
        B[:, -1] = 0.0
    return B, screen


# ---------------------------------------------------------------- kernel K2


def df_gather_w_plain(Bc, col_map, C) -> torch.Tensor:
    """Plain version of K2: expand the block to a dense [Qc, nbf, nbf] tile
    through col_map (trash column = zeros), then W = tile · C."""
    nbf = C.shape[0]
    tile = Bc.index_select(1, col_map).reshape(-1, nbf, nbf)
    return torch.einsum("qmn,mi->qin", tile, C)


def df_gather_w(Bc, col_map, C) -> torch.Tensor:
    """Kernel K2: W[q, i, n] = sum_m Bc[q, col_map[m*nbf + n]] C[m, i].

    Bc: [Qc, npq+1] rows of packed B (f64 or f32; trash column npq);
    col_map: [nbf*nbf] int32; C: [nbf, k] of Bc's dtype.  Returns
    [Qc, k, nbf].  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    nbf, k = C.shape
    qc, ldb = Bc.shape
    if col_map.dtype != torch.int32 or col_map.shape != (nbf * nbf,) \
            or C.dtype != Bc.dtype:
        raise ValueError("df_gather_w: col_map must be int32 [nbf*nbf] and "
                         "C share Bc's dtype")
    if not Bc.is_cuda:
        return df_gather_w_plain(Bc, col_map, C)
    if Bc.dtype not in (torch.float64, torch.float32) or qc > 65535:
        raise ValueError("df_gather_w: f64/f32 blocks of at most 65535 rows")
    for t in (Bc, col_map, C):
        if t.device != Bc.device or not t.is_contiguous():
            raise ValueError("df_gather_w: contiguous tensors on one device")
    W = torch.empty((qc, k, nbf), dtype=Bc.dtype, device=Bc.device)
    sym = ("jc_df_gather_w_f64" if Bc.dtype == torch.float64
           else "jc_df_gather_w_f32")
    kernels.launch(sym, Bc.data_ptr(), ldb, ldb - 1, col_map.data_ptr(),
                   C.data_ptr(), nbf, k, qc, W.data_ptr())
    return W


# ---------------------------------------------------------------- builder


def _sync(dev) -> None:
    """Wait for the card, so that the phase timings are the device's."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class ScreenedDFFockBuilder(FockBuilder):
    """Packed-B DF Fock builder with Q-blocked exchange (the scale path;
    replaces ScreenedDF.jl + GPUDF.jl's single-rank duties)."""

    # budgets as fractions of the device's memory (the JAX package's fixed
    # 6 GB / 1.5 GB were sized for a 16 GB TPU v5e); a CPU run uses those
    # fixed figures
    B_FRACTION = 0.6
    W_FRACTION = 0.05

    def __init__(self, B: torch.Tensor, screen: PackedScreen, opts,
                 nocc: int):
        device = B.device
        self.nbf = nbf = screen.nbf
        if device.type == "cuda":
            total = torch.cuda.get_device_properties(device).total_memory
            b_budget, w_budget = self.B_FRACTION * total, self.W_FRACTION * total
        else:
            b_budget, w_budget = 6.0e9, 1.5e9
        self.mixed = bool(opts.mixed_precision)
        need = B.numel() * (12 if self.mixed else 8)
        if need > b_budget:
            raise MemoryError(
                f"packed B needs {need / 1e9:.1f} GB with its f32 copy, over "
                f"the {b_budget / 1e9:.1f} GB device budget; the host-streamed "
                "mode is not ported (ROADMAP.md A4)")
        self.screen = screen
        self.A = A = B.shape[0]
        self.B = B
        self.B32 = B.float() if self.mixed else None
        self.supports_f32_phase = self.mixed

        n_blocks = int(opts.df_exchange_n_blocks or 0)
        if n_blocks > 0:
            self.q_chunk = -(-A // n_blocks)
        else:
            # the largest Q-block whose W [Qc, nocc, nbf] fits the budget
            # (the CPU's plain K2 also expands the [Qc, nbf, nbf] tile)
            per_q = nbf * (max(nocc, 1) if device.type == "cuda" else nbf)
            self.q_chunk = max(64, int(w_budget / (8 * per_q)))
        self.q_chunk = min(self.q_chunk, A, 65535)
        # upper block triangle of K = W^T W pays once that gemm dominates
        # (ScreenedDF.jl:459-641's K_block_width analog)
        self.k_blocks = 4 if nbf >= 1024 else 1
        if screen.npq >= 2**31:
            raise ValueError("packed width exceeds the int32 col_map")
        self._col_map = torch.as_tensor(screen.col_map, device=device).to(torch.int32)
        self._pq_flat = torch.as_tensor(screen.pq_flat, device=device)

    @classmethod
    def build(cls, primary, auxiliary, opts, device,
              timings: Timings | None = None) -> "ScreenedDFFockBuilder":
        B, screen = build_B_packed(primary, auxiliary, opts, device, timings)
        return cls(B, screen, opts, primary.nels // 2)

    def q_blocks(self, src) -> list[torch.Tensor]:
        """The Q-blocks of packed B (f64 or its f32 copy), as views."""
        return [src[q:q + self.q_chunk] for q in range(0, self.A, self.q_chunk)]

    def sweep(self, blocks, Vs, Cs, s):
        """One pass over the Q-blocks: K = sum_Q (W s)^T W of the density
        factored by (Cs, s) (W from K2; s None for orbitals; the upper
        block triangle, mirrored, when k_blocks > 1), and, when Vs (each
        block's V_Q = B_Q d) is given, the packed Coulomb vector
        Jp = sum_Q V_Q B_Q.  Returns (K [nbf, nbf], Jp or None) in the
        blocks' dtype."""
        nbf, fdt, dev = self.nbf, blocks[0].dtype, blocks[0].device
        nb = self.k_blocks
        kb = -(-nbf // nb)
        Jp = None if Vs is None else torch.zeros(self.screen.npq + 1,
                                                 dtype=fdt, device=dev)
        K = torch.zeros((nb * kb, nb * kb), dtype=fdt, device=dev)
        for n, blk in enumerate(blocks):
            if Jp is not None:
                Jp += Vs[n] @ blk
            if Cs.shape[1] == 0:   # an empty spin channel
                continue
            W = df_gather_w(blk, self._col_map, Cs)          # [qc, k, nbf]
            Wm = W.reshape(-1, nbf)
            Ws = Wm if s is None else (W * s[None, :, None]).reshape(-1, nbf)
            if nb == 1:
                K += Ws.T @ Wm
                continue
            pad = nb * kb - nbf
            W2 = torch.nn.functional.pad(Wm, (0, pad)).reshape(-1, nb, kb)
            Ws2 = torch.nn.functional.pad(Ws, (0, pad)).reshape(-1, nb, kb)
            for I in range(nb):
                for J in range(I, nb):
                    K[I * kb:(I + 1) * kb, J * kb:(J + 1) * kb] += \
                        Ws2[:, I, :].T @ W2[:, J, :]
        if nb > 1:
            # mirror the upper block triangle (diagonal blocks once)
            idx = torch.arange(nb * kb, device=dev) // kb
            bd = idx[:, None] == idx[None, :]
            K = K + K.T - torch.where(bd, K, 0.0)
        return K[:nbf, :nbf], Jp

    def scatter_j(self, Jp) -> torch.Tensor:
        """The dense f64 J [nbf, nbf] of the packed Coulomb vector."""
        nbf = self.nbf
        J = torch.zeros(nbf * nbf, dtype=torch.float64, device=Jp.device)
        J[self._pq_flat] = Jp[:-1].double()
        return J.reshape(nbf, nbf)

    def two_electron_fock(self, D, iteration, timings: Timings, C_occ=None,
                          precision: str = "f64"):
        use_f32 = precision == "f32" and self.supports_f32_phase
        fdt = torch.float32 if use_f32 else torch.float64
        dev = D.device
        d = torch.cat([D.reshape(-1)[self._pq_flat],
                       D.new_zeros(1)]).to(fdt)
        if C_occ is None:
            Cs, s = signed_factor(D)
            Cs, s = Cs.to(fdt).contiguous(), s.to(fdt)
        else:
            Cs, s = C_occ.to(fdt).contiguous(), None
        blocks = self.q_blocks(self.B32 if use_f32 else self.B)
        with timings.timed(JCTC.V_time, iteration):
            Vs = [blk @ d for blk in blocks]
            _sync(dev)
        with timings.timed(JCTC.K_time, iteration):
            K, Jp = self.sweep(blocks, Vs, Cs, s)
            _sync(dev)
        with timings.timed(JCTC.J_time, iteration):
            G = self.scatter_j(Jp) - K.double()
            _sync(dev)
        return G

    def finalize(self):
        self.B = None
        self.B32 = None
