"""Density-fitted (RI) Fock build, dense B.

Port of ``juliachem_jl_tpu/models/df.py`` (DensityFitting.jl + ScreenedDF.jl
analog):

  setup:
    (P|Q) metric, L = chol(P|Q)                 [form_J_AB_inv analog]
    (Q|mu nu) 3-center tensor (Schwarz-masked)  [ThreeCenterIntegrals analog]
    B = L^{-1} (Q|mu nu)                        [calculate_B analog]
  every iteration:
    V_Q = sum_{mn} B[Q,m,n] D[m,n];  J = sum_Q B[Q] V_Q
    W[Q,i,n] = sum_m B[Q,m,n] C_occ[m,i]       [calculate_W analog]
    G = J - sum_{Q,i} W W^T                     [J - K/2 with D = 2 C C^T]

The 2- and 3-center integrals go through kernel K1 on the GPU; the
per-iteration J/K are plain products (torch.matmul), as XLA had them.
"""

from __future__ import annotations

import torch

from ..basis.spherical import (aux_needs_sph, cart_to_sph_basis,
                               project_rows_sph_)
from ..ops import eri3c, schwarz
from ..ops.eri import as_f64
from ..ops.pairs import unique_pair_blocks
from ..utils.timings import JCTC, Timings
from .linalg import fold_metric, metric_fold
from .scf import FockBuilder


def screened_pair_blocks(primary, sigma: float, metric_diag_max: float,
                         device):
    """Apply the DF screening criterion (Huang et al. 2020; reference
    SchwarzScreening.jl:1-8): drop shell pair ab if
    (ab|ab) < sigma^2 / max_P (P|P)."""
    out = []
    for b in unique_pair_blocks(primary):
        q = schwarz.pair_schwarz(b, device)          # sqrt(max (ab|ab))
        keep = schwarz.df_pair_mask(q, sigma, metric_diag_max).cpu().numpy()
        if keep.any():
            out.append(b.select(keep))
    return out


def _fitted_space(aux, metric, opts):
    """The metric in the fitting space and the in-place row projection onto
    it: the solid-harmonic span when the aux set has d or higher shells
    (df_spherical_aux, default on; juliachem_jl_tpu/models/df.py:71-77),
    else the metric itself and no projection."""
    if opts.df_spherical_aux and aux_needs_sph(aux):
        T = as_f64(cart_to_sph_basis(aux), metric.device)
        return T.T @ metric @ T, lambda P3: project_rows_sph_(aux, P3)
    return metric, lambda P3: P3


def fitted_metric_and_rows(aux, metric, P3, opts):
    """Project metric and 3-center rows onto the fitting space, then fold.
    Works in place on P3 (f64 or f32): returns B, the first fitted rows of
    P3 (a view)."""
    metric, project = _fitted_space(aux, metric, opts)
    return fold_metric(metric, project(P3))


def fitted_fold(aux, metric, opts, dtype):
    """``fitted_metric_and_rows`` with the metric factored once for a B of
    ``dtype``: returns fold(P3), which projects and folds any column block
    P3 [aux.nbf, c] in place and returns its fitted rows (a view).  The
    projection and the fold combine rows only, so each column range of B
    is built on its own."""
    metric, project = _fitted_space(aux, metric, opts)
    fold = metric_fold(metric, dtype)
    return lambda P3: fold(project(P3))


def build_B(primary, aux, opts, device,
            timings: Timings | None = None) -> torch.Tensor:
    """The fitted 3-index tensor B[Q, mu, nu] with metric folded in
    (calculate_B analog, ScreenedDF.jl:98-105)."""
    timings = timings or Timings()
    with timings.timed(JCTC.two_center_time):
        metric = eri3c.two_center_metric(aux, device)
    with timings.timed(JCTC.screening_time):
        pair_blocks = (
            screened_pair_blocks(primary, opts.df_screening_sigma,
                                 float(torch.diagonal(metric).max()), device)
            if opts.df_screen_exchange else None
        )
    with timings.timed(JCTC.three_center_time):
        P3 = eri3c.three_center_tensor(primary, aux, device, pair_blocks)
    with timings.timed(JCTC.B_time):
        nbf = primary.nbf
        B = fitted_metric_and_rows(aux, metric, P3.reshape(aux.nbf, -1), opts)
    return B.reshape(B.shape[0], nbf, nbf)


def signed_factor(D: torch.Tensor):
    """Signed eigen-factorization D = 2 sum_k s_k c_k c_k^T, s_k = ±1 —
    correct for indefinite D, where keeping only positive eigenvalues would
    drop the negative exchange contributions."""
    w, U = torch.linalg.eigh(D)
    keep = w.abs() > 1e-12
    wk, Uk = w[keep], U[:, keep]
    return Uk * torch.sqrt(0.5 * wk.abs())[None, :], torch.sign(wk)


def df_fock(B, D, C, s=None) -> torch.Tensor:
    """G = J - K/2 from the dense fitted tensor; s (±1 per column of C)
    for an indefinite D."""
    A, nbf = B.shape[0], B.shape[1]
    Bm = B.reshape(A, nbf * nbf)
    V = Bm @ D.reshape(-1)                       # [A]
    J = (V @ Bm).reshape(nbf, nbf)
    W = torch.einsum("qmn,mi->qin", B, C)        # [A, occ, nbf]
    Wm = W.reshape(-1, nbf)
    Ws = Wm if s is None else (W * s[None, :, None]).reshape(-1, nbf)
    return J - Ws.T @ Wm                         # K/2 for D = 2 C C^T


def df_j(B, Dt) -> torch.Tensor:
    """Coulomb matrix of Dt from the dense fitted tensor (UHF shares one V_Q
    of the total density)."""
    A, nbf = B.shape[0], B.shape[1]
    Bm = B.reshape(A, nbf * nbf)
    return ((Bm @ Dt.reshape(-1)) @ Bm).reshape(nbf, nbf)


def df_k(B, C) -> torch.Tensor:
    """Exchange K(C C^T) from orbitals (or a factor) C [nbf, k]."""
    nbf = B.shape[1]
    Wm = torch.einsum("qmn,mi->qin", B, C).reshape(-1, nbf)
    return Wm.T @ Wm


def psd_factor(D: torch.Tensor) -> torch.Tensor:
    """C with C C^T = D over the eigenvalues of D above 1e-12 (a spin
    density on the iterations before orbitals exist)."""
    w, U = torch.linalg.eigh(D)
    keep = w > 1e-12
    return U[:, keep] * torch.sqrt(w[keep])[None, :]


class DFFockBuilder(FockBuilder):
    """Dense (single-device) DF Fock builder over a fitted B[A, nbf, nbf]
    (``build`` makes B with screening applied to the 3-center build)."""

    def __init__(self, B: torch.Tensor, opts):
        self.nbf = B.shape[1]
        self.B = B
        self.mixed = bool(opts.mixed_precision)
        self.B32 = self.B.float() if self.mixed else None
        self.supports_f32_phase = self.mixed

    @classmethod
    def build(cls, primary, auxiliary, opts, device,
              timings: Timings | None = None) -> "DFFockBuilder":
        return cls(build_B(primary, auxiliary, opts, device, timings), opts)

    def two_electron_fock(self, D, iteration, timings: Timings, C_occ=None,
                          precision: str = "f64"):
        if C_occ is None:
            # C-free entry (SAD guess)
            Cs, s = signed_factor(D)
            return df_fock(self.B, D, Cs, s)
        if precision == "f32" and self.B32 is not None:
            return df_fock(self.B32, D.float(), C_occ.float()).double()
        return df_fock(self.B, D, C_occ)

    def two_electron_jk(self, Da, Db, iteration, timings: Timings, Ca=None,
                        Cb=None):
        """J from one V_Q of the total density; K per spin from W = B C_s
        (or a PSD eigen-factor of D_s while no orbitals exist)."""
        J = df_j(self.B, Da + Db)
        Ka = df_k(self.B, psd_factor(Da) if Ca is None else Ca)
        if Ca is None and Cb is None and torch.equal(Da, Db):
            return J, Ka, Ka
        return J, Ka, df_k(self.B, psd_factor(Db) if Cb is None else Cb)

    def finalize(self):
        self.B = None
        self.B32 = None
