"""Dense linear algebra for the SCF: orthogonalization, Roothaan step, DIIS,
and the DF metric fold.

Port of ``juliachem_jl_tpu/models/linalg.py``.  Every step runs in f64 torch
on the calculation's device (the H100 has native f64, so the TPU's host
round-trips, blocked folds and split-precision workarounds are gone).
"""

from __future__ import annotations

import math
import warnings

import torch

# (min(diag L) / max(diag L))^2 below this marks the metric numerically
# singular: the Cholesky factor's inverse would amplify integral noise by
# ~1/ratio.  Generated (AutoAux) auxiliary sets on N-rich systems reach
# cond ~1e17; real JKFIT tables sit around 1e5-1e8 and keep the fast path.
_METRIC_DIAG_RATIO2 = 1e-12


def fold_metric(metric: torch.Tensor, B: torch.Tensor,
                lindep_thresh: float = 1e-10) -> torch.Tensor:
    """DF metric fold: returns f(J) B with conditioning-aware f.

    Healthy metric: f = L^{-1} (Cholesky, the reference's route —
    ScreenedDF.jl:98-105), applied by a triangular solve.  Numerically
    singular metric: the symmetric pseudo-inverse square root
    V_k diag(w_k^{-1/2}) V_k^T with eigenvalues below ``lindep_thresh * w_max``
    dropped (dropped directions become exact zero rows of B).
    """
    L, info = torch.linalg.cholesky_ex(metric)
    if int(info) == 0:
        d = torch.diagonal(L)
        if float((d.min() / d.max()) ** 2) >= _METRIC_DIAG_RATIO2:
            # the solver may hand back a column-major result: B is read by
            # row blocks downstream
            return torch.linalg.solve_triangular(L, B, upper=False).contiguous()
    w, V = torch.linalg.eigh(metric)
    keep = w >= lindep_thresh * w[-1]
    warnings.warn(
        f"DF metric numerically singular (min eig {float(w[0]):.2e}, max "
        f"{float(w[-1]):.2e}); folding with pseudo-inverse sqrt, dropping "
        f"{int((~keep).sum())}/{len(w)} auxiliary directions", stacklevel=2)
    Vk = V[:, keep]
    M = (Vk / torch.sqrt(w[keep])[None, :]) @ Vk.T
    return (M @ B).contiguous()


def orthogonalizer(S: torch.Tensor, lindep_thresh: float = 1.0e-6) -> torch.Tensor:
    """Canonical orthogonalization X = U_f s_f^{-1/2}, eigenvalues below
    ``lindep_thresh`` dropped (reference SCF.jl:141-162).  [nbf, nmo]."""
    s, U = torch.linalg.eigh(S)
    keep = s >= lindep_thresh
    return U[:, keep] / torch.sqrt(s[keep])[None, :]


def roothaan_step(F: torch.Tensor, X: torch.Tensor, nocc: int):
    """One Roothaan-Hall iteration (reference ``iteration()``, SCF.jl:1072-1125):
    F' = X^T F X; eigh -> (eps, C'); C = X C'; D = 2 C_occ C_occ^T."""
    Fp = X.T @ F @ X
    eps, Cp = torch.linalg.eigh(Fp)
    C = X @ Cp
    Cocc = C[:, :nocc]
    D = 2.0 * (Cocc @ Cocc.T)
    return eps, C, D


class DIIS:
    """Pulay DIIS on the commutator error e = F D S - S D F (reference
    SCF.jl:472-501, EnergyHelpers.jl:234-258)."""

    def __init__(self, max_vec: int = 8):
        self.max_vec = max_vec
        self.F_hist: list[torch.Tensor] = []
        self.e_hist: list[torch.Tensor] = []

    def push(self, F: torch.Tensor, e: torch.Tensor) -> None:
        self.F_hist.append(F)
        self.e_hist.append(e)
        if len(self.F_hist) > self.max_vec:
            self.F_hist.pop(0)
            self.e_hist.pop(0)

    @property
    def size(self) -> int:
        return len(self.F_hist)

    def extrapolate(self) -> torch.Tensor:
        n = self.size
        if n == 1:
            return self.F_hist[0]
        E = torch.stack(self.e_hist).reshape(n, -1)
        B = torch.empty((n + 1, n + 1), dtype=E.dtype, device=E.device)
        B[:n, :n] = E @ E.T
        B[n, :] = -1.0
        B[:, n] = -1.0
        B[n, n] = 0.0
        rhs = torch.zeros(n + 1, dtype=E.dtype, device=E.device)
        rhs[n] = -1.0
        try:
            c = torch.linalg.solve(B, rhs)
        except torch.linalg.LinAlgError:
            # singular subspace: the minimum-norm least-squares solution
            c = torch.linalg.pinv(B) @ rhs
        return torch.einsum("k,kij->ij", c[:n], torch.stack(self.F_hist))


def damping_factor(delta_e: float) -> float:
    """Dynamic damping weight (reference SCF.jl:504-505): for |dE| >= 1,
    F <- x F + (1-x) F_old with x = 1/log_50(50 |dE|)."""
    de = abs(delta_e)
    if de < 1.0:
        return 1.0
    return 1.0 / (math.log(50.0 * de) / math.log(50.0))
