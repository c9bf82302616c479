"""Boys function F_m(T), vectorized, f64-accurate.

Port of ``juliachem_jl_tpu/ops/boys.py``: the same branch-free algorithm.

* T <= TCRIT: 128-term downward series for F_mmax
  (Helgaker/Jorgensen/Olsen eq. 9.8.12), then stable downward recursion.
* T  > TCRIT: asymptotic F_0 = sqrt(pi/4T) (erf(sqrt T) = 1 to machine eps
  for T > 35) and upward recursion, stable since exp(-T) is negligible.

``boys`` is the plain torch version.  The CUDA integral kernels (csrc/boys.cuh)
evaluate the same recurrences as a device function, K1, K4 and K5
multiplying by compile-time reciprocals where this divides; ``boys_probe``
runs either device form alone, so it can be held against ``boys`` in isolation.
"""

from __future__ import annotations

import math

import torch

from . import kernels

TCRIT = 35.0
_NSERIES = 128
BOYS_PROBE_MMAX = 16  # highest m the probe kernel is instantiated for


def boys(T: torch.Tensor, mmax: int) -> torch.Tensor:
    """Return F_m(T) for m = 0..mmax, stacked on a new trailing axis."""
    Ts = torch.clamp(T, max=TCRIT)      # series-branch argument (clamped)
    Tl = torch.clamp(T, min=TCRIT)      # large-branch argument (clamped)
    expTs = torch.exp(-Ts)

    term = torch.full_like(Ts, 1.0 / (2.0 * mmax + 1.0))
    ssum = term.clone()
    for k in range(_NSERIES):
        term = term * (2.0 * Ts) / (2.0 * mmax + 2.0 * k + 3.0)
        ssum = ssum + term
    f_small = [None] * (mmax + 1)
    f_small[mmax] = expTs * ssum
    for m in range(mmax - 1, -1, -1):   # downward: stable
        f_small[m] = (2.0 * Ts * f_small[m + 1] + expTs) / (2.0 * m + 1.0)

    f_large = [None] * (mmax + 1)
    f_large[0] = 0.5 * torch.sqrt(math.pi / Tl)
    expTl = torch.exp(-Tl)
    inv2T = 0.5 / Tl
    for m in range(1, mmax + 1):        # upward: stable for T > TCRIT > mmax
        f_large[m] = ((2.0 * m - 1.0) * f_large[m - 1] - expTl) * inv2T

    small = T <= TCRIT
    out = [torch.where(small, fs, fl) for fs, fl in zip(f_small, f_large)]
    return torch.stack(out, dim=-1)


def boys_probe(T: torch.Tensor, mmax: int, recip: bool = False
               ) -> torch.Tensor:
    """F_0..F_mmax(T) through the CUDA device Boys function (kernel K3):
    the dividing form, or with ``recip`` the reciprocal form of K1/K4/K5.

    T: 1-D float64.  On a CPU tensor this is ``boys``; on a CUDA tensor it
    launches ``jc_boys_probe`` (``jc_boys_probe_recip``) or raises."""
    if T.dtype != torch.float64 or T.dim() != 1:
        raise ValueError("boys_probe takes a 1-D float64 tensor")
    if not 0 <= mmax <= BOYS_PROBE_MMAX:
        raise ValueError(f"boys_probe: mmax must be in [0, {BOYS_PROBE_MMAX}]")
    if not T.is_cuda:
        return boys(T, mmax)
    T = T.contiguous()
    out = torch.empty((T.shape[0], mmax + 1), dtype=torch.float64,
                      device=T.device)
    kernels.launch("jc_boys_probe_recip" if recip else "jc_boys_probe",
                   T.data_ptr(), T.shape[0], mmax, out.data_ptr())
    return out
