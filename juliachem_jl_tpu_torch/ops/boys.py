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


_ROWS = 1 << 18  # Boys arguments a chunk of boys_rows ([2^18, 128] f64)


def boys_rows(T: torch.Tensor, mmax: int) -> torch.Tensor:
    """``boys`` with the series' terms formed side by side (a cumulative
    product of the term ratios 2T / (2 mmax + 2k + 3), then one sum) in
    place of 128 dependent steps: the same series, recursions and branches
    in a few operations a chunk of ``_ROWS`` arguments, for callers whose
    batches are bound by their launches on the card (the derivative
    programs of ops/oei_grad.py and ops/eri_grad.py).  Equal to ``boys`` to
    rounding; ``boys`` stays the kernels' plain form, whose one-step-at-a-time
    series is the device's (the K3 probe holds the two within 1e-14)."""
    flat = T.reshape(-1)
    k = torch.arange(_NSERIES, dtype=T.dtype, device=T.device)
    inv = 1.0 / (2.0 * mmax + 2.0 * k + 3.0)
    parts = []
    for s in range(0, max(flat.shape[0], 1), _ROWS):
        t = flat[s:s + _ROWS]
        Ts = torch.clamp(t, max=TCRIT)
        Tl = torch.clamp(t, min=TCRIT)
        expTs = torch.exp(-Ts)
        terms = torch.cumprod((2.0 * Ts)[:, None] * inv[None, :], dim=1)
        fs = expTs * (1.0 + terms.sum(dim=1)) / (2.0 * mmax + 1.0)
        small = [fs]
        for m in range(mmax - 1, -1, -1):   # downward: stable
            small.append((2.0 * Ts * small[-1] + expTs) / (2.0 * m + 1.0))
        large = [0.5 * torch.sqrt(math.pi / Tl)]
        expTl, inv2T = torch.exp(-Tl), 0.5 / Tl
        for m in range(1, mmax + 1):        # upward: stable for T > TCRIT
            large.append(((2.0 * m - 1.0) * large[-1] - expTl) * inv2T)
        parts.append(torch.where((t <= TCRIT)[:, None],
                                 torch.stack(small[::-1], dim=-1),
                                 torch.stack(large, dim=-1)))
    return torch.cat(parts).reshape(T.shape + (mmax + 1,))


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
