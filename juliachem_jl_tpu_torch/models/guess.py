"""Initial-guess densities.

Port of ``juliachem_jl_tpu/models/guess.py``.

* hcore: F = H (lives in scf.initial_state; reference SCF.jl:107-117).
* SAD: superposition of atomic densities, each the spherically-averaged
  fractional-occupation atomic RHF density of its element, computed on the
  fly (plain torch, on the calculation's device) and cached per
  (element, basis, device).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _fractional_occupations(eps: np.ndarray, nel: float, degen_tol: float = 1e-6):
    """Fill MOs in energy order; electrons within a degenerate set are spread
    equally (spherical averaging)."""
    occ = np.zeros_like(eps)
    rem = float(nel)
    i = 0
    n = len(eps)
    while rem > 1e-12 and i < n:
        j = i
        while j + 1 < n and abs(eps[j + 1] - eps[i]) < degen_tol:
            j += 1
        g = j - i + 1
        fill = min(2.0 * g, rem)
        occ[i : j + 1] = fill / g
        rem -= fill
        i = j + 1
    return occ


@lru_cache(maxsize=None)
def _atomic_scf(symbol: str, basis_name: str, device: torch.device):
    """Spherically-averaged atomic RHF; returns (D_atom, E_atom, nbf)."""
    from .. import basis as basis_mod
    from .. import molecule as molecule_mod
    from ..ops.eri import full_eri_tensor
    from ..ops.oei import overlap_kinetic_nuclear

    mol = molecule_mod.from_input_dict(
        {"symbols": [symbol], "geometry": [0.0, 0.0, 0.0], "molecular_charge": 0}
    )
    b = basis_mod.build(mol, basis_name)
    S, T, V = overlap_kinetic_nuclear(b, mol, device)
    H = T + V
    G = full_eri_tensor(b, device)
    nel = float(mol.z[0])

    # canonical orthogonalization
    s, U = torch.linalg.eigh(S)
    keep = s > 1e-10
    X = U[:, keep] / torch.sqrt(s[keep])

    def density(F):
        Fp = X.T @ F @ X
        eps, Cp = torch.linalg.eigh(Fp)
        C = X @ Cp
        occ = torch.as_tensor(_fractional_occupations(eps.cpu().numpy(), nel),
                              device=device)
        return (C * occ[None, :]) @ C.T, eps

    D, _ = density(H)
    E = 0.0
    for it in range(80):
        J = torch.einsum("pqrs,rs->pq", G, D)
        K = torch.einsum("prqs,rs->pq", G, D)
        F = H + J - 0.5 * K
        E_new = 0.5 * float(torch.sum(D * (H + F)))
        D_new, _ = density(F)
        # static mixing for open-shell fractional-occupation stability
        D = 0.6 * D_new + 0.4 * D
        if abs(E_new - E) < 1e-10 and it > 4:
            E = E_new
            break
        E = E_new
    return D, E, b.nbf


def atomic_rhf_energy(symbol: str, basis_name: str, device) -> float:
    return _atomic_scf(symbol, basis_name, torch.device(device))[1]


def sad_guess(mol, basis, device) -> torch.Tensor:
    """Block-diagonal superposition-of-atomic-densities guess
    (EnergyHelpers.jl:142-170 analog)."""
    device = torch.device(device)
    D = torch.zeros((basis.nbf, basis.nbf), dtype=torch.float64, device=device)
    # per-atom function ranges follow shell offsets
    atom_slices: dict[int, list[int]] = {}
    for s in basis.shells:
        atom_slices.setdefault(s.atom, []).extend(
            range(s.offset, s.offset + s.nbf)
        )
    for ia, sym in enumerate(mol.symbols):
        Da, _, nbf_a = _atomic_scf(sym, basis.name, device)
        idx = torch.as_tensor(atom_slices[ia], device=device)
        if len(idx) != nbf_a:
            raise ValueError(f"SAD block of {sym} has {nbf_a} functions, "
                             f"the atom's shells {len(idx)}")
        D[idx[:, None], idx[None, :]] = Da
    return D
