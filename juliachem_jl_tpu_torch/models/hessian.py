"""Harmonic vibrational analysis: numerical Hessian of the analytic gradient.

Port of ``juliachem_jl_tpu/models/hessian.py`` (beyond the reference, which
has no working gradients): the Hessian by central differences of the
analytic nuclear gradient (6N gradient evaluations on the calculation's
device), symmetrized, mass-weighted and diagonalized on the host (a 3N x 3N
matrix); translations and rotations are dropped by eigenvalue magnitude.
Frequencies in cm^-1, imaginary modes as negative numbers.
"""

from __future__ import annotations

import numpy as np

from .. import basis as basis_mod
from .. import config
from ..utils import elements
from .optimize import molecule_at

# unit chain: Hessian eigenvalues are Eh / (bohr^2 amu) after mass
# weighting; convert to angular frequency and then wavenumbers
_HARTREE_J = 4.3597447222071e-18
_BOHR_M = 5.29177210903e-11
_AMU_KG = 1.66053906660e-27
_C_CM_S = 2.99792458e10
_EIG_TO_CM1 = (np.sqrt(_HARTREE_J / (_BOHR_M ** 2 * _AMU_KG))
               / (2.0 * np.pi * _C_CM_S))


def hessian(mol, model: dict, scf_flags: dict | None = None,
            method: str = "RHF", step: float = 5.0e-3, output: int = 0,
            device=None) -> np.ndarray:
    """Numerical [3N, 3N] Cartesian Hessian (Eh/bohr^2, host numpy) by
    central differences of the analytic gradient (step in bohr), each
    gradient on ``device``.  The SCF flags default to dele 1e-10, rmsd
    1e-8, niter 100, as in the JAX package."""
    from . import gradient as gradient_mod

    device = config.resolve_device(device)
    flags = dict(scf_flags or {})
    flags.setdefault("dele", 1e-10)
    flags.setdefault("rmsd", 1e-8)
    flags.setdefault("niter", 100)
    n3 = 3 * mol.natom
    H = np.zeros((n3, n3))

    def grad_at(x):
        m = molecule_at(mol, x)
        res = gradient_mod.run(m, basis_mod.run(m, model), flags,
                               method=method, device=device)
        return res["Gradient"].cpu().numpy().reshape(-1)

    x0 = np.asarray(mol.coords, dtype=np.float64).reshape(-1)
    for k in range(n3):
        xp = x0.copy()
        xp[k] += step
        xm = x0.copy()
        xm[k] -= step
        H[k] = (grad_at(xp) - grad_at(xm)) / (2.0 * step)
        if output >= 1:
            print(f"hessian row {k + 1}/{n3}")
    return 0.5 * (H + H.T)


def frequencies(mol, model: dict, scf_flags: dict | None = None,
                method: str = "RHF", step: float = 5.0e-3, output: int = 0,
                device=None) -> dict:
    """Harmonic frequencies (cm^-1) and normal modes: {"Frequencies":
    [n_vib] (negative = imaginary), "Modes": [n_vib, 3N] mass-weighted
    normal modes, "Hessian": [3N, 3N], "All Frequencies": all 3N values
    including translations and rotations (near zero)}."""
    H = hessian(mol, model, scf_flags, method=method, step=step,
                output=output, device=device)
    masses = np.array([elements.mass(int(z)) for z in mol.z])
    inv_sqrt_m = np.repeat(1.0 / np.sqrt(masses), 3)
    w, V = np.linalg.eigh(H * inv_sqrt_m[:, None] * inv_sqrt_m[None, :])
    freqs_all = np.sign(w) * np.sqrt(np.abs(w)) * _EIG_TO_CM1
    # drop the 3 translations and 2 (linear) or 3 rotations: the smallest
    n_tr = 5 if mol.natom == 2 else (3 if mol.natom == 1 else 6)
    vib_idx = np.sort(np.argsort(np.abs(freqs_all))[n_tr:])
    return {
        "Frequencies": freqs_all[vib_idx],
        "Modes": V[:, vib_idx].T,
        "Hessian": H,
        "All Frequencies": freqs_all,
    }
