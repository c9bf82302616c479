"""Geometry optimization on the analytic nuclear gradients.

Port of ``juliachem_jl_tpu/models/optimize.py`` (beyond the reference, whose
gradient module is disabled, Gradient.jl:31-32): scipy's BFGS over the
Cartesian coordinates on the host, with the energy and the analytic
RHF/UHF/ROHF gradient (conventional or RI-fitted) of each step computed on
the calculation's device.  Each step rebuilds the basis at the displaced
geometry and converges the SCF tightly from scratch (loose SCF noise
destroys line searches).  Only the 3N-vectors of BFGS live on the host.
"""

from __future__ import annotations

import numpy as np

from .. import basis as basis_mod
from .. import config
from ..molecule import Molecule


def molecule_at(mol, x) -> Molecule:
    """``mol`` with its coordinates (bohr) replaced by x [3N]."""
    return Molecule(z=mol.z, symbols=mol.symbols,
                    coords=np.asarray(x, dtype=np.float64).reshape(-1, 3),
                    charge=mol.charge, multiplicity=mol.multiplicity)


def optimize(mol, model: dict, scf_flags: dict | None = None,
             method: str = "RHF", gtol: float = 3.0e-5,
             maxiter: int = 50, output: int = 0, device=None) -> dict:
    """Minimize the SCF energy over nuclear coordinates on ``device``
    (default: the one given to ``initialize``, the card unless it named the
    CPU).

    model: the input-file model section ({"basis": ..., optionally
    "auxiliary_basis", "spherical", ...}).  The SCF flags default to dele
    1e-9, rmsd 1e-7, niter 80, as in the JAX package.  Returns {"Molecule":
    optimized molecule, "Energy": final energy, "Gradient": final gradient
    [natom, 3] (host numpy), "Converged?": bool, "Steps": n, "Trajectory":
    [(E, |g|max), ...], "SCF Result": the last step's result}.
    """
    from scipy.optimize import minimize

    from . import gradient as gradient_mod

    device = config.resolve_device(device)
    flags = dict(scf_flags or {})
    flags.setdefault("dele", 1e-9)
    flags.setdefault("rmsd", 1e-7)
    flags.setdefault("niter", 80)
    trajectory: list[tuple[float, float]] = []
    state = {"res": None}

    def eval_eg(x):
        m = molecule_at(mol, x)
        res = gradient_mod.run(m, basis_mod.run(m, model), flags,
                               method=method, device=device)
        g = res["Gradient"].cpu().numpy()
        state["res"] = res
        trajectory.append((float(res["Energy"]), float(np.abs(g).max())))
        if output >= 1:
            print(f"opt step {len(trajectory):3d}  E = {res['Energy']:.10f}"
                  f"  |g|max = {np.abs(g).max():.2e}")
        return float(res["Energy"]), g.reshape(-1)

    x0 = np.asarray(mol.coords, dtype=np.float64).reshape(-1)
    out = minimize(eval_eg, x0, jac=True, method="BFGS",
                   options={"gtol": gtol, "maxiter": maxiter})
    g_final = out.jac.reshape(-1, 3)
    return {
        "Molecule": molecule_at(mol, out.x),
        "Energy": float(out.fun),
        "Gradient": g_final,
        "Converged?": bool(np.abs(g_final).max() < gtol),
        "Steps": len(trajectory),
        "Trajectory": trajectory,
        "SCF Result": state["res"],
    }
