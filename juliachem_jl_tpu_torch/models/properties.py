"""Molecular properties (parity with src/rhf/properties/Properties.jl).

Port of ``juliachem_jl_tpu/models/properties.py``.  Keyword-driven:
{"mo energies": true, "mulliken": true, "lowdin": true, "multipole":
"dipole", "formation": true}.  The sums run on the device of the SCF result;
the properties come back as host numpy arrays and Python floats.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.elements import AU_TO_DEBYE


def mo_energies(result) -> dict:
    """MO energies + HOMO-LUMO gap (Properties.jl:44-94, OrbitalEnergies.jl)."""
    eps = result["MO Energies"].cpu().numpy()
    nocc = int(round(float(torch.trace(result["Density"] @ result["Overlap"])) / 2.0))
    homo = eps[nocc - 1]
    lumo = eps[nocc] if nocc < len(eps) else np.nan
    return {"energies": eps, "homo": homo, "lumo": lumo,
            "homo_lumo": float(lumo - homo)}


def _atom_sums(mol, basis, per_bf: torch.Tensor) -> np.ndarray:
    bf_atom = torch.as_tensor(basis.bf_to_atom(), device=per_bf.device)
    pops = torch.zeros(mol.natom, dtype=torch.float64, device=per_bf.device)
    pops.index_add_(0, bf_atom, per_bf)
    return pops.cpu().numpy()


def mulliken_populations(mol, basis, result) -> np.ndarray:
    """Per-atom Mulliken populations from (D * S) block sums
    (Mulliken.jl:3-60)."""
    ds = result["Density"] * result["Overlap"]
    return _atom_sums(mol, basis, ds.sum(dim=1))


def mulliken_charges(mol, basis, result) -> np.ndarray:
    return np.asarray(mol.z, dtype=float) - mulliken_populations(mol, basis, result)


def lowdin_populations(mol, basis, result) -> np.ndarray:
    """Per-atom Lowdin populations diag(S^1/2 D S^1/2) block-summed."""
    D, S = result["Density"], result["Overlap"]
    w, U = torch.linalg.eigh(S)
    S_half = (U * torch.sqrt(torch.clamp(w, min=0.0))[None, :]) @ U.T
    diag = torch.einsum("pq,qr,rp->p", S_half, D, S_half)
    return _atom_sums(mol, basis, diag)


def dipole_moment(mol, basis, result) -> dict:
    """Nuclear + electronic dipole in Debye (Multipole.jl:60-117)."""
    from ..ops.oei import dipole_matrices

    D = result["Density"]
    mx, my, mz = dipole_matrices(basis, D.device, origin=np.zeros(3))
    el = -np.array([float(torch.sum(D * m)) for m in (mx, my, mz)])
    nuc = (np.asarray(mol.z, dtype=float)[:, None] * mol.coords).sum(axis=0)
    total = (nuc + el) * AU_TO_DEBYE
    return {
        "nuclear": nuc, "electronic": el, "total": total,
        "moment": float(np.linalg.norm(total)),
    }


def formation_energy(mol, basis, result, atom_energies: dict | None = None) -> float:
    """E_formation = E_tot - sum_atoms E_atom (FormationEnergies.jl:5-29)."""
    from ..basis.eatom import lookup_atom_energy

    e = float(result["Energy"])
    dev = result["Density"].device
    for sym in mol.symbols:
        e -= lookup_atom_energy(sym, basis.name, dev, atom_energies)
    return e


def run(mol, basis_sets, rhf_result, prop_keywords: dict | None = None,
        output: int = 0) -> dict:
    """API parity with JCRHF.Properties.run (Properties.jl:26-42)."""
    kw = prop_keywords or {}
    basis = basis_sets.primary if hasattr(basis_sets, "primary") else basis_sets
    out: dict = {}
    if kw.get("mo energies"):
        out["MO Energies"] = mo_energies(rhf_result)
        if output >= 1:
            print(f"HOMO-LUMO gap: {out['MO Energies']['homo_lumo']:.6f} h")
    if kw.get("mulliken"):
        out["Mulliken Population"] = mulliken_populations(mol, basis, rhf_result)
        if output >= 1:
            print("Mulliken populations:", out["Mulliken Population"])
    if kw.get("lowdin"):
        out["Lowdin Population"] = lowdin_populations(mol, basis, rhf_result)
        if output >= 1:
            print("Lowdin populations:", out["Lowdin Population"])
    if kw.get("multipole") == "dipole":
        out["Dipole"] = dipole_moment(mol, basis, rhf_result)
        if output >= 1:
            print(f"Dipole moment: {out['Dipole']['moment']:.6f} D")
    if kw.get("formation"):
        out["Formation Energy"] = formation_energy(mol, basis, rhf_result)
    return out
