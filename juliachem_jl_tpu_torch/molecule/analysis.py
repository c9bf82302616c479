"""Geometry analysis: bond lengths, angles.

Port of ``juliachem_jl_tpu/molecule/analysis.py`` (parity target: reference
src/molecule/MoleculeAnalysis.jl, present but commented out in the
snapshot, :36-199): covalent-radius bond detection, bond-length table, bond
angles.  Host numpy on the Molecule's coordinates.
"""

from __future__ import annotations

import numpy as np

from ..utils.elements import z_to_symbol

# covalent radii (Angstrom), Cordero et al. 2008, H..Ar subset + fallbacks
_COVALENT_R = {
    1: 0.31, 2: 0.28, 3: 1.28, 4: 0.96, 5: 0.84, 6: 0.76, 7: 0.71, 8: 0.66,
    9: 0.57, 10: 0.58, 11: 1.66, 12: 1.41, 13: 1.21, 14: 1.11, 15: 1.07,
    16: 1.05, 17: 1.02, 18: 1.06,
}
_BOHR = 0.52917724924


def bonds(mol, tolerance: float = 1.2) -> list[tuple[int, int, float]]:
    """(i, j, r_bohr) for atom pairs closer than tolerance x sum of covalent
    radii."""
    out = []
    coords = mol.coords
    for i in range(mol.natom):
        for j in range(i + 1, mol.natom):
            r = float(np.linalg.norm(coords[i] - coords[j]))
            rc = (_COVALENT_R.get(int(mol.z[i]), 1.5)
                  + _COVALENT_R.get(int(mol.z[j]), 1.5)) / _BOHR
            if r <= tolerance * rc:
                out.append((i, j, r))
    return out


def bond_angles(mol, bond_list=None) -> list[tuple[int, int, int, float]]:
    """(i, j, k, angle_deg) for bonded triplets i-j-k (j is the vertex)."""
    bl = bonds(mol) if bond_list is None else bond_list
    neigh: dict[int, list[int]] = {}
    for i, j, _ in bl:
        neigh.setdefault(i, []).append(j)
        neigh.setdefault(j, []).append(i)
    out = []
    for j, ns in neigh.items():
        for a in range(len(ns)):
            for b in range(a + 1, len(ns)):
                i, k = ns[a], ns[b]
                v1 = mol.coords[i] - mol.coords[j]
                v2 = mol.coords[k] - mol.coords[j]
                cosang = float(v1 @ v2 / (np.linalg.norm(v1)
                                          * np.linalg.norm(v2)))
                out.append((i, j, k, float(np.degrees(
                    np.arccos(np.clip(cosang, -1, 1))))))
    return out


def print_analysis(mol, printer=print) -> None:
    bl = bonds(mol)
    printer("Bond lengths (Bohr):")
    for i, j, r in bl:
        printer(f"  {z_to_symbol(int(mol.z[i]))}{i + 1:<3d}-"
                f"{z_to_symbol(int(mol.z[j]))}{j + 1:<3d} {r:10.5f}")
    printer("Bond angles (deg):")
    for i, j, k, a in bond_angles(mol, bl):
        printer(f"  {i + 1:3d}-{j + 1:3d}-{k + 1:3d} {a:10.3f}")
