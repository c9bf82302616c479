"""Molecule representation and geometry handling.

Parity with reference src/modules/MolStructs.jl (Atom/Molecule) and
src/basis/JCBasis.jl:58-101 (Angstrom->Bohr conversion, center-of-mass shift),
plus src/molecule/JCMolecule.jl coordinate printing.  Unlike the reference
there is no dual Julia/C++ representation to keep in sync — a Molecule is a
plain dataclass over numpy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils import elements
from . import analysis  # noqa: F401


@dataclass
class Molecule:
    z: np.ndarray        # (natom,) atomic numbers
    symbols: list[str]   # element symbols
    coords: np.ndarray   # (natom, 3) in Bohr, COM-shifted
    charge: int = 0
    multiplicity: int = 1  # 2S+1 (used by the UHF driver; RHF requires 1)

    @property
    def natom(self) -> int:
        return len(self.z)

    @property
    def nelectrons(self) -> int:
        return int(self.z.sum()) - self.charge

    def nuclear_repulsion(self) -> float:
        """E_nuc = sum_{i<j} Z_i Z_j / r_ij; reference EnergyHelpers.jl:5-23."""
        diff = self.coords[:, None, :] - self.coords[None, :, :]
        r = np.sqrt((diff**2).sum(-1))
        zz = np.outer(self.z, self.z)
        iu = np.triu_indices(self.natom, k=1)
        return float((zz[iu] / r[iu]).sum()) if self.natom > 1 else 0.0


def from_input_dict(molecule: dict) -> Molecule:
    """Build a Molecule from the input JSON molecule section.

    Applies the reference's conventions: geometry is Angstrom, divided by
    0.52917724924 (JCBasis.jl:61), then shifted to the center of mass
    (JCBasis.jl:87-101).
    """
    symbols = [str(s) for s in molecule["symbols"]]
    geom = np.asarray(molecule["geometry"], dtype=np.float64).reshape(-1, 3)
    if geom.shape[0] != len(symbols):
        raise ValueError(
            f"geometry has {geom.shape[0]} atoms but symbols has {len(symbols)}"
        )
    z = np.array([elements.symbol_to_z(s) for s in symbols], dtype=np.int64)
    coords = geom * elements.ANGSTROM_TO_BOHR
    masses = np.array([elements.mass(int(zi)) for zi in z])
    com = (masses[:, None] * coords).sum(0) / masses.sum()
    coords = coords - com
    charge = int(molecule.get("molecular_charge", 0))
    mult = int(molecule.get("molecular_multiplicity", 1))
    return Molecule(z=z, symbols=symbols, coords=coords, charge=charge,
                    multiplicity=mult)


def run(inp, output: int = 0) -> Molecule:
    """API parity with JCMolecule.run (JCMolecule.jl:27-53): build the
    molecule and optionally print coordinates."""
    mol = from_input_dict(inp.molecule if hasattr(inp, "molecule") else inp)
    if output >= 1:
        print("-" * 40)
        print("Molecular coordinates (Bohr, COM frame):")
        for s, xyz in zip(mol.symbols, mol.coords):
            print(f"  {s:3s} {xyz[0]:14.8f} {xyz[1]:14.8f} {xyz[2]:14.8f}")
        print(f"  charge = {mol.charge}, electrons = {mol.nelectrons}")
        print("-" * 40)
    return mol
