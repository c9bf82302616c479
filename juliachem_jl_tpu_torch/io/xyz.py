"""XYZ geometry import.

Parity with reference src/io/xyz_to_molecule.jl:3-81: parse a .xyz file into
the molecule dict shape used by input JSONs (flat geometry list in Angstrom,
symbols list, molecular charge).
"""

from __future__ import annotations


def xyz_to_molecule_dict(path: str, charge: int = 0) -> dict:
    symbols: list[str] = []
    geometry: list[float] = []
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    try:
        natoms = int(lines[0].split()[0])
        body = lines[2 : 2 + natoms]
    except (ValueError, IndexError):
        # headerless xyz: every line is "Sym x y z"
        body = [ln for ln in lines if len(ln.split()) >= 4]
    for ln in body:
        parts = ln.split()
        symbols.append(parts[0])
        geometry.extend(float(x) for x in parts[1:4])
    return {
        "symbols": symbols,
        "geometry": geometry,
        "molecular_charge": charge,
    }
