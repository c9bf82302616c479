"""Basis construction (analog of reference JCBasis.run, src/basis/JCBasis.jl:39-166)."""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np

from . import library
from .structs import Basis, Shell, ShellClass, compile_basis, ncart, cart_components, axial_normalization  # noqa: F401

_LMAP = {"S": 0, "P": 1, "D": 2, "F": 3, "G": 4}


@dataclass
class CalculationBasisSets:
    """Primary + optional auxiliary basis (reference BasisStructs.jl:182-185).

    spherical=True requests the real-solid-harmonic AO basis: integrals stay
    Cartesian (the reference convention, and what the MD kernels produce)
    and the SCF runs in the transformed 2l+1 space (basis/spherical.py).
    The reference has no spherical option — this exceeds it."""

    primary: Basis
    auxiliary: Basis | None = None
    spherical: bool = False


def _shells_for_atom(atom_idx: int, center: np.ndarray, spec: list[dict]) -> list[Shell]:
    """Expand a library shell list for one atom, splitting L (sp) shells into
    separate s and p shells exactly as the reference does (JCBasis.jl:244-290)."""
    out: list[Shell] = []
    for entry in spec:
        exps = np.asarray(entry["exps"], dtype=np.float64)
        if entry["l"] == "L":
            out.append(Shell(l=0, atom=atom_idx, center=center, exps=exps,
                             coefs=np.asarray(entry["coefs_s"], dtype=np.float64)))
            out.append(Shell(l=1, atom=atom_idx, center=center, exps=exps,
                             coefs=np.asarray(entry["coefs_p"], dtype=np.float64)))
        else:
            out.append(Shell(l=_LMAP[entry["l"]], atom=atom_idx, center=center,
                             exps=exps,
                             coefs=np.asarray(entry["coefs"], dtype=np.float64)))
    return out


def build(mol, basis_name: str, nels: int | None = None) -> Basis:
    """Build (and normalize/compile) a basis for a molecule."""
    shells: list[Shell] = []
    for ia, sym in enumerate(mol.symbols):
        spec = library.lookup(sym, basis_name)
        shells.extend(_shells_for_atom(ia, mol.coords[ia], spec))
    if nels is None:
        nels = mol.nelectrons
    return compile_basis(shells, nels=nels, name=basis_name)


def build_auxiliary(mol, aux_name: str, primary_name: str) -> Basis:
    """Build the DF auxiliary basis; falls back to even-tempered AutoAux for
    (element, set) pairs missing from the library."""
    shells: list[Shell] = []
    for ia, sym in enumerate(mol.symbols):
        try:
            spec = library.lookup(sym, aux_name)
        except KeyError:
            warnings.warn(
                f"auxiliary basis {aux_name!r} has no data for {sym}; "
                "using even-tempered AutoAux",
                stacklevel=2,
            )
            spec = library.autoaux(library.lookup(sym, primary_name))
        shells.extend(_shells_for_atom(ia, mol.coords[ia], spec))
    return compile_basis(shells, nels=0, name=aux_name)


def register_basis_file(path: str, name: str | None = None) -> str:
    """Load a GAMESS-US format basis file and register it for lookup.

    Returns the registered basis name (the file stem when not given).
    Covers any element — the escape hatch for elements beyond the bundled
    library's exact-data coverage (see basis/external.py)."""
    import os

    from . import external

    data = external.load_basis_file(path)
    if name is None:
        name = os.path.splitext(os.path.basename(path))[0]
    library.register(name, data)
    return name


def run(mol, model: dict, output: int = 0) -> CalculationBasisSets:
    """API parity with JCBasis.run(molecule, model) (JCBasis.jl:39-219)."""
    if model.get("basis_file"):
        register_basis_file(model["basis_file"], model["basis"])
    aux_name = model.get("auxiliary_basis")
    if model.get("auxiliary_basis_file"):
        # a user-supplied aux file without an explicit name still builds an
        # auxiliary basis (under the file-stem name) rather than being
        # silently ignored
        aux_name = register_basis_file(
            model["auxiliary_basis_file"], aux_name)
    primary = build(mol, model["basis"])
    aux = None
    if aux_name:
        aux = build_auxiliary(mol, aux_name, model["basis"])
    if output >= 3:
        print_basis(primary)
        if aux is not None:
            print("--- auxiliary ---")
            print_basis(aux)
    return CalculationBasisSets(primary=primary, auxiliary=aux,
                                spherical=bool(model.get("spherical")))


def print_basis(basis: Basis, printer=print) -> None:
    """Shell table printer (format follows JCBasis's output=3 printout)."""
    printer(f"Basis {basis.name}: {basis.nshell} shells, {basis.nbf} Cartesian functions")
    for i, s in enumerate(basis.shells):
        letter = "SPDFG"[s.l]
        for k in range(s.nprim):
            printer(f"  {i + 1:4d}  {letter}  {k + 1:2d}  {s.exps[k]:16.6f}  {s.coefs[k]:12.6f}")
