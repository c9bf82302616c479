"""End-to-end driver: input file -> energy + properties.

Port of ``juliachem_jl_tpu/driver.py`` (the reference's canonical script
sequence, example_scripts/full-rhf.jl):
  initialize -> JCInput.run -> JCMolecule.run -> JCBasis.run ->
  JCRHF.Energy.run -> JCRHF.Properties.run -> finalize.
Closed-shell RHF energies, density-fitted or conventional (no auxiliary
basis needed for ``scf_type: "rhf"``); every other method or driver raises
NotImplementedError naming its ROADMAP.md item.
"""

from __future__ import annotations

from . import basis as basis_mod
from . import io as io_mod
from . import molecule as molecule_mod
from .models import properties as properties_mod
from .models import rhf as rhf_mod


def run_spec(spec, output: int = 0, device=None) -> dict:
    """Run a parsed input on ``device`` (default: the one given to
    ``initialize``, the card unless it named the CPU)."""
    method = str(spec.model.get("method", "RHF")).upper()
    if method != "RHF":
        raise NotImplementedError(
            f"method {method} is not ported yet (ROADMAP.md A8: UHF/ROHF)")
    if spec.driver != "energy":
        raise NotImplementedError(
            f"driver {spec.driver!r} is not ported yet (ROADMAP.md A10)")
    mol = molecule_mod.run(spec, output=output)
    bsets = basis_mod.run(mol, spec.model, output=output)
    scf_flags = dict(spec.scf_keywords)
    if spec.auxiliary_basis and "scf_type" not in scf_flags:
        scf_flags["scf_type"] = "df"
    result = rhf_mod.energy(mol, bsets, scf_flags, output=output,
                            device=device)
    props = properties_mod.run(mol, bsets, result, spec.prop_keywords,
                               output=output)
    return {
        "Input": spec,
        "Molecule": mol,
        "Basis": bsets,
        "Energy": result,
        "Properties": props,
    }


def run_file(path: str, output: int = 0, device=None) -> dict:
    """Run a QCSchema-style JSON input file end to end."""
    spec = io_mod.read_input(path, output=output)
    return run_spec(spec, output=output, device=device)
