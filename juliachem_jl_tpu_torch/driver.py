"""End-to-end driver: input file -> energy + properties.

Port of ``juliachem_jl_tpu/driver.py`` (the reference's canonical script
sequence, example_scripts/full-rhf.jl):
  initialize -> JCInput.run -> JCMolecule.run -> JCBasis.run ->
  JCRHF.Energy.run -> JCRHF.Properties.run -> finalize.
RHF, UHF and ROHF, density-fitted or conventional (no auxiliary basis
needed for ``scf_type: "rhf"``), in a Cartesian or spherical-harmonic AO
basis; the drivers ``energy``, ``gradient`` (the analytic nuclear
gradient), ``optimize`` (BFGS) and ``frequencies`` (central differences of
the analytic gradient), as the JAX package's ``driver.py``.  Any other
method name raises ValueError.
"""

from __future__ import annotations

from . import basis as basis_mod
from . import io as io_mod
from . import molecule as molecule_mod
from .models import properties as properties_mod
from .models import rhf as rhf_mod
from .models import rohf as rohf_mod
from .models import uhf as uhf_mod

_ENERGY = {"RHF": rhf_mod.energy, "UHF": uhf_mod.energy,
           "ROHF": rohf_mod.energy}


def run_spec(spec, output: int = 0, device=None) -> dict:
    """Run a parsed input on ``device`` (default: the one given to
    ``initialize``, the card unless it named the CPU).  ``model.method``
    picks RHF (the default), UHF or ROHF, as the JAX package's
    ``_energy_for`` does.  Unlike that one, which runs RHF for any other
    name, this raises ValueError, so that a mistyped open-shell request
    does not return a closed-shell energy."""
    method = str(spec.model.get("method", "RHF")).upper()
    if method not in _ENERGY:
        raise ValueError(f"model.method {method!r}: expected one of "
                         f"{', '.join(_ENERGY)}")
    mol = molecule_mod.run(spec, output=output)
    bsets = basis_mod.run(mol, spec.model, output=output)
    scf_flags = dict(spec.scf_keywords)
    if spec.auxiliary_basis and "scf_type" not in scf_flags:
        scf_flags["scf_type"] = "df"
    if spec.driver == "optimize":
        from .models import optimize as optimize_mod

        result = optimize_mod.optimize(mol, spec.model, scf_flags,
                                       method=method, output=output,
                                       device=device)
        result = {**result.pop("SCF Result"), **result}
    elif spec.driver == "frequencies":
        from .models import hessian as hessian_mod

        freq = hessian_mod.frequencies(mol, spec.model, scf_flags,
                                       method=method, output=output,
                                       device=device)
        result = {**_ENERGY[method](mol, bsets, scf_flags, output=output,
                                    device=device), **freq}
    elif spec.driver == "gradient":
        from .models import gradient as gradient_mod

        result = gradient_mod.run(mol, bsets, scf_flags, output=output,
                                  method=method, device=device)
    else:
        result = _ENERGY[method](
            mol, bsets, scf_flags, output=output, device=device)
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
