"""Geometry optimization and harmonic frequencies of the PyTorch port vs the
JAX package (the cases of tests/test_optimize.py), both on the CPU:

- H2 RHF/6-31G from 0.9 A: the final energy within 1e-9 Eh and geometry
  within 1e-5 bohr of the JAX package's BFGS run, fewer steps than the
  budget, the trajectory's energies step by step within 1e-9 Eh;
- the OH radical by UHF from 1.10 A (gtol 1e-4), as DF-UHF (6-31G /
  cc-pVDZ-JKFIT): the JAX package's conventional UHF optimization takes
  ~40 s on the CPU, its DF one ~2 s;
- H2 RHF/6-31G frequencies at the JAX package's optimized geometry within
  0.01 cm^-1, translations and rotations near zero;
- the input-file drivers ``gradient``, ``optimize`` and ``frequencies``
  through run_file (H2 STO-3G), each against the port's own direct call.
"""

import json

import numpy as np
import pytest

import juliachem_jl_tpu as jx
import juliachem_jl_tpu_torch as tc
from juliachem_jl_tpu.models import hessian as jx_hessian
from juliachem_jl_tpu.models import optimize as jx_optimize
from juliachem_jl_tpu_torch import interop
from juliachem_jl_tpu_torch.models import hessian as tc_hessian
from juliachem_jl_tpu_torch.models import optimize as tc_optimize
from tests._torch_parity import CPU, assert_close

H2 = {"symbols": ["H", "H"], "geometry": [0, 0, 0, 0, 0, 0.9]}
OH = {"symbols": ["O", "H"], "geometry": [0, 0, 0, 0, 0, 1.10],
      "molecular_multiplicity": 2}


def _both(molecule):
    mol = jx.molecule.from_input_dict(molecule)
    return mol, interop.molecule(mol)


@pytest.fixture(scope="module")
def h2_opt():
    mol, pm = _both(H2)
    model = {"basis": "6-31G"}
    return (jx_optimize.optimize(mol, model),
            tc_optimize.optimize(pm, model, device=CPU))


def test_optimize_h2_rhf(h2_opt):
    ref, out = h2_opt
    assert out["Converged?"] and ref["Converged?"]
    assert abs(out["Energy"] - ref["Energy"]) <= 1e-9
    assert_close(out["Molecule"].coords, ref["Molecule"].coords, 1e-5)
    assert out["Steps"] == ref["Steps"]
    assert_close(np.array(out["Trajectory"])[:, 0],
                 np.array(ref["Trajectory"])[:, 0], 1e-9)
    assert out["Energy"] < out["Trajectory"][0][0]


def test_optimize_oh_uhf():
    mol, pm = _both(OH)
    model = {"basis": "6-31G", "auxiliary_basis": "cc-pVDZ-JKFIT"}
    flags = {"scf_type": "df"}
    ref = jx_optimize.optimize(mol, model, flags, method="UHF", gtol=1e-4)
    out = tc_optimize.optimize(pm, model, flags, method="UHF", gtol=1e-4,
                               device=CPU)
    assert out["Converged?"] and ref["Converged?"]
    assert abs(out["Energy"] - ref["Energy"]) <= 1e-9
    assert_close(out["Molecule"].coords, ref["Molecule"].coords, 1e-5)
    assert np.abs(out["Gradient"]).max() < 1e-4
    assert out["SCF Result"]["S2"] > 0.75


def test_frequencies_h2(h2_opt):
    ref_opt, _ = h2_opt
    mol = ref_opt["Molecule"]
    ref = jx_hessian.frequencies(mol, {"basis": "6-31G"})
    out = tc_hessian.frequencies(interop.molecule(mol), {"basis": "6-31G"},
                                 device=CPU)
    assert out["Frequencies"].shape == (1,)
    assert_close(out["Frequencies"], ref["Frequencies"], 0.01)
    assert_close(out["Hessian"], ref["Hessian"], 1e-7)
    assert np.sort(np.abs(out["All Frequencies"]))[:5].max() < 60.0


@pytest.mark.parametrize("driver", ["gradient", "optimize", "frequencies"])
def test_run_file_drivers(tmp_path, driver):
    """The input-file route of each derivative driver (H2 STO-3G): the
    result of run_file equals the direct call's."""
    spec = {"molecule": {**H2, "geometry": [0, 0, 0, 0, 0, 0.74]},
            "driver": driver, "model": {"method": "RHF", "basis": "STO-3G"},
            "keywords": {"scf": {"niter": 50, "dele": 1e-10, "rmsd": 1e-8}}}
    path = tmp_path / f"h2_{driver}.json"
    path.write_text(json.dumps(spec))
    out = tc.run_file(str(path), device=CPU)["Energy"]
    mol = tc.molecule.from_input_dict(spec["molecule"])
    flags = spec["keywords"]["scf"]
    if driver == "gradient":
        from juliachem_jl_tpu_torch.models import gradient

        g = gradient.run(mol, tc.basis.run(mol, spec["model"]), flags,
                         device=CPU)["Gradient"]
        assert_close(out["Gradient"], g, 1e-12)
        assert 1e-4 < abs(float(g[1, 2])) < 0.1
    elif driver == "optimize":
        ref = tc_optimize.optimize(mol, spec["model"], flags, device=CPU)
        assert out["Converged?"] and out["Steps"] == ref["Steps"]
        assert abs(out["Energy"] - ref["Energy"]) <= 1e-12
    else:
        ref = tc_hessian.frequencies(mol, spec["model"], flags, device=CPU)
        assert_close(out["Frequencies"], ref["Frequencies"], 1e-9)
        assert "MO Energies" in out


def test_derivative_entry_points_default_to_the_card():
    """gradient.run, optimize and frequencies resolve device=None to the
    card and raise without one: never a quiet CPU run."""
    import torch

    from juliachem_jl_tpu_torch.models import gradient

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    mol = tc.molecule.from_input_dict(H2)
    model = {"basis": "STO-3G"}
    for call in (lambda: gradient.run(mol, tc.basis.run(mol, model)),
                 lambda: tc_optimize.optimize(mol, model),
                 lambda: tc_hessian.frequencies(mol, model)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
