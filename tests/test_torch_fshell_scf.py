"""RHF energies in an f basis: the PyTorch port against the JAX package, on
the CPU (the kernels' plain versions).

The first 2 waters of the generated w32 cluster in 6-31G(2df,p) (every
pair class to (ff|ff); the SAD guess runs K4's plain version on the O
atom's (ff|ff)), converged to dele 1e-9, rmsd 1e-7:

- DF-RHF (cc-pVTZ-JKFIT, packed B switched off by size: the dense
  builder) against the JAX package run here, within 1e-8 Eh;
- conventional RHF (in-core ScreenedDirectFock) against the JAX package's
  energy recorded in juliachem_jl_tpu_torch/data/smoke_reference.json
  (``f_shell``, with the script that made it), within 1e-8 Eh: the JAX
  package compiles its 55 ERI class programs for about 5 minutes on a CPU
  first, too long for this suite.
"""

import json
from pathlib import Path

import pytest

import juliachem_jl_tpu as jx
import juliachem_jl_tpu_torch as tc
from tests._torch_parity import CPU
from tests.test_torch_fshell_k4 import F_BASIS, two_waters

REFERENCE = (Path(__file__).resolve().parents[1] / "juliachem_jl_tpu_torch"
             / "data" / "smoke_reference.json")


def _input(scf_type: str) -> dict:
    """The flags of the recorded references (smoke_ref_fshell.py)."""
    model = {"method": "RHF", "basis": F_BASIS}
    scf = {"scf_type": scf_type, "niter": 60, "dele": 1e-9, "rmsd": 1e-7,
           "guess": "sad"}
    if scf_type == "df":
        model["auxiliary_basis"] = "cc-pVTZ-JKFIT"
        scf["mixed_precision"] = False
    return {"molecule": two_waters(), "driver": "energy", "model": model,
            "keywords": {"scf": scf}}


def _port(scf_type: str) -> dict:
    return tc.run_spec(tc.io.parse_input(_input(scf_type)),
                       device=CPU)["Energy"]


def test_df_rhf_matches_jax():
    ref = jx.run_spec(jx.io.parse_input(_input("df")))["Energy"]
    got = _port("df")
    assert got["Converged?"] and ref["Converged?"]
    assert abs(float(got["Energy"]) - float(ref["Energy"])) <= 1e-8


def test_conventional_rhf_matches_recorded_jax():
    rec = json.loads(REFERENCE.read_text())["f_shell"]["systems"][
        f"w2 {F_BASIS} RHF"]
    assert rec["flags"] == _input("rhf")["keywords"]["scf"]
    got = _port("rhf")
    assert got["Converged?"] and rec["converged"]
    assert got["Timings"].non_timing_data["fock_builder"] == \
        "ScreenedDirectFock"
    assert abs(float(got["Energy"]) - rec["energy"]) <= 1e-8


@pytest.mark.parametrize("system,basis", [
    ("w2", F_BASIS), ("benzene_2_water", F_BASIS),
    ("benzene_2_water", "6-311++G(3df,3pd)")])
def test_recorded_df_references_are_converged(system, basis):
    """The recorded JAX energies that chip_smoke.py holds the card to."""
    rec = json.loads(REFERENCE.read_text())["f_shell"]["systems"][
        f"{system} {basis} DF"]
    assert rec["converged"] and rec["basis"] == basis
    assert rec["flags"]["scf_type"] == "df"
