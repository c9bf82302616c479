"""RHF energies in the g basis: the PyTorch port against the JAX package, on
the CPU (the kernels' plain versions).

6-311++G(3df,3pd)+G (tests/data/6-311ppG_3df_3pd_G.gbs through
``model.basis_file``: one G shell on each O), from the SAD guess (K4's
plain version on the O atom's (gg|gg)), converged to dele 1e-9, rmsd 1e-7,
each against the JAX package's energy recorded in
juliachem_jl_tpu_torch/data/smoke_reference.json (``g_shell``, with the
script that made it) within 1e-8 Eh:

- DF-RHF of the first 2 waters of the generated w32 cluster (cc-pVTZ-JKFIT,
  the dense builder), every pair class to (gg) in K1;
- conventional RHF (in-core ScreenedDirectFock) of the first water, every
  one-centre g class pair to (gg|gg) in K4 and K6.  The water dimer's
  conventional run (chip_smoke.py phase 11 holds the card to its JAX
  energy) takes minutes on the CPU: its in-core fill evaluates every g
  quartet through the plain version.

The JAX package compiles its 120 ERI class programs for ~15-20 minutes on
a CPU for a conventional run in this basis, too long for this suite.
"""

import json
from pathlib import Path

import pytest

import juliachem_jl_tpu_torch as tc
from tests._torch_parity import CPU
from tests.test_torch_fshell_k4 import two_waters
from tests.test_torch_gshell_k4 import G_BASIS, G_FILE

REFERENCE = (Path(__file__).resolve().parents[1] / "juliachem_jl_tpu_torch"
             / "data" / "smoke_reference.json")


def _waters(n: int) -> dict:
    mol = two_waters()
    return {**mol, "symbols": mol["symbols"][:3 * n],
            "geometry": mol["geometry"][:9 * n]}


def _input(n: int, scf_type: str) -> dict:
    """The flags of the recorded references (smoke_ref_gshell.py)."""
    model = {"method": "RHF", "basis": G_BASIS, "basis_file": str(G_FILE)}
    scf = {"scf_type": scf_type, "niter": 60, "dele": 1e-9, "rmsd": 1e-7,
           "guess": "sad"}
    if scf_type == "df":
        model["auxiliary_basis"] = "cc-pVTZ-JKFIT"
        scf["mixed_precision"] = False
    return {"molecule": _waters(n), "driver": "energy", "model": model,
            "keywords": {"scf": scf}}


def _recorded(key: str) -> dict:
    return json.loads(REFERENCE.read_text())["g_shell"]["systems"][key]


@pytest.mark.parametrize("n,scf_type,builder", [
    (2, "df", "DFFockBuilder"), (1, "rhf", "ScreenedDirectFock")],
    ids=["w2-df", "w1-rhf"])
def test_rhf_matches_recorded_jax(n, scf_type, builder):
    rec = _recorded(f"w{n} {G_BASIS} {'DF' if scf_type == 'df' else 'RHF'}")
    assert rec["flags"] == _input(n, scf_type)["keywords"]["scf"]
    got = tc.run_spec(tc.io.parse_input(_input(n, scf_type)),
                      device=CPU)["Energy"]
    assert got["Converged?"] and rec["converged"]
    assert got["Timings"].non_timing_data["fock_builder"] == builder
    assert abs(float(got["Energy"]) - rec["energy"]) <= 1e-8


def test_recorded_g_references_are_converged():
    """The recorded JAX energies that chip_smoke.py phase 11 holds the card
    to, in the basis of the file."""
    systems = json.loads(REFERENCE.read_text())["g_shell"]["systems"]
    assert f"w2 {G_BASIS} RHF" in systems
    for rec in systems.values():
        assert rec["converged"] and rec["basis"] == G_BASIS
