"""Conventional RHF through run_spec: the PyTorch port (plain versions, on
the CPU) vs the JAX package, on water 6-31G*.

The conventional run and the DF guess (DF iterations with cc-pVDZ-JKFIT,
then conventional ones): energy within 1e-8 Eh, MO energies 1e-8, dipole
(Debye) and Mulliken populations 1e-6; ``mixed_precision`` pinned the same
on both sides (ROADMAP.md C4).
"""

import pytest

import juliachem_jl_tpu as jx
import juliachem_jl_tpu_torch as tc
from tests._torch_parity import CPU, WATER, assert_close

PROPS = {"mo energies": True, "mulliken": True, "multipole": "dipole"}


def _input(scf_extra, aux=None):
    scf = {"scf_type": "rhf", "niter": 60, "dele": 1e-9, "rmsd": 1e-7,
           "guess": "sad", **scf_extra}
    model = {"method": "RHF", "basis": "6-31G*"}
    if aux:
        model["auxiliary_basis"] = aux
    return {"molecule": WATER, "driver": "energy", "model": model,
            "keywords": {"scf": scf, "prop": PROPS}}


RUNS = {
    # (scf keywords, auxiliary basis, port route)
    "conventional": ({}, None, "ScreenedDirectFock"),
    "df-guess": ({"guess": "df", "mixed_precision": False}, "cc-pVDZ-JKFIT",
                 "ScreenedDirectFock"),
}


@pytest.mark.parametrize("case", list(RUNS))
def test_run_spec_conventional_matches_jax(case):
    extra, aux, route = RUNS[case]
    inp = _input(extra, aux)
    ref = jx.run_spec(jx.io.parse_input(inp))
    got = tc.run_spec(tc.io.parse_input(inp), device=CPU)
    re, ge = ref["Energy"], got["Energy"]
    assert ge["Converged?"] and re["Converged?"]
    assert ge["Timings"].non_timing_data["fock_builder"] == route
    assert abs(ge["Energy"] - re["Energy"]) <= 1e-8
    rp, gp = ref["Properties"], got["Properties"]
    assert_close(gp["MO Energies"]["energies"], rp["MO Energies"]["energies"],
                 1e-8)
    assert_close(gp["Dipole"]["total"], rp["Dipole"]["total"], 1e-6)
    assert_close(gp["Mulliken Population"], rp["Mulliken Population"], 1e-6)
    if case == "df-guess":
        nt = ge["Timings"].non_timing_data
        assert nt["df_guess_builder"] == "DFFockBuilder"
        assert int(nt["df_guess_iterations"]) > 0
