"""The whole DF-RHF slice of the PyTorch port vs the JAX package, on the CPU.

Same input through both packages' run_spec: energy within 1e-8 Eh, MO
energies 1e-8, dipole (Debye) and Mulliken/Lowdin populations 1e-6.
``mixed_precision`` is pinned the same on both sides (ROADMAP.md C4).
Out-of-slice options raise NotImplementedError instead of running some
other path; conventional RHF and the DF guess are held in
tests/test_torch_conventional*.py.
"""

import pytest

import juliachem_jl_tpu as jx
import juliachem_jl_tpu_torch as tc
from juliachem_jl_tpu_torch import interop
from tests._torch_parity import WATER, assert_close

PROPS = {"mo energies": True, "mulliken": True, "lowdin": True,
         "multipole": "dipole", "formation": True}

CASES = {
    # (primary, auxiliary, extra scf keywords)
    "631g-dense": ("6-31G", "cc-pVDZ-JKFIT", {}),
    "631g-packed-f64only": ("6-31G", "cc-pVDZ-JKFIT",
                            {"contraction_mode": "screened",
                             "mixed_precision": False}),
    "631+gs-packed": ("6-31+G*", "cc-pVTZ-JKFIT",
                      {"contraction_mode": "screened"}),
}


def _input(prim, aux, extra, driver="energy", method="RHF"):
    scf = {"scf_type": "df", "niter": 60, "dele": 1e-9, "rmsd": 1e-7,
           "guess": "sad", **extra}
    return {"molecule": WATER, "driver": driver,
            "model": {"method": method, "basis": prim, "auxiliary_basis": aux},
            "keywords": {"scf": scf, "prop": PROPS}}


@pytest.mark.parametrize("case", list(CASES))
def test_run_spec_matches_jax(case):
    inp = _input(*CASES[case])
    ref = jx.run_spec(jx.io.parse_input(inp))
    tc.initialize("cpu")
    try:
        got = tc.run_spec(tc.io.parse_input(inp))
    finally:
        tc.finalize()
    re, ge = ref["Energy"], got["Energy"]
    assert ge["Converged?"] and re["Converged?"]
    route = ("ScreenedDFFockBuilder" if "packed" in case else "DFFockBuilder")
    assert ge["Timings"].non_timing_data["fock_builder"] == route
    assert abs(ge["Energy"] - re["Energy"]) <= 1e-8
    rp, gp = ref["Properties"], got["Properties"]
    assert_close(gp["MO Energies"]["energies"], rp["MO Energies"]["energies"],
                 1e-8)
    assert_close(gp["Dipole"]["total"], rp["Dipole"]["total"], 1e-6)
    assert_close(gp["Mulliken Population"], rp["Mulliken Population"], 1e-6)
    assert_close(gp["Lowdin Population"], rp["Lowdin Population"], 1e-6)
    assert abs(gp["Formation Energy"] - rp["Formation Energy"]) <= 1e-8


OUT_OF_SLICE = {
    "uhf": {"method": "UHF"},
    "gradient": {"driver": "gradient"},
    "multi-device": {"scf": {"num_devices": 2}},
    "conventional-multi-device": {"scf": {"scf_type": "rhf",
                                          "num_devices": 2}},
    "fdiff": {"scf": {"fdiff": True}},
    "restart": {"scf": {"restart": "ckpt.npz"}},
    "b-cache": {"scf": {"df_b_cache": "runs/x"}},
    "f32-B": {"scf": {"df_b_dtype": "f32"}},
}


@pytest.mark.parametrize("case", list(OUT_OF_SLICE))
def test_out_of_slice_raises(case):
    spec = OUT_OF_SLICE[case]
    inp = _input("6-31G", "cc-pVDZ-JKFIT", spec.get("scf", {}),
                 driver=spec.get("driver", "energy"),
                 method=spec.get("method", "RHF"))
    with pytest.raises(NotImplementedError):
        tc.run_spec(tc.io.parse_input(inp), device="cpu")


def _scf_table(capsys, energy, *args, **kw) -> list[float]:
    """Total energy of every iteration, from the SCF table that
    ``models.rhf.energy(..., output=2)`` prints."""
    capsys.readouterr()
    energy(*args, output=2, **kw)
    rows = [ln.split() for ln in capsys.readouterr().out.splitlines()]
    return [float(f[1]) for f in rows if len(f) >= 5 and f[0].isdigit()]


@pytest.mark.parametrize("case", ["631g-dense", "631+gs-packed"])
def test_hcore_damped_trajectory_matches_jax(capsys, case):
    """DF-RHF from the core-Hamiltonian guess with the dynamic damping on
    (the DF phase of ``guess: "df"``): the port walks the JAX package's SCF
    path iteration by iteration, each energy within 1e-8 Eh."""
    prim, aux, extra = CASES[case]
    flags = {"scf_type": "df", "guess": "hcore", "mixed_precision": False,
             "niter": 30, "dele": 1e-9, "rmsd": 1e-7, **extra}
    mol = jx.molecule.from_input_dict(WATER)
    bsets = jx.basis.CalculationBasisSets(
        jx.basis.build(mol, prim), jx.basis.build_auxiliary(mol, aux, prim))
    ref = _scf_table(capsys, jx.models.rhf.energy, mol, bsets, flags)
    got = _scf_table(capsys, tc.models.rhf.energy, interop.molecule(mol),
                     interop.basis_sets(bsets), flags, device="cpu")
    assert len(ref) > 5
    assert len(got) == len(ref)
    assert_close(got, ref, 1e-8)
