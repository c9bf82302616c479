"""Open-shell SCF (UHF, ROHF) of the PyTorch port (plain versions, on the
CPU) vs the JAX package.

- ``two_electron_jk`` of every builder at one numpy-seeded (Da, Db, Ca, Cb)
  on the OH radical: J, K(Da), K(Db) within 1e-10 of the JAX package's
  (conventional builders against the JAX in-core ScreenedDirectFock; the DF
  builders against the JAX builder of the same kind, ``k_blocks`` set on
  both sides; with orbitals and with the eigen-factor of the densities);
- UHF and ROHF energies, conventional and DF (dense and packed B), the same
  flags on both sides: within 1e-8 Eh, S^2 within 1e-8;
- ``guess_mix`` (broken-symmetry stretched H2), the H atom (an empty beta
  channel), the impossible multiplicity, the run_spec route with the Mulliken
  spin populations, and what stays out of the slice (num_devices > 1 with no
  process group, the RHF-only keywords, a spherical AO basis); DF-UHF on an f32 B runs.
"""

import warnings

import numpy as np
import pytest
import torch

import juliachem_jl_tpu as jx
import juliachem_jl_tpu_torch as tc
from juliachem_jl_tpu.models import df as jx_df
from juliachem_jl_tpu.models import df_screened_jk as jx_dfjk
from juliachem_jl_tpu.models import rohf as jx_rohf
from juliachem_jl_tpu.models import uhf as jx_uhf
from juliachem_jl_tpu.ops import fock as jx_fock
from juliachem_jl_tpu.utils.options import create_scf_options as jx_options
from juliachem_jl_tpu.utils.timings import Timings as JxTimings
from juliachem_jl_tpu_torch import interop
from juliachem_jl_tpu_torch.models import df as tc_df
from juliachem_jl_tpu_torch.models import df_screened_jk as tc_dfjk
from juliachem_jl_tpu_torch.models import rohf as tc_rohf
from juliachem_jl_tpu_torch.models import uhf as tc_uhf
from juliachem_jl_tpu_torch.ops import fock as tc_fock
from juliachem_jl_tpu_torch.ops import fock_stream as tc_fock_stream
from juliachem_jl_tpu_torch.utils.options import create_scf_options as tc_options
from juliachem_jl_tpu_torch.utils.timings import Timings
from tests._torch_parity import CPU, assert_close

OH = {"symbols": ["O", "H"], "geometry": [0, 0, 0, 0, 0, 0.97],
      "molecular_multiplicity": 2}


def _system(molecule, prim="6-31G", aux="cc-pVTZ-JKFIT"):
    mol = jx.molecule.from_input_dict(molecule)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bsets = jx.basis.CalculationBasisSets(
            jx.basis.build(mol, prim),
            None if aux is None else jx.basis.build_auxiliary(mol, aux, prim))
    return mol, bsets


@pytest.fixture(scope="module")
def spin_densities():
    """OH radical 6-31G / cc-pVTZ-JKFIT and a numpy-seeded open-shell
    (Ca [nbf, 5], Cb [nbf, 4]) with Da = Ca Ca^T, Db = Cb Cb^T."""
    _, bsets = _system(OH)
    nbf = bsets.primary.nbf
    rng = np.random.default_rng(11)
    Q, _ = np.linalg.qr(rng.standard_normal((nbf, nbf)))
    Ca, Cb = 0.5 * Q[:, :5], 0.5 * Q[:, 1:5]
    return bsets, Ca, Cb, Ca @ Ca.T, Cb @ Cb.T


@pytest.fixture(scope="module")
def conventional_reference(spin_densities):
    bsets, Ca, Cb, Da, Db = spin_densities
    ref = jx_fock.ScreenedDirectFock(bsets.primary, incore=True)
    return {spin: [np.asarray(x) for x in ref.two_electron_jk(
                Da, Da if spin == "closed" else Db, 1, JxTimings())]
            for spin in ("open", "closed")}


CONVENTIONAL = {
    "dense": lambda b: tc_fock.DenseFock(b, CPU),
    "incore": lambda b: tc_fock.ScreenedDirectFock(b, incore=True, device=CPU),
    "direct": lambda b: tc_fock.ScreenedDirectFock(b, incore=False,
                                                   device=CPU),
    "streaming": lambda b: tc_fock_stream.StreamingDirectFock(b, device=CPU),
}


@pytest.mark.parametrize("spin", ["open", "closed"])
@pytest.mark.parametrize("builder", list(CONVENTIONAL))
def test_conventional_two_electron_jk_matches_jax(
        spin_densities, conventional_reference, builder, spin):
    bsets, _, _, Da, Db = spin_densities
    if spin == "closed":
        Db = Da
    fb = CONVENTIONAL[builder](interop.basis(bsets.primary))
    got = fb.two_electron_jk(torch.as_tensor(Da), torch.as_tensor(Db), 1,
                             Timings())
    for g, r in zip(got, conventional_reference[spin]):
        assert_close(g, r, 1e-10)


DF_BUILDERS = {
    # (JAX builder, port builder, k_blocks)
    "dense": (jx_df.DFFockBuilder, tc_df.DFFockBuilder, None),
    "packed-k1": (jx_dfjk.ScreenedDFJKBuilder, tc_dfjk.ScreenedDFJKBuilder, 1),
    "packed-k2": (jx_dfjk.ScreenedDFJKBuilder, tc_dfjk.ScreenedDFJKBuilder, 2),
}


@pytest.mark.parametrize("orbitals", [True, False],
                         ids=["orbitals", "eigen-factor"])
@pytest.mark.parametrize("builder", list(DF_BUILDERS))
def test_df_two_electron_jk_matches_jax(spin_densities, builder, orbitals):
    bsets, Ca, Cb, Da, Db = spin_densities
    jx_cls, tc_cls, k_blocks = DF_BUILDERS[builder]
    flags = {"scf_type": "df", "mixed_precision": False}
    ref = jx_cls(bsets.primary, bsets.auxiliary, jx_options(flags))
    pb = interop.basis_sets(bsets)
    fb = tc_cls.build(pb.primary, pb.auxiliary, tc_options(flags), CPU)
    if k_blocks:
        ref.k_blocks = fb.k_blocks = k_blocks
    C = (Ca, Cb) if orbitals else (None, None)
    want = ref.two_electron_jk(Da, Db, 1, JxTimings(), *C)
    got = fb.two_electron_jk(
        torch.as_tensor(Da), torch.as_tensor(Db), 1, Timings(),
        *(None if c is None else torch.as_tensor(c) for c in C))
    for g, r in zip(got, want):
        assert_close(g, np.asarray(r), 1e-10)


SCF_ROUTES = {
    # (scf keywords, auxiliary basis, port builder)
    "conventional": ({"scf_type": "rhf"}, None, "ScreenedDirectFock"),
    "df-dense": ({"scf_type": "df"}, "cc-pVTZ-JKFIT", "DFFockBuilder"),
    "df-packed": ({"scf_type": "df", "contraction_mode": "screened",
                   "mixed_precision": False}, "cc-pVTZ-JKFIT",
                  "ScreenedDFJKBuilder"),
}
METHODS = {"UHF": (jx_uhf.energy, tc_uhf.energy),
           "ROHF": (jx_rohf.energy, tc_rohf.energy)}


@pytest.mark.parametrize("route", list(SCF_ROUTES))
@pytest.mark.parametrize("method", list(METHODS))
def test_open_shell_energy_matches_jax(method, route):
    extra, aux, builder = SCF_ROUTES[route]
    mol, bsets = _system(OH, aux=aux)
    flags = {"niter": 80, "dele": 1e-9, "rmsd": 1e-7, "guess": "sad", **extra}
    jx_energy, tc_energy = METHODS[method]
    ref = jx_energy(mol, bsets, flags)
    got = tc_energy(interop.molecule(mol), interop.basis_sets(bsets), flags,
                    device=CPU)
    assert ref["Converged?"] and got["Converged?"]
    assert got["Timings"].non_timing_data["fock_builder"] == builder
    assert abs(got["Energy"] - ref["Energy"]) <= 1e-8
    assert abs(got["S2"] - ref["S2"]) <= 1e-8
    assert (got["N Alpha"], got["N Beta"]) == (5, 4)
    assert got["Density"].device.type == "cpu"
    assert_close(got["MO Energies"], ref["MO Energies"], 1e-7)


def test_uhf_guess_mix_breaks_symmetry_as_jax():
    """Stretched H2 from the rotated core-Hamiltonian guess: the same
    broken-symmetry solution (energy 1e-8 Eh, S^2 1e-8)."""
    mol, bsets = _system({"symbols": ["H", "H"],
                          "geometry": [0, 0, 0, 0, 0, 2.5]}, aux=None)
    flags = {"niter": 60, "dele": 1e-10, "rmsd": 1e-8,
             "contraction_mode": "dense", "guess": "hcore", "guess_mix": 0.7}
    ref = jx_uhf.energy(mol, bsets, flags)
    got = tc_uhf.energy(interop.molecule(mol), interop.basis_sets(bsets),
                        flags, device=CPU)
    assert got["Converged?"]
    assert got["Timings"].non_timing_data["fock_builder"] == "DenseFock"
    assert abs(got["Energy"] - ref["Energy"]) <= 1e-8
    assert abs(got["S2"] - ref["S2"]) <= 1e-8
    assert got["S2"] > 0.3


@pytest.mark.parametrize("scf_type", ["rhf", "df"])
def test_uhf_one_electron_matches_jax(scf_type):
    """The H atom: an empty beta channel through both builder families."""
    mol, bsets = _system({"symbols": ["H"], "geometry": [0, 0, 0],
                          "molecular_multiplicity": 2})
    flags = {"scf_type": scf_type, "niter": 30, "dele": 1e-10, "rmsd": 1e-8,
             "guess": "hcore"}
    ref = jx_uhf.energy(mol, bsets, flags)
    got = tc_uhf.energy(interop.molecule(mol), interop.basis_sets(bsets),
                        flags, device=CPU)
    assert got["Converged?"]
    assert abs(got["Energy"] - ref["Energy"]) <= 1e-8
    assert abs(got["S2"] - 0.75) <= 1e-12
    assert (got["N Alpha"], got["N Beta"]) == (1, 0)


def test_uhf_impossible_multiplicity_raises():
    mol, bsets = _system({"symbols": ["O", "H", "H"],
                          "geometry": [0, 0, 0, 0.757, 0.586, 0,
                                       -0.757, 0.586, 0]}, aux=None)
    for energy in (tc_uhf.energy, tc_rohf.energy):
        with pytest.raises(ValueError):
            energy(interop.molecule(mol), interop.basis_sets(bsets),
                   {"multiplicity": 2}, device=CPU)


PROPS = {"mulliken": True, "multipole": "dipole"}


def _spec(method, scf, molecule=OH, aux="cc-pVTZ-JKFIT"):
    model = {"method": method, "basis": "6-31G"}
    if aux:
        model["auxiliary_basis"] = aux
    return {"molecule": molecule, "driver": "energy", "model": model,
            "keywords": {"scf": {"niter": 80, "dele": 1e-9, "rmsd": 1e-7,
                                 "guess": "sad", **scf},
                         "prop": PROPS}}


@pytest.mark.parametrize("method", ["UHF", "ROHF"])
def test_run_spec_routes_open_shell_as_jax(method):
    """run_spec with model.method UHF/ROHF: energy, S^2, dipole and the
    Mulliken (spin) populations of the JAX package's run_spec."""
    inp = _spec(method, {"scf_type": "df"})
    ref = jx.run_spec(jx.io.parse_input(inp))
    got = tc.run_spec(tc.io.parse_input(inp), device=CPU)
    re, ge = ref["Energy"], got["Energy"]
    assert ge["Converged?"] and re["Converged?"]
    assert abs(ge["Energy"] - re["Energy"]) <= 1e-8
    assert abs(ge["S2"] - re["S2"]) <= 1e-8
    rp, gp = ref["Properties"], got["Properties"]
    assert_close(gp["Mulliken Population"], rp["Mulliken Population"], 1e-6)
    assert_close(gp["Mulliken Spin Population"],
                 rp["Mulliken Spin Population"], 1e-6)
    assert abs(gp["Mulliken Spin Population"].sum() - 1.0) <= 1e-8
    assert_close(gp["Dipole"]["total"], rp["Dipole"]["total"], 1e-6)


def test_mo_energies_of_a_uhf_result_as_jax():
    """properties.mo_energies on a UHF result (nocc from tr(D S) / 2): the
    JAX package's HOMO and LUMO, on the broken-symmetry H2 of
    test_uhf_guess_mix_breaks_symmetry_as_jax."""
    inp = _spec("UHF", {"scf_type": "rhf", "contraction_mode": "dense",
                        "guess": "hcore", "guess_mix": 0.7},
                molecule={"symbols": ["H", "H"],
                          "geometry": [0, 0, 0, 0, 0, 2.5]}, aux=None)
    inp["keywords"]["prop"] = {"mo energies": True, "mulliken": True}
    ref = jx.run_spec(jx.io.parse_input(inp))["Properties"]
    got = tc.run_spec(tc.io.parse_input(inp), device=CPU)["Properties"]
    for key in ("homo", "lumo", "homo_lumo"):
        assert abs(got["MO Energies"][key] - ref["MO Energies"][key]) <= 1e-8
    # the sign of an eigenvector, which LAPACK leaves free, decides the atom
    # the rotated guess puts the alpha spin on: compare up to the mirror
    assert_close(np.sort(got["Mulliken Spin Population"]),
                 np.sort(ref["Mulliken Spin Population"]), 1e-6)


OUT_OF_SLICE = {
    "uhf-multi-device": ("UHF", {"scf_type": "df", "num_devices": 2}),
    "rohf-multi-device": ("ROHF", {"scf_type": "rhf", "num_devices": 2}),
    # keywords the JAX package's open-shell loops ignore: the port raises
    "uhf-fdiff": ("UHF", {"scf_type": "df", "fdiff": True}),
    "rohf-checkpoint": ("ROHF", {"scf_type": "rhf",
                                 "checkpoint": "ckpt.npz"}),
}


@pytest.mark.parametrize("case", list(OUT_OF_SLICE) + ["uhf-f32-B"])
def test_open_shell_out_of_slice_raises(case):
    """What the open-shell port does not run raises; DF-UHF on an f32 B
    (out of slice before the large-system chain) runs now, on the packed
    builder (held to the JAX package in tests/test_torch_f32b.py)."""
    if case == "uhf-f32-B":
        out = tc.run_spec(tc.io.parse_input(_spec("UHF", {
            "scf_type": "df", "df_b_dtype": "f32",
            "contraction_mode": "screened"})), device=CPU)["Energy"]
        assert out["Converged?"]
        assert out["Timings"].non_timing_data["fock_builder"] == \
            "ScreenedDFJKBuilder"
        return
    method, scf = OUT_OF_SLICE[case]
    # num_devices > 1 runs over a process group of that many ranks
    # (tests/test_torch_sharded.py); without one it raises, saying so
    err, match = ((RuntimeError, "process group") if "multi-device" in case
                  else (NotImplementedError, None))
    with pytest.raises(err, match=match):
        tc.run_spec(tc.io.parse_input(_spec(method, scf)), device=CPU)


@pytest.mark.parametrize("method", ["UFH", "MP2"])
def test_run_spec_unknown_method_raises(method):
    """The JAX package's run_spec runs RHF for any other method name; the
    port raises, so a mistyped open-shell request gives no closed-shell
    energy."""
    with pytest.raises(ValueError, match="model.method"):
        tc.run_spec(tc.io.parse_input(_spec(method, {"scf_type": "df"})),
                    device=CPU)


def test_spherical_basis_raises_for_open_shell():
    """The spherical-harmonic AO basis runs for UHF and ROHF now (it raised
    before it was ported): in 6-31G, which has no d shell, the spherical
    span is the Cartesian one, so the energies agree (the property
    tests/test_spherical.py holds for the JAX package); the JAX package's
    spherical energies are held in tests/test_torch_spherical.py."""
    mol, bsets = _system(OH, aux=None)
    pm, pb = interop.molecule(mol), interop.basis_sets(bsets)
    flags = {"niter": 80, "dele": 1e-10, "rmsd": 1e-8}
    for energy in (tc_uhf.energy, tc_rohf.energy):
        cart = energy(pm, pb, flags, device=CPU)
        pb.spherical = True
        sph = energy(pm, pb, flags, device=CPU)
        pb.spherical = False
        assert cart["Spherical Transform"] is None
        assert sph["Spherical Transform"].shape == (11, 11)
        assert sph["Converged?"] and cart["Converged?"]
        assert abs(sph["Energy"] - cart["Energy"]) < 1e-9


def test_builder_without_spin_resolved_jk_raises():
    from juliachem_jl_tpu_torch.models.scf import FockBuilder

    with pytest.raises(NotImplementedError):
        FockBuilder().two_electron_jk(None, None, 1, Timings())
