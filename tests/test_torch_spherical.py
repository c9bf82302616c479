"""The spherical-harmonic AO basis of the PyTorch port vs the JAX package.

The cases of tests/test_spherical.py, run through both packages on the CPU
(the port on ``torch.device("cpu")``, so the kernels' plain versions), each
held within 1e-9 Eh of the JAX package's energy:

- the transform helpers (``lift_rows_sph``, ``project_metric_sph``,
  ``sph_bf_to_atom``) against the JAX package's numpy ones;
- water 6-31G (s/p only: the spherical span is the Cartesian one) and
  6-31G* (a d shell: a strict subspace, E_sph >= E_cart) conventional RHF,
  and 6-31G* DF-RHF;
- properties (MO energies, Mulliken, Lowdin, dipole) in the spherical basis;
- RI-MP2 on spherical orbitals (exact on the s/p basis, the JAX package's
  E2 with the d shell);
- closed-shell UHF = RHF, and the OH doublet by DF-UHF and DF-ROHF;
- the input-file route (``model.spherical``) and a restart from a spherical
  checkpoint (and its refusal by a Cartesian run).

The JAX package's conventional 6-31G* RHF (~30 s of ERI class compiles on
the CPU) runs once, in a module fixture.
"""

import json
import warnings

import numpy as np
import pytest
import torch

import juliachem_jl_tpu as jx
import juliachem_jl_tpu_torch as tc
from juliachem_jl_tpu.basis import spherical as jx_sph
from juliachem_jl_tpu.models import mp2 as jx_mp2
from juliachem_jl_tpu.models import rohf as jx_rohf
from juliachem_jl_tpu.models import uhf as jx_uhf
from juliachem_jl_tpu_torch import interop
from juliachem_jl_tpu_torch.basis import spherical as tc_sph
from juliachem_jl_tpu_torch.models import mp2 as tc_mp2
from juliachem_jl_tpu_torch.models import properties as tc_props
from juliachem_jl_tpu_torch.models import rhf as tc_rhf
from juliachem_jl_tpu_torch.models import rohf as tc_rohf
from juliachem_jl_tpu_torch.models import uhf as tc_uhf
from tests._torch_parity import CPU, WATER, assert_close

TIGHT = {"niter": 60, "dele": 1e-9, "rmsd": 1e-7}
E_TOL = 1e-9
OH = {"symbols": ["O", "H"], "geometry": [0.0, 0.0, 0.0, 0.0, 0.0, 0.9697],
      "molecular_multiplicity": 2}


def _bsets(molecule, prim, aux=None, spherical=True):
    mol = jx.molecule.from_input_dict(molecule)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bs = jx.basis.CalculationBasisSets(
            jx.basis.build(mol, prim),
            jx.basis.build_auxiliary(mol, aux, prim) if aux else None,
            spherical=spherical)
    return mol, bs


def _port(mol, bs):
    return interop.molecule(mol), interop.basis_sets(bs)


@pytest.fixture(scope="module")
def conv_631gs():
    """Water 6-31G* spherical conventional RHF: the JAX package's result
    and the port's, on the same basis."""
    mol, bs = _bsets(WATER, "6-31G*")
    ref = jx.models.rhf.energy(mol, bs, TIGHT)
    pm, pb = _port(mol, bs)
    return mol, bs, ref, tc_rhf.energy(pm, pb, TIGHT, device=CPU)


def test_transform_helpers_match_jax():
    """lift_rows_sph, project_metric_sph and sph_bf_to_atom against the
    JAX package's numpy versions on an aux set with d..g shells."""
    mol = jx.molecule.from_input_dict(WATER)
    aux = jx.basis.build_auxiliary(mol, "cc-pVTZ-JKFIT", "6-31G")
    pa = interop.basis(aux)
    rng = np.random.default_rng(7)
    ns = jx_sph.cart_to_sph_basis(aux).shape[1]
    X = rng.standard_normal((ns, 5))
    assert_close(tc_sph.lift_rows_sph(pa, torch.as_tensor(X)),
                 jx_sph.lift_rows_sph(aux, X), 1e-14)
    M = rng.standard_normal((aux.nbf, aux.nbf))
    M = M + M.T
    assert_close(tc_sph.project_metric_sph(pa, torch.as_tensor(M)),
                 jx_sph.project_metric_sph(aux, M), 1e-12)
    assert np.array_equal(tc_sph.sph_bf_to_atom(pa),
                          jx_sph.sph_bf_to_atom(aux))
    assert_close(tc_sph.sph_transform(pa, CPU),
                 jx_sph.cart_to_sph_basis(aux), 0.0)


def test_sp_basis_energy_invariant():
    """6-31G has no d shell: the spherical energy is the Cartesian one, and
    both equal the JAX package's spherical energy."""
    mol, bs = _bsets(WATER, "6-31G")
    ref = jx.models.rhf.energy(mol, bs, TIGHT)
    pm, pb = _port(mol, bs)
    sph = tc_rhf.energy(pm, pb, TIGHT, device=CPU)
    pb.spherical = False
    cart = tc_rhf.energy(pm, pb, TIGHT, device=CPU)
    assert sph["Converged?"] and sph["Spherical Transform"] is not None
    assert abs(sph["Energy"] - ref["Energy"]) <= E_TOL
    assert abs(sph["Energy"] - cart["Energy"]) <= E_TOL


def test_d_basis_conventional_matches_jax(conv_631gs):
    """6-31G* conventional: the JAX package's energy within 1e-9 Eh, 18
    spherical functions (19 Cartesian), above the Cartesian energy by a
    small gap, and the route's builder recorded (not the adapter)."""
    mol, bs, ref, out = conv_631gs
    assert out["Converged?"]
    assert abs(out["Energy"] - ref["Energy"]) <= E_TOL
    assert out["MO Coeff"].shape == (18, 18)
    assert out["Spherical Transform"].shape == (19, 18)
    nt = out["Timings"].non_timing_data
    assert nt["fock_builder"] == "ScreenedDirectFock"
    assert nt["spherical"] == "True"
    pm, pb = _port(mol, bs)
    pb.spherical = False
    e_cart = tc_rhf.energy(pm, pb, TIGHT, device=CPU)["Energy"]
    assert e_cart - 1e-10 <= out["Energy"] < e_cart + 2e-3


def test_df_matches_jax_in_spherical_basis():
    """6-31G* DF-RHF (cc-pVTZ-JKFIT) in the spherical basis, dense and
    packed builders, within 1e-9 Eh of the JAX package."""
    mol, bs = _bsets(WATER, "6-31G*", "cc-pVTZ-JKFIT")
    flags = {**TIGHT, "scf_type": "df"}
    ref = jx.models.rhf.energy(mol, bs, flags)
    pm, pb = _port(mol, bs)
    for mode in ("dense", "screened"):
        out = tc_rhf.energy(pm, pb, {**flags, "contraction_mode": mode},
                            device=CPU)
        assert out["Converged?"]
        assert abs(out["Energy"] - ref["Energy"]) <= E_TOL, mode


def test_properties_spherical(conv_631gs):
    """MO energies, Mulliken and Lowdin populations and the dipole in the
    spherical basis against the JAX package's on its own orbitals (carried
    by interop), and on the port's converged run."""
    mol, bs, ref, out = conv_631gs
    kw = {"mo energies": True, "mulliken": True, "lowdin": True,
          "multipole": "dipole"}
    jp = jx.models.properties.run(mol, bs, ref, kw)
    pm, pb = _port(mol, bs)
    pp = tc_props.run(pm, pb, interop.scf_result(ref, CPU), kw)
    assert_close(pp["Mulliken Population"], jp["Mulliken Population"], 1e-12)
    assert_close(pp["Lowdin Population"], jp["Lowdin Population"], 1e-12)
    assert_close(pp["Dipole"]["total"], jp["Dipole"]["total"], 1e-12)
    assert_close(pp["MO Energies"]["energies"],
                 jp["MO Energies"]["energies"], 1e-12)
    own = tc_props.run(pm, pb, out, kw)
    assert abs(own["Mulliken Population"].sum() - 10.0) < 1e-10
    assert abs(own["Lowdin Population"].sum() - 10.0) < 1e-10
    assert_close(own["Dipole"]["total"], jp["Dipole"]["total"], 1e-6)


@pytest.mark.parametrize("prim", ["6-31G", "6-31G*"])
def test_mp2_on_spherical_orbitals(prim):
    """RI-MP2 on the JAX package's spherical DF orbitals (C_cart = T C_s):
    the JAX package's E2 within 1e-10 Eh; on 6-31G the Cartesian run's E2
    too (the same span)."""
    mol, bs = _bsets(WATER, prim, "cc-pVTZ-JKFIT")
    flags = {**TIGHT, "scf_type": "df"}
    ref = jx.models.rhf.energy(mol, bs, flags)
    e2_jx = jx_mp2.ri_mp2_energy(ref, bs)["E2"]
    _, pb = _port(mol, bs)
    e2 = tc_mp2.ri_mp2_energy(interop.scf_result(ref, CPU), pb)["E2"]
    assert abs(e2 - e2_jx) <= 1e-10
    if prim == "6-31G":
        bs.spherical = False
        cart = jx.models.rhf.energy(mol, bs, flags)
        e2_cart = tc_mp2.ri_mp2_energy(interop.scf_result(cart, CPU),
                                       interop.basis_sets(bs))["E2"]
        assert abs(e2 - e2_cart) <= 1e-8


def test_uhf_rohf_spherical(conv_631gs):
    """Closed-shell spherical UHF and ROHF equal the JAX package's
    spherical RHF; the OH doublet by DF-UHF and DF-ROHF (6-31G* /
    cc-pVDZ-JKFIT, spherical) within 1e-9 Eh of the JAX package's, with
    E_UHF <= E_ROHF; RI-UMP2 on the UHF orbitals within 1e-10 Eh."""
    mol, bs, ref, _ = conv_631gs
    pm, pb = _port(mol, bs)
    flags = {**TIGHT, "dele": 1e-10, "rmsd": 1e-8}
    u = tc_uhf.energy(pm, pb, flags, device=CPU)
    assert u["Converged?"] and u["Spherical Transform"] is not None
    assert abs(u["Energy"] - ref["Energy"]) <= 1e-8
    r = tc_rohf.energy(pm, pb, flags, device=CPU)
    assert abs(r["Energy"] - ref["Energy"]) <= 1e-8

    mol, bs = _bsets(OH, "6-31G*", "cc-pVDZ-JKFIT")
    pm, pb = _port(mol, bs)
    oh = {**flags, "scf_type": "df", "multiplicity": 2, "niter": 100}
    ju = jx_uhf.energy(mol, bs, oh)
    jr = jx_rohf.energy(mol, bs, oh)
    pu = tc_uhf.energy(pm, pb, oh, device=CPU)
    pr = tc_rohf.energy(pm, pb, oh, device=CPU)
    assert pu["Converged?"] and pr["Converged?"]
    assert abs(pu["Energy"] - ju["Energy"]) <= E_TOL
    assert abs(pr["Energy"] - jr["Energy"]) <= E_TOL
    assert pu["Energy"] <= pr["Energy"] + 1e-10
    e2_jx = jx_mp2.ri_ump2_energy(ju, bs)["E2"]
    e2 = tc_mp2.ri_ump2_energy(interop.scf_result(ju, CPU), pb)["E2"]
    assert abs(e2 - e2_jx) <= 1e-10


def _input(extra_scf=None):
    return {"molecule": WATER, "driver": "energy",
            "model": {"method": "RHF", "basis": "6-31G*", "spherical": True},
            "keywords": {"scf": {**TIGHT, **(extra_scf or {})},
                         "prop": {"mulliken": True}}}


def test_driver_spherical_input(tmp_path, conv_631gs):
    """'spherical': true flows from the input file through run_file: the
    JAX package's energy within 1e-9 Eh, 18 spherical functions, Mulliken
    populations summing to the electron count."""
    _, _, ref, _ = conv_631gs
    p = tmp_path / "water_sph.json"
    p.write_text(json.dumps(_input()))
    out = tc.run_file(str(p), device=CPU)
    res = out["Energy"]
    assert res["Spherical Transform"] is not None
    assert res["MO Coeff"].shape[0] == 18
    assert abs(res["Energy"] - ref["Energy"]) <= E_TOL
    assert abs(out["Properties"]["Mulliken Population"].sum() - 10.0) < 1e-10


def test_restart_from_spherical_checkpoint(tmp_path, conv_631gs):
    """A spherical run's checkpoint restarts a spherical run at its
    converged state (at most 2 iterations, the JAX package's energy within
    1e-9 Eh); a Cartesian run refuses it (its fingerprint is "sph:")."""
    _, _, ref, _ = conv_631gs
    ckpt = str(tmp_path / "sph.npz")
    tc.run_spec(tc.io.parse_input(_input({"checkpoint": ckpt})), device=CPU)
    out = tc.run_spec(tc.io.parse_input(_input({"restart": ckpt})),
                      device=CPU)["Energy"]
    assert out["Converged?"] and out["Iterations"] <= 2
    assert abs(out["Energy"] - ref["Energy"]) <= E_TOL
    cart = _input({"restart": ckpt})
    cart["model"]["spherical"] = False
    with pytest.raises(ValueError, match="fingerprint"):
        tc.run_spec(tc.io.parse_input(cart), device=CPU)
