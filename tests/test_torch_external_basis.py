"""GAMESS-US basis files (basis/external.py) through both packages, on the CPU.

The cases of tests/test_external_basis.py and tests/test_neon_external.py,
run through the JAX package and the PyTorch port side by side:

- the bundled 6-31G (O, H) written as GAMESS text parses to the same shells
  in both packages, equal to the library's;
- a water RHF from the registered file equals the library's run in the
  port, and the JAX package's energy within 1e-10 Eh;
- ``model["basis_file"]`` registers the file in ``basis.run``, with the
  file stem as the name when none is given;
- neon STO-3G from tests/data/ne_sto3g.gbs (an element outside the bundled
  set): the port's energy against the JAX package's within 1e-10 Eh, the
  literature value -126.60452 Eh within 1e-4, and a virial ratio near 2;
- the g basis file tests/data/6-311ppG_3df_3pd_G.gbs regenerates byte for
  byte from tools/make_g_basis.py and parses to the same shells in both
  packages.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

import juliachem_jl_tpu as jx
import juliachem_jl_tpu_torch as tc
from juliachem_jl_tpu.basis import external as jx_external
from juliachem_jl_tpu_torch.basis import external as tc_external
from juliachem_jl_tpu_torch.basis import library as tc_library
from tests._torch_parity import CPU, WATER
from tests.test_external_basis import _to_gamess

DATA = Path(__file__).parent / "data"
ROOT = Path(__file__).resolve().parents[1]
FLAGS = {"niter": 60, "dele": 1e-9, "rmsd": 1e-7}
NEON = {"symbols": ["Ne"], "geometry": [0.0, 0.0, 0.0],
        "molecular_charge": 0}


def _same_shells(a_list, b_list):
    assert len(a_list) == len(b_list)
    for a, b in zip(a_list, b_list):
        assert a["l"] == b["l"]
        assert list(a["exps"]) == list(b["exps"])
        keys = ("coefs_s", "coefs_p") if a["l"] == "L" else ("coefs",)
        for k in keys:
            assert list(a[k]) == list(b[k])


def test_gamess_roundtrip_shells_both_packages():
    text = _to_gamess("6-31G", ["O", "H"])
    got = tc_external.parse_gamess_basis(text)
    ref = jx_external.parse_gamess_basis(text)
    assert set(got) == set(ref) == {"O", "H"}
    for el in ("O", "H"):
        _same_shells(got[el], ref[el])
        lib = tc_library.lookup(el, "6-31G")
        for a, b in zip(got[el], lib):
            assert a["l"] == b["l"]
            assert np.allclose(a["exps"], b["exps"], rtol=1e-12)
            key = "coefs" if a["l"] != "L" else "coefs_s"
            assert np.allclose(a[key], b[key], rtol=1e-12)


def test_external_file_energy_matches_library_and_jax(tmp_path):
    path = tmp_path / "my631g.gbs"
    path.write_text(_to_gamess("6-31G", ["O", "H"]))
    mol = tc.molecule.from_input_dict(WATER)
    e_lib = tc.models.rhf.energy(
        mol, tc.basis.CalculationBasisSets(tc.basis.build(mol, "6-31G")),
        FLAGS, device=CPU)
    name = tc.basis.register_basis_file(str(path), name="user-631g")
    assert name == "user-631g"
    e_ext = tc.models.rhf.energy(
        mol, tc.basis.CalculationBasisSets(tc.basis.build(mol, "user-631g")),
        FLAGS, device=CPU)
    assert abs(float(e_ext["Energy"]) - float(e_lib["Energy"])) < 1e-12
    jmol = jx.molecule.from_input_dict(WATER)
    jx.basis.register_basis_file(str(path), name="user-631g")
    e_jax = jx.models.rhf.energy(
        jmol, jx.basis.CalculationBasisSets(
            jx.basis.build(jmol, "user-631g"), None), FLAGS)
    assert abs(float(e_ext["Energy"]) - float(e_jax["Energy"])) < 1e-10


def test_model_basis_file_key(tmp_path):
    path = tmp_path / "file631g.gbs"
    path.write_text(_to_gamess("6-31G", ["O", "H"]))
    mol = tc.molecule.from_input_dict(WATER)
    bsets = tc.basis.run(mol, {"basis": "file-631g", "basis_file": str(path)})
    assert bsets.primary.nbf == tc.basis.build(mol, "6-31G").nbf
    jb = jx.basis.run(jx.molecule.from_input_dict(WATER),
                      {"basis": "file-631g", "basis_file": str(path)})
    assert bsets.primary.nbf == jb.primary.nbf
    # an auxiliary file without a name registers under its file stem
    aux = tc.basis.run(mol, {"basis": "6-31G",
                             "auxiliary_basis_file": str(path)})
    assert aux.auxiliary is not None and aux.auxiliary.name == "file631g"


@pytest.fixture(scope="module")
def neon():
    tc.basis.register_basis_file(str(DATA / "ne_sto3g.gbs"),
                                 name="STO-3G-ne-file")
    mol = tc.molecule.from_input_dict(NEON)
    bsets = tc.basis.run(mol, {"method": "RHF", "basis": "STO-3G-ne-file"})
    flags = {"niter": 50, "dele": 1e-10, "rmsd": 1e-8}
    res = tc.models.rhf.energy(mol, bsets, flags, device=CPU)
    jx.basis.register_basis_file(str(DATA / "ne_sto3g.gbs"),
                                 name="STO-3G-ne-file")
    jmol = jx.molecule.from_input_dict(NEON)
    jres = jx.models.rhf.energy(
        jmol, jx.basis.run(jmol, {"method": "RHF",
                                  "basis": "STO-3G-ne-file"}), flags)
    return mol, bsets, res, jres


def test_neon_energy_matches_jax_and_literature(neon):
    _, _, res, jres = neon
    assert res["Converged?"] and jres["Converged?"]
    assert abs(float(res["Energy"]) - float(jres["Energy"])) < 1e-10
    assert abs(float(res["Energy"]) - (-126.60452)) < 1e-4


def test_neon_virial_ratio(neon):
    from juliachem_jl_tpu.ops import oei

    _, bsets, res, _ = neon
    jmol = jx.molecule.from_input_dict(NEON)
    jb = jx.basis.run(jmol, {"method": "RHF", "basis": "STO-3G-ne-file"})
    _, T, _ = (np.asarray(m) for m in oei.overlap_kinetic_nuclear(
        jb.primary, jmol))
    D = np.asarray(res["Density"].cpu() if hasattr(res["Density"], "cpu")
                   else res["Density"])
    t_e = float(np.sum(D * T))
    ratio = -(float(res["Energy"]) - t_e) / t_e
    assert abs(ratio - 2.0) < 2e-2, ratio


def test_g_basis_file_regenerates_and_parses_alike():
    spec = importlib.util.spec_from_file_location(
        "make_g_basis", ROOT / "tools" / "make_g_basis.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    path = DATA / "6-311ppG_3df_3pd_G.gbs"
    assert mod.g_basis_text() == path.read_text()
    got = tc_external.load_basis_file(str(path))
    ref = jx_external.load_basis_file(str(path))
    assert set(got) == set(ref) == {"H", "C", "O"}
    for el in got:
        _same_shells(got[el], ref[el])
        # the library's 6-311++G(3df,3pd) and one G shell on C and O
        base = tc_library.lookup(el, "6-311++G(3df,3pd)")
        _same_shells(got[el][:len(base)], base)
        assert [s["l"] for s in got[el][len(base):]] == \
            ([] if el == "H" else ["G"])
