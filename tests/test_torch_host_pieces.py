"""The port's small host pieces against the JAX package on the CPU:
``molecule.analysis`` (bonds, bond angles, the printed table) on water and
on benzene_2_water, and the ``debug`` keyword's ``debug.h5`` (the
one-electron matrices and, per iteration, F, D, C and the energy), key by
key, on water DF and on water spherical conventional."""

from __future__ import annotations

import json
import os
import warnings
from pathlib import Path

import numpy as np
import pytest

import juliachem_jl_tpu as jx
import juliachem_jl_tpu_torch as tc
from juliachem_jl_tpu_torch import interop
from tests._torch_parity import CPU, WATER

h5py = pytest.importorskip("h5py")

GOLDENS = Path(__file__).parent / "data" / "s22x3_gamess_goldens.json"
BOHR = 0.52917724924


def _benzene_2_water() -> dict:
    atoms = json.loads(GOLDENS.read_text())["benzene_2_water"]["atoms"]
    return {"symbols": [a["symbol"] for a in atoms],
            "geometry": [x * BOHR for a in atoms for x in a["xyz_bohr"]],
            "molecular_charge": 0}


@pytest.mark.parametrize("name", ["water", "benzene_2_water"])
def test_analysis_matches_jax(name):
    """Bonds (atom pairs and lengths), bond angles and the printed table of
    the port equal the JAX package's on the same input."""
    spec = WATER if name == "water" else _benzene_2_water()
    jm = jx.molecule.from_input_dict(spec)
    tm = tc.molecule.from_input_dict(spec)
    jb, tb = jx.molecule.analysis.bonds(jm), tc.molecule.analysis.bonds(tm)
    assert [b[:2] for b in tb] == [b[:2] for b in jb] and len(tb) > 1
    assert np.allclose([b[2] for b in tb], [b[2] for b in jb], rtol=0,
                       atol=1e-12)
    ja = jx.molecule.analysis.bond_angles(jm, jb)
    ta = tc.molecule.analysis.bond_angles(tm, tb)
    assert [a[:3] for a in ta] == [a[:3] for a in ja] and ta
    assert np.allclose([a[3] for a in ta], [a[3] for a in ja], rtol=0,
                       atol=1e-10)
    jl, tl = [], []
    jx.molecule.analysis.print_analysis(jm, jl.append)
    tc.molecule.analysis.print_analysis(tm, tl.append)
    assert tl == jl


def _debug_file(run, where: Path) -> dict:
    """Run ``run()`` in ``where`` and read back its debug.h5 as
    {key: array}."""
    where.mkdir()
    cwd = os.getcwd()
    os.chdir(where)
    try:
        run()
    finally:
        os.chdir(cwd)
    out = {}
    with h5py.File(where / "debug.h5") as f:
        f.visititems(lambda k, v: out.__setitem__(k, v[()])
                     if isinstance(v, h5py.Dataset) else None)
    return out


DEBUG_CASES = {
    # (primary, auxiliary, spherical, scf keywords); the DF case in f64
    # throughout: the f32 phase's Fock builds round apart in the two
    # packages (XLA's and torch's f32 products), ~1e-6 in F
    "water-df": ("6-31G", "cc-pVDZ-JKFIT", False,
                 {"scf_type": "df", "mixed_precision": False}),
    "water-spherical-conventional": ("6-31G*", None, True,
                                     {"scf_type": "rhf"}),
}


@pytest.mark.parametrize("case", list(DEBUG_CASES))
def test_debug_dump_matches_jax(case, tmp_path):
    """``debug: true`` writes the JAX package's keys (overlap, kinetic,
    nuc_attr, core_hamiltonian, ortho, and fock, density, coefficients,
    energy per iteration as ``key/iteration``), every value within 1e-10
    of the JAX package's (the eigenvector columns of X and C up to their
    sign)."""
    prim, aux, sph, extra = DEBUG_CASES[case]
    mol = jx.molecule.from_input_dict(WATER)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bsets = jx.basis.CalculationBasisSets(
            jx.basis.build(mol, prim),
            jx.basis.build_auxiliary(mol, aux, prim) if aux else None,
            spherical=sph)
    flags = {"niter": 4, "dele": 1e-9, "rmsd": 1e-7, "guess": "sad",
             "debug": True, **extra}
    ref = _debug_file(lambda: jx.models.rhf.energy(mol, bsets, dict(flags)),
                      tmp_path / "jax")
    got = _debug_file(lambda: tc.models.rhf.energy(
        interop.molecule(mol), interop.basis_sets(bsets), dict(flags),
        device=CPU), tmp_path / "port")
    assert sorted(got) == sorted(ref)
    assert {"overlap", "kinetic", "nuc_attr", "core_hamiltonian", "ortho",
            "fock/4", "density/4", "coefficients/4", "energy/4"} <= set(got)
    for key, want in ref.items():
        have = np.asarray(got[key])
        assert np.shape(have) == np.shape(want), key
        if key == "ortho" or key.startswith("coefficients/"):
            have, want = _eigenvector_frames(have, want)
        err = float(np.max(np.abs(have - want)))
        assert err <= 1e-10, (key, err)


def _eigenvector_frames(have, want):
    """Eigenvector columns (of S for X, of F' for C) are fixed only up to
    their sign, and within a degenerate level up to a rotation, which
    LAPACK's eigh in the JAX package and in torch pick apart: each
    nondegenerate column is compared with its sign aligned, each degenerate
    level (equal column norms, 1/s for X) by its projector."""
    norms = np.sum(want * want, axis=0)
    out_h, out_w, k = [], [], 0
    while k < want.shape[1]:
        j = k + 1
        while j < want.shape[1] and abs(norms[j] - norms[k]) <= 1e-8 * norms[k]:
            j += 1
        h, w = have[:, k:j], want[:, k:j]
        if j - k == 1:
            out_h.append((h * np.sign(np.sum(h * w)))[:, 0])
            out_w.append(w[:, 0])
        else:
            out_h.append((h @ h.T).ravel())
            out_w.append((w @ w.T).ravel())
        k = j
    return np.concatenate(out_h), np.concatenate(out_w)
