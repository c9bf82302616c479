"""The nuclear derivatives of the PyTorch port vs the JAX package.

Both packages on the CPU (the port on ``torch.device("cpu")``):

- ``stv_gradients`` (dS, dT, dV [natom, 3, nbf, nbf]) within 1e-12 on
  water 6-31G*;
- ``eri_grad_class`` against the JAX ``_eri_grad_kernel`` on the first
  quartets of every class pair of water 6-31G* (ss .. dd on each side, up
  to (dd|dd)), dA, dB and dC each within 1e-11 x max |block|;
- the conventional two-electron gradient at a seeded D (closed shell and
  spin densities) within 1e-11 (6-31G, STO-3G); the RI-fitted one (``sph_aux`` true) and
  the total RHF gradient at the JAX package's converged D and W (carried
  by interop) within 1e-11;
- end to end, ``gradient.run`` with dele 1e-11 and rmsd 1e-9 for RHF, UHF
  and ROHF x conventional and DF x Cartesian and spherical (water STO-3G
  conventional, 6-31G DF Cartesian, 6-31G* DF spherical; the cation for
  UHF and ROHF) within 1e-8 Eh/bohr (the JAX package's conventional
  gradient runs its 4-center derivatives on host numpy: ~10 s a case at
  6-31G, so the conventional cases stay at STO-3G, whose p shells the
  spherical transform permutes);
- the port's own gradients against central finite differences of its own
  energy: DF with ``df_spherical_aux`` false (which the JAX package's
  gradient does not pass, ROADMAP.md C2, so it cannot be the reference)
  and conventional in the spherical 6-31G* basis.
"""

import warnings

import numpy as np
import pytest
import torch

import juliachem_jl_tpu as jx
from juliachem_jl_tpu.models import gradient as jx_grad
from juliachem_jl_tpu.ops import eri_grad as jx_eri_grad
from juliachem_jl_tpu.ops.oei_grad import stv_gradients as jx_stv
from juliachem_jl_tpu.ops.pairs import unique_pair_blocks
from juliachem_jl_tpu_torch import interop
from juliachem_jl_tpu_torch.models import gradient as tc_grad
from juliachem_jl_tpu_torch.models import rhf as tc_rhf
from juliachem_jl_tpu_torch.ops import eri_grad as tc_eri_grad
from juliachem_jl_tpu_torch.ops.oei_grad import stv_gradients as tc_stv
from tests._torch_parity import CPU, WATER, assert_close, np_

TIGHT = {"niter": 100, "dele": 1e-11, "rmsd": 1e-9}
CATION = {**WATER, "molecular_charge": 1, "molecular_multiplicity": 2}


def _bsets(molecule, prim, aux=None, spherical=False):
    mol = jx.molecule.from_input_dict(molecule)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bs = jx.basis.CalculationBasisSets(
            jx.basis.build(mol, prim),
            jx.basis.build_auxiliary(mol, aux, prim) if aux else None,
            spherical=spherical)
    return mol, bs


def _seeded_density(nbf: int, seed: int) -> np.ndarray:
    X = np.random.default_rng(seed).standard_normal((nbf, nbf))
    return X + X.T


def test_stv_gradients_match_jax():
    mol, bs = _bsets(WATER, "6-31G*")
    ref = jx_stv(bs.primary, mol)
    out = tc_stv(interop.basis(bs.primary), interop.molecule(mol), CPU)
    for o, r in zip(out, ref):
        assert_close(o, r, 1e-12)


_631GS_BLOCKS = unique_pair_blocks(
    _bsets(WATER, "6-31G*")[1].primary)
_CLASS_PAIRS = [(i, j) for i in range(len(_631GS_BLOCKS))
                for j in range(len(_631GS_BLOCKS))]


@pytest.mark.parametrize("bi,bj", _CLASS_PAIRS, ids=[
    "({}{}|{}{})".format(*"spd"[_631GS_BLOCKS[i].la] + "spd"[_631GS_BLOCKS[i].lb],
                        *"spd"[_631GS_BLOCKS[j].la] + "spd"[_631GS_BLOCKS[j].lb])
    for i, j in _CLASS_PAIRS])
def test_eri_grad_class_matches_jax(bi, bj):
    """dA, dB, dC of the first 3 quartets (each bra pair against the last
    ket pairs) of one class pair, within 1e-11 x max |block|."""
    bra, ket = _631GS_BLOCKS[bi], _631GS_BLOCKS[bj]
    ib = np.arange(min(3, bra.n))
    ik = (ket.n - 1 - np.arange(min(3, ket.n)))[:len(ib)]
    ib = ib[:len(ik)]

    def cols(blk, sel):
        return (blk.aexp[sel], blk.bexp[sel], blk.acoef[sel], blk.bcoef[sel],
                blk.A[sel], blk.B[sel])

    ref = jx_eri_grad._eri_grad_kernel(bra.la, bra.lb, ket.la, ket.lb)(
        *cols(bra, ib), *cols(ket, ik))
    out = tc_eri_grad.eri_grad_class(
        bra.la, bra.lb, ket.la, ket.lb,
        *(torch.as_tensor(x) for x in cols(bra, ib) + cols(ket, ik)))
    for o, r in zip(out, ref):
        assert_close(o, r, 1e-11 * max(float(np.abs(r).max()), 1e-30))


@pytest.mark.parametrize("spin", [False, True])
def test_two_electron_gradient_matches_jax(spin):
    """Conventional dE_2e at a seeded D (6-31G; spin densities on STO-3G)
    within 1e-11 of the JAX package's (the d classes: the class-kernel
    test above, and the spherical finite-difference test below)."""
    mol, bs = _bsets(WATER, "STO-3G" if spin else "6-31G")
    prim, pm = interop.basis(bs.primary), interop.molecule(mol)
    D = _seeded_density(bs.primary.nbf, 3)
    if spin:
        Da, Db = 0.1 * D @ D, 0.07 * D @ D
        ref = jx_eri_grad.two_electron_gradient(bs.primary, mol, Da + Db,
                                                spin_densities=(Da, Db))
        out = tc_eri_grad.two_electron_gradient(
            prim, pm, torch.as_tensor(Da + Db),
            spin_densities=(torch.as_tensor(Da), torch.as_tensor(Db)))
    else:
        ref = jx_eri_grad.two_electron_gradient(bs.primary, mol, D)
        out = tc_eri_grad.two_electron_gradient(prim, pm, torch.as_tensor(D))
    assert_close(out, ref, 1e-11)
    assert float(out.sum(dim=0).abs().max()) < 1e-9


@pytest.fixture(scope="module")
def df_631gs():
    """The JAX package's converged spherical DF-RHF of water 6-31G* /
    cc-pVDZ-JKFIT (its D and W in the Cartesian rows)."""
    mol, bs = _bsets(WATER, "6-31G*", "cc-pVDZ-JKFIT", spherical=True)
    res = jx.models.rhf.energy(mol, bs, {**TIGHT, "scf_type": "df"})
    T = res["Spherical Transform"]
    return mol, bs, T @ res["Density"] @ T.T, T @ res["W"] @ T.T


def test_df_gradient_matches_jax(df_631gs):
    """The RI-fitted dE_2e (aux fit in the solid-harmonic space) at the JAX
    package's converged D, closed shell and with spin densities, within
    1e-11; translationally invariant."""
    mol, bs, D, _ = df_631gs
    prim, aux = interop.basis(bs.primary), interop.basis(bs.auxiliary)
    pm = interop.molecule(mol)
    ref = jx_eri_grad.df_two_electron_gradient(bs.primary, bs.auxiliary, mol,
                                               D, sph_aux=True)
    tm = {}
    out = tc_eri_grad.df_two_electron_gradient(prim, aux, pm,
                                               torch.as_tensor(D),
                                               sph_aux=True, timings=tm)
    assert_close(out, ref, 1e-11)
    assert float(out.sum(dim=0).abs().max()) < 1e-10
    assert set(tm) == {"three_center", "metric", "fit",
                       "three_center_derivative", "metric_derivative"}
    Da, Db = 0.6 * D, 0.4 * D
    ref = jx_eri_grad.df_two_electron_gradient(
        bs.primary, bs.auxiliary, mol, D, spin_densities=(Da, Db))
    out = tc_eri_grad.df_two_electron_gradient(
        prim, aux, pm, torch.as_tensor(D),
        spin_densities=(torch.as_tensor(Da), torch.as_tensor(Db)))
    assert_close(out, ref, 1e-11)


@pytest.mark.parametrize("df", [False, True])
def test_total_gradient_at_jax_density(df, df_631gs):
    """The total RHF gradient at the JAX package's converged D and W:
    conventional (water STO-3G) and DF (the fixture's), within 1e-11."""
    if df:
        mol, bs, D, W = df_631gs
    else:
        mol, bs = _bsets(WATER, "STO-3G")
        res = jx.models.rhf.energy(mol, bs, TIGHT)
        D, W = np.asarray(res["Density"]), np.asarray(res["W"])
    aux = bs.auxiliary if df else None
    ref = jx_grad.total_gradient(mol, bs.primary, D, W, aux=aux)
    out = tc_grad.total_gradient(
        interop.molecule(mol), interop.basis(bs.primary), torch.as_tensor(D),
        torch.as_tensor(W), aux=None if aux is None else interop.basis(aux))
    assert_close(out, ref, 1e-11)


# (method, scf_type, spherical, primary basis) of the end-to-end matrix
E2E = [(m, st, sph, {("rhf", False): "STO-3G", ("rhf", True): "STO-3G",
                     ("df", False): "6-31G", ("df", True): "6-31G*"}[st, sph])
       for m in ("RHF", "UHF", "ROHF") for st in ("rhf", "df")
       for sph in (False, True)]


@pytest.mark.parametrize("method,scf_type,spherical,prim", E2E, ids=[
    f"{m}-{'conv' if st == 'rhf' else 'df'}-{'sph' if s else 'cart'}-{p}"
    for m, st, s, p in E2E])
def test_gradient_run_matches_jax(method, scf_type, spherical, prim):
    """gradient.run end to end (SCF and gradient) within 1e-8 Eh/bohr of
    the JAX package's, the energy within 1e-9 Eh; UHF and ROHF on the
    water cation (doublet)."""
    molecule = WATER if method == "RHF" else CATION
    aux = "cc-pVDZ-JKFIT" if scf_type == "df" else None
    mol, bs = _bsets(molecule, prim, aux, spherical)
    flags = {**TIGHT, "scf_type": scf_type}
    ref = jx_grad.run(mol, bs, flags, method=method)
    out = tc_grad.run(interop.molecule(mol), interop.basis_sets(bs), flags,
                      method=method, device=CPU)
    assert out["Converged?"]
    assert (out["Spherical Transform"] is not None) == spherical
    assert abs(out["Energy"] - ref["Energy"]) <= 1e-9
    assert_close(out["Gradient"], ref["Gradient"], 1e-8)
    assert out["Gradient"].dtype == torch.float64


def _fd_check(molecule, prim, aux, spherical, flags, coords_to_check,
              h: float = 2e-4, tol: float = 5e-6):
    """The port's gradient.run against central differences of its own
    converged energy (h in bohr) on the listed (atom, axis).  The displaced
    molecules move Molecule.coords directly (from_input_dict recentres to
    the centre of mass, which would halve an input-frame step)."""
    from juliachem_jl_tpu_torch import basis as tc_basis
    from juliachem_jl_tpu_torch.models.optimize import molecule_at

    def bsets(m):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return tc_basis.CalculationBasisSets(
                tc_basis.build(m, prim),
                tc_basis.build_auxiliary(m, aux, prim) if aux else None,
                spherical=spherical)

    pm = interop.molecule(jx.molecule.from_input_dict(molecule))
    g = np_(tc_grad.run(pm, bsets(pm), flags, device=CPU)["Gradient"])
    assert np.abs(g.sum(axis=0)).max() < 1e-8
    x0 = pm.coords.reshape(-1)
    for k, d in coords_to_check:
        es = []
        for s in (+1, -1):
            x = x0.copy()
            x[3 * k + d] += s * h
            m = molecule_at(pm, x)
            r = tc_rhf.energy(m, bsets(m), flags, device=CPU)
            assert r["Converged?"]
            es.append(r["Energy"])
        fd = (es[0] - es[1]) / (2 * h)
        assert abs(fd - g[k, d]) < tol, (k, d, fd, g[k, d])


def test_df_gradient_cartesian_aux_vs_finite_differences():
    """df_spherical_aux false: the DF gradient fits in the Cartesian aux
    space the SCF fitted in (the port threads the keyword through; the JAX
    package's gradient does not, ROADMAP.md C2), against central
    differences of the port's own DF energy."""
    _fd_check(WATER, "STO-3G", "cc-pVDZ-JKFIT", False,
              {**TIGHT, "scf_type": "df", "df_spherical_aux": False},
              [(0, 2), (1, 1)])


def test_spherical_gradient_vs_finite_differences():
    """Conventional RHF in the spherical 6-31G* basis against central
    differences of the port's own energy (tests/test_spherical.py's check
    for the JAX package)."""
    _fd_check(WATER, "6-31G*", None, True, {**TIGHT, "scf_type": "rhf"},
              [(0, 2)])
