"""RI-MP2, SCS-MP2 and RI-UMP2 of the PyTorch port (plain versions, on the
CPU) vs the JAX package.

- K7's plain versions (the E2 pair sums in modes rmp2, ss and os, and the
  opposite-spin part that mode rmp2 gives beside E2) against the JAX
  package's jitted scans on numpy-seeded factors, ragged shapes included:
  within 1e-12 x the energy's scale; an empty channel gives 0 through the
  wrapper;
- ri_mp2_energy (with SCS) and ri_ump2_energy (UHF and ROHF references) on
  identical orbitals, carried from the JAX package's SCF result by
  ``interop.scf_result``: within 1e-11 Eh (each side builds its own B; the
  sums run in another order);
- the closed-shell identity RI-UMP2 = RI-MP2 on one DF-UHF reference, and
  num_devices > 1 raising without a process group (the sharded E2 runs in
  tests/test_torch_sharded.py).
"""

import warnings

import numpy as np
import pytest
import torch

import juliachem_jl_tpu as jx
from juliachem_jl_tpu.models import mp2 as jx_mp2
from juliachem_jl_tpu.models import rhf as jx_rhf
from juliachem_jl_tpu.models import rohf as jx_rohf
from juliachem_jl_tpu.models import uhf as jx_uhf
from juliachem_jl_tpu_torch import interop
from juliachem_jl_tpu_torch.models import mp2 as tc_mp2
from juliachem_jl_tpu_torch.models import uhf as tc_uhf
from juliachem_jl_tpu_torch.utils.options import create_scf_options as tc_options
from tests._torch_parity import CPU

# (A, no_x, nv_x, no_y, nv_y): a real-looking case, one occupied orbital,
# virtual counts off K7's 64-wide tile and A off its 16-row Q-chunk
SHAPES = {"small": (40, 4, 20, 3, 21), "one-occupied": (17, 1, 9, 1, 9),
          "ragged": (37, 3, 67, 2, 65)}


def _factors(shape, seed):
    A, nox, nvx, noy, nvy = shape
    rng = np.random.default_rng(seed)
    Bx = rng.standard_normal((A, nox, nvx)) * 0.1
    By = rng.standard_normal((A, noy, nvy)) * 0.1
    eps = [np.sort(rng.uniform(lo, hi, n)) for lo, hi, n in (
        (-20.0, -0.3, nox), (0.1, 30.0, nvx), (-20.0, -0.3, noy),
        (0.1, 30.0, nvy))]
    return Bx, By, eps


def _jax_e2(mode, Bx, By, eps):
    import jax.numpy as jnp

    eox, evx, eoy, evy = (jnp.asarray(e) for e in eps)
    if mode == "rmp2":
        return float(jx_mp2._e2_jit(jnp.asarray(Bx), eox, evx))
    if mode == "ss":
        return float(jx_mp2._e2_ss_jit(jnp.asarray(Bx), eox, evx))
    return float(jx_mp2._e2_os_jit(jnp.asarray(Bx), jnp.asarray(By), eox, evx,
                                   eoy, evy))


def _port_e2(mode, Bx, By, eps):
    t = [torch.as_tensor(x) for x in (Bx, By, *eps)]
    if mode == "os":
        return tc_mp2.e2_os(t[0], t[1], t[2], t[3], t[4], t[5])
    if mode == "rmp2":
        return tc_mp2.e2_rmp2(t[0], t[2], t[3])[0]
    return tc_mp2.e2_ss(t[0], t[2], t[3])


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mode", ["rmp2", "ss", "os"])
def test_k7_plain_matches_jax_scan(mode, shape):
    Bx, By, eps = _factors(SHAPES[shape], seed=list(SHAPES).index(shape))
    want = _jax_e2(mode, Bx, By, eps)
    got = _port_e2(mode, Bx, By, eps)
    assert want <= 0.0
    assert abs(got - want) <= 1e-12 * max(1.0, abs(want))


@pytest.mark.parametrize("empty", ["no_y", "nv_x", "A"])
def test_k7_empty_channel_is_zero(empty):
    """A one-electron doublet has no beta occupied orbital (no_y = 0): the
    wrapper returns 0 (on the card without a launch)."""
    shape = dict(zip(("A", "no_x", "nv_x", "no_y", "nv_y"), SHAPES["small"]))
    shape[empty] = 0
    Bx, By, eps = _factors(tuple(shape.values()), seed=3)
    assert _port_e2("os", Bx, By, eps) == 0.0
    if empty != "no_y":
        assert _port_e2("rmp2", Bx, Bx, (eps[0], eps[1], eps[0], eps[1])) == 0.0


def test_k7_wrapper_checks_shapes():
    Bx, By, eps = _factors(SHAPES["small"], seed=4)
    with pytest.raises(ValueError):
        tc_mp2.e2_rmp2(torch.as_tensor(Bx), torch.as_tensor(eps[1]),
                       torch.as_tensor(eps[0]))
    with pytest.raises(ValueError):
        tc_mp2.e2_os(torch.as_tensor(Bx), torch.as_tensor(By[:-1]),
                     *(torch.as_tensor(e) for e in eps))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_k7_rmp2_opposite_spin_part_matches_jax_os_scan(shape):
    """Mode rmp2 gives (E2, E_os): E_os is the JAX package's opposite-spin
    scan with the same factor on both sides, as its SCS split runs it."""
    import jax.numpy as jnp

    Bx, _, eps = _factors(SHAPES[shape], seed=list(SHAPES).index(shape))
    eo, ev = jnp.asarray(eps[0]), jnp.asarray(eps[1])
    want = float(jx_mp2._e2_os_jit(jnp.asarray(Bx), jnp.asarray(Bx), eo, ev,
                                   eo, ev))
    e2, e_os = tc_mp2.e2_rmp2(*(torch.as_tensor(x) for x in (Bx, *eps[:2])))
    assert e_os < 0.0
    assert abs(e_os - want) <= 1e-12 * max(1.0, abs(want))
    assert abs(e2 - _jax_e2("rmp2", Bx, Bx, eps)) <= 1e-12 * max(1.0, abs(e2))


def _system(molecule, prim="6-31G", aux="cc-pVTZ-JKFIT"):
    mol = jx.molecule.from_input_dict(molecule)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bsets = jx.basis.CalculationBasisSets(
            jx.basis.build(mol, prim), jx.basis.build_auxiliary(mol, aux, prim))
    return mol, bsets


WATER = {"symbols": ["O", "H", "H"],
         "geometry": [0, 0, 0, 0.757, 0.586, 0, -0.757, 0.586, 0]}
OH = {"symbols": ["O", "H"], "geometry": [0, 0, 0, 0, 0, 0.97],
      "molecular_multiplicity": 2}
FLAGS = {"scf_type": "df", "niter": 60, "dele": 1e-10, "rmsd": 1e-8,
         "guess": "sad"}


@pytest.fixture(scope="module")
def water():
    mol, bsets = _system(WATER)
    return mol, bsets, jx_rhf.energy(mol, bsets, FLAGS)


def test_ri_mp2_scs_matches_jax(water):
    _, bsets, r = water
    want = jx_mp2.ri_mp2_energy(r, bsets, scs=True)
    got = tc_mp2.ri_mp2_energy(interop.scf_result(r, CPU),
                               interop.basis_sets(bsets), scs=True)
    assert set(got) == set(want)
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-11, key
    assert got["E2 Opposite Spin"] < got["E2 Same Spin"] < 0.0


@pytest.mark.parametrize("method", ["UHF", "ROHF"])
def test_ri_ump2_matches_jax(method):
    mol, bsets = _system(OH)
    energy = jx_uhf.energy if method == "UHF" else jx_rohf.energy
    ref = energy(mol, bsets, {**FLAGS, "dele": 1e-9, "rmsd": 1e-7})
    assert ref["Converged?"]
    want = jx_mp2.ri_ump2_energy(ref, bsets)
    got = tc_mp2.ri_ump2_energy(interop.scf_result(ref, CPU),
                                interop.basis_sets(bsets))
    assert set(got) == set(want)
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-11, key
    assert got["E2 Opposite Spin"] < got["E2 Same Spin"] < 0.0


def test_ri_ump2_closed_shell_equals_ri_mp2():
    """On one closed-shell DF-UHF reference of the port, RI-UMP2 (modes ss,
    ss, os) reproduces RI-MP2 (mode rmp2)."""
    mol, bsets = _system(WATER)
    u = tc_uhf.energy(interop.molecule(mol), interop.basis_sets(bsets), FLAGS,
                      device=CPU)
    assert u["Converged?"] and abs(u["S2"]) < 1e-10
    pb = interop.basis_sets(bsets)
    e_r = tc_mp2.ri_mp2_energy(u, pb, scs=True)
    e_u = tc_mp2.ri_ump2_energy(u, pb)
    for key in ("E2", "E2 Same Spin", "E2 Opposite Spin", "E2 SCS"):
        assert abs(e_u[key] - e_r[key]) <= 1e-11, key


def test_ri_mp2_reuses_a_given_B(water):
    """B given (here the JAX package's, as numpy): the same E2."""
    _, bsets, r = water
    B = jx.models.df.build_B(bsets.primary, bsets.auxiliary)
    want = jx_mp2.ri_mp2_energy(r, bsets)["E2"]
    got = tc_mp2.ri_mp2_energy(interop.scf_result(r, CPU),
                               interop.basis_sets(bsets), B=np.asarray(B))
    assert abs(got["E2"] - want) <= 1e-11


def test_sharded_ri_mp2_raises(water):
    """num_devices > 1 runs the sharded RI-MP2 over a process group of that
    many ranks (tests/test_torch_sharded.py); without one it raises."""
    _, bsets, r = water
    with pytest.raises(RuntimeError, match="process group"):
        tc_mp2.ri_mp2_energy(interop.scf_result(r, CPU),
                             interop.basis_sets(bsets),
                             opts=tc_options({"num_devices": 2}))
