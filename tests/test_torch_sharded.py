"""The multi-device path of the PyTorch port (a torch.distributed process
group, gloo on the CPU) vs the JAX package's sharded programs (its 8 virtual
CPU devices, tests/conftest.py) and vs one device.

A module fixture starts one 2-rank and one 4-rank group
(``parallel.launch.spawn``); each rank runs every stanza of
``tests/_torch_sharded_ranks.py`` once and returns its results.  The
stanzas mirror ``MULTICHIP_r05.json`` / ``__graft_entry__.py::_dryrun_impl``:

- water DF-RHF through run_spec with ``num_devices``, f64 and mixed
  precision: E within 1e-10 Eh of one device and of the JAX package's
  sharded E, the same on every rank; each rank's checkpoint in its own file;
  at 2 ranks also in the spherical-harmonic AO basis (6-31G*), within 1e-10
  Eh of one device and of the JAX package;
- packed sharded G at a fixed D (cc-pVDZ-JKFIT, and cc-pVTZ-JKFIT with its
  spherical aux projection and an uneven aux partition), from orbitals and
  from the eigen-factor, and in the per-phase (profile_fock) form: within
  1e-11 max-abs of the JAX package's make_packed_fock_step and of one
  device; its f32 phase within 2e-5 of the JAX package's f32 step (f32
  sums in another order); every rank's B rows within 1e-12 (relative to
  max |B|) of the single-device packed B's rows;
- the dense q x k make_df_fock_step / make_scf_step on a (n/2) x 2 grid:
  G and F within 1e-11, E within 1e-10 of the JAX package's;
- conventional 6-31G: the quartet-sharded direct and the sharded staircase
  G at a fixed D within 1e-11 of one device, the direct route's SCF within
  1e-10 Eh of one device;
- the singular-metric pseudo-inverse fold: G within 1e-11 of one device and
  within 1e-9 of the JAX package's sharded builder (the packages'
  eigensolvers differ, amplified by the metric's condition);
- sharded RI-MP2 E2 within 1e-12 Eh of the JAX package's sharded E2 and of
  one device, with its keys;
- UHF and ROHF doublets within 1e-10 Eh of one device and of the JAX
  package's sharded runs;
- K5's t0 split and K7's occupied-range split vs their whole-range plain
  versions; a failing rank that stops the group within its timeout;
  num_devices other than the group's size, or > 1 with no group, raising;
  NCCL with more ranks than GPUs raising; the rank-grid smoke
  (``parallel.dist_smoke``).
"""

import os
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juliachem_jl_tpu as jx
import juliachem_jl_tpu_torch as tc
from juliachem_jl_tpu.models import df as jx_df
from juliachem_jl_tpu.models import guess as jx_guess
from juliachem_jl_tpu.models import mp2 as jx_mp2
from juliachem_jl_tpu.models import rohf as jx_rohf
from juliachem_jl_tpu.models import uhf as jx_uhf
from juliachem_jl_tpu.models.df_sharded import ShardedDFFockBuilder as JxSharded
from juliachem_jl_tpu.parallel import mesh as jx_mesh
from juliachem_jl_tpu.parallel import shard as jx_shard
from juliachem_jl_tpu.utils.options import create_scf_options as jx_options
from juliachem_jl_tpu.utils.timings import Timings as JxTimings
from juliachem_jl_tpu_torch import interop
from juliachem_jl_tpu_torch.models import df_screened as tc_dfs
from juliachem_jl_tpu_torch.models import mp2 as tc_mp2
from juliachem_jl_tpu_torch.models import rohf as tc_rohf
from juliachem_jl_tpu_torch.models import uhf as tc_uhf
from juliachem_jl_tpu_torch.ops import fock as tc_fock
from juliachem_jl_tpu_torch.ops import fock_stream as tc_stream
from juliachem_jl_tpu_torch.ops.fock_sharded import share
from juliachem_jl_tpu_torch.parallel import dist_smoke
from juliachem_jl_tpu_torch.parallel.launch import spawn
from juliachem_jl_tpu_torch.utils.options import create_scf_options as tc_options
from juliachem_jl_tpu_torch.utils.timings import Timings
from tests import _torch_sharded_ranks as ranks
from tests._torch_parity import CPU, WATER, assert_close

WORLDS = (2, 4)
RHF = {"scf_type": "df", "niter": 60, "dele": 1e-10, "rmsd": 1e-8,
       "mixed_precision": False}
RHF_MIXED = {**RHF, "dele": 1e-11, "rmsd": 1e-9, "mixed_precision": True}
OH = {"symbols": ["O", "H"], "geometry": [0.0, 0.0, 0.0, 0.0, 0.0, 0.9697],
      "molecular_multiplicity": 2}
OPEN = {"scf_type": "df", "niter": 80, "dele": 1e-10, "rmsd": 1e-8,
        "multiplicity": 2}
CONV = {"scf_type": "rhf", "niter": 40, "dele": 1e-10, "rmsd": 1e-8}
PACKED = {"cc-pVDZ-JKFIT": "6-31G", "cc-pVTZ-JKFIT": "6-31+G*"}
# two near-coincident waters: a numerically singular aux metric
_EPS = 1e-4
PINV = {"symbols": ["O", "H", "H", "O", "H", "H"],
        "geometry": [0.0, 0.0, 0.116321, 0.0, 0.751155, -0.465285,
                     0.0, -0.751155, -0.465285,
                     _EPS, _EPS, 0.116321, _EPS, 0.751155 + _EPS, -0.465285,
                     _EPS, -0.751155, -0.465285 + _EPS],
        "molecular_charge": 2}


def _spec(prim, aux, scf, molecule=WATER, method="RHF"):
    model = {"method": method, "basis": prim}
    if aux:
        model["auxiliary_basis"] = aux
    return {"molecule": molecule, "driver": "energy", "model": model,
            "keywords": {"scf": scf}}


def _jx_system(molecule, prim, aux):
    mol = jx.molecule.from_input_dict(molecule)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return mol, jx.basis.CalculationBasisSets(
            jx.basis.build(mol, prim),
            None if aux is None else jx.basis.build_auxiliary(mol, aux, prim))


def _factor(nbf: int, nocc: int, seed: int):
    """A numpy-seeded occupied factor C and D = 2 C C^T."""
    C = 0.3 * np.random.default_rng(seed).standard_normal((nbf, nocc))
    return 2.0 * C @ C.T, C


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """What every rank gets (port-side objects carried from the JAX
    package's, numpy arrays) and the references the parent computes."""
    tmp = tmp_path_factory.mktemp("sharded")
    ref: dict = {"packed": {}}
    inp: dict = {"packed": {}}
    for aux, prim in PACKED.items():
        _, bs = _jx_system(WATER, prim, aux)
        D, C = _factor(bs.primary.nbf, 5, seed=len(aux))
        pb = interop.basis_sets(bs)
        inp["packed"][aux] = (pb.primary, pb.auxiliary, D, C)
        B1, screen = tc_dfs.build_B_packed(pb.primary, pb.auxiliary,
                                           tc_options({}), CPU)
        one = tc_dfs.ScreenedDFFockBuilder(B1, screen, tc_options({}), 5)
        ref["packed"][aux] = {
            "jx_system": bs, "D": D, "C": C, "B": B1.numpy(),
            "G_one": one.two_electron_fock(torch.as_tensor(D), 1, Timings(),
                                           C_occ=torch.as_tensor(C)).numpy()}
    # dense q x k: water 6-31G / cc-pVDZ-JKFIT, B padded for (n/2) x 2
    _, bs = _jx_system(WATER, "6-31G", "cc-pVDZ-JKFIT")
    Bd = np.asarray(jx_df.build_B(bs.primary, bs.auxiliary))
    Bd = jx_mesh.pad_to_multiple(jx_mesh.pad_to_multiple(Bd, 0, 2), 2, 2)
    nbf = bs.primary.nbf
    D, C = _factor(nbf, 5, seed=3)
    Hm = np.random.default_rng(4).standard_normal((nbf, nbf))
    inp["dense"] = {"B": Bd, "D": D, "Cocc": C, "H": Hm + Hm.T,
                    "X": np.eye(nbf)}
    # conventional 6-31G at a fixed D, and its SCF
    mol, bs = _jx_system(WATER, "6-31G", None)
    prim = interop.basis(bs.primary)
    D, _ = _factor(prim.nbf, 5, seed=5)
    inp["conventional"] = {"primary": prim, "D": D,
                           "spec": _spec("6-31G", None, CONV)}
    Dt = torch.as_tensor(D)
    ref["conventional"] = {
        "G_direct": tc_fock.ScreenedDirectFock(prim, incore=False, device=CPU)
        .two_electron_fock(Dt, 1, None).numpy(),
        "G_stream": tc_stream.StreamingDirectFock(prim, device=CPU)
        .two_electron_fock(Dt, 1, None).numpy(),
        "E": tc.run_spec(tc.io.parse_input(_spec("6-31G", None, CONV)),
                         device=CPU)["Energy"]["Energy"]}
    # the singular metric at the SAD density
    mol, bs = _jx_system(PINV, "STO-3G", "cc-pVDZ-JKFIT")
    D = np.asarray(jx_guess.sad_guess(mol, bs.primary))
    w, V = np.linalg.eigh(D)
    nocc = bs.primary.nels // 2
    C = V[:, ::-1][:, :nocc] * np.sqrt(np.maximum(w[::-1][:nocc], 0.0))
    pb = interop.basis_sets(bs)
    inp["pinv"] = {"primary": pb.primary, "aux": pb.auxiliary, "D": D,
                   "Cocc": C}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        one = tc_dfs.ScreenedDFFockBuilder.build(
            pb.primary, pb.auxiliary, tc_options({"mixed_precision": False}),
            CPU)
    ref["pinv"] = {"jx_system": bs, "D": D, "C": C,
                   "G_one": one.two_electron_fock(
                       torch.as_tensor(D), 1, Timings(),
                       C_occ=torch.as_tensor(C)).numpy()}
    # RI-MP2 on the JAX package's converged water STO-3G orbitals
    mol, bs = _jx_system(WATER, "STO-3G", "cc-pVDZ-JKFIT")
    r = jx.models.rhf.energy(mol, bs, RHF)
    res = {k: np.asarray(r[k]) for k in ("MO Coeff", "MO Energies")}
    res.update({"Energy": float(r["Energy"]), "Spherical Transform": None})
    inp["mp2"] = {"result": res, "bsets": interop.basis_sets(bs)}
    ref["mp2"] = {"jx": (r, bs), "E2_one": tc_mp2.ri_mp2_energy(
        interop.scf_result(r, CPU), interop.basis_sets(bs))["E2"]}
    # UHF / ROHF doublets
    mol, bs = _jx_system(OH, "STO-3G", "cc-pVDZ-JKFIT")
    pm, pb = interop.molecule(mol), interop.basis_sets(bs)
    inp["open_shell"] = {"mol": pm, "bsets": pb, "flags": OPEN}
    ref["open_shell"] = {
        "jx": (mol, bs),
        "uhf": tc_uhf.energy(pm, pb, OPEN, device=CPU)["Energy"],
        "rohf": tc_rohf.energy(pm, pb, OPEN, device=CPU)["Energy"]}
    # DF-RHF through run_spec
    ref["rhf"] = tc.run_spec(tc.io.parse_input(_spec(
        "STO-3G", "cc-pVDZ-JKFIT", RHF)), device=CPU)["Energy"]["Energy"]
    ref["rhf_mixed"] = tc.run_spec(tc.io.parse_input(_spec(
        "STO-3G", "cc-pVDZ-JKFIT", RHF_MIXED)), device=CPU)["Energy"]["Energy"]
    # spherical-harmonic AO basis (2 ranks): the adapter around the
    # sharded builder
    ref["rhf_sph"] = tc.run_spec(tc.io.parse_input(_sph_spec(RHF)),
                                 device=CPU)["Energy"]["Energy"]
    per_world = {}
    for n in WORLDS:
        ckpt = str(tmp / f"ckpt{n}.npz")
        per_world[n] = {**inp, "checkpoint": ckpt, "run_spec": {
            "rhf": _spec("STO-3G", "cc-pVDZ-JKFIT",
                         {**RHF, "num_devices": n, "checkpoint": ckpt}),
            "rhf_mixed": _spec("STO-3G", "cc-pVDZ-JKFIT",
                               {**RHF_MIXED, "num_devices": n})}}
    per_world[2]["run_spec"]["rhf_sph"] = _sph_spec(
        {**RHF, "num_devices": 2})
    return per_world, ref


def _sph_spec(scf):
    """Water 6-31G* / cc-pVDZ-JKFIT DF-RHF in the spherical AO basis."""
    spec = _spec("6-31G*", "cc-pVDZ-JKFIT", scf)
    spec["model"]["spherical"] = True
    return spec


@pytest.fixture(scope="module")
def groups(inputs):
    """{n: [rank 0's results, ...]} of one n-rank gloo group per n."""
    per_world, _ = inputs
    with ThreadPoolExecutor(len(WORLDS)) as ex:   # both groups at once
        futs = {n: ex.submit(spawn, ranks.run_stanzas, n,
                             args=(per_world[n],), timeout=300.0)
                for n in WORLDS}
        return {n: f.result() for n, f in futs.items()}


@pytest.fixture(scope="module")
def ref(inputs):
    return inputs[1]


def _same_on_every_rank(res, *keys):
    vals = []
    for r in res:
        v = r
        for k in keys:
            v = v[k]
        vals.append(v)
    assert all(v == vals[0] for v in vals[1:]), vals
    return vals[0]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("key", ["rhf", "rhf_mixed"])
def test_sharded_df_rhf_energy(groups, ref, n, key):
    """run_spec with num_devices n: the sharded builder on every rank, one
    energy on all ranks, within 1e-10 Eh of one device and of the JAX
    package's sharded run."""
    out = _same_on_every_rank(groups[n], key)
    assert out["converged"]
    assert out["builder"] == "ShardedDFFockBuilder"
    assert out["num_devices"] == str(n)
    assert abs(out["E"] - ref[key]) <= 1e-10
    mol, bs = _jx_system(WATER, "STO-3G", "cc-pVDZ-JKFIT")
    flags = RHF if key == "rhf" else RHF_MIXED
    e_jx = jx.models.rhf.energy(mol, bs, {**flags, "num_devices": n})
    assert abs(out["E"] - float(e_jx["Energy"])) <= 1e-10


def test_sharded_spherical_df_rhf(groups, ref):
    """The spherical-harmonic basis under num_devices 2 (the adapter wraps
    the sharded builder): one energy on both ranks, within 1e-10 Eh of one
    device and of the JAX package's (one device, its CPU backend)."""
    out = _same_on_every_rank(groups[2], "rhf_sph")
    assert out["converged"]
    assert out["builder"] == "ShardedDFFockBuilder"
    assert abs(out["E"] - ref["rhf_sph"]) <= 1e-10
    mol, bs = _jx_system(WATER, "6-31G*", "cc-pVDZ-JKFIT")
    bs.spherical = True
    e_jx = jx.models.rhf.energy(mol, bs, RHF)
    assert abs(out["E"] - float(e_jx["Energy"])) <= 1e-10


@pytest.mark.parametrize("n", WORLDS)
def test_checkpoint_per_rank(groups, n):
    """Every rank writes its own checkpoint file: n distinct files, each
    holding the run's energy."""
    res = groups[n]
    paths = [r["checkpoint"]["path"] for r in res]
    assert len(set(paths)) == n
    for r in res:
        assert os.path.exists(r["checkpoint"]["path"])
        assert abs(r["checkpoint"]["rank_file_energy"] - r["rhf"]["E"]) \
            <= 1e-12


def _jx_packed(bs, n, D, C):
    """The JAX package's sharded builder on n of its virtual devices: G
    from orbitals, from the eigen-factor, and its f32 step."""
    b = JxSharded(bs.primary, bs.auxiliary, jx_options(
        {"scf_type": "df", "num_devices": n}))
    t = JxTimings()
    return (np.asarray(b.two_electron_fock(D, 1, t, C)),
            np.asarray(b.two_electron_fock(D, 1, t)),
            np.asarray(b.two_electron_fock(D, 1, t, C, precision="f32")))


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("aux", list(PACKED))
def test_sharded_packed_G(groups, ref, n, aux):
    """G at a fixed D: every rank's equal, within 1e-11 of the JAX
    package's make_packed_fock_step (from orbitals and from the
    eigen-factor) and of one device; the profile_fock form the same G,
    timed as J_time and K_time."""
    rf = ref["packed"][aux]
    g_occ, g_fac, _ = _jx_packed(rf["jx_system"], n, rf["D"], rf["C"])
    for r in groups[n]:
        p = r["packed"][aux]
        assert_close(p["G_occ"], g_occ, 1e-11)
        assert_close(p["G_factor"], g_fac, 1e-11)
        assert_close(p["G_occ"], rf["G_one"], 1e-11)
        assert_close(p["G_profile"], p["G_occ"], 1e-11)
        assert {"J_time", "K_time"} <= set(p["profile_keys"])


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("aux", list(PACKED))
def test_sharded_f32_phase(groups, ref, n, aux):
    """The mixed-precision phase on the B32 rows: within 2e-5 of the JAX
    package's f32 step (both sum in f32, in other orders)."""
    rf = ref["packed"][aux]
    _, _, g32 = _jx_packed(rf["jx_system"], n, rf["D"], rf["C"])
    for r in groups[n]:
        p = r["packed"][aux]
        assert p["f32_phase"]
        assert_close(p["G_f32"], g32, 2e-5)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("aux", list(PACKED))
def test_sharded_B_rows(groups, ref, n, aux):
    """Each rank's rows of B (built from its own aux shells, projected,
    folded with one all_reduce per column chunk) equal the single-device
    packed B's rows within 1e-12 x max |B|; the ranks' rows tile B in
    order, padded to one count, with the per-device telemetry."""
    B = ref["packed"][aux]["B"]
    scale = float(np.abs(B).max())
    res = groups[n]
    assert res[0]["packed"][aux]["rows"][0] == 0
    assert res[-1]["packed"][aux]["rows"][1] == B.shape[0]
    for a, b in zip(res, res[1:]):
        assert a["packed"][aux]["rows"][1] == b["packed"][aux]["rows"][0]
    pad = {r["packed"][aux]["padded_rows"] for r in res}
    assert len(pad) == 1
    for r in res:
        p = r["packed"][aux]
        r0, r1 = p["rows"]
        assert_close(p["B_rows"], B[r0:r1], 1e-12 * scale)
        tel = p["telemetry"]
        assert tel["num_devices"] == str(n)
        assert tel[f"device_B_rows-DEVICE-{n - 1}"] == str(p["padded_rows"])
    # every rank padded to one count, at least the largest rank's rows and
    # fewer than n_chunks (here 1) rows more
    biggest = max(r["packed"][aux]["rows"][1] - r["packed"][aux]["rows"][0]
                  for r in res)
    assert res[0]["packed"][aux]["padded_rows"] == biggest


@pytest.mark.parametrize("n", WORLDS)
def test_dense_qk_step(groups, inputs, n):
    """make_df_fock_step / make_scf_step on a (n/2) x 2 rank grid: G and F
    within 1e-11, E within 1e-10 of the JAX package's on the same grid."""
    d = inputs[0][n]["dense"]
    mesh = jx_mesh.make_mesh(n, k_axis=2)
    A_pad, nbf, nbf_pad = d["B"].shape[0], d["D"].shape[0], d["B"].shape[2]
    nocc = d["Cocc"].shape[1]
    B_sh = jx_shard.shard_B(mesh, jnp.asarray(d["B"]))
    G = jx_shard.make_df_fock_step(mesh, A_pad, nbf, nbf_pad, nocc)(
        B_sh, jnp.asarray(np.pad(d["D"], ((0, 0), (0, nbf_pad - nbf)))),
        jnp.asarray(d["Cocc"]))
    F, _, _, _, E = jx_shard.make_scf_step(mesh, A_pad, nbf, nbf_pad, nocc)(
        B_sh, jnp.asarray(d["H"]), jnp.asarray(d["X"]), jnp.asarray(d["D"]),
        jnp.asarray(d["Cocc"]))
    for r in groups[n]:
        assert r["dense"]["grid"] == [n // 2, 2]
        assert_close(r["dense"]["G"], np.asarray(G), 1e-11)
        assert_close(r["dense"]["F"], np.asarray(F), 1e-11)
        assert abs(r["dense"]["E_elec"] - float(E)) <= 1e-10


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("builder", ["G_direct", "G_stream"])
def test_sharded_conventional_G(groups, ref, n, builder):
    """The quartet-sharded direct build (K5 list mode on each rank's share)
    and the sharded staircase build (K5 staircase on each rank's t0 range):
    within 1e-11 of one device."""
    for r in groups[n]:
        assert_close(r["conventional"][builder],
                     ref["conventional"][builder], 1e-11)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_conventional_scf(groups, ref, n):
    """Conventional RHF with num_devices n (JCHEM_CONV_STREAM=0: the
    quartet-sharded direct route): within 1e-10 Eh of one device."""
    out = _same_on_every_rank(groups[n], "conventional", "scf")
    assert out["converged"] and out["builder"] == "ShardedDirectFock"
    assert abs(out["E"] - ref["conventional"]["E"]) <= 1e-10


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_pinv_fold(groups, ref, n):
    """A numerically singular metric folds with the pseudo-inverse square
    root on the ranks too: G within 1e-11 of one device and of the JAX
    package's sharded builder."""
    rf = ref["pinv"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g_jx = np.asarray(JxSharded(
            rf["jx_system"].primary, rf["jx_system"].auxiliary,
            jx_options({"scf_type": "df", "num_devices": n,
                        "mixed_precision": False}))
            .two_electron_fock(rf["D"], 1, JxTimings(), rf["C"]))
    for r in groups[n]:
        assert_close(r["pinv"]["G"], rf["G_one"], 1e-11)
        # the two packages' eigensolvers round the eigenvectors of this
        # cond ~1e17 metric differently, and the pseudo-inverse square root
        # amplifies that (6e-11 measured): not a property of the sharding
        assert_close(r["pinv"]["G"], g_jx, 1e-9)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_mp2(groups, ref, n):
    """Sharded RI-MP2 on identical orbitals: E2 within 1e-12 Eh of the JAX
    package's make_sharded_e2 and of one device, with its keys."""
    r, bs = ref["mp2"]["jx"]
    e_jx = jx_mp2.ri_mp2_energy(r, bs, opts=SimpleNamespace(num_devices=n))
    out = _same_on_every_rank(groups[n], "mp2")
    assert out["keys"] == sorted(e_jx)
    assert abs(out["E2"] - e_jx["E2"]) <= 1e-12
    assert abs(out["E2"] - ref["mp2"]["E2_one"]) <= 1e-12


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("method", ["uhf", "rohf"])
def test_sharded_open_shell(groups, ref, n, method):
    """UHF and ROHF doublets (OH) with num_devices n: the sharded JK
    builder, within 1e-10 Eh of one device and of the JAX package's
    sharded runs."""
    out = _same_on_every_rank(groups[n], method)
    assert out["converged"] and out["builder"] == "ShardedDFJKBuilder"
    assert abs(out["E"] - ref["open_shell"][method]) <= 1e-10
    mol, bs = ref["open_shell"]["jx"]
    energy = {"uhf": jx_uhf.energy, "rohf": jx_rohf.energy}
    e_jx = energy[method](mol, bs, {**OPEN, "num_devices": n})["Energy"]
    assert abs(out["E"] - float(e_jx)) <= 1e-10


@pytest.mark.parametrize("n", WORLDS)
def test_wrong_num_devices_raises(groups, n):
    for r in groups[n]:
        assert "process group has" in (r["wrong_num_devices"] or "")


def test_no_group_raises():
    """num_devices > 1 with no process group raises, saying how to start
    one."""
    mol, bs = _jx_system(WATER, "STO-3G", "cc-pVDZ-JKFIT")
    with pytest.raises(RuntimeError, match="torchrun"):
        tc.models.rhf.energy(interop.molecule(mol), interop.basis_sets(bs),
                             {**RHF, "num_devices": 2}, device=CPU)


def test_initialize_distributed_needs_a_multi_process_environment(
        monkeypatch):
    """No torchrun variables (or a world of one): no group, no waiting;
    NCCL with more ranks on the host than visible GPUs raises, before any
    process group is made."""
    from juliachem_jl_tpu_torch.parallel import mesh

    for var in ("WORLD_SIZE", "RANK", "JCHEM_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    assert mesh.initialize_distributed("cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh.initialize_distributed("cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("JCHEM_DIST_BACKEND", "nccl")
    with pytest.raises(RuntimeError, match="one GPU per rank"):
        mesh.initialize_distributed("cpu")
    assert not torch.distributed.is_initialized()


def test_failing_rank_stops_the_group():
    """Rank 1 raises while rank 0 waits in a collective: the launcher
    kills the group and re-raises rank 1's error well inside its
    timeout."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn(ranks.fail_on_rank_one, 2, timeout=60.0)
    assert time.perf_counter() - t0 < 30.0


def test_dist_smoke():
    """The rank-grid smoke on a 2 x 2 grid: every rank's sum over both axes
    and its gather agree."""
    res = dist_smoke.run_smoke(4, k_axis=2)
    assert [r["mesh"] for r in res] == [[2, 2]] * 4


# ------------------------------------------- the kernels' ranges (plain)


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_k5_t0_split(parts):
    """K5 staircase (plain version) over ``parts`` contiguous t0 ranges of
    each class pair sums to the whole-range launch within 1e-13 x max|JK|."""
    mol, bs = _jx_system(WATER, "6-31G", None)
    prim = interop.basis(bs.primary)
    sdf = tc_stream.StreamingDirectFock(prim, device=CPU)
    D, _ = _factor(prim.nbf, 5, seed=11)
    D = torch.as_tensor(D)
    whole = torch.zeros((2, prim.nbf, prim.nbf), dtype=torch.float64)
    split = torch.zeros_like(whole)
    for cp in sdf.pairs:
        bra, ket = sdf.blocks[cp.bi].table, sdf.blocks[cp.ki].table
        tc_stream.eri4c_jk_staircase(whole, bra, ket, cp.cum, cp.N, cp.same, D)
        for k in range(parts):
            s = share(cp.N, parts, k)
            tc_stream.eri4c_jk_staircase(split, bra, ket, cp.cum,
                                         s.stop - s.start, cp.same, D,
                                         t0=s.start)
    assert_close(split, whole, 1e-13 * float(whole.abs().max()))
    with pytest.raises(ValueError):
        tc_stream.eri4c_jk_staircase(split, bra, ket, cp.cum, 2, cp.same, D,
                                     t0=cp.N - 1)


@pytest.mark.parametrize("parts", [2, 3, 5])
@pytest.mark.parametrize("mode", ["rmp2", "ss", "os"])
def test_k7_range_split(mode, parts):
    """K7 (plain versions) over the occupied ranges of
    ``occupied_ranges(no, parts)`` sums to the whole-range energy within
    1e-14 Eh; the ranges cover [0, no) in order."""
    rng = np.random.default_rng(parts)
    no, nv, A = 7, 11, 13
    Bx = torch.as_tensor(0.1 * rng.standard_normal((A, no, nv)))
    By = torch.as_tensor(0.1 * rng.standard_normal((A, no - 1, nv + 2)))
    eo = torch.as_tensor(-1.0 - rng.random(no))
    ev = torch.as_tensor(0.5 + rng.random(nv))
    eo_b = torch.as_tensor(-1.0 - rng.random(no - 1))
    ev_b = torch.as_tensor(0.5 + rng.random(nv + 2))
    ranges = tc_mp2.occupied_ranges(no, parts)
    assert ranges[0][0] == 0 and ranges[-1][1] == no
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))

    def e(i_range=None):
        if mode == "os":
            return tc_mp2.e2_os(Bx, By, eo, ev, eo_b, ev_b, i_range)
        if mode == "rmp2":
            return np.array(tc_mp2.e2_rmp2(Bx, eo, ev, i_range))
        return tc_mp2.e2_ss(Bx, eo, ev, i_range)

    whole = e()
    total = sum(e(r) for r in ranges)
    assert np.all(np.abs(total - whole) <= 1e-14)
