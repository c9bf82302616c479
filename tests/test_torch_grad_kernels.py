"""K10 (csrc/oei_grad.cuh) and K11 (csrc/eri3c_grad.cuh), the gradient's
derivative kernels, on the CPU: their plain versions against the JAX
package and against the port's per-class routes, their host tables, and
their wrappers.

- K10's plain version (``oei_grad.stv_grad_plain``) against the JAX
  package's ``stv_gradients`` contracted with a seeded symmetric D and W,
  within 1e-11 Eh/bohr: water 6-31G* and water in an f basis,
  6-31G(2df,p); the CPU route of ``one_electron_gradient`` (the
  derivative matrices contracted) against it.
- K11's plain versions (the CPU route of ``df_two_electron_gradient``)
  against the JAX package's ``df_two_electron_gradient`` at a seeded D,
  closed shell and with spin densities, within 1e-11 Eh/bohr: water
  6-31G* / cc-pVDZ-JKFIT in the solid-harmonic aux space, and water 6-31G
  with the contracted 6-31G set as the aux basis (aux shells of several
  primitives) in the Cartesian one.
- Class by class to (gg) on a small g basis (an O and an H in
  tests/data/6-311ppG_3df_3pd_G.gbs, cc-pVTZ-JKFIT aux to g): K10's plain
  version against the port's padded-block route (``_stv_grad_block`` and
  ``_scatter`` into the derivative matrices, contracted), and K11's
  3-center and metric plain versions against ``eri_grad_class`` over the
  shells' padded blocks (every ordered pair for the metric), within
  1e-11 x the class's max |g| (1e-11 where that is below 1).
- The fit's gamma and Omega (``eri_grad.df_gamma_omega``) are what the
  gradient contracts; the lift of gamma by column chunks gives the whole
  lift's numbers.
- The tables list every live primitive pair once, with both shells'
  atoms; K11's items (every aux shell with every pair; the metric's
  unordered pairs on two atoms) once each.
- The wrappers refuse CPU tensors and launch nothing; a class without an
  instance raises NotImplementedError before anything reaches the card.
"""

import dataclasses
import functools
import pathlib
import warnings
from collections import Counter

import numpy as np
import pytest
import torch

import juliachem_jl_tpu as jx
from juliachem_jl_tpu.ops import eri_grad as jx_eri_grad
from juliachem_jl_tpu.ops.oei_grad import stv_gradients as jx_stv
from juliachem_jl_tpu_torch import basis as tbasis
from juliachem_jl_tpu_torch import interop
from juliachem_jl_tpu_torch import molecule as tmolecule
from juliachem_jl_tpu_torch.ops import eri_grad, oei, oei_grad
from juliachem_jl_tpu_torch.ops.pairs import unique_pair_blocks

torch.set_num_threads(1)
CPU = torch.device("cpu")
G_FILE = pathlib.Path(__file__).parent / "data" / "6-311ppG_3df_3pd_G.gbs"
G_BASIS = "6-311++G(3df,3pd)+G"
WATER = {"symbols": ["O", "H", "H"],
         "geometry": [0.0, 0.0, 0.116321, 0.0, 0.751155, -0.465285,
                      0.0, -0.751155, -0.465285]}
OH = {"symbols": ["O", "H"], "geometry": [0.0, 0.0, 0.0, 0.3, 0.8, 1.1],
      "molecular_multiplicity": 2}
CLASSES = [(a, b) for a in range(5) for b in range(a, 5)]


def _sym(n: int, seed: int) -> np.ndarray:
    X = np.random.default_rng(seed).standard_normal((n, n))
    return X + X.T


def _jax(molecule, prim, aux=None):
    mol = jx.molecule.from_input_dict(molecule)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bs = jx.basis.CalculationBasisSets(
            jx.basis.build(mol, prim),
            jx.basis.build_auxiliary(mol, aux, prim) if aux else None)
    return mol, bs


@pytest.mark.parametrize("name", ["6-31G*", "6-31G(2df,p)"])
def test_k10_plain_matches_jax(name):
    mol, bs = _jax(WATER, name)
    D, W = _sym(bs.primary.nbf, 1), _sym(bs.primary.nbf, 2)
    dS, dT, dV = jx_stv(bs.primary, mol)
    ref = (np.einsum("pq,kdpq->kd", D, dT + dV)
           - np.einsum("pq,kdpq->kd", W, dS))
    prim, pm = interop.basis(bs.primary), interop.molecule(mol)
    Dt, Wt = torch.as_tensor(D), torch.as_tensor(W)
    work = Counter()
    got = oei_grad.stv_grad_plain(oei_grad.stv_grad_tables(prim, CPU),
                                  oei.atom_table(pm, CPU), Dt, Wt, work)
    assert np.max(np.abs(got.numpy() - ref)) <= 1e-11
    # the work of each class: its pairs, by live primitive count
    assert sum(n for k, n in work.items()) == sum(
        b.n for b in unique_pair_blocks(prim))
    cpu = oei_grad.one_electron_gradient(prim, pm, Dt, Wt)
    assert cpu.device.type == "cpu"
    assert float((cpu - got).abs().max()) <= 1e-11


@pytest.mark.parametrize("case", ["rhf sph", "spin sph", "rhf contracted aux",
                                  "spin contracted aux"])
def test_k11_plain_matches_jax(case):
    spin = case.startswith("spin")
    sph = case.endswith("sph")
    prim_name, aux_name = (("6-31G*", "cc-pVDZ-JKFIT") if sph
                           else ("6-31G", "6-31G"))
    mol, bs = _jax(WATER, prim_name, aux_name)
    D = 0.1 * _sym(bs.primary.nbf, 3)
    spins = (0.6 * D, 0.4 * D) if spin else None
    ref = jx_eri_grad.df_two_electron_gradient(
        bs.primary, bs.auxiliary, mol, D, spin_densities=spins, sph_aux=sph)
    got = eri_grad.df_two_electron_gradient(
        interop.basis(bs.primary), interop.basis(bs.auxiliary),
        interop.molecule(mol), torch.as_tensor(D),
        spin_densities=None if spins is None else tuple(
            torch.as_tensor(x) for x in spins), sph_aux=sph)
    assert np.max(np.abs(got.numpy() - ref)) <= 1e-11


@pytest.mark.parametrize("cols", [1, 7, 100, None])
def test_lift_by_column_chunks_equals_the_whole_lift(cols):
    """``lift_rows_sph`` with ``cols`` (the DF gradient lifts gamma that
    way) gives the whole lift's numbers, on an aux set to g."""
    from juliachem_jl_tpu_torch.basis.spherical import (_shell_rows,
                                                        lift_rows_sph)

    _, aux, _ = _g_system()
    n_sph = _shell_rows(aux)[1]
    X = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (n_sph, 9, 23)))
    whole = lift_rows_sph(aux, X)
    got = lift_rows_sph(aux, X, cols=cols)
    assert got.shape == (aux.nbf, 9, 23)
    assert float((got - whole).abs().max()) <= 1e-15 * float(
        whole.abs().max())


@pytest.mark.parametrize("sph", [True, False])
def test_gamma_omega_are_what_the_gradient_contracts(sph):
    """``df_gamma_omega`` (the smoke holds K11 to its plain versions on
    its gamma and Omega) is what ``df_two_electron_gradient`` contracts:
    the plain derivative terms on it give the gradient, and it reports the
    three parts it times."""
    mol, bs = _jax(WATER, "6-31G*", "cc-pVDZ-JKFIT")
    prim, aux = interop.basis(bs.primary), interop.basis(bs.auxiliary)
    pm = interop.molecule(mol)
    D = torch.as_tensor(0.1 * _sym(prim.nbf, 3))
    laps = []
    gamma, Omega = eri_grad.df_gamma_omega(prim, aux, D, sph_aux=sph,
                                           lap=laps.append)
    assert laps == ["three_center", "metric", "fit"]
    assert gamma.shape == (aux.nbf, prim.nbf, prim.nbf)
    assert Omega.shape == (aux.nbf, aux.nbf)
    aux_t, pair_t = eri_grad.df_grad_tables(prim, aux, CPU)
    g = torch.zeros((pm.natom, 3), dtype=torch.float64)
    eri_grad.three_center_grad_plain(aux_t, pair_t, gamma, g)
    eri_grad.metric_grad_plain(aux_t, Omega, g)
    ref = eri_grad.df_two_electron_gradient(prim, aux, pm, D, sph_aux=sph)
    assert float((g - ref).abs().max()) == 0.0


# ------------------------------------------------------------ class by class

@functools.lru_cache(maxsize=None)
def _g_system():
    """(primary, aux, molecule) of an O and an H in the g basis file with
    cc-pVTZ-JKFIT: every primary class to (gg), aux classes to g."""
    tbasis.register_basis_file(str(G_FILE), G_BASIS)
    mol = tmolecule.from_input_dict(OH)
    return (tbasis.build(mol, G_BASIS),
            tbasis.build_auxiliary(mol, "cc-pVTZ-JKFIT", G_BASIS), mol)


@functools.lru_cache(maxsize=None)
def _g_inputs():
    prim, aux, mol = _g_system()
    rng = np.random.default_rng(7)
    X = rng.standard_normal((aux.nbf, prim.nbf, prim.nbf))
    return (torch.as_tensor(_sym(prim.nbf, 4)),
            torch.as_tensor(_sym(prim.nbf, 5)),
            torch.as_tensor(X + X.transpose(0, 2, 1)),
            torch.as_tensor(_sym(aux.nbf, 6)))


def _close(got, ref):
    """Within 1e-11 x the class's max |g|, or 1e-11 where that is below 1
    (a class whose shells sit on one atom sums to zero: the block route
    leaves rounding there, the metric's table skips it)."""
    scale = max(float(ref.abs().max()), 1.0)
    assert float((got - ref).abs().max()) <= 1e-11 * scale


@pytest.mark.parametrize("cls", CLASSES)
def test_k10_plain_matches_the_block_route_on_each_class(cls):
    prim, _, mol = _g_system()
    D, W, _, _ = _g_inputs()
    blk = {(b.la, b.lb): b for b in unique_pair_blocks(prim)}[cls]
    natom, nbf = mol.natom, prim.nbf
    coords = torch.as_tensor(mol.coords)
    Z = torch.as_tensor(np.asarray(mol.z, dtype=float))
    ds, dt, dva, dvb, dvc = oei_grad._stv_grad_block(
        blk.la, blk.lb, *oei._block_args(blk, slice(None), CPU), coords, Z)
    M = {k: torch.zeros((natom, 3, nbf, nbf), dtype=torch.float64)
         for k in "STV"}
    at = torch.as_tensor(np.asarray(prim.shell_atom))
    at_a, at_b = at[blk.ish], at[blk.jsh]
    oei_grad._scatter(M["S"], blk, at_a, ds)
    oei_grad._scatter(M["S"], blk, at_b, -ds)
    oei_grad._scatter(M["T"], blk, at_a, dt)
    oei_grad._scatter(M["T"], blk, at_b, -dt)
    oei_grad._scatter(M["V"], blk, at_a, dva)
    oei_grad._scatter(M["V"], blk, at_b, dvb)
    oei_grad._scatter(M["V"], blk, None, dvc)
    ref = (torch.einsum("pq,kdpq->kd", D, M["T"] + M["V"])
           - torch.einsum("pq,kdpq->kd", W, M["S"]))
    tab = oei.stv_table(blk, CPU, prim.shell_atom)
    got = oei_grad.stv_grad_plain([tab], oei.atom_table(mol, CPU), D, W)
    _close(got, ref)


def _sides(prim, aux):
    atom_a, atom_p = np.asarray(aux.shell_atom), np.asarray(prim.shell_atom)
    return ({b.la: [eri_grad._Side(g, CPU, atom_a)
                    for _, g in eri_grad.live_groups(b)]
             for b in eri_grad.aux_unit_blocks(aux)},
            {(b.la, b.lb): [eri_grad._Side(g, CPU, atom_p)
                            for _, g in eri_grad.live_groups(b)]
             for b in unique_pair_blocks(prim)})


def _block_route(grad, bra, ket, contract):
    """Every (bra row, ket row) of two padded groups through
    ``eri_grad_class``: contract(ib, ik, dA, dC) -> (fA, fC) to the bra's
    atom and the ket's first atom; -(fA + fC) to the ket's second atom
    where it is a real shell."""
    b, k = bra.blk, ket.blk
    ib, ik = (torch.as_tensor(x.reshape(-1)) for x in np.meshgrid(
        np.arange(b.n), np.arange(k.n), indexing="ij"))
    dA, _, dC = eri_grad.eri_grad_class(b.la, b.lb, k.la, k.lb,
                                        *bra.take(ib), *ket.take(ik),
                                        need_b=False)
    fA, fC = contract(ib, ik, dA, dC)
    grad.index_add_(0, bra.atom_a[ib], fA)
    grad.index_add_(0, ket.atom_a[ik], fC)
    if bool((k.jsh >= 0).all()):
        grad.index_add_(0, ket.atom_b[ik], -(fA + fC))


@pytest.mark.parametrize("la", range(5))
@pytest.mark.parametrize("cls", CLASSES)
def test_k11_3c_plain_matches_the_block_route_on_each_class(la, cls):
    prim, aux, mol = _g_system()
    _, _, gamma, _ = _g_inputs()
    aux_s, pair_s = _sides(prim, aux)
    ref = torch.zeros((mol.natom, 3), dtype=torch.float64)
    for asd in aux_s[la]:
        for ps in pair_s[cls]:
            nca, (ncp, ncq) = asd.nc[0], ps.nc

            def contract(ib, ik, dA, dC, asd=asd, ps=ps):
                oa = asd.rows(ib, "a")
                op, oq = ps.rows(ik, "a"), ps.rows(ik, "b")
                g = gamma[oa[:, :, None, None], op[:, None, :, None],
                          oq[:, None, None, :]].reshape(-1, nca, ncp * ncq)
                w = (2.0 * ps.w[ik])[:, None]
                return (w * torch.einsum("nac,ndac->nd", g, dA),
                        w * torch.einsum("nac,ndac->nd", g, dC))

            _block_route(ref, asd, ps, contract)
    aux_t, pair_t = eri_grad.df_grad_tables(prim, aux, CPU)
    ti = {t.la: t for t in aux_t}[la]
    tj = {(t.la, t.lb): t for t in pair_t}[cls]
    got = torch.zeros_like(ref)
    eri_grad.three_center_grad_plain([ti], [tj], gamma, got)
    _close(got, ref)


@pytest.mark.parametrize("cls", CLASSES)
def test_k11_metric_plain_matches_the_block_route_on_each_class(cls):
    prim, aux, mol = _g_system()
    _, _, _, Omega = _g_inputs()
    aux_s, _ = _sides(prim, aux)
    ref = torch.zeros((mol.natom, 3), dtype=torch.float64)
    li, lj = cls
    for x, y in {(li, lj), (lj, li)}:   # every ordered pair of the classes
        for si in aux_s[x]:
            for sj in aux_s[y]:
                def contract(ib, ik, dA, dC, si=si, sj=sj):
                    op, oq = si.rows(ib, "a"), sj.rows(ik, "a")
                    om = Omega[op[:, :, None], oq[:, None, :]]
                    return (-torch.einsum("nac,ndac->nd", om, dA),
                            -torch.einsum("nac,ndac->nd", om, dC))

                _block_route(ref, si, sj, contract)
    aux_t, _ = eri_grad.df_grad_tables(prim, aux, CPU)
    t = {t.la: t for t in aux_t}
    got = torch.zeros_like(ref)
    eri_grad.metric_grad_plain([t[li]] if li == lj else [t[li], t[lj]],
                               Omega, got)
    if li != lj:   # [t[li], t[lj]] also walks (li|li) and (lj|lj): drop them
        for only in (t[li], t[lj]):
            eri_grad.metric_grad_plain([only], -Omega, got)
    _close(got, ref)


# ------------------------------------------------------------------ tables

@pytest.mark.parametrize("name", ["6-31+G*", G_BASIS])
def test_tables_list_each_primitive_pair_once_with_its_atoms(name):
    tbasis.register_basis_file(str(G_FILE), G_BASIS)
    mol = tmolecule.from_input_dict(WATER)
    b = tbasis.build(mol, name)
    atom_of = np.asarray(b.shell_atom)
    for blk, tab in zip(unique_pair_blocks(b),
                        oei_grad.stv_grad_tables(b, CPU)):
        meta, prim = tab.meta.numpy(), tab.prim.numpy()
        assert meta.shape == (blk.n, 7)
        assert np.array_equal(meta[:, 3], np.concatenate(
            [[0], np.cumsum(meta[:, 4])[:-1]]))
        assert meta[:, 4].sum() == prim.shape[0]
        key = {(oa, ob): k for k, (oa, ob) in
               enumerate(zip(blk.off_a.tolist(), blk.off_b.tolist()))}
        seen = set()
        for row in meta:
            k = key[(int(row[0]), int(row[1]))]
            seen.add(k)
            assert (row[5], row[6]) == (atom_of[blk.ish[k]],
                                        atom_of[blk.jsh[k]])
            live = ((blk.acoef[k] != 0)[:, None]
                    & (blk.bcoef[k] != 0)[None, :]).sum()
            assert row[4] == live
        assert len(seen) == blk.n


def test_k11_items_each_once():
    """Every aux shell meets every pair (the kernel's items: aux shell
    major over the dense product), its own atoms; the metric's pairs are
    the unordered pairs of shells on two atoms, each once."""
    prim, aux, mol = _g_system()
    aux_t, pair_t = eri_grad.df_grad_tables(prim, aux, CPU)
    atom_a = np.asarray(aux.shell_atom)
    shells = []
    for t in aux_t:
        m = t.meta.numpy()
        assert np.all(m[:, 5] == m[:, 6])     # the unit partner's atom
        assert np.all(m[:, 1] == 0) and not m[:, 2].any()
        shells += [(t.la, int(o), int(a)) for o, a in zip(m[:, 0], m[:, 5])]
    assert len({s[1] for s in shells}) == len(shells) == len(aux.shells)
    assert sorted(a for _, _, a in shells) == sorted(atom_a.tolist())
    assert sum(t.n for t in pair_t) == sum(
        b.n for b in unique_pair_blocks(prim))
    seen = set()
    for a, ti in enumerate(aux_t):
        for tj in aux_t[a:]:
            i, j = eri_grad._metric_pairs(ti, tj)
            mi, mj = ti.meta.numpy(), tj.meta.numpy()
            for x, y in zip(i, j):
                key = frozenset([int(mi[x, 0]), int(mj[y, 0])])
                assert len(key) == 2 and key not in seen
                assert mi[x, 5] != mj[y, 5]
                seen.add(key)
    by_off = {o: at for _, o, at in shells}
    want = {frozenset([p, q]) for p in by_off for q in by_off
            if p != q and by_off[p] != by_off[q]}
    assert seen == want


# ----------------------------------------------------------------- wrappers

def test_wrappers_refuse_cpu_tensors(monkeypatch):
    prim, aux, mol = _g_system()
    D, W, gamma, Omega = _g_inputs()

    def refuse(*a, **k):
        raise AssertionError("a kernel launched on CPU tensors")

    monkeypatch.setattr(oei.kernels, "launch", refuse)
    atoms = oei.atom_table(mol, CPU)
    grad = torch.zeros((mol.natom, 3), dtype=torch.float64)
    for tab in oei_grad.stv_grad_tables(prim, CPU):
        with pytest.raises(ValueError, match="CUDA"):
            oei_grad.stv_grad_class(tab, atoms, D, W, grad)
    aux_t, pair_t = eri_grad.df_grad_tables(prim, aux, CPU)
    with pytest.raises(ValueError, match="CUDA"):
        eri_grad.eri3c_grad_class(aux_t[0], pair_t[0], gamma, grad)
    with pytest.raises(ValueError, match="CUDA"):
        eri_grad.metric_grad_class(aux_t[0], aux_t[1], Omega, grad)
    assert not bool(grad.any())


def test_cpu_route_runs_no_wrapper(monkeypatch):
    """On the CPU the gradient's derivative terms never reach a wrapper:
    the DF terms run K11's plain versions, the one-electron part the
    derivative matrices."""
    mol, bs = _jax(WATER, "6-31G", "cc-pVDZ-JKFIT")
    prim, aux = interop.basis(bs.primary), interop.basis(bs.auxiliary)
    pm = interop.molecule(mol)
    D = torch.as_tensor(0.1 * _sym(prim.nbf, 8))

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper on the CPU path")

    for mod, fn in ((oei_grad, "stv_grad_class"),
                    (eri_grad, "eri3c_grad_class"),
                    (eri_grad, "metric_grad_class")):
        monkeypatch.setattr(mod, fn, refuse)
    work = Counter()
    g1 = oei_grad.one_electron_gradient(prim, pm, D, D, work)
    g2 = eri_grad.df_two_electron_gradient(prim, aux, pm, D, work=work)
    assert g1.shape == g2.shape == (3, 3)
    assert {(k[0], k[2]) for k in work} == {("stv", 0), ("stv", 1),
                                             ("eri", -1)}


def test_a_class_without_an_instance_raises_before_the_card():
    prim, aux, mol = _g_system()
    h = dataclasses.replace(prim.classes[0], l=5)
    p5 = dataclasses.replace(prim, classes={**prim.classes, 5: h})
    a5 = dataclasses.replace(aux, classes={**aux.classes, 5: h})
    for bad in (dict(primary=p5, aux=aux), dict(primary=prim, aux=a5)):
        with pytest.raises(NotImplementedError):
            eri_grad.df_grad_tables(bad["primary"], bad["aux"], "cuda")
    with pytest.raises(NotImplementedError):
        oei_grad.stv_grad_tables(p5, "cuda")
