"""K9 (csrc/oei*.cu, the one-electron integrals) on the CPU: its plain
version against the JAX package, its host packing, and its wrapper.

- ``overlap_kinetic_nuclear_plain`` (K9's oracle on the card) against the
  JAX package's ``overlap_kinetic_nuclear`` within 1e-12 absolute on every
  class of unique shell pairs to (gg): water (a G shell on O) in the g
  basis file read by each package's own reader, each class's stored
  elements compared on their own.
- The packing of ``stv_tables``: each shell pair's live primitive pairs
  are exactly the nonzero-coefficient pairs of its padded block, in the
  block's order; the shell pairs' rows cover the packed rows once; the
  store map (block plus transpose, a diagonal pair once) covers every (i,
  j) of nbf x nbf exactly once.
- ``stv_class`` (K9's wrapper for one class) refuses CPU tensors and
  launches nothing.
- The wrapper sends the CPU to the plain version and packs nothing for K9
  there; its card branch raises NotImplementedError for a shell above g
  before anything reaches the card.
"""

import dataclasses
import functools
import pathlib

import numpy as np
import pytest
import torch

import juliachem_jl_tpu as jx
from juliachem_jl_tpu.ops import oei as jx_oei
from juliachem_jl_tpu_torch import basis as tbasis
from juliachem_jl_tpu_torch import molecule as tmolecule
from juliachem_jl_tpu_torch.ops import oei
from juliachem_jl_tpu_torch.ops.pairs import unique_pair_blocks

torch.set_num_threads(1)
CPU = torch.device("cpu")
G_FILE = pathlib.Path(__file__).parent / "data" / "6-311ppG_3df_3pd_G.gbs"
G_BASIS = "6-311++G(3df,3pd)+G"
WATER = {"symbols": ["O", "H", "H"],
         "geometry": [0.0, 0.0, 0.116321, 0.0, 0.751155, -0.465285,
                      0.0, -0.751155, -0.465285]}
CLASSES = [(a, b) for a in range(5) for b in range(a, 5)]


@functools.lru_cache(maxsize=None)
def _g_water():
    """(port basis, port molecule, plain S/T/V, JAX S/T/V) of water in the
    g basis file."""
    tbasis.register_basis_file(str(G_FILE), G_BASIS)
    jx.basis.register_basis_file(str(G_FILE), G_BASIS)
    tmol = tmolecule.from_input_dict(WATER)
    jmol = jx.molecule.from_input_dict(WATER)
    tb = tbasis.build(tmol, G_BASIS)
    ref = jx_oei.overlap_kinetic_nuclear(jx.basis.build(jmol, G_BASIS), jmol)
    got = oei.overlap_kinetic_nuclear_plain(tb, tmol, CPU)
    return tb, tmol, [m.numpy() for m in got], ref


def _system(name):
    mol = tmolecule.from_input_dict(WATER)
    if name == G_BASIS:
        tbasis.register_basis_file(str(G_FILE), G_BASIS)
    return tbasis.build(mol, name), mol


@pytest.mark.parametrize("cls", CLASSES)
def test_plain_matches_jax_on_each_class(cls):
    tb, _, got, ref = _g_water()
    tab = {(t.la, t.lb): t for t in oei.stv_tables(tb, CPU)}[cls]
    idx = oei.stv_targets(tab, tb.nbf).reshape(-1)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert np.max(np.abs(g.reshape(-1)[idx] - r.reshape(-1)[idx])) <= 1e-12


@pytest.mark.parametrize("name", ["6-31+G*", "6-311++G(3df,3pd)", G_BASIS])
def test_packing_lists_the_nonzero_primitive_pairs(name):
    b, _ = _system(name)
    padded = 0
    for blk, tab in zip(unique_pair_blocks(b), oei.stv_tables(b, CPU)):
        assert (tab.la, tab.lb) == (blk.la, blk.lb)
        meta = tab.meta.numpy()
        prim = tab.prim.numpy()
        assert tab.n == blk.n and meta.dtype == np.int32
        # the pairs' rows tile the packed rows: each row once, in order
        assert np.array_equal(meta[:, 3], np.concatenate(
            [[0], np.cumsum(meta[:, 4])[:-1]]))
        assert meta[:, 4].sum() == prim.shape[0]
        assert np.all(np.diff(meta[:, 4]) <= 0)      # most first
        # each shell pair of the block once, found by its offsets
        key = {(oa, ob): k for k, (oa, ob) in
               enumerate(zip(blk.off_a.tolist(), blk.off_b.tolist()))}
        assert len(key) == blk.n
        seen = set()
        for r, row in enumerate(meta):
            k = key[(int(row[0]), int(row[1]))]
            seen.add(k)
            assert bool(row[2]) == (blk.ish[k] == blk.jsh[k])
            assert np.array_equal(tab.pair.numpy()[r],
                                  np.concatenate([blk.A[k], blk.B[k]]))
            ii, jj = np.nonzero((blk.acoef[k] != 0)[:, None]
                                & (blk.bcoef[k] != 0)[None, :])
            want = np.stack([blk.aexp[k, ii], blk.bexp[k, jj],
                             blk.acoef[k, ii] * blk.bcoef[k, jj]], axis=1)
            assert np.array_equal(prim[row[3]:row[3] + row[4]], want)
            padded += blk.aexp.shape[1] * blk.bexp.shape[1] - row[4]
        assert len(seen) == blk.n
    # the bases pad their classes to the longest contraction: the packing
    # leaves the padding out
    assert padded > 0


@pytest.mark.parametrize("name", ["6-31+G*", "6-311++G(3df,3pd)", G_BASIS])
def test_store_map_covers_every_element_once(name):
    b, _ = _system(name)
    hits = np.zeros(b.nbf * b.nbf, dtype=np.int64)
    for tab in oei.stv_tables(b, CPU):
        dst = oei.stv_targets(tab, b.nbf)
        # a diagonal pair's block is its own transpose: stored once
        off = tab.meta.numpy()[:, 2] == 0
        assert np.array_equal(dst[~off, :, 0], dst[~off, :, 1])
        np.add.at(hits, dst[off].reshape(-1), 1)
        np.add.at(hits, dst[~off, :, 0].reshape(-1), 1)
    assert np.all(hits == 1)


def test_stv_class_refuses_cpu_tensors(monkeypatch):
    b, mol = _system("6-31+G*")
    atoms = oei.atom_table(mol, CPU)
    M = [torch.zeros((b.nbf, b.nbf), dtype=torch.float64) for _ in range(3)]

    def refuse(*a, **k):
        raise AssertionError("K9 launched on CPU tensors")

    monkeypatch.setattr(oei.kernels, "launch", refuse)
    for tab in oei.stv_tables(b, CPU):
        with pytest.raises(ValueError, match="CUDA"):
            oei.stv_class(tab, atoms, *M)
    assert all(not bool(m.any()) for m in M)


def test_wrapper_runs_the_plain_version_on_the_cpu(monkeypatch):
    b, mol = _system("6-31+G*")
    ref = oei.overlap_kinetic_nuclear_plain(b, mol, CPU)

    def refuse(*a, **k):
        raise AssertionError("K9's packing on the CPU path")

    monkeypatch.setattr(oei, "stv_tables", refuse)
    got = oei.overlap_kinetic_nuclear(b, mol, "cpu")
    for g, r in zip(got, ref):
        assert g.device.type == "cpu"
        assert torch.equal(g, r)


def test_card_branch_raises_above_g_before_the_card():
    b, mol = _system("6-31+G*")
    h = dataclasses.replace(b.classes[0], l=5)
    b5 = dataclasses.replace(b, classes={**b.classes, 5: h})
    with pytest.raises(NotImplementedError):
        oei.overlap_kinetic_nuclear(b5, mol, "cuda")
    with pytest.raises(NotImplementedError):
        oei.check_stv_class(2, 5)
    oei.check_stv_class(4, 4)
