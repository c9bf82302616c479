"""Conventional (direct-SCF) RHF of the PyTorch port vs the JAX package, on
the CPU (the kernels' plain versions).

Water with 6-31G* and 6-31+G* (d shells, so every class with l <= 2):
- K4's plain version, every class: within 1e-12 x the block's max-abs of
  the JAX ``_eri_kernel_body`` on the same numpy inputs;
- the screened quartet batches (set and weights) exactly, and the
  staircase quartet count equal to the JAX count;
- J and K at one fixed symmetric D, for DenseFock, ScreenedDirectFock
  in-core (K6's plain version) and direct (K5 list mode) and
  StreamingDirectFock (K5 staircase mode), within 1e-11 x max(|J|, |K|) of
  the JAX in-core ScreenedDirectFock (as tests/test_fock_stream.py holds
  its two builders);
- the router: the JAX router's builder under the same environment, and
  one Schwarz diagonal for its quartet count and the builder;
- the primitive-quartet and Boys-series counts behind chip_smoke.py's
  bounds, over both builders' quartets and against a numpy count.

run_spec parity is in tests/test_torch_conventional_scf.py (a file of its
own, so the test workers run the two in parallel).
"""

import numpy as np
import pytest
import torch

import chip_smoke
import juliachem_jl_tpu as jx
import juliachem_jl_tpu_torch as tc
from juliachem_jl_tpu.models import rhf as jx_rhf
from juliachem_jl_tpu.ops import eri as jx_eri
from juliachem_jl_tpu.ops import fock as jx_fock
from juliachem_jl_tpu.ops import fock_stream as jx_fock_stream
from juliachem_jl_tpu.ops.pairs import unique_pair_blocks as jx_blocks
from juliachem_jl_tpu.utils.options import create_scf_options as jx_options
from juliachem_jl_tpu.utils.timings import Timings as JxTimings
from juliachem_jl_tpu_torch import interop
from juliachem_jl_tpu_torch.ops import eri as tc_eri
from juliachem_jl_tpu_torch.ops import fock as tc_fock
from juliachem_jl_tpu_torch.ops import fock_stream as tc_fock_stream
from tests._torch_parity import CPU, WATER, assert_close, np_

PROPS = {"mo energies": True, "mulliken": True, "multipole": "dipole"}


def _basis(name="6-31+G*"):
    return jx.basis.build(jx.molecule.from_input_dict(WATER), name)


def _class_pairs():
    blocks = jx_blocks(_basis())
    return [(i, j) for i in range(len(blocks)) for j in range(i, len(blocks))]


@pytest.mark.parametrize("bi,bj", _class_pairs())
def test_k4_plain_matches_jax_eri_body(bi, bj):
    """Every class of water 6-31+G*, up to 40 random quartets each."""
    blocks = jx_blocks(_basis())
    bra, ket = blocks[bi], blocks[bj]
    rng = np.random.default_rng(100 * bi + bj)
    n = 40
    sb = rng.integers(0, bra.n, n)
    sk = rng.integers(0, ket.n, n)
    body = jx_eri._eri_kernel_body(bra.la, bra.lb, ket.la, ket.lb,
                                   bra.aexp.shape[1], bra.bexp.shape[1],
                                   ket.aexp.shape[1], ket.bexp.shape[1])
    ref = np.asarray(body(bra.aexp[sb], bra.bexp[sb], bra.acoef[sb],
                          bra.bcoef[sb], bra.A[sb], bra.B[sb],
                          ket.aexp[sk], ket.bexp[sk], ket.acoef[sk],
                          ket.bcoef[sk], ket.A[sk], ket.B[sk]))
    tb, tk = (tc_eri.pair_table(b, CPU)
              for b in interop.pair_blocks([bra, ket]))
    got = tc_eri.eri4c_class(tb, tk, torch.as_tensor(sb), torch.as_tensor(sk))
    assert_close(got, ref, 1e-12 * np.abs(ref).max())


def test_pair_table_puts_nonzero_primitives_first():
    """6-311G: core s shells of 6 primitives padded into the s class of the
    valence shells; the table counts the nonzero ones per shell."""
    b = jx.basis.build(jx.molecule.from_input_dict(WATER), "6-311G")
    blk = interop.pair_blocks([jx_blocks(b)[0]])[0]
    tab = tc_eri.pair_table(blk, CPU)
    ka = tab.meta[:, 2].numpy()
    assert list(ka) == list(np.count_nonzero(blk.acoef, axis=1))
    acoef = tab.pair[:, tab.Ka:2 * tab.Ka].numpy()
    for row, k in zip(acoef, ka):
        assert np.all(row[:k] != 0.0) and np.all(row[k:] == 0.0)


@pytest.mark.parametrize("name", ["6-31G*", "6-31+G*"])
def test_quartet_batches_match_jax(name):
    b = _basis(name)
    ref, Qref = jx_fock.build_quartet_batches(b)
    got, Q = tc_fock.build_quartet_batches(interop.basis(b), device=CPU)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g.bra.la, g.bra.lb, g.ket.la, g.ket.lb) == (
            r.bra.la, r.bra.lb, r.ket.la, r.ket.lb)
        np.testing.assert_array_equal(g.bra.ish[g.sel_bra], r.bra.ish[r.sel_bra])
        np.testing.assert_array_equal(g.bra.jsh[g.sel_bra], r.bra.jsh[r.sel_bra])
        np.testing.assert_array_equal(g.ket.ish[g.sel_ket], r.ket.ish[r.sel_ket])
        np.testing.assert_array_equal(g.ket.jsh[g.sel_ket], r.ket.jsh[r.sel_ket])
        np.testing.assert_array_equal(g.weight, r.weight)
    assert_close(Q, Qref, 1e-12 * np.abs(Qref).max())


def test_shell_pair_bounds_match_jax():
    from juliachem_jl_tpu.ops.schwarz import shell_pair_bounds as jx_bounds
    from juliachem_jl_tpu_torch.ops.schwarz import shell_pair_bounds

    b = _basis("6-31+G*")
    ref = jx_bounds(b)
    assert_close(shell_pair_bounds(interop.basis(b), CPU), ref,
                 1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("name", ["6-31G*", "6-31+G*"])
def test_count_screened_quartets_matches_jax(name):
    b = _basis(name)
    n = tc_fock_stream.count_screened_quartets(interop.basis(b), device=CPU)
    assert n == jx_fock_stream.count_screened_quartets(b)
    builder = tc_fock.ScreenedDirectFock(interop.basis(b), device=CPU)
    assert builder.n_quartets == n


@pytest.fixture(scope="module")
def jk_reference():
    """JAX in-core ScreenedDirectFock J, K at a fixed symmetric D."""
    b = _basis("6-31G*")
    rng = np.random.default_rng(0)
    X = rng.standard_normal((b.nbf, b.nbf))
    D = X + X.T
    J, K = jx_fock.ScreenedDirectFock(b, incore=True).jk_halves(
        D, 1, JxTimings())
    return b, D, np.asarray(J), np.asarray(K)


BUILDERS = {
    "dense": lambda b: tc_fock.DenseFock(b, CPU),
    "screened-incore": lambda b: tc_fock.ScreenedDirectFock(b, incore=True,
                                                            device=CPU),
    "screened-direct": lambda b: tc_fock.ScreenedDirectFock(b, incore=False,
                                                            device=CPU),
    "streaming": lambda b: tc_fock_stream.StreamingDirectFock(b, device=CPU),
}


@pytest.mark.parametrize("builder", list(BUILDERS))
def test_jk_halves_match_jax(jk_reference, builder):
    b, D, Jr, Kr = jk_reference
    fb = BUILDERS[builder](interop.basis(b))
    J, K = fb.jk_halves(torch.as_tensor(D))
    scale = max(np.abs(Jr).max(), np.abs(Kr).max())
    assert_close(J, Jr, 1e-11 * scale)
    assert_close(K, Kr, 1e-11 * scale)


def _list_prims(builder):
    """(padded, nonzero-coefficient, Boys-series) primitive quartets of a
    ScreenedDirectFock's quartet lists, counted as chip_smoke.py counts them."""
    out = np.zeros(3, dtype=np.int64)
    for g in builder.groups:
        out += (g.sel_bra.shape[0] * g.bra.Ka * g.bra.Kb * g.ket.Ka * g.ket.Kb,
                *chip_smoke.quartet_prims(g.bra, g.ket, g.sel_bra, g.sel_ket))
    return tuple(int(x) for x in out)


def test_streaming_counts_fewer_real_primitive_quartets():
    """6-311G pads its core s shells to 6 primitives: the kernels visit the
    nonzero-coefficient primitive quartets only, and the counts of
    chip_smoke.py's bounds are the same over both conventional builders'
    quartets (lists and staircases)."""
    b = interop.basis(jx.basis.build(jx.molecule.from_input_dict(WATER),
                                     "6-311G"))
    p1 = _list_prims(tc_fock.ScreenedDirectFock(b, device=CPU))
    stair = chip_smoke.staircase_prims(
        tc_fock_stream.StreamingDirectFock(b, device=CPU))
    p2 = tuple(sum(x[k] for x in stair)
               for k in ("padded", "n_prim", "n_series"))
    assert p1 == p2
    assert p1[1] < p1[0]


def test_boys_series_count_matches_numpy():
    """The Boys arguments T = pq/(p+q)|P-Q|^2 <= 35 that chip_smoke.py
    charges with the series, against a direct numpy count over the JAX
    package's quartet batches (water 6-311G, padded shells)."""
    jb = jx.basis.build(jx.molecule.from_input_dict(WATER), "6-311G")
    n_live = n_series = 0
    for bt in jx_fock.build_quartet_batches(jb)[0]:
        def prims(blk, sel):
            a, b = blk.aexp[sel][:, :, None], blk.bexp[sel][:, None, :]
            p = a + b
            P = (a[..., None] * blk.A[sel][:, None, None]
                 + b[..., None] * blk.B[sel][:, None, None]) / p[..., None]
            live = ((blk.acoef[sel] != 0)[:, :, None]
                    & (blk.bcoef[sel] != 0)[:, None, :])
            n = len(sel)
            return p.reshape(n, -1), P.reshape(n, -1, 3), live.reshape(n, -1)

        p, P, lb = prims(bt.bra, bt.sel_bra)
        q, Q, lk = prims(bt.ket, bt.sel_ket)
        T = (p[:, :, None] * q[:, None] / (p[:, :, None] + q[:, None])
             * ((P[:, :, None] - Q[:, None]) ** 2).sum(-1))
        live = lb[:, :, None] & lk[:, None]
        n_live += int(live.sum())
        n_series += int((live & (T <= 35.0)).sum())
    got = _list_prims(tc_fock.ScreenedDirectFock(interop.basis(jb),
                                                 device=CPU))
    assert got[1:] == (n_live, n_series)
    assert 0 < n_series < n_live


@pytest.mark.parametrize("env,route", [
    ({}, "ScreenedDirectFock"),
    ({"JCHEM_CONV_STREAM": "1"}, "StreamingDirectFock"),
    ({"JCHEM_CONV_STREAM_THRESHOLD": "10"}, "StreamingDirectFock"),
    ({"JCHEM_CONV_STREAM": "0", "JCHEM_CONV_STREAM_THRESHOLD": "10"},
     "ScreenedDirectFock"),
    ({"JCHEM_INCORE_BUDGET": "100"}, "ScreenedDirectFock"),
], ids=["default", "stream-forced", "stream-threshold", "stream-off",
        "direct"])
def test_router_reads_the_jax_environment(monkeypatch, env, route):
    """The port's router picks the JAX router's builder (and in-core mode)
    under the same environment."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    b = _basis("6-31G*")
    flags = {"scf_type": "rhf"}
    jb = jx_rhf._make_fock_builder(jx.basis.CalculationBasisSets(b, None),
                                   jx_options(flags), prefer_df=False)
    tb = tc.models.rhf._make_fock_builder(
        tc.basis.CalculationBasisSets(interop.basis(b), None),
        tc.utils.options.create_scf_options(flags), CPU, False)
    assert type(tb).__name__ == type(jb).__name__ == route
    if route == "ScreenedDirectFock":
        assert tb.incore == jb.incore == ("JCHEM_INCORE_BUDGET" not in env)


def test_dense_route_runs_densefock():
    """contraction_mode "dense" up to 160 functions: DenseFock, the same
    energy as the screened in-core route within 1e-8 Eh."""
    def energy(mode):
        scf = {"scf_type": "rhf", "niter": 40, "dele": 1e-9, "rmsd": 1e-7,
               "guess": "sad", "contraction_mode": mode}
        return tc.run_spec(tc.io.parse_input({
            "molecule": WATER, "model": {"method": "RHF", "basis": "6-31G*"},
            "keywords": {"scf": scf}}), device=CPU)["Energy"]

    e, ref = energy("dense"), energy("default")
    assert e["Timings"].non_timing_data["fock_builder"] == "DenseFock"
    assert ref["Timings"].non_timing_data["fock_builder"] == "ScreenedDirectFock"
    assert abs(e["Energy"] - ref["Energy"]) <= 1e-8
    assert np_(e["Density"]).shape == (19, 19)


@pytest.mark.parametrize("env", [{}, {"JCHEM_CONV_STREAM_THRESHOLD": "10"}],
                         ids=["screened", "streaming"])
def test_router_computes_the_schwarz_diagonal_once(monkeypatch, env):
    """The quartet count that picks the builder and the builder itself share
    one Schwarz diagonal: one pair_schwarz call per pair block."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    pair_schwarz = tc_fock.pair_schwarz
    monkeypatch.setattr(tc_fock, "pair_schwarz",
                        lambda b, d: calls.append(b) or pair_schwarz(b, d))
    b = interop.basis(_basis("6-31G*"))
    tc.models.rhf._make_fock_builder(
        tc.basis.CalculationBasisSets(b, None),
        tc.utils.options.create_scf_options({"scf_type": "rhf"}), CPU, False)
    assert len(calls) == len(tc.ops.pairs.unique_pair_blocks(b))
