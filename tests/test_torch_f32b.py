"""The large-system DF chain of the PyTorch port (plain versions, on the CPU)
vs the JAX package: the f32 packed B, its fold, and the B and raw-3c caches.

- K8's plain version (the split fold) against the JAX package's
  ``_split_matmul``, elementwise within K8's gate:
  4 sqrt(A) 2^-24 (|Mh| + |Ml|) |X|;
- ``apply_triangular_inverse`` on an f32 B (Jacobi equilibration, f64
  product, f32 store) against the JAX package's on the cond-1e8 metric of
  tests/test_b_f32.py: within 1 f32 ulp, and 1e-5 relative of the f64
  solve; ``_apply_square`` with ``JCHEM_SPLIT_FOLD=1`` against the JAX
  package's split path (``_HOST_SOLVE_FLOPS`` patched to 0 in the test);
- ``build_B_packed`` with ``df_b_dtype: f32`` against the JAX package's,
  within 2 f32 ulp plus 1e-11 of the row's largest element: the f64
  values the two packages round to f32 carry the f64 B's own parity (its
  energies agree to 1e-11 Eh), so an element that is zero by
  symmetry in one package can be 1e-18 in the other (measured: 759 of
  73670 elements past 2 ulp, all below 1.6e-5 of their row's largest, by
  at most 4.0e-12 of it); the in-place projection and fold of an f64 B
  against the out-of-place products, within 1e-12;
- DF-RHF (packed) and DF-UHF of the water cation on an f32 B against the
  JAX package: within 1e-8 Eh in the same number of iterations;
- the B cache: a hit builds no 3-center tensor, a changed geometry or
  screening sigma rebuilds, a fold that fails resumes from the raw-3c
  checkpoint; the generated water clusters regenerate exactly.
"""

import json
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import juliachem_jl_tpu as jx
import juliachem_jl_tpu_torch as tc
from juliachem_jl_tpu.models import df_screened as jx_dfs
from juliachem_jl_tpu.models import linalg as jx_linalg
from juliachem_jl_tpu.utils.options import create_scf_options as jx_options
from juliachem_jl_tpu_torch import interop
from juliachem_jl_tpu_torch.basis.spherical import cart_to_sph_basis
from juliachem_jl_tpu_torch.models import df as tc_df
from juliachem_jl_tpu_torch.models import df_screened as tc_dfs
from juliachem_jl_tpu_torch.models import linalg as tc_linalg
from juliachem_jl_tpu_torch.ops import eri3c as tc_eri3c
from juliachem_jl_tpu_torch.utils.options import create_scf_options as tc_options
from tests._torch_parity import CPU, WATER, np_

REPO = Path(__file__).resolve().parents[1]


def _k8_bound(Mh, Ml, X):
    """K8's gate, elementwise: 4 sqrt(A) 2^-24 (|Mh| + |Ml|) |X|."""
    A = Mh.shape[1]
    return 4 * np.sqrt(A) * 2.0**-24 * ((np.abs(Mh) + np.abs(Ml)).astype(
        np.float64) @ np.abs(X).astype(np.float64))


def _split(M):
    Mh = M.astype(np.float32)
    return Mh, (M - Mh.astype(np.float64)).astype(np.float32)


def test_split_fold_plain_matches_jax_split_matmul():
    rng = np.random.default_rng(3)
    A, C = 200, 300
    M = np.tril(rng.standard_normal((A, A))) * np.logspace(0, 3, A)[None, :]
    X = rng.standard_normal((A, C)).astype(np.float32)
    Mh, Ml = _split(M)
    got = np_(tc_linalg.split_fold(*(torch.from_numpy(a) for a in (Mh, Ml, X))))
    ref = np.asarray(jx_linalg._split_matmul(Mh, Ml, X))
    bound = _k8_bound(Mh, Ml, X)
    assert got.dtype == np.float32
    assert np.all(np.abs(got.astype(np.float64) - ref) <= bound)
    exact = (Mh.astype(np.float64) + Ml) @ X.astype(np.float64)
    assert np.all(np.abs(got - exact) <= bound)


def _cond1e8_metric():
    """The cond-1e8 metric and 3-center rows of tests/test_b_f32.py:42-58."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((48, 48))
    w = np.logspace(-6, 2, 48)
    Q, _ = np.linalg.qr(A)
    M = (Q * w) @ Q.T
    M = 0.5 * (M + M.T)
    B0 = rng.standard_normal((48, 9))
    return M, B0


def test_apply_triangular_inverse_f32_matches_jax():
    M, B0 = _cond1e8_metric()
    L = np.linalg.cholesky(M)
    ref = jx_linalg.apply_triangular_inverse(L, B0.astype(np.float32))
    got = np_(tc_linalg.apply_triangular_inverse(
        torch.from_numpy(L), torch.from_numpy(B0.astype(np.float32))))
    assert got.dtype == np.float32
    assert np.all(np.abs(got - ref) <= np.spacing(np.abs(ref)))
    exact = np.linalg.solve(L, B0)
    assert np.abs(got - exact).max() / np.abs(exact).max() <= 1e-5


def test_split_apply_square_matches_jax(monkeypatch):
    """The split path of ``_apply_square`` (f32 B, JCHEM_SPLIT_FOLD=1): the
    JAX package takes it only above its host crossover, so its
    ``_HOST_SOLVE_FLOPS`` is set to 0 here."""
    M, B0 = _cond1e8_metric()
    L = np.linalg.cholesky(M)
    Ls = L / np.sqrt(np.einsum("ij,ij->i", L, L))[:, None]
    Minv = jx_linalg.triangular_inverse(Ls)
    X = B0.astype(np.float32)
    monkeypatch.setenv("JCHEM_SPLIT_FOLD", "1")
    monkeypatch.setattr(jx_linalg, "_HOST_SOLVE_FLOPS", 0)
    ref = jx_linalg._apply_square(Minv, X.copy())
    got = np_(tc_linalg._apply_square(torch.from_numpy(Minv),
                                      torch.from_numpy(X.copy())))
    bound = _k8_bound(*_split(Minv), X)
    assert np.all(np.abs(got.astype(np.float64) - ref) <= 2 * bound)


def _water_bsets(prim="6-31+G*", aux="cc-pVTZ-JKFIT", scale=1.0):
    mol = jx.molecule.from_input_dict(
        dict(WATER, geometry=[g * scale for g in WATER["geometry"]]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bsets = jx.basis.CalculationBasisSets(
            jx.basis.build(mol, prim), jx.basis.build_auxiliary(mol, aux, prim))
    return mol, bsets


def test_build_b_packed_f32_matches_jax():
    _, bsets = _water_bsets()
    flags = {"df_b_dtype": "f32"}
    Bj, sj = jx_dfs.build_B_packed(bsets.primary, bsets.auxiliary,
                                   jx_options(flags))
    pb = interop.basis_sets(bsets)
    Bt, st = tc_dfs.build_B_packed(pb.primary, pb.auxiliary,
                                   tc_options(flags), CPU)
    Bt = np_(Bt)
    assert Bt.dtype == np.float32 and Bt.shape == Bj.shape
    assert np.array_equal(st.pq_flat, sj.pq_flat)
    ulp = np.spacing(np.abs(Bj).astype(np.float32))
    row = np.abs(Bj).max(axis=1, keepdims=True)
    assert np.all(np.abs(Bt - Bj) <= 2 * ulp + 1e-11 * row)


def test_inplace_f64_build_matches_out_of_place():
    """The peak-free route (K1 into the packed tensor, in-place solid-harmonic
    projection, chunked in-place triangular solve) against the products
    made out of place, f64."""
    _, bsets = _water_bsets()
    pb = interop.basis_sets(bsets)
    prim, aux = pb.primary, pb.auxiliary
    opts = tc_options({})
    B, screen = tc_dfs.build_B_packed(prim, aux, opts, CPU)
    metric = tc_eri3c.two_center_metric(aux, CPU)
    pair_blocks = tc_df.screened_pair_blocks(
        prim, opts.df_screening_sigma, float(torch.diagonal(metric).max()), CPU)
    P3 = tc_eri3c.three_center_tensor(prim, aux, CPU, pair_blocks,
                                      col_map=screen.col_map,
                                      packed_width=screen.npq + 1)
    T = torch.from_numpy(cart_to_sph_basis(aux))
    L = torch.linalg.cholesky(T.T @ metric @ T)
    ref = torch.linalg.solve_triangular(L, T.T @ P3, upper=False)
    ref[:, -1] = 0.0
    assert B.shape == ref.shape
    assert float((B - ref).abs().max()) <= 1e-12


def _spec(method, extra, charge=0, mult=1):
    scf = {"scf_type": "df", "niter": 80, "dele": 1e-9, "rmsd": 1e-7,
           "guess": "sad", "contraction_mode": "screened",
           "df_b_dtype": "f32", **extra}
    return {"molecule": dict(WATER, molecular_charge=charge,
                             molecular_multiplicity=mult),
            "model": {"method": method, "basis": "6-31+G*",
                      "auxiliary_basis": "cc-pVTZ-JKFIT"},
            "keywords": {"scf": scf}}


@pytest.mark.parametrize("method,charge,mult,mixed", [
    ("RHF", 0, 1, False), ("RHF", 0, 1, True), ("UHF", 1, 2, False)],
    ids=["rhf", "rhf-mixed", "uhf-cation"])
def test_f32_b_energy_matches_jax(method, charge, mult, mixed):
    """Energy within 1e-8 Eh; with the f32 phase on (``rhf-mixed``, the
    f32 B read as it is) the two packages sum the f32 products in other
    orders, so their iteration counts may differ by the f32 noise and only
    the energy is held (ROADMAP.md C4)."""
    inp = _spec(method, {"mixed_precision": mixed}, charge, mult)
    ref = jx.run_spec(jx.io.parse_input(inp))["Energy"]
    got = tc.run_spec(tc.io.parse_input(inp), device=CPU)["Energy"]
    builder = "ScreenedDFFockBuilder" if method == "RHF" else "ScreenedDFJKBuilder"
    assert got["Timings"].non_timing_data["fock_builder"] == builder
    assert got["Converged?"] and ref["Converged?"]
    if not mixed:
        assert got["Iterations"] == ref["Iterations"]
    assert abs(got["Energy"] - ref["Energy"]) <= 1e-8


# ------------------------------------------------------------- the B cache


def _port_bsets(scale=1.0):
    _, bsets = _water_bsets("6-31G", "cc-pVDZ-JKFIT", scale)
    return interop.basis_sets(bsets)


def _counting_3c(monkeypatch):
    calls = []
    real = tc_eri3c.three_center_tensor

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tc_eri3c, "three_center_tensor", counted)
    return calls


def test_b_cache_hit_builds_no_3c_tensor(tmp_path, monkeypatch):
    pb = _port_bsets()
    opts = tc_options({"df_b_dtype": "f32", "df_b_cache": str(tmp_path / "c")})
    B1, s1 = tc_dfs.build_B_packed(pb.primary, pb.auxiliary, opts, CPU)
    assert not (tmp_path / "c_torch_raw.npy").exists()   # dropped

    def refuse(*args, **kw):
        raise AssertionError("the cache hit built a 3-center tensor")

    monkeypatch.setattr(tc_eri3c, "three_center_tensor", refuse)
    B2, s2 = tc_dfs.build_B_packed(pb.primary, pb.auxiliary, opts, CPU)
    assert B2.dtype == torch.float32 and torch.equal(B1, B2)
    assert np.array_equal(s1.col_map, s2.col_map)


@pytest.mark.parametrize("change", ["geometry", "sigma", "dtype"])
def test_b_cache_mismatch_rebuilds(tmp_path, monkeypatch, change):
    """Another geometry, another screening sigma (which the JAX package's
    cache does not record, ROADMAP.md C3) or another dtype: the cache misses
    and B is built again."""
    flags = {"df_b_dtype": "f32", "df_b_cache": str(tmp_path / "c")}
    pb = _port_bsets()
    tc_dfs.build_B_packed(pb.primary, pb.auxiliary, tc_options(flags), CPU)
    calls = _counting_3c(monkeypatch)
    if change == "geometry":
        pb = _port_bsets(scale=1.05)
    elif change == "sigma":
        flags["df_sigma"] = 1e-4
    else:
        flags["df_b_dtype"] = "f64"
    B, _ = tc_dfs.build_B_packed(pb.primary, pb.auxiliary, tc_options(flags),
                                 CPU)
    assert calls == [1]
    ref, _ = tc_dfs.build_B_packed(
        pb.primary, pb.auxiliary,
        tc_options({k: v for k, v in flags.items() if k != "df_b_cache"}), CPU)
    assert torch.equal(B, ref)


def test_failed_fold_resumes_from_raw_cache(tmp_path, monkeypatch):
    pb = _port_bsets()
    opts = tc_options({"df_b_dtype": "f32", "df_b_cache": str(tmp_path / "c")})

    def dying_fold(metric, B, **kw):
        raise RuntimeError("simulated failure in the fold")

    real_fold = tc_df.fold_metric
    monkeypatch.setattr(tc_df, "fold_metric", dying_fold)
    with pytest.raises(RuntimeError, match="simulated"):
        tc_dfs.build_B_packed(pb.primary, pb.auxiliary, opts, CPU)
    assert (tmp_path / "c_torch_raw.npy").exists()
    assert not (tmp_path / "c_torch_B.npy").exists()
    monkeypatch.setattr(tc_df, "fold_metric", real_fold)
    calls = _counting_3c(monkeypatch)
    B1, _ = tc_dfs.build_B_packed(pb.primary, pb.auxiliary, opts, CPU)
    assert calls == []
    assert not (tmp_path / "c_torch_raw.npy").exists()
    assert (tmp_path / "c_torch_B.npy").exists()
    B2, _ = tc_dfs.build_B_packed(pb.primary, pb.auxiliary,
                                  tc_options({"df_b_dtype": "f32"}), CPU)
    assert torch.equal(B1, B2)


def test_water_clusters_regenerate_exactly(tmp_path):
    out = tmp_path / "clusters.json"
    subprocess.run([sys.executable, str(REPO / "tools" /
                                        "make_water_clusters.py"),
                    "--out", str(out)], check=True, timeout=120)
    committed = REPO / "juliachem_jl_tpu_torch" / "data" / "water_clusters.json"
    assert out.read_bytes() == committed.read_bytes()
    data = json.loads(committed.read_text())
    assert [data[k]["n_waters"] for k in ("w32", "w64")] == [32, 64]
