"""The port's host-streamed packed B (``models/df_screened.py``'s memory
modes) on the CPU, where the "host" B is the CPU tensor and its Q-blocks
are views: the same code as on the card without the side stream.

- the mode picker gives each of the three modes at the budgets that should
  give it, and refuses a host B over the machine's available memory;
- the column-chunked build (``three_center_tensor(col_range=)``, the fold
  factored once) equals the one-piece B, f64 and f32, with and without the
  solid-harmonic aux projection;
- streamed G (f64, the signed factor, the f32 phase) and the JK builder's
  J, K(Da), K(Db) equal the resident builder's at a fixed D, in both stream
  modes;
- the stream-mode SCF (RHF, DF-UHF) lands on the JAX package's stream-mode
  energy (its ``DEVICE_B_BUDGET`` patched) within 1e-9 Eh;
- a B cache written in stream mode reloads into host memory with the same
  B; the raw 3-center checkpoint resumes chunk by chunk after a failed
  fold.

The modes are forced by patching ``ScreenedDFFockBuilder.budgets``, as the
JAX package's tests patch ``DEVICE_B_BUDGET``
(``tests/test_df_screened.py:165-183,217-230``).
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

import juliachem_jl_tpu as jx
from juliachem_jl_tpu.models import df_screened as jx_dfs
from juliachem_jl_tpu.models import rhf as jx_rhf
from juliachem_jl_tpu.models import uhf as jx_uhf
from juliachem_jl_tpu_torch import interop
from juliachem_jl_tpu_torch.models import df as tc_df
from juliachem_jl_tpu_torch.models import df_screened as tc_dfs
from juliachem_jl_tpu_torch.models import rhf as tc_rhf
from juliachem_jl_tpu_torch.models import uhf as tc_uhf
from juliachem_jl_tpu_torch.models.df_screened_jk import ScreenedDFJKBuilder
from juliachem_jl_tpu_torch.ops import eri3c as tc_eri3c
from juliachem_jl_tpu_torch.utils.options import create_scf_options as tc_options
from juliachem_jl_tpu_torch.utils.timings import Timings
from tests._torch_parity import CPU, WATER, port_system

Builder = tc_dfs.ScreenedDFFockBuilder
DF = {"scf_type": "df"}
TIGHT = {"niter": 60, "dele": 1e-10, "rmsd": 1e-8, "guess": "sad",
         "contraction_mode": "screened"}
OH = {"symbols": ["O", "H"], "geometry": [0, 0, 0, 0, 0, 0.97],
      "molecular_multiplicity": 2}


@pytest.fixture(scope="module")
def water():
    """Water 6-31+G* / cc-pVTZ-JKFIT in the port, its resident packed B."""
    _, bsets = port_system("water_631+gs")
    B, screen = tc_dfs.build_B_packed(bsets.primary, bsets.auxiliary,
                                      tc_options(DF), CPU)
    return bsets, B, screen


def _stream_cols(monkeypatch, cols):
    """Column chunks of ``cols`` packed columns in a stream-mode build."""
    monkeypatch.setattr(tc_dfs, "stream_build_cols",
                        lambda rows, dtype, device: cols)


def _set_budgets(monkeypatch, b_bytes, w_bytes=1.5e9):
    monkeypatch.setattr(Builder, "budgets",
                        classmethod(lambda cls, dev: (b_bytes, w_bytes)))


# Q-blocks of a third of B's rows (``df_exchange_n_blocks``), so that a
# sweep streams several
BLOCKS = {"df_exchange_n_blocks": 3}


def _budget_for(mode, rows, width, mixed=True):
    """A B budget that gives ``mode`` to an f64 B [rows, width] in Q-blocks
    of ``BLOCKS`` (without the mixed-precision phase, B alone is
    weighed)."""
    b64, b32 = rows * width * 8, rows * width * 4
    buffers = 2 * -(-rows // 3) * width * 8
    assert b32 + buffers < b64 + b32
    if not mixed:
        return {"resident": b64, "stream": b64 - 1}[mode]
    return {"resident": b64 + b32, "stream_b32": b32 + buffers,
            "stream": b32 + buffers - 1}[mode]


# B [300, 5000] for nbf 40 at a W budget giving Q-blocks of 64 rows:
# (B dtype, mixed precision, the B budget from (B bytes, B32 bytes, two
# f64 Q-block buffers' bytes), the mode it should give)
ROWS, WIDTH, NBF = 300, 5000, 40
MODES = {
    "resident": ("f64", True, lambda b, b32, buf: b + b32, tc_dfs.RESIDENT),
    "stream_b32": ("f64", True, lambda b, b32, buf: b32 + buf,
                   tc_dfs.STREAM_B32),
    "stream": ("f64", True, lambda b, b32, buf: b32 + buf - 1,
               tc_dfs.STREAM),
    "f64-unmixed-resident": ("f64", False, lambda b, b32, buf: b,
                             tc_dfs.RESIDENT),
    "f64-unmixed-stream": ("f64", False, lambda b, b32, buf: b - 1,
                           tc_dfs.STREAM),
    "f32-B-resident": ("f32", True, lambda b, b32, buf: b32,
                       tc_dfs.RESIDENT),
    "f32-B-stream": ("f32", True, lambda b, b32, buf: b32 - 1,
                     tc_dfs.STREAM),
}


@pytest.mark.parametrize("case", list(MODES))
def test_memory_mode_picker(case, monkeypatch):
    """Resident while B (+ B32 for an f64 B in the mixed-precision phase)
    fits; stream with B32 resident while B32 and two Q-block buffers fit;
    else stream.  Without the mixed-precision phase, or for an f32 B (its
    own f32 copy), B alone is weighed and nothing else stays resident."""
    dt, mixed, budget, want = MODES[case]
    b, b32 = ROWS * WIDTH * 8, ROWS * WIDTH * 4
    buf = 2 * 64 * WIDTH * 8
    assert b32 + buf < b + b32
    _set_budgets(monkeypatch, budget(b, b32, buf), 64 * 8 * NBF * NBF)
    opts = tc_options({**DF, "df_b_dtype": dt, "mixed_precision": mixed})
    dtype = torch.float32 if dt == "f32" else torch.float64
    assert Builder.memory_mode(ROWS, WIDTH, dtype, opts, NBF, 5,
                               CPU) == want


def test_host_memory_limit_raises(monkeypatch):
    """A streamed B over the machine's available memory is refused before
    the build, the message naming both sizes."""
    _set_budgets(monkeypatch, 1e4)
    monkeypatch.setattr(tc_dfs, "host_available_bytes", lambda: 10**6)
    with pytest.raises(MemoryError, match=r"0\.1 GB of host memory.*0\.0 GB "
                       "available"):
        Builder.memory_mode(2000, 5000, torch.float64, tc_options(DF), 40, 5,
                            CPU)


CHUNKED = {"f64-sph": {}, "f64-cart": {"df_spherical_aux": False},
           "f32-sph": {"df_b_dtype": "f32"}}


@pytest.mark.parametrize("case", list(CHUNKED))
def test_column_chunks_equal_one_piece(case, monkeypatch):
    """B built in column chunks (K1 into each range with its local trash
    column, the fold factored once and applied per chunk) equals the
    one-piece B: within 1e-13 x max|B| in f64, word for word in f32."""
    _, bsets = port_system("water_631g")
    opts = tc_options({**DF, **CHUNKED[case]})
    ref, screen = tc_dfs.build_B_packed(bsets.primary, bsets.auxiliary, opts,
                                        CPU)
    for cols in (37, 64, screen.npq):
        _stream_cols(monkeypatch, cols)
        got, s2 = tc_dfs.build_B_packed(
            bsets.primary, bsets.auxiliary, opts, CPU,
            mode_of=lambda *a: tc_dfs.STREAM)
        assert np.array_equal(s2.col_map, screen.col_map)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert not got.is_cuda and bool((got[:, -1] == 0).all())
        if ref.dtype == torch.float32:
            assert torch.equal(got, ref), cols
        else:
            err = float((got - ref).abs().max())
            assert err <= 1e-13 * float(ref.abs().max()), (cols, err)


def test_three_center_col_range_is_a_slice(water):
    """``three_center_tensor(col_range=)`` gives the range's columns of the
    whole packed 3-center tensor bit for bit, its trash column zero."""
    bsets, _, screen = water
    prim, aux = bsets.primary, bsets.auxiliary
    metric = tc_eri3c.two_center_metric(aux, CPU)
    blocks = tc_df.screened_pair_blocks(prim, 1e-5,
                                        float(torch.diagonal(metric).max()),
                                        CPU)
    full = tc_eri3c.three_center_tensor(prim, aux, CPU, blocks,
                                        col_map=screen.col_map,
                                        packed_width=screen.npq + 1)
    for c0, c1 in ((0, 50), (50, 51), (screen.npq - 40, screen.npq)):
        part = tc_eri3c.three_center_tensor(prim, aux, CPU, blocks,
                                            col_map=screen.col_map,
                                            col_range=(c0, c1))
        assert part.shape == (aux.nbf, c1 - c0 + 1)
        assert torch.equal(part[:, :-1], full[:, c0:c1])
        assert bool((part[:, -1] == 0).all())


def _density(nbf, k=5, seed=3):
    rng = np.random.default_rng(seed)
    C = torch.as_tensor(rng.normal(size=(nbf, k)))
    return C, 2.0 * C @ C.T


@pytest.mark.parametrize("mode", ["stream_b32", "stream"])
def test_streamed_builds_equal_resident(water, mode, monkeypatch):
    """G at a fixed D (orbitals in f64 and in the f32 phase, the signed
    eigen-factor) and the JK builder's J, K(Da), K(Db) of a streamed B
    equal the resident builder's over the same three Q-blocks within 1e-12
    relative."""
    bsets, B, _ = water
    nbf = bsets.primary.nbf
    opts = tc_options({**DF, **BLOCKS})
    res = ScreenedDFJKBuilder.build(bsets.primary, bsets.auxiliary, opts,
                                    CPU)
    _set_budgets(monkeypatch, _budget_for(mode, *B.shape))
    st = ScreenedDFJKBuilder.build(bsets.primary, bsets.auxiliary, opts, CPU)
    assert res.mode == tc_dfs.RESIDENT
    assert st.mode == {"stream_b32": tc_dfs.STREAM_B32,
                       "stream": tc_dfs.STREAM}[mode]
    assert (st.B32 is None) == (mode == "stream")
    assert st.q_chunk == res.q_chunk == -(-st.A // 3)
    C, D = _density(nbf)
    for kw in ({"C_occ": C}, {"C_occ": C, "precision": "f32"}, {}):
        g0 = res.two_electron_fock(D, 1, Timings(), **kw)
        g1 = st.two_electron_fock(D, 1, Timings(), **kw)
        assert float((g1 - g0).abs().max()) <= 1e-12 * float(g0.abs().max())
    Ca, Cb = C, C[:, :3]
    args = (Ca @ Ca.T, Cb @ Cb.T, 1, Timings())
    for orbitals in ((Ca, Cb), (None, None)):
        want = res.two_electron_jk(*args, *orbitals)
        got = st.two_electron_jk(*args, *orbitals)
        for g, r in zip(got, want):
            assert float((g - r).abs().max()) <= 1e-12 * float(r.abs().max())


def test_jk_one_pass_equals_two(water):
    """The JK builder's one pass (J, K(Da), K(Db) from each block) equals
    two single-factor sweeps of the resident B bit for bit."""
    bsets, _, _ = water
    fb = ScreenedDFJKBuilder.build(bsets.primary, bsets.auxiliary,
                                   tc_options(DF), CPU)
    C, _ = _density(bsets.primary.nbf)
    Ca, Cb = C, C[:, :3].contiguous()
    J, Ka, Kb = fb.two_electron_jk(Ca @ Ca.T, Cb @ Cb.T, 1, Timings(), Ca,
                                   Cb)
    d = torch.cat([(Ca @ Ca.T + Cb @ Cb.T).reshape(-1)[fb._pq_flat],
                   torch.zeros(1, dtype=torch.float64)])
    Ka2, Jp = fb.sweep(fb.q_blocks(fb.B, 5), d, Ca, None)
    Kb2, _ = fb.sweep(fb.q_blocks(fb.B, 5), None, Cb, None)
    assert torch.equal(Ka, Ka2) and torch.equal(Kb, Kb2)
    assert torch.equal(J, fb.scatter_j(Jp))


def _jax_water(prim="6-31G", aux="cc-pVDZ-JKFIT", molecule=WATER):
    mol = jx.molecule.from_input_dict(molecule)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bsets = jx.basis.CalculationBasisSets(
            jx.basis.build(mol, prim), jx.basis.build_auxiliary(mol, aux, prim))
    return mol, bsets


SCF_STREAM = {
    # (energy functions, molecule, extra keywords, JAX budget, port mode)
    "rhf-stream": ((jx_rhf.energy, tc_rhf.energy), WATER, {}, 1e4,
                   "stream"),
    "rhf-stream-b32": ((jx_rhf.energy, tc_rhf.energy), WATER, {}, "b32",
                       "stream_b32"),
    "uhf-stream": ((jx_uhf.energy, tc_uhf.energy), OH,
                   {"mixed_precision": False}, 1e4, "stream"),
}


@pytest.mark.parametrize("case", list(SCF_STREAM))
def test_stream_scf_matches_jax_stream(case, monkeypatch):
    """DF-RHF and DF-UHF on a streamed B (the port's budgets and the JAX
    package's DEVICE_B_BUDGET patched so both stream, B32 resident or not)
    converge to the JAX package's stream-mode energy within 1e-9 Eh."""
    (jx_energy, tc_energy), molecule, extra, jx_budget, mode = \
        SCF_STREAM[case]
    mol, bsets = _jax_water(molecule=molecule)
    flags = {**DF, **TIGHT, **BLOCKS, **extra}
    pb = interop.basis_sets(bsets)
    B, _ = tc_dfs.build_B_packed(pb.primary, pb.auxiliary, tc_options(flags),
                                 CPU)
    if jx_budget == "b32":   # B64 streams, B32 stays (jax: B32 <= budget)
        jx_budget = B.numel() * 4
    monkeypatch.setattr(jx_dfs.ScreenedDFFockBuilder, "DEVICE_B_BUDGET",
                        jx_budget)
    ref = jx_energy(mol, bsets, dict(flags))
    _set_budgets(monkeypatch, _budget_for(mode, *B.shape,
                                          flags.get("mixed_precision", True)))
    got = tc_energy(interop.molecule(mol), pb, dict(flags), device=CPU)
    nt = got["Timings"].non_timing_data
    assert nt["B_mode"] == {"stream": tc_dfs.STREAM,
                            "stream_b32": tc_dfs.STREAM_B32}[mode]
    assert ref["Converged?"] and got["Converged?"]
    assert abs(got["Energy"] - ref["Energy"]) <= 1e-9


def test_b_cache_in_stream_mode_reloads_to_host(water, tmp_path,
                                                monkeypatch):
    """A B cache written by a stream-mode build holds that B; read back in
    stream mode it comes into host memory without a 3-center build, and
    in resident mode the same B comes onto the device."""
    bsets, ref, _ = water
    prim, aux = bsets.primary, bsets.auxiliary
    opts = tc_options({**DF, "df_b_cache": str(tmp_path / "c")})
    stream = lambda *a: tc_dfs.STREAM  # noqa: E731
    _stream_cols(monkeypatch, 100)
    B1, _ = tc_dfs.build_B_packed(prim, aux, opts, CPU, mode_of=stream)
    assert (tmp_path / "c_torch_B.npy").exists()
    assert not (tmp_path / "c_torch_raw.npy").exists()
    calls = []
    real = tc_eri3c.three_center_tensor
    monkeypatch.setattr(tc_eri3c, "three_center_tensor",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    B2, _ = tc_dfs.build_B_packed(prim, aux, opts, CPU, mode_of=stream)
    B3, _ = tc_dfs.build_B_packed(prim, aux, opts, CPU)
    assert calls == []
    assert torch.equal(B1, B2) and torch.equal(B2, B3)
    assert float((B1 - ref).abs().max()) <= 1e-13 * float(ref.abs().max())


def test_raw_checkpoint_resumes_chunk_by_chunk(water, tmp_path,
                                               monkeypatch):
    """A stream-mode build writes each chunk's raw 3-center columns before
    its fold; after a fold that fails on the third chunk, the next build
    reads the checkpointed chunks and runs K1 only for the rest, and its B
    equals an uncached build's."""
    bsets, _, screen = water
    prim, aux = bsets.primary, bsets.auxiliary
    opts = tc_options({**DF, "df_b_dtype": "f32",
                       "df_b_cache": str(tmp_path / "c")})
    stream = lambda *a: tc_dfs.STREAM  # noqa: E731
    real_fold = tc_df.fitted_fold

    def dying(*a, **k):
        fold, n = real_fold(*a, **k), []

        def run(P):
            n.append(1)
            if len(n) == 3:
                raise RuntimeError("simulated failure in the fold")
            return fold(P)
        return run

    monkeypatch.setattr(tc_df, "fitted_fold", dying)
    _stream_cols(monkeypatch, 100)
    with pytest.raises(RuntimeError, match="simulated"):
        tc_dfs.build_B_packed(prim, aux, opts, CPU, mode_of=stream)
    assert (tmp_path / "c_torch_raw.npy").exists()
    assert int(np.load(tmp_path / "c_torch_rawmeta.npz")["cols"]) == 300
    monkeypatch.setattr(tc_df, "fitted_fold", real_fold)
    ranges = []
    real = tc_eri3c.three_center_tensor

    def counted(*a, **k):
        ranges.append(k.get("col_range"))
        return real(*a, **k)

    monkeypatch.setattr(tc_eri3c, "three_center_tensor", counted)
    B1, _ = tc_dfs.build_B_packed(prim, aux, opts, CPU, mode_of=stream)
    assert ranges == [(c, min(c + 100, screen.npq))
                      for c in range(300, screen.npq, 100)]
    assert not (tmp_path / "c_torch_raw.npy").exists()
    monkeypatch.setattr(tc_eri3c, "three_center_tensor", real)
    B2, _ = tc_dfs.build_B_packed(prim, aux, tc_options(
        {**DF, "df_b_dtype": "f32"}), CPU, mode_of=stream)
    assert torch.equal(B1, B2)
