"""The design of K2's f32 instance (csrc/df_gather_w.cu, the FP32 FMA body
of the mixed-precision phase) on the CPU: the pieces the card runs that a
plain version can mirror.

- ``emulated_walk`` is the kernel's walk in plain torch, all in f32: the
  grid of blocks (kFNQ rows q, an i-group of kFKT orbitals, one 64-column
  n-tile), the listed slabs of each n-tile only, each slab staged as the
  ring holds it (the gathered B tiles, trash entries zero-filled without a
  read, the C slab zero past k and nbf), the thread -> register-tile map (8 orbitals
  x 4 n for each row q), one FP32 fused multiply-add per (m, register) in
  the kernel's order, and the epilogue that stages a row q's tile and
  stores it masked at the ragged edges.
- (a) Every W element is written by exactly one thread of one block, at
  ragged nbf, k and row counts; every accumulator of a block belongs to
  one thread.
- (b) The shared-memory accesses of one warp fall on distinct banks: the
  float4 reads of C and of B of one FMA step, the 4-byte gathers into a
  stage; the epilogue's float4 stores take the least number of passes.
- (c) The walk equals ``df_gather_w_plain`` in f32 within 1e-5 x max|W|,
  and the f64 product within the f32 bound nbf 2^-24 sum_m |B| |C| of each
  element.
- (d) The tile the build passes (``kernels.K2F_*`` as ``-DJC_K2F_*``) is
  the one csrc/ takes, with the thread map and strides mirrored here.
- The port's packed G in the f32 phase (its W from the walk), for C_occ
  and for the signed factor of an indefinite D, and the JK builder's J,
  K(Da), K(Db) from one f32 sweep, equal the JAX package's f32 phase
  within 1e-5 x max|G| (f32 rounding and the order of the sums differ).
"""

import numpy as np
import pytest
import torch

from juliachem_jl_tpu.models import df_screened as jx_dfs
from juliachem_jl_tpu.models import df_screened_jk as jx_dfs_jk
from juliachem_jl_tpu.utils.options import create_scf_options as jx_options
from juliachem_jl_tpu.utils.timings import Timings as JxTimings
from juliachem_jl_tpu_torch import interop
from juliachem_jl_tpu_torch.models import df_screened as tc_dfs
from juliachem_jl_tpu_torch.models import df_screened_jk as tc_dfs_jk
from juliachem_jl_tpu_torch.ops import kernels
from juliachem_jl_tpu_torch.utils.options import create_scf_options
from juliachem_jl_tpu_torch.utils.timings import Timings
from tests._torch_parity import jax_system
from tests.test_torch_k2_tiles import banded_col_map

SRC = (kernels.CSRC_DIR / "df_gather_w.cu").read_text()
SM, TN = kernels.K2_SLAB_M, kernels.K2_TILE_N
NQ, KT, STAGES = kernels.K2F_NQ, kernels.K2F_KT, kernels.K2F_STAGES
NT = (KT // 8) * (TN // 4)          # kFThreads
WI = KT // 64                       # kFWarpsI
BS, CS, OS = TN + 4, KT + 4, TN + 4  # kFBStride, kFCStride, kFOStride
BTILE = SM * BS
STAGE = NQ * BTILE + SM * CS        # floats a stage


def thread_map():
    """(ti, tn) of every thread, as df_gather_w_f32_kernel sets them."""
    tid = np.arange(NT)
    lane, warp = tid & 31, tid >> 5
    return (lane & 7) + 8 * (warp % WI), (lane >> 3) + 4 * (warp // WI)


def register_tile():
    """[NT, 2, 4] orbitals and [NT, 4] columns of each thread's
    accumulators acc[r][j][a][e]: orbital 4 ti + (KT / 2) j + a, column
    4 tn + e."""
    ti, tn = thread_map()
    io = (4 * ti[:, None, None] + (KT // 2) * np.arange(2)[None, :, None]
          + np.arange(4)[None, None, :])
    nn = 4 * tn[:, None] + np.arange(4)[None, :]
    return io, nn


def grid(nbf, k, qc):
    """(n_groups, n_tiles, q-groups) of the launch."""
    return -(-k // KT), -(-nbf // TN), -(-qc // NQ)


def fma32(a, b, c):
    """f32 fused multiply-add: the exact f32 product and the sum in f64,
    rounded once to f32 (a double rounding differs from the card's FFMA in
    the last bit only at rare ties)."""
    return (c.double() + a.double() * b.double()).float()


def emulated_walk(Bc, col_map, C, slabs):
    """The f32 instance's walk in plain torch (f32 in, f32 out)."""
    nbf, k = C.shape
    qc, width = Bc.shape
    ng, nt, nqg = grid(nbf, k, qc)
    ptr, idx = (np.asarray(a) for a in slabs)
    io, nn = (torch.as_tensor(a) for a in register_tile())
    # B rows padded to whole q-groups (rows past qc read as zero), with a
    # zero column for the trash entries and those outside nbf (the kernel
    # zero-fills them); C padded to whole slabs and i-groups
    Bp = torch.zeros((nqg * NQ, width + 1), dtype=torch.float32)
    Bp[:qc, :width] = Bc
    Bp = Bp.reshape(nqg, NQ, width + 1)
    Cp = torch.zeros((-(-nbf // SM) * SM, ng * KT), dtype=torch.float32)
    Cp[:nbf, :k] = C
    cm = np.asarray(col_map).reshape(nbf, nbf)
    W = torch.full((qc, k, nbf), float("nan"), dtype=torch.float32)
    for t in range(nt):
        n0 = t * TN
        acc = torch.zeros((nqg, ng, NQ, NT, 2, 4, 4), dtype=torch.float32)
        for s in idx[ptr[t]:ptr[t + 1]]:
            m0 = s * SM
            # the stage: cm of the slab, trash (width - 1) and outside nbf
            # -> the zero column
            tile = np.full((SM, TN), width, dtype=np.int64)
            mm, cc = min(SM, nbf - m0), min(TN, nbf - n0)
            tile[:mm, :cc] = cm[m0:m0 + mm, n0:n0 + cc]
            tile[tile == width - 1] = width
            sB = Bp[:, :, torch.as_tensor(tile)]          # [nqg, NQ, SM, TN]
            sC = Cp[m0:m0 + SM].reshape(SM, ng, KT).transpose(0, 1)
            for m in range(SM):
                cv = sC[:, m][:, io]                       # [ng, NT, 2, 4]
                bv = sB[:, :, m][:, :, nn]                 # [nqg, NQ, NT, 4]
                acc = fma32(cv[None, :, None, :, :, :, None],
                            bv[:, None, :, :, None, None, :], acc)
        # epilogue: row q's [KT][64] tile staged, stored masked
        so = torch.zeros((nqg, ng, NQ, KT, TN), dtype=torch.float32)
        so[:, :, :, io[:, :, :, None], nn[:, None, None, :]] = acc
        out = so.permute(0, 2, 1, 3, 4).reshape(nqg * NQ, ng * KT, TN)
        cc = min(TN, nbf - n0)
        W[:, :, n0:n0 + cc] = out[:qc, :k, :cc]
    return W


def inputs(nbf, k, qc, seed, stray=0.0):
    """f32 Bc [qc, npq+1] with a zero trash column, the int32 col_map of a
    banded screen (whole dead tiles), f32 C [nbf, k] and the slab CSR."""
    col_map, npq = banded_col_map(nbf, seed, 1, stray)
    rng = np.random.default_rng(seed + 20)
    Bc = rng.normal(size=(qc, npq + 1)).astype(np.float32)
    Bc[:, -1] = 0.0
    C = rng.normal(size=(nbf, k)).astype(np.float32)
    return (torch.tensor(Bc), torch.tensor(col_map, dtype=torch.int32),
            torch.tensor(C), tc_dfs.k2_slabs(col_map, nbf, npq))


def test_tile_constants_match_csrc():
    """csrc/ takes the f32 instance's tile from the build's defines, and
    its thread map, strides and register tile are the ones mirrored here."""
    for name, v in (("NQ", NQ), ("KT", KT), ("STAGES", STAGES)):
        assert f"-DJC_K2F_{name}={v}" in kernels.NVCC_FLAGS
    for line in ("constexpr int kFNQ = JC_K2F_NQ;",
                 "constexpr int kFKT = JC_K2F_KT;",
                 "constexpr int kFStages = JC_K2F_STAGES;",
                 "constexpr int kFRowsI = kFKT / 8;",
                 "constexpr int kFWarpsI = kFRowsI / 8;",
                 "constexpr int kFThreads = kFRowsI * (kTileN / 4);",
                 "constexpr int kFBStride = kTileN + 4;",
                 "constexpr int kFCStride = kFKT + 4;",
                 "constexpr int kFOStride = kTileN + 4;",
                 "constexpr int kFStage = kFNQ * kFBTile + kSlabM * kFCStride;",
                 "const int ti = (lane & 7) + 8 * (warp % kFWarpsI);",
                 "const int tn = (lane >> 3) + 4 * (warp / kFWarpsI);",
                 "const int g = blockIdx.x % n_groups, t = blockIdx.x / n_groups;",
                 "const int64_t q0 = (int64_t)blockIdx.y * NQ;",
                 "const int e = tid + u * NT;",
                 "jc::cp_async4(st + r * kFBTile + (e / kTileN) * BS + e % kTileN,",
                 "const float* sC = st + NQ * kFBTile + 4 * ti;",
                 "st + r * kFBTile + mm * BS + 4 * tn);",
                 "acc[r][j][a][e] = __fmaf_rn(cv[j][a], bv[e], acc[r][j][a][e]);",
                 "*reinterpret_cast<float4*>(so + (4 * ti + j * (KT / 2) + a) * OS +",
                 "if (i < k && n < nbf) Wq[(int64_t)i * nbf + n] = so[ii * OS + nn];"):
        assert line in SRC, line
    assert "const dim3 grid(n_tiles * n_groups, (qc + kFNQ - 1) / kFNQ);" in SRC
    assert "df_gather_w_f32_kernel<<<grid, kFThreads, kFSmemBytes," in SRC
    assert NT % 32 == 0 and SM * TN % NT == 0 and KT % 64 == 0
    # the ring under the 227 KB a block can have, the epilogue inside it
    assert 4 * STAGES * STAGE <= 232448
    assert KT * OS <= STAGES * STAGE


@pytest.mark.parametrize("nbf,k,qc", [(137, 21, 300), (137, 47, 301),
                                      (517, 47, 300), (517, 130, 301),
                                      (517, 320, 300), (137, 320, 301)])
def test_each_w_element_written_by_one_thread_of_one_block(nbf, k, qc):
    """The grid x the epilogue's store map cover W [qc, k, nbf] exactly
    once: the q of a store comes from (blockIdx.y, r) alone and its (i, n)
    from (blockIdx.x, the thread, its store index) alone, so each factor
    is counted on its own; each block's accumulators belong to one thread
    each, and its store loop reads each staged (i, n) once."""
    ng, nt, nqg = grid(nbf, k, qc)
    # q: rows q0 + r, r < nq = min(NQ, qc - q0)
    qs = [by * NQ + r for by in range(nqg)
          for r in range(min(NQ, qc - by * NQ))]
    assert np.array_equal(np.bincount(qs, minlength=qc), np.ones(qc))
    # (i, n): blockIdx.x = t n_groups + g; the store loop e = tid + u NT
    io, nn = register_tile()
    owner = np.zeros((KT, TN), dtype=int)
    np.add.at(owner, (io[:, :, :, None], nn[:, None, None, :]), 1)
    assert (owner == 1).all(), "a register tile element of two threads"
    e = np.arange(0, KT * TN, NT)[None, :] + np.arange(NT)[:, None]
    assert np.array_equal(np.bincount(e.ravel(), minlength=KT * TN),
                          np.ones(KT * TN))
    ii, jj = e // TN, e % TN
    hits = np.zeros((k, nbf), dtype=int)
    for bx in range(ng * nt):
        g, t = bx % ng, bx // ng
        i, n = g * KT + ii, t * TN + jj
        ok = (i < k) & (n < nbf)
        np.add.at(hits, (i[ok], n[ok]), 1)
    assert (hits == 1).all()


def banks(words_per_lane):
    """Passes one warp's shared-memory access needs: each lane's words (4
    bytes each, a float4 being 4 consecutive words); lanes on the same word
    share it (broadcast)."""
    words = {int(w) for ws in words_per_lane for w in ws}
    per_bank = np.bincount([w % 32 for w in words], minlength=32)
    return int(per_bank.max()), len(words)


def test_warp_shared_memory_accesses_fall_on_distinct_banks():
    ti, tn = thread_map()
    io, nn = register_tile()
    for warp in range(NT // 32):
        lanes = np.arange(32) + 32 * warp
        for m in range(SM):
            # C: two float4 a thread, at 4 ti and 4 ti + KT / 2
            for j in range(2):
                ws = [NQ * BTILE + m * CS + io[t, j] for t in lanes]
                passes, n = banks(ws)
                assert passes == 1 and n == 32, (warp, m, j)
            # B: one float4 a thread and row q
            for r in range(NQ):
                ws = [r * BTILE + m * BS + nn[t] for t in lanes]
                passes, n = banks(ws)
                assert passes == 1 and n == 16, (warp, m, r)
        # the gathers into a stage: 4-byte words e = tid + u NT
        for u in range(SM * TN // NT):
            for r in range(NQ):
                e = lanes + u * NT
                passes, _ = banks([[r * BTILE + x // TN * BS + x % TN]
                                   for x in e])
                assert passes == 1
        # the epilogue's float4 stores of row q: 32 distinct float4 take
        # at least 4 passes, and take no more
        for j in range(2):
            for a in range(4):
                ws = [(io[t, j, a]) * OS + nn[t] for t in lanes]
                passes, n = banks(ws)
                assert n == 128 and passes == 4


@pytest.mark.parametrize("nbf,k,qc,seed,stray", [
    (137, 21, 7, 1, 0.0), (137, 47, 9, 2, 0.01), (200, 70, 5, 3, 0.001),
    (517, 130, 3, 4, 0.0), (300, 320, 3, 5, 0.0), (45, 3, 2, 6, 0.0)])
def test_walk_equals_plain_and_f64_product(nbf, k, qc, seed, stray):
    Bc, cm, C, slabs = inputs(nbf, k, qc, seed, stray)
    poisoned = Bc.clone()
    poisoned[:, -1] = float("nan")   # the walk never reads the trash column
    got = emulated_walk(poisoned, cm, C, slabs)
    assert not torch.isnan(got).any(), "a W element unwritten or trash read"
    ref = tc_dfs.df_gather_w_plain(Bc, cm, C)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    # against the f64 product: recursive FMA summation over nbf terms
    exact = tc_dfs.df_gather_w_plain(Bc.double(), cm, C.double())
    mag = tc_dfs.df_gather_w_plain(Bc.double().abs(), cm, C.double().abs())
    assert ((got.double() - exact).abs() <= nbf * 2.0**-24 * mag).all()
    # the wrapper on CPU tensors takes the plain version
    assert torch.equal(tc_dfs.df_gather_w(Bc, cm, C, slabs), ref)


@pytest.fixture(scope="module")
def water_pair():
    """The JAX package's packed JK builder on water 6-31+G* /
    cc-pVTZ-JKFIT, and the port's on its B and screen (mixed precision:
    both keep B32)."""
    _, jb = jax_system("water_631+gs")
    jbuild = jx_dfs_jk.ScreenedDFJKBuilder(
        jb.primary, jb.auxiliary, jx_options({"scf_type": "df"}),
        timings=JxTimings())
    nocc = jb.primary.nels // 2
    tbuild = tc_dfs_jk.ScreenedDFJKBuilder(
        interop.tensor(np.asarray(jbuild.B), torch.device("cpu")),
        interop.packed_screen(jbuild.screen),
        create_scf_options({"scf_type": "df"}), nocc)
    assert jbuild.supports_f32_phase and tbuild.supports_f32_phase
    return jbuild, tbuild, nocc


def walk_recorder(monkeypatch, seen):
    def walk(Bc, col_map, C, slabs):
        assert Bc.dtype == C.dtype == torch.float32
        seen.append(slabs)
        return emulated_walk(Bc, col_map, C, slabs)

    monkeypatch.setattr(tc_dfs, "df_gather_w", walk)


@pytest.mark.parametrize("factor", ["C_occ", "signed"])
def test_f32_phase_G_through_the_walk_equals_jax(water_pair, monkeypatch,
                                                 factor):
    """The f32-phase G at a fixed D: C_occ, or the signed factor of an
    indefinite D (C_occ None, as for fdiff_f32's density difference)."""
    jbuild, tbuild, nocc = water_pair
    seen = []
    walk_recorder(monkeypatch, seen)
    rng = np.random.default_rng(17)
    nbf = tbuild.nbf
    C = rng.normal(size=(nbf, nocc)) * 0.3
    D = 2.0 * C @ C.T
    kw = {"C_occ": C}
    if factor == "signed":
        C2 = rng.normal(size=(nbf, 3)) * 0.3
        D = D - C2 @ C2.T
        kw = {}
    ref = np.asarray(jbuild.two_electron_fock(D, 1, JxTimings(),
                                              precision="f32", **kw))
    got = tbuild.two_electron_fock(
        torch.tensor(D), 1, Timings(), precision="f32",
        **{k: torch.tensor(v) for k, v in kw.items()}).numpy()
    assert seen and all(s is tbuild._slabs for s in seen)
    assert float(np.abs(got - ref).max()) <= 1e-5 * float(np.abs(ref).max())


def test_f32_jk_sweep_through_the_walk_equals_jax(water_pair, monkeypatch):
    """J(Da + Db), K(Da) and K(Db) from one f32 sweep of the port's JK
    builder (K2 twice a block) against the JAX JK builder's two f32 passes
    (``_k_pass``)."""
    jbuild, tbuild, nocc = water_pair
    seen = []
    walk_recorder(monkeypatch, seen)
    rng = np.random.default_rng(23)
    nbf = tbuild.nbf
    Ca = rng.normal(size=(nbf, nocc)) * 0.3
    Cb = rng.normal(size=(nbf, nocc - 1)) * 0.3
    Da, Db = Ca @ Ca.T, Cb @ Cb.T
    d = np.concatenate([(Da + Db).reshape(-1)[np.asarray(jbuild._pq_flat)],
                        [0.0]])
    Ka, Jp = jbuild._k_pass(d, *jbuild._spin_factor(Da, Ca), "f32")
    Kb, _ = jbuild._k_pass(0.0 * d, *jbuild._spin_factor(Db, Cb), "f32")
    J = np.zeros(nbf * nbf)
    J[np.asarray(jbuild._pq_flat)] = np.asarray(Jp)[:-1]
    f32 = torch.float32
    (tKa, tKb), tJp = tbuild.sweep_factors(
        tbuild.blocks(f32, nocc), torch.tensor(d, dtype=f32),
        [(torch.tensor(Ca, dtype=f32), None),
         (torch.tensor(Cb, dtype=f32), None)])
    assert len(seen) == 2 * len(tbuild.q_blocks(tbuild.B32, nocc))
    for got, ref in ((tbuild.scatter_j(tJp), J.reshape(nbf, nbf)),
                     (tKa, Ka), (tKb, Kb)):
        ref = np.asarray(ref)
        assert float(np.abs(got.double().numpy() - ref).max()) \
            <= 1e-5 * float(np.abs(ref).max())
