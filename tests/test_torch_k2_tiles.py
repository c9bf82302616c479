"""What surrounds kernel K2's tensor-core body, on the CPU.

K2 (``juliachem_jl_tpu_torch/csrc/df_gather_w.cu``) walks, for each
64-column n-tile, only the 16-row m-slabs in which some col_map entry is not
trash; the list is the CSR pair of ``models.df_screened.k2_slabs``, built
once per builder.  Here: the list covers every live (m, n) and no dead slab
(random col_maps with whole dead tiles and ragged sizes, an all-trash one,
the real col_map of water in 6-31+G* / cc-pVTZ-JKFIT); a plain walk over
the listed slabs equals ``df_gather_w_plain`` within 1e-13 relative; the
packed builder's G at a fixed D, with its W from that walk, equals the JAX
package's ``ScreenedDFFockBuilder`` G within 1e-12; and the kernel is
built on the tiles the list is made of.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from juliachem_jl_tpu.models import df_screened as jx_dfs
from juliachem_jl_tpu.utils.options import create_scf_options as jx_options
from juliachem_jl_tpu.utils.timings import Timings as JxTimings
from juliachem_jl_tpu_torch import interop
from juliachem_jl_tpu_torch.models import df_screened as tc_dfs
from juliachem_jl_tpu_torch.models.df import screened_pair_blocks
from juliachem_jl_tpu_torch.ops import eri3c, kernels
from juliachem_jl_tpu_torch.utils.options import create_scf_options
from juliachem_jl_tpu_torch.utils.timings import Timings
from tests._torch_parity import CPU, jax_system, port_system

CSRC = (Path(__file__).resolve().parents[1] / "juliachem_jl_tpu_torch"
        / "csrc" / "df_gather_w.cu")
SM, TN = kernels.K2_SLAB_M, kernels.K2_TILE_N


def banded_col_map(nbf: int, seed: int, reach: int = 1,
                   stray: float = 0.0) -> tuple[np.ndarray, int]:
    """A col_map as a screen of atom-ordered functions makes it: "atoms" of
    random sizes, (m, n) live when their atoms are at most ``reach`` apart
    (so distant pairs leave whole dead tiles), plus a ``stray`` fraction of
    live entries anywhere; packed columns numbered in flat order."""
    rng = np.random.default_rng(seed)
    atom = np.repeat(np.arange(nbf), rng.integers(5, 30, nbf))[:nbf]
    live = np.abs(atom[:, None] - atom[None, :]) <= reach
    live |= rng.random((nbf, nbf)) < stray
    live |= live.T
    flat = np.flatnonzero(live)
    col_map = np.full(nbf * nbf, len(flat), dtype=np.int64)
    col_map[flat] = np.arange(len(flat))
    return col_map, len(flat)


def listed_tiles(ptr, idx, nbf: int) -> np.ndarray:
    """[m-slabs, n-tiles] bool of the slabs the CSR lists."""
    ms, nt = -(-nbf // SM), -(-nbf // TN)
    assert ptr.shape == (nt + 1,) and ptr[0] == 0 and ptr[-1] == len(idx)
    out = np.zeros((ms, nt), dtype=bool)
    for t in range(nt):
        s = idx[ptr[t]:ptr[t + 1]]
        assert np.all(np.diff(s) > 0), "slabs of a tile in ascending order"
        out[s, t] = True
    return out


def check_covers(col_map, nbf: int, trash: int) -> int:
    """The CSR of col_map lists exactly the live slabs: every (m, n) whose
    entry is not trash lies in a listed slab of its tile, and every listed
    slab holds such an entry.  Returns the number of dead slabs."""
    ptr, idx = tc_dfs.k2_slabs(col_map, nbf, trash)
    assert ptr.dtype == np.int32 and idx.dtype == np.int32
    listed = listed_tiles(ptr, idx, nbf)
    cm = np.asarray(col_map).reshape(nbf, nbf)
    m, n = np.nonzero(cm != trash)
    assert listed[m // SM, n // TN].all(), "a live entry in an unlisted slab"
    for s, t in zip(*np.nonzero(listed)):
        assert np.any(cm[s * SM:(s + 1) * SM, t * TN:(t + 1) * TN] != trash)
    return int((~listed).sum())


def gather_w_tiled(Bc, col_map, C, slabs) -> torch.Tensor:
    """K2's walk in plain torch: for each n-tile, only its listed m-slabs,
    each a [Qc, 16, 64] gather times the slab's rows of C."""
    nbf, k = C.shape
    ptr, idx = (np.asarray(a) for a in slabs)
    cm = col_map.reshape(nbf, nbf)
    W = torch.zeros((Bc.shape[0], k, nbf), dtype=C.dtype)
    for t in range(len(ptr) - 1):
        n0, n1 = t * TN, min((t + 1) * TN, nbf)
        for s in idx[ptr[t]:ptr[t + 1]]:
            m0, m1 = s * SM, min((s + 1) * SM, nbf)
            tile = Bc[:, cm[m0:m1, n0:n1].reshape(-1)].reshape(
                -1, m1 - m0, n1 - n0).to(C.dtype)
            W[:, :, n0:n1] += torch.einsum("qmn,mi->qin", tile, C[m0:m1])
    return W


@pytest.fixture(scope="module")
def water_screen():
    _, tb = port_system("water_631+gs")
    opts = create_scf_options({"scf_type": "df"})
    metric_max = float(torch.diagonal(
        eri3c.two_center_metric(tb.auxiliary, CPU)).max())
    return tc_dfs.build_packed_screen(tb.primary, screened_pair_blocks(
        tb.primary, opts.df_screening_sigma, metric_max, CPU))


@pytest.mark.parametrize("nbf,seed,reach,stray", [
    (45, 0, 1, 0.0), (137, 1, 1, 0.0), (200, 2, 2, 0.001), (517, 3, 1, 0.0),
    (64, 4, 0, 0.0), (16, 5, 0, 0.0), (130, 6, 3, 0.02)])
def test_slabs_cover_live_entries_and_no_dead_slab(nbf, seed, reach, stray):
    col_map, npq = banded_col_map(nbf, seed, reach, stray)
    dead = check_covers(col_map, nbf, npq)
    if nbf >= 137 and stray == 0.0:
        assert dead > 0, "the case should hold whole dead tiles"


def test_slabs_of_an_all_trash_col_map_are_empty():
    nbf = 77
    ptr, idx = tc_dfs.k2_slabs(np.full(nbf * nbf, 5, np.int64), nbf, 5)
    assert len(idx) == 0 and np.all(ptr == 0)
    assert ptr.shape == (-(-nbf // TN) + 1,)


def test_slabs_of_water_col_map(water_screen):
    s = water_screen
    check_covers(s.col_map, s.nbf, s.npq)


@pytest.mark.parametrize("nbf,k,seed", [(137, 21, 1), (45, 3, 0),
                                        (200, 70, 2)])
def test_tiled_walk_equals_plain(nbf, k, seed):
    col_map, npq = banded_col_map(nbf, seed, 1, 0.0)
    rng = np.random.default_rng(seed + 10)
    Bc = rng.normal(size=(3, npq + 1))
    Bc[:, -1] = 0.0
    Bc, C = torch.tensor(Bc), torch.tensor(rng.normal(size=(nbf, k)))
    cm = torch.tensor(col_map, dtype=torch.int32)
    slabs = tc_dfs.k2_slabs(col_map, nbf, npq)
    ref = tc_dfs.df_gather_w_plain(Bc, cm, C)
    got = gather_w_tiled(Bc, cm.long(), C, slabs)
    assert float((got - ref).abs().max()) <= 1e-13 * float(ref.abs().max())
    # the wrapper on CPU tensors takes the plain version, slabs or not
    assert torch.equal(tc_dfs.df_gather_w(Bc, cm, C, slabs), ref)


def test_tile_constants_match_csrc():
    """csrc/ takes K2's tile from the build's defines, which carry the
    slab list's tile."""
    src = CSRC.read_text()
    assert "constexpr int kSlabM = JC_K2_SLAB_M;" in src
    assert "constexpr int kTileN = JC_K2_TILE_N;" in src
    assert f"-DJC_K2_SLAB_M={SM}" in kernels.NVCC_FLAGS
    assert f"-DJC_K2_TILE_N={TN}" in kernels.NVCC_FLAGS


def test_packed_G_through_the_slab_walk_equals_jax(monkeypatch):
    """The port's packed builder over the JAX package's B, its W from the
    walk over the builder's own slab list (``sweep`` passes it to K2), G at
    a fixed D against the JAX ScreenedDFFockBuilder's."""
    _, jb = jax_system("water_631+gs")
    opts = jx_options({"scf_type": "df"})
    jpacked = jx_dfs.ScreenedDFFockBuilder(jb.primary, jb.auxiliary, opts,
                                           timings=JxTimings())
    nocc = jb.primary.nels // 2
    tpacked = tc_dfs.ScreenedDFFockBuilder(
        interop.tensor(np.asarray(jpacked.B), CPU),
        interop.packed_screen(jpacked.screen),
        create_scf_options({"scf_type": "df"}), nocc)
    seen = []

    def walk(Bc, col_map, C, slabs):
        seen.append(slabs)
        return gather_w_tiled(Bc, col_map.long(), C, slabs)

    monkeypatch.setattr(tc_dfs, "df_gather_w", walk)
    rng = np.random.default_rng(11)
    C = rng.normal(size=(jb.primary.nbf, nocc)) * 0.3
    D = 2.0 * C @ C.T
    ref = np.asarray(jpacked.two_electron_fock(D, 1, JxTimings(), C_occ=C))
    got = tpacked.two_electron_fock(torch.tensor(D), 1, Timings(),
                                    C_occ=torch.tensor(C)).numpy()
    assert seen and all(s is tpacked._slabs for s in seen)
    want = tc_dfs.k2_slabs(tpacked.screen.col_map, tpacked.nbf,
                           tpacked.screen.npq)
    assert all(np.array_equal(a.numpy(), b)
               for a, b in zip(tpacked._slabs, want))
    assert float(np.abs(got - ref).max()) <= 1e-12
