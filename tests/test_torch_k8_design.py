"""The design of K8 (csrc/split_fold.cu, the split fold) on the CPU: the
pieces the card runs that a plain version can mirror.  (``split_fold_plain``
against the JAX package's ``_split_matmul`` is
tests/test_torch_f32b.py::test_split_fold_plain_matches_jax_split_matmul.)

- The tile the build passes (``kernels.K8_TILE_M/_TILE_N/_SLAB`` as
  ``-DJC_K8_*``) is the one csrc/ takes and its thread map is written for.
- A plain walk of the launch order: block (bx, by) in launch order (x
  fastest) takes row tile gridDim.y - 1 - by and column tile bx; every
  output tile is taken exactly once, and under ``lower`` the tiles come
  heaviest first (their k-slab counts never rise along the order); each
  tile's k range ends at its last row (+1), or at K.
- A plain walk of the thread map: the 256 threads' 8 x 4 register tiles
  (rows wm*32 + ty + 4 i, columns wn*32 + 4 tx + j) cover the 128 x 64
  tile once; the float4 reads of one k-group hit distinct banks (M: the
  four quarter-warps' rows; X: one quarter-warp's 8 consecutive float4s).
- The tiles' products over their k ranges, in f64, equal the full product
  of a lower-triangular M at shapes ragged in R, K and C: the skipped
  slabs hold only zeros.
"""

import re

import numpy as np
import pytest

from juliachem_jl_tpu_torch.ops import kernels

SRC = (kernels.CSRC_DIR / "split_fold.cu").read_text()
TM, TN, TK = kernels.K8_TILE_M, kernels.K8_TILE_N, kernels.K8_SLAB


def _order(R, K, C, lower):
    """(row tile start, column tile start, k_end) of each block in launch
    order, as split_fold_kernel computes them."""
    gx, gy = -(-C // TN), -(-R // TM)
    out = []
    for by in range(gy):
        for bx in range(gx):
            r0, c0 = (gy - 1 - by) * TM, bx * TN
            last = min(r0 + TM, R)
            out.append((r0, c0, last if lower and last < K else K))
    return out


def test_tile_flags_match_the_build_and_csrc():
    assert f"-DJC_K8_TILE_M={TM}" in kernels.NVCC_FLAGS
    assert f"-DJC_K8_TILE_N={TN}" in kernels.NVCC_FLAGS
    assert f"-DJC_K8_SLAB={TK}" in kernels.NVCC_FLAGS
    assert "constexpr int kK8TileM = JC_K8_TILE_M;" in SRC
    assert "constexpr int kK8TileN = JC_K8_TILE_N;" in SRC
    assert "constexpr int kK8Slab = JC_K8_SLAB;" in SRC
    assert re.search(r"static_assert\(kK8TileM == 128 && kK8TileN == 64", SRC)
    assert (TM, TN, TK % 4) == (128, 64, 0)
    # the order the walk mirrors
    assert "(gridDim.y - 1 - blockIdx.y) * kK8TileM" in SRC
    assert "const int64_t c0 = (int64_t)blockIdx.x * kK8TileN;" in SRC
    assert "const int64_t k_end = (lower && last < K) ? last : K;" in SRC
    assert "const int wm = warp >> 1, wn = warp & 1, ty = lane >> 3, " \
           "tx = lane & 7;" in SRC


@pytest.mark.parametrize("R,K,C", [(4448, 4448, 6144), (1112, 1112, 16384),
                                   (129, 131, 67), (300, 300, 1001)])
@pytest.mark.parametrize("lower", [True, False])
def test_launch_order_covers_each_tile_once_heaviest_first(R, K, C, lower):
    order = _order(R, K, C, lower)
    tiles = [(r0, c0) for r0, c0, _ in order]
    assert len(tiles) == len(set(tiles))
    assert set(tiles) == {(r, c) for r in range(0, R, TM)
                          for c in range(0, C, TN)}
    slabs = [-(-k_end // TK) for _, _, k_end in order]
    for r0, _, k_end in order:
        last = min(r0 + TM, R) - 1
        assert k_end == (min(last + 1, K) if lower else K)
    if lower:
        assert all(a >= b for a, b in zip(slabs, slabs[1:]))
        assert slabs[0] > slabs[-1] or R <= TM
    else:
        assert len(set(slabs)) == 1


def test_thread_map_covers_the_tile_and_reads_distinct_banks():
    owner = np.full((TM, TN), -1)
    ldm = TK + 4   # a stage's row stride of Mh, Ml (kK8LdM)
    assert "constexpr int kK8LdM = kK8Slab + 4;" in SRC
    for tid in range(256):
        lane, warp = tid & 31, tid >> 5
        wm, wn, ty, tx = warp >> 1, warp & 1, lane >> 3, lane & 7
        for i in range(8):
            for j in range(4):
                r, c = wm * 32 + ty + 4 * i, wn * 32 + 4 * tx + j
                assert owner[r, c] == -1
                owner[r, c] = tid
    assert (owner >= 0).all()
    for warp in range(8):
        wm, wn = warp >> 1, warp & 1
        for i in range(8):
            for kk in range(0, TK, 4):
                # M: quarter-warp ty reads one float4 of row wm*32 + ty + 4i
                banks = [set(range((wm * 32 + ty + 4 * i) * ldm + kk,
                                   (wm * 32 + ty + 4 * i) * ldm + kk + 4))
                         for ty in range(4)]
                banks = [{b % 32 for b in s} for s in banks]
                assert len(set().union(*banks)) == 16
        # X: a quarter-warp's 8 float4s of one k row cover the 32 banks
        words = {(wn * 32 + 4 * tx + j) % 32 for tx in range(8)
                 for j in range(4)}
        assert len(words) == 32


@pytest.mark.parametrize("R,K,C", [(129, 129, 67), (300, 300, 130),
                                   (257, 257, 64)])
def test_tiles_over_their_k_ranges_equal_the_product(R, K, C):
    rng = np.random.default_rng(R + C)
    M = np.tril(rng.standard_normal((R, K)))
    X = rng.standard_normal((K, C))
    Y = np.full((R, C), np.nan)
    for r0, c0, k_end in _order(R, K, C, lower=True):
        kk = -(-k_end // TK) * TK   # whole slabs, zero-filled past K
        Y[r0:r0 + TM, c0:c0 + TN] = (M[r0:r0 + TM, :min(kk, K)]
                                     @ X[:min(kk, K), c0:c0 + TN])
    ref = M @ X
    assert np.abs(Y - ref).max() <= 1e-13 * np.abs(ref).max()
