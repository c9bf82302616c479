"""The design of K4/K5 (csrc/eri4c.cuh) on the CPU: the pieces the card
runs that a plain version can mirror.

- The divide-free Boys series of K4/K5 (boys.cuh ``boys<M, true>``: the
  series and the downward recursion multiply by the reciprocals
  1/(2M+2k+3) and 1/(2m+1), each rounded once) as a numpy copy, against
  the JAX package's ``boys_np`` within 1e-14 relative for m <= 16 over
  T in [0, 35] and on the asymptotic branch to T = 60 (the reciprocals
  are rounded once, so the forms differ in the last bits: 3.1e-15 at
  most on this grid).
- The lane route of the route table of ``ops/kernels.py`` against the
  ``-D`` flag the build passes (one bit mask a bra pair class, bit j the
  ket pair class j, over the 120 class pairs to (gg|gg)) and the macros
  of csrc/ that read it; a class pair of ``ERI4C_BLOCK`` takes the block
  route, the rest the warp route (the block route's flags:
  tests/test_torch_k4_block_design.py).
- A plain walk of K5's j_ab reduction: the quartets t0 .. t0 + n - 1 of
  a staircase cut into 32-lane windows from t0, the runs of one bra row
  in a window taken from cum, one sum per run added to J; held to
  ``eri4c_jk_staircase_plain`` within 1e-13 x max |JK| on water in
  6-311++G(2d,2p) from a t0 that is not a multiple of 32, with rows that
  straddle two windows (the sums differ only in their order).
- A plain walk of the warp route's ket tiles (csrc/eri4c.cuh
  ``jk_partial``): each quartet's block cut into tiles of CT components cd
  (whole, 17, 7 and 1: tiles that straddle rows c, a short last tile), each
  tile's share of the six J/K outputs taken with the tile's own (c, d) and
  summed over the tiles; held to the plain digestion's values within
  1e-13 x their max-abs on every class pair of water in 6-31G(2df,p), to
  (ff|ff).
"""

import itertools
import re

import numpy as np
import pytest
import torch

import juliachem_jl_tpu_torch as jc
from juliachem_jl_tpu.ops.boys import boys_np
from juliachem_jl_tpu_torch.basis.structs import ncart
from juliachem_jl_tpu_torch.ops import eri, fock, fock_stream, kernels
from juliachem_jl_tpu_torch.ops.segsum import reduce_into

WATER = {"symbols": ["O", "H", "H"],
         "geometry": [0.0, 0.0, 0.116321, 0.0, 0.751155, -0.465285,
                      0.0, -0.751155, -0.465285]}
CSRC = kernels.CSRC_DIR
TCRIT, NSERIES = 35.0, 128


def boys_recip(T, mmax):
    """numpy copy of boys.cuh's boys<mmax, true>"""
    T = np.asarray(T, dtype=np.float64)
    Ts, Tl = np.minimum(T, TCRIT), np.maximum(T, TCRIT)
    x, e = 2.0 * Ts, np.exp(-Ts)
    term = np.full_like(Ts, 1.0 / (2 * mmax + 1))
    ssum = term.copy()
    for k in range(NSERIES):
        term = term * x * (1.0 / (2 * (mmax + k + 1) + 1))
        ssum = ssum + term
    small = [None] * (mmax + 1)
    small[mmax] = e * ssum
    for m in range(mmax - 1, -1, -1):
        small[m] = (x * small[m + 1] + e) * (1.0 / (2 * m + 1))
    large = [0.5 * np.sqrt(np.pi / Tl)]
    el, inv2T = np.exp(-Tl), 0.5 / Tl
    for m in range(1, mmax + 1):
        large.append(((2.0 * m - 1.0) * large[m - 1] - el) * inv2T)
    return np.stack([np.where(T <= TCRIT, s, g) for s, g in zip(small, large)],
                    axis=-1)


@pytest.mark.parametrize("mmax", [0, 3, 8, 12, 16])
def test_reciprocal_boys_series_matches_boys_np(mmax):
    T = np.concatenate([np.linspace(0.0, 35.0, 70001),
                        np.linspace(35.0, 60.0, 5001)[1:]])
    got, ref = boys_recip(T, mmax), boys_np(T, mmax)
    assert float(np.max(np.abs(got - ref) / np.abs(ref))) <= 1e-14


def test_route_table_matches_the_build_and_csrc():
    flags = kernels.route_flags()
    m = [re.fullmatch(rf"-DJC_ERI4C_LANE_MASK_B{i}=(0x[0-9a-f]+)", f)
         for i, f in enumerate(flags)]
    assert len(flags) == 15 and all(m)
    masks = [int(x.group(1), 16) for x in m]
    head = (CSRC / "eri4c.cuh").read_text()
    assert "#ifndef JC_ERI4C_LANE_MASK_B14" in head
    assert re.search(r"constexpr unsigned kEri4cLaneMasks\[15\] = \{\s+"
                     + r",\s+".join(f"JC_ERI4C_LANE_MASK_B{i}"
                                    for i in range(15)) + r"\};", head)
    assert re.search(r"static constexpr bool kLane =\s+\(kEri4cLaneMasks\["
                     r"pair_class\(LA, LB\)\] >> pair_class\(LC, LD\)\) & 1;",
                     head)
    # pair_class's index in csrc/ is the mask (bra) and the bit (ket) the
    # table sets: the i <= j walk over PAIR_CLASSES
    def pair_class(a, b):
        return a * 5 - a * (a - 1) // 2 + (b - a)
    assert re.search(r"return a \* 5 - a \* \(a - 1\) / 2 \+ \(b - a\);", head)
    launch = (CSRC / "eri4c_launch.cuh").read_text()
    # K4 and K5 each take the route of their class pair from that flag
    assert len(re.findall(r"if constexpr \(Eri4cClass<LA, LB, LC, LD>::kLane\)",
                          launch)) == 2
    pcs = eri.PAIR_CLASSES
    assert [pair_class(*pc) for pc in pcs] == list(range(len(pcs)))
    seen = set()
    for i, j in itertools.combinations_with_replacement(range(len(pcs)), 2):
        cls = (*pcs[i], *pcs[j])
        seen.add((i, j))
        block = cls in kernels.ERI4C_BLOCK
        lane = ((sum(cls) <= kernels.ERI4C_LANE_MAX_L
                 and cls not in kernels.ERI4C_LANE_EXCLUDE)
                or cls in kernels.ERI4C_LANE_INCLUDE) and not block
        assert kernels.eri4c_route(*cls) == (
            "lane" if lane else "block" if block else "warp"), cls
        assert (masks[i] >> j) & 1 == lane, cls
    assert len(seen) == 120 and len(masks) == 15
    assert all(m < 1 << 15 and m & ((1 << i) - 1) == 0
               for i, m in enumerate(masks))
    # every class pair of total angular momentum 3 or less takes the lane
    # route, and the table is what the build hashes and passes
    assert all(kernels.eri4c_route(*c) == "lane" for c in
               itertools.product(range(4), repeat=4) if sum(c) <= 3)
    assert flags[0] not in kernels.NVCC_FLAGS
    src = (kernels.PKG_DIR / "ops" / "kernels.py").read_text()
    assert "*NVCC_FLAGS, *route_flags()" in src


def _water_stair():
    mol = jc.molecule.from_input_dict(WATER)
    prim = jc.basis.build(mol, "6-311++G(2d,2p)")
    sdf = fock_stream.StreamingDirectFock(prim, device="cpu")
    rng = np.random.default_rng(5)
    X = rng.normal(size=(prim.nbf, prim.nbf))
    return prim, sdf, torch.as_tensor(X + X.T).contiguous()


def test_jab_run_sums_match_the_plain_staircase():
    prim, sdf, D = _water_stair()
    nbf = prim.nbf
    ref = torch.zeros((2, nbf, nbf), dtype=torch.float64)
    got = torch.zeros_like(ref)
    quartets = adds = straddle = 0
    for cp in sdf.pairs:
        bra, ket = sdf.blocks[cp.bi].table, sdf.blocks[cp.ki].table
        t0 = 5 if cp.N > 5 else 0
        n = cp.N - t0
        fock_stream.eri4c_jk_staircase_plain(ref, bra, ket, cp.cum, n,
                                             cp.same, D, t0=t0)
        t = torch.arange(t0, t0 + n, dtype=torch.int64)
        r, c, w = fock_stream.decode_staircase(cp.cum, t, bra, ket, cp.same)
        I = eri.eri4c_plain(bra, ket, r, c)
        vals, targets = fock._digest_vals(I, w, D, bra, ket, r, c)
        nab = ncart(bra.la) * ncart(bra.lb)
        # the five images with their own targets, one add per element
        reduce_into(got.view(-1), targets[:, nab:], vals[:, nab:])
        # j_ab: windows of 32 lanes from t0; a row's run in a window is
        # [max(cum[r-1], start), min(cum[r], end)); one sum per run
        cum = cp.cum.tolist()
        for start in range(t0, t0 + n, 32):
            end = min(start + 32, t0 + n)
            s = start
            while s < end:
                row = int(r[s - t0])
                stop = min(cum[row], end)
                run = slice(s - t0, stop - t0)
                reduce_into(got.view(-1), targets[run.start, :nab],
                            vals[run, :nab].sum(0))
                adds += 1
                s = stop
            row0 = int(r[start - t0])
            if start > t0 and (cum[row0 - 1] if row0 else 0) < start:
                straddle += 1
        quartets += n
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-13 * scale
    assert straddle > 0          # some row's run began in an earlier window
    assert adds < quartets / 2   # the run sums replace most j_ab atomics


def _tiled_outputs(I, w, D, bra, ket, r, c, CT):
    """The six outputs of each quartet as K5's warp route sums them over ket
    tiles of CT components: per tile, j_ab and the K images from the tile's
    cd = c*ND + d, j_cd on the tile's own components."""
    na, nb = ncart(bra.la), ncart(bra.lb)
    nc, nd = ncart(ket.la), ncart(ket.lb)
    n = I.shape[0]
    mb, mk = bra.meta[r].long().numpy(), ket.meta[c].long().numpy()
    Dn = D.numpy()

    def blk(ro, co, n1, n2):
        return Dn[ro[:, None, None] + np.arange(n1)[None, :, None],
                  co[:, None, None] + np.arange(n2)[None, None, :]]

    Dcd, Dab = blk(mk[:, 0], mk[:, 1], nc, nd), blk(mb[:, 0], mb[:, 1], na, nb)
    Dbd, Dbc = blk(mb[:, 1], mk[:, 1], nb, nd), blk(mb[:, 1], mk[:, 0], nb, nc)
    Dad, Dac = blk(mb[:, 0], mk[:, 1], na, nd), blk(mb[:, 0], mk[:, 0], na, nc)
    jab, jcd = np.zeros((n, na, nb)), np.zeros((n, nc, nd))
    kac, kad = np.zeros((n, na, nc)), np.zeros((n, na, nd))
    kbc, kbd = np.zeros((n, nb, nc)), np.zeros((n, nb, nd))
    In = I.numpy()
    for cd0 in range(0, nc * nd, CT):
        cd = np.arange(cd0, min(cd0 + CT, nc * nd))
        ci, di = cd // nd, cd % nd
        I4 = In[:, :, cd].reshape(n, na, nb, len(cd))
        jab += 2.0 * np.einsum("nabt,nt->nab", I4, Dcd[:, ci, di])
        jcd[:, ci, di] += 2.0 * np.einsum("nabt,nab->nt", I4, Dab)
        for acc, part, idx in (
                (kac, np.einsum("nabt,nbt->nat", I4, Dbd[:, :, di]), ci),
                (kad, np.einsum("nabt,nbt->nat", I4, Dbc[:, :, ci]), di),
                (kbc, np.einsum("nabt,nat->nbt", I4, Dad[:, :, di]), ci),
                (kbd, np.einsum("nabt,nat->nbt", I4, Dac[:, :, ci]), di)):
            for t, x in enumerate(idx):
                acc[:, :, x] += part[:, :, t]
    wn = w.numpy()[:, None]
    return np.concatenate([v.reshape(n, -1) * wn
                           for v in (jab, jcd, kac, kad, kbc, kbd)], axis=1)


def test_ket_tiles_sum_to_the_plain_digestion():
    mol = jc.molecule.from_input_dict(WATER)
    prim = jc.basis.build(mol, "6-31G(2df,p)")
    sdf = fock_stream.StreamingDirectFock(prim, device="cpu")
    rng = np.random.default_rng(9)
    X = rng.normal(size=(prim.nbf, prim.nbf))
    D = torch.as_tensor(X + X.T).contiguous()
    classes = set()
    for cp in sdf.pairs:
        bra, ket = sdf.blocks[cp.bi].table, sdf.blocks[cp.ki].table
        t = torch.arange(min(cp.N, 3), dtype=torch.int64)
        r, c, w = fock_stream.decode_staircase(cp.cum, t, bra, ket, cp.same)
        I = eri.eri4c_plain(bra, ket, r, c)
        ref, _ = fock._digest_vals(I, w, D, bra, ket, r, c)
        ref = ref.numpy()
        ncd = ncart(ket.la) * ncart(ket.lb)
        for CT in sorted({ncd, min(ncd, 17), min(ncd, 7), 1}):
            got = _tiled_outputs(I, w, D, bra, ket, r, c, CT)
            assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max(), \
                ((bra.la, bra.lb, ket.la, ket.lb), CT)
        classes.add((bra.la, bra.lb, ket.la, ket.lb))
    assert (3, 3, 3, 3) in classes and len(classes) == 55
