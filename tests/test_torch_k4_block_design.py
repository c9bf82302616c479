"""The design of K4/K5's block route (csrc/eri4c.cuh ``eri4c_block``) on the
CPU: the pieces the card runs, walked in the card's order with numpy.

- (a) The level-parallel R recursion: every entry of level n of
  hermite_R's downward recursion from level n + 1 at once (one barrier a
  level on the card), the even levels in R and the odd ones in a second
  buffer, against the JAX package's ``r_tensor`` within 1e-13 relative
  (of the largest |R|) for L = 7 .. 16.
- (b) A plain walk of the block route's two products: M gathered fragment
  by fragment from R through the device's index arithmetic (nherm(s-1) +
  d(d+1)/2 + v of the summed Hermite triples, the sign (-1)^|g|; held to
  ``combine_tables``), T1 = M Ecd and I = Eab^T T1 accumulated in k-steps
  of 4 over the route's tiles (the geometry of ``Eri4cBlockSmem`` /
  ``eri4c_block_geometry``), the live primitive pairs stacked on both
  GEMM dimensions, in rounds of primitive pairs where the geometry has
  them; held to the JAX ``_eri_kernel_body`` and the port's
  ``eri4c_plain`` within 1e-12 x max |I| on every g class pair of one
  water in 6-311++G(3df,3pd)+G, a few quartets each, and on the class
  pairs that run in rounds in the long-contraction basis cc-pVDZ+S12G2
  (tests/data/long_s_2g.gbs: a 12-primitive S and a 2-primitive G shell
  on O).
- (c) K5's digestion from those tiles (each tile's share of the six J/K
  outputs, ``jk_partial``, summed over the tiles, times the weight)
  against ``digest_plain`` within 1e-13 x max(|J|, |K|); the outputs that
  ``block_digest_tile`` visits for a tile hold every output the tile
  reaches, each once.
- (d) The three-way route table (lane / block / warp) of ``ops/kernels.py``
  against the build's flags (one lane and one block mask a bra pair
  class, disjoint) and the macros of csrc/ that read them; the block
  route's shared memory within the card's 227 KB on the g class pairs,
  in one round at the g basis's contractions, and in rounds at any
  contraction ((ss|gg) with 144 x 4 padded primitive pairs, (gg|gg) with
  2-primitive g shells).
"""

import importlib.util
import itertools
import re
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

import juliachem_jl_tpu_torch as tc
from juliachem_jl_tpu.ops import eri as jx_eri
from juliachem_jl_tpu.ops.mcmurchie import r_tensor as jx_r_tensor
from juliachem_jl_tpu_torch.basis.structs import ncart
from juliachem_jl_tpu_torch.ops import eri, fock, fock_stream, kernels
from juliachem_jl_tpu_torch.ops.class_tables import combine_tables, nherm
from tests.test_torch_eri4c_design import boys_recip

G_BASIS = "6-311++G(3df,3pd)+G"
G_FILE = Path(__file__).parent / "data" / "6-311ppG_3df_3pd_G.gbs"
# long contractions (tools/make_g_basis.py --long): a 12-primitive S and a
# 2-primitive G shell on O, so (ss) pairs hold 144 primitive pairs
LONG_BASIS = "cc-pVDZ+S12G2"
LONG_FILE = Path(__file__).parent / "data" / "long_s_2g.gbs"
WATER = {"symbols": ["O", "H", "H"],
         "geometry": [0.0, 0.0, 0.116321, 0.0, 0.751155, -0.465285,
                      0.0, -0.751155, -0.465285]}
CSRC = kernels.CSRC_DIR
TWO_PI_POW_2_5 = 2.0 * np.pi ** 2.5
SMEM_MAX = 232448   # bytes of shared memory a block may take on the H100


def herm_triples(L):
    """(t, u, v) in herm_index order (csrc/mcmurchie.cuh herm_triple)."""
    out = []
    for s in range(L + 1):
        for d in range(s + 1):
            for u in range(d, -1, -1):
                out.append((s - d, u, d - u))
    return out


def herm_index(t, u, v):   # csrc/mcmurchie.cuh
    s, d = t + u + v, u + v
    return s * (s + 1) * (s + 2) // 6 + d * (d + 1) // 2 + v


def top_values(L, alpha, F):
    """G[..., n] = (-2 alpha)^n F[..., n], the power by repeated products
    as the card and ``r_tensor`` take it."""
    G = np.empty(F.shape)
    pw = np.ones(alpha.shape)
    for n in range(L + 1):
        G[..., n] = pw * F[..., n]
        pw = pw * (-2.0 * alpha)
    return G


def r_levels(L, alpha, X, G):
    """csrc/eri4c.cuh eri4c_block step 3 as numpy over a batch: G[..., n] =
    (-2 alpha)^n F_n pref; level n = L .. 0, every entry of a level from
    the level above at once, even levels in R, odd ones in Rs."""
    trip = herm_triples(L)
    NH, NHS = nherm(L), nherm(L - 1)
    R = np.zeros(alpha.shape + (NH,))
    Rs = np.zeros(alpha.shape + (max(NHS, 1),))
    for n in range(L, -1, -1):
        even = n % 2 == 0
        dst, src = (R, Rs) if even else (Rs, R)
        new = np.empty(alpha.shape + (nherm(L - n),))
        for h in range(nherm(L - n)):
            t, u, v = trip[h]
            if h == 0:
                new[..., h] = G[..., n]
                continue
            for axis, (i, lo, hi) in enumerate(
                    ((t, (t - 2, u, v), (t - 1, u, v)),
                     (u, (t, u - 2, v), (t, u - 1, v)),
                     (v, (t, u, v - 2), (t, u, v - 1)))):
                if i > 0:
                    x = X[..., axis] * src[..., herm_index(*hi)]
                    if i >= 2:
                        x = (i - 1) * src[..., herm_index(*lo)] + x
                    new[..., h] = x
                    break
        dst[..., :nherm(L - n)] = new   # after the level: the barrier
    return R


@pytest.mark.parametrize("L", range(7, 17))
def test_level_parallel_r_matches_jax_r_tensor(L):
    rng = np.random.default_rng(L)
    n = 64
    alpha = rng.uniform(0.05, 4.0, n)
    X = rng.normal(scale=1.5, size=(n, 3))
    T = alpha * (X ** 2).sum(-1)
    F = boys_recip(T, L) * rng.uniform(0.5, 2.0, n)[:, None]
    got = r_levels(L, alpha, X, top_values(L, alpha, F))
    ref = np.asarray(jx_r_tensor(L, alpha, X, F))
    assert got.shape == ref.shape == (n, nherm(L))
    scale = np.abs(ref).max(axis=1, keepdims=True)
    assert float((np.abs(got - ref) / scale).max()) <= 1e-13


# ------------------------------------------------- the block route's layout

def pad_to(x, m):
    return (x + m - 1) // m * m


def block_smem(cls, Kab, Kcd, CT, AT, jk):
    """Doubles of one block (csrc/eri4c.cuh Eri4cBlockSmem) for rounds of
    Kab bra and Kcd ket primitive pairs."""
    la, lb, lc, ld = cls
    nab, ncd = ncart(la) * ncart(lb), ncart(lc) * ncart(ld)
    nhb, nhk, L = nherm(la + lb), nherm(lc + ld), sum(cls)
    neb = (la + 1) * (lb + 1) * (la + lb + 1)
    nek = (lc + 1) * (ld + 1) * (lc + ld + 1)
    ndg = (ncart(lc) * ncart(ld) + nab + ncart(lb) * ncart(ld)
           + ncart(lb) * ncart(lc) + ncart(la) * ncart(ld)
           + ncart(la) * ncart(lc))
    nout = nab + ncd + (ncart(la) + ncart(lb)) * (ncart(lc) + ncart(ld))
    K4b, K4k = pad_to(Kab * nhb, 4), pad_to(Kcd * nhk, 4)
    ldE, ldA = pad_to(CT, 16) + 4, pad_to(AT, 16) + 4
    R = 4 + 5 * (Kab + Kcd) + 3 * (Kab * neb + Kcd * nek)
    X1 = R + Kab * Kcd * nherm(L)
    end = X1 + max(K4k * ldE, AT * CT) + K4b * ldA + K4b * ldE
    end = max(end, X1 + Kab * Kcd * (nherm(L - 1) + L + 5))
    tab = end + (ndg + nout if jk else 0) + nab + ncd
    return tab + (nherm(L) + nab + ncd + 2 * K4k + 1) // 2 + 32


def block_tile():
    """csrc/eri4c.cuh kEri4cBlockTile."""
    m = re.search(r"constexpr int kEri4cBlockTile = (\d+);",
                  (CSRC / "eri4c.cuh").read_text())
    return int(m.group(1))


def block_geometry(cls, Kab, Kcd, jk=True):
    """(CT, AT, RB, RK, bytes) of csrc/eri4c.cuh eri4c_block_geometry for
    Kab bra and Kcd ket primitive pairs (the padded contractions)."""
    la, lb, lc, ld = cls
    nab, ncd = ncart(la) * ncart(lb), ncart(lc) * ncart(ld)
    tile = block_tile()
    cap = (kernels.ERI4C_BLOCK4_CAP if kernels.eri4c_block_warps(*cls) == 4
           else kernels.ERI4C_BLOCK_CAP)
    RB, RK = Kab, Kcd
    while True:
        CT, AT = min(ncd, tile), min(nab, tile)
        while (8 * block_smem(cls, RB, RK, CT, AT, jk) > cap
               and (CT > 8 or AT > 8)):
            if CT >= AT:
                CT = CT - 16 if CT >= 24 else 8
            else:
                AT = AT - 16 if AT >= 24 else 8
        if 8 * block_smem(cls, RB, RK, CT, AT, jk) <= cap or RB == RK == 1:
            break
        if RB >= RK:
            RB = (RB + 1) // 2
        else:
            RK = (RK + 1) // 2
    return CT, AT, RB, RK, 8 * block_smem(cls, RB, RK, CT, AT, jk)


# ------------------------------------------------------ the plain walk

@lru_cache(maxsize=None)
def _water(long=False):
    """Water's basis and Schwarz staircase in the g basis, or (long) in
    the long-contraction g basis."""
    path, name = (LONG_FILE, LONG_BASIS) if long else (G_FILE, G_BASIS)
    tc.basis.register_basis_file(str(path), name)
    prim = tc.basis.build(tc.molecule.from_input_dict(WATER), name)
    sdf = fock_stream.StreamingDirectFock(prim, device="cpu")
    return prim, sdf


def _g_cases():
    _, sdf = _water()
    out = []
    for i, cp in enumerate(sdf.pairs):
        b, k = sdf.blocks[cp.bi].table, sdf.blocks[cp.ki].table
        if 4 in (b.la, b.lb, k.la, k.lb):
            out.append(i)
    return out


def _long_cases():
    """The class pairs of water's staircase in the long-contraction basis
    that the block route takes in more than one round of primitive pairs
    (K4's geometry or K5's)."""
    _, sdf = _water(long=True)
    out = []
    for i, cp in enumerate(sdf.pairs):
        b, k = sdf.blocks[cp.bi].table, sdf.blocks[cp.ki].table
        cls = (b.la, b.lb, k.la, k.lb)
        if kernels.eri4c_route(*cls) != "block":
            continue
        geos = [block_geometry(cls, b.Ka * b.Kb, k.Ka * k.Kb, jk)
                for jk in (False, True)]
        if any(g[2] < b.Ka * b.Kb or g[3] < k.Ka * k.Kb for g in geos):
            out.append(i)
    return out


def prim_data(tab, row):
    """Live primitive pairs of one pair-table row in the kernel's order k
    = i kb + j: exponent sums, centres, per-dimension E tables, and the
    contraction products."""
    Ka, Kb = tab.Ka, tab.Kb
    x = tab.pair[row].numpy()
    ka, kb = (int(v) for v in tab.meta[row, 2:4])
    A, B = x[2 * Ka + 2 * Kb:2 * Ka + 2 * Kb + 3], x[2 * Ka + 2 * Kb + 3:]
    p, P, cc = [], [], []
    for i in range(ka):
        for j in range(kb):
            a, b = x[i], x[2 * Ka + j]
            p.append(a + b)
            P.append((a * A + b * B) / (a + b))
            cc.append(x[Ka + i] * x[2 * Ka + Kb + j])
    return np.array(p), np.array(P), np.array(cc)


def hermite_rows(tab, row, l1, l2):
    """Eab[(k, h)][ab] of one pair-table row, live pairs stacked (k = i kb
    + j), from the plain expansion (``PairTable.hermite``)."""
    Eab, _, _, live = tab.hermite(torch.as_tensor([row]))
    E = Eab[0][live[0]].numpy()            # [K2 live, nab, nh]
    return E.transpose(0, 2, 1).reshape(-1, E.shape[1])


@lru_cache(maxsize=None)
def gather_table(lb_, lk_):
    """M's gather of one class pair through the device's index arithmetic
    (csrc/eri4c.cuh MGather: nherm(s-1) + d(d+1)/2 + v of the summed
    Hermite triples, the sign (-1)^|g|), held to ``combine_tables``."""
    trb, trk = herm_triples(lb_), herm_triples(lk_)
    idx = np.array([[herm_index(t + t2, u + u2, v + v2)
                     for t2, u2, v2 in trk] for t, u, v in trb])
    sign = np.array([(-1.0) ** (t2 + u2 + v2) for t2, u2, v2 in trk])
    comb, csign = combine_tables(lb_, lk_)
    assert (idx == np.asarray(comb)).all()
    assert (sign == np.asarray(csign)).all()
    return idx, sign


def block_walk(bra, ket, r, c, jk=True):
    """The (ab|cd) block of quartet (r, c) as the block route computes it,
    round by round of live primitive pairs and tile by tile (the geometry
    of K5, ``jk``, or K4): returns each round's share of each tile
    [(ab0, cd0, I tile)], the whole block, and the rounds' (RB, RK)."""
    la, lb, lc, ld = bra.la, bra.lb, ket.la, ket.lb
    cls = (la, lb, lc, ld)
    L, NHB, NHK = sum(cls), nherm(la + lb), nherm(lc + ld)
    NAB, NCD = ncart(la) * ncart(lb), ncart(lc) * ncart(ld)
    pb, Pb, _ = prim_data(bra, r)
    pk, Pk, _ = prim_data(ket, c)
    K2b, K2k = len(pb), len(pk)
    # Boys and R of every live primitive quartet (k, l), each in its round
    p, q = pb[:, None], pk[None, :]
    PQ = Pb[:, None, :] - Pk[None, :, :]
    psum = p + q
    alpha = p * q / psum
    T = alpha * (PQ ** 2).sum(-1)
    pref = TWO_PI_POW_2_5 / (p * q * np.sqrt(psum))
    F = boys_recip(T, L) * pref[..., None]
    R = r_levels(L, alpha, PQ, top_values(L, alpha, F))   # [K2b, K2k, NH]
    idx, sign = gather_table(la + lb, lc + ld)
    Eb_all = hermite_rows(bra, r, la, lb)                  # [K2b NHB, NAB]
    Ek_all = hermite_rows(ket, c, lc, ld)                  # [K2k NHK, NCD]
    CT, AT, RB, RK, nbytes = block_geometry(cls, bra.Ka * bra.Kb,
                                            ket.Ka * ket.Kb, jk)
    assert nbytes <= SMEM_MAX
    tiles, I = [], np.zeros((NAB, NCD))
    for b0 in range(0, K2b, RB):
        nb = min(RB, K2b - b0)
        for k0 in range(0, K2k, RK):
            nk = min(RK, K2k - k0)
            # the round's M[(k,h)][(l,g)], its pairs stacked on both sides,
            # zero past the live rows and k-steps
            Mb, Mk = nb * NHB, nk * NHK
            K4b, K4k = pad_to(Mb, 4), pad_to(Mk, 4)
            Mr = R[b0:b0 + nb, k0:k0 + nk][:, :, idx] * sign
            M = np.zeros((K4b, K4k))
            M[:Mb, :Mk] = Mr.transpose(0, 2, 1, 3).reshape(Mb, Mk)
            Eab = np.zeros((K4b, NAB))
            Eab[:Mb] = Eb_all[b0 * NHB:(b0 + nb) * NHB]
            Ecd = np.zeros((K4k, NCD))
            Ecd[:Mk] = Ek_all[k0 * NHK:(k0 + nk) * NHK]
            for cd0 in range(0, NCD, CT):
                ct = min(CT, NCD - cd0)
                T1 = np.zeros((K4b, ct))
                for s in range(0, K4k, 4):      # product 1, k-steps of 4
                    T1 += M[:, s:s + 4] @ Ecd[s:s + 4, cd0:cd0 + ct]
                for ab0 in range(0, NAB, AT):
                    at = min(AT, NAB - ab0)
                    It = np.zeros((at, ct))
                    for s in range(0, K4b, 4):  # product 2, k-steps of 4
                        It += Eab[s:s + 4, ab0:ab0 + at].T @ T1[s:s + 4]
                    tiles.append((ab0, cd0, It))
                    # K4 writes the first round's tile, adds the others'
                    I[ab0:ab0 + at, cd0:cd0 + ct] += It
    return tiles, I, (RB, RK)


@lru_cache(maxsize=None)
def _case(i, long=False, jk=True):
    """One g class pair of water's staircase (``_water(long)``): a few
    quartets (rows of near pairs), their blocks by the walk in K5's
    geometry (jk) or K4's, the tiles of each."""
    _, sdf = _water(long)
    cp = sdf.pairs[i]
    bra, ket = sdf.blocks[cp.bi].table, sdf.blocks[cp.ki].table
    t = torch.arange(cp.N, dtype=torch.int64)
    r, c, w = fock_stream.decode_staircase(cp.cum, t, bra, ket, cp.same)
    pick = np.linspace(0, cp.N - 1, min(cp.N, 3)).astype(int)
    if long:
        # the first quartet and the one of the most live primitive quartets
        live = (bra.meta[r, 2] * bra.meta[r, 3] * ket.meta[c, 2]
                * ket.meta[c, 3])
        pick = np.array([0, int(live.argmax())])
    pick = np.unique(pick)
    r, c, w = r[pick], c[pick], w[pick]
    walks = [block_walk(bra, ket, int(a), int(b), jk)[:2]
             for a, b in zip(r, c)]
    return bra, ket, r, c, w, walks


def _jax_blocks(bra, ket, r, c):
    """The JAX ``_eri_kernel_body`` on the same rows (numpy inputs)."""
    def cols(tab, sel):
        return [x.numpy() for x in tab.columns(sel)]

    body = jx_eri._eri_kernel_body(bra.la, bra.lb, ket.la, ket.lb, bra.Ka,
                                   bra.Kb, ket.Ka, ket.Kb)
    return np.asarray(body(*cols(bra, r), *cols(ket, c)))


@lru_cache(maxsize=None)
def _gg_scale():
    _, sdf = _water()
    i = next(i for i in _g_cases()
             if (sdf.blocks[sdf.pairs[i].bi].table.la,
                 sdf.blocks[sdf.pairs[i].ki].table.la) == (4, 4))
    bra, ket, r, c, _, _ = _case(i)
    return float(np.abs(_jax_blocks(bra, ket, r, c)).max())


def check_walk(i, long=False, jk=True):
    bra, ket, r, c, w, walks = _case(i, long, jk)
    got = np.stack([I for _, I in walks])
    ref = _jax_blocks(bra, ket, r, c)
    plain = eri.eri4c_plain(bra, ket, r, c).numpy()
    # a one-centre class pair of odd total momentum vanishes: held to the
    # scale of the water's (gg|gg) quartets then
    scale = float(np.abs(ref).max()) or _gg_scale()
    assert float(np.abs(got - ref).max()) <= 1e-12 * scale
    assert float(np.abs(got - plain).max()) <= 1e-12 * scale


@pytest.mark.parametrize("i", _g_cases())
def test_block_walk_matches_jax_and_plain(i):
    check_walk(i)


@pytest.mark.parametrize("i", _long_cases())
@pytest.mark.parametrize("jk", [False, True], ids=["k4", "k5"])
def test_block_rounds_walk_matches_jax_and_plain(i, jk):
    """Long contractions: the block in rounds of primitive pairs (K4's
    geometry and K5's), each round's tiles added, against the JAX package
    and the plain version."""
    _, sdf = _water(long=True)
    cp = sdf.pairs[i]
    bra, ket = sdf.blocks[cp.bi].table, sdf.blocks[cp.ki].table
    g = block_geometry((bra.la, bra.lb, ket.la, ket.lb), bra.Ka * bra.Kb,
                       ket.Ka * ket.Kb, jk)
    check_walk(i, long=True, jk=jk)
    assert g[4] <= SMEM_MAX
    # where this geometry has rounds, some quartet runs in more than one
    _, _, r, c, _, _ = _case(i, True, jk)
    if g[2] < bra.Ka * bra.Kb or g[3] < ket.Ka * ket.Kb:
        assert bool(((bra.meta[r, 2] * bra.meta[r, 3] > g[2])
                     | (ket.meta[c, 2] * ket.meta[c, 3] > g[3])).any())


def tile_share(It, ab0, cd0, cls, D, oa, ob, oc, od, nbf):
    """One tile's share of the six J/K outputs of a quartet (csrc/eri4c.cuh
    ``jk_partial``): the block zero outside the tile, contracted."""
    na, nb, nc_, nd = (ncart(x) for x in cls)
    blk = np.zeros((na * nb, nc_ * nd))
    blk[ab0:ab0 + It.shape[0], cd0:cd0 + It.shape[1]] = It
    I4 = blk.reshape(na, nb, nc_, nd)
    Dab = D[oa:oa + na, ob:ob + nb]
    Dcd = D[oc:oc + nc_, od:od + nd]
    Dbd, Dbc = D[ob:ob + nb, od:od + nd], D[ob:ob + nb, oc:oc + nc_]
    Dad, Dac = D[oa:oa + na, od:od + nd], D[oa:oa + na, oc:oc + nc_]
    J, K = np.zeros((nbf, nbf)), np.zeros((nbf, nbf))
    J[oa:oa + na, ob:ob + nb] += 2.0 * np.einsum("abcd,cd->ab", I4, Dcd)
    J[oc:oc + nc_, od:od + nd] += 2.0 * np.einsum("abcd,ab->cd", I4, Dab)
    K[oa:oa + na, oc:oc + nc_] += np.einsum("abcd,bd->ac", I4, Dbd)
    K[oa:oa + na, od:od + nd] += np.einsum("abcd,bc->ad", I4, Dbc)
    K[ob:ob + nb, oc:oc + nc_] += np.einsum("abcd,ad->bc", I4, Dad)
    K[ob:ob + nb, od:od + nd] += np.einsum("abcd,ac->bd", I4, Dac)
    return J, K


def tile_outputs(cls, ab0, at, cd0, ct):
    """The outputs (jk_partial's order) that csrc/eri4c.cuh
    ``block_digest_tile`` visits for one tile, in its order."""
    NA, NB, NC, ND = (ncart(x) for x in cls)
    NAB, NCD = NA * NB, NC * ND
    a0, a1 = ab0 // NB, (ab0 + at - 1) // NB
    c0, c1 = cd0 // ND, (cd0 + ct - 1) // ND
    b0, b1 = (0, NB - 1) if a1 > a0 else (ab0 % NB, (ab0 + at - 1) % NB)
    d0, d1 = (0, ND - 1) if c1 > c0 else (cd0 % ND, (cd0 + ct - 1) % ND)
    A, B = range(a0, a1 + 1), range(b0, b1 + 1)
    Cr, Dr = range(c0, c1 + 1), range(d0, d1 + 1)
    k0 = NAB + NCD
    return ([ab0 + e for e in range(at)] + [NAB + cd0 + e for e in range(ct)]
            + [k0 + a * NC + c for a in A for c in Cr]
            + [k0 + NA * NC + a * ND + d for a in A for d in Dr]
            + [k0 + NA * NC + NA * ND + b * NC + c for b in B for c in Cr]
            + [k0 + NA * NC + NA * ND + NB * NC + b * ND + d
               for b in B for d in Dr])


def reached_outputs(cls, ab0, at, cd0, ct):
    """Every output that an element of the tile adds to."""
    NA, NB, NC, ND = (ncart(x) for x in cls)
    NAB, NCD = NA * NB, NC * ND
    k0 = NAB + NCD
    out = set()
    for ab in range(ab0, ab0 + at):
        a, b = divmod(ab, NB)
        for cd in range(cd0, cd0 + ct):
            c, d = divmod(cd, ND)
            out |= {ab, NAB + cd, k0 + a * NC + c, k0 + NA * NC + a * ND + d,
                    k0 + NA * NC + NA * ND + b * NC + c,
                    k0 + NA * NC + NA * ND + NB * NC + b * ND + d}
    return out


def check_digestion(i, long=False):
    bra, ket, r, c, w, walks = _case(i, long)
    prim, _ = _water(long)
    nbf = prim.nbf
    rng = np.random.default_rng(7 + i)
    X = rng.normal(size=(nbf, nbf))
    D = X + X.T
    cls = (bra.la, bra.lb, ket.la, ket.lb)
    J, K = np.zeros((nbf, nbf)), np.zeros((nbf, nbf))
    for q, (tiles, _) in enumerate(walks):
        mb, mk = bra.meta[r[q]], ket.meta[c[q]]
        acc_J, acc_K = np.zeros((nbf, nbf)), np.zeros((nbf, nbf))
        for ab0, cd0, It in tiles:
            # the device visits each output the tile reaches, once
            seen = tile_outputs(cls, ab0, It.shape[0], cd0, It.shape[1])
            assert len(seen) == len(set(seen))
            assert reached_outputs(cls, ab0, It.shape[0], cd0,
                                   It.shape[1]) <= set(seen)
            dJ, dK = tile_share(It, ab0, cd0, cls, D, int(mb[0]), int(mb[1]),
                                int(mk[0]), int(mk[1]), nbf)
            acc_J += dJ
            acc_K += dK
        J += float(w[q]) * acc_J
        K += float(w[q]) * acc_K
    JK = torch.zeros((2, nbf, nbf), dtype=torch.float64)
    I = torch.as_tensor(np.stack([I for _, I in walks]))
    fock.digest_plain(JK, I, w, torch.as_tensor(D), bra, ket, r, c)
    scale = float(JK.abs().max()) or _gg_scale() * float(np.abs(D).max())
    assert float(np.abs(J - JK[0].numpy()).max()) <= 1e-13 * scale
    assert float(np.abs(K - JK[1].numpy()).max()) <= 1e-13 * scale


@pytest.mark.parametrize("i", _g_cases())
def test_block_digestion_matches_digest_plain(i):
    check_digestion(i)


@pytest.mark.parametrize("i", _long_cases())
def test_block_rounds_digestion_matches_digest_plain(i):
    """Long contractions: K5 digests each round's share of each tile."""
    check_digestion(i, long=True)


def test_route_table_has_three_routes_matching_flags_and_csrc():
    pcs = eri.PAIR_CLASSES
    lane = [int(re.fullmatch(rf"-DJC_ERI4C_LANE_MASK_B{i}=(0x[0-9a-f]+)",
                             f).group(1), 16)
            for i, f in enumerate(kernels.route_flags())]
    bflags = kernels.block_route_flags()
    block = [int(re.fullmatch(rf"-DJC_ERI4C_BLOCK_MASK_B{i}=(0x[0-9a-f]+)",
                              f).group(1), 16)
             for i, f in enumerate(bflags[:15])]
    block4 = [int(re.fullmatch(rf"-DJC_ERI4C_BLOCK4_MASK_B{i}=(0x[0-9a-f]+)",
                               f).group(1), 16)
              for i, f in enumerate(bflags[15:30])]
    assert bflags[30:] == (
        f"-DJC_ERI4C_BLOCK_WARPS={kernels.ERI4C_BLOCK_WARPS}",
        f"-DJC_ERI4C_BLOCK_CAP={kernels.ERI4C_BLOCK_CAP}",
        f"-DJC_ERI4C_BLOCK4_CAP={kernels.ERI4C_BLOCK4_CAP}")
    seen = {"lane": 0, "block": 0, "warp": 0}
    for i, j in itertools.combinations_with_replacement(range(len(pcs)), 2):
        cls = (*pcs[i], *pcs[j])
        route = kernels.eri4c_route(*cls)
        seen[route] += 1
        assert (lane[i] >> j) & 1 == (route == "lane"), cls
        assert (block[i] >> j) & 1 == (route == "block"), cls
        # 4 warps a block only on the block route
        assert (block4[i] >> j) & 1 == (
            route == "block" and cls in kernels.ERI4C_BLOCK4), cls
        assert kernels.eri4c_block_warps(*cls) == (
            0 if route != "block" else 4 if cls in kernels.ERI4C_BLOCK4
            else kernels.ERI4C_BLOCK_WARPS), cls
        assert route == "block" if cls in kernels.ERI4C_BLOCK else True
        # K6's lane route only where K4/K5 take the lane route
        if kernels.digest_route(*cls) == "lane":
            assert route == "lane", cls
    assert sum(seen.values()) == 120 and all(seen.values())
    assert all((lane[i] & block[i]) == 0 and block[i] < 1 << 15
               and block[i] & ((1 << i) - 1) == 0 for i in range(15))
    # every g class pair off the lane route has been measured against the
    # block route: none is left on the warp route
    for cls in kernels.ERI4C_BLOCK:
        assert len(cls) == 4 and 4 in cls
    # the sources read them so
    head = (CSRC / "eri4c.cuh").read_text()
    assert "#ifndef JC_ERI4C_BLOCK_MASK_B14" in head
    assert re.search(r"constexpr unsigned kEri4cBlockMasks\[15\] = \{\s+"
                     + r",\s+".join(f"JC_ERI4C_BLOCK_MASK_B{i}"
                                    for i in range(15)) + r"\};", head)
    assert re.search(
        r"static constexpr bool kBlock =\s+!kLane &&\s+\(\(kEri4cBlockMasks"
        r"\[pair_class\(LA, LB\)\] >> pair_class\(LC, LD\)\) & 1\);", head)
    assert re.search(
        r"static constexpr bool kBlock4 =\s+kBlock &&\s+\(\(kEri4cBlock4Masks"
        r"\[pair_class\(LA, LB\)\] >> pair_class\(LC, LD\)\) & 1\);", head)
    assert re.search(r"static constexpr int kThreads = C::kBlock4 \? 128 : "
                     r"kEri4cBlockThreads;", head)
    # the block route's build flags have no default in the sources
    assert re.search(
        r"#if !defined\(JC_ERI4C_BLOCK_WARPS\) \|\| "
        r"!defined\(JC_ERI4C_BLOCK_CAP\) \|\| \\\s+"
        r"!defined\(JC_ERI4C_BLOCK4_CAP\)\s+#error", head)
    for name in ("_WARPS", "_CAP", "4_CAP"):
        assert f"#define JC_ERI4C_BLOCK{name}" not in head
    assert "JC_ERI4C_BLOCK_TILE" not in head and block_tile() == 64
    launch = (CSRC / "eri4c_launch.cuh").read_text()
    assert len(re.findall(
        r"else if constexpr \(Eri4cClass<LA, LB, LC, LD>::kBlock\)",
        launch)) == 2
    assert "else if constexpr (C::kBlock)" in launch
    # the build passes and hashes the block flags
    src = (kernels.PKG_DIR / "ops" / "kernels.py").read_text()
    assert "*block_route_flags(), \"-I\", str(CSRC_DIR)," in src
    assert "*block_route_flags(),\n" in src


@pytest.mark.parametrize("cls", sorted(kernels.ERI4C_BLOCK))
def test_block_route_fits_the_card_in_the_g_basis(cls):
    """The block route's shared memory at the g basis's padded
    contractions (one water): within 227 KB, the tiles whole or cut."""
    _, sdf = _water()
    tabs = {(b.table.la, b.table.lb): b.table for b in sdf.blocks}
    bra, ket = tabs[cls[:2]], tabs[cls[2:]]
    for jk in (False, True):
        CT, AT, RB, RK, nbytes = block_geometry(cls, bra.Ka * bra.Kb,
                                                ket.Ka * ket.Kb, jk)
        assert nbytes <= SMEM_MAX, (cls, CT, AT, nbytes)
        # one round: the contractions of this basis fit whole
        assert (RB, RK) == (bra.Ka * bra.Kb, ket.Ka * ket.Kb)
        assert 8 <= CT <= ncart(cls[2]) * ncart(cls[3])
        assert 8 <= AT or AT == ncart(cls[0]) * ncart(cls[1])


@pytest.mark.parametrize("cls", sorted(kernels.ERI4C_BLOCK))
def test_block_route_fits_the_card_at_any_contraction(cls):
    """One primitive pair a round and tiles of 8, where the geometry ends
    when nothing larger fits its cap, stay within 227 KB: the block
    route's shared memory does not grow with the contraction."""
    for jk in (False, True):
        assert 8 * block_smem(cls, 1, 1, 8, 8, jk) <= SMEM_MAX, (cls, jk)
        for Kab, Kcd in ((1, 1), (144, 1), (1, 144), (144, 144), (36, 49)):
            CT, AT, RB, RK, nbytes = block_geometry(cls, Kab, Kcd, jk)
            assert nbytes <= SMEM_MAX, (cls, jk, Kab, Kcd)
            assert 1 <= RB <= Kab and 1 <= RK <= Kcd


@pytest.mark.parametrize("cls,Kab,Kcd", [((0, 0, 4, 4), 144, 1),
                                         ((0, 0, 4, 4), 144, 4),
                                         ((4, 4, 4, 4), 4, 4)])
@pytest.mark.parametrize("jk", [False, True], ids=["k4", "k5"])
def test_block_geometry_long_contractions(cls, Kab, Kcd, jk):
    """(ss|gg) with 12-primitive s shells (cc-pVQZ's O) and (gg|gg) with
    2-primitive g shells: one round of every padded primitive quartet
    (their R and the recursion's scratch) would pass the card's 227 KB
    even at tiles of 8, so the block route runs them in rounds within its
    cap."""
    CT, AT, RB, RK, nbytes = block_geometry(cls, Kab, Kcd, jk)
    cap = kernels.ERI4C_BLOCK_CAP
    assert 8 * block_smem(cls, Kab, Kcd, 8, 8, jk) > SMEM_MAX
    assert nbytes <= cap <= SMEM_MAX
    assert RB * RK < Kab * Kcd
    assert CT >= 8 and (AT >= 8 or AT == ncart(cls[0]) * ncart(cls[1]))


def test_long_basis_file_regenerates():
    spec = importlib.util.spec_from_file_location(
        "make_g_basis", Path(__file__).parents[1] / "tools" / "make_g_basis.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.long_basis_text() == LONG_FILE.read_text()
    prim, sdf = _water(long=True)
    tabs = {(b.table.la, b.table.lb): b.table for b in sdf.blocks}
    assert tabs[(0, 0)].Ka == tabs[(0, 0)].Kb == 12
    assert tabs[(4, 4)].Ka == tabs[(4, 4)].Kb == 2
