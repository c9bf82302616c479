"""The designs of K6's block route and K1's T1 body (csrc/eri4c.cuh,
csrc/eri3c.cuh) on the CPU, on one water in 6-311++G(3df,3pd)+G
(tests/data/6-311ppG_3df_3pd_G.gbs) with cc-pVTZ-JKFIT.

- K6, block route (``digest_jk_block_kernel``): a plain walk of its slabs,
  one a a slab (S[b][c][d] = I[a b][c d]): k_bc, k_bd and j_cd summed over
  the slabs, the slab's shares of k_ac, k_ad and j_ab summed into its
  partial arrays ([NB][NC], [NB][ND], [NB][NC]) and those, complete with
  the slab, added once an output; on every g class pair that the route
  table puts on the block route, held to ``digest_plain`` and to the JAX
  ``_make_digest_body`` within 1e-12 x max(|J|, |K|).  Each slab's ring
  stage (``stage_doubles``' 16-byte copies from a block 8 bytes off a
  16-byte boundary or not) holds exactly the slab, the block takes one
  add an output (``NOUT``) and its shared memory fits the card's 227 KB.
- K1, the T1 body (``eri3c_block_t1``): a plain walk of a block per (bra
  pair, tile of QT aux shells): Boys per primitive product (zero past the
  class's shells), R level by level in the even and odd buffers of
  ``block_r_levels``, T1 = M Ec with M gathered from R through the packed
  tables of ``MGather`` (the Hermite triples, product 1's k index), then
  out = Eab^T T1; on every g class on the T1 body, held to K1's plain
  version (``eri3c_class_plain``) and the JAX package's host 3-center
  build within 1e-12 x each class's max-abs, QT as csrc sizes it.
- The route tables of ops/kernels.py (``DIGEST_BLOCK``, ``ERI3C_T1``)
  against the masks the build passes, and the build keyed by them.
"""

import itertools
import re
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juliachem_jl_tpu as jx
import juliachem_jl_tpu_torch as tc
from juliachem_jl_tpu.ops import eri3c as jx_eri3c
from juliachem_jl_tpu.ops.fock import _make_digest_body
from juliachem_jl_tpu.ops.pairs import unique_pair_blocks as jx_blocks
from juliachem_jl_tpu_torch.basis.structs import ncart
from juliachem_jl_tpu_torch.ops import eri, eri3c, fock, kernels
from juliachem_jl_tpu_torch.ops.boys import boys
from juliachem_jl_tpu_torch.ops.class_tables import nherm
from juliachem_jl_tpu_torch.ops.eri import TWO_PI_POW_2_5, bra_hermite
from juliachem_jl_tpu_torch.ops.pairs import unique_pair_blocks
from tests._torch_parity import WATER
from tests.test_torch_gshell_k4 import G_BASIS, register_g

CSRC = kernels.CSRC_DIR
SMEM_MAX = 232448  # bytes of shared memory a block may opt into (H100)


def _csrc_int(name: str, pattern: str) -> int:
    """An integer constant of csrc/<name>, the first group of pattern."""
    return int(re.search(pattern, (CSRC / name).read_text()).group(1))


# K6's block route: threads of its CTA and slabs in its ring; K1's T1
# body: its shared-memory cap (csrc constants)
DIGEST_THREADS = _csrc_int("eri4c.cuh",
                           r"constexpr int kDigestBlockThreads = (\d+);")
DIGEST_STAGES = _csrc_int("eri4c.cuh",
                          r"constexpr int kDigestBlockStages = (\d+);")
T1_CAP = 1024 * _csrc_int(
    "eri3c.cuh", r"constexpr size_t kEri3cT1Cap = (\d+) \* 1024;")


@lru_cache(maxsize=None)
def _water():
    register_g()
    mol = tc.molecule.from_input_dict(WATER)
    return (tc.basis.build(mol, G_BASIS),
            tc.basis.build_auxiliary(mol, "cc-pVTZ-JKFIT", G_BASIS))


# --------------------------------------------------------- K6 block route

def _block_doubles(cls) -> tuple[int, int, int]:
    """(slab, its ring stage, the CTA's doubles) as DigestClass sizes them."""
    na, nb, nc, nd = map(ncart, cls)
    ndg = nc * nd + na * nb + nb * nd + nb * nc + na * nd + na * nc
    slab = nb * nc * nd
    stage = (slab + 3) // 2 * 2
    return slab, stage, (DIGEST_STAGES * stage + ndg
                         + 2 * nb * nc + nb * nd)


def _stage_targets(slab: int, off: int, nth: int) -> set:
    """The stage entries ``stage_doubles<NTH>`` writes for a slab whose
    first double is ``off`` (0 or 1) doubles past a 16-byte boundary: the
    8-byte copy of the first, then 16-byte copies (the last one's second
    half zero-filled where it runs past the slab)."""
    got = set()
    if off:
        got.add(1)
    m = slab - off
    for t in range(nth):
        for p in range(2 * t, m, 2 * nth):
            got |= {2 * off + p, 2 * off + p + 1}
    return got


def k6_block_walk(JK, I, w, D, bra, ket, sel_bra, sel_ket) -> int:
    """Plain walk of K6's block route over the blocks I [n, nab, ncd] into
    JK [2, nbf, nbf]; returns the adds it made (one an output a block)."""
    na, nb, nc, nd = (ncart(bra.la), ncart(bra.lb), ncart(ket.la),
                      ncart(ket.lb))
    n, nbf = I.shape[0], D.shape[0]
    S5 = I.reshape(n, na, nb, nc, nd)
    mb, mk = bra.meta[sel_bra].long(), ket.meta[sel_ket].long()
    oa, ob, oc, od = mb[:, 0], mb[:, 1], mk[:, 0], mk[:, 1]

    def rng(o, k):
        return o[:, None] + torch.arange(k)[None, :]

    ia, ib, ic, idd = rng(oa, na), rng(ob, nb), rng(oc, nc), rng(od, nd)

    def blk(u, v):   # the D block [n, |u|, |v|] of dg_element
        return D[u[:, :, None], v[:, None, :]]

    Dcd, Dab, Dbd = blk(ic, idd), blk(ia, ib), blk(ib, idd)
    Dbc, Dad, Dac = blk(ib, ic), blk(ia, idd), blk(ia, ic)
    J, K = JK[0].view(-1), JK[1].view(-1)
    adds = 0

    def add(T, u, v, vals):
        nonlocal adds
        T.index_add_(0, (u[:, :, None] * nbf + v[:, None, :]).reshape(-1),
                     vals.reshape(-1))
        adds += vals[0].numel()

    kbc = I.new_zeros((n, nb, nc))
    kbd = I.new_zeros((n, nb, nd))
    jcd = I.new_zeros((n, nc, nd))
    wn = w[:, None, None]
    for a in range(na):
        S = S5[:, a]
        # owners (b, c) over d; (b, d) over c; (c d) over b
        kbc += torch.einsum("nbcd,nd->nbc", S, Dad[:, a])
        xac = torch.einsum("nbcd,nbd->nbc", S, Dbd)
        xab = torch.einsum("nbcd,ncd->nbc", S, Dcd)
        kbd += torch.einsum("nbcd,nc->nbd", S, Dac[:, a])
        xad = torch.einsum("nbcd,nbc->nbd", S, Dbc)
        jcd += torch.einsum("nbcd,nb->ncd", S, Dab[:, a])
        # k_ac[a], k_ad[a], j_ab[a]: complete with the slab
        row = ia[:, a:a + 1]
        add(K, row, ic, wn * xac.sum(1)[:, None, :])
        add(K, row, idd, wn * xad.sum(1)[:, None, :])
        add(J, row, ib, 2.0 * wn * xab.sum(2)[:, None, :])
    add(K, ib, ic, wn * kbc)
    add(K, ib, idd, wn * kbd)
    add(J, ic, idd, 2.0 * wn * jcd)
    return adds


@lru_cache(maxsize=None)
def _k6_cases(nblk: int = 6):
    """The first nblk in-core quartets of every g class pair of the water
    on K6's block route: (class pair, batch, blocks [nblk, nab, ncd]), and
    the water's class pairs."""
    prim, _ = _water()
    groups = fock.ScreenedDirectFock(prim, incore=False, device="cpu").groups
    out, seen = [], []
    for b in groups:
        cls = (b.bra.la, b.bra.lb, b.ket.la, b.ket.lb)
        seen.append(cls)
        if kernels.digest_route(*cls) != "block":
            continue
        sb, sk = b.sel_bra[:nblk], b.sel_ket[:nblk]
        out.append((cls, b, sb, sk, b.weight[:nblk],
                    eri.eri4c_plain(b.bra, b.ket, sb, sk)))
    return prim, out, seen


def _flat(off1, n1, off2, n2, nbf):
    u = off1[:, None] + np.arange(n1)[None, :]
    v = off2[:, None] + np.arange(n2)[None, :]
    return (u[:, :, None] * nbf + v[:, None, :]).reshape(len(off1), -1)


def test_k6_block_walk_matches_plain_and_jax_on_every_block_class_pair():
    """Each class pair's walk within 1e-12 x max(|J|, |K|) of
    ``digest_plain`` (a class pair zero by symmetry within 1e-15), one add
    an output a block; the walks of all of them within 1e-12 of the JAX
    digestion of the same blocks (one jitted program over the class
    pairs: one compile)."""
    prim, cases, seen = _k6_cases()
    nbf = prim.nbf
    # every class pair of the water on the block route, (gg|gg) among them
    assert [c for c, *_ in cases] == [c for c in seen
                                      if c in kernels.DIGEST_BLOCK]
    assert len(cases) > 10 and (4, 4, 4, 4) in {c for c, *_ in cases}
    rng = np.random.default_rng(7)
    X = rng.normal(size=(nbf, nbf))
    D = torch.as_tensor(X + X.T).contiguous()
    total = torch.zeros((2, nbf, nbf), dtype=torch.float64)
    bodies, args = [], []
    for cls, b, sb, sk, w, I in cases:
        JK, ref = (torch.zeros((2, nbf, nbf), dtype=torch.float64)
                   for _ in range(2))
        adds = k6_block_walk(JK, I, w, D, b.bra, b.ket, sb, sk)
        fock.digest_plain(ref, I, w, D, b.bra, b.ket, sb, sk)
        na, nb, nc, nd = map(ncart, cls)
        nout = (na * nb + nc * nd + na * nc + na * nd + nb * nc + nb * nd)
        assert adds == nout, cls        # one add an output a block
        scale = float(ref.abs().max())
        bound = 1e-12 * scale if scale > 1e-8 else 1e-15
        assert float((JK - ref).abs().max()) <= bound, cls
        total += JK
        mb, mk = b.bra.meta[sb].long().numpy(), b.ket.meta[sk].long().numpy()
        oa, ob, oc, od = mb[:, 0], mb[:, 1], mk[:, 0], mk[:, 1]
        idx = [_flat(*x, nbf) for x in (
            (oa, na, ob, nb), (oc, nc, od, nd), (oa, na, oc, nc),
            (oa, na, od, nd), (ob, nb, oc, nc), (ob, nb, od, nd))]
        bodies.append(_make_digest_body(*cls, nbf))
        args.append((jnp.asarray(I.numpy()), jnp.asarray(w.numpy()),
                     *map(jnp.asarray, idx)))

    def digest_all(Jw, Kw, Dj, args):
        for f, (I, w, *idx) in zip(bodies, args):
            Jw, Kw = f(Jw, Kw, I, w, Dj, *idx)
        return Jw, Kw

    Jw, Kw = jax.jit(digest_all)(jnp.zeros(nbf * nbf), jnp.zeros(nbf * nbf),
                                 jnp.asarray(D.numpy()), args)
    jax_ref = np.stack([np.asarray(Jw), np.asarray(Kw)]).reshape(2, nbf, nbf)
    assert np.abs(total.numpy() - jax_ref).max() <= \
        1e-12 * np.abs(jax_ref).max()


@pytest.mark.parametrize("cls", sorted(kernels.DIGEST_BLOCK))
def test_k6_block_ring_holds_each_slab(cls):
    """Each slab lands whole in its stage from either alignment, within the
    stage, and the CTA fits the card's shared memory."""
    slab, stage, doubles = _block_doubles(cls)
    nth = DIGEST_THREADS
    for off in (0, 1):
        got = _stage_targets(slab, off, nth)
        assert set(range(off, off + slab)) <= got
        assert max(got) < stage and stage % 2 == 0
        # past the slab only the zero-filled half of the last copy
        assert len(got - set(range(off, off + slab))) <= 1
    assert 8 * doubles <= SMEM_MAX
    # a thread's owners: k_bc, k_bd and j_cd sums in registers
    na, nb, nc, nd = map(ncart, cls)
    assert max(nb * nc, nb * nd, nc * nd) <= 2 * nth


# --------------------------------------------------------- K1 T1 body

def _t1_smem(cls, K2: int, Kq: int, QT: int) -> int:
    """Doubles of one T1-body block (Eri3cT1Smem)."""
    la, lb, lq = cls
    nab, ncq = ncart(la) * ncart(lb), ncart(lq)
    nhb, nhq, L = nherm(la + lb), nherm(lq), la + lb + lq
    fm = (nab + 15) // 16
    k4 = (K2 * nhb + 3) // 4 * 4
    f = fm
    if 8 * k4 * (16 * fm + 4) > 80 * 1024:   # eri3c_ftile
        while f > 1 and 8 * k4 * (16 * f + 4) > 48 * 1024:
            f -= 1
    lda = 16 * f + 4
    ldb = (QT * ncq + 7) // 8 * 8 + 4
    k4q = (Kq * nhq + 3) // 4 * 4
    lde = (ncq + 15) // 16 * 16 + 4
    nprim = K2 * QT * Kq
    ne = (la + 1) * (lb + 1) * (la + lb + 1)
    B = 4 * K2 + 3 * K2 * ne
    scratch = nprim * (nherm(L - 1) + L + 5)
    R = B + max(k4 * ldb, scratch)
    end = max(R + nprim * nherm(L) + QT * k4q * lde, R + k4 * lda)
    return end + (nherm(L) + 2 * k4q + 1) // 2


def _t1_tile(cls, K2: int, Kq: int) -> int:
    qt = 8
    while qt > 1 and 8 * _t1_smem(cls, K2, Kq, qt) > T1_CAP:
        qt //= 2
    return qt


def _herm_triples(L: int) -> np.ndarray:
    """[nherm(L), 3] (t, u, v) in csrc's order (herm_triple)."""
    out = []
    for s in range(L + 1):
        for uv in range(s + 1):
            for v in range(uv + 1):
                out.append((s - uv, uv - v, v))
    return np.asarray(out)


def _hidx(t, u, v):
    s, d = t + u + v, u + v
    return s * (s + 1) * (s + 2) // 6 + d * (d + 1) // 2 + v


def r_levels(G: np.ndarray, Q: np.ndarray, L: int) -> np.ndarray:
    """block_r_levels over products [f]: G [f, L+1], Q [f, 3] (X, Y, Z) ->
    R [f, nherm(L)], level by level through an even and an odd buffer."""
    tri = _herm_triples(L)
    nf = G.shape[0]
    even = np.zeros((nf, nherm(L)))
    odd = np.zeros((nf, nherm(L - 1)))
    for n in range(L, -1, -1):
        dst, src = (even, odd) if n % 2 == 0 else (odd, even)
        nl = nherm(L - n)
        new = np.empty((nf, nl))
        new[:, 0] = G[:, n]
        for h in range(1, nl):
            t, u, v = tri[h]
            ax, k = (0, t) if t > 0 else ((1, u) if u > 0 else (2, v))
            lo = [t, u, v]
            lo[ax] -= 1
            hi = src[:, _hidx(*lo)]
            val = Q[:, ax] * hi
            if k >= 2:
                lo[ax] -= 1
                val = (k - 1) * src[:, _hidx(*lo)] + val
            new[:, h] = val
        dst[:, :nl] = new
    return even


def k1_t1_walk(out, bra, aux, cols, cols_t, mirror) -> int:
    """Plain walk of K1's T1 body for one class into out [A, width];
    returns QT."""
    la, lb, lq = bra.la, bra.lb, aux.lq
    Kq, ncq, nq = aux.Kq, ncart(lq), aux.nq
    nhb, nhq, L = nherm(la + lb), nherm(lq), la + lb + lq
    nab = ncart(la) * ncart(lb)
    QT = _t1_tile((la, lb, lq), bra.Ka * bra.Kb, Kq)
    aexp, bexp, acoef, bcoef, A, B = bra.columns(slice(None))
    Eab, p, P = bra_hermite(la, lb, aexp, bexp, acoef, bcoef, A, B)
    Eab, p, P = Eab.numpy(), p.numpy(), P.numpy()
    table, kq = aux.table.numpy(), aux.kq.numpy()
    ecd = aux.ecd.numpy()
    tri_all = _herm_triples(L)
    # MGather's k index kk = (r, g): r's R offset, g's (order, u+v, v)
    kk = np.arange(Kq * nhq)
    r_of, g_of = kk // nhq, kk % nhq
    gt = _herm_triples(lq)[g_of]
    meta = bra.meta.numpy()
    for pi in range(bra.n):
        # the live primitive pairs k = (i, j), i < ka, j < kb (each shell's
        # nonzero primitives first), as pair_prim enumerates them
        ka, kb = meta[pi, 2], meta[pi, 3]
        k2 = ka * kb
        ks = (np.arange(k2) // kb) * bra.Kb + np.arange(k2) % kb
        assert (acoef[pi, :ka] != 0).all() and (bcoef[pi, :kb] != 0).all()
        for q0 in range(0, nq, QT):
            # products f = (k QT + qi) Kq + r, zero past the class's shells
            # and each shell's live primitives
            f = np.arange(k2 * QT * Kq)
            r, qi, k = f % Kq, (f // Kq) % QT, f // (Kq * QT)
            q = q0 + qi
            ok = (q < nq) & (r < kq[np.minimum(q, nq - 1)])
            qs = np.minimum(q, nq - 1)
            qe = table[qs, r]
            Qc = table[qs, 2 * Kq:2 * Kq + 3]
            XYZ = P[pi, ks[k]] - Qc
            pe = p[pi, ks[k]]
            qe = np.where(ok, qe, 1.0)
            psum = pe + qe
            alpha = pe * qe / psum
            T = alpha * (XYZ ** 2).sum(1)
            pref = TWO_PI_POW_2_5 / (pe * qe * np.sqrt(psum))
            F = boys(torch.as_tensor(T), L).numpy()
            G = F * pref[:, None] * (-2.0 * alpha[:, None]) ** np.arange(L + 1)
            G[~ok] = 0.0
            XYZ[~ok] = 0.0
            R = r_levels(G, XYZ, L).reshape(k2, QT, Kq, -1)
            for j in range(QT):
                if q0 + j >= nq:
                    continue
                # M[(k,h)][(r,g)] = R_{k,j,r}[h + g] (MGather)
                ht = tri_all[:nhb]
                s = ht.sum(1)[:, None] + gt.sum(1)[None, :]
                d = (ht[:, 1] + ht[:, 2])[:, None] + (gt[:, 1] + gt[:, 2])[None, :]
                v = ht[:, 2][:, None] + gt[:, 2][None, :]
                idx = s * (s + 1) * (s + 2) // 6 + d * (d + 1) // 2 + v
                M = R[:, j][:, r_of[None, :], idx]       # [k2, nhb, Kq nhq]
                Ec = ecd[q0 + j].reshape(Kq, ncq, nhq).transpose(0, 2, 1) \
                    .reshape(Kq * nhq, ncq)
                T1 = M @ Ec                               # [k2, nhb, ncq]
                blk = torch.as_tensor(
                    np.einsum("kah,khc->ca", Eab[pi, ks], T1))
                rows = aux.qrow[q0 + j] + torch.arange(ncq)
                out[rows[:, None], cols[pi][None, :]] = blk
                if mirror[pi]:
                    out[rows[:, None], cols_t[pi][None, :]] = blk
    assert nab == Eab.shape[2]
    return QT


@lru_cache(maxsize=None)
def _k1_system():
    register_g()
    prim, aux = _water()
    mol = jx.molecule.from_input_dict(WATER)
    jprim = jx.basis.build(mol, G_BASIS)
    jaux = jx.basis.build_auxiliary(mol, "cc-pVTZ-JKFIT", G_BASIS)
    return prim, aux, jprim, jaux


@pytest.mark.parametrize("la", range(5))
def test_k1_t1_walk_matches_plain_and_jax_on_the_g_classes(la):
    prim, aux, jprim, jaux = _k1_system()
    nbf, A = prim.nbf, aux.nbf
    blk = next(b for b in unique_pair_blocks(prim)
               if (b.la, b.lb) == (la, 4))
    kp = eri3c.k1_pairs(blk, lambda ia, ib: ia * nbf + ib, "cpu")
    jblk = next(b for b in jx_blocks(jprim) if (b.la, b.lb) == (la, 4))
    jax_ref = np.asarray(jx_eri3c._three_center_host(
        jprim, jaux, [jblk], None, None)).reshape(A, nbf * nbf)
    on_t1 = nonzero = 0
    for at in eri3c.aux_tables(aux, "cpu"):
        cls = (la, 4, at.lq)
        if kernels.eri3c_body(*cls) != "t1":
            continue
        on_t1 += 1
        ref = torch.zeros((A, nbf * nbf), dtype=torch.float64)
        eri3c.eri3c_class_plain(ref, kp.table, at, kp.cols, kp.cols_t,
                                kp.mirror)
        got = torch.zeros_like(ref)
        QT = k1_t1_walk(got, kp.table, at, kp.cols, kp.cols_t, kp.mirror)
        assert 8 * _t1_smem(cls, kp.table.Ka * kp.table.Kb, at.Kq, QT) \
            <= SMEM_MAX
        rows = (at.qrow[:, None] + torch.arange(ncart(at.lq))[None]).reshape(-1)
        # a class zero by symmetry (every pair and aux shell on O, odd in
        # total) is held to 1e-15
        scale = float(ref[rows].abs().max())
        bound = 1e-12 * scale if scale > 1e-8 else 1e-15
        assert float((got - ref).abs().max()) <= bound, cls
        assert np.abs(got.numpy()[rows.numpy()]
                      - jax_ref[rows.numpy()]).max() <= bound, cls
        nonzero += scale > 1e-8
    assert on_t1 == sum(1 for c in kernels.ERI3C_T1 if c[:2] == (la, 4))
    assert nonzero >= on_t1 // 2


# --------------------------------------------------------- route tables

def _masks(flags, name, n=15):
    assert len(flags) == n, flags
    m = [re.fullmatch(rf"-D{name}_B{i}=(0x[0-9a-f]+)", f)
         for i, f in enumerate(flags)]
    assert all(m), flags
    return [int(x.group(1), 16) for x in m]


def test_k6_block_table_matches_the_build_and_csrc(monkeypatch):
    masks = _masks(kernels.digest_route_flags(), "JC_DIGEST_BLOCK_MASK")
    pcs = eri.PAIR_CLASSES
    on_block = set()
    for i, j in itertools.combinations_with_replacement(range(15), 2):
        cls = (*pcs[i], *pcs[j])
        route = kernels.digest_route(*cls)
        assert ((masks[i] >> j) & 1) == (route == "block"), cls
        if route == "block":
            on_block.add(cls)
            assert 4 in cls, cls            # the g class pairs only
    assert on_block == kernels.DIGEST_BLOCK
    # a block whose block and D blocks pass the warp route's stage takes
    # the block route (the warp route's static_assert)
    cap = _csrc_int("eri4c.cuh", r"constexpr size_t kDigestWarpCap = "
                    r"(\d+) \* 1024;") * 1024
    for i, j in itertools.combinations_with_replacement(range(15), 2):
        cls = (*pcs[i], *pcs[j])
        na, nb, nc, nd = map(ncart, cls)
        ndg = nc * nd + na * nb + nb * nd + nb * nc + na * nd + na * nc
        if 8 * (na * nb * nc * nd + ndg) > cap:
            assert cls in kernels.DIGEST_BLOCK, cls
    # the build is keyed by the table: another table, another library
    before = kernels._digest()
    monkeypatch.setattr(kernels, "DIGEST_BLOCK",
                        kernels.DIGEST_BLOCK - {(4, 4, 4, 4)})
    assert kernels._digest() != before


def test_k1_t1_table_matches_the_build_and_csrc(monkeypatch):
    masks = _masks(kernels.eri3c_t1_flags(), "JC_ERI3C_T1_MASK")
    for (i, (la, lb)), lq in itertools.product(
            enumerate(kernels.ERI3C_BRAS), range(5)):
        body = kernels.eri3c_body(la, lb, lq)
        assert ((masks[i] >> lq) & 1) == (body == "t1"), (la, lb, lq)
        assert body == (None if kernels.eri3c_route(la, lb, lq) == "lane"
                        else "t1" if (la, lb, lq) in kernels.ERI3C_T1
                        else "thread")
    # the T1 body runs only on block-route g classes (its bra Hermite rows
    # fill whole m16 fragments: nherm(la + lb) >= 16)
    assert all(c[1] == 4 and kernels.eri3c_route(*c) == "block"
               and nherm(c[0] + c[1]) >= 16 for c in kernels.ERI3C_T1)
    # the build is keyed by the table: another table, another library
    before = kernels._digest()
    monkeypatch.setattr(kernels, "ERI3C_T1", kernels.ERI3C_T1 - {(4, 4, 4)})
    assert kernels._digest() != before
