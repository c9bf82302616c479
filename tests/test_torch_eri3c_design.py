"""The design of K1 (csrc/eri3c.cuh) on the CPU: the pieces the card runs
that a plain version can mirror.

- The nonzero-first packing (``eri3c.k1_pairs`` on ``eri.pair_table``, the
  pairs sorted by their first output column; ``eri3c.aux_table`` with the
  aux expansion built once): the plain version reading it against the JAX
  package's host 3-center builder and its metric, per (pair class | aux
  class), within 1e-12 x the class's max-abs (1e-15 for a class that is
  zero by symmetry): only the summation order changes.  Water in 6-31+G* /
  cc-pVTZ-JKFIT (the (ss) class mixes O 1s of 6 primitives with H s of 3
  and 1), dense and packed; benzene_2_water in 6-311++G(2d,2p) /
  cc-pVTZ-JKFIT on the first pairs of every pair class, packed.  The plain
  version evaluates the Boys function for the live primitive products only,
  as many as the packing's counts give K1 to walk.
- K1's route table of ``ops/kernels.py`` against the ``-D`` flags the
  build passes (one bit mask a bra class, bit lq, over the 75 classes to
  (gg|g)) and the macros of csrc/ that read them.
- A plain walk of the kernels' thread -> (pair, aux shell, component) maps
  (lane route; block route with its DMMA fragments, at aux tiles of 1 to
  8 shells) over water's sorted pairs: every (row, column) target,
  the mirror's too, written exactly once, and the lanes of a warp on
  increasing columns.
"""

import itertools
import re
from functools import lru_cache

import numpy as np
import pytest

import juliachem_jl_tpu as jx
from juliachem_jl_tpu.ops import eri3c as jx_eri3c
from juliachem_jl_tpu.ops.pairs import unique_pair_blocks as jx_blocks
from juliachem_jl_tpu_torch import interop
from juliachem_jl_tpu_torch.basis.structs import ncart
from juliachem_jl_tpu_torch.models.df_screened import build_packed_screen
from juliachem_jl_tpu_torch.ops import eri3c, kernels
from tests._torch_parity import CPU, WATER, np_

CSRC = kernels.CSRC_DIR
# threads a K1 block (both routes), as csrc/eri3c.cuh builds it
THREADS = int(re.search(r"constexpr int kEri3cThreads = (\d+);",
                        (CSRC / "eri3c.cuh").read_text()).group(1))
BENZENE_2_WATER = "benzene_2_water"


@lru_cache(maxsize=None)
def _jax_system(name: str):
    if name == "water":
        mol = jx.molecule.from_input_dict(WATER)
        prim = jx.basis.build(mol, "6-31+G*")
        return prim, jx.basis.build_auxiliary(mol, "cc-pVTZ-JKFIT", "6-31+G*")
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    golden = json.loads((root / "tests" / "data" /
                         "s22x3_gamess_goldens.json").read_text())[name]
    bohr = 0.52917724924
    mol = jx.molecule.from_input_dict(
        {"symbols": [a["symbol"] for a in golden["atoms"]],
         "geometry": [x * bohr for a in golden["atoms"]
                      for x in a["xyz_bohr"]],
         "molecular_charge": 0})
    prim = jx.basis.build(mol, golden["basis"])
    return prim, jx.basis.build_auxiliary(mol, "cc-pVTZ-JKFIT",
                                          golden["basis"])


def _class_rows(aux, lq):
    cl = aux.classes[lq]
    return (cl.offsets[:, None] + np.arange(ncart(lq))[None]).ravel()


def _hold_per_class(got, ref, aux, what):
    for lq in aux.classes:
        rows = _class_rows(aux, lq)
        scale = max(float(np.abs(ref[rows]).max()), 1e-3)
        err = float(np.abs(got[rows] - ref[rows]).max())
        assert err <= 1e-12 * scale, (what, lq, err, scale)


def _first_pairs(blocks, n):
    return [b.select(np.arange(min(n, b.n))) for b in blocks]


@pytest.mark.parametrize("system,mode", [("water", "dense"),
                                         ("water", "packed"),
                                         (BENZENE_2_WATER, "packed")])
def test_k1_packing_plain_matches_jax_per_class(system, mode):
    jprim, jaux = _jax_system(system)
    tprim, taux = interop.basis(jprim), interop.basis(jaux)
    blocks = jx_blocks(jprim)
    if system != "water":
        blocks = _first_pairs(blocks, 6)
    for blk in blocks:
        tblk = interop.pair_blocks([blk])
        if mode == "dense":
            ref = np.asarray(jx_eri3c._three_center_host(
                jprim, jaux, [blk], None, None)).reshape(jaux.nbf, -1)
            got = np_(eri3c.three_center_tensor(tprim, taux, CPU, tblk)
                      ).reshape(jaux.nbf, -1)
        else:
            screen = build_packed_screen(tprim, tblk)
            w = screen.npq + 1
            ref = np.asarray(jx_eri3c._three_center_host(
                jprim, jaux, [blk], screen.col_map, w))
            got = np_(eri3c.three_center_tensor(
                tprim, taux, CPU, tblk, col_map=screen.col_map,
                packed_width=w))
        _hold_per_class(got, ref, jaux, (blk.la, blk.lb))


def test_k1_metric_plain_matches_jax_per_class():
    _, jaux = _jax_system("water")
    got = np_(eri3c.two_center_metric(interop.basis(jaux), CPU))
    ref = np.asarray(jx_eri3c.two_center_metric(jaux))
    for lp in jaux.classes:
        cols = _class_rows(jaux, lp)
        _hold_per_class(got[:, cols], ref[:, cols], jaux, ("metric", lp))


def test_k1_walks_the_live_primitive_products_only(monkeypatch):
    """The packing's counts (meta's nonzero primitives of a and b, the aux
    kq) give the primitive products K1 walks: the nonzero ones of the
    padded blocks, and the plain version evaluates Boys for exactly those."""
    jprim, jaux = _jax_system("water")
    tprim, taux = interop.basis(jprim), interop.basis(jaux)
    auxs = eri3c.aux_tables(taux, CPU)
    walked = real = padded = 0
    for blk in interop.pair_blocks(jx_blocks(jprim)):
        meta = eri3c.k1_pairs(blk, lambda ia, ib: ia * tprim.nbf + ib,
                              CPU).table.meta
        kp = int((meta[:, 2] * meta[:, 3]).sum())
        live = int(((blk.acoef != 0)[:, :, None]
                    & (blk.bcoef != 0)[:, None, :]).sum())
        for a in auxs:
            walked += kp * int(a.kq.sum())
            real += live * int((a.table[:, a.Kq:2 * a.Kq] != 0).sum())
            padded += blk.n * blk.aexp.shape[1] * blk.bexp.shape[1] \
                * a.nq * a.Kq
    assert walked == real < padded
    seen = []
    real_boys = eri3c.boys
    monkeypatch.setattr(eri3c, "boys",
                        lambda T, L: seen.append(T.numel()) or real_boys(T, L))
    eri3c.three_center_tensor(tprim, taux, CPU)
    assert sum(seen) == walked


def _masks(flags, name):
    """The route masks of the -D<name>_B<i>=0x.. flags: one a bra, in
    order."""
    m = [re.fullmatch(rf"-D{name}_B{i}=(0x[0-9a-f]+)", f)
         for i, f in enumerate(flags)]
    assert all(m), flags
    return [int(x.group(1), 16) for x in m]


def test_k1_route_table_matches_the_build_and_csrc():
    flags = kernels.eri3c_route_flags()
    lane = _masks(flags, "JC_ERI3C_LANE_MASK")
    assert len(flags) == 15, flags
    head = (CSRC / "eri3c.cuh").read_text()
    assert "#ifndef JC_ERI3C_LANE_MASK_B14" in head
    assert re.search(r"constexpr unsigned kEri3cLaneMasks\[15\] = \{\s+"
                     + r",\s+".join(f"JC_ERI3C_LANE_MASK_B{i}"
                                    for i in range(15)) + r"\};", head)
    assert ("static constexpr bool kLane = (kEri3cLaneMasks[eri3c_bra(LA, "
            "LB)] >> LQ) & 1;") in head
    assert re.search(r"return lb <= 2 \? la \* 3 - la \* \(la - 1\) / 2 \+ "
                     r"\(lb - la\) : \(lb == 3 \? 6 \+ la : 10 \+ la\);",
                     head)

    def eri3c_bra(la, lb):   # csrc/eri3c.cuh
        return (la * 3 - la * (la - 1) // 2 + (lb - la) if lb <= 2
                else (6 + la if lb == 3 else 10 + la))

    assert [eri3c_bra(*b) for b in kernels.ERI3C_BRAS] == list(range(15))
    assert len(lane) == 15
    # the route of each class is the table's, in the mask and bit the csrc
    # reads
    for (i, (la, lb)), lq in itertools.product(
            enumerate(kernels.ERI3C_BRAS), range(5)):
        route = kernels.eri3c_route(la, lb, lq)
        assert (lane[i] >> lq) & 1 == (route == "lane"), (la, lb, lq)
        wide = ncart(la) * ncart(lb) >= kernels.ERI3C_WIDE_NAB
        cut = (kernels.ERI3C_LANE_MAX_L_WIDE if wide
               else kernels.ERI3C_LANE_MAX_L)
        on_lane = (la + lb + lq <= cut
                   and (la, lb, lq) not in kernels.ERI3C_LANE_EXCLUDE)
        assert route == ("lane" if on_lane else "block"), (la, lb, lq)
    assert all(m < 1 << 5 for m in lane)
    assert {(la, lb, lq) for la, lb in kernels.ERI3C_BRAS
            for lq in range(5)} == set(eri3c.KERNEL_CLASSES)
    # every class of L <= 4 runs one (pair, aux shell) a thread
    assert all(kernels.eri3c_route(*c) == "lane"
               for c in eri3c.KERNEL_CLASSES if sum(c) <= 4)
    launch = (CSRC / "eri3c_launch.cuh").read_text()
    # the launch and the geometry each take the route of their class
    assert len(re.findall(r"if constexpr \(Eri3cClass<LA, LB, LQ>::kLane\)",
                          launch)) == 1
    assert len(re.findall(r"using K = Eri3cClass<LA, LB, LQ>;\n.*\n.*\n"
                          r"  if constexpr \(K::kLane\)", launch)) == 1
    assert "constexpr int kEri3cThreads = 128;" in head
    assert "constexpr size_t kEri3cBlockCap = 100 * 1024;" in head
    # the build hashes and passes the table to every source
    src = (kernels.PKG_DIR / "ops" / "kernels.py").read_text()
    assert "*NVCC_FLAGS, *route_flags(), *eri3c_route_flags()," in src
    assert "*eri3c_route_flags())).encode())" in src
    assert not set(flags) & set(kernels.NVCC_FLAGS)


# ------------------------------------------------- thread -> target maps

def lane_map(n, nq, nab, ncq):
    """(p, q, ab, c) stored by eri3c_lane_kernel: warp w = 4 blockIdx +
    threadIdx / 32 takes aux shell w % nq and the pairs 32 (w / nq) + lane;
    each thread stores its whole block."""
    warps = -(-n // 32) * nq
    t = np.arange(-(-warps // 4) * THREADS)
    w = t // 32
    q, p = w % nq, (w // nq) * 32 + t % 32
    keep = p < n
    p, q = p[keep], q[keep]
    ab, c = np.meshgrid(np.arange(nab), np.arange(ncq), indexing="ij")
    return (np.repeat(p, nab * ncq), np.repeat(q, nab * ncq),
            np.tile(ab.ravel(), len(p)), np.tile(c.ravel(), len(p)))


def _blocks(n, nq, QT):
    nqt = -(-nq // QT)
    b = np.arange(n * nqt)
    return b // nqt, (b % nqt) * QT


def block_map(n, nq, nab, ncq, QT):
    """eri3c_block_kernel's DMMA product: warp w the n8 fragments fv = w,
    w + 4, .. of every m16 row fu; lane (g, t) = (lane / 4, lane % 4) holds
    element e at row ab = 16 fu + g + 8 (e / 2), column nn = 8 fv + 2 t +
    e % 2 (csrc/dmma.cuh)."""
    p, q0 = _blocks(n, nq, QT)
    FM, Np = -(-nab // 16), -(-QT * ncq // 8) * 8
    rows, cols = [], []
    for warp in range(THREADS // 32):
        for fv in range(warp, Np // 8, THREADS // 32):
            for lane, fu, e in itertools.product(range(32), range(FM),
                                                 range(4)):
                rows.append(16 * fu + lane // 4 + 8 * (e // 2))
                cols.append(8 * fv + 2 * (lane % 4) + e % 2)
    ab, nn = np.array(rows), np.array(cols)
    P, Q, AB, C = np.broadcast_arrays(
        p[:, None], q0[:, None] + (nn // ncq)[None], ab[None],
        (nn % ncq)[None])
    keep = (AB < nab) & (nn[None] < QT * ncq) & (Q < nq)
    return P[keep], Q[keep], AB[keep], C[keep]


@lru_cache(maxsize=None)
def _water_k1():
    jprim, jaux = _jax_system("water")
    prim, aux = interop.basis(jprim), interop.basis(jaux)
    auxs = eri3c.aux_tables(aux, CPU)
    nbf = prim.nbf
    classes = [(eri3c.k1_pairs(b, lambda ia, ib: ia * nbf + ib, CPU),
                nbf * nbf) for b in eri3c.unique_pair_blocks(prim)]
    classes += [(eri3c.k1_pairs(b, lambda ia, ib: ib, CPU), aux.nbf)
                for b in eri3c.aux_unit_blocks(aux)]
    return classes, auxs, aux.nbf


@pytest.mark.parametrize("route,QT", [("lane", 1), ("block", 1),
                                      ("block", 2), ("block", 4),
                                      ("block", 8)])
def test_k1_thread_maps_write_every_target_once(route, QT):
    classes, auxs, A = _water_k1()
    for kp, width in classes:
        bra = kp.table
        nab = ncart(bra.la) * ncart(bra.lb)
        cols, cols_t = np_(kp.cols), np_(kp.cols_t)
        mirror = np_(kp.mirror).astype(bool)
        # the sort: neighbouring pairs (a warp's lanes) on increasing columns
        assert (np.diff(cols[:, 0]) > 0).all()
        for at in auxs:
            ncq, nq = ncart(at.lq), at.nq
            if route == "lane":
                p, q, ab, c = lane_map(bra.n, nq, nab, ncq)
            else:
                p, q, ab, c = block_map(bra.n, nq, nab, ncq, QT)
            row = np_(at.qrow)[q] + c
            tgt = np.concatenate([row * width + cols[p, ab],
                                  (row * width + cols_t[p, ab])[mirror[p]]])
            want = (bra.n + int(mirror.sum())) * nab * nq * ncq
            uniq, counts = np.unique(tgt, return_counts=True)
            assert len(tgt) == want and (counts == 1).all(), \
                (route, QT, bra.la, bra.lb, at.lq)
            assert uniq.max() < A * width

