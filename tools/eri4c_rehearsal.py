#!/usr/bin/env python3
"""Rehearse K4/K5/K6 (csrc/eri4c.cuh) on the CPU before a chip call.

    python3 tools/eri4c_rehearsal.py [--cut 3 6] [--basis 6-311++G(2d,2p)]
                                     [--warp-cap BYTES] [--quartets N]
                                     [--only-l L] [--k6-only]

Compiles the device code with g++ (C++20) against a CPU stand-in for the
CUDA builtins (tools/eri4c_rehearsal/: one std::thread per CUDA thread,
barriers for __syncwarp and the shuffles, the launch geometry of
eri4c_launch.cuh), once per lane-route cut (``kernels.ERI4C_LANE_MAX_L``,
the route table's exclusions kept), into
juliachem_jl_tpu_torch/_build/rehearsal/.  Then, on water in the basis, for
every class pair of the Schwarz staircase: K4 on the staircase's quartets
against ``eri4c_plain``; K5 in staircase mode over the whole range and
over three ranges whose starts are not multiples of 32, and in list mode
over ScreenedDirectFock's batches, against the plain versions; K6 on the
list batches against ``digest_plain``, each class pair on its route as
built (lane, block or warp), then from the second block of each batch
(blocks 8 bytes off a 16-byte boundary) and on its first 45 blocks.
Bounds: K4
1e-12 x max |I|, J/K
1e-11 x max(|J|, |K|), the card's gates.  Prints each error, exits 1 if
one is over its bound.  Classes up to (dd|dd), and the f class pairs when
the basis has f shells (harness.cpp's lists); ``--warp-cap`` builds the
warp route with a smaller tile cap, so that its ket tiles run on classes
the basis has.  The block route (one quartet a block, its products on
the emulated DMMA step) runs where the route table of ops/kernels.py puts
it, its shared memory held to the card's 227 KB; ``--quartets N`` takes
the first N quartets of each class pair's staircase and of each list
batch (a block of 256 threads a quartet is slow to emulate), ``--only-l``
only the class pairs that hold a shell of that angular momentum,
``--k6-only`` K6 alone, ``--k6-block-all`` K6's block route on every
class pair off its lane route.  The numbers say nothing of the card's
speed.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from juliachem_jl_tpu_torch import basis, molecule  # noqa: E402
from juliachem_jl_tpu_torch.ops import (eri, fock, fock_stream,  # noqa: E402
                                        kernels)

HERE = ROOT / "tools" / "eri4c_rehearsal"
CSRC = ROOT / "juliachem_jl_tpu_torch" / "csrc"
WATER = {"symbols": ["O", "H", "H"],
         "geometry": [0.0, 0.0, 0.116321, 0.0, 0.751155, -0.465285,
                      0.0, -0.751155, -0.465285]}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build(cut: int, warp_cap: int | None, with_f: bool,
          with_g: bool = False) -> ctypes.CDLL:
    """The harness with the route table of ops/kernels.py at this cut (and
    the warp route's tile cap, the f and g class pairs, where asked)."""
    out = ROOT / "juliachem_jl_tpu_torch" / "_build" / "rehearsal"
    out.mkdir(parents=True, exist_ok=True)
    tag = f"cut{cut}" + (f"_cap{warp_cap}" if warp_cap else "") + \
        f"_k6b{len(kernels.DIGEST_BLOCK)}" + \
        ("_f" if with_f else "") + ("_g" if with_g else "")
    so = out / f"eri4c_rehearsal_{tag}.so"
    kernels.ERI4C_LANE_MAX_L = cut
    extra = ([f"-DJC_ERI4C_WARP_CAP={warp_cap}"] if warp_cap else []) + \
        (["-DRH_WITH_F"] if with_f else []) + \
        (["-DRH_WITH_G"] if with_g else [])
    subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared",
                    "-pthread", *kernels.route_flags(),
                    *kernels.block_route_flags(),
                    f"-DJC_DIGEST_LANE_MAX_N={kernels.DIGEST_LANE_MAX_N}",
                    *kernels.digest_route_flags(), *extra,
                    "-I", str(HERE / "shim"), "-I", str(CSRC),
                    str(HERE / "harness.cpp"), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.rh_lane_mask.restype = ctypes.c_ulonglong
    lib.rh_lane_mask.argtypes = [_I]
    lib.rh_block_mask.restype = ctypes.c_ulonglong
    lib.rh_block_mask.argtypes = [_I]
    lib.rh_block_geometry.argtypes = [_I] * 8 + [_P]
    lib.rh_eri4c.argtypes = [_I] * 4 + [_P, _I, _I, _P, _P, _I, _I, _P, _P,
                                        _P, _LL, _P]
    lib.rh_eri4c_jk.argtypes = [_I] * 4 + [_P, _I, _I, _P, _P, _I, _I, _P,
                                           _P, _P, _P, _P, _LL, _I, _LL, _LL,
                                           _P, _LL, _P]
    lib.rh_digest_jk.argtypes = [_I] * 4 + [_P, _P, _P, _P, _P, _LL, _P, _P,
                                            _LL, _P]
    lib.rh_digest_lane.argtypes = [_I] * 4
    return lib


def ptr(t):
    return None if t is None else t.data_ptr()


def k4(lib, bra, ket, r, c):
    nab = eri.ncart(bra.la) * eri.ncart(bra.lb)
    ncd = eri.ncart(ket.la) * eri.ncart(ket.lb)
    out = torch.full((len(r), nab, ncd), float("nan"), dtype=torch.float64)
    rc = lib.rh_eri4c(bra.la, bra.lb, ket.la, ket.lb, ptr(bra.pair), bra.Ka,
                      bra.Kb, ptr(bra.meta), ptr(ket.pair), ket.Ka, ket.Kb,
                      ptr(ket.meta), ptr(r), ptr(c), len(r), ptr(out))
    assert rc == 0, rc
    return out


def k5(lib, JK, D, bra, ket, n, sel_bra=None, sel_ket=None, weight=None,
       cum=None, same=False, t0=0):
    rc = lib.rh_eri4c_jk(bra.la, bra.lb, ket.la, ket.lb, ptr(bra.pair),
                         bra.Ka, bra.Kb, ptr(bra.meta), ptr(ket.pair), ket.Ka,
                         ket.Kb, ptr(ket.meta), ptr(sel_bra), ptr(sel_ket),
                         ptr(weight), ptr(cum),
                         0 if cum is None else cum.shape[0], int(same), n, t0,
                         ptr(D), D.shape[0], ptr(JK))
    assert rc == 0, rc


def k6(lib, JK, D, g, I, sel):
    """K6 on the quartets ``sel`` of batch g (blocks I[sel], which may
    start 8 bytes off a 16-byte boundary), on the route of its class pair
    as built."""
    sb, sk, w = (t[sel].contiguous() for t in (g.sel_bra, g.sel_ket,
                                                g.weight))
    rc = lib.rh_digest_jk(g.bra.la, g.bra.lb, g.ket.la, g.ket.lb,
                          ptr(g.bra.meta), ptr(g.ket.meta), ptr(sb), ptr(sk),
                          ptr(w), sb.shape[0], ptr(I), ptr(D), D.shape[0],
                          ptr(JK))
    assert rc == 0, rc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cut", type=int, nargs="+", default=[3, 6])
    ap.add_argument("--basis", default="6-311++G(2d,2p)")
    ap.add_argument("--basis-file", default=None,
                    help="a GAMESS-US basis file, registered as --basis "
                         "(tests/data/6-311ppG_3df_3pd_G.gbs: the g classes)")
    ap.add_argument("--quartets", type=int, default=None,
                    help="the first N quartets of each class pair")
    ap.add_argument("--only-l", type=int, default=None,
                    help="only the class pairs with a shell of this l")
    ap.add_argument("--k6-only", action="store_true",
                    help="K6 alone (K4 and K5 not run)")
    ap.add_argument("--k6-block-all", action="store_true",
                    help="K6's block route on every class pair off its "
                         "lane route (kernels.DIGEST_BLOCK)")
    ap.add_argument("--warp-cap", type=int, default=None,
                    help="bytes a warp-route quartet may take before its "
                         "kets are tiled (JC_ERI4C_WARP_CAP; small values "
                         "tile every warp-route class)")
    args = ap.parse_args()
    torch.set_num_threads(1)
    if args.k6_block_all:
        kernels.DIGEST_BLOCK = frozenset(
            (*a, *b) for a, b in itertools.combinations_with_replacement(
                eri.PAIR_CLASSES, 2))
    if args.basis_file:
        basis.register_basis_file(args.basis_file, args.basis)
    mol = molecule.from_input_dict(WATER)
    prim = basis.build(mol, args.basis)
    nbf = prim.nbf
    rng = np.random.default_rng(11)
    X = rng.normal(size=(nbf, nbf))
    D = torch.as_tensor(X + X.T).contiguous()
    sdf = fock_stream.StreamingDirectFock(prim, device="cpu")
    sdirect = fock.ScreenedDirectFock(prim, incore=False, device="cpu")
    with_f = any(3 in (b.table.la, b.table.lb) for b in sdf.blocks)
    with_g = any(4 in (b.table.la, b.table.lb) for b in sdf.blocks)
    if args.only_l is not None:
        # the harness's class lists of that momentum only (g++ minutes)
        with_f, with_g = with_f and args.only_l == 3, with_g and \
            args.only_l == 4
        def has_l(bra, ket):
            return args.only_l in (bra.la, bra.lb, ket.la, ket.lb)
        sdf.pairs = [cp for cp in sdf.pairs
                     if has_l(sdf.blocks[cp.bi].table, sdf.blocks[cp.ki].table)]
        sdirect.groups = [g for g in sdirect.groups if has_l(g.bra, g.ket)]
    if args.quartets is not None:
        for cp in sdf.pairs:
            cp.N = min(cp.N, args.quartets)
        for g in sdirect.groups:
            for k in ("sel_bra", "sel_ket", "weight"):
                setattr(g, k, getattr(g, k)[:args.quartets].contiguous())
    bad = 0

    def report(what, err, bound):
        nonlocal bad
        ok = err <= bound
        bad += not ok
        print(f"  {what}: max abs err {err:.3e} (bound {bound:.3e})"
              f"{'' if ok else '  <-- OVER'}", flush=True)

    def zeros():
        return torch.zeros((2, nbf, nbf), dtype=torch.float64)

    for cut in args.cut:
        lib = build(cut, args.warp_cap, with_f, with_g)
        masks = ",".join(f"{lib.rh_lane_mask(i):#x}"
                         for i in range(len(eri.PAIR_CLASSES)))
        bmasks = ",".join(f"{lib.rh_block_mask(i):#x}"
                          for i in range(len(eri.PAIR_CLASSES)))
        print(f"lane cut {cut} (route masks {masks}; block route masks "
              f"{bmasks}), warp cap {args.warp_cap or 'as built'}, water "
              f"{args.basis}, nbf {nbf}", flush=True)
        geo = (ctypes.c_longlong * 5)()
        for cp in sdf.pairs:
            bra, ket = sdf.blocks[cp.bi].table, sdf.blocks[cp.ki].table
            lib.rh_block_geometry(bra.la, bra.lb, ket.la, ket.lb, bra.Ka,
                                  bra.Kb, ket.Ka, ket.Kb, geo)
            if geo[2]:
                print(f"  block route ({bra.la}{bra.lb}|{ket.la}{ket.lb}): "
                      f"CT {geo[0]}, AT {geo[1]}, rounds of {geo[3]} x "
                      f"{geo[4]} primitive pairs, {geo[2]} B a block",
                      flush=True)
        # K4 on the staircase's quartets, each class pair
        worst, scale = 0.0, 0.0
        for cp in [] if args.k6_only else sdf.pairs:
            bra, ket = sdf.blocks[cp.bi].table, sdf.blocks[cp.ki].table
            t = torch.arange(cp.N, dtype=torch.int64)
            r, c, _ = fock_stream.decode_staircase(cp.cum, t, bra, ket,
                                                   cp.same)
            ref = eri.eri4c_plain(bra, ket, r, c)
            got = k4(lib, bra, ket, r, c)
            worst = max(worst, float((got - ref).abs().max()))
            scale = max(scale, float(ref.abs().max()))
        report(f"K4, {len(sdf.pairs)} class pairs", worst, 1e-12 * scale)
        # K5 staircase: whole ranges, then ranges from t0 % 32 != 0
        ref, got, split, plain_split = zeros(), zeros(), zeros(), zeros()
        for cp in [] if args.k6_only else sdf.pairs:
            bra, ket = sdf.blocks[cp.bi].table, sdf.blocks[cp.ki].table
            fock_stream.eri4c_jk_staircase_plain(ref, bra, ket, cp.cum, cp.N,
                                                 cp.same, D)
            k5(lib, got, D, bra, ket, cp.N, cum=cp.cum, same=cp.same)
            cuts = sorted({0, min(cp.N, 5), min(cp.N, 37 + cp.N // 3), cp.N})
            for a, b in zip(cuts, cuts[1:]):
                k5(lib, split, D, bra, ket, b - a, cum=cp.cum, same=cp.same,
                   t0=a)
                fock_stream.eri4c_jk_staircase_plain(plain_split, bra, ket,
                                                     cp.cum, b - a, cp.same,
                                                     D, t0=a)
        s = float(ref.abs().max())
        report("K5 staircase", float((got - ref).abs().max()), 1e-11 * s)
        report("K5 staircase from t0 (ranges split at 5 and 37 + N/3)",
               max(float((split - ref).abs().max()),
                   float((split - plain_split).abs().max())), 1e-11 * s)
        # K5 list mode and K6 over ScreenedDirectFock's batches, K6 on the
        # route of each class pair as built (held to kernels.digest_route)
        ref, got, got6 = zeros(), zeros(), zeros()
        routes = {}
        for g in sdirect.groups:
            n = g.sel_bra.shape[0]
            I = eri.eri4c_plain(g.bra, g.ket, g.sel_bra, g.sel_ket)
            fock.digest_plain(ref, I, g.weight, D, g.bra, g.ket, g.sel_bra,
                              g.sel_ket)
            if not args.k6_only:
                k5(lib, got, D, g.bra, g.ket, n, sel_bra=g.sel_bra,
                   sel_ket=g.sel_ket, weight=g.weight)
            k6(lib, got6, D, g, I.contiguous(), slice(None))
            cls = (g.bra.la, g.bra.lb, g.ket.la, g.ket.lb)
            routes[cls] = ("warp", "lane", "block")[lib.rh_digest_lane(*cls)]
            if routes[cls] != kernels.digest_route(*cls):
                bad += 1
                print(f"  K6 {cls}: built {routes[cls]}, table "
                      f"{kernels.digest_route(*cls)}  FAIL", flush=True)
        s = float(ref.abs().max())
        if not args.k6_only:
            report(f"K5 list, {len(sdirect.groups)} batches",
                   float((got - ref).abs().max()), 1e-11 * s)
        report("K6, each class pair on its route",
               float((got6 - ref).abs().max()), 1e-11 * s)
        print("  K6 routes built: " + ", ".join(
            f"({c[0]}{c[1]}|{c[2]}{c[3]}) {r}"
            for c, r in sorted(routes.items())), flush=True)
        # K6 from the second block on (I 8 bytes off a 16-byte boundary
        # where a block has an odd count) and on the first 45 blocks (a
        # warp short of 32 after one whole warp)
        ref, got6 = zeros(), zeros()
        for g in sdirect.groups:
            n = g.sel_bra.shape[0]
            I = eri.eri4c_plain(g.bra, g.ket, g.sel_bra, g.sel_ket)
            for sel in (slice(1, None), slice(0, 45)):
                if len(range(n)[sel]) == 0:
                    continue
                fock.digest_plain(ref, I[sel], g.weight[sel], D, g.bra,
                                  g.ket, g.sel_bra[sel], g.sel_ket[sel])
                k6(lib, got6, D, g, I.contiguous()[sel], sel)
        report("K6 from block 1 and on blocks 0-44",
               float((got6 - ref).abs().max()),
               1e-11 * float(ref.abs().max()))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
