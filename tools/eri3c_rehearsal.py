#!/usr/bin/env python3
"""Rehearse K1 (csrc/eri3c.cuh) on the CPU before a chip call.

    python3 tools/eri3c_rehearsal.py [--cut 5 0]
                                     [--basis 6-31+G*] [--aux cc-pVTZ-JKFIT]

Compiles K1's device code with g++ (C++20) against the CPU stand-in for the
CUDA builtins of tools/eri4c_rehearsal/shim (one std::thread per CUDA
thread, barriers for __syncthreads and the warp's DMMA step, the launch
geometry of eri3c_launch.cuh), once per lane-route cut
(``kernels.ERI3C_LANE_MAX_L``, its exclusions kept and the wide bras' cut
held at or below it), into juliachem_jl_tpu_torch/_build/rehearsal/.  A
cut of 0 puts every class on the block route.  Then, on water in the basis pair (and in the pair
with the basis as its own, contracted, aux set): every (pair class | aux
class) of the 3-center tensor and every (unit bra | aux class) of the
metric, the pairs packed and sorted as ``three_center_tensor`` packs them,
against ``eri3c_class_plain`` (1e-12 x each class's max-abs, the card's
gate; 1e-15 for a class that is zero by symmetry), the f32 store against
the f64 output rounded (bit for bit), and every target written (an output
filled with NaN first).  Prints each error, exits 1 if one is over its
bound.  With an f basis (``--basis "6-31G(2df,p)"``) the harness is built
with the f pairs.  The numbers say nothing of the card's speed.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from juliachem_jl_tpu_torch import basis, molecule  # noqa: E402
from juliachem_jl_tpu_torch.basis.structs import ncart  # noqa: E402
from juliachem_jl_tpu_torch.ops import eri3c, kernels  # noqa: E402
from juliachem_jl_tpu_torch.ops.pairs import unique_pair_blocks  # noqa: E402

HERE = ROOT / "tools" / "eri4c_rehearsal"
CSRC = ROOT / "juliachem_jl_tpu_torch" / "csrc"
WATER = {"symbols": ["O", "H", "H"],
         "geometry": [0.0, 0.0, 0.116321, 0.0, 0.751155, -0.465285,
                      0.0, -0.751155, -0.465285]}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LANE_MAX_L_WIDE = kernels.ERI3C_LANE_MAX_L_WIDE


def build(cut: int, with_f: bool, with_g: bool = False) -> ctypes.CDLL:
    """The harness with K1's route table at this cut."""
    out = ROOT / "juliachem_jl_tpu_torch" / "_build" / "rehearsal"
    out.mkdir(parents=True, exist_ok=True)
    so = out / (f"eri3c_rehearsal_cut{cut}{'_f' if with_f else ''}"
                f"{'_g' if with_g else ''}.so")
    kernels.ERI3C_LANE_MAX_L = cut
    kernels.ERI3C_LANE_MAX_L_WIDE = min(cut, LANE_MAX_L_WIDE)
    subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared",
                    "-pthread", *kernels.route_flags(),
                    *kernels.eri3c_route_flags(),
                    *kernels.block_route_flags(),
                    f"-DJC_DIGEST_LANE_MAX_N={kernels.DIGEST_LANE_MAX_N}",
                    *kernels.digest_route_flags(), *kernels.eri3c_t1_flags(),
                    *(["-DRH_WITH_F"] if with_f else []),
                    *(["-DRH_WITH_G"] if with_g else []),
                    "-I", str(HERE / "shim"), "-I", str(CSRC),
                    str(HERE / "eri3c_harness.cpp"), "-o", str(so)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    lib.rh_lane_mask.restype = ctypes.c_ulonglong
    lib.rh_lane_mask.argtypes = [_I]
    lib.rh_eri3c.argtypes = [_I, _I, _I, _P, _P, _LL, _I, _I, _P, _P, _P, _P,
                             _I, _I, _P, _P, _P, _P, _I, _LL]
    lib.rh_eri3c_tile.argtypes = [_I] * 6
    return lib


def k1(lib, out, bra, aux, cols, cols_t, mirror):
    rc = lib.rh_eri3c(bra.la, bra.lb, aux.lq, bra.pair.data_ptr(),
                      bra.meta.data_ptr(), bra.n, bra.Ka, bra.Kb,
                      aux.table.data_ptr(), aux.kq.data_ptr(),
                      aux.qrow.data_ptr(), aux.ecd.data_ptr(), aux.nq,
                      aux.Kq, cols.data_ptr(), cols_t.data_ptr(),
                      mirror.data_ptr(), out.data_ptr(),
                      int(out.dtype == torch.float32), out.stride(0))
    assert rc == 0, (bra.la, bra.lb, aux.lq, rc)


def classes(prim, aux):
    """(label, K1Pairs, aux tables, width) of the 3-center tensor's pair
    classes (dense columns) and of the metric's unit bras."""
    nbf, A = prim.nbf, aux.nbf
    auxs = eri3c.aux_tables(aux, "cpu")
    out = []
    for blk in unique_pair_blocks(prim):
        out.append((f"({blk.la}{blk.lb}|", eri3c.k1_pairs(
            blk, lambda ia, ib: ia * nbf + ib, "cpu"), auxs, nbf * nbf))
    for blk in eri3c.aux_unit_blocks(aux):
        out.append((f"metric (0{blk.lb}|", eri3c.k1_pairs(
            blk, lambda ia, ib: ib, "cpu"), auxs, A))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cut", type=int, nargs="+",
                    default=[kernels.ERI3C_LANE_MAX_L, 0])
    ap.add_argument("--basis", default="6-31+G*")
    ap.add_argument("--basis-file", default=None,
                    help="a GAMESS-US basis file, registered as --basis "
                         "(tests/data/6-311ppG_3df_3pd_G.gbs: the g bras)")
    ap.add_argument("--aux", default="cc-pVTZ-JKFIT")
    args = ap.parse_args()
    torch.set_num_threads(1)
    if args.basis_file:
        basis.register_basis_file(args.basis_file, args.basis)
    mol = molecule.from_input_dict(WATER)
    prim = basis.build(mol, args.basis)
    systems = [(args.aux, basis.build_auxiliary(mol, args.aux, args.basis)),
               (args.basis, basis.build(mol, args.basis))]
    with_f = 3 in prim.classes
    with_g = 4 in prim.classes
    bad = 0

    def report(what, err, bound):
        nonlocal bad
        ok = err <= bound
        bad += not ok
        print(f"  {what}: {err:.3e} (bound {bound:.3e})"
              f"{'' if ok else '  <-- OVER'}", flush=True)

    for cut in args.cut:
        lib = build(cut, with_f, with_g)
        masks = ",".join(f"{lib.rh_lane_mask(i):#x}"
                         for i in range(len(kernels.ERI3C_BRAS)))
        print(f"cut {cut} (lane masks {masks}), water "
              f"{args.basis}", flush=True)
        for aux_name, aux in systems:
            A = aux.nbf
            for label, kp, auxs, width in classes(prim, aux):
                bra = kp.table
                for at in auxs:
                    ref = torch.zeros((A, width), dtype=torch.float64)
                    eri3c.eri3c_class_plain(ref, bra, at, kp.cols,
                                            kp.cols_t, kp.mirror)
                    got = torch.full((A, width), float("nan"),
                                     dtype=torch.float64)
                    k1(lib, got, bra, at, kp.cols, kp.cols_t, kp.mirror)
                    got32 = torch.full((A, width), float("nan"),
                                       dtype=torch.float32)
                    k1(lib, got32, bra, at, kp.cols, kp.cols_t,
                       kp.mirror)
                    # every target of the class written once, nothing
                    # else: the untouched entries stay NaN, as ref's 0
                    hit = ~torch.isnan(got)
                    written = torch.zeros_like(hit)
                    rows = (at.qrow[:, None]
                            + torch.arange(ncart(at.lq))[None]).reshape(-1)
                    for c, m in ((kp.cols, None), (kp.cols_t, kp.mirror)):
                        cc = c if m is None else c[m.bool()]
                        written[rows[:, None], cc.reshape(1, -1)] = True
                    cls = f"{label}{at.lq}) {aux_name}"
                    tile = lib.rh_eri3c_tile(bra.la, bra.lb, at.lq,
                                             bra.Ka, bra.Kb, at.Kq)
                    route = kernels.eri3c_route(bra.la, bra.lb, at.lq)
                    body = kernels.eri3c_body(bra.la, bra.lb, at.lq)
                    route += f" ({body})" if body else ""
                    scale = float(ref.abs().max())
                    err = float((got.nan_to_num(0.0) - ref).abs().max())
                    # a class zero by symmetry (every pair and aux
                    # shell on one atom, odd in total) is held to 1e-15
                    report(f"{cls} {route} QT {tile}: f64 err", err,
                           1e-12 * max(scale, 1e-3))
                    if not torch.equal(hit, written):
                        print(f"  {cls}: targets written "
                              f"{int(hit.sum())}, expected "
                              f"{int(written.sum())}  <-- OVER",
                              flush=True)
                        bad += 1
                    off = int((got32[written] != got[written].float())
                              .sum())
                    if off:
                        print(f"  {cls}: f32 store {off} elements off "
                              "the f64 output rounded  <-- OVER",
                              flush=True)
                        bad += 1
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
