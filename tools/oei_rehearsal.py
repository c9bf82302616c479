#!/usr/bin/env python3
"""Rehearse K9 (csrc/oei.cuh) on the CPU before a chip call.

    python3 tools/oei_rehearsal.py [--groups 8 16 32]
        [--basis 6-31+G* "6-311++G(3df,3pd)" "6-311++G(3df,3pd)+G"]
        [--basis-file tests/data/6-311ppG_3df_3pd_G.gbs]

Compiles K9's device code with g++ (C++20) against the CPU stand-in for the
CUDA builtins of tools/eri4c_rehearsal/shim (one std::thread per CUDA
thread, the warp's shuffles and __syncwarp through barriers, the launch
geometry of csrc/oei_launch.cuh) into juliachem_jl_tpu_torch/_build/
rehearsal/, then, on two waters in each basis (the last one read from
--basis-file), runs every class at every group size into S, T and V filled
with NaN first and holds them to ``overlap_kinetic_nuclear_plain`` within
1e-12 x each matrix's max-abs (the card's gate): every element written, by
the packing of ``stv_tables``.  Prints each error, exits 1 if one is over
its bound.  About a minute with the build; says nothing of the card's
speed.
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
from juliachem_jl_tpu_torch.ops import kernels, oei  # noqa: E402

HERE = ROOT / "tools" / "eri4c_rehearsal"
CSRC = ROOT / "juliachem_jl_tpu_torch" / "csrc"
WATERS = {"symbols": ["O", "H", "H", "O", "H", "H"],
          "geometry": [0.0, 0.0, 0.116321, 0.0, 0.751155, -0.465285,
                       0.0, -0.751155, -0.465285, 2.9, 0.1, 0.2,
                       3.5, 0.8, -0.3, 3.4, -0.7, -0.4]}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
G_BASIS_FILE = "tests/data/6-311ppG_3df_3pd_G.gbs"


def build() -> ctypes.CDLL:
    out = ROOT / "juliachem_jl_tpu_torch" / "_build" / "rehearsal"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "oei_rehearsal.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared",
                    "-pthread", "-I", str(HERE / "shim"), "-I", str(CSRC),
                    str(HERE / "oei_harness.cpp"), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.rh_stv.argtypes = [_I, _I, _I, _P, _P, _P, _LL, _P, _I, _P, _P, _P,
                           _LL]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, nargs="+",
                    default=list(kernels.STV_GROUPS))
    ap.add_argument("--basis", nargs="+",
                    default=["6-31+G*", "6-311++G(3df,3pd)",
                             "6-311++G(3df,3pd)+G"])
    ap.add_argument("--basis-file", default=str(ROOT / G_BASIS_FILE),
                    help="a GAMESS-US basis file, registered as the last "
                         "--basis")
    args = ap.parse_args()
    torch.set_num_threads(1)
    basis.register_basis_file(args.basis_file, args.basis[-1])
    lib = build()
    mol = molecule.from_input_dict(WATERS)
    atoms = oei.atom_table(mol, "cpu")
    worst = 0.0
    for name in args.basis:
        b = basis.build(mol, name)
        ref = oei.overlap_kinetic_nuclear_plain(b, mol, "cpu")
        tabs = oei.stv_tables(b, "cpu")
        for g in args.groups:
            out = [torch.full((b.nbf, b.nbf), float("nan"),
                              dtype=torch.float64) for _ in range(3)]
            for t in tabs:
                rc = lib.rh_stv(t.la, t.lb, g, t.prim.data_ptr(),
                                t.pair.data_ptr(), t.meta.data_ptr(), t.n,
                                atoms.data_ptr(), atoms.shape[0],
                                *(m.data_ptr() for m in out), b.nbf)
                assert rc == 0, (t.la, t.lb, g, rc)
            errs = [float((o - r).abs().max() / r.abs().max())
                    for o, r in zip(out, ref)]
            worst = max([worst, *errs])
            print(f"{name} (nbf {b.nbf}, classes "
                  f"{[(t.la, t.lb) for t in tabs]}), G = {g}: error / "
                  f"max-abs S {errs[0]:.2e}, T {errs[1]:.2e}, V "
                  f"{errs[2]:.2e}", flush=True)
    print(f"worst {worst:.2e} (bound 1e-12)")
    return 0 if worst <= 1e-12 else 1


if __name__ == "__main__":
    sys.exit(main())
