#!/usr/bin/env python3
"""Rehearse K10 (csrc/oei_grad.cuh) and K11 (csrc/eri3c_grad.cuh) on the
CPU before a chip call.

    python3 tools/grad_rehearsal.py [--groups 8 16 32] [--cap 2]

Compiles their device code with g++ (C++20) against the CPU stand-in for
the CUDA builtins of tools/eri4c_rehearsal/shim (one std::thread per CUDA
thread, the warp's shuffles through barriers, the blocks of
csrc/oei_grad_launch.cuh and eri3c_grad_launch.cuh, at most --cap blocks a
launch so that the grid-stride loops turn) into
juliachem_jl_tpu_torch/_build/rehearsal/, then holds every class to the
plain versions on the same tables within 1e-12 x max |g| of each gradient:
K10 at each group size on two waters in 6-31+G*, 6-311++G(3df,3pd) and the
g basis (tests/data/6-311ppG_3df_3pd_G.gbs) at a seeded symmetric D and W;
K11's 3-center and 2-center instances on one water in 6-31+G* and in the g
basis with cc-pVTZ-JKFIT (aux shells to g) at a seeded gamma (symmetric in
pq) and Omega.  Prints each error, exits 1 if one is over its bound.  A few
minutes with the build; says nothing of the card's speed.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from juliachem_jl_tpu_torch import basis, molecule  # noqa: E402
from juliachem_jl_tpu_torch.ops import eri_grad, kernels, oei, oei_grad  # noqa: E402

HERE = ROOT / "tools" / "eri4c_rehearsal"
CSRC = ROOT / "juliachem_jl_tpu_torch" / "csrc"
WATERS = {"symbols": ["O", "H", "H", "O", "H", "H"],
          "geometry": [0.0, 0.0, 0.116321, 0.0, 0.751155, -0.465285,
                       0.0, -0.751155, -0.465285, 2.9, 0.1, 0.2,
                       3.5, 0.8, -0.3, 3.4, -0.7, -0.4]}
WATER = {"symbols": WATERS["symbols"][:3], "geometry": WATERS["geometry"][:9]}
G_BASIS = "6-311++G(3df,3pd)+G"
G_BASIS_FILE = ROOT / "tests" / "data" / "6-311ppG_3df_3pd_G.gbs"
_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double


def build() -> ctypes.CDLL:
    out = ROOT / "juliachem_jl_tpu_torch" / "_build" / "rehearsal"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "grad_rehearsal.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared",
                    "-pthread", "-I", str(HERE / "shim"), "-I", str(CSRC),
                    str(HERE / "grad_harness.cpp"), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.rh_stv_grad.argtypes = [_I, _I, _I, _P, _P, _P, _LL, _P, _I, _P, _P,
                                _LL, _P, _LL]
    lib.rh_eri3c_grad.argtypes = [_I, _I, _I, _I, _P, _P, _P, _LL, _P, _P, _P,
                                  _LL, _P, _LL, _LL, _D, _P, _I, _LL]
    return lib


def sym(n: int, seed: int) -> torch.Tensor:
    X = np.random.default_rng(seed).standard_normal((n, n))
    return torch.as_tensor(X + X.T)


def rel(out, ref) -> float:
    return float((out - ref).abs().max() / ref.abs().max())


def k10(lib, groups, cap) -> float:
    mol = molecule.from_input_dict(WATERS)
    atoms = oei.atom_table(mol, "cpu")
    worst = 0.0
    for name in ("6-31+G*", "6-311++G(3df,3pd)", G_BASIS):
        b = basis.build(mol, name)
        D, W = sym(b.nbf, 1), sym(b.nbf, 2)
        tabs = oei_grad.stv_grad_tables(b, "cpu")
        ref = oei_grad.stv_grad_plain(tabs, atoms, D, W)
        for g in groups:
            out = torch.zeros((mol.natom, 3), dtype=torch.float64)
            for t in tabs:
                rc = lib.rh_stv_grad(t.la, t.lb, g, t.prim.data_ptr(),
                                     t.pair.data_ptr(), t.meta.data_ptr(),
                                     t.n, atoms.data_ptr(), mol.natom,
                                     D.data_ptr(), W.data_ptr(), b.nbf,
                                     out.data_ptr(), cap)
                assert rc == 0, (t.la, t.lb, g, rc)
            e = rel(out, ref)
            worst = max(worst, e)
            print(f"K10 {name} (nbf {b.nbf}, classes "
                  f"{[(t.la, t.lb) for t in tabs]}), G = {g}: error / max "
                  f"|g| {e:.2e}", flush=True)
    return worst


def k11(lib, cap) -> float:
    mol = molecule.from_input_dict(WATER)
    worst = 0.0
    for name in ("6-31+G*", G_BASIS):
        prim = basis.build(mol, name)
        aux = basis.build_auxiliary(mol, "cc-pVTZ-JKFIT", name)
        A, nbf = aux.nbf, prim.nbf
        X = np.random.default_rng(5).standard_normal((A, nbf, nbf))
        gamma = torch.as_tensor(X + X.transpose(0, 2, 1))
        Omega = sym(A, 6)
        aux_t, pair_t = eri_grad.df_grad_tables(prim, aux, "cpu")
        for what in ("3-center", "metric"):
            ref = torch.zeros((mol.natom, 3), dtype=torch.float64)
            out = torch.zeros_like(ref)
            if what == "3-center":
                eri_grad.three_center_grad_plain(aux_t, pair_t, gamma, ref)
                runs = [(ti, tj, 0, gamma, nbf * nbf, nbf, 2.0)
                        for ti in aux_t for tj in pair_t]
            else:
                eri_grad.metric_grad_plain(aux_t, Omega, ref)
                runs = [(ti, tj, 1, Omega, A, 1, -2.0)
                        for a, ti in enumerate(aux_t) for tj in aux_t[a:]]
            for ti, tj, metric, G, s_a, s_p, w in runs:
                rc = lib.rh_eri3c_grad(
                    ti.la, tj.la, tj.lb if not metric else 0, metric,
                    ti.prim.data_ptr(), ti.pair.data_ptr(),
                    ti.meta.data_ptr(), ti.n, tj.prim.data_ptr(),
                    tj.pair.data_ptr(), tj.meta.data_ptr(), tj.n,
                    G.data_ptr(), s_a, s_p, w, out.data_ptr(), mol.natom, cap)
                assert rc == 0, (ti.la, tj.la, tj.lb, metric, rc)
            e = rel(out, ref)
            worst = max(worst, e)
            print(f"K11 {what} {name} / cc-pVTZ-JKFIT (nbf {nbf}, A {A}): "
                  f"error / max |g| {e:.2e}", flush=True)
    return worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, nargs="+",
                    default=list(kernels.STV_GROUPS))
    ap.add_argument("--cap", type=int, default=2,
                    help="blocks a launch at most (the grid-stride loops)")
    args = ap.parse_args()
    torch.set_num_threads(1)
    basis.register_basis_file(str(G_BASIS_FILE), G_BASIS)
    lib = build()
    worst = max(k10(lib, args.groups, args.cap), k11(lib, args.cap))
    print(f"worst {worst:.2e} (bound 1e-12)")
    return 0 if worst <= 1e-12 else 1


if __name__ == "__main__":
    sys.exit(main())
