#!/usr/bin/env python3
"""Time K5 (staircase mode) or K6 (in-core digestion) class pair by class
pair over full conventional builds on one NVIDIA GPU.

    python3 tools/eri4c_class_times.py [--mode stair|digest_jk|subsets]
                                       [--root DIR] [--set NAME=EXPR ...]
                                       [--basis-file FILE --basis NAME]
                                       [--only-l L] [--no-warm]
                                       [--out result.json]

Builds the kernels of the package under ``--root`` (default: this
checkout; another checkout, such as a parent commit unpacked beside it,
compares two trees in one call), then, at a seeded random symmetric
density (the kernels' work does not depend on D), each class pair's
launch timed by CUDA events after a warm-up build:

- ``--mode stair`` (default): one full StreamingDirectFock build of
  benzene_2_water (the S22x3 geometry, 6-311++G(2d,2p)),
  ``chip_smoke.stair_class_times``, with each class pair's route as the
  package was built (a package without ``eri.eri4c_geometry`` has one
  warp per quartet: "warp"); with ``--basis-file`` and ``--basis``, in
  that GAMESS-US basis (registered under that name: the g basis of
  tests/data/6-311ppG_3df_3pd_G.gbs as "6-311++G(3df,3pd)+G"), and with
  ``--only-l``, only the class pairs that hold a shell of that angular
  momentum (``--no-warm``: no warm-up build first);
- ``--mode subsets``: phase 3g of chip_smoke.py without its plain
  references: K4, K6 (on K4's blocks), K5 list and K5 staircase on the
  first SUBSET_G quartets
  of each class pair of benzene_2_water that holds a shell of
  ``--only-l`` (default 4) in the basis of ``--basis-file``/``--basis``,
  each class pair timed alone (``chip_smoke.class_pair_times``);
- ``--mode digest_jk``: one in-core ScreenedDirectFock build (K4 fills the
  blocks, K6 digests them) of ammonia_trimer in its S22x3 basis
  (6-311++G(2d,2p), 5.83e6 quartets) and in 6-31G(2df,p) (1.21e6), or,
  with ``--basis-file`` and ``--basis``, of the first 2 waters of the
  generated w32 cluster in that basis (chip_smoke.py phase 11's in-core
  system in the g basis), ``chip_smoke.incore_k6_times`` (each class
  pair's K6 route is ``kernels.digest_route``'s, fixed when the package is
  built), summed by route (``chip_smoke.k6_by_route``).

``--set NAME=EXPR`` sets an attribute of the package's ops/kernels.py
before the build, EXPR evaluated in that module (another route table or
tile: ``--set ERI4C_LANE_MAX_L=7``, ``--set 'ERI4C_BLOCK=frozenset()'``,
``--set ERI4C_BLOCK_CAP=110*1024``; the build hashes the flags).  Every
line names the card and its power limit.  Needs CUDA; exits 2 without
it.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("stair", "digest_jk", "subsets"),
                    default="stair")
    ap.add_argument("--set", action="append", default=[],
                    help="NAME=EXPR: an attribute of ops/kernels.py")
    ap.add_argument("--no-warm", action="store_true")
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--basis-file")
    ap.add_argument("--basis")
    ap.add_argument("--only-l", type=int)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("eri4c_class_times: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import juliachem_jl_tpu_torch as jc
    from juliachem_jl_tpu_torch.ops import kernels

    if Path(jc.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {jc.__file__}, not the package under "
                           f"{root}")
    from juliachem_jl_tpu_torch.ops import eri

    route = (smoke.compiled_route if hasattr(eri, "eri4c_geometry")
             else lambda bra, ket: "warp")
    smi = smoke.sh("nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader").splitlines()[0]
    tag = f"[{smi}] [{root.name}]"
    for item in args.set:
        key, expr = item.split("=", 1)
        setattr(kernels, key, eval(expr, vars(kernels)))
        tag += f" [{key}={expr}]"
    dev = jc.initialize("cuda")
    kernels.library()
    print(f"{tag} build {kernels.build_info.get('seconds', 0.0):.1f} s",
          flush=True)
    regs = smoke.eri4c_registers(tag) if "log" in kernels.build_info else {}
    goldens = json.loads((HERE / "tests" / "data" /
                          "s22x3_gamess_goldens.json").read_text())
    if args.mode == "digest_jk":
        from juliachem_jl_tpu_torch.ops import fock

        golden = goldens["ammonia_trimer"]
        out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
               "root": str(root), "ptxas": regs, "builds": {}}
        if args.basis_file:
            jc.basis.register_basis_file(args.basis_file, args.basis)
            w32 = json.loads((HERE / "juliachem_jl_tpu_torch" / "data" /
                              "water_clusters.json").read_text())["w32"]
            mol = jc.molecule.from_input_dict(
                {"symbols": w32["symbols"][:6],
                 "geometry": w32["geometry"][:18]})
            systems = [(f"w2 {args.basis}",
                        lambda: jc.basis.build(mol, args.basis))]
        else:
            def trimer(basis):
                sp = jc.io.parse_input(smoke.system_input(
                    "ammonia_trimer", {**golden, "basis": basis}, aux=False))
                return jc.basis.run(jc.molecule.run(sp), sp.model).primary

            systems = [(f"ammonia_trimer {b}", lambda b=b: trimer(b))
                       for b in (golden["basis"], smoke.F_BASIS_SMALL)]
        for name, make in systems:
            prim = make()
            gen = torch.Generator(device=dev).manual_seed(5)
            X = torch.randn((prim.nbf, prim.nbf), dtype=torch.float64,
                            device=dev, generator=gen)
            fb = fock.ScreenedDirectFock(prim, incore=True, device=dev)
            fb.jk_halves(X + X.T)   # K4 fills the blocks; the warm-up build
            out["builds"][name] = smoke.incore_k6_times(
                tag, fb, X + X.T, name)
            smoke.k6_by_route(tag, fb, out["builds"][name])
            fb.finalize()
            del fb
            torch.cuda.empty_cache()
        jc.finalize()
        if args.out:
            Path(args.out).write_text(json.dumps(smoke.str_keys(out),
                                                 indent=1, default=str))
        return 0
    golden = goldens["benzene_2_water"]
    if args.basis_file:
        jc.basis.register_basis_file(args.basis_file, args.basis)
        golden = {**golden, "basis": args.basis}
    inp = smoke.system_input("benzene_2_water", golden, aux=False)
    sp = jc.io.parse_input(inp)
    bsets = jc.basis.run(jc.molecule.run(sp), sp.model)
    nbf = bsets.primary.nbf
    if args.mode == "subsets":
        out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
               "root": str(root), "ptxas": regs,
               "subsets": subset_times(smoke, tag, dev, bsets.primary,
                                       4 if args.only_l is None
                                       else args.only_l)}
        jc.finalize()
        if args.out:
            Path(args.out).write_text(json.dumps(smoke.str_keys(out),
                                                 indent=1, default=str))
        return 0
    gen = torch.Generator(device=dev).manual_seed(5)
    X = torch.randn((nbf, nbf), dtype=torch.float64, device=dev,
                    generator=gen)
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "root": str(root), "ptxas": regs,
           "full_build": smoke.stair_class_times(
               tag, dev, bsets.primary, X + X.T,
               f"benzene_2_water {golden['basis']}", route,
               warm=not args.no_warm, only_l=args.only_l)}
    jc.finalize()
    if args.out:
        Path(args.out).write_text(json.dumps(smoke.str_keys(out), indent=1,
                                             default=str))
    return 0


def subset_times(smoke, tag: str, dev, prim, need_l: int) -> list:
    """chip_smoke's phase 3g cases (the first SUBSET_G quartets of each
    class pair with a shell of angular momentum need_l, a seeded D), each
    class pair's K4, K6, K5 list and K5 staircase launch timed alone, after
    one warm launch of each."""
    import torch

    from juliachem_jl_tpu_torch.ops import eri, fock_stream

    sdf = fock_stream.StreamingDirectFock(prim, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    X = torch.randn((prim.nbf, prim.nbf), dtype=torch.float64, device=dev,
                    generator=gen)
    D = (X + X.T).contiguous()
    cases, geometry = [], {}
    for cp in sdf.pairs:
        bra, ket = sdf.blocks[cp.bi].table, sdf.blocks[cp.ki].table
        cls = (bra.la, bra.lb, ket.la, ket.lb)
        if need_l not in cls:
            continue
        m = min(cp.N, smoke.SUBSET_G)
        t = torch.arange(m, dtype=torch.int64, device=dev)
        r, c, w = fock_stream.decode_staircase(cp.cum, t, bra, ket, cp.same)
        n_prim, n_series = smoke.quartet_prims(bra, ket, r, c)
        kb = (bra.meta[r, 2] * bra.meta[r, 3]).double()
        kk = (ket.meta[c, 2] * ket.meta[c, 3]).double()
        cases.append(dict(bra=bra, ket=ket, r=r, c=c, w=w, m=m, cum=cp.cum,
                          same=cp.same, n_prim=n_prim, n_series=n_series,
                          kb=float(kb.sum()), kk=float(kk.sum())))
        geometry[cls] = (eri.eri4c_geometry(bra, ket)
                         if hasattr(eri, "eri4c_geometry") else
                         {"route": "warp", "blocks_per_sm": 0,
                          "warps_per_sm": 0})
    rows = smoke.class_pair_times(cases, D, prim.nbf, geometry)
    for v in rows:
        print(f"{tag} subsets class pair " + smoke.fmt_class_row(v, {}),
              flush=True)
    for k in ("eri4c", "digest_jk", "eri4c_jk_list", "eri4c_jk_stair"):
        print(f"{tag} subsets {k}: {sum(v[k]['ms'] for v in rows):.3f} ms "
              f"over {len(rows)} class pairs, bound "
              f"{sum(v[k]['bound_ms'] for v in rows):.4f} ms", flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(main())
