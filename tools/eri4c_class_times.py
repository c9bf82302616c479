#!/usr/bin/env python3
"""Time K5 (staircase mode) or K6 (in-core digestion) class pair by class
pair over full conventional builds on one NVIDIA GPU.

    python3 tools/eri4c_class_times.py [--mode stair|digest_jk] [--root DIR]
                                       [--basis-file FILE --basis NAME]
                                       [--only-l L] [--out result.json]

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
  momentum;
- ``--mode digest_jk``: one in-core ScreenedDirectFock build (K4 fills the
  blocks, K6 digests them) of ammonia_trimer in its S22x3 basis
  (6-311++G(2d,2p), 5.83e6 quartets) and in 6-31G(2df,p) (1.21e6),
  ``chip_smoke.incore_k6_times`` (each class pair's K6 route is
  ``kernels.digest_route``'s, fixed when the package is built).

Every line names the card and its power limit.  Needs CUDA; exits 2
without it.
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
    ap.add_argument("--mode", choices=("stair", "digest_jk"), default="stair")
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
        for basis in (golden["basis"], smoke.F_BASIS_SMALL):
            sp = jc.io.parse_input(smoke.system_input(
                "ammonia_trimer", {**golden, "basis": basis}, aux=False))
            prim = jc.basis.run(jc.molecule.run(sp), sp.model).primary
            gen = torch.Generator(device=dev).manual_seed(5)
            X = torch.randn((prim.nbf, prim.nbf), dtype=torch.float64,
                            device=dev, generator=gen)
            fb = fock.ScreenedDirectFock(prim, incore=True, device=dev)
            fb.jk_halves(X + X.T)   # K4 fills the blocks; the warm-up build
            name = f"ammonia_trimer {basis}"
            out["builds"][name] = smoke.incore_k6_times(
                tag, fb, X + X.T, name)
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
    gen = torch.Generator(device=dev).manual_seed(5)
    X = torch.randn((nbf, nbf), dtype=torch.float64, device=dev,
                    generator=gen)
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "root": str(root), "ptxas": regs,
           "full_build": smoke.stair_class_times(
               tag, dev, bsets.primary, X + X.T,
               f"benzene_2_water {golden['basis']}", route,
               only_l=args.only_l)}
    jc.finalize()
    if args.out:
        Path(args.out).write_text(json.dumps(smoke.str_keys(out), indent=1,
                                             default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
