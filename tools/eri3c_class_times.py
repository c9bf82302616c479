#!/usr/bin/env python3
"""Time K1 class by class over full 3-center builds on one NVIDIA GPU.

    python3 tools/eri3c_class_times.py [--root DIR] [--set NAME=EXPR ...]
                                       [--systems benzene_2_water w32 w32f32
                                                  benzene_2_water_3df
                                                  benzene_2_water_g w64f32]
                                       [--out result.json]

Builds the kernels of the package under ``--root`` (default: this checkout;
another checkout of this design, such as a variant of its route table
unpacked beside it, compares two trees in one call), then for each system
runs the packed DF builder's 3-center pipeline as
``models/df_screened.py::build_B_packed`` does (the 2-center metric, the
Schwarz-screened pair blocks, the packed 3-center tensor into B's columns):
once to warm up, once timed.  Every K1 launch of the timed build is timed
by CUDA events by class (``chip_smoke.K1Times``), beside each class's bound
over the launch's inputs and its route as this tree's table gives it; each
build is synchronised at both ends, so that its host wall holds its kernels
and K1's share of it is the kernels' part.  Systems: ``benzene_2_water``
(6-311++G(2d,2p) / cc-pVTZ-JKFIT), ``benzene_2_water_3df`` (the same in
6-311++G(3df,3pd): the f classes), ``benzene_2_water_g`` (the same in
6-311++G(3df,3pd)+G, read from tests/data/6-311ppG_3df_3pd_G.gbs: the g
classes, whose launches are also summed on a line of their own),
``w32`` (the generated 32-water cluster,
6-31+G* / cc-pVTZ-JKFIT, f64 B), ``w32f32`` (the same into an f32 B),
``w64f32`` (the 64-water cluster into an f32 B, 22 GB).  ``--set
NAME=EXPR`` sets an attribute of the package's ops/kernels.py before the
build, EXPR evaluated in that module (another body table:
``--set 'ERI3C_T1=frozenset()'``; the build hashes the flags).  Every line names the card and its power
limit.  Needs CUDA; exits 2 without it.
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
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--systems", nargs="+",
                    default=["benzene_2_water", "w32", "w32f32"])
    ap.add_argument("--set", action="append", default=[],
                    help="NAME=EXPR: an attribute of ops/kernels.py")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("eri3c_class_times: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import juliachem_jl_tpu_torch as jc
    from juliachem_jl_tpu_torch.models.df import screened_pair_blocks
    from juliachem_jl_tpu_torch.models.df_screened import build_packed_screen
    from juliachem_jl_tpu_torch.ops import eri3c, kernels
    from juliachem_jl_tpu_torch.utils.options import create_scf_options

    if Path(jc.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {jc.__file__}, not the package under "
                           f"{root}")
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
    ptxas = smoke.eri3c_registers(tag) if "log" in kernels.build_info else {}
    goldens = json.loads((HERE / "tests" / "data" /
                          "s22x3_gamess_goldens.json").read_text())
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "root": str(root), "ptxas": ptxas, "systems": {}}
    for name in args.systems:
        if name == "benzene_2_water_g":
            inp = smoke.g_input("benzene_2_water", goldens["benzene_2_water"],
                                {"mixed_precision": False})
        elif name.startswith("benzene_2_water"):
            golden = goldens["benzene_2_water"]
            if name.endswith("3df"):
                golden = {**golden, "basis": smoke.F_BASIS}
            inp = smoke.system_input("benzene_2_water", golden,
                                     {"mixed_precision": False})
        else:
            inp = smoke.cluster_input(name[:3])
        dtype = torch.float32 if name.endswith("f32") else torch.float64
        sp = jc.io.parse_input(inp)
        bsets = jc.basis.run(jc.molecule.run(sp), sp.model)
        prim, aux = bsets.primary, bsets.auxiliary
        opts = create_scf_options(sp.scf_keywords)

        def build():
            metric = eri3c.two_center_metric(aux, dev)
            blocks = screened_pair_blocks(prim, opts.df_screening_sigma,
                                          float(torch.diagonal(metric).max()),
                                          dev)
            screen = build_packed_screen(prim, blocks)
            P3 = eri3c.three_center_tensor(
                prim, aux, dev, blocks, col_map=screen.col_map,
                packed_width=screen.npq + 1, out_dtype=dtype)
            return sum(float(P3[i:i + 256].abs().sum(dtype=torch.float64))
                       for i in range(0, P3.shape[0], 256))

        build()
        torch.cuda.empty_cache()
        with smoke.K1Times(bound=True) as timer:
            checksum = build()
        res = timer.result()
        torch.cuda.empty_cache()
        print(f"{tag} {name} ({dtype}): nbf {prim.nbf}, naux {aux.nbf}; "
              + smoke.fmt_k1_times(res) + f"; |P3| sum {checksum!r}",
              flush=True)
        body = getattr(kernels, "eri3c_body", lambda *c: None)
        for ph, v in res.items():
            for cls, c in v["classes"].items():
                b = body(*cls)
                print(f"{tag} {name} {ph} {cls} {kernels.eri3c_route(*cls)}"
                      + (f" ({b})" if b else "") + f": {c['launches']} "
                      f"launches, {c['ms']:.4f} ms, bound "
                      f"{c['bound_ms']:.5f} ms ({c['bound_by']})", flush=True)
        if name == "benzene_2_water_g":
            g = smoke.k1_class_sum(res["three_center"], lambda c: c[1] == 4)
            print(f"{tag} {name}: the g classes of the 3-center build, "
                  f"{g['classes']} classes, {g['launches']} launches, "
                  f"{g['ms']:.3f} ms (bound {g['bound_ms']:.4f} ms), the "
                  f"largest {g['largest']} {g['largest_ms']:.3f} ms",
                  flush=True)
        out["systems"][name] = {"dtype": str(dtype), "nbf": prim.nbf,
                                "naux": aux.nbf, "checksum": checksum,
                                "k1": res}
    jc.finalize()
    if args.out:
        Path(args.out).write_text(json.dumps(smoke.str_keys(out), indent=1,
                                             default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
