#!/usr/bin/env python3
"""One generated water cluster through the PyTorch port on one GPU.

    python3 tools/run_water_cluster.py [w32|w64] [--out result.json]

Runs DF-RHF of the cluster (juliachem_jl_tpu_torch/data/water_clusters.json;
6-31+G* / cc-pVTZ-JKFIT and chip_smoke.py's convergence keywords) twice
through run_spec: with an f64 B (streamed from page-locked host memory
where the card's budget cannot hold it with its f32 copy; a MemoryError,
with the bytes it names, is recorded), then with an f32 B, each after its
packed builder's build alone, to read that build's peak memory, and prints
E(f32 B) - E(f64 B).  Prints the card's name and power limit, each run's
lines from chip_smoke.run_cluster (B's bytes, build and run peak memory, setup
phases, Fock s/iter, iterations, energy, wall time to energy, K1's launches
of the run's metric and 3-center builds by class) and, last, one JSON line
with both results.  Needs CUDA; exits 2 without it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cluster", nargs="?", default="w64",
                    choices=["w32", "w64"])
    ap.add_argument("--out", help="write the result as JSON here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("run_water_cluster: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import juliachem_jl_tpu_torch as jc
    from juliachem_jl_tpu_torch.ops import kernels

    smi = cs.sh("nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader").splitlines()[0]
    tag = f"[{smi}]"
    print(smi, flush=True)
    jc.initialize("cuda")
    kernels.library()
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "cluster": args.cluster}
    try:
        out["f64"] = cs.run_cluster(tag, jc, args.cluster, {},
                                    f"{args.cluster} f64 B",
                                    measure_build=True, k1_times=True)
    except MemoryError as exc:
        out["f64"] = {"memory_error": str(exc)}
        print(f"{tag} {args.cluster} f64 B: MemoryError: {exc}", flush=True)
    torch.cuda.empty_cache()
    out["f32"] = cs.run_cluster(tag, jc, args.cluster, {"df_b_dtype": "f32"},
                                f"{args.cluster} f32 B", measure_build=True,
                                k1_times=True)
    if "energy" in out["f64"]:
        out["f32_minus_f64_B"] = out["f32"]["energy"] - out["f64"]["energy"]
        print(f"{tag} {args.cluster}: E(f32 B) - E(f64 B) = "
              f"{out['f32_minus_f64_B']:.6e} Eh", flush=True)
    jc.finalize()
    out = cs.str_keys(out)   # K1's classes are tuples
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
