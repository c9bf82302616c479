#!/usr/bin/env python3
"""Time K8 (the split fold, csrc/split_fold.cu) at the fold chunks of the
first 8 waters of w32 and of w32 on one NVIDIA GPU.

    python3 tools/k8_times.py [--root DIR] [--out result.json]

Builds the kernels of the package under ``--root`` (default: this
checkout; another checkout, such as a parent commit unpacked beside it,
compares two trees in one call), then runs ``chip_smoke.check_k8`` at each
fold's shape (A fitted rows of the cluster's aux set, one column chunk of
``linalg.fold_chunk(A)`` columns, a lower-triangular M): K8 held to its
plain version and to the f64 product within 4 sqrt(A) 2^-24 (|Mh| + |Ml|)
|X| elementwise, its CUDA-event time beside its plain version, the library
call (two cuBLAS SGEMMs with TF32 off and the add), the f64 fold and the
bound.  Every line names the card and its power limit.  Needs CUDA; exits
2 without it.
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
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k8_times: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import juliachem_jl_tpu_torch as jc
    from juliachem_jl_tpu_torch.models.df_screened import fitted_rows
    from juliachem_jl_tpu_torch.ops import kernels
    from juliachem_jl_tpu_torch.utils.options import create_scf_options

    if Path(jc.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {jc.__file__}, not the package under "
                           f"{root}")
    smi = smoke.sh("nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader").splitlines()[0]
    tag = f"[{smi}] [{root.name}]"
    dev = jc.initialize("cuda")
    kernels.library()
    print(f"{tag} build {kernels.build_info.get('seconds', 0.0):.1f} s",
          flush=True)
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "root": str(root), "folds": {}}
    for label, waters in (("w8", 8), ("w32", None)):
        sp = jc.io.parse_input(smoke.cluster_input("w32", waters=waters))
        bsets = jc.basis.run(jc.molecule.run(sp), sp.model)
        rows = fitted_rows(bsets.auxiliary, create_scf_options(sp.scf_keywords))
        out["folds"][label] = smoke.check_k8(tag, dev, rows, label)
    jc.finalize()
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
