#!/usr/bin/env python3
"""Compare the packed DF tensors of two checkouts on one NVIDIA GPU.

    python3 tools/df_b_diff.py --other DIR [--system w32] [--out result.json]

Loads the package of this checkout and the one under ``--other`` (such as
a parent commit unpacked beside it; imported under another name, so both
live in one process) and, for one generated water cluster
(``juliachem_jl_tpu_torch/data/water_clusters.json``, 6-31+G* /
cc-pVTZ-JKFIT), builds with each tree the packed 3-center tensor
(``ops/eri3c.py::three_center_tensor`` into B's columns) and the folded B
(``models/df_screened.py::build_B_packed``), each in f64 and into an f32
B.  For each of the four tensors it prints how many words differ between
the trees, the largest difference and the largest magnitude: how far a
change of K1's summation order reaches into B, and how many of the f32
B's words it flips.  Each tree builds its own kernels.  The line names the
card and its power limit.  Needs CUDA; exits 2 without it.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
PKG = "juliachem_jl_tpu_torch"


def load_tree(root: Path, name: str):
    """The package under ``root`` imported as ``name`` (its imports within
    the package are relative)."""
    init = root / PKG / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def build_tensors(jc, inp: dict, dtype, dev) -> dict:
    """The packed 3-center tensor and the folded B of ``inp`` in ``dtype``
    (``df_b_dtype``), built by the package ``jc``, with the screen's column
    map."""
    import torch

    name = jc.__name__
    df = importlib.import_module(f"{name}.models.df")
    dfs = importlib.import_module(f"{name}.models.df_screened")
    eri3c = importlib.import_module(f"{name}.ops.eri3c")
    options = importlib.import_module(f"{name}.utils.options")
    flags = {"df_b_dtype": "f32"} if dtype == torch.float32 else {}
    inp = {**inp, "keywords": {"scf": {**inp["keywords"]["scf"], **flags}}}
    sp = jc.io.parse_input(inp)
    bsets = jc.basis.run(jc.molecule.run(sp), sp.model)
    prim, aux = bsets.primary, bsets.auxiliary
    opts = options.create_scf_options(sp.scf_keywords)
    metric = eri3c.two_center_metric(aux, dev)
    blocks = df.screened_pair_blocks(prim, opts.df_screening_sigma,
                                     float(torch.diagonal(metric).max()), dev)
    screen = dfs.build_packed_screen(prim, blocks)
    P3 = eri3c.three_center_tensor(prim, aux, dev, blocks,
                                   col_map=screen.col_map,
                                   packed_width=screen.npq + 1,
                                   out_dtype=dtype)
    B, screen_b = dfs.build_B_packed(prim, aux, opts, dev)
    return {"P3": P3, "B": B, "col_map": screen.col_map,
            "col_map_B": screen_b.col_map}


def diff(a, b, rows: int = 256) -> dict:
    """Words of ``a`` and ``b`` that differ, the largest difference and the
    largest magnitude (f64 sums, by row blocks)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"shapes {tuple(a.shape)}, {tuple(b.shape)}; "
                         f"dtypes {a.dtype}, {b.dtype}")
    n = 0
    dmax = amax = 0.0
    for i in range(0, a.shape[0], rows):
        x, y = a[i:i + rows], b[i:i + rows]
        n += int((x != y).sum())
        dmax = max(dmax, float((x.double() - y.double()).abs().max()))
        amax = max(amax, float(torch.maximum(x.abs().max(), y.abs().max())))
    return {"words": a.numel(), "differ": n, "max_abs_diff": dmax,
            "max_abs": amax}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--system", default="w32")
    ap.add_argument("--out")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("df_b_diff: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as smoke
    import juliachem_jl_tpu_torch as this

    other = load_tree(Path(args.other).resolve(), "jc_other")
    smi = smoke.sh("nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader").splitlines()[0]
    dev = torch.device("cuda")
    for jc in (this, other):
        jc.initialize("cuda")
        importlib.import_module(f"{jc.__name__}.ops.kernels").library()
    inp = smoke.cluster_input(args.system)
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "system": args.system, "other": str(Path(args.other).resolve())}
    for dtype in (torch.float64, torch.float32):
        a = build_tensors(other, inp, dtype, dev)
        b = build_tensors(this, inp, dtype, dev)
        for k in ("col_map", "col_map_B"):
            if not np.array_equal(np.asarray(a[k]), np.asarray(b[k])):
                raise RuntimeError(f"the trees screen differently ({k})")
        for name in ("P3", "B"):
            d = diff(a[name], b[name])
            out[f"{name} {dtype}"] = d
            print(f"[{smi}] {args.system} {name} {dtype} "
                  f"{tuple(a[name].shape)}: {d['differ']} of {d['words']} "
                  f"words differ, max |diff| {d['max_abs_diff']!r}, max "
                  f"|value| {d['max_abs']!r}", flush=True)
        del a, b
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
