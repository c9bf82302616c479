#!/usr/bin/env python3
"""The w32 DF-RHF gradient under variants of its fit and SCF settings, each
held to central differences of its own energy, on one NVIDIA GPU.

    python3 tools/grad_fit_variants.py [--waters N] [--variants A,B]
                                       [--out result.json]

For each variant: ``models.gradient.run`` on w32 (6-31+G* /
cc-pVTZ-JKFIT, 96 atoms) or its first N waters, with chip_smoke.py's
W_SCF and the variant's keywords (``chip_smoke.cluster_input``); its SCF
iterations and wall, the gradient's wall and parts, the peak device memory,
|sum g|, and the central differences (step ``chip_smoke.W_GRAD_FD_STEP``)
on the first O's z and the first H's x against the analytic gradient,
beside the smoke's bound ``W_GRAD_FD_TOL``.  The variants take apart the
settings of the smoke's w32 gradient (``chip_smoke.W_GRAD``): the fit in
Cartesian aux rows or in the solid-harmonic aux space, D converged to rmsd
1e-9 or 1e-11, and the packed builder's pair screen and exchange screen at
their defaults or off.  A variant that fails is reported and the next one
runs.  Every line names the card and its power limit.  Needs CUDA; exits 2
without it.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

TIGHT = {"mixed_precision": False, "niter": 100}
VARIANTS = {
    # Cartesian aux rows, D to rmsd 1e-9, the builder's default screens
    "cart rmsd 1e-9": {**TIGHT, "df_spherical_aux": False, "dele": 1e-11,
                       "rmsd": 1e-9},
    # ... D to rmsd 1e-11
    "cart rmsd 1e-11": {**TIGHT, "df_spherical_aux": False, "dele": 1e-10,
                        "rmsd": 1e-11},
    # ... every pair above 1e-12, no exchange screen, D to rmsd 1e-9
    "cart rmsd 1e-9 unscreened": {**TIGHT, "df_spherical_aux": False,
                                  "dele": 1e-11, "rmsd": 1e-9,
                                  "df_sigma": 1e-12,
                                  "df_exchange_screen": False},
    # ... and D to rmsd 1e-11 (chip_smoke.W_GRAD)
    "cart rmsd 1e-11 unscreened": {**TIGHT, "df_spherical_aux": False,
                                   "dele": 1e-10, "rmsd": 1e-11,
                                   "df_sigma": 1e-12,
                                   "df_exchange_screen": False},
    # the solid-harmonic fit, D to rmsd 1e-9, the default screens
    "sph rmsd 1e-9": {**TIGHT, "dele": 1e-11, "rmsd": 1e-9},
    # ... D to rmsd 1e-11, every pair above 1e-12, no exchange screen
    "sph rmsd 1e-11 unscreened": {**TIGHT, "dele": 1e-10, "rmsd": 1e-11,
                                  "df_sigma": 1e-12,
                                  "df_exchange_screen": False},
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--waters", type=int, default=None,
                    help="the first N waters of w32 (default: all 32)")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names of VARIANTS")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("grad_fit_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import juliachem_jl_tpu_torch as jc
    from juliachem_jl_tpu_torch.models import gradient, rhf
    from juliachem_jl_tpu_torch.models.optimize import molecule_at

    smi = smoke.sh("nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader").splitlines()[0]
    tag = f"[{smi}]"
    dev = jc.initialize("cuda")
    h, tol = smoke.W_GRAD_FD_STEP, smoke.W_GRAD_FD_TOL
    out = {"device": smi, "fd_step": h, "fd_tol": tol, "variants": {}}
    for name in args.variants.split(","):
        flags_in = VARIANTS[name]
        inp = smoke.cluster_input("w32", flags_in, waters=args.waters)
        rec = {"keywords": flags_in}
        out["variants"][name] = rec
        try:
            p = jc.io.parse_input(inp)
            mol = jc.molecule.run(p)
            flags = dict(p.scf_keywords)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            tm = {}
            t0 = time.perf_counter()
            res = gradient.run(mol, jc.basis.run(mol, p.model), flags,
                               timings=tm)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            g = res["Gradient"].cpu().numpy()
            rec.update(energy=float(res["Energy"]),
                       iterations=int(res["Iterations"]),
                       converged=bool(res["Converged?"]),
                       scf_s=res["Timings"].run_time,
                       gradient_s=wall - res["Timings"].run_time,
                       parts_ms={k: 1e3 * v for k, v in tm.items()
                                 if k != "work"},
                       peak_device_bytes=torch.cuda.max_memory_allocated(dev),
                       sum_abs_max=float(abs(g.sum(axis=0)).max()), fd={})
            print(f"{tag} {name} ({mol.natom} atoms): {rec['iterations']} "
                  f"iterations (converged {rec['converged']}), E = "
                  f"{rec['energy']:.10f} Eh, SCF {rec['scf_s']:.2f} s, "
                  f"gradient {rec['gradient_s']:.2f} s (parts ms: "
                  + ", ".join(f"{k} {v:.1f}"
                              for k, v in rec["parts_ms"].items())
                  + f"), peak {rec['peak_device_bytes'] / 1e9:.3f} GB, "
                  f"|sum g| {rec['sum_abs_max']:.2e}", flush=True)
            x0 = mol.coords.reshape(-1)
            for k, d in ((mol.symbols.index("O"), 2),
                         (mol.symbols.index("H"), 0)):
                es = []
                for sgn in (+1, -1):
                    x = x0.copy()
                    x[3 * k + d] += sgn * h
                    m = molecule_at(mol, x)
                    r = rhf.energy(m, jc.basis.run(m, p.model), flags)
                    es.append((float(r["Energy"]), bool(r["Converged?"])))
                fd = (es[0][0] - es[1][0]) / (2 * h)
                key = f"{mol.symbols[k]}{k} {'xyz'[d]}"
                rec["fd"][key] = {"fd": fd, "analytic": float(g[k][d]),
                                  "diff": fd - float(g[k][d]),
                                  "converged": [e[1] for e in es]}
                print(f"{tag} {name}: d E / d {key}: finite differences "
                      f"{fd:.9f}, analytic {g[k][d]:.9f}, difference "
                      f"{fd - g[k][d]:.3e} Eh/bohr (the smoke's bound {tol}"
                      f"; displaced SCFs converged "
                      f"{[e[1] for e in es]})", flush=True)
            rec["within_tol"] = bool(all(
                abs(v["diff"]) <= tol for v in rec["fd"].values()))
        except Exception as exc:   # report it and go on with the next
            rec["error"] = f"{type(exc).__name__}: {exc}"
            print(f"{tag} {name}: failed: {rec['error']}", flush=True)
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1, default=float))
    print(json.dumps({k: {"within_tol": v.get("within_tol"),
                          "diffs": {kk: vv["diff"]
                                    for kk, vv in v.get("fd", {}).items()},
                          "peak_GB": v.get("peak_device_bytes", 0) / 1e9,
                          "error": v.get("error")}
                      for k, v in out["variants"].items()}), flush=True)
    return 0 if all("error" not in v for v in out["variants"].values()) \
        else 1


if __name__ == "__main__":
    sys.exit(main())
