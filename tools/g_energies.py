#!/usr/bin/env python3
"""The g-basis energies of chip_smoke.py's phase 11 for one tree, on one
NVIDIA GPU.

    python3 tools/g_energies.py [--root DIR] [--out result.json]

Builds the kernels of the package under ``--root`` (default: this
checkout; another, such as a parent commit unpacked beside it, so that two
trees' energies can be held to each other), then runs to convergence, with
the inputs of the smoke's phase 11, made by its own constructors
(``chip_smoke.g_input``, ``chip_smoke.w2_input``): ``benzene_2_water``
DF-RHF and ``ethene_ethyne_2`` DF-RHF in 6-311++G(3df,3pd)+G
(tests/data/6-311ppG_3df_3pd_G.gbs) with ``mixed_precision`` false, and
the first 2 waters of w32 conventional from SAD.  Prints each energy to 1e-12 Eh beside the JAX package's recorded one
where there is one (``smoke_reference.json`` ``g_shell``); every line names
the card and its power limit.  Needs CUDA; exits 2 without it.
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
        print("g_energies: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import juliachem_jl_tpu_torch as jc

    if Path(jc.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {jc.__file__}, not the package under "
                           f"{root}")
    smi = smoke.sh("nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader").splitlines()[0]
    tag = f"[{smi}] [{root.name}]"
    jc.initialize("cuda")
    goldens = json.loads((HERE / "tests" / "data" /
                          "s22x3_gamess_goldens.json").read_text())
    refs = json.loads((HERE / "juliachem_jl_tpu_torch" / "data" /
                       "smoke_reference.json").read_text())["g_shell"][
        "systems"]
    g = smoke.G_BASIS
    nomp = {"mixed_precision": False}
    systems = {
        f"benzene_2_water {g} DF": smoke.g_input(
            "benzene_2_water", goldens["benzene_2_water"], nomp),
        f"ethene_ethyne_2 {g} DF": smoke.g_input(
            "ethene_ethyne_2", goldens["ethene_ethyne_2"], nomp),
        f"w2 {g} RHF": smoke.w2_input(g, smoke.G_BASIS_FILE)}
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "root": str(root), "energies": {}}
    for name, inp in systems.items():
        res = jc.run_spec(jc.io.parse_input(inp))["Energy"]
        E = float(res["Energy"])
        ref = refs.get(name, {}).get("energy")
        out["energies"][name] = {"energy": E, "converged":
                                 bool(res["Converged?"]),
                                 "iterations": int(res["Iterations"]),
                                 "jax": ref}
        print(f"{tag} {name}: E = {E:.12f} Eh, converged "
              f"{bool(res['Converged?'])} in {int(res['Iterations'])} "
              "iterations" + (f", E - JAX = {E - ref:.3e}" if ref is not None
                              else ""), flush=True)
    jc.finalize()
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
