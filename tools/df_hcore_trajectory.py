#!/usr/bin/env python3
"""DF-RHF of one S22x3 system from the core-Hamiltonian guess with the
default dynamic damping: the DF phase that ``guess: "df"`` runs before its
conventional iterations.  Prints the SCF table of every iteration, then one
JSON line with the energies per iteration.

    env JAX_PLATFORMS=cpu python tools/df_hcore_trajectory.py jax benzene_2_water
    python tools/df_hcore_trajectory.py torch benzene_2_water     (on a GPU)

``jax`` runs the JAX package (juliachem_jl_tpu), ``torch`` the PyTorch port
(juliachem_jl_tpu_torch, on the card); each run imports only its own
package.  The JAX package on the CPU holds more than 16 GB of host memory
at benzene_2_water.  Geometry, basis (6-311++G(2d,2p)) and auxiliary basis
(cc-pVTZ-JKFIT) as in chip_smoke.py; ``mixed_precision`` off; 50 iterations,
the DF phase's budget (``df_niter``).
"""

from __future__ import annotations

import contextlib
import io
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BOHR = 0.52917724924
FLAGS = {"scf_type": "df", "guess": "hcore", "mixed_precision": False,
         "niter": 50, "dele": 1e-9, "rmsd": 1e-7}


def main() -> int:
    package, name = sys.argv[1], sys.argv[2]
    sys.path.insert(0, str(ROOT))
    if package == "jax":
        import juliachem_jl_tpu as jc
        device = {}
    elif package == "torch":
        import juliachem_jl_tpu_torch as jc
        device = {"device": "cuda"}
    else:
        raise SystemExit(f"unknown package {package!r}: jax or torch")
    g = json.loads((ROOT / "tests" / "data" /
                    "s22x3_gamess_goldens.json").read_text())[name]
    spec = jc.io.parse_input({
        "molecule": {"symbols": [a["symbol"] for a in g["atoms"]],
                     "geometry": [x * BOHR for a in g["atoms"]
                                  for x in a["xyz_bohr"]],
                     "molecular_charge": 0},
        "driver": "energy",
        "model": {"method": "RHF", "basis": g["basis"],
                  "auxiliary_basis": "cc-pVTZ-JKFIT"},
        "keywords": {"scf": FLAGS}})
    mol = jc.molecule.run(spec)
    bsets = jc.basis.run(mol, spec.model)
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = jc.models.rhf.energy(mol, bsets, spec.scf_keywords, output=2,
                                   **device)
    table = buf.getvalue()
    print(table, flush=True)
    energies = []
    for line in table.splitlines():
        f = line.split()
        if len(f) >= 5 and f[0].isdigit():
            energies.append(float(f[1]))
    print(json.dumps({"package": package, "system": name, "flags": FLAGS,
                      "converged": bool(res["Converged?"]),
                      "iterations": int(res["Iterations"]),
                      "energy": float(res["Energy"]), "energies": energies,
                      "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
