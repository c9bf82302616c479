"""Multi-process smoke test of the rank grid.

Port of ``juliachem_jl_tpu/parallel/dist_smoke.py``: the analog of running
the reference under ``mpiexec -n 2`` (JCRuntime.jl:6-16 MPI.Init + the rank
grid of GPUDF.jl:1011-1055).  ``run_smoke`` starts n ranks
(``parallel.launch.spawn``); each goes through ``initialize_distributed``
(torchrun's variables, set by the launcher) and ``make_global_mesh``, sums
its block of one array over both grid axes with ``all_reduce``, and gathers
one row per rank; the parent checks that every rank agrees with the whole
array's sum.
"""

from __future__ import annotations

import numpy as np
import torch


def _child(k_axis: int, device: str) -> dict:
    from . import mesh as mesh_mod

    m = mesh_mod.make_global_mesh(k_axis, device)
    nq, nk = m.nq, m.nk
    x = np.arange(nq * 3 * nk * 5, dtype=np.float64).reshape(nq * 3, nk * 5)
    blk = torch.as_tensor(
        x[m.q_index * 3:(m.q_index + 1) * 3, m.k_index * 5:(m.k_index + 1) * 5],
        device=m.device)
    total, = m.all_reduce_cat(blk.sum().reshape(1))
    ranks = m.all_gather(torch.tensor([float(m.rank)], dtype=torch.float64,
                                      device=m.device))
    return {"rank": m.rank, "world": m.world, "backend": m.backend,
            "mesh": [nq, nk], "psum": float(total[0]), "want": float(x.sum()),
            "gathered": [int(r) for r in ranks.tolist()]}


def run_smoke(n_procs: int = 2, k_axis: int = 1, backend: str = "gloo",
              device: str = "cpu", timeout: float = 300.0) -> list[dict]:
    """Start ``n_procs`` ranks, run the child, and assert every rank
    agrees.  Returns the per-rank results in rank order."""
    from .launch import spawn

    results = spawn(_child, n_procs, args=(k_axis, device), backend=backend,
                    device=device, timeout=timeout)
    for r in results:
        if r["world"] != n_procs or r["mesh"][0] * r["mesh"][1] != n_procs:
            raise RuntimeError(f"distributed smoke: rank grid {r}")
        if abs(r["psum"] - r["want"]) > 1e-9:
            raise RuntimeError(f"distributed smoke: sum {r['psum']} != "
                               f"{r['want']}")
        if r["gathered"] != list(range(n_procs)):
            raise RuntimeError(f"distributed smoke: gathered {r['gathered']}")
    return results
