"""Multi-device DF Fock builder: the production sharded path.

Port of ``juliachem_jl_tpu/models/df_sharded.py``.  ``num_devices`` (SCF
keyword, Constants.jl GPUAlgorithms.num_devices analog) routes rhf.energy
here when the program runs as a process group of that many ranks: each rank
builds its own Q rows of packed B (parallel/build.py, GPUDF.jl:828-1008
analog) and every Fock build sweeps them through kernel K2 with one
all_reduce of the J/K partials (parallel/shard.py::packed_fock_step, the
MPI.Allreduce! analog).

Each rank holds A_pad / n rows of packed B: the memory axis that lets the
aux dimension scale with the device count (the reference's whole reason for
GPUDF's device partition).  The JAX package's sharded build reads none of
the large-system keywords (``df_b_dtype``, ``df_b_cache``); the port raises
on them under ``num_devices > 1`` (models/rhf.py) rather than ignoring them.
"""

from __future__ import annotations

import copy

import torch

from ..parallel.build import build_B_packed_sharded
from ..parallel.mesh import make_mesh
from ..parallel.shard import packed_fock_phases, packed_fock_step
from ..utils.options import create_scf_options
from ..utils.timings import JCTC, Timings
from .df import signed_factor
from .df_screened import ScreenedDFFockBuilder


class ShardedDFFockBuilder(ScreenedDFFockBuilder):
    """Packed screened-pq DF Fock over the ranks of a process group (one
    rank per device; ``num_devices`` = the group's size).  The Q-block
    sweep, the Coulomb vectors and the J scatter are the single-device
    builder's, on this rank's rows of B.  The JAX package's
    ``_signed_factor`` (the eigen-factor of D padded to 32 columns for its
    TPU tiles) is ``df.signed_factor`` here, without the padding."""

    def __init__(self, primary, auxiliary, opts=None,
                 timings: Timings | None = None, device=None, mesh=None):
        opts = opts if opts is not None else create_scf_options({})
        timings = timings or Timings()
        n = int(opts.num_devices or 1)
        self.mesh = mesh if mesh is not None else make_mesh(n, device=device)
        dev = self.mesh.device
        # the per-device budget, shared by the ranks that share the card
        budget = self.budgets(dev)[0] / self.mesh.share

        def check(rows, width):
            need = rows * width * 8
            if need > budget:
                raise MemoryError(
                    f"this rank's packed B [{rows}, {width}] float64 needs "
                    f"{need / 1e9:.1f} GB over the {budget / 1e9:.1f} GB "
                    "per-rank budget; run more ranks")

        B, screen, A_pad, _, _, ranges = build_B_packed_sharded(
            primary, auxiliary, self.mesh, opts, timings, check_budget=check)
        self.rows = ranges[self.mesh.rank]   # this rank's rows of the whole B
        # mixed-precision phase: an f32 copy beside the f64 rows when both
        # fit the per-device budget (the JAX package's B32 shard)
        per_dev_bytes = B.shape[0] * B.shape[1] * 12
        local = copy.copy(opts)
        local.mixed_precision = bool(opts.mixed_precision
                                     and per_dev_bytes <= budget)
        super().__init__(B, screen, local, primary.nels // 2)
        self.profile = bool(opts.profile_fock)
        nt = timings.non_timing_data
        nt[JCTC.gpu_num_devices] = str(n)
        nt["B_shape"] = str([A_pad, B.shape[1]])
        # per-device telemetry (JCTiming GPU-key analog): each rank owns
        # A_pad / n rows of packed B
        for r in range(n):
            nt[f"device_B_rows-DEVICE-{r}"] = str(B.shape[0])
            nt[f"device_B_bytes-DEVICE-{r}"] = str(B.numel() * 8)

    def two_electron_fock(self, D, iteration, timings: Timings, C_occ=None,
                          precision: str = "f64"):
        use_f32 = precision == "f32" and self.supports_f32_phase
        fdt = torch.float32 if use_f32 else torch.float64
        d = torch.cat([D.reshape(-1)[self._pq_flat], D.new_zeros(1)]).to(fdt)
        if C_occ is None:
            Cs, s = signed_factor(D)
            Cs, s = Cs.to(fdt).contiguous(), s.to(fdt)
        else:
            Cs, s = C_occ.to(fdt).contiguous(), None
        if self.profile and not use_f32:
            return packed_fock_phases(self.mesh, self, d, Cs, s, iteration,
                                      timings)
        with timings.timed(JCTC.fock_time + "_device", iteration):
            return packed_fock_step(self.mesh, self,
                                    self.B32 if use_f32 else self.B, d, Cs, s)
