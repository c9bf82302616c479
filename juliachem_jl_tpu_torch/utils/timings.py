"""Timing / telemetry registry.

Parity with reference src/shared/JCTiming.jl + JCTiming_Setters.jl: a single
object threaded through the SCF recording per-phase and per-iteration wall
times keyed by string constants, plus non-timing metadata (options, basis
sizes, convergence), serializable to JSON/HDF5.

Keys follow the reference's JCTC namespace (JCTiming.jl:15-105) so downstream
analysis tooling translates directly.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager


class JCTC:
    """String key constants (subset of reference JCTiming.jl JCTC)."""

    run_time = "run_time"
    fock_time = "fock_time"
    iteration_time = "iteration_time"
    two_electron_integrals = "two_electron_integrals"
    screening_time = "screening_time"
    B_time = "B_time"
    W_time = "W_time"
    J_time = "J_time"
    K_time = "K_time"
    V_time = "V_time"
    H_time = "H_time"
    density_time = "density_time"
    three_center_time = "three_center_integrals_time"
    two_center_time = "two_center_integrals_time"
    form_J_AB_inv_time = "form_J_AB_inv_time"
    diis_time = "diis_time"
    eigensolve_time = "eigensolve_time"
    guess_time = "guess_time"
    device_memory_bytes = "device_memory_bytes"
    scf_data_bytes = "scf_data_bytes"
    scf_energy = "scf_energy"
    converged = "converged"
    n_basis_functions = "n_basis_functions"
    n_auxiliary_basis_functions = "n_auxiliary_basis_functions"
    n_electrons = "n_electrons"
    n_occupied_orbitals = "n_occupied_orbitals"
    n_iterations = "n_iterations"
    contraction_mode = "contraction_mode"
    gpu_num_devices = "num_devices"


def iteration_key(key: str, iteration: int) -> str:
    """Reference JCTiming_key (JCTiming.jl:135-139)."""
    return f"{key}-{iteration}"


def device_key(key: str, iteration: int, device: int) -> str:
    """Reference JCTiming_GPUkey (JCTiming.jl:141-145)."""
    return f"{key}-{iteration}-DEVICE-{device}"


class Timings:
    """Mutable run-wide telemetry (reference JCTiming struct, JCTiming.jl:111-120)."""

    def __init__(self, run_name: str = "default"):
        self.run_name = run_name
        self.run_time = 0.0
        self.converged = False
        self.scf_energy = 0.0
        self.timings: dict[str, float] = {}
        self.non_timing_data: dict[str, str] = {}
        self.user_options: dict[str, str] = {}
        self.options: dict[str, str] = {}

    # -- setters (reference JCTiming_Setters.jl) ------------------------------
    def set_user_options(self, scf_flags: dict | None) -> None:
        for k, v in (scf_flags or {}).items():
            self.user_options[str(k)] = str(v)

    def set_options(self, opts) -> None:
        for k, v in opts.to_dict().items():
            self.options[str(k)] = str(v)

    def set_basis_info(self, nbf: int, nels: int, naux: int | None = None) -> None:
        self.non_timing_data[JCTC.n_basis_functions] = str(nbf)
        self.non_timing_data[JCTC.n_electrons] = str(nels)
        self.non_timing_data[JCTC.n_occupied_orbitals] = str(nels // 2)
        if naux is not None:
            self.non_timing_data[JCTC.n_auxiliary_basis_functions] = str(naux)

    def set_converged(self, converged: bool, energy: float, n_iterations: int) -> None:
        self.converged = bool(converged)
        self.scf_energy = float(energy)
        self.non_timing_data[JCTC.converged] = str(bool(converged))
        self.non_timing_data[JCTC.n_iterations] = str(n_iterations)

    # -- recording ------------------------------------------------------------
    def record(self, key: str, seconds: float, iteration: int | None = None) -> None:
        if iteration is not None:
            key = iteration_key(key, iteration)
        self.timings[key] = float(seconds)

    @contextmanager
    def timed(self, key: str, iteration: int | None = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(key, time.perf_counter() - t0, iteration)

    # -- serialization (analog of jc_timings_write.jl HDF5 dump) --------------
    def to_dict(self) -> dict:
        return {
            "run_name": self.run_name,
            "run_time": self.run_time,
            "converged": self.converged,
            "scf_energy": self.scf_energy,
            "timings": self.timings,
            "non_timing_data": self.non_timing_data,
            "user_options": self.user_options,
            "options": self.options,
        }

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)

    def save_hdf5(self, path: str) -> None:
        import h5py

        with h5py.File(path, "w") as f:
            f.attrs["run_name"] = self.run_name
            f.attrs["run_time"] = self.run_time
            f.attrs["converged"] = self.converged
            f.attrs["scf_energy"] = self.scf_energy
            tg = f.create_group("timings")
            for k, v in self.timings.items():
                tg.attrs[k] = v
            for name, d in (
                ("non_timing_data", self.non_timing_data),
                ("user_options", self.user_options),
                ("options", self.options),
            ):
                g = f.create_group(name)
                for k, v in d.items():
                    g.attrs[k] = v
