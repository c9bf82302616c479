"""SCF driver: the Roothaan-Hall / DIIS iteration loop.

Port of ``juliachem_jl_tpu/models/scf.py`` (reference rhf_kernel /
scf_cycles_kernel, src/rhf/energy/SCF.jl:69-592) with a pluggable Fock
builder.  D, F and C stay on the calculation's device; Python scalars are
taken only where the loop tests convergence or gates DIIS.  Same semantics
as the JAX package: the mixed-precision f32 phase, DIIS gating, dynamic
damping, the optional level shift and the energy-stagnation exit.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass

import torch

from ..ops.oei import overlap_kinetic_nuclear
from ..utils import constants as C
from ..utils.options import SCFOptions
from ..utils.timings import JCTC, Timings
from . import linalg


@dataclass
class SCFState:
    """Carries everything the iteration loop mutates (analog of SCFData,
    src/shared/SCFData.jl:19-37).  Matrices are tensors on one device."""

    H: torch.Tensor
    S: torch.Tensor
    X: torch.Tensor
    nocc: int
    F: torch.Tensor = None
    D: torch.Tensor = None
    C: torch.Tensor = None
    eps: torch.Tensor = None
    energy_elec: float = 0.0
    iteration: int = 0
    stagnated: bool = False  # converged via the energy-stagnation exit


class FockBuilder:
    """Interface: given the (factor-2) density D, return the two-electron part
    G[D] = J - 0.5 K so that F = H + G[D].  Builders that exploit the
    occupied MO factorization (DF) use C_occ when available."""

    supports_f32_phase = False

    def two_electron_fock(self, D: torch.Tensor, iteration: int,
                          timings: Timings, C_occ=None,
                          precision: str = "f64") -> torch.Tensor:
        raise NotImplementedError

    def finalize(self):  # release per-geometry tensors
        pass


def electronic_energy(D, H, F) -> float:
    """E_elec = 1/2 sum D (H + F)  (reference SCF.jl:1110-1125 convention,
    D = 2 C_occ C_occ^T)."""
    return 0.5 * float(torch.sum(D * (H + F)))


def scf_loop(state: SCFState, fock_builder: FockBuilder, opts: SCFOptions,
             timings: Timings, e_nuc: float, output: int = 0,
             max_iterations: int | None = None,
             energy_convergence: float | None = None,
             density_convergence: float | None = None) -> bool:
    """Iterate to convergence; returns True if converged.

    Convergence test: |dE| <= dele and rms(dD) <= rmsd (SCF.jl:549); the
    keyword arguments override the options' limits (the DF-guess warm-up).
    """
    dele = (opts.energy_convergence if energy_convergence is None
            else energy_convergence)
    rmsd = (opts.density_convergence if density_convergence is None
            else density_convergence)
    niter = opts.max_iterations if max_iterations is None else max_iterations

    diis = linalg.DIIS(max_vec=opts.ndiis)
    E_old = state.energy_elec
    D_old = state.D.clone() if state.D is not None else None
    F_old = None
    last_dE = 1.0e9
    supports_f32 = fock_builder.supports_f32_phase
    fp32_phase = bool(opts.mixed_precision and supports_f32)
    last_drms = 1.0e9
    converged = False
    # Energy-stagnation exit (juliachem_jl_tpu/models/scf.py:157-176): when
    # the energy spread over the last stall_window+1 f64 iterations is
    # <= 100*dele, d_rms has stopped improving and we are inside the
    # convergence basin, declare convergence and mark it (state.stagnated).
    # On exact-f64 builds d_rms keeps shrinking under DIIS, so this rarely
    # fires before the plain test.
    stag_gate = max(1.0e-4, 10.0 * rmsd)
    stall_window = 3
    e_window: deque = deque(maxlen=stall_window + 1)
    stall_count = 0
    best_drms = 1.0e9
    dev = state.H.device

    if output >= 2:
        print(f"{'iter':>4s} {'E total':>20s} {'dE':>12s} {'D rms':>12s} {'t (s)':>8s}")

    for it in range(1, niter + 1):
        t_it = time.perf_counter()
        state.iteration = it

        C_occ = state.C[:, : state.nocc] if state.C is not None else None
        # mixed-precision phase control: leave f32 once the density step is
        # small (scale-free criterion), or after half the iteration budget
        # (and never converge from an f32 iteration)
        if fp32_phase and (last_drms < opts.mixed_precision_switch
                           or it > niter // 2):
            fp32_phase = False
        precision = "f32" if fp32_phase else "f64"
        if fp32_phase:
            # marker so consumers can split per-iteration Fock times by
            # precision phase instead of reporting a blended mean
            timings.record("fock_f32", 1.0, it)
        with timings.timed(JCTC.fock_time, it):
            G = fock_builder.two_electron_fock(state.D, it, timings, C_occ,
                                               precision=precision)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        F = state.H + G

        # DIIS on e = F D S - S D F; wild early Fock matrices are kept out of
        # the subspace until the commutator is moderate (the JAX package's
        # deliberate deviation from SCF.jl:472-501)
        with timings.timed(JCTC.diis_time, it):
            e_vec = F @ state.D @ state.S - state.S @ state.D @ F
            e_max = float(e_vec.abs().max())
            if e_max < 10.0:
                diis.push(F, e_vec)
            F_diis = diis.extrapolate() if diis.size > 0 else F

        # dynamic damping for early iterations (SCF.jl:504-505)
        if opts.damp and F_old is not None:
            x = linalg.damping_factor(last_dE)
            if x < 1.0:
                F_diis = x * F_diis + (1.0 - x) * F_old
        F_old = F

        # virtual level shift on the Roothaan-step Fock only, released once
        # the density step is inside the basin
        if opts.level_shift > 0.0 and last_drms > 1.0e-4:
            SDS = state.S @ (0.5 * state.D) @ state.S
            F_diis = F_diis + opts.level_shift * (state.S - SDS)

        with timings.timed(JCTC.eigensolve_time, it):
            eps, Cmo, D = linalg.roothaan_step(F_diis, state.X, state.nocc)

        E_elec = electronic_energy(D, state.H, F)
        if not math.isfinite(E_elec) or abs(E_elec) > 1.0e8:
            # a NaN/inf energy never recovers (it poisons DIIS and the
            # density): stop and report a clean convergence failure
            state.F, state.D, state.C, state.eps = F, D, Cmo, eps
            state.energy_elec = E_elec
            return False
        dE = E_elec - E_old
        last_dE = dE
        d_rms = (float(torch.sqrt(torch.mean((D - D_old) ** 2)))
                 if D_old is not None else 1.0)
        last_drms = d_rms

        state.F, state.D, state.C, state.eps = F, D, Cmo, eps
        state.energy_elec = E_elec
        E_old, D_old = E_elec, D

        t_el = time.perf_counter() - t_it
        timings.record(JCTC.iteration_time, t_el, it)
        # memory telemetry each iteration (DensityFitting.jl:226-228 analog)
        state_b = sum(int(a.numel() * a.element_size())
                      for a in (state.H, state.S, state.X, state.F, state.D,
                                state.C) if a is not None)
        timings.record(JCTC.scf_data_bytes, float(state_b), it)
        if dev.type == "cuda":
            timings.record(JCTC.device_memory_bytes,
                           float(torch.cuda.memory_allocated(dev)), it)
        if output >= 2:
            print(f"{it:4d} {E_elec + e_nuc:20.10f} {dE:12.3e} {d_rms:12.3e} "
                  f"{t_el:8.2f}")

        if abs(dE) <= dele and d_rms <= rmsd:
            if fp32_phase:
                # never declare convergence off an f32 Fock: drop to f64 and
                # keep iterating
                fp32_phase = False
            else:
                converged = True
                break

        if fp32_phase:
            e_window.clear()
            stall_count = 0
        else:
            e_window.append(E_elec)
            spread = max(e_window) - min(e_window)
            if (len(e_window) == e_window.maxlen and spread <= 100.0 * dele
                    and d_rms <= stag_gate and d_rms >= 0.5 * best_drms):
                stall_count += 1
                if stall_count >= stall_window:
                    converged = True
                    state.stagnated = True
                    if output >= 2:
                        print(f"  converged via energy-stagnation exit "
                              f"(E spread {spread:.1e} over last "
                              f"{len(e_window)} iters; d_rms floor "
                              f"{d_rms:.2e} > rmsd {rmsd:.1e})")
                    break
            else:
                stall_count = 0
        best_drms = min(best_drms, d_rms)
    return converged


def energy_weighted_density(state: SCFState) -> torch.Tensor:
    """W = 2 sum_occ eps_i C_i C_i^T (reference SCF.jl:577-586)."""
    Cocc = state.C[:, : state.nocc]
    return 2.0 * (Cocc * state.eps[: state.nocc][None, :]) @ Cocc.T


def initial_state(mol, basis, opts: SCFOptions, timings: Timings, device,
                  output: int = 0) -> SCFState:
    """Hamiltonian core pieces + orthogonalizer + guess density."""
    with timings.timed(JCTC.H_time):
        S, T, V = overlap_kinetic_nuclear(basis, mol, device)
    H = T + V
    X = linalg.orthogonalizer(S)
    nocc = basis.nels // 2
    if basis.nels % 2 != 0:
        raise ValueError(
            f"RHF requires an even number of electrons (got {basis.nels})"
        )
    state = SCFState(H=H, S=S, X=X, nocc=nocc)

    with timings.timed(JCTC.guess_time):
        if opts.guess == C.Guess.sad:
            from .guess import sad_guess

            state.D = sad_guess(mol, basis, device)
            state.F = None
        else:  # hcore guess (F = H): SCF.jl:107-117
            eps, Cmo, D = linalg.roothaan_step(H, X, nocc)
            state.eps, state.C, state.D = eps, Cmo, D
            state.F = H.clone()
            state.energy_elec = electronic_energy(state.D, H, H)
    return state
