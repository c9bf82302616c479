"""RHF energy driver (API parity with JCRHF.Energy.run, src/rhf/energy/Energy.jl).

Port of ``juliachem_jl_tpu/models/rhf.py``: density-fitted and conventional
(direct-SCF) RHF, and the DF guess (DF iterations, then conventional).  Returns
the same result dictionary shape as the JAX package (Fock, Density, W, MO
Coeff, MO Energies, Overlap as tensors on the calculation's device; Energy,
Converged?, Iterations, Timings).  The route taken is recorded in
``Timings.non_timing_data["fock_builder"]``.
"""

from __future__ import annotations

import os
import time

from .. import config
from ..utils import constants as C
from ..utils.options import create_scf_options, print_scf_options
from ..utils.timings import JCTC, Timings
from . import scf as scf_mod

# keywords of the JAX package this port does not run yet -> ROADMAP.md item
_NOT_PORTED = {
    "restart": "A4 (SCF checkpoints)",
    "checkpoint": "A4 (SCF checkpoints)",
    "df_b_cache": "A4 (B caches)",
    "oei_cache": "A4 (one-electron caches)",
    "fdiff": "A4 (incremental Fock)",
    "fdiff_f32": "A4 (incremental Fock)",
    "debug": "A4 (debug dumps)",
    "wall_deadline": "A5 (bench deadline)",
    "bench_fock_reps": "A5 (bench timing reps)",
}


def _check_ported(scf_flags: dict, opts) -> None:
    for key, item in _NOT_PORTED.items():
        if scf_flags.get(key):
            raise NotImplementedError(
                f"scf keyword {key!r} is not ported yet (ROADMAP.md {item})")
    if opts.num_devices > 1:
        raise NotImplementedError(
            "num_devices > 1 is not ported yet (ROADMAP.md A11)")
    if str(opts.df_b_dtype) != "f64":
        raise NotImplementedError(
            "df_b_dtype 'f32' is not ported yet (ROADMAP.md B16)")


def _conventional_builder(basis, opts, device):
    """Conventional branch of the JAX package's router (models/rhf.py:79-96),
    reading the same environment: DenseFock for contraction_mode "dense" up
    to 160 functions; StreamingDirectFock past JCHEM_CONV_STREAM_THRESHOLD
    (3e7) screened quartets or with JCHEM_CONV_STREAM=1 (0 never);
    ScreenedDirectFock otherwise (in-core while its ERIs fit
    JCHEM_INCORE_BUDGET)."""
    from ..ops.fock import (DEFAULT_CUTOFF, DenseFock, ScreenedDirectFock,
                            schwarz_blocks)
    from ..ops.fock_stream import StreamingDirectFock, count_screened_quartets

    if opts.contraction_mode == C.ContractionMode.dense and basis.nbf <= 160:
        return DenseFock(basis, device)
    # the Schwarz diagonal, computed once for the count and the builder
    schwarz = schwarz_blocks(basis, DEFAULT_CUTOFF, 1.0e-4, device)
    force = os.environ.get("JCHEM_CONV_STREAM")
    if force == "1":
        return StreamingDirectFock(basis, device=device, schwarz=schwarz)
    if force != "0":
        thresh = float(os.environ.get("JCHEM_CONV_STREAM_THRESHOLD", 3e7))
        if count_screened_quartets(basis, device=device,
                                   schwarz=schwarz) > thresh:
            return StreamingDirectFock(basis, device=device, schwarz=schwarz)
    return ScreenedDirectFock(basis, device=device, schwarz=schwarz)


def _make_fock_builder(basis_sets, opts, device, prefer_df: bool,
                       timings=None):
    """The JAX package's router (models/rhf.py:21-96): for DF, dense B while
    it stays under 2 GB, else the packed screened builder; conventional
    builders otherwise."""
    from .df import DFFockBuilder
    from .df_screened import ScreenedDFFockBuilder

    if not prefer_df:
        # Schwarz diagonal + quartet enumeration
        with (timings or Timings()).timed("conventional_setup_time"):
            return _conventional_builder(basis_sets.primary, opts, device)
    if basis_sets.auxiliary is None:
        raise ValueError(
            "density-fitted SCF requires an auxiliary basis "
            "(model['auxiliary_basis'])"
        )
    nbf, A = basis_sets.primary.nbf, basis_sets.auxiliary.nbf
    dense_bytes = A * nbf * nbf * 8
    mode = opts.contraction_mode
    use_screened = (
        mode == C.ContractionMode.screened
        or (mode == C.ContractionMode.default and not opts.df_force_dense
            and dense_bytes > 2.0e9)
    )
    cls = ScreenedDFFockBuilder if use_screened else DFFockBuilder
    return cls.build(basis_sets.primary, basis_sets.auxiliary, opts, device,
                     timings=timings)


def energy(mol, basis_sets, scf_flags: dict | None = None, output: int = 0,
           device=None) -> dict:
    """Compute the RHF (or DF-RHF) energy on ``device`` (default: the one
    given to ``initialize``, the card unless it named the CPU).

    scf_flags follows the reference keyword surface (Constants.jl), e.g.
    {"scf_type": "df", "guess": "sad", "niter": 100, "dele": 1e-8, "rmsd": 1e-6}.
    """
    device = config.resolve_device(device)
    t0 = time.perf_counter()
    scf_flags = scf_flags or {}
    opts = create_scf_options(scf_flags)
    _check_ported(scf_flags, opts)
    if getattr(basis_sets, "spherical", False):
        raise NotImplementedError(
            "the spherical-harmonic AO basis is not ported yet (ROADMAP.md A4)")
    timings = Timings()
    timings.set_user_options(scf_flags)
    timings.set_options(opts)

    primary = basis_sets.primary
    timings.set_basis_info(
        primary.nbf, primary.nels,
        basis_sets.auxiliary.nbf if basis_sets.auxiliary is not None else None,
    )
    if output >= 1:
        print_scf_options(opts)

    e_nuc = mol.nuclear_repulsion()
    state = scf_mod.initial_state(mol, primary, opts, timings, device, output)
    use_df = opts.scf_type == C.SCFType.density_fitting
    df_guess = opts.guess == C.Guess.density_fitting
    fock_builder = _make_fock_builder(basis_sets, opts, device,
                                      use_df or df_guess, timings)
    if df_guess and not use_df:
        # DF warm-up phase, then conventional iterations (SCF.jl:527-550)
        scf_mod.scf_loop(
            state, fock_builder, opts, timings, e_nuc, output,
            max_iterations=opts.df_max_iterations,
            energy_convergence=opts.df_energy_convergence,
            density_convergence=opts.df_density_convergence,
        )
        fock_builder.finalize()
        timings.non_timing_data["df_guess_builder"] = type(
            fock_builder).__name__
        timings.non_timing_data["df_guess_iterations"] = str(state.iteration)
        fock_builder = _make_fock_builder(basis_sets, opts, device, False,
                                          timings)
    timings.non_timing_data["fock_builder"] = type(fock_builder).__name__
    if hasattr(fock_builder, "incore"):
        timings.non_timing_data["incore"] = str(fock_builder.incore)
    timings.non_timing_data["device"] = str(device)

    converged = scf_mod.scf_loop(state, fock_builder, opts, timings, e_nuc,
                                 output)
    fock_builder.finalize()

    E_total = state.energy_elec + e_nuc
    timings.set_converged(converged, E_total, state.iteration)
    timings.run_time = time.perf_counter() - t0
    timings.record(JCTC.run_time, timings.run_time)
    timings.scf_energy = E_total

    if output >= 1:
        tag = "" if converged else " (NOT CONVERGED)"
        print(f"Total SCF Energy: {E_total:.10f} h{tag}")

    error = None
    if not converged:
        # QCSchema-style error payload (reference SCF.jl:201-222)
        error = {
            "error_type": "convergence_error",
            "error_message": (
                f"SCF did not converge in {state.iteration} iterations "
                f"(dele={opts.energy_convergence}, rmsd={opts.density_convergence})"
            ),
            "success": False,
        }

    W = scf_mod.energy_weighted_density(state) if state.C is not None else None
    return {
        "Error": error,
        "Fock": state.F,
        "Density": state.D,
        "W": W,
        "MO Coeff": state.C,
        "MO Energies": state.eps,
        "Overlap": state.S,
        "Energy": E_total,
        "Energy Elec": state.energy_elec,
        "E Nuc": e_nuc,
        "Converged?": converged,
        "Stagnated": state.stagnated,
        "Iterations": state.iteration,
        "Timings": timings,
    }

