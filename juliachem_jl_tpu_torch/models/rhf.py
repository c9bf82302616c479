"""RHF energy driver (API parity with JCRHF.Energy.run, src/rhf/energy/Energy.jl).

Port of ``juliachem_jl_tpu/models/rhf.py``: density-fitted and conventional
(direct-SCF) RHF, and the DF guess (DF iterations, then conventional), on one
device or, with ``num_devices: n``, over the n ranks of a process group (the
sharded builders of models/df_sharded.py, ops/fock_sharded.py and
ops/fock_stream.py; every rank returns the same result).  Returns
the same result dictionary shape as the JAX package (Fock, Density, W, MO
Coeff, MO Energies, Overlap as tensors on the calculation's device; Energy,
Converged?, Stagnated, Deadline Hit, Iterations, Timings, and the
Spherical Transform T of a spherical-harmonic run, else None).  A
spherical run (``basis_sets.spherical``) wraps whichever builder the router
picks in ``scf.SphericalFockAdapter``.  The route taken is recorded in
``Timings.non_timing_data["fock_builder"]``.
"""

from __future__ import annotations

import os
import time

import torch

from .. import config
from ..parallel.mesh import check_world
from ..utils import constants as C
from ..utils.options import create_scf_options, print_scf_options
from ..utils.timings import JCTC, Timings
from . import scf as scf_mod

# keywords only the RHF loop runs (the JAX package's UHF/ROHF loops ignore
# them; the port's raise instead)
_RHF_ONLY = ("restart", "checkpoint", "oei_cache", "fdiff", "fdiff_f32",
             "wall_deadline", "bench_fock_reps", "debug")
# keywords the sharded builders do not run (the JAX package's router and
# sharded build ignore them under num_devices > 1; the port raises)
_SHARDED_REFUSES = {
    "df_b_dtype": lambda v: str(v) != "f64",
    "df_b_cache": bool,
    "df_force_dense": bool,
    "contraction_mode": lambda v: str(v).lower() == C.ContractionMode.dense,
}


def _check_ported(scf_flags: dict, opts, open_shell: bool = False) -> None:
    if opts.num_devices > 1:
        for key, refused in _SHARDED_REFUSES.items():
            if key in scf_flags and refused(scf_flags[key]):
                raise NotImplementedError(
                    f"scf keyword {key}={scf_flags[key]!r} with num_devices > "
                    "1: the sharded builders do not run it")
    check_world(opts.num_devices)
    for key in _RHF_ONLY if open_shell else ():
        if scf_flags.get(key):
            raise NotImplementedError(
                f"scf keyword {key!r} runs with RHF only")


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


def sharded_conventional_builder(basis, opts, device, timings=None):
    """The JAX package's conventional branch under num_devices > 1
    (models/rhf.py:57-78), reading the same environment: the sharded
    staircase builder past JCHEM_CONV_STREAM_THRESHOLD (3e7) screened
    quartets or with JCHEM_CONV_STREAM=1 (0 never), else the quartet-sharded
    direct builder."""
    from ..ops.fock import DEFAULT_CUTOFF, schwarz_blocks
    from ..ops.fock_sharded import ShardedDirectFock
    from ..ops.fock_stream import ShardedStreamingFock, count_screened_quartets
    from ..parallel.mesh import make_mesh

    mesh = make_mesh(opts.num_devices, device=device)
    schwarz = schwarz_blocks(basis, DEFAULT_CUTOFF, 1.0e-4, mesh.device)
    force = os.environ.get("JCHEM_CONV_STREAM")
    thresh = float(os.environ.get("JCHEM_CONV_STREAM_THRESHOLD", 3e7))
    if force == "1" or (force != "0" and count_screened_quartets(
            basis, device=mesh.device, schwarz=schwarz) > thresh):
        return ShardedStreamingFock(basis, mesh=mesh, timings=timings,
                                    schwarz=schwarz)
    return ShardedDirectFock(basis, mesh=mesh, timings=timings,
                             schwarz=schwarz)


def _make_fock_builder(basis_sets, opts, device, prefer_df: bool,
                       timings=None):
    """The JAX package's router (models/rhf.py:21-96): under num_devices > 1
    the sharded builders; for DF, dense B while it stays under 2 GB, else
    the packed screened builder; conventional builders otherwise."""
    from .df import DFFockBuilder
    from .df_screened import ScreenedDFFockBuilder

    if opts.num_devices > 1 and not prefer_df:
        with (timings or Timings()).timed("conventional_setup_time"):
            return sharded_conventional_builder(basis_sets.primary, opts,
                                                device, timings)
    if not prefer_df:
        # Schwarz diagonal + quartet enumeration
        with (timings or Timings()).timed("conventional_setup_time"):
            return _conventional_builder(basis_sets.primary, opts, device)
    if basis_sets.auxiliary is None:
        raise ValueError(
            "density-fitted SCF requires an auxiliary basis "
            "(model['auxiliary_basis'])"
        )
    if opts.num_devices > 1:
        from .df_sharded import ShardedDFFockBuilder

        return ShardedDFFockBuilder(basis_sets.primary, basis_sets.auxiliary,
                                    opts, timings=timings, device=device)
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

    # spherical-harmonic AO basis: every matrix of the SCF in the 2l+1
    # space, the builders Cartesian behind the adapter
    sph_T = scf_mod.spherical_transform(basis_sets, device)
    e_nuc = mol.nuclear_repulsion()
    fingerprint = scf_mod.system_fingerprint(mol, primary)
    if sph_T is not None:
        fingerprint = "sph:" + fingerprint
    restart_path = scf_flags.get("restart")
    if restart_path:
        state = scf_mod.load_checkpoint(restart_path, device, fingerprint,
                                        e_nuc)
    else:
        state = scf_mod.initial_state(mol, primary, opts, timings, device,
                                      output, sph_T=sph_T)
    use_df = opts.scf_type == C.SCFType.density_fitting
    df_guess = opts.guess == C.Guess.density_fitting
    fock_builder = scf_mod.wrap_spherical(_make_fock_builder(
        basis_sets, opts, device, use_df or df_guess, timings), sph_T)
    if df_guess and not use_df:
        # DF warm-up phase, then conventional iterations (SCF.jl:527-550)
        scf_mod.scf_loop(
            state, fock_builder, opts, timings, e_nuc, output,
            max_iterations=opts.df_max_iterations,
            energy_convergence=opts.df_energy_convergence,
            density_convergence=opts.df_density_convergence,
        )
        fock_builder.finalize()
        timings.non_timing_data["df_guess_builder"] = scf_mod.builder_name(
            fock_builder)
        timings.non_timing_data["df_guess_iterations"] = str(state.iteration)
        fock_builder = scf_mod.wrap_spherical(_make_fock_builder(
            basis_sets, opts, device, False, timings), sph_T)
    timings.non_timing_data["fock_builder"] = scf_mod.builder_name(
        fock_builder)
    timings.non_timing_data["spherical"] = str(sph_T is not None)
    if hasattr(fock_builder, "incore"):
        timings.non_timing_data["incore"] = str(fock_builder.incore)
    timings.non_timing_data["device"] = str(device)

    converged = scf_mod.scf_loop(
        state, fock_builder, opts, timings, e_nuc, output,
        checkpoint_path=scf_flags.get("checkpoint"),
        checkpoint_every=int(scf_flags.get("checkpoint_every", 5)),
        fingerprint=fingerprint)
    # timing reps: full Fock builds at the final density after the SCF,
    # results discarded, each marked "fock_rep" (the JAX package's
    # bench_fock_reps, models/rhf.py:170-186)
    reps = int(scf_flags.get("bench_fock_reps", 0))
    if reps > 0 and state.C is not None:
        C_occ = state.C[:, : state.nocc]
        for r in range(reps):
            if 0.0 < opts.wall_deadline < time.time():
                break
            it = state.iteration + 1 + r
            with timings.timed(JCTC.fock_time, it):
                fock_builder.two_electron_fock(state.D, it, timings, C_occ)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            timings.record("fock_rep", 1.0, it)
    fock_builder.finalize()
    if state.debug is not None:
        state.debug.close()

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
        "Deadline Hit": state.deadline_hit,
        "Iterations": state.iteration,
        "Timings": timings,
        # T [nbf_cart, nbf_sph] of a spherical-harmonic run, else None:
        # every matrix above is then in the spherical (computational) basis,
        # and properties, MP2 and gradients map through T
        "Spherical Transform": sph_T,
    }

