"""UHF energy driver: unrestricted (spin-polarized) Hartree-Fock.

Port of ``juliachem_jl_tpu/models/uhf.py``.  Two coupled Roothaan problems
share one Coulomb build:

    F_a = H + J(D_a + D_b) - K(D_a)
    F_b = H + J(D_a + D_b) - K(D_b)

with factor-1 spin densities D_s = C_s,occ C_s,occ^T, from the builders'
``two_electron_jk`` (two digestion passes on the conventional builders, one
V_Q and one W per spin on the DF builders).  D, F and C stay on the
calculation's device.  The result dict has the JAX package's keys (S^2,
multiplicity, spin density).  With ``num_devices: n`` the builders are the
sharded ones over the n ranks of a process group (ShardedDFJKBuilder, or
ShardedDirectFock for conventional), and the loop keeps every rank's state
bit-identical by broadcasting rank 0's (as models/scf.py does).  A
spherical-harmonic run projects H and S (and the SAD guess) and wraps the
builder in ``scf.SphericalFockAdapter``, as the JAX package does.
"""

from __future__ import annotations

import math
import time

import torch

from .. import config
from ..ops.oei import overlap_kinetic_nuclear
from ..utils import constants as C
from ..utils.options import create_scf_options
from ..utils.timings import JCTC, Timings
from . import linalg
from .rhf import _check_ported
from .scf import (builder_name, project_guess, spherical_transform,
                  wrap_spherical)


def _occupations(nels: int, multiplicity: int) -> tuple[int, int]:
    """(n_alpha, n_beta) from electron count and spin multiplicity 2S+1."""
    if multiplicity < 1:
        raise ValueError(f"multiplicity must be >= 1 (got {multiplicity})")
    n_unpaired = multiplicity - 1
    if (nels - n_unpaired) % 2 != 0 or nels < n_unpaired:
        raise ValueError(
            f"multiplicity {multiplicity} is impossible for {nels} electrons"
        )
    nb = (nels - n_unpaired) // 2
    return nb + n_unpaired, nb


def _spin_step(F, X, nocc):
    """Roothaan step for one spin channel: (eps, C, factor-1 density)."""
    eps, Cp = torch.linalg.eigh(X.T @ F @ X)
    Cmo = X @ Cp
    Cocc = Cmo[:, :nocc]
    return eps, Cmo, Cocc @ Cocc.T


def s_squared(Ca, Cb, S, na: int, nb: int) -> float:
    """<S^2> = Sz(Sz+1) + N_b - sum_ij |(C_a^T S C_b)_ij|^2 (occ x occ)."""
    sz = 0.5 * (na - nb)
    if na == 0 or nb == 0:
        return sz * (sz + 1.0)
    Sab = Ca[:, :na].T @ S @ Cb[:, :nb]
    return float(sz * (sz + 1.0) + nb - torch.sum(Sab ** 2))


def setup(mol, basis_sets, scf_flags, device):
    """What UHF and ROHF share before their loops: options (with the
    ``multiplicity`` keyword taken out), timings, occupations, H, S, X and
    the spin-resolved builder."""
    device = config.resolve_device(device)
    scf_flags = dict(scf_flags or {})
    multiplicity = int(scf_flags.pop(
        "multiplicity", getattr(mol, "multiplicity", 1)))
    guess_mix = float(scf_flags.pop("guess_mix", 0.0))
    opts = create_scf_options(scf_flags)
    _check_ported(scf_flags, opts, open_shell=True)
    timings = Timings()
    timings.set_user_options(scf_flags)
    timings.set_options(opts)
    primary = basis_sets.primary
    timings.set_basis_info(
        primary.nbf, primary.nels,
        basis_sets.auxiliary.nbf if basis_sets.auxiliary is not None else None)
    na, nb = _occupations(primary.nels, multiplicity)
    with timings.timed(JCTC.H_time):
        S, T, V = overlap_kinetic_nuclear(primary, mol, device)
    H = T + V
    S_cart = S
    sph_T = spherical_transform(basis_sets, device)
    if sph_T is not None:
        H = sph_T.T @ H @ sph_T
        S = sph_T.T @ S @ sph_T
    X = linalg.orthogonalizer(S)
    use_df = opts.scf_type == C.SCFType.density_fitting
    builder = wrap_spherical(
        make_jk_builder(basis_sets, opts, use_df, timings, device), sph_T)
    timings.non_timing_data["fock_builder"] = builder_name(builder)
    if hasattr(builder, "incore"):
        timings.non_timing_data["incore"] = str(builder.incore)
    timings.non_timing_data["spherical"] = str(sph_T is not None)
    timings.non_timing_data["device"] = str(device)
    return dict(opts=opts, timings=timings, multiplicity=multiplicity,
                guess_mix=guess_mix, na=na, nb=nb, S=S, S_cart=S_cart, H=H,
                X=X, builder=builder, device=device, sph_T=sph_T)


def finish(name: str, timings: Timings, opts, converged: bool, E_total: float,
           it: int, t0: float, output: int):
    """Record the run's totals; the QCSchema-style error of an unconverged
    run (or None)."""
    timings.set_converged(converged, E_total, it)
    timings.run_time = time.perf_counter() - t0
    timings.record(JCTC.run_time, timings.run_time)
    timings.scf_energy = E_total
    if output >= 1:
        tag = "" if converged else " (NOT CONVERGED)"
        print(f"Total {name} Energy: {E_total:.10f} h{tag}")
    if converged:
        return None
    return {
        "error_type": "convergence_error",
        "error_message": (
            f"{name} did not converge in {it} iterations "
            f"(dele={opts.energy_convergence}, "
            f"rmsd={opts.density_convergence})"),
        "success": False,
    }


def energy(mol, basis_sets, scf_flags: dict | None = None, output: int = 0,
           device=None) -> dict:
    """Compute the UHF (or DF-UHF) energy on ``device`` (default: the one
    given to ``initialize``, the card unless it named the CPU).

    Extra keywords over rhf.energy: ``multiplicity`` (default: from
    mol.multiplicity) and ``guess_mix`` (HOMO-LUMO mixing angle in radians
    applied to the initial guess; breaks spin symmetry for singlet
    diradicals, e.g. stretched H2).
    """
    t0 = time.perf_counter()
    st = setup(mol, basis_sets, scf_flags, device)
    opts, timings, builder = st["opts"], st["timings"], st["builder"]
    na, nb, S, H, X = st["na"], st["nb"], st["S"], st["H"], st["X"]
    dev = st["device"]
    e_nuc = mol.nuclear_repulsion()

    # --- initial guess -----------------------------------------------------
    Ca = Cb = None
    with timings.timed(JCTC.guess_time):
        if opts.guess == C.Guess.sad:
            from .guess import sad_guess

            Dt = sad_guess(mol, basis_sets.primary, dev)
            if st["sph_T"] is not None:
                Dt = project_guess(Dt, S, st["S_cart"], st["sph_T"])
            Da = Db = 0.5 * Dt
        else:  # hcore
            _, Ca, Da = _spin_step(H, X, na)
            _, Cb, Db = _spin_step(H, X, nb)
        if st["guess_mix"] != 0.0:
            if Ca is None:
                _, Ca, _ = _spin_step(H, X, na)
                _, Cb, _ = _spin_step(H, X, nb)
            # rotate the alpha HOMO into the LUMO (and beta oppositely) to
            # break spin symmetry
            c, s = math.cos(st["guess_mix"]), math.sin(st["guess_mix"])
            ch, cl = Ca[:, na - 1].clone(), Ca[:, na].clone()
            Ca[:, na - 1], Ca[:, na] = c * ch + s * cl, -s * ch + c * cl
            if nb > 0:
                bh, bl = Cb[:, nb - 1].clone(), Cb[:, nb].clone()
                Cb[:, nb - 1], Cb[:, nb] = c * bh - s * bl, s * bh + c * bl
            Da = Ca[:, :na] @ Ca[:, :na].T
            Db = Cb[:, :nb] @ Cb[:, :nb].T

    mesh = getattr(builder, "mesh", None)
    if mesh is not None:   # start every rank from rank 0's state
        Da, Db = Da.contiguous(), Db.contiguous()
        mesh.broadcast_(H, S, X, Da, Db, Ca, Cb)
    diis = linalg.DIIS(max_vec=opts.ndiis)
    E_old = 0.0
    Da_old, Db_old = Da.clone(), Db.clone()
    Fa_old = Fb_old = None
    last_dE = 1.0e9
    converged = False
    it = 0
    eps_a = eps_b = None
    Fa = Fb = None

    if output >= 2:
        print(f"{'iter':>4s} {'E total':>20s} {'dE':>12s} {'D rms':>12s} "
              f"{'t (s)':>8s}")

    for it in range(1, opts.max_iterations + 1):
        t_it = time.perf_counter()
        with timings.timed(JCTC.fock_time, it):
            J, Ka, Kb = builder.two_electron_jk(
                Da, Db, it, timings,
                Ca[:, :na] if Ca is not None else None,
                Cb[:, :nb] if Cb is not None else None)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        Fa = H + J - Ka
        Fb = H + J - Kb
        if mesh is not None:
            mesh.broadcast_(Fa, Fb)

        with timings.timed(JCTC.diis_time, it):
            ea = Fa @ Da @ S - S @ Da @ Fa
            eb = Fb @ Db @ S - S @ Db @ Fb
            e_max = max(float(ea.abs().max()), float(eb.abs().max()))
            if e_max < 10.0:
                diis.push(torch.stack([Fa, Fb]), torch.stack([ea, eb]))
            if diis.size > 0:
                Fa_x, Fb_x = diis.extrapolate()
            else:
                Fa_x, Fb_x = Fa, Fb

        if opts.damp and Fa_old is not None:
            x = linalg.damping_factor(last_dE)
            if x < 1.0:
                Fa_x = x * Fa_x + (1.0 - x) * Fa_old
                Fb_x = x * Fb_x + (1.0 - x) * Fb_old
        Fa_old, Fb_old = Fa, Fb

        with timings.timed(JCTC.eigensolve_time, it):
            eps_a, Ca, Da = _spin_step(Fa_x, X, na)
            eps_b, Cb, Db = _spin_step(Fb_x, X, nb)
            if mesh is not None:
                mesh.broadcast_(eps_a, Ca, Da, eps_b, Cb, Db)

        E_elec = 0.5 * float(
            torch.sum((Da + Db) * H) + torch.sum(Da * Fa) + torch.sum(Db * Fb))
        if not math.isfinite(E_elec) or abs(E_elec) > 1.0e8:
            E_old = E_elec
            break  # NaN/garbage never recovers; report a convergence error
        dE = E_elec - E_old
        last_dE = dE
        d_rms = float(torch.sqrt(0.5 * (torch.mean((Da - Da_old) ** 2)
                                        + torch.mean((Db - Db_old) ** 2))))
        E_old = E_elec
        Da_old, Db_old = Da, Db

        t_el = time.perf_counter() - t_it
        timings.record(JCTC.iteration_time, t_el, it)
        if dev.type == "cuda":
            timings.record(JCTC.device_memory_bytes,
                           float(torch.cuda.memory_allocated(dev)), it)
        if output >= 2:
            print(f"{it:4d} {E_elec + e_nuc:20.10f} {dE:12.3e} "
                  f"{d_rms:12.3e} {t_el:8.2f}")

        if abs(dE) <= opts.energy_convergence and \
                d_rms <= opts.density_convergence:
            converged = True
            break

    builder.finalize()
    E_total = E_old + e_nuc
    error = finish("UHF", timings, opts, converged, E_total, it, t0, output)
    sz = 0.5 * (na - nb)
    return {
        "Error": error,
        # factor conventions match RHF consumers: "Density" traces to nels
        "Fock": 0.5 * (Fa + Fb),
        "Fock Alpha": Fa,
        "Fock Beta": Fb,
        "Density": Da + Db,
        "Spin Density": Da - Db,
        "MO Coeff": Ca,
        "MO Coeff Alpha": Ca,
        "MO Coeff Beta": Cb,
        "MO Energies": eps_a,
        "MO Energies Alpha": eps_a,
        "MO Energies Beta": eps_b,
        "Overlap": S,
        "Energy": E_total,
        "Energy Elec": E_old,
        "E Nuc": e_nuc,
        "S2": s_squared(Ca, Cb, S, na, nb),
        "S2 Ideal": sz * (sz + 1.0),
        "Multiplicity": st["multiplicity"],
        "N Alpha": na,
        "N Beta": nb,
        "Converged?": converged,
        "Iterations": it,
        "Timings": timings,
        "Spherical Transform": st["sph_T"],
    }


def make_jk_builder(basis_sets, opts, use_df: bool, timings, device):
    """Builders exposing two_electron_jk, routed as the JAX package's UHF
    router (models/uhf.py:270-308): for DF, the sharded ShardedDFJKBuilder
    under num_devices > 1 (:282-287), else the dense fitted B while it
    stays under 2 GB, else the packed ScreenedDFJKBuilder; conventional:
    DenseFock for ``contraction_mode: dense`` up to 160 functions, else
    ScreenedDirectFock (in-core while its ERIs fit; never the streaming
    builder).  Conventional under num_devices > 1, which the JAX package
    runs on one device, runs the quartet-sharded ShardedDirectFock."""
    primary = basis_sets.primary
    if opts.num_devices > 1:
        if not use_df:
            from ..ops.fock_sharded import ShardedDirectFock

            with timings.timed("conventional_setup_time"):
                return ShardedDirectFock(primary, n_devices=opts.num_devices,
                                         timings=timings, device=device)
        if basis_sets.auxiliary is None:
            raise ValueError(
                "density-fitted UHF requires an auxiliary basis "
                "(model['auxiliary_basis'])")
        from .df_sharded_jk import ShardedDFJKBuilder

        return ShardedDFJKBuilder(primary, basis_sets.auxiliary, opts,
                                  timings=timings, device=device)
    if use_df:
        from .df import DFFockBuilder
        from .df_screened_jk import ScreenedDFJKBuilder

        if basis_sets.auxiliary is None:
            raise ValueError(
                "density-fitted UHF requires an auxiliary basis "
                "(model['auxiliary_basis'])")
        nbf, A = primary.nbf, basis_sets.auxiliary.nbf
        mode = opts.contraction_mode
        use_screened = (
            mode == C.ContractionMode.screened
            or (mode == C.ContractionMode.default
                and not opts.df_force_dense
                and A * nbf * nbf * 8 > 2.0e9))
        cls = ScreenedDFJKBuilder if use_screened else DFFockBuilder
        return cls.build(primary, basis_sets.auxiliary, opts, device,
                         timings=timings)
    from ..ops.fock import DenseFock, ScreenedDirectFock

    if opts.contraction_mode == C.ContractionMode.dense and primary.nbf <= 160:
        return DenseFock(primary, device)
    with timings.timed("conventional_setup_time"):
        return ScreenedDirectFock(primary, device=device)
