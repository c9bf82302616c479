"""ROHF energy driver: restricted open-shell Hartree-Fock.

Port of ``juliachem_jl_tpu/models/rohf.py``.  One set of spatial orbitals:
nb doubly occupied, na - nb singly occupied.  The spin Fock matrices come
from the builders' ``two_electron_jk`` (as for UHF), coupled through the
Guest-Saunders effective Fock

    R_mo =  [ (Fa+Fb)/2   Fb          (Fa+Fb)/2 ]   closed
            [ Fb          (Fa+Fb)/2   Fa        ]   open
            [ (Fa+Fb)/2   Fa          (Fa+Fb)/2 ]   virtual

assembled in the current MO basis; DIIS runs on its AO-frame form with the
total-density commutator.  The start is the core Hamiltonian.  <S^2> is
exactly s(s+1) by construction.  With ``num_devices: n`` the spin-resolved
builder is a sharded one (uhf.make_jk_builder) and rank 0's state is
broadcast as in models/uhf.py.
"""

from __future__ import annotations

import math
import time

import torch

from ..utils.timings import JCTC
from . import linalg
from .uhf import finish, setup


def _diag_in_x(F_ao, X):
    """Diagonalize an AO-frame symmetric operator in the X-orthonormal
    frame; (eps, C) with C^T S C = I."""
    eps, Cp = torch.linalg.eigh(X.T @ F_ao @ X)
    return eps, X @ Cp


def energy(mol, basis_sets, scf_flags: dict | None = None, output: int = 0,
           device=None) -> dict:
    """Compute the ROHF (or DF-ROHF) energy on ``device`` (default: the one
    given to ``initialize``).  Keywords as rhf.energy plus
    ``multiplicity``."""
    t0 = time.perf_counter()
    st = setup(mol, basis_sets, scf_flags, device)
    opts, timings, builder = st["opts"], st["timings"], st["builder"]
    na, nb, S, H, X = st["na"], st["nb"], st["S"], st["H"], st["X"]
    dev = st["device"]
    e_nuc = mol.nuclear_repulsion()

    # initial orbitals from the core Hamiltonian (single shared set)
    with timings.timed(JCTC.guess_time):
        eps, Cmo = _diag_in_x(H, X)

    mesh = getattr(builder, "mesh", None)
    if mesh is not None:   # start every rank from rank 0's state
        mesh.broadcast_(H, S, X, eps, Cmo)
    diis = linalg.DIIS(max_vec=opts.ndiis)
    E_old = 0.0
    D_old = None
    R_old = None
    last_dE = 1.0e9
    converged = False
    it = 0
    Fa = Fb = None
    c, o, v = slice(0, nb), slice(nb, na), slice(na, None)

    if output >= 2:
        print(f"{'iter':>4s} {'E total':>20s} {'dE':>12s} {'D rms':>12s} "
              f"{'t (s)':>8s}")

    for it in range(1, opts.max_iterations + 1):
        t_it = time.perf_counter()
        Ca, Cb = Cmo[:, :na], Cmo[:, :nb]
        Da, Db = Ca @ Ca.T, Cb @ Cb.T

        with timings.timed(JCTC.fock_time, it):
            J, Ka, Kb = builder.two_electron_jk(Da, Db, it, timings, Ca, Cb)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        Fa = H + J - Ka
        Fb = H + J - Kb
        if mesh is not None:
            mesh.broadcast_(Fa, Fb)

        # Guest-Saunders effective Fock in the current (S-orthonormal) MO
        # basis
        Fa_mo = Cmo.T @ Fa @ Cmo
        Fb_mo = Cmo.T @ Fb @ Cmo
        R = 0.5 * (Fa_mo + Fb_mo)
        R[c, o] = Fb_mo[c, o]
        R[o, c] = Fb_mo[o, c]
        R[o, v] = Fa_mo[o, v]
        R[v, o] = Fa_mo[v, o]

        # DIIS in the AO frame on the back-transformed effective Fock with
        # the total-density commutator error
        SC = S @ Cmo
        R_ao = SC @ R @ SC.T
        Dt = Da + Db
        with timings.timed(JCTC.diis_time, it):
            e_vec = R_ao @ Dt @ S - S @ Dt @ R_ao
            if float(e_vec.abs().max()) < 10.0:
                diis.push(R_ao, e_vec)
            R_x = diis.extrapolate() if diis.size > 0 else R_ao

        if opts.damp and R_old is not None:
            x = linalg.damping_factor(last_dE)
            if x < 1.0:
                R_x = x * R_x + (1.0 - x) * R_old
        R_old = R_ao

        with timings.timed(JCTC.eigensolve_time, it):
            eps, Cmo = _diag_in_x(R_x, X)
            if mesh is not None:
                mesh.broadcast_(eps, Cmo)

        E_elec = 0.5 * float(
            torch.sum(Dt * H) + torch.sum(Da * Fa) + torch.sum(Db * Fb))
        if not math.isfinite(E_elec) or abs(E_elec) > 1.0e8:
            E_old = E_elec
            break  # NaN/garbage never recovers; report a convergence error
        dE = E_elec - E_old
        last_dE = dE
        d_rms = (float(torch.sqrt(torch.mean((Dt - D_old) ** 2)))
                 if D_old is not None else 1.0)
        E_old = E_elec
        D_old = Dt

        t_el = time.perf_counter() - t_it
        timings.record(JCTC.iteration_time, t_el, it)
        if output >= 2:
            print(f"{it:4d} {E_elec + e_nuc:20.10f} {dE:12.3e} "
                  f"{d_rms:12.3e} {t_el:8.2f}")

        if abs(dE) <= opts.energy_convergence and \
                d_rms <= opts.density_convergence:
            converged = True
            break

    builder.finalize()
    E_total = E_old + e_nuc
    error = finish("ROHF", timings, opts, converged, E_total, it, t0, output)
    Ca, Cb = Cmo[:, :na], Cmo[:, :nb]
    Da, Db = Ca @ Ca.T, Cb @ Cb.T
    sz = 0.5 * (na - nb)
    return {
        "Error": error,
        "Fock": 0.5 * (Fa + Fb),
        "Fock Alpha": Fa,
        "Fock Beta": Fb,
        "Density": Da + Db,
        "Spin Density": Da - Db,
        "MO Coeff": Cmo,
        "MO Energies": eps,
        "Overlap": S,
        "Energy": E_total,
        "Energy Elec": E_old,
        "E Nuc": e_nuc,
        "S2": sz * (sz + 1.0),       # exact by construction
        "S2 Ideal": sz * (sz + 1.0),
        "Multiplicity": st["multiplicity"],
        "N Alpha": na,
        "N Beta": nb,
        "Converged?": converged,
        "Iterations": it,
        "Timings": timings,
        "Spherical Transform": st["sph_T"],
    }
