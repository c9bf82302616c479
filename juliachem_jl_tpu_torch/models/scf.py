"""SCF driver: the Roothaan-Hall / DIIS iteration loop.

Port of ``juliachem_jl_tpu/models/scf.py`` (reference rhf_kernel /
scf_cycles_kernel, src/rhf/energy/SCF.jl:69-592) with a pluggable Fock
builder.  D, F and C stay on the calculation's device; Python scalars are
taken only where the loop tests convergence or gates DIIS.  Same semantics
as the JAX package: the mixed-precision f32 phase, DIIS gating, dynamic
damping, the optional level shift, the energy-stagnation exit, the
incremental Fock (``fdiff``, with f32 increments under ``fdiff_f32``), the
wall deadline and restartable checkpoints (``save_checkpoint`` /
``load_checkpoint``, and the one-electron cache of ``initial_state``; the
port writes its own files, one per rank in a process group:
``parallel.mesh.rank_path``).

Under a sharded builder (one with a ``mesh``) every rank runs this loop on
the same replicated matrices, as the JAX package's one SPMD program does.
The ranks' own arithmetic may differ in the last bit (the one-electron
integrals and the 4-center digestion sum with atomics in no fixed order),
and a one-ulp difference could send the ranks' convergence tests, and so
their numbers of collectives, apart.  So the loop broadcasts rank 0's state
at the start, its F after each build and its (eps, C, D) after each Roothaan
step (three nbf^2 matrices an iteration), and takes the wall-deadline
decision from rank 0: every rank holds bit-identical state.
"""

from __future__ import annotations

import hashlib
import math
import sys
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.oei import overlap_kinetic_nuclear
from ..parallel.mesh import rank_path
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
    deadline_hit: bool = False  # stopped early at opts.wall_deadline
    debug: object = None  # DebugDump or None


class FockBuilder:
    """Interface: given the (factor-2) density D, return the two-electron part
    G[D] = J - 0.5 K so that F = H + G[D].  Builders that exploit the
    occupied MO factorization (DF) use C_occ when available."""

    supports_f32_phase = False

    def two_electron_fock(self, D: torch.Tensor, iteration: int,
                          timings: Timings, C_occ=None,
                          precision: str = "f64") -> torch.Tensor:
        raise NotImplementedError

    def two_electron_jk(self, Da: torch.Tensor, Db: torch.Tensor,
                        iteration: int, timings: Timings, Ca=None, Cb=None):
        """Spin-resolved contractions for UHF/ROHF (models/uhf.py): given
        factor-1 spin densities, return (J(Da+Db), K(Da), K(Db))."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the spin-resolved "
            "J/K interface (UHF); use the dense, screened-direct or dense-DF "
            "builder")

    def finalize(self):  # release per-geometry tensors
        pass


class SphericalFockAdapter(FockBuilder):
    """Wrap any Cartesian Fock builder for a spherical-harmonic SCF (the JAX
    package's ``models/scf.py:66-99``): G_s(D_s) = T^T G_c(T D_s T^T) T with
    the geometry-independent block transform T [nbf_cart, nbf_sph]
    (basis/spherical.py).  G is linear in D, so the wrapped builder's
    screening, DF and kernels apply unchanged; the occupied orbitals go in
    as T C_s, which spans the same occupied space.  Every other attribute
    (``mesh``, ``incore``, ...) is the wrapped builder's."""

    def __init__(self, inner: FockBuilder, T: torch.Tensor):
        self.inner = inner
        self.T = T
        self.supports_f32_phase = inner.supports_f32_phase

    def __getattr__(self, name):
        if name == "inner":   # not set yet (unpickling): no recursion
            raise AttributeError(name)
        return getattr(self.inner, name)

    def _up(self, M):
        return None if M is None else self.T @ M

    def _sym_up(self, D):
        return self.T @ D @ self.T.T

    def _down(self, G):
        return self.T.T @ G @ self.T

    def two_electron_fock(self, D, iteration, timings: Timings, C_occ=None,
                          precision: str = "f64"):
        G = self.inner.two_electron_fock(self._sym_up(D), iteration, timings,
                                         self._up(C_occ), precision=precision)
        return self._down(G)

    def two_electron_jk(self, Da, Db, iteration, timings: Timings, Ca=None,
                        Cb=None):
        J, Ka, Kb = self.inner.two_electron_jk(
            self._sym_up(Da), self._sym_up(Db), iteration, timings,
            self._up(Ca), self._up(Cb))
        return self._down(J), self._down(Ka), self._down(Kb)

    def finalize(self):
        self.inner.finalize()


def spherical_transform(basis_sets, device) -> torch.Tensor | None:
    """T [nbf_cart, nbf_sph] on ``device`` for a spherical-harmonic run
    (``basis_sets.spherical``), else None."""
    if not getattr(basis_sets, "spherical", False):
        return None
    from ..basis.spherical import sph_transform

    return sph_transform(basis_sets.primary, device)


def wrap_spherical(builder: FockBuilder, T) -> FockBuilder:
    """``builder`` behind a SphericalFockAdapter when T is given."""
    return builder if T is None else SphericalFockAdapter(builder, T)


def builder_name(builder: FockBuilder) -> str:
    """The class name of the builder that does the work (the adapter's
    wrapped one)."""
    return type(getattr(builder, "inner", builder)).__name__


def project_guess(D, S_sph, S_cart, T):
    """Metric projection of a Cartesian guess density onto the spherical
    span: D_s = Q D_c Q^T, Q = S_s^-1 T^T S_c (only a guess: trace and
    idempotency need not be exact)."""
    Q = torch.linalg.solve(S_sph, T.T @ S_cart)
    return Q @ D @ Q.T


def electronic_energy(D, H, F) -> float:
    """E_elec = 1/2 sum D (H + F)  (reference SCF.jl:1110-1125 convention,
    D = 2 C_occ C_occ^T)."""
    return 0.5 * float(torch.sum(D * (H + F)))


def scf_loop(state: SCFState, fock_builder: FockBuilder, opts: SCFOptions,
             timings: Timings, e_nuc: float, output: int = 0,
             max_iterations: int | None = None,
             energy_convergence: float | None = None,
             density_convergence: float | None = None,
             checkpoint_path: str | None = None,
             checkpoint_every: int = 5, fingerprint: str = "") -> bool:
    """Iterate to convergence; returns True if converged.

    Convergence test: |dE| <= dele and rms(dD) <= rmsd (SCF.jl:549); the
    keyword arguments override the options' limits (the DF-guess warm-up).
    With ``checkpoint_path`` the state is saved every ``checkpoint_every``
    iterations and at the end.
    """
    dele = (opts.energy_convergence if energy_convergence is None
            else energy_convergence)
    rmsd = (opts.density_convergence if density_convergence is None
            else density_convergence)
    niter = opts.max_iterations if max_iterations is None else max_iterations

    mesh = getattr(fock_builder, "mesh", None)
    if mesh is not None:   # start every rank from rank 0's state
        mesh.broadcast_(*(getattr(state, k) for k in _STATE_TENSORS))
        state.energy_elec = mesh.agree_value(state.energy_elec)
    diis = linalg.DIIS(max_vec=opts.ndiis)
    E_old = state.energy_elec
    D_old = state.D.clone() if state.D is not None else None
    F_old = None
    last_dE = 1.0e9
    G_cumul = None
    D_fock_ref = None
    supports_f32 = fock_builder.supports_f32_phase
    fp32_phase = bool(opts.mixed_precision and supports_f32 and not opts.fdiff)
    # f32 incremental Fock (opts.fdiff_f32): the increments F(dD) build in
    # f32 (their error scales with ||F(dD)||, which vanishes with dD), with
    # a full f64 resync every opts.fdiff_resync increments and a forced one
    # before any convergence is declared
    fdiff32 = bool(opts.fdiff_f32 and opts.fdiff and opts.mixed_precision
                   and supports_f32)
    inc_since_sync = 0
    force_resync = False
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

    t_last_iter = 0.0
    for it in range(1, niter + 1):
        # a budgeted run stops BEFORE an iteration that, by the last one's
        # wall, cannot finish by the deadline (absolute epoch seconds)
        late = (opts.wall_deadline > 0.0 and it > 1
                and time.time() + 1.3 * t_last_iter > opts.wall_deadline)
        if mesh is not None and opts.wall_deadline > 0.0:
            late = mesh.agree(late)
        if late:
            state.deadline_hit = True
            print(f"# scf: stopping before iter {it} — wall deadline "
                  f"({opts.wall_deadline - time.time():.0f}s left < "
                  f"1.3x last iter {t_last_iter:.1f}s)", file=sys.stderr,
                  flush=True)
            break
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
        resync = fdiff32 and (force_resync
                              or inc_since_sync >= max(opts.fdiff_resync, 1))
        with timings.timed(JCTC.fock_time, it):
            if opts.fdiff and G_cumul is not None and not resync:
                # incremental Fock: build with dD, accumulate (SCF.jl:421-431)
                if fdiff32:
                    timings.record("fock_f32", 1.0, it)
                    inc_since_sync += 1
                G_cumul = G_cumul + fock_builder.two_electron_fock(
                    state.D - D_fock_ref, it, timings, None,
                    precision="f32" if fdiff32 else "f64")
                D_fock_ref = state.D.clone()
                G = G_cumul
            else:
                G = fock_builder.two_electron_fock(state.D, it, timings,
                                                   C_occ, precision=precision)
                if opts.fdiff:
                    G_cumul = G
                    D_fock_ref = state.D.clone()
                inc_since_sync = 0
                force_resync = False
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        F = state.H + G
        if mesh is not None:
            mesh.broadcast_(F)

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
            if mesh is not None:
                mesh.broadcast_(eps, Cmo, D)

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

        if state.debug is not None:
            state.debug.write("fock", F, it)
            state.debug.write("density", D, it)
            state.debug.write("coefficients", Cmo, it)
            state.debug.write("energy", E_elec, it)

        t_el = time.perf_counter() - t_it
        t_last_iter = t_el
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

        if checkpoint_path and it % checkpoint_every == 0:
            save_checkpoint(state, checkpoint_path, e_nuc, fingerprint)

        if abs(dE) <= dele and d_rms <= rmsd:
            if fp32_phase:
                # never declare convergence off an f32 Fock: drop to f64 and
                # keep iterating
                fp32_phase = False
            elif fdiff32 and inc_since_sync > 0:
                # this Fock holds f32 increments: rebuild it in full f64
                # next iteration and accept the test only on that one
                force_resync = True
            else:
                converged = True
                break

        if fp32_phase or (fdiff32 and inc_since_sync > 0):
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
    if checkpoint_path:
        save_checkpoint(state, checkpoint_path, e_nuc, fingerprint)
    return converged


def system_fingerprint(mol, basis) -> str:
    """Hash of geometry and basis identity for checkpoint and one-electron
    cache consistency checks (the JAX package's, models/scf.py:372-381)."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(mol.coords, dtype=np.float64).tobytes())
    h.update(np.ascontiguousarray(mol.z, dtype=np.int64).tobytes())
    h.update(f"{basis.name}|{basis.nbf}|{basis.nels}".encode())
    return h.hexdigest()


_STATE_TENSORS = ("H", "S", "X", "F", "D", "C", "eps")


def save_checkpoint(state: SCFState, path: str, e_nuc: float,
                    fingerprint: str = "") -> None:
    """Persist restartable SCF state (numpy .npz, this rank's file; a
    capability the reference lacks — its 'Restart data is being output'
    banner writes nothing, SCF.jl:205-207)."""
    arrays = {k: getattr(state, k).cpu().numpy() for k in _STATE_TENSORS
              if getattr(state, k) is not None}
    np.savez_compressed(rank_path(path), **arrays, nocc=state.nocc,
                        energy_elec=state.energy_elec,
                        iteration=state.iteration, e_nuc=e_nuc,
                        fingerprint=np.bytes_(fingerprint.encode()))


def load_checkpoint(path: str, device, expect_fingerprint: str | None = None,
                    expect_e_nuc: float | None = None) -> SCFState:
    """The state ``save_checkpoint`` wrote (this rank's file), on
    ``device``; refuses (ValueError) a checkpoint of another molecule or
    basis, or of another geometry."""
    path = rank_path(path)
    z = np.load(path)
    if expect_fingerprint is not None and "fingerprint" in z:
        stored = bytes(z["fingerprint"]).decode()
        if stored and stored != expect_fingerprint:
            raise ValueError(
                f"checkpoint {path!r} was written for a different "
                f"molecule/basis (fingerprint mismatch); refusing to restart"
            )
    if expect_e_nuc is not None:
        if abs(float(z["e_nuc"]) - expect_e_nuc) > 1e-8:
            raise ValueError(
                f"checkpoint {path!r} nuclear repulsion "
                f"{float(z['e_nuc'])!r} != current {expect_e_nuc!r}; "
                f"geometry changed — refusing to restart"
            )
    t = {k: torch.as_tensor(z[k], device=device) if k in z else None
         for k in _STATE_TENSORS}
    return SCFState(nocc=int(z["nocc"]), energy_elec=float(z["energy_elec"]),
                    iteration=int(z["iteration"]), **t)


def energy_weighted_density(state: SCFState) -> torch.Tensor:
    """W = 2 sum_occ eps_i C_i C_i^T (reference SCF.jl:577-586)."""
    Cocc = state.C[:, : state.nocc]
    return 2.0 * (Cocc * state.eps[: state.nocc][None, :]) @ Cocc.T


def initial_state(mol, basis, opts: SCFOptions, timings: Timings, device,
                  output: int = 0, sph_T: torch.Tensor | None = None
                  ) -> SCFState:
    """Hamiltonian core pieces + orthogonalizer + guess density.  With
    ``opts.oei_cache`` (a path prefix) S, T and V are loaded from, or saved
    to, ``<prefix>_torch_oei.npz``, guarded by ``system_fingerprint``.

    sph_T (optional [nbf_cart, nbf_sph], ``spherical_transform``) switches
    the SCF to the real-solid-harmonic basis: the Cartesian one-electron
    matrices are built as usual and projected once, and the SAD guess is
    projected onto the spherical metric (``project_guess``)."""
    with timings.timed(JCTC.H_time):
        S = None
        path = rank_path(opts.oei_cache + "_torch_oei.npz"
                         if opts.oei_cache else "")
        fp = system_fingerprint(mol, basis) if path else ""
        if path:
            try:
                z = np.load(path)
                if str(z["fingerprint"]) == fp \
                        and z["S"].shape == (basis.nbf, basis.nbf):
                    S, T, V = (torch.as_tensor(z[k], device=device)
                               for k in ("S", "T", "V"))
                    print(f"# initial_state: loaded cached S/T/V from {path}",
                          file=sys.stderr, flush=True)
            except (OSError, KeyError, ValueError):
                S = None
        if S is None:
            S, T, V = overlap_kinetic_nuclear(basis, mol, device)
            if path:
                try:
                    np.savez(path, S=S.cpu().numpy(), T=T.cpu().numpy(),
                             V=V.cpu().numpy(), fingerprint=fp)
                except OSError:
                    pass
    H = T + V
    S_cart = S
    if sph_T is not None:
        H = sph_T.T @ H @ sph_T
        S = sph_T.T @ S @ sph_T
    X = linalg.orthogonalizer(S)
    debug = None
    # the JAX package's keys (models/scf.py:470-476); S and H in the
    # computational basis, T and V Cartesian; under num_devices > 1 rank 0
    # writes the one file
    if opts.debug and not (torch.distributed.is_initialized()
                           and torch.distributed.get_rank() != 0):
        from ..utils.debug_dump import DebugDump

        debug = DebugDump(enabled=True)
        for key, val in (("overlap", S), ("kinetic", T), ("nuc_attr", V),
                         ("core_hamiltonian", H), ("ortho", X)):
            debug.write(key, val)
    nocc = basis.nels // 2
    if basis.nels % 2 != 0:
        raise ValueError(
            f"RHF requires an even number of electrons (got {basis.nels})"
        )
    state = SCFState(H=H, S=S, X=X, nocc=nocc, debug=debug)

    with timings.timed(JCTC.guess_time):
        if opts.guess == C.Guess.sad:
            from .guess import sad_guess

            D = sad_guess(mol, basis, device)
            if sph_T is not None:
                D = project_guess(D, S, S_cart, sph_T)
            state.D = D
            state.F = None
        else:  # hcore guess (F = H): SCF.jl:107-117
            eps, Cmo, D = linalg.roothaan_step(H, X, nocc)
            state.eps, state.C, state.D = eps, Cmo, D
            state.F = H.clone()
            state.energy_elec = electronic_energy(state.D, H, H)
    return state
