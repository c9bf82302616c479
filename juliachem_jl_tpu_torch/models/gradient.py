"""Analytic nuclear gradients of RHF, UHF and ROHF, conventional and DF.

Port of ``juliachem_jl_tpu/models/gradient.py`` (the reference scaffolds
gradients but disables them, src/rhf/gradient/Gradient.jl:31-32; its
one-electron assembly is GradHelpers.jl:65-467):

    dE/dR = dE_nuc + sum D (dT + dV) - sum W dS + dE_2e

with the two-electron term from the derivative integrals of ops/eri_grad.py
(conventional, or the RI-fitted functional of a density-fitted SCF).  A
spherical-harmonic run contracts the Cartesian derivative integrals with
the back-transformed T D_s T^T and T W_s T^T (T does not depend on the
geometry).  Every gradient is a float64 tensor [natom, 3] on the device of
the SCF it differentiates.  Unlike the JAX package, whose DF gradient always
fits in the solid-harmonic aux space, the DF gradient here follows the
SCF's ``df_spherical_aux`` keyword, so that it differentiates the energy the
SCF computed (ROADMAP.md C2, C11).
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from .. import config

METHODS = ("RHF", "UHF", "ROHF")


def nuclear_repulsion_gradient(mol, device) -> torch.Tensor:
    """d E_nuc / d R [natom, 3] (reference GradHelpers.jl:38-63)."""
    coords = torch.as_tensor(mol.coords, dtype=torch.float64, device=device)
    z = torch.as_tensor(np.asarray(mol.z, dtype=float), device=device)
    diff = coords[:, None, :] - coords[None, :, :]        # [i, j, 3]
    r2 = (diff**2).sum(-1)
    eye = torch.eye(mol.natom, dtype=torch.bool, device=device)
    inv_r3 = torch.where(eye, 0.0, 1.0 / torch.sqrt(
        torch.where(eye, 1.0, r2)) ** 3)
    zz = z[:, None] * z[None, :]
    return -(zz[:, :, None] * inv_r3[:, :, None] * diff).sum(dim=1)


def one_electron_gradient(mol, basis, D: torch.Tensor, W: torch.Tensor,
                          work: Counter | None = None) -> torch.Tensor:
    """grad[k] = sum_pq D_pq (dT + dV)_pq/dR_k - sum_pq W_pq dS_pq/dR_k
    (GradHelpers.jl:65-467 assembly), for the factor-2 density D and the
    energy-weighted density W, on D's device: kernel K10 on the card, its
    plain version on the CPU (``ops/oei_grad.py``), neither of which forms
    the derivative matrices."""
    from ..ops import oei_grad

    return oei_grad.one_electron_gradient(basis, mol, D, W, work)


def _two_electron(mol, basis, D, aux, spin_densities, sph_aux, timings,
                  work):
    from ..ops.eri_grad import df_two_electron_gradient, two_electron_gradient

    if aux is None:
        return two_electron_gradient(basis, mol, D,
                                     spin_densities=spin_densities,
                                     work=work)
    return df_two_electron_gradient(basis, aux, mol, D,
                                    spin_densities=spin_densities,
                                    sph_aux=sph_aux, timings=timings,
                                    work=work)


def _timed(timings, key, fn):
    """fn(), its synchronised wall added to ``timings[key]`` when given."""
    import time

    if timings is None:
        return fn()
    t0 = time.perf_counter()
    out = fn()
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0
    return out


def _total(mol, basis, D, W, aux, spin_densities, sph_aux, timings):
    work = None if timings is None else timings.setdefault("work", Counter())
    g1 = _timed(timings, "one_electron",
                lambda: one_electron_gradient(mol, basis, D, W, work))
    g2 = _timed(timings, "two_electron", lambda: _two_electron(
        mol, basis, D, aux, spin_densities, sph_aux, timings, work))
    return nuclear_repulsion_gradient(mol, D.device) + g1 + g2


def total_gradient(mol, basis, D: torch.Tensor, W: torch.Tensor, aux=None,
                   sph_aux: bool = True, timings: dict | None = None
                   ) -> torch.Tensor:
    """Full analytic RHF gradient [natom, 3] from a converged (Cartesian)
    density and energy-weighted density.  aux=None differentiates the exact
    two-electron energy; with an auxiliary basis the RI-fitted energy
    (3-center and metric derivative terms), fitted in the solid-harmonic
    aux space when ``sph_aux``.  ``timings`` (a dict) collects the
    synchronised wall of the parts and, under "work", a Counter of the
    pairs and quartets the derivative programs evaluated."""
    return _total(mol, basis, D, W, aux, None, sph_aux, timings)


def _to_cart(T, *mats):
    return mats if T is None else tuple(T @ M @ T.T for M in mats)


def total_gradient_uhf(mol, basis, uhf_result, aux=None,
                       sph_aux: bool = True, timings: dict | None = None
                       ) -> torch.Tensor:
    """Full analytic UHF gradient [natom, 3] from a converged UHF result:
    the one-electron term contracts the total density and the spin-summed
    energy-weighted density, the two-electron term the UHF two-particle
    density."""
    na, nb = int(uhf_result["N Alpha"]), int(uhf_result["N Beta"])
    Ca, Cb = uhf_result["MO Coeff Alpha"], uhf_result["MO Coeff Beta"]
    ea, eb = uhf_result["MO Energies Alpha"], uhf_result["MO Energies Beta"]
    Da = Ca[:, :na] @ Ca[:, :na].T
    Db = Cb[:, :nb] @ Cb[:, :nb].T
    W = ((Ca[:, :na] * ea[:na][None, :]) @ Ca[:, :na].T
         + (Cb[:, :nb] * eb[:nb][None, :]) @ Cb[:, :nb].T)
    Da, Db, W = _to_cart(uhf_result.get("Spherical Transform"), Da, Db, W)
    return _total(mol, basis, Da + Db, W, aux, (Da, Db), sph_aux, timings)


def total_gradient_rohf(mol, basis, rohf_result, aux=None,
                        sph_aux: bool = True, timings: dict | None = None
                        ) -> torch.Tensor:
    """Analytic ROHF gradient [natom, 3], with the general SCF Pulay weight
        W = 1/2 sum_s (D_s F_s S^-1 + S^-1 F_s D_s)
    (valid for any converged single-determinant SCF; the shared ROHF
    orbitals diagonalize the effective Fock, not F_a/F_b), and the UHF
    two-particle density of the one shared orbital set."""
    na, nb = int(rohf_result["N Alpha"]), int(rohf_result["N Beta"])
    C, S = rohf_result["MO Coeff"], rohf_result["Overlap"]
    Da = C[:, :na] @ C[:, :na].T
    Db = C[:, :nb] @ C[:, :nb].T
    W = torch.zeros_like(S)
    for Ds, Fs in ((Da, rohf_result["Fock Alpha"]),
                   (Db, rohf_result["Fock Beta"])):
        X = torch.linalg.solve(S, Fs @ Ds)          # S^-1 F_s D_s
        W = W + 0.5 * (X + X.T)
    Da, Db, W = _to_cart(rohf_result.get("Spherical Transform"), Da, Db, W)
    return _total(mol, basis, Da + Db, W, aux, (Da, Db), sph_aux, timings)


def run(mol, basis_sets, scf_flags=None, output: int = 0,
        method: str = "RHF", device=None, timings: dict | None = None
        ) -> dict:
    """API shape of JCRHF.Gradient.run (Gradient.jl:19-29), working:
    converges the SCF on ``device`` (default: the one given to
    ``initialize``, the card unless it named the CPU) and returns its result
    with the analytic nuclear gradient of the same energy functional under
    "Gradient" (conventional, or RI-fitted when scf_type=df, in the aux space
    ``df_spherical_aux`` names).  ``method``: RHF, UHF or ROHF (anything
    else raises ValueError; the JAX package runs RHF).  ``timings`` (a
    dict) collects the synchronised wall of the gradient's parts and, under
    "work", what its derivative programs evaluated (``total_gradient``)."""
    from . import rhf, rohf, uhf

    device = config.resolve_device(device)
    if basis_sets is None or getattr(basis_sets, "primary", None) is None:
        raise ValueError("gradient.run requires built basis sets "
                         "(basis.run(mol, model))")
    method = method.upper()
    if method not in METHODS:
        raise ValueError(f"gradient.run: method {method!r}, expected one of "
                         f"{', '.join(METHODS)}")
    flags = dict(scf_flags or {})
    use_df = str(flags.get("scf_type", "rhf")).lower() == "df"
    if use_df and basis_sets.auxiliary is None:
        raise ValueError("scf_type=df gradient requires an auxiliary basis")
    aux = basis_sets.auxiliary if use_df else None
    sph_aux = bool(flags.get("df_spherical_aux", True))
    energy = {"RHF": rhf.energy, "UHF": uhf.energy, "ROHF": rohf.energy}
    res = energy[method](mol, basis_sets, flags, output=output,
                         device=device)
    if not res.get("Converged?"):
        raise RuntimeError("gradient requested on an unconverged SCF")
    if device.type == "cuda":
        # the SCF's builder (its B: 8.2 GB at w32 with Cartesian aux rows)
        # is released; hand its cached blocks back before the DF gradient
        # allocates its dense (A|pq) and U (23 GB each at w32)
        import gc

        gc.collect()
        torch.cuda.empty_cache()
    primary = basis_sets.primary
    if method == "UHF":
        grad = total_gradient_uhf(mol, primary, res, aux, sph_aux, timings)
    elif method == "ROHF":
        grad = total_gradient_rohf(mol, primary, res, aux, sph_aux, timings)
    else:
        # dT/dR = 0, so the spherical gradient is exactly the Cartesian
        # assembly contracted with the back-transformed D and W
        D, W = _to_cart(res.get("Spherical Transform"), res["Density"],
                        res["W"])
        grad = total_gradient(mol, primary, D, W, aux, sph_aux, timings)
    if output >= 2:
        print(f"{method} nuclear gradient (Eh/bohr):")
        for k, g in enumerate(grad.tolist()):
            print(f"  {mol.symbols[k]:2s} {g[0]: .10f} {g[1]: .10f} "
                  f"{g[2]: .10f}")
    return {**res, "Gradient": grad}
