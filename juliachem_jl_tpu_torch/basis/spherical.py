"""Real solid harmonics and the Cartesian->spherical AO transformation.

The reference framework is Cartesian-only (its GAMESS-convention shells,
BasisStructs.jl, carry ncart = (l+1)(l+2)/2 components and no 5d/7f option);
this module adds the spherical-harmonic basis option on top of the same
Cartesian MD integral engine.  TPU-first rationale: the integral kernels
stay in their batched Cartesian form (where the MD E/R factorization is
MXU-friendly), and sphericalization is ONE dense [nbf_cart, nbf_sph]
matmul applied to AO matrices — XLA fuses it into the surrounding
contractions, and because the transform is geometry-independent
(dT/dR = 0) analytic gradients need no new derivative kernels: the
spherical density/W matrices transform back to Cartesian and reuse the
existing assembly.

Correctness is proven internally rather than against tabulated
coefficients: each generated polynomial is asserted harmonic
(Laplacian exactly zero) and homogeneous of degree l, and the 2l+1
polynomials are mutually orthogonal under the exact unit-sphere monomial
measure — which characterizes the degree-l real solid harmonics up to an
orthogonal mix within the shell (energies, populations and dipoles are
invariant to that mix).
"""

from __future__ import annotations

import math

import numpy as np

from .structs import Basis, axial_normalization, cart_components, ncart

__all__ = [
    "solid_harmonic_polys",
    "cart_to_sph_shell",
    "cart_to_sph_basis",
    "nsph",
]


def nsph(l: int) -> int:
    """Number of spherical components for angular momentum l."""
    return 2 * l + 1


# ---------------------------------------------------------------------------
# solid harmonic polynomials as monomial dicts {(lx,ly,lz): coeff}
# ---------------------------------------------------------------------------


def _mul_axis(poly: dict, axis: int) -> dict:
    out: dict = {}
    for (a, b, c), v in poly.items():
        key = (a + (axis == 0), b + (axis == 1), c + (axis == 2))
        out[key] = out.get(key, 0.0) + v
    return out


def _mul_r2(poly: dict) -> dict:
    # r^2 * poly = x^2 poly + y^2 poly + z^2 poly
    out: dict = {}
    for (a, b, c), v in poly.items():
        for da, db, dc in ((2, 0, 0), (0, 2, 0), (0, 0, 2)):
            key = (a + da, b + db, c + dc)
            out[key] = out.get(key, 0.0) + v
    return out


def _axpy(alpha: float, x: dict, y: dict) -> dict:
    out = dict(y)
    for k, v in x.items():
        out[k] = out.get(k, 0.0) + alpha * v
    return {k: v for k, v in out.items() if v != 0.0}


def _laplacian(poly: dict) -> dict:
    out: dict = {}
    for (a, b, c), v in poly.items():
        for i, (p, key) in enumerate((
                (a, (a - 2, b, c)), (b, (a, b - 2, c)), (c, (a, b, c - 2)))):
            if p >= 2:
                out[key] = out.get(key, 0.0) + v * p * (p - 1)
    return {k: v for k, v in out.items() if abs(v) > 0.0}


def _sphere_moment(p: int, q: int, r: int) -> float:
    """Exact unit-sphere integral of x^p y^q z^r (up to the common 4*pi
    factor): zero for any odd power, else (p-1)!!(q-1)!!(r-1)!!/(p+q+r+1)!!.
    """
    if p % 2 or q % 2 or r % 2:
        return 0.0
    dfact = lambda n: math.prod(range(n, 0, -2)) if n > 0 else 1
    return dfact(p - 1) * dfact(q - 1) * dfact(r - 1) / dfact(p + q + r + 1)


def _sphere_dot(pa: dict, pb: dict) -> float:
    s = 0.0
    for (a, b, c), va in pa.items():
        for (d, e, f), vb in pb.items():
            if va and vb:
                s += va * vb * _sphere_moment(a + d, b + e, c + f)
    return s


def solid_harmonic_polys(l: int) -> list[dict]:
    """The 2l+1 real solid harmonics of degree l as monomial dicts, ordered
    m = 0, +1, -1, ..., +l, -l.  Built by the standard x/y diagonal and
    z vertical recursions; every polynomial is verified harmonic
    (exact zero Laplacian) and the set verified mutually orthogonal on the
    unit sphere before being returned.
    """
    S: dict = {(0, 0): {(0, 0, 0): 1.0}}
    for ll in range(l):
        d0 = 1.0 if ll == 0 else 0.0
        fac = math.sqrt(2.0 ** d0 * (2 * ll + 1) / (2 * ll + 2))
        S[(ll + 1, ll + 1)] = _axpy(
            -fac * (1.0 - d0), _mul_axis(S[(ll, -ll)], 1),
            {k: fac * v for k, v in _mul_axis(S[(ll, ll)], 0).items()})
        S[(ll + 1, -(ll + 1))] = _axpy(
            fac * (1.0 - d0), _mul_axis(S[(ll, -ll)], 0),
            {k: fac * v for k, v in _mul_axis(S[(ll, ll)], 1).items()})
        for m in range(-ll, ll + 1):
            num = _mul_axis(S[(ll, m)], 2)
            num = {k: (2 * ll + 1) * v for k, v in num.items()}
            low = math.sqrt((ll + m) * (ll - m))
            if low != 0.0 and (ll - 1, m) in S:
                num = _axpy(-low, _mul_r2(S[(ll - 1, m)]), num)
            den = math.sqrt((ll + 1 + m) * (ll + 1 - m))
            S[(ll + 1, m)] = {k: v / den for k, v in num.items()}

    order = [0]
    for m in range(1, l + 1):
        order += [m, -m]
    polys = [S[(l, m)] for m in order]

    # ---- internal proofs -------------------------------------------------
    for p in polys:
        for k in p:
            assert sum(k) == l, f"degree-{l} harmonic has monomial {k}"
        lap = _laplacian(p)
        scale = max(abs(v) for v in p.values())
        bad = {k: v for k, v in lap.items() if abs(v) > 1e-10 * scale}
        assert not bad, f"solid harmonic l={l} not harmonic: {bad}"
    for i in range(len(polys)):
        for j in range(i):
            dot = _sphere_dot(polys[i], polys[j])
            ni = math.sqrt(_sphere_dot(polys[i], polys[i]))
            nj = math.sqrt(_sphere_dot(polys[j], polys[j]))
            assert abs(dot) < 1e-12 * ni * nj, (
                f"solid harmonics l={l} m-indices {i},{j} not orthogonal")
    return polys


# ---------------------------------------------------------------------------
# per-shell and whole-basis transformation matrices
# ---------------------------------------------------------------------------


def cart_to_sph_shell(l: int) -> np.ndarray:
    """[ncart(l), nsph(l)] transform from THIS CODE's normalized Cartesian
    components (cart_components order, axial normalization — structs.py) to
    unit-normalized real solid harmonic functions.

    Column normalization uses the exact within-shell angular overlap of the
    Cartesian components (the radial factor is common to all components of
    a shell and cancels), so T^T S_shell T = I exactly for every
    contraction — verified by tests against the ops.oei overlap matrices.
    """
    comps = cart_components(l)
    ax = axial_normalization(l)           # per-component axial norms
    polys = solid_harmonic_polys(l)

    # angular overlap of the *normalized* cartesian components.  The code's
    # axial factors are relative (axial components carry 1; the absolute
    # unit normalization lives in the radial contraction coefficients), so
    # the true shell overlap block is the raw angular moment matrix scaled
    # to a unit axial diagonal.
    nc = ncart(l)
    m_axial = _sphere_moment(2 * l, 0, 0)
    s_ang = np.zeros((nc, nc))
    for i, (a, b, c) in enumerate(comps):
        for j, (d, e, f) in enumerate(comps):
            s_ang[i, j] = (ax[i] * ax[j]
                           * _sphere_moment(a + d, b + e, c + f) / m_axial)

    T = np.zeros((nc, nsph(l)))
    for m, poly in enumerate(polys):
        for i, key in enumerate(comps):
            # the spherical function is sum_key coeff * x^a y^b z^c; the
            # stored cartesian bf carries ax[i] * monomial, so divide it out
            T[i, m] = poly.get(key, 0.0) / ax[i]
    # unit-normalize each spherical function under the shell metric
    for m in range(nsph(l)):
        n2 = T[:, m] @ s_ang @ T[:, m]
        T[:, m] /= math.sqrt(n2)
    return T


def cart_to_sph_basis(basis: Basis) -> np.ndarray:
    """Block-diagonal [nbf_cart, nbf_sph] transform for a compiled Basis.
    Spherical functions are ordered shell-by-shell in cartesian offset
    order, so per-shell/per-atom maps stay contiguous."""
    Tcache = {l: cart_to_sph_shell(l) for l in
              sorted({s.l for s in basis.shells})}
    shells = sorted(basis.shells, key=lambda s: s.offset)
    nbf_sph = sum(nsph(s.l) for s in shells)
    out = np.zeros((basis.nbf, nbf_sph))
    col = 0
    for s in shells:
        T = Tcache[s.l]
        out[s.offset:s.offset + T.shape[0], col:col + T.shape[1]] = T
        col += T.shape[1]
    return out


def aux_needs_sph(basis: Basis) -> bool:
    """True when the solid-harmonic aux projection changes anything
    (a d or higher shell exists; s/p transforms are the identity)."""
    return any(s.l >= 2 for s in basis.shells)
