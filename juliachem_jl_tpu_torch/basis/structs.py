"""Shell / Basis data structures, compiled for class-batched TPU kernels.

Parity notes:
* Shell normalization follows the reference's GAMESS convention — contraction
  coefficients are unnormalized then renormalized so the (l,0,0) Cartesian
  component has unit self-overlap (BasisStructs.jl:52-109); the remaining
  components are fixed by per-component "axial normalization" factors
  (Globals.jl:6-44), which we expose as static per-class vectors applied to
  integral blocks.
* Cartesian component ordering matches the reference's documented Psi4/simint
  order (Globals.jl:97-172): e.g. d = xx,xy,xz,yy,yz,zz.
* Basis functions are Cartesian (6d/10f/15g), matching the reference
  (BasisStructs.jl:31-33, nbas = am(am+1)/2 in its 1-based am convention).

The "compiled" representation groups shells by angular momentum so integral
kernels see fixed-shape, padded, batched inputs — the TPU-first replacement
for the reference's per-shell-quartet Libint dispatch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

MAX_AM = 4  # s..g, matching the reference's normalization tables (Globals.jl:20-28)
AM_LETTER = "SPDFG"


def ncart(l: int) -> int:
    """Number of Cartesian components for angular momentum l."""
    return (l + 1) * (l + 2) // 2


@lru_cache(maxsize=None)
def cart_components(l: int) -> tuple[tuple[int, int, int], ...]:
    """Cartesian (lx,ly,lz) triples in the reference's component order
    (Globals.jl:97-172): descending lx, then descending ly."""
    return tuple(
        (lx, ly, l - lx - ly)
        for lx in range(l, -1, -1)
        for ly in range(l - lx, -1, -1)
    )


def _dfact(n: int) -> float:
    """(2n-1)!! with (2*0-1)!! = 1."""
    out = 1.0
    for k in range(2 * n - 1, 0, -2):
        out *= k
    return out


@lru_cache(maxsize=None)
def axial_normalization(l: int) -> np.ndarray:
    """Per-component factor sqrt((2l-1)!! / ((2lx-1)!!(2ly-1)!!(2lz-1)!!)).

    With contraction coefficients renormalized against the (l,0,0) component,
    multiplying a component's integral row by this factor yields fully
    normalized Cartesian functions — the reference applies the same factors to
    integral blocks in EnergyHelpers.jl:260-411.
    """
    top = _dfact(l)
    return np.array(
        [np.sqrt(top / (_dfact(lx) * _dfact(ly) * _dfact(lz)))
         for lx, ly, lz in cart_components(l)],
        dtype=np.float64,
    )


@dataclass
class Shell:
    """One contracted Cartesian shell (L/sp shells already split)."""

    l: int
    atom: int
    center: np.ndarray          # (3,) Bohr
    exps: np.ndarray            # (K,)
    coefs: np.ndarray           # (K,) raw library coefficients
    norm_coefs: np.ndarray = field(default=None)  # (K,) normalized (set by normalize())
    offset: int = 0             # first basis-function index

    @property
    def nbf(self) -> int:
        return ncart(self.l)

    @property
    def nprim(self) -> int:
        return len(self.exps)

    def normalize(self) -> None:
        """GAMESS-convention renormalization (BasisStructs.jl:52-109).

        1. Scale each primitive coefficient by the primitive norm of the
           (l,0,0) component: (2a/pi)^(3/4) (4a)^(l/2) / sqrt((2l-1)!!).
        2. Rescale the contraction so the contracted (l,0,0) function has unit
           self-overlap.
        """
        a = np.asarray(self.exps, dtype=np.float64)
        c = np.asarray(self.coefs, dtype=np.float64)
        l = self.l
        prim_norm = (2.0 * a / np.pi) ** 0.75 * (4.0 * a) ** (l / 2.0) / np.sqrt(_dfact(l))
        cn = c * prim_norm
        p = a[:, None] + a[None, :]
        self_ovl = (np.pi / p) ** 1.5 * _dfact(l) / (2.0 * p) ** l
        nrm = float(cn @ self_ovl @ cn)
        self.norm_coefs = cn / np.sqrt(nrm)


@dataclass
class ShellClass:
    """All shells of one angular momentum, padded into batch arrays."""

    l: int
    shell_idx: np.ndarray   # (n,) indices into Basis.shells
    centers: np.ndarray     # (n, 3)
    exps: np.ndarray        # (n, K) padded with 1.0
    coefs: np.ndarray       # (n, K) normalized, padded with 0.0
    offsets: np.ndarray     # (n,) basis-function offsets
    atoms: np.ndarray       # (n,)

    @property
    def nshell(self) -> int:
        return len(self.shell_idx)

    @property
    def kmax(self) -> int:
        return self.exps.shape[1]


@dataclass
class Basis:
    """A built basis set (analog of reference BasisStructs.Basis)."""

    shells: list[Shell]
    nbf: int
    nels: int
    name: str = ""
    classes: dict[int, ShellClass] = field(default_factory=dict)
    # flat per-shell arrays
    shell_l: np.ndarray = None
    shell_atom: np.ndarray = None
    shell_offset: np.ndarray = None
    shell_nbf: np.ndarray = None

    @property
    def nshell(self) -> int:
        return len(self.shells)

    @property
    def max_l(self) -> int:
        return int(self.shell_l.max()) if self.nshell else 0

    def bf_to_shell(self) -> np.ndarray:
        """Map basis-function index -> shell index."""
        out = np.zeros(self.nbf, dtype=np.int64)
        for i, s in enumerate(self.shells):
            out[s.offset : s.offset + s.nbf] = i
        return out

    def bf_to_atom(self) -> np.ndarray:
        out = np.zeros(self.nbf, dtype=np.int64)
        for s in self.shells:
            out[s.offset : s.offset + s.nbf] = s.atom
        return out


def compile_basis(shells: list[Shell], nels: int, name: str = "") -> Basis:
    """Assign offsets, normalize, and group shells into padded am classes."""
    offset = 0
    for s in shells:
        s.offset = offset
        offset += s.nbf
        s.normalize()
    nbf = offset

    basis = Basis(shells=shells, nbf=nbf, nels=nels, name=name)
    basis.shell_l = np.array([s.l for s in shells], dtype=np.int64)
    basis.shell_atom = np.array([s.atom for s in shells], dtype=np.int64)
    basis.shell_offset = np.array([s.offset for s in shells], dtype=np.int64)
    basis.shell_nbf = np.array([s.nbf for s in shells], dtype=np.int64)

    for l in sorted(set(int(x) for x in basis.shell_l)):
        idx = np.nonzero(basis.shell_l == l)[0]
        kmax = max(shells[i].nprim for i in idx)
        n = len(idx)
        exps = np.ones((n, kmax), dtype=np.float64)
        coefs = np.zeros((n, kmax), dtype=np.float64)
        centers = np.zeros((n, 3), dtype=np.float64)
        for row, i in enumerate(idx):
            s = shells[i]
            exps[row, : s.nprim] = s.exps
            coefs[row, : s.nprim] = s.norm_coefs
            centers[row] = s.center
        basis.classes[l] = ShellClass(
            l=l,
            shell_idx=idx,
            centers=centers,
            exps=exps,
            coefs=coefs,
            offsets=basis.shell_offset[idx].copy(),
            atoms=basis.shell_atom[idx].copy(),
        )
    return basis
