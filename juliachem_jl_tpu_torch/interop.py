"""Carry state over from the JAX package (juliachem_jl_tpu) to this one.

The JAX package's objects are read by attribute, as plain numpy arrays; this
module imports neither jax nor juliachem_jl_tpu.  The tests use it to feed
the identical basis to both packages, and to feed a B tensor built by the
JAX package into this package's Fock builders.
"""

from __future__ import annotations

import numpy as np
import torch

from .basis import CalculationBasisSets
from .basis.structs import Basis, Shell, ShellClass
from .models.df_screened import PackedScreen
from .molecule import Molecule
from .ops.pairs import PairBlock


def _a(x, dtype=None) -> np.ndarray:
    return np.array(x, dtype=dtype, copy=True)


def molecule(jmol) -> Molecule:
    return Molecule(z=_a(jmol.z, np.int64), symbols=list(jmol.symbols),
                    coords=_a(jmol.coords, np.float64), charge=int(jmol.charge),
                    multiplicity=int(jmol.multiplicity))


def basis(jbasis) -> Basis:
    shells = [Shell(l=int(s.l), atom=int(s.atom), center=_a(s.center),
                    exps=_a(s.exps), coefs=_a(s.coefs),
                    norm_coefs=_a(s.norm_coefs), offset=int(s.offset))
              for s in jbasis.shells]
    out = Basis(shells=shells, nbf=int(jbasis.nbf), nels=int(jbasis.nels),
                name=str(jbasis.name))
    for name in ("shell_l", "shell_atom", "shell_offset", "shell_nbf"):
        setattr(out, name, _a(getattr(jbasis, name), np.int64))
    for l, cl in jbasis.classes.items():
        out.classes[int(l)] = ShellClass(
            l=int(cl.l), shell_idx=_a(cl.shell_idx, np.int64),
            centers=_a(cl.centers), exps=_a(cl.exps), coefs=_a(cl.coefs),
            offsets=_a(cl.offsets, np.int64), atoms=_a(cl.atoms, np.int64))
    return out


def basis_sets(jsets) -> CalculationBasisSets:
    aux = jsets.auxiliary
    return CalculationBasisSets(primary=basis(jsets.primary),
                                auxiliary=None if aux is None else basis(aux),
                                spherical=bool(jsets.spherical))


def pair_blocks(jblocks) -> list[PairBlock]:
    return [PairBlock(la=int(b.la), lb=int(b.lb),
                      ish=_a(b.ish, np.int64), jsh=_a(b.jsh, np.int64),
                      aexp=_a(b.aexp), bexp=_a(b.bexp), acoef=_a(b.acoef),
                      bcoef=_a(b.bcoef), A=_a(b.A), B=_a(b.B),
                      off_a=_a(b.off_a, np.int64), off_b=_a(b.off_b, np.int64))
            for b in jblocks]


def packed_screen(jscreen) -> PackedScreen:
    return PackedScreen(nbf=int(jscreen.nbf), npq=int(jscreen.npq),
                        pq_flat=_a(jscreen.pq_flat, np.int64),
                        col_map=_a(jscreen.col_map, np.int64))


def tensor(x, device) -> torch.Tensor:
    """A (folded, packed or dense) B or any other float array as float64 on
    ``device``."""
    return torch.as_tensor(_a(x, np.float64), device=device)
