"""Reference atomic energies for formation-energy properties.

Parity with reference records/eatom.h5 (read by FormationEnergies.jl:10).
The shipped table (extracted to data/eatom.json) covers what the reference
ships (RHF/RIMP2 x H x 47 basis sets); other (element, basis) pairs fall back
to computing the spherically-averaged atomic RHF energy on the fly — a
capability the reference lacks.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache

_PATH = os.path.join(os.path.dirname(__file__), "..", "data", "eatom.json")


@lru_cache(maxsize=1)
def _table() -> dict:
    with open(os.path.abspath(_PATH)) as f:
        return json.load(f)


def lookup_atom_energy(symbol: str, basis_name: str, device,
                       override: dict | None = None,
                       method: str = "RHF") -> float:
    if override and symbol in override:
        return float(override[symbol])
    entry = _table().get(method, {}).get(symbol, {})
    if basis_name in entry:
        return float(entry[basis_name])
    from ..models.guess import atomic_rhf_energy

    return atomic_rhf_energy(symbol, basis_name, device)
