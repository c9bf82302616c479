"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Each test builds its system here, runs the JAX package on the CPU backend and
the port on ``torch.device("cpu")`` (so the kernels' plain versions), and
compares the results as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

import juliachem_jl_tpu as jx
from juliachem_jl_tpu_torch import interop

CPU = torch.device("cpu")
# the suite runs several test processes at once (pytest-xdist); one torch
# thread each keeps them from oversubscribing the cores
torch.set_num_threads(1)

WATER = {
    "symbols": ["O", "H", "H"],
    "geometry": [0.0, 0.0, 0.116321, 0.0, 0.751155, -0.465285,
                 0.0, -0.751155, -0.465285],
    "molecular_charge": 0,
}

# (primary, auxiliary): s/p only with a d-capped aux set, and d primary
# shells with g aux shells, so every class template of K1 has a CPU oracle
SYSTEMS = {
    "water_631g": ("6-31G", "cc-pVDZ-JKFIT"),
    "water_631+gs": ("6-31+G*", "cc-pVTZ-JKFIT"),
}
# a contracted set as the auxiliary basis (every shipped fitting set is
# uncontracted); only for the 2-center metric, see ROADMAP.md C7
EXTRA_SYSTEMS = {"water_contracted_aux": ("6-31G", "6-31G")}


def jax_system(name: str):
    """(JAX molecule, JAX CalculationBasisSets) of a named test system."""
    prim, aux = {**SYSTEMS, **EXTRA_SYSTEMS}[name]
    mol = jx.molecule.from_input_dict(WATER)
    bsets = jx.basis.CalculationBasisSets(
        jx.basis.build(mol, prim), jx.basis.build_auxiliary(mol, aux, prim))
    return mol, bsets


def port_system(name: str):
    """The same system, carried into the port (identical basis arrays)."""
    mol, bsets = jax_system(name)
    return interop.molecule(mol), interop.basis_sets(bsets)


def np_(x) -> np.ndarray:
    """A torch tensor or array-like as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(port, ref, atol: float) -> None:
    port, ref = np_(port), np_(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= atol, f"max abs error {err:.3e} > {atol:.1e}"

