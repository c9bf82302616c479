"""The PyTorch port's CUDA kernels against their plain torch versions, on
the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  This file imports neither jax nor the JAX package, so it also runs on
a machine that has only torch:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Bounds: K1 1e-12 x the output's max-abs, K2 1e-12 relative in f64 and 1e-5
in f32, K3 1e-14 relative; the DF-RHF energy on the card within 1e-9 Eh of
the same run on the CPU.
"""

import numpy as np
import pytest
import torch

import juliachem_jl_tpu_torch as jc
from juliachem_jl_tpu_torch.models import df_screened
from juliachem_jl_tpu_torch.ops import boys, eri3c, kernels

CPU = torch.device("cpu")
WATER = {"symbols": ["O", "H", "H"],
         "geometry": [0.0, 0.0, 0.116321, 0.0, 0.751155, -0.465285,
                      0.0, -0.751155, -0.465285]}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _water(prim="6-31+G*", aux="cc-pVTZ-JKFIT"):
    mol = jc.molecule.from_input_dict(WATER)
    return jc.basis.build(mol, prim), jc.basis.build_auxiliary(mol, aux, prim)


@pytest.mark.cuda
def test_k3_boys_probe(cuda_device):
    T = torch.linspace(0, 60, 20001, dtype=torch.float64, device=cuda_device)
    n0 = kernels.launches["boys_probe"]
    for m in range(9):
        ref = boys.boys(T, m)
        got = boys.boys_probe(T, m)
        assert float(((got - ref).abs() / ref.abs()).max()) <= 1e-14
    assert kernels.launches["boys_probe"] == n0 + 9


@pytest.mark.cuda
@pytest.mark.parametrize("aux_name", ["cc-pVTZ-JKFIT", "6-31G"],
                         ids=["jkfit", "contracted-aux"])
@pytest.mark.parametrize("what", ["metric", "three_center"])
def test_k1_eri3c(cuda_device, what, aux_name):
    """Every class of K1 (d primary shells, g aux shells); 6-31G as the
    auxiliary set gives contracted aux shells (Kq > 1)."""
    prim, aux = _water(aux=aux_name)
    if what == "metric":
        def f(d):
            return eri3c.two_center_metric(aux, d)
    else:
        def f(d):
            return eri3c.three_center_tensor(prim, aux, d)
    n0 = kernels.launches["eri3c"]
    got = f(cuda_device).cpu()
    assert kernels.launches["eri3c"] > n0
    ref = f(CPU)
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.cuda
def test_k1_raises_for_a_class_it_lacks(cuda_device):
    """(ff|s) is not instantiated: the wrapper raises instead of launching."""
    def zeros(*shape, dtype=torch.float64):
        return torch.zeros(shape, dtype=dtype, device=cuda_device)

    n, nab = 1, 100
    with pytest.raises(NotImplementedError):
        eri3c.eri3c_class(zeros(4, 4), 3, 3, 0, 1, 1, zeros(n, 10),
                          zeros(1, 5), zeros(1, dtype=torch.int64),
                          zeros(n, nab, dtype=torch.int64),
                          zeros(n, nab, dtype=torch.int64),
                          zeros(n, dtype=torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float64, 1e-12),
                                         (torch.float32, 1e-5)])
def test_k2_df_gather_w(cuda_device, dtype, bound):
    rng = np.random.default_rng(5)
    nbf, npq, qc, k = 137, 4000, 300, 21
    col_map = rng.integers(0, npq + 1, nbf * nbf).astype(np.int32)
    Bc = rng.normal(size=(qc, npq + 1))
    Bc[:, -1] = 0.0
    C = rng.normal(size=(nbf, k))
    Bc, C = (torch.tensor(a, device=cuda_device).to(dtype) for a in (Bc, C))
    col_map = torch.tensor(col_map, device=cuda_device)
    n0 = kernels.launches["df_gather_w"]
    got = df_screened.df_gather_w(Bc, col_map, C)
    assert kernels.launches["df_gather_w"] == n0 + 1
    ref = df_screened.df_gather_w_plain(Bc, col_map, C)
    assert float((got - ref).abs().max() / ref.abs().max()) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dense", "screened"])
def test_dfrhf_on_card_matches_cpu(cuda_device, mode):
    spec = jc.io.parse_input({
        "molecule": WATER,
        "model": {"method": "RHF", "basis": "6-31+G*",
                  "auxiliary_basis": "cc-pVTZ-JKFIT"},
        "keywords": {"scf": {"scf_type": "df", "niter": 60, "dele": 1e-10,
                             "rmsd": 1e-8, "guess": "sad",
                             "contraction_mode": mode}}})
    e_card = jc.run_spec(spec, device=cuda_device)["Energy"]
    e_cpu = jc.run_spec(spec, device=CPU)["Energy"]
    assert e_card["Converged?"] and e_cpu["Converged?"]
    assert e_card["Density"].is_cuda
    assert abs(e_card["Energy"] - e_cpu["Energy"]) <= 1e-9


def test_k2_wrapper_checks_its_inputs():
    """Runs everywhere: a mistyped call raises before any launch."""
    Bc = torch.zeros((2, 5), dtype=torch.float64)
    C = torch.zeros((2, 1), dtype=torch.float32)
    with pytest.raises(ValueError):
        df_screened.df_gather_w(Bc, torch.zeros(4, dtype=torch.int32), C)
    with pytest.raises(ValueError):
        df_screened.df_gather_w(Bc, torch.zeros(4, dtype=torch.int64),
                                C.double())
