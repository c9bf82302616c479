"""The PyTorch port's CUDA kernels against their plain torch versions, on
the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  This file imports neither jax nor the JAX package, so it also runs on
a machine that has only torch:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Bounds: K1 and K4 1e-12 x the output's max-abs, K2 1e-12 relative in f64
and 1e-5 in f32, K3 1e-14 relative; K5 (list and staircase modes) and K6:
J and K within 1e-11 x max(|J|, |K|) of the plain versions (f64 atomics sum
in no fixed order); the DF-RHF and conventional RHF energies on the card
within 1e-9 Eh of the same runs on the CPU.
"""

import numpy as np
import pytest
import torch

import juliachem_jl_tpu_torch as jc
from juliachem_jl_tpu_torch.models import df_screened
from juliachem_jl_tpu_torch.ops import (boys, eri, eri3c, fock, fock_stream,
                                        kernels)
from juliachem_jl_tpu_torch.ops.pairs import unique_pair_blocks

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


@pytest.mark.cuda
def test_k4_eri4c_every_class(cuda_device):
    """Every (bra | ket) class of water 6-31+G* (s, p, d), all quartets,
    within 1e-12 x the largest integral (a class of one-center quartets
    whose angular momenta sum to an odd number is zero by parity, so its
    own max is rounding noise)."""
    prim, _ = _water()
    blocks = unique_pair_blocks(prim)
    n0 = kernels.launches["eri4c"]
    pairs = []
    for i, bra in enumerate(blocks):
        for ket in blocks[i:]:
            sb, sk = np.meshgrid(np.arange(bra.n), np.arange(ket.n),
                                 indexing="ij")
            got = eri.eri_block(bra, ket, sb.ravel(), sk.ravel(),
                                cuda_device).cpu()
            ref = eri.eri_block(bra, ket, sb.ravel(), sk.ravel(), CPU)
            pairs.append(((bra.la, bra.lb, ket.la, ket.lb), got, ref))
    assert kernels.launches["eri4c"] - n0 == len(pairs)
    scale = max(float(ref.abs().max()) for _, _, ref in pairs)
    for cls, got, ref in pairs:
        assert float((got - ref).abs().max()) <= 1e-12 * scale, cls


@pytest.mark.cuda
def test_k4_raises_for_a_class_it_lacks(cuda_device):
    """(ff|ss) is not instantiated: the wrapper raises instead of launching."""
    def table(l, n=1):
        return eri.PairTable(
            la=l, lb=l, Ka=1, Kb=1,
            pair=torch.ones((n, 10), dtype=torch.float64, device=cuda_device),
            meta=torch.ones((n, 5), dtype=torch.int32, device=cuda_device))

    sel = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    with pytest.raises(NotImplementedError):
        eri.eri4c_class(table(0), table(3), sel, sel)


@pytest.mark.cuda
@pytest.mark.parametrize("builder,kernel", [
    ("incore", "digest_jk"), ("direct", "eri4c_jk_list"),
    ("streaming", "eri4c_jk_stair")])
def test_k5_k6_jk_match_plain(cuda_device, builder, kernel):
    """J, K at a fixed symmetric D through K6 (in-core), K5 list mode
    (direct) and K5 staircase mode (streaming) against the plain versions."""
    prim, _ = _water("6-311++G(2d,2p)")
    rng = np.random.default_rng(3)
    X = rng.normal(size=(prim.nbf, prim.nbf))
    D = torch.as_tensor(X + X.T)

    def make(dev):
        if builder == "streaming":
            return fock_stream.StreamingDirectFock(prim, device=dev)
        return fock.ScreenedDirectFock(prim, incore=builder == "incore",
                                       device=dev)

    n0 = kernels.launches[kernel]
    Jg, Kg = (x.cpu() for x in make(cuda_device).jk_halves(D.to(cuda_device)))
    assert kernels.launches[kernel] > n0
    Jr, Kr = make(CPU).jk_halves(D)
    scale = max(float(Jr.abs().max()), float(Kr.abs().max()))
    assert float((Jg - Jr).abs().max()) <= 1e-11 * scale
    assert float((Kg - Kr).abs().max()) <= 1e-11 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("guess", ["sad", "df"])
def test_conventional_rhf_on_card_matches_cpu(cuda_device, guess):
    spec = jc.io.parse_input({
        "molecule": WATER,
        "model": {"method": "RHF", "basis": "6-31+G*",
                  "auxiliary_basis": "cc-pVTZ-JKFIT"},
        "keywords": {"scf": {"scf_type": "rhf", "niter": 60, "dele": 1e-10,
                             "rmsd": 1e-8, "guess": guess,
                             "mixed_precision": False}}})
    e_card = jc.run_spec(spec, device=cuda_device)["Energy"]
    e_cpu = jc.run_spec(spec, device=CPU)["Energy"]
    assert e_card["Converged?"] and e_cpu["Converged?"]
    assert e_card["Timings"].non_timing_data["fock_builder"] == \
        "ScreenedDirectFock"
    assert e_card["Density"].is_cuda
    assert abs(e_card["Energy"] - e_cpu["Energy"]) <= 1e-9
