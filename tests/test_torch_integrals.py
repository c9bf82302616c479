"""Integral layer of the PyTorch port vs the JAX package, on the CPU.

The port runs on torch.device("cpu"), so every kernel wrapper takes its
plain torch version; the JAX side runs its host (numpy) path, which
tests/test_df_screened.py::test_device_3c_path_matches_host ties to the
jitted device kernel.  Tolerances: 1e-14 relative for Boys, 1e-12 max-abs
for integral blocks (the JAX stages agree with each other to ~1e-13).
The kernels themselves run on the card only (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from juliachem_jl_tpu.models.df import screened_pair_blocks as jx_screened_blocks
from juliachem_jl_tpu.ops import boys as jx_boys
from juliachem_jl_tpu.ops import eri3c as jx_eri3c
from juliachem_jl_tpu.ops import mcmurchie as jx_md
from juliachem_jl_tpu.ops import oei as jx_oei
from juliachem_jl_tpu.ops import schwarz as jx_schwarz
from juliachem_jl_tpu.ops.pairs import unique_pair_blocks as jx_pairs
from juliachem_jl_tpu_torch import interop
from juliachem_jl_tpu_torch.models.df_screened import build_packed_screen
from juliachem_jl_tpu_torch.ops import boys as tc_boys
from juliachem_jl_tpu_torch.ops import eri3c as tc_eri3c
from juliachem_jl_tpu_torch.ops import kernels
from juliachem_jl_tpu_torch.ops import mcmurchie as tc_md
from juliachem_jl_tpu_torch.ops import oei as tc_oei
from juliachem_jl_tpu_torch.ops import schwarz as tc_schwarz
from tests._torch_parity import (CPU, SYSTEMS, assert_close, jax_system,
                                 np_, port_system)


@pytest.mark.parametrize("mmax", [0, 1, 4, 8, 12])
def test_boys_matches_numpy(mmax):
    T = np.concatenate([np.linspace(0.0, 60.0, 6001), [1e-12, 34.999, 35.0,
                                                       35.001]])
    ref = jx_boys.boys_np(T, mmax)
    got = np_(tc_boys.boys(torch.tensor(T, dtype=torch.float64), mmax))
    assert np.max(np.abs(got - ref) / np.abs(ref)) <= 1e-14


@pytest.mark.parametrize("la,lb", [(0, 0), (1, 2), (2, 2)])
def test_hermite_e_and_r_match(la, lb):
    rng = np.random.default_rng(7)
    n, Ka, Kb = 5, 3, 2
    args = [rng.uniform(0.2, 4.0, (n, Ka)), rng.uniform(0.2, 4.0, (n, Kb)),
            rng.normal(size=(n, Ka)), rng.normal(size=(n, Kb)),
            rng.normal(size=(n, 3)), rng.normal(size=(n, 3))]
    pj = jx_md.pair_primitive_data(*args)
    pt = tc_md.pair_primitive_data(*(torch.tensor(a) for a in args))
    assert_close(tc_md.e_dense(la, lb, pt), jx_md.e_dense(la, lb, pj), 1e-12)
    assert_close(tc_md.hermite_expansion(la, lb, pt),
                 jx_md.hermite_expansion(la, lb, pj), 1e-12)
    L = la + lb + 4
    alpha = rng.uniform(0.1, 3.0, (n, 4))
    X = rng.normal(size=(n, 4, 3))
    T = alpha * (X ** 2).sum(-1)
    F = jx_boys.boys_np(T, L)
    assert_close(tc_md.r_tensor(L, torch.tensor(alpha), torch.tensor(X),
                                torch.tensor(F)),
                 jx_md.r_tensor(L, alpha, X, F), 1e-12)


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_one_electron_matrices(name):
    jmol, jb = jax_system(name)
    tmol, tb = port_system(name)
    for got, ref in zip(tc_oei.overlap_kinetic_nuclear(tb.primary, tmol, CPU),
                        jx_oei.overlap_kinetic_nuclear(jb.primary, jmol)):
        assert_close(got, ref, 1e-12)
    for got, ref in zip(tc_oei.dipole_matrices(tb.primary, CPU),
                        jx_oei.dipole_matrices(jb.primary)):
        assert_close(got, ref, 1e-12)


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_pair_schwarz(name):
    _, jb = jax_system(name)
    for blk in jx_pairs(jb.primary):
        got = tc_schwarz.pair_schwarz(interop.pair_blocks([blk])[0], CPU)
        assert_close(got, jx_schwarz.pair_schwarz(blk), 1e-12)


@pytest.mark.parametrize("name", [*SYSTEMS, "water_contracted_aux"])
def test_two_center_metric(name):
    """The JAX metric runs the 4-center body with one-primitive unit shells;
    the contracted aux set (Kq up to 6) holds the port's unit partner to
    one primitive too (ROADMAP.md C7)."""
    _, jb = jax_system(name)
    _, tb = port_system(name)
    assert_close(tc_eri3c.two_center_metric(tb.auxiliary, CPU),
                 jx_eri3c.two_center_metric(jb.auxiliary), 1e-12)


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("name", list(SYSTEMS))
def test_three_center_tensor(name, packed):
    _, jb = jax_system(name)
    _, tb = port_system(name)
    metric_max = float(np.diag(jx_eri3c.two_center_metric(jb.auxiliary)).max())
    jblocks = jx_screened_blocks(jb.primary, 1e-5, metric_max)
    tblocks = interop.pair_blocks(jblocks)
    kw = {}
    if packed:
        screen = build_packed_screen(tb.primary, tblocks)
        kw = {"col_map": screen.col_map, "packed_width": screen.npq + 1}
    ref = jx_eri3c.three_center_tensor(jb.primary, jb.auxiliary, jblocks, **kw)
    got = tc_eri3c.three_center_tensor(tb.primary, tb.auxiliary, CPU, tblocks,
                                       **kw)
    assert_close(got, ref, 1e-12)


def test_cpu_wrappers_never_load_the_kernels():
    _, tb = port_system("water_631g")
    before = dict(kernels.launches)
    tc_eri3c.two_center_metric(tb.auxiliary, CPU)
    tc_boys.boys_probe(torch.linspace(0, 40, 11, dtype=torch.float64), 3)
    assert kernels.launches == before
    assert kernels._lib is None

