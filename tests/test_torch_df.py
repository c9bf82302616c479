"""DF layer of the PyTorch port vs the JAX package, on the CPU.

The metric fold, B (dense and packed) and one Fock build of both builders at
a fixed D and C.  For the Fock builds the port is handed the B the JAX
package built (juliachem_jl_tpu_torch.interop), so the per-iteration J/K is
compared apart from the 3-center build.  Tolerances: B 1e-10 max-abs;
G 1e-10 max-abs in f64 and 1e-4 x max|G| in the f32 phase.
"""

import warnings

import numpy as np
import pytest
import torch

from juliachem_jl_tpu.models import df as jx_df
from juliachem_jl_tpu.models import df_screened as jx_dfs
from juliachem_jl_tpu.models import linalg as jx_linalg
from juliachem_jl_tpu.utils.options import create_scf_options as jx_options
from juliachem_jl_tpu.utils.timings import Timings as JxTimings
from juliachem_jl_tpu_torch import interop
from juliachem_jl_tpu_torch.models import df as tc_df
from juliachem_jl_tpu_torch.models import df_screened as tc_dfs
from juliachem_jl_tpu_torch.models import linalg as tc_linalg
from juliachem_jl_tpu_torch.utils.options import create_scf_options
from juliachem_jl_tpu_torch.utils.timings import Timings
from tests._torch_parity import (CPU, SYSTEMS, assert_close, jax_system,
                                 port_system)

FLAGS = {"scf_type": "df"}


@pytest.mark.parametrize("singular", [False, True], ids=["cholesky", "pinv"])
def test_fold_metric(singular):
    rng = np.random.default_rng(3)
    n, m = 40, 25
    X = rng.normal(size=(n, n))
    w = np.geomspace(1e-3, 10.0, n)
    if singular:
        w[:4] = 1e-19   # below the Cholesky ratio gate: pseudo-inverse branch
    Q, _ = np.linalg.qr(X)
    metric = (Q * w) @ Q.T
    metric = 0.5 * (metric + metric.T)
    B = rng.normal(size=(n, m))
    ref = B.copy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jx_linalg.fold_metric(metric, ref)
        got = tc_linalg.fold_metric(torch.tensor(metric), torch.tensor(B))
    assert_close(got, ref, 1e-10 * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_build_B_dense(name):
    _, jb = jax_system(name)
    _, tb = port_system(name)
    ref = jx_df.build_B(jb.primary, jb.auxiliary, jx_options(FLAGS))
    got = tc_df.build_B(tb.primary, tb.auxiliary, create_scf_options(FLAGS), CPU)
    assert_close(got, ref, 1e-10)


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_build_B_packed(name):
    _, jb = jax_system(name)
    _, tb = port_system(name)
    ref, jscreen = jx_dfs.build_B_packed(jb.primary, jb.auxiliary,
                                         jx_options(FLAGS))
    got, screen = tc_dfs.build_B_packed(tb.primary, tb.auxiliary,
                                        create_scf_options(FLAGS), CPU)
    assert screen.npq == jscreen.npq
    assert np.array_equal(screen.col_map, jscreen.col_map)
    assert_close(got, ref, 1e-10)


@pytest.fixture(scope="module")
def builders():
    """JAX builders of both kinds on water 6-31+G* / cc-pVTZ-JKFIT, and the
    port's builders over the very same B."""
    _, jb = jax_system("water_631+gs")
    opts = jx_options(FLAGS)
    jdense = jx_df.DFFockBuilder(jb.primary, jb.auxiliary, opts,
                                 timings=JxTimings())
    jpacked = jx_dfs.ScreenedDFFockBuilder(jb.primary, jb.auxiliary, opts,
                                           timings=JxTimings())
    topts = create_scf_options(FLAGS)
    tdense = tc_df.DFFockBuilder(interop.tensor(np.asarray(jdense.B), CPU), topts)
    tpacked = tc_dfs.ScreenedDFFockBuilder(
        interop.tensor(np.asarray(jpacked.B), CPU),
        interop.packed_screen(jpacked.screen), topts, jb.primary.nels // 2)
    return jb, {"dense": (jdense, tdense), "packed": (jpacked, tpacked)}


_FOCK_CASES = [(kind, prec, signed, kb)
               for kind, kbs in (("dense", (1,)), ("packed", (1, 4)))
               for prec in ("f64", "f32") for signed in (False, True)
               for kb in kbs]


@pytest.mark.parametrize("kind,precision,signed,k_blocks", _FOCK_CASES,
                         ids=["-".join(map(str, c)) for c in _FOCK_CASES])
def test_two_electron_fock(builders, kind, precision, signed, k_blocks):
    jb, pair = builders
    jx, tc = pair[kind]
    if kind == "packed":
        jx.k_blocks = tc.k_blocks = k_blocks
    rng = np.random.default_rng(11)
    nbf, nocc = jb.primary.nbf, jb.primary.nels // 2
    if signed:
        M = rng.normal(size=(nbf, nbf))
        D, C = M + M.T, None          # indefinite: the signed eigen-factor
    else:
        C = rng.normal(size=(nbf, nocc)) * 0.3
        D = 2.0 * C @ C.T
    ref = np.asarray(jx.two_electron_fock(D, 1, JxTimings(), C_occ=C,
                                          precision=precision))
    got = tc.two_electron_fock(torch.tensor(D), 1, Timings(),
                               C_occ=None if C is None else torch.tensor(C),
                               precision=precision)
    # the dense builder builds a C-free (signed) G in f64 whatever the phase
    f32 = precision == "f32" and not (kind == "dense" and signed)
    tol = 1e-4 * np.abs(ref).max() if f32 else 1e-10
    assert_close(got, ref, tol)


def test_gather_w_wrapper_plain_on_cpu():
    """K2's wrapper on CPU tensors is the tile gather + einsum."""
    rng = np.random.default_rng(5)
    nbf, npq, qc, k = 9, 30, 4, 3
    col_map = rng.integers(0, npq + 1, nbf * nbf).astype(np.int32)
    Bc = rng.normal(size=(qc, npq + 1))
    Bc[:, -1] = 0.0
    C = rng.normal(size=(nbf, k))
    tile = Bc[:, col_map].reshape(qc, nbf, nbf)
    ref = np.einsum("qmn,mi->qin", tile, C)
    slabs = tc_dfs.k2_slabs(col_map, nbf, npq)
    got = tc_dfs.df_gather_w(torch.tensor(Bc), torch.tensor(col_map),
                             torch.tensor(C), slabs)
    assert_close(got, ref, 1e-13)


@pytest.mark.parametrize("upcast_rows", [7, 10_000])
def test_sweep_upcasts_each_f32_slice_once(builders, upcast_rows):
    """The f64 build on an f32 B forms V_Q = B_Q d and its product V_Q B_Q
    from one upcast of each row slice; G is bit for bit the two-pass form
    (every V_Q from one upcast, then J from a second upcast of the same
    slices), over several Q-blocks and slices a block."""
    jb, pair = builders
    _, tpacked = pair["packed"]
    nocc = jb.primary.nels // 2
    B32 = tpacked.B.float()
    fb = tc_dfs.ScreenedDFFockBuilder(
        B32, tpacked.screen,
        create_scf_options({**FLAGS, "df_b_dtype": "f32",
                            "df_exchange_n_blocks": 3}), nocc)
    fb.upcast_rows = upcast_rows
    rng = np.random.default_rng(4)
    C = torch.tensor(rng.normal(size=(jb.primary.nbf, nocc)) * 0.3)
    D = 2.0 * C @ C.T
    G = fb.two_electron_fock(D, 2, Timings(), C_occ=C)
    d = torch.cat([D.reshape(-1)[fb._pq_flat], D.new_zeros(1)])
    blocks = fb.q_blocks(fb.B, nocc)
    assert len(blocks) == 3
    Vs = [torch.cat([sub @ d for sub in fb._rows_as(blk, torch.float64)])
          for blk in blocks]
    Jp = torch.zeros(fb.screen.npq + 1, dtype=torch.float64)
    for V, blk in zip(Vs, blocks):
        r = 0
        for sub in fb._rows_as(blk, torch.float64):
            Jp += V[r:r + sub.shape[0]] @ sub
            r += sub.shape[0]
    K, _ = fb.sweep(blocks, None, C.contiguous(), None)
    assert torch.equal(G, fb.scatter_j(Jp) - K.double())
