"""K4's and K5's plain versions against the JAX package on the g classes,
on the CPU.

The first 2 waters of the generated w32 cluster in 6-311++G(3df,3pd)+G
(tests/data/6-311ppG_3df_3pd_G.gbs: the library's 6-311++G(3df,3pd) and one
G shell on each O), read through both packages' GAMESS-US basis-file
entry: every class pair that holds a g shell (65 of the 120 pair-class
pairs), a few random quartets each, one case a class pair.  K4's plain
version is held to the JAX ``_eri_kernel_body`` on the same numpy inputs,
and K5's plain version in list mode (``fock.eri4c_jk_plain``, the blocks
digested at once into J and K with a random density and weights) to the
JAX digestion ``_digest_vals_body`` of the JAX blocks scattered into J and
K; both within 1e-12 x the max-abs of the JAX result.  The kernels
themselves are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 11).
"""

from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

import juliachem_jl_tpu as jx
import juliachem_jl_tpu_torch as tc
from juliachem_jl_tpu.ops import eri as jx_eri
from juliachem_jl_tpu.ops import fock as jx_fock
from juliachem_jl_tpu.ops.pairs import unique_pair_blocks as jx_blocks
from juliachem_jl_tpu_torch import interop
from juliachem_jl_tpu_torch.ops import eri as tc_eri
from juliachem_jl_tpu_torch.ops import fock as tc_fock
from tests._torch_parity import CPU, assert_close
from tests.test_torch_fshell_k4 import two_waters

G_BASIS = "6-311++G(3df,3pd)+G"
G_FILE = Path(__file__).parent / "data" / "6-311ppG_3df_3pd_G.gbs"


def register_g() -> None:
    """The g basis file registered in both packages (idempotent)."""
    jx.basis.register_basis_file(str(G_FILE), G_BASIS)
    tc.basis.register_basis_file(str(G_FILE), G_BASIS)


@lru_cache(maxsize=None)
def _blocks():
    register_g()
    return jx_blocks(jx.basis.build(jx.molecule.from_input_dict(two_waters()),
                                    G_BASIS))


@lru_cache(maxsize=None)
def _nbf() -> int:
    register_g()
    return jx.basis.build(jx.molecule.from_input_dict(two_waters()),
                          G_BASIS).nbf


def _g_class_pairs():
    blocks = _blocks()
    return [(i, j) for i in range(len(blocks)) for j in range(i, len(blocks))
            if 4 in (blocks[i].la, blocks[i].lb, blocks[j].la, blocks[j].lb)]


def test_every_g_class_pair_is_covered():
    assert len(_blocks()) == 15
    assert len(_g_class_pairs()) == 65


@pytest.mark.parametrize("bi,bj", _g_class_pairs())
def test_k4_k5_plain_match_jax_g(bi, bj):
    blocks = _blocks()
    bra, ket = blocks[bi], blocks[bj]
    rng = np.random.default_rng(100 * bi + bj)
    n = 4

    def near(blk):   # pairs of one water (|AB| < 3 bohr): sizeable blocks
        d = np.linalg.norm(blk.A - blk.B, axis=1)
        return np.flatnonzero(d < 3.0)

    sb = rng.choice(near(bra), n)
    sk = rng.choice(near(ket), n)
    body = jx_eri._eri_kernel_body(bra.la, bra.lb, ket.la, ket.lb,
                                   bra.aexp.shape[1], bra.bexp.shape[1],
                                   ket.aexp.shape[1], ket.bexp.shape[1])
    ref = np.asarray(body(bra.aexp[sb], bra.bexp[sb], bra.acoef[sb],
                          bra.bcoef[sb], bra.A[sb], bra.B[sb],
                          ket.aexp[sk], ket.bexp[sk], ket.acoef[sk],
                          ket.bcoef[sk], ket.A[sk], ket.B[sk]))
    assert np.abs(ref).max() > 1e-6   # not a class that vanishes by parity
    tb, tk = (tc_eri.pair_table(b, CPU)
              for b in interop.pair_blocks([bra, ket]))
    tsb, tsk = torch.as_tensor(sb), torch.as_tensor(sk)
    got = tc_eri.eri4c_class(tb, tk, tsb, tsk)
    assert_close(got, ref, 1e-12 * np.abs(ref).max())

    # K5, list mode: the same quartets digested into J, K
    nbf = _nbf()
    X = rng.normal(size=(nbf, nbf))
    D = X + X.T
    w = rng.uniform(0.25, 1.0, n)
    nc = [(l + 1) * (l + 2) // 2 for l in (bra.la, bra.lb, ket.la, ket.lb)]

    def rows(off, k):
        return off[:, None] + np.arange(k)[None, :]

    ia, ib = rows(bra.off_a[sb], nc[0]), rows(bra.off_b[sb], nc[1])
    ic, idd = rows(ket.off_a[sk], nc[2]), rows(ket.off_b[sk], nc[3])

    def flat(u, v):
        return (u[:, :, None] * nbf + v[:, None, :]).reshape(n, -1)

    vals = jx_fock._digest_vals_body(*nc)(
        ref, w, D.reshape(-1), flat(ia, ib), flat(ic, idd), flat(ia, ic),
        flat(ia, idd), flat(ib, ic), flat(ib, idd))
    JK_ref = np.zeros(2 * nbf * nbf)
    for v, t, base in zip(vals, (flat(ia, ib), flat(ic, idd), flat(ia, ic),
                                 flat(ia, idd), flat(ib, ic), flat(ib, idd)),
                          (0, 0, 1, 1, 1, 1)):
        np.add.at(JK_ref, base * nbf * nbf + t.reshape(-1),
                  np.asarray(v).reshape(-1))
    JK = torch.zeros((2, nbf, nbf), dtype=torch.float64)
    tc_fock.eri4c_jk_plain(JK, tb, tk, tsb, tsk, torch.as_tensor(w),
                           torch.as_tensor(D))
    assert_close(JK.reshape(-1), JK_ref, 1e-12 * np.abs(JK_ref).max())
