"""K4's plain version against the JAX package on the f classes, on the CPU.

The first 2 waters of the generated w32 cluster
(juliachem_jl_tpu_torch/data/water_clusters.json) in 6-31G(2df,p): every
class pair that holds an f shell (34 of the 55 pair-class pairs), a few
random quartets each, within 1e-12 x the block's max-abs of the JAX
``_eri_kernel_body`` on the same numpy inputs.  Two waters, so that f
shells sit on two centres and no class pair is all one-centre quartets
(whose odd-parity classes vanish).  The kernels themselves are held to
these plain versions on the card (tests/test_torch_cuda.py).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import juliachem_jl_tpu as jx
from juliachem_jl_tpu.ops import eri as jx_eri
from juliachem_jl_tpu.ops.pairs import unique_pair_blocks as jx_blocks
from juliachem_jl_tpu_torch import interop
from juliachem_jl_tpu_torch.ops import eri as tc_eri
from tests._torch_parity import CPU, assert_close

F_BASIS = "6-31G(2df,p)"
CLUSTERS = (Path(__file__).resolve().parents[1] / "juliachem_jl_tpu_torch"
            / "data" / "water_clusters.json")


def two_waters() -> dict:
    """The first 2 waters of the generated w32 cluster, as a molecule."""
    c = json.loads(CLUSTERS.read_text())["w32"]
    return {"symbols": c["symbols"][:6], "geometry": c["geometry"][:18],
            "molecular_charge": 0}


def _blocks():
    return jx_blocks(jx.basis.build(jx.molecule.from_input_dict(two_waters()),
                                    F_BASIS))


def _f_class_pairs():
    blocks = _blocks()
    return [(i, j) for i in range(len(blocks)) for j in range(i, len(blocks))
            if 3 in (blocks[i].la, blocks[i].lb, blocks[j].la, blocks[j].lb)]


def test_every_f_class_pair_is_covered():
    assert len(_f_class_pairs()) == 34


@pytest.mark.parametrize("bi,bj", _f_class_pairs())
def test_k4_plain_matches_jax_eri_body_f(bi, bj):
    blocks = _blocks()
    bra, ket = blocks[bi], blocks[bj]
    rng = np.random.default_rng(100 * bi + bj)
    n = 6
    sb = rng.integers(0, bra.n, n)
    sk = rng.integers(0, ket.n, n)
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
    got = tc_eri.eri4c_class(tb, tk, torch.as_tensor(sb), torch.as_tensor(sk))
    assert_close(got, ref, 1e-12 * np.abs(ref).max())
