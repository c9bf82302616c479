"""K1's plain version against the JAX package on the g classes, on the CPU.

The first 2 waters of the generated w32 cluster in 6-311++G(3df,3pd)+G
(tests/data/6-311ppG_3df_3pd_G.gbs, read through both packages' basis-file
entry) with cc-pVTZ-JKFIT: the (Q | ab) rows of each primary g class (0,4),
(1,4), (2,4), (3,4), (4,4) against each aux class lq = 0..4, from the
port's ``three_center_tensor`` on that one pair block (K1's plain version
on the CPU) and from the JAX package's host 3-center builder
(``_three_center_host``), within 1e-12 x the rows' max-abs.
"""

from functools import lru_cache

import numpy as np
import pytest

import juliachem_jl_tpu as jx
from juliachem_jl_tpu.ops import eri3c as jx_eri3c
from juliachem_jl_tpu.ops.pairs import unique_pair_blocks as jx_blocks
from juliachem_jl_tpu_torch import interop
from juliachem_jl_tpu_torch.ops import eri3c as tc_eri3c
from tests._torch_parity import CPU, assert_close, np_
from tests.test_torch_fshell_k4 import two_waters
from tests.test_torch_gshell_k4 import G_BASIS, register_g


@lru_cache(maxsize=None)
def _system():
    register_g()
    mol = jx.molecule.from_input_dict(two_waters())
    prim = jx.basis.build(mol, G_BASIS)
    aux = jx.basis.build_auxiliary(mol, "cc-pVTZ-JKFIT", G_BASIS)
    return prim, aux


@lru_cache(maxsize=None)
def _both(la: int, lb: int):
    """(port, JAX) dense (Q | ab) tensors [A, nbf, nbf] of one pair block."""
    prim, aux = _system()
    blk = next(b for b in jx_blocks(prim) if (b.la, b.lb) == (la, lb))
    ref = jx_eri3c._three_center_host(prim, aux, [blk], None, None)
    got = tc_eri3c.three_center_tensor(interop.basis(prim),
                                       interop.basis(aux), CPU,
                                       interop.pair_blocks([blk]))
    return np_(got), np.asarray(ref).reshape(np_(got).shape)


@pytest.mark.parametrize("lq", range(5))
@pytest.mark.parametrize("la", range(5))
def test_k1_plain_matches_jax_g_classes(la, lq):
    _, aux = _system()
    cl = aux.classes[lq]
    rows = (cl.offsets[:, None] + np.arange((lq + 1) * (lq + 2) // 2)).ravel()
    got, ref = _both(la, 4)
    scale = np.abs(ref[rows]).max()
    assert scale > 1e-6
    assert_close(got[rows], ref[rows], 1e-12 * scale)
