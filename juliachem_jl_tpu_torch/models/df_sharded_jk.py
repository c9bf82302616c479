"""Sharded spin-resolved DF J/K builder: multi-device UHF/ROHF.

Port of ``juliachem_jl_tpu/models/df_sharded_jk.py``: the production sharded
path (df_sharded.py — this rank's packed Q rows of B, one all_reduce per
build) behind the open-shell ``two_electron_jk`` interface of models/uhf.py
and models/rohf.py.  The sharded form of models/df_screened_jk.py.
"""

from __future__ import annotations

import torch

from ..parallel.shard_jk import packed_jk_step
from ..utils.timings import JCTC, Timings
from .df_screened_jk import ScreenedDFJKBuilder
from .df_sharded import ShardedDFFockBuilder


class ShardedDFJKBuilder(ShardedDFFockBuilder):
    """ShardedDFFockBuilder plus two_electron_jk over the ranks."""

    _spin_factor = staticmethod(ScreenedDFJKBuilder._spin_factor)

    def two_electron_jk(self, Da, Db, iteration, timings: Timings,
                        Ca=None, Cb=None):
        d = torch.cat([(Da + Db).reshape(-1)[self._pq_flat], Da.new_zeros(1)])
        Cs_a, s_a = self._spin_factor(Da, Ca)
        Cs_b, s_b = self._spin_factor(Db, Cb)
        with timings.timed(JCTC.fock_time + "_device", iteration):
            return packed_jk_step(self.mesh, self, d, Cs_a, s_a, Cs_b, s_b)
