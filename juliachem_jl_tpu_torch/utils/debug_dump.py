"""Debug intermediate dumps (reference debug.h5 analog).

Port of ``juliachem_jl_tpu/utils/debug_dump.py``.  With scf_flags["debug"]
= true the reference writes every SCF intermediate (S, T, V, H, X,
per-iteration F, C, D, energies) to debug.h5 for golden-file diffing
against another package (SCF.jl:119-126,330-336,467-469,1090-1122).  Same
here, keyed identically per iteration (``key/iteration``); a tensor is
written as its numpy copy.  ``h5py`` is imported at the first write, so a
run without ``debug`` never needs it; where it is missing a debug run
raises ``ImportError``.
"""

from __future__ import annotations

import numpy as np
import torch


class DebugDump:
    def __init__(self, path: str = "debug.h5", enabled: bool = False):
        self.enabled = enabled
        self.path = path
        self._file = None

    def _f(self):
        if self._file is None:
            import h5py

            self._file = h5py.File(self.path, "w")
        return self._file

    def write(self, key: str, value, iteration: int | None = None) -> None:
        if not self.enabled:
            return
        if iteration is not None:
            key = f"{key}/{iteration}"
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        f = self._f()
        if key in f:
            del f[key]
        f.create_dataset(key, data=np.asarray(value))

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
