"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (in parallel)
for ``sm_90a`` and the objects are linked into one shared library with a plain
C interface, loaded with ctypes.  The library goes into ``_build/`` beside the
package, named by a hash of the sources and flags, and is built at the first
launch in a process; nothing is built when the package is imported.

Every launch goes through ``launch``: it passes PyTorch's current stream,
raises if the C function reports a CUDA error, and only then counts the launch
in ``launches`` (kernel name -> number of launches since the last
``reset_launches``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = ("-O3", "-std=c++17", ARCH, "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C symbol -> (kernel it launches, argument types before the stream)
_FUNCS = {
    "jc_eri3c": ("eri3c", [_I, _I, _I, _P, _LL, _I, _I, _P, _P, _I, _I,
                           _P, _P, _P, _P, _LL]),
    "jc_df_gather_w_f64": ("df_gather_w", [_P, _LL, _LL, _P, _P, _I, _I,
                                           _I, _P]),
    "jc_df_gather_w_f32": ("df_gather_w", [_P, _LL, _LL, _P, _P, _I, _I,
                                           _I, _P]),
    "jc_boys_probe": ("boys_probe", [_P, _LL, _I, _P]),
    "jc_eri4c": ("eri4c", [_I, _I, _I, _I, _P, _I, _I, _P, _P, _I, _I, _P,
                           _P, _P, _LL, _P]),
    "jc_eri4c_jk": ("eri4c_jk_list", [_I, _I, _I, _I, _P, _I, _I, _P, _P, _I,
                                      _I, _P, _P, _P, _P, _P, _LL, _I, _LL,
                                      _P, _LL, _P]),
    "jc_digest_jk": ("digest_jk", [_I, _I, _I, _I, _P, _P, _P, _P, _P, _LL,
                                   _P, _P, _LL, _P]),
}

launches = {"eri3c": 0, "df_gather_w": 0, "boys_probe": 0, "eri4c": 0,
            "eri4c_jk_list": 0, "eri4c_jk_stair": 0, "digest_jk": 0}

_lock = threading.Lock()
_lib = None
build_info: dict = {}   # so path, seconds, compiler output of the last build


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of csrc/ are built "
                       "with nvcc (set CUDA_HOME)")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/ into _build/libjchem_cuda_<hash>.so (once per source
    state) and return its path."""
    so = BUILD_DIR / f"libjchem_cuda_{_digest()}.so"
    if so.exists():
        build_info.setdefault("so", str(so))
        build_info.setdefault("seconds", 0.0)
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + "\n"
                               + "\n".join(logs)[-20000:])
        tmp_so = tmp / so.name
        link = subprocess.run(
            [nvcc, ARCH, "-shared", "-o", str(tmp_so),
             *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout[-20000:])
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_info.update(so=str(so), seconds=time.perf_counter() - t0,
                      log="\n".join(logs))
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for sym, (_, argtypes) in _FUNCS.items():
                fn = getattr(lib, sym)
                fn.argtypes = [*argtypes, _P]
                fn.restype = _I
            lib.jc_error_string.argtypes = [_I]
            lib.jc_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(symbol: str, *args, count_as: str | None = None) -> None:
    """Call one C entry point on PyTorch's current stream; raise on a CUDA
    error, else count the launch (under ``count_as`` when one entry point
    serves two modes)."""
    import torch

    lib = library()
    rc = getattr(lib, symbol)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {rc} "
                           f"({lib.jc_error_string(rc).decode()})")
    launches[count_as or _FUNCS[symbol][0]] += 1
