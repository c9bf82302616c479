"""Start a process group on one host: n ranks, one process each.

``spawn(fn, n, ...)`` runs ``fn(*args)`` on every rank of a fresh group and
returns the ranks' results, in rank order, to the caller — the analog of
``mpiexec -n`` for the reference and of the JAX package's two-process smoke
(``parallel/dist_smoke.py``).  Each rank is a new interpreter
(``python -m juliachem_jl_tpu_torch.parallel.launch``) with torchrun's
variables set, a free port on 127.0.0.1, and the caller's ``sys.path``, so
``fn`` must be a module-level function of an importable module.

A rank has ``setup_timeout`` seconds to join the group and then ``timeout``
seconds for its work, and every collective times out after ``timeout``
(``JCHEM_DIST_TIMEOUT``).  When one rank fails or the time runs out, every
rank is killed and the parent raises with the failing rank's error: no rank
outlives the call.  Results travel as pickles that the ranks write into a
temporary directory of the caller's ``TMPDIR``.
"""

from __future__ import annotations

import importlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
import traceback


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def spawn(fn, n: int, *, args: tuple = (), backend: str | None = None,
          device: str = "cpu", timeout: float = 600.0,
          setup_timeout: float = 120.0) -> list:
    """Run ``fn(*args)`` on ``n`` ranks of a new ``backend`` group whose
    ranks use ``device`` ("cpu"; "cuda" puts NCCL rank r on cuda:r; under
    gloo "cuda:0" lets every rank share card 0).  ``backend`` defaults to
    NCCL for a CUDA device and gloo for the CPU: gloo on the card only
    when named.  Returns [rank 0's result,
    ..., rank n-1's].  Raises RuntimeError when a rank fails and
    TimeoutError when one does not join or finish in time; either way no
    rank survives."""
    if backend is None:
        backend = "nccl" if device.startswith("cuda") else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if device.startswith("cuda"):
        # one build of the kernels for all ranks, before they start
        from ..ops import kernels

        kernels.build()
    fn_ref = (fn.__module__, fn.__qualname__)
    importlib.import_module(fn_ref[0])   # fail here, not in n children
    port = free_port()
    path = os.pathsep.join(p for p in sys.path if p and os.path.isdir(p))
    with tempfile.TemporaryDirectory(prefix="jchem_spawn_") as work:
        with open(os.path.join(work, "spec.pkl"), "wb") as f:
            pickle.dump({"fn": fn_ref, "args": args, "device": device}, f)
        base = dict(os.environ)
        base.update({
            "WORLD_SIZE": str(n), "LOCAL_WORLD_SIZE": str(n),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
            "JCHEM_DIST_BACKEND": backend, "JCHEM_DISTRIBUTED": "1",
            "JCHEM_DIST_TIMEOUT": str(timeout), "PYTHONPATH": path,
        })
        if device == "cpu" and "OMP_NUM_THREADS" not in os.environ:
            # the ranks share this host's cores
            base["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // n))
        procs = []
        try:
            for r in range(n):
                env = dict(base, RANK=str(r), LOCAL_RANK=str(r))
                with open(os.path.join(work, f"rank{r}.log"), "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m",
                         "juliachem_jl_tpu_torch.parallel.launch", work,
                         str(r)], env=env, stdout=log,
                        stderr=subprocess.STDOUT))
            _wait(procs, work, setup_timeout, timeout)
            return [_result(work, r) for r in range(n)]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()


def _wait(procs, work: str, setup_timeout: float, timeout: float) -> None:
    t0 = time.monotonic()
    work_deadline = None
    while True:
        codes = [p.poll() for p in procs]
        if any(c not in (None, 0) for c in codes):
            # the others usually fail within moments (a collective with a
            # dead peer): let them, so that every failing rank is reported
            end = time.monotonic() + 2.0
            while time.monotonic() < end and None in codes:
                time.sleep(0.05)
                codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            raise RuntimeError(
                f"rank(s) {bad} of {len(procs)} failed; the group was "
                "stopped.  Their output ends:\n" + "\n".join(
                    f"--- rank {r} (exit {codes[r]}):\n"
                    + _tail(os.path.join(work, f"rank{r}.log"))
                    for r in bad))
        if all(c == 0 for c in codes):
            return
        now = time.monotonic()
        if work_deadline is None:
            if all(os.path.exists(os.path.join(work, f"ready{r}"))
                   for r in range(len(procs))):
                work_deadline = now + timeout
            elif now - t0 > setup_timeout:
                raise TimeoutError(f"the {len(procs)} ranks did not join the "
                                   f"group within {setup_timeout:g} s")
        elif now > work_deadline:
            raise TimeoutError(f"the {len(procs)} ranks did not finish "
                               f"within {timeout:g} s; the group was stopped")
        time.sleep(0.05)


def _result(work: str, r: int):
    path = os.path.join(work, f"result{r}.pkl")
    if not os.path.exists(path):
        raise RuntimeError(f"rank {r} exited without a result")
    with open(path, "rb") as f:
        return pickle.load(f)


def _child(work: str, rank: int) -> None:
    import torch.distributed as dist

    from .. import config
    from . import mesh

    with open(os.path.join(work, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    device = spec["device"]
    if device == "cuda" and os.environ["JCHEM_DIST_BACKEND"] == "nccl":
        device = f"cuda:{rank}"
    config.set_default_device(device)
    mesh.initialize_distributed(device)
    open(os.path.join(work, f"ready{rank}"), "w").close()
    mod, name = spec["fn"]
    fn = importlib.import_module(mod)
    for part in name.split("."):
        fn = getattr(fn, part)
    result = fn(*spec["args"])
    tmp = os.path.join(work, f"result{rank}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, os.path.join(work, f"result{rank}.pkl"))
    dist.destroy_process_group()


if __name__ == "__main__":
    try:
        _child(sys.argv[1], int(sys.argv[2]))
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
