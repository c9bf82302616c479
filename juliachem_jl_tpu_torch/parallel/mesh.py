"""The rank grid: one ``torch.distributed`` rank per device.

Port of ``juliachem_jl_tpu/parallel/mesh.py``.  Where the JAX package lays
its devices out as a ``jax.sharding.Mesh`` with named axes and runs one SPMD
program over it, the port runs one process per device in a process group
(the reference's MPI ranks x GPUs, SURVEY.md §2.3) and names the same two
axes over the ranks:

  "q" — auxiliary-basis (Q) shards of the DF B tensor (DynamicLoad.jl:160-203,
        GPUDF.jl:1026-1056);
  "k" — a secondary axis over exchange-matrix columns, used only by the dense
        q x k Fock step (parallel/shard.py::df_fock_step).

Rank r sits at (q, k) = (r // nk, r % nk).  Backends: NCCL for CUDA, with
rank r on ``cuda:LOCAL_RANK``; gloo for the CPU.  ``JCHEM_DIST_BACKEND=gloo``
lets several ranks share one card; it is never chosen automatically.  Every
collective has the timeout ``JCHEM_DIST_TIMEOUT`` (seconds, default 600), so
a rank that dies before a collective cannot hang the others forever.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .. import config

DEFAULT_TIMEOUT = 600.0


def collective_timeout() -> float:
    """Seconds a collective may wait (``JCHEM_DIST_TIMEOUT``)."""
    return float(os.environ.get("JCHEM_DIST_TIMEOUT", DEFAULT_TIMEOUT))


def backend_for(device: torch.device) -> str:
    """``JCHEM_DIST_BACKEND`` when set (nccl or gloo), else NCCL for a CUDA
    device and gloo for the CPU."""
    named = os.environ.get("JCHEM_DIST_BACKEND", "")
    if named:
        if named not in ("nccl", "gloo"):
            raise ValueError(f"JCHEM_DIST_BACKEND={named!r}: nccl or gloo")
        return named
    return "nccl" if device.type == "cuda" else "gloo"


def _env_int(name: str) -> int | None:
    try:
        return int(os.environ[name])
    except (KeyError, ValueError):
        return None


def _local_world() -> int:
    """Ranks on this host (torchrun's LOCAL_WORLD_SIZE, else the world)."""
    return _env_int("LOCAL_WORLD_SIZE") or dist.get_world_size()


def _check_nccl_devices(local_world: int) -> None:
    visible = torch.cuda.device_count()
    if local_world > visible:
        raise RuntimeError(
            f"NCCL needs one GPU per rank: {local_world} ranks on this host, "
            f"{visible} GPU(s) visible.  Run fewer ranks, or let the ranks "
            "share a card through gloo with JCHEM_DIST_BACKEND=gloo")


def initialize_distributed(device=None) -> bool:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) — the analog of the reference's MPI.Init()
    (JCRuntime.jl:6-16).  Returns True if more than one rank is (now)
    active.

    It initialises only when the environment provably has more than one
    process (WORLD_SIZE > 1), or when ``JCHEM_DISTRIBUTED=1`` forces it (a
    group of one, as NCCL at world 1); a single process with stale or no
    variables stays single.  A failed bring-up raises: it never degrades to
    one process silently.  Idempotent."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world = _env_int("WORLD_SIZE")
    forced = os.environ.get("JCHEM_DISTRIBUTED") == "1"
    if not forced and (world is None or world <= 1):
        return False
    missing = [v for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if v not in os.environ]
    if missing:
        raise RuntimeError("initialize_distributed: the environment lacks "
                           + ", ".join(missing) + " (launch under torchrun "
                           "or juliachem_jl_tpu_torch.parallel.launch.spawn)")
    device = config.resolve_device(device)
    backend = backend_for(device)
    if backend == "nccl":
        _check_nccl_devices(_env_int("LOCAL_WORLD_SIZE") or world)
        torch.cuda.set_device(_env_int("LOCAL_RANK") or 0)
    dist.init_process_group(backend, init_method="env://",
                            timeout=timedelta(seconds=collective_timeout()))
    return dist.get_world_size() > 1


@dataclass(eq=False)
class Mesh:
    """This rank's place in the q x k rank grid, its device, and the
    collectives the sharded programs use.  ``backend`` None is a group of
    one without torch.distributed: every collective is the identity."""

    world: int
    rank: int
    device: torch.device
    backend: str | None
    nq: int
    nk: int
    q_group: object = None   # the ranks of this rank's k index (size nq)
    k_group: object = None   # the ranks of this rank's q index (size nk)
    share: int = 1           # ranks that share this rank's device

    @property
    def q_index(self) -> int:
        return self.rank // self.nk

    @property
    def k_index(self) -> int:
        return self.rank % self.nk

    def _group(self, axis: str | None):
        return {None: None, "q": self.q_group, "k": self.k_group}[axis]

    def _alone(self, axis: str | None) -> bool:
        """Nothing to exchange: no process group, or a grid axis of one
        rank (a group of one still runs its collectives: NCCL at world 1
        goes through the same calls)."""
        if axis is None:
            return self.backend is None
        return {"q": self.nq, "k": self.nk}[axis] == 1

    def _size(self, axis: str | None) -> int:
        return {None: self.world, "q": self.nq, "k": self.nk}[axis]

    def all_reduce_cat(self, *ts: torch.Tensor, axis: str | None = None):
        """The sums over the ranks of ``axis`` (None: all) of tensors of
        one dtype, in ONE collective on their concatenation (the
        MPI.Allreduce! of DensityFitting.jl:68-71); new tensors of the same
        shapes."""
        if self._alone(axis):
            return ts
        buf = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(buf, group=self._group(axis))
        out, o = [], 0
        for t in ts:
            out.append(buf[o:o + t.numel()].view(t.shape))
            o += t.numel()
        return tuple(out)

    def all_gather(self, t: torch.Tensor, dim: int = 0,
                   axis: str | None = None) -> torch.Tensor:
        """The ranks' equal-shaped ``t`` concatenated along ``dim`` in rank
        order (``jax.lax.all_gather(..., tiled=True)``)."""
        if self._alone(axis):
            return t
        n = self._size(axis)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=self._group(axis))
        return torch.cat(parts, dim=dim)

    def broadcast_(self, *ts: torch.Tensor, src: int = 0) -> None:
        """Overwrite each tensor with rank ``src``'s, in place."""
        if self.backend is None:
            return
        for t in ts:
            if t is not None:
                if not t.is_contiguous():
                    raise ValueError("broadcast_: a contiguous tensor")
                dist.broadcast(t, src)

    def agree_value(self, x: float) -> float:
        """Rank 0's host value ``x`` on every rank."""
        if self.backend is None:
            return x
        t = torch.tensor([float(x)], dtype=torch.float64,
                         device=self.device if self.backend == "nccl"
                         else "cpu")
        dist.broadcast(t, 0)
        return float(t.item())

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank (a host-side decision, such as a
        wall-clock deadline, that all ranks must take together)."""
        return bool(self.agree_value(1.0 if flag else 0.0))


def check_world(n_devices: int | None, device=None) -> int:
    """The device count of a run: ``n_devices`` (None: the group's size),
    which must equal the process group's size, one rank per device.  Under
    torchrun's environment the group is joined first; ``n_devices`` > 1
    with no group raises, saying how to start one."""
    if not dist.is_initialized() and (n_devices or 1) > 1:
        initialize_distributed(device)   # under torchrun: join its group
    if not dist.is_initialized():
        n = 1 if n_devices is None else int(n_devices)
        if n != 1:
            raise RuntimeError(
                f"num_devices={n} needs a process group of {n} ranks, one per "
                "device, and none is initialised: launch the program under "
                f"`torchrun --nproc-per-node {n}` (NCCL, one GPU each), or "
                "call juliachem_jl_tpu_torch.parallel.launch.spawn(fn, "
                f"{n}, ...)")
        return n
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"num_devices={n} but the process group has {world} "
                         "ranks: one rank per device")
    return n


def make_mesh(n_devices: int | None = None, k_axis: int = 1,
              device=None) -> Mesh:
    """The rank grid of the current process group, nq = n / k_axis rows
    by k_axis columns.  ``n_devices`` must equal the group's world size
    (None: take it; ``check_world``).  Without a process group only
    n_devices = 1 is possible: a group of one, whose collectives are the
    identity.  NCCL puts rank r on ``cuda:LOCAL_RANK``;
    under gloo the ranks use ``device`` (default: the package default),
    which several of them may share."""
    device = config.resolve_device(device)
    n = check_world(n_devices, device)
    if not dist.is_initialized():
        if k_axis != 1:
            raise ValueError(f"k_axis={k_axis} needs {k_axis} ranks")
        return Mesh(world=1, rank=0, device=device, backend=None, nq=1, nk=1)
    world, rank = dist.get_world_size(), dist.get_rank()
    backend = str(dist.get_backend())
    if n % k_axis != 0:
        raise ValueError(f"n_devices={n} not divisible by k_axis={k_axis}")
    share = 1
    if backend == "nccl":
        _check_nccl_devices(_local_world())
        local = _env_int("LOCAL_RANK") or 0
        if device.type != "cuda" or device.index not in (None, local):
            raise ValueError(f"NCCL rank {rank} runs on cuda:{local}, not "
                             f"{device}")
        device = torch.device("cuda", local)
    elif device.type == "cuda":
        share = _local_world()   # gloo ranks sharing the card
    nq = n // k_axis
    q_group = k_group = None
    if k_axis > 1:
        # every rank creates every subgroup, in the same order
        for q in range(nq):
            g = dist.new_group([q * k_axis + k for k in range(k_axis)])
            if q == rank // k_axis:
                k_group = g
        for k in range(k_axis):
            g = dist.new_group([q * k_axis + k for q in range(nq)])
            if k == rank % k_axis:
                q_group = g
    return Mesh(world=world, rank=rank, device=device, backend=backend,
                nq=nq, nk=k_axis, q_group=q_group, k_group=k_group,
                share=share)


def make_global_mesh(k_axis: int | None = None, device=None) -> Mesh:
    """The grid over every rank of every host, host-major: "q" spans hosts
    and "k" stays inside a host (the JAX package's ``make_global_mesh``).
    torchrun numbers ranks host by host, so k_axis consecutive ranks share a
    host when k_axis divides the ranks per host (or spans whole hosts when
    it is a multiple of them).  The per-iteration collectives on "k" move
    O(nbf^2) data every Fock build and belong inside a host; "q" reduces the
    final partials once per build and tolerates the network between hosts."""
    initialize_distributed(device)
    if not dist.is_initialized():
        return make_mesh(1, 1, device)
    n = dist.get_world_size()
    n_local = _local_world()
    n_hosts = max(1, n // n_local)
    if k_axis is None:
        k_axis = n_local if n_hosts > 1 else 1
    if n % k_axis != 0:
        raise ValueError(f"{n} ranks not divisible by k_axis={k_axis}")
    if n_hosts > 1 and n_local % k_axis != 0 and k_axis % n_local != 0:
        raise ValueError(
            f"k_axis={k_axis} must divide the ranks per host {n_local} "
            "(or be a multiple of it)")
    return make_mesh(n, k_axis, device)


def pad_to_multiple(x: np.ndarray, axis: int, multiple: int) -> np.ndarray:
    """Zero-pad one axis up to a multiple (even Q-shards: the analog of the
    reference's uneven Allgatherv + reorder, which SPMD avoids by padding)."""
    size = x.shape[axis]
    rem = (-size) % multiple
    if rem == 0:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return np.pad(x, pad)


def rank_path(path: str) -> str:
    """``path`` for this rank's own copy of a per-rank file: unchanged in a
    single process, else with ``.rank<r>`` before the extension, so that
    two ranks never write the same file."""
    if not path or not dist.is_initialized() or dist.get_world_size() == 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.rank{dist.get_rank()}{ext}"
