"""Screened (packed-pq) density-fitted Fock build — the scale path.

Port of ``juliachem_jl_tpu/models/df_screened.py`` (the reference's
ScreenedDF.jl as packed tensors):

  reference (ScreenedDF.jl)                  here
  -------------------------                  ----
  sparse_pq_index_map + contiguous           PackedScreen.col_map (flat
  non-zero ranges per p (:16-77)             (mu,nu) -> packed column; trash
                                             column for screened-out entries)
  B stored [rank_Q, screened_pq] (:98-105)   B stored [A, npq+1] (both index
                                             orders packed; last col zero)
  per-p gemms over non-zero rows for W       per-Q-block kernel K2: the gather
  (:242-289)                                 through col_map fused into
                                             W = B_block C, no dense tile
  blocked lower-triangle exchange            optional upper block triangle of
  (:385-641)                                 K = W^T W (k_blocks > 1)
  screened symmetric J via per-p gemv        packed matvec pair
  (:318-365)                                 V = B d, J = V B

B is f64 or, with ``df_b_dtype: "f32"``, f32: K1 stores f32, the row
projection and the metric fold work in place, and the f64 iterations read
the f32 B through f64 products (K2's f32-B instantiation for W, upcast row
slices for V = B d and J = V B, where the JAX package promotes the f32
blocks against the f64 d and C).  The B, raw-3c and one-electron disk
caches are ported with the port's own files.

Memory modes, chosen before the 3-center build from B's bytes against the
card's budget (``ScreenedDFFockBuilder.memory_mode``; the JAX package's
``models/df_screened.py:23-28,426-440``, measured against the port's own
``budgets``):

  resident          B on the card, with B32 for the mixed-precision phase
                    (an f32 B is its own copy)
  stream, B32       B in page-locked host memory, streamed per Q-block each
  resident          f64 iteration through two device buffers (the copy of
                    block i+1 on a side stream while K2, W^T W and V B run
                    on block i); B32 on the card, made one uploaded block at
                    a time, for the f32 phase
  stream            even B32 does not fit: the f32 phase streams the host
                    blocks too and casts each on the card (round to
                    nearest, as the JAX package's host cast)

In a stream mode the build walks B in column chunks (K1 into the chunk,
then its projection and fold, then the copy into the host B), so P3 never
lies whole on the card.  A host B over the machine's available memory
raises ``MemoryError`` before the build.  On the CPU the "host" B is the
CPU tensor and its blocks are views: the same code without the side
stream.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time
import warnings
import weakref
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass

import numpy as np
import torch

from ..basis.spherical import aux_needs_sph, nsph
from ..ops import eri3c, kernels
from ..utils.timings import JCTC, Timings
from . import df
from .df import screened_pair_blocks, signed_factor
from .scf import FockBuilder


@dataclass
class PackedScreen:
    """Sparse pq bookkeeping (SchwarzScreening.jl / ScreenedDF.jl:16-77
    analog).  Both (mu,nu) and (nu,mu) of every surviving pair are packed,
    so J needs no off-diagonal doubling and K tiles are symmetric."""

    nbf: int
    npq: int
    pq_flat: np.ndarray   # [npq] int64 flat (mu*nbf+nu) of packed col c
    col_map: np.ndarray   # [nbf*nbf] int64 -> packed col; npq = trash

    @property
    def fill(self) -> float:
        return self.npq / float(self.nbf * self.nbf)


def build_packed_screen(primary, pair_blocks) -> PackedScreen:
    """Packed column map over the basis-function products of the surviving
    (Schwarz/sigma-screened) shell pairs."""
    nbf = primary.nbf
    flats = []
    for b in pair_blocks:
        nca, ncb = b.nbf_block
        ia = b.off_a[:, None, None] + np.arange(nca)[None, :, None]
        ib = b.off_b[:, None, None] + np.arange(ncb)[None, None, :]
        ia = np.broadcast_to(ia, (b.n, nca, ncb)).ravel()
        ib = np.broadcast_to(ib, (b.n, nca, ncb)).ravel()
        flats.append(ia * nbf + ib)
        flats.append(ib * nbf + ia)
    pq_flat = np.unique(np.concatenate(flats)) if flats else np.empty(0, np.int64)
    npq = len(pq_flat)
    col_map = np.full(nbf * nbf, npq, dtype=np.int64)
    col_map[pq_flat] = np.arange(npq, dtype=np.int64)
    return PackedScreen(nbf=nbf, npq=npq, pq_flat=pq_flat, col_map=col_map)


def _b_dtype(opts) -> torch.dtype:
    return torch.float32 if str(opts.df_b_dtype) == "f32" else torch.float64


def fitted_rows(aux, opts) -> int:
    """Rows of the fitted B: the solid-harmonic count when the aux set is
    projected (df_spherical_aux and a d or higher shell), else aux.nbf."""
    if opts.df_spherical_aux and aux_needs_sph(aux):
        return sum(nsph(s.l) for s in aux.shells)
    return aux.nbf


RESIDENT = "resident"
STREAM_B32 = "stream, B32 resident"
STREAM = "stream"

# a stream-mode build's column chunk of P3: these bytes of the card's
# memory (the fraction), or of a CPU run's
STREAM_BUILD_FRACTION = 0.05
STREAM_BUILD_CPU_BYTES = 1.5e9


def stream_build_cols(rows: int, dtype, device) -> int:
    """Packed columns of one chunk of a stream-mode build: the most whose
    [rows, columns] P3 chunk of ``dtype`` fits the build budget, at least
    1024."""
    budget = (STREAM_BUILD_FRACTION
              * torch.cuda.get_device_properties(device).total_memory
              if device.type == "cuda" else STREAM_BUILD_CPU_BYTES)
    size = torch.finfo(dtype).bits // 8
    return max(1024, int(budget / (size * max(rows, 1))))


def build_B_packed(primary, aux, opts, device,
                   timings: Timings | None = None, mode_of=None):
    """Packed B[A, npq+1] with the metric folded in, plus the screen maps.

    Same pipeline as df.build_B (2-center metric -> screening -> 3-center ->
    fold) but the 3-center tensor is written directly into packed columns —
    the dense [A, nbf, nbf] intermediate never exists — in B's dtype
    (``opts.df_b_dtype``), and projected and folded in place: the build
    holds one copy of B.  ``mode_of(rows, width, dtype)``, when given, runs
    before the 3-center build (and before a cached B is loaded) and returns
    the memory mode (default: resident).  In a stream mode B is built into
    host memory (``host_empty``) column chunk by column chunk
    (``stream_build_cols``): K1 into the
    chunk (``three_center_tensor(col_range=)``), then its projection and
    fold (the metric factored once, ``df.fitted_fold``), then the copy out.

    With ``opts.df_b_cache`` (a path prefix), as the JAX package
    (``models/df_screened.py:86-167``): a valid B cache is loaded (onto the
    card, or into host memory in a stream mode) and nothing is built; else
    the unfolded 3-center tensor is checkpointed before the fold overwrites
    it (and resumed from on the next call; a stream-mode build writes and
    reads it chunk by chunk), and dropped once the B cache is written.  The
    caches are the port's own files."""
    timings = timings or Timings()
    dtype = _b_dtype(opts)
    cache = opts.df_b_cache or ""
    fp = cache and _cache_fingerprint(primary, aux, opts)
    mode_of = mode_of or (lambda rows, width, dt: RESIDENT)
    if cache:
        hit = _open_b_cache(cache, fp)
        if hit is not None:
            Bnp, screen = hit
            mode = mode_of(*Bnp.shape, dtype)
            return _cached_b(Bnp, device, mode), screen
    with timings.timed(JCTC.two_center_time):
        metric = eri3c.two_center_metric(aux, device)
    with timings.timed(JCTC.screening_time):
        pair_blocks = screened_pair_blocks(
            primary, opts.df_screening_sigma,
            float(torch.diagonal(metric).max()), device)
        screen = build_packed_screen(primary, pair_blocks)
    width = screen.npq + 1
    mode = mode_of(fitted_rows(aux, opts), width, dtype)
    if mode != RESIDENT:
        B = _stream_build(primary, aux, metric, pair_blocks, screen, opts,
                          device, dtype, timings, cache, fp)
    else:
        # a raw checkpoint resumes this build only when whole
        raw, done = (_open_raw_cache(cache, fp, screen, dtype) if cache
                     else (None, 0))
        if raw is not None and done == width:
            P3 = torch.from_numpy(np.array(raw)).to(device)
            timings.timings.setdefault(JCTC.three_center_time, 0.0)
        else:
            with timings.timed(JCTC.three_center_time):
                P3 = eri3c.three_center_tensor(
                    primary, aux, device, pair_blocks,
                    col_map=screen.col_map, packed_width=width,
                    out_dtype=dtype)
            if cache:
                _save_raw_cache(cache, fp, screen, P3)
        with timings.timed(JCTC.B_time):
            B = df.fitted_metric_and_rows(aux, metric, P3, opts)
            del P3
            B[:, -1] = 0.0
    if cache:
        _save_b_cache(cache, fp, B, screen)
        _drop_raw_cache(cache)
    return B, screen


def _stream_build(primary, aux, metric, pair_blocks, screen, opts, device,
                  dtype, timings: Timings, cache: str,
                  fp: str) -> torch.Tensor:
    """The stream modes' build: B [fitted rows, npq+1] in host memory, one
    column chunk at a time on ``device`` (its 3-center and fold walls
    summed over the chunks, each synchronised; the wall of the host
    allocation as ``B_host_alloc_time``)."""
    npq, A = screen.npq, aux.nbf
    rows = fitted_rows(aux, opts)
    cols = min(stream_build_cols(A, dtype, device), max(npq, 1))
    with timings.timed("B_host_alloc_time"):
        B = host_empty((rows, npq + 1), dtype, device)
        B[:, -1] = 0.0
    # a pinned staging buffer for the chunk's rows: its copy from the card
    # is one contiguous transfer, then a host copy into B's columns
    stage = (host_empty((rows * cols,), dtype, device)
             if device.type == "cuda" else None)
    fold = df.fitted_fold(aux, metric, opts, dtype)
    raw, done = (_open_raw_cache(cache, fp, screen, dtype, "r+")
                 if cache else (None, 0))
    if cache and raw is None:
        raw, done = _raw_writer(cache, fp, screen, (A, npq + 1), dtype), 0
    t3c = tfold = 0.0
    for c0 in range(0, npq, cols):
        c1 = min(c0 + cols, npq)
        t0 = time.perf_counter()
        if c1 <= done:
            P = torch.from_numpy(np.ascontiguousarray(raw[:, c0:c1])).to(
                device)
        else:
            P = eri3c.three_center_tensor(
                primary, aux, device, pair_blocks, col_map=screen.col_map,
                out_dtype=dtype, col_range=(c0, c1))[:, :c1 - c0]
        _sync(device)
        t3c += time.perf_counter() - t0
        if raw is not None and c1 > done:   # the chunk, before its fold
            raw[:, c0:c1] = P.cpu().numpy()
            _raw_progress(cache, fp, screen, raw, c1 if c1 < npq else npq + 1)
        t1 = time.perf_counter()
        Bc = fold(P)
        _to_host(B[:, c0:c1], Bc, stage)
        del P, Bc
        tfold += time.perf_counter() - t1
    timings.record(JCTC.three_center_time, t3c)
    timings.record(JCTC.B_time, tfold)
    return B


def _to_host(dst: torch.Tensor, src: torch.Tensor, stage) -> None:
    """dst (columns of the host B) <- src; from the card through the
    pinned staging buffer."""
    if stage is None:
        dst.copy_(src)
        return
    buf = stage[:src.numel()].view(src.shape)
    buf.copy_(src)
    dst.copy_(buf)


# ---------------------------------------------------------------- host memory


def host_available_bytes() -> int | None:
    """The machine's available memory (``MemAvailable`` of /proc/meminfo),
    or None where that file is absent."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def host_empty(shape, dtype, device) -> torch.Tensor:
    """An uninitialised CPU tensor that a B in host memory lives in.  For a
    card run its pages are locked (``cudaHostRegister``: the pinned
    allocator would round a 37 GB B up to 64 GiB), so that its blocks copy
    to the card asynchronously; they are unlocked when the tensor goes."""
    t = torch.empty(shape, dtype=dtype)
    nbytes = t.numel() * t.element_size()
    if device.type == "cuda" and nbytes:
        cudart = torch.cuda.cudart()
        ptr = t.data_ptr()
        rc = int(cudart.cudaHostRegister(ptr, nbytes, 0))
        if rc != 0:
            raise RuntimeError(f"cudaHostRegister of {nbytes / 1e9:.2f} GB "
                               f"failed: CUDA error {rc}")
        weakref.finalize(t, cudart.cudaHostUnregister, ptr).atexit = False
    return t


# ---------------------------------------------------------------- caches


def _colmap_hash(col_map: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(col_map, dtype=np.int64).tobytes()).hexdigest()


def _cache_fingerprint(primary, aux, opts) -> str:
    """Geometry, basis and build options a cached B depends on: both bases'
    shells (centers, exponents, coefficients), the solid-harmonic
    projection, the screening sigma and B's dtype.  The JAX package's
    fingerprint lacks the sigma (ROADMAP.md C3)."""
    h = hashlib.sha256()
    sph = bool(opts.df_spherical_aux and aux_needs_sph(aux))
    h.update(f"{primary.nbf}|{aux.nbf}|{sph}|{float(opts.df_screening_sigma)!r}"
             f"|{_b_dtype(opts)}".encode())
    for b in (primary, aux):
        for l, cl in sorted(b.classes.items()):
            h.update(f"{l}|{cl.nshell}".encode())
            for a in (cl.centers, cl.exps, cl.coefs):
                h.update(np.ascontiguousarray(a, dtype=np.float64).tobytes())
    return h.hexdigest()


def _note(msg: str) -> None:
    print(f"# build_B_packed: {msg}", file=sys.stderr, flush=True)


def _save_npy(path: str, t: torch.Tensor) -> None:
    """Write t (any device) as .npy, atomically."""
    tmp = path + ".tmp.npy"
    np.save(tmp, t.cpu().numpy())
    os.replace(tmp, path)


def _open_b_cache(prefix: str, fp: str):
    """(the cached B as a read-only memory map, its screen), when the cache
    was written for this system and these options, else None."""
    bp, mp = prefix + "_torch_B.npy", prefix + "_torch_Bmeta.npz"
    if not (os.path.exists(bp) and os.path.exists(mp)):
        return None
    meta = np.load(mp)
    if str(meta["fingerprint"]) != fp:
        _note(f"B cache {bp} was written for another system or options; "
              "rebuilding")
        return None
    screen = PackedScreen(nbf=int(meta["nbf"]), npq=int(meta["npq"]),
                          pq_flat=meta["pq_flat"], col_map=meta["col_map"])
    B = np.load(bp, mmap_mode="r")
    if (B.shape != (int(meta["arows"]), screen.npq + 1)
            or str(meta["colmap_sha"]) != _colmap_hash(screen.col_map)):
        _note(f"B cache {bp} is inconsistent; rebuilding")
        return None
    _note(f"loaded cached B from {bp} ({B.nbytes / 1e9:.2f} GB)")
    return B, screen


def _cached_b(Bnp: np.ndarray, device, mode: str) -> torch.Tensor:
    """The cached B onto the card (resident), or into host memory (a
    stream mode) 1024 rows at a time."""
    if mode == RESIDENT:
        return torch.from_numpy(np.array(Bnp)).to(device)
    B = host_empty(Bnp.shape, torch.float32 if Bnp.dtype == np.float32
                   else torch.float64, device)
    for r in range(0, Bnp.shape[0], 1024):
        B[r:r + 1024] = torch.from_numpy(np.array(Bnp[r:r + 1024]))
    return B


def _save_b_cache(prefix: str, fp: str, B: torch.Tensor, screen) -> None:
    try:
        os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
        _note(f"writing B cache to {prefix}_torch_B.npy")
        _save_npy(prefix + "_torch_B.npy", B)
        np.savez(prefix + "_torch_Bmeta.npz", fingerprint=fp, nbf=screen.nbf,
                 npq=screen.npq, pq_flat=screen.pq_flat,
                 col_map=screen.col_map, arows=B.shape[0],
                 colmap_sha=_colmap_hash(screen.col_map))
    except OSError as exc:
        warnings.warn(f"B cache write failed ({exc}); continuing without",
                      stacklevel=2)


def _open_raw_cache(prefix: str, fp: str, screen, dtype, mode: str = "r"):
    """The unfolded (pre-projection, pre-fold) 3-center checkpoint as a
    memory map (opened with ``mode``) and the count of its leading packed
    columns written so far (all of them, unless a stream-mode build stopped
    part way), when its fingerprint, dtype and screen (a hash of col_map)
    match this build; else (None, 0)."""
    rp, mp = prefix + "_torch_raw.npy", prefix + "_torch_rawmeta.npz"
    if not (os.path.exists(rp) and os.path.exists(mp)):
        return None, 0
    meta = np.load(mp)
    P3 = np.load(rp, mmap_mode=mode)
    want = np.float32 if dtype == torch.float32 else np.float64
    if (str(meta["fingerprint"]) != fp
            or str(meta["colmap_sha"]) != _colmap_hash(screen.col_map)
            or P3.dtype != want or P3.ndim != 2
            or P3.shape[1] != screen.npq + 1):
        _note(f"raw 3c checkpoint {rp} does not match this build; ignoring it")
        return None, 0
    done = int(meta["cols"]) if "cols" in meta else P3.shape[1]
    _note(f"raw 3c checkpoint {rp} ({P3.nbytes / 1e9:.2f} GB) holds {done} "
          f"of {P3.shape[1]} columns; resuming from them")
    return P3, done


def _save_raw_cache(prefix: str, fp: str, screen, P3: torch.Tensor) -> None:
    try:
        os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
        _note(f"checkpointing raw 3c tensor to {prefix}_torch_raw.npy "
              f"({P3.numel() * P3.element_size() / 1e9:.2f} GB)")
        _save_npy(prefix + "_torch_raw.npy", P3)
        _save_raw_meta(prefix, fp, screen, P3.shape[1])
    except OSError as exc:
        warnings.warn(f"raw 3c checkpoint write failed ({exc}); continuing "
                      "without", stacklevel=2)


def _save_raw_meta(prefix: str, fp: str, screen, cols: int) -> None:
    """The raw checkpoint's guard: fingerprint, col_map hash and the count
    of leading columns written (atomically)."""
    tmp = prefix + "_torch_rawmeta.tmp.npz"
    np.savez(tmp, fingerprint=fp, colmap_sha=_colmap_hash(screen.col_map),
             cols=cols)
    os.replace(tmp, prefix + "_torch_rawmeta.npz")


def _raw_writer(prefix: str, fp: str, screen, shape, dtype):
    """A stream-mode build's raw 3c checkpoint, open for its chunks (a
    memory-mapped .npy, zeros where no chunk writes: the trash column, no
    column written yet), or None when it cannot be created."""
    try:
        os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
        _note(f"checkpointing raw 3c tensor to {prefix}_torch_raw.npy chunk "
              "by chunk")
        raw = np.lib.format.open_memmap(
            prefix + "_torch_raw.npy", mode="w+", shape=shape,
            dtype=np.float32 if dtype == torch.float32 else np.float64)
        _save_raw_meta(prefix, fp, screen, 0)
        return raw
    except OSError as exc:
        warnings.warn(f"raw 3c checkpoint write failed ({exc}); continuing "
                      "without", stacklevel=2)
        return None


def _raw_progress(prefix: str, fp: str, screen, raw, cols: int) -> None:
    """Flush the raw checkpoint's chunks and record its first ``cols``
    columns as written."""
    try:
        raw.flush()
        _save_raw_meta(prefix, fp, screen, cols)
    except OSError as exc:
        warnings.warn(f"raw 3c checkpoint write failed ({exc}); continuing "
                      "without", stacklevel=2)


def _drop_raw_cache(prefix: str) -> None:
    for suffix in ("_torch_raw.npy", "_torch_rawmeta.npz"):
        try:
            os.remove(prefix + suffix)
        except OSError:
            pass


# ---------------------------------------------------------------- kernel K2


def k2_slabs(col_map, nbf: int, trash: int) -> tuple[np.ndarray, np.ndarray]:
    """The live m-slabs of K2's n-tiles as a CSR pair (slab_ptr
    [ceil(nbf / TN) + 1], slab_idx), int32, on K2's tile of SM rows of m by
    TN columns of n (``kernels.K2_SLAB_M``, ``kernels.K2_TILE_N``, which
    the kernel is built with): slab s (rows SM s .. SM (s + 1) - 1) is
    listed under n-tile t (columns TN t .. TN (t + 1) - 1), in ascending s,
    when some col_map entry of that tile is not ``trash``.  K2 walks only
    these slabs."""
    sm, tn = kernels.K2_SLAB_M, kernels.K2_TILE_N
    cm = np.asarray(col_map).reshape(nbf, nbf) != trash
    ms, nt = -(-nbf // sm), -(-nbf // tn)
    live = np.zeros((ms * sm, nt * tn), dtype=bool)
    live[:nbf, :nbf] = cm
    tiles = live.reshape(ms, sm, nt, tn).any(axis=(1, 3))
    slab_ptr = np.zeros(nt + 1, dtype=np.int32)
    slab_ptr[1:] = np.cumsum(tiles.sum(axis=0))
    return slab_ptr, np.nonzero(tiles.T)[1].astype(np.int32)


def df_gather_w_plain(Bc, col_map, C) -> torch.Tensor:
    """Plain version of K2: expand the block to a dense [Qc, nbf, nbf] tile
    through col_map (trash column = zeros), in C's dtype, then W = tile · C."""
    nbf = C.shape[0]
    tile = Bc.index_select(1, col_map).reshape(-1, nbf, nbf).to(C.dtype)
    return torch.einsum("qmn,mi->qin", tile, C)


def df_gather_w(Bc, col_map, C, slabs) -> torch.Tensor:
    """Kernel K2: W[q, i, n] = sum_m Bc[q, col_map[m*nbf + n]] C[m, i].

    Bc: [Qc, npq+1] rows of packed B whose trash column npq is zero (the
    DMMA instances gather it for the screened-out entries of a live slab
    and rely on its zeros, as the plain version does; the FP32 instance
    zero-fills those entries and never reads it); col_map: [nbf*nbf] int32;
    C: [nbf, k].  Bc and C both f64 (counted as
    ``df_gather_w``: the DMMA body), both f32 (``df_gather_w_f32``: the
    FP32 FMA body of the mixed-precision phase), or an f32 Bc with an f64 C
    (``df_gather_w_f32b``: the DMMA body for the f64 iterations on an f32
    B).  ``slabs``: ``k2_slabs`` of col_map as int32 tensors on Bc's device,
    the slabs every instance walks (the plain version reads all of col_map).
    Returns [Qc, k, nbf] in C's dtype.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    nbf, k = C.shape
    qc, ldb = Bc.shape
    pair = (Bc.dtype, C.dtype)
    if col_map.dtype != torch.int32 or col_map.shape != (nbf * nbf,) \
            or pair not in _K2_SYMBOLS:
        raise ValueError("df_gather_w: col_map must be int32 [nbf*nbf]; Bc "
                         "and C f64/f64, f32/f32 or f32/f64")
    if not Bc.is_cuda:
        return df_gather_w_plain(Bc, col_map, C)
    if qc > 65535:
        raise ValueError("df_gather_w: blocks of at most 65535 rows")
    slab_ptr, slab_idx = slabs or (None, None)
    if slab_idx is None \
            or slab_ptr.shape != (-(-nbf // kernels.K2_TILE_N) + 1,) \
            or slab_ptr.dtype != torch.int32 or slab_idx.dtype != torch.int32:
        raise ValueError("df_gather_w: slabs must be k2_slabs(col_map) as "
                         "int32 tensors")
    W = torch.empty((qc, k, nbf), dtype=C.dtype, device=Bc.device)
    _check_k2(Bc, col_map, C, slab_ptr, slab_idx)
    kernels.launch(_K2_SYMBOLS[pair], Bc.data_ptr(), ldb, col_map.data_ptr(),
                   slab_ptr.data_ptr(), slab_idx.data_ptr(), C.data_ptr(),
                   nbf, k, qc, W.data_ptr())
    return W


def _check_k2(*ts) -> None:
    for t in ts:
        if t.device != ts[0].device or not t.is_contiguous():
            raise ValueError("df_gather_w: contiguous tensors on one device")


_K2_SYMBOLS = {(torch.float64, torch.float64): "jc_df_gather_w_f64",
               (torch.float32, torch.float32): "jc_df_gather_w_f32",
               (torch.float32, torch.float64): "jc_df_gather_w_f32b"}


class KPassSplit:
    """CUDA-event times of the packed K pass by phase, per sweep: K2's
    launches (``K2``), the W^T W products with the sign scaling and the
    mirror (``WtW``), V_Q = B_Q d with its product V_Q B_Q (``VB``), the
    f32 -> f64 row upcasts (``upcast``) and, on a streamed B, the host ->
    card copies on the side stream (``H2D``), the time the compute stream
    waits for a copy (``wait``) and the f64 -> f32 casts of the streamed
    blocks of the f32 phase (``cast``).  Set as a builder's ``split`` to
    record every sweep on the card; ``ms()`` synchronises and returns, per
    sweep, its compute dtype and the ms of each phase."""

    def __init__(self):
        self.sweeps: list[tuple[str, dict]] = []

    def start(self, dtype) -> None:
        self.sweeps.append((str(dtype).replace("torch.", ""), {}))

    @contextmanager
    def phase(self, name: str):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        yield
        b.record()
        self.sweeps[-1][1].setdefault(name, []).append((a, b))

    def ms(self) -> list[dict]:
        torch.cuda.synchronize()
        return [{"dtype": dt, **{k: sum(a.elapsed_time(b) for a, b in v)
                                 for k, v in ph.items()}}
                for dt, ph in self.sweeps]


def _no_phase(name: str):
    return nullcontext()


# ---------------------------------------------------------------- builder


def _sync(dev) -> None:
    """Wait for the card, so that the phase timings are the device's."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class ScreenedDFFockBuilder(FockBuilder):
    """Packed-B DF Fock builder with Q-blocked exchange and, past the
    card's budget, a host-streamed B (the scale path; replaces
    ScreenedDF.jl + GPUDF.jl's single-rank duties)."""

    # budgets as fractions of the device's memory (the JAX package's fixed
    # 6 GB / 1.5 GB were sized for a 16 GB TPU v5e); a CPU run uses those
    # fixed figures
    B_FRACTION = 0.6
    W_FRACTION = 0.05
    # f64 bytes of one upcast row slice of an f32 B (V = B d, J = V B)
    UPCAST_BYTES = 2.5e8
    # a KPassSplit records the phases of every sweep (None: off)
    split = None

    @classmethod
    def budgets(cls, device) -> tuple[float, float]:
        """(bytes for B, bytes for one Q-block's W) on ``device``."""
        if device.type == "cuda":
            total = torch.cuda.get_device_properties(device).total_memory
            return cls.B_FRACTION * total, cls.W_FRACTION * total
        return 6.0e9, 1.5e9

    @classmethod
    def memory_mode(cls, rows: int, width: int, dtype, opts, nbf: int,
                    nocc: int, device) -> str:
        """Where B [rows, width] of ``dtype`` lives, from its bytes against
        the B budget (``budgets``): ``RESIDENT`` when B, with the f32 copy
        that an f64 B keeps for the mixed-precision phase, fits;
        ``STREAM_B32`` when it does not but that copy and two Q-block
        buffers (``block_rows`` for ``nocc``) do; else ``STREAM``.  Without
        the mixed-precision phase, or for an f32 B, B alone is weighed.  A
        streamed B over the machine's available memory raises MemoryError,
        naming both sizes."""
        size = torch.finfo(dtype).bits // 8
        b_bytes = rows * width * size
        b32 = rows * width * 4 if opts.mixed_precision and size == 8 else 0
        budget = cls.budgets(device)[0]
        if b_bytes + b32 <= budget:
            return RESIDENT
        n_blocks = int(opts.df_exchange_n_blocks or 0)
        qc = (min(-(-rows // n_blocks), rows, 65535) if n_blocks > 0
              else cls.block_rows(nbf, nocc, rows, device))
        mode = (STREAM_B32 if b32 and b32 + 2 * qc * width * size <= budget
                else STREAM)
        avail = host_available_bytes()
        if avail is not None and b_bytes > avail:
            raise MemoryError(
                f"packed B [{rows}, {width}] {str(dtype)[6:]} needs "
                f"{b_bytes / 1e9:.1f} GB of host memory to stream from (over "
                f"the {budget / 1e9:.1f} GB device budget), and the machine "
                f"has {avail / 1e9:.1f} GB available")
        return mode

    def __init__(self, B: torch.Tensor, screen: PackedScreen, opts,
                 nocc: int, mode: str = RESIDENT, device=None):
        """B on ``device`` (default: B's), or, in a stream mode, in host
        memory for a run on ``device``."""
        self.device = device = torch.device(device) if device else B.device
        self.nbf = nbf = screen.nbf
        self.mixed = bool(opts.mixed_precision)
        self.mode = mode
        self.screen = screen
        self.A = A = B.shape[0]
        self.B = B
        self.supports_f32_phase = self.mixed
        self.upcast_rows = max(1, int(self.UPCAST_BYTES / (8 * B.shape[1])))

        n_blocks = int(opts.df_exchange_n_blocks or 0)
        self._fixed_chunk = -(-A // n_blocks) if n_blocks > 0 else None
        self.q_chunk = self.chunk_for(nocc)
        # upper block triangle of K = W^T W pays once that gemm dominates
        # (ScreenedDF.jl:459-641's K_block_width analog)
        self.k_blocks = 4 if nbf >= 1024 else 1
        if screen.npq >= 2**31:
            raise ValueError("packed width exceeds the int32 col_map")
        self._col_map = torch.as_tensor(screen.col_map, device=device).to(torch.int32)
        self._slabs = tuple(torch.as_tensor(a, device=device) for a in
                            k2_slabs(screen.col_map, nbf, screen.npq))
        self._pq_flat = torch.as_tensor(screen.pq_flat, device=device)
        # the stream's two device buffers (sized for the largest block of
        # the run), its side stream and the events that free each buffer
        self._bufs = None
        self._free = [torch.cuda.Event() for _ in range(2)] \
            if device.type == "cuda" else None
        self._copies = torch.cuda.Stream(device) \
            if device.type == "cuda" and mode != RESIDENT else None
        # an f32 B is its own f32 copy; in STREAM_B32 the copy is made on
        # the card from the uploaded blocks, never from a device-resident B
        if B.dtype == torch.float32:
            self.B32 = B if mode == RESIDENT else None
        elif mode == RESIDENT:
            self.B32 = B.float() if self.mixed else None
        elif mode == STREAM_B32:
            self.B32 = torch.empty(B.shape, dtype=torch.float32,
                                   device=device)
            for q, blk in self._stream(self.q_chunk, torch.float32,
                                       timed=False):
                self.B32[q:q + blk.shape[0]] = blk
        else:
            self.B32 = None

    @classmethod
    def build(cls, primary, auxiliary, opts, device,
              timings: Timings | None = None) -> "ScreenedDFFockBuilder":
        timings = timings or Timings()
        device = torch.device(device)
        nocc = primary.nels // 2
        modes = []

        def mode_of(rows, width, dtype):
            modes.append(cls.memory_mode(rows, width, dtype, opts,
                                         primary.nbf, nocc, device))
            return modes[-1]

        B, screen = build_B_packed(primary, auxiliary, opts, device, timings,
                                   mode_of=mode_of)
        # the device-side tables and, in STREAM_B32, B32 from the host B
        with timings.timed("builder_init_time"):
            builder = cls(B, screen, opts, nocc, modes[-1], device)
            _sync(device)
        nt = timings.non_timing_data
        nt["B_shape"] = str(list(B.shape))
        nt["B_bytes"] = str(B.numel() * B.element_size())
        nt["B_mode"] = modes[-1]
        return builder

    @classmethod
    def block_rows(cls, nbf: int, k: int, rows: int, device) -> int:
        """Rows of a Q-block of B's ``rows`` on ``device`` when
        ``df_exchange_n_blocks`` is unset: the most whose W [Qc, k, nbf] for
        a factor of k columns fits the W budget (the CPU's plain K2 also
        expands the [Qc, nbf, nbf] tile), at least 64, at most K2's 65535."""
        per_q = nbf * (max(k, 1) if device.type == "cuda" else nbf)
        q = max(64, int(cls.budgets(device)[1] / (8 * per_q)))
        return min(q, rows, 65535)

    def chunk_for(self, k: int) -> int:
        """Rows of a Q-block: ``df_exchange_n_blocks`` when set, else
        ``block_rows`` for a factor of k columns; the SAD iteration's signed
        factor has up to nbf columns, not nocc."""
        if self._fixed_chunk is not None:
            return min(self._fixed_chunk, self.A, 65535)
        return self.block_rows(self.nbf, k, self.A, self.device)

    def q_blocks(self, src, k: int | None = None) -> list[torch.Tensor]:
        """The Q-blocks of a device-resident B (f64 or its f32 copy), as
        views, sized for a factor of k columns (default: the occupied
        count)."""
        qc = self.q_chunk if k is None else self.chunk_for(k)
        return [src[q:q + qc] for q in range(0, self.A, qc)]

    def blocks(self, dtype, k: int):
        """The Q-blocks a sweep in ``dtype`` reads, sized for a factor of k
        columns (``chunk_for``): views of the resident B or B32, else the
        host B's blocks streamed to the card (``_stream``), cast to f32 on
        the card for the f32 phase of an f64 B."""
        if dtype == torch.float32 and self.B32 is not None:
            return self.q_blocks(self.B32, k)
        if self.mode == RESIDENT:
            return self.q_blocks(self.B, k)
        cast = torch.float32 if (dtype == torch.float32
                                 and self.B.dtype == torch.float64) else None
        return (blk for _, blk in self._stream(self.chunk_for(k), cast))

    def _stream(self, qc: int, cast=None, timed: bool = True):
        """Yield (first row, block) for the host B's Q-blocks of qc rows.
        On the card each block is copied into one of two device buffers on
        the side stream (``non_blocking`` from page-locked memory) while the
        compute stream works on the other; the compute stream waits for a
        block's copy (a CUDA event) before it is yielded, and the copy into
        a buffer waits for the compute that read it last.  ``cast``
        converts each block on the card; ``timed`` records the copies, the
        waits and the casts in the builder's ``split``.  On the CPU the
        blocks are views of B."""
        A, src = self.A, self.B
        starts = list(range(0, A, qc))
        if self.device.type != "cuda":
            for q in starts:
                blk = src[q:q + qc]
                yield q, (blk if cast is None else blk.to(cast))
            return
        phase = (self.split.phase if timed and self.split is not None
                 else _no_phase)
        bufs = self._buffers(qc)
        side, cur = self._copies, torch.cuda.current_stream(self.device)

        def issue(i):
            q, b = starts[i], bufs[i % 2]
            n = min(qc, A - q)
            ready = torch.cuda.Event()
            with torch.cuda.stream(side):
                side.wait_event(self._free[i % 2])
                with phase("H2D"):
                    b[:n].copy_(src[q:q + n], non_blocking=True)
                ready.record(side)
            return q, b[:n], ready

        pending = issue(0)
        for i in range(len(starts)):
            q, blk, ready = pending
            if i + 1 < len(starts):
                pending = issue(i + 1)
            with phase("wait"):
                cur.wait_event(ready)
            if cast is not None:
                with phase("cast"):
                    blk = blk.to(cast)
            yield q, blk
            self._free[i % 2].record(cur)

    def _buffers(self, qc: int):
        """The two device buffers of the stream, at least qc rows each."""
        if self._bufs is None or self._bufs[0].shape[0] < qc:
            if self._bufs is not None:
                _sync(self.device)
                self._bufs = None
            self._bufs = [torch.empty((qc, self.B.shape[1]), dtype=self.B.dtype,
                                      device=self.device) for _ in range(2)]
        return self._bufs

    def _rows_as(self, blk, dtype, phase=_no_phase):
        """The block itself in its own dtype, else its row slices converted
        one at a time (the f64 iterations on an f32 B)."""
        if blk.dtype == dtype:
            yield blk
            return
        for r in range(0, blk.shape[0], self.upcast_rows):
            with phase("upcast"):
                sub = blk[r:r + self.upcast_rows].to(dtype)
            yield sub

    def sweep(self, blocks, d, Cs, s):
        """One pass over the Q-blocks for one factor: ``sweep_factors``
        with [(Cs, s)]; returns (K, Jp)."""
        (K,), Jp = self.sweep_factors(blocks, d, [(Cs, s)])
        return K, Jp

    def sweep_factors(self, blocks, d, factors):
        """One pass over the Q-blocks: for each (Cs, s) of ``factors``, K =
        sum_Q (W s)^T W of the density factored by (Cs, s) (W from K2; s
        None for orbitals; the upper block triangle, mirrored, when k_blocks
        > 1), and, when the packed density d is given, the packed Coulomb
        vector Jp = sum_Q (B_Q d) B_Q, both products from one read of each
        row slice (one f64 upcast of each slice of an f32 block, as the JAX
        package's _jk_chunk_fused).  Each block serves every factor while
        it is on the card (UHF/ROHF: K(Da) and K(Db) from one read of a
        streamed B); each K sums the blocks in their order.  The factors
        set the compute dtype (an f32 B's blocks are read through f64
        products in the f64 iterations; d comes in that dtype).  Returns
        ([K [nbf, nbf] per factor], Jp or None) in that dtype."""
        nbf = self.nbf
        fdt, dev = factors[0][0].dtype, factors[0][0].device
        nb = self.k_blocks
        kb = -(-nbf // nb)
        cuts = [slice(i * kb, min((i + 1) * kb, nbf)) for i in range(nb)]
        phase = _no_phase
        if self.split is not None:
            self.split.start(fdt)
            phase = self.split.phase
        Jp = None if d is None else torch.zeros(self.screen.npq + 1,
                                                dtype=fdt, device=dev)
        Ks = [torch.zeros((nbf, nbf), dtype=fdt, device=dev) for _ in factors]
        for blk in blocks:
            if Jp is not None:
                for sub in self._rows_as(blk, fdt, phase):
                    with phase("VB"):
                        Jp += (sub @ d) @ sub
            for (Cs, s), K in zip(factors, Ks):
                if Cs.shape[1] == 0:   # an empty spin channel
                    continue
                with phase("K2"):
                    W = df_gather_w(blk, self._col_map, Cs, self._slabs)
                with phase("WtW"):
                    Wm = W.reshape(-1, nbf)
                    Ws = (Wm if s is None
                          else (W * s[None, :, None]).reshape(-1, nbf))
                    # the upper block triangle of column blocks (all of K
                    # when nb is 1), on strided column views of W: no
                    # padded copies
                    for I in range(nb):
                        for J in range(I, nb):
                            K[cuts[I], cuts[J]] += (Ws[:, cuts[I]].T
                                                    @ Wm[:, cuts[J]])
        if nb > 1:
            with phase("WtW"):
                # mirror the upper block triangle (diagonal blocks once)
                idx = torch.arange(nbf, device=dev) // kb
                bd = idx[:, None] == idx[None, :]
                Ks = [K + K.T - torch.where(bd, K, 0.0) for K in Ks]
        return Ks, Jp

    def scatter_j(self, Jp) -> torch.Tensor:
        """The dense f64 J [nbf, nbf] of the packed Coulomb vector."""
        nbf = self.nbf
        J = torch.zeros(nbf * nbf, dtype=torch.float64, device=Jp.device)
        J[self._pq_flat] = Jp[:-1].double()
        return J.reshape(nbf, nbf)

    def two_electron_fock(self, D, iteration, timings: Timings, C_occ=None,
                          precision: str = "f64"):
        use_f32 = precision == "f32" and self.supports_f32_phase
        fdt = torch.float32 if use_f32 else torch.float64
        dev = D.device
        d = torch.cat([D.reshape(-1)[self._pq_flat],
                       D.new_zeros(1)]).to(fdt)
        if C_occ is None:
            Cs, s = signed_factor(D)
            Cs, s = Cs.to(fdt).contiguous(), s.to(fdt)
        else:
            Cs, s = C_occ.to(fdt).contiguous(), None
        with timings.timed(JCTC.K_time, iteration):
            K, Jp = self.sweep(self.blocks(fdt, Cs.shape[1]), d, Cs, s)
            _sync(dev)
        with timings.timed(JCTC.J_time, iteration):
            G = self.scatter_j(Jp) - K.double()
            _sync(dev)
        return G

    def finalize(self):
        _sync(self.device)
        self.B = None
        self.B32 = None
        self._bufs = None
