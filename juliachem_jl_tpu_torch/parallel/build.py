"""Sharded (multi-device) packed-B construction.

Port of ``juliachem_jl_tpu/parallel/build.py``.  The reference distributes
the 3-center + B work and memory across ranks x GPUs with a static
auxiliary partition (GPUDF.jl:828-1008, DynamicLoad.jl:160-203).  Each rank
owns a contiguous block of auxiliary *shells*, hence a contiguous block of
B's Q rows, and builds the 3-center rows of that block itself, on its own
device, through kernel K1 with the shared ``col_map`` (the JAX package
builds every block on the host and then places it).  The solid-harmonic row
projection is block-diagonal per aux shell, so each rank projects its own
rows in place.  The metric fold couples rows; it never holds all of B on
one rank: per column chunk one ``all_gather`` brings every rank the chunk's
rows, each rank folds the chunk as one device does and keeps its own rows
(``fold_sharded``).
"""

from __future__ import annotations

import copy
import warnings

import numpy as np
import torch

from ..basis.spherical import aux_needs_sph, cart_to_sph_basis, nsph
from ..basis.structs import Basis, compile_basis, ncart
from ..models import linalg
from ..ops import eri3c
from ..ops.eri import as_f64
from ..utils.timings import JCTC, Timings
from .mesh import Mesh


def subset_basis(basis: Basis, shell_range: range) -> Basis:
    """A standalone Basis over a contiguous shell subset (local offsets)."""
    shells = [copy.copy(basis.shells[i]) for i in shell_range]
    return compile_basis(shells, nels=0, name=f"{basis.name}[{shell_range.start}:{shell_range.stop}]")


def partition_aux_shells(aux: Basis, ndev: int) -> list[tuple[int, int]]:
    """Contiguous aux-shell ranges with ~balanced function counts
    (static_load_rank_indicies analog, DynamicLoad.jl:160-203)."""
    nbf_cum = np.cumsum(aux.shell_nbf)
    bounds = [0]
    for g in range(1, ndev):
        target = g * aux.nbf / ndev
        i = int(np.searchsorted(nbf_cum, target))
        bounds.append(max(i, bounds[-1]))
    bounds.append(aux.nshell)
    return [(bounds[i], bounds[i + 1]) for i in range(ndev)]


def fitted_row_ranges(aux: Basis, parts, sph: bool) -> list[tuple[int, int]]:
    """Each rank's rows [r0, r1) of the fitted B: its shells' solid-harmonic
    counts when the aux set is projected, else their Cartesian counts."""
    size = [nsph(s.l) if sph else ncart(s.l) for s in aux.shells]
    out, r = [], 0
    for s0, s1 in parts:
        n = sum(size[s0:s1])
        out.append((r, r + n))
        r += n
    return out


def fold_sharded(mesh: Mesh, metric: torch.Tensor, P3: torch.Tensor,
                 ranges: list[tuple[int, int]],
                 lindep_thresh: float = 1e-10) -> torch.Tensor:
    """In place, this rank's rows of f(J) P3 (``linalg.fold_metric`` over
    the whole B, conditioning-aware f), where P3 holds this rank's rows
    ``ranges[rank]`` of the projected 3-center tensor.  Per column chunk,
    one ``all_gather`` assembles the chunk's rows from every rank and each
    rank folds the whole chunk as one device does (the triangular solve, or
    the product with the pseudo-inverse square root) and keeps its rows:
    every rank's rows are the single-device B's, whatever the metric's
    condition (a sum of per-rank partial products would round in another
    order, which a singular metric amplifies).  No rank holds more of B
    than one column chunk of all rows."""
    L, info = torch.linalg.cholesky_ex(metric)
    M = None
    if int(info) != 0 or float((torch.diagonal(L).min()
                                / torch.diagonal(L).max()) ** 2) \
            < linalg._METRIC_DIAG_RATIO2:
        w, V = torch.linalg.eigh(metric)
        keep = w >= lindep_thresh * w[-1]
        warnings.warn(
            f"DF metric numerically singular (min eig {float(w[0]):.2e}, max "
            f"{float(w[-1]):.2e}); folding with pseudo-inverse sqrt, dropping "
            f"{int((~keep).sum())}/{len(w)} auxiliary directions",
            stacklevel=2)
        Vk = V[:, keep]
        M = (Vk / torch.sqrt(w[keep])[None, :]) @ Vk.T
    r0, r1 = ranges[mesh.rank]
    A, n_own = metric.shape[0], max(b - a for a, b in ranges)
    for cs in linalg._chunks(A, P3.shape[1]):
        mine = P3.new_zeros((n_own, cs.stop - cs.start))
        mine[:r1 - r0] = P3[:, cs]
        got = mesh.all_gather(mine)
        X = torch.cat([got[k * n_own:k * n_own + b - a]
                       for k, (a, b) in enumerate(ranges)])
        del got, mine
        P3[:, cs] = (torch.linalg.solve_triangular(L, X, upper=False)[r0:r1]
                     if M is None else M[r0:r1] @ X)
    return P3


def build_B_packed_sharded(primary: Basis, aux: Basis, mesh: Mesh, opts,
                           timings: Timings | None = None,
                           tile_budget: float = 1.5e9, check_budget=None):
    """This rank's rows of the packed B, built, projected and folded as
    above, then zero-padded to n_chunks x q_chunk rows (the same count on
    every rank, as the JAX package's A_pad / ndev; fewer than n_chunks of
    them padding).  ``check_budget(rows,
    width)``, when given, runs before the 3-center build.

    Returns (B_own [n_chunks * q_chunk, npq+1] f64 on mesh.device, screen,
    A_pad, q_chunk, n_chunks, row_ranges), where row_ranges[r] is rank r's
    [r0, r1) in the single-device packed B."""
    from ..models.df import screened_pair_blocks
    from ..models.df_screened import build_packed_screen

    timings = timings or Timings()
    dev = mesh.device
    with timings.timed(JCTC.two_center_time):
        metric = eri3c.two_center_metric(aux, dev)
    with timings.timed(JCTC.screening_time):
        pair_blocks = screened_pair_blocks(
            primary, opts.df_screening_sigma,
            float(torch.diagonal(metric).max()), dev)
        screen = build_packed_screen(primary, pair_blocks)
    width = screen.npq + 1
    parts = partition_aux_shells(aux, mesh.world)
    sph = bool(opts.df_spherical_aux and aux_needs_sph(aux))
    ranges = fitted_row_ranges(aux, parts, sph)
    # the JAX package's chunk count (a chunk's dense tile within
    # tile_budget), with the chunk trimmed so the padding stays below
    # n_chunks rows (its full-size chunks padded w32's ranks by 9 %)
    A_l0 = max(r1 - r0 for r0, r1 in ranges)
    nbf = primary.nbf
    n_chunks = -(-A_l0 // max(16, min(A_l0, int(tile_budget
                                                  / (8 * nbf * nbf)))))
    qc = -(-A_l0 // n_chunks)
    rows = n_chunks * qc
    if check_budget is not None:
        check_budget(rows, width)
    s0, s1 = parts[mesh.rank]
    sub = subset_basis(aux, range(s0, s1)) if s1 > s0 else None
    with timings.timed(JCTC.three_center_time):
        P3 = (eri3c.three_center_tensor(primary, sub, dev, pair_blocks,
                                        col_map=screen.col_map,
                                        packed_width=width)
              if sub is not None else
              torch.zeros((0, width), dtype=torch.float64, device=dev))
    with timings.timed(JCTC.B_time):
        if sph:
            from ..basis.spherical import project_rows_sph_

            T = as_f64(cart_to_sph_basis(aux), dev)
            metric = T.T @ metric @ T
            if sub is not None:
                P3 = project_rows_sph_(sub, P3)
        B = fold_sharded(mesh, metric, P3, ranges)
        B[:, -1] = 0.0
    if rows != B.shape[0]:
        out = torch.zeros((rows, width), dtype=B.dtype, device=dev)
        out[:B.shape[0]] = B
        del B, P3
        B = out
    return B, screen, mesh.world * rows, qc, n_chunks, ranges
