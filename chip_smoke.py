#!/usr/bin/env python3
"""Smoke run of the PyTorch port (juliachem_jl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out result.json]

Phases, each printing its lines (every measured number tagged with the
card's name and power limit):

1. device: card name, ``nvidia-smi`` name and power limit, torch's CUDA
   version, ``nvcc --version``;
2. build the CUDA kernels of juliachem_jl_tpu_torch/csrc with nvcc (one
   process per source, in parallel); 2a. ``cuobjdump -sass`` of the built
   library: every f64 tensor-core instance of K2 and K7 holds DMMA
   instructions, K2's f32 instance FFMA and no tensor-core instruction
   (no TF32), each K9 instance DFMA and SHFL; ptxas's registers, stack
   and spills of every K4/K5/K6, K1 and K9 instance, and the build wall
   of K1's sources;
3. each kernel against its plain torch version on the card, times from CUDA
   events beside the least time the card could take (``bound_ms``):
   K1 (3-center integrals, every class of benzene_2_water / cc-pVTZ-JKFIT,
   and of w32 and of benzene_2_water in 6-31G(2df,p) (the other bases the
   DF paths run), a subset of bra pairs, each class on the route of the table of
   ops/kernels.py as compiled, a block-route class within a block's
   shared memory and two blocks an SM; the primitive products K1 walks
   in the full 3-center builds of benzene_2_water and w32 equal to those
   of nonzero coefficients), K2 (packed-B exchange factor: the f64
   instance and the FP32 FMA instance of the mixed-precision phase, beside
   the f64 instance's time and the replaced f32 body's recorded one; also
   at w32's Q-block, whose col_map has whole dead tiles, and in phase 13
   at w64's), the
   probe K3 (device Boys function), K9 (S, T and V, the nuclear sum in
   the kernel: every class of benzene_2_water in its DF basis, in
   6-311++G(3df,3pd) and in the g basis, each class's elements within
   1e-12 x max |M| of ``overlap_kinetic_nuclear_plain``; phase 3s), and
   at the class shapes of
   ammonia_trimer and benzene_2_water (6-311++G(2d,2p)), the first quartets
   of every class pair of the Schwarz staircase: K4 (4-center integrals),
   K6 (digestion of cached blocks), K5 in list and in staircase mode (the
   integrals digested at once); K1's f32 store (bit for bit the f64 output
   rounded), K2's f32-B instance (bit for bit K2 f64 on the upcast block),
   and K8 (the split fold) at the fold shapes of the first 8 waters of the
   w32 cluster and of w32 itself against its plain version, two cuBLAS
   SGEMMs and the f64 fold; then the f classes at benzene_2_water's shapes
   in 6-311++G(3df,3pd) / cc-pVTZ-JKFIT: K1 (f64 and the f32 store) on
   every (bra | aux) class and K4, K6, K5 list and staircase on the first
   quartets of every class pair, with (ff|g) and (ff|ff) also timed alone;
   K4/K5's bound also split by pipe (Boys + R on the scalar FP64 pipe,
   the products), and K5's launch geometry of every class pair (its lane
   or warp route as compiled, held to the table of ops/kernels.py; ket
   tiles; warps an SM: a tiled class pair, (ff|ff) among them, must hold
   two); then the g classes the same way at benzene_2_water's shapes in
   6-311++G(3df,3pd)+G (its GAMESS-US file through ``model.basis_file``):
   K1 on every g bra (sg) .. (gg) against lq 0..4, (gg|g) alone too, and
   K4, K6, K5 list and staircase on the first 1024 quartets of every class
   pair with a g shell, (gg|gg) alone too (bra and ket tiles), with the g
   instances' routes, registers and spills;
4. ammonia_trimer DF-RHF through run_spec (dense-B route);
5. benzene_2_water DF-RHF through run_spec (packed route); the same on an
   f32 B (``df_b_dtype: f32``), held to the JAX package's f32-B energy, and
   with ``JCHEM_SPLIT_FOLD=1`` (K8), recorded only: the split fold does not
   converge there, in either package; the first 8 waters of the w32 cluster
   with f64 B, f32 B (each held to the JAX package's) and the split fold
   (held to the f64 fold within the DF gate); then K7 (the
   fused MP2 pair energy, modes rmp2, ss, os) against its plain version at
   its full width; RI-MP2 with SCS on those orbitals (E2 and its
   opposite-spin part held to the JAX package's and to the plain
   version's); the radical cation (charge 1,
   doublet) through run_spec with method UHF (packed ScreenedDFJKBuilder)
   and RI-UMP2, and the vertical ionisation energy at the HF and MP2 level;
6. ammonia_trimer conventional RHF through run_spec (in-core
   ScreenedDirectFock: K4 fills, K6 digests); its cation by conventional UHF
   and ROHF (in-core) and DF-UHF (dense B); then at the converged RHF
   density and the cation's UHF (Da, Db) one build through the direct
   ScreenedDirectFock (K5 list mode) and one through StreamingDirectFock (K5
   staircase mode), G and J, K(Da), K(Db) each held to the in-core ones,
   and K6's time a build at the full in-core size (5.83e6 blocks), class
   pair by class pair, summed by route, beside its bound, the cached
   build's wall and the SCF's Fock s/iter (``incore_k6_times``,
   ``k6_by_route``);
   the identities closed-shell UHF = RHF and RI-UMP2 = RI-MP2; the
   incremental Fock (``fdiff``) conventional and on dense DF with f32
   increments, each held to its full-build run within 1e-8 Eh;
7. benzene_2_water conventional RHF through run_spec with the DF guess (DF
   iterations on the packed builder, then StreamingDirectFock), with
   ``damp: false`` (ROADMAP.md C8); then one build at its converged D
   class pair by class pair, each launch timed alone with its bound and
   its route as compiled: every class pair of L <= 3 that the path
   launched must be on K5's lane route;
8. the large-system chain on the generated 32-water cluster (6-31+G* /
   cc-pVTZ-JKFIT, nbf 736): f64 B (with K9 held to its plain version at
   w32's 96 nuclei, every element within 1e-12 x max |M|, its time over
   w32's classes beside its bound, and the dipole integrals' wall); f32 B with the B,
   raw-3c and one-electron caches and checkpoints (within 3e-4 Eh of
   f64, half the B bytes, at most half the build's peak memory); again
   from those caches and the checkpoint (no 3-center build, the same B,
   at most 2 iterations, within 1e-9 Eh), in a temporary directory
   removed after;
   the split fold (K8) on the f32 B, recorded beside the f64 fold, not
   gated: at this size it lies outside the DF gate;
9. the sharded programs (``num_devices``), as process groups of ranks
   that share the card through gloo (``parallel.launch.spawn``), at 2 and
   4 ranks: (a) ``benzene_2_water`` DF-RHF, (b) its cation DF-UHF, (c)
   RI-MP2 on (a)'s orbitals, (d) ``ammonia_trimer`` conventional through
   the quartet-sharded direct builder, (e) one sharded staircase build of
   ``benzene_2_water`` at its converged D, (g) the packed builds at that D
   timed (f64, f32 phase, per-phase form, spin-resolved JK), (h) the dense
   q x k step of ``ammonia_trimer``, and at 2 ranks (f) w32 on an f64 B
   (each rank's B at most 0.55 of the whole); every energy, G and E2 held
   to the single-device run of this card, the launches per rank printed;
   then NCCL at world 1 (the sharded DF and staircase builders built
   directly, held to one device's G) and NCCL across cards where more
   than one is visible.  K5's start offset t0 and K7's occupied range are
   held to their whole-range launches and plain versions in phase 3;
10. the f bases (pair classes to (ff|ff), aux shells to g): benzene_2_water
   DF-RHF (packed B) in 6-311++G(3df,3pd) (nbf 851) and in 6-31G(2df,p)
   (nbf 515); ammonia_trimer in 6-31G(2df,p) conventional (in-core), then
   at its density one direct (K5 list) and one streaming (K5 staircase)
   build held to the in-core one, and K6's time a build there (1.21e6
   blocks); the first 2 waters of w32 in
   6-31G(2df,p) conventional; the SCF energies held to the JAX package's,
   and each of K1, K4, K5 (both modes) and K6 shown to have launched an f
   class on its path (K4's (ff|ff) on the SAD atoms);
11. the g basis 6-311++G(3df,3pd)+G (pair classes to (gg|gg)) through
   ``model.basis_file``: benzene_2_water DF-RHF (packed B, nbf 1046),
   below the 3df energy and held to the JAX package's where one is
   recorded; ethene_ethyne_2 DF-RHF (dense B, nbf 512) held to the JAX
   package's energy; the first 2 waters of w32 conventional in-core (nbf 196),
   held to the JAX package's energy, then at its density one direct (K5
   list) and one streaming (K5 staircase) build held to the in-core one,
   and K6's time a build there; each of K1, K4, K5 (both modes) and K6
   shown to have launched a g class on its path (K4's (gg|gg) launches
   on the SAD atoms counted);
12. the spherical-harmonic AO basis and the nuclear derivatives:
   benzene_2_water DF-RHF in the spherical basis (nbf 517 -> 491, packed
   B; not below the Cartesian energy) and its analytic DF gradient (K1's
   dense (A|pq), the fit, K10 for the one-electron part and K11 for the
   3-center and metric derivatives), translationally invariant and held to
   central differences of the card's own energy; K10 and K11's two
   instances held to their plain versions on the card there and at the DF
   gradient of the first 8 waters of w32 (each per-atom component within
   1e-10 x max |g|), timed beside their bounds and the plain versions; the
   DF-RHF gradient of w32 (6-31+G* / cc-pVTZ-JKFIT, 96 atoms) with its
   parts beside their bounds, its peak device memory
   below the card's, translationally invariant, and held to central
   differences on one O z and one H x within 1e-6 Eh/bohr; the first 2
   waters of w32 in
   cc-pVDZ spherical: conventional RHF gradients through the in-core,
   direct and streaming builders, the cation's UHF, ROHF and DF-UHF
   gradients, each held to the JAX package's recorded gradient within
   1e-7 Eh/bohr, and RI-MP2 on the RHF orbitals to its E2 within 1e-8 Eh;
   one water DF-RHF spherical through run_file with the drivers gradient,
   optimize (from a stretched O-H) and frequencies, held to the JAX
   package's recorded gradient, optimized energy and geometry, and
   frequencies.  Each gradient's parts are timed beside their bounds;
13. the host-streamed B (``models/df_screened.py``'s memory modes): (a)
   the machine's MemTotal and MemAvailable and the page-locked host ->
   card bandwidth of one 2 GB copy; (b) w32 streamed with B32 resident
   (ScreenedDFFockBuilder's B_FRACTION and W_FRACTION set here so that the
   f64 B streams in Q-blocks of about a tenth of its rows), with the B
   cache, within 1e-9 Eh of phase 8's f64 B, and G at phase 8's converged
   D within 1e-12 x max|G| of the resident builder's on the same blocks,
   each build's wall beside max(B bytes / that bandwidth, the resident
   build); (c) w32 from (b)'s B cache (no 3-center build, the same B
   checksum); (d) w32 with nothing resident (the f32 phase on streamed
   blocks cast on the card), within 1e-9 Eh of (b); (e) w64 at the
   defaults (f64 B, mixed precision; K9 held to its plain version, its
   time over w64's classes and the dipole integrals' wall as at w32), which must choose the stream with
   B32 resident on its own, its build's device peak below B's bytes; (f)
   w64 resident on an f64 B without the mixed-precision phase, within
   1e-8 Eh of (e), whose f64 build time (e)'s is printed beside; (g) the
   benzene_2_water cation's J, K(Da), K(Db) on a streamed B within 1e-12
   relative of the resident builder's, K2 launched twice a block.

The packed K pass of the w-cluster runs and of one ``benzene_2_water``
build at its converged D is split by phase with CUDA events (K2, W^T W,
V B, the f32 -> f64 row upcasts; ``KPassSplit``).  K1's launches in the
metric and 3-center builds of the ``benzene_2_water`` DF run and of the
w32 f64-B and f32-B runs are timed by class with CUDA events beside
their bounds, and their sum taken as K1's share of each build's
synchronised wall (``K1Times``).

Each path runs with the launch counts set to 0 just before it and read just
after (each launch is also counted per angular-momentum class).  Energies
are held to the JAX package's recorded DF, f32-B, MP2, f-basis and
g-basis energies (juliachem_jl_tpu_torch/data/smoke_reference.json, 1e-6 Eh) and to GAMESS
(tests/data/s22x3_gamess_goldens.json: DF within 1.5e-3 Eh, conventional
within 1.49e-8 relative).  The second-to-last line is ``{"kernels": [...]}``;
the last is ``{"ok": true, "device": ...}``.  Any failed check exits
nonzero without that last line; so does a machine without CUDA or a
directory without the package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BOHR = 0.52917724924
SCF = {"scf_type": "df", "niter": 60, "dele": 1e-9, "rmsd": 1e-7,
       "guess": "sad"}
PROPS = {"mo energies": True, "mulliken": True, "multipole": "dipole"}
CONV_SCF = {"scf_type": "rhf", "niter": 60, "dele": 1e-9, "rmsd": 1e-7}
E_REF_TOL = 1e-6       # vs the JAX package's energy (CPU, f64)
E_GAMESS_TOL = 1.5e-3  # DF vs conventional GAMESS
E_GAMESS_REL = 1.49e-8  # conventional vs GAMESS (tests/test_s22x3.py:61)
E2_PLAIN_TOL = 1e-9    # K7 vs its plain version on the card (Eh)
E_DF_UHF_TOL = 1.5e-3  # DF-UHF vs conventional UHF (tests/test_uhf.py:95)
# the cation's DF-UHF held to one device (phase 9): its energy drifts along
# a flat direction by ~1e-8 Eh an iteration near dele 1e-9 (ROADMAP.md C9:
# 121-133 iterations), so two runs that round differently stop up to
# 1.4e-7 Eh apart at the smoke's convergence (4 gloo ranks against one
# device, on an H100); converged to dele 1e-11 the drift left is ~1e-10 Eh
CATION_TIGHT = {**SCF, "mixed_precision": False, "niter": 300,
                "dele": 1e-11, "rmsd": 1e-9}
HARTREE_EV = 27.211386245988
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_F64_OPS_S = 67e12
PEAK_F64_PIPE_S = 34e12  # FP64 outside the tensor cores
PEAK_F32_OPS_S = 67e12  # FP32 outside the tensor cores
# the large-system chain (water clusters, juliachem_jl_tpu_torch/data/
# water_clusters.json): bench.py's basis pair, converged to dele 1e-10 and
# rmsd 1e-8: at dele 1e-8, rmsd 1e-6 the loop may stop while E still swings
# by 1e-7 Eh (ROADMAP.md C0; 2.3e-7 Eh on two waters of the w32 cluster,
# 6-31G, on the CPU), which would hide a restart that lands elsewhere
W_SCF = {"scf_type": "df", "niter": 50, "dele": 1e-10, "rmsd": 1e-8,
         "guess": "sad"}
W_BASIS, W_AUX = "6-31+G*", "cc-pVTZ-JKFIT"
# w32: f32 B vs f64 B.  The shift of f32 storage grows with the system
# (-1.04e-5 Eh at w8 in both packages, smoke_reference.json f32_b;
# -1.661e-4 Eh at w32 on an H100 80GB HBM3), so 1e-4 does not hold at w32;
# the gate sits just above the measured shift, so a worse f32 B fails
E_F32_B_TOL = 3e-4
# w64 on an f32 B, converged with W_SCF (tools/run_water_cluster.py w64 on
# an NVIDIA H100 80GB HBM3 at 700 W): phase 13 prints the f32 storage's
# shift against its own f64-B energy
W64_F32B_ENERGY = -4865.1375295166
# phase 12's water-cluster DF gradients (w8, w32), fitted in Cartesian aux
# rows (5312 at w32; the SCF and the gradient both).  The analytic
# gradient is linear in D, so D is converged to rmsd 1e-11 (the central
# differences' energies, h = 5e-4 bohr, are second order in D's error; at
# rmsd 1e-9 the w32 gradient missed them by 3.1e-6 Eh/bohr), and as it
# differentiates the unscreened DF energy, the packed builder keeps every
# pair above 1e-12 (the default sigma, 1e-5, drops pairs whose share of the
# energy moves with the geometry) and screens no exchange.
# tools/grad_fit_variants.py takes these settings apart (PERF.md §6)
W_GRAD = {"df_spherical_aux": False, "mixed_precision": False,
          "dele": 1e-10, "rmsd": 1e-11, "niter": 100, "df_sigma": 1e-12,
          "df_exchange_screen": False}
W_GRAD_FD_STEP, W_GRAD_FD_TOL = 5e-4, 1e-6
# the first 8 waters of w32 as the JAX package's recorded runs have them
W8_SCF = {"niter": 60, "dele": 1e-9, "rmsd": 1e-7,
          "contraction_mode": "screened", "mixed_precision": False}
# K2's f32 instance before its FP32 register-tiled design (one row q and
# 16 orbitals a block over every row m), as this script and
# tools/run_water_cluster.py recorded it on the tree before that design,
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §5-6): printed on a line
# of its own beside the design's time, never in the kernels line
K2_F32_RECORDED = {
    "benzene_2_water": "5.070 ms a launch at this Q-block (PERF.md §6)",
    "w32 Q-block": "77.3 ms a launch at this Q-block, the K2 of an "
                   "f32-phase build (PR 7 run 9, PERF.md §5)",
    "w64 Q-block": "1124.6 ms of K2 in an f32-phase build of 8 such blocks "
                   "on an f32 B (PR 13 run 1, PERF.md §5)"}
# K4/K5's g class pairs before their block route (7 on the lane route, 58
# on the warp route), as phase 3g recorded them on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md §6, the tree before the block route): printed on
# a line of its own beside this run's times, never in the kernels line
G_RECORDED = {"eri4c": "730.3 ms (gg|gg) alone 138.2 ms",
              "eri4c_jk_list": "803.3 ms (gg|gg) alone 158.8 ms",
              "eri4c_jk_stair": "819.5 ms (gg|gg) alone 159.2 ms",
              "full g staircase build of benzene_2_water":
                  "94.4 s in its 65 g class pairs"}
# K6's g class pairs and K1's g classes before their redesign (K6's warp
# route, blocks past 110 KiB read where they lie; K1's block route with R
# and T1 a thread an item), as the smoke and tools/eri*_class_times.py
# recorded them on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6): printed
# on a line of its own beside this run's times, never in the kernels line
G_K6_K1_RECORDED = {
    "digest_jk phase 3g": "12.962 ms over the 65 g class pairs, (gg|gg) "
                          "alone 3.234 ms",
    "digest_jk in-core build of w2": "7.517, 7.455, 7.442 ms",
    "eri3c phase 3g": "6.593 ms over the 25 g classes, (gg|g) alone 0.498 "
                      "ms",
    "eri3c 3-center build": "20.091, 20.072 ms in the 25 g classes of "
                            "benzene_2_water's, the largest (pg|d) 3.016 "
                            "ms"}
E_RESTART_TOL = 1e-9   # restart from the caches vs the run that wrote them
E_FDIFF_TOL = 1e-8     # incremental Fock vs the full build each iteration
SUBSET = 4096  # quartets per class pair in the 4-center kernel checks
# ... and in phase 3g's checks of the g class pairs: their warp route and
# plain versions take ~2.5 and ~10 s over 4096 quartets of the 65 class
# pairs, so the check runs at a quarter of that depth
SUBSET_G = 1024
# phase 10, the f bases: the repo's production f basis
# (tools/make_basis_library.py:233) and the smallest f basis of the library
F_BASIS = "6-311++G(3df,3pd)"
F_BASIS_SMALL = "6-31G(2df,p)"
# phase 11, the g basis: the production f basis plus one G shell on C and
# O (the G exponents of cc-pVTZ-JKFIT), read from its GAMESS-US file
# through model.basis_file (tools/make_g_basis.py writes it)
G_BASIS = "6-311++G(3df,3pd)+G"
G_BASIS_FILE = "tests/data/6-311ppG_3df_3pd_G.gbs"
# ... and long contractions, for the block route's rounds of primitive
# pairs: cc-pVDZ plus a 12-primitive S and a 2-primitive G shell on O
# (tools/make_g_basis.py --long), one water, SUBSET_LONG quartets a class
# pair
LONG_BASIS = "cc-pVDZ+S12G2"
LONG_BASIS_FILE = "tests/data/long_s_2g.gbs"
SUBSET_LONG = 256
BOYS_TCRIT = 35.0  # csrc/boys.cuh: the series up to this T, asymptotic above
# clock cycles of the kernel that holds the stream while one in-core
# build's K6 launches are queued (~50 ms at the H100's clocks; queueing 55
# launches takes a few ms)
K6_QUEUE_CYCLES = 100_000_000
T_BUDGET = 1 << 25  # Boys arguments per chunk when counting them


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def sh(*cmd: str) -> str:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"<{cmd[0]} unavailable: {exc}>"
    return (out.stdout or out.stderr).strip()


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean device time of fn() in ms over reps runs, after one warm-up."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_of(nbytes: float, ops: float, peak: float = PEAK_F64_OPS_S) -> dict:
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over the peak of their type (default f64), and
    which one binds."""
    t_b, t_o = nbytes / PEAK_BYTES_S * 1e3, ops / peak * 1e3
    return {"bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "bytes": nbytes, "operations": ops}


def str_keys(x):
    """x with every dict key that JSON cannot take (a class tuple) as a
    string."""
    if isinstance(x, dict):
        return {k if isinstance(k, (str, int, float)) else str(k): str_keys(v)
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [str_keys(v) for v in x]
    return x


def nherm(L: int) -> int:
    return (L + 1) * (L + 2) * (L + 3) // 6


def ncart(l: int) -> int:
    return (l + 1) * (l + 2) // 2


def boys_r_ops(L: int, n_prim: float, n_series: float) -> float:
    """Operations of the Boys function and the Hermite R recursion of n_prim
    primitive quartets at total order L, n_series of them with T <= 35: the
    128-term series there (multiply, divide, add per term), the asymptotic
    form elsewhere (square root, exponential, divide); the recursion over
    the orders; three operations per R value at every level of its
    recursion."""
    per = 3 * L + 3 * sum(nherm(L - n) for n in range(L + 1))
    return n_prim * per + n_series * 3 * 128 + (n_prim - n_series) * 3


def eri_ops(la, lb, lc, ld, n_prim, n_series, kb_sum, kk_sum) -> float:
    """Operations of McMurchie-Davidson ERIs of one class: per primitive
    quartet Boys + R and the T1 product; per bra primitive pair of each
    quartet the expansion and the output product; per ket primitive pair
    its expansion (n_prim primitive quartets, n_series of them on the Boys
    series; kb_sum, kk_sum: bra and ket primitive pairs summed over the
    quartets)."""
    nab, ncd = ncart(la) * ncart(lb), ncart(lc) * ncart(ld)
    nhb, nhk = nherm(la + lb), nherm(lc + ld)
    return (boys_r_ops(la + lb + lc + ld, n_prim, n_series)
            + n_prim * 2 * nhb * ncd * nhk
            + kb_sum * (4 * nab * nhb + 2 * nab * nhb * ncd)
            + kk_sum * 4 * ncd * nhk)


def pipe_split(cls, n_prim, n_series, kb_sum, kk_sum, quartets) -> dict:
    """K4/K5's operations of one class split by pipe, beside ``bound_of``'s
    single rate: the Boys series and the R recursion on the scalar FP64
    pipe (34 TFLOP/s), the products and the digestion (12 per block
    element) at the 67 TFLOP/s of the bound."""
    la, lb, lc, ld = cls
    scalar = boys_r_ops(la + lb + lc + ld, n_prim, n_series)
    products = (eri_ops(la, lb, lc, ld, n_prim, n_series, kb_sum, kk_sum)
                - scalar + 12.0 * quartets * ncart(la) * ncart(lb)
                * ncart(lc) * ncart(ld))
    return {"fp64_pipe_ops": scalar,
            "fp64_pipe_ms": scalar / PEAK_F64_PIPE_S * 1e3,
            "product_ops": products,
            "product_ms": products / PEAK_F64_OPS_S * 1e3}


def add_splits(splits) -> dict:
    out = {k: sum(s[k] for s in splits) for k in ("fp64_pipe_ops",
                                                   "product_ops")}
    out["fp64_pipe_ms"] = out["fp64_pipe_ops"] / PEAK_F64_PIPE_S * 1e3
    out["product_ms"] = out["product_ops"] / PEAK_F64_OPS_S * 1e3
    return out


def fmt_pipes(s: dict) -> str:
    return (f"FP64 pipe {s['fp64_pipe_ms']:.4f} ms ({s['fp64_pipe_ops']:.4e} "
            f"Boys + R operations at 34 TFLOP/s), products "
            f"{s['product_ms']:.4f} ms ({s['product_ops']:.4e} at 67)")


def compiled_route(bra, ket) -> str:
    """The route K4/K5 were built with for the class pair of two CUDA pair
    tables (``jc_eri4c_geometry``: ``Eri4cClass::kLane`` as nvcc compiled
    it), held to the table of ``ops/kernels.py``."""
    from juliachem_jl_tpu_torch.ops import eri, kernels

    cls = (bra.la, bra.lb, ket.la, ket.lb)
    got, want = eri.eri4c_geometry(bra, ket)["route"], kernels.eri4c_route(*cls)
    check(got == want, f"{cls}: built on the {got} route, the table of "
          f"ops/kernels.py says {want}")
    return got


def compiled_k6_route(bra, ket) -> dict:
    """K6's launch geometry for a class pair as the kernels were built
    (``fock.digest_geometry``), its route held to ``kernels.digest_route``,
    which takes the lane route only where K4/K5's table (as built) has it."""
    from juliachem_jl_tpu_torch.ops import eri, fock, kernels

    cls = (bra.la, bra.lb, ket.la, ket.lb)
    geo = fock.digest_geometry(bra, ket)
    want = kernels.digest_route(*cls)
    check(geo["route"] == want, f"K6 {cls}: built on the {geo['route']} "
          f"route, the table of ops/kernels.py says {want}")
    check(geo["route"] != "lane" or eri.eri4c_geometry(bra, ket)["route"]
          == "lane", f"K6 {cls}: on the lane route, K4/K5's is "
          f"{kernels.eri4c_route(*cls)}")
    return geo


def k6_route_text(geo: dict) -> str:
    return (f"{geo['route']} ({geo['warps_per_block']} warps a block, "
            f"{geo['warps_per_sm']} warps/SM)")


def digest_bound(bra, ket, n: int) -> tuple[float, float]:
    """(bytes, operations) of K6 over n cached blocks of one class pair, as
    ``fourc_bounds`` counts them: the blocks, selections and weights and
    the meta tables read once; 12 operations a block element.  A build
    adds D read and J, K written once (24 nbf^2 bytes)."""
    blk = ncart(bra.la) * ncart(bra.lb) * ncart(ket.la) * ncart(ket.lb)
    return (8.0 * n * blk + 24.0 * n
            + 4.0 * (bra.meta.numel() + ket.meta.numel()), 12.0 * n * blk)


def incore_k6_times(tag: str, fb, D, name: str) -> dict:
    """One in-core build of the ScreenedDirectFock ``fb`` at D through K6
    (its blocks cached and one build done before: the warm-up), each class
    pair's launch timed alone by CUDA events, beside its bound
    (``digest_bound``); the sum of the launches is K6's device time a
    build.  The launches and their
    events are queued behind a sleeping kernel (``K6_QUEUE_CYCLES``), so
    that a launch's time holds no wait for the host (a build's wall with
    the host's part is the cached build's in ``builds_at``)."""
    import torch

    from juliachem_jl_tpu_torch.ops import fock

    nbf = fb.nbf
    D = D.to(device=fb.device, dtype=torch.float64).contiguous()
    JK = torch.zeros((2, nbf, nbf), dtype=torch.float64, device=fb.device)
    events = []
    torch.cuda.synchronize()
    # the launches queue up behind a sleeping kernel, so that the events
    # time the kernels back to back and not the host's launch path
    asleep = torch.cuda.Event(enable_timing=True)
    asleep.record()
    torch.cuda._sleep(K6_QUEUE_CYCLES)
    t0 = time.perf_counter()
    for g in fb.groups:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fock.digest_jk(JK, g.I, g.bra, g.ket, g.sel_bra, g.sel_ket, g.weight,
                       D)
        ev[1].record()
        events.append(ev)
    queued = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    slept = asleep.elapsed_time(events[0][0]) if events else 0.0
    check(queued * 1e3 < slept, f"K6 {name}: queueing the launches took "
          f"{queued * 1e3:.3f} ms, the device slept {slept:.3f} ms")
    rows, nbytes, ops = [], 8.0 * 3 * nbf * nbf, 0.0
    for g, (a, b) in zip(fb.groups, events):
        n = g.sel_bra.shape[0]
        cls = (g.bra.la, g.bra.lb, g.ket.la, g.ket.lb)
        by, op = digest_bound(g.bra, g.ket, n)
        nbytes, ops = nbytes + by, ops + op
        rows.append({"cls": list(cls), "quartets": n,
                     "ms": a.elapsed_time(b), **bound_of(by, op)})
    for v in rows:
        c = v["cls"]
        print(f"{tag} K6 {name} class ({c[0]}{c[1]}|{c[2]}{c[3]}): "
              f"{v['quartets']} blocks, kernel {v['ms']:.4f} ms, bound "
              f"{v['bound_ms']:.4f} ms ({v['bound_by']})", flush=True)
    total = {"system": name, "quartets": sum(v["quartets"] for v in rows),
             "launches": len(rows), "ms": sum(v["ms"] for v in rows),
             "queue_s": queued, **bound_of(nbytes, ops), "classes": rows}
    print(f"{tag} K6 {name}: one in-core build, {total['launches']} launches, "
          f"{total['quartets']} blocks ({nbytes / 1e9:.4f} GB): "
          f"{total['ms']:.3f} ms in the launches (CUDA events, queued behind "
          f"a sleeping kernel; the host queued them in {queued * 1e3:.3f} "
          f"ms), bound {total['bound_ms']:.4f} ms ({total['bound_by']})",
          flush=True)
    return total


def k6_by_route(tag: str, fb, k6: dict) -> dict:
    """The class pairs of ``incore_k6_times``' build ``k6`` on each of K6's
    routes as built (``compiled_k6_route``): their count, blocks, summed
    kernel time and bound; each class row gains its route and geometry."""
    by_route = {}
    for g, v in zip(fb.groups, k6["classes"]):
        v["geometry"] = compiled_k6_route(g.bra, g.ket)
        v["route"] = v["geometry"]["route"]
        r = by_route.setdefault(v["route"], {"class_pairs": 0, "quartets": 0,
                                             "ms": 0.0, "bound_ms": 0.0})
        r["class_pairs"] += 1
        r["quartets"] += v["quartets"]
        r["ms"] += v["ms"]
        r["bound_ms"] += v["bound_ms"]
    k6["by_route"] = by_route
    print(f"{tag} K6 {k6['system']} by route (the build's times): " + ", ".join(
        f"{k} {v['class_pairs']} class pairs, {v['quartets']} blocks, "
        f"{v['ms']:.3f} ms (bound {v['bound_ms']:.4f})"
        for k, v in sorted(by_route.items())) + "; " + ", ".join(
        f"({c[0]}{c[1]}|{c[2]}{c[3]}) {k6_route_text(v['geometry'])}"
        for v in k6["classes"] for c in [v["cls"]]), flush=True)
    return by_route


def stair_class_times(tag: str, dev, prim, D, name: str, route,
                      warm: bool = True, only_l: int | None = None) -> dict:
    """One full StreamingDirectFock build of ``prim`` at D, each class
    pair's K5 staircase launch timed alone by CUDA events (after one
    warm-up build unless ``warm`` is False), with its quartets, live and
    Boys-series primitive quartets (``staircase_prims``), its bound
    (``eri_ops`` + digestion, as in ``check_4c``), that bound split by
    pipe, and its route (``route(bra, ket)``: ``compiled_route`` on this
    tree); with ``only_l``, only the class pairs that hold a shell of that
    angular momentum."""
    import torch

    from juliachem_jl_tpu_torch.ops import fock_stream

    sdf = fock_stream.StreamingDirectFock(prim, device=dev)
    if only_l is not None:
        sdf.pairs = [cp for cp in sdf.pairs if only_l in (
            sdf.blocks[cp.bi].table.la, sdf.blocks[cp.bi].table.lb,
            sdf.blocks[cp.ki].table.la, sdf.blocks[cp.ki].table.lb)]
        sdf.n_quartets = sum(cp.N for cp in sdf.pairs)
    stair = staircase_prims(sdf)
    nbf = prim.nbf
    D = D.to(device=dev, dtype=torch.float64).contiguous()
    JK = torch.zeros((2, nbf, nbf), dtype=torch.float64, device=dev)

    def launch(cp):
        fock_stream.eri4c_jk_staircase(JK, sdf.blocks[cp.bi].table,
                                       sdf.blocks[cp.ki].table, cp.cum, cp.N,
                                       cp.same, D)

    if warm:
        for cp in sdf.pairs:
            launch(cp)
    events = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for cp in sdf.pairs:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        launch(cp)
        ev[1].record()
        events.append(ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = []
    for x, (a, b) in zip(stair, events):
        cls = (x["bra"].la, x["bra"].lb, x["ket"].la, x["ket"].lb)
        blk = ncart(cls[0]) * ncart(cls[1]) * ncart(cls[2]) * ncart(cls[3])
        nbytes = (8.0 * (x["bra"].pair.numel() + x["ket"].pair.numel()
                         + x["ncum"]) + 4.0 * (x["bra"].meta.numel()
                                                + x["ket"].meta.numel()))
        ops = (eri_ops(*cls, x["n_prim"], x["n_series"], x["kb"], x["kk"])
               + 12.0 * x["N"] * blk)
        rows.append({"cls": list(cls), "L": sum(cls),
                     "route": route(x["bra"], x["ket"]),
                     "quartets": x["N"], "n_prim": x["n_prim"],
                     "n_series": x["n_series"], "ms": a.elapsed_time(b),
                     **bound_of(nbytes, ops),
                     **pipe_split(cls, x["n_prim"], x["n_series"], x["kb"],
                                  x["kk"], x["N"])})
    for v in rows:
        print(f"{tag} K5 staircase {name} class ({v['cls'][0]}{v['cls'][1]}|"
              f"{v['cls'][2]}{v['cls'][3]}) L={v['L']} route {v['route']}: "
              f"{v['quartets']} quartets, {v['n_prim']} live primitive "
              f"quartets ({v['n_series']} on the Boys series); kernel "
              f"{v['ms']:.3f} ms, bound {v['bound_ms']:.4f} ms "
              f"({v['bound_by']}); {fmt_pipes(v)}", flush=True)
    total = sum(v["ms"] for v in rows)
    split = add_splits(rows)
    print(f"{tag} K5 staircase {name}: one full build, {len(rows)} class "
          f"pairs, {sdf.n_quartets} quartets: {total:.3f} ms in the launches "
          f"(CUDA events; {wall:.3f} s host wall), bound "
          f"{sum(v['bound_ms'] for v in rows):.3f} ms; {fmt_pipes(split)}",
          flush=True)
    return {"system": name, "quartets": sdf.n_quartets, "ms": total,
            "wall_s": wall, "classes": rows, **split}


def prim_pairs(pair, Ka: int, Kb: int):
    """Primitive pairs of packed pair rows [n, 2Ka+2Kb+6] (aexp | acoef |
    bexp | bcoef | A | B): exponent sums p [n, Ka*Kb], centres P
    [n, Ka*Kb, 3], and whether both coefficients are nonzero."""
    o = 2 * Ka + 2 * Kb
    a, b = pair[:, :Ka, None], pair[:, None, 2 * Ka:2 * Ka + Kb]
    p = a + b
    P = (a[..., None] * pair[:, None, None, o:o + 3]
         + b[..., None] * pair[:, None, None, o + 3:o + 6]) / p[..., None]
    live = (pair[:, Ka:2 * Ka, None] != 0) & (pair[:, None, 2 * Ka + Kb:o] != 0)
    n = pair.shape[0]
    return p.reshape(n, -1), P.reshape(n, -1, 3), live.reshape(n, -1)


def series_count(p, P, q, Q, live) -> int:
    """How many of the live primitive quartets (or 3-center products) take
    the Boys series, T = pq/(p+q) |P-Q|^2 <= 35 (arguments broadcast)."""
    T = p * q / (p + q) * ((P - Q) ** 2).sum(-1)
    return int(((T <= BOYS_TCRIT) & live).sum())


def quartet_prims(bra, ket, r, c) -> tuple[int, int]:
    """(nonzero-coefficient, Boys-series) primitive quartets of the quartets
    (bra[r[i]], ket[c[i]]) of two PairTables."""
    n_prim = n_series = 0
    step = max(1, T_BUDGET // (bra.Ka * bra.Kb * ket.Ka * ket.Kb))
    for s in range(0, len(r), step):
        pb, Pb, lb = prim_pairs(bra.pair[r[s:s + step]], bra.Ka, bra.Kb)
        pk, Pk, lk = prim_pairs(ket.pair[c[s:s + step]], ket.Ka, ket.Kb)
        live = lb[:, :, None] & lk[:, None, :]
        n_prim += int(live.sum())
        n_series += series_count(pb[:, :, None], Pb[:, :, None], pk[:, None],
                                 Pk[:, None], live)
    return n_prim, n_series


def staircase_prims(sdf) -> list[dict]:
    """Per class pair of a StreamingDirectFock, the primitive quartets of
    one full build: padded to the class contractions, of nonzero
    coefficients (n_prim), of these on the Boys series (n_series), and the
    bra and ket primitive pairs summed over the quartets (kb, kk)."""
    import torch

    out = []
    for cp in sdf.pairs:
        bra, ket = sdf.blocks[cp.bi].table, sdf.blocks[cp.ki].table
        pb, Pb, lb = prim_pairs(bra.pair, bra.Ka, bra.Kb)
        pk, Pk, lk = prim_pairs(ket.pair, ket.Ka, ket.Kb)
        lim = torch.as_tensor(cp.lim, dtype=torch.int64, device=pb.device)
        # the live ket primitive pairs row by row: those of the rows c <
        # lim[r] are the first prefix[lim[r]]
        prefix = torch.cat([lim.new_zeros(1), lk.sum(1).cumsum(0)])
        kidx = lk.reshape(-1).nonzero().squeeze(1)
        pk, Pk = pk.reshape(-1)[kidx], Pk.reshape(-1, 3)[kidx]
        bidx = lb.reshape(-1).nonzero().squeeze(1)
        jlim = prefix[lim[bidx // lb.shape[1]]]
        pb, Pb = pb.reshape(-1)[bidx], Pb.reshape(-1, 3)[bidx]
        n_series = 0
        step = max(1, T_BUDGET // max(1, int(jlim.max()) if len(jlim) else 1))
        for e in range(0, len(bidx), step):
            jl = jlim[e:e + step]
            jm = int(jl.max())
            live = torch.arange(jm, device=jl.device)[None, :] < jl[:, None]
            n_series += series_count(pb[e:e + step, None], Pb[e:e + step, None],
                                     pk[None, :jm], Pk[None, :jm], live)
        out.append(dict(
            bra=bra, ket=ket, N=cp.N, ncum=cp.cum.numel(),
            padded=cp.N * bra.Ka * bra.Kb * ket.Ka * ket.Kb,
            n_prim=int(jlim.sum()), n_series=n_series,
            kb=int((lb.sum(1) * lim).sum()), kk=int(prefix[lim].sum())))
    return out


def system_input(name: str, golden: dict, extra: dict | None = None,
                 scf: dict | None = None, aux: bool = True,
                 method: str = "RHF", charge: int = 0,
                 multiplicity: int = 1) -> dict:
    atoms = golden["atoms"]
    model = {"method": method, "basis": golden["basis"]}
    if aux:
        model["auxiliary_basis"] = "cc-pVTZ-JKFIT"
    return {
        "molecule": {"symbols": [a["symbol"] for a in atoms],
                     "geometry": [x * BOHR for a in atoms for x in a["xyz_bohr"]],
                     "molecular_charge": charge,
                     "molecular_multiplicity": multiplicity},
        "driver": "energy",
        "model": model,
        "keywords": {"scf": {**(scf or SCF), **(extra or {})}, "prop": PROPS},
    }


# ------------------------------------------------------------------ phase 3

def check_k3(tag: str, dev) -> dict:
    import torch

    from juliachem_jl_tpu_torch.ops import boys, kernels

    T = torch.linspace(0.0, 60.0, 1_000_001, dtype=torch.float64, device=dev)
    worst = 0.0
    n0 = kernels.launches["boys_probe"]
    for m in range(9):
        ref = boys.boys(T, m)
        got = boys.boys_probe(T, m)
        worst = max(worst, float(((got - ref).abs() / ref.abs()).max()))
    check(kernels.launches["boys_probe"] == n0 + 9,
          "K3 comparison did not launch the kernel")
    check(worst <= 1e-14, f"K3 boys_probe relative error {worst:.3e} > 1e-14")
    # the second instance: the divide-free form K4/K5 inline
    worst_r = 0.0
    n0 = kernels.launches["boys_probe_recip"]
    for m in range(17):
        ref = boys.boys(T, m)
        got = boys.boys_probe(T, m, recip=True)
        worst_r = max(worst_r, float(((got - ref).abs() / ref.abs()).max()))
    check(kernels.launches["boys_probe_recip"] == n0 + 17,
          "K3 comparison did not launch the divide-free instance")
    check(worst_r <= 1e-14,
          f"K3 divide-free relative error {worst_r:.3e} > 1e-14")
    ms = cuda_ms(lambda: boys.boys_probe(T, 8))
    ms_r = cuda_ms(lambda: boys.boys_probe(T, 8, recip=True))
    plain = cuda_ms(lambda: boys.boys(T, 8))
    print(f"{tag} K3 boys_probe T in [0,60] n=1000001 m<=8: max rel err "
          f"{worst:.3e} (bound 1e-14); m=8 kernel {ms:.4f} ms, plain torch "
          f"{plain:.4f} ms; divide-free instance m<=16: max rel err "
          f"{worst_r:.3e}, m=8 {ms_r:.4f} ms", flush=True)
    n = T.shape[0]
    n_series = int((T <= BOYS_TCRIT).sum())
    return {"name": "boys_probe", "route": "cuda",
            "source": "juliachem_jl_tpu_torch/csrc/boys_probe.cu",
            "replaces": "juliachem_jl_tpu/ops/boys.py:61",
            "max_abs_err": float((boys.boys_probe(T, 8)
                                  - boys.boys(T, 8)).abs().max()),
            "max_rel_err": worst, "ms": ms, "plain_ms": plain,
            "recip": {"max_rel_err": worst_r, "ms": ms_r},
            "library_ms": None,
            **bound_of(8.0 * n * (1 + 9), n_series * 3 * 128
                       + (n - n_series) * 3 + n * 3 * 8)}


# ------------------------------------------------------------------ K9

def stv_counts(tables, atoms) -> dict:
    """Per class of K9's packing (``oei.stv_tables``): shell pairs, live
    primitive pairs, the (live primitive pair, nucleus) items of the
    nuclear sum and those of them on the Boys series (T <= 35), and the
    S/T/V elements the class stores (its blocks and their transposes)."""
    import torch

    C = atoms[:, :3]
    rows = max(1, (1 << 24) // max(atoms.shape[0], 1))
    out = {}
    for tab in tables:
        meta = tab.meta.long()
        seg = torch.repeat_interleave(
            torch.arange(tab.n, device=meta.device), meta[:, 4])
        series = 0
        for s0 in range(0, tab.prim.shape[0], rows):
            a, b = tab.prim[s0:s0 + rows, 0], tab.prim[s0:s0 + rows, 1]
            cen = tab.pair[seg[s0:s0 + rows]]
            p = a + b
            P = (a[:, None] * cen[:, :3] + b[:, None] * cen[:, 3:]) / p[:, None]
            T = p[:, None] * ((P[:, None, :] - C[None]) ** 2).sum(-1)
            series += int((T <= BOYS_TCRIT).sum())
        nab = ncart(tab.la) * ncart(tab.lb)
        diag = int((meta[:, 2] != 0).sum())
        out[(tab.la, tab.lb)] = {
            "pairs": tab.n, "live_prim_pairs": int(tab.prim.shape[0]),
            "items": int(tab.prim.shape[0]) * atoms.shape[0],
            "series_items": series, "stores": nab * (2 * tab.n - diag)}
    return out


def stv_ops(la: int, lb: int, c: dict) -> float:
    """K9's operations for one class's counts (``stv_counts``): per item
    Boys and R (``boys_r_ops``), the distance, the charge scaling of the
    L + 1 Boys values and the nherm(L) adds of the sum; per live primitive
    pair its three E tables to lb + 2 (five operations an entry) and the
    contraction of each component pair (S 4, T 25, V 3 a Hermite term)."""
    L = la + lb
    ne = (la + 1) * (lb + 3) * (L + 3)
    per_prim = 15 * ne + ncart(la) * ncart(lb) * (29 + 3 * nherm(L))
    return (boys_r_ops(L, c["items"], c["series_items"])
            + c["items"] * (8 + (L + 1) + nherm(L))
            + c["live_prim_pairs"] * per_prim)


def stv_bound(counts: dict, natom: int) -> dict:
    """``bound_of`` K9's launches of ``counts``: each packed row read once
    (24 B a live primitive pair, 68 B a shell pair, 32 B a nucleus), each
    stored element written once."""
    nbytes = (sum(24 * c["live_prim_pairs"] + 68 * c["pairs"]
                  + 24 * c["stores"] for c in counts.values())
              + 32 * natom)
    ops = sum(stv_ops(*cls, c) for cls, c in counts.items())
    return bound_of(nbytes, ops)


def stv_launch_ms(tables, atoms, nbf: int, dev, reps: int = 3,
                  group: int | None = None) -> dict:
    """K9's CUDA-event time over all of ``tables`` (one launch a class, a
    mean of ``reps`` after a warm-up), and each class's alone."""
    import torch

    from juliachem_jl_tpu_torch.ops import oei

    M = [torch.empty((nbf, nbf), dtype=torch.float64, device=dev)
         for _ in range(3)]

    def run(tabs):
        return lambda: [oei.stv_class(t, atoms, *M, group=group) for t in tabs]

    return {"ms": cuda_ms(run(tables), reps),
            "per_class": {(t.la, t.lb): cuda_ms(run([t]), reps)
                          for t in tables}}


def stv_registers(tag: str) -> dict:
    """K9's instances (one a class), as ptxas reported them in this
    process's build: registers, stack frame, spills."""
    out = ptxas_instances(re.compile(
        r"\d+(stv_kernel)ILi(\d)ELi(\d)E"), 2).get("stv_kernel")
    check(out is not None and out["instances"] == 15,
          "ptxas: K9's instances are not one a class")
    print(f"{tag} K9 instances (ptxas): " + fmt_instances(
        {"stv_kernel": out}), flush=True)
    return out


def check_k9(tag: str, dev, label: str, prim, mol) -> dict:
    """K9 against its plain version on one system: ``overlap_kinetic_
    nuclear`` on the card (K9, one launch a class) and ``overlap_kinetic_
    nuclear_plain`` there, every class's stored elements within 1e-12 x
    each matrix's max-abs; K9's CUDA-event time (all classes, each class)
    beside the bound of this system's counts, the wrapper's wall (packing
    included) and the plain version's time."""
    import torch

    from juliachem_jl_tpu_torch.ops import kernels, oei

    nbf = prim.nbf
    n0 = kernels.launches["stv"]
    t0 = time.perf_counter()
    got = oei.overlap_kinetic_nuclear(prim, mol, dev)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    tables = oei.stv_tables(prim, dev)
    check(kernels.launches["stv"] - n0 == len(tables),
          f"{label}: K9 launched {kernels.launches['stv'] - n0} times for "
          f"{len(tables)} classes")
    ref = oei.overlap_kinetic_nuclear_plain(prim, mol, dev)
    scale = [float(r.abs().max()) for r in ref]
    per_class, worst = {}, 0.0
    for tab in tables:
        idx = torch.as_tensor(oei.stv_targets(tab, nbf),
                              device=dev).reshape(-1)
        errs = [float((g.reshape(-1)[idx] - r.reshape(-1)[idx]).abs().max())
                / s for g, r, s in zip(got, ref, scale)]
        per_class[f"{tab.la}{tab.lb}"] = {"rel_err": errs}
        worst = max(worst, *errs)
    check(worst <= 1e-12, f"{label}: K9 off its plain version by "
          f"{worst:.3e} x max |M| (bound 1e-12)")
    atoms = oei.atom_table(mol, dev)
    times = stv_launch_ms(tables, atoms, nbf, dev)
    plain_ms = cuda_ms(lambda: oei.overlap_kinetic_nuclear_plain(
        prim, mol, dev), reps=1)
    counts = stv_counts(tables, atoms)
    bound = stv_bound(counts, mol.natom)
    for cls, c in counts.items():
        per_class["".join(map(str, cls))].update(
            c, ms=times["per_class"][cls], **bound_of(0.0, stv_ops(*cls, c)))
    items = sum(c["items"] for c in counts.values())
    series = sum(c["series_items"] for c in counts.values())
    print(f"{tag} K9 {label}: nbf {nbf}, {mol.natom} atoms, "
          f"{len(tables)} classes, {items} (live primitive pair, nucleus) "
          f"items ({series} on the Boys series); max err / max |M| "
          f"{worst:.3e} (bound 1e-12); K9 ({kernels.stv_group(mol.natom)} "
          f"lanes a pair) {times['ms']:.4f} ms (bound "
          f"{bound['bound_ms']:.4f} ms, {bound['bound_by']}), the wrapper "
          f"with its packing {call_ms:.1f} ms, plain {plain_ms:.2f} ms; by "
          "class (ms, rel err S T V): " + "; ".join(
              f"({cls}) {v['ms']:.4f} "
              + " ".join(f"{e:.1e}" for e in v["rel_err"])
              for cls, v in per_class.items()), flush=True)
    return {"name": "stv", "route": "cuda",
            "source": "juliachem_jl_tpu_torch/csrc/oei.cuh",
            "replaces": "juliachem_jl_tpu/ops/oei.py:42",
            "shapes": label, "max_abs_err": max(
                float((g - r).abs().max()) for g, r in zip(got, ref)),
            "rel_err": worst, "ms": times["ms"], "plain_ms": plain_ms,
            "call_ms": call_ms, "library_ms": None, **bound,
            "group": kernels.stv_group(mol.natom), "per_class": per_class}


def dipole_bound(prim) -> dict:
    """``bound_of`` the dipole integrals (``oei.dipole_matrices``, plain
    torch, B29) of a basis, from the code's I/O and operations: each unique
    pair block's exponents, coefficients and centres read once, the three
    nbf x nbf matrices written once; per padded primitive pair its three E
    tables (bra to la, ket to lb + 1; five operations an entry) and per
    component pair the three moment products and their contraction (18)."""
    from juliachem_jl_tpu_torch.ops.pairs import unique_pair_blocks

    nbytes, ops = 3 * prim.nbf * prim.nbf * 8, 0.0
    for blk in unique_pair_blocks(prim):
        ka, kb = blk.aexp.shape[1], blk.bexp.shape[1]
        nbytes += blk.n * (16 * (ka + kb) + 48)
        ops += blk.n * ka * kb * (
            15 * (blk.la + 1) * (blk.lb + 2) * (blk.la + blk.lb + 2)
            + 18 * ncart(blk.la) * ncart(blk.lb))
    return bound_of(nbytes, ops)


def stv_at(tag: str, label: str, prim, mol) -> dict:
    """At a cluster on its SCF path: K9 (``overlap_kinetic_nuclear``) held
    to its plain version on the card (every element within 1e-12 x each
    matrix's max-abs, at the group ``kernels.stv_group`` picks for these
    nuclei), K9's CUDA-event time over the classes beside its bound, the
    walls of ``overlap_kinetic_nuclear`` (the pair blocks, K9's packing and
    launches), of the plain version and of the dipole integrals (plain
    torch, ``dipole_matrices``), each by the host clock to a synchronise.
    Its launches are not the path's: the launch counts are restored."""
    import torch

    from juliachem_jl_tpu_torch.ops import kernels, oei

    saved = (dict(kernels.launches),
             {k: dict(v) for k, v in kernels.class_launches.items()})
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = oei.overlap_kinetic_nuclear(prim, mol, dev)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    ref = oei.overlap_kinetic_nuclear_plain(prim, mol, dev)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0 - call_s
    err = max(float((g - r).abs().max() / r.abs().max())
              for g, r in zip(got, ref))
    check(err <= 1e-12, f"{label}: K9 off its plain version by {err:.3e} x "
          "max |M| (bound 1e-12)")
    del got, ref
    tables = oei.stv_tables(prim, dev)
    atoms = oei.atom_table(mol, dev)
    times = stv_launch_ms(tables, atoms, prim.nbf, dev)
    counts = stv_counts(tables, atoms)
    bound = stv_bound(counts, mol.natom)
    oei.dipole_matrices(prim, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    oei.dipole_matrices(prim, dev)
    torch.cuda.synchronize()
    dip_s = time.perf_counter() - t0
    dip = dipole_bound(prim)
    kernels.launches.update(saved[0])
    kernels.class_launches.clear()
    kernels.class_launches.update(saved[1])
    items = sum(c["items"] for c in counts.values())
    series = sum(c["series_items"] for c in counts.values())
    print(f"{tag} {label}: S/T/V by K9 ({kernels.stv_group(mol.natom)} lanes "
          f"a pair) {times['ms']:.4f} ms over {len(tables)} classes (bound "
          f"{bound['bound_ms']:.4f} ms, {bound['bound_by']}; {items} items, "
          f"{series} on the Boys series), max err / max |M| {err:.3e} "
          f"against the plain version (bound 1e-12); overlap_kinetic_nuclear "
          f"(pair blocks, packing, K9) {call_s:.4f} s, plain {plain_s:.4f} s; "
          f"dipole integrals (plain torch) {dip_s:.4f} s (bound "
          f"{dip['bound_ms']:.4f} ms, {dip['bound_by']})", flush=True)
    return {"ms": times["ms"], "call_s": call_s, "plain_ms": 1e3 * plain_s,
            "rel_err": err, "group": kernels.stv_group(mol.natom),
            "per_class_ms": {
                f"{a}{b}": v for (a, b), v in times["per_class"].items()},
            "dipole_s": dip_s, "dipole_bound": dip, "items": items,
            "series_items": series,
            **bound}


def k1_calls(dev, bsets, n_pairs: int = 64) -> list:
    """Every (bra class | aux class) of the system, the first n_pairs bra
    pairs of each class against every aux shell, as K1's arguments into a
    compact [A, 2*n*nab] output: each call a dict of the class, the
    arguments after ``out`` and the output's width.  Every pair is
    mirrored, into columns of its own."""
    import numpy as np
    import torch

    from juliachem_jl_tpu_torch.basis.structs import ncart
    from juliachem_jl_tpu_torch.ops import eri3c
    from juliachem_jl_tpu_torch.ops.pairs import unique_pair_blocks

    prim, aux = bsets.primary, bsets.auxiliary
    auxs = eri3c.aux_tables(aux, dev)
    bra = ([b.select(np.arange(min(n_pairs, b.n))) for b in unique_pair_blocks(prim)]
           + [b.select(np.arange(min(n_pairs, b.n))) for b in eri3c.aux_unit_blocks(aux)])
    calls = []
    for blk in bra:
        nab = ncart(blk.la) * ncart(blk.lb)
        kp = eri3c.k1_pairs(blk, lambda ia, ib: np.arange(ia.size).reshape(
            ia.shape), dev)
        mirror = torch.ones(blk.n, dtype=torch.uint8, device=dev)
        for at in auxs:
            calls.append({"cls": (blk.la, blk.lb, at.lq),
                          "args": (kp.table, at, kp.cols,
                                   kp.cols + blk.n * nab, mirror),
                          "width": 2 * blk.n * nab})
    return calls


def k1_call_shape(args) -> dict:
    """One K1 launch's inputs, from the arguments after ``out`` of
    ``eri3c_class(out, bra, aux, cols, cols_t, mirror)``: the class, the
    pair rows and their contraction widths, the aux rows, the output
    columns, the mirror flags, and the bytes of the function's inputs (the
    pair rows, the aux exponents, coefficients and centres, the aux row
    offsets, the columns and the mirror flags; not the tables the kernel
    derives from them, such as the primitive counts or the aux expansion)."""
    bra, aux, cols, cols_t, mirror = args
    nbytes = 8.0 * (bra.pair.numel() + aux.table.numel() + aux.qrow.numel()
                    + cols.numel() + cols_t.numel()) + mirror.numel()
    return {"cls": (bra.la, bra.lb, aux.lq), "Ka": bra.Ka, "Kb": bra.Kb,
            "pair": bra.pair, "aux": aux.table, "mirror": mirror,
            "in_bytes": nbytes}


def k1_bound(shapes, out_size: int) -> dict:
    """K1's bound over launches (``k1_call_shape``): every input read once,
    every (aux row, column) written once (out_size bytes each; twice for a
    mirrored pair); operations over the primitive products of nonzero
    coefficients, the Boys series only where T <= 35."""
    nbytes = ops = 0.0
    for c in shapes:
        (la, lb, lq), Ka, Kb, pair, aux_t = (c["cls"], c["Ka"], c["Kb"],
                                             c["pair"], c["aux"])
        Kq = (aux_t.shape[1] - 3) // 2
        nq = aux_t.shape[0]
        nab, ncq, nhb = ncart(la) * ncart(lb), ncart(lq), nherm(la + lb)
        live_q = aux_t[:, Kq:2 * Kq] != 0
        n_prim = n_series = kb_sum = 0.0
        step = max(1, T_BUDGET // max(1, Ka * Kb * nq * Kq))
        for s in range(0, pair.shape[0], step):
            p, P, live_p = prim_pairs(pair[s:s + step], Ka, Kb)
            live = live_p[:, :, None, None] & live_q[None, None]
            n_prim += float(live.sum())
            kb_sum += float(live_p.sum())
            n_series += series_count(
                p[:, :, None, None], P[:, :, None, None],
                aux_t[None, None, :, :Kq],
                aux_t[None, None, :, None, 2 * Kq:], live)
        writes = float(pair.shape[0] + int(c["mirror"].sum())) * nab
        nbytes += c["in_bytes"] + out_size * writes * ncq * nq
        ops += (boys_r_ops(la + lb + lq, n_prim, n_series)
                + n_prim * 2 * nhb * ncq * nherm(lq)
                + kb_sum * nq * (4 * nab * nhb + 2 * nab * nhb * ncq))
    return bound_of(nbytes, ops)


def run_k1(fn, calls, A, dtype):
    """Every call of K1 (or its plain version) into fresh zeroed outputs."""
    import torch

    outs = []
    for c in calls:
        out = torch.zeros((A, c["width"]), dtype=dtype,
                          device=c["args"][0].pair.device)
        fn(out, *c["args"])
        outs.append(out)
    return outs


def k1_largest(tag: str, calls, A: int, dtype, largest) -> dict:
    """K1 and its plain version timed on the calls of one class alone,
    beside that class's bound."""
    from juliachem_jl_tpu_torch.ops import eri3c

    sub = [c for c in calls if tuple(c["cls"]) == tuple(largest)]
    check(bool(sub), f"K1: no call of class {largest}")
    ms = cuda_ms(lambda: run_k1(eri3c.eri3c_class, sub, A, dtype), reps=2)
    plain = cuda_ms(lambda: run_k1(eri3c.eri3c_class_plain, sub, A, dtype),
                    reps=2)
    b = k1_bound([k1_call_shape(c["args"]) for c in sub],
                 8 if dtype.itemsize == 8 else 4)
    print(f"{tag} K1 {dtype} class {tuple(largest)} alone: kernel {ms:.3f} ms,"
          f" plain torch {plain:.3f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']})", flush=True)
    return {"class": list(largest), "ms": ms, "plain_ms": plain, **b}


def k1_routes(tag: str, calls) -> dict:
    """K1's route and launch geometry of every class of ``calls`` as
    compiled (``eri3c.eri3c_geometry``), held to the table of
    ops/kernels.py; a block-route class must fit the card's 227 KB of
    shared memory a block (it would fail its launch otherwise) and, within
    ``kEri3cBlockCap``, hold two blocks an SM."""
    from juliachem_jl_tpu_torch.ops import eri3c, kernels

    out = {}
    for c in calls:
        bra, aux = c["args"][0], c["args"][1]
        g = eri3c.eri3c_geometry(*c["cls"], bra.Ka, bra.Kb, aux.Kq)
        want = kernels.eri3c_route(*c["cls"])
        check(g["route"] == want, f"K1 class {c['cls']} compiled on the "
              f"{g['route']} route, the table says {want}")
        if g["route"] != "lane":
            check(g["body"] == kernels.eri3c_body(*c["cls"]),
                  f"K1 class {c['cls']} compiled with the {g['body']} body, "
                  f"the table says {kernels.eri3c_body(*c['cls'])}")
            check(g["smem_bytes"] <= 232448, f"K1 class {c['cls']}: "
                  f"{g['smem_bytes']} bytes of shared memory a block")
            # the thread body: two blocks of 4 warps an SM; the T1 body's
            # blocks of 8 warps at least one
            check(g["blocks_per_sm"] >= 2 or g["QT"] == 1
                  or (g["body"] == "t1" and g["blocks_per_sm"] >= 1),
                  f"K1 class {c['cls']}: {g['blocks_per_sm']} blocks an SM")
        out[str(c["cls"])] = g
    routes = {}
    for cls, g in out.items():
        routes.setdefault(g["route"], []).append(cls)
    print(f"{tag} K1 routes as compiled: " + "; ".join(
        f"{r} {len(v)} classes" for r, v in routes.items())
        + "; block route " + ", ".join(
            f"{cls} {g['body']} QT {g['QT']} {g['threads']} threads "
            f"{g['smem_bytes']} B {g['blocks_per_sm']}/SM"
            for cls, g in out.items() if g["route"] != "lane"), flush=True)
    return out


def check_k1(tag: str, dev, bsets, calls, name: str = "eri3c",
             largest=None) -> dict:
    """K1 against its plain version on every class of ``calls``; with
    ``largest``, that class timed alone too."""
    import torch

    from juliachem_jl_tpu_torch.ops import eri3c, kernels

    A = bsets.auxiliary.nbf
    worst_rel, worst_abs = 0.0, 0.0
    n0 = kernels.launches["eri3c"]
    got = run_k1(eri3c.eri3c_class, calls, A, torch.float64)
    ref = run_k1(eri3c.eri3c_class_plain, calls, A, torch.float64)
    for c, g, r in zip(calls, got, ref):
        err = float((g - r).abs().max())
        scale = float(r.abs().max())
        check(err <= 1e-12 * scale,
              f"K1 class {c['cls']}: max abs err {err:.3e} > 1e-12 x "
              f"{scale:.3e}")
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / scale if scale else 0.0)
    check(kernels.launches["eri3c"] - n0 == len(calls),
          "K1 comparison did not launch the kernel for every class")
    del got, ref
    n_pairs = max(c["args"][0].n for c in calls)
    ms = cuda_ms(lambda: run_k1(eri3c.eri3c_class, calls, A, torch.float64),
                 reps=2)
    plain = cuda_ms(lambda: run_k1(eri3c.eri3c_class_plain, calls, A,
                                   torch.float64), reps=2)
    print(f"{tag} K1 {name}: {len(calls)} classes x {n_pairs} bra pairs x all "
          f"aux shells: max abs err {worst_abs:.3e}, max err/block max-abs "
          f"{worst_rel:.3e} (bound 1e-12); kernel {ms:.3f} ms, plain torch "
          f"{plain:.3f} ms", flush=True)
    b = k1_bound([k1_call_shape(c["args"]) for c in calls], 8)
    print(f"{tag} K1 {name} bound {b['bound_ms']:.3f} ms ({b['bound_by']}: "
          f"{b['bytes']:.3e} B, {b['operations']:.3e} operations)", flush=True)
    out = {"name": name, "route": "cuda",
           "source": "juliachem_jl_tpu_torch/csrc/eri3c.cuh",
           "replaces": "juliachem_jl_tpu/ops/eri3c.py:126",
           "max_abs_err": worst_abs, "max_rel_err": worst_rel,
           "ms": ms, "plain_ms": plain, "library_ms": None, **b}
    if largest is not None:
        out["largest_class"] = k1_largest(tag, calls, A, torch.float64,
                                          largest)
    return out


def check_k1_f32(tag: str, dev, bsets, calls, largest=None) -> dict:
    """K1's f32 store on the same classes: its output is the f64 output
    rounded to f32, bit for bit (K1 has no atomics)."""
    import torch

    from juliachem_jl_tpu_torch.ops import eri3c, kernels

    A = bsets.auxiliary.nbf
    n0 = kernels.launches["eri3c_f32"]
    got = run_k1(eri3c.eri3c_class, calls, A, torch.float32)
    check(kernels.launches["eri3c_f32"] - n0 == len(calls),
          "K1 f32 comparison did not launch the kernel for every class")
    ref = run_k1(eri3c.eri3c_class, calls, A, torch.float64)
    differ = sum(int((g != r.float()).sum()) for g, r in zip(got, ref))
    check(differ == 0, f"K1 f32 store: {differ} elements differ from the "
          "f64 output rounded")
    plain = run_k1(eri3c.eri3c_class_plain, calls, A, torch.float32)
    err = max(float((g - p).abs().max()) for g, p in zip(got, plain))
    del got, ref, plain
    ms = cuda_ms(lambda: run_k1(eri3c.eri3c_class, calls, A, torch.float32),
                 reps=2)
    plain_ms = cuda_ms(lambda: run_k1(eri3c.eri3c_class_plain, calls, A,
                                      torch.float32), reps=2)
    b = k1_bound([k1_call_shape(c["args"]) for c in calls], 4)
    print(f"{tag} K1 eri3c f32 store: {len(calls)} classes, 0 elements off "
          f"the f64 output rounded (bit for bit); max abs err vs the plain "
          f"f32 version {err:.3e}; kernel {ms:.3f} ms, plain torch "
          f"{plain_ms:.3f} ms, bound {b['bound_ms']:.3f} ms ({b['bound_by']})",
          flush=True)
    out = {"name": "eri3c_f32", "route": "cuda",
           "source": "juliachem_jl_tpu_torch/csrc/eri3c.cuh",
           "replaces": "juliachem_jl_tpu/ops/eri3c.py:126",
           "max_abs_err": err, "elements_off_f64_rounded": differ,
           "ms": ms, "plain_ms": plain_ms, "library_ms": None, **b}
    if largest is not None:
        out["largest_class"] = k1_largest(tag, calls, A, torch.float32,
                                          largest)
    return out


class K1Times:
    """CUDA-event times of every K1 launch while active, by build phase
    (``metric``: ``two_center_metric``; ``three_center``:
    ``three_center_tensor``) and class: ``eri3c.eri3c_class`` and the two
    builds wrapped, each build synchronised at its start and end so that
    its host wall holds its kernels.  ``result()`` gives per phase its
    builds' walls, K1's summed device time and share of the wall, its
    launches, and per class launches and ms (with ``bound``, each class's
    and the phase's bound over the launches' inputs)."""

    PHASES = {"two_center_metric": "metric",
              "three_center_tensor": "three_center"}

    def __init__(self, bound: bool = False):
        self.bound = bound

    def __enter__(self):
        import torch

        from juliachem_jl_tpu_torch.ops import eri3c

        self.mod = eri3c
        self.saved = {k: getattr(eri3c, k)
                      for k in ("eri3c_class", *self.PHASES)}
        self.events = {ph: [] for ph in self.PHASES.values()}
        self.walls = {ph: [] for ph in self.PHASES.values()}
        phase = [None]
        k1 = self.saved["eri3c_class"]

        def timed_k1(out, *args):
            if phase[0] is None or not out.is_cuda:
                return k1(out, *args)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            k1(out, *args)
            ev[1].record()
            shape = k1_call_shape(args)
            if not self.bound:
                shape = {"cls": shape["cls"]}
            self.events[phase[0]].append((shape, out.element_size(), *ev))

        def wrap(fn, ph):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                phase[0] = ph
                try:
                    return fn(*a, **kw)
                finally:
                    phase[0] = None
                    torch.cuda.synchronize()
                    self.walls[ph].append(time.perf_counter() - t0)
            return run

        eri3c.eri3c_class = timed_k1
        for name, ph in self.PHASES.items():
            setattr(eri3c, name, wrap(self.saved[name], ph))
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.mod, k, v)
        return False

    def result(self) -> dict:
        import torch

        torch.cuda.synchronize()
        out = {}
        for ph, evs in self.events.items():
            per = {}
            for shape, size, e0, e1 in evs:
                c = per.setdefault(shape["cls"], {"launches": 0, "ms": 0.0,
                                                  "shapes": [], "size": size})
                c["launches"] += 1
                c["ms"] += e0.elapsed_time(e1)
                if self.bound:
                    c["shapes"].append(shape)
            total = sum(c["ms"] for c in per.values())
            wall = sum(self.walls[ph])
            res = {"builds": len(self.walls[ph]), "wall_s": wall,
                   "k1_ms": total, "launches": len(evs),
                   "k1_share": total / (wall * 1e3) if wall else None,
                   "classes": {}}
            all_shapes = []
            for cls, c in sorted(per.items()):
                row = {"launches": c["launches"], "ms": c["ms"]}
                if self.bound:
                    b = k1_bound(c["shapes"], c["size"])
                    row.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"])
                    all_shapes += [(s, c["size"]) for s in c["shapes"]]
                res["classes"][cls] = row
            if self.bound and all_shapes:
                b = k1_bound([s for s, _ in all_shapes], all_shapes[0][1])
                res.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"])
            out[ph] = res
        return out


def k1_class_sum(phase: dict, pick) -> dict:
    """K1's launches, ms and bound (summed class by class) over the classes
    of one ``K1Times`` phase that ``pick(cls)`` selects, and the slowest."""
    rows = {c: v for c, v in phase["classes"].items() if pick(c)}
    big = max(rows, key=lambda c: rows[c]["ms"]) if rows else None
    return {"classes": len(rows),
            "launches": sum(v["launches"] for v in rows.values()),
            "ms": sum(v["ms"] for v in rows.values()),
            "bound_ms": sum(v.get("bound_ms", 0.0) for v in rows.values()),
            "largest": big, "largest_ms": rows[big]["ms"] if big else 0.0}


def fmt_k1_times(res: dict) -> str:
    return "; ".join(
        f"{ph} {v['builds']} builds, wall {v['wall_s']:.4f} s, K1 "
        f"{v['k1_ms']:.3f} ms in {v['launches']} launches ("
        + (f"{100 * v['k1_share']:.1f} %" if v["k1_share"] is not None
           else "-") + " of the wall"
        + (f", bound {v['bound_ms']:.4f} ms" if "bound_ms" in v else "")
        + ")" for ph, v in res.items() if v["builds"])


def check_k8(tag: str, dev, A: int, label: str) -> dict:
    """K8 at a fold's shape (``label``): A fitted rows, one column chunk
    (``linalg.fold_chunk(A)`` columns) of a wider f32 B (a strided view, as
    the fold reads it), random Mh, Ml of an f64 lower-triangular M, launched
    as the fold launches it (``lower``).  Gate, elementwise: |K8 - plain|
    and |K8 - f64((Mh + Ml) X)| <= 4 sqrt(A) 2^-24 (|Mh| + |Ml|) |X|.
    Times: the kernel, its plain version, the library (two cuBLAS SGEMMs,
    TF32 off, and the add) and the f64 fold the port takes without
    JCHEM_SPLIT_FOLD (DGEMM of the upcast chunk, f32 store).  The bound
    counts the triangle: 2 A (A+1) C FP32 operations, (A (A+1) + 2 A C) x 4
    bytes."""
    import torch

    from juliachem_jl_tpu_torch.models import linalg
    from juliachem_jl_tpu_torch.ops import kernels

    C = linalg.fold_chunk(A)
    gen = torch.Generator(device=dev).manual_seed(4)
    M = torch.randn((A, A), dtype=torch.float64, device=dev,
                    generator=gen).tril_() / A ** 0.5
    B = torch.randn((A, C + 64), dtype=torch.float32, device=dev,
                    generator=gen)
    X = B[:, 32:32 + C]
    Mh = M.float()
    Ml = (M - Mh.double()).float()
    n0 = kernels.launches["split_fold"]
    got = linalg.split_fold(Mh, Ml, X, lower=True)
    torch.cuda.synchronize()
    check(kernels.launches["split_fold"] == n0 + 1,
          "K8 comparison did not launch the kernel")
    plain = linalg.split_fold_plain(Mh, Ml, X)
    bound = 4 * A ** 0.5 * 2.0 ** -24 * ((Mh.abs() + Ml.abs()).double()
                                         @ X.abs().double())
    d_plain = (got - plain).double().abs()
    d_exact = (got.double() - (Mh.double() + Ml.double()) @ X.double()).abs()
    r_plain = float((d_plain / bound).max())
    r_exact = float((d_exact / bound).max())
    err = float(d_plain.max())
    del plain, bound, d_plain, d_exact
    check(r_plain <= 1.0 and r_exact <= 1.0,
          f"K8: error / gate {r_plain:.3e} (plain), {r_exact:.3e} (f64)")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ms = cuda_ms(lambda: linalg.split_fold(Mh, Ml, X, lower=True))
        plain_ms = cuda_ms(lambda: linalg.split_fold_plain(Mh, Ml, X))
        library_ms = cuda_ms(lambda: torch.add(torch.mm(Mh, X),
                                               torch.mm(Ml, X)))
        f64_ms = cuda_ms(lambda: (M @ X.double()).float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    b = bound_of(4.0 * (A * (A + 1) + 2 * A * C), 2.0 * A * (A + 1) * C,
                 PEAK_F32_OPS_S)
    print(f"{tag} K8 split_fold at the {label} fold, A={A} C={C}: max "
          f"|K8 - plain| {err:.3e}, "
          f"largest error / gate {max(r_plain, r_exact):.3e} (gate 4 sqrt(A) "
          f"2^-24 (|Mh|+|Ml|)|X|, elementwise); kernel {ms:.3f} ms, plain "
          f"torch {plain_ms:.3f} ms, library (2 SGEMM + add, TF32 off) "
          f"{library_ms:.3f} ms, f64 fold (DGEMM + f32 store) {f64_ms:.3f} "
          f"ms, bound {b['bound_ms']:.3f} ms ({b['bound_by']})", flush=True)
    return {"name": "split_fold", "route": "cuda",
            "source": "juliachem_jl_tpu_torch/csrc/split_fold.cu",
            "replaces": "juliachem_jl_tpu/models/linalg.py:57",
            "shapes": [A, A, C], "at": label, "max_abs_err": err,
            "max_err_over_gate": max(r_plain, r_exact), "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "two torch.mm (cuBLAS SGEMM, TF32 off) and the add",
            "f64_fold_ms": f64_ms, **b}


def k2_block(dev, bsets, opts, k: int | None = None,
             qc: int | None = None) -> dict:
    """K2's inputs at a system's packed shapes: its real screen
    (Schwarz-screened col_map, whose dead 16 x 64 tiles K2 skips), one
    Q-block of ``qc`` fitted aux rows (default all of them) of random f64
    B with a zero trash column, a random f64 factor of ``k`` columns
    (default the occupied count), the live-slab list, the count of live
    (m, n) entries and a line that names the shapes."""
    import torch

    from juliachem_jl_tpu_torch.models.df import screened_pair_blocks
    from juliachem_jl_tpu_torch.models.df_screened import (
        build_packed_screen, fitted_rows, k2_slabs)
    from juliachem_jl_tpu_torch.ops import eri3c

    prim, aux = bsets.primary, bsets.auxiliary
    metric_max = float(torch.diagonal(eri3c.two_center_metric(aux, dev)).max())
    screen = build_packed_screen(prim, screened_pair_blocks(
        prim, opts.df_screening_sigma, metric_max, dev))
    qc = qc or fitted_rows(aux, opts)
    nbf, k = prim.nbf, k or prim.nels // 2
    gen = torch.Generator(device=dev).manual_seed(0)
    Bc = torch.randn((qc, screen.npq + 1), dtype=torch.float64, device=dev,
                     generator=gen)
    Bc[:, -1] = 0.0
    C = torch.randn((nbf, k), dtype=torch.float64, device=dev, generator=gen)
    col_map = torch.as_tensor(screen.col_map, device=dev).to(torch.int32)
    ptr, idx = k2_slabs(screen.col_map, nbf, screen.npq)
    slabs = (torch.as_tensor(ptr, device=dev), torch.as_tensor(idx, device=dev))
    n_slabs = -(-nbf // 16) * (len(ptr) - 1)
    return {"Bc": Bc, "C": C, "col_map": col_map, "slabs": slabs,
            "npq": screen.npq, "nbf": nbf, "k": k, "qc": qc,
            "live": int((col_map != screen.npq).sum()),
            "live_slabs": len(idx), "n_slabs": n_slabs,
            "shapes": [qc, screen.npq, nbf, k],
            "what": f"Qc={qc} npq={screen.npq} nbf={nbf} k={k}, live slabs "
                    f"{len(idx)} of {n_slabs}"}


def k2_f32_bound(blk: dict) -> dict:
    """The f32 instance's bound: f32 words of B, C and W and col_map moved
    once, one FP32 FMA per (q, i, live (m, n)) entry."""
    qc, k, nbf = blk["qc"], blk["k"], blk["nbf"]
    return bound_of(4.0 * blk["Bc"].numel() + 4.0 * blk["col_map"].numel()
                    + 4.0 * blk["C"].numel() + 4.0 * qc * k * nbf,
                    2.0 * qc * blk["live"] * k, PEAK_F32_OPS_S)


def check_k2(tag: str, dev, bsets, opts, label: str = "benzene_2_water",
             k: int | None = None,
             qc: int | None = None) -> tuple[dict, dict, dict]:
    """K2 at a system's packed shapes (``k2_block``): the f64 instance and
    the f32 instance (FP32 FMA body), each held to the plain version on all
    ``qc`` rows (1e-12 and 1e-5 relative), and the f32-B instance (f32 B,
    f64 C and W) held bit for bit to the f64 instance on the upcast block.
    Returns the kernel line entries of the f64, f32 and f32-B instances;
    the f32 one carries the f64 instance's time on the same block.  The
    recorded time of the FMA body the f32 instance replaced
    (``K2_F32_RECORDED``) is printed on a line of its own."""
    import torch

    from juliachem_jl_tpu_torch.models.df_screened import (
        df_gather_w, df_gather_w_plain)
    from juliachem_jl_tpu_torch.ops import kernels

    blk = k2_block(dev, bsets, opts, k, qc)
    Bc, C, col_map, slabs = blk["Bc"], blk["C"], blk["col_map"], blk["slabs"]
    qc, k, nbf = blk["qc"], blk["k"], blk["nbf"]
    what = f"{label} {blk['what']}"
    res = {}
    for dt, bound, name in ((torch.float64, 1e-12, "df_gather_w"),
                            (torch.float32, 1e-5, "df_gather_w_f32")):
        B_, C_ = Bc.to(dt), C.to(dt)
        n0 = kernels.launches[name]
        got = df_gather_w(B_, col_map, C_, slabs)
        check(kernels.launches[name] == n0 + 1,
              f"K2 comparison did not launch {name}")
        ref = df_gather_w_plain(B_, col_map, C_)
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        del got, ref
        check(rel <= bound, f"K2 {name} at {label}: relative error {rel:.3e} "
              f"> {bound}")
        ms = cuda_ms(lambda: df_gather_w(B_, col_map, C_, slabs))
        plain = cuda_ms(lambda: df_gather_w_plain(B_, col_map, C_))
        res[name] = (err, rel, ms, plain)
        print(f"{tag} K2 {name} {what}: max abs err {err:.3e}, rel "
              f"{rel:.3e} (bound {bound}); kernel {ms:.3f} ms, plain torch "
              f"(tile + einsum) {plain:.3f} ms", flush=True)
        del B_, C_
    common = {"route": "cuda",
              "source": "juliachem_jl_tpu_torch/csrc/df_gather_w.cu",
              "replaces": "juliachem_jl_tpu/models/df_screened.py:303",
              "at": label, "shapes": blk["shapes"],
              "live_slabs": blk["live_slabs"], "slabs": blk["n_slabs"],
              "library_ms": None}
    # bound (f64): B, col_map and C read once, W written once; one FMA per
    # (q, i, live (m, n)) entry
    b = bound_of(8.0 * Bc.numel() + 4.0 * col_map.numel() + 8.0 * C.numel()
                 + 8.0 * qc * k * nbf, 2.0 * qc * blk["live"] * k)
    err, rel, ms, plain = res["df_gather_w"]
    k2 = {"name": "df_gather_w", **common, "max_abs_err": err,
          "max_rel_err": rel, "ms": ms, "plain_ms": plain, **b}
    b_f32 = k2_f32_bound(blk)
    err, rel, ms32, plain = res["df_gather_w_f32"]
    k2f = {"name": "df_gather_w_f32", **common, "max_abs_err": err,
           "max_rel_err": rel, "ms": ms32, "plain_ms": plain, **b_f32,
           "f64_ms": ms, "over_f64": ms32 / ms}
    print(f"{tag} K2 {label}: f64 bound {b['bound_ms']:.3f} ms "
          f"({b['bound_by']}); f32 (FP32 FMA, {kernels.K2F_NQ} rows q x "
          f"{kernels.K2F_KT} orbitals a block, {kernels.K2F_STAGES} stages) "
          f"{ms32:.3f} ms, bound {b_f32['bound_ms']:.3f} ms "
          f"({b_f32['bound_by']}): {ms32 / b_f32['bound_ms']:.2f}x it, "
          f"{ms32 / ms:.3f}x the f64 instance's {ms:.3f} ms on the same "
          f"block", flush=True)
    if label in K2_F32_RECORDED:
        print(f"{tag} K2 df_gather_w_f32 {label}: the FMA body it replaced, "
              f"recorded, not measured in this run: "
              f"{K2_F32_RECORDED[label]}", flush=True)
    # the f32-B instance (f64 iterations on an f32 B): bit for bit the f64
    # instance on the upcast block
    B32 = Bc.float()
    del Bc
    n0 = kernels.launches["df_gather_w_f32b"]
    got = df_gather_w(B32, col_map, C, slabs)
    check(kernels.launches["df_gather_w_f32b"] == n0 + 1,
          "K2 f32-B comparison did not launch the kernel")
    differ = int((got != df_gather_w(B32.double(), col_map, C, slabs)).sum())
    check(differ == 0, f"K2 f32-B at {label}: {differ} elements differ from "
          "the f64 instance on Bc.double()")
    err32 = float((got - df_gather_w_plain(B32, col_map, C)).abs().max())
    del got
    ms32 = cuda_ms(lambda: df_gather_w(B32, col_map, C, slabs))
    plain32 = cuda_ms(lambda: df_gather_w_plain(B32, col_map, C))
    b32 = bound_of(4.0 * B32.numel() + 4.0 * col_map.numel()
                   + 8.0 * C.numel() + 8.0 * qc * k * nbf,
                   2.0 * qc * blk["live"] * k)
    print(f"{tag} K2 df_gather_w_f32b (f32 B, f64 C and W) {what}: 0 "
          f"elements off the f64 instance on Bc.double() (bit for bit); max "
          f"abs err vs plain {err32:.3e}; kernel {ms32:.3f} ms, plain torch "
          f"{plain32:.3f} ms, bound {b32['bound_ms']:.3f} ms "
          f"({b32['bound_by']})", flush=True)
    k2b = {"name": "df_gather_w_f32b", **common, "max_abs_err": err32,
           "elements_off_f64": differ, "ms": ms32, "plain_ms": plain32,
           **b32}
    return k2, k2f, k2b


# K2's and K7's DMMA instances (mangled-name fragments of csrc/'s
# templates) and the kernel each serves
DMMA_INSTANCES = {
    "df_gather_w": "df_gather_w_dmmaIdE",
    "df_gather_w_f32b": "df_gather_w_dmmaIfE",
    "e2_rmp2": "mp2_e2_pair_kernelILi0EE",
    "e2_ss": "mp2_e2_pair_kernelILi1EE",
    "e2_os": "mp2_e2_os_kernel",
}
# K2's f32 instance: FP32 FMA, no tensor-core instruction of any type (an
# HMMA would be TF32, not the JAX package's f32 product)
K2_F32_KERNEL = "df_gather_w_f32_kernel"


def k2_f32_tile(registers: int | None, tile=None) -> dict:
    """K2's f32 instance at ``tile`` (NQ, KT, stages; default
    ops/kernels.py's K2F_*): threads and shared-memory bytes a block as
    csrc/df_gather_w.cu computes them, and, at ``registers`` a thread
    (ptxas), the blocks an SM of card 0 holds: the least that its register
    file (allocated 256 a warp), its shared memory (1 KiB reserved a
    block), its threads and 32 blocks allow."""
    import torch

    from juliachem_jl_tpu_torch.ops import kernels

    nq, kt, stages = tile or (kernels.K2F_NQ, kernels.K2F_KT,
                              kernels.K2F_STAGES)
    sm, tn = kernels.K2_SLAB_M, kernels.K2_TILE_N
    threads = kt // 8 * (tn // 4)
    smem = 4 * stages * (nq * sm * (tn + 4) + sm * (kt + 4))
    out = {"NQ": nq, "KT": kt, "stages": stages, "threads": threads,
           "smem_bytes": smem, "registers": registers, "blocks_per_sm": None}
    if registers:
        p = torch.cuda.get_device_properties(0)
        regs = getattr(p, "regs_per_multiprocessor", 65536)
        smem_sm = getattr(p, "shared_memory_per_multiprocessor", 233472)
        max_threads = getattr(p, "max_threads_per_multi_processor", 2048)
        warp_regs = -(-registers * 32 // 256) * 256
        out["blocks_per_sm"] = min(
            regs // warp_regs // (threads // 32), smem_sm // (smem + 1024),
            max_threads // threads, 32)
    return out


def sass_opcode(line: str) -> str | None:
    """The opcode of one instruction line of ``cuobjdump -sass`` (its
    modifiers and predicate dropped: "HMMA", "DMMA", "FFMA", ...), or
    None for any other line."""
    m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                 line)
    return m.group(1) if m else None


def parse_sass(lines, checked, per_fn: dict) -> None:
    """Count, into ``per_fn``, the DMMA, DFMA, SHFL, FFMA, LDGSTS and
    tensor-core (*MMA) instructions of each function of a ``cuobjdump
    -sass`` listing whose name holds one of the fragments ``checked``."""
    fn = None
    for ln in lines:
        if "Function :" in ln:
            fn = ln.split("Function :", 1)[1].strip()
            if not any(frag in fn for frag in checked):
                fn = None
                continue
            per_fn[fn] = {"DMMA": 0, "MMA": 0, "FFMA": 0, "LDGSTS": 0,
                          "DFMA": 0, "SHFL": 0}
        elif fn is not None and (op := sass_opcode(ln)):
            c = per_fn[fn]
            c["DMMA"] += op == "DMMA"
            c["DFMA"] += op == "DFMA"
            c["SHFL"] += op == "SHFL"
            c["MMA"] += op.endswith("MMA")
            c["FFMA"] += op == "FFMA"
            c["LDGSTS"] += op == "LDGSTS"


def sass_listings(so: str, cuobjdump: str, tmp: Path) -> tuple[list, str]:
    """``cuobjdump -sass`` of the library into files under ``tmp``: one
    process a cubin of it (``-xelf all``: one a source with device code),
    all at once, as one process over the whole library took ~160-205 s;
    the whole library in one process where the extraction does not give
    every cubin ``-lelf`` lists.  Returns the files and the route taken."""
    listed = subprocess.run([cuobjdump, "-lelf", so], capture_output=True,
                            text=True, timeout=300)
    n_elf = sum("ELF file" in ln for ln in listed.stdout.splitlines())
    ext = subprocess.run([cuobjdump, "-xelf", "all", so], cwd=tmp,
                         capture_output=True, text=True, timeout=300)
    cubins = sorted(tmp.glob("*.cubin"))
    if ext.returncode != 0 or not cubins or len(cubins) != n_elf:
        cubins = []   # every listed cubin on its own file, or none
    how = (f"{len(cubins)} cubins in parallel" if cubins
           else "the whole library in one process")
    jobs = [(c, c.with_suffix(".sass")) for c in cubins] or [
        (Path(so), tmp / "library.sass")]
    procs = []
    try:
        for src, out in jobs:
            fout, ferr = open(out, "w"), tempfile.TemporaryFile("w+")
            procs.append((src, out, fout, ferr, subprocess.Popen(
                [cuobjdump, "-sass", str(src)], stdout=fout, stderr=ferr,
                text=True)))
        for src, _, _, ferr, proc in procs:
            rc = proc.wait(timeout=600)
            ferr.seek(0)
            check(rc == 0, f"cuobjdump -sass {src.name} failed: "
                  f"{ferr.read()[-2000:]}")
    finally:
        for _, _, fout, ferr, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            fout.close()
            ferr.close()
    return [out for _, out, *_ in procs], how


def check_sass(tag: str, so: str, cuobjdump: str) -> dict:
    """DMMA instructions in the SASS of each K2/K7 tensor-core instance of
    the built library (``cuobjdump -sass``; fails if an instance is missing
    or has none), of each K4/K5 block-route instance (one a class pair
    of the route table and kernel) and of each instance of K1's T1 body
    (one a class of its table); cp.async copies (LDGSTS) in each instance
    of K6's block route (one a class pair of its table); FFMA and no
    tensor-core instruction
    (an opcode ending in MMA: HMMA, HGMMA, DMMA, IMMA, ...) in K2's f32
    instance, and each instance's registers a thread as ptxas reported
    them in the build."""
    from juliachem_jl_tpu_torch.ops import kernels

    # only the functions checked below are parsed (the library holds ~500
    # instances)
    checked = (*DMMA_INSTANCES.values(), K2_F32_KERNEL, "eri4c_block_kernel",
               "eri4c_jk_block_kernel", "eri3c_block_kernel",
               "digest_jk_block_kernel", "stv_kernel")
    t0 = time.perf_counter()
    per_fn = {}
    with tempfile.TemporaryDirectory() as tmp:
        files, how = sass_listings(so, cuobjdump, Path(tmp))
        for path in files:
            with open(path) as f:
                parse_sass(f, checked, per_fn)
    print(f"{tag} SASS ({how}) read and parsed in "
          f"{time.perf_counter() - t0:.1f} s ({len(per_fn)} functions "
          "checked)", flush=True)

    def one(inst, frag):
        fns = [f for f in per_fn if frag in f]
        check(len(fns) == 1, f"SASS: {len(fns)} functions match {inst}")
        return per_fn[fns[0]]

    counts = {inst: one(inst, frag)["DMMA"]
              for inst, frag in DMMA_INSTANCES.items()}
    print(f"{tag} SASS DMMA instructions per instance: " + ", ".join(
        f"{k} {v}" for k, v in counts.items()), flush=True)
    check(all(v > 0 for v in counts.values()),
          "SASS: a K2/K7 tensor-core instance has no DMMA instruction")
    # K4/K5's block-route instances: one a class pair of the route table
    # and kernel, each with DMMA instructions
    from juliachem_jl_tpu_torch.ops import eri

    n_block = sum(kernels.eri4c_route(*bra, *ket) == "block"
                  for i, bra in enumerate(eri.PAIR_CLASSES)
                  for ket in eri.PAIR_CLASSES[i:])
    block_fns = {f: v["DMMA"] for f, v in per_fn.items()
                 if "eri4c_block_kernel" in f or "eri4c_jk_block_kernel" in f}
    print(f"{tag} SASS of K4/K5's block route: {len(block_fns)} instances "
          f"(the table has {n_block} class pairs), DMMA instructions "
          f"{min(block_fns.values(), default=0)}-"
          f"{max(block_fns.values(), default=0)} an instance", flush=True)
    check(len(block_fns) == 2 * n_block, "SASS: K4/K5's block-route "
          "instances are not one a class pair of the table and kernel")
    check(all(v > 0 for v in block_fns.values()),
          "SASS: a K4/K5 block-route instance has no DMMA instruction")
    # K1's T1 body, one instance a class of its table, each with DMMA (both
    # products); K6's block route, one a class pair of its table, each
    # copying its slabs by cp.async (LDGSTS)
    t1_fns = {}
    for f, v in per_fn.items():
        m = re.search(r"eri3c_block_kernelILi(\d)ELi(\d)ELi(\d)E", f)
        if m and tuple(map(int, m.groups())) in kernels.ERI3C_T1:
            t1_fns[f] = v["DMMA"]
    k6_fns = {f: v["LDGSTS"] for f, v in per_fn.items()
              if "digest_jk_block_kernel" in f}
    print(f"{tag} SASS of K1's T1 body: {len(t1_fns)} instances (the table "
          f"has {len(kernels.ERI3C_T1)}), DMMA "
          f"{min(t1_fns.values(), default=0)}-"
          f"{max(t1_fns.values(), default=0)} an instance; K6's block route: "
          f"{len(k6_fns)} instances (the table has "
          f"{len(kernels.DIGEST_BLOCK)}), LDGSTS "
          f"{min(k6_fns.values(), default=0)}-"
          f"{max(k6_fns.values(), default=0)} an instance", flush=True)
    check(len(t1_fns) == len(kernels.ERI3C_T1)
          and all(v > 0 for v in t1_fns.values()),
          "SASS: K1's T1-body instances are not one a class of the table, "
          "each with DMMA")
    check(len(k6_fns) == len(kernels.DIGEST_BLOCK)
          and all(v > 0 for v in k6_fns.values()),
          "SASS: K6's block-route instances are not one a class pair of the "
          "table, each with cp.async copies")
    # K9: one instance a class, each with DFMA (Boys, R, the contraction)
    # and the group's shuffles
    stv_fns = {f: v for f, v in per_fn.items() if "stv_kernel" in f}
    print(f"{tag} SASS of K9: {len(stv_fns)} instances (15 classes), DFMA "
          f"{min((v['DFMA'] for v in stv_fns.values()), default=0)}-"
          f"{max((v['DFMA'] for v in stv_fns.values()), default=0)}, SHFL "
          f"{min((v['SHFL'] for v in stv_fns.values()), default=0)}-"
          f"{max((v['SHFL'] for v in stv_fns.values()), default=0)} an "
          "instance", flush=True)
    check(len(stv_fns) == 15
          and all(v["DFMA"] > 0 and v["SHFL"] > 0 for v in stv_fns.values()),
          "SASS: K9's instances are not one a class, each with DFMA and "
          "SHFL")
    f32 = one("df_gather_w_f32", K2_F32_KERNEL)
    print(f"{tag} SASS of K2's f32 instance: FFMA {f32['FFMA']}, tensor-core "
          f"(*MMA) {f32['MMA']}", flush=True)
    check(f32["FFMA"] > 0 and f32["MMA"] == 0, "SASS: K2's f32 instance "
          "lacks FFMA or holds a tensor-core instruction")
    # registers a thread, from ptxas -v in this process's build log
    regs, fn = {}, None
    for ln in kernels.build_info.get("log", "").splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif fn is not None and "Used" in ln and "registers" in ln:
            regs[fn] = int(ln.split("Used", 1)[1].split()[0])
    frags = {**DMMA_INSTANCES, "df_gather_w_f32": K2_F32_KERNEL}
    used = {inst: next((r for f, r in regs.items() if frag in f), None)
            for inst, frag in frags.items()}
    print(f"{tag} registers a thread (ptxas): " + ", ".join(
        f"{k} {'not in this build log' if v is None else v}"
        for k, v in used.items()), flush=True)
    tile = k2_f32_tile(used["df_gather_w_f32"])
    print(f"{tag} K2's f32 instance: {tile['NQ']} rows q x {tile['KT']} "
          f"orbitals a block, {tile['stages']} stages, {tile['threads']} "
          f"threads, {tile['smem_bytes']} B of shared memory, "
          f"{tile['blocks_per_sm'] or 'unknown'} blocks an SM", flush=True)
    return {"dmma": counts, "df_gather_w_f32": {**f32, **tile},
            "registers": used, "eri4c_block_dmma": block_fns,
            "stv_kernel": stv_fns}


def ptxas_instances(pat, nidx: int) -> dict:
    """Per kernel instance whose mangled name matches ``pat`` (groups: the
    kernel, then nidx class indices), as ptxas reported it in this
    process's build: registers a thread, stack frame and spill bytes."""
    from juliachem_jl_tpu_torch.ops import kernels

    per, cur = {}, None
    for ln in kernels.build_info.get("log", "").splitlines():
        m = pat.search(ln)
        if "Compiling entry function" in ln:
            cur = None
            if m:
                cur = per.setdefault(m.group(1), {}).setdefault(
                    "".join(m.group(*range(2, 2 + nidx))), {})
        elif cur is not None and "bytes stack frame" in ln:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            cur.update(stack=nums[0], spill_stores=nums[1],
                       spill_loads=nums[2])
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur["registers"] = int(ln.split("Used", 1)[1].split()[0])
    return {kern: instance_summary(cls) for kern, cls in per.items()}


def instance_summary(cls: dict) -> dict:
    """A kernel's instances (class -> ptxas's registers, stack, spills):
    their count, register range, largest stack and the spilling ones."""
    regs = [v.get("registers", 0) for v in cls.values()]
    return {"instances": len(cls), "registers_min": min(regs),
            "registers_max": max(regs),
            "stack_max": max(v.get("stack", 0) for v in cls.values()),
            "spilling": sorted(k for k, v in cls.items()
                               if v.get("spill_stores", 0)),
            "classes": cls}


def fmt_instances(out: dict) -> str:
    return "; ".join(
        f"{k} {v['instances']} instances, {v['registers_min']}-"
        f"{v['registers_max']} registers, stack frame up to {v['stack_max']} "
        f"bytes, spilling {v['spilling'] or 'none'}" for k, v in out.items())


def eri4c_registers(tag: str) -> dict:
    """Per K4/K5/K6 instance, as ptxas reported it in this process's build:
    registers a thread, stack frame and spill bytes, by kernel (the lane,
    warp and block routes of K4, K5 and K6) and class."""
    out = ptxas_instances(re.compile(
        r"\d+(eri4c_jk_lane_kernel|eri4c_lane_kernel|eri4c_jk_kernel|"
        r"eri4c_kernel|eri4c_jk_block_kernel|eri4c_block_kernel|"
        r"digest_jk_lane_kernel|digest_jk_warp_kernel|digest_jk_block_kernel)"
        r"ILi(\d)ELi(\d)ELi(\d)ELi(\d)E"), 4)
    print(f"{tag} K4/K5/K6 instances (ptxas): " + fmt_instances(out),
          flush=True)
    return out


def eri3c_registers(tag: str) -> dict:
    """Per K1 instance (lane and block route), as ptxas reported it in
    this process's build, and the build wall of K1's sources (s from the
    start of the parallel build)."""
    from juliachem_jl_tpu_torch.ops import kernels

    out = ptxas_instances(re.compile(
        r"\d+(eri3c_lane_kernel|eri3c_block_kernel)"
        r"ILi(\d)ELi(\d)ELi(\d)E"), 3)
    walls = {k: v for k, v in kernels.build_info.get("per_source", {}).items()
             if k.startswith("eri3c")}
    print(f"{tag} K1 instances (ptxas): " + fmt_instances(out)
          + "; K1 sources built by " + ", ".join(
              f"{k} {v:.1f} s" for k, v in sorted(walls.items())), flush=True)
    return {"instances": out, "source_walls_s": walls}


def k1_primitive_counts(tag: str, dev, bsets, opts, label: str) -> dict:
    """(pair primitive pair, aux primitive) products of the system's full
    3-center build: those K1 walks (the live counts of its packing: the
    pair tables' meta and the aux tables' kq, ``k1_pairs``, ``aux_tables``),
    those of nonzero coefficients, and those a walk over each class padded
    to its largest contraction would take (K1 before it walked live
    primitives only).  K1 must walk the nonzero ones and no more."""
    import numpy as np
    import torch

    from juliachem_jl_tpu_torch.models.df import screened_pair_blocks
    from juliachem_jl_tpu_torch.ops import eri3c

    prim, aux = bsets.primary, bsets.auxiliary
    metric_max = float(torch.diagonal(eri3c.two_center_metric(aux, dev)).max())
    auxs = eri3c.aux_tables(aux, dev)
    walked_q = sum(int(a.kq.sum()) for a in auxs)
    padded = real = walked = 0
    for b in screened_pair_blocks(prim, opts.df_screening_sigma, metric_max,
                                  dev):
        kp = (np.count_nonzero(b.acoef, axis=1)
              * np.count_nonzero(b.bcoef, axis=1)).sum()
        meta = eri3c.k1_pairs(b, lambda ia, ib: ia, dev).table.meta
        walked += int((meta[:, 2].long() * meta[:, 3].long()).sum()) * walked_q
        for cl in aux.classes.values():
            padded += b.n * b.aexp.shape[1] * b.bexp.shape[1] * cl.nshell * cl.kmax
            real += int(kp) * int(np.count_nonzero(cl.coefs))
    print(f"{tag} K1 on the full 3-center build of {label}: {walked} "
          f"primitive products walked, {real} of nonzero coefficients "
          f"(walked / real {walked / real:.4f}); {padded} with the class "
          f"padding (real / padded {real / padded:.4f})", flush=True)
    check(walked == real, f"K1 walks {walked} primitive products of "
          f"{label}'s 3-center build, {real} are nonzero")
    return {"padded": padded, "real": real, "walked": walked}


def fourc_bounds(cases, nbf: int) -> dict:
    """(bytes, operations) of K4, K6, K5 list and K5 staircase over the
    4-center cases of ``check_4c``: tables, selections and blocks read or
    written once, D read and J, K written once; operations of the
    integrals (``eri_ops``) and of the six-image digestion (12 per block
    element)."""
    def table_bytes(x):
        return 8.0 * (x["bra"].pair.numel() + x["ket"].pair.numel()) + 4.0 * (
            x["bra"].meta.numel() + x["ket"].meta.numel())

    def blk(x):
        return (ncart(x["bra"].la) * ncart(x["bra"].lb)
                * ncart(x["ket"].la) * ncart(x["ket"].lb))

    ops_eri = sum(eri_ops(x["bra"].la, x["bra"].lb, x["ket"].la, x["ket"].lb,
                          x["n_prim"], x["n_series"], x["kb"], x["kk"])
                  for x in cases)
    ops_dig = sum(12.0 * x["m"] * blk(x) for x in cases)
    jk_bytes = 8.0 * 3 * nbf * nbf   # D read, J and K written
    io_blocks = sum(8.0 * x["m"] * blk(x) for x in cases)
    stair = (sum(table_bytes(x) + 8.0 * x["cum"].numel() for x in cases)
             + jk_bytes, ops_eri + ops_dig)
    return {
        "eri4c": (sum(table_bytes(x) + 16.0 * x["m"] for x in cases)
                  + io_blocks, ops_eri),
        "digest_jk": (io_blocks + sum(24.0 * x["m"] + 4.0 * (
            x["bra"].meta.numel() + x["ket"].meta.numel()) for x in cases)
            + jk_bytes, ops_dig),
        "eri4c_jk_list": (sum(table_bytes(x) + 24.0 * x["m"] for x in cases)
                          + jk_bytes, ops_eri + ops_dig),
        "eri4c_jk_stair": stair, "eri4c_jk_stair_t0": stair}


def fourc_runners(cases, I_ref, D) -> dict:
    """Kernel and plain runs of K4, K6, K5 list and K5 staircase over the
    cases (JK accumulated into the argument of the J/K ones)."""
    from juliachem_jl_tpu_torch.ops import eri, fock, fock_stream

    def k4(fn):
        return lambda _: [fn(x["bra"], x["ket"], x["r"], x["c"]) for x in cases]

    def each(fn):
        def run(JK):
            for i, x in enumerate(cases):
                fn(JK, i, x)
        return run

    return {
        "eri4c": (k4(eri.eri4c_class), k4(eri.eri4c_plain)),
        "digest_jk": (
            each(lambda JK, i, x: fock.digest_jk(JK, I_ref[i], x["bra"],
                                                 x["ket"], x["r"], x["c"],
                                                 x["w"], D)),
            each(lambda JK, i, x: fock.digest_plain(JK, I_ref[i], x["w"], D,
                                                    x["bra"], x["ket"],
                                                    x["r"], x["c"]))),
        "eri4c_jk_list": (
            each(lambda JK, i, x: fock.eri4c_jk(JK, x["bra"], x["ket"],
                                                x["r"], x["c"], x["w"], D)),
            each(lambda JK, i, x: fock.eri4c_jk_plain(
                JK, x["bra"], x["ket"], x["r"], x["c"], x["w"], D))),
        "eri4c_jk_stair": (
            each(lambda JK, i, x: fock_stream.eri4c_jk_staircase(
                JK, x["bra"], x["ket"], x["cum"], x["m"], x["same"], D)),
            each(lambda JK, i, x: fock_stream.eri4c_jk_staircase_plain(
                JK, x["bra"], x["ket"], x["cum"], x["m"], x["same"], D)))}


def class_pair_times(cases, D, nbf: int, geometry: dict) -> list[dict]:
    """K4, K6 (on the case's K4 blocks), K5 list and K5 staircase class
    pair by class pair over the cases of ``check_4c`` (each launch timed
    alone by CUDA events, the best of five after the checks' warm
    launches), each beside its bound (``fourc_bounds`` of the one case) and
    its route and blocks an SM (``geometry``; K6's from
    ``fock.digest_geometry``)."""
    import torch

    from juliachem_jl_tpu_torch.ops import eri, fock, fock_stream

    JK = torch.zeros((2, nbf, nbf), dtype=torch.float64, device=D.device)
    launch = {
        "eri4c": lambda x: eri.eri4c_class(x["bra"], x["ket"], x["r"],
                                           x["c"]),
        "digest_jk": lambda x: fock.digest_jk(JK, x["I"], x["bra"], x["ket"],
                                              x["r"], x["c"], x["w"], D),
        "eri4c_jk_list": lambda x: fock.eri4c_jk(JK, x["bra"], x["ket"],
                                                 x["r"], x["c"], x["w"], D),
        "eri4c_jk_stair": lambda x: fock_stream.eri4c_jk_staircase(
            JK, x["bra"], x["ket"], x["cum"], x["m"], x["same"], D)}
    rows = []
    for x in cases:
        cls = (x["bra"].la, x["bra"].lb, x["ket"].la, x["ket"].lb)
        b = fourc_bounds([x], nbf)
        k6 = fock.digest_geometry(x["bra"], x["ket"])
        row = {"cls": list(cls), "quartets": x["m"],
               "route": geometry[cls]["route"],
               "blocks_per_sm": geometry[cls]["blocks_per_sm"],
               "warps_per_sm": geometry[cls]["warps_per_sm"],
               "k6_route": k6["route"], "k6_blocks_per_sm": k6["blocks_per_sm"],
               "k6_warps_per_sm": k6["warps_per_sm"]}
        x = {**x, "I": eri.eri4c_class(x["bra"], x["ket"], x["r"], x["c"])}
        for label, fn in launch.items():
            best = None
            for _ in range(5):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                fn(x)
                ev[1].record()
                torch.cuda.synchronize()
                t = ev[0].elapsed_time(ev[1])
                best = t if best is None else min(best, t)
            row[label] = {"ms": best, **bound_of(*b[label])}
        del x
        rows.append(row)
    return rows


def fmt_class_row(v: dict, regs: dict) -> str:
    """One class pair of ``class_pair_times`` with its instances' ptxas
    report (``regs``: K4's and K5's kernel of its route)."""
    c = v["cls"]
    times = ", ".join(
        f"{k} {v[k]['ms']:.3f} ms (bound {v[k]['bound_ms']:.4f})"
        for k in ("eri4c", "digest_jk", "eri4c_jk_list", "eri4c_jk_stair")
        if k in v)
    inst = "".join(
        f"; {k} {r.get('registers', '?')} registers, spills "
        f"{r.get('spill_stores', '?')}/{r.get('spill_loads', '?')} B"
        for k, r in regs.items())
    k6 = (f"; K6 route {v['k6_route']}, {v['k6_blocks_per_sm']} blocks/SM "
          f"({v['k6_warps_per_sm']} warps)" if "k6_route" in v else "")
    return (f"({c[0]}{c[1]}|{c[2]}{c[3]}) route {v['route']}, {v['quartets']} "
            f"quartets: {times}{inst}; {v['blocks_per_sm']} blocks/SM "
            f"({v['warps_per_sm']} warps){k6}")


def check_4c(tag: str, dev, name: str, bsets, seed: int,
             largest=None, need_l: int | None = None,
             subset: int = SUBSET) -> dict:
    """K4, K6 and K5 (list and staircase mode) against their plain versions
    on the first ``subset`` quartets of every class pair of the system's Schwarz
    staircase, with one random symmetric D; per kernel: errors, CUDA-event
    times of all class pairs, the bound and the primitive-quartet counts;
    with ``largest`` (la, lb, lc, ld), that class pair timed alone too;
    with ``need_l``, only the class pairs that hold a shell of that angular
    momentum (and no full-build bound)."""
    import numpy as np
    import torch

    from juliachem_jl_tpu_torch.ops import eri, fock, fock_stream, kernels

    prim = bsets.primary
    sdf = fock_stream.StreamingDirectFock(prim, device=dev)
    nbf = prim.nbf
    gen = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn((nbf, nbf), dtype=torch.float64, device=dev, generator=gen)
    D = (X + X.T).contiguous()
    cases = []
    for cp in sdf.pairs:
        bra, ket = sdf.blocks[cp.bi].table, sdf.blocks[cp.ki].table
        if need_l is not None and need_l not in (bra.la, bra.lb, ket.la,
                                                 ket.lb):
            continue
        m = min(cp.N, subset)
        t = torch.arange(m, dtype=torch.int64, device=dev)
        r, c, w = fock_stream.decode_staircase(cp.cum, t, bra, ket, cp.same)
        kb = (bra.meta[r, 2] * bra.meta[r, 3]).double()
        kk = (ket.meta[c, 2] * ket.meta[c, 3]).double()
        n_prim, n_series = quartet_prims(bra, ket, r, c)
        check(n_prim == int((kb * kk).sum()),
              "live primitive quartets disagree with the tables' counts")
        cases.append(dict(bra=bra, ket=ket, r=r, c=c, w=w, m=m, cum=cp.cum,
                          same=cp.same, n_prim=n_prim, n_series=n_series,
                          kb=float(kb.sum()), kk=float(kk.sum()),
                          padded=m * bra.Ka * bra.Kb * ket.Ka * ket.Kb))

    def zeros():
        return torch.zeros((2, nbf, nbf), dtype=torch.float64, device=dev)

    # plain references, each computed once
    I_ref = [eri.eri4c_plain(x["bra"], x["ket"], x["r"], x["c"]) for x in cases]
    JK_ref = zeros()
    for x, I in zip(cases, I_ref):
        fock.digest_plain(JK_ref, I, x["w"], D, x["bra"], x["ket"], x["r"],
                          x["c"])
    scale = float(JK_ref.abs().max())
    out = {}
    n_prim = sum(x["n_prim"] for x in cases)
    n_series = sum(x["n_series"] for x in cases)
    padded = sum(x["padded"] for x in cases)
    nq = sum(x["m"] for x in cases)

    bounds = fourc_bounds(cases, nbf)
    runs = fourc_runners(cases, I_ref, D)

    # K4, within 1e-12 x the largest integral of the subset
    n0 = kernels.launches["eri4c"]
    worst = 0.0
    i_scale = max(float(I.abs().max()) for I in I_ref)
    for x, I in zip(cases, I_ref):
        got = eri.eri4c_class(x["bra"], x["ket"], x["r"], x["c"])
        err = float((got - I).abs().max())
        check(err <= 1e-12 * i_scale,
              f"K4 {name} class ({x['bra'].la}{x['bra'].lb}|{x['ket'].la}"
              f"{x['ket'].lb}): max abs err {err:.3e} > 1e-12 x {i_scale:.3e}")
        worst = max(worst, err)
    check(kernels.launches["eri4c"] - n0 == len(cases),
          "K4 comparison did not launch the kernel for every class")
    out["eri4c"] = dict(
        max_abs_err=worst, ms=cuda_ms(lambda: runs["eri4c"][0](None), reps=2),
        plain_ms=cuda_ms(lambda: runs["eri4c"][1](None), reps=2),
        **bound_of(*bounds["eri4c"]))

    # K6, K5 list, K5 staircase: JK against the plain digestion
    for label in ("digest_jk", "eri4c_jk_list", "eri4c_jk_stair"):
        run_kernel, run_plain = runs[label]
        n0 = kernels.launches[label]
        JK = zeros()
        run_kernel(JK)
        check(kernels.launches[label] - n0 == len(cases),
              f"{label} comparison did not launch the kernel for every class")
        err = float((JK - JK_ref).abs().max())
        check(err <= 1e-11 * scale,
              f"{label} {name}: max abs err {err:.3e} > 1e-11 x {scale:.3e}")
        out[label] = dict(max_abs_err=err,
                          ms=cuda_ms(lambda: run_kernel(zeros()), reps=2),
                          plain_ms=cuda_ms(lambda: run_plain(zeros()), reps=2),
                          **bound_of(*bounds[label]))
    for x in cases:   # K6's route of each class pair, held to the table
        compiled_k6_route(x["bra"], x["ket"])
    # K5 staircase over two t0 ranges of each class pair (what each rank of
    # the sharded staircase build launches), against the plain version over
    # the same ranges and the whole-range reference
    from juliachem_jl_tpu_torch.ops.fock_sharded import share

    def stair_t0(fn):
        def run(JK):
            for x in cases:
                for k in range(2):
                    s = share(x["m"], 2, k)
                    if s.stop > s.start:
                        fn(JK, x["bra"], x["ket"], x["cum"], s.stop - s.start,
                           x["same"], D, t0=s.start)
        return run

    n0 = kernels.launches["eri4c_jk_stair"]
    JK = zeros()
    stair_t0(fock_stream.eri4c_jk_staircase)(JK)
    n_ranges = sum(1 for x in cases for k in range(2)
                   if share(x["m"], 2, k).stop > share(x["m"], 2, k).start)
    check(kernels.launches["eri4c_jk_stair"] - n0 == n_ranges,
          "K5 t0 split did not launch the kernel for every range")
    JK_plain = zeros()
    stair_t0(fock_stream.eri4c_jk_staircase_plain)(JK_plain)
    err = max(float((JK - JK_ref).abs().max()),
              float((JK - JK_plain).abs().max()))
    check(err <= 1e-11 * scale, f"K5 t0 split {name}: max abs err {err:.3e} "
          f"> 1e-11 x {scale:.3e}")
    out["eri4c_jk_stair_t0"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: stair_t0(
            fock_stream.eri4c_jk_staircase)(zeros()), reps=2),
        plain_ms=cuda_ms(lambda: stair_t0(
            fock_stream.eri4c_jk_staircase_plain)(zeros()), reps=2),
        **bound_of(*bounds["eri4c_jk_stair_t0"]))
    split = add_splits([pipe_split(
        (x["bra"].la, x["bra"].lb, x["ket"].la, x["ket"].lb), x["n_prim"],
        x["n_series"], x["kb"], x["kk"], x["m"]) for x in cases])
    for label, v in out.items():
        v["pipes"] = split
        print(f"{tag} {label} {name}: {len(cases)} class pairs, {nq} quartets, "
              f"{n_prim:.4e} primitive quartets ({n_series:.4e} on the Boys "
              f"series; padded {padded:.4e}): max abs "
              f"err {v['max_abs_err']:.3e}; kernel {v['ms']:.3f} ms, plain "
              f"torch {v['plain_ms']:.3f} ms, bound {v['bound_ms']:.4f} ms "
              f"({v['bound_by']}); by pipe: {fmt_pipes(split)}", flush=True)
    if largest is not None:   # one class pair alone, checked above
        sel = [i for i, x in enumerate(cases)
               if (x["bra"].la, x["bra"].lb, x["ket"].la, x["ket"].lb)
               == tuple(largest)]
        check(bool(sel), f"{name}: no class pair {tuple(largest)}")
        sub = [cases[i] for i in sel]
        b_sub = fourc_bounds(sub, nbf)
        r_sub = fourc_runners(sub, [I_ref[i] for i in sel], D)
        for label in ("eri4c", "digest_jk", "eri4c_jk_list",
                      "eri4c_jk_stair"):
            run_kernel, run_plain = r_sub[label]
            v = dict(cls=list(largest), quartets=sum(x["m"] for x in sub),
                     ms=cuda_ms(lambda: run_kernel(zeros()), reps=2),
                     plain_ms=cuda_ms(lambda: run_plain(zeros()), reps=2),
                     **bound_of(*b_sub[label]))
            out[label]["largest_class"] = v
            print(f"{tag} {label} {name} class {tuple(largest)} alone: "
                  f"{v['quartets']} quartets, kernel {v['ms']:.3f} ms, plain "
                  f"torch {v['plain_ms']:.3f} ms, bound {v['bound_ms']:.5f} "
                  f"ms ({v['bound_by']})", flush=True)
    # K5's launch geometry of every class pair: route (as compiled, held to
    # the table of ops/kernels.py), ket tile, warps an SM (the occupancy
    # calculator); a class pair whose warp would pass kEri4cWarpCap runs in
    # ket tiles, two warps or more an SM
    geometry = {}
    for x in cases:
        cls = (x["bra"].la, x["bra"].lb, x["ket"].la, x["ket"].lb)
        compiled_route(x["bra"], x["ket"])
        geometry[cls] = eri.eri4c_geometry(x["bra"], x["ket"])
    warp = {c: g for c, g in geometry.items() if g["route"] == "warp"}
    block = {c: g for c, g in geometry.items() if g["route"] == "block"}
    tiled = {c: g for c, g in warp.items()
             if g["CT"] < ncart(c[2]) * ncart(c[3])}
    print(f"{tag} K5 geometry {name}: "
          f"{len(geometry) - len(warp) - len(block)} class pairs on the lane "
          f"route, {len(warp)} on the warp route (" + ", ".join(
              f"{c} CT {g['CT']} {g['warp_bytes'] / 1024:.1f} "
              f"KiB {g['warps_per_sm']} warps/SM"
              for c, g in sorted(warp.items()))
          + f"); in tiles: {sorted(tiled) or 'none'}; {len(block)} on the "
          "block route (" + ", ".join(
              f"{c} CT {g['CT']} AT {g['AT']} rounds {g['RB']}x{g['RK']} "
              f"{g['block_bytes'] / 1024:.1f} KiB {g['blocks_per_sm']} "
              "blocks/SM" for c, g in sorted(block.items())) + ")",
          flush=True)
    check(all(g["warps_per_sm"] >= 2 for g in tiled.values()),
          f"{name}: a tiled class pair holds fewer than 2 warps an SM")
    check(all(g["blocks_per_sm"] >= 1 and g["block_bytes"] <= 232448
              for g in block.values()),
          f"{name}: a block-route class pair passes 227 KB or fits no SM")
    if largest is not None:
        check(geometry[tuple(largest)]["warps_per_sm"] >= 2,
              f"{name}: {tuple(largest)} holds "
              f"{geometry[tuple(largest)]['warps_per_sm']} warps an SM")
    if need_l is not None:
        per_class = class_pair_times(cases, D, nbf, geometry)
        return {"system": name, "class_pairs": len(cases), "quartets": nq,
                "per_class": per_class,
                "primitive_quartets": n_prim,
                "series_primitive_quartets": n_series,
                "padded_primitive_quartets": padded, "jk_scale": scale,
                "kernels": out, "full": None,
                "geometry": {"".join(map(str, c)): g
                             for c, g in geometry.items()}}
    # the bound of one full build (every screened quartet) through K5
    ops_full = 0.0
    bytes_full = 8.0 * 3 * nbf * nbf   # D read, J and K written
    stair = staircase_prims(sdf)
    splits = []
    for x in stair:
        la, lb, lc, ld = x["bra"].la, x["bra"].lb, x["ket"].la, x["ket"].lb
        ops_full += eri_ops(la, lb, lc, ld, x["n_prim"], x["n_series"],
                            x["kb"], x["kk"])
        ops_full += 12.0 * x["N"] * ncart(la) * ncart(lb) * ncart(lc) * ncart(ld)
        bytes_full += 8.0 * (x["bra"].pair.numel() + x["ket"].pair.numel()
                             + x["ncum"])
        splits.append(pipe_split((la, lb, lc, ld), x["n_prim"], x["n_series"],
                                 x["kb"], x["kk"], x["N"]))
    full = {"quartets": sdf.n_quartets,
            "padded_primitive_quartets": sum(x["padded"] for x in stair),
            "primitive_quartets": sum(x["n_prim"] for x in stair),
            "series_primitive_quartets": sum(x["n_series"] for x in stair),
            **bound_of(bytes_full, ops_full), "pipes": add_splits(splits)}
    print(f"{tag} {name}: one full K5 build ({sdf.n_quartets} quartets) is "
          f"bound by {full['bound_ms']:.3f} ms ({full['bound_by']}: "
          f"{ops_full:.4e} operations); by pipe: "
          f"{fmt_pipes(full['pipes'])}", flush=True)
    return {"system": name, "class_pairs": len(cases), "quartets": nq,
            "primitive_quartets": n_prim, "series_primitive_quartets": n_series,
            "padded_primitive_quartets": padded,
            "jk_scale": scale, "kernels": out, "full": full,
            "geometry": {"".join(map(str, c)): g
                         for c, g in geometry.items()}}


def check_k7(tag: str, dev, bsets, rhf) -> dict:
    """K7 against its plain version at benzene_2_water's full width: mode
    rmp2 on the B_ia of the DF-RHF orbitals (47 occupied, 468 virtual);
    modes ss (beta) and os on numpy-seeded spin orbitals of the radical
    cation's occupations (47 alpha, 46 beta): the RHF orbitals, each spin
    turned by its own random orthogonal matrix, with the RHF orbital
    energies (beta virtuals shifted up by 0.1 Eh).  Per mode: |E_kernel -
    E_plain| (mode rmp2: the larger of its E2's and its opposite-spin
    part's), CUDA-event times of the kernel, the plain version and the
    library's (ia|jb) product alone (torch.matmul of the [no nv, A] x
    [A, no nv] views: the yardstick of a product-bound kernel; the port
    never calls it), and the bound: the product's operations the energy
    needs, all of them for os, the pairs (ia) <= (jb) for rmp2 and ss
    ((ia|jb) = (jb|ia) and D is symmetric)."""
    import numpy as np
    import torch

    from juliachem_jl_tpu_torch.models import df, mp2
    from juliachem_jl_tpu_torch.ops import kernels
    from juliachem_jl_tpu_torch.utils.options import create_scf_options

    prim = bsets.primary
    na = prim.nels // 2
    nb = na - 1
    B = df.build_B(prim, bsets.auxiliary, create_scf_options(SCF), dev)
    C, eps = rhf["MO Coeff"], rhf["MO Energies"]
    rng = np.random.default_rng(7)

    def turned(C):
        n = C.shape[1]   # MOs: nbf less the near-dependent combinations
        Q, _ = np.linalg.qr(np.eye(n) + 0.1 * rng.standard_normal((n, n)))
        return C @ torch.as_tensor(Q, device=dev)

    Ca, Cb = turned(C), turned(C)
    Bia = mp2.mo_b(B, C[:, :na], C[:, na:])
    Ba = mp2.mo_b(B, Ca[:, :na], Ca[:, na:])
    Bb = mp2.mo_b(B, Cb[:, :nb], Cb[:, nb:])
    A = B.shape[0]
    del B
    eo, ev = eps[:na].contiguous(), eps[na:].contiguous()
    eo_b, ev_b = eps[:nb].contiguous(), (eps[nb:] + 0.1).contiguous()
    cases = {
        "rmp2": ((Bia, eo, ev), (Bia, eo, ev), mp2.e2_rmp2,
                 mp2.e2_rmp2_plain, "juliachem_jl_tpu/models/mp2.py:41"),
        "ss": ((Bb, eo_b, ev_b), (Bb, eo_b, ev_b), mp2.e2_ss,
               mp2.e2_ss_plain, "juliachem_jl_tpu/models/mp2.py:158"),
        "os": ((Ba, eo, ev), (Bb, eo_b, ev_b), mp2.e2_os,
               mp2.e2_os_plain, "juliachem_jl_tpu/models/mp2.py:175"),
    }
    out = {}
    for mode, (x, y, kern, plain, rep) in cases.items():
        args = (x[0], y[0], x[1], x[2], y[1], y[2]) if mode == "os" else x
        name = f"e2_{mode}"
        n0 = kernels.launches[name]
        got = kern(*args)
        check(kernels.launches[name] == n0 + 1,
              f"K7 {mode} comparison did not launch the kernel")
        ref = plain(*args)
        # mode rmp2 gives (E2, E_os) from one launch
        got_os, ref_os = (got[1], ref[1]) if mode == "rmp2" else (None, None)
        got, ref = (got[0], ref[0]) if mode == "rmp2" else (got, ref)
        err = abs(got - ref)
        if mode == "rmp2":
            err = max(err, abs(got_os - ref_os))
        check(err <= E2_PLAIN_TOL,
              f"K7 {mode}: |E_kernel - E_plain| {err:.3e} > {E2_PLAIN_TOL}")
        Bx, By = x[0], y[0]
        _, nox, nvx = Bx.shape
        _, noy, nvy = By.shape
        ms = cuda_ms(lambda: kern(*args))
        plain_ms = cuda_ms(lambda: plain(*args))
        library_ms = cuda_ms(lambda: Bx.reshape(A, -1).T @ By.reshape(A, -1))
        nbytes = 8.0 * (Bx.numel() + (By.numel() if mode == "os" else 0)
                        + nox + nvx + (noy + nvy if mode == "os" else 0) + 1)
        pairs = (nox * nvx * (noy * nvy) if mode == "os"
                 else nox * nvx * (nox * nvx + 1) / 2)
        b = bound_of(nbytes, 2.0 * A * pairs)
        os_part = (f" (opposite-spin part: kernel {got_os:.12f}, plain "
                   f"{ref_os:.12f})" if mode == "rmp2" else "")
        print(f"{tag} K7 {name} A={A} no={nox}/{noy} nv={nvx}/{nvy}: E kernel "
              f"{got:.12f}, plain {ref:.12f}{os_part}, |diff| {err:.3e} (bound "
              f"{E2_PLAIN_TOL}); kernel {ms:.3f} ms, plain torch {plain_ms:.3f} "
              f"ms, library (ia|jb) product alone {library_ms:.3f} ms, bound "
              f"{b['bound_ms']:.3f} ms ({b['bound_by']})", flush=True)
        if mode == "rmp2":
            # K7 over the two occupied ranges the ranks of a 2-rank sharded
            # RI-MP2 sum (make_sharded_e2's i-blocks), held to the
            # whole-range launch and to the plain version over the ranges
            ranges = mp2.occupied_ranges(nox, 2)
            n0 = kernels.launches[name]
            split = np.sum([kern(Bx, x[1], x[2], r) for r in ranges], axis=0)
            check(kernels.launches[name] == n0 + len(ranges),
                  "K7 range split did not launch the kernel per range")
            split_plain = np.sum([plain(Bx, x[1], x[2], r) for r in ranges],
                                 axis=0)
            err_r = float(max(np.abs(split - np.array((got, got_os))).max(),
                              np.abs(split - split_plain).max()))
            check(float(np.abs(split - np.array((got, got_os))).max()) <= 1e-14,
                  "K7 range split: the ranges do not sum to the whole launch")
            check(float(np.abs(split - split_plain).max()) <= E2_PLAIN_TOL,
                  "K7 range split: off the plain version")
            out["e2_rmp2_range"] = {
                "name": "e2_rmp2_range", "route": "cuda",
                "source": "juliachem_jl_tpu_torch/csrc/mp2_e2.cu",
                "replaces": "juliachem_jl_tpu/models/mp2.py:66",
                "shapes": [A, nox, nvx, noy, nvy], "ranges": ranges,
                "max_abs_err": err_r,
                "ms": cuda_ms(lambda: [kern(Bx, x[1], x[2], r)
                                       for r in ranges]),
                "plain_ms": cuda_ms(lambda: [plain(Bx, x[1], x[2], r)
                                             for r in ranges]),
                "library_ms": library_ms,
                "library": "torch.matmul of the [no*nv, A] x [A, no*nv] "
                           "views: the (ia|jb) product alone", **b}
            print(f"{tag} K7 e2_rmp2 over the occupied ranges {ranges}: sum "
                  f"- whole launch {split - np.array((got, got_os))}, - plain "
                  f"{split - split_plain}; kernel "
                  f"{out['e2_rmp2_range']['ms']:.3f} ms, plain torch "
                  f"{out['e2_rmp2_range']['plain_ms']:.3f} ms", flush=True)
        out[name] = {"name": name, "route": "cuda",
                     "source": "juliachem_jl_tpu_torch/csrc/mp2_e2.cu",
                     "replaces": rep, "shapes": [A, nox, nvx, noy, nvy],
                     "energy": got, "plain_energy": ref, "max_abs_err": err,
                     **({"energy_opposite_spin": got_os,
                         "plain_energy_opposite_spin": ref_os}
                        if mode == "rmp2" else {}),
                     "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "library": "torch.matmul of the [no*nv, A] x [A, no*nv] "
                                "views: the (ia|jb) product alone",
                     **b}
    return out


# --------------------------------------------------------------- phases 4-5

def steady_mean(vals: list[float]) -> float:
    """bench.py's steady mean: drop values over 2x the median (>= 3 samples)."""
    import statistics

    if len(vals) >= 3:
        med = statistics.median(vals)
        vals = [v for v in vals if v <= 2.0 * med] or vals
    return sum(vals) / len(vals) if vals else float("nan")


def fock_stats(tm, iterations: int) -> dict:
    """Fock s/iter of a run's Timings, as bench.py reads them: the steady
    f64 mean (iteration 1 and the f32 phase left out), the f32 phase's
    mean, and the mean of the post-SCF ``fock_rep`` builds."""
    from juliachem_jl_tpu_torch.utils.timings import JCTC

    pref = JCTC.fock_time + "-"
    keys = sorted(int(k[len(pref):]) for k in tm.timings if k.startswith(pref))
    reps = [tm.timings[f"{pref}{i}"] for i in keys
            if f"fock_rep-{i}" in tm.timings]
    # after a DF guess the conventional loop rewrote fock_time-1..n; the
    # keys above n are the DF iterations' (or timing reps)
    iters = [i for i in keys if i <= iterations]
    f32 = {i for i in iters if f"fock_f32-{i}" in tm.timings}
    steady = iters[1:] if len(iters) > 2 else iters
    f64 = [tm.timings[f"{pref}{i}"] for i in steady if i not in f32]
    f32v = [tm.timings[f"{pref}{i}"] for i in steady if i in f32]
    # packed route: per-iteration split of the f64 build (the J/K pass of
    # V = B d, V B, K2 and W^T W; scatter of J and G = J - K/2)
    split = {k: steady_mean([tm.timings[f"{key}-{i}"] for i in steady
                             if i not in f32 and f"{key}-{i}" in tm.timings])
             for k, key in (("JK_pass", JCTC.K_time),
                            ("finalize", JCTC.J_time))}
    return {"fock_s_per_iter_f64_steady": steady_mean(f64),
            "f64_steady_iters": len(f64),
            "fock_s_first_iter": (tm.timings[f"{pref}{iters[0]}"] if iters
                                  else None),
            "fock_s_per_iter_f32_phase": steady_mean(f32v) if f32v else None,
            "f32_phase_iters": len(f32v), "fock_split_s": split,
            "fock_s_rep_mean": sum(reps) / len(reps) if reps else None,
            "fock_reps": len(reps)}


def cluster_input(name: str, extra: dict | None = None,
                  waters: int | None = None) -> dict:
    """A generated water cluster (juliachem_jl_tpu_torch/data/
    water_clusters.json), or its first ``waters`` waters, as a run_spec
    input: 6-31+G* / cc-pVTZ-JKFIT and the convergence keywords of W_SCF."""
    c = json.loads((ROOT / "juliachem_jl_tpu_torch" / "data" /
                    "water_clusters.json").read_text())[name]
    n = waters or c["n_waters"]
    return {"molecule": {"symbols": c["symbols"][:3 * n],
                         "geometry": c["geometry"][:9 * n],
                         "molecular_charge": 0},
            "driver": "energy",
            "model": {"method": "RHF", "basis": W_BASIS,
                      "auxiliary_basis": W_AUX},
            "keywords": {"scf": {**W_SCF, **(extra or {})}}}


def build_peak(jc, inp: dict) -> int:
    """Device bytes the packed builder's build of ``inp`` adds at its peak
    (3-center build, projection, fold, the builder): the peak memory is
    reset just before ``ScreenedDFFockBuilder.build`` and read after it,
    less what was allocated before.  Disk caches are left out of ``inp``."""
    import torch

    from juliachem_jl_tpu_torch.models.df_screened import ScreenedDFFockBuilder
    from juliachem_jl_tpu_torch.utils.options import create_scf_options

    spec = jc.io.parse_input(inp)
    bsets = jc.basis.run(jc.molecule.run(spec), spec.model)
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fb = ScreenedDFFockBuilder.build(bsets.primary, bsets.auxiliary,
                                     create_scf_options(spec.scf_keywords),
                                     dev)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    fb.finalize()
    del fb
    torch.cuda.empty_cache()
    return peak


def b_checksum(B) -> tuple[float, float]:
    """(sum, sum of squares) of B's elements in f64, 256 rows at a time: two
    numbers that tell one B from another (a cached B from the one built)."""
    s = sq = 0.0
    for r in range(0, B.shape[0], 256):
        sub = B[r:r + 256].double()
        s += float(sub.sum())
        sq += float((sub * sub).sum())
    return s, sq


def k_pass_split(sweeps: list[dict]) -> dict:
    """Per compute dtype, the mean ms of each phase of the packed K pass
    (``KPassSplit.ms()``: K2, W^T W, V B, upcast) over the sweeps after the
    first (the first SCF iteration's factor is SAD's signed one)."""
    out = {}
    for sw in sweeps[1:] or sweeps:
        acc = out.setdefault(sw["dtype"], {"sweeps": 0})
        acc["sweeps"] += 1
        for k, v in sw.items():
            if k != "dtype":
                acc[k] = acc.get(k, 0.0) + v
    for acc in out.values():
        for k in acc:
            if k != "sweeps":
                acc[k] /= acc["sweeps"]
    return out


def fmt_split(split: dict) -> str:
    return "; ".join(f"{dt} ({v['sweeps']} builds) " + ", ".join(
        f"{k} {x:.3f}" for k, x in v.items() if k != "sweeps")
        for dt, v in split.items())


def run_cluster(tag: str, jc, name: str, extra: dict, label: str,
                waters: int | None = None, measure_build: bool = False,
                gated: bool = True, k1_times: bool = False,
                checksum: bool = True, keep_density: bool = False,
                stv: bool = False) -> dict:
    """One DF-RHF run_spec of a water cluster on the card (peak device memory
    reset just before it); with ``measure_build``, first the peak of the
    packed builder's build alone (``build_peak``).  Returns the energy,
    iterations, B's bytes and checksum, the build's and the run's peak
    device memory, the setup phases, the Fock s/iter and which caches were
    read (from the port's notes on stderr, which are passed through), and
    the K pass of every build split by phase with CUDA events (K2, W^T W,
    V B, the f32 -> f64 row upcasts; ``KPassSplit``).  B's checksum is
    taken from the builder ``ScreenedDFFockBuilder.build`` returns, wrapped
    for this run only.  A run that is not ``gated`` is recorded whether it
    converges or not.  With ``k1_times``, K1's launches of run_spec's
    3-center build and metric timed by class (``K1Times``).  Also the
    builder's memory mode, the bytes of a B in host memory, and the device
    bytes run_spec's builder build added at its peak (``build_peak_inline``:
    the peak reset just before it).  ``checksum`` False skips B's checksum
    (a host B's is summed on the CPU); ``keep_density`` keeps the converged
    D as "density"; ``stv`` holds K9 to its plain version at the system's
    nuclei and adds K9's time over its classes beside its bound and the
    dipole integrals' wall (``stv_at``), none of it counted as the path's
    launches."""
    import contextlib
    import io

    import torch

    from juliachem_jl_tpu_torch.models.df_screened import (
        KPassSplit, ScreenedDFFockBuilder)
    from juliachem_jl_tpu_torch.utils.timings import JCTC

    dev = torch.device("cuda")
    peak_build = None
    if measure_build:
        nocache = {k: v for k, v in extra.items()
                   if k not in ("df_b_cache", "oei_cache", "checkpoint",
                                "restart")}
        peak_build = build_peak(jc, cluster_input(name, nocache, waters))
        # the path's launch counts start at run_spec, not at this build
        from juliachem_jl_tpu_torch.ops import kernels
        kernels.reset_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    notes = io.StringIO()
    sums = []
    build = ScreenedDFFockBuilder.__dict__["build"]

    built = {}

    def build_and_sum(cls, *args, **kwargs):
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fb = build.__func__(cls, *args, **kwargs)
        torch.cuda.synchronize(dev)
        built.update(peak=torch.cuda.max_memory_allocated(dev) - base,
                     mode=fb.mode, host_bytes=(0 if fb.B.is_cuda else
                                               fb.B.numel() * fb.B.element_size()))
        if checksum:
            sums.append(b_checksum(fb.B))
        return fb

    ScreenedDFFockBuilder.build = classmethod(build_and_sum)
    ScreenedDFFockBuilder.split = KPassSplit()
    t0 = time.perf_counter()
    timer = K1Times(bound=True) if k1_times else contextlib.nullcontext()
    try:
        with contextlib.redirect_stderr(notes), timer:
            out = jc.run_spec(jc.io.parse_input(cluster_input(name, extra,
                                                              waters)))
    finally:
        ScreenedDFFockBuilder.build = build
        sweeps = ScreenedDFFockBuilder.split.ms()
        ScreenedDFFockBuilder.split = None
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    sys.stderr.write(notes.getvalue())
    res = out["Energy"]
    tm = res["Timings"]
    nt = tm.non_timing_data
    setup = {k: tm.timings.get(key) for k, key in (
        ("two_center", JCTC.two_center_time),
        ("three_center", JCTC.three_center_time), ("B", JCTC.B_time),
        ("screening", JCTC.screening_time), ("H", JCTC.H_time),
        ("guess", JCTC.guess_time), ("host_alloc", "B_host_alloc_time"),
        ("builder_init", "builder_init_time"))}
    fmt = lambda v, f=".3f": "absent" if v is None else format(v, f)
    summary = {
        "system": label, "route": nt["fock_builder"],
        "converged": bool(res["Converged?"]),
        "iterations": int(res["Iterations"]), "energy": float(res["Energy"]),
        "nbf": out["Basis"].primary.nbf, "naux": out["Basis"].auxiliary.nbf,
        "B_shape": nt.get("B_shape"), "B_bytes": int(nt.get("B_bytes", 0)),
        "B_checksum": sums[-1] if sums else None,
        "build_peak_device_bytes": peak_build,
        "build_peak_inline_bytes": built.get("peak"),
        "B_mode": built.get("mode"), "host_B_bytes": built.get("host_bytes"),
        "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
        "setup_s": setup, **fock_stats(tm, int(res["Iterations"])),
        "k_pass_split_ms": k_pass_split(sweeps), "wall_s": wall,
        "loaded_B_cache": "loaded cached B" in notes.getvalue(),
        "loaded_S_T_V": "loaded cached S/T/V" in notes.getvalue(),
    }
    print(f"{tag} {label}: nbf {summary['nbf']}, naux {summary['naux']} "
          f"(Cartesian), B {summary['B_shape']} {summary['B_bytes'] / 1e9:.3f}"
          f" GB; converged {summary['converged']} in {summary['iterations']} "
          f"iterations, E = {summary['energy']:.10f} Eh; wall {wall:.2f} s; "
          f"build peak {fmt(peak_build and peak_build / 1e9)} GB, run peak "
          f"{summary['peak_device_bytes'] / 1e9:.3f} GB", flush=True)
    print(f"{tag} {label}: B {summary['B_mode']}, host B "
          f"{(summary['host_B_bytes'] or 0) / 1e9:.3f} GB, run_spec's build "
          f"peak {fmt(built.get('peak') and built['peak'] / 1e9)} GB",
          flush=True)
    print(f"{tag} {label}: setup s " + ", ".join(
        f"{k} {fmt(v)}" for k, v in setup.items())
        + f"; Fock f64 steady {fmt(summary['fock_s_per_iter_f64_steady'], '.4f')}"
        f" s/iter over {summary['f64_steady_iters']}, f32 phase "
        f"{fmt(summary['fock_s_per_iter_f32_phase'], '.4f')} s/iter over "
        f"{summary['f32_phase_iters']}, fock_rep mean "
        f"{fmt(summary['fock_s_rep_mean'], '.4f')} s over "
        f"{summary['fock_reps']}; f64 split s/iter " + ", ".join(
            f"{k} {v:.4f}" for k, v in summary["fock_split_s"].items()),
        flush=True)
    print(f"{tag} {label}: K pass split, ms per build (CUDA events): "
          + fmt_split(summary["k_pass_split_ms"]), flush=True)
    if k1_times:
        summary["k1_times"] = timer.result()
        print(f"{tag} {label}: K1 by CUDA events: "
              + fmt_k1_times(summary["k1_times"]), flush=True)
    check(summary["route"] == "ScreenedDFFockBuilder",
          f"{label}: route {summary['route']}")
    check(summary["converged"] or not gated, f"{label}: SCF did not converge")
    if stv:
        summary["stv"] = stv_at(tag, label, out["Basis"].primary,
                                out["Molecule"])
    if keep_density:
        summary["density"] = res["Density"]
    return summary


def g_input(name: str, golden: dict, extra: dict | None = None,
            scf: dict | None = None, aux: bool = True) -> dict:
    """``system_input`` in the g basis, read from its file through
    ``model.basis_file``."""
    inp = system_input(name, {**golden, "basis": G_BASIS}, extra, scf, aux)
    inp["model"]["basis_file"] = str(ROOT / G_BASIS_FILE)
    return inp


def w2_input(basis: str, basis_file: str | None = None) -> dict:
    """The first 2 waters of w32, conventional RHF from SAD (CONV_SCF), in
    ``basis`` (read from ``basis_file`` where given)."""
    w32 = json.loads((ROOT / "juliachem_jl_tpu_torch" / "data" /
                      "water_clusters.json").read_text())["w32"]
    model = {"method": "RHF", "basis": basis}
    if basis_file:
        model["basis_file"] = str(ROOT / basis_file)
    return {"molecule": {"symbols": w32["symbols"][:6],
                         "geometry": w32["geometry"][:18],
                         "molecular_charge": 0},
            "driver": "energy", "model": model,
            "keywords": {"scf": {**CONV_SCF, "guess": "sad"},
                         "prop": PROPS}}


def g_instances(tag: str, sass: dict) -> dict:
    """The g instances of K1 and K4/K5/K6 as ptxas reported them (route by
    kernel name, registers, stack, spills), printed and returned."""
    out = {}
    for kern, v in [*sass["eri4c"].items(),
                    *sass["eri3c"]["instances"].items()]:
        cls = {c: x for c, x in v["classes"].items()
               if "4" in (c if len(c) == 4 else c[:2])}
        if cls:
            out[kern] = instance_summary(cls)
    print(f"{tag} g instances (ptxas): " + fmt_instances(out), flush=True)
    return out


def run_system(tag: str, jc, name: str, golden: dict | None,
               ref: dict | None, route: str, extra: dict | None = None,
               conventional: bool = False, aux: bool = True,
               inp: dict | None = None, k1_times: bool = False) -> dict:
    """One run_spec to convergence, held to the JAX package's energy (ref)
    and to GAMESS (golden: DF within 1.5e-3 Eh, conventional RHF at
    1.49e-8 relative).  ``inp``: the run_spec input, in place of the one
    ``system_input`` makes from the golden (whose GAMESS energy is then
    for another basis: pass golden None).  With ``k1_times``, K1's launches
    of the run's 3-center builds and metric timed by class (``K1Times``)."""
    import contextlib

    import torch

    from juliachem_jl_tpu_torch.utils.timings import JCTC

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    if inp is None:
        inp = system_input(name, golden, extra,
                           CONV_SCF if conventional else SCF, aux)
    timer = K1Times(bound=True) if k1_times else contextlib.nullcontext()
    with timer:
        out = jc.run_spec(jc.io.parse_input(inp))
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    res = out["Energy"]
    tm = res["Timings"]
    E = float(res["Energy"])
    d_gms = E - golden["energy"] if golden else None
    d_ref = E - ref["energy"] if ref else None
    nt = tm.non_timing_data
    builder = nt["fock_builder"]
    stats = fock_stats(tm, int(res["Iterations"]))
    setup = {k: tm.timings.get(key, float("nan")) for k, key in (
        ("two_center", JCTC.two_center_time), ("three_center", JCTC.three_center_time),
        ("B", JCTC.B_time), ("screening", JCTC.screening_time),
        ("H", JCTC.H_time), ("guess", JCTC.guess_time),
        ("conventional_setup", "conventional_setup_time"))}
    peak = torch.cuda.max_memory_allocated(dev)
    summary = {
        "system": name, "route": builder, "incore": nt.get("incore"),
        "nbf": out["Basis"].primary.nbf,
        "df_guess_builder": nt.get("df_guess_builder"),
        "df_guess_iterations": nt.get("df_guess_iterations"),
        "converged": bool(res["Converged?"]),
        "iterations": int(res["Iterations"]), "energy": E,
        "minus_jax_reference": d_ref, "minus_gamess": d_gms,
        "setup_s": setup, **stats, "wall_s": wall,
        "peak_device_bytes": peak,
        "on_cuda": all(t.is_cuda for t in (res["Density"], res["Fock"],
                                           res["MO Coeff"], res["Overlap"])),
    }
    ref_txt = f", E - JAX = {d_ref:.3e}" if ref else ""
    gms_txt = f", E - GAMESS = {d_gms:.3e}" if golden else ""
    guess_txt = (f" after {summary['df_guess_iterations']} DF-guess iterations"
                 f" on {summary['df_guess_builder']}"
                 if summary["df_guess_builder"] else "")
    print(f"{tag} {name}: route {builder} (incore {summary['incore']}), "
          f"converged {summary['converged']} in {summary['iterations']} "
          f"iterations{guess_txt}, E = {E:.10f} Eh{ref_txt}{gms_txt}, nbf "
          f"{summary['nbf']}, wall {wall:.2f} s", flush=True)
    print(f"{tag} {name}: setup s " + ", ".join(
        f"{k} {v:.3f}" for k, v in setup.items()), flush=True)
    f32_txt = (f"; f32 phase {summary['fock_s_per_iter_f32_phase']:.5f} s/iter "
               f"over {summary['f32_phase_iters']} iters"
               if summary["f32_phase_iters"] else "; no f32 phase")
    print(f"{tag} {name}: Fock f64 steady {summary['fock_s_per_iter_f64_steady']:.5f}"
          f" s/iter over {summary['f64_steady_iters']} iters, first iteration "
          f"{summary['fock_s_first_iter']:.5f} s{f32_txt}; peak device memory "
          f"{peak / 1e9:.3f} GB", flush=True)
    if not math.isnan(stats["fock_split_s"]["JK_pass"]):  # packed builder
        print(f"{tag} {name}: f64 Fock split s/iter " + ", ".join(
            f"{k} {v:.5f}" for k, v in stats["fock_split_s"].items()),
            flush=True)
    if k1_times:
        summary["k1_times"] = timer.result()
        print(f"{tag} {name}: K1 by CUDA events: "
              + fmt_k1_times(summary["k1_times"]), flush=True)
    check(builder == route, f"{name}: route {builder}, expected {route}")
    check(summary["converged"], f"{name}: SCF did not converge")
    if ref:
        check(abs(d_ref) <= E_REF_TOL,
              f"{name}: |E - JAX| = {abs(d_ref):.3e} > {E_REF_TOL}")
    if golden:
        gms_tol = (E_GAMESS_REL * abs(golden["energy"]) if conventional
                   else E_GAMESS_TOL)
        check(abs(d_gms) <= gms_tol,
              f"{name}: |E - GAMESS| = {abs(d_gms):.3e} > {gms_tol:.3e}")
    check(summary["on_cuda"], f"{name}: SCF tensors are not on the card")
    summary.update(density=res["Density"], result=res, basis=out["Basis"])
    return summary


def run_open(tag: str, jc, name: str, golden: dict, method: str, charge: int,
             multiplicity: int, route: str, scf: dict, aux: bool = True,
             trajectory: bool = False) -> dict:
    """One UHF/ROHF run_spec to convergence on its expected route;
    trajectory: keep the SCF table (iteration, E, dE, D rms) that
    ``output=2`` prints and print every 20th row."""
    import contextlib
    import io

    import torch

    from juliachem_jl_tpu_torch.utils.timings import JCTC

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    inp = jc.io.parse_input(system_input(
        name, golden, scf=scf, aux=aux, method=method, charge=charge,
        multiplicity=multiplicity))
    table = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(table if trajectory else sys.stdout):
        out = jc.run_spec(inp, output=2 if trajectory else 0)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    rows = [[float(x) for x in f[:4]] for f in (
        ln.split() for ln in table.getvalue().splitlines())
        if len(f) >= 5 and f[0].isdigit()]
    res = out["Energy"]
    tm = res["Timings"]
    nt = tm.non_timing_data
    iters = int(res["Iterations"])
    fock = [tm.timings[f"{JCTC.fock_time}-{i}"] for i in range(1, iters + 1)]
    summary = {
        "system": f"{name} {method} charge {charge} multiplicity "
                  f"{multiplicity}",
        "route": nt["fock_builder"], "incore": nt.get("incore"),
        "converged": bool(res["Converged?"]), "iterations": iters,
        "energy": float(res["Energy"]), "S2": float(res["S2"]),
        "n_alpha": int(res["N Alpha"]), "n_beta": int(res["N Beta"]),
        "fock_s_per_iter_steady": steady_mean(fock[1:] if iters > 2 else fock),
        "fock_s_first_iter": fock[0] if fock else None, "wall_s": wall,
        "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
        "on_cuda": all(t.is_cuda for t in (res["Density"], res["Fock"],
                                           res["MO Coeff"], res["Overlap"])),
        "trajectory": rows,
    }
    for r in rows:
        if r[0] == 1 or r[0] % 20 == 0 or r[0] == rows[-1][0]:
            print(f"{tag} {summary['system']} iteration {int(r[0])}: E = "
                  f"{r[1]:.10f} Eh, dE {r[2]:.3e}, D rms {r[3]:.3e}",
                  flush=True)
    print(f"{tag} {summary['system']}: route {summary['route']} (incore "
          f"{summary['incore']}), converged {summary['converged']} in {iters} "
          f"iterations, E = {summary['energy']:.10f} Eh, S2 = "
          f"{summary['S2']:.6f}, Fock {summary['fock_s_per_iter_steady']:.5f} "
          f"s/iter, wall {wall:.2f} s, peak device memory "
          f"{summary['peak_device_bytes'] / 1e9:.3f} GB", flush=True)
    check(summary["route"] == route,
          f"{summary['system']}: route {summary['route']}, expected {route}")
    check(summary["converged"], f"{summary['system']}: SCF did not converge")
    check(summary["on_cuda"], f"{summary['system']}: tensors not on the card")
    summary.update(result=res, basis=out["Basis"])
    return summary


def run_mp2(tag: str, label: str, scf: dict, ump2: bool) -> dict:
    """RI-MP2 with SCS (RHF reference) or RI-UMP2 on a converged run."""
    import torch

    from juliachem_jl_tpu_torch.models import mp2

    t0 = time.perf_counter()
    if ump2:
        m = mp2.ri_ump2_energy(scf["result"], scf["basis"])
    else:
        m = mp2.ri_mp2_energy(scf["result"], scf["basis"], scs=True)
    torch.cuda.synchronize()
    m["wall_s"] = time.perf_counter() - t0
    print(f"{tag} {label}: E2 = {m['E2']:.10f} Eh (opposite spin "
          f"{m['E2 Opposite Spin']:.10f}, same spin {m['E2 Same Spin']:.10f},"
          f" SCS {m['E2 SCS']:.10f}), E(MP2) = {m['Energy']:.10f} Eh, wall "
          f"{m['wall_s']:.3f} s", flush=True)
    check(m["E2 Opposite Spin"] < m["E2 Same Spin"] < 0.0,
          f"{label}: expected E_os < E_ss < 0")
    return m


def builds_at(tag: str, dev, prim, D, Da, Db,
              name: str = "ammonia_trimer",
              scf_fock_s: float | None = None) -> dict:
    """At a converged RHF density D and a converged UHF pair (Da, Db): one
    in-core build (reference G and J, K(Da), K(Db)), one direct build (K5
    list mode) and one streaming build (K5 staircase mode), each with the
    launch counts of its own path; G, J, Ka, Kb of each held to the in-core
    ones at 1e-11 x their max-abs.  After the in-core builds, K6's time a
    build at the full in-core size (``incore_k6_times``), printed beside the
    cached build's wall and the SCF's steady Fock s/iter (``scf_fock_s``)."""
    import torch

    from juliachem_jl_tpu_torch.ops import fock, fock_stream, kernels
    from juliachem_jl_tpu_torch.utils.timings import Timings

    out = {}
    G_ref = jk_ref = None
    for label, make in (
            ("incore", lambda: fock.ScreenedDirectFock(prim, incore=True,
                                                       device=dev)),
            ("direct", lambda: fock.ScreenedDirectFock(prim, incore=False,
                                                       device=dev)),
            ("streaming", lambda: fock_stream.StreamingDirectFock(
                prim, device=dev))):
        kernels.reset_launches()
        t0 = time.perf_counter()
        fb = make()
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        J, K = fb.jk_halves(D)
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        if label == "incore":   # the blocks are cached: time a second build
            J, K = fb.jk_halves(D)
            torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        cached = t3 - t2 if label == "incore" else None
        if label == "incore":   # K6 alone, each class pair timed; uncounted
            saved = (dict(kernels.launches),
                     {k: dict(v) for k, v in kernels.class_launches.items()})
            k6 = incore_k6_times(tag, fb, D, name)
            k6_by_route(tag, fb, k6)
            kernels.launches.update(saved[0])
            kernels.class_launches.clear()
            kernels.class_launches.update(saved[1])
            print(f"{tag} {name}: K6 {k6['ms']:.3f} ms a build at the full "
                  f"in-core size (bound {k6['bound_ms']:.4f} ms); the cached "
                  f"build's wall {1e3 * cached:.3f} ms"
                  + (f"; the SCF's steady Fock {1e3 * scf_fock_s:.3f} ms/iter"
                     if scf_fock_s is not None else ""), flush=True)
            k6["cached_build_wall_ms"] = 1e3 * cached
            k6["scf_fock_s_per_iter"] = scf_fock_s
            t3 = time.perf_counter()
        G = J - 0.5 * K
        jk = fb.two_electron_jk(Da, Db, 1, Timings())
        torch.cuda.synchronize(dev)
        t4 = time.perf_counter()
        counts = {k: v for k, v in kernels.launches.items() if v}
        cls_counts = {k: dict(v) for k, v in kernels.class_launches.items()}
        if G_ref is None:
            G_ref, jk_ref = G, jk
        err = float((G - G_ref).abs().max())
        scale = float(G_ref.abs().max())
        err_jk = max(float((a - b).abs().max()) for a, b in zip(jk, jk_ref))
        scale_jk = max(float(x.abs().max()) for x in jk_ref)
        out[label] = {"setup_s": t1 - t0, "build_s": t2 - t1,
                      "cached_build_s": cached,
                      "uhf_jk_s": t4 - t3,
                      "max_abs_err_vs_incore": err,
                      "uhf_jk_max_abs_err_vs_incore": err_jk,
                      "launches": counts, "class_launches": cls_counts,
                      "quartets": fb.n_quartets}
        if label == "incore":
            out[label]["k6"] = k6
        print(f"{tag} {name} {label} build at the converged D: setup "
              f"{t1 - t0:.3f} s, build {t2 - t1:.4f} s"
              + (f" (cached blocks: {cached:.4f} s)" if label == "incore"
                 else "")
              + f", |G - G_incore| {err:.3e} (bound 1e-11 x {scale:.3e}); "
              f"UHF J, K(Da), K(Db) at (Da, Db) {t4 - t3:.4f} s, "
              f"max |. - incore| {err_jk:.3e} (bound 1e-11 x {scale_jk:.3e}); "
              f"launches {counts}", flush=True)
        check(err <= 1e-11 * scale,
              f"{label} build: |G - G_incore| {err:.3e} > 1e-11 x {scale:.3e}")
        check(err_jk <= 1e-11 * scale_jk,
              f"{label} UHF J/K: max err {err_jk:.3e} > 1e-11 x "
              f"{scale_jk:.3e}")
        fb.finalize()
    check(out["direct"]["launches"].get("eri4c_jk_list", 0) > 0,
          "K5 list mode never launched on the direct build")
    check(out["streaming"]["launches"].get("eri4c_jk_stair", 0) > 0,
          "K5 staircase mode never launched on the streaming build")
    return out


# --------------------------------------------------------------- phase 12

def spherical(inp: dict) -> dict:
    """A run_spec input in the spherical-harmonic AO basis."""
    return {**inp, "model": {**inp["model"], "spherical": True}}


def grad_bounds(tm: dict, primary, aux, natom: int) -> dict:
    """Per part of one gradient, its synchronised wall (ms, ``tm``) beside
    the least time the card could take for the same work (``bound_of``):
    each input read once, each output written once, and the operations of
    the run's inputs: the Hermite R entries (one FMA each) of every
    primitive product the derivative programs evaluated (the items that
    ``tm["work"]`` counts by class and live primitive counts, whether the
    kernels or their plain versions ran) and the FMAs of their
    contractions.  The one-electron part reads D, W (each pair's block),
    its packed tables and writes [natom, 3]; the 3-center derivative reads
    gamma's unique-pair blocks, the metric derivative Omega's blocks of the
    pairs it sums."""
    nbf = primary.nbf
    out = {}

    def part(key, nbytes, ops):
        if key in tm:
            out[key] = {"ms": 1e3 * tm[key], **bound_of(nbytes, ops)}

    work = tm.get("work", {})

    def counted(kind, pred=lambda k: True):
        return [(key[1:], n) for key, n in work.items()
                if key[0] == kind and pred(key)]

    stv = counted("stv")
    ops = sum(n * (2 * k2 * na * nherm(la + lb + 1)
                   + 4 * 3 * ncart(la) * ncart(lb) * (1 + na))
              for (la, lb, k2, na), n in stv)
    part("one_electron",
         sum(n * (2 * 8 * ncart(la) * ncart(lb) + 76 + 24 * k2)
             for (la, lb, k2, na), n in stv) + natom * (32 + 24), ops)
    if aux is None:
        ops = sum(n * (2 * k2b * k2k * nherm(la + lb + lc + ld + 1)
                       + 2 * 3 * 3 * ncart(la) * ncart(lb) * ncart(lc)
                       * ncart(ld))
                  for (la, lb, lc, ld, k2b, k2k), n in counted("eri"))
        part("two_electron", 3 * nbf * nbf * 8, ops)
        return out
    A = aux.nbf

    def df_part(metric):
        rows = counted("eri", lambda k: k[2] == -1 and (k[4] == -1) == metric)
        ops = nbytes = 0
        for (la, _, lp, lq, ka, kp), n in rows:
            lq = max(lq, 0)
            ncd = ncart(lp) * ncart(lq)
            ops += n * (2 * ka * kp * nherm(la + lp + lq + 1)
                        + 2 * 2 * 3 * ncart(la) * ncd)
            nbytes += n * ncart(la) * ncd * 8
        return nbytes + 24 * natom, ops

    part("three_center", A * nbf * nbf * 8, 0.0)
    part("metric", A * A * 8, 0.0)
    part("fit", 4 * A * nbf * nbf * 8,
         4 * A * nbf ** 3 + 2.0 / 3.0 * A ** 3 + 6 * A * A * nbf * nbf)
    part("three_center_derivative", *df_part(False))
    part("metric_derivative", *df_part(True))
    return out


def run_gradient(tag: str, jc, label: str, inp: dict, ref: dict | None,
                 route: str, incore: str | None = None,
                 env: dict | None = None, tol: float = 1e-7) -> dict:
    """models.gradient.run on a run_spec input (its SCF flags, method and
    aux set), its parts timed and bounded (``grad_bounds``), held to the
    JAX package's recorded gradient (max-abs ``tol`` Eh/bohr) and energy
    (E_REF_TOL), to translational invariance, and its Mulliken charges to
    the molecular charge."""
    import torch

    from juliachem_jl_tpu_torch.models import gradient, properties

    spec = jc.io.parse_input(inp)
    mol = jc.molecule.run(spec)
    bsets = jc.basis.run(mol, spec.model)
    flags = dict(spec.scf_keywords)
    method = str(spec.model.get("method", "RHF")).upper()
    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    tm = {}
    t0 = time.perf_counter()
    try:
        res = gradient.run(mol, bsets, flags, method=method, timings=tm)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    g = res["Gradient"].cpu().numpy()
    nt = res["Timings"].non_timing_data
    aux = bsets.auxiliary if flags.get("scf_type") == "df" else None
    parts = grad_bounds(tm, bsets.primary, aux, mol.natom)
    charges = properties.mulliken_charges(mol, bsets.primary, res)
    out = {"system": label, "energy": float(res["Energy"]),
           "iterations": int(res["Iterations"]),
           "stagnated": bool(res.get("Stagnated")), "route": nt["fock_builder"],
           "incore": nt.get("incore"), "gradient": g.tolist(),
           "sum_abs_max": float(abs(g.sum(axis=0)).max()),
           "scf_s": res["Timings"].run_time, "wall_s": wall, "parts": parts,
           "peak_device_bytes": peak,
           "charge_sum_minus_charge": float(charges.sum()) - mol.charge,
           "on_cuda": res["Gradient"].is_cuda}
    if ref:
        out["minus_jax_gradient"] = float(abs(g - ref["gradient"]).max())
        out["minus_jax_energy"] = out["energy"] - ref["energy"]
    print(f"{tag} {label}: route {out['route']} (incore {out['incore']}), "
          f"{out['iterations']} iterations"
          + (" (the stagnation exit)" if out["stagnated"] else "")
          + f", E = {out['energy']:.10f} Eh"
          + (f" (E - JAX {out['minus_jax_energy']:.3e}, |g - JAX| "
             f"{out['minus_jax_gradient']:.3e})" if ref else "")
          + f", |sum g| {out['sum_abs_max']:.2e}; SCF {out['scf_s']:.2f} s, "
          f"gradient wall {wall - out['scf_s']:.2f} s; parts ms (bound ms, "
          "by): " + ", ".join(
              f"{k} {v['ms']:.1f} ({v['bound_ms']:.3f}, {v['bound_by']})"
              for k, v in parts.items())
          + f"; peak device memory {peak / 1e9:.3f} GB", flush=True)
    check(out["route"] == route, f"{label}: route {out['route']}, expected "
          f"{route}")
    if incore is not None:
        check(out["incore"] == incore, f"{label}: incore {out['incore']}")
    check(out["on_cuda"], f"{label}: the gradient is not on the card")
    check(out["sum_abs_max"] <= 1e-8,
          f"{label}: |sum of the gradient| = {out['sum_abs_max']:.3e}")
    check(abs(out["charge_sum_minus_charge"]) <= 1e-10,
          f"{label}: Mulliken charges sum to "
          f"{out['charge_sum_minus_charge'] + mol.charge:.12f}")
    if ref:
        check(out["minus_jax_gradient"] <= tol,
              f"{label}: |g - JAX| = {out['minus_jax_gradient']:.3e} > {tol}")
        check(abs(out["minus_jax_energy"]) <= E_REF_TOL,
              f"{label}: |E - JAX| = {abs(out['minus_jax_energy']):.3e}")
    out.update(result=res, basis=bsets, molecule=mol, flags=flags,
               model=spec.model)
    return out


def finite_differences(tag: str, jc, label: str, run: dict, coords,
                       h: float = 2e-4, tol: float = 5e-6) -> dict:
    """Central differences of the card's own converged energy (step h
    bohr) on the given (atom, axis) against the analytic gradient of
    ``run`` (a ``run_gradient`` result), within tol Eh/bohr."""
    from juliachem_jl_tpu_torch.models import rhf
    from juliachem_jl_tpu_torch.models.optimize import molecule_at

    mol, g = run["molecule"], run["gradient"]
    x0 = mol.coords.reshape(-1)
    out = {}
    for k, d in coords:
        es = []
        for sgn in (+1, -1):
            x = x0.copy()
            x[3 * k + d] += sgn * h
            m = molecule_at(mol, x)
            r = rhf.energy(m, jc.basis.run(m, run["model"]), run["flags"])
            check(r["Converged?"], f"{label}: displaced SCF did not converge")
            es.append(float(r["Energy"]))
        fd = (es[0] - es[1]) / (2 * h)
        key = f"{mol.symbols[k]}{k} {'xyz'[d]}"
        out[key] = {"fd": fd, "analytic": g[k][d], "diff": fd - g[k][d]}
        print(f"{tag} {label}: d E / d {key}: finite differences {fd:.9f}, "
              f"analytic {g[k][d]:.9f}, difference {fd - g[k][d]:.3e} Eh/bohr "
              f"(bound {tol})", flush=True)
        check(abs(fd - g[k][d]) <= tol,
              f"{label}: finite differences off the analytic gradient at "
              f"{key} by {abs(fd - g[k][d]):.3e}")
    return out


def grad_registers(tag: str) -> dict:
    """K10's and K11's instances, as ptxas reported them in this process's
    build: registers, stack frame, spills (K11 by (lA, lp, lq, metric))."""
    out = {**ptxas_instances(re.compile(
        r"\d+(stv_grad_kernel)ILi(\d)ELi(\d)E"), 2), **ptxas_instances(
        re.compile(r"\d+(eri3c_grad_kernel)ILi(\d)ELi(\d)ELi(\d)ELb(\d)E"),
        4)}
    check(out.get("stv_grad_kernel", {}).get("instances") == 15
          and out.get("eri3c_grad_kernel", {}).get("instances") == 90,
          "ptxas: K10's instances are not 15 or K11's not 75 + 15")
    print(f"{tag} K10, K11 instances (ptxas): " + fmt_instances(out),
          flush=True)
    return out


def k10_bound(counts: dict, natom: int) -> dict:
    """``bound_of`` K10's launches of ``counts`` (``stv_counts`` of its
    tables): D's and W's block of each pair read once (16 B an element),
    each packed row once (24 B a live primitive pair, 76 B a pair), the
    nuclei and [natom, 3]; per (live primitive pair, nucleus) item Boys and
    R to L + 1 (``boys_r_ops``), the charge scaling, the nuclear sum and
    the Hellmann-Feynman dot (6 nherm(L)); per live primitive pair its E
    tables (bra to la + 1, ket to lb + 2; five operations an entry), Hd (2
    nab nherm(L)) and each component pair's S, T derivatives (60) and V
    derivatives (4 x 3 nherm(L + 1))."""
    nbytes = natom * (32 + 24)
    ops = 0.0
    for (la, lb), c in counts.items():
        L, nab = la + lb, ncart(la) * ncart(lb)
        ne = (la + 2) * (lb + 3) * (L + 4)
        nbytes += 16 * nab * c["pairs"] + 24 * c["live_prim_pairs"] \
            + 76 * c["pairs"]
        ops += (boys_r_ops(L + 1, c["items"], c["series_items"])
                + c["items"] * (8 + (L + 2) + nherm(L + 1) + 6 * nherm(L))
                + c["live_prim_pairs"] * (15 * ne + 2 * nab * nherm(L)
                                          + nab * (60 + 12 * nherm(L + 1))))
    return bound_of(nbytes, ops)


def k11_counts(ti, tj, metric: bool) -> dict:
    """One class of K11 (``eri_grad.df_grad_tables``): its items (every aux
    shell with every pair; the metric's unordered pairs on two atoms), the
    gamma (or Omega) elements they read, their primitive products and those
    on the Boys series (rho |A - P|^2 <= 35)."""
    import torch

    from juliachem_jl_tpu_torch.ops import eri_grad

    import numpy as np

    lq = 0 if metric else tj.lb
    ncd = ncart(tj.la) * ncart(lq)
    if metric:
        i, j = eri_grad._metric_pairs(ti, tj)
    else:
        i, j = (x.reshape(-1) for x in np.meshgrid(
            np.arange(ti.n), np.arange(tj.n), indexing="ij"))
    out = {"items": int(len(i)), "elements": int(len(i)) * ncart(ti.la) * ncd,
           "products": 0, "series": 0}
    if not len(i):
        return out
    ma, mp = ti.meta.long(), tj.meta.long()
    dev = ti.prim.device
    ii = torch.as_tensor(i, device=dev)
    jj = torch.as_tensor(j, device=dev)
    ka, kp = ma[ii, 4], mp[jj, 4]
    out["products"] = int((ka * kp).sum())
    # every (aux primitive, live primitive pair) of the items, in chunks
    for s0 in range(0, len(i), 1 << 16):
        sa, sp = ii[s0:s0 + (1 << 16)], jj[s0:s0 + (1 << 16)]
        for x in range(int(ma[sa, 4].max())):
            for y in range(int(mp[sp, 4].max())):
                live = (ma[sa, 4] > x) & (mp[sp, 4] > y)
                ra = (ma[sa, 3] + x)[live]
                rp = (mp[sp, 3] + y)[live]
                al, a, b = ti.prim[ra, 0], tj.prim[rp, 0], tj.prim[rp, 1]
                cen = tj.pair[sp[live]]
                p = a + b
                P = (a[:, None] * cen[:, :3] + b[:, None] * cen[:, 3:]) \
                    / p[:, None]
                d2 = ((ti.pair[sa[live], :3] - P) ** 2).sum(1)
                out["series"] += int((al * p / (al + p) * d2
                                      <= BOYS_TCRIT).sum())
    return out


def k11_bound(per_class: dict, natom: int) -> dict:
    """``bound_of`` K11's launches (``k11_counts`` by class (lA, lp, lq)):
    the gamma or Omega elements of their items read once, [natom, 3]
    written; per primitive product Boys and R to L + 1, the component's
    Hermite sums V (2 nca ncd nherm(lp + lq)) and, 3-center, V_d (3 x 2 nca
    ncd nherm(lp + lq + 1)), and their contractions against R (2 x 3 nca
    nherm(lp + lq) nherm(lA + 1) for fA, as much again for fC)."""
    nbytes = natom * 24
    ops = 0.0
    for (la, lp, lq, metric), c in per_class.items():
        ncd = ncart(lp) * ncart(lq)
        nca, lk = ncart(la), lp + lq
        per = 2 * nca * ncd * nherm(lk) + 6 * nca * nherm(lk) * nherm(la + 1)
        if not metric:
            per += 6 * nca * ncd * nherm(lk + 1) \
                + 6 * nca * nherm(lk + 1) * nherm(la)
        nbytes += 8 * c["elements"]
        ops += (boys_r_ops(la + lk + 1, c["products"], c["series"])
                + c["products"] * per)
    return bound_of(nbytes, ops)


def check_grad_kernels(tag: str, label: str, run: dict) -> dict:
    """K10 and K11's two instances against their plain versions on the
    card, at the converged D and W of a ``run_gradient`` result and the
    gamma and Omega its DF gradient forms (``eri_grad.df_gamma_omega``):
    each per-atom component within 1e-10 x max |g| of the plain version
    (the atomics sum in no fixed order), K10 at each of its group sizes
    too; each kernel's CUDA-event time over its classes (a launch a class)
    beside its bound (``k10_bound``, ``k11_bound``) and the plain version's
    time.  Its launches are not the path's: the launch counts are
    restored."""
    import torch

    from juliachem_jl_tpu_torch.ops import eri_grad, kernels, oei, oei_grad

    saved = (dict(kernels.launches),
             {k: dict(v) for k, v in kernels.class_launches.items()})
    mol, bsets, res = run["molecule"], run["basis"], run["result"]
    primary, aux = bsets.primary, bsets.auxiliary
    T = res.get("Spherical Transform")
    D, W = res["Density"], res["W"]
    if T is not None:
        D, W = T @ D @ T.T, T @ W @ T.T
    D, W = D.contiguous(), W.contiguous()
    dev = D.device
    sph = bool(run["flags"].get("df_spherical_aux", True))
    gamma, Omega = eri_grad.df_gamma_omega(primary, aux, D, sph_aux=sph)
    natom = mol.natom
    atoms = oei.atom_table(mol, dev)

    def zeros():
        return torch.zeros((natom, 3), dtype=torch.float64, device=dev)

    def record(name, got, launch, plain, bound, extra):
        # the plain version runs once: its result is the reference
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        ref = plain()
        ev[1].record()
        torch.cuda.synchronize()
        plain_ms = ev[0].elapsed_time(ev[1])
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        check(err <= 1e-10 * scale, f"{label}: {name} off its plain version "
              f"by {err:.3e} (bound 1e-10 x max |g| = {1e-10 * scale:.3e})")
        ms = cuda_ms(launch)
        return {"name": name, "route": "cuda", "shapes": label,
                "max_abs_err": err, "rel_err": err / scale, "ms": ms,
                "plain_ms": plain_ms, "library_ms": None, **bound, **extra}

    t10 = oei_grad.stv_grad_tables(primary, dev)
    g = zeros()
    k10 = record(
        "stv_grad", oei_grad.one_electron_gradient(primary, mol, D, W),
        lambda: [oei_grad.stv_grad_class(t, atoms, D, W, g) for t in t10],
        lambda: oei_grad.stv_grad_plain(t10, atoms, D, W),
        k10_bound(stv_counts(t10, atoms), natom),
        {"source": "juliachem_jl_tpu_torch/csrc/oei_grad.cuh",
         "replaces": "juliachem_jl_tpu/ops/oei_grad.py:66",
         "group": kernels.stv_group(natom)})
    # ... and at each group size K10 has (the path takes one by the number
    # of nuclei: G = 8 only above 136 atoms)
    ref10 = oei_grad.stv_grad_plain(t10, atoms, D, W)
    k10["per_group"] = {}
    for G in kernels.STV_GROUPS:
        gG = zeros()
        for t in t10:
            oei_grad.stv_grad_class(t, atoms, D, W, gG, group=G)
        errG = float((gG - ref10).abs().max())
        check(errG <= 1e-10 * float(ref10.abs().max()),
              f"{label}: K10 at G = {G} off its plain version by {errG:.3e}")
        k10["per_group"][G] = {"max_abs_err": errG, "ms": cuda_ms(
            lambda: [oei_grad.stv_grad_class(t, atoms, D, W, gG, group=G)
                     for t in t10])}
    aux_t, pair_t = eri_grad.df_grad_tables(primary, aux, dev)
    metric_pairs = [(ti, tj) for a, ti in enumerate(aux_t)
                    for tj in aux_t[a:]]

    def k11_3c(out):
        for ti in aux_t:
            for tj in pair_t:
                eri_grad.eri3c_grad_class(ti, tj, gamma, out)
        return out

    def k11_2c(out):
        for ti, tj in metric_pairs:
            eri_grad.metric_grad_class(ti, tj, Omega, out)
        return out

    def plain_3c():
        out = zeros()
        eri_grad.three_center_grad_plain(aux_t, pair_t, gamma, out)
        return out

    def plain_2c():
        out = zeros()
        eri_grad.metric_grad_plain(aux_t, Omega, out)
        return out

    c3 = {(ti.la, tj.la, tj.lb, False): k11_counts(ti, tj, False)
          for ti in aux_t for tj in pair_t}
    c2 = {(ti.la, tj.la, 0, True): k11_counts(ti, tj, True)
          for ti, tj in metric_pairs}
    k11 = record("eri3c_grad", k11_3c(zeros()),
                 lambda: k11_3c(g), plain_3c, k11_bound(c3, natom),
                 {"source": "juliachem_jl_tpu_torch/csrc/eri3c_grad.cuh",
                  "replaces": "juliachem_jl_tpu/ops/eri_grad.py:52",
                  "items": sum(c["items"] for c in c3.values()),
                  "products": sum(c["products"] for c in c3.values())})
    k11m = record("metric_grad", k11_2c(zeros()),
                  lambda: k11_2c(g), plain_2c, k11_bound(c2, natom),
                  {"source": "juliachem_jl_tpu_torch/csrc/eri3c_grad.cuh",
                   "replaces": "juliachem_jl_tpu/ops/eri_grad.py:52",
                   "items": sum(c["items"] for c in c2.values()),
                   "products": sum(c["products"] for c in c2.values())})
    kernels.launches.update(saved[0])
    kernels.class_launches.clear()
    kernels.class_launches.update(saved[1])
    del gamma, Omega
    torch.cuda.empty_cache()
    out = {"stv_grad": k10, "eri3c_grad": k11, "metric_grad": k11m}
    print(f"{tag} {label}: the gradient's kernels against their plain "
          f"versions on the card ({natom} atoms, nbf {primary.nbf}, aux "
          f"{aux.nbf}): " + "; ".join(
              f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f} ms, "
              f"{v['bound_by']}; plain {v['plain_ms']:.1f} ms), max err "
              f"{v['max_abs_err']:.2e} ({v['rel_err']:.2e} of max |g|)"
              for k, v in out.items())
          + f"; K11 items {k11['items']} 3-center ({k11['products']} "
          f"primitive products), {k11m['items']} metric; K10 by group "
          "size (G: ms, max err): " + ", ".join(
              f"{G}: {v['ms']:.4f}, {v['max_abs_err']:.2e}"
              for G, v in k10["per_group"].items()), flush=True)
    return out


def run_phase12(tag: str, jc, path, counts: dict, refs_d: dict, cart: dict,
                inp_a: dict, expect_nsph: int) -> dict:
    """Phase 12 (module docstring): the spherical-harmonic AO basis and the
    nuclear derivatives.  ``path(label, fn)`` runs fn with the launch
    counts set to 0 just before and records them in ``counts[label]``;
    ``refs_d`` is smoke_reference.json's ``derivatives`` systems; ``cart``
    the Cartesian run of ``inp_a`` (phase 5's ``benzene_2_water`` DF), and
    ``expect_nsph`` the spherical function count of ``inp_a``'s basis.
    Returns the phase's record."""
    from juliachem_jl_tpu_torch.models import mp2 as mp2_mod

    #     (a) benzene_2_water DF-RHF spherical (nbf 517 -> 491, packed B),
    #     not below phase 5's Cartesian energy; (b) its analytic DF gradient
    #     (27 atoms) at dele 1e-11, translationally invariant and held to
    #     central differences of the card's own energy on the first heavy
    #     atom's (a C) and the first H's coordinate; (c) the first 2 waters of w32, cc-pVDZ spherical: the
    #     conventional RHF gradient in-core (K4, K6), direct and streaming
    #     (K5), the cation's UHF and ROHF gradients and its DF-UHF gradient
    #     (cc-pVDZ-JKFIT), each held to the JAX package's recorded gradient,
    #     and RI-MP2 on the RHF orbitals (K7) to its E2; (d) one water
    #     DF-RHF cc-pVDZ / cc-pVDZ-JKFIT spherical through run_file: driver
    #     optimize from O-H stretched by 0.1 A, frequencies at the JAX
    #     package's optimized geometry, gradient at the stretched one, each
    #     held to the JAX package's recorded result
    t_d = time.perf_counter()
    label_sa = "benzene_2_water spherical DF"
    sph_a = path(label_sa, lambda: run_system(
        tag, jc, label_sa, None, None, "ScreenedDFFockBuilder",
        inp=spherical(inp_a)))
    nsph = sph_a["result"]["MO Coeff"].shape[0]
    print(f"{tag} {label_sa}: nbf {sph_a['nbf']} Cartesian -> {nsph} "
          f"spherical, E - E(Cartesian, phase 5) = "
          f"{sph_a['energy'] - cart['energy']:.6e} Eh, Fock "
          f"{sph_a['fock_s_per_iter_f64_steady'] * 1e3:.3f} ms/iter (Cartesian "
          f"{cart['fock_s_per_iter_f64_steady'] * 1e3:.3f})", flush=True)
    check(nsph == expect_nsph, f"{label_sa}: {nsph} spherical functions, "
          f"expected {expect_nsph}")
    check(sph_a["energy"] >= cart["energy"] - 1e-9,
          f"{label_sa}: E = {sph_a['energy']:.10f} below the Cartesian "
          f"{cart['energy']:.10f}")
    label_sb = "benzene_2_water spherical DF gradient"
    sph_b = path(label_sb, lambda: run_gradient(
        tag, jc, label_sb, spherical({**inp_a, "keywords": {
            **inp_a["keywords"], "scf": {**inp_a["keywords"]["scf"],
                                         "dele": 1e-11, "rmsd": 1e-9,
                                         "niter": 100}}}),
        None, "ScreenedDFFockBuilder"))
    syms = sph_b["molecule"].symbols
    sph_b["finite_differences"] = finite_differences(
        tag, jc, label_sb, sph_b,
        [(next(i for i, x in enumerate(syms) if x != "H"), 2),
         (syms.index("H"), 0)])
    grad_kernels = {label_sb: check_grad_kernels(tag, label_sb, sph_b)}
    grads = {label_sb: sph_b}
    # (b') the DF gradient of the first 8 waters of w32 and of w32 itself
    #     (6-31+G* / cc-pVTZ-JKFIT, ``W_GRAD``; nbf 736, 5312 Cartesian aux
    #     functions, 96 atoms at w32): K10 and K11 against their plain
    #     versions at w8; at w32 the parts beside their bounds, the peak
    #     device memory, and central differences on one O z and one H x
    label_w8 = "w8 DF gradient"
    w8g = path(label_w8, lambda: run_gradient(
        tag, jc, label_w8, cluster_input("w32", W_GRAD, waters=8), None,
        "DFFockBuilder"))
    grad_kernels[label_w8] = check_grad_kernels(tag, label_w8, w8g)
    grads[label_w8] = w8g
    label_w32 = "w32 DF gradient"
    w32g = path(label_w32, lambda: run_gradient(
        tag, jc, label_w32, cluster_input("w32", W_GRAD), None,
        "ScreenedDFFockBuilder"))
    import torch

    card = torch.cuda.get_device_properties(0).total_memory
    check(w32g["peak_device_bytes"] < card, f"{label_w32}: peak "
          f"{w32g['peak_device_bytes']} bytes, the card has {card}")
    syms = w32g["molecule"].symbols
    w32g["finite_differences"] = finite_differences(
        tag, jc, label_w32, w32g, [(syms.index("O"), 2), (syms.index("H"), 0)],
        h=W_GRAD_FD_STEP, tol=W_GRAD_FD_TOL)
    grads[label_w32] = w32g
    for label, key, env, route, incore in (
            ("w2 spherical RHF gradient in-core", "w2 rhf", {},
             "ScreenedDirectFock", "True"),
            ("w2 spherical RHF gradient direct", "w2 rhf",
             {"JCHEM_INCORE_BUDGET": "0"}, "ScreenedDirectFock", "False"),
            ("w2 spherical RHF gradient streaming", "w2 rhf",
             {"JCHEM_CONV_STREAM": "1"}, "StreamingDirectFock", None),
            ("w2+ spherical UHF gradient", "w2+ uhf", {},
             "ScreenedDirectFock", "True"),
            ("w2+ spherical ROHF gradient", "w2+ rohf", {},
             "ScreenedDirectFock", "True"),
            ("w2+ spherical DF-UHF gradient", "w2+ df-uhf", {},
             "DFFockBuilder", None)):
        ref = refs_d[key]
        grads[label] = path(label, lambda: run_gradient(
            tag, jc, label, {**ref["input"], "driver": "gradient"}, ref,
            route, incore, env))
    w2 = grads["w2 spherical RHF gradient in-core"]
    label_mp = "w2 spherical RI-MP2"
    m_w2 = path(label_mp, lambda: mp2_mod.ri_mp2_energy(w2["result"],
                                                        w2["basis"]))
    d_e2 = m_w2["E2"] - refs_d["w2 rhf"]["E2"]
    print(f"{tag} {label_mp}: E2 = {m_w2['E2']:.10f} Eh, E2 - JAX = "
          f"{d_e2:.3e} (bound 1e-8)", flush=True)
    check(abs(d_e2) <= 1e-8, f"{label_mp}: |E2 - JAX| = {abs(d_e2):.3e}")
    # (d), (e): the input-file route of the three derivative drivers
    run_files = {}
    with tempfile.TemporaryDirectory() as tmp:
        for driver, key in (("gradient", "w1 gradient"),
                            ("optimize", "w1 optimize"),
                            ("frequencies", "w1 frequencies")):
            p = Path(tmp) / f"w1_{driver}.json"
            p.write_text(json.dumps(refs_d[key]["input"]))
            label = f"w1 spherical DF run_file {driver}"
            t0 = time.perf_counter()
            run_files[driver] = path(label, lambda: jc.run_file(str(p)))
            run_files[driver]["wall_s"] = time.perf_counter() - t0
    r_g = run_files["gradient"]["Energy"]
    d_g = float(abs(r_g["Gradient"].cpu().numpy()
                    - refs_d["w1 gradient"]["gradient"]).max())
    r_o = run_files["optimize"]["Energy"]
    ref_o = refs_d["w1 optimize"]
    d_eo = r_o["Energy"] - ref_o["energy"]
    d_xo = float(abs(r_o["Molecule"].coords - ref_o["coords_bohr"]).max())
    f_port = run_files["frequencies"]["Energy"]["Frequencies"]
    d_f = float(abs(f_port - refs_d["w1 frequencies"]["frequencies"]).max())
    print(f"{tag} w1 spherical DF run_file: gradient |g - JAX| {d_g:.3e} "
          f"(bound 1e-7), {run_files['gradient']['wall_s']:.2f} s; optimize "
          f"{r_o['Steps']} steps (JAX {ref_o['steps']}), E = "
          f"{r_o['Energy']:.10f} Eh, E - JAX {d_eo:.3e} (bound 1e-8), |x - "
          f"JAX| {d_xo:.3e} bohr (bound 1e-4), "
          f"{run_files['optimize']['wall_s']:.2f} s; frequencies "
          + ", ".join(f"{x:.2f}" for x in f_port)
          + f" cm^-1, |f - JAX| {d_f:.3e} (bound 0.5), "
          f"{run_files['frequencies']['wall_s']:.2f} s", flush=True)
    check(d_g <= 1e-7, f"w1 run_file gradient: |g - JAX| = {d_g:.3e}")
    check(r_o["Converged?"], "w1 run_file optimize did not converge")
    check(abs(d_eo) <= 1e-8, f"w1 run_file optimize: |E - JAX| = {d_eo:.3e}")
    check(d_xo <= 1e-4, f"w1 run_file optimize: |x - JAX| = {d_xo:.3e}")
    check(d_f <= 0.5, f"w1 run_file frequencies: |f - JAX| = {d_f:.3e}")
    d_main = {"df_gather_w": label_sa, "eri3c": label_sb,
              "stv_grad": label_sb, "eri3c_grad": label_sb,
              "metric_grad": label_sb,
              "eri4c": "w2 spherical RHF gradient in-core",
              "digest_jk": "w2 spherical RHF gradient in-core",
              "eri4c_jk_list": "w2 spherical RHF gradient direct",
              "eri4c_jk_stair": "w2 spherical RHF gradient streaming",
              "e2_rmp2": label_mp}
    for name, label in (*d_main.items(), ("stv_grad", label_w32),
                        ("eri3c_grad", label_w32), ("metric_grad", label_w32)):
        check(counts[label].get(name, 0) > 0,
              f"kernel {name} never launched on {label}")
    d_s = time.perf_counter() - t_d
    print(f"{tag} phase 12 (spherical basis, derivatives) took {d_s:.1f} s; "
          "launches per kernel: " + ", ".join(
              f"{n} {counts[lb][n]} ({lb})" for n, lb in d_main.items()),
          flush=True)
    return {
        "benzene_2_water spherical DF": {
            k: v for k, v in sph_a.items()
            if k not in ("density", "result", "basis")},
        "gradients": {k: {kk: vv for kk, vv in v.items() if kk not in (
            "result", "basis", "molecule", "flags", "model")}
            for k, v in grads.items()},
        "w2 spherical RI-MP2 E2": m_w2["E2"],
        "gradient_kernels": grad_kernels,
        "run_file": {"gradient_minus_jax": d_g,
                     "optimize": {"energy": r_o["Energy"],
                                  "minus_jax": d_eo, "coords_minus_jax": d_xo,
                                  "steps": r_o["Steps"],
                                  "wall_s": run_files["optimize"]["wall_s"]},
                     "frequencies": {"cm1": list(map(float, f_port)),
                                     "minus_jax": d_f,
                                     "wall_s":
                                         run_files["frequencies"]["wall_s"]}},
        "seconds": d_s}


# --------------------------------------------------------------- phase 13

def host_facts(tag: str) -> dict:
    """The machine's MemTotal and MemAvailable (/proc/meminfo) and the
    page-locked host -> card bandwidth of one 2 GB copy (CUDA events, the
    best of three), as the streamed B's copies see it."""
    import torch

    from juliachem_jl_tpu_torch.models.df_screened import host_empty

    mem = {}
    for line in Path("/proc/meminfo").read_text().splitlines():
        key, val = line.split(":", 1)
        if key in ("MemTotal", "MemAvailable"):
            mem[key] = int(val.split()[0]) * 1024
    n = 2 * 10**9 // 8
    src = host_empty((n,), torch.float64, torch.device("cuda"))
    src.fill_(1.0)
    dst = torch.empty(n, dtype=torch.float64, device="cuda")
    times = []
    for _ in range(3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        dst.copy_(src, non_blocking=True)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    check(bool((dst[::10**6] == 1.0).all()), "host -> card copy: wrong values")
    out = {**mem, "h2d_bytes": 8 * n, "h2d_ms": min(times),
           "h2d_bytes_s": 8 * n / (min(times) / 1e3),
           "pinned": bool(src.is_pinned())}
    del src, dst
    torch.cuda.empty_cache()
    print(f"{tag} host: MemTotal {mem['MemTotal'] / 1e9:.2f} GB, MemAvailable "
          f"{mem['MemAvailable'] / 1e9:.2f} GB; page-locked host -> card copy "
          f"of {out['h2d_bytes'] / 1e9:.1f} GB in {out['h2d_ms']:.3f} ms = "
          f"{out['h2d_bytes_s'] / 1e9:.2f} GB/s (best of 3; pinned "
          f"{out['pinned']})", flush=True)
    check(out["pinned"], "host_empty did not give page-locked memory")
    return out


@contextlib.contextmanager
def builder_fractions(b_fraction: float | None = None,
                      w_fraction: float | None = None):
    """ScreenedDFFockBuilder's budget fractions (B_FRACTION, W_FRACTION)
    set for a block of the smoke, restored after."""
    from juliachem_jl_tpu_torch.models.df_screened import ScreenedDFFockBuilder

    saved = (ScreenedDFFockBuilder.B_FRACTION,
             ScreenedDFFockBuilder.W_FRACTION)
    if b_fraction is not None:
        ScreenedDFFockBuilder.B_FRACTION = b_fraction
    if w_fraction is not None:
        ScreenedDFFockBuilder.W_FRACTION = w_fraction
    try:
        yield
    finally:
        (ScreenedDFFockBuilder.B_FRACTION,
         ScreenedDFFockBuilder.W_FRACTION) = saved


def best_wall(fn, reps: int = 3):
    """(fn()'s result, the best synchronised wall in s of ``reps`` calls)."""
    import torch

    best, out = math.inf, None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return out, best


def stream_vs_resident(tag: str, label: str, make, D, b_fraction: float,
                       w_fraction: float, bw: float) -> dict:
    """G at D (its signed factor) from a resident builder and from one
    forced to stream by ``b_fraction``, both on Q-blocks of ``w_fraction``:
    held within 1e-12 x max|G|; each build's best wall, the streamed one
    beside max(B's bytes / the H2D bandwidth, the resident one)."""
    import torch

    from juliachem_jl_tpu_torch.utils.timings import Timings

    def fock(fb):
        return fb.two_electron_fock(D, 1, Timings())

    with builder_fractions(w_fraction=w_fraction):
        fb = make()
        G0, t_res = best_wall(lambda: fock(fb))
        mode0 = fb.mode
        fb.finalize()
        del fb
        torch.cuda.empty_cache()
    with builder_fractions(b_fraction, w_fraction):
        fb = make()
        G1, t_st = best_wall(lambda: fock(fb))
        mode1, nbytes, blocks = fb.mode, fb.B.numel() * 8, -(-fb.A // fb.q_chunk)
        fb.finalize()
        del fb
        torch.cuda.empty_cache()
    err = float((G1 - G0).abs().max()) / float(G0.abs().max())
    bound = max(nbytes / bw, t_res)
    out = {"modes": [mode0, mode1], "rel_err": err, "resident_s": t_res,
           "stream_s": t_st, "h2d_bound_s": nbytes / bw,
           "max_h2d_resident_s": bound, "stream_over_bound": t_st / bound,
           "q_blocks": blocks}
    print(f"{tag} {label}: G at the converged D, {mode1} vs {mode0} on "
          f"{blocks} Q-blocks: max |dG| / max |G| = {err:.3e} (bound 1e-12); "
          f"one f64 build {1e3 * t_st:.2f} ms streamed, {1e3 * t_res:.2f} ms "
          f"resident, H2D bound {1e3 * nbytes / bw:.2f} ms: streamed / "
          f"max(H2D bound, resident) = {out['stream_over_bound']:.3f}",
          flush=True)
    check(mode0 == "resident" and mode1 != "resident",
          f"{label}: modes {mode0}, {mode1}")
    check(err <= 1e-12, f"{label}: streamed G off the resident G by {err:.3e}")
    return out


def run_phase13(tag: str, jc, path, counts: dict, w32a: dict,
                cation: dict) -> dict:
    """Phase 13, the host-streamed B: (a) host facts; (b) w32 streamed with
    B32 resident (budget fractions set here), with the B cache, and G at
    phase 8's D against the resident builder's; (c) w32 from (b)'s B
    cache; (d) w32 with nothing resident (the f32 phase on streamed blocks
    cast on the card); (e) w64 at the defaults, streamed with B32 resident
    by its own choice; (f) w64 resident on an f64 B without the
    mixed-precision phase, within 1e-8 Eh of (e); (g) one UHF J, K(Da),
    K(Db) build of the benzene_2_water cation on a streamed B against the
    resident one."""
    import torch

    from juliachem_jl_tpu_torch.models.df_screened import (
        STREAM, STREAM_B32, ScreenedDFFockBuilder, fitted_rows)
    from juliachem_jl_tpu_torch.models.df_screened_jk import ScreenedDFJKBuilder
    from juliachem_jl_tpu_torch.utils.options import create_scf_options
    from juliachem_jl_tpu_torch.utils.timings import Timings

    dev = torch.device("cuda")
    t13 = time.perf_counter()
    out = {"host": host_facts(tag)}
    bw = out["host"]["h2d_bytes_s"]
    total = torch.cuda.get_device_properties(dev).total_memory
    # (b)-(d): w32's f64 B streams in Q-blocks of W_W32 of the card (about
    # a tenth of its rows); the B budget between the modes' sizes
    W_W32 = 0.005
    rows, width = json.loads(w32a["B_shape"])
    b64, b32 = rows * width * 8, rows * width * 4
    spec = jc.io.parse_input(cluster_input("w32"))
    bsets = jc.basis.run(jc.molecule.run(spec), spec.model)
    with builder_fractions(w_fraction=W_W32):
        qc = ScreenedDFFockBuilder.block_rows(
            bsets.primary.nbf, bsets.primary.nels // 2, rows, dev)
    buffers = 2 * qc * width * 8
    frac_b32 = (b32 + buffers + b64 + b32) / 2 / total
    frac_none = (b32 + buffers / 2) / total
    print(f"{tag} w32: B {b64 / 1e9:.3f} GB, B32 {b32 / 1e9:.3f} GB, two "
          f"Q-block buffers of {qc} rows {buffers / 1e9:.3f} GB; B budget "
          f"{frac_b32 * total / 1e9:.3f} GB (stream, B32 resident), "
          f"{frac_none * total / 1e9:.3f} GB (stream)", flush=True)
    tmp = tempfile.mkdtemp(prefix="jchem_smoke13_")
    try:
        cache = os.path.join(tmp, "w32")
        with builder_fractions(frac_b32, W_W32):
            b = path("w32 stream B32", lambda: run_cluster(
                tag, jc, "w32", {"df_b_cache": cache}, "w32 stream B32"))
            c = path("w32 stream B32 from the B cache", lambda: run_cluster(
                tag, jc, "w32", {"df_b_cache": cache},
                "w32 stream B32 from the B cache"))
        with builder_fractions(frac_none, W_W32):
            d = path("w32 stream", lambda: run_cluster(
                tag, jc, "w32", {}, "w32 stream"))
        opts = create_scf_options(spec.scf_keywords)
        out["w32_G"] = stream_vs_resident(
            tag, "w32", lambda: ScreenedDFFockBuilder.build(
                bsets.primary, bsets.auxiliary, opts, dev),
            w32a["density"], frac_b32, W_W32, bw)
        d_b8 = b["energy"] - w32a["energy"]
        d_cb = c["energy"] - b["energy"]
        d_db = d["energy"] - b["energy"]
        print(f"{tag} w32 streamed: E(stream, B32) - E(phase 8 f64 B) = "
              f"{d_b8:.3e} Eh; from the B cache: E - E(b) = {d_cb:.3e} Eh, "
              f"3-center {c['setup_s']['three_center']}, B checksum equal "
              f"{c['B_checksum'] == b['B_checksum']}; nothing resident: E - "
              f"E(b) = {d_db:.3e} Eh, f32 phase {d['f32_phase_iters']} "
              "iterations on streamed blocks (bound 1e-9 Eh each)", flush=True)
        check(b["B_mode"] == STREAM_B32 and c["B_mode"] == STREAM_B32
              and d["B_mode"] == STREAM, "w32: memory modes "
              f"{b['B_mode']}, {c['B_mode']}, {d['B_mode']}")
        check(abs(d_b8) <= 1e-9, f"w32 stream B32: |dE| = {abs(d_b8):.3e}")
        check(c["loaded_B_cache"] and not c["setup_s"]["three_center"],
              "w32 from the B cache built a 3-center tensor")
        check(c["B_checksum"] == b["B_checksum"],
              "w32: the cached host B differs from the one built")
        check(abs(d_cb) <= 1e-9 and abs(d_db) <= 1e-9,
              f"w32 streamed: |dE| {abs(d_cb):.3e}, {abs(d_db):.3e}")
        check(d["f32_phase_iters"] > 0 and "cast" in d["k_pass_split_ms"].get(
            "float32", {}), "w32 stream: no f32 phase on streamed blocks")
        for lab in ("w32 stream B32", "w32 stream"):
            check(counts[lab].get("df_gather_w", 0) > 0,
                  f"K2 never launched on {lab}")
        # (e) w64 at the defaults, (f) resident without the f32 copy; the
        #     one-electron cache carries S/T/V from (e) to (f)
        oei = os.path.join(tmp, "w64")
        e = path("w64 f64 B defaults", lambda: run_cluster(
            tag, jc, "w64", {"oei_cache": oei}, "w64 f64 B defaults",
            checksum=False, stv=True))
        torch.cuda.empty_cache()
        f = path("w64 f64 B resident", lambda: run_cluster(
            tag, jc, "w64", {"oei_cache": oei, "mixed_precision": False},
            "w64 f64 B resident, mixed_precision false", checksum=False))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    d_ef = e["energy"] - f["energy"]
    t_f64 = e["fock_s_per_iter_f64_steady"]
    bound = max(e["B_bytes"] / bw, f["fock_s_per_iter_f64_steady"])
    split = e["k_pass_split_ms"].get("float64", {})
    print(f"{tag} w64 at the defaults: {e['B_mode']}, host B "
          f"{e['host_B_bytes'] / 1e9:.3f} GB, build peak "
          f"{e['build_peak_inline_bytes'] / 1e9:.3f} GB (B {e['B_bytes'] / 1e9:.3f}"
          f" GB), run peak {e['peak_device_bytes'] / 1e9:.3f} GB; host B "
          f"allocation {e['setup_s']['host_alloc']:.3f} s, 3-center "
          f"{e['setup_s']['three_center']:.3f} s, fold and copy out "
          f"{e['setup_s']['B']:.3f} s (chunked), B32 from the host blocks "
          f"{e['setup_s']['builder_init']:.3f} s; f32 phase "
          f"{e['fock_s_per_iter_f32_phase'] or math.nan:.4f} s/iter over "
          f"{e['f32_phase_iters']}, f64 "
          f"{t_f64:.4f} s/iter, max(H2D bound {e['B_bytes'] / bw:.4f}, "
          f"resident (f) {f['fock_s_per_iter_f64_steady']:.4f}) = {bound:.4f}: "
          f"ratio {t_f64 / bound:.3f}; its K pass ms: H2D "
          f"{split.get('H2D', 0.0):.1f}, wait {split.get('wait', 0.0):.1f}; "
          f"E(e) - E(f) = {d_ef:.3e} Eh (bound 1e-8); E(f32 B, recorded) - "
          f"E(f64 B) = {W64_F32B_ENERGY - e['energy']:.4e} Eh", flush=True)
    check(e["B_mode"] == STREAM_B32, f"w64 defaults: mode {e['B_mode']}")
    check(f["B_mode"] == "resident", f"w64 f64 unmixed: mode {f['B_mode']}")
    check(e["build_peak_inline_bytes"] < e["B_bytes"],
          "w64 defaults: the build's device peak is not below B's bytes")
    check(abs(d_ef) <= 1e-8, f"w64: |E(stream) - E(resident)| = {abs(d_ef):.3e}")
    check(counts["w64 f64 B defaults"].get("df_gather_w", 0) > 0
          and counts["w64 f64 B defaults"].get("eri3c", 0) > 0,
          "w64 defaults: K1 or K2 never launched")
    # K2 at w64's Q-block for the occupied factor (the f32 phase of (e)
    # sweeps B32 in such blocks): each instance against the plain version
    spec64 = jc.io.parse_input(cluster_input("w64"))
    bsets64 = jc.basis.run(jc.molecule.run(spec64), spec64.model)
    opts64 = create_scf_options(spec64.scf_keywords)
    k64 = bsets64.primary.nels // 2
    qc64 = ScreenedDFFockBuilder.block_rows(
        bsets64.primary.nbf, k64, fitted_rows(bsets64.auxiliary, opts64), dev)
    torch.cuda.empty_cache()
    out["k2_w64"] = dict(zip(("f64", "f32", "f32b"), check_k2(
        tag, dev, bsets64, opts64, "w64 Q-block", k64, qc64)))
    del bsets64
    torch.cuda.empty_cache()
    # (g) one UHF build on a streamed B: the benzene_2_water cation's
    #     (Ca, Cb); Q-blocks at a W_FRACTION of 2e-4 (17 blocks on an 80 GB
    #     card), B over a 0.1 GB budget
    r = cation["result"]
    na, nb = int(r["N Alpha"]), int(r["N Beta"])
    Ca = r["MO Coeff Alpha"][:, :na].contiguous()
    Cb = r["MO Coeff Beta"][:, :nb].contiguous()
    cb = cation["basis"]
    opts_c = create_scf_options({"scf_type": "df", "mixed_precision": False})

    def jk(frac):
        with builder_fractions(frac, 2e-4):
            fb = ScreenedDFJKBuilder.build(cb.primary, cb.auxiliary, opts_c,
                                           dev)
            res = fb.two_electron_jk(Ca @ Ca.T, Cb @ Cb.T, 1, Timings(), Ca,
                                     Cb)
            meta = (fb.mode, -(-fb.A // fb.chunk_for(max(na, nb))))
            fb.finalize()
        return res, meta

    ref, meta0 = jk(None)
    got, meta1 = path("benzene_2_water cation streamed JK build",
                      lambda: jk(0.1e9 / total))
    errs = [float((g - x).abs().max()) / float(x.abs().max())
            for g, x in zip(got, ref)]
    k2 = counts["benzene_2_water cation streamed JK build"].get(
        "df_gather_w", 0)
    print(f"{tag} benzene_2_water cation: J, K(Da), K(Db) on a streamed B "
          f"({meta1[0]}, {meta1[1]} Q-blocks) vs resident ({meta0[0]}): "
          "max |d| / max: " + ", ".join(f"{x:.3e}" for x in errs)
          + f" (bound 1e-12); K2 launches {k2}", flush=True)
    check(meta1[0] != "resident" and meta0[0] == "resident",
          "cation JK: modes")
    check(max(errs) <= 1e-12, "cation JK on a streamed B off the resident")
    check(k2 == 2 * meta1[1], f"cation JK: K2 launched {k2} times, not twice "
          f"a block of {meta1[1]}")
    out.update(w32_stream_b32=b, w32_from_cache=c, w32_stream=d,
               w64_defaults=e, w64_resident_f64=f,
               cation_jk={"rel_err": errs, "modes": [meta0[0], meta1[0]],
                          "q_blocks": meta1[1], "k2_launches": k2},
               seconds=time.perf_counter() - t13)
    print(f"{tag} phase 13 (host-streamed B) took {out['seconds']:.1f} s",
          flush=True)
    return out


def f32_phase_k2(tag: str, counts: dict, runs: dict) -> dict:
    """K2's f32 instance on the mixed-precision phase of each packed run
    (path label -> run_cluster summary): a run whose f32 phase swept B
    (f32 iterations, or f32 sweeps in its K pass split) must have launched
    ``df_gather_w_f32``.  Per run, the f32 phase's iterations and those
    launches, and the K pass of its f32 builds (K2 and the sum of the
    compute stream's phases, the side stream's H2D left out; ms by CUDA
    events) beside its f64 builds', with the Fock s/iter of both."""
    def total(v):
        return (sum(x for key, x in v.items() if key not in ("sweeps", "H2D"))
                if v else None)

    def fmt(x, f=".3f"):
        return "-" if x is None else format(x, f)

    out = {}
    for label, r in runs.items():
        split = r["k_pass_split_ms"]
        f32, f64 = split.get("float32", {}), split.get("float64", {})
        n = counts[label].get("df_gather_w_f32", 0)
        out[label] = {
            "f32_phase_iters": r["f32_phase_iters"], "launches": n,
            "fock_s_f32_phase": r["fock_s_per_iter_f32_phase"],
            "fock_s_f64_steady": r["fock_s_per_iter_f64_steady"],
            "K2_ms_f32_build": f32.get("K2"), "K_pass_ms_f32_build": total(f32),
            "K2_ms_f64_build": f64.get("K2"), "K_pass_ms_f64_build": total(f64)}
        v = out[label]
        print(f"{tag} {label}: f32 phase {v['f32_phase_iters']} iterations, "
              f"df_gather_w_f32 launched {n} times; an f32-phase build: K2 "
              f"{fmt(v['K2_ms_f32_build'])} of a K pass of "
              f"{fmt(v['K_pass_ms_f32_build'])} ms, Fock "
              f"{fmt(v['fock_s_f32_phase'], '.4f')} s/iter; an f64 build: "
              f"K2 {fmt(v['K2_ms_f64_build'])} of "
              f"{fmt(v['K_pass_ms_f64_build'])} ms, Fock "
              f"{fmt(v['fock_s_f64_steady'], '.4f')} s/iter", flush=True)
        check(n > 0 or not (f32 or r["f32_phase_iters"]),
              f"{label}: an f32 phase without K2's f32 instance")
    return out


# --------------------------------------------------------------- phase 9

def packed_build_times(fb, D) -> dict:
    """Wall ms of one packed DF build at D on fb's device, each the mean of
    3 after a warm-up, synchronised: G = J - K/2 in f64 and in the f32
    phase, the per-phase (profile_fock) form where fb has it, and the
    spin-resolved (J, Ka, Kb) at Da = Db = D/2, whose J - Ka must be G;
    and G itself."""
    import torch

    from juliachem_jl_tpu_torch.utils.timings import Timings

    cuda = D.is_cuda

    def timed(fn, reps: int = 3) -> float:
        fn()
        if cuda:
            torch.cuda.synchronize(D.device)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if cuda:
            torch.cuda.synchronize(D.device)
        return (time.perf_counter() - t0) / reps * 1e3

    G = fb.two_electron_fock(D, 1, Timings())
    out = {"f64_ms": timed(lambda: fb.two_electron_fock(D, 1, Timings()))}
    if fb.supports_f32_phase:
        out["f32_ms"] = timed(lambda: fb.two_electron_fock(
            D, 1, Timings(), precision="f32"))
    if hasattr(fb, "profile"):
        fb.profile = True
        out["phases_ms"] = timed(lambda: fb.two_electron_fock(D, 1, Timings()))
        out["phases_err"] = float((fb.two_electron_fock(D, 1, Timings())
                                   - G).abs().max())
        fb.profile = False
    if cuda:
        # one f64 (and one f32-phase) build split by phase with CUDA events
        from juliachem_jl_tpu_torch.models.df_screened import KPassSplit

        fb.split = KPassSplit()
        fb.two_electron_fock(D, 1, Timings())
        if fb.supports_f32_phase:
            fb.two_electron_fock(D, 1, Timings(), precision="f32")
        out["k_pass_split"] = {sw.pop("dtype"): sw for sw in fb.split.ms()}
        fb.split = None
    Dh = (0.5 * D).contiguous()
    out["jk_ms"] = timed(lambda: fb.two_electron_jk(Dh, Dh, 1, Timings()))
    J, Ka, _ = fb.two_electron_jk(Dh, Dh, 1, Timings())
    out["jk_err"] = float((J - Ka - G).abs().max())
    out["G"] = G.cpu().numpy()
    return out


def sharded_rank(payload: dict) -> dict:
    """One rank of a sharded group on the card (``parallel.launch.spawn``
    imports this module by name): each phase of ``payload`` with the launch
    counts set to 0 just before it and read just after, its wall time and
    this rank's peak device memory.  (a) benzene_2_water DF-RHF, (b) its
    cation DF-UHF, (c) RI-MP2 on (a)'s orbitals, (d) ammonia_trimer
    conventional (quartet-sharded direct), (e) one sharded staircase build
    of benzene_2_water at the given converged D, (f) w32 on an f64 B;
    every run with num_devices = the group's size."""
    import torch
    import torch.distributed as dist

    import juliachem_jl_tpu_torch as jc
    from juliachem_jl_tpu_torch.models import df, mp2
    from juliachem_jl_tpu_torch.models.df_sharded_jk import ShardedDFJKBuilder
    from juliachem_jl_tpu_torch.ops import kernels
    from juliachem_jl_tpu_torch.ops.fock_stream import ShardedStreamingFock
    from juliachem_jl_tpu_torch.parallel import mesh as mesh_mod
    from juliachem_jl_tpu_torch.parallel import shard
    from juliachem_jl_tpu_torch.utils.options import create_scf_options
    from juliachem_jl_tpu_torch.utils.timings import JCTC

    n, rank = dist.get_world_size(), dist.get_rank()
    dev = jc.config.resolve_device()   # the launcher set this rank's device
    cuda = dev.type == "cuda"
    out = {"rank": rank, "world": n, "device": str(dev)}
    keep = {}

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def phase(label, fn):
        kernels.reset_launches()
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = fn()
        sync()
        res.update(wall_s=time.perf_counter() - t0,
                   launches={k: v for k, v in kernels.launches.items() if v},
                   peak_device_bytes=(torch.cuda.max_memory_allocated(dev)
                                      if cuda else 0))
        out[label] = res

    def scf(inp, label):
        r = jc.run_spec(jc.io.parse_input(inp))
        e = r["Energy"]
        keep[label] = r
        tm = e["Timings"]
        nt = tm.non_timing_data
        return {"energy": float(e["Energy"]),
                "converged": bool(e["Converged?"]),
                "iterations": int(e["Iterations"]),
                "route": nt["fock_builder"], "num_devices": nt.get("num_devices"),
                "B_bytes_rank": int(nt.get(f"device_B_bytes-DEVICE-{rank}", 0)),
                "B_shape": nt.get("B_shape"),
                "fock_s_per_iter": steady_mean([
                    tm.timings[f"{JCTC.fock_time}-{i}"]
                    for i in range(2, int(e["Iterations"]) + 1)]),
                "setup_s": {k: tm.timings.get(key) for k, key in (
                    ("three_center", JCTC.three_center_time),
                    ("B", JCTC.B_time))}}

    for label, inp in payload["scf"].items():
        phase(label, lambda: scf(inp, label))
    if "mp2" in payload:
        r = keep[payload["mp2"]]

        def run_mp2_sharded():
            m = mp2.ri_mp2_energy(r["Energy"], r["Basis"],
                                  opts=create_scf_options({"num_devices": n}))
            return {"E2": m["E2"], "keys": sorted(m)}

        phase("c RI-MP2", run_mp2_sharded)
    if "stream_D" in payload:
        spec = jc.io.parse_input(payload["stream_system"])
        prim = jc.basis.run(jc.molecule.run(spec), spec.model).primary

        def stream():
            sf = ShardedStreamingFock(prim, n_devices=n)
            D = torch.as_tensor(payload["stream_D"], device=dev)
            sync()
            t0 = time.perf_counter()
            G = sf.two_electron_fock(D, 1, None)
            sync()
            return {"G": G.cpu().numpy(), "build_s": time.perf_counter() - t0,
                    "quartets": sf.n_quartets}

        phase("e streaming build", stream)
    if "packed_system" in payload:
        spec = jc.io.parse_input(payload["packed_system"])
        bs = jc.basis.run(jc.molecule.run(spec), spec.model)

        def packed():
            fb = ShardedDFJKBuilder(bs.primary, bs.auxiliary, create_scf_options(
                {"scf_type": "df", "num_devices": n}))
            res = packed_build_times(
                fb, torch.as_tensor(payload["packed_D"], device=dev))
            fb.finalize()
            return res

        phase("g packed builds at D", packed)
    if "dense_system" in payload:
        spec = jc.io.parse_input(payload["dense_system"])
        bs = jc.basis.run(jc.molecule.run(spec), spec.model)

        def dense():
            opts = create_scf_options({"scf_type": "df"})
            B = df.build_B(bs.primary, bs.auxiliary, opts, dev)
            nbf, nocc = bs.primary.nbf, bs.primary.nels // 2
            m = mesh_mod.make_mesh(n, 2)
            Bp = torch.nn.functional.pad(B, (0, (-nbf) % 2, 0, 0,
                                             0, (-B.shape[0]) % m.nq))
            D = torch.as_tensor(payload["dense_D"], device=dev)
            w, V = torch.linalg.eigh(D)
            # D = 2 C C^T
            C = (V[:, -nocc:] * torch.sqrt(0.5 * w[-nocc:].clamp(min=0))
                 ).contiguous()
            G1 = df.df_fock(B, D, C)
            blk = shard.shard_B(m, Bp)
            del Bp
            Dp = torch.nn.functional.pad(D, (0, blk.shape[2] * m.nk - nbf))
            G = shard.df_fock_step(m, blk, Dp, C, nbf)
            H = torch.eye(nbf, dtype=D.dtype, device=dev)

            def ms(fn):
                fn()
                sync()
                t0 = time.perf_counter()
                for _ in range(3):
                    fn()
                sync()
                return (time.perf_counter() - t0) / 3 * 1e3

            return {"grid": [m.nq, m.nk], "err": float((G - G1).abs().max()),
                    "scale": float(G1.abs().max()),
                    "ms": ms(lambda: shard.df_fock_step(m, blk, Dp, C, nbf)),
                    "scf_step_ms": ms(lambda: shard.scf_step(
                        m, blk, H, H, D, C, blk.shape[2] * m.nk)),
                    "one_device_ms": ms(lambda: df.df_fock(B, D, C))}

        phase("h dense q x k step", dense)
    return out


def nccl_one_rank(payload: dict) -> dict:
    """A group of one rank on NCCL: ShardedDFFockBuilder and
    ShardedStreamingFock built directly at world 1, one build each at the
    given D, through the same collectives as n ranks."""
    import torch

    import juliachem_jl_tpu_torch as jc
    from juliachem_jl_tpu_torch.models.df_sharded import ShardedDFFockBuilder
    from juliachem_jl_tpu_torch.ops import kernels
    from juliachem_jl_tpu_torch.ops.fock_stream import ShardedStreamingFock
    from juliachem_jl_tpu_torch.utils.options import create_scf_options
    from juliachem_jl_tpu_torch.utils.timings import Timings

    spec = jc.io.parse_input(payload["system"])
    bsets = jc.basis.run(jc.molecule.run(spec), spec.model)
    kernels.reset_launches()
    df = ShardedDFFockBuilder(bsets.primary, bsets.auxiliary,
                              create_scf_options({"scf_type": "df",
                                                  "num_devices": 1}))
    D = torch.as_tensor(payload["D"], device=df.mesh.device)
    G_df = df.two_electron_fock(D, 1, Timings())
    df.finalize()
    G_st = ShardedStreamingFock(bsets.primary, n_devices=1).two_electron_fock(
        D, 1, None)
    return {"backend": df.mesh.backend, "world": df.mesh.world,
            "device": str(df.mesh.device), "G_df": G_df.cpu().numpy(),
            "G_stream": G_st.cpu().numpy(),
            "launches": {k: v for k, v in kernels.launches.items() if v}}


def run_sharded(tag: str, jc, goldens: dict, refs: dict, single: dict) -> dict:
    """Phase 9: the sharded programs over gloo groups of 2 and 4 ranks
    sharing card 0 (JCHEM_DIST_BACKEND=gloo), each rank on the real kernels;
    NCCL at world 1; NCCL across cards where more than one is visible.
    ``single``: the single-device references of the same runs on this card.
    Returns the per-group results and the checks' numbers."""
    import numpy as np
    import torch

    import chip_smoke as this   # the ranks import the rank functions by name
    from juliachem_jl_tpu_torch.parallel.launch import spawn

    g_b, g_a = goldens["benzene_2_water"], goldens["ammonia_trimer"]
    out = {}
    for n in (2, 4):
        scf = {
            "a benzene_2_water DF-RHF": system_input(
                "benzene_2_water", g_b, {"mixed_precision": False,
                                         "num_devices": n}),
            "b benzene_2_water cation DF-UHF": system_input(
                "benzene_2_water", g_b, scf=dict(CATION_TIGHT, num_devices=n),
                method="UHF", charge=1, multiplicity=2),
            "d ammonia_trimer conventional sharded direct": system_input(
                "ammonia_trimer", g_a, {"guess": "sad", "num_devices": n},
                CONV_SCF, aux=False),
        }
        if n == 2:
            scf["f w32 f64 B"] = cluster_input("w32", {"num_devices": 2})
        payload = {"scf": scf, "mp2": "a benzene_2_water DF-RHF",
                   "stream_system": system_input("benzene_2_water", g_b,
                                                 aux=False),
                   "stream_D": single["benzene_D"],
                   "packed_system": system_input("benzene_2_water", g_b),
                   "packed_D": single["benzene_D"],
                   "dense_system": system_input("ammonia_trimer", g_a),
                   "dense_D": single["ammonia_D"]}
        os.environ["JCHEM_CONV_STREAM"] = "0"   # (d): the direct route
        t0 = time.perf_counter()
        try:
            res = spawn(this.sharded_rank, n, args=(payload,), backend="gloo",
                        device="cuda:0", timeout=420.0)
        finally:
            del os.environ["JCHEM_CONV_STREAM"]
        wall = time.perf_counter() - t0
        checks = {}
        for label in res[0]:
            if not isinstance(res[0][label], dict):
                continue
            per_rank = [r[label] for r in res]
            launches = [r["launches"] for r in per_rank]
            extra = ""
            if "fock_s_per_iter" in per_rank[0]:
                extra = (f"{per_rank[0]['iterations']} iterations, Fock "
                         f"{per_rank[0]['fock_s_per_iter'] * 1e3:.2f} ms/iter, "
                         "3-center / fold s " + ", ".join(
                             f"{r['setup_s']['three_center']:.3f} / "
                             f"{r['setup_s']['B']:.3f}"
                             if r['setup_s']['B'] is not None else "-"
                             for r in per_rank) + "; ")
            print(f"{tag} gloo {n} ranks on cuda:0, {label}: {extra}wall "
                  f"{max(r['wall_s'] for r in per_rank):.2f} s, peak device "
                  f"memory per rank "
                  + ", ".join(f"{r['peak_device_bytes'] / 1e9:.3f}"
                              for r in per_rank)
                  + f" GB; launches per rank {launches}", flush=True)
        e = {k: res[0][k]["energy"] for k in scf}
        for k in scf:
            vals = {r[k]["energy"] for r in res}
            check(len(vals) == 1, f"gloo {n}: {k}: ranks disagree {vals}")
            check(all(r[k]["converged"] for r in res),
                  f"gloo {n}: {k}: did not converge")
            check(res[0][k]["num_devices"] == str(n),
                  f"gloo {n}: {k}: num_devices {res[0][k]['num_devices']}")
        a, b = "a benzene_2_water DF-RHF", "b benzene_2_water cation DF-UHF"
        d = "d ammonia_trimer conventional sharded direct"
        checks["rhf_minus_single"] = e[a] - single["benzene"]
        checks["rhf_minus_jax"] = e[a] - refs["benzene_2_water"]["energy"]
        checks["uhf_minus_single"] = e[b] - single["cation"]
        checks["conv_minus_single"] = e[d] - single["ammonia_conv"]
        checks["conv_rel_gamess"] = (e[d] - g_a["energy"]) / abs(g_a["energy"])
        e2 = {r["c RI-MP2"]["E2"] for r in res}
        check(len(e2) == 1, f"gloo {n}: RI-MP2 ranks disagree {e2}")
        checks["e2_minus_single"] = e2.pop() - single["e2"]
        G = res[0]["e streaming build"]["G"]
        checks["stream_G_err"] = float(np.abs(G - single["stream_G"]).max())
        checks["stream_G_scale"] = float(np.abs(single["stream_G"]).max())
        for r in res[1:]:
            check(np.array_equal(r["e streaming build"]["G"], G),
                  f"gloo {n}: streaming G differs between ranks")
        pk = res[0]["g packed builds at D"]
        sc = float(np.abs(single["df_G"]).max())
        checks["packed_G_err"] = float(np.abs(pk["G"] - single["df_G"]).max())
        checks["packed_phases_err"] = pk["phases_err"]
        checks["packed_jk_err"] = pk["jk_err"]
        dq = res[0]["h dense q x k step"]
        checks["dense_qk_err"] = dq["err"]
        print(f"{tag} gloo {n} ranks: packed G at D - one device "
              f"{checks['packed_G_err']:.3e}, per-phase form "
              f"{pk['phases_err']:.3e}, J - Ka of the JK step {pk['jk_err']:.3e}"
              f" (bound 1e-11 x {sc:.3e}); ms per build f64 "
              f"{pk['f64_ms']:.2f}, f32 {pk['f32_ms']:.2f}, per-phase "
              f"{pk['phases_ms']:.2f}, JK {pk['jk_ms']:.2f} (one device: "
              + ", ".join(f"{k} {v:.2f}" for k, v in
                          single["packed_ms"].items())
              + f"); dense q x k step on a {dq['grid']} grid "
              f"{dq['ms']:.2f} ms (with the Roothaan step "
              f"{dq['scf_step_ms']:.2f} ms; one device's dense build "
              f"{dq['one_device_ms']:.2f} ms), G - one device "
              f"{dq['err']:.3e} (bound 1e-11 x {dq['scale']:.3e})",
              flush=True)
        check(max(checks["packed_G_err"], pk["phases_err"], pk["jk_err"])
              <= 1e-11 * sc, f"gloo {n}: packed builds off one device's")
        check(dq["err"] <= 1e-11 * dq["scale"], f"gloo {n}: dense q x k G")
        print(f"{tag} gloo {n} ranks: E(DF-RHF) - one device "
              f"{checks['rhf_minus_single']:.3e} (bound 1e-9), - JAX "
              f"{checks['rhf_minus_jax']:.3e} (bound {E_REF_TOL}); cation "
              f"DF-UHF - one device {checks['uhf_minus_single']:.3e} (bound "
              f"1e-8; both to dele 1e-11, {res[0][b]['iterations']} "
              f"iterations here, {single['cation_iterations']} on one device)"
              f"; RI-MP2 E2 - one device {checks['e2_minus_single']:.3e} "
              f"(bound 1e-10); ammonia_trimer sharded direct - one device "
              f"{checks['conv_minus_single']:.3e} (bound 1e-10), vs GAMESS "
              f"{checks['conv_rel_gamess']:.3e} relative (bound "
              f"{E_GAMESS_REL}); streaming G max |diff| "
              f"{checks['stream_G_err']:.3e} (bound 1e-10 x "
              f"{checks['stream_G_scale']:.3e}); group wall {wall:.1f} s",
              flush=True)
        check(abs(checks["rhf_minus_single"]) <= 1e-9, f"gloo {n}: DF-RHF")
        check(abs(checks["rhf_minus_jax"]) <= E_REF_TOL, f"gloo {n}: vs JAX")
        check(abs(checks["uhf_minus_single"]) <= 1e-8, f"gloo {n}: DF-UHF")
        check(abs(checks["e2_minus_single"]) <= 1e-10, f"gloo {n}: RI-MP2")
        check(abs(checks["conv_minus_single"]) <= 1e-10,
              f"gloo {n}: sharded direct vs one device")
        check(abs(checks["conv_rel_gamess"]) <= E_GAMESS_REL,
              f"gloo {n}: sharded direct vs GAMESS")
        check(checks["stream_G_err"] <= 1e-10 * checks["stream_G_scale"],
              f"gloo {n}: sharded streaming G")
        for label, kernel in ((a, "eri3c"), (a, "df_gather_w"),
                              (b, "df_gather_w"), ("c RI-MP2", "e2_rmp2"),
                              (d, "eri4c_jk_list"),
                              ("e streaming build", "eri4c_jk_stair")):
            check(all(r[label]["launches"].get(kernel, 0) > 0 for r in res),
                  f"gloo {n}: {kernel} not launched on every rank in {label}")
        if n == 2:
            f = "f w32 f64 B"
            checks["w32_minus_single"] = e[f] - single["w32"]
            ratio = max(r[f]["B_bytes_rank"] for r in res) / single["w32_B_bytes"]
            checks["w32_B_rank_ratio"] = ratio
            print(f"{tag} gloo 2 ranks: w32 f64 B: E - one device "
                  f"{checks['w32_minus_single']:.3e} (bound 1e-9); B bytes "
                  f"per rank " + ", ".join(str(r[f]["B_bytes_rank"])
                                           for r in res)
                  + f" of {single['w32_B_bytes']} ({ratio:.4f}, bound 0.55); "
                  f"B {res[0][f]['B_shape']} (padded rows x width); peak "
                  f"device memory per rank " + ", ".join(
                      f"{r[f]['peak_device_bytes'] / 1e9:.3f}" for r in res)
                  + " GB", flush=True)
            check(abs(checks["w32_minus_single"]) <= 1e-9, "w32 2 ranks: E")
            check(ratio <= 0.55, f"w32 2 ranks: B per rank {ratio:.4f}")
        out[f"gloo {n}"] = {"ranks": [{k: ({kk: vv for kk, vv in v.items()
                                            if kk not in ("G", "D")}
                                           if isinstance(v, dict) else v)
                                       for k, v in r.items()} for r in res],
                            "checks": checks, "wall_s": wall}
    # (g) NCCL at world 1, the sharded builders built directly
    t0 = time.perf_counter()
    r1, = spawn(this.nccl_one_rank, 1, args=({
        "system": system_input("benzene_2_water", g_b,
                               {"mixed_precision": False}),
        "D": single["benzene_D"]},), backend="nccl", device="cuda",
        timeout=300.0)
    err_df = float(np.abs(r1["G_df"] - single["df_G"]).max())
    err_st = float(np.abs(r1["G_stream"] - single["stream_G"]).max())
    sc_df = float(np.abs(single["df_G"]).max())
    sc_st = float(np.abs(single["stream_G"]).max())
    print(f"{tag} NCCL world 1 ({r1['backend']}, {r1['device']}): "
          f"ShardedDFFockBuilder G - one device {err_df:.3e} (bound 1e-12 x "
          f"{sc_df:.3e}), ShardedStreamingFock G - one device {err_st:.3e} "
          f"(bound 1e-12 x {sc_st:.3e}: f64 atomics sum in no fixed order); "
          f"launches {r1['launches']}; wall {time.perf_counter() - t0:.1f} s",
          flush=True)
    check(r1["backend"] == "nccl" and r1["world"] == 1, "NCCL world 1")
    check(err_df <= 1e-12 * sc_df and err_st <= 1e-12 * sc_st,
          "NCCL world 1: G off one device's")
    out["nccl 1"] = {"df_G_err": err_df, "stream_G_err": err_st,
                     "launches": r1["launches"]}
    # (h) NCCL across cards
    count = torch.cuda.device_count()
    if count >= 2:
        n = min(count, 4)
        res = spawn(this.sharded_rank, n, args=({"scf": {
            "a benzene_2_water DF-RHF": system_input(
                "benzene_2_water", g_b, {"mixed_precision": False,
                                         "num_devices": n})}},),
            backend="nccl", device="cuda", timeout=300.0)
        e = res[0]["a benzene_2_water DF-RHF"]["energy"]
        print(f"{tag} NCCL {n} ranks on {n} cards: benzene_2_water DF-RHF E "
              f"- one device {e - single['benzene']:.3e}", flush=True)
        check(abs(e - single["benzene"]) <= 1e-9, f"NCCL {n} ranks")
        out[f"nccl {n}"] = {"energy": e}
    else:
        print(f"{tag} NCCL across cards: not run, {count} GPU visible",
              flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the detailed results as JSON here")
    args = ap.parse_args()

    if not (ROOT / "juliachem_jl_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: juliachem_jl_tpu_torch/ not found beside this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import juliachem_jl_tpu_torch as jc
    from juliachem_jl_tpu_torch.ops import kernels
    from juliachem_jl_tpu_torch.utils.options import create_scf_options

    # 1. device
    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader").splitlines()[0]
    tag = f"[{smi}]"
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; count {torch.cuda.device_count()}")
    print(smi)
    print("nvcc: " + sh(kernels._nvcc(), "--version").splitlines()[-1],
          flush=True)
    dev = jc.initialize("cuda")

    # 2. build
    t0 = time.perf_counter()
    kernels.library()
    build_s = time.perf_counter() - t0
    spills = [ln.strip() for ln in kernels.build_info.get("log", "").splitlines()
              if "spill" in ln and " 0 bytes spill stores" not in ln]
    per_source = kernels.build_info.get("per_source", {})
    print(f"{tag} build: {len(kernels._sources())} CUDA sources -> "
          f"{Path(kernels.build_info['so']).name} in {build_s:.1f} s "
          f"({len(spills)} kernel instances spill registers); slowest "
          "sources (s from the start): " + ", ".join(
              f"{k} {v:.1f}" for k, v in sorted(
                  per_source.items(), key=lambda kv: -kv[1])[:6]),
          flush=True)
    # 2a. the SASS of K2's and K7's tensor-core instances holds DMMA
    sass = check_sass(tag, kernels.build_info["so"],
                      str(Path(kernels._nvcc()).parent / "cuobjdump"))
    sass["eri4c"] = eri4c_registers(tag)
    sass["eri3c"] = eri3c_registers(tag)
    sass["stv"] = stv_registers(tag)
    sass["grad"] = grad_registers(tag)

    goldens = json.loads((ROOT / "tests" / "data" /
                          "s22x3_gamess_goldens.json").read_text())
    smoke_ref = json.loads((ROOT / "juliachem_jl_tpu_torch" / "data" /
                            "smoke_reference.json").read_text())
    refs = smoke_ref["systems"]
    refs_corr = smoke_ref["correlated"]["systems"]
    refs_f32 = smoke_ref["f32_b"]["systems"]

    def mark(what):
        print(f"{tag} {what} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    mark("build and SASS checks")
    # 3. kernels vs plain: K1/K2/K3 at benzene_2_water's DF shapes; K4, K5,
    #    K6 at ammonia_trimer's and benzene_2_water's 4-center shapes
    spec = jc.io.parse_input(system_input("benzene_2_water",
                                          goldens["benzene_2_water"]))
    bsets = jc.basis.run(jc.molecule.run(spec), spec.model)
    calls = k1_calls(dev, bsets)
    k1 = check_k1(tag, dev, bsets, calls)
    k1_geometry = {"benzene_2_water": k1_routes(tag, calls)}
    k1_f32 = check_k1_f32(tag, dev, bsets, calls)
    del calls
    k2, k2_f32, k2_f32b = check_k2(tag, dev, bsets,
                                   create_scf_options(spec.scf_keywords))
    k3 = check_k3(tag, dev)
    mark("phase 3 K1, K2, K3")
    # 3s. K9 (S/T/V) against its plain version, every class, at
    #     benzene_2_water in its DF basis, in the f basis and in the g basis
    k9 = {}
    for label, inp in (
            ("benzene_2_water", system_input(
                "benzene_2_water", goldens["benzene_2_water"])),
            (f"benzene_2_water {F_BASIS}", system_input(
                "benzene_2_water", {**goldens["benzene_2_water"],
                                    "basis": F_BASIS})),
            (f"benzene_2_water {G_BASIS}", g_input(
                "benzene_2_water", goldens["benzene_2_water"]))):
        spec_s = jc.io.parse_input(inp)
        mol_s = jc.molecule.run(spec_s)
        k9[label] = check_k9(tag, dev, label,
                             jc.basis.run(mol_s, spec_s.model).primary, mol_s)
    torch.cuda.empty_cache()
    mark("phase 3s K9")
    # K8 at the fold shapes of the paths that launch it: the fitted rows of
    # the aux set of w32's first 8 waters and of w32
    from juliachem_jl_tpu_torch.models.df_screened import fitted_rows
    k8_at = {}
    for label, waters in (("w8", 8), ("w32", None)):
        spec_w = jc.io.parse_input(cluster_input("w32", waters=waters))
        bsets_w = jc.basis.run(jc.molecule.run(spec_w), spec_w.model)
        rows = fitted_rows(bsets_w.auxiliary,
                           create_scf_options(spec_w.scf_keywords))
        k8_at[label] = check_k8(tag, dev, rows, label)
    # K2 at w32's Q-block: the packed builder's block rows for its
    # occupied count on the card
    from juliachem_jl_tpu_torch.models.df_screened import ScreenedDFFockBuilder
    k_w = bsets_w.primary.nels // 2
    qc_w = ScreenedDFFockBuilder.block_rows(bsets_w.primary.nbf, k_w, rows,
                                            dev)
    k2_w, k2f_w, k2b_w = check_k2(tag, dev, bsets_w,
                                  create_scf_options(spec_w.scf_keywords),
                                  "w32 Q-block", k_w, qc_w)
    k1_w32_products = k1_primitive_counts(
        tag, dev, bsets_w, create_scf_options(spec_w.scf_keywords), "w32")
    # K1 on every class of w32 (w8's are among them), its own contractions
    k1_other = {"w32": check_k1(tag, dev, bsets_w, k1_calls(dev, bsets_w),
                                name="eri3c_w32")}
    del bsets_w
    torch.cuda.empty_cache()
    mark("phase 3 K8, K2 and K1 at w32")
    k8 = {**k8_at["w32"], "at_w8_fold": {
        k: v for k, v in k8_at["w8"].items()
        if k not in ("name", "route", "source", "replaces", "library")}}
    k1["primitive_products"] = {
        "benzene_2_water": k1_primitive_counts(
            tag, dev, bsets, create_scf_options(spec.scf_keywords),
            "benzene_2_water"), "w32": k1_w32_products}
    spec_a = jc.io.parse_input(system_input(
        "ammonia_trimer", goldens["ammonia_trimer"], aux=False))
    bsets_a = jc.basis.run(jc.molecule.run(spec_a), spec_a.model)
    fourc = {"ammonia_trimer": check_4c(tag, dev, "ammonia_trimer", bsets_a, 1),
             "benzene_2_water": check_4c(tag, dev, "benzene_2_water", bsets, 2)}
    mark("phase 3 K4, K5, K6")
    # 3f. the f classes (ROADMAP.md B17) at benzene_2_water's shapes in
    #     6-311++G(3df,3pd) / cc-pVTZ-JKFIT: K1 (f64 and the f32 store) on
    #     every (bra | aux) class, (ff|g) alone too; K4, K6, K5 list and K5
    #     staircase on the first SUBSET quartets of every class pair,
    #     (ff|ff) alone too
    bz_f = f"benzene_2_water {F_BASIS}"
    spec_f = jc.io.parse_input(system_input(
        "benzene_2_water", {**goldens["benzene_2_water"], "basis": F_BASIS}))
    bsets_f = jc.basis.run(jc.molecule.run(spec_f), spec_f.model)
    calls = k1_calls(dev, bsets_f)
    k1_f = check_k1(tag, dev, bsets_f, calls, name="eri3c_f",
                    largest=(3, 3, 4))
    k1_geometry[bz_f] = k1_routes(tag, calls)
    k1_f32["f_classes"] = check_k1_f32(tag, dev, bsets_f, calls,
                                       largest=(3, 3, 4))
    del calls
    # ... and in the other f basis of phase 10
    spec_f2 = jc.io.parse_input(system_input(
        "benzene_2_water", {**goldens["benzene_2_water"],
                            "basis": F_BASIS_SMALL}))
    bsets_f2 = jc.basis.run(jc.molecule.run(spec_f2), spec_f2.model)
    k1_other[F_BASIS_SMALL] = check_k1(tag, dev, bsets_f2,
                                       k1_calls(dev, bsets_f2),
                                       name="eri3c_f_small")
    del bsets_f2
    fourc[bz_f] = check_4c(tag, dev, bz_f, bsets_f, 3, largest=(3, 3, 3, 3))
    for name, v in fourc.items():
        f = v["full"]
        print(f"{tag} {name}: {f['quartets']} screened quartets, "
              f"{f['primitive_quartets']} primitive quartets of nonzero "
              f"coefficients ({f['series_primitive_quartets']} on the Boys "
              f"series), {f['padded_primitive_quartets']} with the class "
              f"padding", flush=True)
    mark("phase 3f")
    # 3g. the g classes at benzene_2_water's shapes in 6-311++G(3df,3pd)+G,
    #     read through model.basis_file: K1 (f64 and the f32 store) on every
    #     g bra against every aux class, (gg|g) alone too; K4, K6, K5 list
    #     and K5 staircase on the first SUBSET_G quartets of every class
    #     pair with a g shell, (gg|gg) alone too; the g instances' routes,
    #     registers and spills
    bz_g = f"benzene_2_water {G_BASIS}"
    spec_g = jc.io.parse_input(g_input("benzene_2_water",
                                       goldens["benzene_2_water"]))
    bsets_g = jc.basis.run(jc.molecule.run(spec_g), spec_g.model)
    check(bsets_g.primary.nbf == 1046, f"{bz_g}: nbf {bsets_g.primary.nbf}")
    calls = [c for c in k1_calls(dev, bsets_g) if c["cls"][1] == 4]
    k1_g = check_k1(tag, dev, bsets_g, calls, name="eri3c_g",
                    largest=(4, 4, 4))
    k1_geometry[bz_g] = k1_routes(tag, calls)
    k1_f32["g_classes"] = check_k1_f32(tag, dev, bsets_g, calls,
                                       largest=(4, 4, 4))
    del calls
    fourc[bz_g] = check_4c(tag, dev, bz_g, bsets_g, 4, largest=(4, 4, 4, 4),
                           need_l=4, subset=SUBSET_G)
    sass["g_instances"] = g_instances(tag, sass)
    kern_of = {"lane": ("eri4c_lane_kernel", "eri4c_jk_lane_kernel"),
               "warp": ("eri4c_kernel", "eri4c_jk_kernel"),
               "block": ("eri4c_block_kernel", "eri4c_jk_block_kernel")}
    for v in fourc[bz_g]["per_class"]:
        key = "".join(map(str, v["cls"]))
        v["ptxas"] = {k: sass["eri4c"].get(k, {}).get("classes", {}).get(
            key, {}) for k in (*kern_of[v["route"]],
                               f"digest_jk_{v['k6_route']}_kernel")}
        print(f"{tag} phase 3g class pair " + fmt_class_row(v, v["ptxas"]),
              flush=True)
    print(f"{tag} phase 3g recorded before the block route (the lane and "
          f"warp routes, PERF.md §6): " + "; ".join(
              f"{k} {v}" for k, v in G_RECORDED.items()), flush=True)
    k6_g = fourc[bz_g]["kernels"]["digest_jk"]
    k6_gg = k6_g["largest_class"]
    k6_routes = {}
    for v in fourc[bz_g]["per_class"]:
        r = k6_routes.setdefault(v["k6_route"], [0, 0.0, 0.0])
        r[0] += 1
        r[1] += v["digest_jk"]["ms"]
        r[2] += v["digest_jk"]["bound_ms"]
    print(f"{tag} phase 3g K6 on the g class pairs: {k6_g['ms']:.3f} ms "
          f"(bound {k6_g['bound_ms']:.4f} ms, {k6_g['bound_by']}), (gg|gg) "
          f"alone {k6_gg['ms']:.3f} ms (bound {k6_gg['bound_ms']:.4f} ms); "
          "by K6 route (class pairs, best-of-5 ms, bound ms): " + ", ".join(
              f"{k} {n} {ms:.3f} {b:.4f}"
              for k, (n, ms, b) in sorted(k6_routes.items()))
          + f". K1 on the g classes: {k1_g['ms']:.3f} ms (bound "
          f"{k1_g['bound_ms']:.4f} ms, {k1_g['bound_by']}), (gg|g) alone "
          f"{k1_g['largest_class']['ms']:.3f} ms (bound "
          f"{k1_g['largest_class']['bound_ms']:.4f} ms)", flush=True)
    print(f"{tag} phase 3g recorded before K6's block route and K1's T1 "
          f"body (PERF.md §6): " + "; ".join(
              f"{k} {v}" for k, v in G_K6_K1_RECORDED.items()), flush=True)
    del bsets_g
    # ... and long contractions: one water in the long-contraction g basis,
    # the g class pairs that the block route takes in rounds of primitive
    # pairs among them, K4, K6, K5 list and staircase against the plain
    # versions under the same gates
    long_label = f"water {LONG_BASIS}"
    jc.basis.register_basis_file(str(ROOT / LONG_BASIS_FILE), LONG_BASIS)
    prim_long = jc.basis.build(jc.molecule.from_input_dict(
        {"symbols": ["O", "H", "H"],
         "geometry": [0.0, 0.0, 0.116321, 0.0, 0.751155, -0.465285,
                      0.0, -0.751155, -0.465285]}), LONG_BASIS)
    fourc_long = check_4c(tag, dev, long_label,
                          types.SimpleNamespace(primary=prim_long), 5,
                          need_l=4, subset=SUBSET_LONG)
    rounds = {c: g for c, g in fourc_long["geometry"].items()
              if g["route"] == "block"
              and (g["RB"] < g["Kab"] or g["RK"] < g["Kcd"])}
    check(len(rounds) > 0, f"{long_label}: no class pair runs in rounds")
    print(f"{tag} phase 3g {long_label}: {fourc_long['class_pairs']} class "
          f"pairs, {fourc_long['quartets']} quartets, "
          f"{len(rounds)} in rounds of primitive pairs; max abs err " +
          ", ".join(f"{k} {v['max_abs_err']:.3e}"
                    for k, v in fourc_long["kernels"].items()), flush=True)
    del prim_long
    torch.cuda.empty_cache()
    mark("phase 3g")

    counts = {}
    class_counts = {}

    def path(label, fn):
        kernels.reset_launches()
        res = fn()
        counts[label] = dict(kernels.launches)
        class_counts[label] = {k: dict(v)
                               for k, v in kernels.class_launches.items()}
        print(f"{tag} launches during {label} (done at "
              f"{time.perf_counter() - t_start:.1f} s): "
              f"{ {k: v for k, v in counts[label].items() if v} }", flush=True)
        return res

    # 4. dense-B DF route
    ammonia = path("ammonia_trimer DF", lambda: run_system(
        tag, jc, "ammonia_trimer", goldens["ammonia_trimer"],
        refs["ammonia_trimer"], "DFFockBuilder"))
    # 5. packed DF route
    benzene = path("benzene_2_water DF", lambda: run_system(
        tag, jc, "benzene_2_water", goldens["benzene_2_water"],
        refs["benzene_2_water"], "ScreenedDFFockBuilder",
        {"mixed_precision": False}, k1_times=True))
    # 5a. the same on an f32 B (K1's f32 store, K2's f32-B instance in
    #     every f64 iteration), held to the JAX package's f32-B energy; the
    #     split fold there is recorded, not gated: it does not converge in
    #     either package (smoke_reference.json, f32_b)
    bz_flags = {"mixed_precision": False, "df_b_dtype": "f32"}
    bz_f32 = path("benzene_2_water DF f32 B", lambda: run_system(
        tag, jc, "benzene_2_water", goldens["benzene_2_water"],
        refs_f32["benzene_2_water"], "ScreenedDFFockBuilder", bz_flags))
    jax_bz_split = refs_f32["benzene_2_water split fold"]
    os.environ["JCHEM_SPLIT_FOLD"] = "1"
    try:
        r = jc.run_spec(jc.io.parse_input(system_input(
            "benzene_2_water", goldens["benzene_2_water"], bz_flags)))["Energy"]
    finally:
        del os.environ["JCHEM_SPLIT_FOLD"]
    bz_split = {"system": "benzene_2_water DF f32 B split fold (not gated)",
                "energy": float(r["Energy"]), "converged": bool(r["Converged?"]),
                "iterations": int(r["Iterations"])}
    print(f"{tag} benzene_2_water f32 B: E(f32) - E(f64) = "
          f"{bz_f32['energy'] - benzene['energy']:.3e} Eh (JAX package: "
          f"{refs_f32['benzene_2_water']['energy'] - refs['benzene_2_water']['energy']:.3e});"
          f" split fold (not gated): converged {bz_split['converged']} in "
          f"{bz_split['iterations']} iterations, E = {bz_split['energy']:.6f} "
          f"Eh (JAX package: converged {jax_bz_split['converged']} in "
          f"{jax_bz_split['iterations']}, E = {jax_bz_split['energy']:.6f})",
          flush=True)
    # 5a'. the split fold where it serves: the first 8 waters of w32 (the
    #     packed builder, mixed precision off), f64 B, f32 B, f32 B with
    #     JCHEM_SPLIT_FOLD=1 (K8); f64 and f32 held to the JAX package's,
    #     the split fold to the f64 fold within the DF gate
    w8 = {}
    for key, flags, env in (("f64 B", {}, "0"), ("f32 B", {"df_b_dtype": "f32"}, "0"),
                            ("split fold", {"df_b_dtype": "f32"}, "1")):
        os.environ["JCHEM_SPLIT_FOLD"] = env
        try:
            w8[key] = path(f"w8 {key}", lambda: run_cluster(
                tag, jc, "w32", {**W8_SCF, **flags}, f"w8 {key}", waters=8))
        finally:
            del os.environ["JCHEM_SPLIT_FOLD"]
        ref = refs_f32[f"w8 {key}"]["energy"]
        w8[key]["minus_jax_reference"] = w8[key]["energy"] - ref
    d_split = w8["split fold"]["energy"] - w8["f32 B"]["energy"]
    jax_d_split = (refs_f32["w8 split fold"]["energy"]
                   - refs_f32["w8 f32 B"]["energy"])
    print(f"{tag} w8: E - JAX = {w8['f64 B']['minus_jax_reference']:.3e} (f64 "
          f"B), {w8['f32 B']['minus_jax_reference']:.3e} (f32 B), "
          f"{w8['split fold']['minus_jax_reference']:.3e} (split fold, not "
          f"gated: f32 sums in another order); E(split) - E(f64 fold) = "
          f"{d_split:.3e} Eh (bound {E_GAMESS_TOL}; JAX package "
          f"{jax_d_split:.3e}); E(f32 B) - E(f64 B) = "
          f"{w8['f32 B']['energy'] - w8['f64 B']['energy']:.3e} Eh", flush=True)
    for key in ("f64 B", "f32 B"):
        check(abs(w8[key]["minus_jax_reference"]) <= E_REF_TOL,
              f"w8 {key}: |E - JAX| > {E_REF_TOL}")
    check(abs(d_split) <= E_GAMESS_TOL,
          f"w8 split fold: |E - E(f64 fold)| = {abs(d_split):.3e} > "
          f"{E_GAMESS_TOL}")
    # 5b. K7 at benzene_2_water's full width, on the packed route's orbitals
    k7 = check_k7(tag, dev, benzene["basis"], benzene["result"])
    # 5c. RI-MP2 (SCS) on the same orbitals
    jax_mp2 = refs_corr["benzene_2_water RI-MP2"]["mp2"]
    neutral_mp2 = path("benzene_2_water RI-MP2", lambda: run_mp2(
        tag, "benzene_2_water RI-MP2", benzene, ump2=False))
    d_jax = max(neutral_mp2["E2"] - jax_mp2["E2"],
                neutral_mp2["E2 Opposite Spin"] - jax_mp2["E2 Opposite Spin"],
                key=abs)
    d_plain = neutral_mp2["E2"] - k7["e2_rmp2"]["plain_energy"]
    d_os = (neutral_mp2["E2 Opposite Spin"]
            - k7["e2_rmp2"]["plain_energy_opposite_spin"])
    print(f"{tag} benzene_2_water RI-MP2: E2, E_os - JAX = {d_jax:.3e} Eh "
          f"(bound {E_REF_TOL}), E2 - plain version on the card = "
          f"{d_plain:.3e} Eh, E_os - plain = {d_os:.3e} Eh (bound "
          f"{E2_PLAIN_TOL})", flush=True)
    check(abs(d_jax) <= E_REF_TOL,
          f"RI-MP2: |E2 or E_os - JAX| = {abs(d_jax):.3e} > {E_REF_TOL}")
    check(max(abs(d_plain), abs(d_os)) <= E2_PLAIN_TOL,
          f"RI-MP2: |E2 - plain| = {abs(d_plain):.3e} or |E_os - plain| = "
          f"{abs(d_os):.3e} > {E2_PLAIN_TOL}")
    # 5d. the radical cation: DF-UHF on the packed route, then RI-UMP2; from
    #     SAD its DIIS needs more than 60 iterations (ROADMAP.md C9): niter
    #     150, as in the JAX package's recorded run
    cation_scf = dict(SCF, mixed_precision=False, niter=150)

    def cation_path():
        scf = run_open(tag, jc, "benzene_2_water", goldens["benzene_2_water"],
                       "UHF", 1, 2, "ScreenedDFJKBuilder", cation_scf,
                       trajectory=True)
        return scf, run_mp2(tag, "benzene_2_water cation RI-UMP2", scf,
                            ump2=True)

    label_cat = "benzene_2_water cation DF-UHF + RI-UMP2"
    cation, cation_mp2 = path(label_cat, cation_path)
    check(counts[label_cat]["df_gather_w"] >= 2 * cation["iterations"],
          "cation DF-UHF: K2 did not run for both spins in every iteration")
    check(cation["S2"] >= 0.75 - 1e-9, f"cation S2 {cation['S2']} < 0.75")
    jax_cat = refs_corr["benzene_2_water cation"]
    d_e = cation["energy"] - jax_cat["energy"]
    d_e2 = cation_mp2["E2"] - jax_cat["mp2"]["E2"]
    print(f"{tag} benzene_2_water cation: E(UHF) - JAX = {d_e:.3e} Eh, "
          f"E2 - JAX = {d_e2:.3e} Eh (bound {E_REF_TOL})", flush=True)
    check(abs(d_e) <= E_REF_TOL and abs(d_e2) <= E_REF_TOL,
          "cation: UHF or RI-UMP2 energy off the JAX package's")
    ie_hf = cation["energy"] - benzene["energy"]
    ie_mp2 = cation_mp2["Energy"] - neutral_mp2["Energy"]
    print(f"{tag} benzene_2_water vertical ionisation energy: HF "
          f"{ie_hf:.6f} Eh ({ie_hf * HARTREE_EV:.4f} eV), MP2 {ie_mp2:.6f} Eh "
          f"({ie_mp2 * HARTREE_EV:.4f} eV)", flush=True)
    # 6. conventional, in-core
    ammonia_conv = path("ammonia_trimer conventional", lambda: run_system(
        tag, jc, "ammonia_trimer", goldens["ammonia_trimer"], None,
        "ScreenedDirectFock", {"guess": "sad"}, conventional=True,
        aux=False))
    check(ammonia_conv["incore"] == "True",
          "ammonia_trimer conventional did not run in-core")
    # 6b. the ammonia_trimer cation: conventional UHF and ROHF (in-core),
    #     DF-UHF (dense B)
    g_a = goldens["ammonia_trimer"]
    conv_scf = dict(CONV_SCF, guess="sad")
    amm_uhf = path("ammonia_trimer cation conventional UHF", lambda: run_open(
        tag, jc, "ammonia_trimer", g_a, "UHF", 1, 2, "ScreenedDirectFock",
        conv_scf, aux=False))
    amm_rohf = path("ammonia_trimer cation conventional ROHF",
                    lambda: run_open(tag, jc, "ammonia_trimer", g_a, "ROHF", 1,
                                     2, "ScreenedDirectFock", conv_scf,
                                     aux=False))
    amm_df = path("ammonia_trimer cation DF-UHF", lambda: run_open(
        tag, jc, "ammonia_trimer", g_a, "UHF", 1, 2, "DFFockBuilder", SCF))
    d_df = amm_df["energy"] - amm_uhf["energy"]
    print(f"{tag} ammonia_trimer cation: E(ROHF) - E(UHF) = "
          f"{amm_rohf['energy'] - amm_uhf['energy']:.6e} Eh, ROHF S2 "
          f"{amm_rohf['S2']}, E(DF-UHF) - E(UHF) = {d_df:.3e} Eh", flush=True)
    check(amm_uhf["incore"] == "True" and amm_rohf["incore"] == "True",
          "ammonia_trimer cation conventional did not run in-core")
    check(amm_uhf["energy"] <= amm_rohf["energy"], "E(UHF) > E(ROHF)")
    check(amm_rohf["S2"] == 0.75, "ROHF S2 is not exactly 0.75")
    check(abs(d_df) <= E_DF_UHF_TOL,
          f"|E(DF-UHF) - E(UHF)| = {abs(d_df):.3e} > {E_DF_UHF_TOL}")
    # 6c. the direct and streaming builds at the RHF D and the cation's
    #     UHF (Da, Db), held to the in-core builds
    r_u = amm_uhf["result"]
    Da = 0.5 * (r_u["Density"] + r_u["Spin Density"])
    Db = 0.5 * (r_u["Density"] - r_u["Spin Density"])
    builds = builds_at(tag, dev, bsets_a.primary, ammonia_conv["density"],
                       Da, Db,
                       scf_fock_s=ammonia_conv["fock_s_per_iter_f64_steady"])
    counts["ammonia_trimer direct build"] = builds["direct"]["launches"]
    counts["ammonia_trimer streaming build"] = builds["streaming"]["launches"]
    # 6d. identities at full width: closed-shell UHF = RHF; RI-UMP2 = RI-MP2
    #     on one closed-shell DF-UHF reference
    amm_singlet = path("ammonia_trimer conventional UHF singlet",
                       lambda: run_open(tag, jc, "ammonia_trimer", g_a, "UHF",
                                        0, 1, "ScreenedDirectFock", conv_scf,
                                        aux=False))
    d_id = amm_singlet["energy"] - ammonia_conv["energy"]

    def identity_path():
        u = run_open(tag, jc, "ammonia_trimer", g_a, "UHF", 0, 1,
                     "DFFockBuilder", SCF)
        return (run_mp2(tag, "ammonia_trimer DF-UHF singlet RI-MP2", u, False),
                run_mp2(tag, "ammonia_trimer DF-UHF singlet RI-UMP2", u, True))

    m_r, m_u = path("ammonia_trimer DF-UHF singlet MP2 identity",
                    identity_path)
    d_mp2 = m_u["E2"] - m_r["E2"]
    print(f"{tag} ammonia_trimer identities: E(UHF singlet) - E(RHF) = "
          f"{d_id:.3e} Eh (bound 1e-8); RI-UMP2 - RI-MP2 on one closed-shell "
          f"DF-UHF reference = {d_mp2:.3e} Eh (bound 1e-10)", flush=True)
    check(abs(d_id) <= 1e-8, f"|E(UHF singlet) - E(RHF)| = {abs(d_id):.3e}")
    check(abs(d_mp2) <= 1e-10, f"|RI-UMP2 - RI-MP2| = {abs(d_mp2):.3e}")
    # 6e. the incremental Fock: conventional in-core (K6 digests the
    #     indefinite dD) and dense DF with f32 increments
    amm_fdiff = path("ammonia_trimer conventional fdiff", lambda: run_system(
        tag, jc, "ammonia_trimer", g_a, None, "ScreenedDirectFock",
        {"guess": "sad", "fdiff": True}, conventional=True, aux=False))
    amm_df_fdiff = path("ammonia_trimer DF fdiff f32", lambda: run_system(
        tag, jc, "ammonia_trimer", g_a, refs["ammonia_trimer"],
        "DFFockBuilder", {"fdiff": True, "fdiff_f32": True}))
    d_fc = amm_fdiff["energy"] - ammonia_conv["energy"]
    d_fd = amm_df_fdiff["energy"] - ammonia["energy"]
    print(f"{tag} ammonia_trimer fdiff: conventional {amm_fdiff['iterations']} "
          f"iterations (full builds: {ammonia_conv['iterations']}), E - E(full)"
          f" = {d_fc:.3e} Eh; dense DF with f32 increments "
          f"{amm_df_fdiff['iterations']} iterations (full builds: "
          f"{ammonia['iterations']}), E - E(full) = {d_fd:.3e} Eh (bound "
          f"{E_FDIFF_TOL})", flush=True)
    check(abs(d_fc) <= E_FDIFF_TOL and abs(d_fd) <= E_FDIFF_TOL,
          "fdiff: energy off the full-build run's")
    # 7. conventional through the DF guess, streaming route; the DF guess
    #    starts from the core Hamiltonian, where the dynamic damping makes
    #    the SCF oscillate on this system (ROADMAP.md C8): damp off
    benzene_conv = path("benzene_2_water conventional", lambda: run_system(
        tag, jc, "benzene_2_water", goldens["benzene_2_water"], None,
        "StreamingDirectFock",
        {"guess": "df", "mixed_precision": False, "damp": False},
        conventional=True))
    check(benzene_conv["df_guess_builder"] == "ScreenedDFFockBuilder",
          "benzene_2_water DF guess did not use the packed builder")
    print(f"{tag} benzene_2_water conventional: "
          f"{benzene_conv['fock_s_per_iter_f64_steady']:.4f} s/iter over "
          f"{benzene_conv['f64_steady_iters']} steady conventional iterations",
          flush=True)
    # 7a. one build at that path's converged D class pair by class pair,
    #     each launch timed alone, with the route each class pair was
    #     compiled with; every class pair of L <= 3 that the path launched
    #     is on the lane route
    stair_classes = stair_class_times(tag, dev, benzene_conv["basis"].primary,
                                      benzene_conv["density"],
                                      "benzene_2_water", compiled_route,
                                      warm=False)
    built = {tuple(v["cls"]): v["route"] for v in stair_classes["classes"]}
    stair_launched = class_counts["benzene_2_water conventional"].get(
        "eri4c_jk_stair", {})
    low = [c for c in stair_launched if sum(c) <= 3]
    check(len(low) == 8 and all(built.get(c) == "lane" for c in low),
          f"benzene_2_water conventional: L <= 3 class pairs {sorted(low)} "
          "not all launched on the lane route")
    print(f"{tag} benzene_2_water conventional: K5 staircase launches by "
          "route as compiled: " + ", ".join(
              f"{c} {built.get(c)} {n}"
              for c, n in sorted(stair_launched.items())), flush=True)
    # 8. the large-system chain at w32 (6-31+G* / cc-pVTZ-JKFIT, nbf 736):
    #    (a) f64 B; (b) f32 B with the B, raw-3c and one-electron caches
    #    and checkpoints; (c) again from (b)'s caches and checkpoint.  (c)
    #    restarts from a converged state, so it runs without the f32 phase,
    #    whose first f32 iteration would move the density off it, and
    #    accepts |dE| <= E_RESTART_TOL (the gate on E(c) - E(b)): the
    #    first iterations after a restart, without DIIS history, move E by
    #    ~1e-10 Eh, which (b)'s dele of 1e-10 would not let pass.
    tmp = tempfile.mkdtemp(prefix="jchem_smoke_")
    try:
        cache = os.path.join(tmp, "w32")
        ckpt = os.path.join(tmp, "w32_ckpt.npz")
        w32a = path("w32 f64 B", lambda: run_cluster(
            tag, jc, "w32", {"bench_fock_reps": 4}, "w32 f64 B",
            measure_build=True, k1_times=True, keep_density=True, stv=True))
        w32b = path("w32 f32 B", lambda: run_cluster(
            tag, jc, "w32", {"df_b_dtype": "f32", "df_b_cache": cache,
                             "oei_cache": cache, "checkpoint": ckpt,
                             "bench_fock_reps": 4}, "w32 f32 B",
            measure_build=True, k1_times=True))
        w32c = path("w32 f32 B from the caches", lambda: run_cluster(
            tag, jc, "w32", {"df_b_dtype": "f32", "df_b_cache": cache,
                             "oei_cache": cache, "restart": ckpt,
                             "mixed_precision": False,
                             "dele": E_RESTART_TOL},
            "w32 f32 B from the caches"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # 8d. the split fold (K8) at w32, recorded beside the f64 fold of the
    #     same f32 B, not gated: at this size it lies outside the DF gate
    os.environ["JCHEM_SPLIT_FOLD"] = "1"
    try:
        w32s = path("w32 split fold", lambda: run_cluster(
            tag, jc, "w32", {"df_b_dtype": "f32"}, "w32 split fold",
            gated=False))
    finally:
        del os.environ["JCHEM_SPLIT_FOLD"]
    w32s["minus_f64_fold"] = w32s["energy"] - w32b["energy"]
    print(f"{tag} w32 split fold (not gated): converged {w32s['converged']} "
          f"in {w32s['iterations']} iterations, E(split) - E(f64 fold) = "
          f"{w32s['minus_f64_fold']:.3e} Eh (the DF gate {E_GAMESS_TOL}; w8: "
          f"{d_split:.3e})", flush=True)
    d_ab = w32b["energy"] - w32a["energy"]
    w32b["minus_f64_B"] = d_ab
    d_bc = w32c["energy"] - w32b["energy"]
    peak_ratio = w32b["build_peak_device_bytes"] / w32a["build_peak_device_bytes"]
    print(f"{tag} w32: E(f32 B) - E(f64 B) = {d_ab:.3e} Eh (bound "
          f"{E_F32_B_TOL}; the JAX package's test allows 5e-5 at one "
          f"water); B bytes {w32b['B_bytes']} vs {w32a['B_bytes']}; build peak "
          f"ratio {peak_ratio:.3f} (bound 0.5); from the caches: "
          f"{w32c['iterations']} iterations, E - E(f32 B) = {d_bc:.3e} Eh "
          f"(bound {E_RESTART_TOL}), 3-center time "
          f"{w32c['setup_s']['three_center']}, B checksum equal "
          f"{w32c['B_checksum'] == w32b['B_checksum']}", flush=True)
    check(abs(d_ab) <= E_F32_B_TOL, f"w32: |E(f32 B) - E(f64 B)| = {abs(d_ab):.3e}")
    check(2 * w32b["B_bytes"] == w32a["B_bytes"], "w32: f32 B is not half the bytes")
    check(peak_ratio <= 0.5, f"w32: f32 build peak / f64 = {peak_ratio:.3f} > 0.5")
    check(w32b["loaded_B_cache"] is False and w32c["loaded_B_cache"],
          "w32: the B cache was not written and read")
    check(not w32c["setup_s"]["three_center"],
          "w32 from the caches built a 3-center tensor")
    check(w32c["setup_s"]["H"] is None,
          "w32 from the caches built S/T/V (the restart carries them)")
    check(w32c["B_checksum"] == w32b["B_checksum"],
          "w32: the cached B differs from the one built")
    check(w32c["iterations"] <= 2,
          f"w32 from the caches took {w32c['iterations']} iterations")
    check(abs(d_bc) <= E_RESTART_TOL, f"w32 restart: |dE| = {abs(d_bc):.3e}")
    # 9. the sharded programs: gloo groups of 2 and 4 ranks sharing this
    #    card, NCCL at world 1, NCCL across cards where there are several;
    #    the single-device references of the same builds first
    from juliachem_jl_tpu_torch.models.df_screened_jk import ScreenedDFJKBuilder
    from juliachem_jl_tpu_torch.ops.fock_stream import StreamingDirectFock

    D_bz, bsets_bz = benzene["density"], benzene["basis"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    G_stream = StreamingDirectFock(bsets_bz.primary, device=dev
                                   ).two_electron_fock(D_bz, 1, None)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    fb = ScreenedDFJKBuilder.build(bsets_bz.primary, bsets_bz.auxiliary,
                                   create_scf_options({"scf_type": "df"}), dev)
    packed_ms = packed_build_times(fb, D_bz)
    G_df = torch.as_tensor(packed_ms.pop("G"), device=dev)
    fb.finalize()
    del fb
    print(f"{tag} benzene_2_water one device at the converged D: staircase "
          f"build {stream_s:.3f} s; packed build ms " + ", ".join(
              f"{k} {v:.3f}" for k, v in packed_ms.items()
              if k.endswith("_ms")) + "; its K pass split, ms (CUDA events): "
          + "; ".join(f"{dt} " + ", ".join(f"{k} {x:.3f}" for k, x in v.items())
                      for dt, v in packed_ms["k_pass_split"].items()),
          flush=True)
    cation_tight = run_open(tag, jc, "benzene_2_water", goldens["benzene_2_water"],
                            "UHF", 1, 2, "ScreenedDFJKBuilder", CATION_TIGHT)
    cation_tight.pop("result"), cation_tight.pop("basis")
    single = {"benzene": benzene["energy"], "cation": cation_tight["energy"],
              "cation_iterations": cation_tight["iterations"],
              "e2": neutral_mp2["E2"], "ammonia_conv": ammonia_conv["energy"],
              "w32": w32a["energy"], "w32_B_bytes": w32a["B_bytes"],
              "benzene_D": D_bz.cpu().numpy(),
              "stream_G": G_stream.cpu().numpy(), "df_G": G_df.cpu().numpy(),
              "stream_s": stream_s, "ammonia_D": ammonia["density"].cpu().numpy(),
              "packed_ms": {k: v for k, v in packed_ms.items()
                            if k.endswith("_ms")}}
    del G_stream, G_df
    torch.cuda.empty_cache()   # the ranks share this card's memory
    t0 = time.perf_counter()
    sharded = run_sharded(tag, jc, goldens, refs, single)
    sharded_s = time.perf_counter() - t0
    sharded["single_stream_build_s"] = stream_s
    print(f"{tag} phase 9 (sharded) took {sharded_s:.1f} s", flush=True)
    for n in (2, 4):
        for r in sharded[f"gloo {n}"]["ranks"]:
            for label, v in r.items():
                if isinstance(v, dict) and "launches" in v:
                    c = counts.setdefault(f"gloo {n} {label} (all ranks)",
                                          {})
                    for k, m in v["launches"].items():
                        c[k] = c.get(k, 0) + m
    # 10. the f bases end to end (ROADMAP.md B17): (a) benzene_2_water
    #     DF-RHF in 6-311++G(3df,3pd) (nbf 851, packed B) and (b) in
    #     6-31G(2df,p) (nbf 515, packed B); (c) ammonia_trimer conventional
    #     in 6-31G(2df,p) (in-core: K4 fills, K6 digests), then at its
    #     density one direct (K5 list) and one streaming (K5 staircase)
    #     build held to the in-core one; (d) the first 2 waters of w32 in
    #     6-31G(2df,p), conventional from SAD.  (a), (b) and (d) are held
    #     to the JAX package's energies, (a) also to lie below (b)
    t_f = time.perf_counter()
    refs_fs = smoke_ref["f_shell"]["systems"]
    g_bz, g_am = goldens["benzene_2_water"], goldens["ammonia_trimer"]
    df_nomp = {"mixed_precision": False}
    label_fa, label_fb = f"{bz_f} DF", f"benzene_2_water {F_BASIS_SMALL} DF"
    label_fc = f"ammonia_trimer {F_BASIS_SMALL} conventional"
    label_fd = f"w2 {F_BASIS_SMALL} conventional"
    f_a = path(label_fa, lambda: run_system(
        tag, jc, bz_f, None, refs_fs[f"{bz_f} DF"], "ScreenedDFFockBuilder",
        inp=system_input("benzene_2_water", {**g_bz, "basis": F_BASIS},
                         df_nomp)))
    f_b = path(label_fb, lambda: run_system(
        tag, jc, f"benzene_2_water {F_BASIS_SMALL}", None,
        refs_fs[f"benzene_2_water {F_BASIS_SMALL} DF"],
        "ScreenedDFFockBuilder",
        inp=system_input("benzene_2_water", {**g_bz, "basis": F_BASIS_SMALL},
                         df_nomp)))
    check(f_a["energy"] < f_b["energy"],
          f"{bz_f}: E = {f_a['energy']:.8f} is not below the smaller "
          f"basis's {f_b['energy']:.8f}")
    f_c = path(label_fc, lambda: run_system(
        tag, jc, f"ammonia_trimer {F_BASIS_SMALL}", None, None,
        "ScreenedDirectFock", conventional=True,
        inp=system_input("ammonia_trimer", {**g_am, "basis": F_BASIS_SMALL},
                         {"guess": "sad"}, CONV_SCF, aux=False)))
    check(f_c["incore"] == "True", f"{label_fc} did not run in-core")
    D_c = f_c["density"]
    builds_f = builds_at(tag, dev, f_c["basis"].primary, D_c, 0.5 * D_c,
                         0.5 * D_c, name=f"ammonia_trimer {F_BASIS_SMALL}",
                         scf_fock_s=f_c["fock_s_per_iter_f64_steady"])
    for k in ("direct", "streaming"):
        counts[f"{label_fc} {k} build"] = builds_f[k]["launches"]
        class_counts[f"{label_fc} {k} build"] = builds_f[k]["class_launches"]
    f_d = path(label_fd, lambda: run_system(
        tag, jc, f"w2 {F_BASIS_SMALL}", None,
        refs_fs[f"w2 {F_BASIS_SMALL} RHF"], "ScreenedDirectFock",
        inp=w2_input(F_BASIS_SMALL)))

    def f_launches(label, name):   # launches of a kernel's f classes
        return sum(n for c, n in class_counts[label].get(name, {}).items()
                   if 3 in c)

    ff = class_counts[label_fa].get("eri4c", {}).get((3, 3, 3, 3), 0)
    check(ff > 0, f"K4 never launched (ff|ff) on {label_fa} (SAD atoms, "
          "Schwarz diagonal)")
    f_main = {"eri3c": label_fa, "stv": label_fa, "eri4c": label_fc,
              "digest_jk": label_fc,
              "eri4c_jk_list": f"{label_fc} direct build",
              "eri4c_jk_stair": f"{label_fc} streaming build"}
    for name, label in f_main.items():
        check(f_launches(label, name) > 0,
              f"kernel {name} never launched an f class on {label}")
    f_s = time.perf_counter() - t_f
    print(f"{tag} phase 10 (f bases) took {f_s:.1f} s; (ff|ff) launches of "
          f"K4 on {label_fa}: {ff}; f-class launches per kernel: " + ", ".join(
              f"{n} {f_launches(lb, n)} ({lb})" for n, lb in f_main.items()),
          flush=True)
    # 11. the g basis end to end, through model.basis_file: (a)
    #     benzene_2_water DF-RHF in 6-311++G(3df,3pd)+G (nbf 1046, packed
    #     B), held to the JAX package's energy where one is recorded and
    #     below the 3df energy of phase 10; (a') ethene_ethyne_2 DF-RHF (nbf
    #     512, dense B, a G shell on each of its 4 C), held to the JAX
    #     package's energy; (b) the first 2 waters of w32 conventional
    #     in-core from SAD (nbf 196, a G shell on each O), held to the JAX
    #     package's energy; at its density one direct (K5 list) and one
    #     streaming (K5 staircase) build held to the in-core one, and K6
    #     timed a build
    t_g = time.perf_counter()
    refs_gs = smoke_ref["g_shell"]["systems"]
    label_ga = f"{bz_g} DF"
    label_gb = f"w2 {G_BASIS} conventional"
    g_a = path(label_ga, lambda: run_system(
        tag, jc, bz_g, None, refs_gs.get(f"{bz_g} DF"),
        "ScreenedDFFockBuilder",
        inp=g_input("benzene_2_water", g_bz, df_nomp), k1_times=True))
    k1_g_build = k1_class_sum(g_a["k1_times"]["three_center"],
                              lambda c: c[1] == 4)
    print(f"{tag} {label_ga}: K1's g classes in its 3-center build(s) "
          f"{k1_g_build['ms']:.3f} ms in {k1_g_build['launches']} launches "
          f"(bound {k1_g_build['bound_ms']:.4f} ms), the largest "
          f"{k1_g_build['largest']} {k1_g_build['largest_ms']:.3f} ms; "
          "recorded before the T1 body: "
          f"{G_K6_K1_RECORDED['eri3c 3-center build']}", flush=True)
    check(g_a["energy"] < f_a["energy"],
          f"{bz_g}: E = {g_a['energy']:.8f} is not below the 3df basis's "
          f"{f_a['energy']:.8f}")
    label_gc = f"ethene_ethyne_2 {G_BASIS} DF"
    g_c = path(label_gc, lambda: run_system(
        tag, jc, f"ethene_ethyne_2 {G_BASIS}", None, refs_gs[label_gc],
        "DFFockBuilder",
        inp=g_input("ethene_ethyne_2", goldens["ethene_ethyne_2"], df_nomp)))
    g_b = path(label_gb, lambda: run_system(
        tag, jc, f"w2 {G_BASIS}", None, refs_gs[f"w2 {G_BASIS} RHF"],
        "ScreenedDirectFock",
        inp=w2_input(G_BASIS, G_BASIS_FILE)))
    check(g_b["incore"] == "True", f"{label_gb} did not run in-core")
    D_g = g_b["density"]
    builds_g = builds_at(tag, dev, g_b["basis"].primary, D_g, 0.5 * D_g,
                         0.5 * D_g, name=f"w2 {G_BASIS}",
                         scf_fock_s=g_b["fock_s_per_iter_f64_steady"])
    k6_w2 = builds_g["incore"]["k6"]
    print(f"{tag} w2 {G_BASIS}: K6 {k6_w2['ms']:.3f} ms an in-core build "
          f"(bound {k6_w2['bound_ms']:.4f} ms, {k6_w2['bound_by']}), by K6 "
          "route (class pairs, ms, bound ms): " + ", ".join(
              f"{k} {v['class_pairs']} {v['ms']:.3f} {v['bound_ms']:.4f}"
              for k, v in sorted(k6_w2["by_route"].items()))
          + "; recorded before the block route: "
          f"{G_K6_K1_RECORDED['digest_jk in-core build of w2']}", flush=True)
    for k in ("direct", "streaming"):
        counts[f"{label_gb} {k} build"] = builds_g[k]["launches"]
        class_counts[f"{label_gb} {k} build"] = builds_g[k]["class_launches"]

    def g_launches(label, name):   # launches of a kernel's g classes (K1:
        # of a g bra)
        return sum(n for c, n in class_counts[label].get(name, {}).items()
                   if 4 in (c[:2] if name == "eri3c" else c))

    gg = {lb: class_counts[lb].get("eri4c", {}).get((4, 4, 4, 4), 0)
          for lb in (label_ga, label_gb)}
    check(gg[label_ga] > 0, f"K4 never launched (gg|gg) on {label_ga} (SAD "
          "atoms, Schwarz diagonal)")
    g_main = {"eri3c": label_ga, "stv": label_ga, "eri4c": label_gb,
              "digest_jk": label_gb,
              "eri4c_jk_list": f"{label_gb} direct build",
              "eri4c_jk_stair": f"{label_gb} streaming build"}
    for name, label in g_main.items():
        check(g_launches(label, name) > 0,
              f"kernel {name} never launched a g class on {label}")
    g_s = time.perf_counter() - t_g
    print(f"{tag} phase 11 (g basis) took {g_s:.1f} s; (gg|gg) launches of "
          f"K4: " + ", ".join(f"{n} ({lb})" for lb, n in gg.items())
          + "; g-class launches per kernel: " + ", ".join(
              f"{n} {g_launches(lb, n)} ({lb})" for n, lb in g_main.items()),
          flush=True)
    # 12. the spherical-harmonic AO basis and the nuclear derivatives
    derivatives = run_phase12(
        tag, jc, path, counts, smoke_ref["derivatives"]["systems"], benzene,
        system_input("benzene_2_water", goldens["benzene_2_water"],
                     {"mixed_precision": False}), 491)
    # 13. the host-streamed B
    streamed = run_phase13(tag, jc, path, counts, w32a, cation)
    jc.finalize()

    # K2's f32 instance on every mixed-precision phase of a packed run
    f32_phase = f32_phase_k2(tag, counts, {
        "w32 f64 B": w32a, "w32 f32 B": w32b, "w32 split fold": w32s,
        "w32 stream B32": streamed["w32_stream_b32"],
        "w32 stream B32 from the B cache": streamed["w32_from_cache"],
        "w32 stream": streamed["w32_stream"],
        "w64 f64 B defaults": streamed["w64_defaults"]})
    check(f32_phase["w32 f64 B"]["launches"] > 0
          and f32_phase["w64 f64 B defaults"]["launches"] > 0,
          "K2's f32 instance never launched on w32 f64 B or w64 defaults")
    # each kernel's launches on its path
    main_path = {"eri3c": "benzene_2_water DF", "df_gather_w": "benzene_2_water DF",
                 "eri3c_f32": "w32 f32 B", "df_gather_w_f32b": "w32 f32 B",
                 "split_fold": "w32 split fold",
                 "eri4c": "ammonia_trimer conventional",
                 "digest_jk": "ammonia_trimer conventional",
                 "eri4c_jk_list": "ammonia_trimer direct build",
                 "eri4c_jk_stair": "benzene_2_water conventional",
                 "e2_rmp2": "benzene_2_water RI-MP2", "e2_ss": label_cat,
                 "e2_os": label_cat, "stv": "benzene_2_water DF"}
    for name, label in (*main_path.items(), ("split_fold", "w8 split fold")):
        check(counts[label].get(name, 0) > 0,
              f"kernel {name} never launched on {label}")
    for k in (k1, k1_f32, k2, k2_f32b, k8):
        k["launches"] = counts[main_path[k["name"]]][k["name"]]
        k["path"] = main_path[k["name"]]
    # K2 at w32's Q-block, on the w32 paths (f64 B, f32 B)
    for k, label in ((k2_w, "w32 f64 B"), (k2b_w, "w32 f32 B")):
        k["launches"] = counts[label][k["name"]]
        k["path"] = label
        k["name"] += "_w32"
    check(k2_w["launches"] > 0, "kernel df_gather_w never launched on w32 f64 B")
    # K2's f32 instance at w32's Q-block on the f32 phase of w32 f64 B, its
    # benzene_2_water and w64 Q-blocks beside
    def shapes_only(v):
        return {key: x for key, x in v.items()
                if key not in ("name", "route", "source", "replaces")}

    k2f = {**k2f_w, "launches": f32_phase["w32 f64 B"]["launches"],
           "path": "w32 f64 B",
           "at_w64_q_block": {
               **shapes_only(streamed["k2_w64"]["f32"]),
               "launches": f32_phase["w64 f64 B defaults"]["launches"],
               "path": "w64 f64 B defaults"},
           "at_benzene_2_water": shapes_only(k2_f32)}
    k8["at_w8_fold"]["launches"] = counts["w8 split fold"]["split_fold"]
    k8["at_w8_fold"]["path"] = "w8 split fold"
    k3["launches"] = counts["benzene_2_water DF"]["boys_probe"]
    shapes = {"eri4c": "ammonia_trimer", "digest_jk": "ammonia_trimer",
              "eri4c_jk_list": "ammonia_trimer",
              "eri4c_jk_stair": "benzene_2_water"}
    meta = {
        "eri4c": ("juliachem_jl_tpu_torch/csrc/eri4c.cuh",
                  "juliachem_jl_tpu/ops/eri.py:45"),
        "digest_jk": ("juliachem_jl_tpu_torch/csrc/eri4c.cuh",
                      "juliachem_jl_tpu/ops/fock.py:344"),
        "eri4c_jk_list": ("juliachem_jl_tpu_torch/csrc/eri4c.cuh",
                          "juliachem_jl_tpu/ops/fock.py:323"),
        "eri4c_jk_stair": ("juliachem_jl_tpu_torch/csrc/eri4c.cuh",
                           "juliachem_jl_tpu/ops/fock_stream.py:92")}
    new_kernels = []
    for name, (src, rep) in meta.items():
        v = fourc[shapes[name]]["kernels"][name]
        new_kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": counts[main_path[name]][name], "path": main_path[name],
            "shapes": shapes[name], "max_abs_err": v["max_abs_err"],
            "ms": v["ms"], "plain_ms": v["plain_ms"],
            "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
            "library_ms": None})
    # K6 at the full in-core size: one build's launches (phase 6c, 10c)
    def k6_build(b):
        v = b["incore"]["k6"]
        return {k: v[k] for k in ("system", "quartets", "launches", "ms",
                                  "bound_ms", "bound_by", "by_route",
                                  "cached_build_wall_ms",
                                  "scf_fock_s_per_iter")}

    for k in new_kernels:
        if k["name"] == "digest_jk":
            k["per_build"] = k6_build(builds)
    # the kernels' ranges, on the sharded paths (launches of all ranks of
    # the 2-rank group: each launch is one rank's range)
    main_path.update({"e2_rmp2_range": "gloo 2 c RI-MP2 (all ranks)",
                      "eri4c_jk_stair_t0":
                          "gloo 2 e streaming build (all ranks)"})
    counter = {"e2_rmp2_range": "e2_rmp2", "eri4c_jk_stair_t0": "eri4c_jk_stair"}
    for name in ("e2_rmp2_range", "eri4c_jk_stair_t0"):
        check(counts[main_path[name]].get(counter[name], 0) > 0,
              f"kernel {name} never launched on {main_path[name]}")
    v = fourc["benzene_2_water"]["kernels"]["eri4c_jk_stair_t0"]
    new_kernels.append({
        "name": "eri4c_jk_stair_t0", "route": "cuda",
        "source": "juliachem_jl_tpu_torch/csrc/eri4c.cuh",
        "replaces": "juliachem_jl_tpu/ops/fock_stream.py:170",
        "launches": counts[main_path["eri4c_jk_stair_t0"]]["eri4c_jk_stair"],
        "path": main_path["eri4c_jk_stair_t0"], "shapes": "benzene_2_water",
        "max_abs_err": v["max_abs_err"], "ms": v["ms"],
        "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
        "bound_by": v["bound_by"], "library_ms": None})
    for name, v in k7.items():
        v["launches"] = counts[main_path[name]][counter.get(name, name)]
        v["path"] = main_path[name]
    # the f classes (phase 3f at benzene_2_water's 6-311++G(3df,3pd)
    # shapes), launches of their f classes on phase 10's paths
    f_kernels = [{**k1_f, "launches": f_launches(label_fa, "eri3c"),
                  "path": label_fa, "shapes": bz_f}]
    for name, (src, rep) in meta.items():
        v = fourc[bz_f]["kernels"][name]
        f_kernels.append({
            "name": f"{name}_f", "route": "cuda", "source": src,
            "replaces": rep, "launches": f_launches(f_main[name], name),
            "path": f_main[name], "shapes": bz_f,
            "max_abs_err": v["max_abs_err"], "ms": v["ms"],
            "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
            "bound_by": v["bound_by"], "library_ms": None,
            "largest_class": v["largest_class"]})
    f_kernels[[k["name"] for k in f_kernels].index("digest_jk_f")].update(
        per_build=k6_build(builds_f))
    # the g classes (phase 3g at benzene_2_water's 6-311++G(3df,3pd)+G
    # shapes), launches of their g classes on phase 11's paths
    g_kernels = [{**k1_g, "launches": g_launches(label_ga, "eri3c"),
                  "path": label_ga, "shapes": bz_g}]
    for name, (src, rep) in meta.items():
        v = fourc[bz_g]["kernels"][name]
        g_kernels.append({
            "name": f"{name}_g", "route": "cuda", "source": src,
            "replaces": rep, "launches": g_launches(g_main[name], name),
            "path": g_main[name], "shapes": bz_g,
            "max_abs_err": v["max_abs_err"], "ms": v["ms"],
            "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
            "bound_by": v["bound_by"], "library_ms": None,
            "largest_class": v["largest_class"]})
    g_kernels[[k["name"] for k in g_kernels].index("digest_jk_g")].update(
        per_build=k6_build(builds_g))
    # K9 at benzene_2_water's shapes (phase 3s), launches on its DF path;
    # at w32 and w64 on their SCF paths; the f and g classes on phase 10's
    # and 11's DF paths
    w64e = streamed["w64_defaults"]
    k9_line = {**k9["benzene_2_water"],
               "launches": counts["benzene_2_water DF"]["stv"],
               "path": "benzene_2_water DF",
               "at_w32": {**w32a["stv"], "launches": counts["w32 f64 B"]["stv"],
                          "path": "w32 f64 B",
                          "H_s": w32a["setup_s"]["H"]},
               "at_w64": {**w64e["stv"],
                          "launches": counts["w64 f64 B defaults"]["stv"],
                          "path": "w64 f64 B defaults",
                          "H_s": w64e["setup_s"]["H"]}}
    k9_f = {**k9[bz_f], "name": "stv_f", "launches": f_launches(label_fa, "stv"),
            "path": label_fa}
    k9_g = {**k9[bz_g], "name": "stv_g", "launches": g_launches(label_ga, "stv"),
            "path": label_ga}
    # K10 and K11 at benzene_2_water's spherical DF gradient (phase 12),
    # launches on its path; at w8 beside, at w32 the parts of its gradient
    gk = derivatives["gradient_kernels"]
    l_bz, l_w8, l_w32 = ("benzene_2_water spherical DF gradient",
                         "w8 DF gradient", "w32 DF gradient")
    part_of = {"stv_grad": "one_electron",
               "eri3c_grad": "three_center_derivative",
               "metric_grad": "metric_derivative"}
    grad_line = []
    for name, part in part_of.items():
        w32_part = derivatives["gradients"][l_w32]["parts"][part]
        grad_line.append({
            **gk[l_bz][name], "launches": counts[l_bz][name], "path": l_bz,
            "registers": sass["grad"][
                "stv_grad_kernel" if name == "stv_grad"
                else "eri3c_grad_kernel"],
            "at_w8": {**shapes_only(gk[l_w8][name]),
                      "launches": counts[l_w8][name], "path": l_w8},
            "at_w32": {"launches": counts[l_w32][name], "path": l_w32,
                       "part": part, "part_ms": w32_part["ms"],
                       "part_bound_ms": w32_part["bound_ms"],
                       "part_bound_by": w32_part["bound_by"]}})
    kern_line = ([k1, k2, k2f] + new_kernels + list(k7.values())
                 + [k8, k1_f32, k2_f32b, k2_w, k2b_w] + f_kernels + g_kernels
                 + [k9_line, k9_f, k9_g] + grad_line)

    systems = [ammonia, benzene, bz_f32, bz_split, *w8.values(),
               ammonia_conv, benzene_conv,
               cation, amm_uhf, amm_rohf, amm_df, amm_singlet, amm_fdiff,
               amm_df_fdiff, w32a, w32b, w32c, w32s, f_a, f_b, f_c, f_d,
               g_a, g_b, g_c]
    for x in systems:
        for key in ("density", "result", "basis"):
            x.pop(key, None)
    correlated = {"benzene_2_water RI-MP2": neutral_mp2,
                  "benzene_2_water cation RI-UMP2": cation_mp2,
                  "ammonia_trimer singlet RI-MP2": m_r,
                  "ammonia_trimer singlet RI-UMP2": m_u,
                  "ionisation_energy_eV": {"HF": ie_hf * HARTREE_EV,
                                           "MP2": ie_mp2 * HARTREE_EV}}
    total_s = time.perf_counter() - t_start
    if args.out:
        Path(args.out).write_text(json.dumps(str_keys({
            "device": kind, "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda, "build_s": build_s, "total_s": total_s,
            "build_per_source_s": per_source,
            "build_log": kernels.build_info.get("log", ""),
            "spills": spills, "sass": sass, "kernels": kern_line,
            "k1_geometry": k1_geometry, "k1_other_bases": k1_other,
            "probes": [k3],
            "four_center": {k: {kk: vv for kk, vv in v.items()}
                            for k, v in fourc.items()},
            "builds_at_ammonia_convergence": builds,
            "stair_classes_benzene_2_water": stair_classes,
            "launches_per_path": counts,
            "class_launches_per_path": class_counts,
            "systems": systems,
            "f_shell": {"builds_at_ammonia_convergence": builds_f,
                        "seconds": f_s},
            "g_shell": {"builds_at_w2_convergence": builds_g,
                        "seconds": g_s, "gg_gg_launches": gg},
            "correlated": correlated, "sharded": sharded,
            "derivatives": derivatives, "f32_phase_k2": f32_phase,
            "host_streamed_B": {k: v for k, v in streamed.items()}}), indent=1,
            default=str))
    print(f"{tag} chip_smoke: all phases passed in {total_s:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": kern_line, "probes": [k3]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:  # any failed phase: report it and exit nonzero
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
