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
# K2's tile, rows of m per slab and columns of n per block: the kernel is
# built with them (csrc/df_gather_w.cu) and models/df_screened.py::k2_slabs
# lists its live slabs on the same tiles
K2_SLAB_M, K2_TILE_N = 16, 64
# K2's f32 instance (csrc/df_gather_w.cu, FP32 FMA): rows q and orbitals a
# block, and slabs in flight in its cp.async ring.  Chosen from the card's
# times at the Q-blocks of benzene_2_water, w32 and w64
# (tools/k2_f32_times.py, PERF.md §6).
K2F_NQ, K2F_KT, K2F_STAGES = 2, 64, 3
# K8's tile (csrc/split_fold.cu): output rows and columns per block and k
# per shared-memory stage
K8_TILE_M, K8_TILE_N, K8_SLAB = 128, 64, 16
# K4/K5's route table (csrc/eri4c.cuh): the class pairs (la lb | lc ld)
# that run one quartet per thread, everything in registers (lane); those
# of ERI4C_BLOCK (below: 56 g class pairs) one quartet a block on DMMA
# (block); every other class pair one quartet a warp in shared memory
# (warp).  The lane cut was chosen class by class from the card's timings
# (PERF.md §6): every class pair up to
# la+lb+lc+ld = ERI4C_LANE_MAX_L but those of ERI4C_LANE_EXCLUDE ((pd|pd):
# its K5 lane instance spills to a 28 KB stack at 32 registers, slower than
# its warp route in 6-311++G(3df,3pd) and reserving ~7.6 GB of local
# memory).  The kernels are built with it (route_flags).
ERI4C_LANE_MAX_L = 6
ERI4C_LANE_EXCLUDE = frozenset({(1, 2, 1, 2)})
# K4/K5's block route (csrc/eri4c.cuh): one quartet a block of
# ERI4C_BLOCK_WARPS warps, its R once a primitive quartet in shared memory,
# both products on the f64 tensor cores, tiles of at most 64 components
# (csrc/eri4c.cuh kEri4cBlockTile) shrunk, and past them rounds of
# primitive pairs halved, while a block would pass ERI4C_BLOCK_CAP bytes.  The
# class pairs of ERI4C_BLOCK take it in place of the lane or warp route,
# those of ERI4C_LANE_INCLUDE the lane route above ERI4C_LANE_MAX_L.
# Chosen class pair by class pair from the card's times of one full
# staircase build of benzene_2_water in 6-311++G(3df,3pd)+G (the real
# path), no class pair slower than its route before on the smoke's phase
# 3g subsets (PERF.md §6; ms of the full build, the earlier route
# first): the block route on every g class pair from L = 8 ((gg|gg) 279.0
# warp -> 12.3, (ss|gg) 2580.8 -> 165.4) and on four of L = 7 ((ss|fg)
# 2190.9 warp, 150.9 lane at a cut of 7 but 2x the warp route's K5 time on
# the subsets, 190.4 block; (sd|pg) 3676.5, 677.8, 656.7; (sg|pd) 2018.1,
# 826.7, 590.8; (pp|pg) 2903.3, 505.6, 439.7); the lane route on the other
# two of L = 7 ((sp|dg) 7187.4 warp, 578.5 lane, 911.7 block; (sf|sg)
# 597.1, 26.2, 199.9; on the subsets, K4 / K5 list / K5 staircase ms, the
# earlier warp route then the lane route, the mean of two readings each in
# one call: (sp|dg) 2.194 / 2.276 / 2.321 -> 0.307 / 1.656 / 1.705, (sf|sg)
# 1.029 / 1.081 / 1.094 -> 0.383 / 0.391 / 0.416) and on the 7 of L <= 6 as
# before (8.5-169.9 ms
# against 498.8-1225.3 on the block route: its fixed cost a quartet, ~30
# us, binds the low classes' millions of quartets).  8 warps a block
# within ERI4C_BLOCK_CAP, but 4 within ERI4C_BLOCK4_CAP (two blocks an SM
# where the tiles allow) for the class pairs of ERI4C_BLOCK4: those where
# 4 warps took the full build's class pair 10 % or more faster (ms, 8 warps
# then 4, k loop unrolled): (ss|fg) 211.9, 177.1; (sp|fg)
# 332.1, 287.7; (sd|pg) 666.1, 519.8; (sd|dg) 572.4, 363.8; (sd|fg) 203.3,
# 152.0; (sf|dg) 154.4, 118.3; (sg|dg) 185.7, 166.2; (sg|ff) 27.6, 24.2;
# (pp|dg) 353.1, 233.6; (pp|fg) 128.8, 107.2; (pd|pg) 533.1, 413.9;
# (pd|dg) 416.7, 301.4; (pd|fg) 153.3, 134.8; (pf|dg) 124.5, 98.3; (dd|dg)
# 132.8, 103.2; (dd|fg) 49.4, 44.4; (df|dg) 73.1, 59.0.  4 warps for all
# took 11.49 s against 9.89 (K5 on the subsets 110.2 ms against 55.2).
ERI4C_BLOCK_WARPS, ERI4C_BLOCK_CAP = 8, 200 * 1024
ERI4C_BLOCK4_CAP = 110 * 1024
_PAIRS = tuple((a, b) for a in range(5) for b in range(a, 5))
ERI4C_LANE_INCLUDE = frozenset({(0, 1, 2, 4), (0, 3, 0, 4)})
ERI4C_BLOCK = frozenset(
    {(*_PAIRS[i], *_PAIRS[j]) for i in range(15) for j in range(i, 15)
     if 4 in (*_PAIRS[i], *_PAIRS[j])
     and sum((*_PAIRS[i], *_PAIRS[j])) >= 8}
    | {(0, 0, 3, 4), (0, 2, 1, 4), (0, 4, 1, 2), (1, 1, 1, 4)})
ERI4C_BLOCK4 = frozenset({
    (0, 0, 3, 4), (0, 1, 3, 4), (0, 2, 1, 4), (0, 2, 2, 4), (0, 2, 3, 4),
    (0, 3, 2, 4), (0, 4, 2, 4), (0, 4, 3, 3), (1, 1, 2, 4), (1, 1, 3, 4),
    (1, 2, 1, 4), (1, 2, 2, 4), (1, 2, 3, 4), (1, 3, 2, 4), (2, 2, 2, 4),
    (2, 2, 3, 4), (2, 3, 2, 4)})
# K6's route table (csrc/eri4c.cuh DigestClass): the class pairs of K4/K5's
# lane route whose blocks hold at most DIGEST_LANE_MAX_N integrals digest
# one cached block a thread (lane); those of DIGEST_BLOCK one block a CTA
# of 8 warps, streamed through shared memory in slabs by a ring of 2
# (block: csrc/eri4c.cuh kDigestBlockThreads, kDigestBlockStages); the
# rest one block a warp (warp).
# The lane cut was chosen class by class from the card's times of both
# routes over one in-core build of ammonia_trimer in 6-311++G(2d,2p) and
# 6-31G(2df,p) (PERF.md §6): the lane route wins to N = 27 (1.1-8.8x),
# loses from N = 36.  The block route was chosen class pair by class pair
# from the card's times of one in-core build of two waters in
# 6-311++G(3df,3pd)+G (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): every g
# class pair off the lane route takes it but the 9 whose blocks of 45-810
# doubles were slower there than on the warp route, which stages a warp's
# blocks together, in each of four readings a route, taken in turn in one
# call (tools/eri4c_class_times.py --mode digest_jk; ms, the warp route's
# then the block route's, lowest to highest): (ss|pg) 0.0190-0.0198,
# 0.0343-0.0347; (ss|dg) 0.0188-0.0195, 0.0204-0.0212; (sp|sg)
# 0.0336-0.0344, 0.0589-0.0597; (sp|pg) 0.0414-0.0425, 0.0492-0.0497;
# (sd|sg) 0.0277-0.0287, 0.0444-0.0452; (sd|pg) 0.0328-0.0332,
# 0.0338-0.0343; (sg|pp) 0.0264-0.0269, 0.0294-0.0296; (pp|pg)
# 0.0384-0.0398, 0.0540-0.0544; (pp|dg) 0.0361-0.0363, 0.0378-0.0382.
# (pd|pg) read 0.0550-0.0568 on the warp route and 0.0563-0.0565 on the
# block route, the warp route not faster in every reading: block.  The 54
# class pairs first on the block route took 5.266 ms on the warp route and
# 0.915 on the block route, (gg|gg) 1.2647 and 0.0331.  A block past the
# warp route's stage (kDigestWarpCap: the 8 class pairs (df|gg) ..
# (gg|gg)) must take the block route (a static_assert of the warp route).
# (ss|sg) is on the lane route.  The kernels are built with it
# (NVCC_FLAGS, digest_route_flags), each class pair on its route only.
DIGEST_LANE_MAX_N = 27
DIGEST_BLOCK = frozenset(
    {(*_PAIRS[i], *_PAIRS[j]) for i in range(15) for j in range(i, 15)
     if 4 in (*_PAIRS[i], *_PAIRS[j])} - {
        (0, 0, 0, 4), (0, 0, 1, 4), (0, 0, 2, 4), (0, 1, 0, 4),
        (0, 1, 1, 4), (0, 2, 0, 4), (0, 2, 1, 4), (0, 4, 1, 1),
        (1, 1, 1, 4), (1, 1, 2, 4)})
# K1's bra classes (la, lb), in the order of its route masks (csrc/eri3c.cuh
# eri3c_bra: mask index, bit lq): the primary pairs to (ff), then the g
# pairs (sg) .. (gg); (sg) is also the (0, 4) unit bra of the 2-center
# metric
ERI3C_BRAS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2), (0, 3), (1, 3),
              (2, 3), (3, 3), (0, 4), (1, 4), (2, 4), (3, 4), (4, 4))
# K1's route table (csrc/eri3c.cuh): the classes (la lb | lq) up to
# la+lb+lq = ERI3C_LANE_MAX_L, but those of ERI3C_LANE_EXCLUDE, run one
# (bra pair, aux shell) per thread, everything in registers, and for bras
# of ERI3C_WIDE_NAB Cartesian components or more ((pd), (dd), the f pairs)
# only up to ERI3C_LANE_MAX_L_WIDE; every other class runs a block per
# (bra pair, tile of aux shells) in shared memory, its product Eab . T1 on
# the f64 tensor cores (DMMA).  Chosen class by class from the card's
# timings at lane cuts 4 and 6 (PERF.md §6, PR 9, run 8; w32's 3-center
# build): on the lane route (sp|g) takes 1.15 ms against 1.60 on the block
# route, but (sd|f) 1.58 against 1.49, (pp|f) 2.16 against 1.79 and the
# L = 6 classes (sd|g), (pp|g) 0.67, 0.95 against 0.57, 0.81; the wide
# bras' lane instances spill 3-7 KB of stack at 255 registers from L = 5
# and lose to the block route by 1.1-1.6x.  The kernels are built with it
# (eri3c_route_flags).
ERI3C_LANE_MAX_L = 5
ERI3C_LANE_EXCLUDE = frozenset({(0, 2, 3), (1, 1, 3)})
ERI3C_LANE_MAX_L_WIDE = 4
ERI3C_WIDE_NAB = 16
# K1's block-route body (csrc/eri3c.cuh): the classes of ERI3C_T1 build the
# R of their primitive products level by level across a block of 8 warps
# and T1 on DMMA (M gathered from R, K4/K5's block machinery), their aux
# tile within 110 KB (csrc/eri3c.cuh kEri3cT1Threads, kEri3cT1Cap); the
# other block classes keep one product's R and one T1 row a thread.
# Chosen class by class from the card's times of the full 3-center build of
# benzene_2_water in 6-311++G(3df,3pd)+G (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md §6): the T1 body where it was faster in both calls, by 13-48 %
# (ms, the thread body then the T1 body, the mean of two readings in one
# call): (pg|p) 2.2002, 1.1454; (pg|d) 3.0157, 1.5755; (fg|p..g)
# 0.2887-0.6783, 0.2418-0.5045; (gg|s..g) 0.3251-0.6011, 0.2158-0.5092;
# the thread body on the other 12 of the block route, where the T1 body's
# fixed cost a block (its barriers, the Boys and R levels of few
# products) made it up to 1.5x slower ((sg|d) 0.9884, 1.4710; (pg|f)
# 1.4915, 1.8435), no faster ((dg|p) 0.9211, 0.9105) or faster in one call
# and slower in the other ((fg|s) 0.3527, 0.3202; 0.3030, 0.3289).  A cap
# of 200 KB (wider aux tiles, so A is built once for up to 8 aux shells;
# one block an SM) was faster on 4 of the 23 block classes and slower on
# 14 (against the body each took in the same call).  The kernels are
# built with it (eri3c_t1_flags).
ERI3C_T1 = frozenset({(1, 4, 1), (1, 4, 2)}
                     | {(3, 4, lq) for lq in range(1, 5)}
                     | {(4, 4, lq) for lq in range(5)})
# K9's group size (csrc/oei.cuh, a launch argument): the lanes that share
# one shell pair, each taking every G-th nucleus of its sum; one of
# STV_GROUPS, picked by the number of nuclei (``stv_group``): G up to each
# count of STV_GROUP_NATOM, 8 above.  Few nuclei leave a group's lanes
# idle and few pairs, so wide groups fill the card; many nuclei keep 8
# lanes busy and narrow groups pay fewer shuffles and E-table builds a
# primitive pair.  Chosen from the card's times of every class at each G
# (tools/stv_times.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md §6; ms of
# all classes, G = 8, 16, 32): benzene_2_water (27 nuclei) 0.481, 0.362,
# 0.308, in 6-311++G(3df,3pd) 0.775, 0.564, 0.496, in the g basis 1.713,
# 1.182, 0.930; w8 (24) 0.386, 0.332, 0.279; w32 (96) 0.680, 0.622,
# 0.800; w64 (192) 2.414, 2.821, 3.804.
STV_GROUPS = (8, 16, 32)
STV_GROUP_NATOM = ((48, 32), (136, 16))
NVCC_FLAGS = ("-O3", "-std=c++17", ARCH, "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", f"-DJC_K2_SLAB_M={K2_SLAB_M}",
              f"-DJC_K2_TILE_N={K2_TILE_N}", f"-DJC_K2F_NQ={K2F_NQ}",
              f"-DJC_K2F_KT={K2F_KT}", f"-DJC_K2F_STAGES={K2F_STAGES}",
              f"-DJC_K8_TILE_M={K8_TILE_M}",
              f"-DJC_K8_TILE_N={K8_TILE_N}", f"-DJC_K8_SLAB={K8_SLAB}",
              f"-DJC_DIGEST_LANE_MAX_N={DIGEST_LANE_MAX_N}")


def stv_group(natom: int) -> int:
    """The lanes K9 gives a shell pair of a system of ``natom`` nuclei."""
    return next((g for top, g in STV_GROUP_NATOM if natom <= top),
                STV_GROUPS[0])


def eri4c_route(la: int, lb: int, lc: int, ld: int) -> str:
    """The route K4/K5 take for a class pair: "lane", "block" or "warp"."""
    if (la, lb, lc, ld) in ERI4C_BLOCK:
        return "block"
    lane = ((la + lb + lc + ld <= ERI4C_LANE_MAX_L
             and (la, lb, lc, ld) not in ERI4C_LANE_EXCLUDE)
            or (la, lb, lc, ld) in ERI4C_LANE_INCLUDE)
    return "lane" if lane else "warp"


def digest_route(la: int, lb: int, lc: int, ld: int) -> str:
    """The route K6 takes for a class pair: "lane", "block" or "warp"."""
    n = ((la + 1) * (la + 2) * (lb + 1) * (lb + 2) * (lc + 1) * (lc + 2)
         * (ld + 1) * (ld + 2)) // 16
    if eri4c_route(la, lb, lc, ld) == "lane" and n <= DIGEST_LANE_MAX_N:
        return "lane"
    return "block" if (la, lb, lc, ld) in DIGEST_BLOCK else "warp"


def digest_route_flags() -> tuple:
    """K6's block route as the sources take it (its lane cut is
    NVCC_FLAGS'): JC_DIGEST_BLOCK_MASK_B<i>, bit j the class pair (bra i |
    ket j) on the block route (the masks of ``route_flags``)."""
    masks = []
    for i, bra in enumerate(_PAIRS):
        m = 0
        for j in range(i, len(_PAIRS)):
            if digest_route(*bra, *_PAIRS[j]) == "block":
                m |= 1 << j
        masks.append(m)
    return tuple(f"-DJC_DIGEST_BLOCK_MASK_B{i}={m:#x}"
                 for i, m in enumerate(masks))


def route_flags() -> tuple:
    """The route table as the sources take it: JC_ERI4C_LANE_MASK_B<i> is
    the mask of bra pair class i (the order of ops/eri.py::PAIR_CLASSES),
    whose bit j is the class pair (bra i | ket j), j >= i, on the lane
    route (one flag a bra: nvcc splits a -D value at its commas)."""
    from .eri import PAIR_CLASSES

    masks = []
    for i, bra in enumerate(PAIR_CLASSES):
        m = 0
        for j in range(i, len(PAIR_CLASSES)):
            if eri4c_route(*bra, *PAIR_CLASSES[j]) == "lane":
                m |= 1 << j
        masks.append(m)
    return tuple(f"-DJC_ERI4C_LANE_MASK_B{i}={m:#x}"
                 for i, m in enumerate(masks))


def eri4c_block_warps(la: int, lb: int, lc: int, ld: int) -> int:
    """Warps a block of a block-route class pair (0 off the route)."""
    if eri4c_route(la, lb, lc, ld) != "block":
        return 0
    return 4 if (la, lb, lc, ld) in ERI4C_BLOCK4 else ERI4C_BLOCK_WARPS


def block_route_flags() -> tuple:
    """The block route as the sources take it: JC_ERI4C_BLOCK_MASK_B<i>,
    bit j the class pair (bra i | ket j) on the block route (the masks of
    ``route_flags``), JC_ERI4C_BLOCK4_MASK_B<i> those of them with 4 warps
    a block (``eri4c_block_warps``), then the warps and shared-memory cap
    of the others and the 4-warp blocks' cap."""
    def masks(pick):
        out = []
        for i, bra in enumerate(_PAIRS):
            m = 0
            for j in range(i, len(_PAIRS)):
                if pick(*bra, *_PAIRS[j]):
                    m |= 1 << j
            out.append(m)
        return out

    block = masks(lambda *c: eri4c_route(*c) == "block")
    block4 = masks(lambda *c: eri4c_block_warps(*c) == 4)
    return (*(f"-DJC_ERI4C_BLOCK_MASK_B{i}={m:#x}"
              for i, m in enumerate(block)),
            *(f"-DJC_ERI4C_BLOCK4_MASK_B{i}={m:#x}"
              for i, m in enumerate(block4)),
            f"-DJC_ERI4C_BLOCK_WARPS={ERI4C_BLOCK_WARPS}",
            f"-DJC_ERI4C_BLOCK_CAP={ERI4C_BLOCK_CAP}",
            f"-DJC_ERI4C_BLOCK4_CAP={ERI4C_BLOCK4_CAP}")


def eri3c_route(la: int, lb: int, lq: int) -> str:
    """The route K1 takes for a class: "lane" or "block"."""
    wide = (la + 1) * (la + 2) * (lb + 1) * (lb + 2) // 4 >= ERI3C_WIDE_NAB
    if (la + lb + lq <= (ERI3C_LANE_MAX_L_WIDE if wide else ERI3C_LANE_MAX_L)
            and (la, lb, lq) not in ERI3C_LANE_EXCLUDE):
        return "lane"
    return "block"


def eri3c_route_flags() -> tuple:
    """K1's route table as the sources take it: JC_ERI3C_LANE_MASK_B<i> is
    the mask of bra class i (the order of ERI3C_BRAS), whose bit lq is the
    class (ERI3C_BRAS[i] | lq) on the lane route."""
    masks = []
    for la, lb in ERI3C_BRAS:
        m = 0
        for lq in range(5):
            if eri3c_route(la, lb, lq) == "lane":
                m |= 1 << lq
        masks.append(m)
    return tuple(f"-DJC_ERI3C_LANE_MASK_B{i}={m:#x}"
                 for i, m in enumerate(masks))


def eri3c_body(la: int, lb: int, lq: int) -> str | None:
    """The body K1's block route runs for a class: "t1" (R across the
    block, T1 on DMMA), "thread", or None on the lane route."""
    if eri3c_route(la, lb, lq) != "block":
        return None
    return "t1" if (la, lb, lq) in ERI3C_T1 else "thread"


def eri3c_t1_flags() -> tuple:
    """K1's body table as the sources take it: JC_ERI3C_T1_MASK_B<i>, bit
    lq the class (ERI3C_BRAS[i] | lq) on the T1 body (the masks of
    ``eri3c_route_flags``)."""
    masks = []
    for la, lb in ERI3C_BRAS:
        m = 0
        for lq in range(5):
            if eri3c_body(la, lb, lq) == "t1":
                m |= 1 << lq
        masks.append(m)
    return tuple(f"-DJC_ERI3C_T1_MASK_B{i}={m:#x}"
                 for i, m in enumerate(masks))


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_D = ctypes.c_double
# C symbol -> (kernel it launches, argument types before the stream)
_FUNCS = {
    "jc_eri3c": ("eri3c", [_I, _I, _I, _P, _P, _LL, _I, _I, _P, _P, _P, _P,
                           _I, _I, _P, _P, _P, _P, _I, _LL]),
    "jc_df_gather_w_f64": ("df_gather_w", [_P, _LL, _P, _P, _P, _P, _I, _I,
                                           _I, _P]),
    "jc_df_gather_w_f32": ("df_gather_w_f32", [_P, _LL, _P, _P, _P, _P,
                                               _I, _I, _I, _P]),
    "jc_df_gather_w_f32b": ("df_gather_w_f32b", [_P, _LL, _P, _P, _P, _P,
                                                 _I, _I, _I, _P]),
    "jc_split_fold": ("split_fold", [_P, _P, _LL, _P, _LL, _P, _LL, _I, _I,
                                     _I, _I]),
    "jc_boys_probe": ("boys_probe", [_P, _LL, _I, _P]),
    "jc_boys_probe_recip": ("boys_probe_recip", [_P, _LL, _I, _P]),
    "jc_eri4c": ("eri4c", [_I, _I, _I, _I, _P, _I, _I, _P, _P, _I, _I, _P,
                           _P, _P, _LL, _P]),
    "jc_eri4c_jk": ("eri4c_jk_list", [_I, _I, _I, _I, _P, _I, _I, _P, _P, _I,
                                      _I, _P, _P, _P, _P, _P, _LL, _I, _LL,
                                      _LL, _P, _LL, _P]),
    "jc_digest_jk": ("digest_jk", [_I, _I, _I, _I, _P, _P, _P, _P, _P, _LL,
                                   _P, _P, _LL, _P]),
    "jc_stv": ("stv", [_I, _I, _I, _P, _P, _P, _LL, _P, _I, _P, _P, _P,
                       _LL]),
    "jc_stv_grad": ("stv_grad", [_I, _I, _I, _P, _P, _P, _LL, _P, _I, _P, _P,
                                 _LL, _P]),
    "jc_eri3c_grad": ("eri3c_grad", [_I, _I, _I, _I, _P, _P, _P, _LL, _P, _P,
                                     _P, _LL, _P, _LL, _LL, _D, _P, _I]),
    "jc_mp2_e2": ("e2_rmp2", [_I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                              _P, _P, _LL, _P]),
}

launches = {"eri3c": 0, "eri3c_f32": 0, "df_gather_w": 0,
            "df_gather_w_f32": 0, "df_gather_w_f32b": 0, "boys_probe": 0,
            "boys_probe_recip": 0, "eri4c": 0,
            "eri4c_jk_list": 0, "eri4c_jk_stair": 0, "digest_jk": 0,
            "e2_rmp2": 0, "e2_ss": 0, "e2_os": 0, "split_fold": 0,
            "stv": 0, "stv_grad": 0, "eri3c_grad": 0, "metric_grad": 0}

# integral kernels: kernel name -> {angular-momentum class: launches}, kept
# beside ``launches`` by the same calls
class_launches: dict = {}

_lock = threading.Lock()
_lib = None
build_info: dict = {}   # so path, seconds (each source's too), compiler output


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    class_launches.clear()


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
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *route_flags(),
                                 *digest_route_flags(), *eri3c_t1_flags(),
                                 *block_route_flags(),
                                 *eri3c_route_flags())).encode())
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
            cmd = [nvcc, *NVCC_FLAGS, *route_flags(), *eri3c_route_flags(),
                   *digest_route_flags(), *eri3c_t1_flags(),
                   *block_route_flags(), "-I", str(CSRC_DIR),
                   "-c", str(src), "-o", str(obj)]
            # compiler output to a file: a pipe could fill while the build
            # polls the processes
            log = open(tmp / (src.stem + ".log"), "w+")
            procs.append((src, obj, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT, text=True)))
        # each source's wall from the start of the build (the slowest one
        # bounds the build)
        per_source = {}
        while len(per_source) < len(procs):
            for src, _, _, proc in procs:
                if src.name not in per_source and proc.poll() is not None:
                    per_source[src.name] = time.perf_counter() - t0
            time.sleep(0.05)
        logs = []
        failed = []
        for src, _, log, proc in procs:
            log.seek(0)
            logs.append(f"== {src.name}\n{log.read()}")
            log.close()
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + "\n"
                               + "\n".join(logs)[-20000:])
        tmp_so = tmp / so.name
        link = subprocess.run(
            [nvcc, ARCH, "-shared", "-o", str(tmp_so),
             *[str(o) for _, o, _, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout[-20000:])
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_info.update(so=str(so), seconds=time.perf_counter() - t0,
                      per_source=per_source, log="\n".join(logs))
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
            lib.jc_mp2_e2_partials.argtypes = [_I] * 7
            lib.jc_mp2_e2_partials.restype = _LL
            lib.jc_eri4c_geometry.argtypes = [_I] * 8 + [_P]
            lib.jc_eri4c_geometry.restype = _I
            lib.jc_digest_jk_geometry.argtypes = [_I] * 4 + [_P]
            lib.jc_digest_jk_geometry.restype = _I
            lib.jc_eri3c_geometry.argtypes = [_I] * 6 + [_P]
            lib.jc_eri3c_geometry.restype = _I
            _lib = lib
        return _lib


def launch(symbol: str, *args, count_as: str | None = None,
           cls: tuple | None = None) -> None:
    """Call one C entry point on PyTorch's current stream; raise on a CUDA
    error, else count the launch (under ``count_as`` when one entry point
    serves two modes; per angular-momentum class ``cls`` too, where given)."""
    import torch

    lib = library()
    rc = getattr(lib, symbol)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {rc} "
                           f"({lib.jc_error_string(rc).decode()})")
    name = count_as or _FUNCS[symbol][0]
    launches[name] += 1
    if cls is not None:
        per = class_launches.setdefault(name, {})
        per[cls] = per.get(cls, 0) + 1
