#!/usr/bin/env python3
"""Smoke run of the PyTorch port (juliachem_jl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out result.json]

Phases, each printing its lines (every measured number tagged with the
card's name and power limit):

1. device: card name, ``nvidia-smi`` name and power limit, torch's CUDA
   version, ``nvcc --version``;
2. build the CUDA kernels of juliachem_jl_tpu_torch/csrc with nvcc (one
   process per source, in parallel);
3. each kernel against its plain torch version on the card, times from CUDA
   events beside the least time the card could take (``bound_ms``):
   K1 (3-center integrals, every class of benzene_2_water / cc-pVTZ-JKFIT,
   a subset of bra pairs), K2 (packed-B exchange factor, f64 and f32), the
   probe K3 (device Boys function), and at the class shapes of
   ammonia_trimer and benzene_2_water (6-311++G(2d,2p)), the first quartets
   of every class pair of the Schwarz staircase: K4 (4-center integrals),
   K6 (digestion of cached blocks), K5 in list and in staircase mode (the
   integrals digested at once);
4. ammonia_trimer DF-RHF through run_spec (dense-B route);
5. benzene_2_water DF-RHF through run_spec (packed route);
6. ammonia_trimer conventional RHF through run_spec (in-core
   ScreenedDirectFock: K4 fills, K6 digests), then at its converged density
   one build through the direct ScreenedDirectFock (K5 list mode) and one
   through StreamingDirectFock (K5 staircase mode), each held to the
   in-core G;
7. benzene_2_water conventional RHF through run_spec with the DF guess (DF
   iterations on the packed builder, then StreamingDirectFock), with
   ``damp: false`` (ROADMAP.md C8).

Each path runs with the launch counts set to 0 just before it and read just
after.  Energies are held to the JAX package's recorded DF energies
(juliachem_jl_tpu_torch/data/smoke_reference.json, 1e-6 Eh) and to GAMESS
(tests/data/s22x3_gamess_goldens.json: DF within 1.5e-3 Eh, conventional
within 1.49e-8 relative).  The second-to-last line is ``{"kernels": [...]}``;
the last is ``{"ok": true, "device": ...}``.  Any failed check exits
nonzero without that last line; so does a machine without CUDA or a
directory without the package.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
import traceback
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
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_F64_OPS_S = 67e12
SUBSET = 4096  # quartets per class pair in the 4-center kernel checks
BOYS_TCRIT = 35.0  # csrc/boys.cuh: the series up to this T, asymptotic above
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


def bound_of(nbytes: float, ops: float) -> dict:
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over the f64 peak, and which one binds."""
    t_b, t_o = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F64_OPS_S * 1e3
    return {"bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "bytes": nbytes, "operations": ops}


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
                 scf: dict | None = None, aux: bool = True) -> dict:
    atoms = golden["atoms"]
    model = {"method": "RHF", "basis": golden["basis"]}
    if aux:
        model["auxiliary_basis"] = "cc-pVTZ-JKFIT"
    return {
        "molecule": {"symbols": [a["symbol"] for a in atoms],
                     "geometry": [x * BOHR for a in atoms for x in a["xyz_bohr"]],
                     "molecular_charge": 0},
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
    ms = cuda_ms(lambda: boys.boys_probe(T, 8))
    plain = cuda_ms(lambda: boys.boys(T, 8))
    print(f"{tag} K3 boys_probe T in [0,60] n=1000001 m<=8: max rel err "
          f"{worst:.3e} (bound 1e-14); m=8 kernel {ms:.4f} ms, plain torch "
          f"{plain:.4f} ms", flush=True)
    n = T.shape[0]
    n_series = int((T <= BOYS_TCRIT).sum())
    return {"name": "boys_probe", "route": "cuda",
            "source": "juliachem_jl_tpu_torch/csrc/boys_probe.cu",
            "replaces": "juliachem_jl_tpu/ops/boys.py:61",
            "max_abs_err": float((boys.boys_probe(T, 8)
                                  - boys.boys(T, 8)).abs().max()),
            "max_rel_err": worst, "ms": ms, "plain_ms": plain,
            "library_ms": None,
            **bound_of(8.0 * n * (1 + 9), n_series * 3 * 128
                       + (n - n_series) * 3 + n * 3 * 8)}


def check_k1(tag: str, dev, bsets, n_pairs: int = 64) -> dict:
    """Every (bra class | aux class) of the system, the first n_pairs bra
    pairs of each class against every aux shell, kernel vs plain, written
    into compact [A, 2*n*nab] outputs."""
    import numpy as np
    import torch

    from juliachem_jl_tpu_torch.basis.structs import ncart
    from juliachem_jl_tpu_torch.ops import eri3c, kernels
    from juliachem_jl_tpu_torch.ops.pairs import unique_pair_blocks

    prim, aux = bsets.primary, bsets.auxiliary
    aux_classes = eri3c._aux_classes(aux, dev)
    bra = ([b.select(np.arange(min(n_pairs, b.n))) for b in unique_pair_blocks(prim)]
           + [b.select(np.arange(min(n_pairs, b.n))) for b in eri3c.aux_unit_blocks(aux)])
    calls = []
    for blk in bra:
        nab = ncart(blk.la) * ncart(blk.lb)
        cols = torch.arange(blk.n * nab, device=dev).reshape(blk.n, nab)
        mirror = torch.ones(blk.n, dtype=torch.uint8, device=dev)
        pair = eri3c.pack_pairs(blk, dev)
        for lq, aux_t, qrow in aux_classes:
            calls.append((blk.la, blk.lb, lq, blk.aexp.shape[1],
                          blk.bexp.shape[1], pair, aux_t, qrow, cols,
                          cols + blk.n * nab, mirror, 2 * blk.n * nab))
    # bound: every pair/aux row read once, every (aux row, column) written
    # once; operations over the nonzero-coefficient primitives, the Boys
    # series only where T <= 35
    nbytes = ops = 0.0
    for (la, lb, lq, Ka, Kb, pair, aux_t, qrow, cols, cols_t, mirror,
         width) in calls:
        Kq = (aux_t.shape[1] - 3) // 2
        p, P, live_p = prim_pairs(pair, Ka, Kb)
        live = live_p[:, :, None, None] & (aux_t[None, None, :, Kq:2 * Kq] != 0)
        n_prim = float(live.sum())
        n_series = series_count(
            p[:, :, None, None], P[:, :, None, None],
            aux_t[None, None, :, :Kq], aux_t[None, None, :, None, 2 * Kq:], live)
        nab, ncq, nhb = ncart(la) * ncart(lb), ncart(lq), nherm(la + lb)
        nbytes += 8.0 * (pair.numel() + aux_t.numel() + qrow.numel()
                         + 2 * cols.numel() + 2 * cols.numel() * ncq * aux_t.shape[0])
        ops += (boys_r_ops(la + lb + lq, n_prim, n_series)
                + n_prim * 2 * nhb * ncq * nherm(lq)
                + float(live_p.sum()) * aux_t.shape[0] * (4 * nab * nhb
                                                          + 2 * nab * nhb * ncq))
    worst_rel, worst_abs = 0.0, 0.0
    n0 = kernels.launches["eri3c"]
    for (la, lb, lq, Ka, Kb, pair, aux_t, qrow, cols, cols_t, mirror,
         width) in calls:
        outs = []
        for fn in (eri3c.eri3c_class, eri3c.eri3c_class_plain):
            out = torch.zeros((aux.nbf, width), dtype=torch.float64, device=dev)
            fn(out, la, lb, lq, Ka, Kb, pair, aux_t, qrow, cols, cols_t, mirror)
            outs.append(out)
        err = float((outs[0] - outs[1]).abs().max())
        scale = float(outs[1].abs().max())
        check(err <= 1e-12 * scale,
              f"K1 class ({la},{lb}|{lq}): max abs err {err:.3e} > 1e-12 x "
              f"{scale:.3e}")
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / scale if scale else 0.0)
    check(kernels.launches["eri3c"] - n0 == len(calls),
          "K1 comparison did not launch the kernel for every class")

    def run(fn):
        for (la, lb, lq, Ka, Kb, pair, aux_t, qrow, cols, cols_t, mirror,
             width) in calls:
            out = torch.zeros((aux.nbf, width), dtype=torch.float64, device=dev)
            fn(out, la, lb, lq, Ka, Kb, pair, aux_t, qrow, cols, cols_t, mirror)

    ms = cuda_ms(lambda: run(eri3c.eri3c_class), reps=2)
    plain = cuda_ms(lambda: run(eri3c.eri3c_class_plain), reps=2)
    print(f"{tag} K1 eri3c: {len(calls)} classes x {n_pairs} bra pairs x all "
          f"aux shells: max abs err {worst_abs:.3e}, max err/block max-abs "
          f"{worst_rel:.3e} (bound 1e-12); kernel {ms:.3f} ms, plain torch "
          f"{plain:.3f} ms", flush=True)
    b = bound_of(nbytes, ops)
    print(f"{tag} K1 eri3c bound {b['bound_ms']:.3f} ms ({b['bound_by']}: "
          f"{nbytes:.3e} B, {ops:.3e} operations)", flush=True)
    return {"name": "eri3c", "route": "cuda",
            "source": "juliachem_jl_tpu_torch/csrc/eri3c.cuh",
            "replaces": "juliachem_jl_tpu/ops/eri3c.py:126",
            "max_abs_err": worst_abs, "max_rel_err": worst_rel,
            "ms": ms, "plain_ms": plain, "library_ms": None, **b}


def check_k2(tag: str, dev, bsets, opts) -> dict:
    """K2 at the system's packed shapes: the real screen (Schwarz-screened
    col_map), one Q-block of all fitted aux rows, the occupied count."""
    import torch

    from juliachem_jl_tpu_torch.models.df import screened_pair_blocks
    from juliachem_jl_tpu_torch.models.df_screened import (
        build_packed_screen, df_gather_w, df_gather_w_plain)
    from juliachem_jl_tpu_torch.basis.spherical import cart_to_sph_basis
    from juliachem_jl_tpu_torch.ops import eri3c, kernels

    prim, aux = bsets.primary, bsets.auxiliary
    metric_max = float(torch.diagonal(eri3c.two_center_metric(aux, dev)).max())
    screen = build_packed_screen(prim, screened_pair_blocks(
        prim, opts.df_screening_sigma, metric_max, dev))
    qc = cart_to_sph_basis(aux).shape[1]
    nbf, k = prim.nbf, prim.nels // 2
    gen = torch.Generator(device=dev).manual_seed(0)
    Bc = torch.randn((qc, screen.npq + 1), dtype=torch.float64, device=dev,
                     generator=gen)
    Bc[:, -1] = 0.0
    C = torch.randn((nbf, k), dtype=torch.float64, device=dev, generator=gen)
    col_map = torch.as_tensor(screen.col_map, device=dev).to(torch.int32)
    res = {}
    for dt, bound in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        B_, C_ = Bc.to(dt), C.to(dt)
        n0 = kernels.launches["df_gather_w"]
        got = df_gather_w(B_, col_map, C_)
        check(kernels.launches["df_gather_w"] == n0 + 1,
              "K2 comparison did not launch the kernel")
        ref = df_gather_w_plain(B_, col_map, C_)
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        check(rel <= bound, f"K2 {dt}: relative error {rel:.3e} > {bound}")
        ms = cuda_ms(lambda: df_gather_w(B_, col_map, C_))
        plain = cuda_ms(lambda: df_gather_w_plain(B_, col_map, C_))
        res[dt] = (err, rel, ms, plain)
        print(f"{tag} K2 df_gather_w {str(dt)[6:]} Qc={qc} npq={screen.npq} "
              f"nbf={nbf} k={k}: max abs err {err:.3e}, rel {rel:.3e} "
              f"(bound {bound}); kernel {ms:.3f} ms, plain torch (tile + "
              f"einsum) {plain:.3f} ms", flush=True)
    err, rel, ms, plain = res[torch.float64]
    # bound (f64): B, col_map and C read once, W written once; one FMA per
    # (q, i, surviving (m, n)) entry
    live = int((col_map != screen.npq).sum())
    b = bound_of(8.0 * Bc.numel() + 4.0 * col_map.numel() + 8.0 * C.numel()
              + 8.0 * qc * k * nbf, 2.0 * qc * live * k)
    print(f"{tag} K2 df_gather_w f64 bound {b['bound_ms']:.3f} ms "
          f"({b['bound_by']})", flush=True)
    return {"name": "df_gather_w", "route": "cuda",
            "source": "juliachem_jl_tpu_torch/csrc/df_gather_w.cu",
            "replaces": "juliachem_jl_tpu/models/df_screened.py:303",
            "max_abs_err": err, "max_rel_err": rel, "ms": ms,
            "plain_ms": plain, "library_ms": None, **b,
            "f32_ms": res[torch.float32][2],
            "f32_plain_ms": res[torch.float32][3]}


def k1_primitive_counts(tag: str, dev, bsets, opts) -> dict:
    """(pair primitive pair, aux primitive) products of the system's full
    3-center build: as K1 loops over them (each class padded to its largest
    contraction) and those of nonzero coefficients."""
    import numpy as np
    import torch

    from juliachem_jl_tpu_torch.models.df import screened_pair_blocks
    from juliachem_jl_tpu_torch.ops import eri3c

    prim, aux = bsets.primary, bsets.auxiliary
    metric_max = float(torch.diagonal(eri3c.two_center_metric(aux, dev)).max())
    padded = real = 0
    for b in screened_pair_blocks(prim, opts.df_screening_sigma, metric_max,
                                  dev):
        kp = (np.count_nonzero(b.acoef, axis=1)
              * np.count_nonzero(b.bcoef, axis=1)).sum()
        for cl in aux.classes.values():
            padded += b.n * b.aexp.shape[1] * b.bexp.shape[1] * cl.nshell * cl.kmax
            real += int(kp) * int(np.count_nonzero(cl.coefs))
    print(f"{tag} K1 on the full 3-center build: {real} primitive products "
          f"of nonzero coefficients, {padded} looped over with the class "
          f"padding ({real / padded:.4f})", flush=True)
    return {"padded": padded, "real": real}


def check_4c(tag: str, dev, name: str, bsets, seed: int) -> dict:
    """K4, K6 and K5 (list and staircase mode) against their plain versions
    on the first SUBSET quartets of every class pair of the system's Schwarz
    staircase, with one random symmetric D; per kernel: errors, CUDA-event
    times of all class pairs, the bound and the primitive-quartet counts."""
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
        m = min(cp.N, SUBSET)
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

    def k4(fn):
        return lambda: [fn(x["bra"], x["ket"], x["r"], x["c"]) for x in cases]

    out["eri4c"] = dict(
        max_abs_err=worst, ms=cuda_ms(k4(eri.eri4c_class), reps=2),
        plain_ms=cuda_ms(k4(eri.eri4c_plain), reps=2),
        **bound_of(sum(table_bytes(x) + 16.0 * x["m"] for x in cases) + io_blocks,
                ops_eri))

    # K6, K5 list, K5 staircase: JK against the plain digestion
    def jk_case(label, run_kernel, run_plain, nbytes, ops):
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
                          **bound_of(nbytes, ops))

    def each(fn):
        def run(JK):
            for i, x in enumerate(cases):
                fn(JK, i, x)
        return run

    jk_case("digest_jk",
            each(lambda JK, i, x: fock.digest_jk(JK, I_ref[i], x["bra"], x["ket"],
                                                 x["r"], x["c"], x["w"], D)),
            each(lambda JK, i, x: fock.digest_plain(JK, I_ref[i], x["w"], D,
                                                    x["bra"], x["ket"], x["r"],
                                                    x["c"])),
            io_blocks + sum(24.0 * x["m"] + 4.0 * (x["bra"].meta.numel()
                                                   + x["ket"].meta.numel())
                            for x in cases) + jk_bytes, ops_dig)
    jk_case("eri4c_jk_list",
            each(lambda JK, i, x: fock.eri4c_jk(JK, x["bra"], x["ket"], x["r"],
                                                x["c"], x["w"], D)),
            each(lambda JK, i, x: fock.eri4c_jk_plain(JK, x["bra"], x["ket"],
                                                      x["r"], x["c"], x["w"], D)),
            sum(table_bytes(x) + 24.0 * x["m"] for x in cases) + jk_bytes,
            ops_eri + ops_dig)
    jk_case("eri4c_jk_stair",
            each(lambda JK, i, x: fock_stream.eri4c_jk_staircase(
                JK, x["bra"], x["ket"], x["cum"], x["m"], x["same"], D)),
            each(lambda JK, i, x: fock_stream.eri4c_jk_staircase_plain(
                JK, x["bra"], x["ket"], x["cum"], x["m"], x["same"], D)),
            sum(table_bytes(x) + 8.0 * x["cum"].numel() for x in cases)
            + jk_bytes, ops_eri + ops_dig)
    for label, v in out.items():
        print(f"{tag} {label} {name}: {len(cases)} class pairs, {nq} quartets, "
              f"{n_prim:.4e} primitive quartets ({n_series:.4e} on the Boys "
              f"series; padded {padded:.4e}): max abs "
              f"err {v['max_abs_err']:.3e}; kernel {v['ms']:.3f} ms, plain "
              f"torch {v['plain_ms']:.3f} ms, bound {v['bound_ms']:.4f} ms "
              f"({v['bound_by']})", flush=True)
    # the bound of one full build (every screened quartet) through K5
    ops_full = 0.0
    bytes_full = jk_bytes
    stair = staircase_prims(sdf)
    for x in stair:
        la, lb, lc, ld = x["bra"].la, x["bra"].lb, x["ket"].la, x["ket"].lb
        ops_full += eri_ops(la, lb, lc, ld, x["n_prim"], x["n_series"],
                            x["kb"], x["kk"])
        ops_full += 12.0 * x["N"] * ncart(la) * ncart(lb) * ncart(lc) * ncart(ld)
        bytes_full += 8.0 * (x["bra"].pair.numel() + x["ket"].pair.numel()
                             + x["ncum"])
    full = {"quartets": sdf.n_quartets,
            "padded_primitive_quartets": sum(x["padded"] for x in stair),
            "primitive_quartets": sum(x["n_prim"] for x in stair),
            "series_primitive_quartets": sum(x["n_series"] for x in stair),
            **bound_of(bytes_full, ops_full)}
    print(f"{tag} {name}: one full K5 build ({sdf.n_quartets} quartets) is "
          f"bound by {full['bound_ms']:.3f} ms ({full['bound_by']}: "
          f"{ops_full:.4e} operations)", flush=True)
    return {"system": name, "class_pairs": len(cases), "quartets": nq,
            "primitive_quartets": n_prim, "series_primitive_quartets": n_series,
            "padded_primitive_quartets": padded,
            "jk_scale": scale, "kernels": out, "full": full}


# --------------------------------------------------------------- phases 4-5

def steady_mean(vals: list[float]) -> float:
    """bench.py's steady mean: drop values over 2x the median (>= 3 samples)."""
    import statistics

    if len(vals) >= 3:
        med = statistics.median(vals)
        vals = [v for v in vals if v <= 2.0 * med] or vals
    return sum(vals) / len(vals) if vals else float("nan")


def run_system(tag: str, jc, name: str, golden: dict, ref: dict | None,
               route: str, extra: dict | None = None,
               conventional: bool = False, aux: bool = True) -> dict:
    """One run_spec to convergence, held to the JAX package's DF energy
    (ref) or, for conventional RHF, to GAMESS at 1.49e-8 relative."""
    import torch

    from juliachem_jl_tpu_torch.utils.timings import JCTC

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = jc.run_spec(jc.io.parse_input(system_input(
        name, golden, extra, CONV_SCF if conventional else SCF, aux)))
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    res = out["Energy"]
    tm = res["Timings"]
    E = float(res["Energy"])
    d_gms = E - golden["energy"]
    d_ref = E - ref["energy"] if ref else None
    nt = tm.non_timing_data
    builder = nt["fock_builder"]
    pref = JCTC.fock_time + "-"
    iters = sorted(int(k[len(pref):]) for k in tm.timings if k.startswith(pref))
    # after a DF guess the conventional loop rewrote fock_time-1..n; the
    # keys above n are the DF iterations'
    iters = [i for i in iters if i <= int(res["Iterations"])]
    fock = {i: tm.timings[f"{pref}{i}"] for i in iters}
    f32 = {i for i in iters if f"fock_f32-{i}" in tm.timings}
    steady = iters[1:] if len(iters) > 2 else iters
    f64_steady = [fock[i] for i in steady if i not in f32]
    f32_phase = [fock[i] for i in steady if i in f32]
    setup = {k: tm.timings.get(key, float("nan")) for k, key in (
        ("two_center", JCTC.two_center_time), ("three_center", JCTC.three_center_time),
        ("B", JCTC.B_time), ("screening", JCTC.screening_time),
        ("H", JCTC.H_time), ("guess", JCTC.guess_time),
        ("conventional_setup", "conventional_setup_time"))}
    # packed route: per-iteration split of the Fock build (V = B d; the
    # J/K pass of K2 + W^T W + V B; scatter of J and G = J - K/2)
    fock_split = {k: steady_mean([tm.timings[f"{key}-{i}"] for i in steady
                                  if i not in f32 and f"{key}-{i}" in tm.timings])
                  for k, key in (("V", JCTC.V_time), ("JK_pass", JCTC.K_time),
                                 ("finalize", JCTC.J_time))}
    peak = torch.cuda.max_memory_allocated(dev)
    summary = {
        "system": name, "route": builder, "incore": nt.get("incore"),
        "df_guess_builder": nt.get("df_guess_builder"),
        "df_guess_iterations": nt.get("df_guess_iterations"),
        "converged": bool(res["Converged?"]),
        "iterations": int(res["Iterations"]), "energy": E,
        "minus_jax_reference": d_ref, "minus_gamess": d_gms,
        "setup_s": setup, "fock_s_per_iter_f64_steady": steady_mean(f64_steady),
        "fock_s_first_iter": fock.get(iters[0]) if iters else None,
        "f64_steady_iters": len(f64_steady),
        "fock_s_per_iter_f32_phase": steady_mean(f32_phase) if f32_phase else None,
        "f32_phase_iters": len(f32_phase), "fock_split_s": fock_split,
        "wall_s": wall,
        "peak_device_bytes": peak,
        "on_cuda": all(t.is_cuda for t in (res["Density"], res["Fock"],
                                           res["MO Coeff"], res["Overlap"])),
    }
    ref_txt = f"E - JAX = {d_ref:.3e}, " if ref else ""
    guess_txt = (f" after {summary['df_guess_iterations']} DF-guess iterations"
                 f" on {summary['df_guess_builder']}"
                 if summary["df_guess_builder"] else "")
    print(f"{tag} {name}: route {builder} (incore {summary['incore']}), "
          f"converged {summary['converged']} in {summary['iterations']} "
          f"iterations{guess_txt}, E = {E:.10f} Eh, {ref_txt}E - GAMESS = "
          f"{d_gms:.3e}, wall {wall:.2f} s", flush=True)
    print(f"{tag} {name}: setup s " + ", ".join(
        f"{k} {v:.3f}" for k, v in setup.items()), flush=True)
    f32_txt = (f"; f32 phase {summary['fock_s_per_iter_f32_phase']:.5f} s/iter "
               f"over {len(f32_phase)} iters" if f32_phase else "; no f32 phase")
    print(f"{tag} {name}: Fock f64 steady {summary['fock_s_per_iter_f64_steady']:.5f}"
          f" s/iter over {len(f64_steady)} iters, first iteration "
          f"{summary['fock_s_first_iter']:.5f} s{f32_txt}; peak device memory "
          f"{peak / 1e9:.3f} GB", flush=True)
    if not math.isnan(fock_split["JK_pass"]):  # recorded by the packed builder
        print(f"{tag} {name}: f64 Fock split s/iter " + ", ".join(
            f"{k} {v:.5f}" for k, v in fock_split.items()), flush=True)
    check(builder == route, f"{name}: route {builder}, expected {route}")
    check(summary["converged"], f"{name}: SCF did not converge")
    if ref:
        check(abs(d_ref) <= E_REF_TOL,
              f"{name}: |E - JAX| = {abs(d_ref):.3e} > {E_REF_TOL}")
    gms_tol = (E_GAMESS_REL * abs(golden["energy"]) if conventional
               else E_GAMESS_TOL)
    check(abs(d_gms) <= gms_tol,
          f"{name}: |E - GAMESS| = {abs(d_gms):.3e} > {gms_tol:.3e}")
    check(summary["on_cuda"], f"{name}: SCF tensors are not on the card")
    summary["density"] = res["Density"]
    return summary


def builds_at(tag: str, dev, prim, D) -> dict:
    """At a converged density: one in-core build (reference G), one direct
    build (K5 list mode) and one streaming build (K5 staircase mode), each
    with the launch counts of its own path; G of each held to the in-core G
    at 1e-11 x max|G|."""
    import torch

    from juliachem_jl_tpu_torch.ops import fock, fock_stream, kernels

    out = {}
    G_ref = None
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
        G = J - 0.5 * K
        counts = {k: v for k, v in kernels.launches.items() if v}
        if G_ref is None:
            G_ref = G
        err = float((G - G_ref).abs().max())
        scale = float(G_ref.abs().max())
        out[label] = {"setup_s": t1 - t0, "build_s": t2 - t1,
                      "cached_build_s": t3 - t2 if label == "incore" else None,
                      "max_abs_err_vs_incore": err, "launches": counts,
                      "quartets": fb.n_quartets}
        print(f"{tag} ammonia_trimer {label} build at the converged D: setup "
              f"{t1 - t0:.3f} s, build {t2 - t1:.4f} s"
              + (f" (cached blocks: {t3 - t2:.4f} s)" if label == "incore"
                 else "")
              + f", |G - G_incore| {err:.3e} (bound 1e-11 x {scale:.3e}); "
              f"launches {counts}", flush=True)
        check(err <= 1e-11 * scale,
              f"{label} build: |G - G_incore| {err:.3e} > 1e-11 x {scale:.3e}")
        fb.finalize()
    check(out["direct"]["launches"].get("eri4c_jk_list", 0) > 0,
          "K5 list mode never launched on the direct build")
    check(out["streaming"]["launches"].get("eri4c_jk_stair", 0) > 0,
          "K5 staircase mode never launched on the streaming build")
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
    print(f"{tag} build: {len(kernels._sources())} CUDA sources -> "
          f"{Path(kernels.build_info['so']).name} in {build_s:.1f} s "
          f"({len(spills)} kernel instances spill registers)", flush=True)

    goldens = json.loads((ROOT / "tests" / "data" /
                          "s22x3_gamess_goldens.json").read_text())
    refs = json.loads((ROOT / "juliachem_jl_tpu_torch" / "data" /
                       "smoke_reference.json").read_text())["systems"]

    # 3. kernels vs plain: K1/K2/K3 at benzene_2_water's DF shapes; K4, K5,
    #    K6 at ammonia_trimer's and benzene_2_water's 4-center shapes
    spec = jc.io.parse_input(system_input("benzene_2_water",
                                          goldens["benzene_2_water"]))
    bsets = jc.basis.run(jc.molecule.run(spec), spec.model)
    k1 = check_k1(tag, dev, bsets)
    k2 = check_k2(tag, dev, bsets, create_scf_options(spec.scf_keywords))
    k3 = check_k3(tag, dev)
    k1["primitive_products"] = k1_primitive_counts(
        tag, dev, bsets, create_scf_options(spec.scf_keywords))
    spec_a = jc.io.parse_input(system_input(
        "ammonia_trimer", goldens["ammonia_trimer"], aux=False))
    bsets_a = jc.basis.run(jc.molecule.run(spec_a), spec_a.model)
    fourc = {"ammonia_trimer": check_4c(tag, dev, "ammonia_trimer", bsets_a, 1),
             "benzene_2_water": check_4c(tag, dev, "benzene_2_water", bsets, 2)}
    for name, v in fourc.items():
        f = v["full"]
        print(f"{tag} {name}: {f['quartets']} screened quartets, "
              f"{f['primitive_quartets']} primitive quartets of nonzero "
              f"coefficients ({f['series_primitive_quartets']} on the Boys "
              f"series), {f['padded_primitive_quartets']} with the class "
              f"padding", flush=True)

    counts = {}

    def path(label, fn):
        kernels.reset_launches()
        res = fn()
        counts[label] = dict(kernels.launches)
        print(f"{tag} launches during {label}: "
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
        {"mixed_precision": False}))
    # 6. conventional, in-core; then the direct and streaming builds at its D
    ammonia_conv = path("ammonia_trimer conventional", lambda: run_system(
        tag, jc, "ammonia_trimer", goldens["ammonia_trimer"], None,
        "ScreenedDirectFock", {"guess": "sad"}, conventional=True,
        aux=False))
    check(ammonia_conv["incore"] == "True",
          "ammonia_trimer conventional did not run in-core")
    builds = builds_at(tag, dev, bsets_a.primary, ammonia_conv["density"])
    counts["ammonia_trimer direct build"] = builds["direct"]["launches"]
    counts["ammonia_trimer streaming build"] = builds["streaming"]["launches"]
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
    jc.finalize()

    # each kernel's launches on its path
    main_path = {"eri3c": "benzene_2_water DF", "df_gather_w": "benzene_2_water DF",
                 "eri4c": "ammonia_trimer conventional",
                 "digest_jk": "ammonia_trimer conventional",
                 "eri4c_jk_list": "ammonia_trimer direct build",
                 "eri4c_jk_stair": "benzene_2_water conventional"}
    for name, label in main_path.items():
        check(counts[label].get(name, 0) > 0,
              f"kernel {name} never launched on {label}")
    for k in (k1, k2):
        k["launches"] = counts[main_path[k["name"]]][k["name"]]
        k["path"] = main_path[k["name"]]
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
    kern_line = [k1, k2] + new_kernels

    systems = [ammonia, benzene, ammonia_conv, benzene_conv]
    for x in systems:
        x.pop("density", None)
    if args.out:
        Path(args.out).write_text(json.dumps({
            "device": kind, "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda, "build_s": build_s,
            "spills": spills, "kernels": kern_line, "probes": [k3],
            "four_center": {k: {kk: vv for kk, vv in v.items()}
                            for k, v in fourc.items()},
            "builds_at_ammonia_convergence": builds,
            "launches_per_path": counts, "systems": systems}, indent=1))
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
