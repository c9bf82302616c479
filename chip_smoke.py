#!/usr/bin/env python3
"""Smoke run of the PyTorch port (juliachem_jl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out result.json]

Phases, each printing its lines (every measured number tagged with the
card's name and power limit):

1. device: card name, ``nvidia-smi`` name and power limit, torch's CUDA
   version, ``nvcc --version``;
2. build the CUDA kernels of juliachem_jl_tpu_torch/csrc with nvcc;
3. each kernel against its plain torch version on the card, at the shapes
   of benzene_2_water (6-311++G(2d,2p) / cc-pVTZ-JKFIT): K1 (3-center
   integrals, every class the system reaches, a subset of bra pairs),
   K2 (packed-B exchange factor, f64 and f32), and the probe K3 (device
   Boys function); kernel and plain times from CUDA events;
4. ammonia_trimer DF-RHF through run_spec (dense-B route);
5. benzene_2_water DF-RHF through run_spec (packed route, the main path),
   with the launch counts of the kernels taken over this run alone.

Energies are held to the JAX package's recorded energies
(juliachem_jl_tpu_torch/data/smoke_reference.json, 1e-6 Eh) and to GAMESS
(tests/data/s22x3_gamess_goldens.json, 1.5e-3 Eh).  The second-to-last line
is ``{"kernels": [...]}``; the last is ``{"ok": true, "device": ...}``.  Any
failed check exits nonzero without that last line; so does a machine
without CUDA or a directory without the package.
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
E_REF_TOL = 1e-6       # vs the JAX package's energy (CPU, f64)
E_GAMESS_TOL = 1.5e-3  # DF vs conventional GAMESS


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


def system_input(name: str, golden: dict, extra: dict | None = None) -> dict:
    atoms = golden["atoms"]
    return {
        "molecule": {"symbols": [a["symbol"] for a in atoms],
                     "geometry": [x * BOHR for a in atoms for x in a["xyz_bohr"]],
                     "molecular_charge": 0},
        "driver": "energy",
        "model": {"method": "RHF", "basis": golden["basis"],
                  "auxiliary_basis": "cc-pVTZ-JKFIT"},
        "keywords": {"scf": {**SCF, **(extra or {})}, "prop": PROPS},
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
    return {"name": "boys_probe", "route": "cuda",
            "source": "juliachem_jl_tpu_torch/csrc/boys_probe.cu",
            "replaces": "juliachem_jl_tpu/ops/boys.py:61",
            "max_abs_err": float((boys.boys_probe(T, 8)
                                  - boys.boys(T, 8)).abs().max()),
            "max_rel_err": worst, "ms": ms, "plain_ms": plain}


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
    return {"name": "eri3c", "route": "cuda",
            "source": "juliachem_jl_tpu_torch/csrc/eri3c.cuh",
            "replaces": "juliachem_jl_tpu/ops/eri3c.py:126",
            "max_abs_err": worst_abs, "max_rel_err": worst_rel,
            "ms": ms, "plain_ms": plain}


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
    return {"name": "df_gather_w", "route": "cuda",
            "source": "juliachem_jl_tpu_torch/csrc/df_gather_w.cu",
            "replaces": "juliachem_jl_tpu/models/df_screened.py:303",
            "max_abs_err": err, "max_rel_err": rel, "ms": ms,
            "plain_ms": plain, "f32_ms": res[torch.float32][2],
            "f32_plain_ms": res[torch.float32][3]}


# --------------------------------------------------------------- phases 4-5

def steady_mean(vals: list[float]) -> float:
    """bench.py's steady mean: drop values over 2x the median (>= 3 samples)."""
    import statistics

    if len(vals) >= 3:
        med = statistics.median(vals)
        vals = [v for v in vals if v <= 2.0 * med] or vals
    return sum(vals) / len(vals) if vals else float("nan")


def run_system(tag: str, jc, name: str, golden: dict, ref: dict, route: str,
               extra: dict | None = None) -> dict:
    import torch

    from juliachem_jl_tpu_torch.utils.timings import JCTC

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = jc.run_spec(jc.io.parse_input(system_input(name, golden, extra)))
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    res = out["Energy"]
    tm = res["Timings"]
    E = float(res["Energy"])
    d_ref, d_gms = E - ref["energy"], E - golden["energy"]
    builder = tm.non_timing_data["fock_builder"]
    pref = JCTC.fock_time + "-"
    iters = sorted(int(k[len(pref):]) for k in tm.timings if k.startswith(pref))
    fock = {i: tm.timings[f"{pref}{i}"] for i in iters}
    f32 = {i for i in iters if f"fock_f32-{i}" in tm.timings}
    steady = iters[1:] if len(iters) > 2 else iters
    f64_steady = [fock[i] for i in steady if i not in f32]
    f32_phase = [fock[i] for i in steady if i in f32]
    setup = {k: tm.timings.get(key, float("nan")) for k, key in (
        ("two_center", JCTC.two_center_time), ("three_center", JCTC.three_center_time),
        ("B", JCTC.B_time), ("screening", JCTC.screening_time),
        ("H", JCTC.H_time), ("guess", JCTC.guess_time))}
    # packed route: per-iteration split of the Fock build (V = B d; the
    # J/K pass of K2 + W^T W + V B; scatter of J and G = J - K/2)
    fock_split = {k: steady_mean([tm.timings[f"{key}-{i}"] for i in steady
                                  if i not in f32 and f"{key}-{i}" in tm.timings])
                  for k, key in (("V", JCTC.V_time), ("JK_pass", JCTC.K_time),
                                 ("finalize", JCTC.J_time))}
    peak = torch.cuda.max_memory_allocated(dev)
    summary = {
        "system": name, "route": builder, "converged": bool(res["Converged?"]),
        "iterations": int(res["Iterations"]), "energy": E,
        "minus_jax_reference": d_ref, "minus_gamess": d_gms,
        "setup_s": setup, "fock_s_per_iter_f64_steady": steady_mean(f64_steady),
        "f64_steady_iters": len(f64_steady),
        "fock_s_per_iter_f32_phase": steady_mean(f32_phase) if f32_phase else None,
        "f32_phase_iters": len(f32_phase), "fock_split_s": fock_split,
        "wall_s": wall,
        "peak_device_bytes": peak,
        "on_cuda": all(t.is_cuda for t in (res["Density"], res["Fock"],
                                           res["MO Coeff"], res["Overlap"])),
    }
    print(f"{tag} {name}: route {builder}, converged {summary['converged']} "
          f"in {summary['iterations']} iterations, E = {E:.10f} Eh, "
          f"E - JAX = {d_ref:.3e}, E - GAMESS = {d_gms:.3e}, wall "
          f"{wall:.2f} s", flush=True)
    print(f"{tag} {name}: setup s " + ", ".join(
        f"{k} {v:.3f}" for k, v in setup.items()), flush=True)
    f32_txt = (f"; f32 phase {summary['fock_s_per_iter_f32_phase']:.5f} s/iter "
               f"over {len(f32_phase)} iters" if f32_phase else "; no f32 phase")
    print(f"{tag} {name}: Fock f64 steady {summary['fock_s_per_iter_f64_steady']:.5f}"
          f" s/iter over {len(f64_steady)} iters{f32_txt}; peak device memory "
          f"{peak / 1e9:.3f} GB", flush=True)
    if not math.isnan(fock_split["JK_pass"]):  # recorded by the packed builder
        print(f"{tag} {name}: f64 Fock split s/iter " + ", ".join(
            f"{k} {v:.5f}" for k, v in fock_split.items()), flush=True)
    check(builder == route, f"{name}: route {builder}, expected {route}")
    check(summary["converged"], f"{name}: SCF did not converge")
    check(abs(d_ref) <= E_REF_TOL,
          f"{name}: |E - JAX| = {abs(d_ref):.3e} > {E_REF_TOL}")
    check(abs(d_gms) <= E_GAMESS_TOL,
          f"{name}: |E - GAMESS| = {abs(d_gms):.3e} > {E_GAMESS_TOL}")
    check(summary["on_cuda"], f"{name}: SCF tensors are not on the card")
    return summary


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

    # 3. kernels vs plain at benzene_2_water's shapes
    spec = jc.io.parse_input(system_input("benzene_2_water",
                                          goldens["benzene_2_water"]))
    bsets = jc.basis.run(jc.molecule.run(spec), spec.model)
    k1 = check_k1(tag, dev, bsets)
    k2 = check_k2(tag, dev, bsets, create_scf_options(spec.scf_keywords))
    k3 = check_k3(tag, dev)

    # 4. dense-B route
    ammonia = run_system(tag, jc, "ammonia_trimer", goldens["ammonia_trimer"],
                         refs["ammonia_trimer"], "DFFockBuilder")

    # 5. packed route, the main path; counts over this run alone
    kernels.reset_launches()
    benzene = run_system(tag, jc, "benzene_2_water",
                         goldens["benzene_2_water"], refs["benzene_2_water"],
                         "ScreenedDFFockBuilder", {"mixed_precision": False})
    counts = dict(kernels.launches)
    print(f"{tag} launches during the benzene_2_water run: {counts}",
          flush=True)
    for k in (k1, k2):
        k["launches"] = counts[k["name"]]
        check(k["launches"] > 0, f"kernel {k['name']} never launched on the "
                                 "main path")
    k3["launches"] = counts["boys_probe"]
    jc.finalize()

    if args.out:
        Path(args.out).write_text(json.dumps({
            "device": kind, "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda, "build_s": build_s,
            "kernels": [k1, k2], "probes": [k3],
            "systems": [ammonia, benzene]}, indent=1))
    print(smi)
    print(json.dumps({"kernels": [k1, k2], "probes": [k3]}))
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
