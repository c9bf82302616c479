#!/usr/bin/env python3
"""Time K9 (csrc/oei.cuh, S/T/V) on one NVIDIA GPU at each group size, class
by class, at the systems the main path gives it.

    python3 tools/stv_times.py [--systems benzene_2_water w32 w64 ...]
        [--groups 8 16 32] [--rounds 2] [--reps 5] [--out FILE]

Systems: ``benzene_2_water`` in its DF basis, ``benzene_2_water_f`` in
6-311++G(3df,3pd), ``benzene_2_water_g`` in the g basis file, and the water
clusters ``w8``, ``w32`` and ``w64`` in 6-31+G* (chip_smoke.py's inputs).
Builds the package's kernels, then for each system packs the classes
(``oei.stv_tables``) and, at each group size of ``kernels.STV_GROUPS``,
runs every class into S, T and V filled with NaN and holds them to
``overlap_kinetic_nuclear_plain`` on the card (1e-12 x each matrix's
max-abs).  Then the CUDA-event times (mean of --reps launches after a
warm-up) of each class at each group size, in turns (the groups in order,
then reversed, --rounds times), and of all classes at the group
``kernels.stv_group`` picks for the system's nuclei and at each class's
fastest group, beside the bound of the system's counts (``chip_smoke.stv_bound``) and the plain
version's time, and at each group size the warp steps that run the Boys
series on some lane (``series_steps``).  Each instance's ptxas registers
and spills are printed.
Every line names the card and its power limit.  Exits 1 if a group is
off the plain version, 2 without CUDA.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
K9_ENTRY = re.compile(r"\d+stv_kernelILi(\d)ELi(\d)E")


def k9_instances(log: str) -> dict:
    """K9's instances as ptxas reported them in ``log``, by class:
    registers a thread, stack frame and spill bytes."""
    per, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = K9_ENTRY.search(ln)
            cur = per.setdefault(m.group(1) + m.group(2), {}) if m else None
        elif cur is not None and "bytes stack frame" in ln:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            cur.update(stack=nums[0], spill_stores=nums[1],
                       spill_loads=nums[2])
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur["registers"] = int(ln.split("Used", 1)[1].split()[0])
    return per


def series_steps(tables, atoms, group: int, tcrit: float) -> tuple[int, int]:
    """K9's warp steps at ``group`` lanes a shell pair (a warp's 32 /
    group pairs, one live primitive pair each and one nucleus a lane: the
    most primitive pairs of its pairs times the nuclei over the group) and
    how many of them run the Boys series on some lane (T <= tcrit), which
    the whole warp then waits for."""
    import torch

    natom = atoms.shape[0]
    its = -(-natom // group)
    C = torch.cat([atoms[:, :3], atoms.new_full((its * group - natom, 3),
                                                float("inf"))])
    rows = max(1, (1 << 24) // (its * group))
    steps = series = 0
    for tab in tables:
        meta = tab.meta.long()
        warp = torch.arange(tab.n, device=meta.device) // (32 // group)
        kmax = torch.zeros(int(warp[-1]) + 1, dtype=torch.long,
                           device=meta.device).scatter_reduce_(
            0, warp, meta[:, 4], "amax")
        steps += int(kmax.sum()) * its
        seg = torch.repeat_interleave(
            torch.arange(tab.n, device=meta.device), meta[:, 4])
        keys = []
        for s0 in range(0, tab.prim.shape[0], rows):
            r = seg[s0:s0 + rows]
            a, b = tab.prim[s0:s0 + rows, 0], tab.prim[s0:s0 + rows, 1]
            cen = tab.pair[r]
            p = a + b
            P = (a[:, None] * cen[:, :3] + b[:, None] * cen[:, 3:]) / p[:, None]
            T = p[:, None] * ((P[:, None, :] - C[None]) ** 2).sum(-1)
            hit = (T.reshape(-1, its, group) <= tcrit).any(-1)
            i, it = torch.nonzero(hit, as_tuple=True)
            k = s0 + i - meta[r[i], 3]
            keys.append((warp[r[i]] * int(kmax.max()) + k) * its + it)
        if keys:
            series += int(torch.unique(torch.cat(keys)).numel())
    return steps, series


def system(smoke, jc, name: str):
    """(primary basis, molecule) of one system."""
    goldens = json.loads((HERE / "tests" / "data" /
                          "s22x3_gamess_goldens.json").read_text())
    bz = goldens["benzene_2_water"]
    if name == "benzene_2_water":
        inp = smoke.system_input(name, bz)
    elif name == "benzene_2_water_f":
        inp = smoke.system_input("benzene_2_water",
                                 {**bz, "basis": smoke.F_BASIS})
    elif name == "benzene_2_water_g":
        inp = smoke.g_input("benzene_2_water", bz)
    elif name == "w8":
        inp = smoke.cluster_input("w32", waters=8)
    else:
        inp = smoke.cluster_input(name)
    spec = jc.io.parse_input(inp)
    mol = jc.molecule.run(spec)
    return jc.basis.run(mol, spec.model).primary, mol


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--systems", nargs="+",
                    default=["benzene_2_water", "benzene_2_water_f",
                             "benzene_2_water_g", "w8", "w32", "w64"])
    ap.add_argument("--groups", type=int, nargs="+", default=None)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("stv_times: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import juliachem_jl_tpu_torch as jc
    from juliachem_jl_tpu_torch.ops import kernels, oei

    smi = smoke.sh("nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader").splitlines()[0]
    tag = f"[{smi}]"
    dev = jc.initialize("cuda")
    kernels.library()
    print(f"{tag} build {kernels.build_info.get('seconds', 0.0):.1f} s; K9 "
          "sources built by " + ", ".join(
              f"{k} {v:.1f} s" for k, v in sorted(
                  kernels.build_info.get("per_source", {}).items())
              if k.startswith("oei")), flush=True)
    log = kernels.build_info.get("log")
    if log is None:
        # the library was built by an earlier process: ptxas's report of
        # K9's sources alone
        tmp = Path(tempfile.mkdtemp(dir=kernels.BUILD_DIR))
        procs = [subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC_DIR),
             "-c", str(src), "-o", str(tmp / (src.stem + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in sorted(kernels.CSRC_DIR.glob("oei_l*.cu"))]
        log = "\n".join(p.communicate()[0] for p in procs)
        shutil.rmtree(tmp, ignore_errors=True)
    per = k9_instances(log)
    regs = smoke.instance_summary(per) if per else {}
    print(f"{tag} K9 instances (ptxas): " + (smoke.fmt_instances(
        {"stv_kernel": regs}) if per else "none in the log"), flush=True)
    groups = args.groups or list(kernels.STV_GROUPS)
    results, bad = {"device": smi, "ptxas": regs, "systems": {}}, False
    for name in args.systems:
        prim, mol = system(smoke, jc, name)
        tables = oei.stv_tables(prim, dev)
        atoms = oei.atom_table(mol, dev)
        nbf = prim.nbf
        ref = oei.overlap_kinetic_nuclear_plain(prim, mol, dev)
        plain_ms = smoke.cuda_ms(lambda: oei.overlap_kinetic_nuclear_plain(
            prim, mol, dev), reps=1)
        counts = smoke.stv_counts(tables, atoms)
        bound = smoke.stv_bound(counts, mol.natom)
        errs, branch = {}, {}
        for g in groups:
            branch[g] = series_steps(tables, atoms, g, smoke.BOYS_TCRIT)
            got = [torch.full_like(ref[0], float("nan")) for _ in range(3)]
            for t in tables:
                oei.stv_class(t, atoms, *got, group=g)
            errs[g] = max(float((x - r).abs().max() / r.abs().max())
                          for x, r in zip(got, ref))
            bad |= not errs[g] <= 1e-12
        readings = {g: [] for g in groups}
        for _ in range(args.rounds):
            for order in (groups, groups[::-1]):
                for g in order:
                    readings[g].append(smoke.stv_launch_ms(
                        tables, atoms, nbf, dev, args.reps, group=g))
        per_class = {}
        for t in tables:
            cls = (t.la, t.lb)
            per_class[cls] = {g: [r["per_class"][cls] for r in readings[g]]
                              for g in groups}
        mean = lambda v: sum(v) / len(v)
        best = {c: min(groups, key=lambda g: mean(v[g]))
                for c, v in per_class.items()}
        table_ms = smoke.stv_launch_ms(tables, atoms, nbf, dev, args.reps)
        best_sum = sum(mean(per_class[c][best[c]]) for c in per_class)
        items = sum(c["items"] for c in counts.values())
        series = sum(c["series_items"] for c in counts.values())
        print(f"{tag} {name}: nbf {nbf}, {mol.natom} atoms, {len(tables)} "
              f"classes, {items} items ({series} on the Boys series); plain "
              f"{plain_ms:.2f} ms; bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}); all classes, ms (readings) by group: "
              + "; ".join(f"G {g} " + ", ".join(
                  f"{r['ms']:.4f}" for r in readings[g])
                  + f" (max err {errs[g]:.1e}; {branch[g][1]} of "
                  f"{branch[g][0]} warp steps run the series)"
                  for g in groups)
              + f"; at stv_group's G {kernels.stv_group(mol.natom)} "
              f"{table_ms['ms']:.4f}, each class's fastest (summed alone) "
              f"{best_sum:.4f}", flush=True)
        for c, v in per_class.items():
            print(f"{tag} {name} ({c[0]}{c[1]}): {counts[c]['pairs']} pairs, "
                  f"{counts[c]['live_prim_pairs']} live primitive pairs, "
                  f"{counts[c]['series_items']} of {counts[c]['items']} items "
                  "on the series; ms by group: " + "; ".join(
                      f"G {g} " + ", ".join(f"{x:.4f}" for x in v[g])
                      for g in groups)
                  + f"; fastest G {best[c]}", flush=True)
        results["systems"][name] = {
            "nbf": nbf, "natom": mol.natom, "plain_ms": plain_ms,
            "bound": bound, "max_rel_err": errs, "table_ms": table_ms,
            "warp_steps_series": branch,
            "best_group": best, "best_sum_ms": best_sum,
            "per_class_ms": per_class, "counts": counts,
            "all_classes_ms": {g: [r["ms"] for r in readings[g]]
                               for g in groups}}
        del ref
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(smoke.str_keys(results),
                                             indent=1, default=str))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
