#!/usr/bin/env python3
"""Time two candidate designs of K9 (csrc/oei.cuh, S/T/V) against it on one
NVIDIA GPU, or rehearse them on the CPU.

    python3 tools/stv_candidates.py [--rounds 2] [--reps 5] [--out FILE]
    python3 tools/stv_candidates.py --rehearse

The candidates (tools/stv_candidates/):

- ``thread``: K9's body with one thread a shell pair (G = 1, 32 pairs a
  block; ``stv_thread.cu``), for the s, p and d classes, at
  ``benzene_2_water`` in its DF basis and at ``w8`` (27 and 24 nuclei).
- ``block``: one block a shell pair, the nuclear sum's R in shared memory,
  built level by level across the block by K4/K5's and K1's
  ``block_r_levels`` (``stv_block.cuh``), for the f and g classes, at
  ``benzene_2_water`` in 6-311++G(3df,3pd) and in the g basis file.

On the card: builds the package's kernels and the candidates' two sources
(one ``nvcc`` each, the package's flags, in parallel with the package's
build), prints ptxas's registers and spills of each candidate instance,
runs each candidate's classes into S, T and V filled with NaN and holds
its elements to ``overlap_kinetic_nuclear_plain`` (1e-12 x each matrix's
max-abs), then times K9 (at the group ``kernels.stv_group`` picks) and the
candidate on those classes with CUDA events (a mean of --reps launches
after a warm-up, each class alone and their sum), in turns K9, candidate,
candidate, K9, --rounds times, beside the bound of the classes' counts
(``chip_smoke.stv_bound``).  Every line names the card and its power limit.
Exits 1 if a candidate is off the plain version, 2 without CUDA.

``--rehearse``: the candidates' device code built with g++ against the CPU
stand-in of tools/eri4c_rehearsal/shim and held to the plain version on
two waters in 6-311++G(2d,2p) (``thread``) and in the g basis file
(``block``); says nothing of the card's speed.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "tools" / "stv_candidates"
SHIM = ROOT / "tools" / "eri4c_rehearsal" / "shim"
G_BASIS_FILE = ROOT / "tests" / "data" / "6-311ppG_3df_3pd_G.gbs"
G_BASIS = "6-311++G(3df,3pd)+G"
# the candidates' C entries, their classes and the systems they are timed at
CANDIDATES = {
    "thread": ("jc_stv_thread", [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2),
                                 (2, 2)], ["benzene_2_water", "w8"]),
    "block": ("jc_stv_block", [(0, 3), (0, 4), (1, 3), (1, 4), (2, 3),
                               (2, 4), (3, 3), (3, 4), (4, 4)],
              ["benzene_2_water_f", "benzene_2_water_g"]),
}
REHEARSAL_BASIS = {"thread": "6-311++G(2d,2p)", "block": G_BASIS}
ENTRY = re.compile(r"Compiling entry function '_ZN2jc\d+"
                   r"(stv_(?:block_)?kernel)ILi(\d)ELi(\d)E")
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ARGTYPES = [_I, _I, _P, _P, _P, _LL, _P, _I, _P, _P, _P, _LL]


def load(path: Path):
    """The module of a script of the repo (chip_smoke.py, a tool)."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def route_flags(kernels) -> list:
    """The -D flags csrc/eri4c.cuh (block_r_levels) is built with."""
    return [*kernels.route_flags(), *kernels.eri3c_route_flags(),
            *kernels.digest_route_flags(), *kernels.eri3c_t1_flags(),
            *kernels.block_route_flags()]


def instances(log: str) -> dict:
    """Each candidate instance's registers, stack frame and spills, as
    ptxas reported them in ``log``."""
    per, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = ENTRY.search(ln)
            cur = (per.setdefault(f"{m.group(1)} ({m.group(2)}{m.group(3)})",
                                  {}) if m else None)
        elif cur is not None and "bytes stack frame" in ln:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            cur.update(stack=nums[0], spill_stores=nums[1],
                       spill_loads=nums[2])
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur["registers"] = int(ln.split("Used", 1)[1].split()[0])
    return per


def call(lib, entry: str, tab, atoms, M) -> None:
    rc = getattr(lib, entry)(tab.la, tab.lb, tab.prim.data_ptr(),
                             tab.pair.data_ptr(), tab.meta.data_ptr(), tab.n,
                             atoms.data_ptr(), atoms.shape[0],
                             *(m.data_ptr() for m in M), M[0].shape[0])
    if rc != 0:
        raise RuntimeError(f"{entry} ({tab.la}{tab.lb}): error {rc}")


def held(got, ref, tabs, oei) -> float:
    """Worst error over the stored elements of ``tabs``' classes, each
    matrix's over its max-abs."""
    import torch

    nbf = ref[0].shape[0]
    idx = torch.as_tensor(np.concatenate(
        [oei.stv_targets(t, nbf).reshape(-1) for t in tabs]),
        device=ref[0].device)
    return max(float((g.reshape(-1)[idx] - r.reshape(-1)[idx]).abs().max()
                     / r.abs().max()) for g, r in zip(got, ref))


def rehearse() -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    from juliachem_jl_tpu_torch import basis, molecule
    from juliachem_jl_tpu_torch.ops import kernels, oei

    out = kernels.BUILD_DIR / "rehearsal"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "stv_candidates.so"
    defines = [f for f in kernels.NVCC_FLAGS if f.startswith("-D")]
    subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared",
                    "-pthread", *defines, *route_flags(kernels), "-I", str(SHIM),
                    "-I", str(kernels.CSRC_DIR), "-I", str(HERE),
                    str(HERE / "harness.cpp"), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    torch.set_num_threads(1)
    basis.register_basis_file(str(G_BASIS_FILE), G_BASIS)
    waters = load(ROOT / "tools" / "oei_rehearsal.py").WATERS
    mol = molecule.from_input_dict(waters)
    atoms = oei.atom_table(mol, "cpu")
    worst = 0.0
    for cand, (entry, classes, _) in CANDIDATES.items():
        fn = getattr(lib, "rh_" + entry[3:])
        fn.argtypes = ARGTYPES
        b = basis.build(mol, REHEARSAL_BASIS[cand])
        ref = oei.overlap_kinetic_nuclear_plain(b, mol, "cpu")
        tabs = [t for t in oei.stv_tables(b, "cpu")
                if (t.la, t.lb) in classes]
        got = [torch.full_like(ref[0], float("nan")) for _ in range(3)]
        for t in tabs:
            call(lib, "rh_" + entry[3:], t, atoms, got)
        err = held(got, ref, tabs, oei)
        worst = max(worst, err)
        print(f"{cand} in {REHEARSAL_BASIS[cand]}: classes "
              f"{[(t.la, t.lb) for t in tabs]}, max err / max |M| {err:.2e} "
              "(bound 1e-12)", flush=True)
    return 0 if worst <= 1e-12 else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.rehearse:
        return rehearse()
    import torch

    if not torch.cuda.is_available():
        print("stv_candidates: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    smoke = load(ROOT / "chip_smoke.py")
    times = load(ROOT / "tools" / "stv_times.py")
    import juliachem_jl_tpu_torch as jc
    from juliachem_jl_tpu_torch.ops import kernels, oei

    smi = smoke.sh("nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader").splitlines()[0]
    tag = f"[{smi}]"
    out = kernels.BUILD_DIR / "stv_candidates"
    out.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, *route_flags(kernels),
         "-I", str(kernels.CSRC_DIR), "-I", str(HERE),
         "-c", str(HERE / f"stv_{c}.cu"), "-o", str(out / f"stv_{c}.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in CANDIDATES]
    dev = jc.initialize("cuda")
    kernels.library()
    log = "\n".join(p.communicate()[0] for p in procs)
    if any(p.returncode for p in procs):
        print(log, file=sys.stderr)
        return 1
    so = out / "stv_candidates.so"
    subprocess.run([kernels._nvcc(), "-shared", "-o", str(so),
                    *(str(out / f"stv_{c}.o") for c in CANDIDATES)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    for entry, _, _ in CANDIDATES.values():
        getattr(lib, entry).argtypes = ARGTYPES
    regs = instances(log)
    print(f"{tag} candidates (ptxas): " + "; ".join(
        f"{k} {v.get('registers')} registers, stack {v.get('stack')} B, "
        f"spills {v.get('spill_stores')} B" for k, v in sorted(regs.items())),
        flush=True)
    results, bad = {"device": smi, "ptxas": regs, "runs": {}}, False
    mean = lambda v: sum(v) / len(v)
    for cand, (entry, classes, systems) in CANDIDATES.items():
        for name in systems:
            prim, mol = times.system(smoke, jc, name)
            tabs = [t for t in oei.stv_tables(prim, dev)
                    if (t.la, t.lb) in classes]
            atoms = oei.atom_table(mol, dev)
            ref = oei.overlap_kinetic_nuclear_plain(prim, mol, dev)
            got = [torch.full_like(ref[0], float("nan")) for _ in range(3)]
            for t in tabs:
                call(lib, entry, t, atoms, got)
            err = held(got, ref, tabs, oei)
            bad |= not err <= 1e-12
            M = [torch.empty_like(ref[0]) for _ in range(3)]

            def run(k, ts, M=M, atoms=atoms, entry=entry):
                for t in ts:
                    if k == "k9":
                        oei.stv_class(t, atoms, *M)
                    else:
                        call(lib, entry, t, atoms, M)

            read = {k: {"all": [], **{(t.la, t.lb): [] for t in tabs}}
                    for k in ("k9", cand)}
            for _ in range(args.rounds):
                for k in ("k9", cand, cand, "k9"):
                    read[k]["all"].append(smoke.cuda_ms(
                        functools.partial(run, k, tabs), args.reps))
                    for t in tabs:
                        read[k][(t.la, t.lb)].append(smoke.cuda_ms(
                            functools.partial(run, k, [t]), args.reps))
            counts = smoke.stv_counts(tabs, atoms)
            bound = smoke.stv_bound(counts, mol.natom)
            print(f"{tag} {cand} at {name} ({mol.natom} nuclei, K9 at G "
                  f"{kernels.stv_group(mol.natom)}): classes "
                  f"{[(t.la, t.lb) for t in tabs]}, max err / max |M| "
                  f"{err:.2e} (bound 1e-12); all classes ms: K9 "
                  + ", ".join(f"{x:.4f}" for x in read["k9"]["all"])
                  + f"; {cand} " + ", ".join(
                      f"{x:.4f}" for x in read[cand]["all"])
                  + f" (bound {bound['bound_ms']:.4f} ms, "
                  f"{bound['bound_by']}); by class, K9 / {cand} mean ms: "
                  + "; ".join(f"({a}{b}) {mean(read['k9'][(a, b)]):.4f} / "
                              f"{mean(read[cand][(a, b)]):.4f}"
                              for a, b in classes if (a, b) in read[cand]),
                  flush=True)
            results["runs"][f"{cand} {name}"] = {
                "natom": mol.natom, "group": kernels.stv_group(mol.natom),
                "max_rel_err": err, "bound": bound, "counts": counts,
                "ms": read}
            del ref, got, M
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(smoke.str_keys(results),
                                             indent=1, default=str))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
