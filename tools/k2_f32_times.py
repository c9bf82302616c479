#!/usr/bin/env python3
"""Time K2's f32 instance (csrc/df_gather_w.cu, the mixed-precision phase:
f32 B, C and W) at the Q-blocks of benzene_2_water, w32 and w64 on one
NVIDIA GPU, for several tiles and beside the bodies of other trees.

    python3 tools/k2_f32_times.py [--tiles 2,64,3 4,64,4 ...]
        [--trees DIR ...] [--systems benzene_2_water w32 w64] [--out FILE]

Builds the package's kernels (the screens need K4; the f64 instance is
timed on the same blocks), then compiles csrc/df_gather_w.cu alone once per
tile (``-DJC_K2F_NQ/_KT/_STAGES``, one nvcc each, in parallel) and the
df_gather_w.cu of each tree under ``--trees`` (at the build's tile: an
edited copy of the source, whose f32 entry point takes the live-slab list
as the package's does).  For each
system, ``chip_smoke.k2_block``'s inputs (the real screen, random f32 B
with a zero trash column and factor, k the occupied count, the Q-block of
the packed builder's block rows): every variant against
``df_gather_w_plain`` in f32 (1e-5 x max|W|), then its CUDA-event time
(mean of a few launches after a warm-up) in turns: trees, tiles, tiles
reversed, trees; beside the f64 instance on the same block, the plain
version and the bound (FP32 operations at 67 TFLOP/s, bytes at 3.35
TB/s).  Each variant's ptxas registers and spills, its SASS (FFMA,
tensor-core instructions) and its blocks an SM are printed.  Every line
names the card and its power limit.  Exits 1 if a variant is off the
plain version, 2 without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def compile_so(nvcc: str, src: Path, out: Path, flags: list) -> subprocess.Popen:
    return subprocess.Popen(
        [nvcc, *flags, "-shared", "-o", str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def sass_counts(smoke, cuobjdump: str, so: Path, frag: str) -> dict:
    """FFMA and tensor-core (opcodes ending in MMA) instructions of the
    function whose name holds ``frag``."""
    text = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True, timeout=300).stdout
    out, cur = {"FFMA": 0, "MMA": 0}, False
    for ln in text.splitlines():
        if "Function :" in ln:
            cur = frag in ln
        elif cur and (op := smoke.sass_opcode(ln)):
            out["FFMA"] += op == "FFMA"
            out["MMA"] += op.endswith("MMA")
    return out


def ptxas(log: str, frag: str) -> dict:
    """Registers, stack and spills of the entry whose name holds ``frag``."""
    out, cur = {}, False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = frag in ln
        elif cur and "Used" in ln and "registers" in ln:
            out["registers"] = int(ln.split("Used", 1)[1].split()[0])
        elif cur and "bytes stack frame" in ln:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            out.update(stack=nums[0], spill_stores=nums[1],
                       spill_loads=nums[2])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", nargs="*", default=None,
                    help="NQ,KT,STAGES tiles (default: the build's)")
    ap.add_argument("--trees", nargs="*", default=[],
                    help="trees whose df_gather_w.cu (the package's "
                         "signature) to time")
    ap.add_argument("--systems", nargs="*",
                    default=["benzene_2_water", "w32", "w64"])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k2_f32_times: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import juliachem_jl_tpu_torch as jc
    from juliachem_jl_tpu_torch.models.df_screened import (
        ScreenedDFFockBuilder, df_gather_w, df_gather_w_plain, fitted_rows)
    from juliachem_jl_tpu_torch.ops import kernels
    from juliachem_jl_tpu_torch.utils.options import create_scf_options

    smi = smoke.sh("nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader").splitlines()[0]
    tag = f"[{smi}]"
    dev = jc.initialize("cuda")
    nvcc = kernels._nvcc()
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    tiles = [tuple(int(x) for x in t.split(",")) for t in (args.tiles or [])]
    build = (kernels.K2F_NQ, kernels.K2F_KT, kernels.K2F_STAGES)
    tiles = tiles or [build]
    # the variants' builds run beside the package's
    vdir = kernels.BUILD_DIR / "k2f_variants"
    vdir.mkdir(parents=True, exist_ok=True)
    base = [f for f in kernels.NVCC_FLAGS if not f.startswith("-DJC_K2F_")]
    src = kernels.CSRC_DIR / "df_gather_w.cu"
    jobs = {}
    for t in tiles:
        flags = base + [f"-DJC_K2F_NQ={t[0]}", f"-DJC_K2F_KT={t[1]}",
                        f"-DJC_K2F_STAGES={t[2]}", f"-I{kernels.CSRC_DIR}"]
        so = vdir / f"k2f_{'_'.join(map(str, t))}_{os.getpid()}.so"
        jobs[t] = (so, compile_so(nvcc, src, so, flags))
    for tree in args.trees:
        tsrc = Path(tree) / "juliachem_jl_tpu_torch" / "csrc"
        key = Path(tree).name
        so = vdir / f"k2f_{key}_{os.getpid()}.so"
        flags = base + [f"-DJC_K2F_NQ={build[0]}", f"-DJC_K2F_KT={build[1]}",
                        f"-DJC_K2F_STAGES={build[2]}", f"-I{tsrc}"]
        jobs[key] = (so, compile_so(nvcc, tsrc / "df_gather_w.cu", so, flags))
    kernels.library()
    print(f"{tag} package build {kernels.build_info.get('seconds', 0.0):.1f}"
          " s", flush=True)
    libs, info = {}, {}
    for key, (so, p) in jobs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            print(log[-4000:], file=sys.stderr)
            raise RuntimeError(f"nvcc failed for {key}")
        lib = ctypes.CDLL(str(so))
        fn = lib.jc_df_gather_w_f32
        fn.restype = _I
        fn.argtypes = [_P, _LL, _P, _P, _P, _P, _I, _I, _I, _P, _P]
        libs[key] = fn
        regs = ptxas(log, smoke.K2_F32_KERNEL)
        tile = key if isinstance(key, tuple) else build
        info[str(key)] = {**smoke.k2_f32_tile(regs.get("registers"), tile),
                          **regs, "sass": sass_counts(smoke, cuobjdump, so,
                                                      smoke.K2_F32_KERNEL)}
        print(f"{tag} variant {key}: {info[str(key)]}", flush=True)
    names = [Path(t).name for t in args.trees]
    keys = names + [k for k in libs if k not in names]
    order = keys + keys[::-1]

    def call(key, B, cm, slabs, C):
        nbf, k = C.shape
        W = torch.empty((B.shape[0], k, nbf), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        rc = libs[key](B.data_ptr(), B.shape[1], cm.data_ptr(),
                       slabs[0].data_ptr(), slabs[1].data_ptr(),
                       C.data_ptr(), nbf, k, B.shape[0], W.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"{key}: CUDA error {rc}")
        return W

    goldens = json.loads((HERE / "tests" / "data" /
                          "s22x3_gamess_goldens.json").read_text())
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "variants": info, "systems": {}}
    bad = []
    for name in args.systems:
        if name == "benzene_2_water":
            sp = jc.io.parse_input(smoke.system_input(name, goldens[name]))
        else:
            sp = jc.io.parse_input(smoke.cluster_input(name))
        bsets = jc.basis.run(jc.molecule.run(sp), sp.model)
        opts = create_scf_options(sp.scf_keywords)
        k = bsets.primary.nels // 2
        qc = ScreenedDFFockBuilder.block_rows(
            bsets.primary.nbf, k, fitted_rows(bsets.auxiliary, opts), dev)
        blk = smoke.k2_block(dev, bsets, opts, k, qc)
        cm, slabs = blk["col_map"], blk["slabs"]
        B32, C32 = blk["Bc"].float(), blk["C"].float()
        f64_ms = smoke.cuda_ms(lambda: df_gather_w(blk["Bc"], cm, blk["C"],
                                                   slabs), args.reps)
        del blk["Bc"]
        torch.cuda.empty_cache()
        ref = df_gather_w_plain(B32, cm, C32)
        scale = float(ref.abs().max())
        plain_ms = smoke.cuda_ms(lambda: df_gather_w_plain(B32, cm, C32),
                                 args.reps)
        errs = {}
        for key in keys:
            W = call(key, B32, cm, slabs, C32)
            errs[str(key)] = float((W - ref).abs().max()) / scale
            del W
        del ref
        torch.cuda.empty_cache()
        times = {str(key): [] for key in keys}
        for key in order:
            times[str(key)].append(smoke.cuda_ms(
                lambda: call(key, B32, cm, slabs, C32),
                args.reps))
        bnd = smoke.k2_f32_bound({**blk, "Bc": B32})
        res = {"what": blk["what"], "shapes": blk["shapes"],
               "f64_instance_ms": f64_ms, "plain_ms": plain_ms,
               "rel_err": errs, "ms": times, **bnd}
        out["systems"][name] = res
        print(f"{tag} {name} {blk['what']}: bound {bnd['bound_ms']:.3f} ms "
              f"({bnd['bound_by']}), f64 instance {f64_ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms", flush=True)
        for key in keys:
            t = times[str(key)]
            # the FMAs the variant executes: every entry of its live slabs
            # for k padded to whole i-groups
            kt = info[str(key)]["KT"]
            done = (2 * qc * -(-k // kt) * kt * blk["live_slabs"]
                    * kernels.K2_SLAB_M * kernels.K2_TILE_N)
            res.setdefault("executed_tflop_s", {})[str(key)] = \
                done / (min(t) * 1e9)
            print(f"{tag} {name} {key}: " + ", ".join(f"{x:.3f}" for x in t)
                  + f" ms ({min(t) / f64_ms:.3f}x the f64 instance, "
                  f"{min(t) / bnd['bound_ms']:.2f}x the bound; "
                  f"{done / (min(t) * 1e9):.2f} TFLOP/s of executed FMAs); "
                  f"rel err {errs[str(key)]:.3e}", flush=True)
        bad += [(name, key) for key, e in errs.items() if e > 1e-5]
        del B32, C32, cm, slabs, blk
        torch.cuda.empty_cache()
    jc.finalize()
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1, default=str))
    if bad:
        print(f"{tag} off the plain version (1e-5): {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
