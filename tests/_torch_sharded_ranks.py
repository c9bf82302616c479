"""What each rank runs for tests/test_torch_sharded.py.

Every rank of a gloo group on the CPU runs ``run_stanzas`` once (through
``juliachem_jl_tpu_torch.parallel.launch.spawn``) and returns numpy results
to the parent, which holds them to the JAX package and to one device.  This
module imports torch and the port only (a rank never imports jax).
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _energy(r: dict) -> dict:
    nt = r["Timings"].non_timing_data
    return {"E": float(r["Energy"]), "converged": bool(r["Converged?"]),
            "iterations": int(r["Iterations"]),
            "builder": nt.get("fock_builder"),
            "num_devices": nt.get("num_devices")}


def run_stanzas(inp: dict) -> dict:
    """Every stanza of the test file on this rank (see the test file)."""
    import torch.distributed as dist

    import juliachem_jl_tpu_torch as tc
    from juliachem_jl_tpu_torch.models import mp2, rohf, uhf
    from juliachem_jl_tpu_torch.models.df_sharded import ShardedDFFockBuilder
    from juliachem_jl_tpu_torch.ops.fock_sharded import ShardedDirectFock
    from juliachem_jl_tpu_torch.ops.fock_stream import ShardedStreamingFock
    from juliachem_jl_tpu_torch.parallel import mesh as mesh_mod
    from juliachem_jl_tpu_torch.parallel.shard import (df_fock_step, scf_step,
                                                       shard_B)
    from juliachem_jl_tpu_torch.utils.options import create_scf_options
    from juliachem_jl_tpu_torch.utils.timings import Timings

    torch.set_num_threads(1)
    world, rank = dist.get_world_size(), dist.get_rank()
    cpu = torch.device("cpu")
    out: dict = {"rank": rank, "world": world}

    # DF-RHF through run_spec (f64 and mixed precision), with a checkpoint
    # written by every rank
    for key, spec in inp["run_spec"].items():
        r = tc.run_spec(tc.io.parse_input(spec), device=cpu)["Energy"]
        out[key] = _energy(r)
    ckpt = inp["checkpoint"]
    mine = mesh_mod.rank_path(ckpt)
    z = np.load(mine)
    out["checkpoint"] = {"path": mine, "rank_file_energy": float(
        z["energy_elec"]) + float(z["e_nuc"])}

    # packed sharded G at a fixed D (K2 sweep + one all_reduce), its f32
    # phase, the per-phase (profile_fock) form, and this rank's B rows
    out["packed"] = {}
    for name, (prim, aux, D, Cocc) in inp["packed"].items():
        D, Cocc = _t(D), _t(Cocc)
        opts = create_scf_options({"scf_type": "df", "num_devices": world})
        tm = Timings()
        b = ShardedDFFockBuilder(prim, aux, opts, timings=tm, device=cpu)
        r0, r1 = b.rows
        out["packed"][name] = {
            "G_factor": _np(b.two_electron_fock(D, 1, tm)),
            "G_occ": _np(b.two_electron_fock(D, 1, tm, C_occ=Cocc)),
            "G_f32": _np(b.two_electron_fock(D, 1, tm, C_occ=Cocc,
                                             precision="f32")),
            "f32_phase": b.supports_f32_phase,
            "rows": (r0, r1), "B_rows": _np(b.B[:r1 - r0]),
            "padded_rows": b.B.shape[0],
            "telemetry": dict(tm.non_timing_data),
        }
        prof = ShardedDFFockBuilder(prim, aux, create_scf_options(
            {"scf_type": "df", "num_devices": world, "profile_fock": True}),
            device=cpu)
        tp = Timings()
        out["packed"][name]["G_profile"] = _np(
            prof.two_electron_fock(D, 1, tp, C_occ=Cocc))
        out["packed"][name]["profile_keys"] = sorted(
            k.rsplit("-", 1)[0] for k in tp.timings)

    # the dense q x k step on a (world / 2) x 2 grid
    dq = inp["dense"]
    m2 = mesh_mod.make_mesh(world, 2, device=cpu)
    B_blk = shard_B(m2, _t(dq["B"]))
    nbf = dq["D"].shape[0]
    D_pad = torch.nn.functional.pad(_t(dq["D"]), (0, dq["B"].shape[2] - nbf))
    F, Dn, Co, eps, E = scf_step(m2, B_blk, _t(dq["H"]), _t(dq["X"]),
                                 _t(dq["D"]), _t(dq["Cocc"]), dq["B"].shape[2])
    out["dense"] = {"G": _np(df_fock_step(m2, B_blk, D_pad, _t(dq["Cocc"]),
                                          nbf)),
                    "F": _np(F), "E_elec": float(E), "grid": [m2.nq, m2.nk]}

    # conventional: the quartet-sharded direct build and the sharded
    # staircase build at a fixed D, and the direct route's SCF
    prim, D = inp["conventional"]["primary"], _t(inp["conventional"]["D"])
    sd = ShardedDirectFock(prim, n_devices=world, device=cpu)
    ss = ShardedStreamingFock(prim, n_devices=world, device=cpu)
    out["conventional"] = {"G_direct": _np(sd.two_electron_fock(D, 1, None)),
                           "G_stream": _np(ss.two_electron_fock(D, 1, None))}
    os.environ["JCHEM_CONV_STREAM"] = "0"
    spec = dict(inp["conventional"]["spec"])
    spec["keywords"] = {"scf": {**spec["keywords"]["scf"],
                                "num_devices": world}}
    r = tc.run_spec(tc.io.parse_input(spec), device=cpu)["Energy"]
    out["conventional"]["scf"] = _energy(r)

    # the singular-metric (pseudo-inverse) fold at the SAD density
    pv = inp["pinv"]
    b = ShardedDFFockBuilder(pv["primary"], pv["aux"], create_scf_options(
        {"scf_type": "df", "num_devices": world, "mixed_precision": False}),
        device=cpu)
    out["pinv"] = {"G": _np(b.two_electron_fock(_t(pv["D"]), 1, Timings(),
                                                C_occ=_t(pv["Cocc"])))}

    # sharded RI-MP2 on given orbitals
    mp = inp["mp2"]
    res = {k: _t(v) if isinstance(v, np.ndarray) else v
           for k, v in mp["result"].items()}
    e = mp2.ri_mp2_energy(res, mp["bsets"], opts=create_scf_options(
        {"num_devices": world}))
    out["mp2"] = {"E2": e["E2"], "keys": sorted(e)}

    # UHF and ROHF doublets
    oh = inp["open_shell"]
    kw = {**oh["flags"], "num_devices": world}
    out["uhf"] = _energy(uhf.energy(oh["mol"], oh["bsets"], kw, device=cpu))
    out["rohf"] = _energy(rohf.energy(oh["mol"], oh["bsets"], kw,
                                      device=cpu))

    # num_devices other than the group's size raises
    bad = dict(inp["run_spec"]["rhf"])
    bad["keywords"] = {"scf": {**bad["keywords"]["scf"],
                               "num_devices": world + 1}}
    try:
        tc.run_spec(tc.io.parse_input(bad), device=cpu)
        out["wrong_num_devices"] = None
    except ValueError as exc:
        out["wrong_num_devices"] = str(exc)
    return out


def fail_on_rank_one() -> None:
    """Rank 1 raises while rank 0 waits in a collective."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def card_packed_G(prim, aux, D, C) -> dict:
    """This rank's sharded packed G at a fixed D on its card (a test of
    tests/test_torch_cuda.py), with its B rows and launch counts."""
    import torch.distributed as dist

    from juliachem_jl_tpu_torch.models.df_sharded import ShardedDFFockBuilder
    from juliachem_jl_tpu_torch.ops import kernels
    from juliachem_jl_tpu_torch.utils.options import create_scf_options
    from juliachem_jl_tpu_torch.utils.timings import Timings

    kernels.reset_launches()
    b = ShardedDFFockBuilder(prim, aux, create_scf_options(
        {"scf_type": "df", "num_devices": dist.get_world_size()}))
    dev = b.mesh.device
    G = b.two_electron_fock(torch.as_tensor(D, device=dev), 1, Timings(),
                            C_occ=torch.as_tensor(C, device=dev))
    r0, r1 = b.rows
    return {"G": _np(G), "B": _np(b.B[:r1 - r0]), "rows": b.rows,
            "launches": dict(kernels.launches)}
