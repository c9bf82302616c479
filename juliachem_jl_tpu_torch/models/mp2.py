"""RI-MP2, SCS-MP2 and RI-UMP2 correlation energies on the fitted B tensor.

Port of ``juliachem_jl_tpu/models/mp2.py``:

    B_ia^Q = sum_{mu nu} C_mu i  B^Q_{mu nu}  C_nu a          (AO -> MO)
    (ia|jb) = sum_Q B_ia^Q B_jb^Q
    E2 = sum_{ijab} (ia|jb) [ 2 (ia|jb) - (ib|ja) ] / (e_i + e_j - e_a - e_b)

The AO -> MO transform is two library products (``mo_b``).  The pair sums
(the JAX package's per-i ``lax.scan``s, ``_e2_kernel``, ``_e2_ss_kernel``,
``_e2_os_kernel``) are kernel K7 (``csrc/mp2_e2.cu``) on the card: the
(ia|jb) product, the denominator and the reduction fused, so the
[no, nv, nv] block never reaches device memory.  CPU tensors take the plain
versions beside it, the same arithmetic in the same order as the JAX scans.
With ``num_devices: n`` (RHF reference) the RI-MP2 runs over the n ranks of
a process group (``ri_mp2_energy_sharded``, the JAX package's
``make_sharded_e2``): each rank forms B_ia from its own Q rows of the
sharded packed B, one all_gather assembles B_ia, K7 sums a disjoint
occupied range of i on each rank, and one scalar all_reduce adds them.
"""

from __future__ import annotations

import math

import torch

from ..ops import kernels
from ..utils.options import create_scf_options

_MODES = {"rmp2": 0, "ss": 1, "os": 2}


# ---------------------------------------------------------------- kernel K7


def _denominator(eo_i, eo_j, ev_a, ev_b):
    """[no_j, nv_a, nv_b] of e_i + e_j - e_a - e_b for one i."""
    return (eo_i + eo_j[:, None, None] - ev_a[None, :, None]
            - ev_b[None, None, :])


def _pair_weights(i: int, like) -> torch.Tensor:
    """[i + 1] weights of the pairs (j <= i) of one i: 2 below the diagonal
    ((i, j) and (j, i) give the same energy), 1 on it."""
    w = torch.full((i + 1,), 2.0, dtype=like.dtype, device=like.device)
    w[i] = 1.0
    return w[:, None, None]


def e2_rmp2_plain(Bia, eo, ev, i_range=None) -> tuple[float, float]:
    """Plain version of K7, mode rmp2: (E2, E_os), the JAX ``_e2_kernel``
    scan and, in the same loop, its ``_e2_os_kernel`` with Bia on both
    sides.  With ``i_range`` (i0, i1), the kernel's sum over that range:
    the pairs j <= i of each i in it, weighted as K7 weighs them."""
    total = total_os = Bia.new_zeros(())
    if i_range is None:
        for i in range(Bia.shape[1]):
            iajb = torch.einsum("qa,qjb->jab", Bia[:, i, :], Bia)
            denom = _denominator(eo[i], eo, ev, ev)
            t = iajb / denom
            total = total + torch.sum(t * (2.0 * iajb
                                           - iajb.transpose(-1, -2)))
            total_os = total_os + torch.sum(iajb * iajb / denom)
        return float(total), float(total_os)
    for i in range(*i_range):
        iajb = torch.einsum("qa,qjb->jab", Bia[:, i, :], Bia[:, :i + 1])
        denom = _denominator(eo[i], eo[:i + 1], ev, ev)
        w = _pair_weights(i, Bia)
        total = total + torch.sum(w * iajb / denom
                                  * (2.0 * iajb - iajb.transpose(-1, -2)))
        total_os = total_os + torch.sum(w * iajb * iajb / denom)
    return float(total), float(total_os)


def e2_ss_plain(Bia, eo, ev, i_range=None) -> float:
    """Plain version of K7, mode ss (the JAX ``_e2_ss_kernel`` scan; with
    ``i_range``, the pairs j <= i of each i in it, as for rmp2)."""
    total = Bia.new_zeros(())
    if i_range is None:
        for i in range(Bia.shape[1]):
            iajb = torch.einsum("qa,qjb->jab", Bia[:, i, :], Bia)
            anti = iajb - iajb.transpose(-1, -2)
            total = total + 0.25 * torch.sum(
                anti * anti / _denominator(eo[i], eo, ev, ev))
        return float(total)
    for i in range(*i_range):
        iajb = torch.einsum("qa,qjb->jab", Bia[:, i, :], Bia[:, :i + 1])
        anti = iajb - iajb.transpose(-1, -2)
        total = total + 0.25 * torch.sum(
            _pair_weights(i, Bia) * anti * anti
            / _denominator(eo[i], eo[:i + 1], ev, ev))
    return float(total)


def e2_os_plain(Bia_a, Bia_b, eo_a, ev_a, eo_b, ev_b, i_range=None) -> float:
    """Plain version of K7, mode os (the JAX ``_e2_os_kernel`` scan, over the
    alpha occupied range ``i_range`` when given)."""
    total = Bia_a.new_zeros(())
    for i in range(*(i_range or (0, Bia_a.shape[1]))):
        iajb = torch.einsum("qa,qjb->jab", Bia_a[:, i, :], Bia_b)
        total = total + torch.sum(iajb * iajb
                                  / _denominator(eo_a[i], eo_b, ev_a, ev_b))
    return float(total)


def _e2(mode: str, Bx, By, eox, evx, eoy, evy, i_range=None):
    """Kernel K7 in one mode over the occupied range ``i_range`` (i0, i1)
    of Bx's orbitals (default: all of them): checks, the exit for an empty
    channel or range (0.0, no launch), then the kernel on CUDA tensors or
    the plain version on CPU tensors.  Mode rmp2 gives (E2, E_os), the
    others one energy."""
    for B, eo, ev in ((Bx, eox, evx), (By, eoy, evy)):
        if B.dim() != 3 or eo.shape != (B.shape[1],) \
                or ev.shape != (B.shape[2],):
            raise ValueError("e2: B [A, no, nv] with eo [no] and ev [nv]")
    A, nox, nvx = Bx.shape
    _, noy, nvy = By.shape
    if By.shape[0] != A:
        raise ValueError("e2: both factors need the same fitted rows")
    i0, i1 = (0, nox) if i_range is None else map(int, i_range)
    if not 0 <= i0 <= i1 <= nox:
        raise ValueError(f"e2: occupied range [{i0}, {i1}) outside [0, {nox})")
    if min(A, nox, nvx, noy, nvy) == 0 or i0 == i1:
        return (0.0, 0.0) if mode == "rmp2" else 0.0
    if not Bx.is_cuda:
        if mode == "os":
            return e2_os_plain(Bx, By, eox, evx, eoy, evy, i_range)
        plain = e2_rmp2_plain if mode == "rmp2" else e2_ss_plain
        return plain(Bx, eox, evx, i_range)
    for t in (Bx, By, eox, evx, eoy, evy):
        if t.dtype != torch.float64 or t.device != Bx.device \
                or not t.is_contiguous():
            raise ValueError("e2: contiguous float64 tensors on one device")
    if max(A, nox, nvx, noy, nvy) >= 2**31:
        raise ValueError("e2: dimensions must fit in int32")
    # the launch grid, and so the partial buffer, is csrc/mp2_e2.cu's
    n = kernels.library().jc_mp2_e2_partials(_MODES[mode], nox, nvx, noy,
                                              nvy, i0, i1)
    if n < 0:
        raise ValueError(f"e2: K7 mode {mode} does not take no {nox}/{noy}, "
                         f"nv {nvx}/{nvy} (grid over CUDA's limits)")
    partial = torch.empty(n, dtype=torch.float64, device=Bx.device)
    kernels.launch("jc_mp2_e2", _MODES[mode], Bx.data_ptr(), By.data_ptr(),
                   A, nox, nvx, noy, nvy, i0, i1, eox.data_ptr(),
                   evx.data_ptr(),
                   eoy.data_ptr(), evy.data_ptr(), n, partial.data_ptr(),
                   count_as=f"e2_{mode}")
    if mode == "rmp2":
        e2, e_os = torch.sum(partial.view(2, -1), dim=1).tolist()
        return e2, e_os
    return float(torch.sum(partial))


def e2_rmp2(Bia, eo, ev, i_range=None) -> tuple[float, float]:
    """K7, mode rmp2: (E2, E_os) of one launch, E2 = sum (ia|jb) [2 (ia|jb)
    - (ib|ja)] / D and its opposite-spin part E_os = sum (ia|jb)^2 / D;
    with ``i_range`` (i0, i1), the part of the pairs j <= i with i in it."""
    return _e2("rmp2", Bia, Bia, eo, ev, eo, ev, i_range)


def e2_ss(Bia, eo, ev, i_range=None) -> float:
    """K7, mode ss: 1/4 sum ((ia|jb) - (ib|ja))^2 / D (one spin)."""
    return _e2("ss", Bia, Bia, eo, ev, eo, ev, i_range)


def e2_os(Bia_a, Bia_b, eo_a, ev_a, eo_b, ev_b, i_range=None) -> float:
    """K7, mode os: sum (ia|jb)^2 / D, i a alpha, j b beta."""
    return _e2("os", Bia_a, Bia_b, eo_a, ev_a, eo_b, ev_b, i_range)


def occupied_ranges(nocc: int, n: int) -> list[tuple[int, int]]:
    """n contiguous ranges [i0, i1) covering [0, nocc) whose pair counts
    (the j <= i pairs K7 sums for rmp2 and ss) are about equal: range k ends
    where i (i + 1) / 2 reaches k / n of all the pairs."""
    total = nocc * (nocc + 1) / 2
    bounds = [0]
    for k in range(1, n):
        i = int(round((math.sqrt(1.0 + 8.0 * total * k / n) - 1.0) / 2.0))
        bounds.append(min(max(i, bounds[-1]), nocc))
    bounds.append(nocc)
    return [(bounds[k], bounds[k + 1]) for k in range(n)]


# ---------------------------------------------------------------- drivers


def _cart_mo(result, C):
    """MO coefficients over the Cartesian AO rows: spherical-harmonic runs
    store C over the 2l+1 spherical AOs, while B is built from the
    Cartesian kernels; C_cart = T C_sph spans the identical MO space, so
    E2 is exact."""
    T = result.get("Spherical Transform")
    return C if T is None else T @ C


def mo_b(B, Cocc, Cvirt) -> torch.Tensor:
    """B_ia^Q [A, nocc, nvirt], contiguous (two library products; the JAX
    package's ``_mo_b``)."""
    t = torch.einsum("qmn,mi->qin", B, Cocc)
    return torch.einsum("qin,na->qia", t, Cvirt).contiguous()


def _fitted_B(basis_sets, B, opts, device) -> torch.Tensor:
    """The dense fitted B [A, nbf, nbf] on ``device``: the one given, else
    built as the JAX package builds it (``df.build_B``)."""
    from .df import build_B

    if B is not None:
        return torch.as_tensor(B, dtype=torch.float64, device=device)
    if basis_sets.auxiliary is None:
        raise ValueError("RI-MP2 requires an auxiliary basis")
    return build_B(basis_sets.primary, basis_sets.auxiliary,
                   opts if opts is not None else create_scf_options({}),
                   device)


def _mp2_result(e_hf: float, e2: float, e_os: float, scs: bool) -> dict:
    out = {"E2": e2, "Energy": e_hf + e2, "E_HF": e_hf}
    if scs:
        # channel split: E_os = sum (ia|jb)^2 / D; E_ss = E2 - E_os
        e_ss = e2 - e_os
        out["E2 Opposite Spin"] = e_os
        out["E2 Same Spin"] = e_ss
        out["E2 SCS"] = 1.2 * e_os + e_ss / 3.0
    return out


def sharded_e2(mesh, B_own, col_map, Cocc, Cvirt, eo, ev):
    """(E2, E_os) over the ranks (``make_sharded_e2``): this rank's Q rows
    of packed B (zero padding rows included) expanded through col_map and
    transformed to B_ia (library products, as ``mo_b``), one all_gather of
    B_ia over the ranks, K7 (mode rmp2) over this rank's occupied range
    (``occupied_ranges``: the j <= i pairs split about evenly), and one
    all_reduce of the two energies."""
    nbf = Cocc.shape[0]
    step = max(1, int(2.5e8 / (8 * nbf * nbf)))   # rows of one dense tile
    parts = [mo_b(B_own[q:q + step].index_select(1, col_map).reshape(
        -1, nbf, nbf), Cocc, Cvirt) for q in range(0, B_own.shape[0], step)]
    Bia = mesh.all_gather(torch.cat(parts))
    del parts
    i_range = occupied_ranges(Cocc.shape[1], mesh.world)[mesh.rank]
    e = torch.tensor(e2_rmp2(Bia, eo, ev, i_range), dtype=torch.float64,
                     device=Bia.device)
    e, = mesh.all_reduce_cat(e)
    return float(e[0]), float(e[1])


def ri_mp2_energy_sharded(rhf_result, basis_sets, n_devices: int, opts=None,
                          scs: bool = False) -> dict:
    """RI-MP2 over the n_devices ranks of the process group (the JAX
    package's ``ri_mp2_energy_sharded``): packed B built with each rank's
    own Q rows (parallel/build.py), E2 by ``sharded_e2``.  Returns the JAX
    package's keys (E2, Energy, E_HF), plus the SCS split when asked for
    (E_os comes from the same K7 launches)."""
    from ..parallel.build import build_B_packed_sharded
    from ..parallel.mesh import make_mesh

    if basis_sets.auxiliary is None:
        raise ValueError("RI-MP2 requires an auxiliary basis")
    C = _cart_mo(rhf_result, rhf_result["MO Coeff"])
    mesh = make_mesh(n_devices, device=C.device)
    opts = opts if opts is not None else create_scf_options({})
    B_own, screen, *_ = build_B_packed_sharded(
        basis_sets.primary, basis_sets.auxiliary, mesh, opts)
    nocc = int(basis_sets.primary.nels // 2)
    eps = rhf_result["MO Energies"]
    col_map = torch.as_tensor(screen.col_map, device=B_own.device)
    e2, e_os = sharded_e2(mesh, B_own, col_map, C[:, :nocc], C[:, nocc:],
                          eps[:nocc].contiguous(), eps[nocc:].contiguous())
    return _mp2_result(float(rhf_result["Energy"]), e2, e_os, scs)


def ri_mp2_energy(rhf_result, basis_sets, mol=None, B=None, opts=None,
                  scs: bool = False) -> dict:
    """RI-MP2 correlation energy from a converged RHF result (on the device
    of its orbitals), reusing B if given.  scs=True adds the spin-channel
    split and the SCS-MP2 energy (E_os comes from the same K7 launch as
    E2).  Without B, num_devices > 1 in opts routes to the sharded path
    (``ri_mp2_energy_sharded``) over a process group of that many ranks."""
    n_dev = int(getattr(opts, "num_devices", 1) or 1) if opts is not None else 1
    if B is None and n_dev > 1:
        return ri_mp2_energy_sharded(rhf_result, basis_sets, n_dev, opts, scs)
    C = _cart_mo(rhf_result, rhf_result["MO Coeff"])
    eps = rhf_result["MO Energies"]
    B = _fitted_B(basis_sets, B, opts, C.device)
    nocc = int(basis_sets.primary.nels // 2)
    Bia = mo_b(B, C[:, :nocc], C[:, nocc:])
    del B
    eo, ev = eps[:nocc].contiguous(), eps[nocc:].contiguous()
    e2, e_os = e2_rmp2(Bia, eo, ev)
    return _mp2_result(float(rhf_result["Energy"]), e2, e_os, scs)


def ri_ump2_energy(uhf_result, basis_sets, B=None, opts=None) -> dict:
    """RI-UMP2 correlation energy from a converged UHF (or ROHF: Ca = Cb =
    ``MO Coeff``) result: E2 = E_aa + E_bb (K7 mode ss) + E_ab (mode os),
    with the channel split and the Grimme SCS energy."""
    na = int(uhf_result["N Alpha"])
    nb = int(uhf_result["N Beta"])
    Ca = uhf_result.get("MO Coeff Alpha", uhf_result["MO Coeff"])
    Cb = uhf_result.get("MO Coeff Beta", Ca)
    Ca, Cb = _cart_mo(uhf_result, Ca), _cart_mo(uhf_result, Cb)
    ea = uhf_result.get("MO Energies Alpha", uhf_result["MO Energies"])
    eb = uhf_result.get("MO Energies Beta", ea)
    B = _fitted_B(basis_sets, B, opts, Ca.device)
    Bia_a = mo_b(B, Ca[:, :na], Ca[:, na:])
    Bia_b = mo_b(B, Cb[:, :nb], Cb[:, nb:])
    del B
    eo_a, ev_a = ea[:na].contiguous(), ea[na:].contiguous()
    eo_b, ev_b = eb[:nb].contiguous(), eb[nb:].contiguous()
    e_aa = e2_ss(Bia_a, eo_a, ev_a)
    e_bb = e2_ss(Bia_b, eo_b, ev_b)
    e_ab = e2_os(Bia_a, Bia_b, eo_a, ev_a, eo_b, ev_b)
    e2 = e_aa + e_bb + e_ab
    e_ss = e_aa + e_bb
    e_hf = float(uhf_result["Energy"])
    return {
        "E2": e2,
        "E2 Same Spin": e_ss,
        "E2 Opposite Spin": e_ab,
        "E2 SCS": 1.2 * e_ab + e_ss / 3.0,   # Grimme spin-component scaling
        "Energy": e_hf + e2,
        "E_HF": e_hf,
    }
