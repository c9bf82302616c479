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
The JAX package's mesh-sharded E2 (``make_sharded_e2``) is not ported
(ROADMAP.md A11): ``num_devices > 1`` raises.
"""

from __future__ import annotations

import torch

from ..ops import kernels
from ..utils.options import create_scf_options

_MODES = {"rmp2": 0, "ss": 1, "os": 2}


# ---------------------------------------------------------------- kernel K7


def _denominator(eo_i, eo_j, ev_a, ev_b):
    """[no_j, nv_a, nv_b] of e_i + e_j - e_a - e_b for one i."""
    return (eo_i + eo_j[:, None, None] - ev_a[None, :, None]
            - ev_b[None, None, :])


def e2_rmp2_plain(Bia, eo, ev) -> tuple[float, float]:
    """Plain version of K7, mode rmp2: (E2, E_os), the JAX ``_e2_kernel``
    scan and, in the same loop, its ``_e2_os_kernel`` with Bia on both
    sides."""
    total = total_os = Bia.new_zeros(())
    for i in range(Bia.shape[1]):
        iajb = torch.einsum("qa,qjb->jab", Bia[:, i, :], Bia)
        denom = _denominator(eo[i], eo, ev, ev)
        t = iajb / denom
        total = total + torch.sum(t * (2.0 * iajb - iajb.transpose(-1, -2)))
        total_os = total_os + torch.sum(iajb * iajb / denom)
    return float(total), float(total_os)


def e2_ss_plain(Bia, eo, ev) -> float:
    """Plain version of K7, mode ss (the JAX ``_e2_ss_kernel`` scan)."""
    total = Bia.new_zeros(())
    for i in range(Bia.shape[1]):
        iajb = torch.einsum("qa,qjb->jab", Bia[:, i, :], Bia)
        anti = iajb - iajb.transpose(-1, -2)
        total = total + 0.25 * torch.sum(anti * anti
                                          / _denominator(eo[i], eo, ev, ev))
    return float(total)


def e2_os_plain(Bia_a, Bia_b, eo_a, ev_a, eo_b, ev_b) -> float:
    """Plain version of K7, mode os (the JAX ``_e2_os_kernel`` scan)."""
    total = Bia_a.new_zeros(())
    for i in range(Bia_a.shape[1]):
        iajb = torch.einsum("qa,qjb->jab", Bia_a[:, i, :], Bia_b)
        total = total + torch.sum(iajb * iajb
                                  / _denominator(eo_a[i], eo_b, ev_a, ev_b))
    return float(total)


def _e2(mode: str, Bx, By, eox, evx, eoy, evy):
    """Kernel K7 in one mode: checks, the empty-channel exit (0.0, no
    launch), then the kernel on CUDA tensors or the plain version on CPU
    tensors.  Mode rmp2 gives (E2, E_os), the others one energy."""
    for B, eo, ev in ((Bx, eox, evx), (By, eoy, evy)):
        if B.dim() != 3 or eo.shape != (B.shape[1],) \
                or ev.shape != (B.shape[2],):
            raise ValueError("e2: B [A, no, nv] with eo [no] and ev [nv]")
    A, nox, nvx = Bx.shape
    _, noy, nvy = By.shape
    if By.shape[0] != A:
        raise ValueError("e2: both factors need the same fitted rows")
    if min(A, nox, nvx, noy, nvy) == 0:
        return (0.0, 0.0) if mode == "rmp2" else 0.0
    if not Bx.is_cuda:
        if mode == "os":
            return e2_os_plain(Bx, By, eox, evx, eoy, evy)
        plain = e2_rmp2_plain if mode == "rmp2" else e2_ss_plain
        return plain(Bx, eox, evx)
    for t in (Bx, By, eox, evx, eoy, evy):
        if t.dtype != torch.float64 or t.device != Bx.device \
                or not t.is_contiguous():
            raise ValueError("e2: contiguous float64 tensors on one device")
    if max(A, nox, nvx, noy, nvy) >= 2**31:
        raise ValueError("e2: dimensions must fit in int32")
    # the launch grid, and so the partial buffer, is csrc/mp2_e2.cu's
    n = kernels.library().jc_mp2_e2_partials(_MODES[mode], nox, nvx, noy,
                                              nvy)
    if n < 0:
        raise ValueError(f"e2: K7 mode {mode} does not take no {nox}/{noy}, "
                         f"nv {nvx}/{nvy} (grid over CUDA's limits)")
    partial = torch.empty(n, dtype=torch.float64, device=Bx.device)
    kernels.launch("jc_mp2_e2", _MODES[mode], Bx.data_ptr(), By.data_ptr(),
                   A, nox, nvx, noy, nvy, eox.data_ptr(), evx.data_ptr(),
                   eoy.data_ptr(), evy.data_ptr(), n, partial.data_ptr(),
                   count_as=f"e2_{mode}")
    if mode == "rmp2":
        e2, e_os = torch.sum(partial.view(2, -1), dim=1).tolist()
        return e2, e_os
    return float(torch.sum(partial))


def e2_rmp2(Bia, eo, ev) -> tuple[float, float]:
    """K7, mode rmp2: (E2, E_os) of one launch, E2 = sum (ia|jb) [2 (ia|jb)
    - (ib|ja)] / D and its opposite-spin part E_os = sum (ia|jb)^2 / D."""
    return _e2("rmp2", Bia, Bia, eo, ev, eo, ev)


def e2_ss(Bia, eo, ev) -> float:
    """K7, mode ss: 1/4 sum ((ia|jb) - (ib|ja))^2 / D (one spin)."""
    return _e2("ss", Bia, Bia, eo, ev, eo, ev)


def e2_os(Bia_a, Bia_b, eo_a, ev_a, eo_b, ev_b) -> float:
    """K7, mode os: sum (ia|jb)^2 / D, i a alpha, j b beta."""
    return _e2("os", Bia_a, Bia_b, eo_a, ev_a, eo_b, ev_b)


# ---------------------------------------------------------------- drivers


def _cart_mo(result, C):
    """MO coefficients over the Cartesian AO rows: the identity, since the
    port runs Cartesian AO bases only (a spherical one raises, ROADMAP.md
    A4)."""
    if result.get("Spherical Transform") is not None:
        raise NotImplementedError(
            "the spherical-harmonic AO basis is not ported yet (ROADMAP.md A4)")
    return C


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


def ri_mp2_energy(rhf_result, basis_sets, mol=None, B=None, opts=None,
                  scs: bool = False) -> dict:
    """RI-MP2 correlation energy from a converged RHF result (on the device
    of its orbitals), reusing B if given.  scs=True adds the spin-channel
    split and the SCS-MP2 energy (E_os comes from the same K7 launch as
    E2).  Without B,
    num_devices > 1 in opts asks for the JAX package's sharded path, which
    raises here."""
    n_dev = int(getattr(opts, "num_devices", 1) or 1) if opts is not None else 1
    if B is None and n_dev > 1:
        raise NotImplementedError(
            "the sharded RI-MP2 (num_devices > 1) is not ported yet "
            "(ROADMAP.md A11)")
    C = _cart_mo(rhf_result, rhf_result["MO Coeff"])
    eps = rhf_result["MO Energies"]
    B = _fitted_B(basis_sets, B, opts, C.device)
    nocc = int(basis_sets.primary.nels // 2)
    Bia = mo_b(B, C[:, :nocc], C[:, nocc:])
    del B
    eo, ev = eps[:nocc].contiguous(), eps[nocc:].contiguous()
    e2, e_os = e2_rmp2(Bia, eo, ev)
    e_hf = float(rhf_result["Energy"])
    out = {"E2": e2, "Energy": e_hf + e2, "E_HF": e_hf}
    if scs:
        # channel split: E_os = sum (ia|jb)^2 / D; E_ss = E2 - E_os
        e_ss = e2 - e_os
        out["E2 Opposite Spin"] = e_os
        out["E2 Same Spin"] = e_ss
        out["E2 SCS"] = 1.2 * e_os + e_ss / 3.0
    return out


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
