"""The design of K6 (csrc/eri4c.cuh, the digestion of cached in-core
blocks) on the CPU: the pieces the card runs that a plain version can
mirror.

- ``digest_plain`` (K6's plain version) against the JAX package's
  ``_make_digest_body`` on the same blocks, D and weights, for class pairs
  of both routes of ``kernels.digest_route`` ((sp|sp) lane; (pd|pd) and
  (dd|dd), 1296 integrals a block, warp; water in 6-311++G(2d,2p)),
  within 1e-12 x max(|J|, |K|).
- The in-core batches (``build_quartet_batches``) of water and of
  ammonia_trimer (its S22x3 basis, 5.83e6 quartets) are bra-row-major in
  ``sel_bra``: the runs the lane route sums j_ab over are its stretches of
  one bra row, and they are long.
- A plain walk of each route over every class pair of water in 6-31G*,
  each class pair on its route of ``kernels.digest_route``: the lane
  route's blocks a thread, 32 a warp, j_ab summed over the runs of one bra
  row in a warp and k_ac, k_bc over the runs of one bra row and one ket
  shell c (``run_sums``), each added once a run, k_ad and k_bd over every
  lane of a warp with one bra row and ket shell d (``group_sums``), added
  once a group, j_cd one add an element; the warp route one add an
  output.  Held to ``digest_plain`` within 1e-13 x max(|J|, |K|) (the
  sums differ only in their order).
- K6 takes K4/K5's route table: every class pair's route from
  ``kernels.eri4c_route`` is its bit in the build's ``-D`` mask;
  ``kernels.digest_route`` puts on the lane route the class pairs of that
  bit whose blocks hold at most ``DIGEST_LANE_MAX_N`` integrals; csrc/
  fixes each class pair's route at compile time from the same two
  (``DigestClass::kLane`` is ``Eri4cClass::kLane`` and the cut the build
  passes) and builds that route's kernel only.
"""

import itertools
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juliachem_jl_tpu_torch as jc
from juliachem_jl_tpu.ops.fock import _make_digest_body
from juliachem_jl_tpu_torch.basis.structs import ncart
from juliachem_jl_tpu_torch.ops import eri, fock, kernels
from juliachem_jl_tpu_torch.ops.segsum import reduce_into

WATER = {"symbols": ["O", "H", "H"],
         "geometry": [0.0, 0.0, 0.116321, 0.0, 0.751155, -0.465285,
                      0.0, -0.751155, -0.465285]}
CSRC = kernels.CSRC_DIR
BOHR = 0.52917724924


def _incore(basis, seed):
    mol = jc.molecule.from_input_dict(WATER)
    prim = jc.basis.build(mol, basis)
    fb = fock.ScreenedDirectFock(prim, incore=True, device="cpu")
    fb.fill_incore()
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(prim.nbf, prim.nbf))
    return prim, fb, torch.as_tensor(X + X.T).contiguous()


def _flat(off1, n1, off2, n2, nbf):
    u = off1[:, None] + np.arange(n1)[None, :]
    v = off2[:, None] + np.arange(n2)[None, :]
    return (u[:, :, None] * nbf + v[:, None, :]).reshape(len(off1), -1)


@pytest.mark.parametrize("cls,route", [((0, 1, 0, 1), "lane"),
                                       ((1, 2, 1, 2), "warp"),
                                       ((2, 2, 2, 2), "warp")])
def test_digest_plain_matches_the_jax_digest_body(cls, route):
    assert kernels.digest_route(*cls) == route
    prim, fb, D = _incore("6-311++G(2d,2p)", 2)
    nbf = prim.nbf
    (g,) = [g for g in fb.groups
            if (g.bra.la, g.bra.lb, g.ket.la, g.ket.lb) == cls]
    JK = torch.zeros((2, nbf, nbf), dtype=torch.float64)
    fock.digest_plain(JK, g.I, g.weight, D, g.bra, g.ket, g.sel_bra,
                      g.sel_ket)
    mb = g.bra.meta[g.sel_bra].long().numpy()
    mk = g.ket.meta[g.sel_ket].long().numpy()
    na, nb, nc, nd = (ncart(cls[0]), ncart(cls[1]), ncart(cls[2]),
                      ncart(cls[3]))
    oa, ob, oc, od = mb[:, 0], mb[:, 1], mk[:, 0], mk[:, 1]
    idx = [_flat(*a, nbf) for a in (
        ((oa, na, ob, nb)), ((oc, nc, od, nd)), ((oa, na, oc, nc)),
        ((oa, na, od, nd)), ((ob, nb, oc, nc)), ((ob, nb, od, nd)))]
    body = _make_digest_body(*cls, nbf)
    Jw, Kw = body(jnp.zeros(nbf * nbf), jnp.zeros(nbf * nbf),
                  jnp.asarray(g.I.numpy()), jnp.asarray(g.weight.numpy()),
                  jnp.asarray(D.numpy()), *map(jnp.asarray, idx))
    ref = np.stack([np.asarray(Jw), np.asarray(Kw)]).reshape(2, nbf, nbf)
    # more blocks than a warp's 32 on the lane route
    assert g.sel_bra.shape[0] > (32 if route == "lane" else 1)
    assert np.abs(JK.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


def _ammonia_trimer():
    golden = json.loads((kernels.PKG_DIR.parent / "tests" / "data" /
                         "s22x3_gamess_goldens.json").read_text())[
        "ammonia_trimer"]
    mol = jc.molecule.from_input_dict({
        "symbols": [a["symbol"] for a in golden["atoms"]],
        "geometry": [x * BOHR for a in golden["atoms"]
                     for x in a["xyz_bohr"]]})
    return jc.basis.build(mol, golden["basis"])


@pytest.mark.parametrize("system", ["water", "ammonia_trimer"])
def test_incore_batches_are_bra_row_major(system):
    prim = (_ammonia_trimer() if system == "ammonia_trimer" else
            jc.basis.build(jc.molecule.from_input_dict(WATER),
                           "6-311++G(2d,2p)"))
    batches, _ = fock.build_quartet_batches(prim, device="cpu")
    quartets = runs = 0
    for b in batches:
        r = np.asarray(b.sel_bra)
        assert np.all(np.diff(r) >= 0), (b.bra.la, b.bra.lb, b.ket.la,
                                         b.ket.lb)
        # within one row the kets ascend: (r, c) lexsorted, no repeats
        same = np.diff(r) == 0
        assert np.all(np.diff(np.asarray(b.sel_ket))[same] > 0)
        quartets += len(r)
        runs += 1 + int(np.count_nonzero(~same))
    # a run's mean length: 29 blocks in water, 338 in ammonia_trimer, whose
    # runs outlast a warp's 32 blocks
    if system == "ammonia_trimer":
        assert quartets == 5830708 and quartets / runs > 32
    else:
        assert quartets / runs > 16


def _outputs(g, D):
    """The six J/K value streams and targets of a batch's blocks, the
    columns of j_ab and of k_ac, k_bc (the sums over runs), and each
    block's keys: its bra row, and its bra row with its ket's first shell."""
    vals, targets = fock._digest_vals(g.I, g.weight, D, g.bra, g.ket,
                                      g.sel_bra, g.sel_ket)
    na, nb = ncart(g.bra.la), ncart(g.bra.lb)
    nc, nd = ncart(g.ket.la), ncart(g.ket.lb)
    kac = na * nb + nc * nd
    kbc = kac + na * nc + na * nd
    jab = np.arange(na * nb)
    kc = np.concatenate([np.arange(kac, kac + na * nc),
                         np.arange(kbc, kbc + nb * nc)])
    kd = np.concatenate([np.arange(kac + na * nc, kbc),
                         np.arange(kbc + nb * nc, vals.shape[1])])
    jcd = np.arange(na * nb, kac)
    r = g.sel_bra.numpy()
    oc = g.ket.meta[g.sel_ket, 0].long().numpy()
    od = g.ket.meta[g.sel_ket, 1].long().numpy()
    return (vals, targets, (jab, r), (kc, r * (1 << 24) + oc),
            (kd, r * (1 << 24) + od), jcd)


def _run_adds(JK, vals, targets, cols, key, starts, ends):
    """One add a run of equal key inside each [start, end) window; returns
    the number of runs."""
    adds = 0
    for a, b in zip(starts, ends):
        q = a
        while q < b:
            e = q + 1
            while e < b and key[e] == key[q]:
                e += 1
            reduce_into(JK.view(-1), targets[q, cols],
                        vals[q:e][:, cols].sum(0))
            adds += 1
            q = e
    return adds


def _lane_walk(JK, g, D):
    """The lane route: block q on lane q % 32 of warp q // 32; j_ab summed
    over each run of equal bra row in a warp, k_ac and k_bc over each run
    of equal bra row and ket shell c, one add a run (run_sums); k_ad and
    k_bd over all the lanes of a warp with one bra row and ket shell d,
    one add a group (group_sums); j_cd one add an element."""
    vals, targets, jab, kc, (kd, key_d), jcd = _outputs(g, D)
    reduce_into(JK.view(-1), targets[:, jcd], vals[:, jcd])
    n = vals.shape[0]
    starts = list(range(0, n, 32))
    ends = [min(s + 32, n) for s in starts]
    adds = sum(_run_adds(JK, vals, targets, cols, key, starts, ends)
               for cols, key in (jab, kc))
    for a, b in zip(starts, ends):
        for k in np.unique(key_d[a:b]):
            lanes = a + np.flatnonzero(key_d[a:b] == k)
            reduce_into(JK.view(-1), targets[lanes[0], kd],
                        vals[lanes][:, kd].sum(0))
            adds += 1
    return adds


def test_route_walks_sum_to_the_plain_digestion():
    prim, fb, D = _incore("6-31G*", 4)
    nbf = prim.nbf
    ref = torch.zeros((2, nbf, nbf), dtype=torch.float64)
    walk = torch.zeros_like(ref)
    seen = {"lane": set(), "warp": set()}
    lane_adds = lane_blocks = 0
    for g in fb.groups:
        cls = (g.bra.la, g.bra.lb, g.ket.la, g.ket.lb)
        fock.digest_plain(ref, g.I, g.weight, D, g.bra, g.ket, g.sel_bra,
                          g.sel_ket)
        route = kernels.digest_route(*cls)
        seen[route].add(cls)
        if route == "lane":
            lane_adds += _lane_walk(walk, g, D)
            lane_blocks += g.sel_bra.shape[0]
        else:   # the warp route: one add an output, digest_plain's
            fock.digest_plain(walk, g.I, g.weight, D, g.bra, g.ket,
                              g.sel_bra, g.sel_ket)
    scale = float(ref.abs().max())
    assert float((walk - ref).abs().max()) <= 1e-13 * scale
    # water in 6-31G*: the classes (ss) .. (dd), on both routes
    assert sum(len(v) for v in seen.values()) == 21
    assert len(seen["lane"]) == 8 and (2, 2, 2, 2) in seen["warp"]
    # one add a run or group in place of one a block, for j_ab, for k_ac,
    # k_bc and for k_ad, k_bd
    assert lane_adds < 1.5 * lane_blocks


def test_k6_takes_the_route_table_of_k4_k5():
    flags = kernels.route_flags()
    masks = [int(re.fullmatch(rf"-DJC_ERI4C_LANE_MASK_B{i}=(0x[0-9a-f]+)",
                              f).group(1), 16) for i, f in enumerate(flags)]
    pcs = eri.PAIR_CLASSES
    lanes = 0
    for i, j in itertools.combinations_with_replacement(range(len(pcs)), 2):
        cls = (*pcs[i], *pcs[j])
        built = kernels.eri4c_route(*cls) == "lane"
        assert ((masks[i] >> j) & 1) == built, cls
        nblk = 1
        for l in cls:
            nblk *= ncart(l)
        # K6's lane route: K4/K5's lane class pairs of small blocks; its
        # block route: the g class pairs of its table; its warp route: the
        # rest
        want = ("lane" if built and nblk <= kernels.DIGEST_LANE_MAX_N else
                "block" if cls in kernels.DIGEST_BLOCK else "warp")
        assert kernels.digest_route(*cls) == want, cls
        lanes += want == "lane"
    assert 0 < lanes < 120
    head = (CSRC / "eri4c.cuh").read_text()
    cls_src = head[head.index("struct DigestClass"):]
    assert re.search(r"using C = Eri4cClass<LA, LB, LC, LD>;", cls_src)
    # each class pair's route is digest_route's, fixed at compile time
    assert re.search(r"static constexpr bool kLane = C::kLane && N <= "
                     r"JC_DIGEST_LANE_MAX_N;", cls_src)
    assert f"-DJC_DIGEST_LANE_MAX_N={kernels.DIGEST_LANE_MAX_N}" in \
        kernels.NVCC_FLAGS
    launch = (CSRC / "eri4c_launch.cuh").read_text()
    pick = launch[launch.index("struct DigestLaunch {"):]
    pick = pick[:pick.index("\n};\n")]
    assert pick.index("if constexpr (G::kLane) return digest_jk_lane_kernel"
                      ) < pick.index("else return digest_jk_warp_kernel")
    body = launch[launch.index("int digest_jk_launch("):]
    body = body[:body.index("\n}\n")]
    assert "auto kern = L::kern();" in body and "lane" not in body.split(
        ")", 1)[0]
    # the wrapper passes no route: the launch takes the pointers and sizes
    assert len(kernels._FUNCS["jc_digest_jk"][1]) == 14
    # the rehearsal launches K6 the same way
    harness = (kernels.PKG_DIR.parent / "tools" / "eri4c_rehearsal" /
               "harness.cpp").read_text()
    h = harness[harness.index("int digest_jk("):]
    assert h.index("if constexpr (G::kLane)") < h.index(
        "digest_jk_lane_kernel") < h.index("digest_jk_warp_kernel")
