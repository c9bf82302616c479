"""The PyTorch port's CUDA kernels against their plain torch versions, on
the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  This file imports neither jax nor the JAX package, so it also runs on
a machine that has only torch:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Bounds: K1 and K4 1e-12 x the output's max-abs, K2 1e-12 relative in f64
(col_maps with whole dead tiles too) and 1e-5 in f32 (the FP32 FMA
instance, counted apart), K3 (both instances)
1e-14 relative; K4 and K5 on each route (lane, warp) in every mode, at
quartet counts and t0 that are not multiples of 32; K5 (list and staircase modes) and K6:
J and K within 1e-11 x max(|J|, |K|) of the plain versions (f64 atomics sum
in no fixed order), K6 on its route (lane or warp) for every class pair,
from blocks that are not 16-byte aligned and over batches whose bra runs
cross warps; K7 (the MP2 pair energy, modes rmp2, ss, os) within
1e-12 x max(1, |E|) of its plain version, the same bits from two
launches, and its occupied-range split
(like K5's t0 split) summing to the whole-range launch; K8 (the split fold) within
4 sqrt(K) 2^-24 (|Mh| + |Ml|) |X| of its plain version and of the f64
product, at shapes ragged in R, K and C, M lower triangular or full, and
at w8's fold chunk; K1's f32 store and K2's f32-B instance bit for bit equal to the f64
output rounded and to the f64 instance on the upcast block; the DF-RHF,
conventional RHF and UHF/ROHF energies on the card within 1e-9 Eh of the
same runs on the CPU, RI-UMP2 on the card's orbitals within 1e-10 Eh; two
gloo ranks sharing the card give the sharded packed G of one device; a
host-streamed B (both stream modes, forced by the budget) gives the
resident builder's B, G and J, K(Da), K(Db).  The
f classes (pair classes to (ff), 34 class pairs with an f shell) are held
the same way on two waters in 6-31G(2df,p), and (ff|ff) on one C atom in
6-311++G(3df,3pd); the class pairs that run in ket tiles hold two warps an
SM.  The g classes (pair classes to (gg), 65 class pairs with a g shell,
K1's bras (sg) .. (gg)) are held the same way on two waters in
6-311++G(3df,3pd)+G (tests/data/6-311ppG_3df_3pd_G.gbs), and (gg|gg) on one
O atom; a class above g (l = 5) raises.  K9 (S, T and V) at each group
size on every class of 8 waters in 6-31+G*, two waters in
6-311++G(3df,3pd) and two in the g basis, into NaN-filled matrices, within
1e-12 x each matrix's max-abs of the plain version; the card's
``overlap_kinetic_nuclear`` launches K9 once a class and no chunk of the
plain path; (hh) raises.  K10 (the one-electron gradient) at each group
size on every class of 8 waters in 6-31+G* and one in the g basis, and
K11 (the DF gradient's 3-center and metric terms) on every class of one
water in 6-31+G* and in the g basis with cc-pVTZ-JKFIT and of water 6-31G
with the contracted 6-31G aux set, each class within 1e-10 x max |g| of
its plain version on the card (f64 atomics sum in no fixed order); the
card's DF-RHF gradient runs K10 and K11, none of the plain versions, and
lands within 1e-10 of the CPU's; a class above g raises.
"""

import pathlib

import numpy as np
import pytest
import torch

import juliachem_jl_tpu_torch as jc
from juliachem_jl_tpu_torch.models import df_screened
from juliachem_jl_tpu_torch.ops import (boys, eri, eri3c, fock, fock_stream,
                                        kernels)
from juliachem_jl_tpu_torch.ops.pairs import unique_pair_blocks

CPU = torch.device("cpu")
WATER = {"symbols": ["O", "H", "H"],
         "geometry": [0.0, 0.0, 0.116321, 0.0, 0.751155, -0.465285,
                      0.0, -0.751155, -0.465285]}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _water(prim="6-31+G*", aux="cc-pVTZ-JKFIT"):
    mol = jc.molecule.from_input_dict(WATER)
    return jc.basis.build(mol, prim), jc.basis.build_auxiliary(mol, aux, prim)


@pytest.mark.cuda
def test_k3_boys_probe(cuda_device):
    T = torch.linspace(0, 60, 20001, dtype=torch.float64, device=cuda_device)
    n0 = kernels.launches["boys_probe"]
    for m in range(9):
        ref = boys.boys(T, m)
        got = boys.boys_probe(T, m)
        assert float(((got - ref).abs() / ref.abs()).max()) <= 1e-14
    assert kernels.launches["boys_probe"] == n0 + 9


@pytest.mark.cuda
def test_k3_boys_probe_recip(cuda_device):
    """K3's second instance, the divide-free form K4/K5 inline, against
    the plain (dividing) version within 1e-14 relative."""
    T = torch.linspace(0, 60, 20001, dtype=torch.float64, device=cuda_device)
    n0 = kernels.launches["boys_probe_recip"]
    for m in (0, 4, 8, 12, 16):
        ref = boys.boys(T, m)
        got = boys.boys_probe(T, m, recip=True)
        assert float(((got - ref).abs() / ref.abs()).max()) <= 1e-14
    assert kernels.launches["boys_probe_recip"] == n0 + 5


@pytest.mark.cuda
@pytest.mark.parametrize("aux_name", ["cc-pVTZ-JKFIT", "6-31G"],
                         ids=["jkfit", "contracted-aux"])
@pytest.mark.parametrize("what", ["metric", "three_center"])
def test_k1_eri3c(cuda_device, what, aux_name):
    """Every class of K1 (d primary shells, g aux shells); 6-31G as the
    auxiliary set gives contracted aux shells (Kq > 1)."""
    prim, aux = _water(aux=aux_name)
    if what == "metric":
        def f(d):
            return eri3c.two_center_metric(aux, d)
    else:
        def f(d):
            return eri3c.three_center_tensor(prim, aux, d)
    n0 = kernels.launches["eri3c"]
    got = f(cuda_device).cpu()
    assert kernels.launches["eri3c"] > n0
    ref = f(CPU)
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.cuda
def test_k1_raises_for_a_class_it_lacks(cuda_device):
    """(hh|s) is not instantiated (K1 stops at g shells, l = 4): the
    wrapper raises instead of launching."""
    def zeros(*shape, dtype=torch.float64):
        return torch.zeros(shape, dtype=dtype, device=cuda_device)

    n, nab = 1, 441
    bra = eri.PairTable(la=5, lb=5, Ka=1, Kb=1, pair=zeros(n, 10),
                        meta=zeros(n, 5, dtype=torch.int32))
    aux = eri3c.AuxTable(lq=0, Kq=1, table=zeros(1, 5),
                         kq=zeros(1, dtype=torch.int32),
                         qrow=zeros(1, dtype=torch.int64), ecd=zeros(1, 1, 1, 1))
    with pytest.raises(NotImplementedError):
        eri3c.eri3c_class(zeros(4, 4), bra, aux,
                          zeros(n, nab, dtype=torch.int64),
                          zeros(n, nab, dtype=torch.int64),
                          zeros(n, dtype=torch.uint8))


def _k1_classes(prim, aux, dev):
    """(K1Pairs, AuxTable) of every (pair class | aux class) of the dense
    3-center tensor and every (unit bra | aux class) of the metric, with
    each output's width."""
    nbf = prim.nbf
    auxs = eri3c.aux_tables(aux, dev)
    out = []
    for blocks, col_of, width in (
            (unique_pair_blocks(prim), lambda ia, ib: ia * nbf + ib,
             nbf * nbf),
            (eri3c.aux_unit_blocks(aux), lambda ia, ib: ib, aux.nbf)):
        for blk in blocks:
            kp = eri3c.k1_pairs(blk, col_of, dev)
            out += [(kp, at, width) for at in auxs]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("prim_aux", [("6-31+G*", "cc-pVTZ-JKFIT"),
                                      ("6-31+G*", "6-31+G*")],
                         ids=["jkfit", "contracted-aux"])
def test_k1_each_class_on_its_route_matches_plain(cuda_device, prim_aux):
    """Every class of water's 3-center tensor and metric (d pairs, aux to
    g; the (ss) class mixes O 1s of 6 primitives with H s of 3 and 1, the
    contracted aux set Kq up to 6), one launch each on the route of the
    table as compiled: f64 within 1e-12 x the class's max-abs of the plain
    version (1e-15 for a class zero by symmetry), the mirror store into
    cols_t, the f32 store bit for bit the f64 output rounded."""
    prim, aux = _water(*prim_aux)
    A = aux.nbf
    for kp, at, width in _k1_classes(prim, aux, cuda_device):
        bra = kp.table
        cls = (bra.la, bra.lb, at.lq)
        geo = eri3c.eri3c_geometry(*cls, bra.Ka, bra.Kb, at.Kq)
        assert geo["route"] == kernels.eri3c_route(*cls), cls
        args = (bra, at, kp.cols, kp.cols_t, kp.mirror)
        kernels.reset_launches()
        got = torch.zeros((A, width), dtype=torch.float64, device=cuda_device)
        eri3c.eri3c_class(got, *args)
        got32 = torch.zeros((A, width), dtype=torch.float32,
                            device=cuda_device)
        eri3c.eri3c_class(got32, *args)
        assert kernels.class_launches == {"eri3c": {cls: 1},
                                          "eri3c_f32": {cls: 1}}
        ref = torch.zeros((A, width), dtype=torch.float64)
        eri3c.eri3c_class_plain(
            ref, eri.PairTable(bra.la, bra.lb, bra.Ka, bra.Kb, bra.pair.cpu(),
                               bra.meta.cpu()),
            eri3c.AuxTable(at.lq, at.Kq, at.table.cpu(), at.kq.cpu(),
                           at.qrow.cpu(), at.ecd.cpu()),
            kp.cols.cpu(), kp.cols_t.cpu(), kp.mirror.cpu())
        scale = max(float(ref.abs().max()), 1e-3)
        assert float((got.cpu() - ref).abs().max()) <= 1e-12 * scale, cls
        assert torch.equal(got32, got.float()), cls


def _largest_contractions() -> dict:
    """The most primitives a shell of each angular momentum has in any
    basis of the library (an sp shell counts for s and p)."""
    from juliachem_jl_tpu_torch.basis import library

    ls = {"S": (0,), "P": (1,), "D": (2,), "F": (3,), "G": (4,),
          "L": (0, 1)}
    out = {}
    for name, elements in library._library().items():
        if name == "__meta__":
            continue
        for shells in elements.values():
            for sh in shells:
                for lv in ls[sh["l"]]:
                    out[lv] = max(out.get(lv, 1), len(sh["exps"]))
    return out


@pytest.mark.cuda
def test_k1_routes_of_all_classes_match_the_table(cuda_device):
    """K1's 55 classes as compiled (``eri3c_geometry``) take the route and
    body of the tables of ops/kernels.py; every block-route class, at one
    primitive a shell and at the largest contractions of the basis library
    (s 8, p 3: (pp) 9 primitive pairs), takes an aux tile of 8, 4, 2 or 1
    shells, within its body's cap (``kEri3cBlockCap``, 100 KB; the T1
    body's ``kEri3cT1Cap``, 110 KB) unless it is one shell, no wider than
    at one primitive, fits a block's 227 KB ((ff|g) among them), and holds
    two blocks of 4 warps an SM (the thread body) or one of 8 (the T1
    body) where its tile is wider than one shell."""
    kmax = _largest_contractions()
    for cls in sorted(eri3c.KERNEL_CLASSES):
        la, lb, lq = cls
        geo = eri3c.eri3c_geometry(*cls, 1, 1, 1)
        assert geo["route"] == kernels.eri3c_route(*cls), cls
        assert geo["body"] == kernels.eri3c_body(*cls), cls
        assert geo["blocks_per_sm"] >= 1, cls
        if geo["route"] == "lane":
            assert geo["QT"] == 1 and geo["smem_bytes"] == 0
            continue
        t1 = geo["body"] == "t1"
        cap = (110 if t1 else 100) * 1024
        # the metric's unit bra (0, lP) is one primitive pair
        Ka, Kb = (1, 1) if (la, lb) == (0, 4) else (kmax[la], kmax[lb])
        for g in (geo, eri3c.eri3c_geometry(*cls, Ka, Kb, kmax[lq])):
            assert g["route"] == geo["route"] and g["QT"] <= geo["QT"], cls
            assert g["QT"] in (1, 2, 4, 8), cls
            assert g["smem_bytes"] <= cap or g["QT"] == 1, cls
            assert g["smem_bytes"] <= 232448, cls
            assert g["threads"] == (256 if t1 else 128), cls
            assert g["blocks_per_sm"] >= (2 if g["QT"] > 1 and not t1
                                          else 1), cls


def _k2_inputs(case, seed, dev):
    """(Bc [qc, npq+1] f64 with a zero trash column, col_map int32, C
    [nbf, k], K2's slab list of col_map) of a K2 case (nbf, k, kind, qc): a
    random col_map (few trash entries), or a banded one as an atom-ordered
    screen leaves it: whole dead 16 x 64 tiles, nbf not a multiple of 16 or
    64."""
    nbf, k, kind, qc = case
    rng = np.random.default_rng(seed)
    if kind == "random":
        npq = 4000
        col_map = rng.integers(0, npq + 1, nbf * nbf)
    else:
        atom = np.repeat(np.arange(nbf), rng.integers(5, 30, nbf))[:nbf]
        live = np.abs(atom[:, None] - atom[None, :]) <= 1
        flat = np.flatnonzero(live)
        npq = len(flat)
        col_map = np.full(nbf * nbf, npq)
        col_map[flat] = np.arange(npq)
    Bc = rng.normal(size=(qc, npq + 1))
    Bc[:, -1] = 0.0
    C = rng.normal(size=(nbf, k))
    slabs = tuple(torch.tensor(a, device=dev)
                  for a in df_screened.k2_slabs(col_map, nbf, npq))
    return (torch.tensor(Bc, device=dev),
            torch.tensor(col_map.astype(np.int32), device=dev),
            torch.tensor(C, device=dev), slabs)


# (nbf, k, col_map kind, rows of B): k 47 of benzene_2_water, k over one
# i-tile, an odd row count (the last block of rows holds one), w64's nbf
# and k
K2_CASES = {"random-137": (137, 21, "random", 300),
            "dead-137": (137, 47, "banded", 300),
            "dead-517": (517, 47, "banded", 300),
            "dead-517-k130": (517, 130, "banded", 300),
            "dead-517-q301": (517, 47, "banded", 301),
            "dead-1472-k320": (1472, 320, "banded", 130)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K2_CASES))
@pytest.mark.parametrize("dtype,bound", [(torch.float64, 1e-12),
                                         (torch.float32, 1e-5)])
def test_k2_df_gather_w(cuda_device, dtype, bound, case):
    """K2 in f64 (the DMMA body) and f32 (the FP32 FMA body, counted as
    ``df_gather_w_f32``, which never reads the trash column: NaN there)
    against its plain version, relative to the output's max-abs; dead
    tiles of col_map skipped by the slab list."""
    Bc, col_map, C, slabs = _k2_inputs(K2_CASES[case], 5, cuda_device)
    Bc, C = Bc.to(dtype), C.to(dtype)
    name = "df_gather_w" if dtype == torch.float64 else "df_gather_w_f32"
    Bk = Bc
    if dtype == torch.float32:
        Bk = Bc.clone()
        Bk[:, -1] = float("nan")
    n0 = dict(kernels.launches)
    got = df_screened.df_gather_w(Bk, col_map, C, slabs)
    assert {k: v - n0[k] for k, v in kernels.launches.items()
            if v != n0[k]} == {name: 1}
    ref = df_screened.df_gather_w_plain(Bc, col_map, C)
    assert float((got - ref).abs().max() / ref.abs().max()) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k2_wrapper_raises_without_slabs(cuda_device, dtype):
    """Every instance on the card walks the slab list: a call without it,
    or with a list of another n-tiling, raises before any launch."""
    Bc, col_map, C, slabs = _k2_inputs(K2_CASES["dead-137"], 5, cuda_device)
    Bc, C = Bc.to(dtype), C.to(dtype)
    n0 = dict(kernels.launches)
    with pytest.raises(ValueError):
        df_screened.df_gather_w(Bc, col_map, C, None)
    with pytest.raises(ValueError):
        df_screened.df_gather_w(Bc, col_map, C, (slabs[0][:-1], slabs[1]))
    assert kernels.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dense", "screened"])
def test_dfrhf_on_card_matches_cpu(cuda_device, mode):
    spec = jc.io.parse_input({
        "molecule": WATER,
        "model": {"method": "RHF", "basis": "6-31+G*",
                  "auxiliary_basis": "cc-pVTZ-JKFIT"},
        "keywords": {"scf": {"scf_type": "df", "niter": 60, "dele": 1e-10,
                             "rmsd": 1e-8, "guess": "sad",
                             "contraction_mode": mode}}})
    e_card = jc.run_spec(spec, device=cuda_device)["Energy"]
    e_cpu = jc.run_spec(spec, device=CPU)["Energy"]
    assert e_card["Converged?"] and e_cpu["Converged?"]
    assert e_card["Density"].is_cuda
    assert abs(e_card["Energy"] - e_cpu["Energy"]) <= 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["stream_b32", "stream"])
def test_streamed_sweep_on_card_equals_resident(cuda_device, mode,
                                                monkeypatch):
    """A B over a forced budget is built in column chunks (K1 on the card
    into each range) into page-locked host memory, equal to the resident B
    within 1e-13 x max|B|; its sweeps copy each Q-block into one of two
    device buffers on the side stream while K2 runs on the other: G (f64
    orbitals, the f32 phase, the signed factor) and J, K(Da), K(Db) equal
    the resident builder's within 1e-12 relative, K2 launched on every
    block, the copies and waits recorded by ``KPassSplit``."""
    from juliachem_jl_tpu_torch.models.df_screened_jk import (
        ScreenedDFJKBuilder)
    from juliachem_jl_tpu_torch.utils.options import create_scf_options
    from juliachem_jl_tpu_torch.utils.timings import Timings

    prim, aux = _water()
    opts = create_scf_options({"scf_type": "df", "df_exchange_n_blocks": 3})
    res = ScreenedDFJKBuilder.build(prim, aux, opts, cuda_device)
    rows, width = res.B.shape
    b32, buffers = rows * width * 4, 2 * res.q_chunk * width * 8
    budget = b32 + buffers if mode == "stream_b32" else b32 + buffers - 1
    monkeypatch.setattr(ScreenedDFJKBuilder, "budgets",
                        classmethod(lambda cls, dev: (budget, 1e9)))
    monkeypatch.setattr(df_screened, "stream_build_cols",
                        lambda rows, dtype, dev: 100)
    st = ScreenedDFJKBuilder.build(prim, aux, opts, cuda_device)
    assert st.mode == {"stream_b32": df_screened.STREAM_B32,
                       "stream": df_screened.STREAM}[mode]
    assert not st.B.is_cuda and st.B.is_pinned()
    assert (st.B32 is None) == (mode == "stream")
    ref = res.B.cpu()
    assert float((st.B - ref).abs().max()) <= 1e-13 * float(ref.abs().max())
    rng = np.random.default_rng(5)
    C = torch.tensor(rng.normal(size=(prim.nbf, 5)), device=cuda_device)
    D = 2.0 * C @ C.T
    split = df_screened.KPassSplit()
    for kw in ({"C_occ": C}, {"C_occ": C, "precision": "f32"}, {}):
        g0 = res.two_electron_fock(D, 1, Timings(), **kw)
        k2 = "df_gather_w_f32" if "precision" in kw else "df_gather_w"
        n0 = kernels.launches[k2]
        st.split = split
        g1 = st.two_electron_fock(D, 1, Timings(), **kw)
        st.split = None
        assert kernels.launches[k2] - n0 == 3
        assert float((g1 - g0).abs().max()) <= 1e-12 * float(g0.abs().max())
    streamed = [ph for dt, ph in split.sweeps
                if dt == "float64" or mode == "stream"]
    assert streamed and all(len(ph["H2D"]) == 3 and len(ph["wait"]) == 3
                            for ph in streamed)
    Ca, Cb = C, C[:, :3].contiguous()
    args = (Ca @ Ca.T, Cb @ Cb.T, 1, Timings(), Ca, Cb)
    for g, r in zip(st.two_electron_jk(*args), res.two_electron_jk(*args)):
        assert float((g - r).abs().max()) <= 1e-12 * float(r.abs().max())


def test_k2_wrapper_checks_its_inputs():
    """Runs everywhere: a mistyped call raises before any launch."""
    Bc = torch.zeros((2, 5), dtype=torch.float64)
    C = torch.zeros((2, 1), dtype=torch.float32)
    with pytest.raises(ValueError):
        df_screened.df_gather_w(Bc, torch.zeros(4, dtype=torch.int32), C,
                                None)
    with pytest.raises(ValueError):
        df_screened.df_gather_w(Bc, torch.zeros(4, dtype=torch.int64),
                                C.double(), None)


@pytest.mark.cuda
def test_k4_eri4c_every_class(cuda_device):
    """Every (bra | ket) class of water 6-31+G* (s, p, d), all quartets,
    within 1e-12 x the largest integral (a class of one-center quartets
    whose angular momenta sum to an odd number is zero by parity, so its
    own max is rounding noise)."""
    prim, _ = _water()
    blocks = unique_pair_blocks(prim)
    n0 = kernels.launches["eri4c"]
    pairs = []
    for i, bra in enumerate(blocks):
        for ket in blocks[i:]:
            sb, sk = np.meshgrid(np.arange(bra.n), np.arange(ket.n),
                                 indexing="ij")
            got = eri.eri_block(bra, ket, sb.ravel(), sk.ravel(),
                                cuda_device).cpu()
            ref = eri.eri_block(bra, ket, sb.ravel(), sk.ravel(), CPU)
            pairs.append(((bra.la, bra.lb, ket.la, ket.lb), got, ref))
    assert kernels.launches["eri4c"] - n0 == len(pairs)
    scale = max(float(ref.abs().max()) for _, _, ref in pairs)
    for cls, got, ref in pairs:
        assert float((got - ref).abs().max()) <= 1e-12 * scale, cls


@pytest.mark.cuda
def test_k4_raises_for_a_class_it_lacks(cuda_device):
    """(ss|hh) is not instantiated (the 4-center kernels stop at g shells,
    l = 4): the wrapper raises instead of launching."""
    def table(l, n=1):
        return eri.PairTable(
            la=l, lb=l, Ka=1, Kb=1,
            pair=torch.ones((n, 10), dtype=torch.float64, device=cuda_device),
            meta=torch.ones((n, 5), dtype=torch.int32, device=cuda_device))

    sel = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    with pytest.raises(NotImplementedError):
        eri.eri4c_class(table(0), table(5), sel, sel)


@pytest.mark.cuda
@pytest.mark.parametrize("builder,kernel", [
    ("incore", "digest_jk"), ("direct", "eri4c_jk_list"),
    ("streaming", "eri4c_jk_stair")])
def test_k5_k6_jk_match_plain(cuda_device, builder, kernel):
    """J, K at a fixed symmetric D through K6 (in-core), K5 list mode
    (direct) and K5 staircase mode (streaming) against the plain versions."""
    prim, _ = _water("6-311++G(2d,2p)")
    rng = np.random.default_rng(3)
    X = rng.normal(size=(prim.nbf, prim.nbf))
    D = torch.as_tensor(X + X.T)

    def make(dev):
        if builder == "streaming":
            return fock_stream.StreamingDirectFock(prim, device=dev)
        return fock.ScreenedDirectFock(prim, incore=builder == "incore",
                                       device=dev)

    n0 = kernels.launches[kernel]
    Jg, Kg = (x.cpu() for x in make(cuda_device).jk_halves(D.to(cuda_device)))
    assert kernels.launches[kernel] > n0
    Jr, Kr = make(CPU).jk_halves(D)
    scale = max(float(Jr.abs().max()), float(Kr.abs().max()))
    assert float((Jg - Jr).abs().max()) <= 1e-11 * scale
    assert float((Kg - Kr).abs().max()) <= 1e-11 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("guess", ["sad", "df"])
def test_conventional_rhf_on_card_matches_cpu(cuda_device, guess):
    spec = jc.io.parse_input({
        "molecule": WATER,
        "model": {"method": "RHF", "basis": "6-31+G*",
                  "auxiliary_basis": "cc-pVTZ-JKFIT"},
        "keywords": {"scf": {"scf_type": "rhf", "niter": 60, "dele": 1e-10,
                             "rmsd": 1e-8, "guess": guess,
                             "mixed_precision": False}}})
    e_card = jc.run_spec(spec, device=cuda_device)["Energy"]
    e_cpu = jc.run_spec(spec, device=CPU)["Energy"]
    assert e_card["Converged?"] and e_cpu["Converged?"]
    assert e_card["Timings"].non_timing_data["fock_builder"] == \
        "ScreenedDirectFock"
    assert e_card["Density"].is_cuda
    assert abs(e_card["Energy"] - e_cpu["Energy"]) <= 1e-9


# (A, no_x, nv_x, no_y, nv_y): one occupied orbital, virtual counts off
# K7's 64-wide tile, A off its 16-row Q-chunk
E2_SHAPES = {"one-occupied": (37, 1, 5, 1, 5), "ragged": (203, 7, 70, 6, 131),
             "tiles": (100, 5, 129, 4, 128)}


def _e2_inputs(shape, seed, dev, dtype=torch.float64):
    A, nox, nvx, noy, nvy = shape
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((A, nox, nvx)) * 0.1,
              rng.standard_normal((A, noy, nvy)) * 0.1,
              *(np.sort(rng.uniform(lo, hi, n)) for lo, hi, n in (
                  (-20.0, -0.3, nox), (0.1, 30.0, nvx), (-20.0, -0.3, noy),
                  (0.1, 30.0, nvy)))]
    return [torch.tensor(a, device=dev, dtype=dtype) for a in arrays]


def _e2(mode, Bx, By, eox, evx, eoy, evy):
    from juliachem_jl_tpu_torch.models import mp2

    if mode == "os":
        return mp2.e2_os(Bx, By, eox, evx, eoy, evy)
    return (mp2.e2_rmp2 if mode == "rmp2" else mp2.e2_ss)(Bx, eox, evx)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(E2_SHAPES))
@pytest.mark.parametrize("mode", ["rmp2", "ss", "os"])
def test_k7_e2_matches_plain(cuda_device, mode, shape):
    """K7 in each mode against its plain version on the same numbers, within
    1e-12 x max(1, |E|) (the sums run in another order); one launch each.
    Mode rmp2 gives E2 and its opposite-spin part from that one launch."""
    args = _e2_inputs(E2_SHAPES[shape], 17, cuda_device)
    n0 = kernels.launches[f"e2_{mode}"]
    got = np.atleast_1d(_e2(mode, *args))
    assert kernels.launches[f"e2_{mode}"] == n0 + 1
    ref = np.atleast_1d(_e2(mode, *(a.cpu() for a in args)))
    assert got.shape == ref.shape == ((2,) if mode == "rmp2" else (1,))
    assert np.all(np.abs(got - ref) <= 1e-12 * np.maximum(1.0, np.abs(ref)))


@pytest.mark.cuda
def test_k7_partial_buffer_follows_the_launch_grid(cuda_device):
    """jc_mp2_e2_partials, the only copy of K7's grid: the j <= i pairs and
    tile pairs of modes rmp2 (two energies per block) and ss; for os, the
    128 x 64 tiles of its flattened (i a) x (j b) product; over an
    occupied range of i; -1 for shapes K7 does not take."""
    lib = kernels.library()

    def n(mode, nox, nvx, noy, nvy, i0=0, i1=None):
        return lib.jc_mp2_e2_partials(mode, nox, nvx, noy, nvy, i0,
                                      nox if i1 is None else i1)

    assert n(0, 31, 486, 31, 486) == 2 * 496 * 36
    assert n(1, 30, 487, 30, 487) == 465 * 36
    # os: 128 x 64 tiles of the flattened (i a) x (j b) product
    assert n(2, 31, 486, 30, 487) == 118 * 229
    assert n(2, 1, 64, 1, 65) == 2
    assert n(1, 30, 487, 29, 487) == -1      # ss needs one spin's factor
    assert n(1, 30, 64 * 65536, 30, 64 * 65536) == -1  # over the y limit
    assert n(2, 1, 2**30, 1, 2**30) == -1    # over the grid's x limit
    assert n(2, 2, 2**30, 1, 64) == -1       # (i a) over int32
    assert n(2, 0, 64, 1, 64) == -1          # empty channel: no launch
    # an occupied range [i0, i1): the j <= i pairs of its i (rmp2, ss),
    # its rows of (i a) (os); an empty or outside range: no launch
    assert n(0, 31, 486, 31, 486, 10, 20) == 2 * (210 - 55) * 36
    assert n(2, 31, 486, 30, 487, 5, 7) == 8 * 229
    assert n(2, 31, 486, 30, 487, 5, 5) == -1
    assert n(1, 30, 487, 30, 487, 0, 31) == -1


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["rmp2", "ss", "os"])
def test_k7_two_launches_agree_bit_for_bit(cuda_device, mode):
    """K7 is deterministic: one partial per block, summed by torch.sum, no
    atomics, so two launches on the same inputs give the same bits."""
    args = _e2_inputs(E2_SHAPES["ragged"], 29, cuda_device)
    first = np.atleast_1d(_e2(mode, *args))
    assert np.array_equal(first, np.atleast_1d(_e2(mode, *args)))


@pytest.mark.cuda
def test_k7_empty_channel_returns_zero_without_a_launch(cuda_device):
    """A one-electron doublet's beta channel (no_y = 0) is empty: 0.0, and
    the kernel is not launched (a grid of 0 blocks is an invalid launch)."""
    args = _e2_inputs((40, 1, 8, 0, 9), 5, cuda_device)
    n0 = dict(kernels.launches)
    assert _e2("os", *args) == 0.0
    assert _e2("ss", args[1], args[1], args[4], args[5], args[4],
               args[5]) == 0.0
    assert kernels.launches == n0


@pytest.mark.cuda
def test_k7_wrapper_raises_on_f32_and_strided_input(cuda_device):
    args = _e2_inputs(E2_SHAPES["ragged"], 2, cuda_device)
    with pytest.raises(ValueError):
        _e2("os", args[0].float(), *args[1:])
    with pytest.raises(ValueError):
        _e2("rmp2", args[0].transpose(1, 2).contiguous().transpose(1, 2),
            *args[1:])
    with pytest.raises(ValueError):
        _e2("os", args[0], args[1][:, :, ::2], args[2], args[3], args[4],
            args[5][::2])


OH = {"symbols": ["O", "H"], "geometry": [0.0, 0.0, 0.0, 0.0, 0.0, 0.97],
      "molecular_multiplicity": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("method,scf_type,kernel", [
    ("UHF", "rhf", "digest_jk"), ("ROHF", "rhf", "digest_jk"),
    ("UHF", "df", "eri3c")])
def test_open_shell_on_card_matches_cpu(cuda_device, method, scf_type, kernel):
    """UHF/ROHF of the OH radical through run_spec on the card and on the
    CPU: energies within 1e-9 Eh; then RI-UMP2 on the card's orbitals
    through K7 (modes ss and os) within 1e-10 Eh of the same on the CPU."""
    from juliachem_jl_tpu_torch.models import mp2

    spec = jc.io.parse_input({
        "molecule": OH,
        "model": {"method": method, "basis": "6-31G*",
                  "auxiliary_basis": "cc-pVTZ-JKFIT"},
        "keywords": {"scf": {"scf_type": scf_type, "niter": 80,
                             "dele": 1e-10, "rmsd": 1e-8, "guess": "sad"}}})
    n0 = kernels.launches[kernel]
    out = jc.run_spec(spec, device=cuda_device)
    assert kernels.launches[kernel] > n0
    e_cpu = jc.run_spec(spec, device=CPU)["Energy"]
    e_card = out["Energy"]
    assert e_card["Converged?"] and e_cpu["Converged?"]
    assert e_card["Density"].is_cuda
    assert abs(e_card["Energy"] - e_cpu["Energy"]) <= 1e-9
    launches = (kernels.launches["e2_ss"], kernels.launches["e2_os"])
    m_card = mp2.ri_ump2_energy(e_card, out["Basis"])
    assert (kernels.launches["e2_ss"], kernels.launches["e2_os"]) == (
        launches[0] + 2, launches[1] + 1)
    cpu = {k: v.cpu() if isinstance(v, torch.Tensor) else v
           for k, v in e_card.items()}
    m_cpu = mp2.ri_ump2_energy(cpu, out["Basis"])
    assert abs(m_card["E2"] - m_cpu["E2"]) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("R,K,C", [(200, 200, 300), (333, 333, 1000),
                                   (64, 64, 64)])
def test_k8_split_fold_matches_plain(cuda_device, R, K, C):
    """K8 within 4 sqrt(K) 2^-24 (|Mh| + |Ml|) |X| of its plain version and
    of the f64 product, elementwise; X a strided column chunk of B."""
    from juliachem_jl_tpu_torch.models import linalg

    rng = np.random.default_rng(R + C)
    M = np.tril(rng.standard_normal((R, K))) * np.logspace(0, 3, K)[None, :]
    Bfull = rng.standard_normal((K, C + 17)).astype(np.float32)
    Mh = torch.tensor(M, device=cuda_device).float()
    Ml = (torch.tensor(M, device=cuda_device) - Mh.double()).float()
    X = torch.tensor(Bfull, device=cuda_device)[:, 5:5 + C]
    n0 = kernels.launches["split_fold"]
    got = linalg.split_fold(Mh, Ml, X)
    assert kernels.launches["split_fold"] == n0 + 1
    ref = linalg.split_fold_plain(Mh, Ml, X)
    bound = 4 * K**0.5 * 2.0**-24 * ((Mh.abs() + Ml.abs()).double()
                                     @ X.abs().double())
    assert bool(((got - ref).double().abs() <= bound).all())
    exact = (Mh.double() + Ml.double()) @ X.double()
    assert bool(((got.double() - exact).abs() <= bound).all())
    # a lower-triangular M: the slabs K8 skips add only zeros
    got_lower = linalg.split_fold(Mh, Ml, X, lower=True)
    assert kernels.launches["split_fold"] == n0 + 2
    assert torch.equal(got_lower, got)


@pytest.mark.cuda
def test_k1_f32_store_is_the_f64_output_rounded(cuda_device):
    """K1's f32 instances round the f64 result once: bit for bit."""
    prim, aux = _water()
    n0 = kernels.launches["eri3c_f32"]
    got = eri3c.three_center_tensor(prim, aux, cuda_device,
                                    out_dtype=torch.float32)
    assert kernels.launches["eri3c_f32"] > n0
    ref = eri3c.three_center_tensor(prim, aux, cuda_device)
    assert got.dtype == torch.float32
    assert torch.equal(got, ref.float())


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K2_CASES))
def test_k2_f32b_equals_f64_on_the_upcast_block(cuda_device, case):
    Bc, col_map, C, slabs = _k2_inputs(K2_CASES[case], 9, cuda_device)
    Bc = Bc.float()
    n0 = kernels.launches["df_gather_w_f32b"]
    got = df_screened.df_gather_w(Bc, col_map, C, slabs)
    assert kernels.launches["df_gather_w_f32b"] == n0 + 1
    assert got.dtype == torch.float64
    assert torch.equal(got, df_screened.df_gather_w(Bc.double(), col_map, C,
                                                    slabs))


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 3])
def test_k5_t0_split_matches_whole_and_plain(cuda_device, parts):
    """K5 in staircase mode over ``parts`` contiguous t0 ranges of every
    class pair: the sum of the ranges within 1e-13 x max |JK| of the
    whole-range launch (f64 atomics sum in no fixed order), and within
    1e-11 x max |JK| of the plain version over the same ranges."""
    from juliachem_jl_tpu_torch.ops.fock_sharded import share

    prim, _ = _water()
    sdf = fock_stream.StreamingDirectFock(prim, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    X = torch.randn((prim.nbf, prim.nbf), dtype=torch.float64,
                    device=cuda_device, generator=g)
    D = (X + X.T).contiguous()
    whole, split, plain = (torch.zeros((2, prim.nbf, prim.nbf),
                                       dtype=torch.float64,
                                       device=cuda_device) for _ in range(3))
    n0 = kernels.launches["eri4c_jk_stair"]
    launched = 0
    for cp in sdf.pairs:
        bra, ket = sdf.blocks[cp.bi].table, sdf.blocks[cp.ki].table
        fock_stream.eri4c_jk_staircase(whole, bra, ket, cp.cum, cp.N,
                                       cp.same, D)
        launched += 1
        for k in range(parts):
            s = share(cp.N, parts, k)
            if s.stop == s.start:
                continue
            fock_stream.eri4c_jk_staircase(split, bra, ket, cp.cum,
                                           s.stop - s.start, cp.same, D,
                                           t0=s.start)
            fock_stream.eri4c_jk_staircase_plain(plain, bra, ket, cp.cum,
                                                 s.stop - s.start, cp.same,
                                                 D, t0=s.start)
            launched += 1
    assert kernels.launches["eri4c_jk_stair"] == n0 + launched
    scale = float(whole.abs().max())
    assert float((split - whole).abs().max()) <= 1e-13 * scale
    assert float((split - plain).abs().max()) <= 1e-11 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["rmp2", "ss", "os"])
def test_k7_range_split_matches_whole_and_plain(cuda_device, mode):
    """K7 over the occupied ranges of ``occupied_ranges(no, 3)``: their sum
    within 1e-14 Eh of the whole-range launch, and each range within
    1e-12 x max(1, |E|) of the plain version over it."""
    from juliachem_jl_tpu_torch.models import mp2

    args = _e2_inputs(E2_SHAPES["ragged"], 23, cuda_device)
    Bx, By, eox, evx, eoy, evy = args
    if mode != "os":
        By, eoy, evy = Bx, eox, evx
    kern = {"rmp2": lambda r: mp2.e2_rmp2(Bx, eox, evx, r),
            "ss": lambda r: mp2.e2_ss(Bx, eox, evx, r),
            "os": lambda r: mp2.e2_os(Bx, By, eox, evx, eoy, evy, r)}[mode]
    cpu = [a.cpu() for a in (Bx, By, eox, evx, eoy, evy)]
    plain = {"rmp2": lambda r: mp2.e2_rmp2_plain(cpu[0], cpu[2], cpu[3], r),
             "ss": lambda r: mp2.e2_ss_plain(cpu[0], cpu[2], cpu[3], r),
             "os": lambda r: mp2.e2_os_plain(*cpu, r)}[mode]
    whole = np.atleast_1d(kern(None))
    total = 0.0
    for r in mp2.occupied_ranges(Bx.shape[1], 3):
        got = np.atleast_1d(kern(r))
        ref = np.atleast_1d(plain(r))
        assert np.all(np.abs(got - ref) <= 1e-12 * np.maximum(1.0,
                                                               np.abs(ref)))
        total = total + got
    assert np.all(np.abs(total - whole) <= 1e-14)


@pytest.mark.cuda
def test_sharded_packed_G_gloo_on_card(cuda_device, monkeypatch):
    """Two gloo ranks sharing card 0 (JCHEM_DIST_BACKEND=gloo): the
    sharded packed G at a fixed D within 1e-11 of one device on the card,
    each rank's B rows within 1e-12 x max |B| of the single-device B's, and
    K1 and K2 launched on every rank."""
    from juliachem_jl_tpu_torch.parallel.launch import spawn
    from juliachem_jl_tpu_torch.utils.options import create_scf_options
    from juliachem_jl_tpu_torch.utils.timings import Timings

    # the ranks import it by name: from this directory, which spawn puts
    # on their path (another installed package may own the name "tests")
    monkeypatch.syspath_prepend(str(pathlib.Path(__file__).resolve().parent))
    import _torch_sharded_ranks as ranks

    prim, aux = _water()
    C = 0.3 * np.random.default_rng(5).standard_normal((prim.nbf, 5))
    D = 2.0 * C @ C.T
    opts = create_scf_options({"scf_type": "df"})
    B1, screen = df_screened.build_B_packed(prim, aux, opts, cuda_device)
    one = df_screened.ScreenedDFFockBuilder(B1, screen, opts, 5)
    G1 = one.two_electron_fock(
        torch.as_tensor(D, device=cuda_device), 1, Timings(),
        C_occ=torch.as_tensor(C, device=cuda_device)).cpu().numpy()
    B1 = B1.cpu().numpy()
    res = spawn(ranks.card_packed_G, 2, args=(prim, aux, D, C),
                backend="gloo", device="cuda:0", timeout=300.0)
    for r in res:
        r0, r1 = r["rows"]
        assert np.abs(r["G"] - G1).max() <= 1e-11
        assert np.abs(r["B"] - B1[r0:r1]).max() <= 1e-12 * np.abs(B1).max()
        assert r["launches"].get("eri3c", 0) > 0
        assert r["launches"].get("df_gather_w", 0) > 0


# --- the f classes (ROADMAP.md B17): the first 2 waters of the generated
# w32 cluster in 6-31G(2df,p), f shells on two centres

F_BASIS = "6-31G(2df,p)"


def _two_waters_f(aux="cc-pVTZ-JKFIT"):
    import json

    c = json.loads((pathlib.Path(jc.__file__).resolve().parent / "data" /
                    "water_clusters.json").read_text())["w32"]
    mol = jc.molecule.from_input_dict({"symbols": c["symbols"][:6],
                                       "geometry": c["geometry"][:18]})
    return (jc.basis.build(mol, F_BASIS),
            jc.basis.build_auxiliary(mol, aux, F_BASIS))


@pytest.mark.cuda
def test_k4_eri4c_f_classes(cuda_device):
    """Every class pair with an f shell (34), all its quartets, within
    1e-12 x the largest integral, and each class launched."""
    prim, _ = _two_waters_f()
    blocks = unique_pair_blocks(prim)
    kernels.reset_launches()
    pairs = []
    for i, bra in enumerate(blocks):
        for ket in blocks[i:]:
            if 3 not in (bra.la, bra.lb, ket.la, ket.lb):
                continue
            sb, sk = np.meshgrid(np.arange(bra.n), np.arange(ket.n),
                                 indexing="ij")
            got = eri.eri_block(bra, ket, sb.ravel(), sk.ravel(),
                                cuda_device).cpu()
            ref = eri.eri_block(bra, ket, sb.ravel(), sk.ravel(), CPU)
            pairs.append(((bra.la, bra.lb, ket.la, ket.lb), got, ref))
    assert len(pairs) == 34
    assert set(kernels.class_launches["eri4c"]) == {c for c, _, _ in pairs}
    scale = max(float(ref.abs().max()) for _, _, ref in pairs)
    for cls, got, ref in pairs:
        assert float((got - ref).abs().max()) <= 1e-12 * scale, cls


@pytest.mark.cuda
def test_k4_ff_ff_of_a_carbon_atom(cuda_device):
    """The SAD case: the full ERI tensor of one C atom in 6-311++G(3df,3pd)
    ((ff|ff) and every other class of one centre, 214 KiB of shared memory
    a warp at (ff|ff)) within 1e-12 x its max-abs of the CPU's."""
    mol = jc.molecule.from_input_dict({"symbols": ["C"],
                                       "geometry": [0.0, 0.0, 0.0]})
    prim = jc.basis.build(mol, "6-311++G(3df,3pd)")
    kernels.reset_launches()
    got = eri.full_eri_tensor(prim, cuda_device).cpu()
    assert kernels.class_launches["eri4c"].get((3, 3, 3, 3), 0) == 1
    ref = eri.full_eri_tensor(prim, CPU)
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k1_eri3c_f_classes(cuda_device, dtype):
    """The 3-center tensor of the f basis (primary pairs to (ff), aux to g)
    against the CPU's: f64 within 1e-12 x its max-abs; the f32 store bit
    for bit the f64 output rounded."""
    prim, aux = _two_waters_f()
    kernels.reset_launches()
    got = eri3c.three_center_tensor(prim, aux, cuda_device,
                                    out_dtype=dtype).cpu()
    launched = set(kernels.class_launches["eri3c" if dtype == torch.float64
                                          else "eri3c_f32"])
    assert {(1, 3, 4), (2, 3, 4), (3, 3, 4), (3, 3, 0)} <= launched
    if dtype == torch.float64:
        ref = eri3c.three_center_tensor(prim, aux, CPU)
        assert float((got - ref).abs().max()) <= \
            1e-12 * float(ref.abs().max())
    else:
        ref = eri3c.three_center_tensor(prim, aux, cuda_device).cpu()
        assert torch.equal(got, ref.float())


@pytest.mark.cuda
@pytest.mark.parametrize("builder,kernel", [
    ("incore", "digest_jk"), ("direct", "eri4c_jk_list"),
    ("streaming", "eri4c_jk_stair")])
def test_k5_k6_jk_match_plain_f_classes(cuda_device, builder, kernel):
    """J, K at a fixed symmetric D through K6, K5 list and K5 staircase on
    the f basis, every f class launched, within 1e-11 x max(|J|, |K|) of
    the plain versions."""
    prim, _ = _two_waters_f()
    rng = np.random.default_rng(7)
    X = rng.normal(size=(prim.nbf, prim.nbf))
    D = torch.as_tensor(X + X.T)

    def make(dev):
        if builder == "streaming":
            return fock_stream.StreamingDirectFock(prim, device=dev)
        return fock.ScreenedDirectFock(prim, incore=builder == "incore",
                                       device=dev)

    fb = make(cuda_device)
    if builder == "streaming":
        tabs = [(fb.blocks[cp.bi].table, fb.blocks[cp.ki].table)
                for cp in fb.pairs]
    else:
        tabs = [(g.bra, g.ket) for g in fb.groups]
    want = {(b.la, b.lb, k.la, k.lb) for b, k in tabs}
    want = {c for c in want if 3 in c}
    assert (3, 3, 3, 3) in want
    kernels.reset_launches()
    Jg, Kg = (x.cpu() for x in fb.jk_halves(D.to(cuda_device)))
    assert {c for c in kernels.class_launches[kernel] if 3 in c} == want
    Jr, Kr = make(CPU).jk_halves(D)
    scale = max(float(Jr.abs().max()), float(Kr.abs().max()))
    assert float((Jg - Jr).abs().max()) <= 1e-11 * scale
    assert float((Kg - Kr).abs().max()) <= 1e-11 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("scf_type", ["df", "rhf"])
def test_f_basis_rhf_on_card_matches_cpu(cuda_device, scf_type):
    """DF-RHF and conventional RHF of the 2-water system in the f basis
    (SAD: K4 on the O atom's (ff|ff)) within 1e-9 Eh of the CPU's."""
    import json

    c = json.loads((pathlib.Path(jc.__file__).resolve().parent / "data" /
                    "water_clusters.json").read_text())["w32"]
    spec = jc.io.parse_input({
        "molecule": {"symbols": c["symbols"][:6],
                     "geometry": c["geometry"][:18]},
        "model": {"method": "RHF", "basis": F_BASIS,
                  "auxiliary_basis": "cc-pVTZ-JKFIT"},
        "keywords": {"scf": {"scf_type": scf_type, "niter": 60,
                             "dele": 1e-10, "rmsd": 1e-8, "guess": "sad",
                             "mixed_precision": False}}})
    kernels.reset_launches()
    e_card = jc.run_spec(spec, device=cuda_device)["Energy"]
    assert kernels.class_launches["eri4c"].get((3, 3, 3, 3), 0) > 0
    e_cpu = jc.run_spec(spec, device=CPU)["Energy"]
    assert e_card["Converged?"] and e_cpu["Converged?"]
    assert abs(e_card["Energy"] - e_cpu["Energy"]) <= 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["k4", "list", "stair", "stair_t0"])
def test_k4_k5_each_route_matches_plain(cuda_device, mode):
    """Water in 6-311++G(2d,2p) (class pairs to (dd|dd): L <= 3 on the lane
    route, the rest on the warp route, both launched; each class pair's
    route read from the build, ``eri.eri4c_geometry``, and held to the
    table of ``ops/kernels.py``): each class pair's
    first 1, 33, 45 and N - 3 staircase quartets (counts that are not
    multiples of 32 nor of a warp's quartets).  K4 against ``eri4c_plain``
    within 1e-12 x max |I|; K5 in list mode (the decoded quartets and
    weights), staircase mode, and staircase mode from t0 = 5 and 37 (mid
    window) against the plain versions within 1e-11 x max(|J|, |K|)."""
    prim, _ = _water("6-311++G(2d,2p)")
    sdf = fock_stream.StreamingDirectFock(prim, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(13)
    X = torch.randn((prim.nbf, prim.nbf), dtype=torch.float64,
                    device=cuda_device, generator=g)
    D = (X + X.T).contiguous()
    got, ref = (torch.zeros((2, prim.nbf, prim.nbf), dtype=torch.float64,
                            device=cuda_device) for _ in range(2))
    kernels.reset_launches()
    routes, err, scale = set(), 0.0, 0.0
    for cp in sdf.pairs:
        bra, ket = sdf.blocks[cp.bi].table, sdf.blocks[cp.ki].table
        cls = (bra.la, bra.lb, ket.la, ket.lb)
        route = eri.eri4c_geometry(bra, ket)["route"]
        assert route == kernels.eri4c_route(*cls), cls
        assert route == "lane" or sum(cls) > 3, cls
        routes.add(route)
        for m in sorted({min(cp.N, k) for k in (1, 33, 45, max(1, cp.N - 3))}):
            if mode == "stair_t0":
                for t0 in (5, 37):
                    if t0 + m <= cp.N:
                        fock_stream.eri4c_jk_staircase(
                            got, bra, ket, cp.cum, m, cp.same, D, t0=t0)
                        fock_stream.eri4c_jk_staircase_plain(
                            ref, bra, ket, cp.cum, m, cp.same, D, t0=t0)
                continue
            if mode == "stair":
                fock_stream.eri4c_jk_staircase(got, bra, ket, cp.cum, m,
                                               cp.same, D)
                fock_stream.eri4c_jk_staircase_plain(ref, bra, ket, cp.cum, m,
                                                     cp.same, D)
                continue
            t = torch.arange(m, dtype=torch.int64, device=cuda_device)
            r, c, w = fock_stream.decode_staircase(cp.cum, t, bra, ket,
                                                   cp.same)
            if mode == "k4":
                I = eri.eri4c_plain(bra, ket, r, c)
                err = max(err, float((eri.eri4c_class(bra, ket, r, c)
                                      - I).abs().max()))
                scale = max(scale, float(I.abs().max()))
            else:
                fock.eri4c_jk(got, bra, ket, r, c, w, D)
                fock.eri4c_jk_plain(ref, bra, ket, r, c, w, D)
    assert routes == {"lane", "warp"}
    name = {"k4": "eri4c", "list": "eri4c_jk_list"}.get(mode, "eri4c_jk_stair")
    launched = kernels.class_launches[name]
    assert set(launched) == {(sdf.blocks[cp.bi].table.la,
                              sdf.blocks[cp.bi].table.lb,
                              sdf.blocks[cp.ki].table.la,
                              sdf.blocks[cp.ki].table.lb) for cp in sdf.pairs}
    if mode == "k4":
        assert err <= 1e-12 * scale
    else:
        assert float((got - ref).abs().max()) <= \
            1e-11 * float(ref.abs().max())


@pytest.mark.cuda
def test_compiled_routes_of_all_55_class_pairs_match_the_table(cuda_device):
    """The route nvcc built for each of the 55 class pairs to (ff|ff)
    (``jc_eri4c_geometry``: ``Eri4cClass::kLane`` from the build's
    ``-DJC_ERI4C_LANE_MASK_B<i>``) is the one ``kernels.eri4c_route`` gives it,
    on pair tables of two waters in 6-31G(2df,p)."""
    import itertools

    prim, _ = _two_waters_f()
    sdf = fock_stream.StreamingDirectFock(prim, device=cuda_device)
    tables = {}
    for b in sdf.blocks:
        tables.setdefault((b.table.la, b.table.lb), b.table)
    pcs = [pc for pc in eri.PAIR_CLASSES if max(pc) <= 3]
    assert set(tables) == set(pcs)
    built = {}
    for i, j in itertools.combinations_with_replacement(range(len(pcs)), 2):
        bra = tables[pcs[i]]
        ket = tables[pcs[j]]
        built[(bra.la, bra.lb, ket.la, ket.lb)] = \
            eri.eri4c_geometry(bra, ket)["route"]
    assert len(built) == 55
    assert built == {c: kernels.eri4c_route(*c) for c in built}
    assert {"lane", "warp"} == set(built.values())


@pytest.mark.cuda
def test_k5_ket_tiles_of_the_f_classes(cuda_device):
    """Two waters in 6-31G(2df,p): the class pairs whose warp-route slice
    would pass 110 KiB ((ff|ff) among them) run in ket tiles of fewer than
    NCD components at 2 warps or more an SM (CUDA's occupancy calculator,
    ``eri.eri4c_geometry``); each one's K5 staircase from t0 = 1, and K4 on
    its quartets, against the plain versions (1e-11 x max(|J|, |K|),
    1e-12 x max |I|)."""
    from juliachem_jl_tpu_torch.basis.structs import ncart

    prim, _ = _two_waters_f()
    sdf = fock_stream.StreamingDirectFock(prim, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(17)
    X = torch.randn((prim.nbf, prim.nbf), dtype=torch.float64,
                    device=cuda_device, generator=g)
    D = (X + X.T).contiguous()
    got, ref = (torch.zeros((2, prim.nbf, prim.nbf), dtype=torch.float64,
                            device=cuda_device) for _ in range(2))
    tiled, err4, scale4 = [], 0.0, 0.0
    for cp in sdf.pairs:
        bra, ket = sdf.blocks[cp.bi].table, sdf.blocks[cp.ki].table
        geo = eri.eri4c_geometry(bra, ket)
        if geo["route"] != "warp" or geo["CT"] >= ncart(ket.la) * ncart(ket.lb):
            continue
        tiled.append((bra.la, bra.lb, ket.la, ket.lb))
        assert geo["warps_per_sm"] >= 2 and geo["warp_bytes"] <= 110 * 1024
        t0 = 1 if cp.N > 1 else 0
        fock_stream.eri4c_jk_staircase(got, bra, ket, cp.cum, cp.N - t0,
                                       cp.same, D, t0=t0)
        fock_stream.eri4c_jk_staircase_plain(ref, bra, ket, cp.cum,
                                             cp.N - t0, cp.same, D, t0=t0)
        t = torch.arange(cp.N, dtype=torch.int64, device=cuda_device)
        r, c, _ = fock_stream.decode_staircase(cp.cum, t, bra, ket, cp.same)
        I = eri.eri4c_plain(bra, ket, r, c)
        err4 = max(err4, float((eri.eri4c_class(bra, ket, r, c)
                                - I).abs().max()))
        scale4 = max(scale4, float(I.abs().max()))
    assert (3, 3, 3, 3) in tiled
    assert err4 <= 1e-12 * scale4
    assert float((got - ref).abs().max()) <= 1e-11 * float(ref.abs().max())


# --- K6's routes (csrc/eri4c.cuh: lane route one cached block a thread,
# warp route one block a warp)

def _k6_each_route(cuda_device, prim, seed):
    """K6 on every class pair of the in-core batches of ``prim``, each on
    its route as built (``fock.digest_geometry``, held to
    ``kernels.digest_route``), over the whole batch, from its second block
    (blocks 8 bytes off a 16-byte boundary where a block has an odd count)
    and over its first 45 (a warp short after a whole one), against
    ``digest_plain``; returns the class pairs seen on each route and their
    geometries."""
    fb = fock.ScreenedDirectFock(prim, incore=True, device=cuda_device)
    fb.fill_incore()
    g = torch.Generator(device=cuda_device).manual_seed(seed)
    X = torch.randn((prim.nbf, prim.nbf), dtype=torch.float64,
                    device=cuda_device, generator=g)
    D = (X + X.T).contiguous()
    seen, geos = {"lane": set(), "warp": set(), "block": set()}, {}
    crossing = 0
    for grp in fb.groups:   # bra runs that cross a warp's 32 blocks
        sb = grp.sel_bra.cpu().numpy()
        crossing += int(np.sum(sb[31:-1:32] == sb[32::32]))
    assert crossing > 0
    got, ref = (torch.zeros((2, prim.nbf, prim.nbf), dtype=torch.float64,
                            device=cuda_device) for _ in range(2))
    kernels.reset_launches()
    launches = 0
    for grp in fb.groups:
        cls = (grp.bra.la, grp.bra.lb, grp.ket.la, grp.ket.lb)
        n = grp.sel_bra.shape[0]
        geos[cls] = geo = fock.digest_geometry(grp.bra, grp.ket)
        assert geo["route"] == kernels.digest_route(*cls), cls
        assert geo["blocks_per_sm"] >= 1, cls
        seen[geo["route"]].add(cls)
        for sel in (slice(None), slice(1, None), slice(0, 45)):
            if len(range(n)[sel]) == 0:
                continue
            args = (grp.I[sel], grp.bra, grp.ket, grp.sel_bra[sel],
                    grp.sel_ket[sel], grp.weight[sel], D)
            fock.digest_jk(got, *args)
            fock.digest_plain(ref, args[0], args[5], D, args[1], args[2],
                              args[3], args[4])
            launches += 1
    assert kernels.launches["digest_jk"] == launches
    assert float((got - ref).abs().max()) <= 1e-11 * float(ref.abs().max())
    return seen, geos


@pytest.mark.cuda
def test_k6_each_class_pair_on_its_route_matches_plain(cuda_device):
    """Water in 6-311++G(2d,2p), class pairs to (dd|dd): K6, each class
    pair on its route, within 1e-11 x max(|J|, |K|) of ``digest_plain``
    (``_k6_each_route``); the lane route runs on exactly the route table's
    class pairs, all of them on K4/K5's lane route."""
    prim, _ = _water("6-311++G(2d,2p)")
    seen, _ = _k6_each_route(cuda_device, prim, 19)
    assert len(seen["lane"]) + len(seen["warp"]) == 21
    assert seen["lane"] and all(kernels.eri4c_route(*c) == "lane"
                                for c in seen["lane"])
    assert (2, 2, 2, 2) in seen["warp"]


@pytest.mark.cuda
def test_k6_each_f_class_pair_on_its_route_matches_plain(cuda_device):
    """Two waters in 6-31G(2df,p), all 55 class pairs to (ff|ff): K6, each
    class pair on its route, within 1e-11 x max(|J|, |K|) of
    ``digest_plain``; (ff|ff) on the warp route, two warps an SM."""
    prim, _ = _two_waters_f()
    seen, geos = _k6_each_route(cuda_device, prim, 23)
    assert len(seen["lane"]) + len(seen["warp"]) == 55
    assert len(seen["lane"]) >= 8
    assert geos[(3, 3, 3, 3)]["route"] == "warp"
    assert geos[(3, 3, 3, 3)]["warps_per_sm"] >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("R,K,C,off", [
    (129, 131, 67, 1), (300, 300, 1001, 4), (1112, 1112, 16384, 32),
    (257, 250, 130, 0)])
def test_k8_ragged_shapes_match_plain_and_f64(cuda_device, R, K, C, off,
                                              lower):
    """K8 at shapes that are not multiples of its 128 x 64 tile nor of its
    16-deep slab (and w8's fold chunk, A = 1112, C = 16384), M lower
    triangular or full, X a column chunk of a wider B (offset ``off``:
    4-byte copies where a row is not 16-byte aligned): one launch each,
    within 4 sqrt(K) 2^-24 (|Mh| + |Ml|) |X| of the plain version and of
    the f64 product elementwise."""
    from juliachem_jl_tpu_torch.models import linalg

    rng = np.random.default_rng(R + K + C)
    M = rng.standard_normal((R, K)) / K ** 0.5
    if lower:
        M = np.tril(M)
    Bfull = rng.standard_normal((K, C + off + 3)).astype(np.float32)
    Mh = torch.tensor(M, device=cuda_device).float()
    Ml = (torch.tensor(M, device=cuda_device) - Mh.double()).float()
    X = torch.tensor(Bfull, device=cuda_device)[:, off:off + C]
    n0 = kernels.launches["split_fold"]
    got = linalg.split_fold(Mh, Ml, X, lower=lower)
    assert kernels.launches["split_fold"] == n0 + 1
    assert got.shape == (R, C) and bool(torch.isfinite(got).all())
    ref = linalg.split_fold_plain(Mh, Ml, X)
    bound = 4 * K**0.5 * 2.0**-24 * ((Mh.abs() + Ml.abs()).double()
                                     @ X.abs().double())
    assert bool(((got - ref).double().abs() <= bound).all())
    exact = (Mh.double() + Ml.double()) @ X.double()
    assert bool(((got.double() - exact).abs() <= bound).all())


# --- the g classes: the first 1 or 2 waters of the generated w32 cluster
# in 6-311++G(3df,3pd)+G (one G shell on each O), read from its basis file;
# one water already makes all 15 pair classes and the 65 class pairs with a
# g shell, and keeps the CPU's plain references to seconds

G_BASIS = "6-311++G(3df,3pd)+G"
G_FILE = pathlib.Path(__file__).parent / "data" / "6-311ppG_3df_3pd_G.gbs"


def _waters_g(n=2, aux="cc-pVTZ-JKFIT"):
    import json

    jc.basis.register_basis_file(str(G_FILE), G_BASIS)
    c = json.loads((pathlib.Path(jc.__file__).resolve().parent / "data" /
                    "water_clusters.json").read_text())["w32"]
    mol = jc.molecule.from_input_dict({"symbols": c["symbols"][:3 * n],
                                       "geometry": c["geometry"][:9 * n]})
    return (jc.basis.build(mol, G_BASIS),
            jc.basis.build_auxiliary(mol, aux, G_BASIS))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k1_eri3c_g_classes(cuda_device, dtype):
    """The 3-center tensor and the metric of the g basis (primary pairs to
    (gg), aux to g: every g bra against lq 0..4 launched, (gg|g) in A
    tiles) against the CPU's: f64 within 1e-12 x its max-abs; the f32 store
    bit for bit the f64 output rounded."""
    prim, aux = _waters_g()
    kernels.reset_launches()
    got = eri3c.three_center_tensor(prim, aux, cuda_device,
                                    out_dtype=dtype).cpu()
    launched = set(kernels.class_launches["eri3c" if dtype == torch.float64
                                          else "eri3c_f32"])
    assert {(la, 4, lq) for la in range(5) for lq in range(5)} <= launched
    if dtype == torch.float64:
        ref = eri3c.three_center_tensor(prim, aux, CPU)
        assert float((got - ref).abs().max()) <= \
            1e-12 * float(ref.abs().max())
        M = eri3c.two_center_metric(aux, cuda_device).cpu()
        Mr = eri3c.two_center_metric(aux, CPU)
        assert float((M - Mr).abs().max()) <= 1e-12 * float(Mr.abs().max())
    else:
        ref = eri3c.three_center_tensor(prim, aux, cuda_device).cpu()
        assert torch.equal(got, ref.float())


@pytest.mark.cuda
def test_k1_each_g_class_on_its_body_matches_plain(cuda_device):
    """Every g class (la, 4 | lq) of two waters in the g basis against
    cc-pVTZ-JKFIT, class by class: built with the body of
    ``kernels.eri3c_body`` (the T1 body, R across the block and T1 on
    DMMA, for ``ERI3C_T1``), within 1e-12 x the class's max-abs of K1's
    plain version (a class zero by symmetry within 1e-15), every target
    written; the f32 store the f64 output rounded, bit for bit."""
    prim, aux = _waters_g()
    nbf, A = prim.nbf, aux.nbf
    auxs = eri3c.aux_tables(aux, cuda_device)
    auxs_cpu = eri3c.aux_tables(aux, CPU)
    bodies = {}
    for blk in unique_pair_blocks(prim):
        if blk.lb != 4:
            continue
        kp = eri3c.k1_pairs(blk, lambda ia, ib: ia * nbf + ib, cuda_device)
        kpc = eri3c.k1_pairs(blk, lambda ia, ib: ia * nbf + ib, CPU)
        for at, atc in zip(auxs, auxs_cpu):
            cls = (blk.la, blk.lb, at.lq)
            geo = eri3c.eri3c_geometry(*cls, kp.table.Ka, kp.table.Kb, at.Kq)
            bodies[cls] = geo["body"]
            assert geo["route"] == kernels.eri3c_route(*cls), cls
            assert geo["body"] == kernels.eri3c_body(*cls), cls
            got = torch.full((A, nbf * nbf), float("nan"),
                             dtype=torch.float64, device=cuda_device)
            eri3c.eri3c_class(got, kp.table, at, kp.cols, kp.cols_t,
                              kp.mirror)
            got32 = torch.full((A, nbf * nbf), float("nan"),
                               dtype=torch.float32, device=cuda_device)
            eri3c.eri3c_class(got32, kp.table, at, kp.cols, kp.cols_t,
                              kp.mirror)
            ref = torch.zeros((A, nbf * nbf), dtype=torch.float64)
            eri3c.eri3c_class_plain(ref, kpc.table, atc, kpc.cols,
                                    kpc.cols_t, kpc.mirror)
            got, got32 = got.cpu(), got32.cpu()
            hit = ~torch.isnan(got)
            rows = (atc.qrow[:, None]
                    + torch.arange(at.ecd.shape[2])[None]).reshape(-1)
            written = torch.zeros_like(hit)
            for c, m in ((kpc.cols, None), (kpc.cols_t, kpc.mirror)):
                cc = c if m is None else c[m.bool()]
                written[rows[:, None], cc.reshape(1, -1)] = True
            assert torch.equal(hit, written), cls
            scale = float(ref.abs().max())
            bound = 1e-12 * scale if scale > 1e-8 else 1e-15
            assert float((got.nan_to_num(0.0) - ref).abs().max()) <= bound, \
                cls
            assert torch.equal(got32[written], got[written].float()), cls
    assert {c for c, b in bodies.items() if b == "t1"} == kernels.ERI3C_T1


@pytest.mark.cuda
def test_k4_eri4c_g_classes(cuda_device):
    """Every class pair with a g shell (65), all its quartets, within
    1e-12 x the largest integral, and each class launched; (gg|gg) and
    (fg|gg) run in bra tiles on the block route (one water)."""
    from juliachem_jl_tpu_torch.basis.structs import ncart

    prim, _ = _waters_g(1)
    blocks = unique_pair_blocks(prim)
    kernels.reset_launches()
    pairs, bra_tiled = [], set()
    for i, bra in enumerate(blocks):
        for ket in blocks[i:]:
            cls = (bra.la, bra.lb, ket.la, ket.lb)
            if 4 not in cls:
                continue
            sb, sk = np.meshgrid(np.arange(bra.n), np.arange(ket.n),
                                 indexing="ij")
            got = eri.eri_block(bra, ket, sb.ravel(), sk.ravel(),
                                cuda_device).cpu()
            ref = eri.eri_block(bra, ket, sb.ravel(), sk.ravel(), CPU)
            pairs.append((cls, got, ref))
            geo = eri.eri4c_geometry(eri.pair_table(bra, cuda_device),
                                     eri.pair_table(ket, cuda_device))
            assert geo["route"] == kernels.eri4c_route(*cls), cls
            assert geo["blocks_per_sm"] >= 1, cls
            if geo["route"] != "lane" and geo["AT"] < ncart(bra.la) * \
                    ncart(bra.lb):
                bra_tiled.add(cls)
    assert len(pairs) == 65
    assert set(kernels.class_launches["eri4c"]) == {c for c, _, _ in pairs}
    assert (4, 4, 4, 4) in bra_tiled and (3, 4, 4, 4) in bra_tiled
    scale = max(float(ref.abs().max()) for _, _, ref in pairs)
    for cls, got, ref in pairs:
        assert float((got - ref).abs().max()) <= 1e-12 * scale, cls


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["k4", "list", "stair"])
def test_k4_k5_each_g_class_pair_on_its_route(cuda_device, mode):
    """One water in 6-311++G(3df,3pd)+G: each of the 65 class pairs with a
    g shell on the route it was built with (``eri.eri4c_geometry``, held to
    ``kernels.eri4c_route``; the block route's shared memory within 227
    KB), its first 1 and N - 3 staircase quartets and all N: K4 against
    ``eri4c_plain`` (1e-12 x max |I|), K5 list and staircase mode against
    their plain versions (1e-11 x max(|J|, |K|)), class pair by class
    pair."""
    prim, _ = _waters_g(1)
    sdf = fock_stream.StreamingDirectFock(prim, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(37)
    X = torch.randn((prim.nbf, prim.nbf), dtype=torch.float64,
                    device=cuda_device, generator=g)
    D = (X + X.T).contiguous()
    kernels.reset_launches()
    routes = {}
    for cp in sdf.pairs:
        bra, ket = sdf.blocks[cp.bi].table, sdf.blocks[cp.ki].table
        cls = (bra.la, bra.lb, ket.la, ket.lb)
        if 4 not in cls:
            continue
        geo = eri.eri4c_geometry(bra, ket)
        assert geo["route"] == kernels.eri4c_route(*cls), cls
        assert geo["route"] != "block" or (geo["block_bytes"] <= 232448
                                           and geo["blocks_per_sm"] >= 1)
        routes[cls] = geo["route"]
        got, ref = (torch.zeros((2, prim.nbf, prim.nbf), dtype=torch.float64,
                                device=cuda_device) for _ in range(2))
        err = scale = 0.0
        for m in sorted({1, max(1, cp.N - 3), cp.N}):
            t = torch.arange(m, dtype=torch.int64, device=cuda_device)
            r, c, w = fock_stream.decode_staircase(cp.cum, t, bra, ket,
                                                   cp.same)
            if mode == "k4":
                I = eri.eri4c_plain(bra, ket, r, c)
                err = max(err, float((eri.eri4c_class(bra, ket, r, c)
                                      - I).abs().max()))
                scale = max(scale, float(I.abs().max()))
            elif mode == "list":
                fock.eri4c_jk(got, bra, ket, r, c, w, D)
                fock.eri4c_jk_plain(ref, bra, ket, r, c, w, D)
            else:
                fock_stream.eri4c_jk_staircase(got, bra, ket, cp.cum, m,
                                               cp.same, D)
                fock_stream.eri4c_jk_staircase_plain(ref, bra, ket, cp.cum, m,
                                                     cp.same, D)
        if mode != "k4":
            err = float((got - ref).abs().max())
            scale = 1e1 * float(ref.abs().max())   # 1e-11 x max(|J|, |K|)
        # a one-centre class pair of odd total momentum vanishes: held to
        # the card's rounding of zero then
        assert err <= 1e-12 * max(scale, 1e-3), (cls, err, scale)
    assert len(routes) == 65
    assert "block" in routes.values()
    name = {"k4": "eri4c", "list": "eri4c_jk_list"}.get(mode, "eri4c_jk_stair")
    assert set(kernels.class_launches[name]) == set(routes)


LONG_BASIS = "cc-pVDZ+S12G2"
LONG_FILE = pathlib.Path(__file__).parent / "data" / "long_s_2g.gbs"


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["k4", "list", "stair"])
def test_k4_k5_long_contractions_in_rounds(cuda_device, mode):
    """One water in cc-pVDZ+S12G2 (a 12-primitive S and a 2-primitive G
    shell on O): the g class pairs that the block route takes in rounds of
    primitive pairs ((ss|gg): 144 x 4 padded primitive quartets), all
    their staircase quartets, K4 against ``eri4c_plain`` (1e-12 x max |I|)
    and K5 list and staircase mode against their plain versions (1e-11 x
    max(|J|, |K|)), within 227 KB a block."""
    jc.basis.register_basis_file(str(LONG_FILE), LONG_BASIS)
    mol = jc.molecule.from_input_dict(
        {"symbols": ["O", "H", "H"],
         "geometry": [0.0, 0.0, 0.116321, 0.0, 0.751155, -0.465285,
                      0.0, -0.751155, -0.465285]})
    prim = jc.basis.build(mol, LONG_BASIS)
    sdf = fock_stream.StreamingDirectFock(prim, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(41)
    X = torch.randn((prim.nbf, prim.nbf), dtype=torch.float64,
                    device=cuda_device, generator=g)
    D = (X + X.T).contiguous()
    kernels.reset_launches()
    rounds = set()
    for cp in sdf.pairs:
        bra, ket = sdf.blocks[cp.bi].table, sdf.blocks[cp.ki].table
        cls = (bra.la, bra.lb, ket.la, ket.lb)
        geo = eri.eri4c_geometry(bra, ket)
        if geo["route"] != "block" or (geo["RB"], geo["RK"]) == (
                geo["Kab"], geo["Kcd"]):
            continue
        assert geo["block_bytes"] <= 232448 and geo["blocks_per_sm"] >= 1
        rounds.add(cls)
        t = torch.arange(cp.N, dtype=torch.int64, device=cuda_device)
        r, c, w = fock_stream.decode_staircase(cp.cum, t, bra, ket, cp.same)
        if mode == "k4":
            I = eri.eri4c_plain(bra, ket, r, c)
            err = float((eri.eri4c_class(bra, ket, r, c) - I).abs().max())
            scale = float(I.abs().max())
        else:
            got, ref = (torch.zeros((2, prim.nbf, prim.nbf),
                                    dtype=torch.float64, device=cuda_device)
                        for _ in range(2))
            if mode == "list":
                fock.eri4c_jk(got, bra, ket, r, c, w, D)
                fock.eri4c_jk_plain(ref, bra, ket, r, c, w, D)
            else:
                fock_stream.eri4c_jk_staircase(got, bra, ket, cp.cum, cp.N,
                                               cp.same, D)
                fock_stream.eri4c_jk_staircase_plain(ref, bra, ket, cp.cum,
                                                     cp.N, cp.same, D)
            err = float((got - ref).abs().max())
            scale = 1e1 * float(ref.abs().max())   # 1e-11 x max(|J|, |K|)
        assert err <= 1e-12 * max(scale, 1e-3), (cls, err, scale)
    assert (0, 0, 4, 4) in rounds and (4, 4, 4, 4) in rounds
    name = {"k4": "eri4c", "list": "eri4c_jk_list"}.get(mode, "eri4c_jk_stair")
    assert rounds <= set(kernels.class_launches[name])


@pytest.mark.cuda
def test_k4_gg_gg_of_an_oxygen_atom(cuda_device):
    """The SAD case: the full ERI tensor of one O atom in
    6-311++G(3df,3pd)+G ((gg|gg) and every other class of one centre, in
    bra and ket tiles) within 1e-12 x its max-abs of the CPU's."""
    jc.basis.register_basis_file(str(G_FILE), G_BASIS)
    mol = jc.molecule.from_input_dict({"symbols": ["O"],
                                       "geometry": [0.0, 0.0, 0.0]})
    prim = jc.basis.build(mol, G_BASIS)
    kernels.reset_launches()
    got = eri.full_eri_tensor(prim, cuda_device).cpu()
    assert kernels.class_launches["eri4c"].get((4, 4, 4, 4), 0) == 1
    ref = eri.full_eri_tensor(prim, CPU)
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("builder,kernel", [
    ("incore", "digest_jk"), ("direct", "eri4c_jk_list"),
    ("streaming", "eri4c_jk_stair")])
def test_k5_k6_jk_match_plain_g_classes(cuda_device, builder, kernel):
    """J, K at a fixed symmetric D through K6, K5 list and K5 staircase on
    the g basis, every g class launched, within 1e-11 x max(|J|, |K|) of
    the plain versions (one water)."""
    prim, _ = _waters_g(1)
    rng = np.random.default_rng(29)
    X = rng.normal(size=(prim.nbf, prim.nbf))
    D = torch.as_tensor(X + X.T)

    def make(dev):
        if builder == "streaming":
            return fock_stream.StreamingDirectFock(prim, device=dev)
        return fock.ScreenedDirectFock(prim, incore=builder == "incore",
                                       device=dev)

    fb = make(cuda_device)
    if builder == "streaming":
        tabs = [(fb.blocks[cp.bi].table, fb.blocks[cp.ki].table)
                for cp in fb.pairs]
    else:
        tabs = [(g.bra, g.ket) for g in fb.groups]
    want = {(b.la, b.lb, k.la, k.lb) for b, k in tabs}
    want = {c for c in want if 4 in c}
    assert (4, 4, 4, 4) in want
    kernels.reset_launches()
    Jg, Kg = (x.cpu() for x in fb.jk_halves(D.to(cuda_device)))
    assert {c for c in kernels.class_launches[kernel] if 4 in c} == want
    Jr, Kr = make(CPU).jk_halves(D)
    scale = max(float(Jr.abs().max()), float(Kr.abs().max()))
    assert float((Jg - Jr).abs().max()) <= 1e-11 * scale
    assert float((Kg - Kr).abs().max()) <= 1e-11 * scale


@pytest.mark.cuda
def test_k6_each_g_class_pair_on_its_route_matches_plain(cuda_device):
    """Two waters in 6-311++G(3df,3pd)+G, all 120 class pairs to (gg|gg):
    K6, each class pair on its route, within 1e-11 x max(|J|, |K|) of
    ``digest_plain``; the block route on exactly the table's class pairs
    ((gg|gg) among them: its 405 KB block streamed through a ring of slabs
    within the card's 227 KB), each holding a block an SM."""
    prim, _ = _waters_g()
    seen, geos = _k6_each_route(cuda_device, prim, 31)
    assert sum(len(v) for v in seen.values()) == 120
    assert seen["block"] == kernels.DIGEST_BLOCK
    assert (4, 4, 4, 4) in seen["block"]
    for cls in seen["block"]:
        g = geos[cls]
        assert g["block_bytes"] <= 232448 and g["blocks_per_sm"] >= 1, cls
        assert g["warps_per_block"] == 8, cls
    for cls in seen["warp"]:
        assert geos[cls]["warp_bytes"] <= 110 * 1024, cls


@pytest.mark.cuda
def test_compiled_routes_of_all_120_class_pairs_match_the_table(cuda_device):
    """The route nvcc built for each of the 120 class pairs to (gg|gg) is
    the one ``kernels.eri4c_route`` gives it (K6's, ``digest_route``), on
    pair tables of two waters in 6-311++G(3df,3pd)+G."""
    import itertools

    prim, _ = _waters_g()
    sdf = fock_stream.StreamingDirectFock(prim, device=cuda_device)
    tables = {}
    for b in sdf.blocks:
        tables.setdefault((b.table.la, b.table.lb), b.table)
    assert set(tables) == set(eri.PAIR_CLASSES)
    built = {}
    for bra_c, ket_c in itertools.combinations_with_replacement(
            eri.PAIR_CLASSES, 2):
        bra, ket = tables[bra_c], tables[ket_c]
        cls = (*bra_c, *ket_c)
        built[cls] = eri.eri4c_geometry(bra, ket)["route"]
        assert fock.digest_geometry(bra, ket)["route"] == \
            kernels.digest_route(*cls), cls
    assert len(built) == 120
    assert built == {c: kernels.eri4c_route(*c) for c in built}


@pytest.mark.cuda
@pytest.mark.parametrize("scf_type,n", [("df", 2), ("rhf", 1)])
def test_g_basis_rhf_on_card_matches_cpu(cuda_device, scf_type, n):
    """DF-RHF of two waters and conventional RHF of one in the g basis,
    through ``model.basis_file`` (SAD: K4 on the O atom's (gg|gg)), within
    1e-9 Eh of the CPU's."""
    import json

    c = json.loads((pathlib.Path(jc.__file__).resolve().parent / "data" /
                    "water_clusters.json").read_text())["w32"]
    spec = jc.io.parse_input({
        "molecule": {"symbols": c["symbols"][:3 * n],
                     "geometry": c["geometry"][:9 * n]},
        "model": {"method": "RHF", "basis": G_BASIS,
                  "basis_file": str(G_FILE),
                  "auxiliary_basis": "cc-pVTZ-JKFIT"},
        "keywords": {"scf": {"scf_type": scf_type, "niter": 60,
                             "dele": 1e-10, "rmsd": 1e-8, "guess": "sad",
                             "mixed_precision": False}}})
    kernels.reset_launches()
    e_card = jc.run_spec(spec, device=cuda_device)["Energy"]
    assert kernels.class_launches["eri4c"].get((4, 4, 4, 4), 0) > 0
    e_cpu = jc.run_spec(spec, device=CPU)["Energy"]
    assert e_card["Converged?"] and e_cpu["Converged?"]
    assert abs(e_card["Energy"] - e_cpu["Energy"]) <= 1e-9


# ------------------------------------------------------------------ K9

def _waters(n):
    """The first n waters of w32 (a Molecule)."""
    import json

    c = json.loads((pathlib.Path(jc.__file__).resolve().parent / "data" /
                    "water_clusters.json").read_text())["w32"]
    return jc.molecule.from_input_dict({"symbols": c["symbols"][:3 * n],
                                        "geometry": c["geometry"][:9 * n]})


K9_SYSTEMS = {"w8 6-31+G*": (8, "6-31+G*"),
              "2 waters 6-311++G(3df,3pd)": (2, "6-311++G(3df,3pd)"),
              "2 waters g basis": (2, G_BASIS)}


@pytest.mark.cuda
@pytest.mark.parametrize("group", kernels.STV_GROUPS)
@pytest.mark.parametrize("system", list(K9_SYSTEMS))
def test_k9_every_class_matches_plain(cuda_device, system, group):
    """K9 at each group size on every class of the system's basis, into
    matrices filled with NaN: every element stored, each class's within
    1e-12 x the matrix's max-abs of the plain version on the card."""
    from juliachem_jl_tpu_torch.ops import oei

    n, name = K9_SYSTEMS[system]
    jc.basis.register_basis_file(str(G_FILE), G_BASIS)
    mol = _waters(n)
    prim = jc.basis.build(mol, name)
    ref = oei.overlap_kinetic_nuclear_plain(prim, mol, cuda_device)
    tables = oei.stv_tables(prim, cuda_device)
    atoms = oei.atom_table(mol, cuda_device)
    got = [torch.full_like(ref[0], float("nan")) for _ in range(3)]
    kernels.reset_launches()
    for t in tables:
        oei.stv_class(t, atoms, *got, group=group)
    assert kernels.launches["stv"] == len(tables)
    assert kernels.class_launches["stv"] == {(t.la, t.lb): 1 for t in tables}
    for g, r in zip(got, ref):
        assert not bool(torch.isnan(g).any())
        assert float((g - r).abs().max()) <= 1e-12 * float(r.abs().max())


@pytest.mark.cuda
def test_k9_wrapper_launches_it_and_builds_no_plain_chunk(cuda_device,
                                                          monkeypatch):
    """``overlap_kinetic_nuclear`` on the card runs K9 once a class and
    none of the plain path's chunks."""
    from juliachem_jl_tpu_torch.ops import oei

    mol = _waters(2)
    prim = jc.basis.build(mol, "6-31+G*")
    ref = oei.overlap_kinetic_nuclear_plain(prim, mol, cuda_device)

    def refuse(*a, **k):
        raise AssertionError("the plain path ran on the card")

    monkeypatch.setattr(oei, "_stv_block", refuse)
    kernels.reset_launches()
    got = oei.overlap_kinetic_nuclear(prim, mol, cuda_device)
    assert kernels.launches["stv"] == len(oei.stv_tables(prim, CPU)) == 6
    for g, r in zip(got, ref):
        assert g.is_cuda
        assert float((g - r).abs().max()) <= 1e-12 * float(r.abs().max())


@pytest.mark.cuda
def test_k9_raises_for_a_class_it_lacks(cuda_device):
    """(hh) is not instantiated (K9 stops at g shells, l = 4)."""
    from juliachem_jl_tpu_torch.ops import oei

    def zeros(*shape, dtype=torch.float64):
        return torch.zeros(shape, dtype=dtype, device=cuda_device)

    tab = oei.StvTable(la=5, lb=5, prim=zeros(1, 3), pair=zeros(1, 6),
                       meta=zeros(1, 5, dtype=torch.int32))
    with pytest.raises(NotImplementedError):
        oei.stv_class(tab, zeros(1, 4), zeros(4, 4), zeros(4, 4), zeros(4, 4))


# ------------------------------------------------------------ K10 and K11

def _grad_close(got, ref):
    """Within 1e-10 x max |g| (1e-10 where that is below 1): the atomics
    sum in no fixed order."""
    scale = max(float(ref.abs().max()), 1.0)
    assert float((got - ref).abs().max()) <= 1e-10 * scale


def _sym_on(n, seed, dev):
    X = np.random.default_rng(seed).standard_normal((n, n))
    return torch.as_tensor(X + X.T, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("system", ["w8 6-31+G*", "w1 g"])
@pytest.mark.parametrize("group", [8, 16, 32])
def test_k10_every_class_matches_plain(cuda_device, system, group):
    from juliachem_jl_tpu_torch.ops import oei, oei_grad

    n, name = {"w8 6-31+G*": (8, "6-31+G*"), "w1 g": (1, G_BASIS)}[system]
    jc.basis.register_basis_file(str(G_FILE), G_BASIS)
    mol = _waters(n)
    prim = jc.basis.build(mol, name)
    D, W = _sym_on(prim.nbf, 1, cuda_device), _sym_on(prim.nbf, 2, cuda_device)
    tables = oei_grad.stv_grad_tables(prim, cuda_device)
    atoms = oei.atom_table(mol, cuda_device)
    kernels.reset_launches()
    for t in tables:
        got = torch.zeros((mol.natom, 3), dtype=torch.float64,
                          device=cuda_device)
        oei_grad.stv_grad_class(t, atoms, D, W, got, group=group)
        _grad_close(got, oei_grad.stv_grad_plain([t], atoms, D, W))
    assert kernels.launches["stv_grad"] == len(tables)


def _k11_case(case, dev):
    jc.basis.register_basis_file(str(G_FILE), G_BASIS)
    name, aux_name = {"6-31+G*": ("6-31+G*", "cc-pVTZ-JKFIT"),
                      "g": (G_BASIS, "cc-pVTZ-JKFIT"),
                      "contracted aux": ("6-31G", "6-31G")}[case]
    mol = _waters(1)
    prim = jc.basis.build(mol, name)
    aux = jc.basis.build_auxiliary(mol, aux_name, name)
    X = np.random.default_rng(3).standard_normal((aux.nbf, prim.nbf,
                                                  prim.nbf))
    gamma = torch.as_tensor(X + X.transpose(0, 2, 1), device=dev)
    return mol, prim, aux, gamma, _sym_on(aux.nbf, 4, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["6-31+G*", "g", "contracted aux"])
def test_k11_every_class_matches_plain(cuda_device, case):
    from juliachem_jl_tpu_torch.ops import eri_grad

    mol, prim, aux, gamma, Omega = _k11_case(case, cuda_device)
    aux_t, pair_t = eri_grad.df_grad_tables(prim, aux, cuda_device)

    def zeros():
        return torch.zeros((mol.natom, 3), dtype=torch.float64,
                           device=cuda_device)

    kernels.reset_launches()
    for ti in aux_t:
        for tj in pair_t:
            got, ref = zeros(), zeros()
            eri_grad.eri3c_grad_class(ti, tj, gamma, got)
            eri_grad.three_center_grad_plain([ti], [tj], gamma, ref)
            _grad_close(got, ref)
    assert kernels.launches["eri3c_grad"] == len(aux_t) * len(pair_t)
    for a, ti in enumerate(aux_t):
        for tj in aux_t[a:]:
            got, ref = zeros(), zeros()
            eri_grad.metric_grad_class(ti, tj, Omega, got)
            # the plain version walks the class pairs of its list: (ti|tj)
            # alone is [ti, tj] less (ti|ti) and (tj|tj)
            eri_grad.metric_grad_plain([ti] if ti is tj else [ti, tj], Omega,
                                       ref)
            if ti is not tj:
                for only in (ti, tj):
                    eri_grad.metric_grad_plain([only], -Omega, ref)
            _grad_close(got, ref)
    n = len(aux_t)
    assert kernels.launches["metric_grad"] == n * (n + 1) // 2


@pytest.mark.cuda
def test_df_gradient_on_card_runs_k10_k11(cuda_device, monkeypatch):
    """The DF-RHF gradient's derivative terms on the card: K10 and K11,
    none of the plain versions; within 1e-10 of the CPU's."""
    from juliachem_jl_tpu_torch.models import gradient
    from juliachem_jl_tpu_torch.ops import eri_grad, oei_grad

    mol = _waters(2)
    bsets = jc.basis.run(mol, {"method": "RHF", "basis": "6-31G*",
                               "auxiliary_basis": "cc-pVDZ-JKFIT"})
    D = _sym_on(bsets.primary.nbf, 5, CPU) * 0.05
    W = _sym_on(bsets.primary.nbf, 6, CPU) * 0.05
    ref = gradient.total_gradient(mol, bsets.primary, D, W,
                                  bsets.auxiliary)

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")

    for mod, fn in ((oei_grad, "stv_grad_plain"),
                    (eri_grad, "three_center_grad_plain"),
                    (eri_grad, "metric_grad_plain")):
        monkeypatch.setattr(mod, fn, refuse)
    kernels.reset_launches()
    got = gradient.total_gradient(mol, bsets.primary, D.to(cuda_device),
                                  W.to(cuda_device), bsets.auxiliary)
    assert got.is_cuda
    for k in ("stv_grad", "eri3c_grad", "metric_grad"):
        assert kernels.launches[k] > 0, k
    _grad_close(got.cpu(), ref)


@pytest.mark.cuda
def test_k10_k11_raise_for_a_class_they_lack(cuda_device):
    """(hh) and an h aux shell are not instantiated (both stop at g)."""
    from juliachem_jl_tpu_torch.ops import eri_grad, oei, oei_grad

    def zeros(*shape, dtype=torch.float64):
        return torch.zeros(shape, dtype=dtype, device=cuda_device)

    def table(la, lb):
        return oei.StvTable(la=la, lb=lb, prim=zeros(1, 3), pair=zeros(1, 6),
                            meta=zeros(1, 7, dtype=torch.int32))

    kernels.reset_launches()
    with pytest.raises(NotImplementedError):
        oei_grad.stv_grad_class(table(5, 5), zeros(1, 4), zeros(4, 4),
                                zeros(4, 4), zeros(1, 3))
    with pytest.raises(NotImplementedError):
        eri_grad.eri3c_grad_class(table(5, 0), table(0, 0), zeros(4, 4, 4),
                                  zeros(1, 3))
    with pytest.raises(NotImplementedError):
        eri_grad.metric_grad_class(table(2, 0), table(5, 0), zeros(4, 4),
                                   zeros(1, 3))
    assert not any(kernels.launches[k] for k in ("stv_grad", "eri3c_grad",
                                                 "metric_grad"))
