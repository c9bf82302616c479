"""The kernels' class tables against the library's bases and csrc/.

For every primary basis in the library, on a molecule of H, C, N and O with
cc-pVTZ-JKFIT (AutoAux for N, which the set lacks): each (la, lb | lq) that
``build`` and ``build_auxiliary`` produce, and each metric bra (0, lP), is in
K1's ``KERNEL_CLASSES``; each pair class of ``unique_pair_blocks`` is in
``PAIR_CLASSES`` of K4/K5/K6; the g basis file of the tests
(tests/data/6-311ppG_3df_3pd_G.gbs) reaches every pair class to (gg).  Then
the tables agree with the cases that csrc/ instantiates, read from its
macros: K1's JC_ERI3C_CASES list times the aux momenta of the eri3c_lq*.cu
units (each instance writes double or float); K4/K5/K6's ket chain
(JC_KETS_FROM_*) from each bra unit eri4c_b<la><lb>.cu and the bra classes
of the dispatch in eri4c.cu; and the route masks the build passes hold one
mask a bra class, in the order the sources index them.  Runs on the port
alone (no JAX).
"""

import itertools
import re
from pathlib import Path

import pytest

import juliachem_jl_tpu_torch as jc
from juliachem_jl_tpu_torch.basis import library
from juliachem_jl_tpu_torch.ops import eri3c, kernels
from juliachem_jl_tpu_torch.ops.eri import PAIR_CLASSES
from juliachem_jl_tpu_torch.ops.pairs import unique_pair_blocks

# formamide and water: H, C, N, O
MOLECULE = {"symbols": ["C", "O", "N", "H", "H", "H", "O", "H", "H"],
            "geometry": [0.0, 0.42, 0.0, 1.22, 0.58, 0.0, -0.72, -0.72, 0.0,
                         -0.52, 1.38, 0.0, -1.72, -0.62, 0.0, -0.27, -1.62,
                         0.0, 0.5, 3.4, 0.3, 1.3, 3.9, 0.3, -0.2, 4.0, 0.3],
            "molecular_charge": 0}
PRIMARY = [n for n in library.available_sets() if "JKFIT" not in n]
CSRC = kernels.CSRC_DIR
G_FILE = Path(__file__).parent / "data" / "6-311ppG_3df_3pd_G.gbs"
G_BASIS = "6-311++G(3df,3pd)+G"


def _classes(name):
    mol = jc.molecule.from_input_dict(MOLECULE)
    prim = jc.basis.build(mol, name)
    aux = jc.basis.build_auxiliary(mol, "cc-pVTZ-JKFIT", name)
    return prim, aux


@pytest.mark.parametrize("name", PRIMARY)
def test_every_class_of_the_library_is_instantiated(name):
    prim, aux = _classes(name)
    pairs = {(b.la, b.lb) for b in unique_pair_blocks(prim)}
    assert pairs <= set(PAIR_CLASSES)
    need = {(la, lb, lq) for la, lb in pairs for lq in aux.classes}
    need |= {(0, lp, lq) for lp in aux.classes for lq in aux.classes}
    assert need <= eri3c.KERNEL_CLASSES, sorted(need - eri3c.KERNEL_CLASSES)


def test_f_bases_reach_every_pair_class():
    """The three f bases give all 10 pair classes and aux shells to g."""
    f_bases = [n for n in PRIMARY
               if max(b.lb for b in unique_pair_blocks(_classes(n)[0])) == 3]
    assert sorted(f_bases) == ["6-311++G(3df,3pd)", "6-311G(2df,2pd)",
                               "6-31G(2df,p)"]
    for n in f_bases:
        prim, aux = _classes(n)
        assert [(b.la, b.lb) for b in unique_pair_blocks(prim)] == \
            [pc for pc in PAIR_CLASSES if max(pc) <= 3]
        assert sorted(aux.classes) == [0, 1, 2, 3, 4]


def test_g_basis_file_reaches_every_pair_class():
    """The g basis file (model.basis_file) gives all 15 pair classes to
    (gg), and K1 and K4/K5/K6 hold every class it makes."""
    jc.basis.register_basis_file(str(G_FILE), G_BASIS)
    # the molecule but its N (the file holds H, C and O)
    keep = [i for i, x in enumerate(MOLECULE["symbols"]) if x != "N"]
    mol = jc.molecule.from_input_dict({
        "symbols": [MOLECULE["symbols"][i] for i in keep],
        "geometry": [MOLECULE["geometry"][3 * i + k] for i in keep
                     for k in range(3)],
        "molecular_charge": 0})
    prim = jc.basis.build(mol, G_BASIS)
    aux = jc.basis.build_auxiliary(mol, "cc-pVTZ-JKFIT", G_BASIS)
    assert [(b.la, b.lb) for b in unique_pair_blocks(prim)] == \
        list(PAIR_CLASSES)
    assert len(PAIR_CLASSES) == 15
    need = {(la, lb, lq) for la, lb in PAIR_CLASSES for lq in aux.classes}
    assert need <= eri3c.KERNEL_CLASSES
    # 120 class pairs, 65 of them with a g shell
    cps = list(itertools.combinations_with_replacement(PAIR_CLASSES, 2))
    assert len(cps) == 120
    assert sum(4 in (*b, *k) for b, k in cps) == 65


def test_route_masks_hold_every_class():
    """One mask a bra class, in the order the sources index them, each bit
    the route table's: 15 bras x 15 kets for K4/K5 (bit j of mask i: ket
    pair class j), 15 bras x 5 aux momenta for K1."""
    def masks_of(flags, pre):   # one -D<pre>_B<i>=0x.. flag a bra
        m = [re.fullmatch(rf"-D{pre}_B{i}=(0x[0-9a-f]+)", f)
             for i, f in enumerate(flags)]
        assert all(m), flags
        return [int(x.group(1), 16) for x in m]

    masks = masks_of(kernels.route_flags(), "JC_ERI4C_LANE_MASK")
    assert len(masks) == len(PAIR_CLASSES)
    for i, j in itertools.product(range(15), repeat=2):
        lane = j >= i and kernels.eri4c_route(
            *PAIR_CLASSES[i], *PAIR_CLASSES[j]) == "lane"
        assert (masks[i] >> j) & 1 == lane, (i, j)
    masks1 = masks_of(kernels.eri3c_route_flags(), "JC_ERI3C_LANE_MASK")
    assert len(masks1) == len(kernels.ERI3C_BRAS) == 15
    for (i, (la, lb)), lq in itertools.product(
            enumerate(kernels.ERI3C_BRAS), range(5)):
        assert (masks1[i] >> lq) & 1 == (
            kernels.eri3c_route(la, lb, lq) == "lane"), (la, lb, lq)
    # the sources read them so: an array of 15 masks each, indexed by
    # pair_class / eri3c_bra
    head4 = (CSRC / "eri4c.cuh").read_text()
    assert re.search(r"constexpr unsigned kEri4cLaneMasks\[15\] = \{\s+"
                     + r",\s+".join(f"JC_ERI4C_LANE_MASK_B{i}"
                                    for i in range(15)) + r"\};", head4)
    assert re.search(r"kLane =\s+\(kEri4cLaneMasks\[pair_class\(LA, LB\)\] "
                     r">> pair_class\(LC, LD\)\) & 1;", head4)
    assert "return a * 5 - a * (a - 1) / 2 + (b - a);" in head4
    head1 = (CSRC / "eri3c.cuh").read_text()
    assert re.search(r"constexpr unsigned kEri3cLaneMasks\[15\] = \{\s+"
                     + r",\s+".join(f"JC_ERI3C_LANE_MASK_B{i}"
                                    for i in range(15)) + r"\};", head1)
    assert "kLane = (kEri3cLaneMasks[eri3c_bra(LA, LB)] >> LQ) & 1;" in head1

    def pair_class(a, b):   # csrc/eri4c.cuh
        return a * 5 - a * (a - 1) // 2 + (b - a)

    def eri3c_bra(la, lb):   # csrc/eri3c.cuh
        return (la * 3 - la * (la - 1) // 2 + (lb - la) if lb <= 2
                else (6 + la if lb == 3 else 10 + la))

    assert [pair_class(*pc) for pc in PAIR_CLASSES] == list(range(15))
    assert [eri3c_bra(*b) for b in kernels.ERI3C_BRAS] == list(range(15))


def test_k1_table_matches_csrc():
    text = (CSRC / "eri3c_launch.cuh").read_text()
    cases = text[text.index("#define JC_ERI3C_CASES"):
                 text.index("#define JC_ERI3C_LQ")]
    bras = {tuple(map(int, m)) for m in
            re.findall(r"M\((\d), (\d), LQ\)", cases)}
    # one instance a class writes double or float (the f32 flag)
    lqs = set()
    for f in CSRC.glob("eri3c_lq*.cu"):
        lqs |= {int(x) for x in
                re.findall(r"JC_ERI3C_LQ\((\d)\)", f.read_text())}
    assert {(la, lb, lq) for la, lb in bras for lq in lqs} == \
        set(eri3c.KERNEL_CLASSES)
    assert not list(CSRC.glob("eri3c_f32*.cu"))


def test_k4_k5_k6_tables_match_csrc():
    launch = (CSRC / "eri4c_launch.cuh").read_text()
    # JC_KETS_FROM_<ab>: ket class (a, b), then the chain it calls
    nxt = {}
    for a, tail in re.findall(
            r"#define JC_KETS_FROM_(\d\d)\(M, LA, LB\) (.*)", launch):
        m = re.search(r"JC_KETS_FROM_(\d\d)", tail)
        assert tail.startswith(f"M(LA, LB, {a[0]}, {a[1]})")
        nxt[a] = m.group(1) if m else None
    chains = {}
    for a in nxt:
        out, k = [], a
        while k is not None:
            out.append((int(k[0]), int(k[1])))
            k = nxt[k]
        chains[a] = out
    instantiated = set()
    for f in CSRC.glob("eri4c_b*.cu"):
        for la, lb, start in re.findall(
                r"JC_ERI4C_BRA\((\d), (\d), JC_KETS_FROM_(\d\d)\)",
                f.read_text()):
            assert f.name == f"eri4c_b{la}{lb}.cu"
            instantiated |= {((int(la), int(lb)), k) for k in chains[start]}
    want = {(PAIR_CLASSES[i], PAIR_CLASSES[j])
            for i, j in itertools.combinations_with_replacement(
                range(len(PAIR_CLASSES)), 2)}
    assert instantiated == want
    dispatch = (CSRC / "eri4c.cu").read_text()
    cases = {(int(x) // 10, int(x) % 10) for x in
             re.findall(r"case (\d+): return FN##_b\d\d", dispatch)}
    decls = {(int(a), int(b)) for a, b in
             re.findall(r"JC_ERI4C_DECL\((\d), (\d)\)", dispatch)}
    assert cases == decls == set(PAIR_CLASSES)
