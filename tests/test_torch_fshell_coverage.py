"""The kernels' class tables against the library's bases and csrc/.

For every primary basis in the library, on a molecule of H, C, N and O with
cc-pVTZ-JKFIT (AutoAux for N, which the set lacks): each (la, lb | lq) that
``build`` and ``build_auxiliary`` produce, and each metric bra (0, lP), is in
K1's ``KERNEL_CLASSES``; each pair class of ``unique_pair_blocks`` is in
``PAIR_CLASSES`` of K4/K5/K6.  Then the tables agree with the cases that
csrc/ instantiates, read from its macros: K1's JC_ERI3C_CASES list times
the aux momenta of the eri3c_lq*.cu units (each instance writes double or
float); K4/K5/K6's
ket chain (JC_KETS_FROM_*) from each bra unit eri4c_b<la><lb>.cu and the
bra classes of the dispatch in eri4c.cu.  Runs on the port alone (no JAX).
"""

import itertools
import re

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
            list(PAIR_CLASSES)
        assert sorted(aux.classes) == [0, 1, 2, 3, 4]


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
