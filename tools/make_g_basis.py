"""Write the g-shell basis "6-311++G(3df,3pd)+G" as a GAMESS-US basis file.

The file is the library's 6-311++G(3df,3pd) for H, C and O plus one
uncontracted G shell on C (exponent 0.858866) and on O (1.607915): the G
exponents of the library's cc-pVTZ-JKFIT.  Every number is written with
``repr``, so parsing the file gives the library's floats bit for bit.

    python3 tools/make_g_basis.py [--out tests/data/6-311ppG_3df_3pd_G.gbs]
    python3 tools/make_g_basis.py --long [--out tests/data/long_s_2g.gbs]

``--long`` writes "cc-pVDZ+S12G2" instead, a basis of long contractions
for the block route's rounds of primitive pairs: the library's cc-pVDZ
for H and O, plus on O an S shell of 12 primitives (exponents in
geometric progression over cc-pVQZ's O s range, 0.2067 to 61420, smooth
made-up coefficients), so that an (ss) pair holds 144 primitive pairs, and
a G shell of 2 primitives.

Both the tests and chip_smoke.py read the committed files; rerun this only
when the library changes (CPU tests check that the files regenerate byte
for byte).
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LIBRARY = ROOT / "juliachem_jl_tpu_torch" / "basis" / "data" / "basis_library.json"
OUT = ROOT / "tests" / "data" / "6-311ppG_3df_3pd_G.gbs"
LONG_OUT = ROOT / "tests" / "data" / "long_s_2g.gbs"
BASE, G_SOURCE = "6-311++G(3df,3pd)", "cc-pVTZ-JKFIT"
ELEMENTS = (("H", "HYDROGEN"), ("C", "CARBON"), ("O", "OXYGEN"))


def _shell_lines(sh: dict) -> list:
    lines = [f"{sh['l']}   {len(sh['exps'])}"]
    if sh["l"] == "L":
        rows = zip(sh["exps"], sh["coefs_s"], sh["coefs_p"])
    else:
        rows = zip(sh["exps"], sh["coefs"])
    for k, row in enumerate(rows):
        lines.append(f"  {k + 1}  " + "  ".join(repr(float(x)) for x in row))
    return lines


def long_basis_text() -> str:
    lib = json.loads(LIBRARY.read_text())
    lines = [
        "! cc-pVDZ+S12G2: the repository library's cc-pVDZ for H and O, plus",
        "! on O an S shell of 12 primitives (exponents in geometric",
        "! progression from 0.2067 to 61420, made-up smooth coefficients) and",
        "! a G shell of 2 primitives: long contractions for the block",
        "! route's rounds of primitive pairs.  Written by",
        "! tools/make_g_basis.py --long.",
        "$DATA",
    ]
    lo, hi = 0.2067, 61420.0
    s12 = {"l": "S",
           "exps": [round(hi * (lo / hi) ** (k / 11), 6) for k in range(12)],
           "coefs": [round(math.exp(-((k - 6.5) / 2.5) ** 2), 6)
                     for k in range(12)]}
    g2 = {"l": "G", "exps": [2.2, 0.9], "coefs": [0.55, 0.6]}
    for sym, name in (("H", "HYDROGEN"), ("O", "OXYGEN")):
        lines.append(name)
        shells = list(lib["cc-pVDZ"][sym]) + ([s12, g2] if sym == "O" else [])
        for sh in shells:
            lines += _shell_lines(sh)
        lines.append("")
    lines.append("$END")
    return "\n".join(lines) + "\n"


def g_basis_text() -> str:
    lib = json.loads(LIBRARY.read_text())
    lines = [
        "! 6-311++G(3df,3pd)+G: the repository library's 6-311++G(3df,3pd)",
        "! for H, C and O, plus one uncontracted G shell on C and on O whose",
        "! exponents are the G exponents of the library's cc-pVTZ-JKFIT.",
        "! Written by tools/make_g_basis.py from",
        "! juliachem_jl_tpu_torch/basis/data/basis_library.json.",
        "$DATA",
    ]
    for sym, name in ELEMENTS:
        lines.append(name)
        shells = list(lib[BASE][sym])
        shells += [s for s in lib[G_SOURCE][sym] if s["l"] == "G"]
        for sh in shells:
            lines += _shell_lines(sh)
        lines.append("")
    lines.append("$END")
    return "\n".join(lines) + "\n"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--long", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    out = args.out or str(LONG_OUT if args.long else OUT)
    Path(out).write_text(long_basis_text() if args.long else g_basis_text())
    print(out)


if __name__ == "__main__":
    main()
