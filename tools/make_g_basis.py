"""Write the g-shell basis "6-311++G(3df,3pd)+G" as a GAMESS-US basis file.

The file is the library's 6-311++G(3df,3pd) for H, C and O plus one
uncontracted G shell on C (exponent 0.858866) and on O (1.607915): the G
exponents of the library's cc-pVTZ-JKFIT.  Every number is written with
``repr``, so parsing the file gives the library's floats bit for bit.

    python3 tools/make_g_basis.py [--out tests/data/6-311ppG_3df_3pd_G.gbs]

Both the tests and chip_smoke.py read the committed file; rerun this only
when the library changes (a CPU test checks that the file regenerates byte
for byte).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LIBRARY = ROOT / "juliachem_jl_tpu_torch" / "basis" / "data" / "basis_library.json"
OUT = ROOT / "tests" / "data" / "6-311ppG_3df_3pd_G.gbs"
BASE, G_SOURCE = "6-311++G(3df,3pd)", "cc-pVTZ-JKFIT"
ELEMENTS = (("H", "HYDROGEN"), ("C", "CARBON"), ("O", "OXYGEN"))


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
            lines.append(f"{sh['l']}   {len(sh['exps'])}")
            if sh["l"] == "L":
                rows = zip(sh["exps"], sh["coefs_s"], sh["coefs_p"])
            else:
                rows = zip(sh["exps"], sh["coefs"])
            for k, row in enumerate(rows):
                lines.append(f"  {k + 1}  " + "  ".join(repr(float(x))
                                                     for x in row))
        lines.append("")
    lines.append("$END")
    return "\n".join(lines) + "\n"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args()
    Path(args.out).write_text(g_basis_text())
    print(args.out)


if __name__ == "__main__":
    main()
