"""External basis-set file support (GAMESS-US format).

Port of ``juliachem_jl_tpu/basis/external.py`` (its own copy: the port
imports nothing of the JAX package).

The reference hard-requires its bundled bsed.h5, which keys every element
H-Xe (src/basis/JCBasis.jl:104, BasisHelpers.jl:1-59); this environment ships
exact data only for the elements appearing in the reference's committed
artifacts (H/C/N/O/F).  Rather than synthesizing unverifiable tables for the
rest of the periodic table, any element/basis can be supplied at runtime from
a standard GAMESS-US format basis file — the format the Basis Set Exchange
(www.basissetexchange.org) exports — via

    from juliachem_jl_tpu_torch import basis
    basis.register_basis_file("my-6-31G.gbs", name="6-31G")

or per-run through the input JSON: ``model["basis_file"] = "path.gbs"``.
Registered data takes precedence over the built-in library and flows through
the exact same GAMESS renormalization as library data (BasisStructs.jl:52-109
convention, implemented in basis/structs.py).
"""

from __future__ import annotations

import re

# GAMESS-US element names (the $DATA header form) -> symbols, H-Xe —
# the same coverage as the reference's BasisHelpers element table.
_GAMESS_NAMES = {
    "HYDROGEN": "H", "HELIUM": "He", "LITHIUM": "Li", "BERYLLIUM": "Be",
    "BORON": "B", "CARBON": "C", "NITROGEN": "N", "OXYGEN": "O",
    "FLUORINE": "F", "NEON": "Ne", "SODIUM": "Na", "MAGNESIUM": "Mg",
    "ALUMINUM": "Al", "ALUMINIUM": "Al", "SILICON": "Si", "PHOSPHORUS": "P",
    "SULFUR": "S", "CHLORINE": "Cl", "ARGON": "Ar", "POTASSIUM": "K",
    "CALCIUM": "Ca", "SCANDIUM": "Sc", "TITANIUM": "Ti", "VANADIUM": "V",
    "CHROMIUM": "Cr", "MANGANESE": "Mn", "IRON": "Fe", "COBALT": "Co",
    "NICKEL": "Ni", "COPPER": "Cu", "ZINC": "Zn", "GALLIUM": "Ga",
    "GERMANIUM": "Ge", "ARSENIC": "As", "SELENIUM": "Se", "BROMINE": "Br",
    "KRYPTON": "Kr", "RUBIDIUM": "Rb", "STRONTIUM": "Sr", "YTTRIUM": "Y",
    "ZIRCONIUM": "Zr", "NIOBIUM": "Nb", "MOLYBDENUM": "Mo",
    "TECHNETIUM": "Tc", "RUTHENIUM": "Ru", "RHODIUM": "Rh",
    "PALLADIUM": "Pd", "SILVER": "Ag", "CADMIUM": "Cd", "INDIUM": "In",
    "TIN": "Sn", "ANTIMONY": "Sb", "TELLURIUM": "Te", "IODINE": "I",
    "XENON": "Xe",
}
_SYMBOLS = {v.upper(): v for v in _GAMESS_NAMES.values()}

_SHELL_LETTERS = {"S", "P", "D", "F", "G", "L"}

_FLOAT = r"[-+]?\d*\.?\d+(?:[EeDd][-+]?\d+)?"


def _to_float(tok: str) -> float:
    return float(tok.replace("D", "E").replace("d", "e"))


def _element_of(line: str) -> str | None:
    """Element header line -> symbol (GAMESS full name or bare symbol)."""
    word = line.split()[0].upper()
    if word in _GAMESS_NAMES:
        return _GAMESS_NAMES[word]
    if word in _SYMBOLS:
        return _SYMBOLS[word]
    return None


def parse_gamess_basis(text: str) -> dict[str, list[dict]]:
    """Parse GAMESS-US basis text -> {symbol: shell list} in the library's
    internal form ({"l": letter, "exps": [...], "coefs": [...]} with L
    (sp) shells carrying coefs_s/coefs_p)."""
    out: dict[str, list[dict]] = {}
    lines = text.splitlines()
    i, n = 0, len(lines)
    element: str | None = None
    while i < n:
        raw = lines[i].strip()
        i += 1
        if (not raw or raw.startswith("!") or raw.startswith("#")
                or raw.upper().startswith("$")):
            if raw.upper().startswith("$END"):
                element = None
            continue
        parts = raw.split()
        letter = parts[0].upper()
        # shell headers ("S 6", "L 3") take precedence over bare element
        # symbols: single letters S/P/F collide with sulfur/phosphorus/
        # fluorine, and inside an element block a <letter, int> pair is
        # always a shell
        is_shell = (element is not None and letter in _SHELL_LETTERS
                    and len(parts) == 2 and parts[1].isdigit())
        if not is_shell:
            sym = _element_of(raw)
            if sym is not None and parts[0][0].isalpha() and len(parts) <= 2:
                element = sym
                out.setdefault(element, [])
                continue
        if is_shell:
            nprim = int(parts[1])
            exps, c1, c2 = [], [], []
            for _ in range(nprim):
                row = lines[i].strip().split()
                i += 1
                # GAMESS rows: [index,] exponent, coef[, coef_p for L] —
                # the leading primitive counter is optional in the wild
                expected = 3 if letter == "L" else 2
                if len(row) == expected + 1:
                    row = row[1:]
                if len(row) != expected or not all(
                        re.fullmatch(_FLOAT, t) for t in row):
                    raise ValueError(
                        f"bad primitive row in {letter} shell: {row!r}")
                vals = [_to_float(t) for t in row]
                exps.append(vals[0])
                c1.append(vals[1])
                if letter == "L":
                    c2.append(vals[2])
            if letter == "L":
                out[element].append(
                    {"l": "L", "exps": exps, "coefs_s": c1, "coefs_p": c2})
            else:
                out[element].append({"l": letter, "exps": exps, "coefs": c1})
            continue
        raise ValueError(
            f"unrecognized line in GAMESS basis input: {raw!r} "
            f"(expected element header or shell header)")
    if not out:
        raise ValueError("no basis data found (is this GAMESS-US format?)")
    return out


def load_basis_file(path: str) -> dict[str, list[dict]]:
    with open(path) as f:
        return parse_gamess_basis(f.read())
