"""QCSchema-style JSON input reader.

Parity with reference src/io/JCInput.jl:56-92: an input file holds four
sections — ``molecule{geometry, symbols, molecular_charge}``, ``driver``
("energy"; "gradient" is an extension beyond the reference), ``model{method,
basis[, auxiliary_basis]}`` and
``keywords{scf, prop}``.  Reference inputs (example_inputs/*.json) parse
unmodified, including the trailing-comma variants the Julia JSON parser
accepts.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field


@dataclass
class InputSpec:
    molecule: dict
    driver: str
    model: dict
    keywords: dict = field(default_factory=dict)

    @property
    def method(self) -> str:
        return self.model.get("method", "RHF")

    @property
    def basis(self) -> str:
        return self.model["basis"]

    @property
    def auxiliary_basis(self) -> str | None:
        return self.model.get("auxiliary_basis")

    @property
    def scf_keywords(self) -> dict:
        return self.keywords.get("scf", {}) or {}

    @property
    def prop_keywords(self) -> dict:
        return self.keywords.get("prop", {}) or {}


_TRAILING_COMMA = re.compile(r",(\s*[}\]])")


def _loads_lenient(text: str) -> dict:
    """Parse JSON, tolerating trailing commas (present in e.g.
    example_inputs/w50.json, accepted by the reference's JSON.jl)."""
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return json.loads(_TRAILING_COMMA.sub(r"\1", text))


def parse_input(data: dict | str) -> InputSpec:
    if isinstance(data, str):
        data = _loads_lenient(data)
    molecule = data["molecule"]
    if "geometry" not in molecule or "symbols" not in molecule:
        raise ValueError("molecule section must contain 'geometry' and 'symbols'")
    driver = data.get("driver", "energy")
    if driver not in ("energy", "gradient", "optimize", "frequencies"):
        # the reference supports only "energy" (JCInput.jl); the rest are
        # our extensions on the analytic-gradient machinery
        raise ValueError(
            f"driver '{driver}' not supported "
            "(have: energy, gradient, optimize, frequencies)"
        )
    return InputSpec(
        molecule=molecule,
        driver=driver,
        model=data["model"],
        keywords=data.get("keywords", {}),
    )


def read_input(path: str, output: int = 0) -> InputSpec:
    """Read an input JSON file; reference JCInput.run (JCInput.jl:20-92)."""
    with open(path) as f:
        spec = parse_input(f.read())
    if output >= 1:
        print(f"Reading input file {path}")
    return spec
