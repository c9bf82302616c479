#!/usr/bin/env python3
"""Write the generated water clusters of juliachem_jl_tpu_torch/data/water_clusters.json.

    python3 tools/make_water_clusters.py [--out PATH]

Two clusters, ``w32`` and ``w64``: rigid waters (O-H 0.9572 A, H-O-H
104.52 deg) with their oxygens on a cubic lattice of spacing 3.1 A (about
liquid density), 4 x 4 x 2 and 4 x 4 x 4 sites, each water turned by a
uniformly random rotation from ``numpy.random.default_rng(0)`` (one
generator per cluster, sites in lattice order); an orientation is drawn
again while any of its atoms lies closer than 1.8 A to an atom of an
already placed water.  Coordinates are in Angstrom, rounded to 8 decimals,
so the file is the same on every machine.  The output holds only the
geometry; the basis sets are the caller's.
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "juliachem_jl_tpu_torch" / "data" / "water_clusters.json"
R_OH = 0.9572
ANGLE_HOH = 104.52
SPACING = 3.1
MIN_DIST = 1.8
CLUSTERS = {"w32": (4, 4, 2), "w64": (4, 4, 4)}


def monomer() -> np.ndarray:
    """O, H, H of one water in its own frame (O at the origin), Angstrom."""
    h = math.radians(ANGLE_HOH) / 2
    return np.array([[0.0, 0.0, 0.0],
                     [R_OH * math.sin(h), 0.0, R_OH * math.cos(h)],
                     [-R_OH * math.sin(h), 0.0, R_OH * math.cos(h)]])


def random_rotation(rng: np.random.Generator) -> np.ndarray:
    """A uniformly distributed rotation matrix (Shoemake's unit
    quaternion from three uniform numbers)."""
    u1, u2, u3 = rng.random(3)
    a, b = math.sqrt(1 - u1), math.sqrt(u1)
    x, y = a * math.sin(2 * math.pi * u2), a * math.cos(2 * math.pi * u2)
    z, w = b * math.sin(2 * math.pi * u3), b * math.cos(2 * math.pi * u3)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def cluster(shape: tuple[int, int, int]) -> dict:
    rng = np.random.default_rng(0)
    base = monomer()
    placed: list[np.ndarray] = []
    for i in range(shape[0]):
        for j in range(shape[1]):
            for k in range(shape[2]):
                site = SPACING * np.array([i, j, k], dtype=np.float64)
                for _ in range(1000):
                    mol = base @ random_rotation(rng).T + site
                    if not placed:
                        break
                    others = np.concatenate(placed)
                    d = np.linalg.norm(mol[:, None] - others[None], axis=-1)
                    if d.min() >= MIN_DIST:
                        break
                else:
                    raise RuntimeError(f"no orientation fits at site {i, j, k}")
                placed.append(mol)
    xyz = np.round(np.concatenate(placed), 8)
    n = len(placed)
    return {"symbols": ["O", "H", "H"] * n,
            "geometry": [float(v) for v in xyz.ravel()],
            "n_waters": n, "lattice": list(shape),
            "spacing_angstrom": SPACING}


def clusters() -> dict:
    return {"_about": "rigid waters (O-H 0.9572 A, H-O-H 104.52 deg), "
                      "oxygens on a cubic lattice of 3.1 A, orientations "
                      "from numpy default_rng(0); geometry in Angstrom; "
                      "written by tools/make_water_clusters.py",
            **{name: cluster(shape) for name, shape in CLUSTERS.items()}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args()
    Path(args.out).write_text(json.dumps(clusters(), indent=1) + "\n")


if __name__ == "__main__":
    main()
