"""Element tables: symbol -> atomic number, atomic masses.

Parity with reference src/basis/BasisHelpers.jl:1-119 (H..Xe).  Masses are the
standard most-abundant-isotope/conventional atomic weights used for
center-of-mass computation (JCBasis.jl:87-101).
"""

SYMBOLS = [
    "X", "H", "He",
    "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar",
    "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr",
    "Rb", "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd",
    "In", "Sn", "Sb", "Te", "I", "Xe",
]

SYMBOL_TO_Z = {s: z for z, s in enumerate(SYMBOLS) if z > 0}

# Conventional atomic weights (amu); index = Z.
MASSES = [
    0.0, 1.00782503, 4.00260325,
    7.01600455, 9.0121822, 11.0093054, 12.0, 14.0030740048, 15.99491461956,
    18.99840322, 19.9924401754,
    22.9897692809, 23.985041700, 26.98153863, 27.9769265325, 30.97376163,
    31.97207100, 34.96885268, 39.9623831225,
    38.96370668, 39.96259098, 44.9559119, 47.9479463, 50.9439595,
    51.9405075, 54.9380451, 55.9349375, 58.9331950, 57.9353429, 62.9295975,
    63.9291422, 68.9255736, 73.9211778, 74.9215965, 79.9165213, 78.9183371,
    83.911507,
    84.911789738, 87.9056121, 88.9058483, 89.9047044, 92.9063781,
    97.9054082, 97.907216, 101.9043493, 102.905504, 105.903486, 106.905097,
    113.9033585, 114.903878, 119.9021947, 120.9038157, 129.9062244,
    126.904473, 131.9041535,
]


def symbol_to_z(symbol: str) -> int:
    return SYMBOL_TO_Z[symbol.capitalize() if len(symbol) > 1 else symbol.upper()]


def z_to_symbol(z: int) -> str:
    return SYMBOLS[z]


def mass(z: int) -> float:
    return MASSES[z]


# Angstrom -> Bohr conversion used by the reference (JCBasis.jl:61).
ANGSTROM_TO_BOHR = 1.0 / 0.52917724924
# Dipole conversion a.u. -> Debye (reference Multipole.jl:117).
AU_TO_DEBYE = 2.54174623
