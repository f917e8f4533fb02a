"""Periodic table data needed for SMILES parsing and valence perception."""

from __future__ import annotations

# symbol → atomic number (through element 118)
SYMBOLS = (
    "H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe Co "
    "Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In Sn Sb "
    "Te I Xe Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf Ta W Re "
    "Os Ir Pt Au Hg Tl Pb Bi Po At Rn Fr Ra Ac Th Pa U Np Pu Am Cm Bk Cf Es "
    "Fm Md No Lr Rf Db Sg Bh Hs Mt Ds Rg Cn Nh Fl Mc Lv Ts Og"
).split()

ATOMIC_NUM = {s: i + 1 for i, s in enumerate(SYMBOLS)}

# default valences for implicit-H computation (SMILES "organic subset" rules;
# multi-valent entries tried in order — the smallest that fits is used)
DEFAULT_VALENCES = {
    "B": (3,),
    "C": (4,),
    "N": (3, 5),
    "O": (2,),
    "P": (3, 5),
    "S": (2, 4, 6),
    "F": (1,),
    "Cl": (1,),
    "Br": (1,),
    "I": (1,),
    "H": (1,),
}

# elements that may be written bare (unbracketed) in SMILES
ORGANIC_SUBSET = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}

# elements that may be written lowercase-aromatic in SMILES
AROMATIC_OK = {"b", "c", "n", "o", "p", "s", "se", "as", "te"}

# outer-shell electron counts (for lone-pair / hybridization perception)
VALENCE_ELECTRONS = {
    1: 1, 5: 3, 6: 4, 7: 5, 8: 6, 9: 7, 14: 4, 15: 5, 16: 6, 17: 7,
    33: 5, 34: 6, 35: 7, 52: 6, 53: 7,
}
