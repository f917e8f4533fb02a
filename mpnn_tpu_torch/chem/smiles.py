"""SMILES parser → Mol. RDKit-free (the execution image has no RDKit; the
reference's `Chem.MolFromSmiles` + `AllChem.SanitizeMol` pipeline
(pre_process/load_dataset.py:16-19) is replaced by this parser + Mol.sanitize).

Supported: organic-subset atoms, bracket atoms ([13CH3+], [nH], [O-], …),
aromatic lowercase atoms, bonds - = # $ : / \\, branches, ring-closure
digits and %nn, dot-separated fragments, wildcards (*). Stereo markers
(/ \\ @ @@) are parsed and discarded (the reference featurizer reads no
stereo features).
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from mpnn_tpu_torch.chem.mol import (
    Atom, BOND_AROMATIC, BOND_DOUBLE, BOND_QUAD, BOND_SINGLE, BOND_TRIPLE,
    Mol,
)
from mpnn_tpu_torch.chem.periodic import ATOMIC_NUM, AROMATIC_OK, ORGANIC_SUBSET


class SmilesError(ValueError):
    pass


_BRACKET_RE = re.compile(
    r"^(?P<isotope>\d+)?"
    r"(?P<symbol>[A-Z][a-z]?|[a-z]{1,2}|\*)"
    r"(?P<chiral>@{1,2}(?:TH\d|AL\d|SP\d|TB\d+|OH\d+)?)?"
    r"(?P<hcount>H\d*)?"
    r"(?P<charge>\+{1,3}|-{1,3}|\+\d+|-\d+)?"
    r"(?::(?P<map>\d+))?$"
)

_TWO_LETTER = {s for s in ATOMIC_NUM if len(s) == 2}

_BOND_ORDERS = {
    "-": (BOND_SINGLE, False),
    "=": (BOND_DOUBLE, False),
    "#": (BOND_TRIPLE, False),
    "$": (BOND_QUAD, False),
    ":": (BOND_AROMATIC, True),
    "/": (BOND_SINGLE, False),
    "\\": (BOND_SINGLE, False),
}


def _parse_bracket(body: str) -> Atom:
    m = _BRACKET_RE.match(body)
    if not m:
        raise SmilesError(f"bad bracket atom: [{body}]")
    sym = m.group("symbol")
    aromatic = sym[0].islower() and sym != "*"
    if aromatic:
        if sym not in AROMATIC_OK:
            raise SmilesError(f"element {sym!r} cannot be aromatic")
        sym = sym.capitalize()
    if sym == "*":
        atomic_num = 0
    else:
        if sym not in ATOMIC_NUM:
            raise SmilesError(f"unknown element {sym!r}")
        atomic_num = ATOMIC_NUM[sym]
    h = m.group("hcount")
    if h is None:
        hs = 0
    elif h == "H":
        hs = 1
    else:
        hs = int(h[1:])
    c = m.group("charge") or ""
    if c.startswith("+"):
        charge = int(c[1:]) if c[1:].isdigit() else len(c)
    elif c.startswith("-"):
        charge = -(int(c[1:]) if c[1:].isdigit() else len(c))
    else:
        charge = 0
    iso = int(m.group("isotope")) if m.group("isotope") else 0
    return Atom(atomic_num=atomic_num, formal_charge=charge,
                explicit_hs=hs, aromatic=aromatic, isotope=iso)


def parse_smiles(smiles: str, sanitize: bool = True) -> Mol:
    mol = Mol()
    prev_atom: Optional[int] = None
    pending_bond: Optional[Tuple[float, bool]] = None
    stack: List[Optional[int]] = []
    ring_bonds = {}     # number → (atom idx, pending bond)
    i, n = 0, len(smiles)

    def attach(new_idx: int):
        nonlocal prev_atom, pending_bond
        if prev_atom is not None:
            if pending_bond is not None:
                order, arom = pending_bond
            else:
                a, b = mol.atoms[prev_atom], mol.atoms[new_idx]
                if a.aromatic and b.aromatic:
                    order, arom = BOND_AROMATIC, True
                else:
                    order, arom = BOND_SINGLE, False
            mol.add_bond(prev_atom, new_idx, order, arom)
        prev_atom = new_idx
        pending_bond = None

    def close_ring(num: int):
        nonlocal pending_bond
        if prev_atom is None:
            raise SmilesError("ring closure before any atom")
        if num in ring_bonds:
            other, other_bond = ring_bonds.pop(num)
            bond = pending_bond or other_bond
            if bond is None:
                a, b = mol.atoms[other], mol.atoms[prev_atom]
                if a.aromatic and b.aromatic:
                    bond = (BOND_AROMATIC, True)
                else:
                    bond = (BOND_SINGLE, False)
            mol.add_bond(other, prev_atom, bond[0], bond[1])
            pending_bond = None
        else:
            ring_bonds[num] = (prev_atom, pending_bond)
            pending_bond = None

    while i < n:
        ch = smiles[i]
        if ch in " \t":
            break                               # SMILES ends at whitespace
        if ch == "[":
            j = smiles.find("]", i)
            if j < 0:
                raise SmilesError("unclosed bracket")
            attach(mol.add_atom(_parse_bracket(smiles[i + 1:j])))
            i = j + 1
        elif ch == "(":
            stack.append(prev_atom)
            i += 1
        elif ch == ")":
            if not stack:
                raise SmilesError("unmatched ')'")
            prev_atom = stack.pop()
            i += 1
        elif ch in _BOND_ORDERS:
            pending_bond = _BOND_ORDERS[ch]
            i += 1
        elif ch == ".":
            prev_atom = None
            pending_bond = None
            i += 1
        elif ch == "%":
            if i + 2 >= n or not smiles[i + 1:i + 3].isdigit():
                raise SmilesError("bad %ring closure")
            close_ring(int(smiles[i + 1:i + 3]))
            i += 3
        elif ch.isdigit():
            close_ring(int(ch))
            i += 1
        elif ch == "*":
            attach(mol.add_atom(Atom(atomic_num=0)))
            i += 1
        elif ch.isupper():
            sym = ch
            if i + 1 < n and (ch + smiles[i + 1]) in _TWO_LETTER \
                    and (ch + smiles[i + 1]) in ORGANIC_SUBSET:
                sym = ch + smiles[i + 1]
            if sym not in ORGANIC_SUBSET:
                raise SmilesError(
                    f"element {sym!r} must be bracketed (position {i})")
            attach(mol.add_atom(Atom(atomic_num=ATOMIC_NUM[sym])))
            i += len(sym)
        elif ch.islower():
            sym = ch
            if i + 1 < n and (ch + smiles[i + 1]) in ("se", "as", "te"):
                sym = ch + smiles[i + 1]
            if sym not in AROMATIC_OK:
                raise SmilesError(f"bad aromatic atom {sym!r}")
            attach(mol.add_atom(Atom(atomic_num=ATOMIC_NUM[sym.capitalize()],
                                     aromatic=True)))
            i += len(sym)
        else:
            raise SmilesError(f"unexpected character {ch!r} at {i}")

    if stack:
        raise SmilesError("unmatched '('")
    if ring_bonds:
        raise SmilesError(f"unclosed ring bonds: {sorted(ring_bonds)}")
    if sanitize:
        mol.sanitize()
    return mol


def mol_from_smiles(smiles: str) -> Optional[Mol]:
    """RDKit-style API: returns None on ANY failure — parse errors,
    graph-construction errors (duplicate ring-closure bonds), or perception
    failures — mirroring MolFromSmiles's skip-row contract
    (load_dataset.py:17-18)."""
    try:
        return parse_smiles(smiles)
    except Exception:
        return None
