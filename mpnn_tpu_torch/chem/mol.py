"""Molecule model + perception (rings, aromaticity, implicit H,
hybridization, conjugation) — RDKit-free.

This module provides the subset of RDKit behavior the reference featurizer
consumes (mol_graph/mol_graph.py:25-90):
  atoms: GetAtomicNum, GetHybridization, IsInRing, GetIsAromatic,
         GetFormalCharge, GetTotalNumHs, neighbor count
  bonds: GetBondTypeAsDouble, GetIsAromatic, GetIsConjugated, IsInRing,
         begin/end indices

Hybridization codes follow RDKit's enum numbering so downstream one-hot
classes line up when the optional RDKit backend is used instead:
  0=UNSPECIFIED 1=S 2=SP 3=SP2 4=SP3 5=SP3D 6=SP3D2 7=OTHER

Perception notes (documented divergences from RDKit):
  - ring membership comes from a cycle-basis (shortest cycle through each
    edge), which matches RDKit's IsInRing for fused systems in practice;
  - aromaticity is a per-ring Hückel 4n+2 check over SSSR-like rings with
    standard π-electron contributions (C in ring double bond → 1, pyrrole-type
    N/O/S lone pair → 2, exocyclic C=O carbon → 0, …). Exact RDKit parity is
    not guaranteed for exotic systems; the common heteroaromatics are covered
    by tests.
  - conjugation: a bond is conjugated iff aromatic, or both end atoms are
    π-capable (participate in a multiple bond, or carry a lone pair adjacent
    to one). Matches RDKit on typical drug-like molecules.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from mpnn_tpu_torch.chem.periodic import (
    ATOMIC_NUM, DEFAULT_VALENCES, SYMBOLS, VALENCE_ELECTRONS,
)

# hybridization codes (RDKit enum order)
HYB_UNSPECIFIED, HYB_S, HYB_SP, HYB_SP2, HYB_SP3, HYB_SP3D, HYB_SP3D2, \
    HYB_OTHER = range(8)

# bond orders: aromatic is 1.5 (GetBondTypeAsDouble convention)
BOND_SINGLE, BOND_DOUBLE, BOND_TRIPLE, BOND_QUAD = 1.0, 2.0, 3.0, 4.0
BOND_AROMATIC = 1.5


@dataclasses.dataclass
class Atom:
    atomic_num: int
    formal_charge: int = 0
    explicit_hs: Optional[int] = None   # from [nH] etc.; None = derive
    aromatic: bool = False
    isotope: int = 0
    # perceived:
    implicit_hs: int = 0
    in_ring: bool = False
    hybridization: int = HYB_UNSPECIFIED
    idx: int = -1

    @property
    def symbol(self) -> str:
        return SYMBOLS[self.atomic_num - 1]

    @property
    def total_hs(self) -> int:
        return (self.explicit_hs or 0) + self.implicit_hs


@dataclasses.dataclass
class Bond:
    begin: int
    end: int
    order: float = BOND_SINGLE          # 1, 1.5, 2, 3
    aromatic: bool = False
    # perceived:
    in_ring: bool = False
    conjugated: bool = False
    idx: int = -1

    def other(self, i: int) -> int:
        return self.end if i == self.begin else self.begin


class Mol:
    """A molecular graph. Build with add_atom/add_bond, then sanitize()."""

    def __init__(self):
        self.atoms: List[Atom] = []
        self.bonds: List[Bond] = []
        self._adj: Dict[int, List[int]] = {}   # atom idx → bond idx list
        self._sanitized = False

    # -- construction -------------------------------------------------------

    def add_atom(self, atom: Atom) -> int:
        atom.idx = len(self.atoms)
        self.atoms.append(atom)
        self._adj[atom.idx] = []
        return atom.idx

    def add_bond(self, begin: int, end: int, order: float = BOND_SINGLE,
                 aromatic: bool = False) -> int:
        if begin == end:
            raise ValueError("self-bond")
        for bi in self._adj[begin]:
            if self.bonds[bi].other(begin) == end:
                raise ValueError(f"duplicate bond {begin}-{end}")
        bond = Bond(begin, end, order, aromatic)
        bond.idx = len(self.bonds)
        self.bonds.append(bond)
        self._adj[begin].append(bond.idx)
        self._adj[end].append(bond.idx)
        return bond.idx

    # -- queries ------------------------------------------------------------

    def num_atoms(self) -> int:
        return len(self.atoms)

    def neighbors(self, i: int) -> List[int]:
        return [self.bonds[bi].other(i) for bi in self._adj[i]]

    def atom_bonds(self, i: int) -> List[Bond]:
        return [self.bonds[bi] for bi in self._adj[i]]

    def get_bond(self, i: int, j: int) -> Optional[Bond]:
        for bi in self._adj[i]:
            if self.bonds[bi].other(i) == j:
                return self.bonds[bi]
        return None

    def degree(self, i: int) -> int:
        return len(self._adj[i])

    # -- perception ---------------------------------------------------------

    def sanitize(self):
        """Perceive rings → aromaticity → implicit H → hybridization →
        conjugation. Idempotent."""
        self._perceive_rings()
        self._perceive_aromaticity()
        self._assign_implicit_hs()
        self._perceive_hybridization()
        self._perceive_conjugation()
        self._sanitized = True
        return self

    # rings ------------------------------------------------------------------

    def _shortest_cycle_through(self, bond: Bond) -> Optional[List[int]]:
        """BFS from bond.begin to bond.end avoiding the bond itself →
        the smallest ring containing this bond (None if acyclic edge)."""
        import collections
        start, goal = bond.begin, bond.end
        prev = {start: None}
        q = collections.deque([start])
        while q:
            cur = q.popleft()
            for bi in self._adj[cur]:
                if bi == bond.idx:
                    continue
                nxt = self.bonds[bi].other(cur)
                if nxt in prev:
                    continue
                prev[nxt] = cur
                if nxt == goal:
                    path, node = [goal], cur
                    while node is not None:
                        path.append(node)
                        node = prev[node]
                    return path          # goal … start; bond closes the ring
                q.append(nxt)
        return None

    def _perceive_rings(self):
        self.rings: List[List[int]] = []
        seen = set()
        for bond in self.bonds:
            cyc = self._shortest_cycle_through(bond)
            bond.in_ring = cyc is not None
            if cyc is not None:
                key = frozenset(cyc)
                if key not in seen:
                    seen.add(key)
                    self.rings.append(cyc)
        for atom in self.atoms:
            atom.in_ring = any(b.in_ring for b in self.atom_bonds(atom.idx))

    # aromaticity ------------------------------------------------------------

    def _pi_contribution(self, idx: int, ring: set) -> Optional[int]:
        """π electrons this atom donates to an aromatic ring; None = blocks
        aromaticity."""
        atom = self.atoms[idx]
        bonds = self.atom_bonds(idx)
        # explicit sp3 centers block (4 sigma partners incl. hs)
        sigma = len(bonds) + (atom.explicit_hs or 0)
        in_ring_double = any(
            b.order == BOND_DOUBLE and b.other(idx) in ring for b in bonds)
        exo_double = any(
            b.order == BOND_DOUBLE and b.other(idx) not in ring for b in bonds)
        any_double = any(b.order >= BOND_DOUBLE for b in bonds)
        z, q = atom.atomic_num, atom.formal_charge
        ve = VALENCE_ELECTRONS.get(z, 4) - q
        if atom.aromatic:
            # input said aromatic: count 1 for C-like, 2 for lone-pair donors
            if z == 6:
                return 1 if not exo_double else 0
            if z in (7, 15):        # n: pyridine-type (1) vs pyrrole-type (2)
                hs = atom.explicit_hs or 0
                # three sigma partners (2 ring + 1 H/substituent) → pyrrole-type
                return 2 if (sigma >= 3 and not any_double) else 1
            if z in (8, 16, 34, 52):
                return 2
            if z == 5:
                return 0            # empty p orbital
            return 1
        # kekulized input
        if in_ring_double:
            return 1
        if exo_double:
            return 0                # e.g. quinone carbonyl carbon
        if any(b.order == BOND_TRIPLE for b in bonds):
            return None
        # saturated atom: can it donate a lone pair?
        bond_e = sum(int(b.order) for b in bonds)
        lone_pairs = (ve - bond_e - atom.total_hs) // 2 \
            if self._sanitized else (ve - bond_e - (atom.explicit_hs or 0)
                                     - self._quick_implicit_h(atom, bonds)) // 2
        if lone_pairs > 0 and z in (7, 8, 16, 15, 34, 52):
            return 2
        if z == 6 and q == -1:
            return 2
        if z == 6 and q == 1:
            return 0
        if z == 5:
            return 0
        return None

    def _quick_implicit_h(self, atom: Atom, bonds) -> int:
        """Implicit-H estimate usable before sanitize() finishes (the
        aromaticity pass needs lone-pair counts before _assign_implicit_hs
        has run). Same valence rules as _assign_implicit_hs."""
        if atom.explicit_hs is not None:
            return 0
        vals = DEFAULT_VALENCES.get(atom.symbol)
        if not vals:
            return 0
        order_sum = self._bond_order_sum_for_valence(atom)
        charge = atom.formal_charge
        adj = charge if atom.atomic_num in (7, 8, 15, 16) else -abs(charge)
        for v in vals:
            target = v + adj
            if order_sum <= target:
                return target - order_sum
        return 0

    def _perceive_aromaticity(self):
        """Hückel 4n+2 per ring; iterate to fixpoint so fused systems where
        one ring's aromatization enables another's converge."""
        changed = True
        rounds = 0
        while changed and rounds < 8:
            changed = False
            rounds += 1
            for ring in self.rings:
                rset = set(ring)
                if len(ring) < 3:
                    continue
                contribs = [self._pi_contribution(i, rset) for i in ring]
                if any(c is None for c in contribs):
                    continue
                # require every atom π-capable: sp3-saturated C with no
                # double bond and no lone pair yields None above
                total = sum(contribs)
                if total >= 2 and (total - 2) % 4 == 0:
                    ring_bonds = []
                    ok = True
                    for a, b in zip(ring, ring[1:] + ring[:1]):
                        bd = self.get_bond(a, b)
                        if bd is None:
                            ok = False
                            break
                        ring_bonds.append(bd)
                    if not ok:
                        continue
                    for i in ring:
                        if not self.atoms[i].aromatic:
                            self.atoms[i].aromatic = True
                            changed = True
                    for bd in ring_bonds:
                        if not bd.aromatic:
                            bd.aromatic = True
                            bd.order = BOND_AROMATIC
                            changed = True

    # implicit H -------------------------------------------------------------

    def _bond_order_sum_for_valence(self, atom: Atom) -> int:
        """Bond-order sum for the implicit-H valence model. Aromatic bonds
        count 1.5 for π-BOND contributors (aromatic C, 2-connected pyridine
        N) but only 1.0 for lone-pair DONORS (pyrrole-type 3-connected N/P,
        aromatic O/S/Se/Te) — their lone pair, not a π bond, joins the ring
        system, so their σ framework alone sets the valence (caffeine's
        N-methyl ring nitrogens carry no H)."""
        import math
        bonds = self.atom_bonds(atom.idx)
        z = atom.atomic_num
        degree = len(bonds)
        donor = atom.aromatic and (
            (z in (7, 15) and degree >= 3) or z in (8, 16, 34, 52))
        total = sum((1.0 if (donor and b.aromatic) else b.order)
                    for b in bonds)
        return int(math.ceil(total))

    def _assign_implicit_hs(self):
        for atom in self.atoms:
            if atom.explicit_hs is not None:
                atom.implicit_hs = 0
                continue
            vals = DEFAULT_VALENCES.get(atom.symbol)
            if vals is None:
                atom.implicit_hs = 0    # metals etc.: no implicit H
                continue
            order_sum = self._bond_order_sum_for_valence(atom)
            # charge adjustment (N+: valence 4, O+: 3, C-: 3, N-: 2, O-: 1)
            charge = atom.formal_charge
            adj = charge if atom.atomic_num in (7, 8, 15, 16) else -abs(charge)
            atom.implicit_hs = 0
            for v in vals:
                target = v + adj
                if order_sum <= target:
                    atom.implicit_hs = target - order_sum
                    break

    # hybridization ----------------------------------------------------------

    def _perceive_hybridization(self):
        for atom in self.atoms:
            z = atom.atomic_num
            if z == 1:
                atom.hybridization = HYB_S
                continue
            if z not in VALENCE_ELECTRONS and z > 10:
                # metals / uncommon: RDKit reports S/UNSPECIFIED-ish; use SP3
                # for bonded, UNSPECIFIED for bare ions
                atom.hybridization = (HYB_UNSPECIFIED
                                      if self.degree(atom.idx) == 0
                                      else HYB_SP3)
                continue
            bonds = self.atom_bonds(atom.idx)
            sigma = len(bonds) + atom.total_hs
            ve = VALENCE_ELECTRONS.get(z, 4) - atom.formal_charge
            # one electron per sigma bond from this atom (aromatic counts 1)
            bond_e = sum(int(round(b.order)) if not b.aromatic else 1
                         for b in bonds) + atom.total_hs
            lone_pairs = max(0, (ve - bond_e) // 2)
            if atom.aromatic:
                atom.hybridization = HYB_SP2
                continue
            # pure STERIC-NUMBER assignment (σ partners + lone pairs) —
            # RDKit's rule. The previous n_pi shortcut (two π bonds → SP)
            # misassigned hypervalent centers: sulfone S (two S=O, σ=4,
            # lp=0) is SP3 in RDKit and textbooks, not SP; same for
            # phosphate P. Pure steric reproduces every first-row case the
            # shortcut got right (nitrile/allene/CO₂ centers: σ2+lp0 → SP;
            # carbonyl C: σ3 → SP2) — pinned by tests/test_chem_golden.py.
            steric = sigma + lone_pairs
            atom.hybridization = {1: HYB_S, 2: HYB_SP, 3: HYB_SP2,
                                  4: HYB_SP3, 5: HYB_SP3D,
                                  6: HYB_SP3D2}.get(steric, HYB_OTHER)

    # conjugation ------------------------------------------------------------

    def _pi_contributor(self, idx: int) -> bool:
        """Atom can extend a π system: participates in a multiple/aromatic
        bond, or carries a lone pair (amide N, ester O, halogens, …)."""
        atom = self.atoms[idx]
        bonds = self.atom_bonds(idx)
        if atom.aromatic or any(b.order >= BOND_DOUBLE or b.aromatic
                                for b in bonds):
            return True
        ve = VALENCE_ELECTRONS.get(atom.atomic_num, 4) - atom.formal_charge
        bond_e = sum(int(round(b.order)) if not b.aromatic else 1
                     for b in bonds) + atom.total_hs
        return (ve - bond_e) >= 2

    def _perceive_conjugation(self):
        """RDKit's pairwise marking (Conjugation.cpp semantics): at every
        atom, for each MULTIPLE/AROMATIC bond b1 and each other bond b2
        whose far atom can extend the π system, mark BOTH conjugated. An
        ISOLATED multiple bond (ethene, a lone ketone C=O) is therefore
        NOT conjugated — the previous both-ends-π-capable rule marked it,
        a systematic RDKit divergence on drug-like motifs, fixed round 3
        (pinned by tests/test_chem_golden.py)."""
        contrib = [self._pi_contributor(i) for i in range(self.num_atoms())]
        for bond in self.bonds:
            bond.conjugated = bool(bond.aromatic)
        for atom in self.atoms:
            # conjugation only extends through SP/SP2 centers (the RDKit
            # gate): a sulfone/phosphate SP3 center does NOT conjugate its
            # two π bonds (runs after _perceive_hybridization — see
            # perceive())
            if atom.hybridization not in (HYB_SP, HYB_SP2):
                continue
            bonds = self.atom_bonds(atom.idx)
            for b1 in bonds:
                if b1.order < BOND_DOUBLE and not b1.aromatic:
                    continue
                for b2 in bonds:
                    if b2 is b1:
                        continue
                    far = b2.end if b2.begin == atom.idx else b2.begin
                    if contrib[far]:
                        b1.conjugated = True
                        b2.conjugated = True

    # fragments ---------------------------------------------------------------

    def fragments(self) -> List[List[int]]:
        """Connected components (atom index lists)."""
        seen = set()
        out = []
        for start in range(self.num_atoms()):
            if start in seen:
                continue
            comp, stack = [], [start]
            seen.add(start)
            while stack:
                cur = stack.pop()
                comp.append(cur)
                for nb in self.neighbors(cur):
                    if nb not in seen:
                        seen.add(nb)
                        stack.append(nb)
            out.append(sorted(comp))
        return out

    def extract_fragment(self, atom_idxs: List[int]) -> "Mol":
        """New Mol containing only the given atoms (renumbered)."""
        import copy
        remap = {a: i for i, a in enumerate(atom_idxs)}
        sub = Mol()
        for a in atom_idxs:
            atom = copy.copy(self.atoms[a])
            sub.add_atom(atom)
        for b in self.bonds:
            if b.begin in remap and b.end in remap:
                sub.add_bond(remap[b.begin], remap[b.end], b.order,
                             b.aromatic)
        if self._sanitized:
            sub.sanitize()
        return sub


def choose_largest_fragment(mol: Mol) -> Mol:
    """Salt stripping: keep the largest covalent unit — most atoms counting
    hydrogens; ties broken by heavier total mass (the reference's
    choose_largest_fragment, pre_process/utils.py:26-57; its call site is
    commented out there but the capability is kept)."""
    from mpnn_tpu_torch.chem.periodic import SYMBOLS
    # rough atomic masses ≈ 2·Z is enough for tie-breaking by weight
    frags = mol.fragments()
    if len(frags) <= 1:
        return mol
    def score(idxs):
        atoms = sum(1 + mol.atoms[i].total_hs for i in idxs)
        weight = sum(2 * mol.atoms[i].atomic_num + mol.atoms[i].total_hs
                     for i in idxs)
        return (atoms, weight)
    best = max(frags, key=score)
    return mol.extract_fragment(best)
