"""Morgan (ECFP) fingerprints with per-atom bit attribution — RDKit-free
(a copy of mpnn_tpu/chem/ecfp.py, over the port's own chem/mol.py).

Replaces the reference's `AllChem.GetMorganFingerprintAsBitVect(mol, 3,
nBits=16384, bitInfo=info)` + per-atom bit matrix construction
(pre_process/load_dataset.py:112-120). The algorithm is the standard Morgan
iteration: hash per-atom invariants, then for each radius combine with
sorted (bond-order, neighbor-hash) pairs. Bit values will NOT be identical
to RDKit's (different hash), but the representation has the same structure,
sparsity, and per-atom attribution semantics; with the optional RDKit
backend installed the loader can use RDKit bits instead.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Dict, List, Tuple

import numpy as np

from mpnn_tpu_torch.chem.mol import Mol


def _hash(*vals: int) -> int:
    raw = struct.pack(f"<{len(vals)}Q", *(v & 0xFFFFFFFFFFFFFFFF for v in vals))
    return struct.unpack("<Q", hashlib.blake2b(raw, digest_size=8).digest())[0]


def _initial_invariants(mol: Mol) -> List[int]:
    inv = []
    for atom in mol.atoms:
        inv.append(_hash(
            atom.atomic_num,
            mol.degree(atom.idx),
            atom.total_hs,
            atom.formal_charge,
            int(atom.in_ring),
            int(atom.aromatic),
        ))
    return inv


def morgan_bit_info(mol: Mol, radius: int = 3,
                    nbits: int = 16384) -> Dict[int, List[Tuple[int, int]]]:
    """→ {bit: [(atom_idx, radius), ...]} — the bitInfo structure."""
    inv = _initial_invariants(mol)
    info: Dict[int, List[Tuple[int, int]]] = {}

    def emit(atom_idx: int, rad: int, code: int):
        bit = code % nbits
        info.setdefault(bit, []).append((atom_idx, rad))

    for i in range(mol.num_atoms()):
        emit(i, 0, inv[i])

    for rad in range(1, radius + 1):
        new_inv = list(inv)
        for i in range(mol.num_atoms()):
            nbrs = sorted(
                (int(2 * b.order), inv[b.other(i)])
                for b in mol.atom_bonds(i))
            flat = [rad, inv[i]]
            for order, h in nbrs:
                flat += [order, h]
            code = _hash(*flat)
            new_inv[i] = code
            # note: RDKit's bitInfo lists EVERY (atom, radius) pair for a
            # bit, including symmetric duplicates — no env dedup here (its
            # env dedup affects only count vectors, not bitInfo membership)
            emit(i, rad, code)
        inv = new_inv
    return info


def ecfp_bits_per_atom(mol: Mol, radius: int = 3,
                       nbits: int = 16384) -> np.ndarray:
    """→ (num_atoms, nbits) float32 matrix; arr[a, bit] = 1 when atom `a` is
    the center of an environment hashing to `bit`
    (load_dataset.py:112-120 semantics)."""
    arr = np.zeros((mol.num_atoms(), nbits), np.float32)
    for bit, positions in morgan_bit_info(mol, radius, nbits).items():
        for pos, _rad in positions:
            arr[pos, bit] = 1
    return arr


def ecfp_bitvector(mol: Mol, radius: int = 3, nbits: int = 16384) -> np.ndarray:
    """→ (nbits,) molecule-level bit vector (union over atoms)."""
    return ecfp_bits_per_atom(mol, radius, nbits).max(axis=0)
