"""Host-side chemistry (numpy only): SMILES parsing and atom/bond
featurization, copied from mpnn_tpu/chem so the port stands alone."""

from mpnn_tpu_torch.chem.mol import Atom, Bond, Mol
from mpnn_tpu_torch.chem.smiles import parse_smiles, mol_from_smiles, SmilesError
from mpnn_tpu_torch.chem.featurize import (
    atom_features,
    bond_features_dense,
    edge_list,
    ATOM_HOT_FEATURES,
    ATOM_BOOL_FEATURES,
    ATOM_NUMERIC_FEATURES,
    BOND_FEATURES,
)
