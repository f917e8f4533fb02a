"""Host-side graph pipeline (numpy only): encoders, MolGraph, packed
batching, CSV datasets and the packed GraphLoader."""

from mpnn_tpu_torch.graphs.encoders import (
    GraphEncoder,
    LabelBinarizer,
    LabelEncoder,
    MinMaxScaler,
)
from mpnn_tpu_torch.graphs.graph import MolGraph, from_mol
from mpnn_tpu_torch.graphs.batching import (
    DEFAULT_NODE_BUCKETS,
    PackedBatch,
    attach_edge_vocab,
    bucket_for,
    build_edge_vocab,
    collate_packed,
)
from mpnn_tpu_torch.graphs.dataset import (
    encode_molgraphs,
    fit_encoders,
    generate_molgraphs,
    load_classification_dataset,
    load_ecfp_dataset,
    load_number_dataset,
)
from mpnn_tpu_torch.graphs.dataloader import GraphLoader
