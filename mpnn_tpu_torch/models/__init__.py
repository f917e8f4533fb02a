"""Model configs, parameter modules and forward passes."""

from mpnn_tpu_torch.models.config import MPNNConfig
from mpnn_tpu_torch.models.network import (NetworkConfig, Network,
                                           network_apply_packed,
                                           network_init)
from mpnn_tpu_torch.models.zoo import ZOO, build
