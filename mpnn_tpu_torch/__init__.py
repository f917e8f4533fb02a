"""mpnn_tpu_torch — the PyTorch/CUDA port of mpnn_tpu (the JAX package).

The serving path of the flagship `lipo` model runs here on an NVIDIA GPU:
SMILES → host featurization and packing (numpy, `chem/`, `graphs/`) →
network shell in PyTorch (`models/network.py`) → the MPNN core in ONE
hand-written CUDA launch (`kernels/fused_step.py`, `csrc/fused_eval.cu`).

Module names follow `mpnn_tpu` so each piece has an obvious counterpart;
this package imports nothing of `mpnn_tpu` and never imports `jax`.
Entry points run on `cuda` unless the caller asks for `device="cpu"`.
"""

__version__ = "0.1.0"
