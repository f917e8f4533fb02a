"""Plain PyTorch ops of the serving slice: linear, norms, GRU, readout,
edge-network MLP."""
