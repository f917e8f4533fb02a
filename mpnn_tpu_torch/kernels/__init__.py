"""Hand-written CUDA kernels (sources in csrc/) with their wrappers and
plain PyTorch versions. Nothing is built at import: kernels/build.py
compiles at first use."""
