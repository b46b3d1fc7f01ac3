"""Plain PyTorch ops and the dispatch to their CUDA kernels."""
