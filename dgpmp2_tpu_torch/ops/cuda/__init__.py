"""CUDA kernels (csrc/*.cu): build, bindings and launch wrappers.

Nothing here builds or loads a kernel at import time.
"""
