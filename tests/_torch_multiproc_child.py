"""Child process of tests/test_torch_multiprocess.py: ``chip_smoke.
mesh_process`` (phase 16 (c)) on the CPU at a small size, one of two
torch.distributed processes joined through gloo.

Usage: python _torch_multiproc_child.py <rank> <world size> <port>
"""
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import chip_smoke  # noqa: E402

torch.set_num_threads(1)
rank, world, port = map(int, sys.argv[1:4])
chip_smoke.mesh_process(rank, world, port, torch.device("cpu"), b=8, t=12,
                        iters=8, train_b=6, unroll=2, tk=1, tol64=1e-12,
                        timeout_s=60)
