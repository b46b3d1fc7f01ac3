"""The benchmark of dgpmp2_tpu_torch, the PyTorch + CUDA port, on the H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``; cells, configurations, traffic mixes and metrics are files
found by name (``spec``).  Imports nothing of JAX or of the JAX package.
"""
