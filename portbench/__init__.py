"""The benchmark of the PyTorch/CUDA port (``sparse_matrix_with_flops_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  The
yardstick lives here and imports nothing of the port: input generators,
the plain references, the comparison that decides ``correct``, the
arithmetic of rates, percentiles, rooflines and idle shares.  From the
port the harness takes only the entry points that a cell drives.
"""
