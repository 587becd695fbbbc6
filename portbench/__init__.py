"""The benchmark of the PyTorch and CUDA port ``lshm_tpu_torch``.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the card; ``python3 -m portbench.calibrate``
reads the numbers that decide ``correct`` over many seeds; ``python -m pytest
portbench/tests`` runs the benchmark's own tests (those marked ``card`` skip without
one).  Nothing here imports JAX or the JAX package ``lshm_tpu``.
"""
