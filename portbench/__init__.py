"""The benchmark of the PyTorch/CUDA port (``sot_tpu_torch``): cells named
in ``BENCHMARK.json``, run by ``python3 -m portbench.run``."""
