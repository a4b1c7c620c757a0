"""The benchmark of ``stringsearchlib_tpu_torch``, the PyTorch and CUDA
port: ``python3 -m benchmark.run`` runs one cell of ``BENCHMARK.json``
(see ``run.py``).  Nothing here imports ``jax`` or the JAX package."""
