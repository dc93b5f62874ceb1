"""The benchmark of lightgbm_tpu_torch, the PyTorch and CUDA port, on one
NVIDIA H100: `python -m bench_cuda --workload <name> --seed <n> --seconds
<s> --trace <0|1>` runs one cell of BENCHMARK.json once (harness.py).
Nothing here imports jax or the JAX package."""
