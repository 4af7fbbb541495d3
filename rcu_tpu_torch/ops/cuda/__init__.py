"""Hand-written CUDA kernels (sources in ``rcu_tpu_torch/csrc/``)."""
