"""Hand-written Hopper kernels (sources in ``spark_rapids_ml_tpu_torch/csrc``),
each beside its plain PyTorch version and a launch counter."""
