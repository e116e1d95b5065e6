"""Tracing ranges, counters and test helpers of the PyTorch/CUDA port."""
