"""Package version of the PyTorch/CUDA port."""

__version__ = "0.1.0"
