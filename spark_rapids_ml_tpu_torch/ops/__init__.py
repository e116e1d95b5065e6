"""Tensor ops of the port: GEMMs, covariance, eigensolvers, and (under
``kernels``) the hand-written CUDA kernels that replace the reference's
Pallas kernels."""
