"""Neighbours namespace — parity with the RAPIDS Spark-ML NearestNeighbors
and ApproximateNearestNeighbors, and with the reference's
``spark_rapids_ml_tpu.neighbors``."""

from spark_rapids_ml_tpu_torch.models.approximate_nearest_neighbors import (
    ApproximateNearestNeighbors,
    ApproximateNearestNeighborsModel,
)
from spark_rapids_ml_tpu_torch.models.nearest_neighbors import NearestNeighbors, NearestNeighborsModel

__all__ = [
    "NearestNeighbors",
    "NearestNeighborsModel",
    "ApproximateNearestNeighbors",
    "ApproximateNearestNeighborsModel",
]
