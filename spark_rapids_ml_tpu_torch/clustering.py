"""Clustering namespace — parity with ``org.apache.spark.ml.clustering``
and the reference's ``spark_rapids_ml_tpu.clustering`` (DBSCAN arrives
with its slice, ROADMAP A.14)."""

from spark_rapids_ml_tpu_torch.models.kmeans import KMeans, KMeansModel

__all__ = ["KMeans", "KMeansModel"]
